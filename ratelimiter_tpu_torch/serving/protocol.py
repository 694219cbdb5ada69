"""Wire protocol subset of the port's server.

The frames, byte for byte as ``ratelimiter_tpu/serving/protocol.py``
encodes them (tests/test_torch_serving.py holds the encoders to it), for
the requests this slice serves. Frame layout (little-endian)::

    u32  payload_length          (not counting these 4 bytes)
    u8   type
    u64  request_id              (echoed in the response)
    ...  type-specific body

Requests:
    ALLOW_N       (1): u32 n, u16 key_len, key utf-8
    RESET         (2): u16 key_len, key utf-8
    HEALTH        (3): -
    METRICS       (4): -
    ALLOW_BATCH   (5): u32 count, then count x {u32 n, u16 key_len, key}
    POLICY_SET    (7): u8 flags (bit0 limit given), i64 limit,
                       f64 window_scale, u16 key_len, key utf-8
    POLICY_GET    (8): u16 key_len, key utf-8
    POLICY_DEL    (9): u16 key_len, key utf-8
    SNAPSHOT     (10): -
    ALLOW_HASHED (11): u32 count | u64 ids[count] | u32 ns[count] — raw
                       u64 ids, splitmix64 and the (h1, h2) split run on
                       the device
    SHM_HELLO    (16): u32 version | u32 req_ring_bytes | u32
                       rep_ring_bytes (0 = the server's default): the
                       shared-memory lane's upgrade, matched on the RAW
                       type byte (16 is the forward bit over base type
                       0, which is no request) before any flag is
                       stripped; it never carries an extension

Responses:
    RESULT        (129): u8 flags (bit0 allowed, bit1 fail_open), i64 limit,
                         i64 remaining, f64 retry_after, f64 reset_at
    OK            (130): -
    HEALTH        (131): u8 status, f64 uptime_s, u64 decisions_total
    METRICS_R     (132): u32 len, Prometheus text utf-8
    RESULT_BATCH  (133): i64 limit (the DEFAULT limit), u32 count, then
                         count x {u8 flags, i64 remaining, f64 retry,
                         f64 reset}
    POLICY_R      (134): u8 found, i64 limit, f64 window_scale
    SNAPSHOT_R    (135): u64 snapshot_id, u64 wal_seq, f64 duration_s
    SHM_HELLO_R   (141): u8 ok, u32 req_cap, u32 rep_cap, u16 len + the
                         ring file's path, u16 len + the control
                         socket's path
    RESULT_HASHED (136): u8 batch_flags (bit1 fail_open), i64 limit,
                         u32 count, u8 allowed_bits[ceil(count/8)]
                         (little-endian bit order), then COLUMNAR
                         i64 remaining | f64 retry | f64 reset
    ERROR         (255): u16 code, u16 msg_len, msg utf-8

Request frame extensions, the JAX package's bits on the type byte: the
trace id (0x40, a u64 prefixed to the body) and the relative deadline
budget (0x20, an f64 prefixed to the body; with both, the trace id comes
first). ``split_request`` strips both. The fleet's forward hint (0x10)
is not served: ``REQUEST_FLAGS`` names it so both doors refuse such
frames with E_INVALID_CONFIG.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

from ratelimiter_tpu_torch.core.errors import (
    ClosedError,
    DeadlineExceededError,
    InvalidConfigError,
    InvalidKeyError,
    InvalidNError,
    RateLimiterError,
    StorageUnavailableError,
)
from ratelimiter_tpu_torch.core.types import BatchResult, Result

MAX_FRAME = 1 << 20
MAX_KEY_LEN = 4096

T_ALLOW_N = 1
T_RESET = 2
T_HEALTH = 3
T_METRICS = 4
T_ALLOW_BATCH = 5
T_POLICY_SET = 7
T_POLICY_GET = 8
T_POLICY_DEL = 9
T_SNAPSHOT = 10
T_ALLOW_HASHED = 11
#: The JAX protocol's DCN push: no door of the port serves it.
T_DCN_PUSH = 6
#: Shared-memory lane negotiation: 16 is the forward bit over base type
#: 0, and base type 0 is no request, so both doors match the RAW type
#: byte exactly before stripping any flag.
T_SHM_HELLO = 16

T_RESULT = 129
T_OK = 130
T_HEALTH_R = 131
T_METRICS_R = 132
T_RESULT_BATCH = 133
T_POLICY_R = 134
T_SNAPSHOT_R = 135
T_RESULT_HASHED = 136
T_SHM_HELLO_R = 141
T_ERROR = 255

#: Request-type extension bit of the JAX package's protocol that this
#: server does not serve (the fleet's forward hint); it refuses frames
#: carrying it.
REQUEST_FLAGS = 0x10

E_INVALID_N = 1
E_INVALID_KEY = 2
E_STORAGE_UNAVAILABLE = 3
E_CLOSED = 4
E_INVALID_CONFIG = 5
#: The JAX protocol's shutting-down code (a StorageUnavailableError on
#: the client).
E_SHUTTING_DOWN = 6
E_INTERNAL = 7
#: The request's propagated deadline expired before its dispatch ran
#: (the fail-closed side of deadline shedding).
E_DEADLINE = 8


def code_for(exc: Exception) -> int:
    if isinstance(exc, DeadlineExceededError):
        return E_DEADLINE
    if isinstance(exc, InvalidNError):
        return E_INVALID_N
    if isinstance(exc, (InvalidKeyError, UnicodeDecodeError)):
        return E_INVALID_KEY
    if isinstance(exc, StorageUnavailableError):
        return E_STORAGE_UNAVAILABLE
    if isinstance(exc, ClosedError):
        return E_CLOSED
    if isinstance(exc, InvalidConfigError):
        return E_INVALID_CONFIG
    return E_INTERNAL


_CODE_TO_EXC = {
    E_INVALID_N: InvalidNError,
    E_INVALID_KEY: InvalidKeyError,
    E_STORAGE_UNAVAILABLE: StorageUnavailableError,
    E_CLOSED: ClosedError,
    E_INVALID_CONFIG: InvalidConfigError,
    E_SHUTTING_DOWN: StorageUnavailableError,
    E_INTERNAL: RateLimiterError,
    E_DEADLINE: DeadlineExceededError,
}


def exception_for(code: int, msg: str) -> Exception:
    """The library's exception for a wire error code (the client raises
    what a local limiter would)."""
    return _CODE_TO_EXC.get(code, RateLimiterError)(msg)


class ProtocolError(RateLimiterError):
    """Malformed frame — the connection is beyond recovery."""


_HDR = struct.Struct("<IBQ")          # length, type, request_id
_ALLOW_BODY = struct.Struct("<IH")    # n, key_len
_KEYLEN = struct.Struct("<H")
_RESULT_BODY = struct.Struct("<Bqqdd")
_HEALTH_BODY = struct.Struct("<BdQ")
_ERROR_HEAD = struct.Struct("<HH")
_U32 = struct.Struct("<I")
_BATCH_ITEM = struct.Struct("<IH")        # n, key_len (per request)
_BATCH_RES_HEAD = struct.Struct("<qI")    # limit, count
_BATCH_RES_ITEM = struct.Struct("<Bqdd")  # flags, remaining, retry, reset
_HASHED_RES_HEAD = struct.Struct("<BqI")  # batch_flags, limit, count

HEADER_SIZE = _HDR.size  # 13


def parse_header(buf: bytes) -> Tuple[int, int, int]:
    """(payload_length, type, req_id) from the 13 header bytes."""
    length, type_, req_id = _HDR.unpack_from(buf)
    if length < 9 or length > MAX_FRAME:
        raise ProtocolError(f"bad frame length {length}")
    return length, type_, req_id


# --------------------------------------------- trace context (ADR-014)
#
# Optional caller trace propagation: setting bit 6 (0x40) on any REQUEST
# type byte means the body is prefixed with a u64 trace id (little-
# endian). Request types are 1..11 and response types >= 128, so the
# flagged range 0x41..0x4B collides with nothing; responses never carry
# the flag (the request id already correlates them). Servers that
# predate the flag drop the connection on the unknown type — the flag is
# only sent by callers that opted into tracing against a known server.
TRACE_FLAG = 0x40
_TRACE_ID = struct.Struct("<Q")

# ------------------------------------------- deadline context (ADR-015)
#
# Request deadline propagation, the same frame-extension mechanism as
# the trace id: bit 5 (0x20) on a REQUEST type byte means the body is
# prefixed with an f64 RELATIVE deadline budget in seconds (relative,
# not absolute — client and server wall clocks need not agree; the
# receiver anchors the budget to frame arrival). Servers SHED work
# whose budget has expired before its dispatch runs, answering per the
# fail-open/fail-closed policy instead of burning a dispatch slot
# (core/errors.DeadlineExceededError on the fail-closed side). When
# both extensions are present the trace id comes FIRST on the wire:
# apply ``with_deadline`` before ``with_trace``.
DEADLINE_FLAG = 0x20
_DEADLINE = struct.Struct("<d")
_REQ_FLAGS = TRACE_FLAG | DEADLINE_FLAG


def with_deadline(frame: bytes, budget_s: float) -> bytes:
    """Re-frame a request with the deadline extension (flag bit on the
    type byte + f64 relative budget prefixed to the body). Must be
    applied BEFORE ``with_trace`` — the trace id is the outermost
    prefix on the wire."""
    length, type_, req_id = _HDR.unpack_from(frame)
    if type_ & _REQ_FLAGS or type_ >= 128:
        raise ProtocolError(f"type {type_} cannot carry a deadline")
    body = _DEADLINE.pack(float(budget_s)) + frame[HEADER_SIZE:]
    return _HDR.pack(1 + 8 + len(body), type_ | DEADLINE_FLAG,
                     req_id) + body


def with_trace(frame: bytes, trace_id: int) -> bytes:
    """Re-frame a request with the trace-id extension (flag bit on the
    type byte + u64 id prefixed to the body). Composes with the
    deadline extension (apply ``with_deadline`` first; the trace id
    ends up outermost)."""
    length, type_, req_id = _HDR.unpack_from(frame)
    if type_ & TRACE_FLAG or type_ >= 128:
        raise ProtocolError(f"type {type_} cannot carry a trace id")
    body = _TRACE_ID.pack(trace_id & 0xFFFFFFFFFFFFFFFF) \
        + frame[HEADER_SIZE:]
    return _HDR.pack(1 + 8 + len(body), type_ | TRACE_FLAG, req_id) + body


def split_trace(type_: int, body: bytes):
    """(base_type, trace_id, body) from a possibly-flagged request frame
    — servers call this once per frame; unflagged frames pass through
    with trace_id 0 and zero copies. The deadline flag (if any) stays
    on the returned type for ``split_request`` callers."""
    if not (type_ & TRACE_FLAG) or type_ >= 128:
        return type_, 0, body
    if len(body) < _TRACE_ID.size:
        raise ProtocolError("short trace-id extension")
    (trace_id,) = _TRACE_ID.unpack_from(body)
    return type_ & ~TRACE_FLAG, trace_id, body[_TRACE_ID.size:]


def split_request(type_: int, body: bytes):
    """(base_type, trace_id, deadline_budget_s, body) — strips BOTH
    frame extensions in canonical order (trace id, then deadline).
    Unflagged frames pass through with (0, None) and zero copies.
    ``deadline_budget_s`` is the sender's RELATIVE budget (None = no
    deadline; <= 0 = already expired on arrival); anchor it to frame
    arrival on the receiving side."""
    type_, trace_id, body = split_trace(type_, body)
    if not (type_ & DEADLINE_FLAG) or type_ >= 128:
        return type_, trace_id, None, body
    if len(body) < _DEADLINE.size:
        raise ProtocolError("short deadline extension")
    (budget,) = _DEADLINE.unpack_from(body)
    return (type_ & ~DEADLINE_FLAG, trace_id, budget,
            body[_DEADLINE.size:])


# ----------------------------------------------------------- requests


def encode_allow_n(req_id: int, key: str, n: int) -> bytes:
    kb = key.encode("utf-8")
    body = _ALLOW_BODY.pack(n, len(kb)) + kb
    return _HDR.pack(1 + 8 + len(body), T_ALLOW_N, req_id) + body


def parse_allow_n(body: bytes) -> Tuple[str, int]:
    n, key_len = _ALLOW_BODY.unpack_from(body)
    if key_len > MAX_KEY_LEN or len(body) != _ALLOW_BODY.size + key_len:
        raise ProtocolError("bad ALLOW_N body")
    return body[_ALLOW_BODY.size:].decode("utf-8"), n


def encode_reset(req_id: int, key: str) -> bytes:
    kb = key.encode("utf-8")
    body = _KEYLEN.pack(len(kb)) + kb
    return _HDR.pack(1 + 8 + len(body), T_RESET, req_id) + body


def parse_reset(body: bytes) -> str:
    (key_len,) = _KEYLEN.unpack_from(body)
    if key_len > MAX_KEY_LEN or len(body) != _KEYLEN.size + key_len:
        raise ProtocolError("bad RESET body")
    return body[_KEYLEN.size:].decode("utf-8")


def encode_simple(type_: int, req_id: int) -> bytes:
    return _HDR.pack(1 + 8, type_, req_id)


def encode_allow_batch(req_id: int, keys, ns) -> bytes:
    parts = [_U32.pack(len(keys))]
    for key, n in zip(keys, ns):
        kb = key.encode("utf-8")
        parts.append(_BATCH_ITEM.pack(n, len(kb)))
        parts.append(kb)
    body = b"".join(parts)
    return _HDR.pack(1 + 8 + len(body), T_ALLOW_BATCH, req_id) + body


def parse_allow_batch(body: bytes):
    """-> (keys, ns)."""
    (count,) = _U32.unpack_from(body)
    off = _U32.size
    keys, ns = [], []
    for _ in range(count):
        if off + _BATCH_ITEM.size > len(body):
            raise ProtocolError("truncated ALLOW_BATCH body")
        n, key_len = _BATCH_ITEM.unpack_from(body, off)
        off += _BATCH_ITEM.size
        if key_len > MAX_KEY_LEN or off + key_len > len(body):
            raise ProtocolError("bad ALLOW_BATCH key")
        keys.append(body[off:off + key_len].decode("utf-8"))
        ns.append(n)
        off += key_len
    if off != len(body):
        raise ProtocolError("trailing bytes in ALLOW_BATCH body")
    return keys, ns


def encode_allow_hashed(req_id: int, ids, ns=None) -> bytes:
    ids = np.ascontiguousarray(ids, dtype="<u8")
    if ns is None:
        ns_arr = np.ones(ids.shape[0], dtype="<u4")
    else:
        ns_arr = np.ascontiguousarray(ns, dtype="<u4")
    if ns_arr.shape[0] != ids.shape[0]:
        raise ValueError("ids and ns must have equal length")
    body = _U32.pack(ids.shape[0]) + ids.tobytes() + ns_arr.tobytes()
    return _HDR.pack(1 + 8 + len(body), T_ALLOW_HASHED, req_id) + body


def parse_allow_hashed(body: bytes):
    """-> (ids uint64, ns uint32) as np.frombuffer views of the body."""
    if len(body) < 4:
        raise ProtocolError("short ALLOW_HASHED body")
    (count,) = _U32.unpack_from(body)
    if len(body) != 4 + 12 * count:
        raise ProtocolError(
            f"bad ALLOW_HASHED body ({len(body)}B for count={count})")
    ids = np.frombuffer(body, dtype="<u8", count=count, offset=4)
    ns = np.frombuffer(body, dtype="<u4", count=count, offset=4 + 8 * count)
    return ids, ns


# ---------------------------------------------------------- responses


def encode_result(req_id: int, res: Result) -> bytes:
    flags = (1 if res.allowed else 0) | (2 if res.fail_open else 0)
    body = _RESULT_BODY.pack(flags, res.limit, res.remaining,
                             res.retry_after, res.reset_at)
    return _HDR.pack(1 + 8 + len(body), T_RESULT, req_id) + body


def parse_result(body: bytes) -> Result:
    flags, limit, remaining, retry_after, reset_at = _RESULT_BODY.unpack(body)
    return Result(allowed=bool(flags & 1), limit=limit, remaining=remaining,
                  retry_after=retry_after, reset_at=reset_at,
                  fail_open=bool(flags & 2))


def encode_ok(req_id: int) -> bytes:
    return _HDR.pack(1 + 8, T_OK, req_id)


def encode_health(req_id: int, serving: bool, uptime_s: float,
                  decisions: int) -> bytes:
    body = _HEALTH_BODY.pack(1 if serving else 0, uptime_s, decisions)
    return _HDR.pack(1 + 8 + len(body), T_HEALTH_R, req_id) + body


def parse_health(body: bytes) -> Tuple[bool, float, int]:
    status, uptime, decisions = _HEALTH_BODY.unpack(body)
    return bool(status), uptime, decisions


def encode_metrics(req_id: int, text: str) -> bytes:
    tb = text.encode("utf-8")
    body = _U32.pack(len(tb)) + tb
    return _HDR.pack(1 + 8 + len(body), T_METRICS_R, req_id) + body


def parse_metrics(body: bytes) -> str:
    (n,) = _U32.unpack_from(body)
    return body[_U32.size:_U32.size + n].decode("utf-8")


def encode_error(req_id: int, code: int, msg: str) -> bytes:
    mb = msg.encode("utf-8")[:65535]
    body = _ERROR_HEAD.pack(code, len(mb)) + mb
    return _HDR.pack(1 + 8 + len(body), T_ERROR, req_id) + body


def parse_error(body: bytes) -> Tuple[int, str]:
    code, msg_len = _ERROR_HEAD.unpack_from(body)
    return code, body[_ERROR_HEAD.size:_ERROR_HEAD.size + msg_len].decode("utf-8")


def encode_result_batch_views(req_id: int, limit: int, results) -> list:
    """T_RESULT_BATCH frame as a writev-style buffer list: frame header and
    batch head as one bytes object, then each 25-byte result record as
    its own buffer. The door hands the list to ``transport.writelines``;
    ``encode_result_batch`` joins it for the one-buffer form."""
    n = len(results)
    body_len = _BATCH_RES_HEAD.size + n * _BATCH_RES_ITEM.size
    parts = [_HDR.pack(1 + 8 + body_len, T_RESULT_BATCH, req_id)
             + _BATCH_RES_HEAD.pack(limit, n)]
    for r in results:
        flags = (1 if r.allowed else 0) | (2 if r.fail_open else 0)
        parts.append(_BATCH_RES_ITEM.pack(flags, r.remaining, r.retry_after,
                                          r.reset_at))
    return parts


def encode_result_batch(req_id: int, limit: int, results) -> bytes:
    return b"".join(encode_result_batch_views(req_id, limit, results))


def parse_result_batch(body: bytes):
    limit, count = _BATCH_RES_HEAD.unpack_from(body)
    off = _BATCH_RES_HEAD.size
    out = []
    for _ in range(count):
        flags, remaining, retry, reset = _BATCH_RES_ITEM.unpack_from(body, off)
        off += _BATCH_RES_ITEM.size
        out.append(Result(allowed=bool(flags & 1), limit=limit,
                          remaining=remaining, retry_after=retry,
                          reset_at=reset, fail_open=bool(flags & 2)))
    return out


def encode_result_hashed(req_id: int, res: BatchResult) -> bytes:
    """Columnar response from a BatchResult, as one bytes frame. Results
    launched with ``wire=True`` carry the device-packed buffers
    (``wire_packed``) and frame through ``encode_result_hashed_views``;
    others pack the mask here."""
    if res.wire_packed is not None:
        return b"".join(bytes(v)
                        for v in encode_result_hashed_views(req_id, res))
    b = len(res)
    flags = 2 if res.fail_open else 0
    bits = np.packbits(np.asarray(res.allowed, dtype=bool),
                       bitorder="little")
    body = (_HASHED_RES_HEAD.pack(flags, res.limit, b) + bits.tobytes()
            + np.ascontiguousarray(res.remaining, dtype="<i8").tobytes()
            + np.ascontiguousarray(res.retry_after, dtype="<f8").tobytes()
            + np.ascontiguousarray(res.reset_at, dtype="<f8").tobytes())
    return _HDR.pack(1 + 8 + len(body), T_RESULT_HASHED, req_id) + body


def encode_result_hashed_views(req_id: int, res: BatchResult) -> list:
    """T_RESULT_HASHED frame as a writev-style buffer list: header and
    allow-mask bytes in one bytes object, then the three value columns as
    memoryviews over the device-fetched ``wire_packed`` words. The single
    source of the packed framing (pad-bit masking, column offsets,
    the row-window form of ``BatchResult.rows``). Results without packed
    buffers take the one-buffer encode."""
    wp = res.wire_packed
    if wp is None:
        return [encode_result_hashed(req_id, res)]
    b = len(res)
    flags = 2 if res.fail_open else 0
    bits_arr, words, padded = wp[0], wp[1], wp[2]
    # Row-window form: frame the sub-range [off, off+b) of a coalesced
    # window's buffers. The mask is a byte slice when the frame starts
    # on a byte boundary of the window, and a re-pack of just this
    # frame's bits otherwise.
    off = wp[3] if len(wp) > 3 else 0
    nb = (b + 7) // 8
    lo = off >> 3
    if off & 7 == 0:
        bits = bytearray(bits_arr[lo:lo + nb].tobytes())
        if b & 7 and nb:
            # Zero the trailing bits of the final partial byte (pad rows
            # or the next frame's rows) so frame bytes are deterministic.
            bits[-1] &= (1 << (b & 7)) - 1
    else:
        chunk = np.asarray(bits_arr[lo:(off + b + 7) >> 3])
        rows_bits = np.unpackbits(chunk, bitorder="little")[
            off - 8 * lo:off - 8 * lo + b]
        bits = bytearray(np.packbits(rows_bits, bitorder="little").tobytes())
    body_len = _HASHED_RES_HEAD.size + nb + 24 * b
    head = (_HDR.pack(1 + 8 + body_len, T_RESULT_HASHED, req_id)
            + _HASHED_RES_HEAD.pack(flags, res.limit, b) + bytes(bits))
    return [head,
            memoryview(words[off:off + b]).cast("B"),
            memoryview(words[padded + off:padded + off + b]).cast("B"),
            memoryview(words[2 * padded + off:2 * padded + off + b])
            .cast("B")]


def parse_result_hashed(body: bytes) -> BatchResult:
    """-> BatchResult with frombuffer-view columns (client side)."""
    if len(body) < _HASHED_RES_HEAD.size:
        raise ProtocolError("short RESULT_HASHED body")
    flags, limit, count = _HASHED_RES_HEAD.unpack_from(body)
    nb = (count + 7) // 8
    off = _HASHED_RES_HEAD.size
    if len(body) != off + nb + 24 * count:
        raise ProtocolError(
            f"bad RESULT_HASHED body ({len(body)}B for count={count})")
    bits = np.frombuffer(body, dtype=np.uint8, count=nb, offset=off)
    allowed = np.unpackbits(bits, bitorder="little")[:count].astype(bool)
    off += nb
    remaining = np.frombuffer(body, dtype="<i8", count=count, offset=off)
    off += 8 * count
    retry = np.frombuffer(body, dtype="<f8", count=count, offset=off)
    off += 8 * count
    reset = np.frombuffer(body, dtype="<f8", count=count, offset=off)
    return BatchResult(allowed=allowed, limit=limit, remaining=remaining,
                       retry_after=retry, reset_at=reset,
                       fail_open=bool(flags & 2))


# --------------------------------------------- shared-memory lane hello

_SHM_HELLO_BODY = struct.Struct("<III")   # version, req_ring, rep_ring
_SHM_HELLO_R_HEAD = struct.Struct("<BII")  # ok, req_cap, rep_cap
_U16 = struct.Struct("<H")


def encode_shm_hello(req_id: int, req_ring_bytes: int = 0,
                     rep_ring_bytes: int = 0) -> bytes:
    """Request the shared-memory lane upgrade (0 = the server's default
    ring size; the server clamps to a power of two in its range)."""
    body = _SHM_HELLO_BODY.pack(1, req_ring_bytes, rep_ring_bytes)
    return _HDR.pack(1 + 8 + len(body), T_SHM_HELLO, req_id) + body


def parse_shm_hello(body: bytes):
    """-> (version, req_ring_bytes, rep_ring_bytes)."""
    if len(body) != _SHM_HELLO_BODY.size:
        raise ProtocolError("bad SHM_HELLO body")
    return _SHM_HELLO_BODY.unpack_from(body)


def encode_shm_hello_r(req_id: int, req_cap: int, rep_cap: int,
                       shm_path: str, ctrl_path: str) -> bytes:
    sp = shm_path.encode("utf-8")
    cp = ctrl_path.encode("utf-8")
    body = (_SHM_HELLO_R_HEAD.pack(1, req_cap, rep_cap)
            + _U16.pack(len(sp)) + sp + _U16.pack(len(cp)) + cp)
    return _HDR.pack(1 + 8 + len(body), T_SHM_HELLO_R, req_id) + body


def parse_shm_hello_r(body: bytes):
    """-> (req_cap, rep_cap, shm_path, ctrl_path)."""
    if len(body) < _SHM_HELLO_R_HEAD.size + 4:
        raise ProtocolError("short SHM_HELLO_R body")
    ok, req_cap, rep_cap = _SHM_HELLO_R_HEAD.unpack_from(body)
    if not ok:
        raise ProtocolError("server rejected SHM_HELLO")
    off = _SHM_HELLO_R_HEAD.size
    (sp_len,) = _U16.unpack_from(body, off)
    off += 2
    shm_path = body[off:off + sp_len].decode("utf-8")
    off += sp_len
    (cp_len,) = _U16.unpack_from(body, off)
    off += 2
    ctrl_path = body[off:off + cp_len].decode("utf-8")
    if off + cp_len != len(body):
        raise ProtocolError("bad SHM_HELLO_R body")
    return req_cap, rep_cap, shm_path, ctrl_path


# ----------------------------------------------------- policy overrides

_POLICY_SET_HEAD = struct.Struct("<BqdH")  # flags, limit, window_scale, key_len
_POLICY_R_BODY = struct.Struct("<Bqd")     # found, limit, window_scale


def encode_policy_set(req_id: int, key: str, limit=None,
                      window_scale: float = 1.0) -> bytes:
    kb = key.encode("utf-8")
    flags = 1 if limit is not None else 0
    body = _POLICY_SET_HEAD.pack(flags, limit if limit is not None else 0,
                                 float(window_scale), len(kb)) + kb
    return _HDR.pack(1 + 8 + len(body), T_POLICY_SET, req_id) + body


def parse_policy_set(body: bytes):
    """-> (key, limit | None, window_scale)."""
    flags, limit, scale, key_len = _POLICY_SET_HEAD.unpack_from(body)
    if key_len > MAX_KEY_LEN or len(body) != _POLICY_SET_HEAD.size + key_len:
        raise ProtocolError("bad POLICY_SET body")
    key = body[_POLICY_SET_HEAD.size:].decode("utf-8")
    return key, (limit if flags & 1 else None), scale


def encode_policy_key(type_: int, req_id: int, key: str) -> bytes:
    """POLICY_GET / POLICY_DEL share the RESET body shape."""
    kb = key.encode("utf-8")
    body = _KEYLEN.pack(len(kb)) + kb
    return _HDR.pack(1 + 8 + len(body), type_, req_id) + body


def encode_policy_r(req_id: int, found: bool, limit: int,
                    window_scale: float) -> bytes:
    body = _POLICY_R_BODY.pack(1 if found else 0, limit, float(window_scale))
    return _HDR.pack(1 + 8 + len(body), T_POLICY_R, req_id) + body


def parse_policy_r(body: bytes):
    """-> (found, limit, window_scale)."""
    found, limit, scale = _POLICY_R_BODY.unpack(body)
    return bool(found), limit, scale


# ------------------------------------------------- durability snapshots

_SNAPSHOT_R_BODY = struct.Struct("<QQd")  # snapshot_id, wal_seq, duration_s


def encode_snapshot_r(req_id: int, snapshot_id: int, wal_seq: int,
                      duration_s: float) -> bytes:
    body = _SNAPSHOT_R_BODY.pack(snapshot_id, wal_seq, float(duration_s))
    return _HDR.pack(1 + 8 + len(body), T_SNAPSHOT_R, req_id) + body


def parse_snapshot_r(body: bytes) -> Tuple[int, int, float]:
    """-> (snapshot_id, wal_seq, duration_s)."""
    snapshot_id, wal_seq, duration = _SNAPSHOT_R_BODY.unpack(body)
    return snapshot_id, wal_seq, duration
