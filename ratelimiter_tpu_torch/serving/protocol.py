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
    DCN_PUSH      (6): u8 kind, then slabs, a debt delta or lease gossip
                       (the DCN section below), optionally in the RLA2
                       envelope; answered OK, or ERROR on a server that
                       takes no pushes
    POLICY_SET    (7): u8 flags (bit0 limit given), i64 limit,
                       f64 window_scale, u16 key_len, key utf-8
    POLICY_GET    (8): u16 key_len, key utf-8
    POLICY_DEL    (9): u16 key_len, key utf-8
    SNAPSHOT     (10): -
    LEASE_GRANT  (13): u64 client, u32 want, f64 ttl_want, u16 key_len,
                       key utf-8
    LEASE_RENEW  (14): u64 client, u64 lease, u64 consumed, u32 want,
                       u16 key_len, key utf-8
    LEASE_RETURN (15): u64 client, u64 lease, u64 consumed, u16 key_len,
                       key utf-8
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
    LEASE_R       (138): u8 granted, u64 lease, i64 budget (tokens this
                         answer adds), f64 ttl_s, i64 limit, u64 epoch
    LEASE_REVOKE  (139): req_id 0; u8 reason, u64 epoch, u32 count, then
                         count x u64 lease ids (none: every lease the
                         connection holds)
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
first). ``split_request`` strips both. The fleet's forward hint (0x10,
``with_forward``; ``split_forward`` strips it) marks a peer's coalesced
forward window: it changes no body byte and only steers batching.

Fleet control frames: FLEET_MAP (12, empty body) answers FLEET_MAP_R
(137: u32 len + the ownership map as JSON); a server that is not a fleet
member answers E_INVALID_CONFIG. A member that does not own a frame's
rows and does not forward answers E_NOT_OWNER (``format_not_owner``).
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
    NotOwnerError,
    RateLimiterError,
    StorageUnavailableError,
)
from ratelimiter_tpu_torch.core.types import BatchResult, Result

MAX_FRAME = 1 << 20
#: DCN pushes carry whole slabs or debt deltas (d x w counters), so they
#: get their own, larger bound, on a server that takes them alone.
MAX_DCN_FRAME = 96 << 20
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
#: Fleet ownership map fetch: empty body, answered T_FLEET_MAP_R.
T_FLEET_MAP = 12
#: Client-embedded quota leases: GRANT, RENEW and RETURN all answer
#: LEASE_R. 13..15 are the last base-type slots below the forward bit.
T_LEASE_GRANT = 13
T_LEASE_RENEW = 14
T_LEASE_RETURN = 15
#: Cross-pod DCN push (parallel/dcn.py payloads; serving/dcn_peer.py).
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
T_FLEET_MAP_R = 137
#: Answer to every T_LEASE_* request.
T_LEASE_R = 138
#: Unsolicited lease revocation push, sent with req_id 0 on the
#: connection that granted: clients of a lease-bearing connection
#: consume rid-0 frames before request/response correlation.
T_LEASE_REVOKE = 139
T_SHM_HELLO_R = 141
T_ERROR = 255

# DCN payload kinds (the first body byte of a T_DCN_PUSH).
DCN_KIND_SLABS = 1   # windowed: completed sub-window slabs
DCN_KIND_DEBT = 2    # token bucket: accumulated debt delta
#: Fleet announce/heartbeat: u32 len + a JSON payload.
DCN_KIND_FLEET = 3
#: Lease revocation gossip: u32 len + a JSON payload.
DCN_KIND_LEASE = 4

#: The fleet's forward hint on a request type byte: the frame is a
#: peer's coalesced forward window. The doors dispatch such windows
#: apart from client frames, because a client window may itself wait on
#: forward legs to the peer, and coalescing the two would chain each
#: reply to windows formed later. It changes no body byte.
FORWARD_FLAG = 0x10

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
#: Fleet typed redirect: the answering server does not own the frame's
#: hash buckets under its ownership epoch and does not forward. The
#: message is ``parse_not_owner``-parseable (owner address and epoch).
E_NOT_OWNER = 9


def code_for(exc: Exception) -> int:
    if isinstance(exc, NotOwnerError):
        return E_NOT_OWNER
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
    E_NOT_OWNER: NotOwnerError,
}


def exception_for(code: int, msg: str) -> Exception:
    """The library's exception for a wire error code (the client raises
    what a local limiter would)."""
    if code == E_NOT_OWNER:
        info = parse_not_owner(msg) or {}
        return NotOwnerError(msg, owner=info.get("owner", ""),
                             epoch=info.get("epoch", 0))
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


def parse_header(buf: bytes, *, allow_dcn: bool = False
                 ) -> Tuple[int, int, int]:
    """(payload_length, type, req_id) from the 13 header bytes.

    ``allow_dcn`` raises the cap to ``MAX_DCN_FRAME`` for a DCN push
    (keyed on the base type, so a traced or deadlined push keeps it):
    only a server that takes pushes passes it, so that no client of a
    plain one can make it buffer slab-sized frames."""
    length, type_, req_id = _HDR.unpack_from(buf)
    base = (type_ & ~(_REQ_FLAGS | FORWARD_FLAG) if type_ < 128
            else type_)
    cap = MAX_DCN_FRAME if (allow_dcn and base == T_DCN_PUSH) else MAX_FRAME
    if length < 9 or length > cap:
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


def with_forward(frame: bytes) -> bytes:
    """Mark a request frame as a fleet forward window (no body change).
    Apply last, after ``with_deadline``/``with_trace``."""
    length, type_, req_id = _HDR.unpack_from(frame)
    if type_ & FORWARD_FLAG or type_ >= 128:
        raise ProtocolError(f"type {type_} cannot carry the forward hint")
    return (_HDR.pack(length, type_ | FORWARD_FLAG, req_id)
            + frame[HEADER_SIZE:])


def split_forward(type_: int):
    """(base_type, is_forward): strips the forward bit. Call after
    ``split_request``. T_SHM_HELLO (16, the bit over base type 0) is
    exempt: the doors match it on the raw byte first."""
    if type_ != T_SHM_HELLO and type_ < 128 and type_ & FORWARD_FLAG:
        return type_ & ~FORWARD_FLAG, True
    return type_, False


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


_BATCH_RES_REC = np.dtype([("flags", "u1"), ("remaining", "<i8"),
                           ("retry", "<f8"), ("reset", "<f8")])


def parse_result_batch_columnar(body: bytes) -> BatchResult:
    """RESULT_BATCH as a columnar BatchResult: one structured
    ``np.frombuffer`` over the packed 25-byte rows (the fleet
    forwarder's string legs merge through numpy)."""
    limit, count = _BATCH_RES_HEAD.unpack_from(body)
    if len(body) != _BATCH_RES_HEAD.size + count * _BATCH_RES_ITEM.size:
        raise ProtocolError(
            f"bad RESULT_BATCH body ({len(body)}B for count={count})")
    rec = np.frombuffer(body, dtype=_BATCH_RES_REC, count=count,
                        offset=_BATCH_RES_HEAD.size)
    flags = rec["flags"]
    return BatchResult(allowed=(flags & 1).astype(bool), limit=limit,
                       remaining=rec["remaining"],
                       retry_after=rec["retry"], reset_at=rec["reset"],
                       fail_open=bool((flags & 2).any()))


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


# ----------------------------------------------------- quota leases
#
# GRANT debits the requested budget from the key's live window UPFRONT
# (through the server's normal decide path), so the global bound holds
# no matter what the client does with the tokens afterwards. RENEW
# reports local consumption (for the audit mirror) and asks for a
# top-up; RETURN reports the final count and releases the grant,
# WITHOUT re-crediting unused budget (the window already charged it;
# failing toward false denies is the documented side).

_LEASE_GRANT_HEAD = struct.Struct("<QIdH")   # client, want, ttl_want, key_len
_LEASE_RENEW_HEAD = struct.Struct("<QQQIH")  # client, lease, consumed, want, key_len
_LEASE_RETURN_HEAD = struct.Struct("<QQQH")  # client, lease, consumed, key_len
_LEASE_R_BODY = struct.Struct("<BQqdqQ")     # flags, lease, budget, ttl, limit, epoch
_LEASE_REVOKE_HEAD = struct.Struct("<BQI")   # reason, epoch, count (then count u64)

#: Revocation reasons (wire u8 + journal/metrics label).
LEASE_REV_POLICY = 1      # per-key override set/deleted
LEASE_REV_LIMIT = 2       # update_limit / update_window
LEASE_REV_CONTROLLER = 3  # AIMD tighten on the key's scope
LEASE_REV_EPOCH = 4       # fleet ownership moved
LEASE_REV_SHUTDOWN = 5    # graceful server shutdown
LEASE_REV_MANUAL = 6      # operator drill (and a reset)
LEASE_REASONS = {LEASE_REV_POLICY: "policy", LEASE_REV_LIMIT: "limit",
                 LEASE_REV_CONTROLLER: "controller",
                 LEASE_REV_EPOCH: "epoch", LEASE_REV_SHUTDOWN: "shutdown",
                 LEASE_REV_MANUAL: "manual"}


def encode_lease_grant(req_id: int, client_id: int, key: str, want: int,
                       ttl_want: float = 0.0) -> bytes:
    kb = key.encode("utf-8")
    body = _LEASE_GRANT_HEAD.pack(client_id, want, float(ttl_want),
                                  len(kb)) + kb
    return _HDR.pack(1 + 8 + len(body), T_LEASE_GRANT, req_id) + body


def parse_lease_grant(body: bytes):
    """-> (client_id, key, want, ttl_want)."""
    client, want, ttl_want, key_len = _LEASE_GRANT_HEAD.unpack_from(body)
    if key_len > MAX_KEY_LEN or len(body) != _LEASE_GRANT_HEAD.size + key_len:
        raise ProtocolError("bad LEASE_GRANT body")
    return client, body[_LEASE_GRANT_HEAD.size:].decode("utf-8"), want, ttl_want


def encode_lease_renew(req_id: int, client_id: int, lease_id: int, key: str,
                       consumed: int, want: int) -> bytes:
    kb = key.encode("utf-8")
    body = _LEASE_RENEW_HEAD.pack(client_id, lease_id, consumed, want,
                                  len(kb)) + kb
    return _HDR.pack(1 + 8 + len(body), T_LEASE_RENEW, req_id) + body


def parse_lease_renew(body: bytes):
    """-> (client_id, lease_id, key, consumed, want)."""
    client, lease, consumed, want, key_len = _LEASE_RENEW_HEAD.unpack_from(body)
    if key_len > MAX_KEY_LEN or len(body) != _LEASE_RENEW_HEAD.size + key_len:
        raise ProtocolError("bad LEASE_RENEW body")
    return (client, lease, body[_LEASE_RENEW_HEAD.size:].decode("utf-8"),
            consumed, want)


def encode_lease_return(req_id: int, client_id: int, lease_id: int, key: str,
                        consumed: int) -> bytes:
    kb = key.encode("utf-8")
    body = _LEASE_RETURN_HEAD.pack(client_id, lease_id, consumed, len(kb)) + kb
    return _HDR.pack(1 + 8 + len(body), T_LEASE_RETURN, req_id) + body


def parse_lease_return(body: bytes):
    """-> (client_id, lease_id, key, consumed)."""
    client, lease, consumed, key_len = _LEASE_RETURN_HEAD.unpack_from(body)
    if key_len > MAX_KEY_LEN or len(body) != _LEASE_RETURN_HEAD.size + key_len:
        raise ProtocolError("bad LEASE_RETURN body")
    return (client, lease, body[_LEASE_RETURN_HEAD.size:].decode("utf-8"),
            consumed)


def encode_lease_r(req_id: int, granted: bool, lease_id: int, budget: int,
                   ttl_s: float, limit: int, epoch: int = 0) -> bytes:
    """``budget`` is the number of tokens ADDED by this answer (initial
    grant or renew top-up): the client adds it to its local counter.
    ``granted`` False means lease refused / released; the client serves
    the key from the wire path."""
    body = _LEASE_R_BODY.pack(1 if granted else 0, lease_id, budget,
                              float(ttl_s), limit, epoch)
    return _HDR.pack(1 + 8 + len(body), T_LEASE_R, req_id) + body


def parse_lease_r(body: bytes):
    """-> (granted, lease_id, budget, ttl_s, limit, epoch)."""
    flags, lease, budget, ttl_s, limit, epoch = _LEASE_R_BODY.unpack(body)
    return bool(flags & 1), lease, budget, ttl_s, limit, epoch


def encode_lease_revoke(reason: int, epoch: int, lease_ids) -> bytes:
    """Unsolicited push (req_id=0). An EMPTY id list revokes every lease
    the receiving client holds from this server (the revoke-all form)."""
    ids = list(lease_ids)
    body = _LEASE_REVOKE_HEAD.pack(reason, epoch, len(ids))
    body += b"".join(_TRACE_ID.pack(i) for i in ids)
    return _HDR.pack(1 + 8 + len(body), T_LEASE_REVOKE, 0) + body


def parse_lease_revoke(body: bytes):
    """-> (reason, epoch, [lease_id, ...])."""
    reason, epoch, count = _LEASE_REVOKE_HEAD.unpack_from(body)
    need = _LEASE_REVOKE_HEAD.size + 8 * count
    if len(body) != need:
        raise ProtocolError("bad LEASE_REVOKE body")
    ids = [_TRACE_ID.unpack_from(body, _LEASE_REVOKE_HEAD.size + 8 * i)[0]
           for i in range(count)]
    return reason, epoch, ids


# ------------------------------------------------------------ DCN frames
#
# T_DCN_PUSH body:
#   u8 kind
#   kind=DCN_KIND_SLABS: s64 sub_us | u32 count | s64 periods[count] |
#                        count * d*w int32 slabs (C order)
#   kind=DCN_KIND_DEBT:  d*w int64 delta (C order)
#   kind=DCN_KIND_LEASE: u32 len | JSON
# The receiver checks the payload's size against its own (d, w) and, for
# slabs, the sub-window length (periods count sub-windows); a mismatch
# is refused, never reshaped.
#
# Authentication (a push adds counter mass, so an open port taking them
# is a lever for targeted denies): with a shared secret the body is
# wrapped as
#   RLA2: b"RLA2" | HMAC-SHA256(secret, sender||seq||body) | u64 sender |
#         u64 seq | body
# and the receiver refuses a stale or repeated (sender, seq)
# (DcnReplayGuard). The legacy RLA1 form (b"RLA1" | HMAC(body) | body)
# has no sequence: a server without a secret accepts every form, one
# with a secret only a valid RLA2.

_DCN_HEAD = struct.Struct("<B")
_S64 = struct.Struct("<q")
DCN_AUTH_MAGIC = b"RLA1"
DCN_AUTH_MAGIC2 = b"RLA2"
_DCN_TAG_LEN = 32
_DCN_SEQ = struct.Struct("<QQ")   # sender id, sequence


class DcnReplayGuard:
    """Per-sender monotonic-sequence filter for RLA2 pushes.

    A sender's sequence tracks wall-clock microseconds (DcnPusher), so a
    first frame from an unknown sender older than ``max_age_s`` is
    refused too, which bounds the replay of a dead sender's captured
    stream to that window. Thread-safe. Without a secret anyone can mint
    sender ids, so it then only drops accidental re-deliveries."""

    #: The sender table's bound: past it the sender with the lowest
    #: sequence is dropped.
    MAX_SENDERS = 4096

    def __init__(self, max_age_s: float = 300.0, time_fn=None):
        import threading
        import time as _time

        self.max_age_s = float(max_age_s)
        self._time = time_fn if time_fn is not None else _time.time
        self._last: dict = {}
        self._lock = threading.Lock()
        self.rejected = 0

    def check(self, sender: int, seq: int) -> None:
        """Record (sender, seq); raises InvalidConfigError on a stale or
        repeated sequence."""
        with self._lock:
            last = self._last.get(sender)
            if last is None:
                floor = int((self._time() - self.max_age_s) * 1e6)
                if seq < floor:
                    self.rejected += 1
                    raise InvalidConfigError(
                        f"stale DCN push rejected (sender seq {seq} is "
                        f"older than the {self.max_age_s:g}s replay window)")
            elif seq <= last:
                self.rejected += 1
                raise InvalidConfigError(
                    f"replayed DCN push rejected (seq {seq} <= last "
                    f"accepted {last} for this sender)")
            self._last[sender] = seq
            if len(self._last) > self.MAX_SENDERS:
                self._last.pop(min(self._last, key=self._last.get))


def wrap_dcn_auth(frame: bytes, secret: str, *, sender=None,
                  seq=None) -> bytes:
    """Re-frame a DCN push with the HMAC envelope on its body: RLA2 when
    ``sender`` and ``seq`` are given (what DcnPusher sends), else RLA1."""
    import hashlib
    import hmac as _hmac

    _length, type_, req_id = _HDR.unpack_from(frame)
    body = frame[HEADER_SIZE:]
    if sender is not None:
        sb = _DCN_SEQ.pack(sender, seq)
        tag = _hmac.new(secret.encode(), sb + body, hashlib.sha256).digest()
        body = DCN_AUTH_MAGIC2 + tag + sb + body
    else:
        tag = _hmac.new(secret.encode(), body, hashlib.sha256).digest()
        body = DCN_AUTH_MAGIC + tag + body
    return _HDR.pack(1 + 8 + len(body), type_, req_id) + body


def unwrap_dcn_auth(body: bytes, secret, guard=None) -> bytes:
    """The push body inside its envelope, checked against the receiver's
    ``secret`` (None: every form passes) and ``guard``. Raises
    InvalidConfigError on a missing or bad tag where a secret is
    required, and on a stale or repeated sequence."""
    if body[:4] == DCN_AUTH_MAGIC2:
        head = 4 + _DCN_TAG_LEN + _DCN_SEQ.size
        if len(body) < head:
            raise ProtocolError("truncated DCN auth envelope")
        tag = body[4:4 + _DCN_TAG_LEN]
        signed = body[4 + _DCN_TAG_LEN:]
        sender, seq = _DCN_SEQ.unpack_from(signed)
        if secret is not None:
            import hashlib
            import hmac as _hmac

            want = _hmac.new(secret.encode(), signed, hashlib.sha256).digest()
            if not _hmac.compare_digest(tag, want):
                raise InvalidConfigError("DCN push auth tag mismatch")
        # After the tag: a forged frame must not move a real sender's
        # watermark.
        if guard is not None:
            guard.check(sender, seq)
        return body[head:]
    if body[:4] == DCN_AUTH_MAGIC:
        if len(body) < 4 + _DCN_TAG_LEN:
            raise ProtocolError("truncated DCN auth envelope")
        if secret is not None:
            raise InvalidConfigError(
                "legacy unsequenced DCN envelope (RLA1) rejected: this "
                "server requires replay-protected pushes (RLA2)")
        return body[4 + _DCN_TAG_LEN:]
    if secret is not None:
        raise InvalidConfigError(
            "unauthenticated DCN push rejected (this server requires "
            "--dcn-secret)")
    return body


def _dcn_frame(req_id: int, body: bytes, secret, sender, seq) -> bytes:
    frame = _HDR.pack(1 + 8 + len(body), T_DCN_PUSH, req_id) + body
    return (wrap_dcn_auth(frame, secret, sender=sender, seq=seq)
            if secret is not None else frame)


def encode_dcn_slabs(req_id: int, periods, slabs, sub_us: int,
                     secret=None, *, sender=None, seq=None) -> bytes:
    """periods int64[k] in sub-window units, slabs int32[k, d, w]
    (``parallel.dcn.export_completed``'s)."""
    k = int(periods.shape[0])
    body = (_DCN_HEAD.pack(DCN_KIND_SLABS) + _S64.pack(sub_us)
            + _U32.pack(k)
            + np.ascontiguousarray(periods, dtype=np.int64).tobytes()
            + np.ascontiguousarray(slabs, dtype=np.int32).tobytes())
    return _dcn_frame(req_id, body, secret, sender, seq)


def encode_dcn_debt(req_id: int, delta, secret=None, *, sender=None,
                    seq=None) -> bytes:
    """delta int64[d, w] (``parallel.dcn.export_debt``'s)."""
    body = (_DCN_HEAD.pack(DCN_KIND_DEBT)
            + np.ascontiguousarray(delta, dtype=np.int64).tobytes())
    return _dcn_frame(req_id, body, secret, sender, seq)


def encode_dcn_lease(req_id: int, payload: dict, secret=None, *,
                     sender=None, seq=None) -> bytes:
    """Lease revocation gossip: a JSON payload ({"scope": "key"|"all",
    "key_hash": ..., "reason": ..., "epoch": ...}) in the same envelope
    as the slabs."""
    import json

    jb = json.dumps(payload, separators=(",", ":")).encode("utf-8")
    body = _DCN_HEAD.pack(DCN_KIND_LEASE) + _U32.pack(len(jb)) + jb
    return _dcn_frame(req_id, body, secret, sender, seq)


def parse_dcn_lease(payload: bytes) -> dict:
    """The JSON payload of a lease gossip body (after its kind byte)."""
    import json

    if len(payload) < 4:
        raise ProtocolError("short lease revocation body")
    (n,) = _U32.unpack_from(payload)
    if len(payload) != 4 + n:
        raise ProtocolError("bad lease revocation body")
    return json.loads(payload[4:4 + n].decode("utf-8"))


# ------------------------------------------------------- fleet frames
#
# Fleet control payloads are JSON: the map is small and changes rarely.
# Decision traffic never rides these frames.

def format_not_owner(bucket: int, owner: str, epoch: int,
                     buckets: int) -> str:
    """The E_NOT_OWNER message: ``k=v`` tokens a client re-routes on.
    ``owner`` is ``host:port`` or ``id@host:port``."""
    return (f"not owner: bucket={bucket} owner={owner} "
            f"epoch={epoch} buckets={buckets}")


def parse_not_owner(msg: str):
    """-> {"bucket", "owner", "epoch", "buckets"}, or None when the
    message does not carry the redirect."""
    if not msg.startswith("not owner:"):
        return None
    out = {}
    for tok in msg.split():
        if "=" not in tok:
            continue
        k, _, v = tok.partition("=")
        if k in ("bucket", "epoch", "buckets"):
            try:
                out[k] = int(v)
            except ValueError:
                return None
        elif k == "owner":
            out[k] = v
    if "owner" not in out or "epoch" not in out:
        return None
    return out


def encode_fleet_map(req_id: int) -> bytes:
    return encode_simple(T_FLEET_MAP, req_id)


def encode_fleet_map_r(req_id: int, payload: dict) -> bytes:
    import json

    jb = json.dumps(payload, separators=(",", ":")).encode("utf-8")
    body = _U32.pack(len(jb)) + jb
    return _HDR.pack(1 + 8 + len(body), T_FLEET_MAP_R, req_id) + body


def parse_fleet_map_r(body: bytes) -> dict:
    import json

    (n,) = _U32.unpack_from(body)
    return json.loads(body[_U32.size:_U32.size + n].decode("utf-8"))


def encode_dcn_fleet(req_id: int, payload: dict, secret=None, *,
                     sender=None, seq=None) -> bytes:
    """Fleet announce/heartbeat: a DCN push of kind DCN_KIND_FLEET with
    a JSON body, in the RLA2 envelope when a secret is held."""
    import json

    jb = json.dumps(payload, separators=(",", ":")).encode("utf-8")
    body = _DCN_HEAD.pack(DCN_KIND_FLEET) + _U32.pack(len(jb)) + jb
    return _dcn_frame(req_id, body, secret, sender, seq)


def parse_dcn_fleet(payload: bytes) -> dict:
    """The JSON payload of a fleet announce body (after its kind
    byte)."""
    import json

    if len(payload) < 4:
        raise ProtocolError("short fleet announce body")
    (n,) = _U32.unpack_from(payload)
    if len(payload) != 4 + n:
        raise ProtocolError("bad fleet announce body")
    return json.loads(payload[4:4 + n].decode("utf-8"))


def parse_dcn(body: bytes, d: int, w: int, sub_us: int):
    """-> (DCN_KIND_SLABS, periods int64[k], slabs int32[k, d, w]) or
    (DCN_KIND_DEBT, delta int64[d, w], None), checked against the
    receiver's geometry (and, for slabs, its sub-window length)."""
    if len(body) < 1:
        raise ProtocolError("empty DCN body")
    (kind,) = _DCN_HEAD.unpack_from(body)
    payload = body[1:]
    if kind == DCN_KIND_SLABS:
        if len(payload) < 12:
            raise ProtocolError("short DCN slabs body")
        (peer_sub,) = _S64.unpack_from(payload)
        if peer_sub != sub_us:
            raise InvalidConfigError(
                f"DCN peer sub-window {peer_sub}us != local {sub_us}us "
                "(window mismatch or mid-migration) — periods would "
                "merge into the wrong sub-windows")
        (k,) = _U32.unpack_from(payload, 8)
        want = 12 + k * 8 + k * d * w * 4
        if len(payload) != want:
            raise ProtocolError(
                f"DCN slabs payload {len(payload)}B != {want}B for "
                f"k={k} d={d} w={w} (geometry mismatch?)")
        periods = np.frombuffer(payload, dtype=np.int64, count=k, offset=12)
        slabs = np.frombuffer(payload, dtype=np.int32,
                              offset=12 + k * 8).reshape(k, d, w)
        return kind, periods, slabs
    if kind == DCN_KIND_DEBT:
        want = d * w * 8
        if len(payload) != want:
            raise ProtocolError(
                f"DCN debt payload {len(payload)}B != {want}B for "
                f"d={d} w={w} (geometry mismatch?)")
        return kind, np.frombuffer(payload, dtype=np.int64).reshape(d, w), None
    raise ProtocolError(f"unknown DCN kind {kind}")
