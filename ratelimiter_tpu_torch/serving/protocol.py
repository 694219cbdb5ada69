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
    ALLOW_HASHED (11): u32 count | u64 ids[count] | u32 ns[count] — raw
                       u64 ids, splitmix64 and the (h1, h2) split run on
                       the device

Responses:
    RESULT        (129): u8 flags (bit0 allowed, bit1 fail_open), i64 limit,
                         i64 remaining, f64 retry_after, f64 reset_at
    OK            (130): -
    HEALTH        (131): u8 status, f64 uptime_s, u64 decisions_total
    METRICS_R     (132): u32 len, Prometheus text utf-8
    RESULT_BATCH  (133): i64 limit (the DEFAULT limit), u32 count, then
                         count x {u8 flags, i64 remaining, f64 retry,
                         f64 reset}
    RESULT_HASHED (136): u8 batch_flags (bit1 fail_open), i64 limit,
                         u32 count, u8 allowed_bits[ceil(count/8)]
                         (little-endian bit order), then COLUMNAR
                         i64 remaining | f64 retry | f64 reset
    ERROR         (255): u16 code, u16 msg_len, msg utf-8

The JAX package's request-type flag bits (trace 0x40, deadline 0x20,
forward 0x10) are not served: ``REQUEST_FLAGS`` names them so the server
can refuse such frames with E_INVALID_CONFIG.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

from ratelimiter_tpu_torch.core.errors import (
    ClosedError,
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
T_ALLOW_HASHED = 11

T_RESULT = 129
T_OK = 130
T_HEALTH_R = 131
T_METRICS_R = 132
T_RESULT_BATCH = 133
T_RESULT_HASHED = 136
T_ERROR = 255

#: Request-type extension bits of the JAX package's protocol (trace,
#: deadline, forward hint); this server refuses frames carrying them.
REQUEST_FLAGS = 0x40 | 0x20 | 0x10

E_INVALID_N = 1
E_INVALID_KEY = 2
E_STORAGE_UNAVAILABLE = 3
E_CLOSED = 4
E_INVALID_CONFIG = 5
E_INTERNAL = 7


def code_for(exc: Exception) -> int:
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
