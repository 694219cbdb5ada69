"""Host bulk string hashing: the C++ hasher, its build, and key packing.

A copy of ``ratelimiter_tpu/native``: ``hasher.cpp`` (the same algorithm
and ABI version, so string keys hash to the same u64 in both packages
and a sketch carried across by ``convert.py`` stays addressable), built
with g++ on first use into ``ratelimiter_tpu_torch/_build/`` (listed in
``.gitignore``) and loaded twice from one file: through ctypes
(``rl_bulk_hash_u64`` over packed bytes) and as a CPython extension
module (``hash_keylist`` over a list of str). ``fallback.py`` is its
plain NumPy twin, which the tests hold it to.

Unlike the JAX package, a failed build raises (with the compiler's
output) instead of hashing with NumPy, and the build is safe when
several processes start together: it holds a file lock, compiles to a
temporary name and renames the library into place.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import importlib.util
import os
import subprocess
import sysconfig
import threading
from typing import Sequence, Tuple

import numpy as np

DEFAULT_SEED = 0x52_4C_54_50_55_31  # "RLTPU1"

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "hasher.cpp")
_ABI = 2

_BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_loaded = None  # (ctypes library, extension module) once built and loaded


def library_path(build_dir: str) -> str:
    """The library's path in ``build_dir``, named by a digest of the
    source, the flags and the interpreter's headers and ABI tag, so an
    edited source or another Python never loads a stale build."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(sysconfig.get_paths()["include"].encode())
    digest.update(str(sysconfig.get_config_var("EXT_SUFFIX")).encode())
    with open(_SRC, "rb") as fh:
        digest.update(fh.read())
    return os.path.join(build_dir, f"_hasher-{digest.hexdigest()[:16]}.so")


def build(build_dir: str = _BUILD_DIR, cxx: str = "g++") -> str:
    """Compile ``hasher.cpp`` with ``cxx`` into ``build_dir`` unless its
    library exists there; returns the library's path. Raises
    RuntimeError, with the compiler's output, when the compiler is
    missing or fails."""
    out = library_path(build_dir)
    if os.path.exists(out):
        return out
    os.makedirs(build_dir, exist_ok=True)
    with open(os.path.join(build_dir, "hasher.lock"), "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(out):  # built by another process meanwhile
                return out
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [cxx, *CXX_FLAGS,
                   f"-I{sysconfig.get_paths()['include']}", "-o", tmp, _SRC]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=300)
            except (OSError, subprocess.TimeoutExpired) as exc:
                raise RuntimeError(
                    f"cannot build the bulk hasher with {cxx!r}: {exc}"
                ) from exc
            if proc.returncode != 0:
                if os.path.exists(tmp):
                    os.remove(tmp)
                raise RuntimeError(
                    f"{cxx} failed to build native/hasher.cpp (exit "
                    f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return out


def load(path: str):
    """``(ctypes library, extension module)`` from the built library at
    ``path``, after checking its ABI version."""
    lib = ctypes.CDLL(path)
    lib.rl_hasher_abi_version.argtypes = []
    lib.rl_hasher_abi_version.restype = ctypes.c_int64
    abi = lib.rl_hasher_abi_version()
    if abi != _ABI:
        raise RuntimeError(f"{path} has hasher ABI {abi}, expected {_ABI}")
    lib.rl_bulk_hash_u64.restype = None
    lib.rl_bulk_hash_u64.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_uint64, ctypes.c_void_p, ctypes.c_int64,
    ]
    # The same file is a CPython extension module: its init function is
    # named after the module name given here (PyInit__hasher).
    spec = importlib.util.spec_from_file_location(
        "ratelimiter_tpu_torch.native._hasher", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return lib, mod


def _native():
    """The built and loaded hasher (built on first use, once per
    process)."""
    global _loaded
    if _loaded is None:
        with _lock:
            if _loaded is None:
                _loaded = load(build())
    return _loaded


def pack_keys(keys: Sequence[str]) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pack strings into (buf uint8[], offsets int64[], byte_lengths int64[]).

    Fast path: one ``str.join`` + one encode for the whole batch, with
    per-key byte lengths taken from ``len`` — valid exactly when every key
    is ASCII, which the total-bytes check proves after the fact. Non-ASCII
    batches fall back to per-key encoding (correct, slower).
    """
    n = len(keys)
    if n == 0:
        return (np.empty(0, np.uint8), np.empty(0, np.int64),
                np.empty(0, np.int64))
    lengths = np.fromiter((len(k) for k in keys), dtype=np.int64, count=n)
    blob = "".join(keys).encode("utf-8")
    if len(blob) != int(lengths.sum()):
        # Some key is non-ASCII: char count != byte count. Re-pack exactly.
        encoded = [k.encode("utf-8") for k in keys]
        lengths = np.fromiter((len(e) for e in encoded), dtype=np.int64,
                              count=n)
        blob = b"".join(encoded)
    buf = np.frombuffer(blob, dtype=np.uint8)
    offsets = np.cumsum(lengths) - lengths
    return buf, offsets, lengths


def hash_packed(buf: np.ndarray, offsets: np.ndarray, lengths: np.ndarray,
                seed: int = DEFAULT_SEED) -> np.ndarray:
    """Hash a packed batch with the C++ hasher (``rl_bulk_hash_u64``)."""
    lib, _ = _native()
    n = offsets.shape[0]
    out = np.empty(n, dtype=np.uint64)
    if n:
        buf = np.ascontiguousarray(buf, dtype=np.uint8)
        offsets = np.ascontiguousarray(offsets, dtype=np.int64)
        lengths = np.ascontiguousarray(lengths, dtype=np.int64)
        if int((offsets + lengths).max()) > buf.shape[0] or (
                int(offsets.min()) < 0 or int(lengths.min()) < 0):
            raise ValueError("packed keys reach outside the buffer")
        lib.rl_bulk_hash_u64(
            buf.ctypes.data, offsets.ctypes.data, lengths.ctypes.data,
            ctypes.c_uint64(seed & 0xFFFFFFFFFFFFFFFF),
            out.ctypes.data, ctypes.c_int64(n))
    return out


def bulk_hash_u64(keys: Sequence[str], seed: int = DEFAULT_SEED) -> np.ndarray:
    """Hash a batch of string keys to uint64: the extension iterates the
    list directly (UTF-8 views, no Python-level packing)."""
    _, mod = _native()
    if not isinstance(keys, list):
        keys = list(keys)
    out = np.empty(len(keys), dtype=np.uint64)
    mod.hash_keylist(keys, seed & 0xFFFFFFFFFFFFFFFF, out.ctypes.data)
    return out
