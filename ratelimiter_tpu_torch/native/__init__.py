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

The native front door (``server.cpp`` with ``shm_ring.h``, the port's
copy of the JAX package's door; serving/native_server.py bridges it) is
built the same way by ``build_server`` and loaded by ``load_server``;
here too a failed build raises with the compiler's output, where the
JAX loader returns None.
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
_SERVER_SRC = os.path.join(_DIR, "server.cpp")
_SERVER_HEADERS = (os.path.join(_DIR, "shm_ring.h"),)
_LOADGEN_SRC = os.path.join(_DIR, "loadgen.cpp")
_LOADGEN_HEADERS = (*_SERVER_HEADERS,
                    os.path.join(_DIR, "ratelimiter_client.hpp"))
#: The port's door ABI (``rl_server_abi_version`` in server.cpp).
SERVER_ABI = 1

_BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_loaded = None  # (ctypes library, extension module) once built and loaded
_server = None  # the door's extension module once built and loaded


def _library_path(build_dir: str, stem: str, sources,
                  suffix: str = ".so") -> str:
    """``build_dir/<stem>-<digest><suffix>``, the digest over the flags,
    the interpreter's headers and ABI tag and every file in ``sources``,
    so an edited source or another Python never loads a stale build."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(sysconfig.get_paths()["include"].encode())
    digest.update(str(sysconfig.get_config_var("EXT_SUFFIX")).encode())
    for src in sources:
        with open(src, "rb") as fh:
            digest.update(fh.read())
    return os.path.join(build_dir,
                        f"{stem}-{digest.hexdigest()[:16]}{suffix}")


def library_path(build_dir: str) -> str:
    """The hasher library's path in ``build_dir``."""
    return _library_path(build_dir, "_hasher", (_SRC,))


def _compile(src: str, out: str, lock_name: str, what: str,
             cxx: str, flags=None) -> str:
    """Compile ``src`` with ``cxx`` into ``out`` unless it exists there,
    under the file lock ``lock_name`` beside it (with ``flags``, the
    shared-library flags with the interpreter's headers when None);
    returns ``out``. Raises
    RuntimeError, with the compiler's output, when the compiler is
    missing or fails."""
    if os.path.exists(out):
        return out
    build_dir = os.path.dirname(out)
    os.makedirs(build_dir, exist_ok=True)
    with open(os.path.join(build_dir, lock_name), "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(out):  # built by another process meanwhile
                return out
            tmp = f"{out}.{os.getpid()}.tmp"
            if flags is None:
                flags = (*CXX_FLAGS,
                         f"-I{sysconfig.get_paths()['include']}")
            cmd = [cxx, *flags, "-o", tmp, src]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=300)
            except (OSError, subprocess.TimeoutExpired) as exc:
                raise RuntimeError(
                    f"cannot build the {what} with {cxx!r}: {exc}"
                ) from exc
            if proc.returncode != 0:
                if os.path.exists(tmp):
                    os.remove(tmp)
                raise RuntimeError(
                    f"{cxx} failed to build native/{os.path.basename(src)} "
                    f"(exit {proc.returncode}):\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return out


def build(build_dir: str = _BUILD_DIR, cxx: str = "g++") -> str:
    """Compile ``hasher.cpp`` with ``cxx`` into ``build_dir`` unless its
    library exists there; returns the library's path. Raises
    RuntimeError, with the compiler's output, when the compiler is
    missing or fails."""
    return _compile(_SRC, library_path(build_dir), "hasher.lock",
                    "bulk hasher", cxx)


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


def server_library_path(build_dir: str) -> str:
    """The native door's library path in ``build_dir`` (its digest covers
    ``server.cpp`` and ``shm_ring.h``)."""
    return _library_path(build_dir, "_server",
                         (_SERVER_SRC, *_SERVER_HEADERS))


def build_server(build_dir: str = _BUILD_DIR, cxx: str = "g++") -> str:
    """Compile the native door (``server.cpp``) with ``cxx`` into
    ``build_dir`` unless its library exists there; returns its path.
    Raises RuntimeError, with the compiler's output, when the compiler
    is missing or fails: the door never falls back to the asyncio one."""
    return _compile(_SERVER_SRC, server_library_path(build_dir),
                    "server.lock", "native front door", cxx)


def load_server_library(path: str):
    """The door's extension module from the built library at ``path``,
    after checking its ABI (``SERVER_ABI``)."""
    lib = ctypes.CDLL(path)
    lib.rl_server_abi_version.argtypes = []
    lib.rl_server_abi_version.restype = ctypes.c_int64
    abi = lib.rl_server_abi_version()
    if abi != SERVER_ABI:
        raise RuntimeError(f"{path} has server ABI {abi}, expected "
                           f"{SERVER_ABI}")
    spec = importlib.util.spec_from_file_location(
        "ratelimiter_tpu_torch.native._server", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_server():
    """The native door's extension module, built on first use (once per
    process)."""
    global _server
    if _server is None:
        with _lock:
            if _server is None:
                _server = load_server_library(build_server())
    return _server


def build_loadgen(build_dir: str = _BUILD_DIR, cxx: str = "g++") -> str:
    """Compile the C++ load generator (``loadgen.cpp``: N threads, one
    connection each, pipelined frames over TCP, a unix socket or the
    shared-memory lane; one JSON line of decisions/s and RTT
    percentiles) into ``build_dir`` unless it is there; returns the
    executable's path. Raises RuntimeError with the compiler's output."""
    out = _library_path(build_dir, "rltpu_loadgen",
                        (_LOADGEN_SRC, *_LOADGEN_HEADERS), suffix="")
    return _compile(_LOADGEN_SRC, out, "loadgen.lock", "load generator",
                    cxx, flags=("-O2", "-std=c++17", "-pthread"))
