"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each ``csrc/*.cu`` source compiles on first use into
``ratelimiter_tpu_torch/_build/`` (listed in ``.gitignore``) as a shared
library with a plain C interface, named by a digest of its source, the
``csrc/*.cuh`` headers and the flags, so an edited source or header never
loads a stale build. The build writes to
a temporary name and renames it into place, so concurrent processes that
race to build the same source all load a complete file. Nothing is built
when a module is imported: the first CUDA launch, or ``build_all``,
triggers it.

Flags: ``sm_90a`` (Hopper), ``-O3``, and ``-fmad=false`` so that nvcc
contracts no multiply-add the sources do not spell out (the kernels spell
the one FMA the reference rounds with, see csrc/sketch_kernels.cu); and
``-Xptxas -v``, whose report of each kernel's registers, stack frame and
spills is kept beside the library (``ptxas_report``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit PyTorch's extension builder finds."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the port's CUDA kernels")


def _lib_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for f in [name + ".cu", *headers]:
        with open(os.path.join(CSRC, f), "rb") as fh:
            digest.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def compile_source(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its build exists; returns the
    library path. Raises with nvcc's output when the build fails."""
    out = _lib_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC, name + ".cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}"
                           f"{proc.stderr}")
    with open(tmp + ".ptxas", "w") as fh:
        fh.write(proc.stdout + proc.stderr)
    os.replace(tmp + ".ptxas", out + ".ptxas")
    os.replace(tmp, out)
    return out


def ptxas_report(name: str) -> Dict[str, dict]:
    """{mangled kernel name: {"registers", "stack_frame", "spill_stores",
    "spill_loads"}} from the build of ``csrc/<name>.cu`` (built first if
    needed), as ``ptxas -v`` reported them."""
    import re

    with open(compile_source(name) + ".ptxas") as fh:
        text = fh.read()
    out: Dict[str, dict] = {}
    current = None
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            current = out.setdefault(m.group(1), {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and current is not None:
            current.update(stack_frame=int(m.group(1)),
                           spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and current is not None:
            current["registers"] = int(m.group(1))
    return out


def build_all(names: Iterable[str]) -> None:
    """Compile several sources at once, one nvcc process each."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        for fut in [pool.submit(compile_source, n) for n in names]:
            fut.result()


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if
    needed (once per process)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(compile_source(name))
            _libs[name] = lib
    return lib
