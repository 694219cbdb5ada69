"""The port's C++ bulk hasher (ratelimiter_tpu_torch/native) against its
NumPy twin (native/fallback.py) and the JAX package's hasher.

The library is built here with g++, as on first use. Seeded ASCII,
non-ASCII, empty and long keys go through both entry points (the packed
buffer through ctypes and the list through the extension module) and must
hash bit-identically (tolerance 0). Also: two processes building at once
into one directory, the raise (with the compiler's output) when the
compiler is missing or fails, and the ABI check.
"""

from __future__ import annotations

import functools
import os
import subprocess
import sys

import numpy as np
import pytest

from ratelimiter_tpu import native as jax_native
from ratelimiter_tpu_torch import native
from ratelimiter_tpu_torch.native.fallback import hash_packed_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _keys(seed: int):
    rng = np.random.default_rng(seed)
    alphabet = list("abcxyz019:-_") + ["ключ", "é", "鍵", "😀", "\x00"]
    keys = ["", "a", "12345678", "123456789"]
    for n in rng.integers(0, 40, size=300):
        keys.append("".join(rng.choice(alphabet, size=int(n))))
    keys += ["x" * 4096, "ключ" * 300]
    return keys


@pytest.mark.parametrize("seed", [0, 1, 0x52_4C_54_50_55_31, 2**64 - 1])
def test_both_entry_points_bit_identical_to_twin_and_jax(seed):
    keys = _keys(seed % 1000)
    packed = native.pack_keys(keys)
    want = hash_packed_numpy(*packed, seed=seed)
    np.testing.assert_array_equal(native.bulk_hash_u64(keys, seed), want)
    np.testing.assert_array_equal(native.hash_packed(*packed, seed=seed),
                                  want)
    np.testing.assert_array_equal(jax_native.bulk_hash_u64(keys, seed), want)
    np.testing.assert_array_equal(
        jax_native.hash_packed(*jax_native.pack_keys(keys), seed=seed), want)


def test_ascii_batches_and_default_seed_match_jax():
    rng = np.random.default_rng(7)
    keys = [f"user:{int(i)}" for i in rng.integers(0, 10**9, size=4096)]
    got = native.bulk_hash_u64(tuple(keys))     # any sequence
    np.testing.assert_array_equal(got, jax_native.bulk_hash_u64(keys))
    np.testing.assert_array_equal(got, hash_packed_numpy(
        *native.pack_keys(keys), seed=native.DEFAULT_SEED))
    assert native.DEFAULT_SEED == jax_native.DEFAULT_SEED
    assert native.bulk_hash_u64([]).shape == (0,)
    assert native.hash_packed(*native.pack_keys([])).shape == (0,)


def test_bad_inputs_raise():
    with pytest.raises(TypeError):
        native.bulk_hash_u64(["a", 3])
    buf, off, lens = native.pack_keys(["abc", "de"])
    with pytest.raises(ValueError):
        native.hash_packed(buf, off, lens + 1)


_BUILD_AND_HASH = r"""
import sys, time
sys.path.insert(0, sys.argv[1])
from ratelimiter_tpu_torch import native
while time.time() < float(sys.argv[3]):
    time.sleep(0.001)
path = native.build(sys.argv[2])
lib, mod = native.load(path)
print(path, int(native.bulk_hash_u64(["k"])[0]))
"""


def test_two_processes_build_at_once(tmp_path):
    """Both processes build into one empty directory, started together:
    both load one complete library and hash alike; no temporary file is
    left behind."""
    import time

    start = time.time() + 1.5
    procs = [subprocess.Popen(
        [sys.executable, "-c", _BUILD_AND_HASH, REPO, str(tmp_path),
         repr(start)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    lines = {out.strip() for out, _ in outs}
    assert len(lines) == 1
    path, h = lines.pop().split()
    assert int(h) == int(jax_native.bulk_hash_u64(["k"])[0])
    assert sorted(os.listdir(tmp_path)) == sorted(
        [os.path.basename(path), "hasher.lock"])


def test_missing_compiler_raises(tmp_path, monkeypatch):
    missing = str(tmp_path / "no-such-dir" / "g++")
    with pytest.raises(RuntimeError, match="cannot build the bulk hasher"):
        native.build(str(tmp_path / "b1"), cxx=missing)
    # The hashing entry points raise too: no NumPy fallback.
    monkeypatch.setattr(native, "_loaded", None)
    monkeypatch.setattr(native, "build", functools.partial(
        native.build, str(tmp_path / "b2"), cxx=missing))
    with pytest.raises(RuntimeError, match="no-such-dir"):
        native.bulk_hash_u64(["a"])
    with pytest.raises(RuntimeError):
        native.hash_packed(*native.pack_keys(["a"]))


def test_failing_compiler_raises_with_its_output(tmp_path):
    fake = tmp_path / "fake-g++"
    fake.write_text("#!/bin/sh\necho 'hasher.cpp:1: error: boom' >&2\n"
                    "exit 1\n")
    fake.chmod(0o755)
    with pytest.raises(RuntimeError, match="boom"):
        native.build(str(tmp_path / "b"), cxx=str(fake))
    assert os.listdir(tmp_path / "b") == ["hasher.lock"]


def test_library_of_another_abi_is_refused(tmp_path):
    src = tmp_path / "old.cpp"
    src.write_text('extern "C" long long rl_hasher_abi_version() '
                   '{ return 1; }\n')
    lib = tmp_path / "old.so"
    subprocess.run(["g++", "-shared", "-fPIC", "-o", str(lib), str(src)],
                   check=True, capture_output=True, timeout=120)
    with pytest.raises(RuntimeError, match="ABI 1, expected 2"):
        native.load(str(lib))
