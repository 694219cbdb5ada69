"""The port's shared step ops against the JAX package, bit for bit.

Inputs are made with NumPy from a seed and fed to both packages; every
output must be identical (no tolerance): the hashing twins (with and
without premix and seed), in-batch admission (mixed n, and a batch total
past 2^24 that takes the JAX package's exact int32 path), the policy
lookup on a full table whose max key must be reachable, result assembly
and wire packing, and the string hasher.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ratelimiter_tpu.native import bulk_hash_u64 as jax_bulk_hash
from ratelimiter_tpu.ops import hashing as jh
from ratelimiter_tpu.ops import policy_kernels as jpk
from ratelimiter_tpu.ops import sketch_kernels as jsk
from ratelimiter_tpu.ops.segment import admit as jax_admit
from ratelimiter_tpu_torch.native import bulk_hash_u64
from ratelimiter_tpu_torch.ops import hashing as th
from ratelimiter_tpu_torch.ops import policy_kernels as tpk
from ratelimiter_tpu_torch.ops import sketch_cuda as sc
from ratelimiter_tpu_torch.ops import sketch_kernels as tsk
from ratelimiter_tpu_torch.ops.segment import admit

SEEDS = [0, 1, 0x5BD1E995, 0xFFFFFFFFFFFFFFFF]


def _u64(rng, n):
    x = rng.integers(0, 2 ** 63, size=n, dtype=np.int64).view(np.uint64)
    x = x * np.uint64(2) + rng.integers(0, 2, size=n).astype(np.uint64)
    return np.concatenate([x, np.array([0, 1, 2 ** 63, 2 ** 64 - 1],
                                       dtype=np.uint64)])


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


def test_splitmix64_twin_matches_numpy_and_jax():
    x = _u64(np.random.default_rng(0), 4096)
    got = _bits(th.splitmix64_dev(th.u64_to_tensor(x, "cpu")))
    np.testing.assert_array_equal(got, jh.splitmix64(x))
    np.testing.assert_array_equal(
        got, np.asarray(jax.jit(jh.splitmix64_dev)(jnp.asarray(x))))


@pytest.mark.parametrize("premix", [False, True])
@pytest.mark.parametrize("seed", SEEDS)
def test_split_hash_twin_matches_numpy_and_jax(seed, premix):
    x = _u64(np.random.default_rng(seed & 0xFFFF), 2048)
    t = th.u64_to_tensor(x, "cpu")
    if premix:
        t = th.splitmix64_dev(t)
        x = jh.splitmix64(x)
    h1, h2 = th.split_hash_dev(t, seed)
    e1, e2 = jh.split_hash(x, seed)
    np.testing.assert_array_equal(h1.numpy(), e1.astype(np.int64))
    np.testing.assert_array_equal(h2.numpy(), e2.astype(np.int64))
    j1, j2 = jax.jit(lambda h: jh.split_hash_dev(h, seed))(jnp.asarray(x))
    np.testing.assert_array_equal(h1.numpy(), np.asarray(j1).astype(np.int64))
    np.testing.assert_array_equal(h2.numpy(), np.asarray(j2).astype(np.int64))


def test_string_hash_matches_jax_package():
    rng = np.random.default_rng(3)
    keys = ["", "a", "ratelimit:user:1", "ключ", "🔑" * 3] + [
        "k%d" % i * int(rng.integers(1, 5)) for i in range(200)]
    keys = [k for k in keys if k] + [""]
    np.testing.assert_array_equal(bulk_hash_u64(keys), jax_bulk_hash(keys))
    np.testing.assert_array_equal(bulk_hash_u64(keys, seed=7),
                                  jax_bulk_hash(keys, seed=7))


def _admit_both(sid, n, avail, iters):
    a, s, c = admit(torch.from_numpy(sid.astype(np.int64)),
                    torch.from_numpy(n), torch.from_numpy(avail), iters)
    ja, js, jc = jax_admit(jnp.asarray(sid.astype(np.int32)), jnp.asarray(n),
                           jnp.asarray(avail), iters)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    return a.numpy()


@pytest.mark.parametrize("seed", range(4))
def test_admit_mixed_n_matches_jax(seed):
    rng = np.random.default_rng(seed)
    B = 256
    sid = rng.integers(0, 40, size=B)
    n = rng.integers(0, 6, size=B).astype(np.float32)
    per_key = rng.integers(0, 30, size=40).astype(np.float32)
    avail = per_key[sid] - rng.random(40).astype(np.float32)[sid]
    allowed = _admit_both(sid, n, np.maximum(avail, 0), iters=4)
    assert allowed.any() and not allowed.all()


def test_admit_total_past_2_24_matches_jax_exact_path():
    rng = np.random.default_rng(9)
    B = 64
    sid = rng.integers(0, 4, size=B)
    n = rng.integers(1 << 20, 1 << 21, size=B).astype(np.float32)
    assert n.sum() >= (1 << 24)
    avail = np.full(B, np.float32((1 << 24) - 1))
    allowed = _admit_both(sid, n, avail, iters=4)
    assert allowed.any() and not allowed.all()


def test_lookup_full_table_reaches_last_row():
    rng = np.random.default_rng(4)
    P = 64
    keys = np.sort(rng.integers(-(2 ** 63), 2 ** 63 - 1, size=P,
                                dtype=np.int64))
    keys[-1] = tpk.PAD_KEY - 1          # a real key near the top of the order
    queries = np.concatenate([keys, keys[:8] + 1, [-(2 ** 63), tpk.PAD_KEY]])
    idx, found = tpk.lookup_i64(torch.from_numpy(keys),
                                torch.from_numpy(queries))
    jidx, jfound = jpk.lookup_i64(jnp.asarray(keys), jnp.asarray(queries))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(found.numpy(), np.asarray(jfound))
    assert found[P - 1] and idx[P - 1] == P - 1


def test_pack_halves_matches_jax_and_host():
    rng = np.random.default_rng(5)
    h1 = np.concatenate([rng.integers(0, 2 ** 32, size=500),
                         [0, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1]]).astype(np.uint32)
    h2 = (rng.integers(0, 2 ** 32, size=h1.shape[0]) | 1).astype(np.uint32)
    got = tpk.pack_halves(torch.from_numpy(h1.astype(np.int64)),
                          torch.from_numpy(h2.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, tpk.pack_halves_host(h1, h2))
    np.testing.assert_array_equal(
        got, np.asarray(jpk.pack_halves(jnp.asarray(h1), jnp.asarray(h2))))


@pytest.mark.parametrize("sub_us", [1_000_000, 999_983, 7, 1 << 20])
def test_boundary_frac_matches_jax_reference(sub_us):
    """XLA compiles the reference's ``1 - elapsed/sub_us`` as an FMA with
    the f32 reciprocal; the port's boundary weight (``frac_plain`` of
    ``frac_operands``, what the front computes) reproduces it for every
    elapsed."""
    S = SW = 4
    p = 100
    state = {"slabs": jnp.zeros((S, 1, 16), jnp.int32),
             "slab_period": jnp.full((S,), p - SW, jnp.int64)}
    f = jax.jit(lambda st, now: jsk._boundary_weight(
        st, jnp.int64(p), now, sub_us=sub_us, SW=SW, S=S, weighted=True)[0])
    rng = np.random.default_rng(sub_us)
    elapsed = np.concatenate([rng.integers(0, sub_us, size=200),
                              [0, 1, sub_us - 1]])
    for e in elapsed:
        now = p * sub_us + int(e)
        assert (np.float32(sc.frac_plain(*tsk.frac_operands(p, now, sub_us)))
                == np.float32(f(state, jnp.int64(now))))


@pytest.mark.parametrize("now_us,window_us", [
    (1_700_000_123_456_789, 60_000_000),
    (6_000_000, 6_000_000),
    (987_654_321, 1_000),
])
def test_finish_window_and_pack_wire_match_jax(now_us, window_us):
    rng = np.random.default_rng(now_us % 1000)
    B = 64
    allowed = rng.random(B) < 0.6
    remaining = rng.integers(0, 100, size=B).astype(np.int32)
    outs = tsk.finish_window(torch.from_numpy(allowed),
                             torch.from_numpy(remaining), now_us, window_us)
    jouts = jsk.finish_window(jnp.asarray(allowed), jnp.asarray(remaining),
                              jnp.int64(now_us), jnp.int64(window_us))
    for o, j in zip(outs, jouts):
        np.testing.assert_array_equal(o.numpy(), np.asarray(j))
        assert o.numpy().dtype == np.asarray(j).dtype
    bits, words = tsk.pack_wire(*outs)
    jbits, jwords = jsk.pack_wire(*jouts)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits))
    np.testing.assert_array_equal(words.numpy(), np.asarray(jwords))
