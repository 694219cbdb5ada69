"""The replicated mesh tier's steps — a port of
``ratelimiter_tpu/parallel/mesh_kernels.py``.

State is fully replicated (every slice holds the identical sketch); the
request batch is sharded positionally over the slices (slice ``i`` gets
rows ``[i*L, (i+1)*L)`` of the padded batch). The two merge modes:

* gather (``gather_step``): one ``all_gather`` of the shards, then every
  replica runs the port's unchanged step (its CUDA front, admission and
  update kernels) on the global batch in chip-major order, and slice
  ``i`` returns the verdicts of its own rows. The state update is a
  replicated deterministic computation: no further collective.
* delta (``delta_window_step``, ``delta_bucket_step``): each replica
  runs the front and admission kernels on its shard against its own
  counts and writes its local histogram into zeroed slabs (``add_back``
  on zeroed ``totals``/``cur``; the bucket's ``bucket_update`` on zeroed
  ``debt``/``acc``); the slabs are psum'd over the mesh and the merged
  delta is added on every replica, so the replicas stay identical. This
  is the JAX delta step's composition (ratelimiter_tpu/ops/
  sketch_kernels.py: the tenant histogram psum'd at :413-414, the write
  histograms at :459-464, the side table's ``hh_hist`` psum'd and
  ``claims``/``touched``/``h2w`` pmax'd at :507-521; ops/
  bucket_kernels.py:191-220), where the jnp step runs the collectives
  inside. Conservative update is off in delta mode (always vanilla
  sums: cross-slice counts must add).

Rollover and reset are replicated computations on replicated state: the
plain single-slice callables, run on every replica.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ratelimiter_tpu_torch.ops import bucket_cuda, bucket_kernels
from ratelimiter_tpu_torch.ops import sketch_cuda, sketch_kernels
from ratelimiter_tpu_torch.parallel.mesh import Mesh

MERGE_MODES = ("gather", "delta")


def check_merge(merge: str) -> None:
    if merge not in MERGE_MODES:
        raise ValueError(f"merge must be one of {MERGE_MODES}, got {merge!r}")


def shard_rows(t: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """The positional shards of a (n*L,) batch tensor, each on its
    slice's device (the JAX ``shard_batch``)."""
    L = t.shape[0] // mesh.size
    return [t[i * L:(i + 1) * L].to(mesh.devices[i], non_blocking=True)
            for i in range(mesh.size)]


def _keys_shards(keys, mesh: Mesh) -> list:
    if isinstance(keys, tuple):
        return list(zip(*(shard_rows(k, mesh) for k in keys)))
    return shard_rows(keys, mesh)


def _gather_keys(keys, mesh: Mesh) -> list:
    """Every replica's copy of the global batch, gathered from the
    shards in slice order."""
    if isinstance(keys, tuple):
        return list(zip(*(mesh.all_gather(shard_rows(k, mesh))
                          for k in keys)))
    return mesh.all_gather(shard_rows(keys, mesh))


def assemble(mesh: Mesh, per_slice: Sequence[tuple]) -> tuple:
    """Slice outputs -> frame-order outputs on slice 0's device."""
    dev = mesh.devices[0]
    return tuple(torch.cat([o.to(dev, non_blocking=True) for o in col])
                 for col in zip(*per_slice))


def gather_step(mesh: Mesh, step, states, keys, n, now_us: int, policies,
                hiers, **kw) -> tuple:
    """Gather mode: all_gather the shards, every replica runs ``step``
    (the single-slice step) on the global batch, and slice ``i`` keeps
    its own rows' verdicts."""
    L = n.shape[0] // mesh.size
    gk = _gather_keys(keys, mesh)
    gn = mesh.all_gather(shard_rows(n, mesh))
    outs = []
    for i, st in enumerate(states):
        o = step(st, gk[i], gn[i], now_us, policies[i], hiers[i], **kw)
        outs.append(tuple(x[i * L:(i + 1) * L] for x in o))
    return assemble(mesh, outs)


def _side_components(state, h1, h2, n, allowed, mine, target_pr, *,
                     thresh: float):
    """The side table's update split at the JAX delta step's collectives
    (sketch_kernels.py:487-521): per replica the owned counts ``hist``,
    the ``touched`` slots and the packed candidate ``claims``, and (given
    the pmax'd claims) the winners' ``h2w``. Plain PyTorch: the reference
    computes it with jnp ops, and it replaces no TPU kernel."""
    import numpy as np

    owner = state["hh_owner"]
    K = owner.shape[0]
    sid = h1 & (K - 1)
    hist = torch.zeros(K, dtype=torch.int32, device=h1.device).index_add_(
        0, sid, torch.where(allowed & mine, n, torch.zeros_like(n)))
    cand = ~mine & (owner[sid] == 0) & (
        target_pr >= float(np.float32(thresh)))
    mass = torch.ceil(torch.clamp(target_pr, 0.0, float(1 << 30))).to(
        torch.int64)
    packed = torch.where(cand, (mass << 32) | h1, 0)
    touched = torch.zeros(K, dtype=torch.int32, device=h1.device).index_add_(
        0, sid, (mine | cand).to(torch.int32))
    claims = torch.zeros(K, dtype=torch.int64, device=h1.device)
    claims.scatter_reduce_(0, sid, packed, "amax")

    def h2w_of(global_claims):
        winner = cand & (packed == global_claims[sid])
        h2w = torch.zeros(K, dtype=torch.int64, device=h1.device)
        h2w.scatter_reduce_(0, sid, torch.where(winner, h2, 0), "amax")
        return h2w

    return hist, touched, claims, h2w_of


def _merge_side(mesh: Mesh, states, comps, period: int) -> None:
    """psum the owned counts, pmax the touched slots and the claims, then
    the winners' h2, and apply the merged update on every replica."""
    hists = mesh.psum([c[0] for c in comps])
    touched = mesh.pmax([c[1] for c in comps])
    claims = mesh.pmax([c[2] for c in comps])
    h2ws = mesh.pmax([c[3](claims[i]) for i, c in enumerate(comps)])
    for st, hist, tch, cl, h2w in zip(states, hists, touched, claims, h2ws):
        owner, owner2 = st["hh_owner"], st["hh_owner2"]
        claim_owner = cl & 0xFFFFFFFF
        newly = (owner == 0) & (claim_owner != 0)
        owner2.copy_(torch.where(newly, h2w, owner2))
        owner.copy_(torch.where(newly, claim_owner, owner))
        st["hh_cur"] += hist
        st["hh_totals"] += hist
        st["hh_last"].masked_fill_(tch > 0, period)


def delta_window_step(mesh: Mesh, states, keys, n, now_us: int, policies,
                      hiers, *, premix: bool, seed: int, period: int,
                      limit: int, sub_us: int, SW: int, S: int, iters: int,
                      weighted: bool, conservative: bool = False,
                      hh_thresh: float = 0.0) -> tuple:
    """Delta mode, windowed: local front and admission per replica, the
    local histograms psum'd, the merged delta added everywhere. Returns
    ``(allowed, remaining, est)`` in frame order on slice 0's device."""
    del conservative  # vanilla sums: cross-slice counts must add
    now_us = max(now_us, period * sub_us)
    ks, ns = _keys_shards(keys, mesh), shard_rows(n, mesh)
    outs, slabs, tn_parts, side = [], [], [], []
    for i, st in enumerate(states):
        bnd = sketch_kernels._boundary(st, period, now_us, sub_us=sub_us,
                                       SW=SW, S=S, weighted=weighted)
        hh = sketch_kernels._side(st, period, S=S, weighted=weighted)
        h1, h2, est, frac, avail, n_f, *parts = sketch_cuda.window_front(
            st["totals"], ks[i], ns[i], premix=premix, seed=seed,
            boundary=bnd, policy=policies[i], limit=limit, hh=hh)
        mine = parts[0][0] if parts else None
        casc = None
        if hiers[i] is not None:
            tn = {"tn_totals": st["tn_totals"].clone(),
                  "tn_cur": st["tn_cur"].clone(),
                  "tn_slabs": st["tn_slabs"]}
            casc = sketch_kernels._cascade(tn, hiers[i], h2, ns[i], frac,
                                           period=period, S=S,
                                           weighted=weighted)
        zt = torch.zeros_like(st["totals"])
        zc = torch.zeros_like(st["cur"])
        allowed, remaining, *tp = sketch_cuda.add_back(
            zt, zc, h1, h2, ns[i], n_f, avail, iters,
            None if mine is None else est, mine, casc)
        if casc is not None:
            # The cascade folded this replica's admitted histogram into
            # the clones (int32, wrapping): the difference is it.
            tn_parts.append(tn["tn_totals"] - st["tn_totals"])
        slabs.append(zt)
        if mine is not None:
            side.append(_side_components(st, h1, h2, ns[i], allowed, mine,
                                         tp[0], thresh=hh_thresh))
        outs.append((allowed, remaining, est))
    for st, hist in zip(states, mesh.psum(slabs)):
        st["totals"] += hist
        st["cur"] += hist
    if tn_parts:
        for st, hist in zip(states, mesh.psum(tn_parts)):
            st["tn_totals"] += hist
            st["tn_cur"] += hist
    if side:
        _merge_side(mesh, states, side, period)
    return assemble(mesh, outs)


def delta_bucket_step(mesh: Mesh, states, keys, n, now_us: int, policies,
                      hiers, *, premix: bool, seed: int, limit: int,
                      rate_num: int, rate_den: int, iters: int,
                      window_us: int, clamp_acc: bool = False) -> tuple:
    """Delta mode, token bucket: local front and admission per replica,
    the local debt increments psum'd, then every replica's debt decays
    and takes the merged increments (clamped at 2^61), as does ``acc``.
    The scalar decay is a deterministic function of the replicated
    ``rem``/``last``, so it needs no collective. Returns ``(allowed,
    remaining, retry_us)`` in frame order on slice 0's device."""
    del clamp_acc  # the dense clamp below covers every acc cell
    ks, ns = _keys_shards(keys, mesh), shard_rows(n, mesh)
    outs, slabs, tn_parts, decays = [], [], [], []
    for i, st in enumerate(states):
        decay, rem = bucket_kernels._decay(st, now_us, rate_num=rate_num,
                                           rate_den=rate_den)
        decays.append((decay, rem))
        h1, h2, _, avail, n_units = bucket_cuda.bucket_front(
            st["debt"], decay, ks[i], ns[i], premix=premix, seed=seed,
            policy=policies[i], limit=limit)
        casc = None
        if hiers[i] is not None:
            casc = bucket_kernels._cascade(st, hiers[i], h2, ns[i], now_us,
                                           window_us)
            base = (torch.zeros_like(st["tn_counts"]) if casc.rolled
                    else st["tn_counts"].clone())
            local = base.clone()
            casc = casc._replace(counts=local, rolled=False)
            tn_parts.append((base, local))
        allowed, consumed, remaining, retry_us = bucket_cuda.bucket_admit(
            h1, n_units, avail, iters, rate_num, rate_den, casc)
        zd = torch.zeros_like(st["debt"])
        za = torch.zeros_like(st["acc"])
        bucket_cuda.bucket_update(zd, za, 0, h1, h2, consumed)
        slabs.append(zd)
        outs.append((allowed, remaining, retry_us))
    cap = bucket_cuda.DEBT_CAP
    for st, hist, (decay, rem) in zip(states, mesh.psum(slabs), decays):
        st["debt"].sub_(decay).clamp_min_(0).add_(hist).clamp_max_(cap)
        st["acc"].add_(hist).clamp_max_(cap)
        bucket_kernels._advance(st, now_us, rem)
    if tn_parts:
        merged = mesh.psum([local - base for base, local in tn_parts])
        for st, (base, _), hist in zip(states, tn_parts, merged):
            st["tn_counts"].copy_(base + hist)
    return assemble(mesh, outs)
