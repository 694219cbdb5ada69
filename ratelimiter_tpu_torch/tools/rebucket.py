"""Offline snapshot re-bucketing: resize a checkpoint onto a new slice
count without starting a server (the cold half of elastic resharding;
the live half is ``SlicedMeshLimiter.restore``). The port's counterpart
of the JAX package's ``tools/rebucket.py``, writing the same file::

    python -m ratelimiter_tpu_torch.tools.rebucket IN.npz OUT.npz --slices M

Both snapshot shapes are taken:

* a combined mesh snapshot (kind ``mesh:<kind>``, ``slice{i}:`` arrays),
  re-bucketed onto M slices (M == 1 writes a plain single-unit snapshot);
* a plain single-unit snapshot (kind ``sketch``), read as a 1-slice
  mesh: M == 1 writes it back unchanged, M > 1 splits it into a
  combined ``mesh:`` snapshot.

The config fingerprint is carried through as it is: re-bucketing moves
state between slices and never changes what it means (the mesh spec is
not in the fingerprint, checkpoint.py), so the output restores under the
same flags and the new ``--mesh-devices``. Host NumPy only: no device
and no server.
"""

from __future__ import annotations

import argparse
import sys

from ratelimiter_tpu_torch.checkpoint import read_raw, write_raw
from ratelimiter_tpu_torch.core.errors import CheckpointError
from ratelimiter_tpu_torch.parallel import reshard


def rebucket_file(src: str, dst: str, new_n: int) -> dict:
    arrays, meta = read_raw(src)
    kind = str(meta.get("kind", ""))
    if kind.startswith("mesh:"):
        states, extras = reshard.split_combined(arrays, meta)
        base_kind = kind[len("mesh:"):]
    else:
        # A plain single-unit snapshot is a 1-slice mesh.
        states, extras = [dict(arrays)], [
            {k: meta[k] for k in ("saved_at", "host_period") if k in meta}]
        base_kind = kind
    old_n = len(states)
    new_states, new_extras = reshard.rebucket(states, extras, new_n)
    out_meta = dict(meta)
    out_meta["rebucketed_from"] = old_n
    if new_n == 1:
        out_arrays = new_states[0]
        out_meta["kind"] = base_kind
        out_meta.pop("n_slices", None)
        out_meta.pop("slice_extras", None)
        out_meta.update(new_extras[0])
    else:
        out_arrays, out_meta = reshard.join_combined(
            new_states, new_extras, out_meta)
        out_meta["kind"] = f"mesh:{base_kind}"
    write_raw(dst, out_arrays, out_meta)
    return {"old_slices": old_n, "new_slices": new_n,
            "kind": out_meta["kind"], "arrays": len(out_arrays)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ratelimiter_tpu_torch.tools.rebucket",
        description="resize a ratelimiter_tpu snapshot onto a new "
                    "slice count (offline elastic resharding)")
    ap.add_argument("src", help="input snapshot (.npz)")
    ap.add_argument("dst", help="output snapshot (.npz)")
    ap.add_argument("--slices", type=int, required=True,
                    help="target slice count (>= 1)")
    args = ap.parse_args(argv)
    if args.slices < 1:
        ap.error("--slices must be >= 1")
    try:
        info = rebucket_file(args.src, args.dst, args.slices)
    except CheckpointError as exc:
        raise SystemExit(str(exc)) from exc
    print(f"rebucketed {args.src} ({info['old_slices']} slice(s)) -> "
          f"{args.dst} ({info['new_slices']} slice(s), "
          f"kind={info['kind']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
