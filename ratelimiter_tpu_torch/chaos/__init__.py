"""Deterministic fault injection (the chaos harness, ADR-015).

The robustness contract of the sliced mesh tier — per-slice quarantine,
degraded-mode serving, deadline shedding — is only a contract if it is
*exercised*: this package is the injection seam the chaos suite
(tests/test_chaos.py), ``loadgen --chaos`` and ``bench.py --chaos``
drive. Design rules:

* **Off by default, zero overhead.** The module global ``INJECTOR`` is
  ``None`` unless a test/bench installs one; every hook site checks that
  one global before doing anything (the same pattern as
  ``tracing.RECORDER``). With no injector installed the hot path is
  byte-identical to a build without this package.

* **Deterministic.** Every probabilistic choice draws from one seeded
  ``random.Random``; scenarios are pure functions of (seed, call
  sequence), so a failing chaos run replays exactly from its seed.

* **Faults are injected where real faults surface.** Slice faults fire
  inside the quarantine guard's dispatch/resolve path
  (parallel/quarantine.py) — the same place a real device error or wedge
  would surface; DCN faults fire in the pusher's send path
  (serving/dcn_peer.py); snapshot stalls fire in the snapshotter's
  capture loop (persistence/snapshotter.py).
"""

from __future__ import annotations

from ratelimiter_tpu_torch.chaos.injector import (  # noqa: F401
    ChaosInjector,
    SliceFault,
    install,
    scenario,
    uninstall,
)

#: The process-wide injector (None = chaos off; hot paths check this one
#: global). Install via :func:`install`, never by assignment — imports
#: elsewhere bind ``chaos.INJECTOR`` through the module object.
INJECTOR: "ChaosInjector | None" = None
