"""Client-embedded quota leases, a copy of ``ratelimiter_tpu/leases/``.

A lease moves a bounded token budget for ONE hot key into a client
process, so that client answers ``allow``/``allow_n`` for the key from
an in-process counter — no wire round trip — while the server keeps the
global bound by debiting the whole budget from the key's live window
UPFRONT (through the door's decide path, so on the card through the
step's kernels). The tier spans:

* :class:`LeaseManager` — server side: nominates hot keys from the
  heavy-hitter side table, grants/renews/revokes, mirrors leased
  consumption into the audit tap, journals lease events, and snapshots
  its grant table so it rides checkpoints (the persistence sidecar).
* :class:`LeaseCache` — client side: per-key token counters, local
  hot-key detection, and a background maintenance channel that grants,
  renews and returns asynchronously (never on the decision path).
* :class:`LeaseListener` — a small asyncio sidecar listener serving
  only the lease control frames, for the native C++ front door (whose
  decision fast path knows nothing of leases).

The fleet's lease gossip and epoch revocation are not ported yet
(ROADMAP A13d, part two).
"""

from ratelimiter_tpu_torch.leases.cache import LeaseCache, LeasedKey
from ratelimiter_tpu_torch.leases.listener import LeaseListener
from ratelimiter_tpu_torch.leases.manager import LeaseManager

__all__ = ["LeaseCache", "LeasedKey", "LeaseListener", "LeaseManager"]
