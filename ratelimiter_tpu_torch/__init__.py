"""ratelimiter_tpu_torch — the PyTorch/CUDA port of ratelimiter_tpu.

A second package beside the JAX one, which stays the reference: the same
``Config``, the same operands and the same results, bit for bit. It
imports ``torch`` and NumPy, never ``jax`` and nothing of
``ratelimiter_tpu`` (the host modules it needs are copied in). The table
kernels of the windowed sketch step and of the sketched token bucket's,
and the dense backend's step, are hand-written CUDA for Hopper
(``csrc/``); everything else is plain PyTorch. Three backends, as in the
JAX package: ``sketch`` (the default), ``dense`` (exact, slot-addressed
state on the card) and ``exact`` (host dicts, the conformance oracle);
``evaluation/`` holds the load generator, the device oracle and the
accuracy harness.

    from ratelimiter_tpu_torch import Algorithm, Config, create_limiter

    lim = create_limiter(Config(algorithm=Algorithm.SLIDING_WINDOW,
                                limit=100, window=60.0))   # device="cuda"
    out = lim.allow_ids(ids)           # raw u64 ids -> BatchResult
    out = lim.allow_batch(["a", "b"])  # string keys
    lim.reset("a")
    lim.update_limit(200)              # live, state kept
    lim.update_window(45.0)            # ring migrated on the device

Durable serving (a WAL of every mutation, background snapshots, crash
recovery) is ``persistence.PersistenceManager``; the server binary turns
it on with ``--snapshot-dir``.

Entry points run on the card unless asked for the CPU (``device="cpu"``),
where the kernels' plain versions run.
"""

from ratelimiter_tpu_torch.core.types import Algorithm, Result, BatchResult
from ratelimiter_tpu_torch.core.config import (
    Config,
    SketchParams,
    DenseParams,
    PersistenceSpec,
    HierarchySpec,
    MeshSpec,
    DEFAULT_PREFIX,
)
from ratelimiter_tpu_torch.core.errors import (
    RateLimiterError,
    InvalidConfigError,
    InvalidKeyError,
    InvalidNError,
    StorageUnavailableError,
    ClosedError,
    CheckpointError,
    DeadlineExceededError,
)
from ratelimiter_tpu_torch.core.clock import Clock, SystemClock, ManualClock
from ratelimiter_tpu_torch.algorithms.base import RateLimiter
from ratelimiter_tpu_torch.algorithms.factory import create_limiter

__version__ = "0.1.0"

__all__ = [
    "Algorithm",
    "Result",
    "BatchResult",
    "Config",
    "SketchParams",
    "DenseParams",
    "PersistenceSpec",
    "HierarchySpec",
    "MeshSpec",
    "DEFAULT_PREFIX",
    "RateLimiterError",
    "InvalidConfigError",
    "InvalidKeyError",
    "InvalidNError",
    "StorageUnavailableError",
    "ClosedError",
    "CheckpointError",
    "DeadlineExceededError",
    "Clock",
    "SystemClock",
    "ManualClock",
    "RateLimiter",
    "create_limiter",
    "__version__",
]
