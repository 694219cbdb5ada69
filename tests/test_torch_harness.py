"""Test-run environment for the port's tests, set at import.

pytest imports every test module at collection, in every xdist worker,
before any test runs. So the setting below is in place for the whole
run of each worker: ``RATELIMITER_TPU_COMPILE_CACHE`` set to "" (unless
the caller set it) turns off the JAX persistent compile cache in
``bench.py`` and in every JAX binary a test spawns (they read it at
import and at start, and skip the cache when it is empty), as
``tests/conftest.py`` keeps it off for the workers themselves: workers
and children sharing one cache directory compile into it concurrently,
the write path the conftest note says deadlocked, and the place the
recorded worker segfaults were. ``tests/test_elastic.py`` sets the same
variable for its own children.
"""

from __future__ import annotations

import os

os.environ.setdefault("RATELIMITER_TPU_COMPILE_CACHE", "")


def test_compile_cache_variable_is_set():
    assert "RATELIMITER_TPU_COMPILE_CACHE" in os.environ
