"""Error types (a copy of ``ratelimiter_tpu/core/errors.py``).

Mirrors the sentinel errors of reference ``internal/ratelimiter/errors.go:5-20``.
Unlike the reference — where only ``ErrInvalidN`` is ever raised and
``ErrInvalidConfig``/``ErrStorageUnavailable``/``ErrInvalidKey``/``ErrClosed``
are dead (SURVEY.md §2.1 row 4) — every error here has live raising sites and
is covered by the contract suite.
"""

from __future__ import annotations


class RateLimiterError(Exception):
    """Base class for all ratelimiter_tpu errors."""


class InvalidConfigError(RateLimiterError, ValueError):
    """Raised when a Config fails validation.

    Reference: ``ErrInvalidConfig`` (``errors.go:7``) + the per-field
    validation messages of ``config.go:16-50``.
    """


class InvalidKeyError(RateLimiterError, ValueError):
    """Raised when a request key is empty or not a string.

    Reference: ``ErrInvalidKey`` (``errors.go:13``) — defined there but never
    checked; the dormant contract suite expects it
    (``interface_test.go:246-251``). We honor the documented contract.
    """


class InvalidNError(RateLimiterError, ValueError):
    """Raised when allow_n is called with n <= 0.

    Reference: ``ErrInvalidN`` (``errors.go:10``), raised pre-backend in all
    three algorithms (e.g. ``tokenbucket.go:91-93``).
    """


class StorageUnavailableError(RateLimiterError, RuntimeError):
    """Raised (fail-closed) when the state backend cannot serve a decision.

    Reference: ``ErrStorageUnavailable`` (``errors.go:16``); fail-closed
    returns a wrapped error and *no* Result
    (``fixedwindow_integration_test.go:271-273``) — here that is an exception.
    """


class ClosedError(RateLimiterError, RuntimeError):
    """Raised when a limiter is used after close().

    Reference: ``ErrClosed`` (``errors.go:19``) — defined, never used. Here
    every public method checks it.
    """
