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


class DeadlineExceededError(RateLimiterError, RuntimeError):
    """Raised (fail-closed) when a request's propagated deadline expired
    before its dispatch ran: the server sheds the work instead of
    spending a dispatch slot on an answer nobody is waiting for.
    Fail-open configs answer a fail-open allowance instead."""


class RequestTimeoutError(RateLimiterError, TimeoutError):
    """Raised by the blocking Client when one call's read deadline
    expires mid-stream. Names the pending request (``request_id`` /
    ``request_type``) and marks the connection desynchronized: the next
    call reconnects, so it can never return the timed-out frame's result
    as its own."""

    def __init__(self, msg: str, *, request_id: int = 0,
                 request_type: int = 0):
        super().__init__(msg)
        self.request_id = int(request_id)
        self.request_type = int(request_type)


class CheckpointError(RateLimiterError, RuntimeError):
    """Raised when a checkpoint cannot be loaded: wrong format version,
    wrong limiter kind, or a snapshot taken under a different config
    (fingerprint mismatch) — restoring it would silently reinterpret the
    state arrays."""
