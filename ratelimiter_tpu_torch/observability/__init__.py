"""The port's observability: the metrics registry (metrics.py), the
decorators around RateLimiter (decorators.py), the flight recorder
(tracing.py), the live accuracy observatory (audit.py, the shadow
auditor; slo.py, the SLO burn tracker) and the control-plane event
journal (events.py) — what the JAX package's
``ratelimiter_tpu/observability/__init__.py`` exports."""

from ratelimiter_tpu_torch.observability import audit, events, slo, tracing
from ratelimiter_tpu_torch.observability.metrics import (
    BATCH_BUCKETS,
    Counter,
    DEFAULT,
    Gauge,
    Histogram,
    LATENCY_BUCKETS,
    Registry,
)
from ratelimiter_tpu_torch.observability.decorators import (
    CircuitBreakerDecorator,
    LimiterDecorator,
    LoggingDecorator,
    MetricsDecorator,
    TracingDecorator,
)
from ratelimiter_tpu_torch.observability.tracing import FlightRecorder

__all__ = [
    "BATCH_BUCKETS",
    "CircuitBreakerDecorator",
    "Counter",
    "DEFAULT",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "LATENCY_BUCKETS",
    "LimiterDecorator",
    "LoggingDecorator",
    "MetricsDecorator",
    "Registry",
    "TracingDecorator",
    "audit",
    "events",
    "slo",
    "tracing",
]
