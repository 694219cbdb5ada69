"""The port's observability: the metrics registry (metrics.py), the
decorators around RateLimiter (decorators.py), the flight recorder
(tracing.py) and the control-plane event journal (events.py) — what the
JAX package's ``ratelimiter_tpu/observability/__init__.py`` exports of
these. The JAX package's accuracy observatory (audit.py) and SLO tracker
(slo.py) are not ported."""

from ratelimiter_tpu_torch.observability import events, tracing
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
    "events",
    "tracing",
]
