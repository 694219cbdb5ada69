"""The port's observability: the Prometheus metrics registry (metrics.py)
the micro-batcher and the door register into."""
