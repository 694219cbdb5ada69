"""The port's serving tier: the wire-protocol subset (protocol.py), the
micro-batcher (batcher.py) and the asyncio TCP door over it (server.py);
``python -m ratelimiter_tpu_torch.serving`` runs it."""
