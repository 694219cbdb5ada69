"""The port's serving tier: the wire-protocol subset (protocol.py) and a
minimal asyncio TCP door (server.py); ``python -m
ratelimiter_tpu_torch.serving`` runs it."""
