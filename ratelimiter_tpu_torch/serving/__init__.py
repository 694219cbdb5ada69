"""The port's serving tier: the wire protocol (protocol.py), the
micro-batcher (batcher.py), the asyncio door over it (server.py), the
native C++ door (native_server.py over native/server.cpp), the
shared-memory lane (shm.py), the HTTP gateway (http_gateway.py) and the
clients (client.py); ``python -m ratelimiter_tpu_torch.serving`` runs
the binary."""

from ratelimiter_tpu_torch.serving.batcher import MicroBatcher
from ratelimiter_tpu_torch.serving.client import AsyncClient, Client
from ratelimiter_tpu_torch.serving.server import RateLimitServer, run_server

__all__ = [
    "AsyncClient",
    "Client",
    "MicroBatcher",
    "RateLimitServer",
    "run_server",
]
