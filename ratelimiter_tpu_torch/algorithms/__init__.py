"""Limiter backends of the port (the windowed sketch and the sketched token
bucket)."""
