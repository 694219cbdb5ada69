"""Limiter backends of the port (the windowed sketch in this slice)."""
