"""Offline tools of the port, each run as ``python -m
ratelimiter_tpu_torch.tools.<name>``:

* ``rebucket``: resize a snapshot onto a new slice count.
"""
