"""Core types, configuration, errors and clock: copies of
``ratelimiter_tpu/core``, kept so the port imports nothing of the JAX
package while accepting the same ``Config`` and returning the same
``Result``/``BatchResult`` shapes."""
