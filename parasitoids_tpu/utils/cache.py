"""Persistent XLA compilation cache helper.

Forward programs here compile in tens of seconds (801² domains, FFT plans);
JAX's persistent compilation cache makes repeat CLI invocations and
benchmark runs start in seconds instead.  Called by the CLI/bench drivers —
library imports stay side-effect free.

The cache lives where ``JAX_COMPILATION_CACHE_DIR`` says, and otherwise in
one fixed directory inside the checkout (``.jax_cache/``, gitignored): a
cache is keyed by its path, so a directory that moves never hits.
"""

from __future__ import annotations

import os

CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), '.jax_cache')


def cache_dir() -> str:
    """``JAX_COMPILATION_CACHE_DIR`` if set, else the checkout's cache."""
    return os.environ.get('JAX_COMPILATION_CACHE_DIR') or CHECKOUT_CACHE_DIR


def enable_compilation_cache():
    """Point JAX's persistent cache at :func:`cache_dir`; returns the
    directory, or None when the cache stays off.

    XLA:CPU executable (de)serialization has segfaulted on this stack
    (pytest faulthandler: compilation_cache.py get/put_executable_and_time),
    so on the CPU the cache is opt-in (``PARA_CACHE_CPU=1``)."""
    import jax

    if jax.default_backend() == 'cpu' and \
            os.environ.get('PARA_CACHE_CPU') != '1':
        return None
    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update('jax_compilation_cache_dir', path)
    jax.config.update('jax_persistent_cache_min_compile_time_secs', 1.0)
    return path
