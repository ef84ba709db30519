"""Profiling / tracing utilities (SURVEY §5: absent in the reference).

  * :func:`trace` — context manager around ``jax.profiler`` writing a
    TensorBoard/Perfetto-loadable device trace.
  * :func:`device_time` — device timing of a jitted function: the op is
    repeated N times inside one compiled ``lax.scan`` whose carry perturbs
    the input (defeating CSE/hoisting), so per-call dispatch divides away.
  * :func:`enable_compile_cache` — JAX's persistent compilation cache at a
    fixed path, for the scripts and benchmarks (the library never sets it).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import jax
import jax.numpy as jnp
from jax import lax

#: In-checkout cache directory used when ``JAX_COMPILATION_CACHE_DIR`` is
#: unset (listed in ``.gitignore``). Fixed, because the path is part of the
#: cache key.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def compile_cache_dir(environ=os.environ) -> str:
    """``JAX_COMPILATION_CACHE_DIR`` when set, else :data:`DEFAULT_CACHE_DIR`."""
    return environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; returns its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and no
    other directory is configured here.
    """
    path = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    return path


@contextlib.contextmanager
def trace(log_dir: str):
    """``with trace("/tmp/trace"):`` — device trace for TensorBoard."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def device_time(
    fn: Callable,
    x: jax.Array,
    *static_args,
    n_inner: int = 10,
    reps: int = 2,
) -> float:
    """Average seconds per call of ``fn(x, *static_args)`` on device.

    ``fn``'s first argument must be a float array; the measurement loop adds
    a data-dependent ~0 perturbation each iteration so the compiler cannot
    fold the repeats. Returns seconds (compile time excluded).
    """

    def loop(x0):
        def body(carry, _):
            out = fn(x0 + carry, *static_args)
            leaves = [
                l
                for l in jax.tree.leaves(out)
                if hasattr(l, "dtype") and jnp.issubdtype(l.dtype, jnp.floating)
            ]
            s = sum(jnp.sum(jnp.where(jnp.isfinite(l), l, 0)) for l in leaves)
            if not leaves:
                s = jnp.asarray(0.0, x0.dtype)
            return jnp.asarray(s, x0.dtype).reshape(()) * 1e-30, ()

        c, _ = lax.scan(body, jnp.zeros((), x0.dtype), None, length=n_inner)
        return c

    jloop = jax.jit(loop)
    jax.block_until_ready(jloop(x))  # compile + warm
    t0 = time.perf_counter()
    out = None
    for _ in range(reps):
        out = jloop(x)  # enqueue; executions serialize on device
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / (reps * n_inner)
