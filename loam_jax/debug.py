"""Numerical-health checks (SURVEY §5 "race detection / sanitizers" row).

The reference is single-threaded C++ — its only sanitizer story is "no
races possible". The accelerator build's analogue of a data race is *silent NaN/Inf
poisoning*: one non-finite value entering a masked einsum/normal-equation
reduction corrupts every downstream pose with no crash (the `0 * nan`
pitfall this codebase zeroes masked rows to avoid). These helpers make that
failure mode loud, on host values and inside jitted programs alike:

  * :func:`check_finite` — host-side assert over any pytree; raises
    ``FloatingPointError`` naming each offending leaf path and its
    non-finite count.
  * :func:`tap_finite` — the same check staged INSIDE jit via
    ``jax.debug.callback`` (works under ``lax.scan``/``while_loop``; the
    callback fires per execution, not per trace). Zero device-side cost
    beyond the reductions; gate it with ``LOAM_DEBUG_NANS``.
  * :func:`debug_nans_enabled` / env var ``LOAM_DEBUG_NANS=1`` — the CI
    switch: library call sites guard their taps with it so production runs
    pay nothing (the check is staged out at trace time).

Use ``jax.config.update("jax_debug_nans", True)`` for op-level bisection on
CPU repros; these helpers are the always-available complement that stays
inside the compiled program (``jax_debug_nans`` re-runs ops un-jitted).
"""

from __future__ import annotations

import os
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np


def debug_nans_enabled() -> bool:
    """True when ``LOAM_DEBUG_NANS=1``: library tap points stage their
    checks in; otherwise the checks do not appear in compiled programs."""
    return os.environ.get("LOAM_DEBUG_NANS", "0") == "1"


def _leaf_paths(tree: Any):
    paths = jax.tree_util.tree_flatten_with_path(tree)[0]
    for path, leaf in paths:
        if hasattr(leaf, "dtype") and jnp.issubdtype(
            jnp.asarray(leaf).dtype, jnp.inexact
        ):
            yield jax.tree_util.keystr(path), leaf


def check_finite(tree: Any, where: str = "") -> None:
    """Raise ``FloatingPointError`` if any float leaf holds NaN/Inf.

    Host-side: call on concrete values (outputs of a jitted call, test
    fixtures). The error message lists every offending leaf as
    ``path: <n> non-finite of <size>`` so a poisoned pytree is diagnosable
    in one shot.
    """
    bad = []
    for path, leaf in _leaf_paths(tree):
        arr = np.asarray(leaf)
        n = int(np.size(arr) - np.count_nonzero(np.isfinite(arr)))
        if n:
            bad.append(f"{path}: {n} non-finite of {arr.size}")
    if bad:
        prefix = f"[{where}] " if where else ""
        raise FloatingPointError(
            prefix + "non-finite values detected:\n  " + "\n  ".join(bad)
        )


def tap_finite(tree: Any, where: str = "", force: bool = False) -> None:
    """Stage a NaN/Inf check into a jitted program (no-op unless
    ``LOAM_DEBUG_NANS=1`` or ``force=True``).

    Computes one non-finite count per float leaf on device (cheap
    reductions, fusible) and raises host-side via ``jax.debug.callback``
    when any is nonzero. Safe inside ``lax.scan``/``while_loop`` bodies.
    The raise surfaces to the caller wrapped in ``jax.errors.JaxRuntimeError``
    whose message carries the per-leaf report. The flag is read at TRACE
    time (it is not part of the jit cache key): set ``LOAM_DEBUG_NANS``
    before the first call of the function under check.
    """
    if not (force or debug_nans_enabled()):
        return
    paths, leaves = [], []
    for path, leaf in _leaf_paths(tree):
        paths.append(path)
        leaves.append(jnp.sum(~jnp.isfinite(leaf), dtype=jnp.int32))
    if not leaves:
        return

    def _report(counts, paths=tuple(paths), where=where):
        bad = [
            f"{p}: {int(c)} non-finite"
            for p, c in zip(paths, counts)
            if int(c)
        ]
        if bad:
            prefix = f"[{where}] " if where else ""
            raise FloatingPointError(
                prefix + "non-finite values detected:\n  " + "\n  ".join(bad)
            )

    jax.debug.callback(_report, jnp.stack(leaves))
