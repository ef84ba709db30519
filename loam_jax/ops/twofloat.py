"""Double-float (compensated f32) arithmetic for selection-critical math.

Accelerators run f64 slowly or not at all; the hardware-native way to get
~49 bits of precision is a (hi, lo) pair of f32s with ``hi + lo`` representing the value
exactly at each step (Dekker 1971 / Knuth TwoSum — the same representation
XLA itself uses when emulating wider types). The feature-extraction
north-star requires *selection* decisions (curvature ordering, threshold and
range-gate comparisons) to match the reference's f64 math bit-for-bit; the
curvature stencil ``|sum(p_neighbors) - 2N p|^2`` cancels catastrophically in
plain f32 at long ranges (~1e2 m coordinates, ~1e-3 m differences), which is
exactly where compensated arithmetic restores the f64 decision order.

All ops are branch-free elementwise work on any backend (f32 IEEE add/mul
round-to-nearest assumed — true for NVIDIA GPUs and all CPUs).

Error bounds: df ops are exact-or-(relatively ~2^-48)-accurate; decisions
agree with f64 whenever the true margin exceeds ~2^-45 of the operands —
far below the f64 oracle's own rounding noise for these expressions.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax


class DF(NamedTuple):
    """A double-float value: ``hi + lo`` with |lo| <= ulp(hi)/2."""

    hi: jax.Array
    lo: jax.Array


def _pin(*xs):
    """Pin intermediates against compiler rewrites.

    Error-free transformations are only exact if every intermediate is
    rounded to f32 exactly as written. Two compiler mechanisms break that:

      * ``lax.optimization_barrier`` survives HLO simplification but is
        expanded away before codegen (XLA:CPU ``cse_barrier_expander``), and
      * the backend then CONTRACTS ``mul`` + ``add``/``sub`` pairs into FMAs
        (observed on XLA:CPU: ``two_sum(fl(a*-6), s)`` computed
        ``fma(a,-6,s)`` for its first add, silently destroying the
        compensation term). XLA:GPU (NVPTX, ``ptxas``) contracts too; the
        pin holds there as well — f32 extraction on an H100 matches the
        f64 oracle index for index (``chip_smoke.py``, extraction phase).

    The select ``where(x == x, x, 0)`` is a durable pin: no compiler can
    fold it without proving ``x`` is never NaN (the fold would change a NaN
    input into 0), and a select between a multiply and its consumer add
    blocks FMA contraction in instruction selection — while remaining an
    ordinary fusible elementwise op (an ``optimization_barrier`` would also
    work at the HLO level but splits fusions, costing a full HBM round trip
    per pinned intermediate; it is also expanded away before codegen, which
    is why it cannot prevent the contraction on its own).
    """
    ys = tuple(jnp.where(x == x, x, jnp.zeros_like(x)) for x in xs)
    return ys if len(xs) > 1 else ys[0]


def two_sum(a, b):
    """Exact addition: returns (s, e) with s = fl(a+b), s + e = a + b.

    Add/sub chains are immune to FMA contraction (no multiplies), so no
    pins are needed here — PROVIDED the inputs are not raw multiplies (every
    multiply in this module is pinned at its definition).
    """
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def fast_two_sum(a, b):
    """Exact addition assuming |a| >= |b|."""
    s = a + b
    e = b - (s - a)
    return s, e


def _split(a):
    """Veltkamp split of an f32 into 12+12-bit halves."""
    c = _pin(jnp.float32(4097.0) * a)  # 2^12 + 1
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Exact multiplication: (p, e) with p = fl(a*b), p + e = a*b.

    Every multiply is pinned: an unpinned ``a*b`` is eligible for FMA
    contraction into whatever add consumes it next (the observed XLA:CPU
    failure contracted ``two_sum(fl(a*-6), s)``'s first add into
    ``fma(a,-6,s)``, destroying the compensation), and the split/product
    identities require each product rounded to f32 exactly as written.
    """
    p = _pin(a * b)
    ah, al = _split(a)
    bh, bl = _split(b)
    t0 = _pin(ah * bh)
    t1 = _pin(ah * bl)
    t2 = _pin(al * bh)
    t3 = _pin(al * bl)
    e = ((t0 - p) + t1 + t2) + t3
    return p, e


def df_from(a) -> DF:
    a = jnp.asarray(a, jnp.float32)
    return DF(a, jnp.zeros_like(a))


def df_from_scalar(v: float) -> DF:
    """Python float (f64) -> DF capturing the full f64 value (hi = f32
    rounding, lo = the remainder) — for thresholds that may not be exactly
    f32-representable."""
    import numpy as np

    hi = float(np.float32(v))
    lo = float(v) - hi
    return DF(jnp.float32(hi), jnp.float32(lo))


def df_add(x: DF, y: DF) -> DF:
    s, e = two_sum(x.hi, y.hi)
    e = e + x.lo + y.lo
    hi, lo = fast_two_sum(s, e)
    return DF(hi, lo)


def df_add_f(x: DF, a) -> DF:
    s, e = two_sum(x.hi, a)
    e = e + x.lo
    hi, lo = fast_two_sum(s, e)
    return DF(hi, lo)


def df_neg(x: DF) -> DF:
    return DF(-x.hi, -x.lo)


def df_sub(x: DF, y: DF) -> DF:
    return df_add(x, df_neg(y))


def df_mul(x: DF, y: DF) -> DF:
    p, e = two_prod(x.hi, y.hi)
    e = e + _pin(x.hi * y.lo) + _pin(x.lo * y.hi)
    hi, lo = fast_two_sum(p, e)
    return DF(hi, lo)


def df_mul_f(x: DF, a) -> DF:
    p, e = two_prod(x.hi, a)
    e = e + _pin(x.lo * a)
    hi, lo = fast_two_sum(p, e)
    return DF(hi, lo)


def df_sq(x: DF) -> DF:
    return df_mul(x, x)


def df_sqrt(x: DF) -> DF:
    """Double-float square root (one Newton refinement of the f32 sqrt).

    For x = (hi, lo) >= 0: y0 = sqrt(hi); y = y0 + (x - y0^2) / (2 y0).
    Zero-safe: returns 0 for x == 0.
    """
    y0 = jnp.sqrt(jnp.maximum(x.hi, 0.0))
    safe = jnp.where(y0 > 0, y0, 1.0)
    r = df_add(x, df_neg(df_sq(DF(y0, jnp.zeros_like(y0)))))  # x - y0^2
    corr = r.hi / (2.0 * safe) + r.lo / (2.0 * safe)
    hi, lo = fast_two_sum(y0, jnp.where(y0 > 0, corr, 0.0))
    return DF(hi, lo)


def df_lt(x: DF, y: DF):
    return (x.hi < y.hi) | ((x.hi == y.hi) & (x.lo < y.lo))


def df_gt(x: DF, y: DF):
    return (x.hi > y.hi) | ((x.hi == y.hi) & (x.lo > y.lo))


def df_gt_f(x: DF, a):
    return df_gt(x, df_from(a))


def df_lt_f(x: DF, a):
    return df_lt(x, df_from(a))


def df_to_f64(x: DF):
    """Exact f64 value (requires x64; for tests/oracles only)."""
    return jnp.asarray(x.hi, jnp.float64) + jnp.asarray(x.lo, jnp.float64)
