"""Vectorized curvature + point-validity kernels.

Vectorized reformulation of the reference's per-point scalar loops:

  * Curvature (``features-inl.h:53-87``): the per-point neighbor accumulation
    ``d_i = sum_{n=1..N}(p_{i-n} + p_{i+n}) - 2N p_i``, ``c_i = |d_i|^2`` is a
    1-D stencil along each scan line — computed here as a sum of 2N static
    shifted slices over the whole (L, P, 3) scan at once (XLA fuses these into
    a single elementwise pass).

  * Validity (``features-inl.h:90-124``, ``features.cpp:18-70``): although the
    reference mutates the mask imperatively point by point, every check's
    *firing condition* is a pure function of the per-point ranges, and the
    mask is monotone (only ever cleared). The whole mask is therefore the
    complement of an OR of dilated firing masks — fully data-parallel:

      check1 (line edge):   fires on j < N or j >= P-N;          clears self
      check2 (range gate):  fires on ~c1 & out-of-range;          clears j-N..j+N
      check3a (occlusion 1): fires on ~c1 & ~c2 & (r[j+1]-r[j]>T); clears j+1..j+N
      check3b (occlusion 2): fires on ~c1 & ~c2 & (r[j]-r[j+1]>T); clears j-N+1..j
      check4 (parallel):    fires on ~c1 & ~c2 & ~c3 & cond;       clears self

    The ``continue`` statements in the reference only gate which *later*
    checks may fire for the same point — captured by the ``~cK`` terms.
    All dilations stay within a scan line by construction (proof: a firing
    point has j in [N, P-N-1], so its widest clear window j±N stays in
    [0, P-1]); shifts here zero-fill rather than wrap, so lines never leak
    into each other.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..params import FeatureExtractionParams, LidarParams


def validate_scan(scan: jax.Array, lidar: LidarParams) -> jax.Array:
    """Shape-check and reshape a scan to (L, P, 3).

    Accepts (L, P, 3) or flat (L*P, 3) row-major layout (the reference's
    input convention). Raises at trace time on mismatch — the analogue of
    ``validateLidarScan`` (``common.h:104-113``).
    """
    L, P = lidar.scan_lines, lidar.points_per_line
    if scan.ndim == 2 and scan.shape == (L * P, 3):
        return scan.reshape(L, P, 3)
    if scan.ndim == 3 and scan.shape == (L, P, 3):
        return scan
    raise ValueError(
        f"LOAM: provided lidar scan shape {scan.shape} does not match provided "
        f"lidar parameters ({L} x {P})"
    )


def _shift(x: jax.Array, k: int, fill=0):
    """Shift along the last axis by k (positive = towards higher index),
    zero/fill padding — never wraps across scan lines."""
    if k == 0:
        return x
    pad = [(0, 0)] * x.ndim
    if k > 0:
        pad[-1] = (k, 0)
        return jnp.pad(x, pad, constant_values=fill)[..., : x.shape[-1]]
    pad[-1] = (0, -k)
    return jnp.pad(x, pad, constant_values=fill)[..., -k:]


def compute_curvature(
    scan: jax.Array, lidar: LidarParams, params: FeatureExtractionParams
) -> jax.Array:
    """Curvature (L, P); -1 sentinel on the first/last ``neighbor_points``
    of each line (reference ``features-inl.h:66-69``)."""
    pts = validate_scan(scan, lidar)
    L, P = lidar.scan_lines, lidar.points_per_line
    N = params.neighbor_points
    # stencil: d = sum_n (p_{j-n} + p_{j+n}) - 2N p_j, via static padded slices
    padded = jnp.pad(pts, ((0, 0), (N, N), (0, 0)))
    d = (-2.0 * N) * pts
    for n in range(1, N + 1):
        d = d + padded[:, N - n : N - n + P] + padded[:, N + n : N + n + P]
    c = jnp.sum(d * d, axis=-1)
    j = jnp.arange(P)
    interior = (j >= N) & (j < P - N)
    return jnp.where(interior[None, :], c, jnp.asarray(-1.0, c.dtype))


def compute_valid_points(
    scan: jax.Array, lidar: LidarParams, params: FeatureExtractionParams
) -> jax.Array:
    """Validity mask (L, P) bool — vectorized form of the reference's four
    sequential checks (see module docstring for the equivalence argument)."""
    pts = validate_scan(scan, lidar)
    r = jnp.linalg.norm(pts, axis=-1)  # (L, P)
    return _valid_from_range_checks(
        r.shape,
        params.neighbor_points,
        lidar.points_per_line,
        out_of_range=(r < lidar.min_range) | (r > lidar.max_range),
        occl_fwd=_shift(r, -1) - r > params.occlusion_thresh,
        occl_bwd=r - _shift(r, -1) > params.occlusion_thresh,
        parallel=(jnp.abs(_shift(r, 1) - r) > params.parallel_thresh * r)
        & (jnp.abs(_shift(r, -1) - r) > params.parallel_thresh * r),
    )


def _valid_from_range_checks(
    shape, N, P, out_of_range, occl_fwd, occl_bwd, parallel
) -> jax.Array:
    """Combine the four checks' raw firing conditions into the validity mask
    (reference sequencing: each check gated on earlier checks not firing;
    dilations per ``features.cpp:18-70``). Shared by the plain and the
    compensated (double-float) paths — only the comparisons differ."""
    j = jnp.arange(P)[None, :]

    # CHECK 1: line edges
    c1 = (j < N) | (j >= P - N)
    not_c1 = ~c1

    # CHECK 2: out-of-range; clears j-N .. j+N
    f2 = not_c1 & out_of_range
    inv2 = jnp.zeros_like(f2)
    for n in range(-N, N + 1):
        inv2 = inv2 | _shift(f2, n, fill=False)

    # CHECK 3: occlusion. Ranges at j+1 valid wherever the check can fire
    # (j <= P-N-1 since ~c1 and N >= 1).
    gate3 = not_c1 & ~f2
    f3a = gate3 & occl_fwd  # case 1: clears j+1..j+N
    f3b = gate3 & occl_bwd  # case 2: clears j-N+1..j
    inv3 = jnp.zeros_like(f3a)
    for n in range(1, N + 1):
        inv3 = inv3 | _shift(f3a, n, fill=False)
    for n in range(0, N):
        inv3 = inv3 | _shift(f3b, -n, fill=False)

    # CHECK 4: beam-parallel surface; clears self only
    gate4 = gate3 & ~(f3a | f3b)
    f4 = gate4 & parallel

    return ~(c1 | inv2 | inv3 | f4)


# ---------------------------------------------------------------------------
# Compensated (double-float) selection path — north-star bit-faithfulness of
# feature SELECTION in f32 (SURVEY §7 "float32 vs float64"): the curvature
# stencil cancels catastrophically in plain f32 at long ranges, flipping the
# sort/threshold decisions the reference's f64 math defines. Double-float
# restores ~49-bit decisions in f32 arithmetic; see ``loam_jax.ops.twofloat``.
# ---------------------------------------------------------------------------


def compute_curvature_df(
    scan: jax.Array, lidar: LidarParams, params: FeatureExtractionParams
):
    """Curvature as a double-float pair ((L, P) hi, (L, P) lo), f32.

    Same expression and association as :func:`compute_curvature` and the f64
    oracle (``oracle/oracle.py::compute_curvature``): per coordinate
    d = -2N p_j + sum_n (p_{j-n} + p_{j+n}); c = d . d — every step
    compensated, so comparisons between resulting values match the f64 order
    to ~2^-48 relative. The -1 sentinel lands exactly on line-edge slots.
    """
    from ..ops import twofloat as tf

    pts = validate_scan(scan, lidar).astype(jnp.float32)
    L, P = lidar.scan_lines, lidar.points_per_line
    N = params.neighbor_points
    padded = jnp.pad(pts, ((0, 0), (N, N), (0, 0)))
    d = tf.DF(*tf.two_prod(pts, jnp.float32(-2.0 * N)))
    for n in range(1, N + 1):
        pair = tf.DF(
            *tf.two_sum(padded[:, N - n : N - n + P], padded[:, N + n : N + n + P])
        )
        d = tf.df_add(d, pair)
    c = tf.df_add(tf.df_add(
        tf.df_sq(tf.DF(d.hi[..., 0], d.lo[..., 0])),
        tf.df_sq(tf.DF(d.hi[..., 1], d.lo[..., 1]))),
        tf.df_sq(tf.DF(d.hi[..., 2], d.lo[..., 2])),
    )
    j = jnp.arange(P)
    interior = ((j >= N) & (j < P - N))[None, :]
    hi = jnp.where(interior, c.hi, jnp.float32(-1.0))
    lo = jnp.where(interior, c.lo, jnp.float32(0.0))
    return hi, lo


def compute_valid_points_df(
    scan: jax.Array, lidar: LidarParams, params: FeatureExtractionParams
) -> jax.Array:
    """Validity mask with all range comparisons in double-float.

    Matches the f64 oracle's decisions (``oracle/oracle.py::
    compute_valid_points``) wherever comparison margins exceed ~2^-45
    relative — ranges, range differences (occlusion) and the beam-parallel
    products are each compensated before comparing.
    """
    from ..ops import twofloat as tf

    pts = validate_scan(scan, lidar).astype(jnp.float32)

    def df_shift(x: "tf.DF", k: int) -> "tf.DF":
        return tf.DF(_shift(x.hi, k), _shift(x.lo, k))

    def df_abs(x: "tf.DF") -> "tf.DF":
        neg = (x.hi < 0) | ((x.hi == 0) & (x.lo < 0))
        return tf.DF(jnp.where(neg, -x.hi, x.hi), jnp.where(neg, -x.lo, x.lo))

    r2 = tf.df_add(tf.df_add(
        tf.DF(*tf.two_prod(pts[..., 0], pts[..., 0])),
        tf.DF(*tf.two_prod(pts[..., 1], pts[..., 1]))),
        tf.DF(*tf.two_prod(pts[..., 2], pts[..., 2])),
    )
    r = tf.df_sqrt(r2)
    r_next = df_shift(r, -1)
    r_prev = df_shift(r, 1)
    # thresholds carried at full f64 value (df), in case they are not
    # exactly f32-representable
    pr = tf.df_mul(r, tf.df_from_scalar(params.parallel_thresh))
    occl = tf.df_from_scalar(params.occlusion_thresh)
    return _valid_from_range_checks(
        r.hi.shape,
        params.neighbor_points,
        lidar.points_per_line,
        out_of_range=tf.df_lt(r, tf.df_from_scalar(lidar.min_range))
        | tf.df_gt(r, tf.df_from_scalar(lidar.max_range)),
        occl_fwd=tf.df_gt(tf.df_sub(r_next, r), occl),
        occl_bwd=tf.df_gt(tf.df_sub(r, r_next), occl),
        parallel=tf.df_gt(df_abs(tf.df_sub(r_prev, r)), pr)
        & tf.df_gt(df_abs(tf.df_sub(r_next, r)), pr),
    )
