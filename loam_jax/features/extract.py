"""Feature extraction driver: sector sort + greedy NMS pick.

Reference: ``extractFeatures`` (``features-inl.h:11-50``) with the sector
pickers (``features-inl.h:137-180``). The reference walks each scan line's
sectors in order, sorts each sector slice by curvature, then greedily picks
edge features (descending curvature) and planar features (ascending), where
every accepted feature suppresses (invalidates) points within
``neighbor_points - 1`` indices — including across the *next* sector's
boundary. Sectors within a line are therefore order-dependent; scan lines are
independent (suppression can never cross a line: accepted features always sit
>= neighbor_points from line ends).

Array mapping:
  * lines  -> ``vmap`` (fully parallel),
  * sectors -> python-unrolled loop carrying the per-line validity mask
    (static per-sector mask windows),
  * the greedy pick -> an unrolled ``lax.scan`` over the sorted sector slots.

Exactness: candidates are prefiltered by threshold only; a candidate that
is masked when visited is a no-op that does not count toward the cap —
exactly the reference's live ``valid_mask[idx]`` check inside its greedy
loop (``features-inl.h:144``). The serial pass therefore walks every sorted
sector slot, but each step touches only a ~(P/S + 2(neighbor_points-1))-wide
STATIC window of the line mask (the sector plus the cross-sector
suppression reach) — the sector loop is python-unrolled so the window
bounds are static. The windowing cuts the mask traffic of each step
~number_sectors-fold and needs no per-sector gathers or compactions.

Tie-breaking: the reference uses unstable ``std::sort`` so curvature ties have
implementation-defined order. We pin the canonical order = stable ascending by
(curvature, index) (descending pass = exact reverse). The NumPy oracle uses
the same rule, so oracle/kernel comparisons are exact (SURVEY §7 "sorting
ties").
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..params import FeatureExtractionParams, LidarParams
from .curvature import compute_curvature, compute_valid_points, validate_scan
from .types import FeatureSet


def _sector_layout(lidar: LidarParams, params: FeatureExtractionParams):
    """Static (S, S_max) within-line position indices + slot-valid flags.

    Sector s covers [s*pps, (s+1)*pps) except the last which absorbs the
    remainder (``features-inl.h:32-35``).
    """
    P, S = lidar.points_per_line, params.number_sectors
    pps = P // S
    s_max = P - (S - 1) * pps
    pos = np.zeros((S, s_max), dtype=np.int32)
    slot_valid = np.zeros((S, s_max), dtype=bool)
    for s in range(S):
        size = s_max if s == S - 1 else pps
        pos[s, :size] = s * pps + np.arange(size)
        slot_valid[s, :size] = True
        pos[s, size:] = P - 1  # in-bounds dummy for gathers
    return jnp.asarray(pos), jnp.asarray(slot_valid), s_max


def _greedy_pass(
    mask: jax.Array,
    candidates: jax.Array,
    max_feats: int,
    nms_halfwidth: int,
    offset: int = 0,
) -> Tuple[jax.Array, jax.Array]:
    """Serial greedy pick over ordered candidates.

    Every step uses only iota-compare/select/reduce vector ops (no
    gather, scatter or dynamic update), so the step fuses into one
    elementwise kernel under ``vmap``. The loop is unrolled (``lax.scan``
    unroll) to amortize per-iteration control overhead.

    Args:
      mask: (W,) current validity mask (bool) — a width-W window of the line
        starting at point index ``offset`` (the full line when offset=0).
      candidates: (K,) within-line point indices in processing order, -1 pad.
        Every non-negative candidate must lie inside the window.
      max_feats: reference cap; up to ``max_feats + 1`` accepted (§2.3(3)).
      nms_halfwidth: neighbor_points; accept clears idx-(n-1) .. idx+(n-1)
        (clipped to the window — callers size windows to cover the reach).
      offset: window start (static), subtracted from candidate indices for
        mask addressing; picks keep the within-line index.

    Returns: (new_mask, picks (max_feats+1,) int32 with -1 padding).
    """
    cap = max_feats + 1
    W = mask.shape[0]
    picks0 = jnp.full((cap,), -1, dtype=jnp.int32)
    iot = jnp.arange(W, dtype=jnp.int32) + jnp.int32(offset)
    cap_iot = jnp.arange(cap, dtype=jnp.int32)

    def body(state, idx):
        mask, count, picks = state
        # Processing stops exactly after the (max+1)-th accept: a candidate is
        # visited iff count_before <= max (break fires only when count > max).
        live = jnp.any((iot == idx) & mask)
        ok = (idx >= 0) & (count <= max_feats) & live
        picks = jnp.where((cap_iot == count) & ok, idx, picks)
        mask = mask & ~(ok & (jnp.abs(iot - idx) <= nms_halfwidth - 1))
        count = count + ok.astype(jnp.int32)
        return (mask, count, picks), None

    (mask, _, picks), _ = lax.scan(
        body, (mask, jnp.int32(0), picks0), candidates, unroll=8
    )
    return mask, picks


def _sector_sort(c_all, cl_all, pos_b):
    """Sort every (line, sector) slice ascending by curvature.

    One batched stable ``lax.sort`` along the slice axis. Returns (sorted
    hi, sorted lo, sorted positions); lo is zeros when ``cl_all`` is None.
    With a lo part the sort is lexicographic on the double-float (hi, lo)
    pair; stability pins the oracle's canonical (curvature, index) tie
    order.
    """
    if cl_all is not None:
        return lax.sort(
            (c_all, cl_all, pos_b), dimension=-1, num_keys=2, is_stable=True
        )
    sc_all, spos_all = lax.sort(
        (c_all, pos_b), dimension=-1, num_keys=1, is_stable=True
    )
    return sc_all, jnp.zeros_like(sc_all), spos_all


@functools.partial(jax.jit, static_argnames=("lidar", "params"))
def extract_features(
    scan: jax.Array,
    lidar: LidarParams,
    params: FeatureExtractionParams = FeatureExtractionParams(),
) -> FeatureSet:
    """Extract LOAM edge/planar features from a range-image scan.

    Args:
      scan: (scan_lines, points_per_line, 3) or flat (L*P, 3) row-major.
    Returns:
      FeatureSet with fixed capacities from ``params`` (slot order matches
      the reference's output order).

    With ``params.precise_selection`` (default) and an f32 scan, all
    selection decisions run in compensated double-float — bit-faithful to
    the reference's f64 selection (see ``curvature.compute_curvature_df``).
    """
    pts = validate_scan(scan, lidar)
    if params.precise_selection and pts.dtype == jnp.float32:
        from .curvature import compute_curvature_df, compute_valid_points_df

        c_hi, c_lo = compute_curvature_df(pts, lidar, params)
        valid = compute_valid_points_df(pts, lidar, params)
        return _extract_core(pts, c_hi, c_lo, valid, lidar, params)
    curv = compute_curvature(pts, lidar, params)  # (L, P)
    valid = compute_valid_points(pts, lidar, params)  # (L, P)
    return extract_features_given(scan, curv, valid, lidar, params)


def select_points(pts: jax.Array, picks: jax.Array) -> jax.Array:
    """Per-line coordinate selection: out[l, c] = pts[l, picks[l, c]].

    ``pts`` (L, P, 3), ``picks`` (L, C) within-line indices; negative picks
    give zero rows. Returns (L, C, 3). Reference: the copy-out of
    ``scan.at(idx)`` into the output vectors (``features-inl.h:146,168``).
    """
    sel = jnp.take_along_axis(pts, jnp.maximum(picks, 0)[..., None], axis=1)
    return jnp.where(picks[..., None] >= 0, sel, 0)


def extract_features_batch(
    scans: jax.Array,
    lidar: LidarParams,
    params: FeatureExtractionParams = FeatureExtractionParams(),
):
    """:func:`extract_features` ``vmap``-ed over a leading frame axis."""
    return jax.vmap(lambda s: extract_features(s, lidar, params))(scans)


@functools.partial(jax.jit, static_argnames=("lidar", "params"))
def extract_features_given(
    scan: jax.Array,
    curv: jax.Array,
    valid: jax.Array,
    lidar: LidarParams,
    params: FeatureExtractionParams = FeatureExtractionParams(),
) -> FeatureSet:
    """Feature pick from precomputed curvature (L, P) and validity (L, P).

    Split out so callers (and parity tests) can control the exact curvature
    values fed to the tie-sensitive greedy stage.
    """
    pts = validate_scan(scan, lidar)
    return _extract_core(pts, curv, None, valid, lidar, params)


def _extract_core(
    pts: jax.Array,
    curv: jax.Array,
    curv_lo,
    valid: jax.Array,
    lidar: LidarParams,
    params: FeatureExtractionParams,
) -> FeatureSet:
    """Sector sort + greedy pick + copy-out. ``curv_lo`` (optional) is the
    double-float low part of the curvature: when given, sorting and
    threshold comparisons are lexicographic on (hi, lo) — the f64 decision
    order."""
    L, P = lidar.scan_lines, lidar.points_per_line
    valid = valid.reshape(L, P)
    with jax.named_scope("sector_sort"):
        cand_e_all, cand_p_all = _candidates(curv, curv_lo, lidar, params)
    with jax.named_scope("greedy_nms"):
        edge_picks, planar_picks = _greedy_nms(
            valid, cand_e_all, cand_p_all, lidar, params
        )

    line_offsets = (jnp.arange(L, dtype=jnp.int32) * P)[:, None, None]

    def flat_meta(picks, cap_total):
        flat_idx = jnp.where(picks >= 0, picks + line_offsets, -1).reshape(cap_total)
        return flat_idx >= 0, flat_idx

    e_cap = params.edge_capacity(lidar)
    p_cap = params.planar_capacity(lidar)
    em, ei = flat_meta(edge_picks, e_cap)
    pm, pi = flat_meta(planar_picks, p_cap)

    # Coordinate copy-out: one per-line gather over BOTH classes. Negative
    # picks yield zero rows, matching the masked-padding convention.
    e_flat = edge_picks.reshape(L, -1)
    ce = e_flat.shape[1]
    cat = jnp.concatenate([e_flat, planar_picks.reshape(L, -1)], axis=1)
    with jax.named_scope("assemble"):
        sel = select_points(pts, cat)
    ep = sel[:, :ce].reshape(e_cap, 3)
    pp = sel[:, ce:].reshape(p_cap, 3)
    return FeatureSet(ep, em, ei, pp, pm, pi)


def _candidates(curv, curv_lo, lidar: LidarParams,
                params: FeatureExtractionParams):
    """Threshold-prefiltered candidate positions per (line, sector, class),
    in processing order: ((L, S, s_max) edge, (L, S, s_max) planar), -1 =
    not a candidate. Edges walk descending curvature, planars ascending."""
    L, P = lidar.scan_lines, lidar.points_per_line
    S = params.number_sectors
    curv = curv.reshape(L, P)

    # slot validity is derived from the +inf sort key downstream; the
    # layout's flags are unused here
    pos_all, _, s_max = _sector_layout(lidar, params)
    pps = P // S

    # Sort ALL (line, sector) slices in ONE batched sort, hoisted out of the
    # sector scan (the sort does not depend on the evolving NMS mask).
    # Position rides along as a sort value, so no post-sort gather. The
    # precise path sorts lexicographically on the double-float (hi, lo)
    # pair; stability pins the oracle's canonical (curvature, index) tie
    # order.
    # Sector slicing is pure static slices + pads (sectors are contiguous
    # ranges; only the last absorbs the remainder) — no (L, P) gather.

    def to_sectors(x2d, fill):
        parts = []
        for s in range(S):
            size = s_max if s == S - 1 else pps
            sl = lax.slice_in_dim(x2d, s * pps, s * pps + size, axis=1)
            if size < s_max:
                sl = jnp.pad(
                    sl, ((0, 0), (0, s_max - size)), constant_values=fill
                )
            parts.append(sl)
        return jnp.stack(parts, axis=1)  # (L, S, s_max)

    c_all = to_sectors(curv, jnp.inf)  # padding slots carry +inf keys
    pos_b = jnp.broadcast_to(pos_all[None], c_all.shape)
    if curv_lo is not None:
        cl = curv_lo.reshape(L, P)
        # canonicalize -0.0 lo parts: hi + (-0.0) and hi + (+0.0) are the
        # SAME f64 value, but lax.sort's total order puts -0.0 first; the
        # f64 oracle treats them as equal and falls to the position
        # tie-break
        cl = jnp.where(cl == 0, jnp.asarray(0.0, cl.dtype), cl)
        cl_all = to_sectors(cl, 0.0)
    else:
        cl_all = None
    sc_all, sc_lo_all, spos_all = _sector_sort(c_all, cl_all, pos_b)
    # slot validity needs no sort operand: padding slots (and only they)
    # carry the +inf key — real curvature is finite (bounded sums of squares)
    ssv_all = sc_all < jnp.inf

    if curv_lo is not None:
        from ..ops import twofloat as tf

        et = tf.df_from_scalar(params.edge_feat_threshold)
        pt = tf.df_from_scalar(params.planar_feat_threshold)

        def above_edge(hi, lo):
            return (hi > et.hi) | ((hi == et.hi) & (lo > et.lo))

        def below_planar(hi, lo):
            return (hi < pt.hi) | ((hi == pt.hi) & (lo < pt.lo))

    else:
        edge_thresh = jnp.asarray(params.edge_feat_threshold, curv.dtype)
        planar_thresh = jnp.asarray(params.planar_feat_threshold, curv.dtype)

        def above_edge(hi, lo):
            return hi > edge_thresh

        def below_planar(hi, lo):
            return hi < planar_thresh

    # Candidate lists, hoisted: threshold-prefiltered sorted positions per
    # (line, sector, class); -1 = not a candidate. Edge pass walks
    # descending curvature = reversed stable-sorted order.
    cand_e_all = jnp.where(above_edge(sc_all, sc_lo_all) & ssv_all, spos_all, -1)[
        ..., ::-1
    ]
    cand_p_all = jnp.where(below_planar(sc_all, sc_lo_all) & ssv_all, spos_all, -1)
    return cand_e_all, cand_p_all


def _greedy_nms(valid, cand_e_all, cand_p_all, lidar: LidarParams,
                params: FeatureExtractionParams):
    """Serial greedy pick of every (line, sector): ((L, S, max_e + 1) edge,
    (L, S, max_p + 1) planar) within-line picks, -1 padded."""
    P = lidar.points_per_line
    N = params.neighbor_points
    S = params.number_sectors
    max_e = params.max_edge_feats_per_sector
    max_p = params.max_planar_feats_per_sector
    _, _, s_max = _sector_layout(lidar, params)
    pps = P // S

    # Sector loop is PYTHON-unrolled (S is static): every sector's greedy
    # passes then operate on a STATIC slice of the line mask — the sector's
    # span plus an (N-1)-point margin each side (the reach of cross-sector
    # suppression, §2.3(4)) — instead of the full line; a ~(P/S)-wide
    # slice cuts the mask traffic of each serial step ~S-fold.
    # Candidates are threshold-prefiltered only (no mask gather, no
    # compaction): a candidate that is masked (or suppressed later) is
    # visited as a no-op that does not count toward the cap — exactly the
    # reference's live ``valid_mask[idx]`` check (``features-inl.h:144``).
    def line_fn(valid_l, cand_e_l, cand_p_l):
        mask = valid_l
        e_picks, p_picks = [], []
        for s in range(S):
            size = s_max if s == S - 1 else pps
            lo = max(s * pps - (N - 1), 0)
            hi = min(s * pps + size + (N - 1), P)
            msl = lax.slice_in_dim(mask, lo, hi, axis=0)

            msl, pe = _greedy_pass(msl, cand_e_l[s], max_e, N, offset=lo)
            msl, pp_ = _greedy_pass(msl, cand_p_l[s], max_p, N, offset=lo)

            mask = lax.dynamic_update_slice_in_dim(mask, msl, lo, axis=0)
            e_picks.append(pe)
            p_picks.append(pp_)
        return jnp.stack(e_picks), jnp.stack(p_picks)

    return jax.vmap(line_fn)(valid, cand_e_all, cand_p_all)
