"""Batched feature association: source features -> target line/plane fits.

Vectorized form of the reference's per-point association loops
(``registration.cpp:23-62`` edges, ``registration.cpp:65-103`` planes): every
source feature is transformed by the current estimate, matched to its k
nearest target features (radius-filtered), and — if enough neighbors survive —
a line/plane is fit to the neighborhood, with the reference's planarity /
co-linearity guards applied with their *effective* semantics (SURVEY
§2.3(1,2)): the line condition-number guard never fires (dead code in the
reference) unless ``params.enforce_line_condition``; the plane guard compares
the SIGNED mean residual.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import fit_line, fit_plane
from ..neighbors import knn
from ..params import RegistrationParams


class EdgeAssociations(NamedTuple):
    """Per-source-edge-slot association results ((E, ...) leaves).

    ``line_a``/``line_b`` are two points on the fitted target line
    (garbage where ``valid`` is False); ``match`` is the nearest target index
    (-1 when invalid) mirroring the reference's ``(src, tgt)`` pair list.
    """

    line_a: jax.Array
    line_b: jax.Array
    valid: jax.Array
    match: jax.Array


class PlaneAssociations(NamedTuple):
    """Per-source-planar-slot association results ((Q, ...) leaves)."""

    normal: jax.Array
    d: jax.Array
    valid: jax.Array
    match: jax.Array


def associate_edges(
    query_pts: jax.Array,
    query_mask: jax.Array,
    target_pts: jax.Array,
    target_mask: jax.Array,
    params: RegistrationParams,
    knn_result=None,
    neighbor_pts=None,
) -> EdgeAssociations:
    """Edge association (reference ``associateEdges``, ``registration.cpp:23-62``).

    Args:
      query_pts: (E, 3) source edge features already transformed by the
        current estimate (the reference transforms per point at
        ``registration.cpp:34``; callers here transform the whole set once).
      query_mask: (E,) validity of source slots.
      target_pts / target_mask: (M, 3) / (M,) padded target edge set.
      knn_result: optional precomputed KnnResult for these queries (e.g. from
        the grid backend); when None the exact brute-force search runs here.
      neighbor_pts: optional pre-gathered (E, k, 3) neighbor coordinates —
        required when ``target_pts`` is not locally addressable (sharded
        targets: the distributed search returns coordinates directly).
    """
    res = knn_result
    if res is None:
        res = knn(
            query_pts,
            target_pts,
            target_mask,
            k=params.num_edge_neighbors,
            max_dist=params.max_edge_neighbor_dist,
        )
    count = jnp.sum(res.mask.astype(jnp.int32), axis=-1)
    enough = count >= params.min_line_fit_points
    neighbors = (
        target_pts[res.indices] if neighbor_pts is None else neighbor_pts
    )  # (E, k, 3)
    a, b, cond = fit_line(neighbors, res.mask)
    # Degenerate fits (identical neighbors etc.) may produce non-finite
    # output; such slots must never contribute (0 * nan poisons the normal
    # equations). The reference cannot hit this (k distinct target points).
    finite = jnp.isfinite(a).all(-1) & jnp.isfinite(b).all(-1)
    valid = query_mask & enough & finite
    if params.enforce_line_condition:
        # The reference *intends* this guard but its condition number is
        # always DBL_MAX (``geometry.cpp:55-56``), so default is off.
        valid = valid & (cond >= params.min_line_condition_number)
    match = jnp.where(valid, res.indices[:, 0], -1).astype(jnp.int32)
    a = jnp.where(valid[:, None], a, jnp.asarray([0.0, 0.0, 0.1], a.dtype))
    b = jnp.where(valid[:, None], b, jnp.asarray([0.0, 0.0, -0.1], b.dtype))
    return EdgeAssociations(a, b, valid, match)


def associate_planes(
    query_pts: jax.Array,
    query_mask: jax.Array,
    target_pts: jax.Array,
    target_mask: jax.Array,
    params: RegistrationParams,
    knn_result=None,
    neighbor_pts=None,
) -> PlaneAssociations:
    """Plane association (reference ``associatePlanes``, ``registration.cpp:65-103``)."""
    res = knn_result
    if res is None:
        res = knn(
            query_pts,
            target_pts,
            target_mask,
            k=params.num_plane_neighbors,
            max_dist=params.max_plane_neighbor_dist,
        )
    count = jnp.sum(res.mask.astype(jnp.int32), axis=-1)
    enough = count >= params.min_plane_fit_points
    neighbors = (
        target_pts[res.indices] if neighbor_pts is None else neighbor_pts
    )  # (Q, k, 3)
    normal, d, avg_dist = fit_plane(neighbors, res.mask)
    # Signed mean residual, matching ``geometry.cpp:71`` + guard at
    # ``registration.cpp:90`` (rejects only when avg_dist > threshold).
    # Non-finite fits (degenerate neighborhoods in f32) must be rejected
    # explicitly: a nan avg_dist slips through the ``~(x > t)`` comparison.
    finite = jnp.isfinite(normal).all(-1) & jnp.isfinite(d) & jnp.isfinite(avg_dist)
    valid = (
        query_mask & enough & finite & ~(avg_dist > params.max_avg_point_plane_dist)
    )
    match = jnp.where(valid, res.indices[:, 0], -1).astype(jnp.int32)
    normal = jnp.where(valid[:, None], normal, jnp.asarray([0.0, 0.0, 1.0], normal.dtype))
    d = jnp.where(valid, d, 0.0)
    return PlaneAssociations(normal, d, valid, match)
