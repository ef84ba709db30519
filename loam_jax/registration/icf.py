"""Iterative Closest Feature: the outer registration loop.

JAX equivalent of reference ``registerFeatures``
(``registration-inl.h:11-78``): up to ``max_iterations`` rounds of
(re-)association + delta-pose solve + left-composition, with the reference's
exact termination semantics:

  * ``INSUFFICIENT_ASSOCIATIONS`` bails *before* solving — the returned pose
    is the estimate entering that iteration, and the iteration records no
    diagnostics (SURVEY §2.3(9)).
  * Convergence is checked *after* the update is applied, so a converged run
    includes its final small update (SURVEY §2.3(10)).
  * The update composes on the left: ``est = delta o est``
    (``registration-inl.h:65``).

The loop is a ``lax.while_loop`` (iterations stop as soon as termination
fires — no wasted device work) and is vmappable over a pair axis for batched
multi-pair registration (the batched loop runs until every pair terminates,
with per-pair masking).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..debug import tap_finite
from ..features.types import FeatureSet
from ..geometry import Pose3, quat_multiply, quat_normalize, quat_rotate
from ..neighbors import build_grid, knn, knn_grid
from ..params import RegistrationParams, TerminationType
from .associate import associate_edges, associate_planes
from .detail import IterationInfo, RegistrationDetail
from .solver import _Problem, lm_solve


class _LoopState(NamedTuple):
    est: Pose3
    i: jax.Array  # current outer iteration index
    status: jax.Array  # int32 TerminationType code
    done: jax.Array  # bool
    detail: IterationInfo  # stacked (max_iterations, ...) slots


def _angle_from_identity(q: jax.Array) -> jax.Array:
    """Rotation angle of a unit quaternion (Eigen ``angularDistance`` to I)."""
    return 2.0 * jnp.arctan2(jnp.linalg.norm(q[..., 1:], axis=-1), jnp.abs(q[..., 0]))


@functools.partial(jax.jit, static_argnames=("params", "with_matches"))
def _register(
    source: FeatureSet,
    target: FeatureSet,
    init: Pose3,
    params: RegistrationParams,
    with_matches: bool,
) -> Tuple[Pose3, RegistrationDetail]:
    return _register_impl(source, target, init, params, with_matches)


def _register_impl(
    source: FeatureSet,
    target: FeatureSet,
    init: Pose3,
    params: RegistrationParams,
    with_matches: bool,
    custom_knn=None,
) -> Tuple[Pose3, RegistrationDetail]:
    """Unjitted registration body.

    ``custom_knn``: optional ``(edge_fn, plane_fn)``, each mapping
    transformed query points ``(Q, 3)`` to ``(KnnResult, neighbor_pts)`` —
    the hook the distributed layer uses to swap in the sharded-target
    search (``parallel.distributed``) while keeping the full loop + detail
    machinery.
    """
    dtype = source.edge_points.dtype
    E = source.edge_points.shape[0]
    Q = source.planar_points.shape[0]
    I = params.max_iterations
    Em = E if with_matches else 0
    Qm = Q if with_matches else 0

    detail0 = IterationInfo(
        target_T_source_init=Pose3.identity(dtype, (I,)),
        estimate_update=Pose3.identity(dtype, (I,)),
        edge_match=jnp.full((I, Em), -1, jnp.int32),
        plane_match=jnp.full((I, Qm), -1, jnp.int32),
        edge_count=jnp.zeros((I,), jnp.int32),
        plane_count=jnp.zeros((I,), jnp.int32),
        edge_knn_overflow=jnp.zeros((I,), jnp.int32),
        plane_knn_overflow=jnp.zeros((I,), jnp.int32),
    )
    state0 = _LoopState(
        est=Pose3(init.rotation.astype(dtype), init.translation.astype(dtype)),
        i=jnp.int32(0),
        status=jnp.int32(TerminationType.MAX_ITER),
        done=jnp.asarray(False),
        detail=detail0,
    )

    # The target is fixed across outer iterations, so acceleration structures
    # build ONCE here (the reference builds its KD-trees once too,
    # ``registration-inl.h:20-23``). The grid backend is exact up to
    # ``grid_max_per_cell`` voxel occupancy and turns each per-iteration
    # search into two binary searches + one gather per (query, cell).
    use_grid = (
        custom_knn is None
        and params.search_backend == "grid"
        and params.max_edge_neighbor_dist > 0
        and params.max_plane_neighbor_dist > 0
    )
    if custom_knn is not None:
        edge_knn, plane_knn = custom_knn
    elif use_grid:
        edge_grid = build_grid(
            target.edge_points, target.edge_mask, params.max_edge_neighbor_dist
        )
        plane_grid = build_grid(
            target.planar_points, target.planar_mask, params.max_plane_neighbor_dist
        )

        def edge_knn(q):
            # overflow (cells over grid_max_per_cell occupancy) is threaded
            # into the per-iteration detail — the grid backend's truncation
            # signal must never be silently discarded (its docstring
            # contract; the reference's KD-tree is exact, kdtree.cpp:10-28)
            res, ovf = knn_grid(
                edge_grid,
                q,
                params.num_edge_neighbors,
                params.max_edge_neighbor_dist,
                params.grid_max_per_cell,
            )
            return res, None, ovf

        def plane_knn(q):
            res, ovf = knn_grid(
                plane_grid,
                q,
                params.num_plane_neighbors,
                params.max_plane_neighbor_dist,
                params.grid_max_per_cell,
            )
            return res, None, ovf

    else:
        def edge_knn(q):
            return knn(
                q, target.edge_points, target.edge_mask,
                params.num_edge_neighbors, params.max_edge_neighbor_dist,
            ), None

        def plane_knn(q):
            return knn(
                q, target.planar_points, target.planar_mask,
                params.num_plane_neighbors, params.max_plane_neighbor_dist,
            ), None

    def cond(state: _LoopState):
        return (state.i < I) & ~state.done

    def _call_knn(fn, q):
        """Normalize knn closures: (res, nbr) or (res, nbr, overflow)."""
        out = fn(q)
        if len(out) == 3:
            return out[0], out[1], out[2].astype(jnp.int32)
        return out[0], out[1], jnp.int32(0)

    def body(state: _LoopState) -> _LoopState:
        est = state.est
        qe = est.act(source.edge_points)
        qp = est.act(source.planar_points)
        with jax.named_scope("knn"):
            e_res, e_nbr, e_ovf = _call_knn(edge_knn, qe)
            p_res, p_nbr, p_ovf = _call_knn(plane_knn, qp)
        ea = associate_edges(
            qe,
            source.edge_mask,
            target.edge_points,
            target.edge_mask,
            params,
            knn_result=e_res,
            neighbor_pts=e_nbr,
        )
        pa = associate_planes(
            qp,
            source.planar_mask,
            target.planar_points,
            target.planar_mask,
            params,
            knn_result=p_res,
            neighbor_pts=p_nbr,
        )
        n_edge = jnp.sum(ea.valid, dtype=jnp.int32)
        n_plane = jnp.sum(pa.valid, dtype=jnp.int32)
        insufficient = (n_edge + n_plane) < params.min_associations

        prior_offset = est.compose(
            Pose3(init.rotation.astype(dtype), init.translation.astype(dtype)).inverse()
        )
        problem = _Problem(
            pts_edge=qe, edge=ea, pts_plane=qp, plane=pa,
            prior_offset=prior_offset,
        )
        delta, _ = lax.cond(
            insufficient,
            lambda p: (Pose3.identity(dtype), jnp.asarray(0.0, dtype)),
            lambda p: lm_solve(p, params),
            problem,
        )

        new_est = Pose3(
            quat_normalize(quat_multiply(delta.rotation, est.rotation)),
            quat_rotate(delta.rotation, est.translation) + delta.translation,
        )
        # LOAM_DEBUG_NANS=1 stages per-iteration poisoning checks into the
        # loop (no-op otherwise); see loam_jax/debug.py.
        tap_finite(
            {"delta": delta, "est": new_est, "lines": ea.line_a,
             "planes": pa.normal},
            where="icf.iteration",
        )
        angle = _angle_from_identity(delta.rotation)
        shift = jnp.linalg.norm(delta.translation, axis=-1)
        converged = (angle < params.rotation_convergence_thresh) & (
            shift < params.position_convergence_thresh
        )

        est_out = jax.tree.map(
            lambda n, o: jnp.where(insufficient, o, n), new_est, est
        )
        status = jnp.where(
            insufficient,
            jnp.int32(TerminationType.INSUFFICIENT_ASSOCIATIONS),
            jnp.where(
                converged,
                jnp.int32(TerminationType.CONVERGED),
                jnp.int32(TerminationType.MAX_ITER),
            ),
        )

        # Record diagnostics (reference records after the solve; an
        # insufficient iteration writes nothing, ``registration-inl.h:45-48``).
        # Row writes use iota-compare + where instead of scatters, which
        # fuse into the loop body's elementwise kernels under vmap.
        row = jnp.where(insufficient, I, state.i)  # I -> dropped
        rows = jnp.arange(I, dtype=row.dtype)
        hit = rows == row  # (I,)

        def put(buf, val):
            # buf (I, ...) <- val (...) at position `row` (no-op when row==I)
            h = hit.reshape((I,) + (1,) * (buf.ndim - 1))
            return jnp.where(h, val[None], buf)

        d = state.detail
        detail = IterationInfo(
            target_T_source_init=Pose3(
                put(d.target_T_source_init.rotation, est.rotation),
                put(d.target_T_source_init.translation, est.translation),
            ),
            estimate_update=Pose3(
                put(d.estimate_update.rotation, delta.rotation),
                put(d.estimate_update.translation, delta.translation),
            ),
            edge_match=put(d.edge_match, ea.match[:Em]),
            plane_match=put(d.plane_match, pa.match[:Qm]),
            edge_count=jnp.where(hit, n_edge, d.edge_count),
            plane_count=jnp.where(hit, n_plane, d.plane_count),
            edge_knn_overflow=jnp.where(hit, e_ovf, d.edge_knn_overflow),
            plane_knn_overflow=jnp.where(hit, p_ovf, d.plane_knn_overflow),
        )

        return _LoopState(
            est=est_out,
            i=state.i + 1,
            status=status,
            done=insufficient | converged,
            detail=detail,
        )

    final = lax.while_loop(cond, body, state0)
    # iterations that ran AND recorded: insufficient terminal one is excluded
    insufficient_end = final.status == TerminationType.INSUFFICIENT_ASSOCIATIONS
    n_rec = jnp.where(insufficient_end, final.i - 1, final.i)
    detail = RegistrationDetail(
        iteration_info=final.detail,
        termination=final.status,
        num_iterations=n_rec.astype(jnp.int32),
    )
    return final.est, detail


def register_features(
    source: FeatureSet,
    target: FeatureSet,
    target_T_source_init: Optional[Pose3] = None,
    params: RegistrationParams = RegistrationParams(),
    with_matches: bool = True,
) -> Tuple[Pose3, RegistrationDetail]:
    """Register a source feature set to a target feature set.

    JAX analogue of reference ``registerFeatures``
    (``registration.h:128-131``): returns the refined ``target_T_source``
    pose and always-on fixed-shape diagnostics (the reference's optional
    ``RegistrationDetail``).

    Args:
      source / target: padded FeatureSets (from ``extract_features`` or
        ``feature_set_from_points``).
      target_T_source_init: initial guess (identity when None).
      params: RegistrationParams (static; part of the jit cache key).
      with_matches: include per-iteration (capacity,)-sized association index
        arrays in the detail (static). Disable for large batched runs.
    """
    if target_T_source_init is None:
        target_T_source_init = Pose3.identity(source.edge_points.dtype)
    return _register(source, target, target_T_source_init, params, with_matches)


def register_features_batch(
    source: FeatureSet,
    target: FeatureSet,
    target_T_source_init: Pose3,
    params: RegistrationParams = RegistrationParams(),
    with_matches: bool = False,
) -> Tuple[Pose3, RegistrationDetail]:
    """Batched multi-pair registration: all leaves carry a leading pair axis.

    The reference processes pairs serially in user code (``README.md:44-60``);
    here one ``vmap`` solves the whole batch in lockstep on one chip (the
    batched while-loop runs until every pair terminates; finished pairs are
    masked). Detail matches are off by default to bound memory.
    """
    return jax.vmap(
        lambda s, t, i: _register(s, t, i, params, with_matches)
    )(source, target, target_T_source_init)
