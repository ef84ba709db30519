"""Distributed (sharded-target) registration and scan-to-map.

SURVEY config 5: the map no longer fits (or shouldn't live) on one chip.
Recipe (scaling-book style):

  * **Sharded kNN**: map/target points are sharded over the mesh's "data"
    axis. Queries are replicated; every device searches its own shard
    (total work divides by D) under ``jax.shard_map``, returning per-device
    top-k lists — indices made global, plus the neighbor *coordinates* so no
    cross-shard gather is ever needed — stacked over a leading device axis.
    The merge (same first-index tie-breaking as the local kernels;
    device-major order = global index order) runs at the jit level, where
    XLA inserts the all-gather (NCCL over NVLink on GPUs).
  * **Sharded registration**: ``_register_impl`` — the FULL single-device
    loop, including ``RegistrationDetail`` — runs at the jit level with its
    kNN hook bound to the sharded search; only the kNN is collective,
    association/fit/solve are replicated (cheap, and every device's control
    flow stays in lockstep so the while_loop terminates identically
    everywhere).
  * **Sharded voxel map**: voxel ownership = hash(voxel) mod D, so every
    voxel has exactly one owner and insertion/dedup is local; the resulting
    distributed map is bit-identical in content to the single-device map.

All ``shard_map`` uses are the modern ``jax.shard_map`` with full
varying-axis type checking (``check_vma``) — device-varying values only ever
leave a shard_map through sharded out_specs or ``psum``.
"""

from __future__ import annotations


from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax, shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..features.types import FeatureSet
from ..geometry import Pose3
from ..map import VoxelMap, voxel_map_empty, voxel_map_insert
from ..map.voxel_map import _voxel_key
from ..neighbors.bruteforce import KnnResult, knn, topk_min
from ..params import RegistrationParams
from ..registration.detail import RegistrationDetail
from ..registration.icf import _register_impl


def sharded_knn(
    queries: jax.Array,
    t_points: jax.Array,
    t_mask: jax.Array,
    k: int,
    max_dist: float,
    mesh: Mesh,
    axis: str = "data",
) -> Tuple[KnnResult, jax.Array]:
    """kNN against a target sharded over ``axis`` (leading capacity dim).

    Local per-shard search runs under ``shard_map``; the per-device top-k
    candidates (global indices, distances, masks, neighbor coordinates) come
    back stacked on a sharded leading device axis and are merged replicated.
    Exact: every true neighbor is in its shard's local top-k.

    Returns (KnnResult with GLOBAL indices, neighbor coords (Q, k, 3)).
    """
    D = mesh.shape[axis]
    M = t_points.shape[0]
    shard = M // D

    def local(q, tp, tm):
        res = knn(q, tp, tm, k, max_dist)
        offset = lax.axis_index(axis) * shard
        nbr = tp[res.indices]  # (Q, k, 3) local gather
        return (
            (res.indices + offset)[None],
            res.distances[None],
            res.mask[None],
            nbr[None],
        )

    rep, sh = P(), P(axis)
    g_idx, g_d, g_m, g_p = shard_map(
        local,
        mesh=mesh,
        in_specs=(rep, sh, sh),
        out_specs=(sh, sh, sh, sh),
    )(queries, t_points, t_mask)

    # replicated merge; device-major candidate order preserves global
    # first-index tie-breaking
    Q = queries.shape[0]
    cand_d = jnp.moveaxis(g_d, 0, 1).reshape(Q, D * k)
    cand_i = jnp.moveaxis(g_idx, 0, 1).reshape(Q, D * k)
    cand_p = jnp.moveaxis(g_p, 0, 1).reshape(Q, D * k, 3)
    cand_m = jnp.moveaxis(g_m, 0, 1).reshape(Q, D * k)
    d = jnp.where(cand_m, cand_d, jnp.inf)
    best_d, pos = topk_min(d, k)
    idx = jnp.take_along_axis(cand_i, pos, axis=1)
    pts = jnp.take_along_axis(cand_p, pos[..., None], axis=1)
    mask = jnp.isfinite(best_d)
    return KnnResult(idx, jnp.where(mask, best_d, jnp.inf), mask), pts


def register_features_sharded(
    source: FeatureSet,
    target: FeatureSet,
    target_T_source_init: Pose3,
    mesh: Mesh,
    params: RegistrationParams = RegistrationParams(),
    axis: str = "data",
    with_matches: bool = False,
) -> Tuple[Pose3, RegistrationDetail]:
    """ICF registration against a target whose features are sharded.

    Target leaves' leading (capacity) axis is sharded over ``axis`` of the
    mesh (capacities must divide the axis size); source and init are
    replicated. Runs the full single-device loop (``_register_impl``) with
    the kNN hook bound to :func:`sharded_knn` — so the return signature and
    diagnostics are IDENTICAL to ``register_features``: (pose, full
    RegistrationDetail).
    """

    def edge_knn(q):
        return sharded_knn(
            q,
            target.edge_points,
            target.edge_mask,
            params.num_edge_neighbors,
            params.max_edge_neighbor_dist,
            mesh,
            axis,
        )

    def plane_knn(q):
        return sharded_knn(
            q,
            target.planar_points,
            target.planar_mask,
            params.num_plane_neighbors,
            params.max_plane_neighbor_dist,
            mesh,
            axis,
        )

    return _register_impl(
        source,
        target,
        target_T_source_init,
        params,
        with_matches=with_matches,
        custom_knn=(edge_knn, plane_knn),
    )


def sharded_map_insert(
    maps: VoxelMap,
    new_points: jax.Array,
    new_mask: jax.Array,
    mesh: Mesh,
    center: Optional[jax.Array] = None,
    keep_radius: float = 0.0,
    axis: str = "data",
) -> Tuple[VoxelMap, jax.Array]:
    """Insert replicated points into a device-sharded voxel map.

    ``maps`` leaves carry a leading device axis (D, C, ...) sharded over
    ``axis``. Voxel ownership = voxel key mod D, so dedup stays local and
    the union of shards equals the single-device map's content. Returns the
    updated sharded map and the total dropped-voxel count.
    """
    D = mesh.shape[axis]
    center_arr = (
        jnp.zeros((3,), maps.points.dtype) if center is None else center
    )
    radius = keep_radius if center is not None else 0.0

    def impl(pts_l, mask_l, new_pts, new_mask, ctr, vox, orig):
        me = lax.axis_index(axis)
        local = VoxelMap(pts_l[0], mask_l[0], vox, orig)
        key = _voxel_key(local, new_pts, new_mask)
        own = (key % D) == me
        m, dropped = voxel_map_insert(
            local, new_pts, new_mask & own, ctr, radius
        )
        return (
            m.points[None],
            m.mask[None],
            lax.psum(dropped, axis),
        )

    rep = P()
    sh = P(axis)
    f = shard_map(
        impl,
        mesh=mesh,
        in_specs=(sh, sh, rep, rep, rep, rep, rep),
        out_specs=(sh, sh, rep),
    )
    pts, mask, dropped = f(
        maps.points, maps.mask, new_points, new_mask, center_arr,
        maps.voxel_size, maps.origin,
    )
    return VoxelMap(pts, mask, maps.voxel_size, maps.origin), dropped


def sharded_map_empty(
    capacity_per_device: int,
    voxel_size: float,
    mesh: Mesh,
    origin=(0.0, 0.0, 0.0),
    dtype=jnp.float32,
    axis: str = "data",
) -> VoxelMap:
    """A (D, C, ...) voxel map placed sharded over the mesh."""
    D = mesh.shape[axis]
    base = voxel_map_empty(capacity_per_device, voxel_size, origin, dtype)
    spec = NamedSharding(mesh, P(axis))
    return VoxelMap(
        jax.device_put(jnp.broadcast_to(base.points, (D,) + base.points.shape), spec),
        jax.device_put(jnp.broadcast_to(base.mask, (D,) + base.mask.shape), spec),
        base.voxel_size,
        base.origin,
    )


# ---------------------------------------------------------------------------
# Composed distributed mapping driver (BASELINE config 5's actual workload):
# extraction -> sharded-target registration -> mod-D sharded map insert, all
# in one jitted step on the mesh. Mirrors the single-device
# ``odometry.scan_to_map.scan_to_map_step`` (the monolithic-target anchor it
# replaces is reference ``registration-inl.h:16-23``).
# ---------------------------------------------------------------------------

import functools

from ..features import extract_features
from ..geometry import quat_conjugate, quat_multiply
from ..odometry.scan_to_map import ScanToMapConfig, ScanToMapState
from ..params import FeatureExtractionParams, LidarParams


def scan_to_map_init_sharded(
    config: ScanToMapConfig,
    mesh: Mesh,
    origin=(0.0, 0.0, 0.0),
    dtype=jnp.float32,
    axis: str = "data",
) -> ScanToMapState:
    """Scan-to-map state whose voxel maps are sharded over the mesh.

    Total capacities match ``config`` (each device owns ``capacity / D``
    slots; capacities must divide the axis size).
    """
    D = mesh.shape[axis]
    if config.edge_capacity % D or config.planar_capacity % D:
        raise ValueError("map capacities must divide the mesh axis size")
    return ScanToMapState(
        edge_map=sharded_map_empty(
            config.edge_capacity // D, config.edge_voxel_size, mesh, origin,
            dtype, axis,
        ),
        planar_map=sharded_map_empty(
            config.planar_capacity // D, config.planar_voxel_size, mesh,
            origin, dtype, axis,
        ),
        world_T_current=Pose3.identity(dtype),
        prev_delta=Pose3.identity(dtype),
        world_T_keyframe=Pose3.identity(dtype),
        frames_since_insert=jnp.int32(-1),
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "lidar", "mesh", "feat_params", "reg_params", "config", "axis"
    ),
)
def scan_to_map_step_sharded(
    state: ScanToMapState,
    scan: jax.Array,
    lidar: LidarParams,
    mesh: Mesh,
    feat_params: FeatureExtractionParams = FeatureExtractionParams(),
    reg_params: RegistrationParams = RegistrationParams(prior_weight=300.0),
    config: ScanToMapConfig = ScanToMapConfig(),
    axis: str = "data",
):
    """One scan-to-map step against device-sharded voxel maps.

    Same flow and semantics as the single-device ``scan_to_map_step``
    (constant-velocity init, first-frame handling, keyframe-gated insert),
    with the registration target sharded over the mesh (collective kNN via
    :func:`sharded_knn`) and map insertion owner-partitioned
    (:func:`sharded_map_insert`). Returns (state, world pose, full
    RegistrationDetail).
    """
    feats = extract_features(scan, lidar, feat_params)
    dtype = feats.edge_points.dtype

    init = state.world_T_current.compose(state.prev_delta)
    # flat device-major views of the sharded maps: (D, C, ...) -> (D*C, ...)
    # keeps the P(axis) sharding on the merged leading axis
    target = FeatureSet(
        edge_points=state.edge_map.points.reshape(-1, 3),
        edge_mask=state.edge_map.mask.reshape(-1),
        edge_indices=jnp.full((state.edge_map.mask.size,), -1, jnp.int32),
        planar_points=state.planar_map.points.reshape(-1, 3),
        planar_mask=state.planar_map.mask.reshape(-1),
        planar_indices=jnp.full((state.planar_map.mask.size,), -1, jnp.int32),
    )
    world_T_new, detail = register_features_sharded(
        feats, target, init, mesh, reg_params, axis
    )
    first = state.frames_since_insert < 0
    world_T_new = jax.tree.map(
        lambda f, s: jnp.where(first, f, s), state.world_T_current, world_T_new
    )

    rel_q = quat_multiply(
        quat_conjugate(state.world_T_keyframe.rotation), world_T_new.rotation
    )
    angle = 2.0 * jnp.arctan2(jnp.linalg.norm(rel_q[1:]), jnp.abs(rel_q[0]))
    dist = jnp.linalg.norm(
        world_T_new.translation - state.world_T_keyframe.translation
    )
    insert = first | (dist > config.keyframe_dist) | (angle > config.keyframe_angle)

    # gate the insert through the mask (not lax.cond) so the collective
    # insert runs unconditionally with no points when not keyframing —
    # eviction is radius-gated identically to the single-device driver's
    # cond by skipping it when nothing is inserted
    ew = world_T_new.act(feats.edge_points)
    pw = world_T_new.act(feats.planar_points)
    center = world_T_new.translation

    def do_insert(maps):
        edge_map, planar_map = maps
        edge_map, _ = sharded_map_insert(
            edge_map, ew, feats.edge_mask, mesh, center, config.keep_radius,
            axis,
        )
        planar_map, _ = sharded_map_insert(
            planar_map, pw, feats.planar_mask, mesh, center,
            config.keep_radius, axis,
        )
        return edge_map, planar_map

    edge_map, planar_map = lax.cond(
        insert, do_insert, lambda m: m, (state.edge_map, state.planar_map)
    )

    prev_delta = state.world_T_current.inverse().compose(world_T_new).normalize()
    new_state = ScanToMapState(
        edge_map=edge_map,
        planar_map=planar_map,
        world_T_current=world_T_new.normalize(),
        prev_delta=prev_delta,
        world_T_keyframe=jax.tree.map(
            lambda k, n: jnp.where(insert, n, k), state.world_T_keyframe,
            world_T_new,
        ),
        frames_since_insert=jnp.where(
            insert, 0, jnp.maximum(state.frames_since_insert, 0) + 1
        ).astype(jnp.int32),
    )
    return new_state, world_T_new, detail
