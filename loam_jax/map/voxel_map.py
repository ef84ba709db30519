"""Fixed-capacity voxel-downsampled point map (jit-compatible pytree).

Design (SURVEY §7 step 7): the map is a padded (capacity, 3)
buffer + validity mask. Insertion voxel-downsamples the union of existing map
points and incoming points to at most one point per voxel — existing points
win ties (stable first-of-run selection after a stable sort by voxel key), so
map points are not perturbed by re-observation — then optionally evicts
points outside a radius around the sensor. Everything is static-shape: a
single sort + segmented compaction, no host round trips.

Overflow (more occupied voxels than capacity) is reported via ``dropped``
so callers can log it (never silent).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ..ops.morton import GRID_CELLS as _K, morton_key


class VoxelMap(NamedTuple):
    """Padded voxel map (a pytree).

    Attributes:
      points: (C, 3) stored points (zeros in invalid slots).
      mask: (C,) slot validity.
      voxel_size: scalar array — downsampling voxel edge length.
      origin: (3,) fixed grid origin (voxel keys are computed relative to
        this; fixed at construction so keys are stable across inserts).
    """

    points: jax.Array
    mask: jax.Array
    voxel_size: jax.Array
    origin: jax.Array

    @property
    def size(self) -> jax.Array:
        return jnp.sum(self.mask, dtype=jnp.int32)


def voxel_map_empty(
    capacity: int,
    voxel_size: float,
    origin=(0.0, 0.0, 0.0),
    dtype=jnp.float32,
) -> VoxelMap:
    """An empty map. ``origin`` should be roughly the trajectory start; the
    addressable span around it is ``_K * voxel_size`` (e.g. 1024 * 0.5 m)."""
    return VoxelMap(
        points=jnp.zeros((capacity, 3), dtype),
        mask=jnp.zeros((capacity,), bool),
        voxel_size=jnp.asarray(voxel_size, dtype),
        origin=jnp.asarray(origin, dtype),
    )


def _voxel_key(map_: VoxelMap, pts: jax.Array, valid: jax.Array) -> jax.Array:
    # Morton (Z-order) keys: bijective with voxel cells, so any such key
    # gives the same downsampling; key-sorted storage keeps each contiguous
    # slot run spatially compact.
    key = morton_key(pts, map_.voxel_size, map_.origin)
    return jnp.where(valid, key, jnp.iinfo(jnp.int32).max)


@functools.partial(jax.jit, static_argnames=("keep_radius", "impl"))
def voxel_map_insert(
    map_: VoxelMap,
    new_points: jax.Array,
    new_mask: jax.Array,
    center: Optional[jax.Array] = None,
    keep_radius: float = 0.0,
    impl: str = "sort2",
) -> Tuple[VoxelMap, jax.Array]:
    """Insert points, voxel-downsample, optionally evict far points.

    Args:
      new_points: (N, 3) candidate points (e.g. features moved to the world
        frame); ``new_mask`` their validity.
      center: if given with ``keep_radius > 0``, points farther than
        ``keep_radius`` from ``center`` (sensor position) are evicted.
      impl: "sort2" (two lax.sorts, scatter-free) or "scatter" (one sort +
        two compaction scatters). Identical map contents.

    Returns: (new_map, dropped) — ``dropped`` counts occupied voxels that
      did not fit in capacity (voxels with the largest keys are dropped;
      callers should size capacity to make this rare and log when nonzero).
    """
    C = map_.points.shape[0]
    pts = jnp.concatenate([map_.points, new_points.astype(map_.points.dtype)])
    valid = jnp.concatenate([map_.mask, new_mask])
    if center is not None and keep_radius > 0:
        dist = jnp.linalg.norm(pts - center, axis=-1)
        valid = valid & (dist <= keep_radius)

    keys = _voxel_key(map_, pts, valid)
    idx = jnp.arange(keys.shape[0], dtype=jnp.int32)
    int_max = jnp.iinfo(jnp.int32).max

    if impl == "sort2":
        # Scatter-free: sort by (key, slot) — stability makes existing map
        # points (first in the concat) win their voxel — then compact
        # survivors to the front with a second sort on their destination
        # slot (int_max for losers/overflow). Identical contents to the
        # scatter path.
        skeys, _, sx, sy, sz = jax.lax.sort(
            (keys, idx, pts[:, 0], pts[:, 1], pts[:, 2]), num_keys=2
        )
        first = jnp.concatenate(
            [jnp.asarray([True]), skeys[1:] != skeys[:-1]]
        ) & (skeys != int_max)
        dest = (jnp.cumsum(first, dtype=jnp.int32) - 1).astype(jnp.int32)
        total = jnp.sum(first, dtype=jnp.int32)
        dropped = jnp.maximum(total - C, 0)
        key2 = jnp.where(first & (dest < C), dest, int_max)
        _, ox, oy, oz = jax.lax.sort(
            (key2, sx, sy, sz), num_keys=1
        )
        count = jnp.minimum(total, C)
        out_mask = jnp.arange(C, dtype=jnp.int32) < count
        out_pts = jnp.where(
            out_mask[:, None],
            jnp.stack([ox[:C], oy[:C], oz[:C]], axis=-1),
            0,
        )
        return (
            VoxelMap(out_pts, out_mask, map_.voxel_size, map_.origin),
            dropped,
        )

    # Stable sort: equal keys keep buffer order, so existing map points (which
    # come first in the concat) win their voxel against new observations.
    # One multi-operand lax.sort carries the coordinates through the sort
    # directly (slot index as tiebreak key = stability), with no gather.
    skeys, _, sx, sy, sz = jax.lax.sort(
        (keys, idx, pts[:, 0], pts[:, 1], pts[:, 2]), num_keys=2
    )
    spts = jnp.stack([sx, sy, sz], axis=-1)
    first = jnp.concatenate(
        [jnp.asarray([True]), skeys[1:] != skeys[:-1]]
    ) & (skeys != int_max)
    dest = jnp.cumsum(first) - 1
    total = jnp.sum(first, dtype=jnp.int32)
    dropped = jnp.maximum(total - C, 0)
    write_to = jnp.where(first & (dest < C), dest, C)
    out_pts = jnp.zeros((C, 3), map_.points.dtype).at[write_to].set(spts, mode="drop")
    out_mask = jnp.zeros((C,), bool).at[write_to].set(first, mode="drop")
    return (
        VoxelMap(out_pts, out_mask, map_.voxel_size, map_.origin),
        dropped,
    )
