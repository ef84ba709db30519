"""Voxel-grid accelerated kNN for map-scale target sets.

The reference builds a nanoflann KD-tree per target set
(``registration-inl.h:20-23``) — pointer-chasing traversal that does not map
to batched accelerator code. The batched equivalent (SURVEY §2.2, §7): bin
target points into a
uniform voxel grid with cell size >= the search radius, sort them by linear
cell key, and answer each query with one gather over the 27 adjacent cells
followed by a top-k. All shapes static; lookups are two ``searchsorted``
binary searches per (query, cell) — no hash collisions because keys are exact
linearized coordinates.

Exactness: with ``cell_size >= max_dist`` every within-radius neighbor lies in
the 27-cell neighborhood, so results equal the brute-force search as long as
no cell holds more than ``max_per_cell`` points. Overflowing candidates are
dropped (counted in ``KnnResult``-adjacent ``overflow`` output so callers can
log the truncation — never silent).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .bruteforce import KnnResult

# cells per axis: keys fit int32 (K^3 = 2^30); at cell=1m this spans ~1 km.
_K = 1024


class GridIndex(NamedTuple):
    """Sorted voxel-grid index over a padded point set (a pytree).

    Attributes:
      points_sorted: (M, 3) points permuted to cell-key order.
      keys_sorted: (M,) int32 linear cell key per sorted point (sentinel
        ``_K**3`` for invalid/padded points, sorting last).
      perm: (M,) int32 original index of each sorted slot.
      origin: (3,) grid origin (min corner).
      cell_size: scalar array.
    """

    points_sorted: jax.Array
    keys_sorted: jax.Array
    perm: jax.Array
    origin: jax.Array
    cell_size: jax.Array


def _cell_coords(points: jax.Array, origin: jax.Array, cell_size) -> jax.Array:
    c = jnp.floor((points - origin) / cell_size).astype(jnp.int32)
    return jnp.clip(c, 0, _K - 1)


def _linear_key(coords: jax.Array) -> jax.Array:
    return (coords[..., 0] * _K + coords[..., 1]) * _K + coords[..., 2]


@functools.partial(jax.jit, static_argnames=())
def build_grid(points: jax.Array, mask: jax.Array, cell_size: jax.Array) -> GridIndex:
    """Build a GridIndex over padded ``points`` ((M, 3)) with validity ``mask``."""
    cell_size = jnp.asarray(cell_size, points.dtype)
    big = jnp.asarray(jnp.finfo(points.dtype).max, points.dtype)
    origin = jnp.min(jnp.where(mask[:, None], points, big), axis=0) - 0.5 * cell_size
    keys = _linear_key(_cell_coords(points, origin, cell_size))
    keys = jnp.where(mask, keys, _K**3)
    perm = jnp.argsort(keys, stable=True).astype(jnp.int32)
    return GridIndex(points[perm], keys[perm], perm, origin, cell_size)


# 27-cell neighborhood offsets, linearized once.
_OFFSETS = np.array(
    [[dx, dy, dz] for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)],
    dtype=np.int32,
)


def _tile_knn_grid(
    index: GridIndex,
    queries: jax.Array,
    k: int,
    max_dist: float,
    C: int,
) -> Tuple[KnnResult, jax.Array]:
    """Grid kNN for one query tile."""
    from .bruteforce import topk_min

    keys = index.keys_sorted
    dtype = index.points_sorted.dtype
    M = keys.shape[0]
    # coordinate-separated target columns: gathers of (Q, 27C) lane-tiled
    # arrays instead of a (Q, 27C, 3) array whose last dim pads 3 -> 128.
    px, py, pz = (index.points_sorted[:, i] for i in range(3))

    qc = _cell_coords(queries, index.origin, index.cell_size)  # (Q, 3)
    # (Q, 27) linear keys of the neighborhood. Clamping at grid borders can
    # produce duplicate cells; duplicates must be masked out or their repeated
    # candidates crowd genuine neighbors out of the top-k.
    nbr = jnp.clip(qc[:, None, :] + jnp.asarray(_OFFSETS)[None, :, :], 0, _K - 1)
    nbr_keys = _linear_key(nbr)  # (Q, 27)
    dup = jnp.tril(nbr_keys[:, :, None] == nbr_keys[:, None, :], k=-1).any(axis=-1)

    start = jnp.searchsorted(keys, nbr_keys, side="left")  # (Q, 27)
    end = jnp.searchsorted(keys, nbr_keys, side="right")
    count = jnp.where(dup, 0, end - start)
    overflow = jnp.sum((count > C).astype(jnp.int32))

    slots = jnp.arange(C, dtype=jnp.int32)  # (C,)
    cand = start[..., None] + slots  # (Q, 27, C) sorted-array positions
    cand_valid = slots < jnp.minimum(count, C)[..., None]
    cand = jnp.minimum(cand, M - 1)

    Q = queries.shape[0]
    cand_flat = cand.reshape(Q, 27 * C)
    valid_flat = cand_valid.reshape(Q, 27 * C)
    dx = px[cand_flat] - queries[:, 0:1]
    dy = py[cand_flat] - queries[:, 1:2]
    dz = pz[cand_flat] - queries[:, 2:3]
    d2 = dx * dx + dy * dy + dz * dz
    d2 = jnp.where(valid_flat, d2, jnp.asarray(jnp.inf, dtype))

    d2k, pos = topk_min(d2, k)
    dist = jnp.sqrt(jnp.maximum(d2k, 0.0))
    valid = jnp.isfinite(d2k) & (dist < max_dist)
    sorted_idx = jnp.take_along_axis(cand_flat, pos, axis=1)
    orig_idx = index.perm[sorted_idx]
    return (
        KnnResult(
            orig_idx.astype(jnp.int32), jnp.where(valid, dist, jnp.inf), valid
        ),
        overflow,
    )


@functools.partial(
    jax.jit, static_argnames=("k", "max_dist", "max_per_cell", "tile")
)
def knn_grid(
    index: GridIndex,
    queries: jax.Array,
    k: int,
    max_dist: float,
    max_per_cell: int = 32,
    tile: int = 4096,
) -> Tuple[KnnResult, jax.Array]:
    """k nearest targets within ``max_dist`` of each query via the grid.

    Requires ``max_dist > 0`` and ``cell_size >= max_dist`` (callers construct
    the grid accordingly). Queries are processed in ``tile``-sized chunks to
    bound the (tile, 27 * max_per_cell) candidate buffers.

    Returns (KnnResult (Q, k), overflow) where ``overflow`` counts
    (query, cell) lookups whose cell had more than ``max_per_cell`` points —
    nonzero means possible (rare) missed neighbors.
    """
    if max_dist <= 0:
        raise ValueError("knn_grid requires a positive search radius")
    Q = queries.shape[0]
    C = max_per_cell
    if Q <= tile:
        return _tile_knn_grid(index, queries, k, max_dist, C)
    n_tiles = -(-Q // tile)
    padded = jnp.zeros((n_tiles * tile, 3), queries.dtype).at[:Q].set(queries)
    res, overflow = lax.map(
        lambda qt: _tile_knn_grid(index, qt, k, max_dist, C),
        padded.reshape(n_tiles, tile, 3),
    )
    return (
        KnnResult(
            res.indices.reshape(n_tiles * tile, k)[:Q],
            res.distances.reshape(n_tiles * tile, k)[:Q],
            res.mask.reshape(n_tiles * tile, k)[:Q],
        ),
        jnp.sum(overflow),
    )
