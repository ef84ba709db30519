"""Exact brute-force kNN.

On a GPU the search runs as one fused Pallas kernel (``ops.knn_gpu``);
elsewhere it is the plain XLA form below, which is also the kernel's
reference. The XLA form computes the (Q, M) squared-distance matrix by
direct coordinate differences and selects the k nearest per query with k
min/argmin passes. Queries are processed in fixed-size tiles via
``lax.map`` so the distance matrix never exceeds ``tile x M``.

Replicates reference kNN semantics exactly (``kdtree.cpp:10-28``): results are
the k nearest targets, distance-ascending, with entries beyond ``max_dist``
masked out (post-hoc radius filter, strict ``<`` comparison). Invalid
(padded) targets never appear in results.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax


class KnnResult(NamedTuple):
    """k-nearest-neighbor search output (a pytree; leading dims batch).

    Attributes:
      indices: (..., Q, k) int32 target indices, distance-ascending. Entries
        where ``mask`` is False are arbitrary in-bounds values.
      distances: (..., Q, k) Euclidean distances (inf where invalid).
      mask: (..., Q, k) bool — True where a real neighbor within the radius
        (and within the valid target set) fills the slot.
    """

    indices: jax.Array
    distances: jax.Array
    mask: jax.Array


def topk_min(d2: jax.Array, k: int) -> Tuple[jax.Array, jax.Array]:
    """Exact k-smallest along the last axis: (values, indices), ascending.

    k unrolled min+argmin reduction passes (cheaper than ``lax.top_k``'s
    sort for small k) that reproduce top_k's first-index tie-breaking
    (argmin returns the first minimum).
    """
    if k == 0 or d2.shape[-1] == 0:
        shape = d2.shape[:-1] + (k,)
        return (
            jnp.full(shape, jnp.inf, d2.dtype),
            jnp.zeros(shape, jnp.int32),
        )
    col = lax.broadcasted_iota(jnp.int32, d2.shape, d2.ndim - 1)
    inf = jnp.asarray(jnp.inf, d2.dtype)
    vals, idxs = [], []
    for _ in range(k):
        i = jnp.argmin(d2, axis=-1)
        v = jnp.take_along_axis(d2, i[..., None], axis=-1)[..., 0]
        vals.append(v)
        idxs.append(i.astype(jnp.int32))
        d2 = jnp.where(col == i[..., None], inf, d2)
    return jnp.stack(vals, axis=-1), jnp.stack(idxs, axis=-1)


def _tile_knn(
    q_tile: jax.Array,
    targets: jax.Array,
    t_sq_masked: jax.Array,
    k: int,
    max_dist: float,
) -> KnnResult:
    """kNN of one query tile against all targets. ``t_sq_masked`` carries +inf
    in invalid target slots so they sort last and are masked out."""
    # Direct per-coordinate squared differences: exact in the working dtype.
    # The |q|^2+|t|^2-2q.t cross-term form (matmul-friendly) cancels
    # catastrophically at long ranges — at |t|~80 m its f32 distances were
    # off by ~1e-4, flipping borderline radius accepts relative to the f64
    # oracle (which, like the reference's nanoflann L2_Simple, uses direct
    # differences).
    d2 = jnp.zeros((q_tile.shape[0], targets.shape[0]), q_tile.dtype)
    for c in range(3):
        dc = q_tile[:, c][:, None] - targets[:, c][None, :]
        d2 = d2 + dc * dc
    d2 = d2 + jnp.where(jnp.isfinite(t_sq_masked), 0.0, jnp.inf)[None, :]
    M = targets.shape[0]
    kk = min(k, M)  # fewer targets than k: result holds fewer entries (§2.3(7))
    d2k, idx = topk_min(d2, kk)
    if kk < k:
        pad = ((0, 0), (0, k - kk))
        d2k = jnp.pad(d2k, pad, constant_values=jnp.inf)
        idx = jnp.pad(idx, pad)
    dist = jnp.sqrt(jnp.maximum(d2k, 0.0))
    valid = jnp.isfinite(d2k)
    if max_dist > 0:
        valid = valid & (dist < max_dist)
    return KnnResult(idx.astype(jnp.int32), jnp.where(valid, dist, jnp.inf), valid)


def knn_backend() -> str:
    """The implementation :func:`knn` runs: ``"triton"`` (the fused Pallas
    kernel) when JAX's default backend is a GPU, ``"xla"`` otherwise."""
    return "triton" if jax.default_backend() == "gpu" else "xla"


def knn(
    queries: jax.Array,
    targets: jax.Array,
    target_mask: jax.Array,
    k: int,
    max_dist: float = 0.0,
    tile: int = 2048,
) -> KnnResult:
    """Exact k-nearest-neighbor search with reference radius semantics.

    Runs the fused GPU kernel (``loam_jax.ops.knn_gpu``) on a GPU backend
    and :func:`_knn_xla` elsewhere (see :func:`knn_backend`); both return
    the same neighbors.

    Args:
      queries: (Q, 3) query points (invalid queries simply yield ignorable
        rows; callers carry their own query mask).
      targets: (M, 3) target points, padded.
      target_mask: (M,) validity of target slots.
      k: neighbors per query (static).
      max_dist: radius filter — neighbors at distance >= max_dist are masked
        (strict ``<`` per ``kdtree.cpp:24-26``). <= 0 disables the filter.
      tile: query tile size of the XLA form (static); queries are padded to
        a multiple.

    Returns: KnnResult with (Q, k) leaves.
    """
    if knn_backend() == "triton":
        from ..ops.knn_gpu import knn_triton

        return knn_triton(queries, targets, target_mask, k, max_dist)
    return _knn_xla(queries, targets, target_mask, k, max_dist, tile)


@functools.partial(jax.jit, static_argnames=("k", "max_dist", "tile"))
def _knn_xla(
    queries: jax.Array,
    targets: jax.Array,
    target_mask: jax.Array,
    k: int,
    max_dist: float = 0.0,
    tile: int = 2048,
) -> KnnResult:
    """Plain-XLA brute force (the CPU path and the GPU kernel's reference)."""
    Q = queries.shape[0]
    dtype = queries.dtype
    t_sq = jnp.sum(targets * targets, axis=-1)
    t_sq_masked = jnp.where(target_mask, t_sq, jnp.asarray(jnp.inf, dtype))

    if Q <= tile:
        return _tile_knn(queries, targets, t_sq_masked, k, max_dist)

    n_tiles = -(-Q // tile)
    padded = jnp.zeros((n_tiles * tile, 3), dtype).at[:Q].set(queries)
    res = lax.map(
        lambda qt: _tile_knn(qt, targets, t_sq_masked, k, max_dist),
        padded.reshape(n_tiles, tile, 3),
    )
    return KnnResult(
        res.indices.reshape(n_tiles * tile, k)[:Q],
        res.distances.reshape(n_tiles * tile, k)[:Q],
        res.mask.reshape(n_tiles * tile, k)[:Q],
    )


def knn_oracle(
    queries: np.ndarray,
    targets: np.ndarray,
    target_mask: np.ndarray,
    k: int,
    max_dist: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """NumPy reference oracle replicating ``kdtree_internal::knnSearch``
    (``kdtree.cpp:10-28``): k nearest by full sort, then strict radius filter.
    Returns (indices, distances, mask) shaped (Q, k)."""
    tgt = np.asarray(targets)[np.asarray(target_mask)]
    orig_idx = np.flatnonzero(np.asarray(target_mask))
    Q = queries.shape[0]
    idx = np.zeros((Q, k), dtype=np.int32)
    dist = np.full((Q, k), np.inf)
    mask = np.zeros((Q, k), dtype=bool)
    for i in range(Q):
        d = np.linalg.norm(tgt - queries[i], axis=-1)
        order = np.argsort(d, kind="stable")[:k]
        m = len(order)
        sel = d[order]
        keep = np.ones(m, dtype=bool) if max_dist <= 0 else sel < max_dist
        idx[i, :m] = orig_idx[order]
        dist[i, :m] = np.where(keep, sel, np.inf)
        mask[i, :m] = keep
    return idx, dist, mask
