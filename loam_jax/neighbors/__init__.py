"""Neighbor search (k-nearest with radius filtering) for loam-jax.

Replaces the reference's nanoflann KD-tree (``loam/include/loam/kdtree.h``,
``loam/src/kdtree.cpp:10-28``) with batched accelerator search:

  * ``knn`` — exact brute-force search over direct coordinate differences:
    a fused Pallas kernel on a GPU (``loam_jax.ops.knn_gpu``), a tiled
    distance matrix plus k min/argmin passes elsewhere. The default for
    feature-set-sized targets (tens of thousands of points).
  * ``grid`` (``loam_jax.neighbors.grid``) — voxel-hash accelerated search for
    map-scale targets.

Semantics match the reference (``kdtree.cpp:24-26``, SURVEY §2.3(7)): "k
nearest, then drop those beyond max_dist" — which is provably equal to "all
within max_dist, keep the k nearest", the form computed here.
"""

from .bruteforce import knn, knn_oracle
from .grid import GridIndex, build_grid, knn_grid

__all__ = ["knn", "knn_oracle", "GridIndex", "build_grid", "knn_grid"]
