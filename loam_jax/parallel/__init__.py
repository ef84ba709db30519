"""Multi-device / multi-host execution (SPMD over a jax mesh).

The reference is single-threaded, single-process (SURVEY §2.2); scaling is
this framework's divergence point. The recipe (scaling-book style): pick a mesh, annotate shardings, let XLA insert the collectives.

Axes used by this domain (SURVEY §2.2 table):
  * ``data``  — frames / scan pairs (batched odometry, config 4-5). The
    consecutive-pair structure needs each device's first frame from its left
    neighbor: XLA lowers the ``x[1:]``/``x[:-1]`` shifts to ``ppermute``
    halo exchanges automatically (NCCL over NVLink on a GPU host).
  * ``line``  — scan lines within feature extraction (the intra-scan "SP"
    axis): lines are independent (SURVEY §2.3(4)), so extraction shards
    cleanly; the curvature stencil's halo is within-line only.

No custom transport is needed — ``jax.distributed.initialize`` + compiler
collectives replace the reference's (absent) comm backend.
"""

from .sharding import (
    make_mesh,
    extract_features_sharded,
    odometry_offline_sharded,
    register_pairs_sharded,
)

__all__ = [
    "make_mesh",
    "extract_features_sharded",
    "odometry_offline_sharded",
    "register_pairs_sharded",
]
