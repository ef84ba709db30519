"""Sharded entry points: batched extraction / registration / odometry on a mesh.

Everything here reuses the single-device jitted pipelines unchanged — the
sharding story is data placement (``NamedSharding`` over a ``Mesh``) plus
XLA's SPMD partitioner. Frame-axis parallelism is embarrassing except for
the consecutive-pair halo (one frame from the left neighbor, lowered to
``ppermute``) and the trajectory prefix-compose (log-depth collective scan);
both are device-to-device collectives.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..features import FeatureSet, extract_features
from ..geometry import Pose3
from ..odometry.offline import odometry_offline
from ..params import FeatureExtractionParams, LidarParams, RegistrationParams
from ..registration import RegistrationDetail, register_features_batch


def make_mesh(
    devices: Optional[list] = None, line_axis: int = 1
) -> Mesh:
    """A ("data", "line") mesh over the available devices.

    ``line_axis`` devices are assigned to intra-scan (scan-line) parallelism;
    the rest to the frame axis. Default: all devices on "data".
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if n % line_axis != 0:
        raise ValueError(f"{n} devices not divisible by line_axis={line_axis}")
    arr = np.asarray(devices).reshape(n // line_axis, line_axis)
    return Mesh(arr, axis_names=("data", "line"))


def extract_features_sharded(
    scans: jax.Array,
    lidar: LidarParams,
    mesh: Mesh,
    params: FeatureExtractionParams = FeatureExtractionParams(),
) -> FeatureSet:
    """Batched feature extraction with frames sharded over "data" and scan
    lines over "line" (lines are independent, SURVEY §2.3(4)).

    Batches through :func:`extract_features_batch` (``vmap`` over
    frames)."""
    from ..features.extract import extract_features_batch

    scans = jnp.asarray(scans)
    if scans.ndim == 3:  # (F, L*P, 3) -> (F, L, P, 3)
        scans = scans.reshape(scans.shape[0], lidar.scan_lines, -1, 3)
    sharded = jax.device_put(scans, NamedSharding(mesh, P("data", "line")))
    return jax.jit(
        lambda s: extract_features_batch(s, lidar, params)
    )(sharded)


def register_pairs_sharded(
    source: FeatureSet,
    target: FeatureSet,
    init: Pose3,
    mesh: Mesh,
    params: RegistrationParams = RegistrationParams(),
) -> Tuple[Pose3, RegistrationDetail]:
    """Batched pair registration with the pair axis sharded over "data"."""
    spec = NamedSharding(mesh, P("data"))
    source = jax.tree.map(lambda x: jax.device_put(x, spec), source)
    target = jax.tree.map(lambda x: jax.device_put(x, spec), target)
    init = jax.tree.map(lambda x: jax.device_put(x, spec), init)
    return register_features_batch(source, target, init, params)


def odometry_offline_sharded(
    scans: jax.Array,
    lidar: LidarParams,
    mesh: Mesh,
    feat_params: FeatureExtractionParams = FeatureExtractionParams(),
    reg_params: RegistrationParams = RegistrationParams(),
) -> Tuple[Pose3, RegistrationDetail]:
    """Whole-trajectory odometry with the frame axis sharded over the mesh.

    The pipeline is the single-chip ``odometry_offline`` unchanged; placing
    the input over the mesh makes XLA partition extraction and the pairwise
    registrations across devices, halo-exchange the boundary frames, and run
    the pose prefix-compose as a collective scan.
    """
    scans = jnp.asarray(scans)
    if scans.ndim == 3:
        scans = scans.reshape(scans.shape[0], lidar.scan_lines, -1, 3)
    sharded = jax.device_put(scans, NamedSharding(mesh, P("data", "line")))
    return odometry_offline(sharded, lidar, feat_params, reg_params)
