"""Odometry drivers: the loops the reference leaves to user code.

The reference's README sketches a sequential scan-to-scan loop the user must
write (``README.md:44-60``) and explicitly owns no map, no keyframing, no
motion prior (``README.md:63``). This package provides those layers as
compiled JAX programs (SURVEY §3.4, BASELINE configs 2-4):

  * ``scan_to_scan`` — streaming scan-to-scan odometry with an optional
    constant-velocity motion prior; one jitted step per frame.
  * ``scan_to_map`` — scan-to-map odometry against fixed-capacity voxel maps
    with distance/rotation keyframing.
  * ``offline`` — batched whole-trajectory odometry: feature extraction
    vmapped over frames, all consecutive pairs registered in one batched
    solve, poses composed with an associative scan (log-depth, on device).
  * ``streaming`` — file-fed odometry with IO, upload and compute
    pipelined (the accelerator form of the reference's file loop).
"""

from .offline import odometry_offline
from .streaming import (
    StreamCarry,
    StreamingOdometry,
    odometry_streaming,
    stream_chunk_step,
    stream_init,
)
from .scan_to_map import (
    ScanToMapConfig,
    ScanToMapState,
    default_map_reg_params,
    scan_to_map_init,
    scan_to_map_offline,
    scan_to_map_step,
    scan_to_map_step_features,
)
from .scan_to_scan import ScanToScanState, scan_to_scan_init, scan_to_scan_step

__all__ = [
    "ScanToMapConfig",
    "ScanToMapState",
    "ScanToScanState",
    "StreamCarry",
    "StreamingOdometry",
    "odometry_offline",
    "odometry_streaming",
    "stream_chunk_step",
    "stream_init",
    "scan_to_map_init",
    "scan_to_map_offline",
    "scan_to_map_step",
    "scan_to_map_step_features",
    "default_map_reg_params",
    "scan_to_scan_init",
    "scan_to_scan_step",
]
