"""loam-jax: a LiDAR odometry & mapping engine in JAX, run on an NVIDIA H100.

Brand-new implementation with the capabilities of the reference C++ library
DanMcGann/loam — curvature-based edge/planar feature extraction over
range-image scans, batched k-NN correspondence search, and point-to-line /
point-to-plane Gauss-Newton registration — rebuilt for accelerators:
fixed-shape masked arrays, vmap/pjit-parallel over scans and pairs, and
everything on device. Plus the layers the reference leaves to the user:
scan-to-scan and scan-to-map odometry drivers, a local voxel map, batched
multi-pair registration, and multi-device sharding."""

from .geometry import (
    Pose3,
    fit_line,
    fit_plane,
    point_to_line_distance,
    point_to_plane_distance,
    quat_angular_distance,
    quat_exp,
    quat_from_axis_angle,
    quat_log,
    quat_multiply,
    quat_rotate,
    quat_to_matrix,
)
from .params import (
    FeatureExtractionParams,
    LidarParams,
    RegistrationParams,
    TerminationType,
)
from .features import (
    FeatureSet,
    compute_curvature,
    compute_valid_points,
    extract_features,
    feature_set_from_points,
)
from . import checkpoint, debug, evaluation, loop_closure, pose_graph
from .dewarp import dewarp_scan
from .map import VoxelMap, voxel_map_empty, voxel_map_insert
from .neighbors import knn
from .odometry import (
    ScanToMapConfig,
    ScanToMapState,
    ScanToScanState,
    StreamingOdometry,
    odometry_offline,
    odometry_streaming,
    scan_to_map_init,
    scan_to_map_offline,
    scan_to_map_step,
    scan_to_map_step_features,
    scan_to_scan_init,
    scan_to_scan_step,
)
from .registration import (
    IterationInfo,
    RegistrationDetail,
    register_features,
    register_features_batch,
)

__version__ = "0.1.0"

__all__ = [
    "Pose3",
    "LidarParams",
    "FeatureExtractionParams",
    "RegistrationParams",
    "TerminationType",
    "FeatureSet",
    "IterationInfo",
    "RegistrationDetail",
    "ScanToMapConfig",
    "ScanToMapState",
    "ScanToScanState",
    "StreamingOdometry",
    "VoxelMap",
    "knn",
    "odometry_offline",
    "odometry_streaming",
    "scan_to_map_init",
    "scan_to_map_offline",
    "scan_to_map_step",
    "scan_to_map_step_features",
    "scan_to_scan_init",
    "scan_to_scan_step",
    "dewarp_scan",
    "voxel_map_empty",
    "voxel_map_insert",
    "register_features",
    "register_features_batch",
    "compute_curvature",
    "compute_valid_points",
    "extract_features",
    "feature_set_from_points",
    "fit_line",
    "fit_plane",
    "point_to_line_distance",
    "point_to_plane_distance",
    "quat_angular_distance",
    "quat_exp",
    "quat_from_axis_angle",
    "quat_log",
    "quat_multiply",
    "quat_rotate",
    "quat_to_matrix",
]
