"""Local map layer for scan-to-map odometry.

The reference deliberately owns no map (``README.md:63`` — "not a state
estimation solution"); its users build one. This package provides the
layer (SURVEY §3.4, BASELINE config 3): a fixed-capacity voxel-downsampled
point map per feature class, with jit-compatible insert / eviction, designed
so the whole scan-to-map loop stays on device.
"""

from .voxel_map import VoxelMap, voxel_map_empty, voxel_map_insert

__all__ = ["VoxelMap", "voxel_map_empty", "voxel_map_insert"]
