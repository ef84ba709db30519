"""File-fed end-to-end path: KITTI .bin files -> ScanLoader -> odometry.

The reference's whole usage model is a user loop over scans read from disk
(``README.md:44-60``). This drives the same flow through our IO layer:
synthetic frames written as KITTI-format .bin files, read back through the
(native, prefetching) ScanLoader, projected to range images, and pushed
through ``odometry_offline`` against the renderer's ground truth.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from loam_jax import LidarParams, odometry_offline
from loam_jax.evaluation import ate_rmse
from loam_jax.io import (
    ScanLoader,
    project_range_image,
    read_kitti_bin,
    render_trajectory,
)

LIDAR = LidarParams(16, 512, 0.5, 80.0)
N_FRAMES = 6


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """Write a synthetic trajectory as KITTI .bin files (x, y, z, intensity
    float32 records — the KITTI velodyne format)."""
    root = tmp_path_factory.mktemp("kitti_seq")
    scans, poses = render_trajectory(
        LIDAR, N_FRAMES, step=np.array([0.08, 0.02, 0.0]), yaw_rate=0.01,
        noise=0.005, seed=3, dtype=np.float32,
    )
    paths = []
    for i, scan in enumerate(scans):
        pts = scan.reshape(-1, 3)
        rec = np.concatenate(
            [pts, np.zeros((len(pts), 1), np.float32)], axis=1
        ).astype(np.float32)
        p = str(root / f"{i:06d}.bin")
        rec.tofile(p)
        paths.append(p)
    gt = np.stack([t for (_, t) in poses])
    return paths, gt


def test_loader_matches_direct_projection(dataset):
    paths, _ = dataset
    loader = ScanLoader(paths, LIDAR.scan_lines, LIDAR.points_per_line)
    loaded = list(loader)
    loader.close()
    assert len(loaded) == N_FRAMES
    for p, scan in zip(paths, loaded):
        direct = project_range_image(
            read_kitti_bin(p), LIDAR.scan_lines, LIDAR.points_per_line
        )
        np.testing.assert_array_equal(scan, direct)


def test_file_fed_odometry(dataset):
    paths, gt = dataset
    loader = ScanLoader(paths, LIDAR.scan_lines, LIDAR.points_per_line)
    scans = jnp.asarray(np.stack(list(loader)))
    loader.close()
    traj, details = odometry_offline(scans, LIDAR)
    est = np.asarray(traj.translation)
    assert np.isfinite(est).all()
    # the range-image re-projection quantizes rows/cols, so the file-fed
    # trajectory is near, not identical to, the structured-scan one
    ate = ate_rmse(est, gt, align=False)
    path_len = float(np.sum(np.linalg.norm(np.diff(gt, axis=0), axis=-1)))
    assert ate < max(0.05 * path_len, 0.05), f"file-fed ATE {ate}"
