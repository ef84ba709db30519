"""File-fed streaming odometry: the reference README's usage loop, pipelined.

The reference documents this flow as a serial user loop — read a scan file,
extract features, register against the previous scan, compose
(reference ``README.md:44-60``). Run as written, reading, uploading and
computing are serialized, so ``odometry_streaming`` overlaps them: native
loader threads read + project + pack scans ahead of the consumer, frames
upload in the 4-byte/point codec (``loam_jax/io/packed.py``, quantization
below sensor noise), and chunks of frames upload + register asynchronously
while the next chunk is still being read.

Run: python examples/streaming_odometry.py [n_frames]
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    n_frames = int(sys.argv[1]) if len(sys.argv) > 1 else 24

    from loam_jax import LidarParams, odometry_streaming
    from loam_jax.evaluation import ate_rmse
    from loam_jax.io import render_trajectory
    from loam_jax.profiling import enable_compile_cache

    enable_compile_cache()
    lidar = LidarParams(16, 512, 0.5, 80.0)

    # Write a synthetic trajectory as KITTI-format .bin files (stand-in for
    # a real dataset directory; zero-egress image ships no public data).
    root = tempfile.mkdtemp(prefix="loam_stream_")
    scans, poses = render_trajectory(
        lidar, n_frames, step=np.array([0.10, 0.03, 0.0]), yaw_rate=0.015,
        noise=0.005, seed=0, dtype=np.float32,
    )
    paths = []
    for i, scan in enumerate(scans):
        pts = scan.reshape(-1, 3)
        rec = np.concatenate([pts, np.zeros((len(pts), 1), np.float32)], 1)
        p = os.path.join(root, f"{i:06d}.bin")
        rec.astype(np.float32).tofile(p)
        paths.append(p)

    trajectory, details = odometry_streaming(
        paths, lidar, chunk_frames=8, packed=True
    )

    est = np.asarray(trajectory.translation)
    gt = np.stack([t for (_, t) in poses])
    path_len = float(np.sum(np.linalg.norm(np.diff(gt, axis=0), axis=-1)))
    print(f"frames: {n_frames}  path: {path_len:.2f} m")
    print(f"ATE: {ate_rmse(est, gt, align=False):.4f} m")
    print(f"end position error: {np.linalg.norm(est[-1] - gt[-1]):.4f} m")


if __name__ == "__main__":
    main()
