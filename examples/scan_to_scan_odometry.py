"""Scan-to-scan odometry over a synthetic trajectory.

The compiled analogue of the reference README's user loop
(reference ``README.md:44-60``): stream scans, extract features,
register each against the previous, accumulate the pose.

    python examples/scan_to_scan_odometry.py [--frames 20] [--offline]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--offline", action="store_true",
                    help="batched whole-trajectory mode (one compiled program)")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from loam_jax import LidarParams, odometry_offline, scan_to_scan_init, scan_to_scan_step
    from loam_jax.evaluation import ate_rmse
    from loam_jax.io import render_trajectory
    from loam_jax.profiling import enable_compile_cache

    enable_compile_cache()
    lidar = LidarParams(16, 512, 0.5, 80.0)
    scans, poses = render_trajectory(
        lidar, args.frames, step=np.array([0.10, 0.02, 0.0]), yaw_rate=0.015,
        noise=0.004, seed=1, dtype=np.float32,
    )
    gt = np.stack([t for (_, t) in poses])

    if args.offline:
        t0 = time.perf_counter()
        traj, details = odometry_offline(jnp.asarray(scans), lidar)
        jax.block_until_ready(traj)
        dt = time.perf_counter() - t0
        est = np.asarray(traj.translation)
    else:
        state = scan_to_scan_init(lidar)
        est = []
        t0 = time.perf_counter()
        for f in range(args.frames):
            state, pose, detail = scan_to_scan_step(
                state, jnp.asarray(scans[f]), lidar
            )
            est.append(np.asarray(pose.translation))
        dt = time.perf_counter() - t0
        est = np.stack(est)

    print(f"{args.frames} frames in {dt:.2f}s "
          f"({args.frames / dt:.1f} scans/s incl. compile)")
    print(f"ATE vs ground truth: {ate_rmse(est, gt, align=False)*100:.2f} cm")
    for i in range(0, args.frames, max(1, args.frames // 5)):
        print(f"  frame {i:3d}: est {est[i].round(3)}  gt {gt[i].round(3)}")


if __name__ == "__main__":
    main()
