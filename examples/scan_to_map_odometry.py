"""Scan-to-map odometry with a local voxel map, keyframing and checkpointing.

    python examples/scan_to_map_odometry.py [--frames 20] [--checkpoint out.npz]
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
    ap.add_argument("--checkpoint", default=None, help="save state npz here")
    ap.add_argument("--resume", default=None, help="resume from state npz")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from loam_jax import (
        LidarParams,
        RegistrationParams,
        checkpoint,
        scan_to_map_init,
        scan_to_map_step,
    )
    from loam_jax.evaluation import ate_rmse
    from loam_jax.io import render_trajectory
    from loam_jax.profiling import enable_compile_cache

    enable_compile_cache()
    lidar = LidarParams(16, 512, 0.5, 80.0)
    reg = RegistrationParams(search_backend="grid")
    scans, poses = render_trajectory(
        lidar, args.frames, step=np.array([0.10, 0.02, 0.0]), yaw_rate=0.015,
        noise=0.004, seed=1, dtype=np.float32,
    )
    gt = np.stack([t for (_, t) in poses])

    state = scan_to_map_init()
    if args.resume:
        state = checkpoint.load(args.resume, state)
        print(f"resumed from {args.resume} "
              f"(map sizes {int(state.edge_map.size)}/{int(state.planar_map.size)})")

    est = []
    t0 = time.perf_counter()
    for f in range(args.frames):
        state, pose, detail = scan_to_map_step(
            state, jnp.asarray(scans[f]), lidar, reg_params=reg
        )
        est.append(np.asarray(pose.translation))
    dt = time.perf_counter() - t0
    est = np.stack(est)

    print(f"{args.frames} frames in {dt:.2f}s "
          f"({args.frames / dt:.1f} scans/s incl. compile)")
    print(f"map: {int(state.edge_map.size)} edge voxels, "
          f"{int(state.planar_map.size)} planar voxels")
    print(f"ATE vs ground truth: {ate_rmse(est, gt, align=False)*100:.2f} cm")

    if args.checkpoint:
        checkpoint.save(args.checkpoint, state)
        print(f"state saved to {args.checkpoint}")


if __name__ == "__main__":
    main()
