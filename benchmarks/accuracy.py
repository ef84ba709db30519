"""Trajectory accuracy benchmark on a long synthetic sequence.

BASELINE's accuracy target is ATE <= the reference on Newer College
segments; that dataset is not available in this zero-egress image, so this
harness evaluates on the synthetic world (exact ground truth, configurable
range noise — 1 cm sigma is Ouster-class) over a long trajectory, for both
odometry modes. Prints one JSON line per mode.

    python benchmarks/accuracy.py [--frames 40] [--noise 0.01] [--cpu]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--noise", type=float, default=0.01)
    ap.add_argument("--scan-lines", type=int, default=32)
    ap.add_argument("--points-per-line", type=int, default=512)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from loam_jax import (
        LidarParams,
        RegistrationParams,
        scan_to_map_init,
        scan_to_map_step,
        scan_to_scan_init,
        scan_to_scan_step,
    )
    from loam_jax.evaluation import ate_rmse, rpe
    from loam_jax.io import render_trajectory
    from loam_jax.profiling import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]

    lidar = LidarParams(args.scan_lines, args.points_per_line, 0.5, 80.0)
    scans, poses = render_trajectory(
        lidar,
        args.frames,
        step=np.array([0.12, 0.02, 0.0]),
        yaw_rate=0.02,
        noise=args.noise,
        seed=5,
        dtype=np.float32,
    )
    gt = np.stack([t for (_, t) in poses])
    gt_rot = np.stack([R for (R, _) in poses])
    path_len = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())

    def report(name, est, est_rot, dt):
        ate = ate_rmse(est, gt, align=False)
        rpe_t, rpe_r = rpe(est, gt, est_rot, gt_rot)
        print(
            json.dumps(
                {
                    "metric": f"ate_{name}",
                    "value": round(ate * 100, 3),
                    "unit": "cm RMSE (no alignment)",
                    "frames": args.frames,
                    "path_m": round(path_len, 2),
                    "ate_pct_of_path": round(100 * ate / path_len, 3),
                    "rpe_trans_cm": round(rpe_t * 100, 3),
                    "rpe_rot_mrad": round(rpe_r * 1000, 3),
                    "scans_per_sec_incl_compile": round(args.frames / dt, 2),
                    "platform": dev.platform,
                    "device_kind": dev.device_kind,
                }
            )
        )

    # scan-to-scan (motion prior)
    state = scan_to_scan_init(lidar)
    est, est_rot = [], []
    t0 = time.perf_counter()
    for f in range(args.frames):
        state, pose, _ = scan_to_scan_step(state, jnp.asarray(scans[f]), lidar)
        est.append(np.asarray(pose.translation))
        est_rot.append(np.asarray(pose.rotation))
    report("scan_to_scan", np.stack(est), np.stack(est_rot), time.perf_counter() - t0)

    # scan-to-map (voxel map + keyframing)
    mstate = scan_to_map_init()
    reg = RegistrationParams(search_backend="grid")
    est, est_rot = [], []
    t0 = time.perf_counter()
    for f in range(args.frames):
        mstate, pose, _ = scan_to_map_step(
            mstate, jnp.asarray(scans[f]), lidar, reg_params=reg
        )
        est.append(np.asarray(pose.translation))
        est_rot.append(np.asarray(pose.rotation))
    report("scan_to_map", np.stack(est), np.stack(est_rot), time.perf_counter() - t0)


if __name__ == "__main__":
    main()
