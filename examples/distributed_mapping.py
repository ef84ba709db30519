"""Distributed scan-to-map odometry on a device mesh (BASELINE config 5).

The registration target (voxel maps of accumulated features) is sharded
over the mesh "data" axis: every device owns capacity/D map slots, kNN
runs as a collective (local top-k + global merge), and map insertion is
owner-partitioned (mod-D by voxel key). On a GPU host the mesh spans the
cards (NCCL collectives); this example runs on 8 virtual CPU devices so it
works anywhere:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/distributed_mapping.py

It drives the sharded step over a short synthetic trajectory and checks it
against the single-device driver (same world, same parameters).
"""

import os
import sys

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from loam_jax import LidarParams, scan_to_map_init, scan_to_map_step
    from loam_jax.io import render_trajectory
    from loam_jax.odometry.scan_to_map import ScanToMapConfig
    from loam_jax.params import RegistrationParams
    from loam_jax.profiling import enable_compile_cache
    from loam_jax.parallel.distributed import (
        scan_to_map_init_sharded,
        scan_to_map_step_sharded,
    )

    enable_compile_cache()
    devices = jax.devices()
    print(f"devices: {len(devices)} x {devices[0].platform}")
    mesh = jax.sharding.Mesh(np.asarray(devices), ("data",))

    lidar = LidarParams(16, 360, 0.5, 80.0)
    frames = 6
    scans, poses_gt = render_trajectory(
        lidar, frames, step=np.array([0.15, 0.05, 0.0]), yaw_rate=0.02,
        noise=0.005, seed=3, dtype=np.float32,
    )
    scans = jnp.asarray(scans)

    config = ScanToMapConfig(edge_capacity=1 << 12, planar_capacity=1 << 14)
    reg = RegistrationParams(prior_weight=300.0)

    state_s = scan_to_map_init_sharded(config, mesh)
    state_1 = scan_to_map_init(config)
    traj_s, traj_1 = [], []
    for f in range(frames):
        state_s, pose_s, _ = scan_to_map_step_sharded(
            state_s, scans[f], lidar, mesh, reg_params=reg, config=config
        )
        state_1, pose_1, _ = scan_to_map_step(
            state_1, scans[f], lidar, reg_params=reg, config=config
        )
        traj_s.append(np.asarray(pose_s.translation))
        traj_1.append(np.asarray(pose_1.translation))
        print(f"frame {f}: sharded t={traj_s[-1].round(3)}  "
              f"single t={traj_1[-1].round(3)}")

    err = np.linalg.norm(np.asarray(traj_s) - np.asarray(traj_1), axis=1).max()
    print(f"max |sharded - single-device| translation: {err:.2e} m")
    gt_end = poses_gt[-1][1] - poses_gt[0][1]
    drift = np.linalg.norm(traj_s[-1] - gt_end)
    print(f"end-pose drift vs ground truth: {drift:.3f} m")
    assert err < 5e-2, "sharded driver diverged from single-device"
    print("OK")


if __name__ == "__main__":
    main()
