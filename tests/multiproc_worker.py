"""Worker for the multi-process distributed tests (SURVEY §4 fake cluster).

Launched N times by ``test_multiprocess.py``:

    python multiproc_worker.py <process_id> <num_processes> <port> [mode]

Each process pins the CPU backend and joins the ``jax.distributed``
coordinator (process 0 hosts it). Modes:

  * ``pose_graph`` (default): shard a deterministic pose-graph edge set over
    the global ("data",) mesh, run ``optimize_pose_graph_sharded``
    (collective normal-equation psums ride the cross-process channel), and
    check against the process-local single-device solve.
  * ``scan_to_map``: drive the FULL distributed mapping pipeline
    (``scan_to_map_step_sharded``: extraction -> collective-kNN registration
    against process-sharded voxel maps -> owner-partitioned insert) over a
    short trajectory, checking poses/keyframing/map occupancy against the
    process-local single-device ``scan_to_map_step`` every frame — the DCN
    code path of the mapping driver.

Exit code 0 = parity held.
"""

import sys


def main():
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    mode = sys.argv[4] if len(sys.argv) > 4 else "pose_graph"

    import jax

    # the fake cluster runs on local CPU devices, whatever the machine has
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    jax.distributed.initialize(
        coordinator_address=f"localhost:{port}",
        num_processes=nproc,
        process_id=pid,
    )
    if mode == "scan_to_map":
        return scan_to_map_mode(pid, nproc)

    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from loam_jax.geometry import Pose3, quat_from_axis_angle
    from loam_jax.pose_graph import (
        PoseGraphEdges,
        optimize_pose_graph,
        optimize_pose_graph_sharded,
    )

    D = len(jax.devices())
    assert D == nproc * len(jax.local_devices())
    mesh = Mesh(np.asarray(jax.devices()).reshape(D), ("data",))

    # deterministic problem, identical on every process: a noisy ring of
    # N nodes with odometry edges + one loop closure
    N = 8
    rng = np.random.default_rng(0)
    angles = np.linspace(0, 2 * np.pi, N, endpoint=False)
    gt_t = np.stack([np.cos(angles), np.sin(angles), 0 * angles], axis=1)
    init_t = gt_t + rng.normal(scale=0.05, size=gt_t.shape)
    init = Pose3(
        jnp.tile(jnp.asarray([1.0, 0, 0, 0]), (N, 1)), jnp.asarray(init_t)
    )

    idx_i, idx_j, mq, mt = [], [], [], []
    for a in range(N):
        b = (a + 1) % N
        idx_i.append(a)
        idx_j.append(b)
        mq.append([1.0, 0, 0, 0])
        mt.append(gt_t[b] - gt_t[a])
    E = len(idx_i)
    cap = -(-E // D) * D  # pad to shard-divisible
    pad = cap - E

    def pad0(x, value=0):
        x = np.asarray(x)
        return np.concatenate([x, np.full((pad,) + x.shape[1:], value, x.dtype)])

    edges_np = dict(
        i=pad0(idx_i).astype(np.int32),
        j=pad0(idx_j).astype(np.int32),
        mq=pad0(mq, 0.0),
        mt=pad0(mt, 0.0),
        w=pad0(np.ones(E), 0.0),
        m=pad0(np.ones(E, bool), False),
    )
    edges_np["mq"][E:, 0] = 1.0  # identity quats in padded slots

    # single-device reference (process-local arrays, no collectives)
    edges_local = PoseGraphEdges(
        jnp.asarray(edges_np["i"]),
        jnp.asarray(edges_np["j"]),
        Pose3(jnp.asarray(edges_np["mq"]), jnp.asarray(edges_np["mt"])),
        jnp.asarray(edges_np["w"]),
        jnp.asarray(edges_np["m"]),
    )
    ref_poses, ref_cost = optimize_pose_graph(init, edges_local, iterations=5)
    ref_t = np.asarray(ref_poses.translation)

    # global sharded edge set: every process contributes its local rows
    sh = NamedSharding(mesh, P("data"))
    rep = NamedSharding(mesh, P())

    def gshard(x):
        x = np.asarray(x)
        return jax.make_array_from_callback(
            x.shape, sh, lambda idx: x[idx]
        )

    def grep(x):
        x = np.asarray(x)
        return jax.make_array_from_callback(
            x.shape, rep, lambda idx: x[idx]
        )

    edges_g = PoseGraphEdges(
        gshard(edges_np["i"]),
        gshard(edges_np["j"]),
        Pose3(gshard(edges_np["mq"]), gshard(edges_np["mt"])),
        gshard(edges_np["w"]),
        gshard(edges_np["m"]),
    )
    init_g = Pose3(grep(np.asarray(init.rotation)), grep(np.asarray(init.translation)))

    poses, cost = jax.jit(
        lambda ini, e: optimize_pose_graph_sharded(ini, e, mesh, iterations=5)
    )(init_g, edges_g)
    # the sharded solver returns replicated (fully-addressable) outputs
    got_t = np.asarray(poses.translation)

    err = np.abs(got_t - ref_t).max()
    cost_err = abs(float(cost) - float(ref_cost))
    print(f"[proc {pid}] max|dt|={err:.3e} dcost={cost_err:.3e}", flush=True)
    assert err < 1e-8, err
    assert cost_err < 1e-10, cost_err
    print(f"[proc {pid}] OK", flush=True)


def scan_to_map_mode(pid: int, nproc: int):
    """Full mapping pipeline across the process boundary, checked per frame
    against the process-local single-device driver."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from loam_jax import LidarParams, scan_to_map_init, scan_to_map_step
    from loam_jax.io import render_trajectory
    from loam_jax.odometry.scan_to_map import ScanToMapConfig
    from loam_jax.params import FeatureExtractionParams, RegistrationParams
    from loam_jax.parallel.distributed import (
        scan_to_map_init_sharded,
        scan_to_map_step_sharded,
    )

    D = len(jax.devices())
    mesh = Mesh(np.asarray(jax.devices()).reshape(D), ("data",))
    lidar = LidarParams(8, 256, 0.5, 80.0)
    feat = FeatureExtractionParams(precise_selection=False)
    reg = RegistrationParams(
        max_iterations=2, min_associations=10, prior_weight=300.0
    )
    cfg = ScanToMapConfig(edge_capacity=512 * D, planar_capacity=2048 * D)

    # identical data on every process (deterministic renderer)
    scans, _ = render_trajectory(
        lidar, 6, step=np.array([0.05, 0.0, 0.0]), noise=0.003, seed=5,
        dtype=np.float32,
    )

    rep = NamedSharding(mesh, P())

    def grep(x):
        x = np.asarray(x)
        return jax.make_array_from_callback(x.shape, rep, lambda idx: x[idx])

    # process-local single-device reference
    single = scan_to_map_init(cfg)
    # global sharded state: init_sharded device_puts identical host data
    # with a cross-process NamedSharding (each process contributes its
    # addressable shards)
    sharded = scan_to_map_init_sharded(cfg, mesh)

    for f in range(scans.shape[0]):
        single, pose_1, _ = scan_to_map_step(
            single, jnp.asarray(scans[f]), lidar, feat_params=feat,
            reg_params=reg, config=cfg,
        )
        sharded, pose_d, _ = scan_to_map_step_sharded(
            sharded, grep(scans[f]), lidar, mesh, feat_params=feat,
            reg_params=reg, config=cfg,
        )
        dt = np.abs(
            np.asarray(pose_d.translation) - np.asarray(pose_1.translation)
        ).max()
        # two independently-converged ICF runs may differ by up to the
        # position convergence threshold (1e-2) per frame: collective psum
        # reduction order != single-device reduction order in f32, and a
        # knife-edge final iteration amplifies the ulp difference
        assert dt < 8e-3, f"frame {f}: pose divergence {dt}"
        fsi_d = int(jax.device_get(sharded.frames_since_insert))
        fsi_1 = int(single.frames_since_insert)
        assert fsi_d == fsi_1, f"frame {f}: keyframing diverged {fsi_d} {fsi_1}"

    n_single = int(single.edge_map.size) + int(single.planar_map.size)
    n_sharded = int(jax.device_get(sharded.edge_map.size)) + int(
        jax.device_get(sharded.planar_map.size)
    )
    assert abs(n_single - n_sharded) <= max(5, n_single // 100), (
        n_single, n_sharded,
    )
    print(f"[proc {pid}] map {n_sharded} vs {n_single} OK", flush=True)
    print(f"[proc {pid}] OK", flush=True)


if __name__ == "__main__":
    main()
