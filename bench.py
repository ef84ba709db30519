"""Headline benchmark: end-to-end odometry throughput on one GPU.

Workload matches the reference's published numbers (``README.md:31``,
BASELINE.md): Ouster-64 geometry — 64 x 1024 = 65,536-point scans — full
pipeline (feature extraction + ICF registration per consecutive pair).
Reference baseline: ~16.5 ms/scan end-to-end single CPU core => ~60.6
scans/s.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "config",
"device", ...}. Every timed configuration is first gated on trajectory
accuracy (ATE against the renderer's ground truth). The bench refuses to
run without a GPU.

Env knobs:
  LOAM_BENCH_MODE     scan_to_scan (default) | batched_pairs | scan_to_map |
                      dataset
  LOAM_BENCH_FRAMES   (default 64)  frames per timed run
  LOAM_BENCH_REPS     (default 8)   timed repetitions per sample
  LOAM_BENCH_CHUNK    (default 4)   registration pairs per lockstep chunk
  LOAM_BENCH_BACKEND  (default "bruteforce") neighbor search backend
"""

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

LIDAR_ARGS = (64, 1024, 0.5, 120.0)


def _trajectory(frames: int):
    from loam_jax.io import render_trajectory
    from loam_jax.params import LidarParams

    lidar = LidarParams(*LIDAR_ARGS)
    scans, poses = render_trajectory(
        lidar, frames, step=np.array([0.08, 0.02, 0.0]), yaw_rate=0.01,
        noise=0.005, seed=0, dtype=np.float32,
    )
    return lidar, scans, poses


def check_accuracy(traj, poses, frames):
    """Benchmark numbers only count if the trajectory is RIGHT: a wrong
    feature set can still yield finite (wrong) poses that register faster.
    Gate every timed configuration on ATE against the renderer's ground
    truth, not just isfinite. Returns the ATE (m)."""
    import jax.numpy as jnp

    from loam_jax.evaluation import ate_rmse

    assert bool(jnp.isfinite(traj.translation).all()), "non-finite trajectory"
    gt = np.stack([t for (_, t) in poses])
    est = np.asarray(traj.translation)
    ate = ate_rmse(est, gt, align=False)
    path = float(np.sum(np.linalg.norm(np.diff(gt, axis=0), axis=-1)))
    limit = max(0.05 * path, 0.05)
    assert ate < limit, (
        f"trajectory ATE {ate:.3f} m exceeds {limit:.3f} m "
        f"({frames} frames, {path:.2f} m path) — wrong results, not a benchmark"
    )
    return ate


def timed(run, frames: int, reps: int) -> list:
    """Three samples of sustained scans/s: enqueue ``reps`` runs (device
    executions serialize), then one ``block_until_ready``."""
    import jax

    vals = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = None
        for _ in range(reps):
            out = run()
        jax.block_until_ready(out)
        vals.append(frames * reps / (time.perf_counter() - t0))
    return vals


def _offline_runner(frames, backend, chunk):
    import jax.numpy as jnp

    from loam_jax import odometry_offline
    from loam_jax.params import FeatureExtractionParams, RegistrationParams

    lidar, scans, poses = _trajectory(frames)
    scans = jnp.asarray(scans)
    reg = RegistrationParams(search_backend=backend)

    def run():
        traj, _ = odometry_offline(
            scans, lidar, FeatureExtractionParams(), reg, chunk_pairs=chunk,
            motion_init=True,
        )
        return traj

    return run, poses


def _scan_to_map_runner(frames):
    import jax.numpy as jnp

    from loam_jax import scan_to_map_offline

    lidar, scans, poses = _trajectory(frames)
    scans = jnp.asarray(scans)

    def run():
        _, traj, _ = scan_to_map_offline(scans, lidar)
        return traj

    return run, poses


def _dataset_runner(frames, root):
    """File-fed odometry (the reference's usage model, README.md:44-60):
    KITTI .bin files -> ``odometry_streaming``, timed INCLUDING the IO
    (native prefetch loader, packed upload, chunked async compute). The
    synthetic trajectory is written once under ``root``."""
    from loam_jax import odometry_streaming

    lidar, scans, poses = _trajectory(frames)
    paths = [os.path.join(root, f"{i:06d}.bin") for i in range(frames)]
    for p, scan in zip(paths, scans):
        pts = scan.reshape(-1, 3).astype(np.float32)
        np.concatenate([pts, np.zeros((len(pts), 1), np.float32)], 1).tofile(p)

    def run():
        traj, _ = odometry_streaming(paths, lidar, chunk_frames=16)
        return traj

    return run, poses


METRICS = {
    "scan_to_scan": "e2e_odometry_throughput",
    "batched_pairs": "batched_pair_registration_throughput",
    "scan_to_map": "e2e_scan_to_map_throughput",
    "dataset": "file_fed_odometry_throughput",
}


def main():
    import jax

    from loam_jax.profiling import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"bench.py measures a GPU; JAX found {dev.platform!r} "
            f"({dev.device_kind}) instead"
        )
    enable_compile_cache()

    mode = os.environ.get("LOAM_BENCH_MODE", "scan_to_scan")
    frames = int(os.environ.get("LOAM_BENCH_FRAMES", "64"))
    reps = int(os.environ.get("LOAM_BENCH_REPS", "8"))
    chunk = int(os.environ.get("LOAM_BENCH_CHUNK", "4"))
    backend = os.environ.get("LOAM_BENCH_BACKEND", "bruteforce")

    with tempfile.TemporaryDirectory() as tmp:
        if mode == "scan_to_scan":
            run, poses = _offline_runner(frames, backend, chunk)
        elif mode == "batched_pairs":
            run, poses = _offline_runner(frames, backend, 8)
        elif mode == "scan_to_map":
            run, poses = _scan_to_map_runner(frames)
        elif mode == "dataset":
            run, poses = _dataset_runner(frames, tmp)
        else:
            raise SystemExit(f"unknown LOAM_BENCH_MODE {mode!r}")

        t0 = time.perf_counter()
        jax.block_until_ready(run())  # compile + warm-up
        setup_s = time.perf_counter() - t0
        ate = check_accuracy(run(), poses, frames)
        samples = timed(run, frames, reps)

    value = float(sorted(samples)[1])  # median of 3
    baseline = 1000.0 / 16.5  # reference: 3.5 ms extract + 13 ms register
    print(json.dumps({
        "metric": METRICS[mode],
        "value": value,
        "unit": "scans/s (64x1024 Ouster-64 scans)",
        "vs_baseline": value / baseline,
        "config": (f"mode={mode} frames={frames} reps={reps} chunk={chunk} "
                   f"backend={backend}"),
        "samples": samples,
        "setup_s": setup_s,
        "ate_m": float(ate),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }), flush=True)


if __name__ == "__main__":
    main()
