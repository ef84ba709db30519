"""Multi-device scaling-efficiency benchmark.

Measures batched odometry throughput on 1 device vs all devices with the
frame axis sharded over the mesh, and reports scaling efficiency
(throughput_N / (N * throughput_1)) on the devices JAX finds:

    python benchmarks/scaling.py                # all GPUs of this host
    python benchmarks/scaling.py --cpu-mesh 4   # rehearsal on 4 virtual CPU devices

A ``--cpu-mesh`` run checks the sharded path and its collectives; its
times measure the host CPU, not a device.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if "--cpu-mesh" in sys.argv:
    _n = sys.argv[sys.argv.index("--cpu-mesh") + 1]
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={_n}"
    ).strip()
    import jax as _jax

    _jax.config.update("jax_platforms", "cpu")

import numpy as np


def run(n_devices, scans, lidar, feat_params, reg_params, reps=3):
    import jax
    from loam_jax.parallel import make_mesh, odometry_offline_sharded

    mesh = make_mesh(jax.devices()[:n_devices], line_axis=1)

    def once():
        traj, _ = odometry_offline_sharded(
            scans, lidar, mesh, feat_params, reg_params
        )
        jax.block_until_ready(traj)

    once()  # compile
    t0 = time.perf_counter()
    for _ in range(reps):
        once()
    return scans.shape[0] * reps / (time.perf_counter() - t0)


def main():
    import jax
    import jax.numpy as jnp

    from loam_jax import LidarParams
    from loam_jax.profiling import enable_compile_cache
    from loam_jax.params import FeatureExtractionParams, RegistrationParams
    from loam_jax.io import render_trajectory

    enable_compile_cache()
    n = len(jax.devices())
    frames_per_device = int(os.environ.get("LOAM_SCALING_FPD", "2"))
    lidar = LidarParams(
        int(os.environ.get("LOAM_SCALING_LINES", "16")),
        int(os.environ.get("LOAM_SCALING_PPL", "512")),
        0.5,
        120.0,
    )
    feat_params = FeatureExtractionParams()
    reg_params = RegistrationParams()

    scans, _ = render_trajectory(
        lidar, n * frames_per_device, step=np.array([0.08, 0.02, 0.0]),
        noise=0.005, seed=0, dtype=np.float32,
    )
    scans = jnp.asarray(scans)

    tp1 = run(1, scans, lidar, feat_params, reg_params)
    if n == 1:
        # one device: there is no scaling to measure; report throughput
        # only rather than a noise-ratio "efficiency"
        print(json.dumps({
            "metric": "scaling_efficiency",
            "devices": 1,
            "throughput_1dev": round(tp1, 2),
            "value": None,
            "unit": "fraction of linear scaling (needs >1 device)",
        }))
        return
    tpn = run(n, scans, lidar, feat_params, reg_params)
    eff = tpn / (n * tp1)
    virtual = jax.devices()[0].platform == "cpu"
    out = {
        "metric": "scaling_efficiency",
        "devices": n,
        "throughput_1dev": round(tp1, 2),
        f"throughput_{n}dev": round(tpn, 2),
        "value": round(eff, 3),
        "unit": "fraction of linear scaling",
        "platform": jax.devices()[0].platform,
        "device_kind": jax.devices()[0].device_kind,
    }
    if virtual:
        # N virtual devices oversubscribe one host CPU — this validates
        # the sharded path functionally, it does NOT measure device scaling
        out["virtual_cpu_mesh"] = True
        out["unit"] += " (virtual CPU mesh: functional validation only)"
    print(json.dumps(out))


if __name__ == "__main__":
    main()
