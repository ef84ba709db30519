"""Device check of extraction against the f64 NumPy oracle.

Runs ``extract_features`` on one 64x1024 f32 scan and
``extract_features_batch`` (``vmap``) on F of them, on the default backend,
and requires the selected index sequences to EQUAL the pure-NumPy f64
oracle's (ground truth independent of any JAX compilation). This is the
check for compiler rewrites that break the double-float selection math
(FMA contraction) or miscompile the batched program.

Run: python scripts/extract_oracle_check.py [FRAMES]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp


def main():
    F = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    from loam_jax import LidarParams, extract_features
    from loam_jax.features import extract_features_batch
    from loam_jax.io import render_trajectory
    from loam_jax.oracle import oracle
    from loam_jax.params import FeatureExtractionParams
    from loam_jax.profiling import enable_compile_cache

    enable_compile_cache()
    lidar = LidarParams(64, 1024, 0.5, 120.0)
    params = FeatureExtractionParams()
    scans, _ = render_trajectory(
        lidar, F, step=np.array([0.08, 0.02, 0.0]), yaw_rate=0.01,
        noise=0.005, seed=0, dtype=np.float32,
    )
    want = [
        oracle.extract_features(s.astype(np.float64), lidar, params)
        for s in scans
    ]
    print("devices:", jax.devices(), flush=True)

    def picks(idx):
        return [int(i) for i in np.asarray(idx) if i >= 0]

    def same(fs, f):
        return (picks(fs.edge_indices) == list(want[f][0])
                and picks(fs.planar_indices) == list(want[f][1]))

    single = same(extract_features(jnp.asarray(scans[0]), lidar, params), 0)
    batch = jax.block_until_ready(
        extract_features_batch(jnp.asarray(scans), lidar, params)
    )
    wrong = [f for f in range(F)
             if not same(jax.tree.map(lambda x: x[f], batch), f)]
    print(f"single scan: {'ORACLE-EXACT' if single else 'WRONG'}")
    print(f"vmap batch of {F}: "
          f"{'ORACLE-EXACT' if not wrong else f'WRONG frames {wrong}'}")
    if not single or wrong:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
