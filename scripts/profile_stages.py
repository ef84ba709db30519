"""Per-stage DEVICE timing of the pipeline on the default backend (a GPU).

Uses ``loam_jax.profiling.device_time`` (dispatch-amortized, CSE-proof).
Run: python scripts/profile_stages.py   [PROFILE_GRID=1 for grid kNN stages]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

from loam_jax.profiling import device_time as _device_time, enable_compile_cache


def device_time(name, fn, x, *static_args, n=10):
    dt = _device_time(fn, x, *static_args, n_inner=n, reps=2)
    print(f"{name:45s} {dt*1000:10.3f} ms")
    return dt


def main():
    from loam_jax import LidarParams, extract_features, knn
    from loam_jax.params import FeatureExtractionParams, RegistrationParams
    from loam_jax.geometry import fit_line, fit_plane, Pose3
    from loam_jax.io import render_trajectory
    from loam_jax.neighbors import build_grid, knn_grid
    from loam_jax.registration.associate import associate_edges, associate_planes
    from loam_jax.registration.solver import _Problem, lm_solve
    from loam_jax.registration.icf import _register

    enable_compile_cache()
    print("devices:", jax.devices())
    lidar = LidarParams(64, 1024, 0.5, 120.0)
    feat_params = FeatureExtractionParams()
    reg = RegistrationParams()
    scans, _ = render_trajectory(
        lidar, 2, step=np.array([0.08, 0.02, 0.0]), noise=0.005, seed=0,
        dtype=np.float32,
    )
    s0, s1 = jnp.asarray(scans[0]), jnp.asarray(scans[1])

    f0 = extract_features(s0, lidar, feat_params)
    f1 = extract_features(s1, lidar, feat_params)
    print("  edges:", int(f0.num_edge), "planars:", int(f0.num_planar))

    device_time(
        "extract_features (64x1024)",
        lambda s: extract_features(s, lidar, feat_params),
        s0,
    )
    device_time(
        "knn edges (4224 q x 4224 t)",
        lambda q: knn(q, f0.edge_points, f0.edge_mask, reg.num_edge_neighbors,
                      reg.max_edge_neighbor_dist),
        f1.edge_points,
    )
    device_time(
        "knn planes (19584 x 19584)",
        lambda q: knn(q, f0.planar_points, f0.planar_mask, reg.num_plane_neighbors,
                      reg.max_plane_neighbor_dist),
        f1.planar_points,
    )
    device_time(
        "build_grid planes",
        lambda t: build_grid(t, f0.planar_mask, reg.max_plane_neighbor_dist),
        f0.planar_points,
    )
    if os.environ.get("PROFILE_GRID", "0") == "1":
        pg = build_grid(f0.planar_points, f0.planar_mask, reg.max_plane_neighbor_dist)
        eg = build_grid(f0.edge_points, f0.edge_mask, reg.max_edge_neighbor_dist)
        device_time(
            "knn_grid edges",
            lambda q: knn_grid(eg, q, reg.num_edge_neighbors, reg.max_edge_neighbor_dist, 64),
            f1.edge_points,
        )
        device_time(
            "knn_grid planes",
            lambda q: knn_grid(pg, q, reg.num_plane_neighbors, reg.max_plane_neighbor_dist, 64),
            f1.planar_points,
        )

    rp = knn(f1.planar_points, f0.planar_points, f0.planar_mask,
             reg.num_plane_neighbors, reg.max_plane_neighbor_dist)
    re = knn(f1.edge_points, f0.edge_points, f0.edge_mask,
             reg.num_edge_neighbors, reg.max_edge_neighbor_dist)
    nbr_e = f0.edge_points[re.indices]
    nbr_p = f0.planar_points[rp.indices]
    device_time("fit_line (4224 x k=5)", lambda n: fit_line(n, re.mask), nbr_e)
    device_time("fit_plane (19584 x k=5)", lambda n: fit_plane(n, rp.mask), nbr_p)

    device_time(
        "associate_edges",
        lambda q: associate_edges(q, f1.edge_mask, f0.edge_points, f0.edge_mask, reg),
        f1.edge_points,
    )
    device_time(
        "associate_planes",
        lambda q: associate_planes(q, f1.planar_mask, f0.planar_points, f0.planar_mask, reg),
        f1.planar_points,
    )

    ea = associate_edges(f1.edge_points, f1.edge_mask, f0.edge_points, f0.edge_mask, reg)
    pa = associate_planes(f1.planar_points, f1.planar_mask, f0.planar_points, f0.planar_mask, reg)
    device_time(
        "lm_solve (4 inner iters)",
        lambda pe: lm_solve(_Problem(pe, ea, f1.planar_points, pa), reg),
        f1.edge_points,
    )

    device_time(
        "register_features (full)",
        lambda a: _register(
            jax.tree.map(lambda x: x, f1)._replace(edge_points=a),
            f0, Pose3.identity(jnp.float32), reg, False),
        f1.edge_points,
    )


if __name__ == "__main__":
    main()
