"""Odometry driver tests on synthetic trajectories.

Ground truth comes from ``render_trajectory``; accuracy thresholds are set
for the small noiseless/low-noise synthetic world (tighter than the BASELINE
ATE target, looser than registration unit tolerances).
"""

import os
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from loam_jax import (
    LidarParams,
    RegistrationParams,
    odometry_offline,
    scan_to_map_init,
    scan_to_map_step,
    scan_to_scan_init,
    scan_to_scan_step,
)
from loam_jax.evaluation import ate_rmse, rpe, rpe_rmse, umeyama_alignment
from loam_jax.io import render_trajectory

LIDAR = LidarParams(16, 360, 0.5, 80.0)
N_FRAMES = 6


@pytest.fixture(scope="module")
def trajectory():
    scans, poses = render_trajectory(
        LIDAR,
        N_FRAMES,
        step=np.array([0.10, 0.03, 0.0]),
        yaw_rate=0.02,
        noise=0.003,
        seed=11,
        dtype=np.float32,
    )
    gt = np.stack([t for (_, t) in poses])
    return scans, gt


def test_scan_to_scan(trajectory):
    scans, gt = trajectory
    state = scan_to_scan_init(LIDAR)
    est_positions = []
    for f in range(N_FRAMES):
        state, pose, detail = scan_to_scan_step(state, jnp.asarray(scans[f]), LIDAR)
        est_positions.append(np.asarray(pose.translation))
    est = np.stack(est_positions)
    ate = ate_rmse(est, gt, align=False)
    assert ate < 0.05, f"scan-to-scan ATE {ate}"


def test_scan_to_map(trajectory):
    scans, gt = trajectory
    state = scan_to_map_init()
    reg = RegistrationParams(search_backend="grid")
    est_positions = []
    for f in range(N_FRAMES):
        state, pose, detail = scan_to_map_step(
            state, jnp.asarray(scans[f]), LIDAR, reg_params=reg
        )
        est_positions.append(np.asarray(pose.translation))
    est = np.stack(est_positions)
    assert int(state.edge_map.size) > 0
    assert int(state.planar_map.size) > 0
    # grid backend truncation signal must be surfaced AND zero at this scale
    # (the search is then exact, like the reference's KD-tree kdtree.cpp:10-28)
    assert int(np.sum(np.asarray(detail.iteration_info.edge_knn_overflow))) == 0
    assert int(np.sum(np.asarray(detail.iteration_info.plane_knn_overflow))) == 0
    ate = ate_rmse(est, gt, align=False)
    assert ate < 0.05, f"scan-to-map ATE {ate}"


def test_offline_matches_streaming(trajectory):
    scans, gt = trajectory
    traj, details = odometry_offline(jnp.asarray(scans), LIDAR)
    est = np.asarray(traj.translation)
    assert est.shape == (N_FRAMES, 3)
    ate = ate_rmse(est, gt, align=False)
    assert ate < 0.05, f"offline ATE {ate}"

    # must agree with the streaming driver without motion prior (identical
    # registrations, identical composition)
    state = scan_to_scan_init(LIDAR)
    stream = []
    for f in range(N_FRAMES):
        state, pose, _ = scan_to_scan_step(
            state, jnp.asarray(scans[f]), LIDAR, use_motion_prior=False
        )
        stream.append(np.asarray(pose.translation))
    np.testing.assert_allclose(est, np.stack(stream), atol=1e-4)


def test_offline_chunked_matches_unchunked(trajectory):
    # lax.map-chunked pair batches (constant program size in F) must produce
    # exactly the same registrations as the single fully-vmapped batch
    scans, _ = trajectory
    traj_a, det_a = odometry_offline(jnp.asarray(scans), LIDAR, chunk_pairs=2)
    traj_b, det_b = odometry_offline(jnp.asarray(scans), LIDAR, chunk_pairs=0)
    np.testing.assert_array_equal(
        np.asarray(traj_a.translation), np.asarray(traj_b.translation)
    )
    np.testing.assert_array_equal(
        np.asarray(traj_a.rotation), np.asarray(traj_b.rotation)
    )
    np.testing.assert_array_equal(
        np.asarray(det_a.termination), np.asarray(det_b.termination)
    )
    np.testing.assert_array_equal(
        np.asarray(det_a.num_iterations), np.asarray(det_b.num_iterations)
    )


def test_umeyama_recovers_known_transform():
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(40, 3))
    ang = 0.7
    R = np.array(
        [[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1.0]]
    )
    t = np.array([1.0, -2.0, 0.5])
    moved = (R @ pts.T).T + t
    R2, t2, s = umeyama_alignment(pts, moved)
    np.testing.assert_allclose(R2, R, atol=1e-9)
    np.testing.assert_allclose(t2, t, atol=1e-9)
    assert ate_rmse(pts, moved, align=True) < 1e-9
    assert rpe_rmse(moved, moved) == 0.0


def test_rpe_matches_hand_computed():
    # Two-pose trajectories. Reference: identity -> +x 1m, no rotation.
    # Estimate: identity -> translation (1, 0.3, 0) with a 0.1 rad yaw.
    def rotz(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])

    ref_R = np.stack([np.eye(3), np.eye(3)])
    ref_t = np.array([[0.0, 0, 0], [1.0, 0, 0]])
    est_R = np.stack([np.eye(3), rotz(0.1)])
    est_t = np.array([[0.0, 0, 0], [1.0, 0.3, 0]])
    t_err, r_err = rpe(est_t, ref_t, est_R, ref_R, delta=1)
    # E = (rotz(0.1), (1, 0.3, 0)); G = (I, (1,0,0));
    # F = G^-1 E = (rotz(0.1), (0, 0.3, 0)) -> trans 0.3, rot 0.1
    np.testing.assert_allclose(t_err, 0.3, atol=1e-12)
    np.testing.assert_allclose(r_err, 0.1, atol=1e-12)

    # quaternion (wxyz) input path must agree with the matrix path
    a = 0.1
    est_q = np.array([[1.0, 0, 0, 0], [np.cos(a / 2), 0, 0, np.sin(a / 2)]])
    ref_q = np.array([[1.0, 0, 0, 0], [1.0, 0, 0, 0]])
    t2, r2 = rpe(est_t, ref_t, est_q, ref_q, delta=1)
    np.testing.assert_allclose([t2, r2], [t_err, r_err], atol=1e-12)

    # rotation drift is invisible to positions but not to rpe()
    est_same_pos = np.array([[0.0, 0, 0], [1.0, 0, 0]])
    t3, r3 = rpe(est_same_pos, ref_t, est_R, ref_R, delta=1)
    assert t3 == 0.0 and abs(r3 - 0.1) < 1e-12
    # position-only fallback: vector difference of relative translations
    assert abs(rpe_rmse(est_t, ref_t) - 0.3) < 1e-12


def test_scan_to_map_offline_matches_streaming(trajectory):
    # the lax.scan-driven whole-trajectory driver must reproduce the
    # streaming step loop exactly (same step function, same carry)
    from loam_jax import scan_to_map_offline
    from loam_jax.odometry.scan_to_map import ScanToMapConfig

    scans, gt = trajectory
    cfg = ScanToMapConfig(edge_capacity=2048, planar_capacity=8192)
    reg = RegistrationParams(search_backend="grid")
    state = scan_to_map_init(cfg)
    stream = []
    for f in range(N_FRAMES):
        state, pose, _ = scan_to_map_step(
            state, jnp.asarray(scans[f]), LIDAR, reg_params=reg, config=cfg
        )
        stream.append(np.asarray(pose.translation))
    fstate, traj, details = scan_to_map_offline(
        jnp.asarray(scans), LIDAR, reg_params=reg, config=cfg
    )
    np.testing.assert_allclose(
        np.asarray(traj.translation), np.stack(stream), atol=1e-6
    )
    np.testing.assert_array_equal(
        np.asarray(fstate.edge_map.mask), np.asarray(state.edge_map.mask)
    )
