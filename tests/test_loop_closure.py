"""Loop-closure detection + end-to-end drift correction test.

Builds a noisy odometry trajectory that revisits its start; the closure
pipeline must find the revisit, verify it by registration, and the
pose-graph solve must pull the loop shut.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from loam_jax import LidarParams, extract_features, feature_set_from_points
from loam_jax.geometry import Pose3, quat_exp, quat_multiply, quat_normalize
from loam_jax.io import render_scan, default_world
from loam_jax.loop_closure import (
    closure_edges,
    optimize_trajectory_with_closures,
    propose_candidates,
    verify_closures,
)

LIDAR = LidarParams(16, 360, 0.5, 80.0)


def _square_loop_scans(n_side=4, step=0.5):
    """Keyframes around a small square, ending back at the start."""
    world = default_world(seed=2)
    positions, yaws = [], []
    pos = np.zeros(3)
    yaw = 0.0
    for side in range(4):
        for _ in range(n_side):
            positions.append(pos.copy())
            yaws.append(yaw)
            c, s = np.cos(yaw), np.sin(yaw)
            pos = pos + np.array([c, s, 0.0]) * step
        yaw += np.pi / 2
    positions.append(positions[0].copy())
    yaws.append(yaws[0] + 2 * np.pi)
    scans = [
        render_scan(LIDAR, p, y, world=world, noise=0.002, seed=i, dtype=np.float32)
        for i, (p, y) in enumerate(zip(positions, yaws))
    ]
    return np.stack(scans), np.stack(positions), np.asarray(yaws)


@pytest.fixture(scope="module")
def loop_data():
    scans, gt_pos, gt_yaw = _square_loop_scans()
    feats = jax.vmap(lambda s: extract_features(jnp.asarray(s), LIDAR))(
        jnp.asarray(scans)
    )
    return scans, gt_pos, gt_yaw, feats


def _gt_trajectory(gt_pos, gt_yaw):
    z = jnp.asarray([0.0, 0.0, 1.0])
    qs = jnp.stack([quat_exp(z * y) for y in gt_yaw]).astype(jnp.float32)
    return Pose3(qs, jnp.asarray(gt_pos, jnp.float32))


def test_propose_candidates_finds_revisit(loop_data):
    scans, gt_pos, gt_yaw, feats = loop_data
    traj = _gt_trajectory(gt_pos, gt_yaw)
    i, j, valid = propose_candidates(traj, max_candidates=4, min_separation=8,
                                     max_distance=1.0)
    pairs = {(int(a), int(b)) for a, b, v in zip(i, j, valid) if bool(v)}
    assert pairs, "no candidates found"
    # the start/end revisit must be among them
    assert any(b - a >= 12 for a, b in pairs)


def test_end_to_end_loop_closure(loop_data):
    scans, gt_pos, gt_yaw, feats = loop_data
    N = len(gt_pos) + 0
    # corrupt the ground-truth trajectory with accumulated drift
    rng = np.random.default_rng(0)
    drift = np.cumsum(rng.normal(0, 0.01, (N + 1, 3)) * np.array([1, 1, 0.2]), axis=0)
    gt = _gt_trajectory(gt_pos, gt_yaw)
    noisy = Pose3(
        gt.rotation,
        gt.translation + jnp.asarray(drift[: N + 1 - 0][: gt.translation.shape[0]],
                                     jnp.float32),
    )
    end_err0 = float(
        jnp.linalg.norm(noisy.translation[-1] - noisy.translation[0])
    )
    opt, closures = optimize_trajectory_with_closures(
        noisy,
        feats,
        max_candidates=4,
        min_separation=8,
        max_distance=1.5,
        iterations=8,
    )
    assert bool(closures.accepted.any()), "no closure verified"
    end_err1 = float(jnp.linalg.norm(opt.translation[-1] - opt.translation[0]))
    # the revisit (frame N-1 == frame 0) must be pulled together
    assert end_err1 < 0.5 * end_err0 or end_err1 < 0.02, (end_err0, end_err1)


def test_wrong_minimum_closure_rejected(loop_data):
    """A registration that CONVERGES into a wrong alignment must not become
    a pose-graph edge: the post-fit quality gates (inlier fraction / mean
    residual) reject it."""
    scans, gt_pos, gt_yaw, feats = loop_data
    N = feats.edge_points.shape[0]

    # candidate pairing frame 0 with a frame ~quarter way around the square:
    # genuinely different viewpoints whose feature sets do not align, but a
    # proximity-based proposer (fed a collapsed trajectory) would offer it
    collapsed = Pose3(
        _gt_trajectory(gt_pos, gt_yaw).rotation,
        jnp.zeros((N, 3), jnp.float32),  # all keyframes claim the same spot
    )
    ci = jnp.asarray([0], jnp.int32)
    cj = jnp.asarray([N // 2], jnp.int32)
    cv = jnp.asarray([True])
    closures = verify_closures(collapsed, feats, ci, cj, cv)
    # whatever the solver did, the gate must hold it out
    assert not bool(closures.accepted[0]), (
        float(closures.inlier_frac[0]),
        float(closures.mean_residual[0]),
    )

    # sanity: the TRUE revisit (first == last keyframe) still passes the gate
    traj = _gt_trajectory(gt_pos, gt_yaw)
    good = verify_closures(
        traj, feats, jnp.asarray([0], jnp.int32),
        jnp.asarray([N - 1], jnp.int32), jnp.asarray([True]),
    )
    assert bool(good.accepted[0])
    assert float(good.inlier_frac[0]) > 0.5
