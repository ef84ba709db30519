"""Pose-graph optimization tests: odometry chain + loop closures."""

import numpy as np

import jax
import jax.numpy as jnp

from loam_jax.geometry import Pose3, quat_exp, quat_multiply, quat_normalize, quat_rotate
from loam_jax.pose_graph import (
    PoseGraphEdges,
    make_edges,
    odometry_edges,
    optimize_pose_graph,
)


def _compose(a: Pose3, b: Pose3) -> Pose3:
    return a.compose(b)


def _make_square_trajectory(n_per_side=5, step=1.0):
    """Ground-truth square loop in the plane, heading along each side."""
    poses = [Pose3.identity(jnp.float64)]
    z = jnp.asarray([0.0, 0.0, 1.0])
    for side in range(4):
        for _ in range(n_per_side):
            rel = Pose3(quat_exp(jnp.zeros(3)), jnp.asarray([step, 0.0, 0.0]))
            poses.append(poses[-1].compose(rel))
        turn = Pose3(quat_exp(z * (np.pi / 2)), jnp.zeros(3))
        poses.append(poses[-1].compose(turn))
    return jax.tree.map(lambda *xs: jnp.stack(xs), *poses)


def _perturb_edges(edges: PoseGraphEdges, sigma_rot, sigma_t, seed=0):
    rng = np.random.default_rng(seed)
    E = edges.i.shape[0]
    dq = quat_exp(jnp.asarray(rng.normal(0, sigma_rot, (E, 3))))
    m = edges.measurement
    noisy = Pose3(
        quat_normalize(quat_multiply(dq, m.rotation)),
        m.translation + jnp.asarray(rng.normal(0, sigma_t, (E, 3))),
    )
    return edges._replace(measurement=noisy)


def test_recovers_exact_graph():
    gt = _make_square_trajectory()
    edges = odometry_edges(gt)
    # start from a badly perturbed initialization
    rng = np.random.default_rng(1)
    N = gt.translation.shape[0]
    init = Pose3(
        quat_normalize(
            quat_multiply(
                quat_exp(jnp.asarray(rng.normal(0, 0.05, (N, 3)))), gt.rotation
            )
        ),
        gt.translation + jnp.asarray(rng.normal(0, 0.3, (N, 3))),
    )
    init = jax.tree.map(lambda a, b: a.at[0].set(b[0]), init, gt)  # node 0 fixed
    opt, cost = optimize_pose_graph(init, edges, iterations=10)
    assert float(cost) < 1e-12
    np.testing.assert_allclose(
        np.asarray(opt.translation), np.asarray(gt.translation), atol=1e-5
    )


def test_loop_closure_corrects_drift():
    gt = _make_square_trajectory()
    N = gt.translation.shape[0]
    # noisy odometry chain accumulates drift
    noisy_odo = _perturb_edges(odometry_edges(gt), 0.004, 0.02, seed=2)
    # integrate the noisy chain as the initial guess
    poses = [Pose3.identity(jnp.float64)]
    for e in range(N - 1):
        rel = jax.tree.map(lambda x: x[e], noisy_odo.measurement)
        poses.append(poses[-1].compose(rel))
    init = jax.tree.map(lambda *xs: jnp.stack(xs), *poses)
    drift0 = float(jnp.linalg.norm(init.translation[-1] - gt.translation[-1]))

    # strong loop closure: last node sees node 0 exactly (z = T_{N-1}^{-1} T_0)
    last = jax.tree.map(lambda x: x[N - 1], gt)
    first = jax.tree.map(lambda x: x[0], gt)
    z = last.inverse().compose(first)
    closure = make_edges(
        jnp.asarray([N - 1]),
        jnp.asarray([0]),
        jax.tree.map(lambda x: x[None], z),
        weight=jnp.asarray([100.0]),
    )
    edges = PoseGraphEdges(
        i=jnp.concatenate([noisy_odo.i, closure.i]),
        j=jnp.concatenate([noisy_odo.j, closure.j]),
        measurement=jax.tree.map(
            lambda a, b: jnp.concatenate([a, b]),
            noisy_odo.measurement,
            closure.measurement,
        ),
        weight=jnp.concatenate([noisy_odo.weight, closure.weight]),
        mask=jnp.concatenate([noisy_odo.mask, closure.mask]),
    )
    opt, cost = optimize_pose_graph(init, edges, iterations=15)
    drift1 = float(jnp.linalg.norm(opt.translation[-1] - gt.translation[-1]))
    assert drift1 < 0.05 * max(drift0, 1e-9) or drift1 < 1e-3, (drift0, drift1)
    # overall trajectory error shrinks substantially
    err0 = float(jnp.linalg.norm(init.translation - gt.translation, axis=1).mean())
    err1 = float(jnp.linalg.norm(opt.translation - gt.translation, axis=1).mean())
    assert err1 < 0.5 * err0, (err0, err1)


def test_masked_edges_ignored():
    gt = _make_square_trajectory(n_per_side=2)
    edges = odometry_edges(gt)
    # append a garbage edge with mask False: must not change the solution
    bogus = make_edges(
        jnp.asarray([0]),
        jnp.asarray([3]),
        jax.tree.map(
            lambda x: x[None],
            Pose3(jnp.asarray([1.0, 0, 0, 0]), jnp.asarray([99.0, 0, 0])),
        ),
        mask=jnp.asarray([False]),
    )
    both = PoseGraphEdges(
        i=jnp.concatenate([edges.i, bogus.i]),
        j=jnp.concatenate([edges.j, bogus.j]),
        measurement=jax.tree.map(
            lambda a, b: jnp.concatenate([a, b]), edges.measurement, bogus.measurement
        ),
        weight=jnp.concatenate([edges.weight, bogus.weight]),
        mask=jnp.concatenate([edges.mask, bogus.mask]),
    )
    a, _ = optimize_pose_graph(gt, edges, iterations=3)
    b, _ = optimize_pose_graph(gt, both, iterations=3)
    np.testing.assert_allclose(
        np.asarray(a.translation), np.asarray(b.translation), atol=1e-9
    )


def test_sharded_solve_matches_single():
    """Edge-sharded (psum-reduced) solve equals the single-device solve."""
    from loam_jax.parallel import make_mesh
    from loam_jax.pose_graph import optimize_pose_graph_sharded

    gt = _make_square_trajectory(n_per_side=2)
    edges = _perturb_edges(odometry_edges(gt), 0.002, 0.01, seed=5)
    E = edges.i.shape[0]
    pad = (-E) % 8
    if pad:
        edges = PoseGraphEdges(
            i=jnp.concatenate([edges.i, jnp.zeros(pad, jnp.int32)]),
            j=jnp.concatenate([edges.j, jnp.ones(pad, jnp.int32)]),
            measurement=jax.tree.map(
                lambda x: jnp.concatenate([x, jnp.broadcast_to(x[:1], (pad,) + x.shape[1:])]),
                edges.measurement,
            ),
            weight=jnp.concatenate([edges.weight, jnp.zeros(pad)]),
            mask=jnp.concatenate([edges.mask, jnp.zeros(pad, bool)]),
        )
    single, cost1 = optimize_pose_graph(gt, edges, iterations=3)
    mesh = make_mesh(line_axis=1)
    sharded, cost2 = optimize_pose_graph_sharded(gt, edges, mesh, iterations=3)
    np.testing.assert_allclose(
        np.asarray(sharded.translation), np.asarray(single.translation), atol=1e-8
    )
    np.testing.assert_allclose(float(cost1), float(cost2), rtol=1e-6, atol=1e-20)
