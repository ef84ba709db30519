"""Adversarial solver scenes: where does fixed-4-step LM diverge from Ceres?

The reference runs true Ceres Levenberg-Marquardt with up to 4 inner
iterations per outer association round (``registration-inl.h:51-56``); this
repo runs 4 damped accept/reject Gauss-Newton steps with a relative damping
floor (``solver.py``). These tests pin the behavior contract on the scenes
where the two could diverge: near-degenerate geometry, far-range f32, and
association counts at exactly the ``min_associations`` boundary.

Documented divergence (also in docs/PERFORMANCE.md): on rank-deficient
problems Ceres's DENSE_QR computes a minimum-norm-ish step in the
unconstrained subspace, while our Marquardt floor (1e-6 of the largest
diagonal) explicitly bounds motion along null directions — both leave the
unobservable directions essentially at the initialization; neither is
"right", and the tests below assert the boundedness our scheme guarantees.
"""

import dataclasses

import numpy as np

import jax.numpy as jnp

from loam_jax import (
    LidarParams,
    Pose3,
    RegistrationParams,
    TerminationType,
    feature_set_from_points,
    register_features,
)
from loam_jax.geometry import quat_from_axis_angle


def _grid_plane(n=40, extent=2.0, origin=(0.0, 0.0, 0.0), axes=((1, 0, 0), (0, 1, 0))):
    """Dense grid of points on a plane patch."""
    u = np.linspace(-extent, extent, n)
    a, b = np.asarray(axes[0], float), np.asarray(axes[1], float)
    pts = [np.asarray(origin) + x * a + y * b for x in u for y in u]
    return np.asarray(pts)


def _register(edge, planar, pose, params=None, init=None):
    params = params or RegistrationParams()
    target = feature_set_from_points(edge, planar, dtype=jnp.float64)
    src_e = np.asarray(pose.act(jnp.asarray(edge))) if len(edge) else edge
    src_p = np.asarray(pose.act(jnp.asarray(planar)))
    source = feature_set_from_points(src_e, src_p, dtype=jnp.float64)
    return register_features(source, target, init, params)


def test_single_wall_is_bounded():
    """One planar wall constrains exactly 1 DoF (translation along the
    normal) + 2 rotations; the 3 unconstrained DoF must not wander. The
    relative damping floor bounds null-direction steps; with at most
    max_iterations x 4 inner steps the composed drift stays small."""
    wall = _grid_plane(n=45, extent=3.0, origin=(5.0, 0.0, 0.0),
                       axes=((0, 1, 0), (0, 0, 1)))  # x=5 yz-plane
    pose = Pose3(jnp.asarray([1.0, 0, 0, 0]), jnp.asarray([0.05, 0.0, 0.0]))
    est, detail = _register(np.zeros((0, 3)), wall, pose)
    t = np.asarray(est.translation)
    q = np.asarray(est.rotation)
    assert np.isfinite(t).all() and np.isfinite(q).all()
    # constrained direction recovered: the wall normal is x
    assert abs(t[0] + 0.05) < 1e-3, t
    # unconstrained directions (y, z translation) bounded near init (0)
    assert abs(t[1]) < 0.05 and abs(t[2]) < 0.05, t
    assert int(detail.termination) in (
        TerminationType.CONVERGED, TerminationType.MAX_ITER,
    )


def test_single_wall_with_prior_pins_null_directions():
    """prior_weight > 0 is the documented knob for holding unobservable
    directions AT the initialization (solver.py::_prior_xi)."""
    wall = _grid_plane(n=45, extent=3.0, origin=(5.0, 0.0, 0.0),
                       axes=((0, 1, 0), (0, 0, 1)))
    pose = Pose3(jnp.asarray([1.0, 0, 0, 0]), jnp.asarray([0.05, 0.0, 0.0]))
    params = dataclasses.replace(RegistrationParams(), prior_weight=1.0)
    est, _ = _register(np.zeros((0, 3)), wall, pose, params)
    t = np.asarray(est.translation)
    assert np.isfinite(t).all()
    assert abs(t[0] + 0.05) < 2e-3, t
    assert abs(t[1]) < 1e-2 and abs(t[2]) < 1e-2, t


def test_far_planes_f32():
    """Planes at ~100 m in f32: the centered-PCA plane fit must stay stable
    (the reference's algebraic points @ abc = 1 normal equations degrade as
    range^2 — the documented deliberate divergence, geometry.py::fit_plane)
    and registration must still recover a small pose."""
    walls = np.concatenate([
        _grid_plane(n=35, extent=4.0, origin=(100.0, 0.0, 0.0),
                    axes=((0, 1, 0), (0, 0, 1))),
        _grid_plane(n=35, extent=4.0, origin=(0.0, 100.0, 0.0),
                    axes=((1, 0, 0), (0, 0, 1))),
        _grid_plane(n=35, extent=4.0, origin=(0.0, 0.0, -2.0),
                    axes=((1, 0, 0), (0, 1, 0))),
    ])
    pose = Pose3(
        quat_from_axis_angle(jnp.asarray([0.0, 0.0, 1.0]), 1e-3),
        jnp.asarray([0.02, -0.01, 0.015]),
    )
    target = feature_set_from_points(np.zeros((0, 3)), walls, dtype=jnp.float32)
    src = feature_set_from_points(
        np.zeros((0, 3)),
        np.asarray(pose.act(jnp.asarray(walls, jnp.float32))),
        dtype=jnp.float32,
    )
    est, detail = register_features(src, target)
    t = np.asarray(est.translation)
    assert np.isfinite(t).all()
    np.testing.assert_allclose(
        t, [-0.02, 0.01, -0.015], atol=5e-3,
    )


def test_exactly_min_associations_boundary():
    """INSUFFICIENT_ASSOCIATIONS fires on count < min_associations, i.e.
    count == min_associations SOLVES (strict <, registration-inl.h:45-48)."""
    # a corner scene with a small, countable feature set
    edge = np.asarray([(2.0, 2.0, z) for z in np.linspace(-1, 1, 30)])
    planar = _grid_plane(n=12, extent=1.0, origin=(4.0, 0.0, 0.0),
                         axes=((0, 1, 0), (0, 0, 1)))  # 144 points
    pose = Pose3(jnp.asarray([1.0, 0, 0, 0]), jnp.asarray([0.01, 0.0, 0.0]))

    # total associable features = 30 + 144 = 174
    ok = dataclasses.replace(RegistrationParams(), min_associations=174)
    est, detail = _register(edge, planar, pose, ok)
    assert int(detail.termination) != TerminationType.INSUFFICIENT_ASSOCIATIONS
    assert int(detail.iteration_info.edge_count[0]) + int(
        detail.iteration_info.plane_count[0]
    ) == 174

    over = dataclasses.replace(RegistrationParams(), min_associations=175)
    est, detail = _register(edge, planar, pose, over)
    assert int(detail.termination) == TerminationType.INSUFFICIENT_ASSOCIATIONS
    # bails BEFORE solving: pose is the init (identity here), and the
    # insufficient iteration records nothing (SURVEY §2.3(9))
    np.testing.assert_allclose(
        np.asarray(est.translation), 0.0, atol=0.0,
    )
    assert int(detail.num_iterations) == 0


def test_minimal_line_fit_points_no_nans():
    """Neighborhoods at exactly min_line_fit_points with (near-)coincident
    points must never emit NaNs into the solve (associate.py guards)."""
    rng = np.random.default_rng(0)
    # clusters of exactly 3 nearly-coincident edge points
    centers = np.asarray([(3.0, y, 0.0) for y in np.linspace(-2, 2, 40)])
    edge = np.concatenate([
        c + 1e-5 * rng.standard_normal((3, 3)) for c in centers
    ])
    planar = _grid_plane(n=20, extent=2.0, origin=(6.0, 0.0, 0.0),
                         axes=((0, 1, 0), (0, 0, 1)))
    pose = Pose3(jnp.asarray([1.0, 0, 0, 0]), jnp.asarray([0.01, -0.005, 0.0]))
    params = dataclasses.replace(RegistrationParams(), min_associations=50)
    est, detail = _register(edge, planar, pose, params)
    assert np.isfinite(np.asarray(est.translation)).all()
    assert np.isfinite(np.asarray(est.rotation)).all()
