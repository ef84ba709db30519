"""Loop-level ICF parity vs the scalar NumPy oracle.

``loam_jax.oracle.icf_oracle.register_oracle`` is a plain-Python
transcription of the reference's registration control flow
(``registration-inl.h:28-74`` / ``registration.cpp:23-103``) with this
framework's f64 solver numerics. These tests assert the JAX
``register_features`` loop matches it ITERATION BY ITERATION: association
validity masks, match indices, per-iteration deltas, iteration count,
termination type, and final pose.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from loam_jax import (
    Pose3,
    RegistrationParams,
    TerminationType,
    feature_set_from_points,
    register_features,
)
from loam_jax.oracle.icf_oracle import register_oracle

from test_registration import simple_scene


@pytest.fixture(scope="module")
def noisy_scene():
    # noise breaks the regular grid's exact kNN distance ties, so discrete
    # decisions cannot depend on tie-resolution order
    edge, planar = simple_scene(step=0.2)
    rng = np.random.default_rng(9)
    edge = edge + rng.normal(scale=0.01, size=edge.shape)
    planar = planar + rng.normal(scale=0.01, size=planar.shape)
    return edge, planar


def _transform(pts, q, t):
    pose = Pose3(jnp.asarray(q, jnp.float64), jnp.asarray(t, jnp.float64))
    return np.asarray(pose.act(jnp.asarray(pts)))


def _run_both(edge, planar, src_edge, src_planar, params, init_q, init_t):
    target = feature_set_from_points(edge, planar, dtype=jnp.float64)
    source = feature_set_from_points(src_edge, src_planar, dtype=jnp.float64)
    init = Pose3(jnp.asarray(init_q, jnp.float64), jnp.asarray(init_t, jnp.float64))
    est, detail = register_features(source, target, init, params)
    oracle = register_oracle(
        src_edge, src_planar, edge, planar, init_q, init_t, params
    )
    return est, detail, oracle


def _check_iterations(detail, oracle):
    n = int(detail.num_iterations)
    assert n == len(oracle.iterations)
    info = detail.iteration_info
    for i, it in enumerate(oracle.iterations):
        em = np.asarray(info.edge_match[i])[: len(it.edge_match)]
        pm = np.asarray(info.plane_match[i])[: len(it.plane_match)]
        np.testing.assert_array_equal(em >= 0, it.edge_valid, f"iter {i} edge valid")
        np.testing.assert_array_equal(em, it.edge_match, f"iter {i} edge match")
        np.testing.assert_array_equal(pm >= 0, it.plane_valid, f"iter {i} plane valid")
        np.testing.assert_array_equal(pm, it.plane_match, f"iter {i} plane match")
        np.testing.assert_array_equal(
            np.asarray(info.edge_count[i]), it.edge_valid.sum()
        )
        np.testing.assert_array_equal(
            np.asarray(info.plane_count[i]), it.plane_valid.sum()
        )
        np.testing.assert_allclose(
            np.asarray(info.target_T_source_init.rotation[i]), it.est_in_q, atol=1e-9
        )
        np.testing.assert_allclose(
            np.asarray(info.target_T_source_init.translation[i]), it.est_in_t, atol=1e-9
        )
        np.testing.assert_allclose(
            np.asarray(info.estimate_update.rotation[i]), it.delta_q, atol=1e-8
        )
        np.testing.assert_allclose(
            np.asarray(info.estimate_update.translation[i]), it.delta_t, atol=1e-8
        )


def test_icf_loop_matches_oracle_converged(noisy_scene):
    edge, planar = noisy_scene
    q = np.array([0.9995, 0.015, 0.02, 0.01])
    q = q / np.linalg.norm(q)
    t = np.array([0.05, -0.03, 0.02])
    src_edge = _transform(edge, q, t)
    src_planar = _transform(planar, q, t)
    params = RegistrationParams()
    est, detail, oracle = _run_both(
        edge, planar, src_edge, src_planar, params, (1.0, 0, 0, 0), (0.0, 0, 0)
    )
    assert int(detail.termination) == oracle.termination
    assert oracle.termination == int(TerminationType.CONVERGED)
    _check_iterations(detail, oracle)
    np.testing.assert_allclose(np.asarray(est.rotation), oracle.q, atol=1e-8)
    np.testing.assert_allclose(np.asarray(est.translation), oracle.t, atol=1e-8)


def test_icf_loop_matches_oracle_max_iter(noisy_scene):
    # convergence thresholds of 0 can never fire -> all max_iterations run
    edge, planar = noisy_scene
    q = np.array([0.999, 0.02, -0.025, 0.015])
    q = q / np.linalg.norm(q)
    t = np.array([-0.04, 0.06, -0.02])
    src_edge = _transform(edge, q, t)
    src_planar = _transform(planar, q, t)
    params = RegistrationParams(
        rotation_convergence_thresh=0.0,
        position_convergence_thresh=0.0,
        max_iterations=5,
    )
    est, detail, oracle = _run_both(
        edge, planar, src_edge, src_planar, params, (1.0, 0, 0, 0), (0.0, 0, 0)
    )
    assert int(detail.termination) == oracle.termination
    assert oracle.termination == int(TerminationType.MAX_ITER)
    assert int(detail.num_iterations) == 5
    _check_iterations(detail, oracle)
    np.testing.assert_allclose(np.asarray(est.rotation), oracle.q, atol=1e-8)
    np.testing.assert_allclose(np.asarray(est.translation), oracle.t, atol=1e-8)


def test_icf_loop_matches_oracle_insufficient(noisy_scene):
    # a source too small for min_associations must bail BEFORE solving with
    # the pose unchanged and zero recorded iterations (§2.3(9))
    edge, planar = noisy_scene
    src_edge, src_planar = edge[:10], planar[:40]
    params = RegistrationParams()
    init_t = (0.3, -0.1, 0.2)
    est, detail, oracle = _run_both(
        edge, planar, src_edge, src_planar, params, (1.0, 0, 0, 0), init_t
    )
    assert int(detail.termination) == oracle.termination
    assert oracle.termination == int(TerminationType.INSUFFICIENT_ASSOCIATIONS)
    assert int(detail.num_iterations) == len(oracle.iterations) == 0
    np.testing.assert_allclose(np.asarray(est.translation), init_t, atol=0)
    np.testing.assert_allclose(np.asarray(est.translation), oracle.t, atol=0)
