"""Dewarping tests: motion-compensated scans recover the end-of-sweep frame."""

import numpy as np

import jax
import jax.numpy as jnp

from loam_jax import LidarParams, extract_features, register_features
from loam_jax.dewarp import dewarp_scan
from loam_jax.geometry import Pose3, quat_from_axis_angle
from loam_jax.io import render_scan
from loam_jax.io.synthetic import render_scan_swept

LIDAR = LidarParams(16, 360, 0.5, 80.0)
Z = jnp.asarray([0.0, 0.0, 1.0])


def _swept(begin_pos, begin_yaw, end_pos, end_yaw, **kw):
    return render_scan_swept(
        LIDAR, np.asarray(begin_pos, float), begin_yaw,
        np.asarray(end_pos, float), end_yaw, dtype=np.float32, **kw,
    )


def test_dewarp_recovers_exact_end_frame():
    begin = np.zeros(3)
    end = np.array([0.25, 0.1, 0.0])
    yaw0, yaw1 = 0.0, 0.06
    warped, exact = _swept(begin, yaw0, end, yaw1)
    # begin_T_end: rotation by (yaw1-yaw0), translation of end in begin frame
    c, s = np.cos(yaw0), np.sin(yaw0)
    t_rel = np.array([c * (end - begin)[0] + s * (end - begin)[1],
                      -s * (end - begin)[0] + c * (end - begin)[1], 0.0])
    delta = Pose3(
        quat_from_axis_angle(Z, yaw1 - yaw0).astype(jnp.float32),
        jnp.asarray(t_rel, jnp.float32),
    )
    out = np.asarray(dewarp_scan(jnp.asarray(warped), delta, LIDAR))
    err_before = np.linalg.norm(warped - exact, axis=-1)
    err_after = np.linalg.norm(out - exact, axis=-1)
    r = np.linalg.norm(exact, axis=-1)
    near = r < 30
    # warped scans are decimeters off; dewarping brings them to mm-cm
    # (linear screw interpolation of the rotation; exact for this motion)
    assert err_before[near].mean() > 0.05
    assert err_after[near].mean() < 0.01
    assert err_after[near].max() < 0.05


def test_dewarp_identity_is_noop():
    scan = render_scan(LIDAR, noise=0.0, seed=1, dtype=np.float32)
    out = np.asarray(
        dewarp_scan(jnp.asarray(scan), Pose3.identity(jnp.float32), LIDAR)
    )
    np.testing.assert_allclose(out, scan, atol=1e-6)


def test_dewarp_improves_registration():
    """Registering a warped moving scan against a static previous scan gets
    closer to ground truth after dewarping with the (known) motion."""
    prev = render_scan(LIDAR, np.zeros(3), 0.0, noise=0.003, seed=0,
                       dtype=np.float32)
    begin = np.array([0.0, 0.0, 0.0])
    end = np.array([0.3, 0.05, 0.0])
    warped, exact = _swept(begin, 0.0, end, 0.04, noise=0.003, seed=1)
    delta = Pose3(
        quat_from_axis_angle(Z, 0.04).astype(jnp.float32),
        jnp.asarray(end, jnp.float32),
    )
    f_prev = extract_features(jnp.asarray(prev), LIDAR)

    def err(scan):
        f = extract_features(jnp.asarray(scan), LIDAR)
        est, _ = register_features(f, f_prev, delta)
        e_t = np.linalg.norm(np.asarray(est.translation) - end)
        return e_t

    e_warped = err(warped)
    e_dewarped = err(np.asarray(dewarp_scan(jnp.asarray(warped), delta, LIDAR)))
    assert e_dewarped < e_warped
    assert e_dewarped < 0.02, (e_warped, e_dewarped)


def test_se3_exp_log_roundtrip_and_interpolation():
    """geometry.se3_exp/se3_log: inverse pair + the constant-twist
    composition law Exp(a xi) o Exp(b xi) = Exp((a+b) xi)."""
    from loam_jax.geometry import se3_exp, se3_log, quat_angular_distance

    rng = np.random.default_rng(9)
    for _ in range(10):
        xi = jnp.asarray(
            np.concatenate([rng.normal(size=3) * 0.7, rng.normal(size=3) * 2.0]),
            jnp.float64,
        )
        pose = se3_exp(xi)
        np.testing.assert_allclose(np.asarray(se3_log(pose)), np.asarray(xi),
                                   atol=1e-12)
        a, b = 0.3, 0.45
        lhs = se3_exp(a * xi).compose(se3_exp(b * xi))
        rhs = se3_exp((a + b) * xi)
        assert float(quat_angular_distance(lhs.rotation, rhs.rotation)) < 1e-12
        np.testing.assert_allclose(np.asarray(lhs.translation),
                                   np.asarray(rhs.translation), atol=1e-12)


def test_dewarp_exact_matches_composed_ground_truth_aggressive_motion():
    """exact=True recovers the END frame to f32 noise under a fast-yaw +
    long-translation constant twist where the default linear-translation
    law is centimeters off (the acknowledged approximation, dewarp.py)."""
    from loam_jax.geometry import se3_exp

    L, P = LIDAR.scan_lines, LIDAR.points_per_line
    rng = np.random.default_rng(4)
    world = rng.uniform(-15, 15, size=(L, P, 3)).astype(np.float32)
    world[..., 2] = rng.uniform(0.2, 3.0, size=(L, P))  # keep off the origin

    # aggressive per-sweep motion: 0.8 rad yaw + [2.0, 0.5, 0.3] m twist
    xi = jnp.asarray([0.0, 0.0, 0.8, 2.0, 0.5, 0.3], jnp.float32)
    alpha = (np.arange(P) + 0.5) / P
    T_c = se3_exp(jnp.asarray(alpha, jnp.float32)[:, None] * xi[None, :])
    T_end = se3_exp(xi)

    # warped scan: column c's points in column c's instantaneous frame
    warped = np.asarray(
        jax.vmap(lambda Tc, pc: Tc.inverse().act(pc), in_axes=(0, 1),
                 out_axes=1)(T_c, jnp.asarray(world))
    )
    gt_end = np.asarray(T_end.inverse().act(jnp.asarray(world)))

    begin_T_end = Pose3(T_end.rotation, T_end.translation)
    out_exact = np.asarray(
        dewarp_scan(jnp.asarray(warped), begin_T_end, LIDAR, exact=True)
    )
    out_cheap = np.asarray(
        dewarp_scan(jnp.asarray(warped), begin_T_end, LIDAR)
    )
    err_exact = np.linalg.norm(out_exact - gt_end, axis=-1)
    err_cheap = np.linalg.norm(out_cheap - gt_end, axis=-1)
    assert err_exact.max() < 1e-4, err_exact.max()
    # the linear-translation approximation is visibly off at this motion
    assert err_cheap.max() > 0.05
    assert err_exact.max() < err_cheap.max() / 100
