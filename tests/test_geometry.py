"""Geometry tests — ports the reference's golden-value suite
(``tests/test_geometry.cpp``, constants generated with GTSAM) plus
closed-form distance grids, and adds batched/masked fit tests the reference
lacks."""

import jax.numpy as jnp
import numpy as np
import pytest

from loam_jax import geometry as geo
from loam_jax.geometry import Pose3


def quat(w, x, y, z):
    return jnp.asarray([w, x, y, z], dtype=jnp.float64)


class TestPose3:
    def test_compose(self):
        # test_geometry.cpp:32-51 golden values (GTSAM)
        q1 = quat(0.7473257838894183, 0.38405116269438366, -0.17015746936361906, -0.5148352287741462)
        q2 = quat(0.8378767472656409, -0.040374739652255895, -0.40934599608063865, 0.3588429911288663)
        t1 = jnp.asarray([-0.4, 3.0, -8.9])
        t2 = jnp.asarray([4.0, -5.0, 1.0])
        comp = Pose3(q1, t1).compose(Pose3(q2, t2))
        expected_q = np.array([0.7567645973045605, 0.019808900212688513, -0.5655135339985058, -0.32727571648894294])
        expected_t = np.array([-2.59584795, -1.87410099, -12.56352171])
        qr = np.asarray(comp.rotation)
        if qr[0] < 0:
            qr = -qr
        np.testing.assert_allclose(qr, expected_q, atol=1e-8)
        np.testing.assert_allclose(np.asarray(comp.translation), expected_t, atol=1e-7)

    def test_inverse(self):
        # test_geometry.cpp:51-66 golden values
        q1 = quat(0.7473257838894183, 0.38405116269438366, -0.17015746936361906, -0.5148352287741462)
        t1 = jnp.asarray([-0.4, 3.0, -8.9])
        inv = Pose3(q1, t1).inverse()
        expected_q = np.array([0.7473257838894183, -0.38405116269438366, 0.17015746936361906, 0.5148352287741462])
        expected_t = np.array([1.60941772, 6.39896027, 6.69575105])
        np.testing.assert_allclose(np.asarray(inv.rotation), expected_q, atol=1e-8)
        np.testing.assert_allclose(np.asarray(inv.translation), expected_t, atol=1e-7)

    def test_matrix(self):
        # test_geometry.cpp:66-87 golden values
        q1 = quat(0.9693342323515085, 0.018781217536151106, 0.15609411554196426, 0.18887307630401792)
        t1 = jnp.asarray([1.0, -5.0, 2.0])
        expected = np.array(
            [
                [0.87992318, -0.360299, 0.30970927, 1.0],
                [0.37202555, 0.92794845, 0.0225534, -5.0],
                [-0.29552021, 0.09537451, 0.95056379, 2.0],
                [0.0, 0.0, 0.0, 1.0],
            ]
        )
        np.testing.assert_allclose(np.asarray(Pose3(q1, t1).matrix()), expected, atol=1e-6)

    def test_identity_roundtrip(self):
        p = Pose3(
            geo.quat_from_axis_angle(jnp.asarray([0.0, 0.0, 1.0]), 0.7),
            jnp.asarray([1.0, 2.0, 3.0]),
        )
        r = p.compose(p.inverse())
        assert float(geo.quat_angular_distance(r.rotation, geo.quat_identity(jnp.float64))) < 1e-12
        np.testing.assert_allclose(np.asarray(r.translation), 0.0, atol=1e-12)

    def test_act_matches_matrix(self):
        rng = np.random.default_rng(0)
        v = rng.normal(size=3)
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        p = Pose3(
            geo.quat_from_axis_angle(jnp.asarray(axis), 0.9),
            jnp.asarray(rng.normal(size=3)),
        )
        out = np.asarray(p.act(jnp.asarray(v)))
        M = np.asarray(p.matrix())
        np.testing.assert_allclose(out, (M @ np.append(v, 1.0))[:3], atol=1e-12)

    def test_exp_log_roundtrip(self):
        rng = np.random.default_rng(1)
        rv = jnp.asarray(rng.normal(size=(32, 3)) * 0.5)
        q = geo.quat_exp(rv)
        np.testing.assert_allclose(np.asarray(geo.quat_log(q)), np.asarray(rv), atol=1e-10)
        # tiny angles
        rv2 = jnp.asarray(rng.normal(size=(8, 3)) * 1e-8)
        np.testing.assert_allclose(np.asarray(geo.quat_log(geo.quat_exp(rv2))), np.asarray(rv2), atol=1e-14)


class TestDistances:
    def test_point_to_line(self):
        # test_geometry.cpp:91-103 closed-form grid
        la = jnp.asarray([0.0, 0.0, 0.0])
        lb = jnp.asarray([0.0, 0.0, 1.0])
        xs = np.arange(-5, 5, 0.5)
        pts = np.array([[x, y, x + y] for x in xs for y in xs])
        d = np.asarray(geo.point_to_line_distance(jnp.asarray(pts), la, lb))
        expected = np.hypot(pts[:, 0], pts[:, 1])
        np.testing.assert_allclose(d, expected, atol=1e-8)

    def test_point_to_plane(self):
        # test_geometry.cpp:105-114
        n = jnp.asarray([1.0, 0.0, 0.0])
        dist = 2.25
        xs = np.arange(-5, 5, 0.5)
        pts = np.array([[x, y, x + y] for x in xs for y in xs])
        d = np.asarray(geo.point_to_plane_distance(jnp.asarray(pts), n, dist))
        np.testing.assert_allclose(d, np.abs(pts[:, 0] - 2.25), atol=1e-8)


class TestFits:
    def test_fit_line_recovers_direction(self):
        rng = np.random.default_rng(2)
        direction = np.array([1.0, 2.0, -0.5])
        direction /= np.linalg.norm(direction)
        t = rng.uniform(-1, 1, size=8)
        pts = 3.0 + t[:, None] * direction
        a, b, cond = geo.fit_line(jnp.asarray(pts), jnp.ones(8, bool))
        d = np.array(a - b)
        d /= np.linalg.norm(d)
        assert abs(abs(d @ direction) - 1.0) < 1e-9
        np.testing.assert_allclose(np.asarray((a + b) / 2), pts.mean(0), atol=1e-9)

    def test_fit_line_masked(self):
        # garbage in masked rows must not affect the fit
        direction = np.array([0.0, 0.0, 1.0])
        pts = np.array([[1, 1, z] for z in np.linspace(-1, 1, 5)], dtype=float)
        full = np.concatenate([pts, [[999, -999, 123], [5, 5, 5]]])
        mask = np.array([True] * 5 + [False] * 2)
        a, b, _ = geo.fit_line(jnp.asarray(full), jnp.asarray(mask))
        d = np.array(a - b)
        d /= np.linalg.norm(d)
        assert abs(abs(d @ direction) - 1.0) < 1e-9

    def test_fit_plane(self):
        # plane x + 2y - z = 4  ->  n ~ (1,2,-1)/sqrt(6), d = 4/sqrt(6)
        rng = np.random.default_rng(3)
        yz = rng.uniform(-2, 2, size=(10, 2))
        x = 4.0 - 2 * yz[:, 0] + yz[:, 1]
        pts = np.column_stack([x, yz])
        n, d, avg = geo.fit_plane(jnp.asarray(pts), jnp.ones(10, bool))
        n = np.asarray(n)
        expected_n = np.array([1.0, 2.0, -1.0]) / np.sqrt(6)
        if n @ expected_n < 0:
            n = -n
        np.testing.assert_allclose(n, expected_n, atol=1e-9)
        assert abs(float(d) - 4 / np.sqrt(6)) < 1e-9
        assert abs(float(avg)) < 1e-9

    def test_fit_plane_masked_batched(self):
        rng = np.random.default_rng(4)
        # batch of 16 planes with 5 candidate rows, last row garbage/masked
        normals = rng.normal(size=(16, 3))
        normals /= np.linalg.norm(normals, axis=1, keepdims=True)
        ds = rng.uniform(1.0, 3.0, size=16)
        pts = np.zeros((16, 5, 3))
        for i in range(16):
            basis = np.linalg.svd(normals[i][None])[2][1:]
            uv = rng.uniform(-1, 1, size=(4, 2))
            pts[i, :4] = ds[i] * normals[i] + uv @ basis
            pts[i, 4] = rng.normal(size=3) * 100
        mask = np.ones((16, 5), bool)
        mask[:, 4] = False
        n, d, avg = geo.fit_plane(jnp.asarray(pts), jnp.asarray(mask))
        n = np.asarray(n)
        sign = np.sign(np.sum(n * normals, axis=1))
        np.testing.assert_allclose(n * sign[:, None], normals, atol=1e-8)
        np.testing.assert_allclose(np.asarray(d), ds, atol=1e-8)
        np.testing.assert_allclose(np.asarray(avg), 0.0, atol=1e-8)
