"""Compat-layer tests: the reference pybind11 API surface, drop-in.

Exercises the README's example flow (``/root/reference/README.md:44-60``)
through the compat names only.
"""

import numpy as np

from loam_jax import compat as loam
from loam_jax.io import render_trajectory


def test_quaternion_and_pose():
    q = loam.Quaterniond(1.0, 0.0, 0.0, 0.0)
    assert q.w() == 1.0 and q.z() == 0.0
    p = loam.Pose3d.Identity()
    assert np.allclose(p.translation, 0)
    p2 = loam.Pose3d(loam.Quaterniond(), np.array([1.0, 2.0, 3.0]))
    comp = p2.compose(p2)
    assert np.allclose(comp.translation, [2, 4, 6])
    inv = p2.inverse()
    assert np.allclose(p2.compose(inv).translation, 0, atol=1e-12)
    assert np.allclose(p2.act(np.zeros(3)), p2.translation)
    assert comp.matrix().shape == (4, 4)


def test_readme_flow():
    lidar_params = loam.LidarParams(16, 256, 0.5, 80.0)
    scans, _ = render_trajectory(
        lidar_params, 2, noise=0.004, seed=3, dtype=np.float64
    )
    feat_params = loam.FeatureExtractionParams()
    feat_params.number_sectors = 6

    features_prev = loam.extractFeatures(
        scans[0].reshape(-1, 3), lidar_params, feat_params
    )
    features_curr = loam.extractFeatures(
        scans[1].reshape(-1, 3), lidar_params, feat_params
    )
    assert features_prev.edge_points.shape[1] == 3
    assert len(features_prev.planar_points) > 100

    detail = loam.RegistrationDetail()
    pose = loam.registerFeatures(
        features_curr,
        features_prev,
        loam.Pose3d.Identity(),
        loam.RegistrationParams(),
        detail,
    )
    assert isinstance(pose, loam.Pose3d)
    assert detail.termination_type == loam.CONVERGED
    assert len(detail.iteration_info) >= 1
    info = detail.iteration_info[0]
    assert len(info.edge_associations) + len(info.plane_associations) >= 100
    # associations are (source_idx, target_idx) int pairs
    s, t = info.plane_associations[0]
    assert isinstance(s, int) and isinstance(t, int)


def test_curvature_and_validity_lists():
    lidar_params = loam.LidarParams(4, 64, 0.5, 80.0)
    scans, _ = render_trajectory(lidar_params, 1, noise=0.0, seed=0)
    c = loam.computeCurvature(scans[0].reshape(-1, 3), lidar_params)
    v = loam.computeValidPoints(scans[0].reshape(-1, 3), lidar_params)
    assert len(c) == 4 * 64 and len(v) == 4 * 64
    assert c[0] == -1.0  # line-edge sentinel
    assert isinstance(v[0], bool)


def test_root_shim_importable():
    import loam as shim

    assert shim.CONVERGED == loam.CONVERGED
    assert hasattr(shim, "registerFeatures")


def test_point_type_adapters():
    """Analogue of the reference's accessor templates (common.h:53-93):
    structured arrays, attribute-style points, and plain lists all work."""
    import collections

    from loam_jax.adapters import as_points

    pts = np.array([(1.0, 2.0, 3.0), (4.0, 5.0, 6.0)],
                   dtype=[("x", "f4"), ("y", "f4"), ("z", "f4")])
    np.testing.assert_allclose(as_points(pts), [[1, 2, 3], [4, 5, 6]])

    P = collections.namedtuple("P", "x y z")
    np.testing.assert_allclose(
        as_points([P(1, 2, 3), P(4, 5, 6)]), [[1, 2, 3], [4, 5, 6]]
    )
    np.testing.assert_allclose(as_points([[1, 2, 3]]), [[1, 2, 3]])
    grid = np.zeros((2, 4, 3))
    assert as_points(grid).shape == (8, 3)
