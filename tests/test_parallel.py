"""Multi-device SPMD tests on the virtual 8-device CPU mesh (conftest)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from loam_jax import LidarParams, odometry_offline
from loam_jax.params import FeatureExtractionParams, RegistrationParams
from loam_jax.parallel import (
    extract_features_sharded,
    make_mesh,
    odometry_offline_sharded,
)
from loam_jax.io import render_trajectory

LIDAR = LidarParams(8, 128, 0.5, 80.0)
FEAT = FeatureExtractionParams(number_sectors=2)
REG = RegistrationParams(max_iterations=2, min_associations=10)


@pytest.fixture(scope="module")
def scans():
    s, _ = render_trajectory(
        LIDAR, 8, step=np.array([0.05, 0.0, 0.0]), noise=0.003, seed=5,
        dtype=np.float32,
    )
    return jnp.asarray(s)


def test_devices_available():
    assert len(jax.devices()) == 8


def test_sharded_extraction_matches_single(scans):
    mesh = make_mesh(line_axis=2)
    sharded = extract_features_sharded(scans, LIDAR, mesh, FEAT)
    from loam_jax import extract_features

    single = jax.vmap(lambda s: extract_features(s, LIDAR, FEAT))(scans)
    np.testing.assert_allclose(
        np.asarray(sharded.edge_points), np.asarray(single.edge_points), atol=1e-6
    )
    np.testing.assert_array_equal(
        np.asarray(sharded.planar_mask), np.asarray(single.planar_mask)
    )


def test_sharded_odometry_matches_single(scans):
    mesh = make_mesh(line_axis=1)
    traj_sh, _ = odometry_offline_sharded(scans, LIDAR, mesh, FEAT, REG)
    traj, _ = odometry_offline(scans, LIDAR, FEAT, REG)
    np.testing.assert_allclose(
        np.asarray(traj_sh.translation), np.asarray(traj.translation), atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(traj_sh.rotation), np.asarray(traj.rotation), atol=1e-5
    )


def test_sharded_odometry_2d_mesh(scans):
    mesh = make_mesh(line_axis=2)
    traj_sh, _ = odometry_offline_sharded(scans, LIDAR, mesh, FEAT, REG)
    traj, _ = odometry_offline(scans, LIDAR, FEAT, REG)
    np.testing.assert_allclose(
        np.asarray(traj_sh.translation), np.asarray(traj.translation), atol=1e-5
    )


def test_sharded_registration_matches_single():
    """Registration against a target sharded over 8 devices must match the
    single-device result (same associations, same tie-breaking)."""
    import jax.numpy as jnp
    from loam_jax import RegistrationParams, feature_set_from_points, register_features
    from loam_jax.geometry import Pose3, quat_from_axis_angle
    from loam_jax.parallel import make_mesh
    from loam_jax.parallel.distributed import register_features_sharded

    rng = np.random.default_rng(7)
    # synthetic planes + edges, padded to shard-divisible capacities
    planar = []
    for y in np.arange(2, 5, 0.12):
        for z in np.arange(-1, 1, 0.12):
            planar.append((-3.0, y, z))
            planar.append((y - 3.0, 5.0, z))
    edge = [(-1.0, 4.0, z) for z in np.arange(-1, 2, 0.05)]
    edge += [(2.0, 2.0, z) for z in np.arange(-1, 2, 0.05)]
    edge = np.asarray(edge)
    planar = np.asarray(planar)
    e_cap = -(-len(edge) // 8) * 8
    p_cap = -(-len(planar) // 8) * 8
    target = feature_set_from_points(
        edge, planar, edge_capacity=e_cap, planar_capacity=p_cap, dtype=jnp.float32
    )
    true = Pose3(
        quat_from_axis_angle(jnp.asarray([0.2, 0.5, 1.0]) / np.sqrt(1.29), 0.03),
        jnp.asarray([0.04, -0.02, 0.05]),
    )
    src_e = np.asarray(true.act(jnp.asarray(edge, jnp.float32)))
    src_p = np.asarray(true.act(jnp.asarray(planar, jnp.float32)))
    source = feature_set_from_points(
        src_e, src_p, edge_capacity=e_cap, planar_capacity=p_cap, dtype=jnp.float32
    )
    params = RegistrationParams(min_associations=50)

    single, detail = register_features(source, target, None, params)
    mesh = make_mesh(line_axis=1)
    sharded, sh_detail = register_features_sharded(
        source, target, Pose3.identity(jnp.float32), mesh, params,
        with_matches=True,
    )
    # full RegistrationDetail parity with the single-device path
    assert int(sh_detail.termination) == int(detail.termination)
    assert int(sh_detail.num_iterations) == int(detail.num_iterations)
    info_s, info_d = detail.iteration_info, sh_detail.iteration_info
    np.testing.assert_array_equal(
        np.asarray(info_d.edge_match), np.asarray(info_s.edge_match)
    )
    np.testing.assert_array_equal(
        np.asarray(info_d.plane_match), np.asarray(info_s.plane_match)
    )
    np.testing.assert_array_equal(
        np.asarray(info_d.edge_count), np.asarray(info_s.edge_count)
    )
    np.testing.assert_array_equal(
        np.asarray(info_d.plane_count), np.asarray(info_s.plane_count)
    )
    np.testing.assert_allclose(
        np.asarray(sharded.translation), np.asarray(single.translation), atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(sharded.rotation), np.asarray(single.rotation), atol=1e-5
    )


def test_sharded_voxel_map_matches_single():
    import jax.numpy as jnp
    from loam_jax import voxel_map_empty, voxel_map_insert
    from loam_jax.parallel import make_mesh
    from loam_jax.parallel.distributed import sharded_map_empty, sharded_map_insert

    rng = np.random.default_rng(3)
    pts = jnp.asarray(rng.uniform(-10, 10, (500, 3)).astype(np.float32))
    mask = jnp.asarray(rng.random(500) > 0.1)

    single = voxel_map_empty(1024, 0.5)
    single, _ = voxel_map_insert(single, pts, mask)

    mesh = make_mesh(line_axis=1)
    sh = sharded_map_empty(256, 0.5, mesh)
    sh, dropped = sharded_map_insert(sh, pts, mask, mesh)
    assert int(dropped) == 0

    def occupied(points, m):
        return set(map(tuple, np.asarray(points)[np.asarray(m)].round(6).tolist()))

    got = occupied(sh.points.reshape(-1, 3), sh.mask.reshape(-1))
    want = occupied(single.points, single.mask)
    assert got == want


def test_sharded_scan_to_map_matches_single(scans):
    """The composed distributed mapping driver (sharded-target registration
    + mod-D sharded map insert in one jitted step) must track the
    single-device scan-to-map driver over a >=10-frame trajectory: same
    keyframe decisions, same map occupancy, same poses (fp tolerance)."""
    from loam_jax import scan_to_map_init, scan_to_map_step
    from loam_jax.odometry.scan_to_map import ScanToMapConfig
    from loam_jax.parallel import make_mesh
    from loam_jax.parallel.distributed import (
        scan_to_map_init_sharded,
        scan_to_map_step_sharded,
    )

    s, _ = render_trajectory(
        LIDAR, 10, step=np.array([0.05, 0.0, 0.0]), noise=0.003, seed=5,
        dtype=np.float32,
    )
    s = jnp.asarray(s)
    cfg = ScanToMapConfig(edge_capacity=1024, planar_capacity=4096)
    reg = RegistrationParams(
        max_iterations=2, min_associations=10, prior_weight=300.0
    )
    mesh = make_mesh(line_axis=1)

    single = scan_to_map_init(cfg)
    sharded = scan_to_map_init_sharded(cfg, mesh)
    for f in range(s.shape[0]):
        single, pose_1, _ = scan_to_map_step(
            single, s[f], LIDAR, feat_params=FEAT, reg_params=reg, config=cfg
        )
        sharded, pose_d, _ = scan_to_map_step_sharded(
            sharded, s[f], LIDAR, mesh, feat_params=FEAT, reg_params=reg,
            config=cfg,
        )
        np.testing.assert_allclose(
            np.asarray(pose_d.translation),
            np.asarray(pose_1.translation),
            atol=2e-3,
            err_msg=f"frame {f}",
        )
        assert int(sharded.frames_since_insert) == int(single.frames_since_insert)
    # same map occupancy (content equality up to pose fp differences)
    n_single = int(single.edge_map.size) + int(single.planar_map.size)
    n_sharded = int(sharded.edge_map.size) + int(sharded.planar_map.size)
    assert abs(n_single - n_sharded) <= max(5, n_single // 100)
