"""Feature-extraction tests.

Tier 1: ports of the reference's synthetic-scene unit tests
(``tests/test_feature_extraction.cpp`` — curvature plane/corner, the four
validity checks).

Tier 2 (beyond the reference): exact oracle-diff — the vectorized kernels
must reproduce the NumPy oracle (scalar transcription of the reference
semantics) bit-for-bit on randomized synthetic scans, including the greedy
NMS pick with its cross-sector suppression and off-by-one caps.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from loam_jax import FeatureExtractionParams, LidarParams
from loam_jax import oracle
from loam_jax.features import (
    compute_curvature,
    compute_valid_points,
    extract_features,
    extract_features_given,
)
from loam_jax.io import render_scan

# Params used throughout the reference's feature tests:
# {neighbor=5, sectors=6, max_e=5, max_p=5, edge_t=100, planar_t=0.1, occl=0.25, par=0.02}
REF_TEST_PARAMS = FeatureExtractionParams(
    neighbor_points=5,
    number_sectors=6,
    max_edge_feats_per_sector=5,
    max_planar_feats_per_sector=5,
    edge_feat_threshold=100.0,
    planar_feat_threshold=0.1,
    occlusion_thresh=0.25,
    parallel_thresh=0.02,
)


def scan_from_points(pts):
    return jnp.asarray(np.asarray(pts, dtype=np.float64))[None, :, :]


class TestCurvature:
    def test_plane(self):
        # test_feature_extraction.cpp:27-53: flat wall -> curvature 0
        pcd = np.array([[i, 1.0, 0.0] for i in range(-5, 6)])
        lidar = LidarParams(1, 11, 0.1, 10.0)
        curv = np.asarray(compute_curvature(scan_from_points(pcd), lidar, REF_TEST_PARAMS))[0]
        assert curv.shape == (11,)
        for i in range(5):
            assert curv[i] == -1
            assert curv[10 - i] == -1
        assert abs(curv[5]) < 1e-9

    def test_corner(self):
        # test_feature_extraction.cpp:55-84: corner -> curvature 900
        pcd = np.array([[i, abs(i) + 1.0, 0.0] for i in range(-5, 6)])
        lidar = LidarParams(1, 11, 0.1, 50.0)
        curv = np.asarray(compute_curvature(scan_from_points(pcd), lidar, REF_TEST_PARAMS))[0]
        for i in range(5):
            assert curv[i] == -1
            assert curv[10 - i] == -1
        assert abs(curv[5] - 900.0) < 1e-9


class TestValidPoints:
    def test_invalid_edges(self):
        # test_feature_extraction.cpp:96-122
        pcd = np.array([[i * 0.1, 1.0, 0.0] for i in range(-5, 6)])
        lidar = LidarParams(1, 11, 0.1, 50.0)
        m = np.asarray(compute_valid_points(scan_from_points(pcd), lidar, REF_TEST_PARAMS))[0]
        for i in range(5):
            assert not m[i]
            assert not m[10 - i]
        assert m[5]

    def test_invalid_ranges(self):
        # test_feature_extraction.cpp:124-155
        pcd = [[i, 1.0, 0.0] for i in range(-5, 0)]
        pcd.append([-0.5, 20.0, 0.0])  # too far
        pcd.append([0.0, 0.2, 0.0])  # too close
        pcd += [[i, 1.0, 0.0] for i in range(1, 6)]
        lidar = LidarParams(1, 12, 0.5, 6.0)
        m = np.asarray(compute_valid_points(scan_from_points(pcd), lidar, REF_TEST_PARAMS))[0]
        for i in range(5):
            assert not m[i]
            assert not m[10 - i]
        assert not m[5]
        assert not m[6]

    def test_occlusion_case1(self):
        # test_feature_extraction.cpp:157-190
        pcd = [[i * 0.1, 4.0, 0.0] for i in range(-15, 0)]
        pcd += [[i * 0.1, 6.0, 0.0] for i in range(0, 15)]
        lidar = LidarParams(1, 30, 0.1, 100.0)
        m = np.asarray(compute_valid_points(scan_from_points(pcd), lidar, REF_TEST_PARAMS))[0]
        for i in range(5):
            assert not m[i]
            assert not m[29 - i]
        for i in range(5, 15):
            assert m[i]
        for i in range(15, 20):
            assert not m[i]
        for i in range(20, 25):
            assert m[i]

    def test_occlusion_case2(self):
        # test_feature_extraction.cpp:192-225
        pcd = [[i * 0.1, 6.0, 0.0] for i in range(-15, 0)]
        pcd += [[i * 0.1, 4.0, 0.0] for i in range(0, 15)]
        lidar = LidarParams(1, 30, 0.1, 100.0)
        m = np.asarray(compute_valid_points(scan_from_points(pcd), lidar, REF_TEST_PARAMS))[0]
        for i in range(5):
            assert not m[i]
            assert not m[29 - i]
        for i in range(5, 10):
            assert m[i]
        for i in range(10, 15):
            assert not m[i]
        for i in range(15, 25):
            assert m[i]

    @pytest.mark.parametrize("case", [1, 2])
    def test_parallel_plane(self, case):
        # test_feature_extraction.cpp:227-299
        near, far = (2.0, 2.1) if case == 1 else (2.1, 2.0)
        pcd = [[i * 0.1, near, 0.0] for i in range(-15, 0)]
        pcd.append([0.0, 0.0, 2.05])
        pcd += [[i * 0.1, far, 0.0] for i in range(1, 16)]
        lidar = LidarParams(1, 31, 0.1, 100.0)
        m = np.asarray(compute_valid_points(scan_from_points(pcd), lidar, REF_TEST_PARAMS))[0]
        for i in range(5):
            assert not m[i]
            assert not m[30 - i]
        for i in range(5, 15):
            assert m[i]
        for i in range(16, 26):
            assert m[i]
        assert not m[15]


class TestOracleParity:
    """The vectorized kernels must match the scalar oracle exactly."""

    @pytest.mark.parametrize("seed", [0, 1, 2])
    @pytest.mark.parametrize(
        "params",
        [
            FeatureExtractionParams(),
            FeatureExtractionParams(neighbor_points=5, number_sectors=4,
                                    max_edge_feats_per_sector=3,
                                    max_planar_feats_per_sector=7,
                                    edge_feat_threshold=50.0,
                                    planar_feat_threshold=2.0,
                                    occlusion_thresh=0.3,
                                    parallel_thresh=0.5),
        ],
        ids=["default", "alt"],
    )
    def test_full_extraction_matches_oracle(self, seed, params):
        lidar = LidarParams(8, 96, 0.5, 60.0)  # 96 % 6 != 0 exercises remainder sector? 96/6=16 exact; use 100
        lidar = LidarParams(8, 100, 0.5, 60.0)  # 100/6 = 16 rem 4 -> last sector bigger
        scan = render_scan(lidar, noise=0.01, seed=seed)

        curv_j = np.asarray(compute_curvature(jnp.asarray(scan), lidar, params)).reshape(-1)
        curv_o = oracle.compute_curvature(scan, lidar, params)
        np.testing.assert_allclose(curv_j, curv_o, rtol=1e-12, atol=1e-12)

        mask_j = np.asarray(compute_valid_points(jnp.asarray(scan), lidar, params)).reshape(-1)
        mask_o = oracle.compute_valid_points(scan, lidar, params)
        np.testing.assert_array_equal(mask_j, mask_o)

        feats = extract_features(jnp.asarray(scan), lidar, params)
        e_idx, p_idx = feats.compact_indices()
        e_o, p_o = oracle.extract_features(scan, lidar, params)
        np.testing.assert_array_equal(e_idx, np.asarray(e_o))
        np.testing.assert_array_equal(p_idx, np.asarray(p_o))

    def test_extraction_matches_oracle_big_noiseless(self):
        # Noiseless scene -> curvature ties galore: exercises the canonical
        # tie-break in the greedy/NMS logic. Curvature values themselves
        # differ from NumPy at the ~1e-12 level (XLA FMA contraction), so the
        # oracle is fed the kernel's own curvature/mask to isolate the pick
        # logic under exact ties.
        lidar = LidarParams(4, 128, 0.5, 60.0)
        params = FeatureExtractionParams()
        scan = render_scan(lidar, noise=0.0)
        curv_j = np.asarray(compute_curvature(jnp.asarray(scan), lidar, params))
        mask_j = np.asarray(compute_valid_points(jnp.asarray(scan), lidar, params))
        feats = extract_features_given(
            jnp.asarray(scan), jnp.asarray(curv_j), jnp.asarray(mask_j), lidar, params
        )
        e_idx, p_idx = feats.compact_indices()
        e_o, p_o = oracle.extract_features(scan, lidar, params, curv=curv_j, mask=mask_j)
        np.testing.assert_array_equal(e_idx, np.asarray(e_o))
        np.testing.assert_array_equal(p_idx, np.asarray(p_o))

    def test_feature_points_match_indices(self):
        lidar = LidarParams(4, 64, 0.5, 60.0)
        scan = render_scan(lidar, noise=0.01, seed=3)
        feats = extract_features(jnp.asarray(scan), lidar, FeatureExtractionParams())
        e_pts, p_pts = feats.compact()
        e_idx, p_idx = feats.compact_indices()
        flat = scan.reshape(-1, 3)
        np.testing.assert_array_equal(e_pts, flat[e_idx])
        np.testing.assert_array_equal(p_pts, flat[p_idx])

    def test_f32_selection_bit_faithful_to_f64(self):
        # the compensated (double-float) selection path must make the f32
        # pipeline's feature choice EXACTLY equal to f64 math on the same
        # f32-valued points — no tolerance (north-star bit-faithfulness)
        lidar = LidarParams(8, 128, 0.5, 60.0)
        scan32 = np.asarray(render_scan(lidar, noise=0.01, seed=7), np.float32)
        f64 = extract_features(
            jnp.asarray(scan32, dtype=jnp.float64), lidar, FeatureExtractionParams()
        )
        f32 = extract_features(
            jnp.asarray(scan32, dtype=jnp.float32), lidar, FeatureExtractionParams()
        )
        e64, p64 = f64.compact_indices()
        e32, p32 = f32.compact_indices()
        np.testing.assert_array_equal(e32, e64)
        np.testing.assert_array_equal(p32, p64)

    def test_f32_full_scale_oracle_parity(self):
        # Ouster-64 scale (64 x 1024), default params, noisy scan: the f32
        # pipeline's selected features must equal the f64 NumPy oracle's
        # EXACTLY, index for index, in output order (SURVEY §7 "hard parts";
        # reference behavior being matched: features-inl.h:137-180)
        lidar = LidarParams(64, 1024, 0.5, 120.0)
        params = FeatureExtractionParams()
        scan32 = np.asarray(
            render_scan(lidar, noise=0.01, seed=7, dtype=np.float32), np.float32
        )
        fs = extract_features(jnp.asarray(scan32), lidar, params)
        got_e = [int(i) for i in np.asarray(fs.edge_indices) if i >= 0]
        got_p = [int(i) for i in np.asarray(fs.planar_indices) if i >= 0]
        oe, op = oracle.extract_features(
            np.asarray(scan32, np.float64), lidar, params
        )
        assert got_e == list(oe)
        assert got_p == list(op)
        assert len(got_p) > 10000  # the scan must actually be feature-rich
