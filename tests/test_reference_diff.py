"""Differential test against the REFERENCE's own compiled extraction code.

Builds ``tests/ref_bridge/ref_extract.cpp`` (which #includes the reference's
headers and ``src/features.cpp`` directly from the reference checkout against
a minimal Eigen shim) and asserts that on random scans the reference's
``extractFeatures`` picks exactly the same feature indices as

  1. the NumPy oracle (``loam_jax/oracle/oracle.py``) — validating that the
     oracle is a faithful transcription of ``features-inl.h:11-180`` +
     ``features.cpp:18-70``, not a shared misreading, and
  2. the JAX pipeline (f32 scan, compensated double-float selection) — the
     bit-faithfulness claim end to end.

The reference is fed the same f32-rounded coordinates (cast to f64) the
pipeline sees, so all three compute selection decisions from identical
point values. Comparison is per class as index SETS with count equality:
the reference's ``std::sort`` is unstable, so the visit order of
equal-curvature candidates is implementation-defined (SURVEY "sorting
ties"); with noisy scans no pickable candidates tie, and the always-tied
-1 sentinels are mask-invalid no-ops either way.
"""

import ctypes
import os
import subprocess

import numpy as np
import pytest

import jax.numpy as jnp

from loam_jax import LidarParams, extract_features
from loam_jax.params import FeatureExtractionParams
from loam_jax.io import render_scan
from loam_jax.oracle import oracle

_REF = "/root/reference"
_BRIDGE = os.path.join(os.path.dirname(__file__), "ref_bridge")

pytestmark = pytest.mark.skipif(
    not os.path.isdir(os.path.join(_REF, "loam", "include")),
    reason="reference checkout not available",
)


def _build_bridge(tmp_path_factory) -> str:
    out = str(tmp_path_factory.getbasetemp() / "libref_extract.so")
    cmd = [
        os.environ.get("CXX", "c++"), "-O2", "-std=c++17", "-shared", "-fPIC",
        "-I", os.path.join(_BRIDGE, "eigen_shim"),
        "-I", os.path.join(_REF, "loam", "include"),
        os.path.join(_BRIDGE, "ref_extract.cpp"),
        os.path.join(_REF, "loam", "src", "features.cpp"),
        "-o", out,
    ]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    return out


@pytest.fixture(scope="module")
def ref_lib(tmp_path_factory):
    try:
        path = _build_bridge(tmp_path_factory)
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        pytest.skip(f"cannot build reference bridge: {e}")
    lib = ctypes.CDLL(path)
    lib.ref_extract_features.restype = ctypes.c_int
    return lib


def _ref_extract(lib, scan: np.ndarray, lidar: LidarParams,
                 params: FeatureExtractionParams):
    pts = np.ascontiguousarray(scan.reshape(-1, 3), dtype=np.float64)
    n = pts.shape[0]
    cap = n
    e_idx = np.full(cap, -1, np.int64)
    p_idx = np.full(cap, -1, np.int64)
    ne = ctypes.c_int64(0)
    np_ = ctypes.c_int64(0)
    rc = lib.ref_extract_features(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_int64(n),
        ctypes.c_int64(lidar.scan_lines), ctypes.c_int64(lidar.points_per_line),
        ctypes.c_double(lidar.min_range), ctypes.c_double(lidar.max_range),
        ctypes.c_int64(params.neighbor_points),
        ctypes.c_int64(params.number_sectors),
        ctypes.c_int64(params.max_edge_feats_per_sector),
        ctypes.c_int64(params.max_planar_feats_per_sector),
        ctypes.c_double(params.edge_feat_threshold),
        ctypes.c_double(params.planar_feat_threshold),
        ctypes.c_double(params.occlusion_thresh),
        ctypes.c_double(params.parallel_thresh),
        e_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(cap), ctypes.byref(ne),
        p_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(cap), ctypes.byref(np_),
    )
    assert rc == 0, f"reference extraction failed rc={rc}"
    return e_idx[: ne.value], p_idx[: np_.value]


def _pipeline_indices(fs):
    e = np.asarray(fs.edge_indices)[np.asarray(fs.edge_mask)]
    p = np.asarray(fs.planar_indices)[np.asarray(fs.planar_mask)]
    return e, p


_CASES = [
    (LidarParams(8, 256, 0.5, 80.0), FeatureExtractionParams(), 6),
    # remainder sector + tighter caps + different suppression width
    (
        LidarParams(4, 100, 0.5, 80.0),
        FeatureExtractionParams(
            number_sectors=3, neighbor_points=2,
            max_edge_feats_per_sector=4, max_planar_feats_per_sector=9,
            edge_feat_threshold=5.0, planar_feat_threshold=0.5,
        ),
        4,
    ),
]


@pytest.mark.parametrize("lidar,params,n_seeds", _CASES)
def test_reference_matches_oracle_and_pipeline(ref_lib, lidar, params, n_seeds):
    for seed in range(n_seeds):
        # f32-rounded coordinates: the identical values the JAX pipeline
        # sees, handed to the reference as f64 (its native precision)
        scan32 = render_scan(lidar, noise=0.02, seed=seed, dtype=np.float32)
        scan64 = scan32.astype(np.float64)

        ref_e, ref_p = _ref_extract(ref_lib, scan64, lidar, params)
        orc_e, orc_p = oracle.extract_features(scan64, lidar, params)
        fs = extract_features(jnp.asarray(scan32), lidar, params)
        jax_e, jax_p = _pipeline_indices(fs)

        for tag, a, b in (
            ("oracle edges", ref_e, np.asarray(orc_e)),
            ("oracle planars", ref_p, np.asarray(orc_p)),
            ("pipeline edges", ref_e, jax_e),
            ("pipeline planars", ref_p, jax_p),
        ):
            assert len(a) == len(b), (
                f"seed {seed}: reference vs {tag} count {len(a)} != {len(b)}"
            )
            np.testing.assert_array_equal(
                np.sort(np.asarray(a)), np.sort(np.asarray(b).astype(np.int64)),
                err_msg=f"seed {seed}: reference vs {tag}",
            )


def test_reference_matches_on_full_ouster_geometry(ref_lib):
    lidar = LidarParams(64, 1024, 0.5, 120.0)
    params = FeatureExtractionParams()
    scan32 = render_scan(lidar, noise=0.02, seed=123, dtype=np.float32)
    ref_e, ref_p = _ref_extract(ref_lib, scan32.astype(np.float64), lidar, params)
    fs = extract_features(jnp.asarray(scan32), lidar, params)
    jax_e, jax_p = _pipeline_indices(fs)
    assert len(ref_e) == len(jax_e) and len(ref_p) == len(jax_p)
    np.testing.assert_array_equal(np.sort(ref_e), np.sort(jax_e.astype(np.int64)))
    np.testing.assert_array_equal(np.sort(ref_p), np.sort(jax_p.astype(np.int64)))
