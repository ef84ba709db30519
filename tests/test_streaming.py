"""Streaming file-fed odometry + packed scan transport.

Covers the two layers of the streaming dataset path:

  1. the 4-byte/point wire codec (``io/packed.py`` + the native packed
     projection): roundtrip error bounds, native/NumPy agreement;
  2. ``odometry_streaming``: parity with ``odometry_offline`` (same math,
     chunk-carried boundary features + motion prior), array and file
     sources, packed and raw transports, chunk-tail padding.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from loam_jax import LidarParams, odometry_offline, odometry_streaming
from loam_jax.evaluation import ate_rmse
from loam_jax.io import (
    PACKED_R_MAX,
    ScanLoader,
    decode_packed,
    encode_packed_grid,
    project_packed_numpy,
    render_trajectory,
)

LIDAR = LidarParams(16, 256, 0.5, 120.0)
N_FRAMES = 10


@pytest.fixture(scope="module")
def traj_data():
    scans, poses = render_trajectory(
        LIDAR, N_FRAMES, step=np.array([0.08, 0.02, 0.0]), yaw_rate=0.01,
        noise=0.005, seed=0, dtype=np.float32,
    )
    gt = np.stack([t for (_, t) in poses])
    return scans, gt


@pytest.fixture(scope="module")
def dataset(traj_data, tmp_path_factory):
    scans, gt = traj_data
    root = tmp_path_factory.mktemp("stream_seq")
    paths = []
    for i, scan in enumerate(scans):
        pts = scan.reshape(-1, 3).astype(np.float32)
        rec = np.concatenate(
            [pts, np.zeros((len(pts), 1), np.float32)], axis=1
        )
        p = str(root / f"{i:06d}.bin")
        rec.tofile(p)
        paths.append(p)
    return paths, gt


@pytest.fixture(scope="module")
def offline_traj(traj_data):
    scans, _ = traj_data
    traj, det = odometry_offline(
        jnp.asarray(scans), LIDAR, chunk_pairs=4, motion_init=True
    )
    return traj, det


# ---------------------------------------------------------------------------
# codec
# ---------------------------------------------------------------------------

def test_packed_roundtrip_error_bounds(traj_data):
    """Grid encode -> decode reconstructs every in-range point to within the
    codec's documented quantization bounds (mm-level, below sensor noise)."""
    scans, _ = traj_data
    scan = scans[0]
    pk = encode_packed_grid(scan)
    assert pk.shape == (4, LIDAR.scan_lines, LIDAR.points_per_line)
    dec = np.asarray(decode_packed(pk))
    r = np.linalg.norm(scan, axis=-1)
    valid = (r > 1e-6) & (r < LIDAR.max_range)
    err = np.linalg.norm(dec - scan, axis=-1)[valid]
    # range quantum 2 mm (+-1 mm) + angular quanta ~2 mm at 120 m
    assert err.max() < 0.01, err.max()
    assert err.mean() < 0.003


def test_packed_far_points_stay_out_of_range():
    """No-return points (beyond max_range, e.g. the renderer's 2*max_range
    sentinel) must still decode out of range — the uint16 clamp to r_max
    (131.07 m) must never pull them inside the 120 m validity gate."""
    L, P = 4, 16
    scan = np.zeros((L, P, 3), np.float32)
    elev = np.linspace(-0.30, 0.25, L)
    for row, rr in ((0, 240.0), (1, 125.0), (2, 130.9), (3, 50.0)):
        az = (3 + 0.5) / P * 2 * np.pi
        scan[row, 3] = [
            rr * np.cos(elev[row]) * np.cos(az),
            rr * np.cos(elev[row]) * np.sin(az),
            rr * np.sin(elev[row]),
        ]
    dec = np.asarray(decode_packed(encode_packed_grid(scan)))
    dec_r = np.linalg.norm(dec, axis=-1)
    assert (dec_r[0, 3] > 120.0) and (dec_r[1, 3] > 120.0)
    assert dec_r[2, 3] > 120.0
    assert abs(dec_r[3, 3] - 50.0) < 0.005


def test_packed_empty_cells_decode_to_zero():
    pk = np.zeros((4, 4, 8), np.uint8)
    dec = np.asarray(decode_packed(pk))
    assert (dec == 0).all()


def test_native_packed_projection_geometry(dataset, traj_data):
    """Native packed projection's decoded cloud lies within codec bounds of
    the source cloud. (Byte-exact native==NumPy equality is NOT required:
    the synthetic renderer puts every point exactly on a cell's azimuth
    edge, so f32-vs-f64 atan2 epsilon legitimately flips column
    assignment; geometry is what must agree.)"""
    paths, _ = dataset
    scans, _ = traj_data
    loader = ScanLoader(
        paths[:1], LIDAR.scan_lines, LIDAR.points_per_line, packed=True
    )
    pk = next(iter(loader))
    loader.close()
    assert pk.dtype == np.uint8
    dec = np.asarray(decode_packed(pk))
    dec_r = np.linalg.norm(dec, axis=-1)
    valid = (dec_r > 1e-6) & (dec_r < LIDAR.max_range)
    src = scans[0].reshape(-1, 3)
    src = src[np.linalg.norm(src, axis=-1) < LIDAR.max_range]
    # every decoded in-range point must be within codec quantization of
    # SOME source point (cell assignment may differ; geometry may not)
    pts = dec[valid]
    d2 = ((pts[:, None, :] - src[None, :, :]) ** 2).sum(-1)
    nn = np.sqrt(d2.min(axis=1))
    assert nn.max() < 0.01, nn.max()


def test_native_packed_matches_numpy_on_generic_cloud():
    """Off the renderer's pathological cell-edge grid (a random cloud), the
    native and NumPy packed projections agree almost everywhere, and every
    disagreement is an epsilon cell-boundary flip (adjacent cell), not a
    value error."""
    from loam_jax.io import native

    if not native.native_available():
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(1)
    az = rng.uniform(0, 2 * np.pi, 4000)
    elev = rng.uniform(-0.28, 0.23, 4000)
    r = rng.uniform(1.0, 60.0, 4000)
    cloud = np.stack(
        [r * np.cos(elev) * np.cos(az), r * np.cos(elev) * np.sin(az),
         r * np.sin(elev)], axis=-1
    ).astype(np.float32)
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        p = os.path.join(td, "c.bin")
        np.concatenate(
            [cloud, np.zeros((len(cloud), 1), np.float32)], axis=1
        ).tofile(p)
        loader = ScanLoader([p], 16, 256, packed=True)
        a = next(iter(loader))
        loader.close()
    b = project_packed_numpy(cloud, 16, 256)
    frac_diff = (a != b).mean()
    assert frac_diff < 0.02, frac_diff


# ---------------------------------------------------------------------------
# streaming driver
# ---------------------------------------------------------------------------

def test_streaming_matches_offline_unpacked(traj_data, offline_traj):
    """Raw (unpacked) streaming from an in-memory array computes the same
    math as odometry_offline(motion_init=True) — identical scans, same
    lockstep registration; only the chunk-boundary alignment of the motion
    prior differs, so poses agree to solver-convergence tolerance."""
    scans, _ = traj_data
    traj_off, _ = offline_traj
    traj_s, det = odometry_streaming(
        scans, LIDAR, chunk_frames=4, packed=False
    )
    assert np.asarray(traj_s.translation).shape == (N_FRAMES, 3)
    np.testing.assert_allclose(
        np.asarray(traj_s.translation), np.asarray(traj_off.translation),
        atol=2e-3,
    )
    np.testing.assert_allclose(
        np.asarray(traj_s.rotation), np.asarray(traj_off.rotation), atol=1e-3
    )
    # details: one per consecutive pair, like offline
    assert jax.tree_util.tree_leaves(det)[0].shape[0] == N_FRAMES - 1


def test_streaming_first_frame_is_identity(traj_data):
    scans, _ = traj_data
    traj, _ = odometry_streaming(scans[:5], LIDAR, chunk_frames=4,
                                 packed=False)
    np.testing.assert_allclose(np.asarray(traj.translation)[0], 0.0)
    np.testing.assert_allclose(  # identity quaternion (w,x,y,z)
        np.asarray(traj.rotation)[0], [1.0, 0.0, 0.0, 0.0], atol=1e-7
    )


def test_streaming_packed_array_source(traj_data, offline_traj):
    """Packed transport from an array source: mm-level quantization shifts
    poses by at most a few mm over 10 frames."""
    scans, _ = traj_data
    traj_off, _ = offline_traj
    traj_p, _ = odometry_streaming(scans, LIDAR, chunk_frames=4, packed=True)
    d = np.abs(
        np.asarray(traj_p.translation) - np.asarray(traj_off.translation)
    ).max()
    assert d < 0.05, d


def test_streaming_files_packed_ate(dataset):
    """Full file path: native loader packs in worker threads, chunks
    stream through device_put + jitted steps. The packed transport must
    not degrade accuracy vs the raw-float file path.

    (Both file paths carry the projection roundtrip's intrinsic loss: the
    renderer puts points exactly on cell azimuth edges, so re-projection
    drops ~16% of points to cell collisions at this 16x256 test scale —
    measured ATE ~0.19 float vs ~0.15 packed over 10 frames. The bench's
    5%-of-path gate at 64-frame Ouster-64 scale is the e2e arbiter.)"""
    paths, gt = dataset
    traj, det = odometry_streaming(paths, LIDAR, chunk_frames=4, packed=True)
    est = np.asarray(traj.translation)
    assert est.shape == (N_FRAMES, 3)
    assert np.isfinite(est).all()
    traj_f, _ = odometry_streaming(paths, LIDAR, chunk_frames=4,
                                   packed=False)
    ate_p = ate_rmse(est, gt, align=False)
    ate_f = ate_rmse(np.asarray(traj_f.translation), gt, align=False)
    assert ate_p < 1.3 * ate_f + 0.02, (ate_p, ate_f)


def test_streaming_chunk_tail_padding(traj_data):
    """Frame counts not divisible by chunk_frames: the padded tail must be
    sliced away and not affect earlier poses."""
    scans, _ = traj_data
    traj7, _ = odometry_streaming(scans[:7], LIDAR, chunk_frames=4,
                                  packed=False)
    traj8, _ = odometry_streaming(scans[:8], LIDAR, chunk_frames=4,
                                  packed=False)
    assert np.asarray(traj7.translation).shape == (7, 3)
    np.testing.assert_allclose(
        np.asarray(traj7.translation), np.asarray(traj8.translation)[:7],
        atol=1e-6,
    )


def test_streaming_empty_source_raises():
    with pytest.raises(ValueError):
        odometry_streaming([], LIDAR)
    with pytest.raises(ValueError):
        odometry_streaming(iter([]), LIDAR)


def test_packed_codec_custom_fov():
    """The codec parameters (elev_lo/elev_hi) must be honored end-to-end:
    encode/decode with a non-default vertical FOV reconstructs within the
    same bounds (round-5 review fix: the FOV is now a parameter of
    odometry_streaming, not a hidden constant)."""
    lo, hi = -0.45, 0.10
    L, P = 12, 128
    elev = np.linspace(lo, hi, L)
    az = (np.arange(P) + 0.25) / P * 2 * np.pi
    r = 8.0 + np.random.default_rng(3).random((L, P)) * 20.0
    scan = np.stack(
        [r * np.cos(elev)[:, None] * np.cos(az)[None, :],
         r * np.cos(elev)[:, None] * np.sin(az)[None, :],
         r * np.sin(elev)[:, None] * np.ones((1, P))], axis=-1
    ).astype(np.float32)
    pk = encode_packed_grid(scan, lo, hi)
    dec = np.asarray(decode_packed(pk, lo, hi))
    err = np.linalg.norm(dec - scan, axis=-1)
    assert err.max() < 0.01, err.max()
    # decoding with the WRONG fov is meters off — the failure mode the
    # parameter exists to prevent
    wrong = np.asarray(decode_packed(pk))
    assert np.linalg.norm(wrong - scan, axis=-1).max() > 0.5


def test_streaming_push_api_matches_batch(traj_data):
    """StreamingOdometry (live push API) must produce the same poses as
    odometry_streaming over the same frames, with frames handed out in
    order and exactly once."""
    from loam_jax.odometry import StreamingOdometry

    scans, _ = traj_data
    ref, _ = odometry_streaming(scans, LIDAR, chunk_frames=4, packed=True)
    odo = StreamingOdometry(LIDAR, chunk_frames=4, packed=True)
    got = []
    for s in scans:
        got.extend(odo.push(s))
    got.extend(odo.finish())
    assert odo.frames_pushed == N_FRAMES
    assert [i for i, _ in got] == list(range(N_FRAMES))
    est = np.stack([np.asarray(p.translation) for _, p in got])
    np.testing.assert_allclose(
        est, np.asarray(ref.translation), atol=1e-6
    )
    with pytest.raises(RuntimeError):
        odo.push(scans[0])


def test_streaming_dewarp_runs(traj_data):
    """dewarp=True motion-compensates each chunk with the carried
    constant-velocity delta (scan_to_scan_step parity at the driver
    level): must run end-to-end and stay close to the non-dewarped
    trajectory on these quasi-static synthetic frames (each frame is
    rendered static, so dewarping with the ~8 cm inter-frame delta only
    perturbs mildly)."""
    scans, gt = traj_data
    traj_d, _ = odometry_streaming(
        scans, LIDAR, chunk_frames=4, packed=False, dewarp=True
    )
    traj_p, _ = odometry_streaming(
        scans, LIDAR, chunk_frames=4, packed=False
    )
    est_d = np.asarray(traj_d.translation)
    assert np.isfinite(est_d).all()
    d = np.abs(est_d - np.asarray(traj_p.translation)).max()
    assert d < 0.2, d


def test_packed_codec_fuzz_roundtrip():
    """Property fuzz: random in-range clouds projected+packed by the NumPy
    mirror decode to within codec bounds of their sources, across random
    geometries and FOVs."""
    rng = np.random.default_rng(123)
    for _ in range(6):
        L = int(rng.integers(4, 24))
        P = int(rng.choice([64, 128, 256]))
        lo = float(rng.uniform(-0.5, -0.1))
        hi = float(rng.uniform(0.05, 0.4))
        n = int(rng.integers(200, 2000))
        az = rng.uniform(0, 2 * np.pi, n)
        el = rng.uniform(lo + 1e-3, hi - 1e-3, n)
        r = rng.uniform(1.0, 100.0, n)
        cloud = np.stack(
            [r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az),
             r * np.sin(el)], axis=-1
        ).astype(np.float32)
        pk = project_packed_numpy(cloud, L, P, lo, hi)
        dec = np.asarray(decode_packed(pk, lo, hi))
        dr = np.linalg.norm(dec, axis=-1)
        valid = dr > 1e-6
        pts = dec[valid]
        if not len(pts):
            continue
        # nearest-source distance (cells keep the nearest return; others
        # are dropped, so compare point-to-cloud, not cell-to-cell)
        d2 = ((pts[:, None, :] - cloud[None, :, :]) ** 2).sum(-1)
        nn = np.sqrt(d2.min(axis=1))
        # bound: range quantum + az/elev cell-offset quanta at max range
        cell_h = (hi - lo) / (L - 1)
        bound = 1e-3 + 100.0 * (2 * np.pi / P / 256 + cell_h / 256) + 5e-3
        assert nn.max() < bound, (L, P, lo, hi, nn.max(), bound)
