"""Native IO runtime tests: readers, projection, prefetching loader.

Runs against the compiled C++ library when the toolchain is present (it is
in CI/dev images) and exercises the NumPy fallbacks explicitly.
"""

import os

import numpy as np
import pytest

from loam_jax.io import native


@pytest.fixture(scope="module")
def cloud():
    rng = np.random.default_rng(0)
    az = rng.uniform(0, 2 * np.pi, 5000)
    elev = rng.uniform(-0.25, 0.2, 5000)
    r = rng.uniform(1.0, 30.0, 5000)
    return np.stack(
        [r * np.cos(elev) * np.cos(az), r * np.cos(elev) * np.sin(az),
         r * np.sin(elev)],
        axis=-1,
    ).astype(np.float32)


def test_native_builds():
    assert native.native_available(), "C++ toolchain present but build failed"


def test_kitti_bin_roundtrip(tmp_path, cloud):
    raw = np.concatenate([cloud, np.zeros((len(cloud), 1), np.float32)], axis=1)
    p = tmp_path / "scan.bin"
    raw.tofile(p)
    pts = native.read_kitti_bin(str(p))
    np.testing.assert_allclose(pts, cloud, rtol=1e-6)


def _write_pcd_ascii(path, pts):
    with open(path, "w") as f:
        f.write("VERSION .7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n")
        f.write(f"WIDTH {len(pts)}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n")
        f.write(f"POINTS {len(pts)}\nDATA ascii\n")
        for x, y, z in pts:
            f.write(f"{x} {y} {z}\n")


def _write_pcd_binary(path, pts):
    with open(path, "wb") as f:
        hdr = (
            "VERSION .7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
            f"WIDTH {len(pts)}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
            f"POINTS {len(pts)}\nDATA binary\n"
        )
        f.write(hdr.encode())
        f.write(np.asarray(pts, np.float32).tobytes())


@pytest.mark.parametrize("writer", [_write_pcd_ascii, _write_pcd_binary])
def test_pcd_roundtrip(tmp_path, cloud, writer):
    p = tmp_path / "scan.pcd"
    writer(str(p), cloud[:500])
    pts = native.read_pcd(str(p))
    np.testing.assert_allclose(pts, cloud[:500], rtol=1e-5, atol=1e-5)


def test_pcd_numpy_fallback_matches_native(tmp_path, cloud):
    p = tmp_path / "scan.pcd"
    _write_pcd_binary(str(p), cloud[:300])
    a = native.read_pcd(str(p))
    b = native._read_pcd_numpy(str(p), 1 << 20)
    np.testing.assert_allclose(a, b)


def test_projection_native_matches_numpy(cloud):
    if not native.native_available():
        pytest.skip("no native lib")
    a = native.project_range_image(cloud, 16, 256)
    lib = native._lib
    try:
        native._lib = None
        native._build_failed = True
        b = native.project_range_image(cloud, 16, 256)
    finally:
        native._lib = lib
        native._build_failed = False
    np.testing.assert_allclose(a, b, atol=1e-6)
    # occupied cells carry actual points from the cloud
    occ = np.linalg.norm(a.reshape(-1, 3), axis=1) > 0
    assert occ.sum() > 1000


def test_scan_loader_streams_in_order(tmp_path, cloud):
    paths = []
    for i in range(6):
        raw = np.concatenate(
            [cloud + i, np.zeros((len(cloud), 1), np.float32)], axis=1
        )
        p = tmp_path / f"{i:06d}.bin"
        raw.astype(np.float32).tofile(p)
        paths.append(str(p))
    loader = native.ScanLoader(paths, 16, 256, n_threads=3, queue_cap=2)
    frames = list(loader)
    loader.close()
    assert len(frames) == 6
    for i, fr in enumerate(frames):
        assert fr.shape == (16, 256, 3)
        ref = native.project_range_image((cloud + i).astype(np.float32), 16, 256)
        np.testing.assert_allclose(fr, ref, atol=1e-6)


def test_write_pcd_roundtrip(tmp_path, cloud):
    p = str(tmp_path / "out.pcd")
    native.write_pcd(p, cloud[:200])
    back = native.read_pcd(p)
    np.testing.assert_allclose(back, cloud[:200], rtol=1e-6)


def test_write_pcd_fallback_matches(tmp_path, cloud):
    p1, p2 = str(tmp_path / "a.pcd"), str(tmp_path / "b.pcd")
    native.write_pcd(p1, cloud[:100])
    lib = native._lib
    try:
        native._lib = None
        native._build_failed = True
        native.write_pcd(p2, cloud[:100])
    finally:
        native._lib = lib
        native._build_failed = False
    assert open(p1, "rb").read() == open(p2, "rb").read()


@pytest.mark.parametrize("content", [
    b"",                                        # empty file
    b"not a pcd at all\n",                      # garbage, no header
    b"FIELDS x y z\nSIZE 4 4 4\nTYPE F F F\n",  # truncated header, no DATA
    (b"VERSION .7\nFIELDS a b\nSIZE 4 4\nTYPE F F\nCOUNT 1 1\nWIDTH 2\n"
     b"HEIGHT 1\nPOINTS 2\nDATA binary\n" + b"\x00" * 16),  # no x/y/z
])
def test_read_pcd_malformed_inputs_raise(tmp_path, content):
    """Malformed PCD inputs must raise IOError from the native reader (and
    its NumPy fallback), never crash or return garbage points."""
    p = tmp_path / "bad.pcd"
    p.write_bytes(content)
    with pytest.raises(Exception) as ei:
        native.read_pcd(str(p))
    assert isinstance(ei.value, (IOError, ValueError))


def test_read_pcd_truncated_binary_body(tmp_path):
    """A binary PCD whose body is shorter than POINTS declares returns only
    the records actually present."""
    hdr = (b"VERSION .7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\n"
           b"COUNT 1 1 1\nWIDTH 10\nHEIGHT 1\nPOINTS 10\nDATA binary\n")
    body = np.arange(9, dtype=np.float32).tobytes()  # 3 full records
    p = tmp_path / "trunc.pcd"
    p.write_bytes(hdr + body)
    pts = native.read_pcd(str(p))
    assert pts.shape == (3, 3)
    np.testing.assert_array_equal(pts.ravel(), np.arange(9, dtype=np.float32))
