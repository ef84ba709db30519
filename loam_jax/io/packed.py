"""Packed 4-byte/point scan transport.

The native loader (``native/loam_io.cpp::loam_project_packed``) can
quantize each projected range-image cell to

  ==========  ====================================================
  plane 0     ``r_lo``  low byte of ``round(r / r_max * 65535)``
  plane 1     ``r_hi``  high byte (r_max = 131.07 m -> 2 mm steps)
  plane 2     ``az8``   azimuth offset within the 2*pi/P cell, 8 bits
  plane 3     ``el8``   elevation offset within the row cell, 8 bits
  ==========  ====================================================

i.e. a (4, L, P) uint8 array per frame — 3x fewer upload bytes than xyz
f32, with quantization error BELOW LiDAR sensor noise: <=1 mm range,
<=1.2e-5 rad azimuth and <=1.7e-5 rad elevation (<2 mm tangential at the
120 m max range; typical sensors spec +-2-3 cm). Empty cells are all-zero
and decode to (0,0,0), exactly the float path's invalid-cell sentinel.

``decode_packed`` is pure elementwise jnp — XLA fuses it into the
extraction program, so decoding is free on device.
"""

from __future__ import annotations

import numpy as np

# Default range full-scale: 131.07 m / 65535 = exactly 2 mm per step, and
# comfortably above any supported sensor's max range (Ouster: 120 m).
PACKED_R_MAX = 131.07

TWO_PI = 6.283185307179586


def decode_packed(packed, elev_lo: float = -0.30, elev_hi: float = 0.25,
                  r_max: float = PACKED_R_MAX):
    """Decode (..., 4, L, P) uint8 packed planes -> (..., L, P, 3) f32 xyz.

    Inverse of ``native/loam_io.cpp::loam_project_packed`` (dequantizing to
    interval centers). jit/vmap-friendly; works on numpy or jax arrays.
    """
    import jax.numpy as jnp

    packed = jnp.asarray(packed)
    L, P = packed.shape[-2], packed.shape[-1]
    r_lo = packed[..., 0, :, :].astype(jnp.float32)
    r_hi = packed[..., 1, :, :].astype(jnp.float32)
    az8 = packed[..., 2, :, :].astype(jnp.float32)
    el8 = packed[..., 3, :, :].astype(jnp.float32)
    rq = r_lo + 256.0 * r_hi
    r = rq * (r_max / 65535.0)
    col = jnp.arange(P, dtype=jnp.float32)
    row = jnp.arange(L, dtype=jnp.float32)[:, None]
    az = (col + (az8 + 0.5) * (1.0 / 256.0)) * (TWO_PI / P)
    cell_h = (elev_hi - elev_lo) / (L - 1)
    elev = elev_lo + row * cell_h + ((el8 + 0.5) * (1.0 / 256.0) - 0.5) * cell_h
    valid = rq > 0
    rxy = r * jnp.cos(elev)
    x = jnp.where(valid, rxy * jnp.cos(az), 0.0)
    y = jnp.where(valid, rxy * jnp.sin(az), 0.0)
    z = jnp.where(valid, r * jnp.sin(elev), 0.0)
    return jnp.stack([x, y, z], axis=-1)



def project_packed_numpy(points: np.ndarray, scan_lines: int,
                         points_per_line: int, elev_lo: float = -0.30,
                         elev_hi: float = 0.25,
                         r_max: float = PACKED_R_MAX) -> np.ndarray:
    """NumPy mirror of the native packed projection (fallback + test oracle).

    (N, 3) unordered cloud -> (4, L, P) uint8; nearest return per cell.
    """
    pts = np.ascontiguousarray(np.asarray(points)[:, :3], np.float32)
    L, P = scan_lines, points_per_line
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    r2 = x * x + y * y + z * z
    keep = r2 > 1e-12
    elev = np.arctan2(z, np.hypot(x, y))
    az = np.arctan2(y, x)
    az = np.where(az < 0, az + TWO_PI, az)
    row = np.rint((elev - elev_lo) / (elev_hi - elev_lo) * (L - 1)).astype(int)
    col = np.minimum((az / TWO_PI * P).astype(int), P - 1)
    keep &= (row >= 0) & (row < L)
    out = np.zeros((4, L, P), np.uint8)
    if not keep.any():
        return out
    cell = (row * P + col)[keep]
    r = np.sqrt(r2[keep])
    az_k, elev_k, row_k, col_k = az[keep], elev[keep], row[keep], col[keep]
    # nearest-return-wins: write descending-range order, nearest last (same
    # tie behavior as the float fallback in native.py)
    order = np.argsort(r, kind="stable")[::-1]
    cell, r = cell[order], r[order]
    az_k, elev_k = az_k[order], elev_k[order]
    row_k, col_k = row_k[order], col_k[order]
    rq = np.clip(np.rint(r / r_max * 65535.0).astype(np.int64), 1, 65535)
    aq = np.clip(((az_k - col_k * (TWO_PI / P)) * P / TWO_PI * 256.0)
                 .astype(np.int64), 0, 255)
    cell_h = (elev_hi - elev_lo) / (L - 1)
    eq = np.clip((((elev_k - (elev_lo + row_k * cell_h)) / cell_h + 0.5)
                  * 256.0).astype(np.int64), 0, 255)
    flat = out.reshape(4, -1)
    flat[0, cell] = (rq & 0xFF).astype(np.uint8)
    flat[1, cell] = (rq >> 8).astype(np.uint8)
    flat[2, cell] = aq.astype(np.uint8)
    flat[3, cell] = eq.astype(np.uint8)
    return out


def encode_packed_grid(scan: np.ndarray, elev_lo: float = -0.30,
                       elev_hi: float = 0.25,
                       r_max: float = PACKED_R_MAX) -> np.ndarray:
    """Encode an already-projected (L, P, 3) grid to (4, L, P) packed planes.

    For feeding in-memory grids (synthetic scans, tests) through the packed
    wire path; files go through the native loader's packed projection
    instead. Each non-empty cell is re-derived from its xyz — NOT from its
    grid position — so decode error stays within the codec's quantization
    bounds even if a point's true angles disagree with its cell (the
    projection already guarantees they agree to within a cell).
    """
    grid = np.asarray(scan, np.float32)
    L, P, _ = grid.shape
    pts = grid.reshape(-1, 3)
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    r = np.sqrt(x * x + y * y + z * z)
    valid = r > 1e-6
    elev = np.arctan2(z, np.hypot(x, y))
    az = np.arctan2(y, x)
    az = np.where(az < 0, az + TWO_PI, az)
    row = np.repeat(np.arange(L), P)
    col = np.tile(np.arange(P), L)
    out = np.zeros((4, L, P), np.uint8)
    flat = out.reshape(4, -1)
    rq = np.clip(np.rint(r / r_max * 65535.0).astype(np.int64), 1, 65535)
    aq = np.clip(((az - col * (TWO_PI / P)) * P / TWO_PI * 256.0)
                 .astype(np.int64), 0, 255)
    cell_h = (elev_hi - elev_lo) / (L - 1)
    eq = np.clip((((elev - (elev_lo + row * cell_h)) / cell_h + 0.5) * 256.0)
                 .astype(np.int64), 0, 255)
    idx = np.nonzero(valid)[0]
    flat[0, idx] = (rq[idx] & 0xFF).astype(np.uint8)
    flat[1, idx] = (rq[idx] >> 8).astype(np.uint8)
    flat[2, idx] = aq[idx].astype(np.uint8)
    flat[3, idx] = eq[idx].astype(np.uint8)
    return out
