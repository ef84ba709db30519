"""Morton (Z-order) keys for the voxel map's storage order.

A contiguous run of Morton-ordered cells is a compact 3-D blob, so sorting
map points by Morton key keeps every contiguous block of map slots
spatially compact (an x-major raster key gives thin full-extent slabs).

Keys are 30-bit (10 bits per axis, 1024 cells per axis), int32-safe.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# cells per axis (2^10; 3 x 10 bits = 30-bit keys fit int32)
GRID_CELLS = 1024


def _part1by2(x: jax.Array) -> jax.Array:
    """Spread the low 10 bits of ``x`` to every 3rd bit (Morton interleave)."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_key_cells(cx: jax.Array, cy: jax.Array, cz: jax.Array) -> jax.Array:
    """Interleave three 10-bit cell coordinates into a 30-bit Morton key."""
    return (
        (_part1by2(cx) << 2) | (_part1by2(cy) << 1) | _part1by2(cz)
    ).astype(jnp.int32)


def morton_key(
    points: jax.Array,
    cell_size,
    origin=None,
) -> jax.Array:
    """Morton key of each point (..., 3) on a ``cell_size`` grid.

    The grid is centered on ``origin`` (defaults to 0) and spans
    ``GRID_CELLS * cell_size``; out-of-span coordinates clamp to the border
    cell (keys stay valid, locality degrades only at the border).
    """
    if origin is not None:
        points = points - origin
    half_span = 0.5 * GRID_CELLS * cell_size
    c = jnp.floor((points + half_span) / cell_size).astype(jnp.int32)
    c = jnp.clip(c, 0, GRID_CELLS - 1)
    return morton_key_cells(c[..., 0], c[..., 1], c[..., 2])
