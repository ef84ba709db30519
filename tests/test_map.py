"""Voxel map tests: downsampling, stability, eviction, overflow reporting."""

import numpy as np

import jax.numpy as jnp

from loam_jax import voxel_map_empty, voxel_map_insert


def test_insert_downsamples_to_one_per_voxel():
    m = voxel_map_empty(64, voxel_size=1.0, dtype=jnp.float64)
    # 10 points in the same voxel + 2 in distinct voxels
    pts = np.concatenate(
        [np.full((10, 3), 0.25) + np.random.default_rng(0).uniform(0, 0.4, (10, 3)) * 0,
         np.array([[5.2, 0.0, 0.0], [0.0, 5.2, 0.0]])]
    )
    m2, dropped = voxel_map_insert(m, jnp.asarray(pts), jnp.ones(len(pts), bool))
    assert int(m2.size) == 3
    assert int(dropped) == 0


def test_existing_points_win_their_voxel():
    m = voxel_map_empty(16, voxel_size=1.0, dtype=jnp.float64)
    first = jnp.asarray([[0.3, 0.3, 0.3]])
    m, _ = voxel_map_insert(m, first, jnp.ones(1, bool))
    # a different point in the same voxel must NOT replace the stored one
    m, _ = voxel_map_insert(m, jnp.asarray([[0.7, 0.7, 0.7]]), jnp.ones(1, bool))
    stored = np.asarray(m.points)[np.asarray(m.mask)]
    assert stored.shape == (1, 3)
    np.testing.assert_allclose(stored[0], [0.3, 0.3, 0.3])


def test_eviction_by_radius():
    m = voxel_map_empty(16, voxel_size=1.0, dtype=jnp.float64)
    pts = jnp.asarray([[0.0, 0.0, 0.0], [60.0, 0.0, 0.0]])
    m, _ = voxel_map_insert(
        m, pts, jnp.ones(2, bool), center=jnp.zeros(3), keep_radius=50.0
    )
    assert int(m.size) == 1


def test_overflow_reported():
    m = voxel_map_empty(4, voxel_size=0.5, dtype=jnp.float64)
    pts = jnp.asarray(np.arange(30).reshape(10, 3) * 1.0)  # 10 distinct voxels
    m, dropped = voxel_map_insert(m, pts, jnp.ones(10, bool))
    assert int(m.size) == 4
    assert int(dropped) == 6


def test_mask_respected():
    m = voxel_map_empty(8, voxel_size=1.0, dtype=jnp.float64)
    pts = jnp.asarray([[0.0, 0.0, 0.0], [3.0, 3.0, 3.0]])
    mask = jnp.asarray([True, False])
    m, _ = voxel_map_insert(m, pts, mask)
    assert int(m.size) == 1


def test_insert_impl_exact_equality():
    """The scatter-free two-sort insert produces the identical map to the
    one-sort + compaction-scatter form."""
    rng = np.random.default_rng(12)
    m_a = voxel_map_empty(512, 0.4)
    m_c = voxel_map_empty(512, 0.4)
    for i in range(3):
        pts = jnp.asarray(rng.uniform(-20, 20, (300, 3)).astype(np.float32))
        mask = jnp.asarray(rng.uniform(size=300) > 0.2)
        center = jnp.asarray([float(i), 0.0, 0.0], jnp.float32)
        m_a, d_a = voxel_map_insert(m_a, pts, mask, center, 25.0, impl="scatter")
        m_c, d_c = voxel_map_insert(m_c, pts, mask, center, 25.0, impl="sort2")
        assert int(d_a) == int(d_c)
        np.testing.assert_array_equal(np.asarray(m_a.mask), np.asarray(m_c.mask))
        np.testing.assert_array_equal(
            np.asarray(m_a.points), np.asarray(m_c.points)
        )


def test_insert_impl_overflow_equality():
    rng = np.random.default_rng(13)
    pts = jnp.asarray(rng.uniform(-30, 30, (2000, 3)).astype(np.float32))
    mask = jnp.ones((2000,), bool)
    m_a, d_a = voxel_map_insert(voxel_map_empty(64, 0.3), pts, mask, impl="scatter")
    m_c, d_c = voxel_map_insert(voxel_map_empty(64, 0.3), pts, mask, impl="sort2")
    assert int(d_a) == int(d_c) and int(d_a) > 0
    np.testing.assert_array_equal(np.asarray(m_a.mask), np.asarray(m_c.mask))
    np.testing.assert_array_equal(np.asarray(m_a.points), np.asarray(m_c.points))
