"""kNN search tests: brute-force and grid backends vs the NumPy oracle.

The oracle replicates the reference's ``kdtree_internal::knnSearch``
(``/root/reference/loam/src/kdtree.cpp:10-28``): exact k nearest, post-hoc
strict radius filter.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from loam_jax.neighbors import build_grid, knn, knn_grid, knn_oracle


def _random_sets(seed, m=257, q=101, pad=40):
    rng = np.random.default_rng(seed)
    targets = rng.uniform(-5, 5, size=(m + pad, 3))
    mask = np.ones(m + pad, dtype=bool)
    mask[m:] = False
    targets[~mask] = 1e6  # junk in padded slots
    queries = rng.uniform(-6, 6, size=(q, 3))
    return queries, targets, mask


def _as_sets(idx, mask):
    return [set(np.asarray(i)[np.asarray(v)].tolist()) for i, v in zip(idx, mask)]


@pytest.mark.parametrize("max_dist", [0.0, 1.0, 2.5])
@pytest.mark.parametrize("k", [1, 5])
def test_bruteforce_matches_oracle(k, max_dist):
    queries, targets, mask = _random_sets(0)
    res = knn(jnp.asarray(queries), jnp.asarray(targets), jnp.asarray(mask), k, max_dist)
    oi, od, om = knn_oracle(queries, targets, mask, k, max_dist)
    # neighbor *sets* must match exactly (ordering ties are irrelevant
    # downstream: fits are symmetric in the neighbors)
    assert _as_sets(res.indices, res.mask) == _as_sets(oi, om)
    # distances of valid entries match, ascending
    d = np.asarray(res.distances)
    valid = np.asarray(res.mask)
    np.testing.assert_allclose(np.sort(d[valid]), np.sort(od[om]), atol=1e-9)
    for row_d, row_m in zip(d, valid):
        rd = row_d[row_m]
        assert np.all(np.diff(rd) >= -1e-12)


def test_bruteforce_tiled_equals_untiled():
    queries, targets, mask = _random_sets(1, m=300, q=700)
    a = knn(jnp.asarray(queries), jnp.asarray(targets), jnp.asarray(mask), 5, 1.5, tile=4096)
    b = knn(jnp.asarray(queries), jnp.asarray(targets), jnp.asarray(mask), 5, 1.5, tile=128)
    assert _as_sets(a.indices, a.mask) == _as_sets(b.indices, b.mask)


def test_fewer_targets_than_k():
    # quirk §2.3(7): with < k valid targets the result holds fewer entries
    targets = np.array([[0.0, 0, 0], [1, 0, 0], [50, 0, 0]])
    mask = np.array([True, True, False])
    res = knn(jnp.asarray([[0.1, 0, 0]]), jnp.asarray(targets), jnp.asarray(mask), 5, 0.0)
    assert int(res.mask.sum()) == 2
    assert set(np.asarray(res.indices)[0, :2].tolist()) == {0, 1}


def test_radius_filter_strict():
    targets = np.array([[1.0, 0, 0], [2.0, 0, 0]])
    mask = np.ones(2, dtype=bool)
    res = knn(jnp.asarray([[0.0, 0, 0]]), jnp.asarray(targets), jnp.asarray(mask), 2, 1.0)
    # strict <: the point at exactly dist 1.0 is dropped (kdtree.cpp:24-26)
    assert int(res.mask.sum()) == 0


@pytest.mark.parametrize("max_dist", [0.8, 2.0])
def test_grid_matches_oracle(max_dist):
    queries, targets, mask = _random_sets(2, m=400, q=150)
    idx = build_grid(jnp.asarray(targets), jnp.asarray(mask), max_dist)
    res, overflow = knn_grid(idx, jnp.asarray(queries), 5, max_dist, max_per_cell=512)
    assert int(overflow) == 0
    oi, od, om = knn_oracle(queries, targets, mask, 5, max_dist)
    assert _as_sets(res.indices, res.mask) == _as_sets(oi, om)


def test_grid_overflow_reported():
    # 100 points in one cell with a tiny cap -> overflow counter fires
    rng = np.random.default_rng(3)
    targets = rng.uniform(0, 0.1, size=(100, 3))
    mask = np.ones(100, dtype=bool)
    idx = build_grid(jnp.asarray(targets), jnp.asarray(mask), 1.0)
    _, overflow = knn_grid(idx, jnp.asarray(targets[:5]), 5, 1.0, max_per_cell=8)
    assert int(overflow) > 0
