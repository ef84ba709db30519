"""Association-layer oracle tests.

Replicates the reference's association control flow in NumPy
(``registration.cpp:23-62`` / ``65-103``: kNN -> count guard -> fit ->
fit-quality guard -> record (src, nearest) pair) and checks the batched
implementation produces identical validity masks and matches on random
scenes, including sparse targets that trigger the count guards.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from loam_jax.neighbors import knn_oracle
from loam_jax.params import RegistrationParams
from loam_jax.registration.associate import associate_edges, associate_planes


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(4)
    # clustered targets: some queries get full neighborhoods, some sparse
    centers = rng.uniform(-6, 6, (30, 3))
    tgt = (centers[rng.integers(0, 30, 400)] + rng.normal(0, 0.3, (400, 3))).astype(
        np.float64
    )
    mask = np.ones(400, bool)
    mask[rng.random(400) < 0.15] = False
    q = (centers[rng.integers(0, 30, 120)] + rng.normal(0, 0.5, (120, 3))).astype(
        np.float64
    )
    qmask = np.ones(120, bool)
    qmask[-10:] = False
    return q, qmask, tgt, mask


def test_edge_association_guards_match_oracle(scene):
    q, qmask, tgt, mask = scene
    params = RegistrationParams()
    ea = associate_edges(
        jnp.asarray(q), jnp.asarray(qmask), jnp.asarray(tgt), jnp.asarray(mask),
        params,
    )
    oi, od, om = knn_oracle(
        q, tgt, mask, params.num_edge_neighbors, params.max_edge_neighbor_dist
    )
    for s in range(len(q)):
        n = int(om[s].sum())
        # reference guard: continue if fewer than min_line_fit_points
        # (condition number guard is dead code -> never rejects)
        expect_valid = qmask[s] and n >= params.min_line_fit_points
        assert bool(ea.valid[s]) == expect_valid, s
        if expect_valid:
            assert int(ea.match[s]) == oi[s][om[s]][0]
        else:
            assert int(ea.match[s]) == -1


def test_plane_association_guards_match_oracle(scene):
    q, qmask, tgt, mask = scene
    params = RegistrationParams()
    pa = associate_planes(
        jnp.asarray(q), jnp.asarray(qmask), jnp.asarray(tgt), jnp.asarray(mask),
        params,
    )
    oi, od, om = knn_oracle(
        q, tgt, mask, params.num_plane_neighbors, params.max_plane_neighbor_dist
    )
    n_checked = 0
    for s in range(len(q)):
        n = int(om[s].sum())
        expect_enough = qmask[s] and n >= params.min_plane_fit_points
        # signed-mean guard is exactly 0 for the PCA fit -> never rejects;
        # only degenerate (non-finite) fits may additionally drop out
        if not expect_enough:
            assert not bool(pa.valid[s]), s
            assert int(pa.match[s]) == -1
        elif bool(pa.valid[s]):
            assert int(pa.match[s]) == oi[s][om[s]][0]
            n_checked += 1
    assert n_checked > 30  # plenty of accepted associations exercised


def test_plane_fit_geometry(scene):
    """Accepted plane fits must satisfy n.p ~ d for their neighborhoods."""
    q, qmask, tgt, mask = scene
    params = RegistrationParams()
    pa = associate_planes(
        jnp.asarray(q), jnp.asarray(qmask), jnp.asarray(tgt), jnp.asarray(mask),
        params,
    )
    oi, od, om = knn_oracle(
        q, tgt, mask, params.num_plane_neighbors, params.max_plane_neighbor_dist
    )
    for s in range(len(q)):
        if not bool(pa.valid[s]):
            continue
        nbrs = tgt[oi[s][om[s]]]
        n = np.asarray(pa.normal[s])
        d = float(pa.d[s])
        resid = nbrs @ n - d
        # PCA fit: signed mean residual is ~0 by construction
        assert abs(resid.mean()) < 1e-9
        assert np.linalg.norm(n) == pytest.approx(1.0, abs=1e-6)
