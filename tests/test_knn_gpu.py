"""The fused GPU kNN kernel (``ops/knn_gpu.py``) and its dispatch.

On the CPU the kernel body runs in the Pallas interpreter
(``interpret=True``) against the NumPy oracle and the plain-XLA reference;
the ``gpu``-marked tests compile it for the card and skip elsewhere.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from loam_jax.neighbors import bruteforce
from loam_jax.neighbors.bruteforce import _knn_xla, knn, knn_oracle
from loam_jax.ops import knn_gpu
from loam_jax.ops.knn_gpu import knn_triton


def _case(name, seed=0):
    """(queries, targets, target_mask) for one named scenario."""
    rng = np.random.default_rng(seed)
    if name == "ties":
        # a lattice: many queries sit exactly between equidistant targets,
        # so first-index tie-breaking decides (exact in f32: small integers)
        g = np.arange(6, dtype=np.float32)
        t = np.stack(np.meshgrid(g, g, [0.0], indexing="ij"), -1).reshape(-1, 3)
        q = t[:, :] + np.float32(0.5) * np.array([1, 0, 0], np.float32)
        return q.astype(np.float32), t.astype(np.float32), np.ones(len(t), bool)
    Q, M = {"basic": (64, 200), "q_not_block_multiple": (37, 150),
            "m_lt_k": (20, 3), "all_masked": (16, 40), "empty": (16, 0)}[name]
    q = rng.uniform(-3, 3, (Q, 3)).astype(np.float32)
    t = rng.uniform(-3, 3, (M, 3)).astype(np.float32)
    m = rng.uniform(size=M) > 0.3
    if name == "all_masked":
        m[:] = False
    return q, t, m


def _run(fn, q, t, m, k, r):
    res = fn(jnp.asarray(q), jnp.asarray(t), jnp.asarray(m), k, r)
    return tuple(np.asarray(x) for x in res)


CASES = ["basic", "q_not_block_multiple", "m_lt_k", "all_masked", "empty",
         "ties"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("radius", [0.0, 1.2])
@pytest.mark.parametrize("k", [1, 5])
def test_interpret_matches_oracle_and_xla(case, radius, k):
    q, t, m = _case(case)
    got_i, got_d, got_m = _run(
        lambda *a: knn_triton(*a, block_q=16, block_t=32, interpret=True),
        q, t, m, k, radius,
    )
    xla_i, xla_d, xla_m = _run(_knn_xla, q, t, m, k, radius)
    or_i, or_d, or_m = knn_oracle(q, t, m, k, radius)
    assert got_i.shape == got_d.shape == got_m.shape == (len(q), k)
    # masks and distances agree bitwise with the XLA reference (same f32
    # direct-difference arithmetic on the CPU) ...
    np.testing.assert_array_equal(got_m, xla_m)
    np.testing.assert_array_equal(got_d, xla_d)
    # ... and so do the indices of every valid slot (masked slots are
    # unspecified), including first-index tie-breaking
    np.testing.assert_array_equal(np.where(got_m, got_i, -1),
                                  np.where(xla_m, xla_i, -1))
    # the f64 oracle agrees on which slots hold a neighbor and on distances
    np.testing.assert_array_equal(got_m, or_m)
    np.testing.assert_allclose(got_d[got_m], or_d[or_m], rtol=1e-6)
    if case == "ties":
        np.testing.assert_array_equal(np.where(got_m, got_i, -1),
                                      np.where(or_m, or_i, -1))


def test_interpret_under_vmap():
    """The ICF loop vmaps registration over pairs; the kernel batches."""
    cases = [_case("basic", s) for s in range(3)]
    q, t, m = (jnp.asarray(np.stack(x)) for x in zip(*cases))
    f = jax.vmap(lambda a, b, c: knn_triton(a, b, c, 5, 1.5, block_q=16,
                                            block_t=32, interpret=True))
    got = f(q, t, m)
    for b in range(3):
        want = _knn_xla(q[b], t[b], m[b], 5, 1.5)
        np.testing.assert_array_equal(np.asarray(got.mask[b]),
                                      np.asarray(want.mask))
        np.testing.assert_array_equal(
            np.where(got.mask[b], got.indices[b], -1),
            np.where(want.mask, want.indices, -1),
        )


def test_entry_bound_admits_every_passing_distance():
    """A slot passes the radius filter iff sqrt(d2) < r in f32; the entry
    bound must exceed every such d2 (else the kernel would drop it)."""
    for r in (0.1, 1.0, 1.5, 2.0, 37.3):
        bound = knn_gpu._entry_bound(r, jnp.float32)
        r32 = np.float32(r)
        d = np.nextafter(r32, np.float32(0))  # largest f32 distance < r
        for d2 in (np.float32(d) * np.float32(d),
                   np.nextafter(np.float32(d) * np.float32(d), np.float32(np.inf))):
            if np.sqrt(d2, dtype=np.float32) < r32:
                assert d2 < bound
    assert knn_gpu._entry_bound(0.0, jnp.float32) == float("inf")


def _spy(monkeypatch, backend):
    calls = []
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    monkeypatch.setattr(
        knn_gpu, "knn_triton",
        lambda *a, **kw: calls.append(("triton", kw)) or _knn_xla(*a[:5]),
    )
    real_xla = bruteforce._knn_xla
    monkeypatch.setattr(
        bruteforce, "_knn_xla",
        lambda *a, **kw: calls.append(("xla", kw)) or real_xla(*a, **kw),
    )
    return calls


@pytest.mark.parametrize("backend,want", [("gpu", "triton"), ("cpu", "xla")])
def test_dispatch_by_platform(monkeypatch, backend, want):
    """gpu -> the compiled kernel (never interpret mode unasked); any other
    platform -> the plain XLA path."""
    calls = _spy(monkeypatch, backend)
    q, t, m = _case("basic")
    assert bruteforce.knn_backend() == want
    knn(jnp.asarray(q), jnp.asarray(t), jnp.asarray(m), 5, 1.5)
    assert [c[0] for c in calls] == [want]
    if want == "triton":
        assert not calls[0][1].get("interpret", False)


def test_wrapper_pads_and_slices():
    """Queries and targets are padded up to block multiples inside the
    wrapper; padded targets never appear and outputs have the caller's Q."""
    q, t, m = _case("q_not_block_multiple")
    m[:] = True
    res = knn_triton(jnp.asarray(q), jnp.asarray(t), jnp.asarray(m), 5, 0.0,
                     block_q=16, block_t=64, interpret=True)
    assert res.indices.shape == (37, 5)
    assert bool(res.mask.all())  # 150 valid targets, no radius
    assert int(res.indices.max()) < 150


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with JAX_PLATFORMS=cuda,cpu)")


@pytest.mark.gpu
@pytest.mark.parametrize("k,radius", [(5, 2.0), (5, 0.0), (1, 1.0)])
def test_compiled_kernel_matches_xla(gpu, k, radius):
    rng = np.random.default_rng(4)
    q = jnp.asarray(rng.uniform(-20, 20, (4224, 3)).astype(np.float32))
    t = jnp.asarray(rng.uniform(-20, 20, (4224, 3)).astype(np.float32))
    m = jnp.asarray(rng.uniform(size=4224) > 0.4)
    got = knn(q, t, m, k, radius)
    want = _knn_xla(q, t, m, k, radius)
    np.testing.assert_array_equal(np.asarray(got.mask), np.asarray(want.mask))
    np.testing.assert_allclose(
        np.asarray(got.distances)[np.asarray(got.mask)],
        np.asarray(want.distances)[np.asarray(want.mask)], rtol=1e-5,
    )


def _lowering_case(kind):
    q, t, m = (jnp.asarray(x) for x in _case("basic"))
    if kind == "plain":
        return (lambda q, t, m: knn_triton(q, t, m, 5, 1.5)), (q, t, m)
    if kind == "vmap":
        f = jax.vmap(lambda q, t, m: knn_triton(q, t, m, 5, 1.5))
        return f, tuple(jnp.stack([x, x]) for x in (q, t, m))
    from loam_jax.parallel.distributed import sharded_knn

    mesh = jax.sharding.Mesh(np.asarray(jax.devices()), ("data",))
    t8 = jnp.concatenate([t, t[:56]])  # 256 targets: divides 8 devices
    m8 = jnp.concatenate([m, m[:56]])
    return (lambda q, t, m: sharded_knn(q, t, m, 5, 1.5, mesh)), (q, t8, m8)


@pytest.mark.parametrize("kind", ["plain", "vmap", "shard_map"])
def test_kernel_lowers_for_cuda(monkeypatch, kind):
    """The Triton lowering runs in Python, so what the GPU route refuses to
    lower (an unsupported primitive, outputs without a shard_map type)
    shows here without a card."""
    monkeypatch.setattr(bruteforce, "knn_backend", lambda: "triton")
    fn, args = _lowering_case(kind)
    text = jax.jit(fn).trace(*args).lower(
        lowering_platforms=("cuda",)).as_text()
    assert "stablehlo.custom_call" in text
