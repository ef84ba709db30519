"""Numerical-health checks (loam_jax/debug.py).

The accelerator analogue of the reference's "no races possible" sanitizer story:
NaN/Inf poisoning of masked reductions must be detectable on demand, both
host-side and inside jitted loops (SURVEY §5 race-detection row).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from loam_jax.debug import check_finite, debug_nans_enabled, tap_finite


def test_check_finite_clean():
    check_finite({"a": jnp.ones((3,)), "b": np.zeros((2, 2))})


def test_check_finite_names_offending_leaves():
    tree = {
        "good": jnp.ones((4,)),
        "bad": jnp.asarray([1.0, jnp.nan, jnp.inf]),
        "ints": jnp.arange(3),  # non-float leaves are ignored
    }
    with pytest.raises(FloatingPointError) as e:
        check_finite(tree, where="unit")
    msg = str(e.value)
    assert "[unit]" in msg
    assert "bad" in msg and "2 non-finite of 3" in msg
    assert "good" not in msg


def test_tap_finite_noop_by_default(monkeypatch):
    monkeypatch.delenv("LOAM_DEBUG_NANS", raising=False)
    assert not debug_nans_enabled()

    @jax.jit
    def f(x):
        tap_finite({"x": x}, where="noop")
        return x * 2

    # poisoned input passes silently: the check was staged out
    out = f(jnp.asarray([jnp.nan, 1.0]))
    assert bool(jnp.isnan(out[0]))


def test_tap_finite_raises_inside_jit():
    @jax.jit
    def f(x):
        tap_finite({"x": x}, where="jit", force=True)
        return x * 2

    jax.block_until_ready(f(jnp.ones((3,))))  # clean: no raise
    with pytest.raises(Exception, match="non-finite"):
        jax.block_until_ready(f(jnp.asarray([1.0, jnp.nan, 3.0])))


def test_tap_finite_inside_scan():
    def body(carry, x):
        tap_finite({"carry": carry}, where="scan", force=True)
        return carry + x, ()

    @jax.jit
    def run(xs):
        return jax.lax.scan(body, jnp.asarray(0.0), xs)[0]

    assert float(run(jnp.ones((4,)))) == 4.0
    with pytest.raises(Exception, match="non-finite"):
        jax.block_until_ready(run(jnp.asarray([1.0, jnp.inf, 1.0, 1.0])))


def test_registration_guards_scrub_poisoned_point(monkeypatch):
    """A NaN source point is rejected by the association guards (kNN
    distance NaN -> mask off -> slot invalid), so the estimate stays finite
    and the staged tap stays quiet — the poisoning the tap exists for is
    state corruption, covered below."""
    monkeypatch.setenv("LOAM_DEBUG_NANS", "1")
    from loam_jax import (
        RegistrationParams, feature_set_from_points, register_features
    )

    rng = np.random.default_rng(0)
    tgt_e = rng.normal(size=(37, 3)).astype(np.float32)
    tgt_p = rng.normal(size=(157, 3)).astype(np.float32)
    src_p = tgt_p.copy()
    src_p[0, 0] = np.nan  # masked-in poisoned point
    src = feature_set_from_points(tgt_e.copy(), src_p)
    tgt = feature_set_from_points(tgt_e, tgt_p)
    params = RegistrationParams(min_associations=5)
    pose, detail = register_features(src, tgt, None, params)
    check_finite({"pose": pose}, where="scrubbed")


def test_registration_tap_fires_on_poisoned_state(monkeypatch):
    """LOAM_DEBUG_NANS=1 stages the ICF-loop check in; a non-finite initial
    pose (upstream state corruption) must be reported, not silently
    propagated. The flag is read at trace time; distinct capacities here
    force a fresh trace."""
    monkeypatch.setenv("LOAM_DEBUG_NANS", "1")
    from loam_jax import (
        Pose3, RegistrationParams, feature_set_from_points, register_features
    )

    rng = np.random.default_rng(1)
    tgt_e = rng.normal(size=(41, 3)).astype(np.float32)
    tgt_p = rng.normal(size=(163, 3)).astype(np.float32)
    src = feature_set_from_points(tgt_e.copy(), tgt_p.copy())
    tgt = feature_set_from_points(tgt_e, tgt_p)
    params = RegistrationParams(min_associations=5)
    bad_init = Pose3(
        jnp.asarray([1.0, 0.0, 0.0, 0.0], jnp.float32),
        jnp.asarray([jnp.nan, 0.0, 0.0], jnp.float32),
    )
    with pytest.raises(Exception, match="non-finite"):
        pose, detail = register_features(src, tgt, bad_init, params)
        jax.block_until_ready(pose.translation)
