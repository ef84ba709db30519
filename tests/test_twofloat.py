"""Double-float (compensated f32) primitive tests.

The EFT invariants must hold BITWISE both eagerly and under jit — XLA's
instruction selection (FMA contraction after optimization-barrier expansion)
is exactly what ``twofloat._pin`` defends against, so every property is
checked through ``jax.jit`` as well.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from loam_jax.ops import twofloat as tf


@pytest.fixture(scope="module")
def vals():
    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.uniform(-120, 120, 50000).astype(np.float32))
    b = jnp.asarray(rng.uniform(-120, 120, 50000).astype(np.float32))
    return a, b


def _f64(x):
    return np.asarray(x, np.float64)


def test_two_sum_exact(vals):
    a, b = vals
    for f in (tf.two_sum, jax.jit(tf.two_sum)):
        s, e = f(a, b)
        np.testing.assert_array_equal(_f64(s) + _f64(e), _f64(a) + _f64(b))


def test_two_prod_exact(vals):
    a, b = vals
    for f in (tf.two_prod, jax.jit(tf.two_prod)):
        p, e = f(a, b)
        np.testing.assert_array_equal(_f64(p) + _f64(e), _f64(a) * _f64(b))


def test_jit_matches_eager_bitwise(vals):
    # the composition that exposed FMA contraction on XLA:CPU
    a, b = vals

    def comp(a, b):
        s = tf.DF(*tf.two_sum(a, b))
        t = tf.DF(*tf.two_prod(a, jnp.float32(-6.0)))
        d = tf.df_add(t, s)
        return tf.df_sqrt(tf.df_sq(d))

    e_ = comp(a, b)
    j_ = jax.jit(comp)(a, b)
    np.testing.assert_array_equal(np.asarray(e_.hi), np.asarray(j_.hi))
    np.testing.assert_array_equal(np.asarray(e_.lo), np.asarray(j_.lo))


def test_df_chain_accuracy_vs_f64(vals):
    a, b = vals

    def chain(a, b):
        d = tf.df_add(tf.DF(*tf.two_prod(a, jnp.float32(-6.0))),
                      tf.DF(*tf.two_sum(a, b)))
        return tf.df_sq(d)

    c = jax.jit(chain)(a, b)
    truth = (_f64(a) * -6.0 + (_f64(a) + _f64(b))) ** 2
    got = _f64(c.hi) + _f64(c.lo)
    denom = np.maximum(np.abs(truth), 1e-30)
    assert (np.abs(got - truth) / denom).max() < 1e-13


def test_df_sqrt_accuracy(vals):
    a, b = vals
    r2 = tf.df_add(tf.DF(*tf.two_prod(a, a)), tf.DF(*tf.two_prod(b, b)))
    r = jax.jit(tf.df_sqrt)(r2)
    truth = np.sqrt(_f64(a) ** 2 + _f64(b) ** 2)
    got = _f64(r.hi) + _f64(r.lo)
    assert (np.abs(got - truth) / truth).max() < 1e-13
    # zero-safe
    z = tf.df_sqrt(tf.df_from(jnp.zeros(4, jnp.float32)))
    np.testing.assert_array_equal(np.asarray(z.hi), 0.0)


def test_df_comparisons():
    # lexicographic (hi, lo) comparison == value comparison for normalized dfs
    x = tf.DF(jnp.float32(1.0), jnp.float32(-1e-11))
    y = tf.DF(jnp.float32(1.0), jnp.float32(1e-11))
    assert bool(tf.df_lt(x, y)) and bool(tf.df_gt(y, x))
    t = tf.df_from_scalar(0.1)  # not exactly f32-representable
    assert abs(float(_f64(t.hi) + _f64(t.lo)) - 0.1) < 1e-16
