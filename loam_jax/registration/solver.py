"""On-device Levenberg–Marquardt for the 6-DoF delta pose.

Replaces the reference's per-iteration Ceres solve (autodiff jets + DENSE_QR,
``registration-inl.h:51-56``) with analytic-Jacobian normal equations: each
residual contributes a 1x6 Jacobian; the Huber-weighted (IRLS) 6x6 ``J^T W J``
and ``J^T W r`` are accumulated with one einsum each (reduction over all
residuals at once — pure VPU/MXU work), and the damped system is solved in
closed form. Matches the reference's solver configuration: 4 inner LM
iterations (``registration-inl.h:53``), Huber delta = 1.0
(``registration.cpp:56,97``), delta-pose parameterization acting on
pre-transformed points with left-composition (SURVEY §2.3(8)).

Parameterization: the inner step is a small twist ``s = (theta, dt)`` applied
on the left of the current delta: ``delta' = (Exp(theta), dt) o delta`` so a
transformed point moves by ``dq = theta x q + dt`` — giving the simple
Jacobian ``J = [q x grad_q_r, grad_q_r]``. (Ceres parameterizes the
quaternion manifold directly; the stationary point is the same, only the step
geometry differs, which the accept/reject damping absorbs.)
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.lax import Precision

from ..geometry import (
    Pose3,
    quat_exp,
    quat_log,
    quat_multiply,
    quat_normalize,
    quat_rotate,
)
from ..params import RegistrationParams
from .associate import EdgeAssociations, PlaneAssociations


def _edge_residual_grad(q: jax.Array, a: jax.Array, b: jax.Array):
    """Point-to-line residual + gradient wrt the (moved) point.

    r = |(q-a) x (q-b)| / |a-b|   (reference ``geometry-inl.h:21-27``)
    grad_q r = ((a-b) x c) / (|c| |a-b|),  c = (q-a) x (q-b)
    """
    c = jnp.cross(q - a, q - b)
    c_norm = jnp.linalg.norm(c, axis=-1)
    ab_norm = jnp.linalg.norm(a - b, axis=-1)
    r = c_norm / jnp.where(ab_norm > 0, ab_norm, 1.0)
    denom = jnp.where(c_norm > 1e-12, c_norm * ab_norm, 1.0)
    grad = jnp.cross(a - b, c) / denom[..., None]
    grad = jnp.where((c_norm > 1e-12)[..., None], grad, 0.0)
    return r, grad


def _plane_residual_grad(q: jax.Array, normal: jax.Array, d: jax.Array):
    """Point-to-plane residual |n.q - d| + gradient sign(n.q - d) n
    (reference ``geometry-inl.h:30-33``, ``registration-inl.h:106-117``)."""
    s = jnp.sum(q * normal, axis=-1) - d
    return jnp.abs(s), jnp.sign(s)[..., None] * normal


def _huber_rho(r: jax.Array, delta: float) -> jax.Array:
    """Huber loss on the residual magnitude (Ceres ``HuberLoss``)."""
    a = jnp.abs(r)
    return jnp.where(a <= delta, r * r, delta * (2.0 * a - delta))


def _huber_weight(r: jax.Array, delta: float) -> jax.Array:
    """IRLS weight rho'(r^2): 1 inside the delta, delta/|r| outside."""
    a = jnp.abs(r)
    return jnp.where(a <= delta, 1.0, delta / jnp.where(a > 0, a, 1.0))


class _Problem(NamedTuple):
    """Fixed associations for one outer ICF iteration (static shapes).

    ``prior_offset`` is ``est o init^-1`` — the accumulated deviation from
    the ICF initialization entering this iteration; the optional quadratic
    prior penalizes ``delta o prior_offset`` so unobservable directions stay
    at the INITIALIZATION across outer iterations (a per-iteration prior
    would let drift accumulate ~max_iterations times).
    """

    pts_edge: jax.Array  # (E, 3) pre-transformed source edge points
    edge: EdgeAssociations
    pts_plane: jax.Array  # (Q, 3)
    plane: PlaneAssociations
    prior_offset: Pose3 = None


def _residuals(problem: _Problem, delta: Pose3):
    """All residuals + gradients at the given delta. Returns
    (r (n,), grad_q (n,3), q (n,3), mask (n,))."""
    qe = delta.act(problem.pts_edge)
    re, ge = _edge_residual_grad(qe, problem.edge.line_a, problem.edge.line_b)
    qp = delta.act(problem.pts_plane)
    rp, gp = _plane_residual_grad(qp, problem.plane.normal, problem.plane.d)
    r = jnp.concatenate([re, rp])
    grad = jnp.concatenate([ge, gp])
    q = jnp.concatenate([qe, qp])
    mask = jnp.concatenate([problem.edge.valid, problem.plane.valid])
    return r, grad, q, mask


def _prior_xi(problem: _Problem, delta: Pose3) -> jax.Array:
    total = delta
    if problem.prior_offset is not None:
        total = delta.compose(problem.prior_offset)
    return jnp.concatenate([quat_log(total.rotation), total.translation])


def _cost(
    problem: _Problem, delta: Pose3, huber_delta: float, prior_weight: float = 0.0
) -> jax.Array:
    r, _, _, mask = _residuals(problem, delta)
    cost = jnp.sum(jnp.where(mask, _huber_rho(r, huber_delta), 0.0))
    if prior_weight > 0:
        xi = _prior_xi(problem, delta)
        cost = cost + prior_weight * jnp.sum(xi * xi)
    return cost


def _chol_solve6(H: jax.Array, g: jax.Array) -> jax.Array:
    """Solve the damped 6x6 SPD system with a fully unrolled Cholesky.

    ``jnp.linalg.solve`` takes a generic pivoted-LU path (gathers + control
    flow — slow for tiny batched systems); an unrolled Cholesky is
    ~100 fused elementwise ops. H must be SPD (guaranteed by the Marquardt
    damping with its relative floor).
    """
    n = 6
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        d = H[..., j, j]
        for kk in range(j):
            d = d - L[j][kk] * L[j][kk]
        Ljj = jnp.sqrt(jnp.maximum(d, 1e-30))
        L[j][j] = Ljj
        inv = 1.0 / Ljj
        for i in range(j + 1, n):
            v = H[..., i, j]
            for kk in range(j):
                v = v - L[i][kk] * L[j][kk]
            L[i][j] = v * inv
    # forward substitution L y = g
    y = [None] * n
    for i in range(n):
        v = g[..., i]
        for kk in range(i):
            v = v - L[i][kk] * y[kk]
        y[i] = v / L[i][i]
    # back substitution L^T x = y
    x = [None] * n
    for i in reversed(range(n)):
        v = y[i]
        for kk in range(i + 1, n):
            v = v - L[kk][i] * x[kk]
        x[i] = v / L[i][i]
    return jnp.stack(x, axis=-1)


def _apply_twist(delta: Pose3, s: jax.Array) -> Pose3:
    """Left-compose the small twist ``s = (theta, dt)`` onto ``delta``."""
    dq = quat_exp(s[..., :3])
    return Pose3(
        quat_normalize(quat_multiply(dq, delta.rotation)),
        quat_rotate(dq, delta.translation) + s[..., 3:],
    )


def lm_solve(
    problem: _Problem,
    params: RegistrationParams,
) -> Tuple[Pose3, jax.Array]:
    """Solve for the delta pose over the fixed associations.

    Runs ``params.inner_iterations`` damped Gauss-Newton (LM) steps with
    cost-decrease accept/reject, starting from the identity delta (the
    reference re-initializes ``estimate_update`` each outer iteration,
    ``registration-inl.h:36``).

    One residual sweep per step: the normal equations (H, g) at the current
    accepted delta ride in the scan carry, so each step's single sweep both
    scores the candidate AND (on accept) relinearizes there. A rejected
    step's relinearization at the unchanged delta would reproduce the
    carried H, g exactly, so reusing them is not an approximation — the
    per-step results are identical to the two-sweep form, at half the
    residual cost.

    Returns (delta, final_cost).
    """
    # lm_impl ("auto"/"xla") is retained for config compatibility; both
    # take this path.
    dtype = problem.pts_edge.dtype
    delta0 = Pose3.identity(dtype)
    lam0 = jnp.asarray(1e-4, dtype)

    def linearize(delta):
        """One sweep -> (cost, H, g) at ``delta``."""
        r, grad, q, mask = _residuals(problem, delta)
        cost = jnp.sum(jnp.where(mask, _huber_rho(r, params.huber_delta), 0.0))
        # J = [q x grad, grad]  (n, 6); zero invalid rows so no masked-slot
        # garbage (0 * nan) can reach the einsum accumulators.
        J = jnp.concatenate([jnp.cross(q, grad), grad], axis=-1)
        J = jnp.where(mask[:, None], J, 0.0)
        r = jnp.where(mask, r, 0.0)
        w = jnp.where(mask, _huber_weight(r, params.huber_delta), 0.0)
        # HIGHEST: a GPU may otherwise run these f32 contractions in TF32
        # (~10 mantissa bits), far too coarse for the 1e-4 rad round trip
        H = jnp.einsum("n,ni,nj->ij", w, J, J, precision=Precision.HIGHEST)
        g = jnp.einsum("n,ni,n->i", w, J, r, precision=Precision.HIGHEST)
        if params.prior_weight > 0:
            # quadratic prior (delta o prior_offset) ~ 0: keeps unobservable
            # directions at the ICF initialization (see
            # RegistrationParams.prior_weight and _Problem.prior_offset)
            xi = _prior_xi(problem, delta)
            cost = cost + params.prior_weight * jnp.sum(xi * xi)
            H = H + params.prior_weight * jnp.eye(6, dtype=dtype)
            g = g + params.prior_weight * xi
        return cost, H, g

    cost0, H0, g0 = linearize(delta0)

    def body(carry, _):
        delta, cost, H, g, lam = carry
        # Marquardt scaling + a RELATIVE floor: with degenerate geometry
        # (e.g. planes from a single wall, no edges) H is rank deficient and
        # per-diagonal scaling alone leaves null directions undamped — the
        # solver then wanders meters along the unconstrained directions.
        # Flooring at 1e-6 of the largest diagonal bounds those steps while
        # perturbing well-conditioned solves negligibly.
        diag = jnp.diagonal(H)
        damp = lam * diag + 1e-6 * jnp.max(diag) + 1e-10
        step = -_chol_solve6(H + jnp.diag(damp), g)
        candidate = _apply_twist(delta, step)
        new_cost, new_H, new_g = linearize(candidate)
        accept = new_cost < cost
        delta = jax.tree.map(lambda n, o: jnp.where(accept, n, o), candidate, delta)
        cost = jnp.where(accept, new_cost, cost)
        H = jnp.where(accept, new_H, H)
        g = jnp.where(accept, new_g, g)
        lam = jnp.where(accept, jnp.maximum(lam / 3.0, 1e-12), jnp.minimum(lam * 4.0, 1e8))
        return (delta, cost, H, g, lam), cost

    # unroll: inner_iterations is tiny (reference-pinned 4); the while-loop
    # bookkeeping around a rolled scan measured ~0.13 ms/outer-iteration in
    # device traces — as much as the four steps' own math
    (delta, _, _, _, _), costs = lax.scan(
        body,
        (delta0, cost0, H0, g0, lam0),
        None,
        length=params.inner_iterations,
        unroll=True,
    )
    return delta, costs[-1]
