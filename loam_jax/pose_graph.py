"""Pose-graph optimization (SE(3) Gauss-Newton) on device.

The layer above odometry that the reference leaves entirely to users
(SURVEY §3.4, §5 "long-context"): given relative-pose constraints —
sequential odometry edges plus loop closures — refine the whole trajectory.

Formulation: all E edges are processed batched (residuals and
(6, 6) Jacobian blocks via vmapped forward-mode autodiff of the exact
quaternion residual), scatter-added into dense normal equations, and solved
with Cholesky + Levenberg-Marquardt damping, everything jit-compatible with
fixed shapes (edges carry a validity mask). Node 0 is gauge-fixed.

Dense 6N x 6N normal equations are the right call on an accelerator for
trajectory scales up to a few thousand keyframes (an O((6N)^3/3) dense
factorization); under ``pjit`` the edge axis shards and XLA ``psum``s the
assembled H across devices. The normal-equation contractions are pinned to
``Precision.HIGHEST`` so a GPU does not run them in TF32.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.lax import Precision

from .geometry import (
    Pose3,
    quat_conjugate,
    quat_exp,
    quat_log,
    quat_multiply,
    quat_normalize,
    quat_rotate,
)


class PoseGraphEdges(NamedTuple):
    """Batched relative-pose constraints (a pytree; leaves lead with E).

    ``measurement`` is the expected ``node_i_T_node_j``; ``weight`` scales
    each edge's contribution (e.g. inverse variance); invalid slots are
    masked out, so edge sets can be padded to a fixed capacity.
    """

    i: jax.Array  # (E,) int32 source node
    j: jax.Array  # (E,) int32 target node
    measurement: Pose3  # (E, ...) leaves
    weight: jax.Array  # (E,)
    mask: jax.Array  # (E,) bool


def make_edges(i, j, measurement: Pose3, weight=None, mask=None) -> PoseGraphEdges:
    i = jnp.asarray(i, jnp.int32)
    if weight is None:
        weight = jnp.ones(i.shape, measurement.translation.dtype)
    if mask is None:
        mask = jnp.ones(i.shape, bool)
    return PoseGraphEdges(
        i, jnp.asarray(j, jnp.int32), measurement, jnp.asarray(weight), mask
    )


def odometry_edges(trajectory: Pose3) -> PoseGraphEdges:
    """Sequential edges from a trajectory of world poses: the standard
    odometry chain ``i -> i+1`` with measurement ``T_i^{-1} T_{i+1}``."""
    prev = jax.tree.map(lambda x: x[:-1], trajectory)
    nxt = jax.tree.map(lambda x: x[1:], trajectory)
    rel = Pose3(
        quat_multiply(quat_conjugate(prev.rotation), nxt.rotation),
        quat_rotate(quat_conjugate(prev.rotation), nxt.translation - prev.translation),
    )
    n = trajectory.translation.shape[0]
    return make_edges(jnp.arange(n - 1), jnp.arange(1, n), rel)


def _edge_residual(xi_i, xi_j, Ti: Pose3, Tj: Pose3, z: Pose3):
    """r = Log(z^{-1} (Exp(xi_i) Ti)^{-1} (Exp(xi_j) Tj)) in R^6
    (rotation part first). Evaluated at xi = 0 in the solver; autodiff
    provides the exact (6, 6) Jacobian blocks."""
    Pi = Pose3(
        quat_multiply(quat_exp(xi_i[:3]), Ti.rotation),
        quat_rotate(quat_exp(xi_i[:3]), Ti.translation) + xi_i[3:],
    )
    Pj = Pose3(
        quat_multiply(quat_exp(xi_j[:3]), Tj.rotation),
        quat_rotate(quat_exp(xi_j[:3]), Tj.translation) + xi_j[3:],
    )
    rel = Pi.inverse().compose(Pj)
    err = z.inverse().compose(rel)
    return jnp.concatenate([quat_log(err.rotation), err.translation])


@functools.partial(jax.jit, static_argnames=("iterations",))
def optimize_pose_graph(
    initial: Pose3,
    edges: PoseGraphEdges,
    iterations: int = 10,
) -> Tuple[Pose3, jax.Array]:
    """Gauss-Newton/LM pose-graph solve.

    Args:
      initial: (N, ...) world poses (node 0 is the fixed gauge).
      edges: padded constraint set.
      iterations: outer LM iterations (static).

    Returns: (optimized trajectory, final total weighted squared error).
    """
    N = initial.translation.shape[0]
    dtype = initial.translation.dtype
    dim = 6 * N
    initial = Pose3(
        initial.rotation.astype(dtype), initial.translation.astype(dtype)
    )
    edges = edges._replace(
        measurement=Pose3(
            edges.measurement.rotation.astype(dtype),
            edges.measurement.translation.astype(dtype),
        ),
        weight=edges.weight.astype(dtype),
    )

    res_fn = lambda xi_i, xi_j, Ti, Tj, z: _edge_residual(xi_i, xi_j, Ti, Tj, z)
    jac_i = jax.jacfwd(res_fn, argnums=0)
    jac_j = jax.jacfwd(res_fn, argnums=1)
    zero6 = jnp.zeros((6,), dtype)

    def edge_terms(poses: Pose3, e: PoseGraphEdges):
        Ti = jax.tree.map(lambda x: x[e.i], poses)
        Tj = jax.tree.map(lambda x: x[e.j], poses)
        r = jax.vmap(res_fn, in_axes=(None, None, 0, 0, 0))(
            zero6, zero6, Ti, Tj, e.measurement
        )
        Ji = jax.vmap(jac_i, in_axes=(None, None, 0, 0, 0))(
            zero6, zero6, Ti, Tj, e.measurement
        )
        Jj = jax.vmap(jac_j, in_axes=(None, None, 0, 0, 0))(
            zero6, zero6, Ti, Tj, e.measurement
        )
        w = jnp.where(e.mask, e.weight, 0.0)
        return r, Ji, Jj, w

    def assemble(poses: Pose3):
        r, Ji, Jj, w = edge_terms(poses, edges)
        H = jnp.zeros((dim, dim), dtype)
        b = jnp.zeros((dim,), dtype)
        wj = w[:, None, None]
        Hii = wj * jnp.einsum("eri,erj->eij", Ji, Ji, precision=Precision.HIGHEST)
        Hjj = wj * jnp.einsum("eri,erj->eij", Jj, Jj, precision=Precision.HIGHEST)
        Hij = wj * jnp.einsum("eri,erj->eij", Ji, Jj, precision=Precision.HIGHEST)
        bi = w[:, None] * jnp.einsum("eri,er->ei", Ji, r, precision=Precision.HIGHEST)
        bj = w[:, None] * jnp.einsum("eri,er->ei", Jj, r, precision=Precision.HIGHEST)
        si = 6 * edges.i
        sj = 6 * edges.j
        oi = si[:, None] + jnp.arange(6)[None, :]  # (E, 6)
        oj = sj[:, None] + jnp.arange(6)[None, :]
        H = H.at[oi[:, :, None], oi[:, None, :]].add(Hii)
        H = H.at[oj[:, :, None], oj[:, None, :]].add(Hjj)
        H = H.at[oi[:, :, None], oj[:, None, :]].add(Hij)
        H = H.at[oj[:, :, None], oi[:, None, :]].add(
            jnp.swapaxes(Hij, -1, -2)
        )
        b = b.at[oi].add(bi)
        b = b.at[oj].add(bj)
        cost = jnp.sum(w * jnp.sum(r * r, axis=-1))
        return H, b, cost

    def apply_update(poses: Pose3, dx: jax.Array) -> Pose3:
        xi = dx.reshape(N, 6)
        xi = xi.at[0].set(0.0)  # gauge
        dq = quat_exp(xi[:, :3])
        return Pose3(
            quat_normalize(quat_multiply(dq, poses.rotation)),
            quat_rotate(dq, poses.translation) + xi[:, 3:],
        )

    gauge = jnp.zeros((dim,), dtype).at[:6].set(1e12)  # clamp node 0

    def body(carry, _):
        poses, lam, cost = carry
        H, b, _ = assemble(poses)
        damp = lam * jnp.diagonal(H) + 1e-8
        Hd = H + jnp.diag(damp + gauge)
        L = jnp.linalg.cholesky(Hd)
        dx = -jax.scipy.linalg.cho_solve((L, True), b)
        candidate = apply_update(poses, dx)
        _, _, new_cost = assemble(candidate)
        accept = new_cost < cost
        poses = jax.tree.map(lambda n, o: jnp.where(accept, n, o), candidate, poses)
        cost = jnp.where(accept, new_cost, cost)
        lam = jnp.where(accept, jnp.maximum(lam / 3.0, 1e-12), jnp.minimum(lam * 4.0, 1e8))
        return (poses, lam, cost), None

    _, _, cost0 = assemble(initial)
    (poses, _, cost), _ = lax.scan(
        body, (initial, jnp.asarray(1e-6, dtype), cost0), None, length=iterations
    )
    return poses, cost


def optimize_pose_graph_sharded(
    initial: Pose3,
    edges: PoseGraphEdges,
    mesh,
    iterations: int = 10,
    axis: str = "data",
) -> Tuple[Pose3, jax.Array]:
    """Distributed pose-graph solve: edges sharded over the mesh.

    Each device assembles the normal-equation contributions of its edge
    shard under ``jax.shard_map``; the 6N x 6N system is ``psum``-reduced
    across devices — which also makes it VMA-replicated, so the modern shard_map
    type checker accepts it — and the LM accept/reject loop runs replicated
    at the jit level (SURVEY §2.2: distributed Gauss-Newton with
    psum-reduced normal equations). Results match the single-device solver
    up to floating-point reduction order. Edge capacity must divide the
    axis size (pad with masked edges).
    """
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    N = initial.translation.shape[0]
    dtype = initial.translation.dtype
    dim = 6 * N
    initial = Pose3(
        initial.rotation.astype(dtype), initial.translation.astype(dtype)
    )
    edges = edges._replace(
        measurement=Pose3(
            edges.measurement.rotation.astype(dtype),
            edges.measurement.translation.astype(dtype),
        ),
        weight=edges.weight.astype(dtype),
    )

    res_fn = _edge_residual
    jac_i = jax.jacfwd(res_fn, argnums=0)
    jac_j = jax.jacfwd(res_fn, argnums=1)
    zero6 = jnp.zeros((6,), dtype)
    gauge = jnp.zeros((dim,), dtype).at[:6].set(1e12)

    def assemble_local(q0, t0, ei, ej, mq, mt, w, m):
        # runs per edge shard inside shard_map; psum makes the outputs
        # replicated (both semantically and in the VMA type system)
        e = PoseGraphEdges(ei, ej, Pose3(mq, mt), w, m)
        poses = Pose3(q0, t0)
        Ti = jax.tree.map(lambda x: x[e.i], poses)
        Tj = jax.tree.map(lambda x: x[e.j], poses)
        r = jax.vmap(res_fn, in_axes=(None, None, 0, 0, 0))(
            zero6, zero6, Ti, Tj, e.measurement
        )
        Ji = jax.vmap(jac_i, in_axes=(None, None, 0, 0, 0))(
            zero6, zero6, Ti, Tj, e.measurement
        )
        Jj = jax.vmap(jac_j, in_axes=(None, None, 0, 0, 0))(
            zero6, zero6, Ti, Tj, e.measurement
        )
        wm = jnp.where(e.mask, e.weight, 0.0)
        H = jnp.zeros((dim, dim), dtype)
        b = jnp.zeros((dim,), dtype)
        wj = wm[:, None, None]
        Hii = wj * jnp.einsum("eri,erj->eij", Ji, Ji, precision=Precision.HIGHEST)
        Hjj = wj * jnp.einsum("eri,erj->eij", Jj, Jj, precision=Precision.HIGHEST)
        Hij = wj * jnp.einsum("eri,erj->eij", Ji, Jj, precision=Precision.HIGHEST)
        bi = wm[:, None] * jnp.einsum("eri,er->ei", Ji, r, precision=Precision.HIGHEST)
        bj = wm[:, None] * jnp.einsum("eri,er->ei", Jj, r, precision=Precision.HIGHEST)
        oi = (6 * e.i)[:, None] + jnp.arange(6)[None, :]
        oj = (6 * e.j)[:, None] + jnp.arange(6)[None, :]
        H = H.at[oi[:, :, None], oi[:, None, :]].add(Hii)
        H = H.at[oj[:, :, None], oj[:, None, :]].add(Hjj)
        H = H.at[oi[:, :, None], oj[:, None, :]].add(Hij)
        H = H.at[oj[:, :, None], oi[:, None, :]].add(
            jnp.swapaxes(Hij, -1, -2)
        )
        b = b.at[oi].add(bi)
        b = b.at[oj].add(bj)
        cost = jnp.sum(wm * jnp.sum(r * r, axis=-1))
        # the collective: reduce partial normal equations over the mesh
        return (
            lax.psum(H, axis),
            lax.psum(b, axis),
            lax.psum(cost, axis),
        )

    rep = P()
    sh = P(axis)
    assemble_sh = shard_map(
        assemble_local,
        mesh=mesh,
        in_specs=(rep, rep, sh, sh, sh, sh, sh, sh),
        out_specs=(rep, rep, rep),
    )

    def assemble(poses):
        return assemble_sh(
            poses.rotation,
            poses.translation,
            edges.i,
            edges.j,
            edges.measurement.rotation,
            edges.measurement.translation,
            edges.weight,
            edges.mask,
        )

    def apply_update(poses, dx):
        xi = dx.reshape(N, 6).at[0].set(0.0)
        dq = quat_exp(xi[:, :3])
        return Pose3(
            quat_normalize(quat_multiply(dq, poses.rotation)),
            quat_rotate(dq, poses.translation) + xi[:, 3:],
        )

    # replicated LM accept/reject loop at the jit level; only assembly is
    # collective
    def body(carry, _):
        poses, lam, cost = carry
        H, b, _ = assemble(poses)
        damp = lam * jnp.diagonal(H) + 1e-8
        L = jnp.linalg.cholesky(H + jnp.diag(damp + gauge))
        dx = -jax.scipy.linalg.cho_solve((L, True), b)
        candidate = apply_update(poses, dx)
        _, _, new_cost = assemble(candidate)
        accept = new_cost < cost
        poses = jax.tree.map(
            lambda n_, o: jnp.where(accept, n_, o), candidate, poses
        )
        cost = jnp.where(accept, new_cost, cost)
        lam = jnp.where(
            accept, jnp.maximum(lam / 3.0, 1e-12), jnp.minimum(lam * 4.0, 1e8)
        )
        return (poses, lam, cost), None

    _, _, cost0 = assemble(initial)
    (poses, _, cost), _ = lax.scan(
        body, (initial, jnp.asarray(1e-6, dtype), cost0), None,
        length=iterations,
    )
    return poses, cost
