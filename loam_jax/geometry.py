"""SE(3) / geometric primitives for loam-jax, as batched JAX operations.

Functional analogue of the reference's geometry module
(``loam/include/loam/geometry.h``, ``loam/src/geometry.cpp``): ``Pose3``
(quaternion + translation), line/plane fitting, and point-to-line /
point-to-plane distances — all shaped for ``vmap``/``jit``: every function
accepts arbitrary leading batch dimensions.

Conventions:
  * Quaternions are ``(..., 4)`` arrays in ``[w, x, y, z]`` order (Hamilton,
    matching Eigen's ``Quaterniond(w, x, y, z)`` constructor semantics).
  * A pose acts on points by ``p' = R p + t`` (reference ``geometry.cpp:21``).
  * Lines are represented by two points ``a``/``b`` on the line (reference
    ``geometry.h:66-74``); planes by unit normal ``n`` and offset ``d`` with
    ``n . p - d = 0`` (reference ``geometry.h:80-88``).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp


# ---------------------------------------------------------------------------
# Quaternion ops  (wxyz, Hamilton convention)
# ---------------------------------------------------------------------------

def quat_identity(dtype=jnp.float32, batch_shape: Tuple[int, ...] = ()) -> jax.Array:
    q = jnp.zeros(batch_shape + (4,), dtype=dtype)
    return q.at[..., 0].set(1.0)


def quat_multiply(q1: jax.Array, q2: jax.Array) -> jax.Array:
    """Hamilton product ``q1 * q2`` on wxyz quaternions."""
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return jnp.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        axis=-1,
    )


def quat_conjugate(q: jax.Array) -> jax.Array:
    return q * jnp.asarray([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def quat_normalize(q: jax.Array) -> jax.Array:
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def quat_rotate(q: jax.Array, v: jax.Array) -> jax.Array:
    """Rotate vector(s) ``v`` (..., 3) by unit quaternion(s) ``q`` (..., 4).

    Uses the 2-cross-product expansion (no matmul needed; pure elementwise):
      v' = v + 2 w (u x v) + 2 u x (u x v),  u = q.xyz
    """
    u = q[..., 1:]
    w = q[..., :1]
    uv = jnp.cross(u, v)
    return v + 2.0 * (w * uv + jnp.cross(u, uv))


def quat_to_matrix(q: jax.Array) -> jax.Array:
    """Unit quaternion (..., 4) -> rotation matrix (..., 3, 3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = jnp.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        axis=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def quat_from_axis_angle(axis: jax.Array, angle: jax.Array) -> jax.Array:
    """Unit ``axis`` (..., 3) and ``angle`` (...) -> quaternion (..., 4)."""
    half = 0.5 * jnp.asarray(angle)
    s = jnp.sin(half)
    return jnp.concatenate(
        [jnp.cos(half)[..., None], s[..., None] * axis], axis=-1
    )


def quat_exp(rotvec: jax.Array) -> jax.Array:
    """so(3) exponential: rotation vector (..., 3) -> unit quaternion (..., 4).

    Numerically stable near zero via the sinc expansion.
    """
    theta_sq = jnp.sum(rotvec * rotvec, axis=-1, keepdims=True)
    theta = jnp.sqrt(theta_sq)
    half = 0.5 * theta
    small = theta_sq < 1e-12
    # sin(theta/2)/theta with Taylor fallback: 1/2 - theta^2/48
    k = jnp.where(small, 0.5 - theta_sq / 48.0, jnp.sin(half) / jnp.where(small, 1.0, theta))
    w = jnp.where(small, 1.0 - theta_sq / 8.0, jnp.cos(half))
    return jnp.concatenate([w, k * rotvec], axis=-1)


def quat_log(q: jax.Array) -> jax.Array:
    """Unit quaternion (..., 4) -> rotation vector (..., 3)."""
    q = jnp.where(q[..., :1] < 0, -q, q)  # take shortest arc
    u = q[..., 1:]
    un = jnp.linalg.norm(u, axis=-1, keepdims=True)
    w = jnp.clip(q[..., :1], -1.0, 1.0)
    angle = 2.0 * jnp.arctan2(un, w)
    small = un < 1e-9
    scale = jnp.where(small, 2.0 / jnp.where(w == 0, 1.0, w), angle / jnp.where(small, 1.0, un))
    return scale * u


def quat_angular_distance(q1: jax.Array, q2: jax.Array) -> jax.Array:
    """Angle of q1^{-1} q2 — matches Eigen's ``angularDistance``."""
    d = quat_multiply(quat_conjugate(q1), q2)
    un = jnp.linalg.norm(d[..., 1:], axis=-1)
    return 2.0 * jnp.arctan2(un, jnp.abs(d[..., 0]))


def _so3_V_apply(rotvec: jax.Array, v: jax.Array, inverse: bool) -> jax.Array:
    """Apply the SO(3) left-Jacobian ``V`` (or its inverse) to ``v``.

    ``V = I + (1-cos t)/t^2 [w]x + (t - sin t)/t^3 [w]x^2`` links the SE(3)
    exponential's translation to the twist: ``Exp(w, u).t = V(w) u``.
    Closed form via two cross products (no 3x3 materialization); Taylor
    guards below t^2 = 1e-8 keep f32/f64 stable at small angles.
    """
    t2 = jnp.sum(rotvec * rotvec, axis=-1, keepdims=True)
    t = jnp.sqrt(t2)
    small = t2 < 1e-8
    safe_t2 = jnp.where(small, 1.0, t2)
    if not inverse:
        # a = (1-cos t)/t^2, b = (t - sin t)/t^3
        a = jnp.where(small, 0.5 - t2 / 24.0, (1.0 - jnp.cos(t)) / safe_t2)
        b = jnp.where(
            small, 1.0 / 6.0 - t2 / 120.0, (t - jnp.sin(t)) / (safe_t2 * jnp.where(small, 1.0, t))
        )
    else:
        # V^-1 = I - 1/2 [w]x + c [w]x^2,
        # c = 1/t^2 - (1 + cos t)/(2 t sin t)   (-> 1/12 + t^2/720 + ...)
        a = jnp.asarray(-0.5, rotvec.dtype) * jnp.ones_like(t2)
        s = jnp.sin(t)
        safe = jnp.where(small | (jnp.abs(s) < 1e-12), 1.0, 2.0 * t * s)
        c = 1.0 / safe_t2 - (1.0 + jnp.cos(t)) / safe
        b = jnp.where(small, 1.0 / 12.0 + t2 / 720.0, c)
    w_cross_v = jnp.cross(rotvec, v)
    w_cross2_v = jnp.cross(rotvec, w_cross_v)
    return v + a * w_cross_v + b * w_cross2_v


def se3_exp(xi: jax.Array) -> "Pose3":
    """SE(3) exponential: twist ``xi = (w, u)`` (..., 6) -> Pose3.

    Exact screw motion: rotation ``Exp(w)``, translation ``V(w) u`` — the
    V-matrix form the cheap dewarp interpolation omits (``dewarp.py``);
    ``se3_exp(a*xi)`` traces the true constant-twist trajectory for any
    fraction ``a``.
    """
    w = xi[..., :3]
    u = xi[..., 3:]
    return Pose3(quat_exp(w), _so3_V_apply(w, u, inverse=False))


def se3_log(pose: "Pose3") -> jax.Array:
    """SE(3) logarithm: Pose3 -> twist (..., 6), inverse of :func:`se3_exp`."""
    w = quat_log(pose.rotation)
    u = _so3_V_apply(w, pose.translation, inverse=True)
    return jnp.concatenate([w, u], axis=-1)


# ---------------------------------------------------------------------------
# Pose3 (pytree)
# ---------------------------------------------------------------------------

class Pose3(NamedTuple):
    """SE(3) pose as a pytree: quaternion (..., 4) wxyz + translation (..., 3).

    Mirrors the reference ``Pose3d`` (``geometry.h:27-50``).
    """

    rotation: jax.Array
    translation: jax.Array

    @staticmethod
    def identity(dtype=jnp.float32, batch_shape: Tuple[int, ...] = ()) -> "Pose3":
        return Pose3(
            quat_identity(dtype, batch_shape),
            jnp.zeros(batch_shape + (3,), dtype=dtype),
        )

    def inverse(self) -> "Pose3":
        """Reference ``geometry.cpp:10-13``."""
        inv_rot = quat_conjugate(self.rotation)
        return Pose3(inv_rot, quat_rotate(inv_rot, -self.translation))

    def compose(self, other: "Pose3") -> "Pose3":
        """``self ∘ other`` — reference ``geometry.cpp:16-18``."""
        return Pose3(
            quat_multiply(self.rotation, other.rotation),
            self.translation + quat_rotate(self.rotation, other.translation),
        )

    def act(self, p: jax.Array) -> jax.Array:
        """Apply the pose to point(s): ``R p + t`` (reference ``geometry.cpp:21``).

        Broadcasts over any leading point batch dims beyond the pose batch.
        """
        return quat_rotate(self.rotation, p) + self.translation

    def matrix(self) -> jax.Array:
        """4x4 homogeneous matrix (reference ``geometry.cpp:24-29``)."""
        batch = self.translation.shape[:-1]
        m = jnp.zeros(batch + (4, 4), dtype=self.translation.dtype)
        m = m.at[..., :3, :3].set(quat_to_matrix(self.rotation))
        m = m.at[..., :3, 3].set(self.translation)
        m = m.at[..., 3, 3].set(1.0)
        return m

    def normalize(self) -> "Pose3":
        return Pose3(quat_normalize(self.rotation), self.translation)


def pose_from_rotvec(rotvec: jax.Array, translation: jax.Array) -> Pose3:
    return Pose3(quat_exp(rotvec), translation)


def pose_cumcompose(rel: Pose3) -> Pose3:
    """Prefix-compose a sequence of relative poses (leading axis).

    ``out[i] = rel[0] o rel[1] o ... o rel[i]`` via ``lax.associative_scan``
    (pose composition is associative) — log-depth on device, replacing the
    host-side sequential accumulation of the reference's user loop.
    """

    def combine(a: Pose3, b: Pose3) -> Pose3:
        return Pose3(
            quat_multiply(a.rotation, b.rotation),
            a.translation + quat_rotate(a.rotation, b.translation),
        )

    out = jax.lax.associative_scan(combine, rel)
    return Pose3(quat_normalize(out.rotation), out.translation)


# ---------------------------------------------------------------------------
# Lines and planes (batched, masked fitting)
# ---------------------------------------------------------------------------

def sym3x3_eigvalsh(A: jax.Array) -> jax.Array:
    """Eigenvalues of symmetric (..., 3, 3) matrices, ascending — closed form.

    Trigonometric solution of the characteristic cubic (Smith's algorithm):
    pure elementwise math that fuses into one kernel, instead of the
    iterative solver behind a batched 3x3 ``jnp.linalg.eigh``.
    """
    dtype = A.dtype
    q = jnp.trace(A, axis1=-2, axis2=-1) / 3.0
    B = A - q[..., None, None] * jnp.eye(3, dtype=dtype)
    p2 = jnp.sum(B * B, axis=(-2, -1)) / 6.0
    p = jnp.sqrt(jnp.maximum(p2, 0.0))
    safe_p = jnp.where(p > 0, p, 1.0)
    # explicit 3x3 determinant (jnp.linalg.det would take a generic LU path)
    b00, b01, b02 = B[..., 0, 0], B[..., 0, 1], B[..., 0, 2]
    b10, b11, b12 = B[..., 1, 0], B[..., 1, 1], B[..., 1, 2]
    b20, b21, b22 = B[..., 2, 0], B[..., 2, 1], B[..., 2, 2]
    detB = (
        b00 * (b11 * b22 - b12 * b21)
        - b01 * (b10 * b22 - b12 * b20)
        + b02 * (b10 * b21 - b11 * b20)
    )
    r = detB / (2.0 * safe_p**3)
    r = jnp.clip(r, -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    two_pi_3 = 2.0 * jnp.pi / 3.0
    e2 = q + 2.0 * p * jnp.cos(phi)  # largest
    e0 = q + 2.0 * p * jnp.cos(phi + two_pi_3)  # smallest
    e1 = 3.0 * q - e0 - e2
    zero_p = p == 0
    eq = jnp.stack([q, q, q], axis=-1)
    eig = jnp.stack([e0, e1, e2], axis=-1)
    return jnp.where(zero_p[..., None], eq, eig)


def sym3x3_principal_eigvec(A: jax.Array, eigval: jax.Array) -> jax.Array:
    """Unit eigenvector of symmetric (..., 3, 3) ``A`` for (non-repeated)
    eigenvalue ``eigval`` via the adjugate of ``A - eigval I`` (closed form:
    the nonzero columns of adj(A - lambda I) span the eigenspace)."""
    dtype = A.dtype
    M = A - eigval[..., None, None] * jnp.eye(3, dtype=dtype)
    r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    c0 = jnp.cross(r1, r2)
    c1 = jnp.cross(r2, r0)
    c2 = jnp.cross(r0, r1)
    n0 = jnp.sum(c0 * c0, axis=-1)
    n1 = jnp.sum(c1 * c1, axis=-1)
    n2 = jnp.sum(c2 * c2, axis=-1)
    # pick the numerically largest cross product
    best01 = jnp.where((n0 >= n1)[..., None], c0, c1)
    nbest01 = jnp.maximum(n0, n1)
    v = jnp.where((nbest01 >= n2)[..., None], best01, c2)
    nv = jnp.sqrt(jnp.maximum(jnp.maximum(nbest01, n2), 1e-30))
    return v / nv[..., None]


def _outer_sum_small_k(centered: jax.Array) -> jax.Array:
    """sum_k centered[..., k, :] (x) centered[..., k, :] with the (static,
    small) neighbor axis unrolled: a K~5 contraction as dot_general lowers
    to a badly-shaped batched matmul; K unrolled multiply-adds are pure
    elementwise work."""
    K = centered.shape[-2]
    cov = centered[..., 0, :, None] * centered[..., 0, None, :]
    for k in range(1, K):
        cov = cov + centered[..., k, :, None] * centered[..., k, None, :]
    return cov


def fit_line(points: jax.Array, mask: jax.Array) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """PCA line fit over masked points (reference ``geometry.cpp:42-59``).

    Args:
      points: (..., K, 3) candidate points (invalid rows arbitrary).
      mask:   (..., K) boolean validity of each row (>= 2 true rows assumed
              where the result is consumed; callers guard on counts).

    Returns:
      (a, b, condition_number): two points on the line, ``center ± 0.1 * dir``
      where ``dir`` is the principal eigenvector, and the co-linearity
      condition number. The 3x3 eigenproblem is solved in closed form
      (``sym3x3_*``) instead of a batched iterative ``eigh``, with identical
      results for the well-separated spectra that pass the registration
      guards.

      NOTE (reference quirk §2.3(1)): ``fitLine`` in the reference computes
      ``eig(2)/eig(0)`` but never assigns it, so its returned condition
      number is always ``DBL_MAX`` and the registration guard never rejects.
      We return the *actually computed* ratio here; the registration layer
      chooses whether to honor it (default: no, matching the reference's
      effective behavior).
    """
    dtype = points.dtype
    m = mask.astype(dtype)[..., None]  # (..., K, 1)
    count = jnp.maximum(jnp.sum(m, axis=-2), 1.0)  # (..., 1)
    center = jnp.sum(points * m, axis=-2) / count  # (..., 3)
    centered = (points - center[..., None, :]) * m
    cov = _outer_sum_small_k(centered)
    eigvals = sym3x3_eigvalsh(cov)
    direction = sym3x3_principal_eigvec(cov, eigvals[..., 2])
    a = center + 0.1 * direction
    b = center - 0.1 * direction
    cond = eigvals[..., 2] / jnp.where(
        jnp.abs(eigvals[..., 0]) < 1e-12, jnp.asarray(1e-12, dtype), eigvals[..., 0]
    )
    return a, b, cond


def fit_plane(points: jax.Array, mask: jax.Array) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Plane fit over masked points (reference ``geometry.cpp:62-73``).

    Deliberate numerical divergence from the reference: the reference solves
    the algebraic system ``points @ abc = 1`` via normal equations, whose
    conditioning degrades as range^2 — catastrophic in f32 for far planes.
    Here the plane is fit by centered PCA (normal = smallest eigenvector of
    the neighborhood covariance, ``d = n . centroid``), computed with the
    closed-form 3x3 eigensolver: identical planes for clean data, the
    orthogonal-least-squares (better) plane for noisy data, stable at any
    range and dtype. The normal is oriented so ``d >= 0``, matching the
    reference's ``d = 1/|abc| > 0`` convention.

    Returns:
      (normal (...,3), d (...), avg_dist (...)) where ``avg_dist`` is the
      SIGNED mean residual ``mean(points . n - d)`` — the reference's
      ``.mean()`` of signed residuals hovers at ~0 for its fit (quirk
      §2.3(2), guard never fires); for the PCA fit it is exactly 0 by
      construction, reproducing that effective behavior precisely.
    """
    dtype = points.dtype
    m = mask.astype(dtype)[..., None]
    count = jnp.maximum(jnp.sum(m, axis=-2), 1.0)  # (..., 1)
    centroid = jnp.sum(points * m, axis=-2) / count
    centered = (points - centroid[..., None, :]) * m
    cov = _outer_sum_small_k(centered)
    eigvals = sym3x3_eigvalsh(cov)
    # smallest-eigenvalue eigenvector = plane normal
    normal = sym3x3_principal_eigvec(cov, eigvals[..., 0])
    d = jnp.sum(normal * centroid, axis=-1)
    flip = jnp.where(d < 0, -1.0, 1.0)
    normal = normal * flip[..., None]
    d = d * flip
    avg_dist = jnp.zeros_like(d)  # signed mean residual of the PCA fit
    return normal, d, avg_dist


def point_to_line_distance(point: jax.Array, line_a: jax.Array, line_b: jax.Array) -> jax.Array:
    """‖(p−a)×(p−b)‖ / ‖a−b‖ (reference ``geometry-inl.h:21-27``)."""
    num = jnp.linalg.norm(jnp.cross(point - line_a, point - line_b), axis=-1)
    den = jnp.linalg.norm(line_a - line_b, axis=-1)
    return num / den


def point_to_plane_distance(point: jax.Array, normal: jax.Array, d: jax.Array) -> jax.Array:
    """|n·p − d| (reference ``geometry-inl.h:30-33``)."""
    return jnp.abs(jnp.sum(point * normal, axis=-1) - d)
