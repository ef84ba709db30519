"""Feature registration ("Iterative Closest Feature") for loam-jax.

JAX reimplementation of the reference's registration module
(``loam/include/loam/registration.h``, ``registration-inl.h``,
``loam/src/registration.cpp``): associate source edge/planar features to
line/plane fits in the target via batched kNN, then solve for the relative
pose with an analytic-Jacobian Levenberg–Marquardt on the 6-DoF delta pose —
replacing Ceres autodiff + DENSE_QR with on-device normal equations
(6x6 Cholesky), everything fixed-shape, jit-compatible and vmappable over a
pair axis.
"""

from .detail import IterationInfo, RegistrationDetail
from .icf import register_features, register_features_batch

__all__ = [
    "IterationInfo",
    "RegistrationDetail",
    "register_features",
    "register_features_batch",
]
