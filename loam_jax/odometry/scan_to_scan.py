"""Streaming scan-to-scan odometry.

Compiled version of the reference README's user loop (``README.md:44-60``):
extract features from each incoming scan, register them against the previous
scan's features, accumulate the relative pose. Additions the reference leaves
to users: a constant-velocity motion prior (initialize each registration with
the previous relative pose instead of identity) and a fully jitted step.

The first frame needs no special casing: registering against the initial
empty feature set terminates with ``INSUFFICIENT_ASSOCIATIONS`` before
solving, leaving the pose at its init (SURVEY §2.3(9)) — i.e. identity.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..features import FeatureSet, extract_features
from ..geometry import Pose3
from ..params import FeatureExtractionParams, LidarParams, RegistrationParams
from ..registration import RegistrationDetail
from ..registration.icf import _register
from ..dewarp import dewarp_scan


class ScanToScanState(NamedTuple):
    """Carry for the streaming loop (a pytree).

    ``prev_delta`` is last frame's ``prev_T_current`` — the constant-velocity
    motion prior for the next registration.
    """

    world_T_current: Pose3
    prev_features: FeatureSet
    prev_delta: Pose3


def scan_to_scan_init(
    lidar: LidarParams,
    feat_params: FeatureExtractionParams = FeatureExtractionParams(),
    dtype=jnp.float32,
) -> ScanToScanState:
    """Initial state: identity pose, empty previous features."""
    e_cap = feat_params.edge_capacity(lidar)
    p_cap = feat_params.planar_capacity(lidar)
    empty = FeatureSet(
        edge_points=jnp.zeros((e_cap, 3), dtype),
        edge_mask=jnp.zeros((e_cap,), bool),
        edge_indices=jnp.full((e_cap,), -1, jnp.int32),
        planar_points=jnp.zeros((p_cap, 3), dtype),
        planar_mask=jnp.zeros((p_cap,), bool),
        planar_indices=jnp.full((p_cap,), -1, jnp.int32),
    )
    return ScanToScanState(
        world_T_current=Pose3.identity(dtype),
        prev_features=empty,
        prev_delta=Pose3.identity(dtype),
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "lidar", "feat_params", "reg_params", "use_motion_prior", "dewarp"
    ),
)
def scan_to_scan_step(
    state: ScanToScanState,
    scan: jax.Array,
    lidar: LidarParams,
    feat_params: FeatureExtractionParams = FeatureExtractionParams(),
    reg_params: RegistrationParams = RegistrationParams(),
    use_motion_prior: bool = True,
    dewarp: bool = False,
) -> Tuple[ScanToScanState, Pose3, RegistrationDetail]:
    """Process one scan; returns (new_state, world_T_current, detail).

    ``dewarp=True`` motion-compensates the sweep with the previous relative
    pose (constant-velocity) before extraction.
    """
    if dewarp:
        scan = dewarp_scan(scan, state.prev_delta, lidar)
    feats = extract_features(scan, lidar, feat_params)
    dtype = feats.edge_points.dtype
    init = state.prev_delta if use_motion_prior else Pose3.identity(dtype)
    # prev_T_current: current scan is the source, previous scan the target.
    delta, detail = _register(
        feats, state.prev_features, init, reg_params, with_matches=False
    )
    world = state.world_T_current.compose(delta).normalize()
    return (
        ScanToScanState(
            world_T_current=world, prev_features=feats, prev_delta=delta
        ),
        world,
        detail,
    )
