"""Batched offline odometry: the data-parallel form of the odometry loop.

The reference's loop is inherently serial (``README.md:44-60``). On an
accelerator the whole trajectory parallelizes (BASELINE config 4):

  1. feature extraction ``vmap``-ed over all frames at once,
  2. every consecutive (source, target) pair registered in one batched
     lockstep solve (``register_features_batch``),
  3. relative poses composed into world poses with
     ``lax.associative_scan`` — log-depth on device, not a host loop.

This is also the multi-chip unit of work: shard the frame axis over a mesh
and steps 1-2 are embarrassingly parallel (see ``loam_jax.parallel``).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..features import extract_features_batch
from ..geometry import Pose3, pose_cumcompose
from ..params import FeatureExtractionParams, LidarParams, RegistrationParams
from ..registration import RegistrationDetail
from ..registration.icf import _register


@functools.partial(
    jax.jit,
    static_argnames=(
        "lidar", "feat_params", "reg_params", "chunk_pairs", "motion_init"
    ),
)
def odometry_offline(
    scans: jax.Array,
    lidar: LidarParams,
    feat_params: FeatureExtractionParams = FeatureExtractionParams(),
    reg_params: RegistrationParams = RegistrationParams(),
    chunk_pairs: int = 1,
    motion_init: bool = False,
) -> Tuple[Pose3, RegistrationDetail]:
    """Whole-trajectory scan-to-scan odometry in one compiled program.

    Args:
      scans: (F, L, P, 3) or (F, L*P, 3) stacked scans.
      chunk_pairs: pairs registered per lockstep batch. Pairs are split into
        ``ceil((F-1)/chunk_pairs)`` chunks driven by ``lax.map``/``lax.scan``,
        so the compiled program size is constant in F (one chunk's
        registration graph) while arbitrarily long trajectories run in ONE
        dispatch. ``chunk_pairs <= 0`` restores the fully-unrolled
        single-vmap form. Default 1: per-pair early termination of the ICF
        while_loop; larger chunks trade it for lockstep batching.
      motion_init: initialize every pair in chunk ``c`` with the last
        converged relative pose of chunk ``c-1`` (a constant-velocity motion
        prior, as the streaming ``scan_to_scan_step`` uses). Near-constant-
        twist trajectories then enter ICF much closer to the optimum and
        converge in fewer outer iterations — a pure throughput win with the
        same converged poses (up to the convergence tolerance). Requires
        chunking (ignored in the single-batch form, where pairs run
        concurrently with no carry).

    Returns:
      (trajectory, details): ``trajectory`` is a Pose3 with (F, ...) leaves —
      ``world_T_frame_i`` with frame 0 at identity; ``details`` stacks the
      per-pair RegistrationDetail for the F-1 registrations.
    """
    F = scans.shape[0]
    feats = extract_features_batch(scans, lidar, feat_params)
    dtype = feats.edge_points.dtype

    src = jax.tree.map(lambda x: x[1:], feats)
    tgt = jax.tree.map(lambda x: x[:-1], feats)
    n_pairs = F - 1

    def reg_batch(s, t, i):
        return jax.vmap(
            lambda s_, t_, i_: _register(
                s_, t_, i_, reg_params, with_matches=False
            )
        )(s, t, i)

    if chunk_pairs <= 0 or n_pairs <= chunk_pairs:
        init = Pose3.identity(dtype, (n_pairs,))
        rel, details = reg_batch(src, tgt, init)
    else:
        C = chunk_pairs
        nc = -(-n_pairs // C)
        pad = nc * C - n_pairs
        # pad with copies of pair 0 (cheap, always registrable); padded
        # results are sliced away below
        def pad_chunk(x):
            x = jnp.concatenate([x, jnp.repeat(x[:1], pad, axis=0)], axis=0)
            return x.reshape((nc, C) + x.shape[1:])

        src_c = jax.tree.map(pad_chunk, src)
        tgt_c = jax.tree.map(pad_chunk, tgt)

        def chunk_step(carry_delta, chunk):
            s, t = chunk
            if motion_init:
                init = jax.tree.map(
                    lambda x: jnp.broadcast_to(x, (C,) + x.shape), carry_delta
                )
            else:
                init = Pose3.identity(dtype, (C,))
            rel, det = reg_batch(s, t, init)
            new_carry = jax.tree.map(lambda x: x[-1], rel)
            return new_carry, (rel, det)

        _, (rel_c, det_c) = lax.scan(
            chunk_step, Pose3.identity(dtype), (src_c, tgt_c)
        )
        unchunk = lambda x: x.reshape((nc * C,) + x.shape[2:])[:n_pairs]
        rel = jax.tree.map(unchunk, rel_c)
        details = jax.tree.map(unchunk, det_c)
    # rel[i] = frame_i_T_frame_{i+1}; prefix-compose into world poses
    world = pose_cumcompose(rel)
    trajectory = Pose3(
        jnp.concatenate(
            [Pose3.identity(dtype, (1,)).rotation, world.rotation]
        ),
        jnp.concatenate(
            [Pose3.identity(dtype, (1,)).translation, world.translation]
        ),
    )
    return trajectory, details
