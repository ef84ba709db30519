"""Checkpoint round-trip tests for the stateful odometry layers."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from loam_jax import checkpoint, scan_to_map_init, scan_to_map_step, LidarParams
from loam_jax.io import render_trajectory


def test_roundtrip_scan_to_map_state(tmp_path):
    lidar = LidarParams(8, 128, 0.5, 80.0)
    scans, _ = render_trajectory(lidar, 2, noise=0.003, seed=4, dtype=np.float32)
    state = scan_to_map_init()
    state, pose, _ = scan_to_map_step(state, jnp.asarray(scans[0]), lidar)
    state, pose, _ = scan_to_map_step(state, jnp.asarray(scans[1]), lidar)

    p = str(tmp_path / "state.npz")
    checkpoint.save(p, state)
    restored = checkpoint.load(p, scan_to_map_init())

    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(restored)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # restored state continues stepping
    state2, pose2, _ = scan_to_map_step(restored, jnp.asarray(scans[1]), lidar)
    assert bool(jnp.isfinite(pose2.translation).all())


def test_schema_mismatch_rejected(tmp_path):
    p = str(tmp_path / "x.npz")
    checkpoint.save(p, {"a": jnp.zeros(3)})
    with pytest.raises(ValueError):
        checkpoint.load(p, {"a": jnp.zeros(3), "b": jnp.zeros(2)})
