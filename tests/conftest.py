"""Test configuration: run everything on a virtual 8-device CPU mesh with
float64 enabled (the reference is all-double; parity tests need f64; the
sharding tests need multiple devices).

Tests run on the CPU: ``JAX_PLATFORMS=cpu python -m pytest tests/``. The
platform is pinned through ``jax.config`` below (to ``JAX_PLATFORMS``, CPU
when unset), before any backend is initialized. Tests that need an NVIDIA
GPU carry the ``gpu`` marker and skip elsewhere; on the card run
``JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu -p no:xdist``, and
``python chip_smoke.py`` for the end-to-end check.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", True)

import pytest

# Tests measured >= 5 s on the 4-core CPU test runner (durations survey,
# round 3). `pytest -m "not slow"` is the fast pre-commit gate (~2 min,
# 100+ tests covering every module); the slow set is the deep tiers —
# oracle bit-parity, SPMD equality, whole-trajectory drivers, kernel
# equality twins — run in CI / before benchmarking. Keep entries in sync
# when renaming tests: unmatched entries are reported at collection time.
_SLOW = {
    "test_associate_oracle.py::test_edge_association_guards_match_oracle",
    "test_checkpoint.py::test_roundtrip_scan_to_map_state",
    "test_compat.py::test_readme_flow",
    "test_debug.py::test_registration_guards_scrub_poisoned_point",
    "test_dewarp.py::test_dewarp_improves_registration",
    "test_edge_cases.py::test_all_points_out_of_range",
    "test_edge_cases.py::test_flat_and_grid_inputs_agree",
    "test_features.py::TestOracleParity::test_extraction_matches_oracle_big_noiseless",
    "test_features.py::TestOracleParity::test_f32_full_scale_oracle_parity",
    "test_features.py::TestOracleParity::test_f32_selection_bit_faithful_to_f64",
    "test_features.py::TestOracleParity::test_feature_points_match_indices",
    "test_features.py::TestOracleParity::test_full_extraction_matches_oracle[default-0]",
    "test_icf_oracle.py::test_icf_loop_matches_oracle_converged",
    "test_loop_closure.py::test_end_to_end_loop_closure",
    "test_loop_closure.py::test_wrong_minimum_closure_rejected",
    "test_multiprocess.py::test_multiprocess_pose_graph_parity",
    "test_multiprocess.py::test_multiprocess_scan_to_map_parity",
    "test_odometry.py::test_offline_chunked_matches_unchunked",
    "test_odometry.py::test_offline_matches_streaming",
    "test_odometry.py::test_scan_to_map",
    "test_odometry.py::test_scan_to_map_offline_matches_streaming",
    "test_odometry.py::test_scan_to_scan",
    "test_parallel.py::test_sharded_extraction_matches_single",
    "test_parallel.py::test_sharded_odometry_2d_mesh",
    "test_parallel.py::test_sharded_odometry_matches_single",
    "test_parallel.py::test_sharded_registration_matches_single",
    "test_parallel.py::test_sharded_scan_to_map_matches_single",
    "test_parallel.py::test_sharded_voxel_map_matches_single",
    "test_pose_graph.py::test_loop_closure_corrects_drift",
    "test_pose_graph.py::test_masked_edges_ignored",
    "test_pose_graph.py::test_recovers_exact_graph",
    "test_pose_graph.py::test_sharded_solve_matches_single",
    "test_reference_diff.py::test_reference_matches_on_full_ouster_geometry",
    "test_reference_diff.py::test_reference_matches_oracle_and_pipeline[lidar0-params0-6]",
    "test_registration.py::test_batched_matches_single",
    "test_registration.py::test_grid_overflow_surfaces_in_detail",
    "test_registration.py::test_plane_avg_dist_guard_is_inert",
    "test_registration.py::test_simple_case",
    "test_adversarial_scenes.py::test_far_planes_f32",
    "test_adversarial_scenes.py::test_single_wall_is_bounded",
    "test_adversarial_scenes.py::test_single_wall_with_prior_pins_null_directions",
    "test_dataset_e2e.py::test_file_fed_odometry",
    "test_edge_cases.py::test_huge_thresholds_everything_planar",
    "test_features.py::TestOracleParity::test_full_extraction_matches_oracle[alt-0]",
    "test_icf_oracle.py::test_icf_loop_matches_oracle_insufficient",
    "test_icf_oracle.py::test_icf_loop_matches_oracle_max_iter",
    "test_debug.py::test_registration_tap_fires_on_poisoned_state",
    "test_edge_cases.py::test_register_empty_source",
    "test_adversarial_scenes.py::test_exactly_min_associations_boundary",
    "test_adversarial_scenes.py::test_minimal_line_fit_points_no_nans",
    "test_dataset_e2e.py::test_loader_matches_direct_projection",
    # streaming tier (full-driver compiles; the fast gate keeps the codec
    # tests + one cheap streaming e2e)
    "test_streaming.py::test_streaming_matches_offline_unpacked",
    "test_streaming.py::test_streaming_files_packed_ate",
    "test_streaming.py::test_streaming_packed_array_source",
    "test_streaming.py::test_streaming_chunk_tail_padding",
    "test_streaming.py::test_streaming_push_api_matches_batch",
    "test_streaming.py::test_streaming_dewarp_runs",
}


def pytest_collection_modifyitems(config, items):
    seen = set()
    for item in items:
        key = item.nodeid.split("tests/")[-1]
        if key in _SLOW:
            item.add_marker(pytest.mark.slow)
            seen.add(key)
