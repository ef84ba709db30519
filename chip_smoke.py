"""Smoke test of loam-jax on an NVIDIA GPU, through the public API.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --ab          # ... plus the A/B timings of phase 7
    python chip_smoke.py --four-cards  # four cards: the sharded paths only

One card, at the full 64x1024 (Ouster-64) width with random (seeded)
synthetic scans:

  1. device      platform, kind, count; persistent compile cache
  2. extraction  ``extract_features`` (one scan) and
                 ``extract_features_batch`` (vmap, 8 frames) vs the f64
                 NumPy oracle: exact index-sequence equality
  3. knn         the compiled GPU kNN kernel vs ``_knn_xla`` and
                 ``knn_oracle`` at the planar (19,584 x 19,584) and edge
                 (4,224 x 4,224) widths, k=5, default radii
  4. scan2scan   ``odometry_offline`` over 64 frames, ATE-gated, plus one
                 registered pair vs its known pose (1e-4 rad, 1e-3 m)
  5. scan2map    ``scan_to_map_offline`` over the same 64 frames, ATE-gated
  6. streaming   ``odometry_streaming`` over 32 ``.bin`` files written into
                 the checkout (native loader, packed codec, async upload)
  7. timings     steady-state time of each phase, the kNN kernel vs XLA,
                 and the extraction stages; with ``--ab`` also the kernel vs
                 XLA end to end in phase 4 and the map search backends

Each phase prints one line with its wall time. Any failure raises, and the
script exits non-zero; it never falls back to the CPU. The line before the
last names the card and its power limit (``nvidia-smi``, run in a child
process that stays off JAX); the last line is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np

#: Tolerances, each with its reason.
#: kNN distances: kernel and XLA both compute f32 direct differences, but
#: the GPU compilers may contract multiply-adds into FMAs differently, so
#: squared distances may differ in the last bits; at |d| <= 2 m that is
#: below 1e-6 m.
KNN_DIST_ATOL = 1e-5
#: kNN vs the f64 oracle: f32 rounding of coordinates up to ~30 m.
KNN_ORACLE_ATOL = 1e-4
#: Registration round trip: the reference's own test tolerances
#: (``test_registration.cpp:83-86``).
ROT_TOL, TRANS_TOL = 1e-4, 1e-3
#: Sharded vs one-card results: the same math, reduced in another order
#: across cards (f32 translation over a 5 m path).
SHARD_ATOL = 1e-4

FRAMES = 64


def card_info() -> str:
    """``name, power.limit`` of the card, from a child process (no JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def phase(name, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    info = out[1] if isinstance(out, tuple) else ""
    print(f"[{name}] ok {time.perf_counter() - t0:.2f} s {info}", flush=True)
    return out[0] if isinstance(out, tuple) else out


def steady(fn, n=3):
    """Median wall seconds of ``n`` calls after one warm-up, each ending in
    ``block_until_ready``."""
    import jax

    jax.block_until_ready(fn())
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


# ---------------------------------------------------------------------------
# one-card phases
# ---------------------------------------------------------------------------


def bench_trajectory(lidar, frames):
    from loam_jax.io import render_trajectory

    return render_trajectory(
        lidar, frames, step=np.array([0.08, 0.02, 0.0]), yaw_rate=0.01,
        noise=0.005, seed=0, dtype=np.float32,
    )


def check_ate(traj, poses):
    """The benchmark's gate: ATE below 5% of the path (min 5 cm)."""
    from loam_jax.evaluation import ate_rmse

    est = np.asarray(traj.translation)
    assert np.isfinite(est).all(), "non-finite trajectory"
    gt = np.stack([t for (_, t) in poses])
    path = float(np.sum(np.linalg.norm(np.diff(gt, axis=0), axis=-1)))
    ate = ate_rmse(est, gt, align=False)
    limit = max(0.05 * path, 0.05)
    assert ate < limit, f"ATE {ate:.4f} m over {limit:.4f} m"
    return ate


def extraction_phase(lidar, scans, batch):
    import jax
    import jax.numpy as jnp

    from loam_jax import extract_features
    from loam_jax.features import extract_features_batch
    from loam_jax.oracle import oracle
    from loam_jax.params import FeatureExtractionParams

    params = FeatureExtractionParams(precise_selection=True)
    want = [oracle.extract_features(s.astype(np.float64), lidar, params)
            for s in scans[:batch]]

    def picks(idx):
        return [int(i) for i in np.asarray(idx) if i >= 0]

    def check(fs, f, what):
        e, p = picks(fs.edge_indices), picks(fs.planar_indices)
        assert e == list(want[f][0]) and p == list(want[f][1]), (
            f"{what} frame {f}: {len(e)}/{len(want[f][0])} edges, "
            f"{len(p)}/{len(want[f][1])} planars differ from the f64 oracle"
        )

    one = jnp.asarray(scans[0])
    check(extract_features(one, lidar, params), 0, "single")
    many = jnp.asarray(scans[:batch])
    fb = jax.block_until_ready(extract_features_batch(many, lidar, params))
    for f in range(batch):
        check(jax.tree.map(lambda x: x[f], fb), f, "vmap")
    n_e, n_p = len(want[0][0]), len(want[0][1])
    return None, (f"single + vmap x{batch} equal the f64 oracle "
                  f"({n_e} edges, {n_p} planars in frame 0)")


def compare_knn(name, got, want, q, t, m, k, radius):
    """Kernel result vs reference: masks equal (up to distances within
    tolerance of the radius), distances within KNN_DIST_ATOL, indices equal
    except among candidates whose distances tie within that tolerance."""
    gm, wm = np.asarray(got.mask), np.asarray(want.mask)
    gd = np.where(gm, np.asarray(got.distances), np.inf)
    wd = np.where(wm, np.asarray(want.distances), np.inf)
    gi, wi = np.asarray(got.indices), np.asarray(want.indices)
    qn, tn = np.asarray(q, np.float64), np.asarray(t, np.float64)
    dm = gm != wm
    if dm.any():
        near = np.abs(np.where(gm, gd, wd) - radius) <= KNN_DIST_ATOL
        assert near[dm].all(), f"{name}: {int(dm.sum())} mask mismatches"
    both = gm & wm
    assert np.abs(gd[both] - wd[both]).max(initial=0) <= KNN_DIST_ATOL, (
        f"{name}: distances differ by {np.abs(gd[both] - wd[both]).max()}"
    )
    di = both & (gi != wi)
    if di.any():
        r, c = np.nonzero(di)
        d_got = np.linalg.norm(tn[gi[r, c]] - qn[r], axis=-1)
        d_want = np.linalg.norm(tn[wi[r, c]] - qn[r], axis=-1)
        assert np.abs(d_got - d_want).max() <= KNN_DIST_ATOL, (
            f"{name}: {int(di.sum())} index mismatches are not ties"
        )
    return int(di.sum())


def knn_phase(f0, f1):
    import jax

    from loam_jax.neighbors import knn, knn_oracle
    from loam_jax.neighbors.bruteforce import _knn_xla, knn_backend
    from loam_jax.ops.knn_gpu import knn_triton

    assert knn_backend() == "triton", "the GPU must run the kernel"
    cases = _knn_cases(f0, f1)
    notes = []
    for name, q, t, m, k, r in cases:
        compiled = jax.jit(
            lambda q, t, m: knn_triton(q, t, m, k, r)
        ).lower(q, t, m).compile()
        print(f"  {name} kernel memory_analysis: {compiled.memory_analysis()}",
              flush=True)
        got = knn(q, t, m, k, r)
        ties = compare_knn(name, got, _knn_xla(q, t, m, k, r), q, t, m, k, r)
        oi, od, om = knn_oracle(np.asarray(q), np.asarray(t), np.asarray(m),
                                k, r)
        gm = np.asarray(got.mask)
        assert (gm == om).all(), f"{name}: mask differs from the f64 oracle"
        err = np.abs(np.asarray(got.distances)[gm] - od[om]).max(initial=0)
        assert err <= KNN_ORACLE_ATOL, f"{name}: {err} m from the f64 oracle"
        notes.append(f"{name} {q.shape[0]}x{t.shape[0]} k={k}: "
                     f"{int(gm.sum())} neighbors, {ties} tie swaps vs XLA")
    return None, "; ".join(notes)


def pair_phase(lidar):
    """Register the features of a noise-free scan against a copy moved by a
    known pose (a frame-to-frame motion of the bench trajectory), iterating
    to convergence well below the tolerances. Noise-free, as in the
    reference's test: with sensor noise the k-neighbor fits are biased at
    the millimetre level, so the known pose is no longer the optimum."""
    import jax.numpy as jnp

    from loam_jax import Pose3, RegistrationParams, extract_features
    from loam_jax import register_features
    from loam_jax.features import FeatureSet
    from loam_jax.geometry import quat_from_axis_angle
    from loam_jax.io import render_scan

    f0 = extract_features(
        jnp.asarray(render_scan(lidar, noise=0.0, seed=0, dtype=np.float32)),
        lidar,
    )

    truth = Pose3(quat_from_axis_angle(jnp.asarray([0.0, 0.0, 1.0]), 0.01),
                  jnp.asarray([0.08, 0.02, 0.0], jnp.float32))
    src = FeatureSet(truth.act(f0.edge_points), f0.edge_mask, f0.edge_indices,
                     truth.act(f0.planar_points), f0.planar_mask,
                     f0.planar_indices)
    reg = RegistrationParams(max_iterations=30,
                             rotation_convergence_thresh=1e-6,
                             position_convergence_thresh=1e-6)
    est, _ = register_features(src, f0, params=reg, with_matches=False)
    # est = target_T_source = truth^-1: truth o est ~ identity
    err = truth.compose(est)
    qe = np.asarray(err.rotation, np.float64)
    ang = 2 * np.arctan2(np.linalg.norm(qe[1:]), abs(qe[0]))
    tr = float(np.linalg.norm(np.asarray(err.translation)))
    assert ang < ROT_TOL and tr < TRANS_TOL, (
        f"pair round trip: {ang:.2e} rad, {tr:.2e} m"
    )
    return f"pair round trip {ang:.1e} rad, {tr:.1e} m"


def scan_to_scan_phase(lidar, scans, poses):
    import jax
    import jax.numpy as jnp

    from loam_jax import odometry_offline

    js = jnp.asarray(scans)
    traj, _ = odometry_offline(js, lidar, chunk_pairs=4, motion_init=True)
    ate = check_ate(jax.block_until_ready(traj), poses)
    return ate


def scan_to_map_phase(lidar, scans, poses, reg=None):
    import jax
    import jax.numpy as jnp

    from loam_jax import scan_to_map_offline

    _, traj, _ = scan_to_map_offline(jnp.asarray(scans), lidar,
                                     reg_params=reg)
    return check_ate(jax.block_until_ready(traj), poses)


def streaming_phase(lidar, scans, poses, n=32):
    from loam_jax import odometry_streaming
    from loam_jax.io.native import native_available

    assert native_available(), "the native IO library did not build"
    root = os.path.join(ROOT, ".smoke_scans")
    os.makedirs(root, exist_ok=True)
    try:
        paths = []
        for i, scan in enumerate(scans[:n]):
            pts = scan.reshape(-1, 3).astype(np.float32)
            p = os.path.join(root, f"{i:06d}.bin")
            np.concatenate([pts, np.zeros((len(pts), 1), np.float32)], 1
                           ).tofile(p)
            paths.append(p)
        run = lambda: odometry_streaming(paths, lidar, chunk_frames=16)[0]
        ate = check_ate(run(), poses[:n])
        secs = steady(run, n=2)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return (ate, secs), (f"native loader: {native_available()}, {n} files, "
                         f"ATE {ate:.4f} m")


def stage_times(lidar, scans):
    """Steady-state time of each extraction stage, each jitted alone over
    the frame batch (so it pays the HBM round trips the fused program
    avoids), beside the whole batched extraction."""
    import jax
    import jax.numpy as jnp

    from loam_jax.features import extract as ex
    from loam_jax.features.curvature import (
        compute_curvature_df, compute_valid_points_df,
    )
    from loam_jax.params import FeatureExtractionParams

    p = FeatureExtractionParams()
    s = jnp.asarray(scans)
    v = jax.vmap
    curv = jax.jit(v(lambda x: (compute_curvature_df(x, lidar, p),
                                compute_valid_points_df(x, lidar, p))))
    (hi, lo), valid = curv(s)
    cand = jax.jit(v(lambda h, l: ex._candidates(h, l, lidar, p)))
    ce, cp = cand(hi, lo)
    nms = jax.jit(v(lambda va, a, b: ex._greedy_nms(va, a, b, lidar, p)))
    ep, pp = nms(valid, ce, cp)
    cat = jnp.concatenate([ep.reshape(ep.shape[0], lidar.scan_lines, -1),
                           pp.reshape(pp.shape[0], lidar.scan_lines, -1)], -1)
    sel = jax.jit(v(ex.select_points))
    whole = jax.jit(lambda x: ex.extract_features_batch(x, lidar, p))
    return {
        "extract_total": steady(lambda: whole(s)),
        "curvature_validity": steady(lambda: curv(s)),
        "sector_sort": steady(lambda: cand(hi, lo)),
        "greedy_nms": steady(lambda: nms(valid, ce, cp)),
        "assemble": steady(lambda: sel(s, cat)),
    }


def _knn_cases(f0, f1):
    from loam_jax.params import RegistrationParams

    reg = RegistrationParams()
    return (
        ("planar", f1.planar_points, f0.planar_points, f0.planar_mask,
         reg.num_plane_neighbors, reg.max_plane_neighbor_dist),
        ("edge", f1.edge_points, f0.edge_points, f0.edge_mask,
         reg.num_edge_neighbors, reg.max_edge_neighbor_dist),
    )


def knn_alone(f0, f1):
    """The kNN kernel vs XLA's plain form, alone, at both widths."""
    from loam_jax.neighbors.bruteforce import _knn_xla
    from loam_jax.ops.knn_gpu import knn_triton

    out = {}
    for name, q, t, m, k, r in _knn_cases(f0, f1):
        out[f"knn_{name}_kernel"] = steady(
            lambda: knn_triton(q, t, m, k, r), n=10)
        out[f"knn_{name}_xla"] = steady(lambda: _knn_xla(q, t, m, k, r), n=10)
    return out


def knn_e2e(lidar, scans):
    """The kNN kernel vs XLA's plain form end to end in
    ``odometry_offline`` (phase 4), in turns kernel, XLA, XLA, kernel."""
    import jax
    import jax.numpy as jnp

    from loam_jax import odometry_offline
    from loam_jax.neighbors import bruteforce

    js = jnp.asarray(scans)
    real = bruteforce.knn_backend
    runs = {}

    def e2e(backend):
        bruteforce.knn_backend = lambda: backend
        jax.clear_caches()
        try:
            return steady(lambda: odometry_offline(
                js, lidar, chunk_pairs=4, motion_init=True)[0])
        finally:
            bruteforce.knn_backend = real

    for backend in ("triton", "xla", "xla", "triton"):
        runs.setdefault(backend, []).append(e2e(backend))
    jax.clear_caches()
    return {"scan2scan_e2e_kernel": float(np.mean(runs["triton"])),
            "scan2scan_e2e_xla": float(np.mean(runs["xla"]))}


def map_backends(lidar, scans, poses):
    """Scan-to-map with the voxel-grid search (the default) vs brute force
    over the whole map (the GPU kernel) at the default map capacities."""
    import dataclasses

    import jax.numpy as jnp

    from loam_jax import scan_to_map_offline
    from loam_jax.odometry import default_map_reg_params

    js = jnp.asarray(scans)
    out = {}
    for backend in ("grid", "bruteforce"):
        reg = dataclasses.replace(default_map_reg_params(),
                                  search_backend=backend)
        ate = scan_to_map_phase(lidar, scans, poses, reg)
        secs = steady(lambda: scan_to_map_offline(js, lidar,
                                                  reg_params=reg)[1])
        out[f"scan2map_{backend}"] = secs
        out[f"scan2map_{backend}_ate_m"] = ate
    return out


def one_card(ab: bool):
    import jax
    import jax.numpy as jnp

    from loam_jax import LidarParams, extract_features, odometry_offline

    lidar = LidarParams(64, 1024, 0.5, 120.0)
    scans, poses = bench_trajectory(lidar, FRAMES)
    phase("extraction", extraction_phase, lidar, scans, 8)
    f0 = extract_features(jnp.asarray(scans[0]), lidar)
    f1 = extract_features(jnp.asarray(scans[1]), lidar)
    phase("knn", knn_phase, f0, f1)
    ate = phase("scan2scan", lambda: (
        scan_to_scan_phase(lidar, scans, poses),
        pair_phase(lidar)))
    print(f"  scan2scan ATE {ate:.4f} m over {FRAMES} frames", flush=True)
    ate = phase("scan2map", lambda: (scan_to_map_phase(lidar, scans, poses),
                                     ""))
    print(f"  scan2map ATE {ate:.4f} m over {FRAMES} frames", flush=True)
    _, stream_s = phase("streaming", streaming_phase, lidar, scans, poses)

    def timings():
        js = jnp.asarray(scans)
        t = {
            "scan2scan_64": steady(lambda: odometry_offline(
                js, lidar, chunk_pairs=4, motion_init=True)[0]),
            "streaming_32": stream_s,
        }
        t.update(stage_times(lidar, scans[:FRAMES]))
        t.update(knn_alone(f0, f1))
        if ab:
            t.update(knn_e2e(lidar, scans))
            t.update(map_backends(lidar, scans, poses))
        for key, val in t.items():
            unit = "m" if key.endswith("_ate_m") else "ms"
            scale = 1.0 if unit == "m" else 1e3
            print(f"  {key:28s} {val * scale:10.3f} {unit}", flush=True)
        return t, ""

    phase("timings", timings)


# ---------------------------------------------------------------------------
# four-card phases: each sharded path beside its one-card result
# ---------------------------------------------------------------------------


def four_cards():
    import jax
    import jax.numpy as jnp

    from loam_jax import (
        LidarParams, odometry_offline, scan_to_map_init, scan_to_map_step,
    )
    from loam_jax.odometry.scan_to_map import ScanToMapConfig
    from loam_jax.parallel import make_mesh, odometry_offline_sharded
    from loam_jax.parallel.distributed import (
        scan_to_map_init_sharded, scan_to_map_step_sharded,
    )
    from loam_jax.params import RegistrationParams
    from loam_jax.pose_graph import (
        odometry_edges, optimize_pose_graph, optimize_pose_graph_sharded,
    )

    assert len(jax.devices()) == 4, "--four-cards needs four devices"
    lidar = LidarParams(64, 1024, 0.5, 120.0)
    frames = 16
    scans, poses = bench_trajectory(lidar, frames)
    js = jnp.asarray(scans)
    mesh = make_mesh(jax.devices(), line_axis=1)

    def offline():
        one, _ = odometry_offline(js, lidar)
        four, _ = odometry_offline_sharded(js, lidar, mesh)
        d = np.abs(np.asarray(four.translation) - np.asarray(one.translation))
        assert d.max() <= SHARD_ATOL, f"sharded odometry differs by {d.max()}"
        check_ate(four, poses)
        t1 = steady(lambda: odometry_offline(js, lidar)[0])
        t4 = steady(lambda: odometry_offline_sharded(js, lidar, mesh)[0])
        return None, (f"{frames} frames: max |4 - 1| {d.max():.1e} m; "
                      f"1 card {t1 * 1e3:.1f} ms, 4 cards {t4 * 1e3:.1f} ms")

    def scan_to_map():
        config = ScanToMapConfig()
        reg = RegistrationParams(prior_weight=300.0)
        mesh1 = jax.sharding.Mesh(np.asarray(jax.devices()), ("data",))
        s4 = scan_to_map_init_sharded(config, mesh1)
        s1 = scan_to_map_init(config)
        worst = 0.0
        n = 6
        t0 = time.perf_counter()
        for f in range(n):
            s4, p4, _ = scan_to_map_step_sharded(
                s4, js[f], lidar, mesh1, reg_params=reg, config=config)
            s1, p1, _ = scan_to_map_step(
                s1, js[f], lidar, reg_params=reg, config=config)
            worst = max(worst, float(np.abs(np.asarray(p4.translation)
                                            - np.asarray(p1.translation)).max()))
        assert worst <= SHARD_ATOL, f"sharded scan-to-map differs by {worst}"
        n4 = int(np.asarray(s4.planar_map.mask).sum())
        n1 = int(np.asarray(s1.planar_map.mask).sum())
        assert n4 == n1, f"sharded planar map holds {n4} points, one card {n1}"
        return None, (f"{n} frames at default capacities: max |4 - 1| "
                      f"{worst:.1e} m, planar map {n4} = {n1} points, "
                      f"{time.perf_counter() - t0:.1f} s")

    def pose_graph():
        traj = jax.tree.map(lambda x: x[:16], odometry_offline(js, lidar)[0])
        edges = odometry_edges(traj)
        E = edges.i.shape[0]
        pad = (-E) % 4
        edges = jax.tree.map(
            lambda x: jnp.concatenate([x, jnp.repeat(x[:1], pad, 0)]), edges
        )._replace(
            mask=jnp.concatenate([jnp.ones(E, bool), jnp.zeros(pad, bool)]))
        one, c1 = optimize_pose_graph(traj, edges, iterations=3)
        four, c4 = optimize_pose_graph_sharded(traj, edges, mesh, iterations=3)
        d = np.abs(np.asarray(four.translation) - np.asarray(one.translation))
        assert d.max() <= SHARD_ATOL, f"sharded pose graph differs by {d.max()}"
        return None, f"{traj.translation.shape[0]} nodes: max |4 - 1| {d.max():.1e} m"

    phase("offline_sharded", offline)
    phase("scan2map_sharded", scan_to_map)
    phase("pose_graph_sharded", pose_graph)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the cross-card paths, on four GPUs")
    ap.add_argument("--ab", action="store_true",
                    help="also time kNN kernel vs XLA end to end and the "
                         "map search backends")
    args = ap.parse_args()

    import jax

    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        sys.exit(f"chip_smoke.py needs an NVIDIA GPU; JAX found "
                 f"{dev.platform!r} ({dev.device_kind})")
    from loam_jax.profiling import enable_compile_cache

    cache = enable_compile_cache()
    print(f"[device] {dev.platform} {dev.device_kind} x{len(devices)}; "
          f"compile cache {cache}", flush=True)
    if args.four_cards:
        four_cards()
    else:
        one_card(args.ab)
    print(card_info(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}), flush=True)


if __name__ == "__main__":
    main()
