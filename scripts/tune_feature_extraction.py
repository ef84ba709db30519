"""Feature-extraction parameter tuning tool.

Parity with the reference's Open3D GUI (``scripts/tune_feature_extraction.py``
in the reference: sliders for every extraction/LiDAR parameter, live
re-extraction, edges orange / planars blue / raw black) — built on matplotlib
so it runs in this stack, with a headless mode for remote boxes:

  interactive:  python scripts/tune_feature_extraction.py --scan scan.pcd
  3-D view:     python scripts/tune_feature_extraction.py --view 3d
  single shot:  python scripts/tune_feature_extraction.py --out view.png
  param sweep:  python scripts/tune_feature_extraction.py \
                    --sweep edge_feat_threshold=10:500:6 --out sweep.png

``--view 3d`` renders the point cloud in a rotatable matplotlib 3-D axes
(the reference viewer is 3-D Open3D, reference script :60-70) with the
same sliders and colors; ``--view 2d`` (default) is the top-down
projection, which stays snappier for 64x1024 scans.

Scans: .pcd / .bin (KITTI) via the native IO runtime, .npy ((L,P,3) or
(L*P,3)), or a synthetic room scan when no file is given.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

RAW_COLOR = "#202020"
EDGE_COLOR = "#ff8800"  # orange, as the reference viewer
PLANAR_COLOR = "#2255dd"  # blue


def load_scan(args):
    from loam_jax import LidarParams
    from loam_jax.io import project_range_image, read_kitti_bin, read_pcd
    from loam_jax.io import render_scan

    lidar = LidarParams(args.scan_lines, args.points_per_line, args.min_range,
                        args.max_range)
    if args.scan is None:
        return render_scan(lidar, noise=0.005, seed=0, dtype=np.float32), lidar
    if args.scan.endswith(".npy"):
        arr = np.load(args.scan).astype(np.float32)
        if arr.ndim == 2:
            arr = arr.reshape(args.scan_lines, args.points_per_line, 3)
        return arr, lidar
    pts = (read_pcd(args.scan) if args.scan.endswith(".pcd")
           else read_kitti_bin(args.scan))
    return (
        project_range_image(pts, args.scan_lines, args.points_per_line),
        lidar,
    )


def extract(scan, lidar, params):
    import jax.numpy as jnp
    from loam_jax import extract_features

    fs = extract_features(jnp.asarray(scan), lidar, params)
    edge, planar = fs.compact()
    return edge, planar


def draw(ax, scan, edge, planar, title="", view="2d"):
    raw = scan.reshape(-1, 3)
    r = np.linalg.norm(raw, axis=1)
    raw = raw[(r > 0.1) & (r < 200)]
    if view == "3d":
        if len(raw) > 60000:  # keep the 3-D canvas interactive
            raw = raw[:: len(raw) // 60000 + 1]
        ax.scatter(raw[:, 0], raw[:, 1], raw[:, 2], s=0.3, c=RAW_COLOR,
                   alpha=0.25, lw=0)
        if len(planar):
            ax.scatter(planar[:, 0], planar[:, 1], planar[:, 2], s=2.5,
                       c=PLANAR_COLOR, lw=0, label=f"planar ({len(planar)})")
        if len(edge):
            ax.scatter(edge[:, 0], edge[:, 1], edge[:, 2], s=8,
                       c=EDGE_COLOR, lw=0, label=f"edge ({len(edge)})")
        # equal data aspect so vertical structure reads true
        spans = raw.max(axis=0) - raw.min(axis=0)
        ax.set_box_aspect(tuple(np.maximum(spans, 1e-3)))
    else:
        ax.scatter(raw[:, 0], raw[:, 1], s=0.3, c=RAW_COLOR, alpha=0.25, lw=0)
        if len(planar):
            ax.scatter(planar[:, 0], planar[:, 1], s=2.5, c=PLANAR_COLOR,
                       lw=0, label=f"planar ({len(planar)})")
        if len(edge):
            ax.scatter(edge[:, 0], edge[:, 1], s=6, c=EDGE_COLOR, lw=0,
                       label=f"edge ({len(edge)})")
        ax.set_aspect("equal")
    ax.legend(loc="upper right", fontsize=7)
    ax.set_title(title, fontsize=9)


PARAM_RANGES = {
    "neighbor_points": (1, 8, int),
    "number_sectors": (1, 12, int),
    "max_edge_feats_per_sector": (1, 40, int),
    "max_planar_feats_per_sector": (1, 120, int),
    "edge_feat_threshold": (1.0, 1000.0, float),
    "planar_feat_threshold": (0.01, 10.0, float),
    "occlusion_thresh": (0.05, 2.0, float),
    "parallel_thresh": (0.05, 4.0, float),
}


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scan", default=None, help=".pcd/.bin/.npy scan file")
    ap.add_argument("--scan-lines", type=int, default=16)
    ap.add_argument("--points-per-line", type=int, default=512)
    ap.add_argument("--min-range", type=float, default=0.5)
    ap.add_argument("--max-range", type=float, default=80.0)
    ap.add_argument("--out", default=None, help="write PNG instead of GUI")
    ap.add_argument("--view", choices=("2d", "3d"), default="2d",
                    help="top-down projection or rotatable 3-D scatter")
    ap.add_argument("--sweep", default=None, help="param=lo:hi:n sweep grid")
    for name, (lo, hi, typ) in PARAM_RANGES.items():
        ap.add_argument(f"--{name.replace('_', '-')}", type=typ, default=None)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import matplotlib

    if args.out:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from loam_jax import FeatureExtractionParams

    scan, lidar = load_scan(args)
    overrides = {
        k: v
        for k in PARAM_RANGES
        if (v := getattr(args, k)) is not None
    }
    base = FeatureExtractionParams(**overrides)

    if args.sweep:
        name, rng = args.sweep.split("=")
        lo, hi, n = rng.split(":")
        typ = PARAM_RANGES[name][2]
        values = np.linspace(float(lo), float(hi), int(n))
        if typ is int:
            values = sorted(set(int(round(v)) for v in values))
        cols = min(3, len(values))
        rows = -(-len(values) // cols)
        sub = {"projection": "3d"} if args.view == "3d" else {}
        fig, axes = plt.subplots(rows, cols, figsize=(6 * cols, 6 * rows),
                                 subplot_kw=sub)
        axes = np.atleast_1d(axes).ravel()
        for ax, v in zip(axes, values):
            p = FeatureExtractionParams(**{**overrides, name: typ(v)})
            edge, planar = extract(scan, lidar, p)
            draw(ax, scan, edge, planar, f"{name} = {typ(v)}", args.view)
        for ax in axes[len(values):]:
            ax.axis("off")
        fig.tight_layout()
        fig.savefig(args.out or "sweep.png", dpi=130)
        print(f"wrote {args.out or 'sweep.png'}")
        return

    if args.out:
        edge, planar = extract(scan, lidar, base)
        sub = {"projection": "3d"} if args.view == "3d" else {}
        fig, ax = plt.subplots(figsize=(9, 9), subplot_kw=sub)
        draw(ax, scan, edge, planar,
             f"{lidar.scan_lines}x{lidar.points_per_line} scan", args.view)
        fig.tight_layout()
        fig.savefig(args.out, dpi=130)
        print(f"wrote {args.out}")
        return

    # ---- interactive: sliders for every extraction parameter ---------------
    from matplotlib.widgets import Slider, TextBox

    fig = plt.figure(figsize=(13, 9))
    if args.view == "3d":
        ax = fig.add_axes([0.02, 0.05, 0.64, 0.92], projection="3d")
    else:
        ax = fig.add_axes([0.05, 0.08, 0.6, 0.88])
    sliders = {}
    y = 0.90
    state = dict(overrides)

    def refresh(_=None):
        # error surface parity with the reference GUI's error dialog
        # (reference tune_feature_extraction.py:244-257): a bad parameter
        # combination or unreadable scan shows the message in-figure
        # instead of killing the tool
        try:
            p = FeatureExtractionParams(
                **{k: PARAM_RANGES[k][2](v) for k, v in state.items()}
            )
            edge, planar = extract(scan, lidar, p)
        except Exception as e:
            ax.clear()
            ax.set_title(f"ERROR: {type(e).__name__}: {e}", fontsize=8,
                         color="red")
            fig.canvas.draw_idle()
            return
        ax.clear()
        draw(ax, scan, edge, planar,
             f"{lidar.scan_lines}x{lidar.points_per_line} scan", args.view)
        fig.canvas.draw_idle()

    def load_path(text):
        # in-GUI scan loading (parity with the reference viewer's file
        # dialog, reference script :187-193): type a .pcd/.bin/.npy path
        # and press enter
        nonlocal scan, lidar
        text = text.strip()
        if not text:
            return
        try:
            args.scan = text
            scan, lidar = load_scan(args)
        except Exception as e:
            ax.clear()
            ax.set_title(f"ERROR loading {text}: {e}", fontsize=8,
                         color="red")
            fig.canvas.draw_idle()
            return
        refresh()

    defaults = FeatureExtractionParams()
    for name, (lo, hi, typ) in PARAM_RANGES.items():
        sax = fig.add_axes([0.72, y, 0.22, 0.03])
        init = state.get(name, getattr(defaults, name))
        s = Slider(sax, name, lo, hi, valinit=init,
                   valstep=1 if typ is int else None)
        state[name] = init

        def _cb(val, name=name, typ=typ):
            state[name] = typ(val)
            refresh()

        s.on_changed(_cb)
        sliders[name] = s
        y -= 0.055

    box_ax = fig.add_axes([0.72, y - 0.01, 0.22, 0.04])
    file_box = TextBox(box_ax, "scan file", initial=args.scan or "")
    file_box.on_submit(load_path)

    refresh()
    plt.show()


if __name__ == "__main__":
    main()
