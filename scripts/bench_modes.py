"""Run every bench mode, one after another, and collect their JSON lines.

Each mode runs ``bench.py`` in its own subprocess, in turn, so only one
process holds the GPU at a time; this parent process never imports JAX.

Usage: python scripts/bench_modes.py [out.json]   (default: chiprun_out/bench_modes.json)
"""

import json
import os
import subprocess
import sys

MODES = ["scan_to_scan", "batched_pairs", "scan_to_map", "dataset"]


def main():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        root, "chiprun_out", "bench_modes.json"
    )
    out = {}
    for mode in MODES:
        env = dict(os.environ, LOAM_BENCH_MODE=mode)
        r = subprocess.run(
            [sys.executable, os.path.join(root, "bench.py")],
            env=env, capture_output=True, text=True,
        )
        lines = [l for l in r.stdout.splitlines() if l.startswith("{")]
        out[mode] = json.loads(lines[-1]) if r.returncode == 0 and lines else {
            "error": f"rc={r.returncode}", "stderr": r.stderr[-400:],
        }
        print(f"{mode}: {json.dumps(out[mode])}", flush=True)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {path}")
    if any("error" in v for v in out.values()):
        raise SystemExit("some modes failed")


if __name__ == "__main__":
    main()
