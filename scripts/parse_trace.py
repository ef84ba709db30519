"""Self-time analysis of a JAX profiler trace (Chrome trace format).

Usage:
    python scripts/parse_trace.py /path/to/plugins/profile/<run>/  # dir or
    python scripts/parse_trace.py trace.json[.gz] [--top 40] [--by source]

Finds the device "XLA Ops" track and computes SELF time per op (duration
minus child durations via a stack walk over the time-sorted events), then
aggregates by op name, HLO category, or source (file:line from event args).
Standalone microbenchmarks of fusible ops are misleading (they miss the
fusions of the real program) — rank costs from a trace of the real
pipeline.

Capture a trace:
    import jax
    jax.profiler.start_trace("/tmp/traces")
    ...run the jitted workload once (post-warmup)...
    jax.profiler.stop_trace()
"""

import argparse
import collections
import gzip
import json
import os
import sys


def load_events(path):
    """Load trace events from a .json/.json.gz file or a profile dir."""
    if os.path.isdir(path):
        hits = []
        for root, _dirs, files in os.walk(path):
            for f in files:
                if f.endswith(".trace.json.gz") or f.endswith(".trace.json"):
                    hits.append(os.path.join(root, f))
        if not hits:
            sys.exit(f"no *.trace.json[.gz] under {path}")
        path = max(hits, key=os.path.getmtime)
        print(f"# {path}", file=sys.stderr)
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rt") as f:
        return json.load(f)["traceEvents"]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("trace")
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--by", choices=["name", "source", "category"],
                    default="name")
    ap.add_argument("--track", default="XLA Ops",
                    help="substring of the thread name to analyze")
    args = ap.parse_args()

    events = load_events(args.trace)

    # map (pid, tid) -> thread name; find the device XLA Ops tracks
    tnames = {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "thread_name":
            tnames[(e["pid"], e["tid"])] = e["args"]["name"]
    tracks = {k for k, v in tnames.items() if args.track in v}
    if not tracks:
        opts = sorted(set(tnames.values()))
        sys.exit(f"no thread matching {args.track!r}; tracks: {opts}")

    per_key = collections.defaultdict(lambda: [0.0, 0])  # self_us, count
    total_busy = 0.0
    for track in tracks:
        evs = [
            e for e in events
            if e.get("ph") == "X" and (e["pid"], e["tid"]) == track
        ]
        evs.sort(key=lambda e: (e["ts"], -e.get("dur", 0)))
        stack = []  # (end_ts, key, child_dur_accum)
        for e in evs:
            ts, dur = e["ts"], e.get("dur", 0)
            while stack and stack[-1][0] <= ts:
                stack.pop()
            a = e.get("args", {})
            if args.by == "source":
                key = a.get("source", a.get("tf_op", e["name"]))
            elif args.by == "category":
                key = a.get("hlo_category", e["name"].split(".")[0])
            else:
                key = e["name"]
            if stack:
                stack[-1][2][0] += dur  # child time of the parent
            else:
                total_busy += dur
            rec = per_key[key]
            child = [0.0]
            stack.append((ts + dur, key, child))
            rec[1] += 1
            rec[0] += dur
            # subtract children lazily: store the accumulator; resolved on pop
            e["_child"] = child
        # second pass: subtract child time
        for e in evs:
            a = e.get("args", {})
            if args.by == "source":
                key = a.get("source", a.get("tf_op", e["name"]))
            elif args.by == "category":
                key = a.get("hlo_category", e["name"].split(".")[0])
            else:
                key = e["name"]
            per_key[key][0] -= e["_child"][0]

    rows = sorted(per_key.items(), key=lambda kv: -kv[1][0])
    print(f"{'self ms':>10} {'count':>7}  key   (device busy "
          f"{total_busy/1e3:.2f} ms)")
    for key, (self_us, count) in rows[: args.top]:
        print(f"{self_us/1e3:10.3f} {count:7d}  {key}")


if __name__ == "__main__":
    main()
