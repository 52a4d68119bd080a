#!/usr/bin/env python3
"""Two trees of the port on one card, in turns: the measured windows of
TopologySpreading/5000Nodes_5000Pods and SchedulingBasic/5000Nodes_10000Pods
(bench.build_cluster, warm, measure) for a parent tree and this one.

    git archive <parent commit> | tar -x -C <dir>   # into an ignored directory
    python3 ab_windows.py <dir> [rounds] [--freeze]

Each round runs parent, change, change, parent, each side in a process of
its own started in its tree, and prints one `AB {...}` JSON line a run:
pods/s, session end, host commit, device wait and the window's seconds.
The last line gives each side's median pods/s and interquartile range.
With --freeze, each side moves everything alive after its warm-up out of
the garbage collector's reach (gc.freeze): a window of a few hundred ms
then no longer reads whether a full collection happened to land in it."""

import json
import os
import statistics
import subprocess
import sys

WORKLOADS = ("TopologySpreading/5000Nodes_5000Pods", "SchedulingBasic/5000Nodes_10000Pods")

ONE_SIDE = """
import gc, json, sys
sys.path.insert(0, ".")
from kubernetes_tpu_torch import bench
out = {}
for w in %r:
    spec = bench.WORKLOADS[w]
    s = bench.build_cluster(5000, node=spec.node)
    bench.warm(s, spec.init_pods, w)
    if "--freeze" in sys.argv:
        gc.collect()
        gc.freeze()
    r = bench.measure(s, spec.measure_pods, workload=w)
    d = r["detail"]
    out[w] = dict(pods_s=r["value"], session_end_s=d["session_end_s"],
                  host_commit_s=d["host_commit_s"], device_wait_s=d["device_wait_s"],
                  elapsed_s=d["elapsed_s"])
print(json.dumps(out))
""" % (WORKLOADS,)


def run_side(tree: str, freeze: bool) -> dict:
    out = subprocess.run([sys.executable, "-c", ONE_SIDE] + (["--freeze"] if freeze else []),
                         cwd=tree, capture_output=True, text=True, timeout=900)
    if out.returncode != 0:
        raise SystemExit(f"{tree}: exit {out.returncode}\n{out.stderr[-2000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> int:
    args = [a for a in sys.argv[1:] if a != "--freeze"]
    freeze = len(args) < len(sys.argv) - 1
    if not args:
        print(__doc__, file=sys.stderr)
        return 2
    trees = {"parent": args[0], "change": os.path.dirname(os.path.abspath(__file__))}
    rounds = int(args[1]) if len(args) > 1 else 3
    pods = {(side, w): [] for side in trees for w in WORKLOADS}
    for _ in range(rounds):
        for side in ("parent", "change", "change", "parent"):
            res = run_side(trees[side], freeze)
            for w in WORKLOADS:
                pods[(side, w)].append(res[w]["pods_s"])
            print("AB " + json.dumps({"tree": side, **res}), flush=True)
    summary = {}
    for (side, w), v in pods.items():
        q = statistics.quantiles(v, n=4) if len(v) > 1 else [v[0]] * 3
        summary[f"{side} {w}"] = dict(median=statistics.median(v), iqr=(q[0], q[2]), runs=len(v))
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
