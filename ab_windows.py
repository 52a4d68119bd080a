#!/usr/bin/env python3
"""Two trees of the port on one card, in turns: the measured windows of
bench workloads (bench.build_cluster at the workload's node count and
profile, warm, measure) for a parent tree and this one; by default
TopologySpreading/5000Nodes_5000Pods and SchedulingBasic/5000Nodes_10000Pods.

    git archive <parent commit> | tar -x -C <dir>   # into an ignored directory
    python3 ab_windows.py <dir> [rounds] [--freeze] [--workloads W1,W2] [--calls]

Each round runs parent, change, change, parent, each side in a process of
its own started in its tree, and prints one `AB {...}` JSON line a run:
pods/s, session end, host commit, device wait, the window's seconds, and
the garbage collector's seconds and full (generation 2) collections in
the window (gc.callbacks).
The last line gives each side's median pods/s and interquartile range.
With --freeze, each side moves everything alive after its warm-up out of
the garbage collector's reach (gc.freeze): a window of a few hundred ms
then no longer reads whether a full collection happened to land in it.
With --calls, each side instead runs once with its window under cProfile
and prints one `CALLS {...}` line: for each of the framework's per-pod and
per-node hooks (HOOKS), its calls and cumulative seconds in the window
(seconds inflated by the profiler; compare sides, not windows)."""

import json
import os
import statistics
import subprocess
import sys

DEFAULT_WORKLOADS = ("TopologySpreading/5000Nodes_5000Pods",
                     "SchedulingBasic/5000Nodes_10000Pods")
HOOKS = ("run_pre_filter_plugins", "run_filter_plugins", "run_reserve_plugins_reserve",
         "run_pre_bind_pre_flight", "run_binding_cycle", "_commit", "_commit_group_member",
         "_collect_session_batch", "_evaluate_placements")

ONE_SIDE = """
import cProfile, gc, json, pstats, sys, time
sys.path.insert(0, ".")
from kubernetes_tpu_torch import bench
out = {}
calls = "--calls" in sys.argv
gcw = dict(s=0.0, full=0, t0=0.0)

def on_gc(phase, info):
    if phase == "start":
        gcw["t0"] = time.perf_counter()
    else:
        gcw["s"] += time.perf_counter() - gcw["t0"]
        gcw["full"] += info["generation"] == 2

for w in sys.argv[1].split(","):
    spec = bench.WORKLOADS[w]
    s = bench.build_cluster(bench.NODES.get(w, 5000), node=spec.node,
                            profile_factory=bench.profile_for(w))
    bench.warm(s, spec.init_pods, w)
    if "--freeze" in sys.argv:
        gc.collect()
        gc.freeze()
    prof = cProfile.Profile() if calls else None
    if prof is not None:
        prof.enable()
    gcw.update(s=0.0, full=0)
    gc.callbacks.append(on_gc)
    r = bench.measure(s, spec.measure_pods, workload=w)
    gc.callbacks.remove(on_gc)
    d = r["detail"]
    out[w] = dict(pods_s=r["value"], session_end_s=d["session_end_s"],
                  host_commit_s=d["host_commit_s"], device_wait_s=d["device_wait_s"],
                  elapsed_s=d["elapsed_s"], gc_s=gcw["s"], gc_full=gcw["full"])
    if prof is not None:
        prof.disable()
        hooks = {}
        for (path, _line, name), (_cc, nc, _tt, ct, _callers) in pstats.Stats(prof).stats.items():
            if name in %r and "kubernetes_tpu_torch" in path:
                hooks[name] = [nc, ct]
        out[w]["calls"] = hooks
print(json.dumps(out))
""" % (HOOKS,)


def run_side(tree: str, workloads, flags) -> dict:
    out = subprocess.run([sys.executable, "-c", ONE_SIDE, ",".join(workloads)] + flags,
                         cwd=tree, capture_output=True, text=True, timeout=900)
    if out.returncode != 0:
        raise SystemExit(f"{tree}: exit {out.returncode}\n{out.stderr[-2000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> int:
    args = sys.argv[1:]
    flags = [a for a in ("--freeze", "--calls") if a in args]
    workloads = DEFAULT_WORKLOADS
    if "--workloads" in args:
        i = args.index("--workloads")
        workloads = tuple(args[i + 1].split(","))
        del args[i:i + 2]
    args = [a for a in args if a not in flags]
    if not args:
        print(__doc__, file=sys.stderr)
        return 2
    trees = {"parent": args[0], "change": os.path.dirname(os.path.abspath(__file__))}
    rounds = int(args[1]) if len(args) > 1 else 3
    if "--calls" in flags:
        for side in ("parent", "change"):
            print("CALLS " + json.dumps({"tree": side, **run_side(trees[side], workloads, flags)}),
                  flush=True)
        return 0
    pods = {(side, w): [] for side in trees for w in workloads}
    for _ in range(rounds):
        for side in ("parent", "change", "change", "parent"):
            res = run_side(trees[side], workloads, flags)
            for w in workloads:
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
