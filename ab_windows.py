#!/usr/bin/env python3
"""Two trees of the port on one card, in turns: the measured windows of
bench workloads (bench.build_cluster at the workload's node count and
profile, warm, measure) for a parent tree and this one; by default
TopologySpreading/5000Nodes_5000Pods and SchedulingBasic/5000Nodes_10000Pods.

    git archive <parent commit> | tar -x -C <dir>   # into an ignored directory
    python3 ab_windows.py <dir> [rounds] [--freeze] [--workloads W1,W2] [--calls] [--shards S]
    python3 ab_windows.py <dir> [rounds] --scan
    python3 ab_windows.py <dir> [rounds] --gates
    python3 ab_windows.py <dir> [rounds] --patches

Each round runs parent, change, change, parent, each side in a process of
its own started in its tree, and prints one `AB {...}` JSON line a run:
pods/s, session end, host commit, device wait, kernel enqueue (dispatch),
the window's seconds, the sharded-lap dispatches, and the garbage
collector's seconds and full (generation 2) collections in the window
(gc.callbacks), and the placement evaluations' count and seconds. With --shards S, each side builds its clusters under a
node mesh of S shards on the one card (make_mesh(devices=[cuda:0] * S)).
The last line gives each side's median pods/s and interquartile range.
With --freeze, each side moves everything alive after its warm-up out of
the garbage collector's reach (gc.freeze): a window of a few hundred ms
then no longer reads whether a full collection happened to land in it.
With --calls, each side instead runs once with its window under cProfile
and prints one `CALLS {...}` line: for each of the framework's per-pod and
per-node hooks (HOOKS), its calls and cumulative seconds in the window
(seconds inflated by the profiler; compare sides, not windows).

With --scan, the two trees' kernels of the scan path instead (the
reference's scan step for a row-local plan of at most 64 steps): this
tree's chip_smoke.scan_path_inputs gathers every input of that path once
(build/scan_inputs.pt), then each side, in the same turns, runs the
kernel its own tree routes each input to (scan_schedule where the tree has
it, else scan_general) and prints one `SCAN {...}` line a run: per input
the kernel, its device ms a launch (torch.profiler), its call ms (CUDA
events) and a digest of the results and carry. The last line gives, per
input, each side's median device ms and whether every run's digest was
the same.

With --patches, the two halves of a row patch, whole: this tree's
chip_smoke.patch_inputs_ab gathers once (build/patches_inputs.pt) the
preempting case's mirror with the flushes' rows (its rows per flush, the
placement drive's, 64 and 2048) and the wave drive's carry patches (one a
tier); each side then times its own tree's flush (NodeStateMirror.
_scatter_dirty) and carry call (NodeStateMirror.patch_carry, or the
scheduler's inline code in a tree that predates it) with this tree's
chip_smoke.whole_patch_cost: host ms a call and the device ms of every op
a call issues, summed, from torch.profiler (two traces that saw every
launch must agree, else CUDA events time the calls: device_timing). One
`PATCHES {...}` line a run; the last line gives, per input, each side's
medians, the ratios, each side's device_timing and whether every digest
agreed.

With --gates, the same for dry_run_preemption and static_masks:
chip_smoke.gate_inputs gathers their timed inputs once
(build/gate_inputs.pt: the dry runs of Unschedulable's churn pod and of a
preemptor after the preempting case, seeded draws, static_masks on those
clusters' pods and on seeded draws), each side runs its own tree's kernel
on every input and prints one `GATES {...}` line a run, and the last line
gives the medians, the ratio and whether every digest agreed."""

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

shards = int(sys.argv[sys.argv.index("--shards") + 1]) if "--shards" in sys.argv else 0
mesh = {}
if shards:
    import torch
    from kubernetes_tpu_torch.parallel import make_mesh
    mesh = dict(mesh=make_mesh(devices=[torch.device("cuda", 0)] * shards))

for w in sys.argv[1].split(","):
    spec = bench.WORKLOADS[w]
    s = bench.build_cluster(bench.NODES.get(w, 5000), node=spec.node,
                            profile_factory=bench.profile_for(w), **mesh)
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
                  dispatch_s=d["dispatch_s"], elapsed_s=d["elapsed_s"],
                  shard_map_dispatches=d["shard_map_dispatches"], gc_s=gcw["s"],
                  gc_full=gcw["full"], placement_device_evals=d.get("placement_device_evals"),
                  placement_eval_s=d.get("placement_eval_s"))
    if prof is not None:
        prof.disable()
        hooks = {}
        for (path, _line, name), (_cc, nc, _tt, ct, _callers) in pstats.Stats(prof).stats.items():
            if name in %r and "kubernetes_tpu_torch" in path:
                hooks[name] = [nc, ct]
        out[w]["calls"] = hooks
print(json.dumps(out))
""" % (HOOKS,)


GATHER = """
import sys
sys.path.insert(0, ".")
import torch
import chip_smoke
torch.save(chip_smoke.scan_path_inputs(torch.device("cuda", 0)), sys.argv[1])
print("{}")
"""

SCAN_SIDE = """
import hashlib, json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke
from kubernetes_tpu_torch.ops import kernel as K
from kubernetes_tpu_torch.ops.device_state import DeviceNodeState
from kubernetes_tpu_torch.ops.features import BatchFeatures

dev = torch.device("cuda", 0)
out = {}
for name, e in torch.load(sys.argv[1]).items():
    st = DeviceNodeState(*[t.to(dev) for t in e["state"]])
    ft = BatchFeatures(*[t.to(dev) for t in e["feats"]])
    facts = K.PlanFacts(**e["facts"])
    strat, B, n = e["strat"], e["B"], e["n_act"]
    masks = K.static_masks(st, ft)
    if e["carry"] is not None:
        ext0 = K.ScanCarry(*[t.to(dev) for t in e["carry"]])
    else:
        ext0 = K.fresh_carry(st, ft, e["vmax"], K.resource_eval(
            ft, strat, st.alloc_r, st.alloc_pods, st.req_r, st.nonzero, st.pod_count,
            *K._nom_lane(ft)))
    # Only a tree from before scan_schedule's removal still has it: this
    # branch serves the comparison with such a parent and nothing else.
    if K.plan_path(ft, facts, B) == "scan" and hasattr(K, "scan_schedule"):
        kname = "scan_schedule"
        fn = lambda: K.scan_schedule(st, ft, B, strat, ext0, masks.static_ok, n,
                                     facts.port_selfblock, facts.has_aux)
    else:
        kname = "scan_general"
        fn = lambda: K.scan_general(st, ft, B, strat, ext0, masks, n, facts)
    o, c = fn()
    h = hashlib.sha256()
    for t in (o,) + tuple(c):
        h.update(t.to(torch.int64).cpu().numpy().tobytes())
    ms, seen = chip_smoke.device_ms(fn, kname)
    out[name] = dict(kernel=kname, device_ms=ms, launches_seen=seen,
                     call_ms=chip_smoke.wall_ms(fn, reps=20), digest=h.hexdigest()[:16],
                     placed=int((o[0] >= 0).sum()), steps=B, pods=n, rows=int(st.valid.shape[0]))
print(json.dumps(out))
"""


GATHER_GATES = """
import sys
sys.path.insert(0, ".")
import torch
import chip_smoke
torch.save(chip_smoke.gate_inputs(torch.device("cuda", 0)), sys.argv[1])
print("{}")
"""

GATES_SIDE = """
import hashlib, json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke
from kubernetes_tpu_torch.ops import kernel as K
from kubernetes_tpu_torch.ops.device_state import DeviceNodeState
from kubernetes_tpu_torch.ops.features import BatchFeatures

dev = torch.device("cuda", 0)
out = {}
for name, e in torch.load(sys.argv[1]).items():
    st = DeviceNodeState(*[t.to(dev) for t in e["state"]])
    ft = BatchFeatures(*[t.to(dev) for t in e["feats"]])
    if e["kind"] == "dry":
        kname = "dry_run_preemption"
        vr, vv = e["vic_req"].to(dev), e["vic_valid"].to(dev)
        fn = lambda: (K.dry_run_preemption(st, ft, vr, vv, e["k"]),)
    else:
        kname = "static_masks"
        fn = lambda: tuple(K.static_masks(st, ft))
    h = hashlib.sha256()
    for t in fn():
        h.update(t.to(torch.int64).cpu().numpy().tobytes())
    ms, seen = chip_smoke.device_ms(fn, kname)
    out[name] = dict(kernel=kname, device_ms=ms, launches_seen=seen,
                     call_ms=chip_smoke.wall_ms(fn, reps=20), digest=h.hexdigest()[:16])
print(json.dumps(out))
"""


GATHER_PATCHES = """
import sys
sys.path.insert(0, ".")
import torch
import chip_smoke
torch.save(chip_smoke.patch_inputs_ab(torch.device("cuda", 0)), sys.argv[1])
print("{}")
"""

PATCHES_SIDE = """
import hashlib, importlib.util, json, sys
sys.path.insert(0, ".")
import torch
from kubernetes_tpu_torch.ops import kernel as K
from kubernetes_tpu_torch.ops.device_state import DeviceNodeState, NodeStateMirror, patch_tier
from kubernetes_tpu_torch.ops.features import BatchFeatures

# The measurement is the changed tree's, whichever tree is timed.
path = sys.path[:]
spec = importlib.util.spec_from_file_location("smoke", sys.argv[2])
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
sys.path[:] = path
dev = torch.device("cuda", 0)
e = torch.load(sys.argv[1])
np_cap, t_cap, s_cap, k_cap = e["caps"]


def mirror():
    m = NodeStateMirror(dev, node_capacity=np_cap, taint_capacity=t_cap,
                        scalar_capacity=s_cap, axis_capacity=k_cap)
    for name, t in zip(smoke.MIRROR_FIELDS, e["mirror"]):
        getattr(m, name)[...] = t.numpy()
    m._device = m._upload()
    m._full_flush = False
    return m


def digest(ts):
    h = hashlib.sha256()
    for t in ts:
        h.update(t.to(torch.int64).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def inline_carry(m, state, f, carry, rows, strat):
    # The carry call of TorchScheduler._apply_delta_patch in a tree whose
    # mirror has no patch_carry.
    prows = rows + [rows[-1]] * (patch_tier(len(rows)) - len(rows))
    return K.patch_carry_rows(state, f, carry, torch.tensor(prows, dtype=torch.int32).to(dev),
                              torch.from_numpy(m.h_req_r[prows]).to(dev),
                              torch.from_numpy(m.h_nonzero[prows]).to(dev),
                              torch.from_numpy(m.h_pod_count[prows]).to(dev), strat)


out = {}
m = mirror()
for name, rows in e["flushes"].items():
    fn = lambda r=rows: m._scatter_dirty(r)
    out["flush: " + name] = dict(kernel="whole flush", rows=len(rows), digest=digest(fn()),
                                 **smoke.whole_patch_cost(fn, "scatter_rows"))
cm = mirror()
cm.h_req_r, cm.h_nonzero, cm.h_pod_count = [t.numpy() for t in e["carry_mirror"]]
for name, c in e["carries"].items():
    state = DeviceNodeState(*[t.to(dev) for t in c["state"]])
    f = BatchFeatures(*[t.to(dev) for t in c["feats"]])
    carry = K.ScanCarry(*[t.to(dev) for t in c["carry"]])
    rows, strat = c["rows"], c["strat"]
    if hasattr(cm, "patch_carry"):
        fn = lambda: cm.patch_carry(state, f, carry, rows, strat)
    else:
        fn = lambda: inline_carry(cm, state, f, carry, rows, strat)
    out["carry: " + name] = dict(kernel="whole carry patch", rows=len(rows),
                                 digest=digest(fn()[:6]),
                                 **smoke.whole_patch_cost(fn, "patch_carry_rows"))
print(json.dumps(out))
"""


def run_side(tree: str, workloads, flags, script=ONE_SIDE) -> dict:
    out = subprocess.run([sys.executable, "-c", script, ",".join(workloads)] + flags,
                         cwd=tree, capture_output=True, text=True, timeout=900)
    if out.returncode != 0:
        raise SystemExit(f"{tree}: exit {out.returncode}\n{out.stderr[-2000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def kernels_main(trees: dict, rounds: int, what: str, gather: str, side: str,
                 keys=("device_ms", "call_ms"), flags=()) -> int:
    """The --scan, --gates and --patches modes: one tree's kernels (or
    patches) against the other's on the same gathered inputs, in turns.
    The summary gives, per input and tree, the kernel and the median, min
    and max of each of `keys`, and each key's change / parent ratio."""
    inputs = os.path.join(trees["change"], "build", f"{what}_inputs.pt")
    os.makedirs(os.path.dirname(inputs), exist_ok=True)
    run_side(trees["change"], [inputs], [], script=gather)
    vals, digests, kernels, timing = {}, {}, {}, {}
    for _ in range(rounds):
        for tree in ("parent", "change", "change", "parent"):
            res = run_side(trees[tree], [inputs], list(flags), script=side)
            for name, r in res.items():
                for k in keys:
                    vals.setdefault((tree, name, k), []).append(r[k])
                digests.setdefault(name, set()).add(r["digest"])
                kernels[(tree, name)] = r["kernel"]
                if "device_timing" in r:
                    timing.setdefault(name, {}).setdefault(tree, set()).add(r["device_timing"])
            print(f"{what.upper()} " + json.dumps({"tree": tree, **res}), flush=True)
    summary = {}
    for name, seen in digests.items():
        summary[name] = {tree: [kernels[(tree, name)]] + [
            [statistics.median(v), min(v), max(v)] for v in
            (vals[(tree, name, k)] for k in keys)] for tree in ("parent", "change")}
        for k in keys:
            p, c = (statistics.median(vals[(tree, name, k)]) for tree in ("parent", "change"))
            summary[name][f"{k}_change_over_parent"] = c / p
        summary[name]["exact"] = len(seen) == 1
        if name in timing:  # "profiler" on both sides, or the device ratio mixes two clocks
            summary[name]["device_timing"] = {t: sorted(v) for t, v in timing[name].items()}
    print(json.dumps(summary), flush=True)
    return 0


def main() -> int:
    args = sys.argv[1:]
    flags = [a for a in ("--freeze", "--calls") if a in args]
    workloads = DEFAULT_WORKLOADS
    if "--workloads" in args:
        i = args.index("--workloads")
        workloads = tuple(args[i + 1].split(","))
        del args[i:i + 2]
    if "--shards" in args:
        i = args.index("--shards")
        flags += args[i:i + 2]
        del args[i:i + 2]
    scan, gates, patches = "--scan" in args, "--gates" in args, "--patches" in args
    args = [a for a in args if a not in ("--freeze", "--calls", "--scan", "--gates", "--patches")]
    if not args:
        print(__doc__, file=sys.stderr)
        return 2
    trees = {"parent": args[0], "change": os.path.dirname(os.path.abspath(__file__))}
    rounds = int(args[1]) if len(args) > 1 else 3
    if scan:
        return kernels_main(trees, rounds, "scan", GATHER, SCAN_SIDE)
    if gates:
        return kernels_main(trees, rounds, "gates", GATHER_GATES, GATES_SIDE)
    if patches:
        return kernels_main(trees, rounds, "patches", GATHER_PATCHES, PATCHES_SIDE,
                            keys=("host_ms", "device_sum_ms", "device_ops"),
                            flags=[os.path.join(trees["change"], "chip_smoke.py")])
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
