#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (kubernetes_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order; any error or mismatch exits non-zero before the result:
  1. build   — compile the five CUDA kernels from csrc/ (one nvcc each, in
               parallel, linked into one library) and print the build
               seconds;
  2. kernels — hold each kernel against its plain PyTorch version on the
               card, on seeded inputs at the main paths' shapes (the
               5000-node mirror's padded capacity, R = 7, T = 4, B = 1024
               for the lap and 64 for the scans): for the fit-only kernels
               the cases rotation start past rows, truncation on and off,
               zero-request pods and all-infeasible rows; for scan_general
               six draws with count tables (spread DoNotSchedule and
               ScheduleAnyway, required anti-affinity and affinity with the
               bootstrap case, landing deltas, PreferNoSchedule, base and
               preferred-node-affinity scores, each on and off; incremental
               and full feasibility; carried and normalized scores) at the
               zone tier V = 64 and the hostname tier V = 8192, B = 1024
               and 64; and the lap with hostname anti-affinity lanes. Both
               fit strategies, fresh and chained carries. Results must be
               exactly equal on every output and carry lane. It also times
               scan_general's first launch in the process against the next;
  3. paths   — each through TorchScheduler on cuda at full width (5000
               nodes of 32 cpu / 256Gi / 110 pods across 50 zones), the
               launch counts zeroed just before each drive and read just
               after:
               TopologySpreading/5000Nodes_5000Pods, the main path (1000
               warm pods, then 5000 pods under a hard zone spread): every
               pod bound, zone skew of the spread pods <= 1, no host-path
               pod, scan_general launched;
               SchedulingBasic/5000Nodes_10000Pods (1024 warm-up pods,
               10000 measured): every pod bound, the lap launched, and a
               small-batch drive (max_batch 64: 40 pods) that must launch
               scan_schedule;
               PreferredTopologySpreading/5000Nodes_5000Pods: every pod
               bound;
               SchedulingPodAntiAffinity/5000Nodes_2000Pods: every pod
               bound, at most one per node, the lap (anti lanes) launched;
               SchedulingPodAffinity/5000Nodes_5000Pods: every pod bound,
               all in one zone;
  4. timing  — on the main paths' own next-batch inputs (exactness checked
               there too): each kernel's device time per launch from
               torch.profiler, its wrapper's wall time per call (host work
               included) and its plain version's, from CUDA events, beside
               the least time the card could take; scan_general on
               scan_schedule's own inputs (it must agree exactly); and the
               mirror's dirty-row scatter (index_copy_, a library call);
  5. parity  — a 500-node cluster with NoSchedule and PreferNoSchedule
               taints, unschedulable nodes, node selectors, pods that fit no
               node, zone and hostname spread, required and preferred
               (anti-)affinity and preferred node affinity: the cuda run's
               assignments and failure counts must equal the port's
               device="cpu" run (the plain versions, which the repository's
               tests hold equal to the JAX package), at max_batch 1024 and
               64; and TopologySpreading's first measured batch (1024 pods
               after the 1000 warm pods) at the full 5000 nodes — cut from
               the 5000 measured pods so that the CPU run stays short;
  6. output  — a `{"kernels": [...]}` line, the card's name and power limit
               as nvidia-smi prints them, and last
               `{"ok": true, "device": {...}}`.

It imports neither jax nor kubernetes_tpu. With no CUDA device, or without
the rest of the repository beside it, it exits non-zero with no result.
"""

import json
import os
import random
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (NVIDIA data sheet)
PEAK_OPS_PER_S = 67e12      # H100 SXM fp32 rate outside the tensor cores; the
                            # integer ALU rate is no higher, so ops/this rate
                            # stays a lower bound on the time


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi unavailable"


def wall_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean time per call of `fn` between two CUDA events: what a caller
    waits, the host's work between launches included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def device_ms(fn, kernel: str, reps: int = 20) -> float:
    """Mean device time of one launch of the `<kernel>_kernel` that `fn`
    launches, from torch.profiler's CUDA kernel events: the kernel alone,
    without the host work of its wrapper."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == DeviceType.CUDA and f"{kernel}_kernel" in e.name]
    check(len(spans) == reps, f"the profiler saw {len(spans)} of {reps} {kernel} launches")
    return sum(spans) / reps / 1e3


def max_abs_err(a, b) -> int:
    """Largest absolute difference over two equal-shaped tensor tuples."""
    err = 0
    for x, y in zip(a, b):
        check(x.shape == y.shape and x.dtype == y.dtype,
              f"shape/dtype mismatch {x.shape} {x.dtype} vs {y.shape} {y.dtype}")
        if x.numel():
            err = max(err, int((x.to(torch.int64) - y.to(torch.int64)).abs().max()))
    return err


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def compare(K, st, ft, strategies=(0, 1)) -> dict:
    """Largest kernel-vs-plain difference of each fit-only kernel on one
    input, over the fit strategies, fresh and chained through the carry."""
    errs = {}
    for strat in strategies:
        m_k, m_p = K.static_masks(st, ft), K._static_masks_plain(st, ft)
        errs["static_masks"] = max(errs.get("static_masks", 0), max_abs_err(m_k, m_p))
        r_args = (ft, strat, st.alloc_r, st.alloc_pods, st.req_r, st.nonzero, st.pod_count)
        r_k, r_p = K.resource_eval(*r_args), K._resource_eval_plain(*r_args)
        errs["resource_eval"] = max(errs.get("resource_eval", 0), max_abs_err(r_k, r_p))
        ext0 = K.fresh_carry(st, ft, ft.dns_counts.shape[1], r_p)
        for name, B, wrap, plain in (("lap_schedule", 1024, K.lap_schedule, K._lap_schedule_plain),
                                     ("scan_schedule", 64, K.scan_schedule, K._scan_schedule_plain)):
            ck = cp = ext0
            for _chain in range(2):  # fresh, then chained through the carry
                o_k, ck = wrap(st, ft, B, strat, ck, m_p.static_ok, B)
                o_p, cp = plain(st, ft, B, strat, cp, m_p.static_ok, B)
                errs[name] = max(errs.get(name, 0),
                                 max_abs_err((o_k,) + tuple(ck), (o_p,) + tuple(cp)))
        torch.cuda.synchronize()
    return errs


def compare_general(K, st, ft, facts, B, strategies=(0, 1)) -> tuple:
    """(max_abs_err, pods placed) of scan_general against its plain version
    on one input, over the fit strategies, fresh and chained."""
    err = placed = 0
    masks = K._static_masks_plain(st, ft)
    for strat in strategies:
        fit = K._resource_eval_plain(ft, strat, st.alloc_r, st.alloc_pods, st.req_r,
                                     st.nonzero, st.pod_count)
        ck = cp = K.fresh_carry(st, ft, ft.dns_counts.shape[1], fit)
        for _chain in range(2):
            o_k, ck = K.scan_general(st, ft, B, strat, ck, masks, B, facts)
            o_p, cp = K._scan_general_plain(st, ft, B, strat, cp, masks, B, facts)
            err = max(err, max_abs_err((o_k,) + tuple(ck), (o_p,) + tuple(cp)))
            placed += int((o_p[0] >= 0).sum())
    torch.cuda.synchronize()
    return err, placed


def first_launch_ms(K, st, ft, facts, B) -> tuple:
    """Wall ms of the process's first scan_general call with no active step
    (what TorchScheduler.warm_for's inert fallback launch takes out of a
    measured window) and of the same call next."""
    masks = K._static_masks_plain(st, ft)
    fit = K._resource_eval_plain(ft, 0, st.alloc_r, st.alloc_pods, st.req_r, st.nonzero,
                                 st.pod_count)
    ext0 = K.fresh_carry(st, ft, ft.dns_counts.shape[1], fit)
    out = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        K.scan_general(st, ft, B, 0, ext0, masks, 0, facts)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return tuple(out)


def to_device(dev, s, f):
    from kubernetes_tpu_torch.ops.device_state import DeviceNodeState
    from kubernetes_tpu_torch.ops.features import BatchFeatures
    return (DeviceNodeState(*[torch.from_numpy(np.array(a)).to(dev) for a in s]),
            BatchFeatures(*[torch.from_numpy(np.array(a)).to(dev) for a in f]))


def kernel_phase(dev, np_cap: int, n_nodes: int) -> dict:
    from kubernetes_tpu_torch.ops import kernel as K
    from kubernetes_tpu_torch.testing.kernel_inputs import (HOST_AXIS, general_inputs,
                                                            random_inputs)

    cases = {"truncation-on": {}, "start-past-rows": dict(start=n_nodes - 1),
             "truncation-off": dict(to_find=n_nodes), "zero-request": dict(zero_request=True),
             "all-infeasible": dict(infeasible=True)}
    errs = {w.__name__: 0 for w in K.WRAPPERS}
    for ci, (case, kw) in enumerate(cases.items()):
        st, ft = to_device(dev, *random_inputs(100 + ci, np_cap, n_nodes, **kw))
        for name, e in compare(K, st, ft).items():
            errs[name] = max(errs[name], e)
        if case == "truncation-on":
            m = K._static_masks_plain(st, ft)
            o_p, _ = K._lap_schedule_plain(st, ft, 1024, 0, K.fresh_carry(
                st, ft, 64, K._resource_eval_plain(ft, 0, st.alloc_r, st.alloc_pods, st.req_r,
                                                   st.nonzero, st.pod_count)),
                m.static_ok, 1024)
            check(int((o_p[0] >= 0).sum()) > 0 and int(ft.to_find) < int(m.static_ok.sum()),
                  "the truncation case must place pods with more feasible rows than to_find")
    print(f"fit-only kernels vs plain: max_abs_err {errs} over {len(cases)} cases x 2 "
          "strategies x fresh+chained", flush=True)
    # scan_general: (draw arguments, value tier, steps)
    general = {
        "spread-zone": (dict(dns=1), 64, 1024),                       # full feasibility, carried
        "spread-soft-pns": (dict(sa=1, pns=True), 64, 1024),          # incremental, normalized
        "affinity-bootstrap": (dict(aff=1, kd=1, ipa_base=True, bootstrap=True), 64, 1024),
        "anti-affinity-na": (dict(anti=2, na=True), 64, 1024),
        "all-lanes": (dict(dns=2, sa=1, anti=1, aff=1, kd=1, pns=True, ipa_base=True,
                           na=True), 8192, 64),
        "hostname-anti": (dict(anti=1, anti_axis=HOST_AXIS), 8192, 64),
    }
    for gi, (case, (kw, vmax, B)) in enumerate(general.items()):
        s, f, facts = general_inputs(200 + gi, np_cap, n_nodes, vmax=vmax, **kw)
        st, ft = to_device(dev, s, f)
        if gi == 0:
            first, second = first_launch_ms(K, st, ft, K.PlanFacts(**facts), B)
            print(f"scan_general's first launch in the process (no active step): {first:.3f} ms "
                  f"a call, the next: {second:.3f} ms", flush=True)
        e, placed = compare_general(K, st, ft, K.PlanFacts(**facts), B)
        print(f"scan_general {case} (V {vmax}, B {B}): max_abs_err {e}, {placed} pods placed "
              "over 2 strategies x fresh+chained", flush=True)
        check(placed > 0, f"the scan_general draw {case} placed nothing")
        errs["scan_general"] = max(errs["scan_general"], e)
    # the lap with hostname anti-affinity lanes
    s, f, facts = general_inputs(300, np_cap, n_nodes, vmax=8192, anti=1, anti_axis=HOST_AXIS)
    st, ft = to_device(dev, s, f)
    ft = ft._replace(anti_self=torch.ones_like(ft.anti_self))  # the pods match their own term
    m = K._static_masks_plain(st, ft)
    for strat in (0, 1):
        fit = K._resource_eval_plain(ft, strat, st.alloc_r, st.alloc_pods, st.req_r, st.nonzero,
                                     st.pod_count)
        ck = cp = K.fresh_carry(st, ft, 8192, fit)
        for _chain in range(2):
            o_k, ck = K.lap_schedule(st, ft, 1024, strat, ck, m.static_ok, 1024)
            o_p, cp = K._lap_schedule_plain(st, ft, 1024, strat, cp, m.static_ok, 1024)
            errs["lap_schedule"] = max(errs["lap_schedule"],
                                       max_abs_err((o_k,) + tuple(ck), (o_p,) + tuple(cp)))
    check(int(cp.anti_counts.sum()) > int(ft.anti_counts.sum()),
          "the anti-lane lap draw landed no anti-affinity pod")
    torch.cuda.synchronize()
    print(f"kernels vs plain: max_abs_err {errs}", flush=True)
    for name, e in errs.items():
        check(e == 0, f"{name} disagrees with its plain version (max_abs_err {e})")
    return errs


# ---------------------------------------------------------------------------
# Phase 3: the paths, each through TorchScheduler on cuda at full width
# ---------------------------------------------------------------------------

def zone_of(node: str) -> int:
    return int(node.split("-")[1]) % 50


def drive(dev, workload: str, max_batch=None):
    """Build the 5000-node cluster, warm the workload, then run its measured
    pods with the launch counts zeroed just before and read just after."""
    from kubernetes_tpu_torch import bench
    from kubernetes_tpu_torch.ops import kernel as K

    w = bench.WORKLOADS[workload]
    sched = bench.build_cluster(5000, device=dev, max_batch=max_batch)
    bench.warm(sched, w.init_pods, workload)
    flushes0 = sched.mirror.scatter_flushes
    K.reset_launch_counts()
    result = bench.measure(sched, w.measure_pods, workload=workload)
    launches = {k.__name__: k.launches for k in K.WRAPPERS}
    launches["scatter_flushes"] = sched.mirror.scatter_flushes - flushes0
    d = result["detail"]
    print(f"path {workload}: {json.dumps(result)}", flush=True)
    total = w.init_pods + w.measure_pods
    bound = len(sched.clientset.bindings)
    check(bound == len(sched.clientset.pods) == total, f"{workload}: {bound} of {total} pods bound")
    check(d["failures"] == 0 and d["host_path_pods"] == 0,
          f"{workload}: failures {d['failures']}, host_path_pods {d['host_path_pods']}")
    check(d["device_batches"] > 0, f"{workload}: no device batch in the measured window")
    return sched, result, launches


def paths_phase(dev) -> dict:
    from kubernetes_tpu_torch import bench
    from kubernetes_tpu_torch.ops import kernel as K

    out = {}
    # the main path
    name = "TopologySpreading/5000Nodes_5000Pods"
    sched, result, launches = drive(dev, name)
    zones = [0] * 50
    for p in sched.clientset.pods.values():
        if p.labels.get("app") == "spread":
            zones[zone_of(p.node_name)] += 1
    print(f"spread pods per zone: min {min(zones)}, max {max(zones)}", flush=True)
    check(max(zones) - min(zones) <= 1, f"zone skew of the spread pods {max(zones) - min(zones)}")
    for k in ("static_masks", "resource_eval", "scan_general"):
        check(launches[k] > 0, f"{k} was not launched on the {name} path")
    out[name] = (sched, result, launches)

    name = "SchedulingBasic/5000Nodes_10000Pods"
    sched, result, launches = drive(dev, name)
    for k in ("static_masks", "resource_eval", "lap_schedule"):
        check(launches[k] > 0, f"{k} was not launched on the {name} path")
    out[name] = (sched, result, launches)

    small = bench.build_cluster(5000, device=dev, max_batch=64)
    K.reset_launch_counts()
    for p in bench.make_pods(40, "small"):
        small.clientset.create_pod(p)
    small.run_until_idle()
    small_launches = {k.__name__: k.launches for k in K.WRAPPERS}
    print(f"small-batch path: bound {len(small.clientset.bindings)}/40, "
          f"launches {small_launches}", flush=True)
    check(len(small.clientset.bindings) == 40 and small.host_path_pods == 0,
          "small-batch drive did not bind every pod on the device")
    for k in ("static_masks", "resource_eval", "scan_schedule"):
        check(small_launches[k] > 0, f"{k} was not launched on the small-batch path")
    out["SchedulingBasic small batch (max_batch 64)"] = (small, None, small_launches)

    name = "PreferredTopologySpreading/5000Nodes_5000Pods"
    sched, result, launches = drive(dev, name)
    check(launches["scan_general"] > 0, f"scan_general was not launched on the {name} path")
    out[name] = (sched, result, launches)

    name = "SchedulingPodAntiAffinity/5000Nodes_2000Pods"
    sched, result, launches = drive(dev, name)
    per_node = {}
    for p in sched.clientset.pods.values():
        per_node[p.node_name] = per_node.get(p.node_name, 0) + 1
    check(max(per_node.values()) == 1, "two app: exclusive pods share a node")
    check(launches["lap_schedule"] > 0, f"the anti-lane lap was not launched on the {name} path")
    out[name] = (sched, result, launches)

    name = "SchedulingPodAffinity/5000Nodes_5000Pods"
    sched, result, launches = drive(dev, name)
    zones_used = {zone_of(p.node_name) for p in sched.clientset.pods.values()}
    print(f"affinity pods' zones: {sorted(zones_used)}", flush=True)
    check(len(zones_used) == 1, f"the affinity pods span {len(zones_used)} zones")
    check(launches["scan_general"] > 0, f"scan_general was not launched on the {name} path")
    out[name] = (sched, result, launches)
    return out


# ---------------------------------------------------------------------------
# Phase 4: timing on the main paths' inputs
# ---------------------------------------------------------------------------

def general_cost(f, facts, K, n_act: int):
    """(bytes, ops) the general scan needs for n_act steps on these inputs:
    per step one pass over the rows for the plan's live lanes, each read
    once (a row's count in a table is the table at the row's value id, so
    the row reads its value id and the table is read once a step), the
    [C1, V] minimum of every spread table, and the landing's one-row
    update. The kernel's own scratch (feasibility, its prefix sum, the
    carried totals between steps) is no input or output and is not
    counted."""
    NP = f.sel_match.shape[0]
    C1, C2 = f.dns_axis.shape[0], f.sa_axis.shape[0]
    A1, A2, KD = f.anti_axis.shape[0], f.aff_axis.shape[0], f.ipa_axis.shape[0]
    V = f.dns_counts.shape[1]
    _incremental, carried = K.plan_modes(f, facts)
    row = 1 + 1                              # static_ok, fit_ok
    row += 8 if carried else 8 + 8           # the carried total, or fit_sc and ba
    row += 4 * (C1 + C2 + A1 + A2 + KD)      # a value id per table
    row += 8 * (facts.has_pns + facts.has_ipa_base + facts.has_na_pref)
    ops_row = 12 + 6 * (C1 + C2 + A1 + A2 + KD) + (0 if carried else 30)
    table = V * (5 * C1 + 4 * (C2 + A1 + A2) + 8 * KD)  # counts (+ dns_dom), deltas i64
    step_bytes = NP * row + table + 256
    return n_act * step_bytes, n_act * (NP * ops_row + C1 * V)


def timing_phase(paths: dict, errs: dict) -> dict:
    """Each kernel and its plain version timed on its main path's own
    inputs: the next batch's device state and features of the path's
    cluster after its measured run, at the path's shapes. The kernels are
    first held exactly equal to their plain versions on these inputs too."""
    from kubernetes_tpu_torch import bench
    from kubernetes_tpu_torch.ops import kernel as K

    sched = paths["SchedulingBasic/5000Nodes_10000Pods"][0]
    pod = bench.make_pods(1, "timed")[0]
    st, plan = sched.build_plan(sched.framework_for_pod(pod), pod, sched.max_batch)
    ft, strat = plan.features, plan.fit_strategy
    for name, e in compare(K, st, ft, (strat,)).items():
        check(e == 0, f"{name} disagrees with its plain version on the main path's inputs")
    static_ok = K._static_masks_plain(st, ft).static_ok
    ext0 = K.fresh_carry(st, ft, plan.vmax, K._resource_eval_plain(
        ft, strat, st.alloc_r, st.alloc_pods, st.req_r, st.nonzero, st.pod_count))
    NP, R = st.alloc_r.shape
    T, L, FR = st.taint_key.shape[1], ft.tol_key.shape[0], ft.fit_slots.shape[0]
    stats = {}
    K._lap_schedule_plain(st, ft, 1024, strat, ext0, static_ok, 1024, stats=stats)
    laps = stats["laps"]
    # Bytes: each input read once and each output written once, per row
    # (int64 = 8, int32 = 4, bool = 1). Ops: the int64/int32 operations the
    # function needs on this run's data (the lap count is data-dependent). A
    # landing changes only its own row, so a lap or step needs one pass over
    # the rows for the prefix sum, rank, rotation, window and key, and a
    # re-evaluation of the rows that landed, not of every row.
    row_ops = 4 * R + 12 * FR + 24           # one resource_eval of a row
    pass_ops = 24                            # one row's share of a lap's pass
    res = (ft, strat, st.alloc_r, st.alloc_pods, st.req_r, st.nonzero, st.pod_count)
    calls = {
        "static_masks": (lambda: K.static_masks(st, ft), lambda: K._static_masks_plain(st, ft),
                         NP * (12 * T + 12) + 16 * L + NP * 14,
                         NP * (T * (10 * L + 6) + 12)),
        "resource_eval": (lambda: K.resource_eval(*res), lambda: K._resource_eval_plain(*res),
                          NP * (16 * R + 28) + NP * 17, NP * row_ops),
        "lap_schedule": (lambda: K.lap_schedule(st, ft, 1024, strat, ext0, static_ok, 1024),
                         lambda: K._lap_schedule_plain(st, ft, 1024, strat, ext0, static_ok,
                                                       1024),
                         NP * (16 * R + 37) + NP * (8 * R + 37) + 8 * 1024,
                         laps * (NP * pass_ops + K.LAP_MAX * row_ops) + NP * row_ops),
        "scan_schedule": (lambda: K.scan_schedule(st, ft, 64, strat, ext0, static_ok, 64),
                          lambda: K._scan_schedule_plain(st, ft, 64, strat, ext0, static_ok, 64),
                          NP * (16 * R + 54) + NP * (8 * R + 37) + 8 * 64,
                          64 * NP * 16 + NP * 24 + 64 * row_ops),
    }
    # scan_general on the main path's next batch: 1024 spread pods after
    # the 6000 of the TopologySpreading run.
    name = "TopologySpreading/5000Nodes_5000Pods"
    gsched = paths[name][0]
    gpod = bench.make_pods(1, "timed", name)[0]
    gst, gplan = gsched.build_plan(gsched.framework_for_pod(gpod), gpod, gsched.max_batch)
    gf = gplan.features
    facts = gplan.facts
    gmasks = K._static_masks_plain(gst, gf)
    gext0 = K.fresh_carry(gst, gf, gplan.vmax, K._resource_eval_plain(
        gf, gplan.fit_strategy, gst.alloc_r, gst.alloc_pods, gst.req_r, gst.nonzero,
        gst.pod_count))
    gB = gplan.batch_pad
    e, _placed = compare_general(K, gst, gf, facts, gB, (gplan.fit_strategy,))
    check(e == 0, "scan_general disagrees with its plain version on the main path's inputs")
    gbytes, gops = general_cost(gf, facts, K, gB)
    calls["scan_general"] = (
        lambda: K.scan_general(gst, gf, gB, gplan.fit_strategy, gext0, gmasks, gB, facts),
        lambda: K._scan_general_plain(gst, gf, gB, gplan.fit_strategy, gext0, gmasks, gB, facts),
        gbytes, gops)
    replaces = {"static_masks": "kubernetes_tpu/ops/kernel.py:106",
                "resource_eval": "kubernetes_tpu/ops/kernel.py:160",
                "lap_schedule": "kubernetes_tpu/ops/kernel.py:799",
                "scan_schedule": "kubernetes_tpu/ops/kernel.py:343",
                "scan_general": "kubernetes_tpu/ops/kernel.py:314"}
    rows = {}
    for kname, (k_fn, p_fn, nbytes, ops) in calls.items():
        ms = device_ms(k_fn, kname)
        host_ms = wall_ms(k_fn, reps=20 if kname != "scan_general" else 5)
        plain_ms = wall_ms(p_fn, reps=2 if kname != "scan_general" else 1, warmup=1)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_OPS_PER_S * 1e3
        rows[kname] = dict(name=kname, route="cuda",
                           source=f"kubernetes_tpu_torch/csrc/{kname}.cu",
                           replaces=replaces[kname], launches=0, max_abs_err=errs[kname],
                           exact=errs[kname] == 0, ms=ms, host_ms=host_ms, plain_ms=plain_ms,
                           bound_ms=max(t_bytes, t_ops),
                           bound_by="bytes" if t_bytes >= t_ops else "operations",
                           library_ms=None, bytes=nbytes, ops=ops)
    rows["lap_schedule"]["laps"] = laps
    rows["scan_general"]["steps"] = gB
    # scan_general on scan_schedule's own inputs: the plan scan_schedule
    # takes (incremental feasibility, carried score, no table) is one of
    # scan_general's modes, so the two must agree there exactly.
    masks = K._static_masks_plain(st, ft)
    o_s, c_s = K.scan_schedule(st, ft, 64, strat, ext0, static_ok, 64)
    o_g, c_g = K.scan_general(st, ft, 64, strat, ext0, masks, 64, plan.facts)
    check(max_abs_err((o_s,) + tuple(c_s), (o_g,) + tuple(c_g)) == 0,
          "scan_general disagrees with scan_schedule on scan_schedule's plan")
    g_ms = device_ms(lambda: K.scan_general(st, ft, 64, strat, ext0, masks, 64, plan.facts),
                     "scan_general")
    rows["scan_schedule"]["scan_general_ms_same_inputs"] = g_ms
    print(f"scan_schedule's plan (64 steps, NP {NP}): scan_schedule "
          f"{rows['scan_schedule']['ms']:.4f} ms on the device, scan_general {g_ms:.4f} ms, "
          "identical results", flush=True)
    print(f"kernel times on the main paths' inputs (NP {NP}, R {R}, T {T}, L {L}, "
          f"{laps} laps per 1024-pod batch; scan_general {gB} steps, V {gplan.vmax}): "
          + ", ".join(f"{n} {r['ms']:.4f} ms on the device, {r['host_ms']:.4f} ms a call "
                      f"(plain {r['plain_ms']:.3f})" for n, r in rows.items()),
          flush=True)
    return rows


def scatter_timing(paths: dict) -> dict:
    """The mirror's dirty-row scatter (one index_copy_ per DeviceNodeState
    field, a library call): its flushes on the main path, and its device
    time and bytes bound for 64 dirty rows of the main path's mirror."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sched = paths["TopologySpreading/5000Nodes_5000Pods"][0]
    mirror = sched.mirror
    rows = list(range(0, 5000, 5000 // 64))[:64]
    mirror._scatter_dirty(rows)
    torch.cuda.synchronize()
    reps = 20
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            mirror._scatter_dirty(rows)
        torch.cuda.synchronize()
    kern_us = copy_us = 0.0
    names = set()
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        span = e.time_range.end - e.time_range.start
        if "memcpy" in e.name.lower():
            copy_us += span
        else:
            kern_us += span
            names.add(e.name[:60])
    row_bytes = sum(a[0].nbytes for a in mirror._arrays()) + mirror.h_topo[:, 0].nbytes
    nbytes = 2 * len(rows) * row_bytes  # rows read from the upload, written into the state
    out = dict(name="dirty-row scatter (index_copy_)", rows=len(rows),
               flushes_on_main_path=paths["TopologySpreading/5000Nodes_5000Pods"][2].get(
                   "scatter_flushes", 0),
               library_ms=kern_us / reps / 1e3, copy_ms=copy_us / reps / 1e3,
               bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bytes=nbytes,
               device_kernels=sorted(names))
    print(f"scatter: {json.dumps(out)}", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 5: cuda/cpu parity
# ---------------------------------------------------------------------------

def parity_phase(dev):
    from kubernetes_tpu_torch import bench
    from kubernetes_tpu_torch.models import TorchScheduler
    from kubernetes_tpu_torch.testing import make_node, make_pod

    zone, host = "topology.kubernetes.io/zone", "kubernetes.io/hostname"

    def mixed(device, max_batch):
        rng = random.Random(7)
        s = TorchScheduler(device=device, max_batch=max_batch)
        for i in range(500):
            b = (make_node().name(f"node-{i}")
                 .capacity({"cpu": rng.choice([2, 4, 8, 16]),
                            "memory": f"{rng.choice([4, 8, 16, 32])}Gi", "pods": 110})
                 .zone(f"zone-{i % 10}").label("disk", rng.choice(["ssd", "hdd"])))
            if rng.random() < 0.3:
                b = b.taint("dedicated", "infra", "NoSchedule")
            if rng.random() < 0.2:
                b = b.taint("soft", "", "PreferNoSchedule")
            if rng.random() < 0.1:
                b = b.unschedulable()
            s.clientset.create_node(b.obj())
        shapes = [
            lambda b: b,
            lambda b: b.toleration("dedicated", "infra", "Equal", "NoSchedule"),
            lambda b: b.node_selector({"disk": "ssd"}),
            lambda b: b.labels({"app": "s"}).spread_constraint(1, zone, "DoNotSchedule",
                                                               {"app": "s"}),
            lambda b: b.labels({"app": "h"}).spread_constraint(2, host, "DoNotSchedule",
                                                               {"app": "h"}),
            lambda b: b.labels({"app": "soft"}).spread_constraint(1, zone, "ScheduleAnyway",
                                                                  {"app": "soft"}),
            lambda b: b.labels({"app": "x"}).pod_affinity(host, {"app": "x"}, anti=True),
            lambda b: b.labels({"app": "pack"}).pod_affinity(zone, {"app": "pack"}),
            lambda b: b.labels({"app": "w"}).pod_affinity(zone, {"app": "s"}, weight=10)
            .pod_affinity(zone, {"app": "w"}, anti=True, weight=5),
            lambda b: b.preferred_node_affinity(7, "disk", ["hdd"]),
        ]
        for wave, shape in enumerate(shapes):
            for i in range(rng.choice([30, 150, 400])):
                p = make_pod().name(f"w{wave}-{i}").req(
                    {"cpu": rng.choice(["250m", "500m", "1"]), "memory": "512Mi"})
                s.clientset.create_pod(shape(p).obj())
            s.run_until_idle()
        for i in range(20):  # larger than every node: device-infeasible, diagnosed
            s.clientset.create_pod(make_pod().name(f"big-{i}").req({"cpu": "20"}).obj())
        s.run_until_idle()
        return s

    def same(a, b, what):
        got = {p.name: p.node_name for p in a.clientset.pods.values()}
        want = {p.name: p.node_name for p in b.clientset.pods.values()}
        diffs = {k: (want[k], got.get(k)) for k in want if want[k] != got.get(k)}
        check(not diffs, f"cuda/cpu divergence ({what}): {list(diffs.items())[:5]}")
        check((a.scheduled, a.failures) == (b.scheduled, b.failures), f"counts differ ({what})")
        print(f"parity ({what}): {len(want)} pods, {b.scheduled} bound, {b.failures} failed "
              f"attempts, {a.device_batches} device batches, identical", flush=True)

    for max_batch in (None, 64):
        a, b = mixed(dev, max_batch), mixed("cpu", max_batch)
        same(a, b, f"mixed 500 nodes, max_batch {max_batch or 1024}")
        check(a.scheduled > 0 and a.device_batches > 0 and a.failures > 0,
              "parity run must place pods on the device and fail the oversized ones")

    name = "TopologySpreading/5000Nodes_5000Pods"
    runs = []
    for device in (dev, "cpu"):
        s = bench.build_cluster(5000, device=device)
        bench.warm(s, bench.WORKLOADS[name].init_pods, name)
        bench.measure(s, 1024, workload=name)
        runs.append(s)
    same(runs[0], runs[1], f"{name}, first measured batch of 1024 pods at 5000 nodes")


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    try:
        from kubernetes_tpu_torch.ops import _build
    except ImportError as e:
        fail(f"the kubernetes_tpu_torch package is not beside this script ({e})")
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    print(f"card: {smi}", flush=True)

    t0 = time.perf_counter()
    _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc, sm_90a, {len(_build.KERNELS)} sources "
          "in parallel, one library)", flush=True)

    np_cap = 64  # NodeStateMirror's capacity tiers: doubling from 64
    while np_cap < 5000:
        np_cap *= 2
    t1 = time.perf_counter()
    errs = kernel_phase(dev, np_cap, 5000)
    print(f"kernels phase: {time.perf_counter() - t1:.1f} s", flush=True)

    t1 = time.perf_counter()
    paths = paths_phase(dev)
    print(f"paths phase: {time.perf_counter() - t1:.1f} s", flush=True)
    t1 = time.perf_counter()
    rows = timing_phase(paths, errs)
    scatter_timing(paths)
    print(f"timing phase: {time.perf_counter() - t1:.1f} s", flush=True)
    for name, (_s, result, _l) in paths.items():
        if result is not None:
            print(f"pods/s {result['value']:.1f} {name} on {smi} "
                  f"({result['detail']['elapsed_s']:.3f} s)", flush=True)
    for name, row in rows.items():
        by_path = {p: launches[name] for p, (_s, _r, launches) in paths.items()}
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path

    t1 = time.perf_counter()
    parity_phase(dev)
    print(f"parity phase: {time.perf_counter() - t1:.1f} s", flush=True)

    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
