#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (kubernetes_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order; any error or mismatch exits non-zero before the result:
  1. build   — compile the four CUDA kernels from csrc/ (one nvcc each, in
               parallel, linked into one library) and print the build
               seconds;
  2. kernels — hold each kernel against its plain PyTorch version on the
               card, on seeded inputs at the main path's shapes (the
               5000-node mirror's padded capacity, R = 7, T = 4, B = 1024
               for the lap and 64 for the scan), over the cases: rotation
               start past rows, truncation on and off, zero-request pods,
               all-infeasible rows; fresh and chained carries. Results must
               be exactly equal on every output and carry lane;
  3. main    — the SchedulingBasic bench shape through TorchScheduler on
               cuda (5000 nodes, 1024 warm-up pods, 10000 measured pods):
               every pod bound, no host-path pod, device batches > 0, and
               the kernels of the path launched (launch counts are zeroed
               just before the measured drive and read just after); then a
               small-batch drive (max_batch 64: 40 pods on a fresh session)
               that must launch the scan kernel;
  4. timing  — on the main path's own next-batch inputs (exactness
               checked there too): each kernel's device time per launch
               from torch.profiler, its wrapper's wall time per call (host
               work included) and its plain version's, from CUDA events,
               beside the least time the card could take;
  5. parity  — a 500-node cluster with NoSchedule taints, unschedulable
               nodes, node selectors and pods that fit no node: the cuda
               run's assignments and failure counts must equal the port's
               device="cpu" run (the plain versions, which the
               repository's tests hold equal to the JAX package);
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
    """Largest kernel-vs-plain difference of each kernel on one input, over
    the fit strategies, fresh and chained through the carry."""
    errs = {w.__name__: 0 for w in K.WRAPPERS}
    for strat in strategies:
        m_k, m_p = K.static_masks(st, ft), K._static_masks_plain(st, ft)
        errs["static_masks"] = max(errs["static_masks"], max_abs_err(m_k, m_p))
        r_args = (ft, strat, st.alloc_r, st.alloc_pods, st.req_r, st.nonzero, st.pod_count)
        r_k, r_p = K.resource_eval(*r_args), K._resource_eval_plain(*r_args)
        errs["resource_eval"] = max(errs["resource_eval"], max_abs_err(r_k, r_p))
        ext0 = K.fresh_carry(st, ft, 64, r_p)
        for name, B, wrap, plain in (("lap_schedule", 1024, K.lap_schedule, K._lap_schedule_plain),
                                     ("scan_schedule", 64, K.scan_schedule, K._scan_schedule_plain)):
            ck = cp = ext0
            for _chain in range(2):  # fresh, then chained through the carry
                o_k, ck = wrap(st, ft, B, strat, ck, m_p.static_ok, B)
                o_p, cp = plain(st, ft, B, strat, cp, m_p.static_ok, B)
                errs[name] = max(errs[name], max_abs_err((o_k,) + tuple(ck), (o_p,) + tuple(cp)))
        torch.cuda.synchronize()
    return errs


def kernel_phase(dev, np_cap: int, n_nodes: int) -> dict:
    from kubernetes_tpu_torch.ops import kernel as K
    from kubernetes_tpu_torch.ops.device_state import DeviceNodeState
    from kubernetes_tpu_torch.ops.features import BatchFeatures
    from kubernetes_tpu_torch.testing.kernel_inputs import random_inputs

    cases = {"truncation-on": {}, "start-past-rows": dict(start=n_nodes - 1),
             "truncation-off": dict(to_find=n_nodes), "zero-request": dict(zero_request=True),
             "all-infeasible": dict(infeasible=True)}
    errs = {w.__name__: 0 for w in K.WRAPPERS}
    for ci, (case, kw) in enumerate(cases.items()):
        s, f = random_inputs(100 + ci, np_cap, n_nodes, **kw)
        st = DeviceNodeState(*[torch.from_numpy(np.array(a)).to(dev) for a in s])
        ft = BatchFeatures(*[torch.from_numpy(np.array(a)).to(dev) for a in f])
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
    print(f"kernels vs plain: max_abs_err {errs} over {len(cases)} cases x 2 strategies x "
          "fresh+chained", flush=True)
    for name, e in errs.items():
        check(e == 0, f"{name} disagrees with its plain version (max_abs_err {e})")
    return errs


def timing_phase(sched, errs: dict) -> dict:
    """Each kernel and its plain version timed on the main path's own
    inputs: the next batch's device state and features of the bench
    cluster after its measured run (5000 nodes holding 11024 pods), at the
    main path's shapes. The kernels are first held exactly equal to their
    plain versions on these inputs too."""
    from kubernetes_tpu_torch import bench
    from kubernetes_tpu_torch.ops import kernel as K

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
    replaces = {"static_masks": "kubernetes_tpu/ops/kernel.py:106",
                "resource_eval": "kubernetes_tpu/ops/kernel.py:160",
                "lap_schedule": "kubernetes_tpu/ops/kernel.py:799",
                "scan_schedule": "kubernetes_tpu/ops/kernel.py:343"}
    rows = {}
    for name, (k_fn, p_fn, nbytes, ops) in calls.items():
        ms = device_ms(k_fn, name)
        host_ms = wall_ms(k_fn, reps=20)
        plain_ms = wall_ms(p_fn, reps=2, warmup=1)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_OPS_PER_S * 1e3
        rows[name] = dict(name=name, route="cuda", source=f"kubernetes_tpu_torch/csrc/{name}.cu",
                          replaces=replaces[name], launches=0, max_abs_err=errs[name],
                          exact=errs[name] == 0, ms=ms, host_ms=host_ms, plain_ms=plain_ms,
                          bound_ms=max(t_bytes, t_ops),
                          bound_by="bytes" if t_bytes >= t_ops else "operations",
                          library_ms=None, bytes=nbytes, ops=ops)
    rows["lap_schedule"]["laps"] = laps
    print(f"kernel times on the main path's inputs (NP {NP}, R {R}, T {T}, L {L}, "
          f"{laps} laps per 1024-pod batch): "
          + ", ".join(f"{n} {r['ms']:.4f} ms on the device, {r['host_ms']:.4f} ms a call "
                      f"(plain {r['plain_ms']:.3f})" for n, r in rows.items()),
          flush=True)
    return rows


# ---------------------------------------------------------------------------
# Phases 3 and 4: the port's main path and the device/CPU parity run
# ---------------------------------------------------------------------------

def main_phase(dev):
    from kubernetes_tpu_torch import bench
    from kubernetes_tpu_torch.ops import kernel as K

    sched = bench.build_cluster(5000, device=dev)
    bench.warm(sched, 1024)
    K.reset_launch_counts()
    result = bench.measure(sched, 10000)
    launches = {w.__name__: w.launches for w in K.WRAPPERS}
    d = result["detail"]
    bound = len(sched.clientset.bindings)
    print(f"main path: {json.dumps(result)}", flush=True)
    check(bound == len(sched.clientset.pods) == 11024, f"{bound} of 11024 pods bound")
    check(d["failures"] == 0 and d["host_path_pods"] == 0,
          f"failures {d['failures']}, host_path_pods {d['host_path_pods']}")
    check(d["device_batches"] > 0, "no device batch in the measured window")
    for name in ("static_masks", "resource_eval", "lap_schedule"):
        check(launches[name] > 0, f"{name} was not launched on the main path")

    small = bench.build_cluster(5000, device=dev, max_batch=64)
    K.reset_launch_counts()
    for p in bench.make_pods(40, "small"):
        small.clientset.create_pod(p)
    small.run_until_idle()
    small_launches = {w.__name__: w.launches for w in K.WRAPPERS}
    print(f"small-batch path: bound {len(small.clientset.bindings)}/40, "
          f"launches {small_launches}", flush=True)
    check(len(small.clientset.bindings) == 40 and small.host_path_pods == 0,
          "small-batch drive did not bind every pod on the device")
    for name in ("static_masks", "resource_eval", "scan_schedule"):
        check(small_launches[name] > 0, f"{name} was not launched on the small-batch path")
    return sched, result, launches, small_launches


def parity_phase(dev):
    from kubernetes_tpu_torch.models import TorchScheduler
    from kubernetes_tpu_torch.testing import make_node, make_pod

    def drive(device, max_batch):
        rng = random.Random(7)
        s = TorchScheduler(device=device, max_batch=max_batch)
        for i in range(500):
            b = (make_node().name(f"node-{i}")
                 .capacity({"cpu": rng.choice([2, 4, 8, 16]),
                            "memory": f"{rng.choice([4, 8, 16, 32])}Gi", "pods": 110})
                 .zone(f"zone-{i % 10}").label("disk", rng.choice(["ssd", "hdd"])))
            if rng.random() < 0.3:
                b = b.taint("dedicated", "infra", "NoSchedule")
            if rng.random() < 0.1:
                b = b.unschedulable()
            s.clientset.create_node(b.obj())
        shapes = [lambda b: b,
                  lambda b: b.toleration("dedicated", "infra", "Equal", "NoSchedule"),
                  lambda b: b.node_selector({"disk": "ssd"})]
        for wave in range(6):
            for i in range(rng.choice([30, 150, 400])):
                p = make_pod().name(f"w{wave}-{i}").req(
                    {"cpu": rng.choice(["250m", "500m", "1"]), "memory": "512Mi"})
                s.clientset.create_pod(shapes[wave % 3](p).obj())
            s.run_until_idle()
        for i in range(20):  # larger than every node: device-infeasible, diagnosed
            s.clientset.create_pod(make_pod().name(f"big-{i}").req({"cpu": "20"}).obj())
        s.run_until_idle()
        return s

    for max_batch in (None, 64):
        a = drive(dev, max_batch)
        b = drive("cpu", max_batch)
        got = {p.name: p.node_name for p in a.clientset.pods.values()}
        want = {p.name: p.node_name for p in b.clientset.pods.values()}
        diffs = {k: (want[k], got.get(k)) for k in want if want[k] != got.get(k)}
        check(not diffs, f"cuda/cpu divergence (max_batch {max_batch}): "
                         f"{list(diffs.items())[:5]}")
        check((a.scheduled, a.failures) == (b.scheduled, b.failures), "counts differ")
        print(f"parity (max_batch {max_batch or 1024}): {len(want)} pods, {b.scheduled} bound, "
              f"{b.failures} failed attempts, {a.device_batches} device batches, identical",
              flush=True)
        check(a.scheduled > 0 and a.device_batches > 0 and a.failures > 0,
              "parity run must place pods on the device and fail the oversized ones")


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
    errs = kernel_phase(dev, np_cap, 5000)

    sched, result, launches, small_launches = main_phase(dev)
    rows = timing_phase(sched, errs)
    print(f"pods/s {result['value']:.1f} on {smi} "
          f"(10000 pods, 5000 nodes, {result['detail']['elapsed_s']:.3f} s)", flush=True)
    for name, row in rows.items():
        row["launches"] = launches[name] + small_launches[name]
        row["launches_by_path"] = {"bench": launches[name], "small_batch": small_launches[name]}

    parity_phase(dev)

    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
