"""SchedulingBasic benchmark of the port: `python -m kubernetes_tpu_torch.bench`.

The shape of the JAX package's bench.py `main` (SchedulingBasic/
5000Nodes_10000Pods): 5000 nodes of 32 cpu / 256Gi / 110 pods across 50
zones, identical 100m/128Mi pods, a same-shape warm-up (kernel build and a
1024-pod block) outside the measured window, then the measured pods
through TorchScheduler. Prints one JSON line with the same keys as
bench.py (`metric`, `value`, `unit`, `vs_baseline`, `detail`), `platform`
naming the card.

Environment: BENCH_NODES, BENCH_PODS, BENCH_WARMUP, BENCH_MAX_BATCH;
`--device cpu` runs the kernels' plain versions on the CPU. `--profile`
runs the measured window under torch.profiler and adds `detail.profile`:
the device's busy time (the union of its kernel and copy intervals), its
busy share of the window, and the time and count of each device kernel.
The profiler slows the host, so pods/s comes from a run without it.
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch

from .models import TorchScheduler
from .ops import kernel
from .testing import make_node, make_pod

BASELINE_PODS_PER_SEC = 680.0  # SchedulingBasic/5000Nodes_10000Pods upstream threshold

WINDOW_COUNTERS = ("scheduled", "failures", "device_batches", "device_scheduled",
                   "host_path_pods", "plan_build_s", "collect_s", "dispatch_s",
                   "device_wait_s", "host_commit_s", "session_end_s")


def build_cluster(n_nodes: int, device="cuda", max_batch=None, zones: int = 50) -> TorchScheduler:
    sched = TorchScheduler(device=device, max_batch=max_batch)
    for i in range(n_nodes):
        sched.clientset.create_node(
            make_node().name(f"node-{i}")
            .capacity({"cpu": 32, "memory": "256Gi", "pods": 110})
            .zone(f"zone-{i % zones}").obj())
    return sched


def make_pods(n: int, prefix: str):
    """N clones of one template (shared spec and signature memo)."""
    proto = (make_pod().name("proto").req({"cpu": "100m", "memory": "128Mi"})
             .labels({"app": prefix}).obj())
    return [proto.clone_from_template(f"{prefix}-{i}") for i in range(n)]


def platform_name(sched: TorchScheduler) -> str:
    if sched.device.type == "cuda":
        return torch.cuda.get_device_name(sched.device)
    return "cpu"


def warm(sched: TorchScheduler, warmup: int) -> None:
    """Kernel build + inert dispatches, then one real warm block."""
    sched.warm_for(make_pods(1, "warmshape")[0])
    for p in make_pods(warmup, "warm"):
        sched.clientset.create_pod(p)
    sched.run_until_idle()


def measure(sched: TorchScheduler, n_pods: int, prefix: str = "bench") -> dict:
    """Schedule n_pods identical pods; returns the window's result line."""
    win0 = {a: getattr(sched, a) for a in WINDOW_COUNTERS}
    for p in make_pods(n_pods, prefix):
        sched.clientset.create_pod(p)
    t0 = time.perf_counter()
    sched.run_until_idle()
    if sched.device.type == "cuda":
        torch.cuda.synchronize(sched.device)
    elapsed = time.perf_counter() - t0
    detail = {a: getattr(sched, a) - win0[a] for a in WINDOW_COUNTERS}
    pods_per_sec = detail["scheduled"] / elapsed if elapsed > 0 else 0.0
    detail.update(elapsed_s=elapsed, platform=platform_name(sched),
                  launches={w.__name__: w.launches for w in kernel.WRAPPERS})
    return {
        "metric": (f"pods scheduled/sec ({sched.snapshot.num_nodes()} nodes, {n_pods} pods, "
                   "device batch path)"),
        "value": pods_per_sec,
        "unit": "pods/s",
        "vs_baseline": pods_per_sec / BASELINE_PODS_PER_SEC,
        "detail": detail,
    }


def profile(sched: TorchScheduler, n_pods: int) -> dict:
    """measure() under torch.profiler, with the device timeline summarized."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    acts = [ProfilerActivity.CPU]
    if sched.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with torch_profile(activities=acts) as prof:
        result = measure(sched, n_pods, prefix="profiled")
    spans, kernels = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        k = kernels.setdefault(e.name, {"count": 0, "ms": 0.0})
        k["count"] += 1
        k["ms"] += (e.time_range.end - e.time_range.start) / 1e3
    busy_us, reach = 0.0, float("-inf")
    for a, b in sorted(spans):  # union of the device intervals
        if b > reach:
            busy_us += b - max(a, reach)
            reach = b
    elapsed = result["detail"]["elapsed_s"]
    result["detail"]["profile"] = {
        "device_events": len(spans), "device_busy_s": busy_us / 1e6,
        "device_busy_share": busy_us / 1e6 / elapsed if elapsed > 0 else 0.0,
        "kernels": dict(sorted(kernels.items(), key=lambda kv: -kv[1]["ms"])),
    }
    return result


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    device = argv[argv.index("--device") + 1] if "--device" in argv else "cuda"
    n_nodes = int(os.environ.get("BENCH_NODES", 5000))
    n_pods = int(os.environ.get("BENCH_PODS", 10000))
    warmup = int(os.environ.get("BENCH_WARMUP", 1024))
    max_batch = int(os.environ.get("BENCH_MAX_BATCH", 0)) or None
    sched = build_cluster(n_nodes, device=device, max_batch=max_batch)
    warm(sched, warmup)
    kernel.reset_launch_counts()
    if "--profile" in argv:
        print(json.dumps(profile(sched, n_pods)))
    else:
        print(json.dumps(measure(sched, n_pods)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
