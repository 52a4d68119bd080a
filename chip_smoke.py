#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (kubernetes_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order; any error or mismatch exits non-zero before the result:
  1. build   — compile the ten CUDA sources from csrc/ (one nvcc each, in
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
               and 64, and six on the edges of its on-chip design (5003
               rows, 16384 rows, 65536 rows, a hostname spread at V = 8192,
               GEN_MAXC spread constraints, every table and lane at once);
               and the lap with hostname anti-affinity lanes; the lap on
               the edges of its on-chip design (lap_phase: to_find 1,
               LAP_MAX windows with spill, start inside a chunk, at 0 and
               past num, no feasible row, fewer feasible rows than
               to_find, 8189 rows, three fit slots, each lane, two
               anti-affinity terms with repeated values, every lane,
               NP 16384 and NP 20000 in device memory; one line a draw
               with its L range and laps). Both
               fit strategies, fresh and chained carries. The schedule
               kernels again with a live nominated-pod lane; dry_run_preemption
               on seeded victim draws at K = 8, 32 and 256 (rows with no
               victim, invalid slots, scalar-resource victims), with no
               row that any removal can fit, and on its design's edges
               (DRY_EDGES: R 1 to 64, K up to 256, victims past
               num_nodes, gates off, no taint or toleration, 160 taint
               slots); static_masks on its edges (MASK_EDGES); resource_eval
               on its edges (RESOURCE_EDGES: NP 1, 63, 64, 65, 5003 and 8192,
               R 2 to 50 with FR 0 to R, each with and without a
               nominated lane, both fit strategies, rows whose divisions
               leave the fast paths, rows 8 bytes off their allocation);
               scatter_rows on
               SCATTER_DRAWS (1, 64, 2048 and 4096 rows, sorted and
               shuffled, in place, NP 5003, R 1 with no taint slot or axis,
               R 9) and through the staging ring, its input state left
               unchanged; patch_carry_rows at K = 32, 256 and 2048 (tiers
               padded with duplicate indices) on a carry chained through two
               schedule_batch calls, with and without a nominated-pod lane,
               at R 9 and NP 5003, in place, through the staging ring, its
               input carry left unchanged; the hazard check (64 flushes and
               64 carry patches back to back behind a long kernel, no
               synchronize, each step's state and carry held against the
               plain versions); schedule_placements at P = 1,
               16 and 64 lanes (an empty padded lane, a one-row, a 100-row
               and an every-row lane, which also marks the padded rows past
               num_nodes), without spread tables, with the plan's and with
               per-lane overrides, at V = 64 and 8192, both fit strategies,
               no active member and a gang of 4, some lane placing only
               part of its gang, its inputs left unchanged, and at NP 20000
               (a gang of 4, one fit strategy) with a placement of 19990 rows (past a lane's on-chip tier: its arrays in device
               memory); whatif_score at the
               rebalance drive's shape (P 128, N 5000, R 3) and at P 1 /
               N 3, with 16 TiB nodes (int64 wrap-around), with negative
               numerators (floored division), both at odd sizes, about its
               tiles (P 1 to 600, N 1 to 5003, the sources on the tile
               edges), at R 2 to 86 (the slack in registers, a shared tile
               and device memory) with both hazards, its inputs left
               unchanged, and empty batches that launch nothing; the what-if
               hazard check (32 score calls behind a long kernel, no
               synchronize of their own, every result kept and held
               against the plain version); the three
               schedule kernels with the blocked lane of a host-port plan
               (port_selfblock): a random third of the carry's rows blocked,
               both fit strategies, fresh and chained, padded steps, draws
               whose batch outnumbers their feasible rows (every row blocked,
               the last pods placed nowhere), schedule_placements' lanes at
               P = 16 and 64 each blocking only their own rows; static_masks
               with a mixed extra_ok; the three schedule kernels with the
               aux_cnt lane of a has_aux plan (a CSI attach limit): a room of
               0 to 3 attachments a row, an increment of 1 or 2, the carry's
               count drawn or zero, fresh and chained, padded steps, draws
               whose batch outnumbers their room (every row filled, the last
               pods placed nowhere), schedule_placements' lanes at P = 16
               and 64 each counting only their own members; the sharded_lap
               kernel (one launch a card a dispatch) at S = 2, 4 and 8 shards
               on one card (and 16 on the first batch), on SchedulingBasic's
               first batch (NP 8192, B 1024) and on draws with the start's
               row in a late shard, a start of 0, LAP_MAX windows with a
               short final lap, shards with no feasible row, padded rows,
               truncation off and nothing feasible, and 40000 rows in two
               shards (past the on-chip tier): each dispatch fresh and
               chained, cut after 1, L and 2L pods and whole, against its
               plain version (LapRun) and the one-device lap kernel, one
               launch a dispatch; then its refusals (33 shards on one card,
               a wait whose budget runs out, an exchange buffer the card
               cannot reach), each raising. Results must be
               exactly equal on every output and carry lane. It also times scan_general's first
               launch in the process against the next;
  3. paths   — each through TorchScheduler on cuda at full width, the
               launch counts zeroed just before each drive and read just
               after:
               TopologySpreading/5000Nodes_5000Pods, the main path of the
               first slices (5000 nodes of 32 cpu / 256Gi / 110 pods across
               50 zones, 1000 warm pods, then 5000 pods under a hard zone
               spread): every pod bound, zone skew of the spread pods <= 1,
               no host-path pod, scan_general launched;
               SchedulingBasic/5000Nodes_10000Pods (1024 warm-up pods,
               10000 measured): every pod bound, the lap launched, and a
               small-batch drive (max_batch 64: 40 pods, the scan path)
               that must launch scan_general;
               PreferredTopologySpreading/5000Nodes_5000Pods: every pod
               bound;
               SchedulingPodAntiAffinity/5000Nodes_2000Pods: every pod
               bound, at most one per node, the lap (anti lanes) launched;
               SchedulingPodAffinity/5000Nodes_5000Pods: every pod bound,
               all in one zone;
               PreemptionAsync/5000Nodes (5000 nodes of 4 cpu, 2000
               priority-1 pods, 1000 priority-100 pods, which find empty
               nodes: nothing is preempted in this shape): every pod bound,
               the lap launched, no host-path pod;
               Unschedulable/5kNodes/100Init/10kPods with the churner run
               for CHURN_PODS 900-cpu priority-1000 pods: all 10000 measured
               pods bound, every churn pod unschedulable and not nominated,
               dry_run_preemption launched once per churn pod's attempt;
               the preempting case (PreemptionAsync's templates with one
               priority-1 4-cpu pod on each of the 5000 nodes, then 256
               priority-100 4-cpu preemptors): every preemptor bound on the
               node its preemption nominated, one victim each, no
               verification divergence, dry_run_preemption and scatter_rows
               launched; the nominated-lane drive (the same templates, 64
               preemptors nominated, then, with the queue's clock held so
               that they wait out their backoff, 512 priority-1 pods deleted
               elsewhere and 544 priority-1 pods created): the lap with the
               live lane lands 512 on the freed nodes and none on a
               nominated one, 32 stay unschedulable, and every preemptor
               then binds on its nominated node;
               the completion waves (incremental resume): SchedulingBasic's
               cluster and 1024 warm pods, then 10 waves of 1000 pods, each
               after 100 bound pods are deleted; a NoSchedule taint added in
               wave 3 and lifted in wave 5, a bound-pod delete and 512 pods
               parked in the inbox during wave 7's session, a
               PreferNoSchedule taint in wave 9 and a node added in wave 10:
               every pod bound, exactly 3 full plan rebuilds (the warm pods,
               waves 9 and 10), every other wave a row patch or a resume,
               wave 7 one session, wave 9 on scan_general, patch_carry_rows
               and scatter_rows launched; then the same drive with resume
               off (a TorchScheduler argument), which must give the same
               assignments;
               SchedulingRequiredPodAntiAffinityWithNSSelector/5000Nodes_2000Pods
               (6000 nodes, 101 team: devops namespaces, 100 x 40 init pods,
               2000 pods with hostname anti-affinity under a
               namespaceSelector): the init phase in at most 2 plan
               acquisitions (and the count with resume off), every measured
               pod bound on a node of its own that holds no init pod;
               SchedulingGangs/1000Nodes_250Groups (1000 nodes over 10 zones,
               250 pod groups of 4 500m/256Mi members): every pod bound by
               gang device sessions, none on the host path, the lap or
               scan_general launched;
               SchedulingGangsPlacement/5000Nodes_250Groups (the same groups
               constrained to one zone, under the placement plugins, on
               TopologySpreading's 5000 nodes over 50 zones): every pod
               bound, each group in one zone, 250 device placement
               evaluations and 250 schedule_placements launches, none on the
               host path; and the same groups on the JAX config's own shape,
               SchedulingGangsPlacement/1000Nodes_250Groups (1000 nodes over
               10 zones, floor 60 pods/s), pods/s printed beside the floor;
               ChurnDriftRebalance/5000Nodes_Rebalance, the descheduler
               (bench.rebalance: 2000 2000m/4Gi pods on 5000 nodes of the
               hollow plane's default shape over 100 zones, every node's cpu
               and memory skewed in place by the hollow plane's formula
               (imbalance 0.4, seed 20) and every 100th tainted NoSchedule,
               then descheduler ticks of 128 x 5000 what-if batches, each
               followed by a scheduler round placing the evicted pods, until
               a tick emits no move): at least one move, no tick with an
               error, whatif_score launched once a tick with candidates,
               every pod bound at the end; each tick's split (encode_batch,
               launch + fetch, best_moves) and scheduler round printed;
               NodeDeclaredFeaturesEnabled/5000Nodes20DeclaredFeatures (the
               5000 nodes each declaring feature-0..19, 5000 init pods, 50000
               measured pods): every pod bound, the lap launched;
               SchedulingWhileGated/1Node_10000GatedPods (one node of 1000
               cpu / 4Ti / 90000 pods, 10000 gated pods, 20000 pods in
               `deleting` deleted at 50/s during the window, 20000 measured
               pods): every measured pod bound, the gated pods parked;
               HostPorts/5000Nodes_4000Pods (1000 port holders on nodes
               0-999, 4000 pods with TCP hostPort 8080 and a 600 MiB image
               that 10 of the 50 zones' nodes report): every pod on a node of
               its own, the lap with the blocked lane and image scores, and
               one more pod unschedulable by NodePorts; the host-port drive
               cut to 1000 nodes at max_batch 64, without and with a zone
               spread (scan_general with the lane, on the scan path and a
               general plan), and
               SchedulingGangsPlacement/1000Nodes_250Groups cut to 50 groups
               whose members hold hostPort 9000 (schedule_placements with the
               lane); the volume shapes at 5000 nodes with no zone label,
               every pod with its own pre-bound 1Gi ReadOnlyMany PV and claim
               and one measured pod scheduled before the window —
               SchedulingCSIPVs/5000Nodes_5000Pods (CSINodes allowing 39
               ebs.csi.aws.com attachments: the lap with the aux lane on
               every dispatch), SchedulingInTreePVs/5000Nodes_2000Pods (no
               driver: no plan with the lane) and CSIAttachLimit/
               5000Nodes_9000Pods (a limit of 3, 15000 slots for 14000 pods):
               every pod bound on the device, no node past its limit; and the
               attach-limit cuts (1000 nodes allowing 2, 100 init pods, then
               1950 pods: every node filled, the rest unschedulable by
               NodeVolumeLimits) at max_batch 1024 (the lap), 64 (the
               scan path) and 64 with a zone spread over 10 zones (both
               scan_general), each with the lane on every dispatch;
               under a mesh of 4 shards on one card (one device repeated,
               make_mesh(devices=[cuda:0] * 4)): SchedulingBasic/5000Nodes_10000Pods,
               pod for pod as the unsharded run, through the sharded lap
               (one sharded_lap launch a dispatch, no one-device lap, pods/s
               labelled as 4 shards on one card: no multi-GPU number); a
               TopologySpreading cut (1000 nodes) on the gathered path;
               delta-resume waves (1000 nodes, deletes and taint flips, one
               full rebuild, scatter_rows and patch_carry_rows a shard); each
               equal to the unsharded run and to the same cut under a CPU
               mesh; and a two-cell sharded_schedule_batch draw (8 shards)
               equal to each cell's single-device run and the CPU run;
  4. timing  — on the main paths' own next-batch inputs (exactness checked
               there too): each kernel's device time per launch from
               torch.profiler (a warm-up step, then at least 19 of 20
               launches seen, the count kept in the row), its wrapper's wall
               time per call (host work included) and its plain version's,
               from CUDA events, beside the least time the card could take
               for what the run's data needs; the schedule kernels
               also with a random nominated-pod lane on the same inputs, and
               the lap on the nominated-lane drive's own session with and
               without its lane;
               scan_general also on PreferredTopologySpreading's and
               SchedulingPodAffinity's next batch, and on the scan path's
               row-local plan (SchedulingBasic's next batch at 64 steps,
               its `row_local` entry); dry_run_preemption on Unschedulable's own dry-run
               inputs (a churn pod against the 10000 bound pods) and on
               the preempting case's (a preemptor after its 256), with
               the host's build and copy of the victim tensors; the
               launch floor (a one-element fill_) and static_masks' and
               resource_eval's call splits (allocation, argument checks,
               launch); resource_eval also on TopologySpreading's fresh
               batch and with a nominated lane under MostAllocated; and
               scatter_rows at the preempting case's rows per flush, with
               index_copy per field (a library call) beside it, and the
               whole flush (NodeStateMirror._scatter_dirty: host ms a call
               and every device op it issues, summed) at the preempting
               case's and the placement drive's rows per flush and at 64
               and 2048 rows;
               patch_carry_rows on the completion waves' own patches (each
               tier the drive used), with the whole carry call
               (NodeStateMirror.patch_carry) timed the same way, and the
               drive's plan acquisition
               seconds by kind (row patch, resume, full rebuild; and full
               rebuilds with resume off) beside it; schedule_placements on
               the placement drive's first group cycle (its 64 lanes and
               plan), its bound summed over the real lanes; whatif_score on
               the rebalance drive's first what-if batch (no library call
               computes it), with the whole score call (whatif_scores: host
               ms a call and every device op it issues, summed); the three schedule kernels with the blocked lane
               on their own drives' first dispatch (the `blocked` entry of
               each row); and with the aux lane (the `aux` entry): the lap on
               SchedulingCSIPVs' first full measured batch, the scans on
               their attach-limit cuts' first batch, schedule_placements on
               a seeded 16-lane draw at NP 8192 (no path launches it
               with the lane: volume members of a placement group take
               the host simulation); the sharded lap on SchedulingBasic's
               next batch at S = 1, 2, 4 and 8 on one card: ms a dispatch,
               the device time of its one launch and us a lap, launches and
               device-to-host copies a dispatch (the counter and
               torch.profiler), its plain version and bound, beside the
               one-device lap; the mesh waves' sharded carry patch and
               dirty-row scatter, with the device time of a shard's launch;
  5. parity  — a 500-node cluster with NoSchedule and PreferNoSchedule
               taints, unschedulable nodes, node selectors, pods that fit no
               node, zone and hostname spread, required and preferred
               (anti-)affinity and preferred node affinity: the cuda run's
               assignments and failure counts must equal the port's
               device="cpu" run (the plain versions, which the repository's
               tests hold equal to the JAX package), at max_batch 1024 and
               64; TopologySpreading's first measured batch (1024 pods after
               the 1000 warm pods) at the full 5000 nodes — cut from the
               5000 measured pods so that the CPU run stays short;
               PreemptionAsync/50Nodes (10 preemptions), the preempting
               case and the nominated-lane drive of phase 3: the cuda runs'
               victims, nominations and assignments must equal the
               device="cpu" runs', with no verification divergence; the
               completion waves and the NSSelector drive: the cuda runs'
               assignments and plan-acquisition counters must equal the
               device="cpu" runs'; pod groups: a 60-node, 3-zone cluster
               under the placement plugins (groups that fit, a group too
               big for one zone's min_count, one that fits nowhere, groups
               with hostname DoNotSchedule and zone ScheduleAnyway spread
               members), pod-group preemption on 8 full nodes, the gang
               drive at full size and the placement drive at its 5000 nodes
               with PLACE_PARITY_GROUPS groups: bindings, victims and
               counters equal; the rebalance drive cut to REBAL_PARITY (1000
               nodes, 400 pods, at most 5 ticks): planned intents, eviction
               ledger, counters and final bindings equal; the host-port cuts
               (the scan path, a zone spread), the port gangs,
               SchedulingWhileGated/1Node_10GatedPods and a 1000-node cut
               whose odd nodes alone declare the feature the pods require:
               bindings, failure and queue counts equal; the three
               attach-limit cuts and a host-path cut (500 nodes, 200 pods
               with unbound WaitForFirstConsumer claims, half matched by
               PVs pinned to a node, half provisioned by an attached PV
               controller): bindings, device and host-path pods, failure and
               queue counts equal;
  6. output  — a `{"kernels": [...]}` line, the card's name and power limit
               as nvidia-smi prints them, and last
               `{"ok": true, "device": {...}}`.

    python3 chip_smoke.py --cards N

runs the node-sharded mesh across N cards of one host, one shard a card,
in place of the phases above: the build; SchedulingBasic/5000Nodes_10000Pods
unsharded on cuda:0 and under make_mesh() over the N cards, pod for pod
equal, one sharded_lap launch a card a dispatch and no one-device lap;
the mesh's delta-resume waves against the unsharded ones; the sharded lap
on the path's next batch, exact against the one-device lap and its plain
version, timed a dispatch and a lap (its exchanges through pinned host
memory) across the N cards beside N shards on cuda:0; an exchange buffer
in another card's memory refused; then a `{"cards": {...}}` line, every
card's name and power limit, and the same last line.

It imports neither jax nor kubernetes_tpu. With no CUDA device (or fewer
than N), or without the rest of the repository beside it, it exits
non-zero with no result.
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
CHURN_PODS = 10             # churn pods of the Unschedulable drive
PREEMPTORS = 256            # preemptors of the full-width preempting case
PREEMPT = "PreemptionAsync/5000Nodes"
UNSCHED = "Unschedulable/5kNodes/100Init/10kPods"
GANGS = "SchedulingGangs/1000Nodes_250Groups"
PLACE = "SchedulingGangsPlacement/5000Nodes_250Groups"
PLACE1K = "SchedulingGangsPlacement/1000Nodes_250Groups"
PLACE_PARITY_GROUPS = 50    # depth of the placement drive's cuda/cpu parity runs
REBAL = "ChurnDriftRebalance/5000Nodes_Rebalance"
REBAL_PARITY = dict(nodes=1000, pods=400, max_ticks=5)   # the drive's cuda/cpu parity cut


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


def traced(fn, reps: int) -> list:
    """(name, µs) of every CUDA op of `reps` calls of `fn`, from
    torch.profiler. The calls are traced in the schedule's active step,
    after a warm-up step of the same calls: launches in the first moments
    of a trace can go unrecorded."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    got = []

    def keep(prof):
        # The step's own annotation is on the device timeline too and spans
        # the whole step: it is no op of `fn`.
        got.extend((e.name, e.time_range.end - e.time_range.start) for e in prof.events()
                   if e.device_type == DeviceType.CUDA and not e.name.startswith("ProfilerStep"))

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=keep) as prof:
        for _step in range(2):
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            prof.step()
    return got


def device_ms(fn, kernel: str, reps: int = 20, pick=None) -> tuple:
    """(mean device ms of one launch, launches the profiler saw) of the
    `<kernel>_kernel` that `fn` launches (or of the CUDA events whose name
    `pick` accepts), from torch.profiler's CUDA kernel
    events: the kernel alone, without the host work of its wrapper. At
    least reps - 1 of the reps launches must be seen in one trace; a trace
    that saw fewer is taken again, up to five traces (what it did see is
    printed). The profiler on the card can lose a trace's CUDA events; when
    every trace lost launches, the reps calls are timed back to back with
    CUDA events instead and 0 launches seen is returned: that time is the
    kernel's with its wrapper's enqueue, an upper bound."""
    pick = pick or (lambda name: f"{kernel}_kernel" in name)
    for attempt in range(5):
        events = traced(fn, reps)
        spans = [us for name, us in events if pick(name)]
        if len(spans) >= reps - 1:
            return sum(spans) / len(spans) / 1e3, len(spans)
        names = sorted({name for name, _us in events})
        print(f"device_ms: trace {attempt + 1} saw {len(spans)} of {reps} {kernel} launches "
              f"({len(events)} CUDA events: {names[:6]})", flush=True)
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    ms = a.elapsed_time(b) / reps
    print(f"device_ms: {kernel} timed with CUDA events over {reps} calls back to back: "
          f"{ms:.6f} ms a call (the profiler lost its launches)", flush=True)
    return ms, 0


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
    input (the lap at 1024 steps, scan_general on the scan path's 64), over
    the fit strategies, fresh and chained through the carry."""
    errs = {}
    for strat in strategies:
        m_k, m_p = K.static_masks(st, ft), K._static_masks_plain(st, ft)
        errs["static_masks"] = max(errs.get("static_masks", 0), max_abs_err(m_k, m_p))
        r_args = (ft, strat, st.alloc_r, st.alloc_pods, st.req_r, st.nonzero, st.pod_count)
        r_k, r_p = K.resource_eval(*r_args), K._resource_eval_plain(*r_args)
        errs["resource_eval"] = max(errs.get("resource_eval", 0), max_abs_err(r_k, r_p))
        ext0 = K.fresh_carry(st, ft, ft.dns_counts.shape[1], r_p)
        facts = K.PlanFacts()  # row-local: the lap at 1024 steps, the scan path at 64
        for name, wrap, plain in (
                ("lap_schedule", lambda c: K.lap_schedule(st, ft, 1024, strat, c, m_p.static_ok,
                                                          1024),
                 lambda c: K._lap_schedule_plain(st, ft, 1024, strat, c, m_p.static_ok, 1024)),
                ("scan_general", lambda c: K.scan_general(st, ft, 64, strat, c, m_p, 64, facts),
                 lambda c: K._scan_general_plain(st, ft, 64, strat, c, m_p, 64, facts))):
            ck = cp = ext0
            for _chain in range(2):  # fresh, then chained through the carry
                o_k, ck = wrap(ck)
                o_p, cp = plain(cp)
                errs[name] = max(errs.get(name, 0),
                                 max_abs_err((o_k,) + tuple(ck), (o_p,) + tuple(cp)))
        torch.cuda.synchronize()
    return errs


def compare_general(K, st, ft, facts, B, strategies=(0, 1), prep=None) -> tuple:
    """(max_abs_err, pods placed) of scan_general against its plain version
    on one input, over the fit strategies, fresh and chained. `prep(carry,
    strategy)` sets the fresh carry's lanes where a draw has them."""
    err = placed = 0
    masks = K._static_masks_plain(st, ft)
    for strat in strategies:
        fit = K._resource_eval_plain(ft, strat, st.alloc_r, st.alloc_pods, st.req_r,
                                     st.nonzero, st.pod_count)
        ck = cp = K.fresh_carry(st, ft, ft.dns_counts.shape[1], fit)
        if prep is not None:
            ck = cp = prep(ck, strat)
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
    general_phase(K, dev, np_cap, n_nodes, errs)
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
    lap_phase(K, dev, np_cap, n_nodes, errs)
    lane_phase(K, dev, np_cap, n_nodes, errs)
    dry_run_phase(K, dev, np_cap, n_nodes, errs)
    masks_phase(K, dev, errs)
    resource_phase(K, dev, errs)
    scatter_phase(K, dev, np_cap, n_nodes, errs)
    patch_phase(K, dev, np_cap, n_nodes, errs)
    hazard_phase(K, dev, errs)
    placement_phase(K, dev, np_cap, n_nodes, errs)
    blocked_phase(K, dev, np_cap, n_nodes, errs)
    aux_phase(K, dev, np_cap, n_nodes, errs)
    whatif_phase(dev, n_nodes, errs)
    whatif_hazard(dev, errs)
    mesh_kernel_phase(dev, np_cap, n_nodes, errs)
    torch.cuda.synchronize()
    print(f"kernels vs plain: max_abs_err {errs}", flush=True)
    for name, e in errs.items():
        check(e == 0, f"{name} disagrees with its plain version (max_abs_err {e})")
    return errs


LAP_ABOVE_TIER = (20000, 19990)   # rows and live rows of the lap draw past the on-chip tier


def lap_draw(K, st, ft, B: int, n_act: int, ports: bool = False, aux: bool = False,
             prep=None) -> tuple:
    """(max_abs_err, pods placed, laps, smallest L, largest L) of the lap
    kernel against its plain version on one draw, both fit strategies,
    fresh and chained; `prep(carry, strategy)` sets the fresh carry's lanes."""
    static_ok = K._static_masks_plain(st, ft).static_ok
    err = placed = laps = 0
    sizes = []
    for strat in (0, 1):
        ck = cp = K.fresh_carry(st, ft, max(ft.anti_counts.shape[1], 1), K._resource_eval_plain(
            ft, strat, st.alloc_r, st.alloc_pods, st.req_r, st.nonzero, st.pod_count,
            *K._nom_lane(ft)))
        if prep is not None:
            ck = cp = prep(ck, strat)
        for _chain in range(2):
            stats = {}
            o_k, ck = K.lap_schedule(st, ft, B, strat, ck, static_ok, n_act, ports, aux)
            o_p, cp = K._lap_schedule_plain(st, ft, B, strat, cp, static_ok, n_act, ports, aux,
                                            stats=stats)
            err = max(err, max_abs_err((o_k,) + tuple(ck), (o_p,) + tuple(cp)))
            placed += int((o_p[0] >= 0).sum())
            laps += stats["laps"]
            sizes += stats["lap_sizes"]
    torch.cuda.synchronize()
    return err, placed, laps, min(sizes), max(sizes)


def lap_phase(K, dev, np_cap: int, n_nodes: int, errs: dict) -> None:
    """The lap kernel against its plain version on the edges of its design
    (csrc/lap_schedule.cu): to_find 1; windows held at LAP_MAX with the
    rest spilling to the next lap, `start` inside a chunk, at 0 and past
    `num`; no feasible row; fewer feasible rows than to_find; rows not a
    multiple of 32 with fewer live rows; a scalar resource as a third fit
    slot; each lane (nominated, blocked, aux,
    hostname anti-affinity), two anti-affinity terms on a rack axis (values
    repeat over rows), every lane at once; NP 16384 (the on-chip tier's
    top) and NP 20000 (the row state in device memory). One line a draw."""
    from kubernetes_tpu_torch.testing.kernel_inputs import (HOST_AXIS, RACK_AXIS, aux_lane,
                                                            general_inputs, nominated_lane,
                                                            with_aux_lane, with_nominated_lane)

    gen = torch.Generator().manual_seed(1400)

    def draw(seed, cap, live, nom=False, ports=False, aux=False, anti=0, axis=None,
             scalar=False, **kw):
        s, f, _facts = general_inputs(seed, cap, live, vmax=8192 if axis == HOST_AXIS else 64,
                                      anti=anti, anti_axis=axis, **kw)
        if nom:
            f = with_nominated_lane(f, nominated_lane(seed, cap, live))
        cnt = None
        if aux:
            room, inc, cnt = aux_lane(seed, cap, live)
            f = with_aux_lane(f, room, inc)
        st, ft = to_device(dev, s, f)
        if anti:
            ft = ft._replace(anti_self=torch.ones_like(ft.anti_self))
        if scalar:  # a scalar resource requested and scored as a third fit slot
            ft = ft._replace(request=ft.request.index_fill(0, torch.tensor([3], device=dev), 1),
                             fit_slots=torch.tensor([0, 1, 3], dtype=torch.int32, device=dev),
                             fit_weights=torch.tensor([1, 1, 2], dtype=torch.int64, device=dev))

        def prep(ext0, strat):
            if ports:
                ext0 = ext0._replace(blocked=(torch.rand(ext0.blocked.shape, generator=gen)
                                              < 0.3).to(dev))
            if aux and strat == 0:
                ext0 = ext0._replace(aux_cnt=torch.from_numpy(cnt).to(dev))
            return ext0
        return st, ft, prep

    tf_few = dict(to_find=n_nodes)  # above the feasible rows: L is 1 every lap
    # (case, seed, rows, live rows, steps, active pods, draw keywords)
    cases = (
        ("to_find 1", 1400, np_cap, n_nodes, 1024, 1024, dict(to_find=1)),
        ("L = LAP_MAX with spill, start inside a chunk", 1401, np_cap, n_nodes, 1024, 1000,
         dict(to_find=20, start=2411)),
        ("start 0", 1402, np_cap, n_nodes, 1024, 1024, dict(to_find=100, start=0)),
        ("start past num", 1403, np_cap, n_nodes, 1024, 1024, dict(to_find=60, start=6000)),
        ("no feasible row", 1404, np_cap, n_nodes, 128, 128, dict(infeasible=True)),
        ("fewer feasible rows than to_find", 1405, np_cap, n_nodes, 128, 128, tf_few),
        ("rows not a multiple of 32", 1406, np_cap - 3, n_nodes + 3, 1024, 1024,
         dict(to_find=37)),
        ("three fit slots, a scalar resource", 1415, np_cap, n_nodes, 256, 256,
         dict(scalar=True, to_find=50)),
        ("nominated lane", 1407, np_cap, n_nodes, 1024, 1024, dict(nom=True, to_find=50)),
        ("blocked lane", 1408, np_cap, n_nodes, 512, 512, dict(ports=True, to_find=50)),
        ("aux lane", 1409, np_cap, n_nodes, 1024, 1024, dict(aux=True, to_find=50)),
        ("hostname anti-affinity", 1410, np_cap, n_nodes, 1024, 1024,
         dict(anti=1, axis=HOST_AXIS, to_find=50)),
        ("two anti-affinity terms on a rack axis (values repeat)", 1411, np_cap, n_nodes, 256,
         256, dict(anti=2, axis=RACK_AXIS, to_find=50)),
        ("every lane", 1412, np_cap, n_nodes, 256, 256,
         dict(nom=True, ports=True, aux=True, anti=2, axis=RACK_AXIS, to_find=40)),
        ("NP 16384", 1413, 16384, 15000, 1024, 1024, {}),
        (f"NP {LAP_ABOVE_TIER[0]}, above the on-chip tier", 1414, *LAP_ABOVE_TIER, 1024, 1024,
         dict(to_find=300)),
    )
    for case, seed, cap, live, B, n_act, kw in cases:
        st, ft, prep = draw(seed, cap, live, **kw)
        err, placed, laps, lo, hi = lap_draw(K, st, ft, B, n_act, kw.get("ports", False),
                                             kw.get("aux", False), prep)
        errs["lap_schedule"] = max(errs["lap_schedule"], err)
        print(f"lap_schedule {case} (NP {cap}, {live} live rows, B {B}): max_abs_err {err}, "
              f"{laps} laps over 2 strategies x fresh+chained, L {lo}..{hi}, {placed} placed",
              flush=True)
        check(err == 0, f"lap_schedule disagrees with its plain version: {case}")
        check(placed > 0 or case == "no feasible row", f"lap_schedule {case}: nothing placed")
        check(case != "to_find 1" or hi == K.LAP_MAX, "the to_find 1 draw never reached LAP_MAX")
        check(case != "fewer feasible rows than to_find" or hi == 1,
              "the few-feasible draw took more than one pod a lap")


def general_phase(K, dev, np_cap: int, n_nodes: int, errs: dict) -> None:
    """scan_general against its plain version on seeded draws: the plan
    kinds (full and incremental feasibility, carried and normalized scores,
    each table kind, the zone and hostname value tiers), and the edges of
    the kernel's on-chip design: a row count that is no multiple of a
    warp's 32-row chunk or of the block, 16384 rows (SchedulingDaemonset's
    15000 nodes, the row state on chip), 65536 rows (above it: value ids
    and totals in device memory), a hostname spread at V = 8192, GEN_MAXC
    spread constraints (9 live, 7 padded with max skew 2^40), more than
    GEN_MAXC tables of every other kind (read in device memory past the
    first GEN_MAXC, 33 a kind past the landing warp's 32 lanes), and every
    table and lane at once (nominated, blocked, aux, fit weights 1 and 2);
    fresh and chained."""
    from kubernetes_tpu_torch.testing.kernel_inputs import (HOST_AXIS, aux_lane, general_inputs,
                                                            nominated_lane, with_aux_lane,
                                                            with_nominated_lane)

    every = dict(dns=2, sa=2, anti=1, aff=2, kd=2, pns=True, ipa_base=True, na=True)
    # (draw arguments, rows, live rows, value tier, steps, seed)
    general = {
        "spread-zone": (dict(dns=1), np_cap, n_nodes, 64, 1024, 200),  # full feasibility, carried
        "spread-soft-pns": (dict(sa=1, pns=True), np_cap, n_nodes, 64, 1024, 201),  # incremental
        "affinity-bootstrap": (dict(aff=1, kd=1, ipa_base=True, bootstrap=True), np_cap, n_nodes,
                               64, 1024, 202),
        "anti-affinity-na": (dict(anti=2, na=True), np_cap, n_nodes, 64, 1024, 203),
        "all-lanes": (dict(dns=2, sa=1, anti=1, aff=1, kd=1, pns=True, ipa_base=True, na=True),
                      np_cap, n_nodes, 8192, 64, 204),
        "hostname-anti": (dict(anti=1, anti_axis=HOST_AXIS), np_cap, n_nodes, 8192, 64, 205),
        "odd-rows": (dict(dns=1, sa=1), 5003, 4999, 64, 64, 256),
        "rows-16384": (dict(dns=1), 16384, 15000, 64, 64, 257),
        "rows-65536": (dict(dns=1, sa=1), 65536, 60000, 64, 32, 208),
        "hostname-spread": (dict(dns=1, dns_axis=HOST_AXIS), np_cap, n_nodes, 8192, 256, 209),
        "c1-gen-maxc": (dict(dns=9), np_cap, n_nodes, 64, 64, 360),
        "every-lane": (every, np_cap, n_nodes, 8192, 64, 311),
        # 17 anti terms (A1 32), 17 ScheduleAnyway constraints, 33 landing deltas (KD 64)
        "tables-past-maxc": (dict(dns=1, sa=17, anti=17, kd=33, anti_axis=HOST_AXIS, pns=True),
                             np_cap, n_nodes, 8192, 64, 312),
        "tables-past-maxc-incremental": (dict(sa=17, anti=33, anti_axis=HOST_AXIS), np_cap,
                                         n_nodes, 8192, 64, 313),
        "affinity-past-maxc": (dict(aff=33, sa=2, kd=2, bootstrap=True), np_cap, n_nodes, 64, 64,
                               314),
    }
    for gi, (case, (kw, cap, live, vmax, B, seed)) in enumerate(general.items()):
        s, f, facts = general_inputs(seed, cap, live, vmax=vmax, **kw)
        prep = None
        if case == "every-lane":
            room, inc, cnt = aux_lane(seed, cap, live)
            f = with_aux_lane(with_nominated_lane(f, nominated_lane(seed, cap, live)), room, inc)
            facts = dict(facts, port_selfblock=True, has_aux=True)
            gen = torch.Generator().manual_seed(seed)

            def prep(carry, strat, cnt=cnt, gen=gen, cap=cap):
                blocked = (torch.rand(cap, generator=gen) < 0.3).to(dev)
                return carry._replace(blocked=blocked, aux_cnt=torch.from_numpy(cnt).to(dev)
                                      if strat == 0 else carry.aux_cnt)
        st, ft = to_device(dev, s, f)
        if case == "every-lane":  # fit weights whose sum is no power of two
            ft = ft._replace(fit_weights=torch.tensor([1, 2], dtype=torch.int64, device=dev))
        check(ft.dns_axis.shape[0] <= K.GEN_MAXC, f"the scan_general draw {case} has too many "
              "spread constraints")
        if gi == 0:
            first, second = first_launch_ms(K, st, ft, K.PlanFacts(**facts), B)
            print(f"scan_general's first launch in the process (no active step): {first:.3f} ms "
                  f"a call, the next: {second:.3f} ms", flush=True)
        e, placed = compare_general(K, st, ft, K.PlanFacts(**facts), B, prep=prep)
        print(f"scan_general {case} (NP {cap}, {live} rows, C1 {ft.dns_axis.shape[0]}, V {vmax}, "
              f"B {B}): max_abs_err {e}, {placed} pods placed over 2 strategies x "
              "fresh+chained", flush=True)
        check(placed > 0, f"the scan_general draw {case} placed nothing")
        errs["scan_general"] = max(errs["scan_general"], e)


def lane_phase(K, dev, np_cap: int, n_nodes: int, errs: dict) -> None:
    """The schedule kernels with a live nominated-pod lane (the lap, and
    scan_general on the scan path and a spread plan), both fit strategies,
    fresh and chained."""
    from kubernetes_tpu_torch.testing.kernel_inputs import (general_inputs, nominated_lane,
                                                            random_inputs, with_nominated_lane)

    s, f = random_inputs(400, np_cap, n_nodes)
    st, ft = to_device(dev, s, with_nominated_lane(f, nominated_lane(400, np_cap, n_nodes)))
    lane = compare(K, st, ft)
    s, f, facts = general_inputs(401, np_cap, n_nodes, vmax=64, dns=1)
    st, ft = to_device(dev, s, with_nominated_lane(f, nominated_lane(401, np_cap, n_nodes)))
    e, placed = compare_general(K, st, ft, K.PlanFacts(**facts), 64)
    lane["scan_general"] = max(lane["scan_general"], e)
    check(placed > 0, "the nominated-lane scan_general draw placed nothing")
    print(f"schedule kernels with a nominated-pod lane vs plain: max_abs_err {lane}", flush=True)
    for name, e in lane.items():
        errs[name] = max(errs[name], e)


# The dry run's edge draws: (K, victim_edge_inputs keyword arguments).
DRY_EDGES = ([(8, dict(r_slots=r)) for r in (1, 7, 8, 9, 33, 64)]
             + [(8, kw) for kw in (dict(past_num=True), dict(no_request=True),
                                   dict(enable_off=(4,)), dict(taints=0), dict(tolerations=0),
                                   dict(pad_taints=True), dict(taints=160, pad_taints=True))]
             + [(8, dict(enable_off=(i,))) for i in range(4)]
             + [(k, kw) for k in (64, 256)
                for kw in ({}, dict(r_slots=33, past_num=True), dict(r_slots=64))])
# static_masks' edge draws: (rows, live rows, static_edge_inputs keyword arguments).
MASK_EDGES = ([(8192, 5000, kw) for kw in (
    {}, dict(taints=0), dict(tolerations=0), dict(taints=0, tolerations=0), dict(pad_taints=True),
    dict(taints=40, pad_taints=True), dict(tolerations=7))]
    + [(8192, 5000, dict(enable_off=(i,))) for i in range(4)]
    + [(5003, 4000, {}), (37, 30, dict(tolerations=0))])


def dry_run_phase(K, dev, np_cap: int, n_nodes: int, errs: dict) -> None:
    """dry_run_preemption against its plain version on seeded victim draws,
    then on the edges of its design (DRY_EDGES: 1 to 64 resource slots, two
    slots a lane past 32; K 8, 64 and 256, victims past the register tier;
    victims on rows past num_nodes; a pod without requests; the fit and
    static gates off; no taint, no toleration, padded taints and 160 taint
    slots, past the shared-memory stage)."""
    from kubernetes_tpu_torch.testing.kernel_inputs import victim_edge_inputs, victim_inputs

    draws = [(k, kw, victim_inputs(500 + k, np_cap, n_nodes, k, **kw))
             for k, kw in ((8, {}), (32, {}), (256, {}), (8, dict(infeasible=True)))]
    draws += [(k, kw, victim_edge_inputs(900 + k + i, np_cap, n_nodes, k, **kw))
              for i, (k, kw) in enumerate(DRY_EDGES)]
    for k, kw, (s, f, vr, vv) in draws:
        st, ft = to_device(dev, s, f)
        args = (st, ft, torch.from_numpy(vr).to(dev), torch.from_numpy(vv).to(dev), k)
        got, want = K.dry_run_preemption(*args), K._dry_run_preemption_plain(*args)
        e = max_abs_err((got,), (want,))
        errs["dry_run_preemption"] = max(errs["dry_run_preemption"], e)
        cands, empty = int(want[:, 0].sum()), int((vv[:n_nodes].sum(axis=1) == 0).sum())
        print(f"dry_run_preemption K {k} R {vr.shape[2]} {kw}: max_abs_err {e}, "
              f"{cands} candidate rows, {int(want[:, 1:].sum())} victims, "
              f"{empty} rows without a victim", flush=True)
        check(empty > 0, "the victim draw has no row without a victim")
        no_fit = kw.get("infeasible") or 4 in kw.get("enable_off", ())
        check((cands == 0) if no_fit else (cands > 0), f"dry run K {k} {kw}: {cands} candidates")


def masks_phase(K, dev, errs: dict) -> None:
    """static_masks against its plain version on the edges of its design
    (MASK_EDGES): no taint or toleration, padded taints, 40 taint slots,
    seven tolerations, each gate off, rows not a multiple of the block or
    of 8."""
    from kubernetes_tpu_torch.testing.kernel_inputs import static_edge_inputs

    for i, (NP, n, kw) in enumerate(MASK_EDGES):
        st, ft = to_device(dev, *static_edge_inputs(1300 + i, NP, n, **kw))
        want = K._static_masks_plain(st, ft)
        e = max_abs_err(K.static_masks(st, ft), want)
        errs["static_masks"] = max(errs["static_masks"], e)
        print(f"static_masks NP {NP} T {st.taint_key.shape[1]} L {ft.tol_key.shape[0]} {kw}: "
              f"max_abs_err {e}, {int(want.static_ok.sum())} static_ok rows, "
              f"{int(want.pns_cnt.sum())} PreferNoSchedule taints", flush=True)


# resource_eval's edge draws: (rows, live rows, resource slots, fit slots).
RESOURCE_EDGES = ([(NP, n, 7, 2) for NP, n in ((1, 1), (63, 60), (64, 64), (65, 50),
                                              (5003, 4990), (8192, 5000))]
                  + [(8192, 5000, R, FR) for R in (2, 3, 7, 9, 40, 50)
                     for FR in sorted({0, 1, R // 2, R})])


def resource_phase(K, dev, errs: dict) -> None:
    """resource_eval against its plain version on the edges of its design
    (RESOURCE_EDGES, each with and without a nominated lane, both fit
    strategies): rows below, at and past one block and the last block
    partial; R 2 to 50 and FR 0 to R; rows whose divisions leave
    lap_floor_div's fast paths; and rows passed as views 8 bytes off their
    allocation. One launch each, the inputs left unchanged."""
    from kubernetes_tpu_torch.testing.kernel_inputs import resource_edge_inputs

    worst = draws = 0
    for i, (NP, n, R, FR) in enumerate(RESOURCE_EDGES):
        for lane in (False, True):
            st, ft = to_device(dev, *resource_edge_inputs(1500 + i, NP, n, r_slots=R,
                                                          fit_slots=FR, lane=lane))
            for strat in (0, 1):
                args = (ft, strat, st.alloc_r, st.alloc_pods, st.req_r, st.nonzero,
                        st.pod_count, *K._nom_lane(ft))
                before = [t.clone() for t in args[2:] if t is not None]
                launches = K.resource_eval.launches
                got, want = K.resource_eval(*args), K._resource_eval_plain(*args)
                e = max_abs_err(got, want)
                check(K.resource_eval.launches == launches + 1, "resource_eval: no launch")
                check(max_abs_err(before, [t for t in args[2:] if t is not None]) == 0,
                      "resource_eval wrote into an input")
                worst, draws = max(worst, e), draws + 1
                print(f"resource_eval NP {NP} R {R} FR {FR}{' lane' if lane else ''} strategy "
                      f"{strat}: max_abs_err {e}, {int(want[0].sum())} fit rows", flush=True)

    def off8(t):  # t's values in a view 8 bytes into a new allocation
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        buf[1:].copy_(t.reshape(-1))
        return buf[1:].view(t.shape)

    st, ft = to_device(dev, *resource_edge_inputs(1590, 8192, 5000, lane=True))
    for strat in (0, 1):
        args = (ft, strat, off8(st.alloc_r), st.alloc_pods, off8(st.req_r), off8(st.nonzero),
                st.pod_count, off8(ft.nom_req), ft.nom_pods)
        e = max_abs_err(K.resource_eval(*args), K._resource_eval_plain(*args))
        worst, draws = max(worst, e), draws + 1
        print(f"resource_eval NP 8192 rows 8 bytes off their allocation, lane, strategy "
              f"{strat}: max_abs_err {e}", flush=True)
    errs["resource_eval"] = max(errs["resource_eval"], worst)
    print(f"resource_eval on its design's edges: max_abs_err {worst} over {draws} draws",
          flush=True)


SCATTER_DRAWS = (
    # NP, rows, R, T, K, order, in place
    (8192, 1, 7, 4, 4, "sorted", False),
    (8192, 64, 7, 4, 4, "sorted", False),
    (8192, 2048, 7, 4, 4, "sorted", False),
    (8192, 4096, 7, 4, 4, "shuffled", False),
    (8192, 64, 7, 4, 4, "shuffled", True),
    (5003, 64, 7, 4, 4, "shuffled", False),   # NP not a multiple of the block
    (8192, 64, 1, 0, 0, "sorted", False),     # R 1, no taint slot, no topology axis
    (8192, 64, 9, 3, 5, "shuffled", True),
)


def scatter_phase(K, dev, np_cap: int, n_nodes: int, errs: dict) -> None:
    """scatter_rows against its plain version (clone and index_copy_ per
    field) on SCATTER_DRAWS: a new state, the old one unchanged, or in
    place the given tensors; then a 2048-row flush through the staging
    path (the rows packed into one pinned buffer, one upload)."""
    from kubernetes_tpu_torch.ops import _build
    from kubernetes_tpu_torch.ops.staging import StagingRing
    from kubernetes_tpu_torch.testing.kernel_inputs import scatter_inputs, stage_rows

    block = _build.defines("scatter_rows.cu")["SCATTER_BLOCK_ROWS"]

    def on(arrays):
        return K.DeviceNodeState(*[torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                                   for a in arrays])

    ring = StagingRing(dev)
    for i, (NP, d, R, T, Kx, order, in_place) in enumerate(SCATTER_DRAWS):
        s, at, rows = scatter_inputs(600 + i, NP, d, r_slots=R, taints=T, axes=Kx, order=order,
                                     block_rows=block)
        st, (idx, packed) = on(s), stage_rows(rows, at, ring=ring)
        before = [t.clone() for t in st]
        want = K._scatter_rows_plain(K.DeviceNodeState(*[t.clone() for t in st]), idx, packed,
                                     in_place)
        got = K.scatter_rows(st, idx, packed, in_place=in_place)
        torch.cuda.synchronize()
        e = max_abs_err(tuple(got), tuple(want))
        changed = sum(int((x != y).sum()) for x, y in zip(got, before))
        print(f"scatter_rows NP {NP}, {d} rows {order}, R {R} T {T} K {Kx}"
              f"{' in place' if in_place else ''}: max_abs_err {e}, {changed} elements changed",
              flush=True)
        check(changed > 0, f"the {d}-row scatter changed nothing")
        if in_place:
            check(got is st, "scatter_rows in place returned other tensors")
        else:
            check(max_abs_err(tuple(st), tuple(before)) == 0, "scatter_rows wrote into its input")
        errs["scatter_rows"] = max(errs["scatter_rows"], e)
    s, at, _rows = scatter_inputs(620, 8192, 2048, block_rows=block)
    st = on(s)
    host = [np.ascontiguousarray(a) for a in _rows]
    idx, packed = K.stage_scatter(StagingRing(dev), host[:-1], host[-1], np.arange(2048),
                                  at=at)
    want = K._scatter_rows_plain(st, idx, packed)
    got = K.scatter_rows(st, idx, packed)
    e = max_abs_err(tuple(got), tuple(want))
    print(f"scatter_rows through the staging ring (2048 rows, one upload): max_abs_err {e}",
          flush=True)
    errs["scatter_rows"] = max(errs["scatter_rows"], e)


def patch_phase(K, dev, np_cap: int, n_nodes: int, errs: dict) -> None:
    """patch_carry_rows against its plain version on a carry chained
    through two real schedule_batch calls: K = 32, 256 and 2048 (tiers
    padded with copies of their last real row), with and without a random
    nominated-pod lane, both fit strategies, the input carry left
    unchanged; in place at K 256; at R 9 and at NP 5003 (not a multiple of
    the block); and through the staging path (one upload of the four
    inputs) at K 2048."""
    from kubernetes_tpu_torch.ops.staging import StagingRing
    from kubernetes_tpu_torch.testing.kernel_inputs import (nominated_lane, patch_inputs,
                                                            random_inputs, with_nominated_lane)

    draws = [(np_cap, n_nodes, 7, lane) for lane in (False, True)]
    draws += [(np_cap, n_nodes, 9, True), (5003, 4990, 7, False)]
    for NP, nn, R, lane in draws:
        s, f = random_inputs(800 + lane + R + NP, NP, nn, r_slots=R)
        if lane:
            f = with_nominated_lane(f, nominated_lane(800, NP, nn, r_slots=R))
        st, ft = to_device(dev, s, f)
        for strat in (0, 1):
            carry = None
            for _chain in range(2):
                _out, carry = K.schedule_batch(st, ft, 1024, strat, 64, K.PlanFacts(),
                                               n_active=1024, carry_in=carry)
            for k, tier in ((20, 32), (200, 256), (1500, 2048)):
                inputs = patch_inputs(810 + k + strat, s, nn, k, tier)
                args = (st, ft, carry) + tuple(torch.from_numpy(a).to(dev) for a in inputs) + (
                    strat,)
                before = [t.clone() for t in carry[:6]]
                got, want = K.patch_carry_rows(*args), K._patch_carry_rows_plain(*args)
                e = max_abs_err(tuple(got), tuple(want))
                moved = int((want.fit_ok != carry.fit_ok).sum())
                what = (f"patch_carry_rows NP {NP} R {R} K {tier} ({k} rows)"
                        f"{' lane' if lane else ''} strategy {strat}")
                print(f"{what}: max_abs_err {e}, {moved} fit verdicts moved", flush=True)
                check(moved > 0, f"the {tier}-row carry patch moved no fit verdict")
                check(max_abs_err(before, carry[:6]) == 0, "patch_carry_rows wrote into its input")
                errs["patch_carry_rows"] = max(errs["patch_carry_rows"], e)
                if tier == 256:
                    mine = K.ScanCarry(*[t.clone() for t in carry])
                    theirs = K.ScanCarry(*[t.clone() for t in carry])
                    ptrs = [t.data_ptr() for t in mine]
                    got = K.patch_carry_rows(st, ft, mine, *args[3:], in_place=True)
                    want = K._patch_carry_rows_plain(st, ft, theirs, *args[3:], in_place=True)
                    e = max_abs_err(tuple(got), tuple(want))
                    print(f"{what} in place: max_abs_err {e}", flush=True)
                    check([t.data_ptr() for t in got] == ptrs,
                          "patch_carry_rows in place returned other tensors")
                    errs["patch_carry_rows"] = max(errs["patch_carry_rows"], e)
                if tier == 2048 and NP == np_cap and not lane:
                    idx, req_rows, nz_rows, cnt_rows = inputs
                    host = [np.array(a) for a in (s[2], s[3], s[4])]
                    host[0][idx], host[1][idx], host[2][idx] = req_rows, nz_rows, cnt_rows
                    staged = K.stage_carry_patch(StagingRing(dev), idx, *host)
                    got = K.patch_carry_rows(st, ft, carry, *staged, strat)
                    e = max_abs_err(tuple(got), tuple(want))
                    print(f"{what} through the staging ring (one upload): max_abs_err {e}",
                          flush=True)
                    errs["patch_carry_rows"] = max(errs["patch_carry_rows"], e)


HAZARD_STEPS = 64          # flushes and carry patches queued behind one long kernel
HAZARD_SLEEP_CYCLES = 200_000_000   # ~0.1 s of the card's clock


def hazard_phase(K, dev, errs: dict) -> None:
    """The staging ring's rule on the card: HAZARD_STEPS row patches back to
    back behind a long kernel (torch.cuda._sleep), with no synchronize
    between them — each a mirror flush of new host rows (_scatter_dirty)
    and a carry patch of the same rows on the state it returns
    (patch_carry), as a session's delta patch makes them, each step
    writing other values into the same host staging. The ring has fewer
    buffers than steps, so the host must wait for the copies before it
    packs a buffer again. Every step's state and carry, once the card has
    run them, equal what the plain versions give on the host values of
    that step."""
    from kubernetes_tpu_torch.ops.device_state import NodeStateMirror, patch_tier
    from kubernetes_tpu_torch.testing.kernel_inputs import random_inputs

    s, f = random_inputs(900, 8192, 5000)
    m = NodeStateMirror(dev, node_capacity=8192, taint_capacity=4, scalar_capacity=4)
    for name, a in zip(MIRROR_FIELDS, s):
        getattr(m, name)[...] = a
    m._device = m._upload()
    m._full_flush = False
    st0, ft = to_device(dev, s, f)
    fit = K._resource_eval_plain(ft, 0, st0.alloc_r, st0.alloc_pods, st0.req_r, st0.nonzero,
                                 st0.pod_count)
    carry = K.fresh_carry(st0, ft, 64, fit)
    prev = K.ScanCarry(*[t.cpu() for t in carry])
    rng = np.random.default_rng(901)
    ring = m.ring(dev)
    waits0 = ring.waits
    steps = []
    torch.cuda.synchronize()
    torch.cuda._sleep(HAZARD_SLEEP_CYCLES)
    t0 = time.perf_counter()
    for _step in range(HAZARD_STEPS):
        rows = sorted(rng.choice(5000, int(rng.integers(1, 300)), replace=False).tolist())
        for a in (m.h_alloc_r, m.h_req_r):
            a[rows] = rng.integers(0, 1 << 40, (len(rows), a.shape[1]))
        m.h_nonzero[rows] = rng.integers(0, 1 << 40, (len(rows), 2))
        m.h_pod_count[rows] = rng.integers(0, 110, len(rows))
        m.h_taint_key[rows] = rng.integers(0, 9, (len(rows), 4))
        m.h_topo[:, rows] = rng.integers(0, 50, (m.h_topo.shape[0], len(rows)))
        state = m._scatter_dirty(rows)
        m._device = state
        carry = m.patch_carry(state, ft, carry, rows, 0)
        steps.append((rows, [a.copy() for a in m._arrays()] + [m.h_topo.copy()], state, carry))
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    waits = ring.waits - waits0
    err_s = err_c = 0
    fc = K.BatchFeatures(*[t.cpu() for t in ft])
    for rows, arrays, state, got_carry in steps:
        want = K.DeviceNodeState(*[torch.from_numpy(a) for a in arrays])
        err_s = max(err_s, max_abs_err(tuple(t.cpu() for t in state), tuple(want)))
        prows = rows + [rows[-1]] * (patch_tier(len(rows)) - len(rows))
        at = torch.tensor(prows, dtype=torch.int32)
        want_carry = K._patch_carry_rows_plain(
            want, fc, prev, at, torch.from_numpy(arrays[2][prows]),
            torch.from_numpy(arrays[3][prows]), torch.from_numpy(arrays[4][prows]), 0)
        err_c = max(err_c, max_abs_err(tuple(t.cpu() for t in got_carry[:6]),
                                       tuple(want_carry[:6])))
        prev = want_carry
    print(f"hazard check: {HAZARD_STEPS} flushes and {HAZARD_STEPS} carry patches behind a "
          f"{HAZARD_SLEEP_CYCLES}-cycle kernel, {host_s * 1e3:.1f} ms of host, {waits} takes "
          f"waited on their buffer's copy: states max_abs_err {err_s}, carries max_abs_err "
          f"{err_c}", flush=True)
    check(waits > 0, "the hazard check never made the host wait on a staging buffer")
    errs["scatter_rows"] = max(errs["scatter_rows"], err_s)
    errs["patch_carry_rows"] = max(errs["patch_carry_rows"], err_c)


def placement_phase(K, dev, np_cap: int, n_nodes: int, errs: dict) -> None:
    """schedule_placements against its plain version: P = 1, 16 and 64
    lanes (a multi-lane draw has an empty padded lane, a one-row lane, a
    100-row lane and an every-row lane, which also marks the rows past
    num_nodes), no spread table, the plan's shared tables and per-lane
    overrides, at V = 64 and 8192, both fit strategies, no active member
    and a gang of 4; then P = 4 at NP 20000 (a gang of 4, one strategy), the
    every-row lane 19990 rows, past a lane's on-chip tier (carried and
    normalized plans). The inputs left unchanged. Some lane must place only
    part of its gang (PlacementFeasible decides there)."""
    from kubernetes_tpu_torch.testing.kernel_inputs import placement_inputs

    big_np, big_n = LAP_ABOVE_TIER
    partial = placed = cases = 0
    for lanes, cap, live, draws in (
            *[(lanes, np_cap, n_nodes, ((64, {}), (64, dict(dns=1, sa=1)),
                                        (64, dict(dns=1, sa=1, overrides=True)),
                                        (8192, dict(dns=2, sa=1)),
                                        (8192, dict(dns=1, sa=2, overrides=True))))
              for lanes in (1, 16, 64)],
            (4, big_np, big_n, ((64, {}), (64, dict(dns=1, sa=1, overrides=True))))):
        for vmax, tables in draws:
            s, f, facts, masks, ov = placement_inputs(900 + lanes + vmax + len(tables), cap,
                                                      live, lanes, vmax=vmax, **tables)
            masks[-1, live:] = True
            st, ft = to_device(dev, s, f)
            if cap == big_np:
                _inc, carried = K.plan_modes(ft, K.PlanFacts(**facts))
                check(K._placement_lane_bytes(live, ft.dns_counts.shape[1], ft.dns_axis.shape[0],
                                              ft.sa_axis.shape[0], carried)
                      > K.PLACEMENT_SMEM_MAX, "the NP 20000 placement lane fits on chip")
            m = torch.from_numpy(masks).to(dev)
            t_ov = None if ov is None else tuple(torch.from_numpy(a).to(dev) for a in ov)
            inputs = list(st) + list(ft) + [m] + list(t_ov or ())
            before = [t.clone() for t in inputs]
            deep = cap == np_cap  # the plain version walks the big lanes' 19990 rows slowly
            for strat in (0, 1) if deep else (1,):
                for n_act in (0, 4) if deep else (4,):
                    args = (st, ft, 8, strat, vmax, K.PlanFacts(**facts), m, n_act, t_ov)
                    got, want = K.schedule_placements(*args), K._schedule_placements_plain(*args)
                    e = max_abs_err((got,), (want,))
                    errs["schedule_placements"] = max(errs["schedule_placements"], e)
                    per_lane = (want[:, 0, :n_act] >= 0).sum(dim=1)
                    partial += int(((per_lane > 0) & (per_lane < n_act)).sum())
                    placed += int(per_lane.sum())
                    cases += 1
            check(max_abs_err(before, inputs) == 0, "schedule_placements wrote into an input")
    torch.cuda.synchronize()
    print(f"schedule_placements vs plain: max_abs_err {errs['schedule_placements']} over "
          f"{cases} cases, {placed} members placed, {partial} lanes placing part of a gang",
          flush=True)
    check(placed > 0 and partial > 0, "the placement draws placed nothing, or no lane only part")


def whatif_phase(dev, n_nodes: int, errs: dict) -> None:
    """whatif_score against its plain version: seeded batches at the
    rebalance drive's shape (P 128, N 5000, R 3) and at P 1 / N 3, a batch
    with 16 TiB nodes (int64 wrap-around), one with negative numerators
    (floored division); the edges of the kernel's tiles (P 1 to 600 and N
    1 to 5003 about one tile and one chunk, the candidates' sources on the
    tile edges); R 2 to 50 (each tier of the slack) with both hazards; an
    empty batch (no launch); the inputs left unchanged. Exactly equal on
    fit_ok and score."""
    from kubernetes_tpu_torch.ops import _build
    from kubernetes_tpu_torch.ops import whatif as W
    from kubernetes_tpu_torch.testing.kernel_inputs import whatif_inputs

    cases = {"drive shape": (1000, 128, n_nodes, {}), "drive shape, 2nd draw": (1001, 128, n_nodes, {}),
             "P 1 / N 3": (1002, 1, 3, {}), "16 TiB nodes": (1003, 128, n_nodes, dict(huge=True)),
             "negative numerators": (1004, 37, n_nodes, dict(negative=True)),
             "both hazards, odd sizes": (1005, 37, 999, dict(huge=True, negative=True))}
    # The edges of the kernel's tiles (WI_NODES nodes x WI_CANDS candidates),
    # the sources on every tile edge; the slack's three tiers (registers up to
    # R 8, the shared tile up to R 85, device memory past it) on the hazards.
    T = _build.defines("whatif_score.cu")["WI_NODES"]
    edges = dict(src_rows=[0, T - 1, T, T + 1, 2 * T - 1, 2 * T, n_nodes - 1])
    for i, (P, N) in enumerate([(P, 129) for P in (1, 7, 8, 9, 15, 16, 17, 128, 600)]
                               + [(17, N) for N in (1, 63, 64, 65, 127, 128, 5003)]
                               + [(600, 5003)]):
        cases[f"P {P} / N {N} on the tile edges"] = (1010 + i, P, N, edges)
    for i, R in enumerate((2, 7, 8, 9, 20, 85, 86)):
        cases[f"R {R}, both hazards"] = (1030 + i, 37, 999, dict(R=R, huge=True, negative=True,
                                                                 **edges))
    for case, (seed, P, N, kw) in cases.items():
        kw = dict(kw)
        R = kw.pop("R", 3)
        ts = [torch.from_numpy(a).to(dev) for a in whatif_inputs(seed, P, N, R, **kw)]
        before = [t.clone() for t in ts]
        launches = W.whatif_score.launches
        got, want = W.whatif_score(*ts), W._whatif_score_plain(*ts)
        e = max_abs_err(got, want)
        check(W.whatif_score.launches == launches + 1, f"whatif_score {case}: no launch")
        check(max_abs_err(before, ts) == 0, f"whatif_score wrote into an input ({case})")
        print(f"whatif_score {case} (P {P}, N {N}): max_abs_err {e}, {int(want[0].sum())} fit "
              f"cells, scores {int(want[1].min())}..{int(want[1].max())}", flush=True)
        errs["whatif_score"] = max(errs["whatif_score"], e)
    for P, N in ((0, n_nodes), (5, 0)):
        launches = W.whatif_score.launches
        fit, score = W.whatif_scores(W.WhatIfBatch(*whatif_inputs(1006, P, N)), device=dev)
        got = W.whatif_score(*[torch.from_numpy(a).to(dev) for a in whatif_inputs(1006, P, N)])
        check(fit.shape == score.shape == tuple(got[0].shape) == (P, N)
              and W.whatif_score.launches == launches,
              f"whatif_score: the empty {P} x {N} batch launched or came back misshapen")
    print("whatif_score: the empty batches launched nothing", flush=True)


WHATIF_HAZARD_CALLS = 32   # what-if score calls queued behind one long kernel


def whatif_hazard(dev, errs: dict) -> None:
    """whatif_scores' buffers on the card: WHATIF_HAZARD_CALLS calls of the
    rebalance drive's shape (128 x 5000), each on its own batch, through one
    staging ring, queued behind a long kernel (torch.cuda._sleep) with no
    synchronize of the caller's between them, every result kept; then each
    held against the plain version on its batch. A result that a later
    call's upload, output or fetch wrote into shows here."""
    from kubernetes_tpu_torch.ops import whatif as W
    from kubernetes_tpu_torch.testing.kernel_inputs import whatif_inputs

    from kubernetes_tpu_torch.ops.staging import StagingRing

    batches = [W.WhatIfBatch(*whatif_inputs(1100 + i, 128, 5000))
               for i in range(WHATIF_HAZARD_CALLS)]
    ring = StagingRing(dev)   # one ring for every call, as the descheduler keeps
    launches = W.whatif_score.launches
    torch.cuda.synchronize()
    torch.cuda._sleep(HAZARD_SLEEP_CYCLES)
    t0 = time.perf_counter()
    results = [W.whatif_scores(b, device=dev, ring=ring) for b in batches]
    host_s = time.perf_counter() - t0
    check(W.whatif_score.launches == launches + WHATIF_HAZARD_CALLS,
          "whatif_scores did not launch once a call")
    worst = 0
    for b, (fit, score) in zip(batches, results):
        want = W._whatif_score_plain(*W.batch_tensors(b, dev))
        worst = max(worst, max_abs_err((torch.from_numpy(fit), torch.from_numpy(score)),
                                       tuple(t.cpu() for t in want)))
    print(f"whatif hazard check: {WHATIF_HAZARD_CALLS} score calls behind a "
          f"{HAZARD_SLEEP_CYCLES}-cycle kernel, {host_s * 1e3:.1f} ms of host, every result "
          f"kept: max_abs_err {worst}", flush=True)
    errs["whatif_score"] = max(errs["whatif_score"], worst)


# ---------------------------------------------------------------------------
# Phase 3: the paths, each through TorchScheduler on cuda at full width
# ---------------------------------------------------------------------------

def zone_of(node: str) -> int:
    return int(node.split("-")[1]) % 50


def run_path(dev, workload: str, n_init=None, n_measure=None, max_batch=None,
             churn_limit=None, label=None, mesh="auto"):
    """Build the workload's 5000-node cluster, warm it (n_init init or
    warm-up pods), then run n_measure measured pods with the launch counts
    zeroed just before and read just after. A `label` names a run that is
    not the workload itself (bench.measure)."""
    from kubernetes_tpu_torch import bench
    from kubernetes_tpu_torch.ops import kernel as K

    w = bench.WORKLOADS[workload]
    sched = bench.build_cluster(bench.NODES.get(workload, 5000), device=dev, max_batch=max_batch,
                                node=w.node, mesh=mesh)
    bench.warm(sched, w.init_pods if n_init is None else n_init, workload)
    flushes0 = sched.mirror.scatter_flushes
    K.reset_launch_counts()
    result = bench.measure(sched, w.measure_pods if n_measure is None else n_measure,
                           workload=workload, churn_limit=churn_limit, label=label)
    launches = {k.__name__: k.launches for k in K.WRAPPERS}
    launches["scatter_flushes"] = sched.mirror.scatter_flushes - flushes0
    print(f"path {label or workload}: {json.dumps(result)}", flush=True)
    return sched, result, launches


def drive(dev, workload: str, max_batch=None):
    """run_path with the workload's own counts; every pod bound on the
    device, none through the host path."""
    from kubernetes_tpu_torch import bench

    w = bench.WORKLOADS[workload]
    sched, result, launches = run_path(dev, workload, max_batch=max_batch)
    d = result["detail"]
    total = w.init_pods + w.measure_pods
    bound = len(sched.clientset.bindings)
    check(bound == len(sched.clientset.pods) == total, f"{workload}: {bound} of {total} pods bound")
    check(d["failures"] == 0 and d["host_path_pods"] == 0,
          f"{workload}: failures {d['failures']}, host_path_pods {d['host_path_pods']}")
    check(d["device_batches"] > 0, f"{workload}: no device batch in the measured window")
    return sched, result, launches


def outcome(sched) -> dict:
    """{pod: (node, nominated node)} over the surviving pods."""
    return {p.name: (p.node_name, p.nominated_node_name) for p in sched.clientset.pods.values()}


PREEMPTING = f"preempting case ({PREEMPTORS} preemptors, 5000 full nodes)"
LANE = "nominated-lane drive (lower-priority pods while nominations stand)"


def preempting_case(dev):
    """PreemptionAsync's templates with every node full: 5000 priority-1
    4-cpu pods on the 5000 nodes of 4 cpu, then PREEMPTORS priority-100
    4-cpu pods, each of which must evict one."""
    return run_path(dev, PREEMPT, n_init=5000, n_measure=PREEMPTORS, label=PREEMPTING)


def lane_drive(dev, n_nodes: int = 5000, n_pre: int = 64, n_free: int = 512, n_over: int = 32):
    """Lower-priority pods scheduled on the device while nominations stand.
    PreemptionAsync's templates with every node full (n_nodes priority-1
    4-cpu pods); n_pre priority-100 preemptors each evict one and are
    nominated in one session, then wait out their backoff. Meanwhile
    n_free priority-1 pods on other nodes are deleted and n_free + n_over
    priority-1 4-cpu pods arrive (the queue's clock stands still meanwhile,
    so the preemptors' 1 s backoff outlasts the host work of the drive, as
    a victim's graceful termination would on a cluster, and the
    higher-priority preemptors do not go first): their session's lap carries the
    nominated lane, which must land n_free of them on the freed nodes, none
    on a nominated node (each is empty, so only the lane keeps them off),
    and leave n_over unschedulable. Then every preemptor binds on its
    nominated node. The launch counts are zeroed just before the
    lower-priority session and read just after it. Returns the scheduler,
    the counts and (device state, plan) of the lower-priority session."""
    from kubernetes_tpu_torch import bench
    from kubernetes_tpu_torch.ops import kernel as K

    w = bench.WORKLOADS[PREEMPT]
    sched = bench.build_cluster(n_nodes, device=dev, node=w.node)
    bench.warm(sched, n_nodes, PREEMPT)
    clock, t_hold = sched.queue.now, sched.queue.now()
    sched.queue.now = lambda: t_hold
    pre = bench.make_pods(n_pre, "pre", PREEMPT)
    for p in pre:
        sched.clientset.create_pod(p)
    check(sched.schedule_one(), f"{LANE}: no session for the preemptors")
    nominated = {p.nominated_node_name for p in pre}
    check(len(nominated) == n_pre and "" not in nominated and not any(p.node_name for p in pre),
          f"{LANE}: the preemptors are not each nominated to a node of their own")
    freed = [p for p in sched.clientset.pods.values()
             if p.priority == 1 and p.node_name not in nominated][:n_free]
    for p in freed:
        sched.clientset.delete_pod(p)
    freed_nodes = {p.node_name for p in freed}
    low = bench._clones(w.init_build, n_free + n_over, "low")
    for p in low:
        sched.clientset.create_pod(p)
    sched.cache.update_snapshot(sched.snapshot)
    lane = sched._nominated_lane(low[0])
    check(lane is not None and len(lane) == n_pre,
          f"{LANE}: the lower-priority pods' plan does not carry the {n_pre} nominations")
    state, plan = sched.build_plan(sched.framework_for_pod(low[0]), low[0], sched.max_batch)
    inputs = (K.DeviceNodeState(*[t.clone() for t in state]), plan, len(low), n_free)
    flushes0 = sched.mirror.scatter_flushes
    K.reset_launch_counts()
    check(sched.schedule_one(), f"{LANE}: no session for the lower-priority pods")
    launches = {k.__name__: k.launches for k in K.WRAPPERS}
    launches["scatter_flushes"] = sched.mirror.scatter_flushes - flushes0
    on = [p.node_name for p in low if p.node_name]
    print(f"{LANE}: {n_pre} nominations, {len(on)} of {len(low)} lower-priority pods bound, "
          f"{sum(n in nominated for n in on)} on a nominated node, launches {launches}",
          flush=True)
    check(sched.queue.nominator.has_nominated_pods()
          and all(p.nominated_node_name and not p.node_name for p in pre),
          f"{LANE}: the nominations did not stand through the lower-priority session")
    check(len(on) == n_free and set(on) == freed_nodes,
          f"{LANE}: {len(on)} lower-priority pods bound, not {n_free} on the freed nodes")
    check(not any(p.nominated_node_name for p in low),
          f"{LANE}: a lower-priority pod was nominated")
    check(torch.device(dev).type == "cpu" or launches["lap_schedule"] > 0,
          f"{LANE}: the lap was not launched with the lane")
    sched.queue.now = clock
    sched.run_until_idle()
    check(all(p.node_name and p.node_name == p.nominated_node_name for p in pre)
          and not sched.queue.nominator.has_nominated_pods(),
          f"{LANE}: not every preemptor bound on its nominated node")
    check(sum(1 for p in low if p.node_name) == n_free,
          f"{LANE}: the unschedulable lower-priority pods changed")
    return sched, launches, inputs


WAVES = "completion waves (SchedulingBasic's 5000 nodes, 10 waves of 1000 pods)"
NSSEL = "SchedulingRequiredPodAntiAffinityWithNSSelector/5000Nodes_2000Pods"
REBUILDS = ("plan_rebuilds_full", "plan_rebuilds_delta", "plan_rebuilds_resume",
            "delta_dirty_rows")


def snapshot_counts(sched) -> dict:
    from kubernetes_tpu_torch.ops import kernel as K

    out = {c: getattr(sched, c) for c in REBUILDS + ("plan_acquire_s", "plan_build_s",
                                                      "host_path_pods", "failures")}
    out.update({k.__name__: k.launches for k in K.WRAPPERS})
    out["scatter_flushes"] = sched.mirror.scatter_flushes
    return out


def wave_drive(dev, resume: bool = True, n_nodes: int = 5000, warm_pods: int = 1024,
               waves: int = 10, wave_pods: int = 1000, deletes: int = 100,
               parked_adds: int = 512, capture=None):
    """Jobs completing and new ones arriving. SchedulingBasic's cluster and
    warm pods, then `waves` waves of `wave_pods` 100m/128Mi pods; before
    each wave `deletes` bound pods of earlier waves are deleted (seeded).
    Wave 3 puts a NoSchedule taint on a node and wave 5 lifts it; in wave 7
    a bound-pod delete and `parked_adds` pod creations are parked in the
    inbox at the session's first dispatch (the session must take them in);
    wave 9 puts a PreferNoSchedule taint on a node (the plan lacks the lane:
    a full rebuild, then the general scan) and wave 10 adds a node (a full
    rebuild). `resume=False` runs the same drive with incremental resume
    off. The launch counts are zeroed after the warm pods and read after
    the last wave. `capture`, a dict, receives the first carry patch of
    each tier (NodeStateMirror.patch_carry's arguments: state, features,
    carry, rows, fit strategy)."""
    from kubernetes_tpu_torch import bench
    from kubernetes_tpu_torch.ops import kernel as K
    from kubernetes_tpu_torch.ops.device_state import patch_tier

    rng = random.Random(2024)
    sched = bench.build_cluster(n_nodes, device=dev, resume=resume)
    bench.warm(sched, warm_pods)
    check(sched.plan_rebuilds_full == 1, f"{WAVES}: the warm pods took {sched.plan_rebuilds_full} "
          "full rebuilds, not 1")
    wave_of, kinds = [0], []
    acquire = sched._resume_or_rebuild

    def recorded_acquire(*args):
        out = acquire(*args)
        kinds.append((wave_of[0], out[4]))
        return out
    sched._resume_or_rebuild = recorded_acquire
    patch = sched.mirror.patch_carry

    def recorded_patch(state, f, carry, rows, strat):
        tier = patch_tier(len(rows))
        if capture is not None and tier not in capture:
            capture[tier] = (state, f, carry, list(rows), strat)
        return patch(state, f, carry, rows, strat)
    sched.mirror.patch_carry = recorded_patch
    taint_node, pns_node = n_nodes // 3, 2 * n_nodes // 3
    per_wave = []
    K.reset_launch_counts()
    c0 = snapshot_counts(sched)
    try:
        for w in range(1, waves + 1):
            wave_of[0] = w
            before = snapshot_counts(sched)
            done = sorted(p.name for p in sched.clientset.pods.values() if p.node_name)
            by_name = {p.name: p for p in sched.clientset.pods.values()}
            for name in rng.sample(done, deletes):
                sched.clientset.delete_pod(by_name[name])
            if w == 3:
                sched.clientset.update_node(bench.cluster_node(
                    taint_node, taint=("dedicated", "infra", "NoSchedule")))
            elif w == 5:
                sched.clientset.update_node(bench.cluster_node(taint_node))
            elif w == 9:
                sched.clientset.update_node(bench.cluster_node(
                    pns_node, taint=("soft", "", "PreferNoSchedule")))
            elif w == 10:
                sched.clientset.create_node(bench.cluster_node(n_nodes))
            for p in bench.make_pods(wave_pods, f"wave{w}"):
                sched.clientset.create_pod(p)
            if w == 7:
                done = sorted(p.name for p in sched.clientset.pods.values() if p.node_name)
                parked_victim = by_name[rng.choice(done)]

                def parked():
                    sched.clientset.delete_pod(parked_victim)
                    for p in bench.make_pods(parked_adds, "wave7-parked"):
                        sched.clientset.create_pod(p)
                dispatch = sched._dispatch

                def first_dispatch(*args):
                    del sched._dispatch
                    sched._event_inbox.append((parked, ()))
                    return dispatch(*args)
                sched._dispatch = first_dispatch
            sched.run_until_idle()
            after = snapshot_counts(sched)
            d = {k: after[k] - before[k] for k in after}
            per_wave.append(dict(wave=w, sessions=[k for ww, k in kinds if ww == w],
                                 has_pns=bool(sched._resume and sched._resume[2][1].facts.has_pns),
                                 **d))
    finally:
        del sched.mirror.patch_carry
        del sched._resume_or_rebuild
    total = {k: v - c0[k] for k, v in snapshot_counts(sched).items()}
    launches = {k: total[k] for k in [w.__name__ for w in K.WRAPPERS] + ["scatter_flushes"]}
    label = WAVES if resume else f"{WAVES}, resume off"
    for r in per_wave:
        print(f"{label} wave {r['wave']}: sessions {r['sessions']}, full/delta/resume "
              f"{r['plan_rebuilds_full']}/{r['plan_rebuilds_delta']}/{r['plan_rebuilds_resume']}, "
              f"{r['delta_dirty_rows']} dirty rows, plan acquisition {r['plan_acquire_s']:.6f} s "
              f"(full rebuilds {r['plan_build_s']:.6f} s), patch_carry_rows "
              f"{r['patch_carry_rows']}, scatter_rows {r['scatter_rows']}, scan_general "
              f"{r['scan_general']}, lap_schedule {r['lap_schedule']}", flush=True)
    pods = list(sched.clientset.pods.values())
    n_all = warm_pods + waves * (wave_pods - deletes) + parked_adds - 1
    check(len(pods) == n_all and all(p.node_name for p in pods),
          f"{label}: {sum(1 for p in pods if p.node_name)} of {len(pods)} pods bound "
          f"({n_all} expected)")
    check(total["host_path_pods"] == 0 and total["failures"] == 0,
          f"{label}: {total['host_path_pods']} host-path pods, {total['failures']} failures")
    if resume:
        check(sched.plan_rebuilds_full == 3,
              f"{label}: {sched.plan_rebuilds_full} full rebuilds, not 3 (warm, waves 9, 10)")
        for r in per_wave:
            first = r["sessions"][0] if r["sessions"] else None
            want = ("full",) if r["wave"] in (9, 10) else ("delta", "resume")
            check(first in want, f"{label}: wave {r['wave']} began with {first}, not {want}")
        w7 = per_wave[6]
        check(len(w7["sessions"]) == 1 and w7["plan_rebuilds_delta"] > (w7["sessions"][0] == "delta"),
              f"{label}: wave 7 took sessions {w7['sessions']} and "
              f"{w7['plan_rebuilds_delta']} delta patches, not one session that patched "
              "its parked delete")
        check(per_wave[8]["has_pns"], f"{label}: wave 9's plan lacks the PreferNoSchedule lane")
        if torch.device(dev).type == "cuda":
            check(per_wave[8]["scan_general"] > 0, f"{label}: wave 9 did not take scan_general")
            for k in ("patch_carry_rows", "scatter_rows", "lap_schedule", "static_masks"):
                check(launches[k] > 0, f"{k} was not launched on the {label} path")
    else:
        check(total["plan_rebuilds_delta"] == total["plan_rebuilds_resume"] == 0,
              f"{label}: a plan was resumed with resume off")
    return sched, launches, per_wave


def nsselector_drive(dev, n_nodes: int = 6000, resume: bool = True, init_only: bool = False,
                     n_init=None, n_measure=None):
    """SchedulingRequiredPodAntiAffinityWithNSSelector/5000Nodes_2000Pods:
    101 team: devops namespaces, 100 x 40 init pods that differ only in
    their namespace (one session under the namespace-erased signature,
    where the exact signature gives one a namespace), then 2000 pods with
    hostname anti-affinity to color: green pods of those namespaces, one on
    each node left free. Launch counts zeroed just before the measured
    pods. Returns (scheduler, result, launches, init plan acquisitions)."""
    from kubernetes_tpu_torch import bench
    from kubernetes_tpu_torch.ops import kernel as K

    w = bench.WORKLOADS[NSSEL]
    n_init = w.init_pods if n_init is None else n_init
    n_measure = w.measure_pods if n_measure is None else n_measure
    sched = bench.build_cluster(n_nodes, device=dev, resume=resume)
    bench.warm(sched, n_init, NSSEL)
    init_plans = sched.plan_rebuilds_full + sched.plan_rebuilds_delta + sched.plan_rebuilds_resume
    init = [p for p in sched.clientset.pods.values() if p.namespace.startswith("init-ns-")]
    print(f"{NSSEL}{'' if resume else ' (resume off)'}: init phase {len(init)} pods in "
          f"{len({p.namespace for p in init})} namespaces, {init_plans} plan acquisitions, "
          f"{sum(1 for p in init if p.node_name)} bound", flush=True)
    check(len(init) == n_init and all(p.node_name for p in init),
          f"{NSSEL}: not every init pod bound")
    if init_only:
        return sched, None, None, init_plans
    check(init_plans <= 2, f"{NSSEL}: the init phase took {init_plans} plan acquisitions")
    flushes0 = sched.mirror.scatter_flushes
    K.reset_launch_counts()
    result = bench.measure(sched, n_measure, workload=NSSEL)
    launches = {k.__name__: k.launches for k in K.WRAPPERS}
    launches["scatter_flushes"] = sched.mirror.scatter_flushes - flushes0
    print(f"path {NSSEL}: {json.dumps(result)}", flush=True)
    pods = list(sched.clientset.pods.values())
    measured = [p for p in pods if p.namespace == "measure-ns-0"]
    check(len(measured) == n_measure and all(p.node_name for p in measured),
          f"{NSSEL}: {sum(1 for p in measured if p.node_name)} of {n_measure} measured "
          "pods bound")
    # Every pod is color: green in a team: devops namespace, so a measured
    # pod's node holds no other pod. (The init pods, which carry no term,
    # share nodes: their scores tie on empty and lightly used nodes.)
    init_nodes = {p.node_name for p in pods if p.namespace != "measure-ns-0"}
    m_nodes = [p.node_name for p in measured]
    print(f"{NSSEL}: init pods on {len(init_nodes)} nodes, measured pods on {len(set(m_nodes))} "
          f"nodes, {len(init_nodes & set(m_nodes))} shared", flush=True)
    check(len(set(m_nodes)) == len(m_nodes) and not init_nodes & set(m_nodes),
          f"{NSSEL}: a node holds a measured pod and another color: green pod")
    d = result["detail"]
    check(d["host_path_pods"] == 0 and d["failures"] == 0,
          f"{NSSEL}: {d['host_path_pods']} host-path pods, {d['failures']} failures")
    if torch.device(dev).type == "cuda":
        check(launches["lap_schedule"] > 0, f"the anti-lane lap was not launched on {NSSEL}")
    return sched, result, launches, init_plans


def gang_drive(dev, n_groups: int = 250, n_nodes: int = 1000, capture=None, max_batch=None):
    """SchedulingGangs/1000Nodes_250Groups: 1000 nodes over 10 zones, then
    n_groups pod groups of 4 500m/256Mi members, each created before its
    members: every pod bound by gang device sessions, none on the host
    path. Launch counts zeroed just before the groups. Its sessions take
    the lap at the default max_batch and the scan path at 64; `capture`
    receives the first dispatch on the scan path (capture_first_dispatch)."""
    from kubernetes_tpu_torch import bench
    from kubernetes_tpu_torch.ops import kernel as K

    w = bench.WORKLOADS[GANGS]
    sched = bench.build_cluster(n_nodes, device=dev, node=w.node, max_batch=max_batch)
    bench.warm(sched, 0, GANGS)
    if capture is not None:
        capture_first_dispatch(sched, capture, path="scan")
    flushes0 = sched.mirror.scatter_flushes
    K.reset_launch_counts()
    result = bench.measure(sched, 4 * n_groups, workload=GANGS)
    launches = {k.__name__: k.launches for k in K.WRAPPERS}
    launches["scatter_flushes"] = sched.mirror.scatter_flushes - flushes0
    print(f"path {GANGS} ({dev}): {json.dumps(result)}", flush=True)
    d = result["detail"]
    pods = list(sched.clientset.pods.values())
    check(len(pods) == 4 * n_groups and all(p.node_name for p in pods),
          f"{GANGS}: {sum(1 for p in pods if p.node_name)} of {len(pods)} pods bound")
    check(d["host_path_pods"] == 0 and d["failures"] == 0 and d["device_scheduled"] == len(pods),
          f"{GANGS}: host_path_pods {d['host_path_pods']}, failures {d['failures']}, "
          f"device_scheduled {d['device_scheduled']}")
    if torch.device(dev).type == "cuda":
        check(launches["lap_schedule"] + launches["scan_general"] > 0,
              f"neither the lap nor scan_general was launched on the {GANGS} path")
    return sched, result, launches


def placement_drive(dev, n_groups: int = 250, capture=None, workload: str = PLACE):
    """SchedulingGangsPlacement/5000Nodes_250Groups (TopologySpreading's
    5000 nodes over 50 zones) or /1000Nodes_250Groups (1000 nodes over 10
    zones, the JAX config's shape) under the placement plugins, then
    n_groups pod groups of 4 500m/256Mi members with the topology
    constraint on the zone: every pod bound, each group in one zone, each
    group cycle's candidate placements (one a zone) in one
    schedule_placements launch, no host-path pod. `capture`, a dict,
    receives the first launch's arguments and its placement count. Launch
    counts zeroed just before the groups."""
    from kubernetes_tpu_torch import bench
    from kubernetes_tpu_torch.models import tpu_scheduler as TS
    from kubernetes_tpu_torch.ops import kernel as K

    w = bench.WORKLOADS[workload]
    sched = bench.build_cluster(bench.NODES.get(workload, 5000), device=dev, node=w.node,
                                profile_factory=bench.profile_for(workload))
    bench.warm(sched, 0, workload)
    launch = TS.schedule_placements

    def recorded(*args):
        if capture is not None and not capture:
            capture["args"] = args
            capture["placements"] = int(args[6].any(dim=1).sum())
        return launch(*args)
    TS.schedule_placements = recorded
    flushes0 = sched.mirror.scatter_flushes
    K.reset_launch_counts()
    try:
        result = bench.measure(sched, 4 * n_groups, workload=workload)
    finally:
        TS.schedule_placements = launch
    launches = {k.__name__: k.launches for k in K.WRAPPERS}
    launches["scatter_flushes"] = sched.mirror.scatter_flushes - flushes0
    print(f"path {workload} ({dev}, {n_groups} groups): {json.dumps(result)}", flush=True)
    d = result["detail"]
    pods = list(sched.clientset.pods.values())
    check(len(pods) == 4 * n_groups and all(p.node_name for p in pods),
          f"{workload}: {sum(1 for p in pods if p.node_name)} of {len(pods)} pods bound")
    zones = {}
    for p in pods:
        zones.setdefault(p.pod_group, set()).add(
            sched.clientset.nodes[p.node_name].labels[bench.ZONE])
    check(all(len(z) == 1 for z in zones.values()), f"{workload}: a group spans several zones")
    check(d["placement_device_evals"] == n_groups and d["host_path_pods"] == 0,
          f"{workload}: {d['placement_device_evals']} device placement evaluations, "
          f"{d['host_path_pods']} host-path pods")
    if torch.device(dev).type == "cuda":
        check(launches["schedule_placements"] == n_groups,
              f"{workload}: schedule_placements launched {launches['schedule_placements']} times, "
              f"not once a group")
    floor = f", floor {w.threshold} pods/s" if w.threshold else ", no upstream floor"
    print(f"{workload} ({dev}): {len({min(z) for z in zones.values()})} zones used, "
          f"{d['placement_eval_s'] / max(1, d['placement_device_evals']) * 1e3:.3f} ms a "
          f"placement evaluation (plan, masks, launch, fetch), {result['value']:.1f} pods/s"
          f"{floor}", flush=True)
    return sched, result, launches


def rebalance_drive(dev, capture=None, **cut):
    """ChurnDriftRebalance/5000Nodes_Rebalance (bench.rebalance): 2000
    2000m/4Gi pods placed on 5000 hollow-shape nodes over 100 zones, every
    node skewed in place (imbalance 0.4, seed 20), every 100th tainted, then
    descheduler ticks (hysteresis 2, margin 0.02, 64 moves: 128 x 5000
    what-if batches), each followed by a scheduler round, until a tick
    emits no move or 20 ticks. `cut` overrides the drive's sizes. Fails
    unless a move was made, no tick counted an error, whatif_score was
    launched once a tick that had candidates (on cuda) and every pod is
    bound at the end. `capture`, a dict, receives the first what-if batch.
    Launch counts zeroed just before the drive."""
    from kubernetes_tpu_torch import bench
    from kubernetes_tpu_torch.ops import kernel as K
    from kubernetes_tpu_torch.ops import whatif as W

    scores = W.whatif_scores

    def recorded(batch, device="cuda", ring=None):
        if capture is not None and not capture:
            capture["batch"] = batch
        return scores(batch, device, ring)
    W.whatif_scores = recorded
    K.reset_launch_counts()
    try:
        out = bench.rebalance(dev, bench.Rebalance()._replace(**cut))
    finally:
        W.whatif_scores = scores
    launches = {k.__name__: k.launches for k in K.WRAPPERS}
    ticks, what = out["ticks"], f"{REBAL} ({dev}, {out['nodes']} nodes)"
    for i, t in enumerate(ticks):
        print(f"{what} tick {i}: {t['moves']} moves, {t['evicted']} evicted, stddev "
              f"{t['util_stddev_milli']} milli, tick {t['tick_s'] * 1e3:.1f} ms (encode_batch "
              f"{t['encode_s'] * 1e3:.1f}, launch + fetch {t['score_s'] * 1e3:.2f}, best_moves "
              f"{t['best_moves_s'] * 1e3:.1f}), scheduler round {t['round_s'] * 1e3:.1f} ms "
              f"({t['round_pods_per_s']:.1f} pods/s)", flush=True)
    print(f"{what}: {len(ticks)} ticks, moves {out['moves']}, blocked {out['blocked']}, "
          f"no_target {out['no_target']}, drift {out['drift']}, evictions {out['evictions']}, "
          f"util_stddev_milli {out['util_stddev_milli_before']} -> "
          f"{out['util_stddev_milli_after']} (the row's ceiling {out['stddev_ceiling']}), "
          f"initial placement {out['initial_placed']} pods in {out['initial_place_s']:.3f} s",
          flush=True)
    check(sum(out["moves"].values()) >= 1, f"{what}: no move (the row's DescheduleMoves floor 1)")
    check(all(t["errors"] == 0 for t in ticks), f"{what}: a tick counted an error")
    check(out["bound"] == out["total"] == out["pods"] and out["initial_placed"] == out["pods"],
          f"{what}: {out['bound']} of {out['total']} pods bound")
    if torch.device(dev).type == "cuda":
        check(all(t["launches"] == t["batches"] for t in ticks),
              f"{what}: whatif_score not launched once a tick with candidates")
        check(launches["whatif_score"] == sum(t["batches"] for t in ticks) > 0,
              f"{what}: whatif_score launched {launches['whatif_score']} times")
    return out, launches


def check_launched(name: str, launches: dict, detail: dict, kernels) -> None:
    """Each kernel of `kernels` was launched on the path. A measured window
    whose sessions all resumed the warm-up session's plan chains its carry
    and launches no resource_eval (the fresh-carry seed): that window shows
    its resumes instead."""
    for k in kernels:
        if (k == "resource_eval" and detail["plan_rebuilds_full"] == 0
                and detail["plan_rebuilds_resume"] + detail["plan_rebuilds_delta"] > 0):
            continue
        check(launches[k] > 0, f"{k} was not launched on the {name} path")


def check_preempting(sched, result, what: str) -> None:
    pre = result["detail"]["preemption"]
    pods = list(sched.clientset.pods.values())
    hi = [p for p in pods if p.priority == 100]
    check(len(hi) == PREEMPTORS and all(p.node_name and p.node_name == p.nominated_node_name
                                        for p in hi),
          f"{what}: not every preemptor bound on its nominated node")
    check(pre["victims"] == PREEMPTORS and len(pods) == 5000,
          f"{what}: {pre['victims']} victims, {len(pods)} pods left")
    check(pre["verify_divergences"] == 0, f"{what}: {pre['verify_divergences']} divergences")
    check(not sched.queue.nominator.has_nominated_pods(), f"{what}: nominations left")


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
    check_launched(name, launches, result["detail"], ("static_masks", "resource_eval",
                                                      "lap_schedule"))
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
    for k in ("static_masks", "resource_eval", "scan_general"):
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

    sched, result, launches = drive(dev, PREEMPT)
    check_launched(PREEMPT, launches, result["detail"], ("static_masks", "resource_eval",
                                                         "lap_schedule"))
    check(result["detail"]["preemption"]["attempts"] == 0, f"{PREEMPT} preempted")
    out[PREEMPT] = (sched, result, launches)

    sched, result, launches = run_path(dev, UNSCHED, churn_limit=CHURN_PODS)
    d = result["detail"]
    pods = list(sched.clientset.pods.values())
    measured = [p for p in pods if p.name.startswith("bench-")]
    churn = [p for p in pods if p.name.startswith("churn-")]
    check(len(measured) == 10000 and all(p.node_name for p in measured),
          f"{UNSCHED}: not every measured pod bound")
    check(len(churn) == CHURN_PODS == d["churn_pods"]
          and not any(p.node_name or p.nominated_node_name for p in churn),
          f"{UNSCHED}: a churn pod was bound or nominated")
    tries = d["preemption"]["attempts"]
    print(f"{UNSCHED}: {CHURN_PODS} churn pods, {tries} PostFilter attempts, "
          f"{launches['dry_run_preemption']} dry_run_preemption launches", flush=True)
    check(tries == CHURN_PODS == launches["dry_run_preemption"] == d["preemption"]["device_evals"],
          f"{UNSCHED}: dry_run_preemption not launched once per churn pod's attempt")
    for k in ("static_masks", "resource_eval", "lap_schedule"):
        check(launches[k] > 0, f"{k} was not launched on the {UNSCHED} path")
    out[UNSCHED] = (sched, result, launches)

    sched, result, launches = preempting_case(dev)
    check_preempting(sched, result, PREEMPTING)
    check_launched(PREEMPTING, launches, result["detail"],
                   ("static_masks", "resource_eval", "lap_schedule", "dry_run_preemption",
                    "scatter_rows"))
    out[PREEMPTING] = (sched, result, launches)

    sched, launches, lane_inputs = lane_drive(dev)
    for k in ("static_masks", "resource_eval", "lap_schedule"):
        check(launches[k] > 0, f"{k} was not launched on the {LANE} path")
    out[LANE] = (sched, None, launches)

    capture = {}
    sched, launches, per_wave = wave_drive(dev, capture=capture)
    out[WAVES] = (sched, None, launches)
    # The same drive with incremental resume off: every session rebuilds
    # its plan; the assignments must not change.
    base, _l, base_waves = wave_drive(dev, resume=False)
    check(assignments(base) == assignments(sched),
          f"{WAVES}: the assignments with resume off differ from those with resume")
    print(f"{WAVES}: the same assignments with resume off ({len(assignments(base))} pods)",
          flush=True)
    waves = dict(per_wave=per_wave, per_wave_without_resume=base_waves, capture=capture,
                 wave_mirror=sched.mirror)

    sched, result, launches, init_plans = nsselector_drive(dev)
    out[NSSEL] = (sched, result, launches)
    _s, _r, _l, base_plans = nsselector_drive(dev, resume=False, init_only=True)
    waves["nsselector_init_plans"] = (init_plans, base_plans)

    out[GANGS] = gang_drive(dev)
    capture = {}
    out[PLACE] = placement_drive(dev, capture=capture)
    waves["placement_capture"] = capture
    out[PLACE1K] = placement_drive(dev, workload=PLACE1K)
    capture = {}
    rebal, launches = rebalance_drive(dev, capture=capture)
    out[REBAL] = (rebal["sched"], None, launches)
    waves["rebalance"], waves["whatif_capture"] = rebal, capture
    out[FEATURES] = features_drive(dev)
    out[GATED] = gated_drive(dev)
    caps = {"lap": {}, "scan": {}, "general": {}, "placements": {}}
    out[HOSTPORTS] = hostport_drive(dev, capture=caps["lap"])
    out[PORT_SCAN] = port_cut(dev, capture=caps["scan"])
    out[PORT_SPREAD] = port_cut(dev, spread=True, capture=caps["general"])
    out[PORT_GANGS] = port_gangs(dev, capture=caps["placements"])
    waves["blocked_captures"] = caps
    caps = {"lap": {}, "scan": {}, "general": {}}
    out[CSIPVS] = volume_drive(dev, CSIPVS, capture=caps["lap"])
    out[INTREE] = volume_drive(dev, INTREE)
    out[ATTACH] = volume_drive(dev, ATTACH)
    out[AUX_LAP] = aux_cut(dev)
    out[AUX_SCAN] = aux_cut(dev, max_batch=64, capture=caps["scan"])
    out[AUX_SPREAD] = aux_cut(dev, max_batch=64, spread=True, capture=caps["general"])
    waves["aux_captures"] = caps
    return out, lane_inputs, waves


def assignments(sched) -> dict:
    return {p.name: p.node_name for p in sched.clientset.pods.values()}


# ---------------------------------------------------------------------------
# Phase 4: timing on the main paths' inputs
# ---------------------------------------------------------------------------

def general_cost(f, facts, K, n_act: int, rows=None):
    """(bytes, ops) the general scan needs for n_act steps on these inputs:
    per step one pass over the rows for the plan's live lanes, each read
    once (a row's count in a table is the table at the row's value id, so
    the row reads its value id and the table is read once a step), the
    [C1, V] minimum of every spread table, and the landing's one-row
    update. The kernel's own scratch (feasibility, its prefix sum, the
    carried totals between steps) is no input or output and is not
    counted. `rows`: the rows a step passes over (all of them by default)."""
    NP = f.sel_match.shape[0] if rows is None else rows
    C1, C2 = f.dns_axis.shape[0], f.sa_axis.shape[0]
    A1, A2, KD = f.anti_axis.shape[0], f.aff_axis.shape[0], f.ipa_axis.shape[0]
    V = f.dns_counts.shape[1]
    _incremental, carried = K.plan_modes(f, facts)
    row = 1 + 1 + facts.port_selfblock       # static_ok, fit_ok (and blocked)
    row += 8 * facts.has_aux                 # aux_cnt and aux_room
    row += 8 if carried else 8 + 8           # the carried total, or fit_sc and ba
    row += 4 * (C1 + C2 + A1 + A2 + KD)      # a value id per table
    row += 8 * (facts.has_pns + facts.has_ipa_base + facts.has_na_pref)
    ops_row = 12 + 6 * (C1 + C2 + A1 + A2 + KD) + (0 if carried else 30)
    table = V * (5 * C1 + 4 * (C2 + A1 + A2) + 8 * KD)  # counts (+ dns_dom), deltas i64
    step_bytes = NP * row + table + 256
    return n_act * step_bytes, n_act * (NP * ops_row + C1 * V)


def scan_path_inputs(dev) -> dict:
    """Every input of the scan path (the reference's scan step for a
    row-local plan of at most 64 steps), by name: SchedulingBasic's next
    batch at 64 steps (NP 8192), the same with a random nominated-pod
    lane, the blocked and aux_cnt lanes' seeded draws (NP 8192, a third of
    the rows pre-blocked; an attach room of 0 to 3), the first batch of
    the host-port and attach-limit cuts (1000 nodes, max_batch 64), and
    the first scan dispatch of SchedulingGangs/1000Nodes_250Groups at
    max_batch 64 (at the default its sessions take the lap). Each is
    (state, features, facts, fit strategy, steps, active pods, carry or
    None for a fresh one, vmax), its tensors on the CPU."""
    from kubernetes_tpu_torch import bench
    from kubernetes_tpu_torch.ops import kernel as K
    from kubernetes_tpu_torch.testing.kernel_inputs import (aux_lane, general_inputs,
                                                            nominated_lane, with_aux_lane)

    def cpu(ts):
        return None if ts is None else [t.detach().to("cpu").clone() for t in ts]

    def entry(st, ft, facts, strat, B, n_act, carry, vmax):
        check(K.plan_path(ft, facts, B) == "scan", "a scan-path input whose plan is not row-local")
        return dict(state=cpu(st), feats=cpu(ft), facts=facts._asdict(), strat=strat, B=B,
                    n_act=int(n_act), carry=cpu(carry), vmax=vmax)

    out = {}
    sched = drive(dev, BASIC)[0]
    pod = bench.make_pods(1, "timed")[0]
    st, plan = sched.build_plan(sched.framework_for_pod(pod), pod, sched.max_batch)
    ft = plan.features
    out["SchedulingBasic next batch, 64 steps"] = entry(st, ft, plan.facts, plan.fit_strategy, 64,
                                                        64, None, plan.vmax)
    NP, R = st.alloc_r.shape
    nom_req, nom_pods = nominated_lane(700, NP, int(st.valid.sum()), R)
    ft_l = ft._replace(nom_req=torch.from_numpy(nom_req), nom_pods=torch.from_numpy(nom_pods))
    out["SchedulingBasic next batch, 64 steps, nominated lane"] = entry(
        st, ft_l, plan.facts, plan.fit_strategy, 64, 64, None, plan.vmax)
    np_cap = NP
    s, f, facts = general_inputs(1102, np_cap, 5000, vmax=64)
    st, ft = to_device("cpu", s, f)
    fit = K._resource_eval_plain(ft, 0, st.alloc_r, st.alloc_pods, st.req_r, st.nonzero,
                                 st.pod_count)
    gen = torch.Generator().manual_seed(1100)
    carry = K.fresh_carry(st, ft, 64, fit)._replace(
        blocked=torch.rand(np_cap, generator=gen) < 0.3)
    out["blocked lane, seeded draw (NP 8192, a third blocked)"] = entry(
        st, ft, K.PlanFacts(**dict(facts, port_selfblock=True)), 0, 64, 60, carry, 64)
    s, f, facts = general_inputs(1202, np_cap, 5000, vmax=64)
    room, inc, cnt = aux_lane(1202, np_cap, 5000)
    st, ft = to_device("cpu", s, with_aux_lane(f, room, inc))
    fit = K._resource_eval_plain(ft, 0, st.alloc_r, st.alloc_pods, st.req_r, st.nonzero,
                                 st.pod_count)
    carry = K.fresh_carry(st, ft, 64, fit)._replace(aux_cnt=torch.from_numpy(cnt))
    out["aux lane, seeded draw (NP 8192)"] = entry(
        st, ft, K.PlanFacts(**dict(facts, has_aux=True)), 0, 64, 60, carry, 64)
    for name, run in ((PORT_SCAN, lambda c: port_cut(dev, capture=c)),
                      (AUX_SCAN, lambda c: aux_cut(dev, max_batch=64, capture=c)),
                      (f"{GANGS} at max_batch 64",
                       lambda c: gang_drive(dev, capture=c, max_batch=64))):
        cap = {}
        run(cap)
        check(cap, f"{name}: no scan-path dispatch captured")
        p = cap["plan"]
        out[f"{name}, first scan batch"] = entry(cap["state"], p.features, p.facts,
                                                 p.fit_strategy, p.batch_pad, cap["n_act"],
                                                 cap["carry"], p.vmax)
    return out


def gate_inputs(dev) -> dict:
    """Every timed input of dry_run_preemption and static_masks, by name,
    for ab_windows.py --gates: the dry runs of Unschedulable's churn pod
    (10000 victims on 5000 rows) and of a preemptor after the preempting
    case (one victim a row), seeded draws at K 64 and 256 and at R 33 (two
    slots a lane); static_masks on a SchedulingBasic pod and on the
    preemptor against those clusters, a seeded draw with two tolerations
    and one with 40 taint slots. Each is
    (kind, state, features and, for a dry run, vic_req, vic_valid, K), its
    tensors on the CPU."""
    from kubernetes_tpu_torch import bench
    from kubernetes_tpu_torch.testing import make_pod
    from kubernetes_tpu_torch.testing.kernel_inputs import (random_inputs, static_edge_inputs,
                                                            victim_edge_inputs, victim_inputs)

    def cpu(ts):
        return [t.detach().to("cpu").clone() for t in ts]

    def dry(args):
        st, ft, vr, vv, k = args
        return dict(kind="dry", state=cpu(st), feats=cpu(ft), vic_req=vr.cpu(), vic_valid=vv.cpu(),
                    k=k)

    def masks(st, ft):
        return dict(kind="masks", state=cpu(st), feats=cpu(ft))

    out = {}
    unsched = run_path(dev, UNSCHED, churn_limit=CHURN_PODS)[0]
    churn = bench.WORKLOADS[UNSCHED].churn.build(make_pod().name("timed-churn")).obj()
    out[f"dry run: {UNSCHED}'s churn pod"] = dry(dry_run_inputs(unsched, churn))
    pre = preempting_case(dev)[0]
    preemptor = bench.make_pods(1, "timed-pre", PREEMPT)[0]
    pargs = dry_run_inputs(pre, preemptor)
    out["dry run: a preemptor after the preempting case"] = dry(pargs)
    for name, (s, f, vr, vv), k in (
            ("dry run: seeded draw, K 64", victim_inputs(1400, 8192, 5000, 64), 64),
            ("dry run: seeded draw, K 256", victim_inputs(1401, 8192, 5000, 256), 256),
            ("dry run: seeded draw, R 33, K 8", victim_edge_inputs(1402, 8192, 5000, 8, r_slots=33),
             8)):
        st, ft = to_device("cpu", s, f)
        out[name] = dict(kind="dry", state=list(st), feats=list(ft),
                         vic_req=torch.from_numpy(vr), vic_valid=torch.from_numpy(vv), k=k)
    pod = bench.make_pods(1, "timed")[0]
    st, plan = unsched.build_plan(unsched.framework_for_pod(pod), pod, unsched.max_batch)
    out[f"static_masks: a SchedulingBasic pod on {UNSCHED}'s cluster"] = masks(st, plan.features)
    out["static_masks: the preemptor after the preempting case"] = masks(pargs[0], pargs[1])
    out["static_masks: seeded draw, T 4, L 2"] = masks(*to_device(
        "cpu", *random_inputs(1403, 8192, 5000)))
    out["static_masks: seeded draw, T 40, L 2"] = masks(*to_device(
        "cpu", *static_edge_inputs(1404, 8192, 5000, taints=40, pad_taints=True)))
    return out


MIRROR_FIELDS = ("h_alloc_r", "h_alloc_pods", "h_req_r", "h_nonzero", "h_pod_count",
                 "h_taint_key", "h_taint_val", "h_taint_eff", "h_unsched", "h_valid",
                 "h_name_id", "h_topo")


def patch_inputs_ab(dev) -> dict:
    """Every timed whole patch, for ab_windows.py --patches: the preempting
    case's mirror (its host staging and capacity tiers) with flush_inputs'
    rows, and the wave drive's first carry patch of each tier (state,
    features, carry, rows, fit strategy) with that drive's host aggregates.
    Tensors on the CPU."""
    pre = preempting_case(dev)[0]
    paths = {PREEMPTING: (pre,), PLACE: placement_drive(dev)}
    m = pre.mirror
    d_pre = max(1, round(m.scatter_rows / max(1, m.scatter_flushes)))
    capture = {}
    wm = wave_drive(dev, capture=capture)[0].mirror

    def cpu(ts):
        return [t.detach().to("cpu").clone() for t in ts]

    carries = {}
    for tier, (state, f, carry, rows, strat) in sorted(capture.items()):
        carries[f"the {WAVES}' {tier}-row tier"] = dict(
            state=cpu(state), feats=cpu(f), carry=cpu(carry), rows=rows, strat=strat)
    return dict(mirror=[torch.from_numpy(getattr(m, n).copy()) for n in MIRROR_FIELDS],
                caps=[m.np_cap, m.t_cap, m.s_cap, m.k_cap],
                flushes=flush_inputs(paths, d_pre),
                carry_mirror=[torch.from_numpy(a.copy())
                              for a in (wm.h_req_r, wm.h_nonzero, wm.h_pod_count)],
                carries=carries)


def eval_inputs(dev) -> dict:
    """Every timed input of resource_eval and whatif_score, by name, for
    ab_windows.py --evals: resource_eval on SchedulingBasic's and
    TopologySpreading's next batch (a fresh batch's seed, NP 8192, R 7,
    FR 2, after each path's run), on TopologySpreading's with a nominated
    lane under MostAllocated, and on a seeded draw with the lane at R 9,
    FR 3; whatif_score (the kernel, and the whole score call) on the
    rebalance drive's first what-if batch and on a seeded 128 x 5000 batch
    with both hazards. Each is (kind, and the state, features and fit
    strategy or the batch's nine arrays), its tensors on the CPU."""
    from kubernetes_tpu_torch import bench
    from kubernetes_tpu_torch.testing.kernel_inputs import (nominated_lane,
                                                            resource_edge_inputs, whatif_inputs)

    def cpu(ts):
        return [t.detach().to("cpu").clone() for t in ts]

    out = {}
    topo = "TopologySpreading/5000Nodes_5000Pods"
    for wl in (BASIC, topo):
        sched = run_path(dev, wl)[0]
        pod = bench.make_pods(1, "timed", wl)[0]
        st, plan = sched.build_plan(sched.framework_for_pod(pod), pod, sched.max_batch)
        feats = plan.features
        out[f"resource_eval: {wl}'s next batch"] = dict(
            kind="eval", state=cpu(st), feats=cpu(feats), strat=plan.fit_strategy)
    NP, R = st.alloc_r.shape
    nom_req, nom_pods = nominated_lane(700, NP, int(st.valid.sum()), R)
    lane = feats._replace(nom_req=torch.from_numpy(nom_req), nom_pods=torch.from_numpy(nom_pods))
    out[f"resource_eval: {topo}'s, a nominated lane, MostAllocated"] = dict(
        kind="eval", state=cpu(st), feats=cpu(lane), strat=1)
    st, ft = to_device("cpu", *resource_edge_inputs(1600, 8192, 5000, r_slots=9, fit_slots=3,
                                                    lane=True))
    out["resource_eval: seeded draw, R 9, FR 3, a lane"] = dict(
        kind="eval", state=list(st), feats=list(ft), strat=0)
    capture = {}
    rebalance_drive(dev, capture=capture)
    for name, arrays in ((f"{REBAL}' first batch", capture["batch"]),
                         ("seeded 128 x 5000, both hazards",
                          whatif_inputs(1601, 128, 5000, huge=True, negative=True))):
        out[f"whatif: {name}"] = dict(kind="whatif",
                                      batch=[torch.from_numpy(np.array(a)) for a in arrays])
    return out


def timing_phase(paths: dict, errs: dict, lane_inputs) -> dict:
    """Each kernel and its plain version timed on its main path's own
    inputs: the next batch's device state and features of the path's
    cluster after its measured run, at the path's shapes. The kernels are
    first held exactly equal to their plain versions on these inputs too.
    The lap also on the nominated-lane drive's own session, with its lane
    and with the lane taken out."""
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
        # A row: the fit filter (4 a slot), FR slots each scored with one
        # division (16 with the float64 path's conversions, product,
        # floor and correction), the two shares (16 each) and the rest.
        "resource_eval": (lambda: K.resource_eval(*res), lambda: K._resource_eval_plain(*res),
                          NP * (16 * R + 28) + NP * 17, NP * (4 * R + 16 * FR + 32)),
        "lap_schedule": (lambda: K.lap_schedule(st, ft, 1024, strat, ext0, static_ok, 1024),
                         lambda: K._lap_schedule_plain(st, ft, 1024, strat, ext0, static_ok,
                                                       1024),
                         NP * (16 * R + 37) + NP * (8 * R + 37) + 8 * 1024,
                         laps * (NP * pass_ops + K.LAP_MAX * row_ops) + NP * row_ops),
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
                "scan_general": "kubernetes_tpu/ops/kernel.py:314"}
    rows = {}
    for kname, (k_fn, p_fn, nbytes, ops) in calls.items():
        slow = kname == "scan_general"  # its plain version takes seconds
        rows[kname] = kernel_row(kname, replaces[kname], errs[kname], k_fn, p_fn, nbytes, ops,
                                 reps=5 if slow else 20, plain_reps=1 if slow else 2)
    rows["static_masks"]["call_split"] = split = static_masks_call_split(K, st, ft)
    print("static_masks call split (ms a call, host clock): " + ", ".join(
        f"{k[:-3]} {v:.5f}" for k, v in split.items()), flush=True)
    rows["resource_eval"]["call_split"] = split = resource_eval_call_split(K, res)
    print("resource_eval call split (ms a call, host clock): " + ", ".join(
        f"{k[:-3]} {v:.5f}" for k, v in split.items()), flush=True)
    rows["lap_schedule"]["laps"] = laps
    rows["lap_schedule"]["us_a_lap"] = rows["lap_schedule"]["ms"] * 1e3 / laps
    rows["scan_general"]["steps"] = gB
    rows["scan_general"]["inputs"] = general_inputs_timing(paths, name, rows["scan_general"])
    # scan_general on the scan path's row-local plan (the reference's scan
    # step at 64 steps): SchedulingBasic's next batch, held exact first.
    masks = K._static_masks_plain(st, ft)
    local = (lambda: K.scan_general(st, ft, 64, strat, ext0, masks, 64, plan.facts),
             lambda: K._scan_general_plain(st, ft, 64, strat, ext0, masks, 64, plan.facts))
    check(K.plan_path(ft, plan.facts, 64) == "scan", "SchedulingBasic's plan is not row-local")
    (o_k, c_k), (o_p, c_p) = local[0](), local[1]()
    check(max_abs_err((o_k,) + tuple(c_k), (o_p,) + tuple(c_p)) == 0,
          "scan_general disagrees with its plain version on the scan path's plan")
    case = kernel_row("scan_general", "", errs["scan_general"], *local,
                      NP * (16 * R + 54) + NP * (8 * R + 37) + 8 * 64,
                      64 * NP * 16 + NP * 24 + 64 * row_ops)
    rows["scan_general"]["row_local"] = {k: case[k] for k in (
        "ms", "ms_launches_seen", "host_ms", "plain_ms", "bound_ms", "bound_by", "bytes", "ops")}
    # The schedule kernels with a nominated-pod lane on the same inputs
    # (held exact for the lap and the row-local scan here too).
    from kubernetes_tpu_torch.testing.kernel_inputs import nominated_lane

    def with_lane(f):
        nom_req, nom_pods = nominated_lane(700, NP, int(st.valid.sum()), R)
        return f._replace(nom_req=torch.from_numpy(nom_req).to(st.valid.device),
                          nom_pods=torch.from_numpy(nom_pods).to(st.valid.device))

    ft_l, gf_l = with_lane(ft), with_lane(gf)
    # resource_eval on the main path's own fresh batch, and with a nominated
    # lane under MostAllocated, each held exact first.
    evals = {}
    for what, (s_, f_, fs_) in {f"{BASIC}'s next batch": (st, ft, strat),
                                f"{name}'s fresh batch": (gst, gf, gplan.fit_strategy),
                                f"{name}'s, a nominated lane, MostAllocated": (gst, gf_l, 1)
                                }.items():
        args = (f_, fs_, s_.alloc_r, s_.alloc_pods, s_.req_r, s_.nonzero, s_.pod_count,
                *K._nom_lane(f_))
        fn = lambda a=args: K.resource_eval(*a)  # noqa: E731
        check(max_abs_err(fn(), K._resource_eval_plain(*args)) == 0,
              f"resource_eval disagrees with its plain version on {what}")
        ms, seen = device_ms(fn, "resource_eval")
        evals[what] = dict(ms=ms, launches_seen=seen, host_ms=wall_ms(fn, reps=20),
                           rows=s_.alloc_r.shape[0], slots=s_.alloc_r.shape[1],
                           fit_slots=f_.fit_slots.shape[0])
        print(f"resource_eval on {what} (NP {s_.alloc_r.shape[0]}, R {s_.alloc_r.shape[1]}, "
              f"FR {f_.fit_slots.shape[0]}): {ms:.6f} ms on the device ({seen} of 20 seen), "
              f"{evals[what]['host_ms']:.4f} ms a call", flush=True)
    rows["resource_eval"]["inputs"] = evals
    lane_calls = {
        "lap_schedule": (lambda: K.lap_schedule(st, ft_l, 1024, strat, ext0, static_ok, 1024),
                         lambda: K._lap_schedule_plain(st, ft_l, 1024, strat, ext0, static_ok,
                                                       1024)),
        "row_local": (lambda: K.scan_general(st, ft_l, 64, strat, ext0, masks, 64, plan.facts),
                      lambda: K._scan_general_plain(st, ft_l, 64, strat, ext0, masks, 64,
                                                    plan.facts)),
        "scan_general": (lambda: K.scan_general(gst, gf_l, gB, gplan.fit_strategy, gext0, gmasks,
                                                gB, facts), None),
    }
    for kname, (k_fn, p_fn) in lane_calls.items():
        if p_fn is not None:
            (o_k, c_k), (o_p, c_p) = k_fn(), p_fn()
            check(max_abs_err((o_k,) + tuple(c_k), (o_p,) + tuple(c_p)) == 0,
                  f"{kname} with the nominated lane disagrees with its plain version")
        row = rows["scan_general"]["row_local"] if kname == "row_local" else rows[kname]
        row["ms_lane"], row["ms_lane_launches_seen"] = device_ms(
            k_fn, "scan_general" if kname == "row_local" else kname)
    # The lap on the nominated-lane drive's session: its nominations keep
    # the pods off the nominated rows, so only the freed rows take them;
    # without the lane the same call lands every pod.
    lst, lplan, l_act, l_free = lane_inputs
    lf = lplan.features
    l_ok = K._static_masks_plain(lst, lf).static_ok
    no_lane = lf._replace(nom_req=lf.nom_req[:0], nom_pods=lf.nom_pods[:0])
    lane_rows = {}
    for what, f_ in (("with_lane", lf), ("without_lane", no_lane)):
        l_ext0 = K.fresh_carry(lst, f_, lplan.vmax, K._resource_eval_plain(
            f_, lplan.fit_strategy, lst.alloc_r, lst.alloc_pods, lst.req_r, lst.nonzero,
            lst.pod_count, *K._nom_lane(f_)))
        args = (lst, f_, lplan.batch_pad, lplan.fit_strategy, l_ext0, l_ok, l_act)
        stats = {}
        (o_k, c_k), (o_p, c_p) = K.lap_schedule(*args), K._lap_schedule_plain(*args, stats=stats)
        check(max_abs_err((o_k,) + tuple(c_k), (o_p,) + tuple(c_p)) == 0,
              f"lap_schedule disagrees with its plain version on the {LANE} ({what})")
        placed = int((o_p[0] >= 0).sum())
        ms, seen = device_ms(lambda: K.lap_schedule(*args), "lap_schedule")
        lane_rows[what] = dict(ms=ms, launches_seen=seen, placed=placed, laps=stats["laps"],
                               us_a_lap=ms * 1e3 / stats["laps"])
    check(lane_rows["with_lane"]["placed"] == l_free
          and lane_rows["without_lane"]["placed"] == l_act,
          f"the {LANE}'s lap placed {lane_rows['with_lane']['placed']} with the lane and "
          f"{lane_rows['without_lane']['placed']} without, of {l_act}")
    rows["lap_schedule"]["lane_drive"] = lane_rows
    print(f"lap on the {LANE} session ({l_act} pods, {int(lf.nom_pods.sum())} nominations): "
          + ", ".join(f"{r['ms']:.4f} ms on the device {what.replace('_', ' ')} "
                      f"({r['placed']} placed, {r['laps']} laps, {r['us_a_lap']:.2f} us a lap)"
                      for what, r in lane_rows.items()), flush=True)
    loc = rows["scan_general"]["row_local"]
    print(f"scan_general on the scan path's row-local plan (64 steps, NP {NP}): "
          f"{loc['ms']:.4f} ms on the device ({loc['ms_lane']:.4f} with a nominated lane), "
          f"{loc['host_ms']:.4f} ms a call, plain {loc['plain_ms']:.3f} ms, bound "
          f"{loc['bound_ms']:.6f} ms ({loc['bound_by']})", flush=True)
    print(f"kernel times on the main paths' inputs (NP {NP}, R {R}, T {T}, L {L}, "
          f"{laps} laps per 1024-pod batch; scan_general {gB} steps, V {gplan.vmax}): "
          + ", ".join(f"{n} {r['ms']:.4f} ms on the device"
                      + (f" ({r['us_a_lap']:.2f} us a lap)" if "us_a_lap" in r else "")
                      + (f" ({r['ms_lane']:.4f} with a nominated lane)" if "ms_lane" in r else "")
                      + f", {r['host_ms']:.4f} ms a call (plain {r['plain_ms']:.3f})"
                      for n, r in rows.items()),
          flush=True)
    return rows


def general_inputs_timing(paths: dict, main: str, main_row: dict) -> dict:
    """scan_general on the next batch of each path that launches it: the
    main path's (timed in its kernels row) and PreferredTopologySpreading's
    (normalized scores, incremental feasibility) and SchedulingPodAffinity's
    (full feasibility, the affinity table), each held exact against the
    plain version, then its device ms (torch.profiler) and call ms (CUDA
    events)."""
    from kubernetes_tpu_torch import bench
    from kubernetes_tpu_torch.ops import kernel as K

    out = {}
    for name in (main, "PreferredTopologySpreading/5000Nodes_5000Pods",
                 "SchedulingPodAffinity/5000Nodes_5000Pods"):
        sched = paths[name][0]
        pod = bench.make_pods(1, "timed", name)[0]
        st, plan = sched.build_plan(sched.framework_for_pod(pod), pod, sched.max_batch)
        f, facts, B = plan.features, plan.facts, plan.batch_pad
        e, placed = compare_general(K, st, f, facts, B, (plan.fit_strategy,))
        check(e == 0, f"scan_general disagrees with its plain version on {name}'s next batch")
        incremental, carried = K.plan_modes(f, facts)
        row = dict(steps=B, vmax=plan.vmax, incremental=incremental, carried=carried,
                   max_abs_err=e, placed=placed)
        if name == main:
            row.update(ms=main_row["ms"], launches_seen=main_row["ms_launches_seen"],
                       host_ms=main_row["host_ms"])
        else:
            masks = K._static_masks_plain(st, f)
            ext0 = K.fresh_carry(st, f, plan.vmax, K._resource_eval_plain(
                f, plan.fit_strategy, st.alloc_r, st.alloc_pods, st.req_r, st.nonzero,
                st.pod_count))
            fn = (lambda st=st, f=f, B=B, s=plan.fit_strategy, e0=ext0, m=masks, fa=facts:
                  K.scan_general(st, f, B, s, e0, m, B, fa))
            row["ms"], row["launches_seen"] = device_ms(fn, "scan_general")
            row["host_ms"] = wall_ms(fn, reps=5)
        out[name] = row
        print(f"scan_general on {name}'s next batch ({B} steps, V {plan.vmax}, incremental "
              f"{incremental}, carried {carried}): exact, {row['ms']:.4f} ms on the device, "
              f"{row['host_ms']:.4f} ms a call", flush=True)
    return out


def kernel_row(kname, replaces, err, k_fn, p_fn, nbytes, ops, library_ms=None, reps=20,
               plain_reps=2):
    """A `kernels` line row: device ms (torch.profiler, over the
    `ms_launches_seen` of 20 launches it saw), wall ms a call and the plain
    version's (CUDA events), and the bound."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S * 1e3
    ms, seen = device_ms(k_fn, kname)
    return dict(name=kname, route="cuda", source=f"kubernetes_tpu_torch/csrc/{kname}.cu",
                replaces=replaces, launches=0, max_abs_err=err, exact=err == 0,
                ms=ms, ms_launches_seen=seen, host_ms=wall_ms(k_fn, reps=reps),
                plain_ms=wall_ms(p_fn, reps=plain_reps, warmup=1), bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations", library_ms=library_ms,
                bytes=nbytes, ops=ops)


def launch_floor_ms(dev, reps: int = 20) -> tuple:
    """(mean device ms, launches seen) of a one-element fill_ on the
    current stream, from torch.profiler: the least device time any kernel
    launch takes on this card, the floor the short kernels are read
    against. A trace that lost the fills is taken again as device_ms
    does; when every one lost them, 0 seen is returned with the fills'
    time back to back on CUDA events, an upper bound."""
    one = torch.empty(1, device=dev)
    return device_ms(lambda: one.fill_(1), "fill", reps, pick=lambda name: "fill" in name.lower())


def host_ms(f, reps: int) -> float:
    """Mean ms a call of `f` on the host's clock over `reps` calls back to
    back (after 50 warm-up calls), the card drained before and after."""
    for _ in range(50):
        f()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        f()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def call_split(K, name: str, dev, alloc, args, call, reps: int = 2000, **others) -> dict:
    """Where a wrapper's host time goes, each part timed alone over `reps`
    calls on the host's clock (ms a call): `alloc()` (the outputs the
    wrapper makes), _marshal's checks of `args` (the launcher's arguments),
    the ctypes call of the launcher with its stream (the launch), `call()`
    (the whole wrapper) and each of `others` (`<key>_ms`, for comparison);
    the rest is the whole less the three parts."""
    from kubernetes_tpu_torch.ops import _build

    cargs = K._marshal(name, dev, args)
    fn = _build.launcher(name)
    out = dict(alloc_ms=host_ms(alloc, reps),
               **{f"{k}_ms": host_ms(f, reps) for k, f in others.items()},
               marshal_ms=host_ms(lambda: K._marshal(name, dev, args), reps),
               launch_ms=host_ms(lambda: fn(*cargs, K._stream(dev)), reps),
               call_ms=host_ms(call, reps))
    out["rest_ms"] = out["call_ms"] - out["alloc_ms"] - out["marshal_ms"] - out["launch_ms"]
    return out


def static_masks_call_split(K, st, ft) -> dict:
    """call_split of static_masks: the one output buffer and its seven
    views, the seven separate allocations the wrapper made before (for
    comparison, `alloc_seven`), _marshal's checks of the 27 arguments, the
    launch, the whole wrapper."""
    dev = st.valid.device
    NP, T = st.taint_key.shape
    L = ft.tol_key.shape[0]
    NPa = -(-NP // 8) * 8

    def alloc():
        return K._static_mask_views(torch.empty(14 * NPa, dtype=torch.uint8, device=dev), NP)

    def alloc_seven():
        return ([torch.empty(NP, dtype=torch.bool, device=dev) for _ in range(6)],
                torch.empty(NP, dtype=torch.int64, device=dev))

    args = (NP, T, L, st.taint_key, st.taint_val, st.taint_eff, ft.tol_key, ft.tol_val,
            ft.tol_eff, ft.tol_op, ft.sel_match, ft.node_name_id, st.name_id, st.unsched,
            ft.tolerates_unsched, ft.exist_anti, ft.enable, st.valid, ft.extra_ok, *alloc())
    return call_split(K, "static_masks", dev, alloc, args, lambda: K.static_masks(st, ft),
                      alloc_seven=alloc_seven)


def resource_eval_call_split(K, res) -> dict:
    """call_split of resource_eval on the arguments `res`: the wrapper's
    three output allocations, one byte buffer viewed as the three (the
    layout measured against them, `one_buffer`), _marshal's checks of the
    21 arguments, the launch, the whole wrapper."""
    f, strat, alloc_r = res[0], res[1], res[2]
    dev, NP = alloc_r.device, alloc_r.shape[0]

    def alloc():
        return (torch.empty(NP, dtype=torch.bool, device=dev),
                torch.empty(NP, dtype=torch.int64, device=dev),
                torch.empty(NP, dtype=torch.int64, device=dev))

    def one_buffer():
        buf = torch.empty(17 * NP, dtype=torch.uint8, device=dev)
        lanes = buf[:16 * NP].view(torch.int64)
        return buf[16 * NP:].view(torch.bool), lanes[:NP], lanes[NP:]

    ints, feats = K._res_args(f, strat)
    args = (NP, *ints, *feats, *res[2:], *K._nom_lane(f), *alloc())
    return call_split(K, "resource_eval", dev, alloc, args, lambda: K.resource_eval(*res),
                      one_buffer=one_buffer)


def library_device_ms(fn, reps: int = 20) -> float:
    """Device time per call of `fn`'s kernels (copies excluded), from
    torch.profiler; a trace that saw none of them is taken again, up to
    five traces, and then the calls are timed back to back on CUDA events
    (an upper bound)."""
    for _attempt in range(5):
        spans = [t for name, t in traced(fn, reps)
                 if "memcpy" not in name.lower() and "memset" not in name.lower()]
        if spans:
            return sum(spans) / reps / 1e3
    print(f"library_device_ms: every trace lost the kernels; timed with CUDA events over "
          f"{reps} calls back to back", flush=True)
    return wall_ms(fn, reps=reps)


def dry_run_inputs(sched, pod) -> tuple:
    """(state, features, vic_req, vic_valid, k) of `pod`'s device dry run
    on `sched`'s cluster as it stands, built as the scheduler's
    device_dry_run_preemption builds them."""
    from kubernetes_tpu_torch.ops.features import build_preemption_victims

    sched.cache.update_snapshot(sched.snapshot)
    sched.mirror.sync(sched.snapshot.node_info_list)
    vic_req, vic_valid, _potential = build_preemption_victims(pod, sched.snapshot, sched.mirror)
    st, plan = sched.build_plan(sched.framework_for_pod(pod), pod, 1)
    R = st.alloc_r.shape[1]
    if vic_req.shape[2] != R:  # the preemptor's own new scalar slots: no victim requests them
        grown = np.zeros(vic_req.shape[:2] + (R,), np.int64)
        grown[:, :, :vic_req.shape[2]] = vic_req
        vic_req = grown
    dev = st.valid.device
    return (st, plan.features, torch.from_numpy(vic_req).to(dev),
            torch.from_numpy(vic_valid).to(dev), vic_valid.shape[1])


def dry_run_cost(st, ft, vic_valid, k) -> tuple:
    """(bytes, ops) of one dry run on these inputs, what the run's data
    needs, read once: the [NP, K] victim flags, the R requests of each
    valid victim (an invalid slot's are never read), and the allocatable,
    requested, count and static-filter inputs of the live rows (below
    num_nodes); the [NP, 1 + K] verdicts written once. Ops: each live
    row's static filter and fit test, and per valid victim its removal
    and a fit test over R slots."""
    NP, R = st.alloc_r.shape
    T, L = st.taint_key.shape[1], ft.tol_key.shape[0]
    live, victims = int(ft.num_nodes), int(vic_valid[:int(ft.num_nodes)].sum())
    nbytes = NP * k + victims * R * 8 + live * (R * 16 + 12 + 12 * T + 12) + NP * (1 + k)
    ops = live * (T * (10 * L + 6) + 4 * R + 12) + victims * (5 * R + 12)
    return nbytes, ops, live, victims


def preemption_timing(paths: dict, errs: dict) -> dict:
    """dry_run_preemption on Unschedulable's own dry-run inputs (a churn pod
    against the cluster after the 10000 measured pods), which its kernels
    row reports, and on the preempting case's (a preemptor against the
    cluster after its 256 preemptions, one victim a row), where 256 of its
    launches run; each held exact first."""
    from kubernetes_tpu_torch import bench
    from kubernetes_tpu_torch.ops import kernel as K
    from kubernetes_tpu_torch.testing import make_pod

    rows = {}
    sched = paths[UNSCHED][0]
    pod = bench.WORKLOADS[UNSCHED].churn.build(make_pod().name("timed-churn")).obj()
    cases = {UNSCHED: dry_run_inputs(sched, pod),
             PREEMPTING: dry_run_inputs(paths[PREEMPTING][0],
                                        bench.make_pods(1, "timed-pre", PREEMPT)[0])}
    inputs = {}
    for name, args in cases.items():
        check(max_abs_err((K.dry_run_preemption(*args),), (K._dry_run_preemption_plain(*args),))
              == 0, f"dry_run_preemption disagrees with its plain version on {name}'s inputs")
        st, ft, _vr, vv, k = args
        nbytes, ops, live, victims = dry_run_cost(st, ft, vv, k)
        row = kernel_row("dry_run_preemption", "kubernetes_tpu/ops/kernel.py:727",
                         errs["dry_run_preemption"], lambda a=args: K.dry_run_preemption(*a),
                         lambda a=args: K._dry_run_preemption_plain(*a), nbytes, ops)
        row.update(k=k, victims=victims, live_rows=live, R=int(st.alloc_r.shape[1]))
        inputs[name] = row
        print(f"dry_run_preemption on {name}'s dry run (NP {st.valid.shape[0]}, K {k}, R "
              f"{row['R']}, {victims} victims on {live} live rows): exact, {row['ms']:.6f} ms on "
              f"the device, {row['host_ms']:.4f} ms a call, plain {row['plain_ms']:.3f} ms, "
              f"bound {row['bound_ms']:.6f} ms", flush=True)
    # The host work around a dry run on the preempting case: the victim
    # tensors built in Python (build_preemption_victims, every node's pods
    # sorted) and their copy to the card.
    from kubernetes_tpu_torch.ops.features import build_preemption_victims

    pre = paths[PREEMPTING][0]
    preemptor = bench.make_pods(1, "timed-pre", PREEMPT)[0]
    t0 = time.perf_counter()
    for _ in range(5):
        vr, vv, _potential = build_preemption_victims(preemptor, pre.snapshot, pre.mirror)
    build_ms = (time.perf_counter() - t0) * 1e3 / 5
    dev = pre.mirror.device
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        torch.from_numpy(vr).to(dev)
        torch.from_numpy(vv).to(dev)
    torch.cuda.synchronize()
    copy_ms = (time.perf_counter() - t0) * 1e3 / 20
    inputs[PREEMPTING].update(victims_build_ms=build_ms, victims_copy_ms=copy_ms,
                              victims_copy_bytes=vr.nbytes + vv.nbytes)
    print(f"the preempting case's dry run on the host: build_preemption_victims {build_ms:.3f} ms, "
          f"its [NP, K, R] and [NP, K] copy to the card {copy_ms:.4f} ms "
          f"({vr.nbytes + vv.nbytes} bytes)", flush=True)
    rows["dry_run_preemption"] = dict(inputs[UNSCHED])
    rows["dry_run_preemption"]["inputs"] = {
        n: {key: r[key] for key in ("ms", "ms_launches_seen", "host_ms", "plain_ms", "bound_ms",
                                    "bound_by", "bytes", "ops", "k", "victims", "live_rows",
                                    "victims_build_ms", "victims_copy_ms", "victims_copy_bytes")
            if key in r}
        for n, r in inputs.items()}

    print("preemption kernels: " + ", ".join(
        f"{n} {r['ms']:.4f} ms on the device, {r['host_ms']:.4f} ms a call, plain "
        f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.6f} ms ({r['bound_by']})"
        for n, r in inputs.items()), flush=True)
    return rows


def scatter_timing(paths: dict, errs: dict) -> dict:
    """scatter_rows at the preempting case's dirty rows per flush, on its
    mirror's resident state, held exact first, beside twelve index_copy
    calls (the same function in library calls) and its bound; and the
    whole flush at flush_inputs' row counts (flush_costs)."""
    from kubernetes_tpu_torch.ops import kernel as K

    rows = {}
    mirror = paths[PREEMPTING][0].mirror
    dev = mirror.device
    d = max(1, round(mirror.scatter_rows / max(1, mirror.scatter_flushes)))
    at = list(range(0, 5000, 5000 // d))[:d]
    state = mirror.flush()
    idx, packed = K.stage_scatter(mirror.ring(dev), mirror._arrays(), mirror.h_topo, at)
    a = K.scatter_rows(state, idx, packed)
    b = K._scatter_rows_plain(state, idx, packed)
    check(max_abs_err(tuple(a), tuple(b)) == 0,
          "scatter_rows disagrees with its plain version on the preempting case's rows")
    at64 = idx.to(torch.int64)
    unpacked = K.unpack_rows(packed, d, *K._widths(state))

    def index_copy():  # the same function as twelve library calls: a new tensor a field
        return ([field.index_copy(0, at64, r) for field, r in zip(state[:-1], unpacked[:-1])]
                + [state.topo.index_copy(1, at64, unpacked.topo)])

    # Bytes: the old state read once and the new one written once, and each
    # staged row and its index read once; ops: one move per element.
    NP = state.valid.shape[0]
    row_bytes = sum(x[0].nbytes for x in mirror._arrays()) + mirror.h_topo[:, 0].nbytes
    elements = sum(int(t[0].numel()) for t in state[:-1]) + state.topo.shape[0]
    rows["scatter_rows"] = kernel_row(
        "scatter_rows", "kubernetes_tpu/ops/device_state.py:130", errs["scatter_rows"],
        lambda: K.scatter_rows(state, idx, packed), lambda: K._scatter_rows_plain(state, idx, packed),
        2 * NP * row_bytes + d * (row_bytes + 4), NP * elements,
        library_ms=library_device_ms(index_copy))
    rows["scatter_rows"].update(rows_per_flush=d, flushes=mirror.scatter_flushes,
                                whole_patch=flush_costs(paths, d))
    r = rows["scatter_rows"]
    print(f"scatter_rows on the {PREEMPTING}'s {d} rows per flush: {r['ms']:.6f} ms on the "
          f"device, {r['host_ms']:.4f} ms a call, plain {r['plain_ms']:.3f} ms, bound "
          f"{r['bound_ms']:.6f} ms ({r['bound_by']}), library {r['library_ms']}", flush=True)
    return rows


def whole_patch_cost(fn, kernel: str, reps: int = 200, calls: int = 20) -> dict:
    """What one call of `fn` costs: host ms (perf_counter around each call,
    the calls back to back with nothing between them, so a call that waits
    on the card pays for the wait) and, from torch.profiler, the device ms
    of every CUDA op a call issues (kernels, copies, fills) summed, with
    their count a call by name. The profiler on the card can lose a trace's
    events, so a trace of `calls` calls counts only when it saw `kernel`'s
    launch `calls` times and a whole number of ops a call, and the sum is
    taken once two such traces saw as many ops (up to five traces). Where
    none agree, the calls are timed back to back with CUDA events instead:
    the device's span of the calls, gaps included, an upper bound of the
    sum, with device_ops 0 and device_timing "events", printed as such."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    host = 0.0
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        host += time.perf_counter() - t0
    torch.cuda.synchronize()
    host_ms = host / reps * 1e3
    whole = {}  # op count -> the traces that saw every launch and that many ops
    for attempt in range(5):
        events = traced(fn, calls)
        launches = sum(f"{kernel}_kernel" in name for name, _us in events)
        if launches == calls and len(events) % calls == 0:
            agree = whole.setdefault(len(events), [])
            agree.append(events)
            if len(agree) == 2:
                names = {}
                for name, _us in events:
                    names[name] = names.get(name, 0) + 1
                sums = [sum(us for _n, us in ev) for ev in agree]
                return dict(host_ms=host_ms, device_sum_ms=sum(sums) / 2 / calls / 1e3,
                            device_ops=len(events) / calls, device_timing="profiler",
                            ops={n: c / calls for n, c in sorted(names.items())})
        else:
            print(f"whole_patch_cost: trace {attempt + 1} saw {launches} of {calls} {kernel} "
                  f"launches in {len(events)} CUDA ops (whole traces so far: "
                  f"{ {n: len(v) for n, v in whole.items()} })", flush=True)
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    b.synchronize()
    ms = a.elapsed_time(b) / calls
    print(f"whole_patch_cost: {kernel}'s patch timed with CUDA events over {calls} calls back "
          f"to back: {ms:.6f} ms a call, gaps included (no two traces agreed)", flush=True)
    return dict(host_ms=host_ms, device_sum_ms=ms, device_ops=0, device_timing="events", ops={})


def flush_inputs(paths: dict, d_pre: int) -> dict:
    """The rows of each timed flush, by name: the preempting case's rows per
    flush (`d_pre`), the placement drive's, 64 and 2048 rows, each spread
    over the 5000 live rows of the preempting case's mirror."""
    place = paths[PLACE][0].mirror
    d_place = round(place.scatter_rows / place.scatter_flushes) if place.scatter_flushes else 0
    out = {}
    for name, d in ((f"the {PREEMPTING}'s rows per flush", d_pre),
                    (f"the {PLACE}'s rows per flush", d_place), ("64 rows", 64),
                    ("2048 rows", 2048)):
        if d:
            out[name] = list(range(0, 5000, 5000 // d))[:d]
    return out


def flush_costs(paths: dict, d_pre: int) -> dict:
    """The whole flush (NodeStateMirror._scatter_dirty: the staging, the
    upload and the launch) on the preempting case's mirror at each of
    flush_inputs' row counts, held exact against the plain version on the
    same host rows first."""
    from kubernetes_tpu_torch.ops import kernel as K

    mirror = paths[PREEMPTING][0].mirror
    out = {}
    for name, at in flush_inputs(paths, d_pre).items():
        got = mirror._scatter_dirty(at)
        want = K._scatter_rows_plain(mirror._device, *K.stage_scatter(
            mirror.ring(mirror.device), mirror._arrays(), mirror.h_topo, at))
        check(max_abs_err(tuple(got), tuple(want)) == 0,
              f"the flush of {name} disagrees with the plain version")
        out[name] = dict(rows=len(at), **whole_patch_cost(lambda a=at: mirror._scatter_dirty(a),
                                                         "scatter_rows"))
        r = out[name]
        print(f"whole flush, {name} ({len(at)}): {r['host_ms']:.4f} ms of host a call, "
              f"{r['device_sum_ms']:.6f} ms of device in {r['device_ops']:g} ops "
              f"({r['device_timing']}: {json.dumps(r['ops'])})", flush=True)
    return out


def placement_cost(K, args) -> tuple:
    """(bytes, ops) of a schedule_placements call: summed over the real
    lanes (the candidate placements), each the fresh carry of its rows (and
    its blocked and aux_cnt lanes) and general_cost's steps over its rows,
    and its row mask read once."""
    state, f, _B, _strat, _vmax, facts, masks, n_act = args[:8]
    NP, R = state.alloc_r.shape
    FR = f.fit_slots.shape[0]
    lane_facts = facts._replace(has_ipa_base=False, anti_rowlocal=False)
    nbytes = ops = 0
    for rows in masks.sum(dim=1).tolist():
        if not rows:
            continue  # a padded lane
        b, o = general_cost(f, lane_facts, K, n_act, rows=rows)
        nbytes += NP + rows * (16 * R + 28 + 2 * facts.port_selfblock + 4 * facts.has_aux) + b
        ops += rows * (4 * R + 12 * FR + 24) + o
    return nbytes, ops


def placement_timing(waves: dict, errs: dict) -> dict:
    """schedule_placements on the placement drive's first group cycle (its
    own masks and plan), held exact first, with placement_cost's bound."""
    from kubernetes_tpu_torch.ops import kernel as K

    cap = waves["placement_capture"]
    check(cap, f"the {PLACE} made no placement evaluation")
    args = cap["args"]
    state, f, _B, _strat, _vmax, facts, masks, n_act = args[:8]
    check(max_abs_err((K.schedule_placements(*args),), (K._schedule_placements_plain(*args),))
          == 0, f"schedule_placements disagrees with its plain version on the {PLACE}' inputs")
    NP = state.alloc_r.shape[0]
    lane_facts = facts._replace(has_ipa_base=False, anti_rowlocal=False)
    nbytes, ops = placement_cost(K, args)
    row = kernel_row("schedule_placements", "kubernetes_tpu/ops/kernel.py:655",
                     errs["schedule_placements"], lambda: K.schedule_placements(*args),
                     lambda: K._schedule_placements_plain(*args), nbytes, ops, plain_reps=1)
    row.update(lanes=int(masks.shape[0]), placements=cap["placements"], members=n_act,
               plan_path=K.plan_path(f, lane_facts, args[2]))
    print(f"schedule_placements on the {PLACE}' first group ({row['lanes']} lanes, "
          f"{row['placements']} placements, {n_act} members, NP {NP}): {row['ms']:.4f} ms on the "
          f"device, {row['host_ms']:.4f} ms a call, plain {row['plain_ms']:.3f} ms, bound "
          f"{row['bound_ms']:.6f} ms ({row['bound_by']})", flush=True)
    return {"schedule_placements": row}


def patch_timing(waves: dict, errs: dict) -> dict:
    """patch_carry_rows on the wave drive's own patches (the first call of
    each tier the drive used), held exact first, with the drive's plan
    acquisition seconds by kind beside it: delta and resume acquisitions
    against full rebuilds, with resume and in the same drive without it."""
    from kubernetes_tpu_torch.ops import kernel as K

    mirror = waves["wave_mirror"]
    tiers = {}
    for tier, (state, f, carry, rows, strat) in sorted(waves["capture"].items()):
        # The patch's inputs staged from the drive's host aggregates as the
        # mirror stages them (its rows' values now, after the drive).
        prows = rows + [rows[-1]] * (tier - len(rows))
        staged = K.stage_carry_patch(mirror.ring(mirror.device), prows, mirror.h_req_r,
                                     mirror.h_nonzero, mirror.h_pod_count)
        args = (state, f, carry, *staged, strat)
        idx = staged[0]
        check(max_abs_err(tuple(K.patch_carry_rows(*args)),
                          tuple(K._patch_carry_rows_plain(*args))) == 0,
              f"patch_carry_rows disagrees with its plain version on the {WAVES}' {tier}-row patch")
        NP, R = state.alloc_r.shape
        FR = f.fit_slots.shape[0]
        lane = f.nom_req.shape[0] > 0
        d = int(torch.unique(idx).numel())
        # What the patch needs: the six lanes read once and written once,
        # each staged row (index, aggregates) read once, and each distinct
        # row's allocatable (and lane) read once. Ops: one resource_eval of
        # each distinct row.
        nbytes = 2 * NP * (8 * R + 16 + 4 + 1 + 8 + 8) + tier * (4 + 8 * R + 16 + 4) \
            + d * (8 * R + 8 + (8 * R + 4 if lane else 0))
        ops = d * (4 * R + 12 * FR + 24)
        tiers[tier] = kernel_row("patch_carry_rows", "kubernetes_tpu/ops/kernel.py:584",
                                 errs["patch_carry_rows"], lambda a=args: K.patch_carry_rows(*a),
                                 lambda a=args: K._patch_carry_rows_plain(*a), nbytes, ops)
        # The whole carry call of a delta patch (NodeStateMirror.patch_carry:
        # the staging, the upload and the launch) on the same rows, held
        # exact against the plain version on the same host rows first.
        got = mirror.patch_carry(state, f, carry, rows, strat)
        check(max_abs_err(tuple(got), tuple(K._patch_carry_rows_plain(*args))) == 0,
              f"the whole carry patch of {tier} rows disagrees with the plain version")
        whole = whole_patch_cost(lambda a=args, r=rows: mirror.patch_carry(a[0], a[1], a[2], r,
                                                                           a[-1]),
                                 "patch_carry_rows")
        tiers[tier].update(tier=tier, rows=d, whole_patch=whole)
        print(f"whole carry patch, the {WAVES}' {tier}-row tier ({d} rows): "
              f"{whole['host_ms']:.4f} ms of host a call, {whole['device_sum_ms']:.6f} ms of "
              f"device in {whole['device_ops']:g} ops ({whole['device_timing']}: "
              f"{json.dumps(whole['ops'])})", flush=True)
    check(tiers, f"the {WAVES} made no carry patch")
    row = dict(tiers[max(tiers)])  # the between-session patch of a wave's deletes
    row["tiers"] = {t: {k: r[k] for k in ("ms", "ms_launches_seen", "host_ms", "plain_ms",
                                           "bound_ms", "bound_by", "rows", "whole_patch")}
                    for t, r in tiers.items()}
    plan_s = {}
    for key, per_wave in (("with_resume", waves["per_wave"]),
                          ("without_resume", waves["per_wave_without_resume"])):
        by_kind = {}
        for r in per_wave:
            if r["plan_rebuilds_full"] + r["plan_rebuilds_delta"] + r["plan_rebuilds_resume"] == 1:
                # one acquisition in the wave: its seconds are the wave's
                by_kind.setdefault(r["sessions"][0], []).append(r["plan_acquire_s"])
        plan_s[key] = {k: dict(sessions=len(v), mean_s=sum(v) / len(v), max_s=max(v))
                       for k, v in by_kind.items()}
    row["wave_drive_plan_s"] = plan_s
    row["nsselector_init_plans"] = dict(zip(("with_resume", "without_resume"),
                                            waves["nsselector_init_plans"]))
    print("patch_carry_rows on the wave drive's patches: " + ", ".join(
        f"K {t} ({r['rows']} rows) {r['ms']:.6f} ms on the device, {r['host_ms']:.4f} ms a call, "
        f"plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.8f} ms" for t, r in tiers.items())
        + f"; plan acquisition s by kind {json.dumps(plan_s)}; NSSelector init plans "
        f"{row['nsselector_init_plans']}", flush=True)
    return {"patch_carry_rows": row}


def whatif_timing(waves: dict, errs: dict) -> dict:
    """whatif_score on the rebalance drive's first what-if batch (its 128
    candidates x 5000 nodes), held exact first. Bytes: each input read once
    (the [N, R] and [N] node rows, the candidates' rows, the [P, N] mask)
    and the [P, N] fit mask and score written once. Ops: per cell the
    vacate test, the fit filter (4 a slot), the non-zero sums,
    LeastAllocated over two slots and BalancedAllocation, three divisions
    among them: 4R + 40. No single PyTorch call computes it."""
    from kubernetes_tpu_torch.ops import whatif as W

    batch = waves["whatif_capture"].get("batch")
    check(batch is not None, f"the {REBAL} made no what-if batch")
    dev = torch.device("cuda", 0)
    ts = W.batch_tensors(batch, dev)
    check(max_abs_err(W.whatif_score(*ts), W._whatif_score_plain(*ts)) == 0,
          f"whatif_score disagrees with its plain version on the {REBAL}' batch")
    P, N, R = batch.n_pods, batch.n_nodes, batch.alloc_r.shape[1]
    nbytes = N * (16 * R + 32) + P * (8 * R + 24) + P * N + P * N * 9
    # A cell: the vacate test, R slots (3 each), the sums, four divisions
    # by the node's divisors (8 each on the float64 path), the scores and
    # the writes; a node: its slack and constants, once.
    ops = P * N * (3 * R + 60) + N * (2 * R + 12)
    row = kernel_row("whatif_score", "kubernetes_tpu/ops/whatif.py:208", errs["whatif_score"],
                     lambda: W.whatif_score(*ts), lambda: W._whatif_score_plain(*ts), nbytes, ops)
    row.update(candidates=P, nodes=N, slots=R)
    print(f"whatif_score on the {REBAL}' first batch (P {P}, N {N}, R {R}): {row['ms']:.5f} ms "
          f"on the device, {row['host_ms']:.4f} ms a call, plain {row['plain_ms']:.3f} ms, bound "
          f"{row['bound_ms']:.6f} ms ({row['bound_by']}), library none", flush=True)
    # The whole score call (whatif_scores: the upload, the launch, the fetch
    # into pinned host memory), held exact first.
    from kubernetes_tpu_torch.ops.staging import StagingRing

    ring = StagingRing(dev)   # the descheduler keeps one for its batches
    fit, score = W.whatif_scores(batch, device=dev, ring=ring)
    want = W._whatif_score_plain(*ts)
    check(max_abs_err((torch.from_numpy(fit), torch.from_numpy(score)),
                      tuple(t.cpu() for t in want)) == 0,
          f"whatif_scores disagrees with the plain version on the {REBAL}' batch")
    row["whole_call"] = whole = whole_patch_cost(
        lambda: W.whatif_scores(batch, device=dev, ring=ring), "whatif_score")
    print(f"whatif_scores, the whole call on that batch: {whole['host_ms']:.4f} ms of host, "
          f"{whole['device_sum_ms']:.6f} ms of device in {whole['device_ops']:g} ops "
          f"({whole['device_timing']}: {json.dumps(whole['ops'])})", flush=True)
    return {"whatif_score": row}


# ---------------------------------------------------------------------------
# Phase 5: cuda/cpu parity
# ---------------------------------------------------------------------------

def parity_phase(dev, paths: dict):
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

    # Preemption: the victims (the surviving pods), nominations and
    # assignments of the cuda runs equal the device="cpu" runs'.
    def same_preemption(a, b, what):
        diffs = {k: (v, outcome(a).get(k)) for k, v in outcome(b).items()
                 if outcome(a).get(k) != v}
        check(outcome(a) == outcome(b), f"cuda/cpu preemption divergence ({what}): "
                                        f"{list(diffs.items())[:5]}")
        pa, pb = a.preemption_counts(), b.preemption_counts()
        check(pa == pb and pa["verify_divergences"] == 0, f"{what}: counts {pa} vs {pb}")
        check(a.preemption_device_evals == b.preemption_device_evals > 0,
              f"{what}: device dry runs {a.preemption_device_evals} vs "
              f"{b.preemption_device_evals}")
        print(f"parity ({what}): {len(outcome(b))} pods, {pb['victims']} victims, "
              f"{pb['attempts']} PostFilter attempts, {a.preemption_device_evals} device dry "
              "runs, identical", flush=True)

    runs = []
    for device in (dev, "cpu"):
        s = bench.build_cluster(50, device=device, node=bench.WORKLOADS[PREEMPT].node)
        bench.warm(s, 40, PREEMPT)
        bench.measure(s, 20, workload=PREEMPT)
        runs.append(s)
    check(runs[1].preemption_counts()["victims"] == 10, "PreemptionAsync/50Nodes: not 10 victims")
    same_preemption(runs[0], runs[1], "PreemptionAsync/50Nodes")
    cpu_sched, cpu_result, _l = preempting_case("cpu")
    check_preempting(cpu_sched, cpu_result, f"{PREEMPTING} on the cpu")
    same_preemption(paths[PREEMPTING][0], cpu_sched, PREEMPTING)
    same_preemption(paths[LANE][0], lane_drive("cpu")[0], LANE)

    # Incremental resume: the same assignments and plan acquisitions.
    def same_resume(a, b, what):
        got, want = assignments(a), assignments(b)
        diffs = {k: (v, got.get(k)) for k, v in want.items() if got.get(k) != v}
        check(not diffs, f"cuda/cpu divergence ({what}): {list(diffs.items())[:5]}")
        ca, cb = ({c: getattr(x, c) for c in REBUILDS} for x in (a, b))
        check(ca == cb, f"{what}: counters {ca} vs {cb}")
        print(f"parity ({what}): {len(want)} pods, {cb}, identical", flush=True)

    same_resume(paths[WAVES][0], wave_drive("cpu")[0], WAVES)
    same_resume(paths[NSSEL][0], nsselector_drive("cpu")[0], NSSEL)
    gang_parity(dev, paths)
    rebalance_parity(dev)
    slice7_parity(dev, paths)
    volume_parity(dev, paths)


def rebalance_parity(dev) -> None:
    """The rebalance drive cut to REBAL_PARITY (1000 nodes, 400 pods, at
    most 5 ticks), same seed and parameters, on cuda and on the cpu: the
    same planned intents, eviction ledger, counters and final bindings."""
    runs = [rebalance_drive(device, **REBAL_PARITY)[0] for device in (dev, "cpu")]
    keys = ("moves", "blocked", "no_target", "drift", "evictions", "pending_evictions",
            "util_stddev_milli_before", "util_stddev_milli_after")
    a, b = ({k: r[k] for k in keys} for r in runs)
    check(a == b, f"{REBAL} cut: counters {a} vs {b}")
    ca, cb = runs[0]["ctrl"], runs[1]["ctrl"]
    check(ca.planned_intents == cb.planned_intents and ca.planned_intents,
          f"{REBAL} cut: the planned intents differ")
    check(runs[0]["cs"].eviction_ledger == runs[1]["cs"].eviction_ledger,
          f"{REBAL} cut: the eviction ledgers differ")
    check(ca.util_stddev_milli == cb.util_stddev_milli and len(runs[0]["ticks"]) == len(runs[1]["ticks"]),
          f"{REBAL} cut: the ticks differ")
    check(assignments(runs[0]["sched"]) == assignments(runs[1]["sched"]),
          f"{REBAL} cut: the final bindings differ")
    print(f"parity ({REBAL}, {REBAL_PARITY}): {len(runs[1]['ticks'])} ticks, "
          f"{len(cb.planned_intents)} planned intents, {b}, identical", flush=True)


GANG_COUNTERS = ("scheduled", "failures", "device_scheduled", "host_path_pods",
                 "device_batches", "placement_device_evals", "plan_rebuilds_full",
                 "plan_rebuilds_delta", "plan_rebuilds_resume")


def gang_parity(dev, paths: dict) -> None:
    """Pod groups: each cuda run's bindings, victims and counters equal the
    device="cpu" run's."""
    from kubernetes_tpu_torch import bench
    from kubernetes_tpu_torch.api.types import PodGroup
    from kubernetes_tpu_torch.core.registry import gang_placement_profile
    from kubernetes_tpu_torch.models import TorchScheduler
    from kubernetes_tpu_torch.testing import make_node, make_pod

    zone, host = "topology.kubernetes.io/zone", "kubernetes.io/hostname"

    def same_gangs(a, b, what):
        got, want = outcome(a), outcome(b)
        diffs = {k: (v, got.get(k)) for k, v in want.items() if got.get(k) != v}
        check(not diffs and set(got) == set(want),
              f"cuda/cpu divergence ({what}): {list(diffs.items())[:5]}")
        ca, cb = ({c: getattr(x, c) for c in GANG_COUNTERS} for x in (a, b))
        check(ca == cb and a.preemption_counts() == b.preemption_counts(),
              f"{what}: counters {ca} vs {cb}")
        print(f"parity ({what}): {len(want)} pods, {cb}, victims "
              f"{b.preemption_counts()['victims']}, identical", flush=True)

    def group(s, name, n, cpu, keys=(zone,), min_count=None, build=None, prio=0):
        s.clientset.create_pod_group(PodGroup(name=name, topology_keys=keys,
                                              min_count=n if min_count is None else min_count))
        for j in range(n):
            b = make_pod().name(f"{name}-{j}").req({"cpu": cpu, "memory": "1Gi"}).priority(prio)
            p = (build(b) if build is not None else b).obj()
            p.pod_group = name
            s.clientset.create_pod(p)

    def placement_cluster(device):
        """60 nodes over 3 zones (z2 five small nodes) under the placement
        plugins: groups that fit, one that fits z0 and z1 but not z2 (its
        min_count exceeds what z2 holds), one that fits nowhere, and groups
        whose members carry a hostname DoNotSchedule spread and a zone
        ScheduleAnyway spread (per-placement spread tables)."""
        s = TorchScheduler(device=device, profile_factory=gang_placement_profile)
        for i in range(60):
            z, cpu = (("z0", 8) if i < 30 else ("z1", 8)) if i < 55 else ("z2", 2)
            s.clientset.create_node(make_node().name(f"n{i}").capacity(
                {"cpu": cpu, "memory": "32Gi", "pods": 110}).zone(z).obj())
        for g in range(6):
            group(s, f"fit{g}", 4, "1")
        group(s, "wide", 6, "2")
        group(s, "nofit", 2, "64")
        for g in range(3):
            group(s, f"spread{g}", 4, "1", build=lambda b, g=g: b.labels({"gang": f"s{g}"})
                  .spread_constraint(1, host, "DoNotSchedule", {"gang": f"s{g}"})
                  .spread_constraint(1, zone, "ScheduleAnyway", {"gang": f"s{g}"}))
        s.run_until_idle()
        return s

    def preemption_cluster(device):
        """8 full nodes of 4 cpu over 2 zones (priority-1 pods), then two
        priority-100 groups of 2 four-cpu members, one constrained to a
        zone: each fits only after lower-priority pods go."""
        s = TorchScheduler(device=device, profile_factory=gang_placement_profile)
        for i in range(8):
            s.clientset.create_node(make_node().name(f"n{i}").capacity(
                {"cpu": 4, "memory": "32Gi", "pods": 110}).zone(f"z{i % 2}").obj())
        for i in range(8):
            p = make_pod().name(f"low-{i}").req({"cpu": "4"}).priority(1).obj()
            p.node_name = f"n{i}"
            s.clientset.create_pod(p)
        group(s, "train", 2, "4", keys=(), prio=100)
        group(s, "zoned", 2, "4", prio=100)
        s.run_until_idle()
        return s

    a, b = placement_cluster(dev), placement_cluster("cpu")
    same_gangs(a, b, "placement groups, 60 nodes over 3 zones")
    check(a.placement_device_evals > 0 and a.failures > 0
          and not any(p.node_name for p in a.clientset.pods.values() if p.pod_group == "nofit")
          and all(p.node_name and int(p.node_name[1:]) < 55
                  for p in a.clientset.pods.values() if p.pod_group == "wide"),
          "the 60-node placement case did not place, park and fail as built")
    a, b = preemption_cluster(dev), preemption_cluster("cpu")
    same_gangs(a, b, "pod-group preemption, 8 full nodes")
    check(a.preemption_counts()["victims"] == 4
          and all(p.node_name for p in a.clientset.pods.values() if p.priority == 100),
          "pod-group preemption did not evict 4 pods and bind both groups")
    same_gangs(paths[GANGS][0], gang_drive("cpu")[0], GANGS)
    same_gangs(placement_drive(dev, PLACE_PARITY_GROUPS)[0],
               placement_drive("cpu", PLACE_PARITY_GROUPS)[0],
               f"{PLACE}, {PLACE_PARITY_GROUPS} groups")


# ---------------------------------------------------------------------------
# Host ports, gates, declared features and images (phases 2, 3, 4 and 5)
# ---------------------------------------------------------------------------

FEATURES = "NodeDeclaredFeaturesEnabled/5000Nodes20DeclaredFeatures"
GATED = "SchedulingWhileGated/1Node_10000GatedPods"
HOSTPORTS = "HostPorts/5000Nodes_4000Pods"
PORT_SCAN = "host ports at 1000 nodes, max_batch 64"
PORT_SPREAD = "host ports with a zone spread at 1000 nodes, max_batch 64"
PORT_GANGS = f"{PLACE1K} cut to 50 groups, members holding hostPort 9000"


def blocked_phase(K, dev, np_cap: int, n_nodes: int, errs: dict) -> None:
    """The three schedule kernels with port_selfblock against their plain
    versions: a random third of the carry's rows blocked before the first
    batch, both fit strategies, fresh and chained, padded steps; draws
    whose batch outnumbers their feasible rows block every row and leave
    the last pods placed nowhere; schedule_placements' lanes each blocking
    only their own rows; and static_masks with a mixed extra_ok."""
    from kubernetes_tpu_torch.testing.kernel_inputs import (general_inputs, placement_inputs,
                                                            random_inputs)

    gen = torch.Generator().manual_seed(1100)

    def pre_blocked(ext0):
        return ext0._replace(blocked=(torch.rand(ext0.blocked.shape, generator=gen)
                                      < 0.3).to(dev))

    def fit(st, ft, strat):
        return K._resource_eval_plain(ft, strat, st.alloc_r, st.alloc_pods, st.req_r,
                                      st.nonzero, st.pod_count)

    summary = []
    # (case, kernel, draw, rows, live rows, steps, active pods)
    for case, kname, draw, cap, live, B, n_act in (
            ("lap", "lap_schedule", dict(), np_cap, n_nodes, 1024, 1000),
            ("lap, every row blocked", "lap_schedule", dict(), 128, 100, 256, 256),
            ("scan", "scan_general", dict(), np_cap, n_nodes, 64, 60),
            ("scan, every row blocked", "scan_general", dict(), 64, 40, 64, 64),
            ("scan_general, zone spread", "scan_general", dict(dns=1), np_cap, n_nodes, 64, 60),
            ("scan_general, soft spread", "scan_general", dict(sa=1, pns=True), np_cap, n_nodes,
             64, 64),
            ("scan_general, every row blocked", "scan_general", dict(sa=1), 64, 40, 64, 64)):
        s, f, facts = general_inputs(1100 + len(summary), cap, live, vmax=64, **draw)
        facts = K.PlanFacts(**dict(facts, port_selfblock=True))
        st, ft = to_device(dev, s, f)
        masks = K._static_masks_plain(st, ft)
        err = placed = 0
        for strat in (0, 1):
            ck = cp = pre_blocked(K.fresh_carry(st, ft, 64, fit(st, ft, strat)))
            for _chain in range(2):
                if kname == "scan_general":
                    o_k, ck = K.scan_general(st, ft, B, strat, ck, masks, n_act, facts)
                    o_p, cp = K._scan_general_plain(st, ft, B, strat, cp, masks, n_act, facts)
                else:
                    o_k, ck = K.lap_schedule(st, ft, B, strat, ck, masks.static_ok, n_act, True)
                    o_p, cp = K._lap_schedule_plain(st, ft, B, strat, cp, masks.static_ok, n_act,
                                                    True)
                err = max(err, max_abs_err((o_k,) + tuple(ck), (o_p,) + tuple(cp)))
                placed += int((o_p[0] >= 0).sum())
            if "every row" in case:
                left = masks.static_ok & cp.fit_ok & ~cp.blocked
                check(not bool(left[:live].any()) and int((o_p[0, :n_act] < 0).sum()) > 0,
                      f"blocked lane, {case}: a feasible row left unblocked, or no pod "
                      "placed nowhere")
        torch.cuda.synchronize()
        check(placed > 0, f"blocked lane, {case}: nothing placed")
        errs[kname] = max(errs[kname], err)
        summary.append(f"{case} {err}")
    # schedule_placements: lanes of one row, ~100 rows and every row.
    err = placed = 0
    # (lanes, spread tables, fit strategies, active members): the plain
    # version walks the lanes one by one, so the 64-lane draw runs once.
    for lanes, tables, strats, acts in ((16, {}, (0, 1), (0, 8)),
                                        (16, dict(dns=1, sa=1, overrides=True), (0, 1), (0, 8)),
                                        (64, dict(dns=1, sa=1, overrides=True), (1,), (8,))):
        s, f, facts, m, ov = placement_inputs(1120 + lanes + len(tables), np_cap, n_nodes,
                                              lanes, vmax=64, **tables)
        st, ft = to_device(dev, s, f)
        m = torch.from_numpy(m).to(dev)
        t_ov = None if ov is None else tuple(torch.from_numpy(a).to(dev) for a in ov)
        facts = K.PlanFacts(**dict(facts, port_selfblock=True))
        for strat in strats:
            for n_act in acts:
                args = (st, ft, 8, strat, 64, facts, m, n_act, t_ov)
                got, want = K.schedule_placements(*args), K._schedule_placements_plain(*args)
                err = max(err, max_abs_err((got,), (want,)))
                for lane in want[:, 0, :n_act]:
                    rows = lane[lane >= 0]
                    check(rows.numel() == rows.unique().numel(),
                          "schedule_placements put two port pods of a lane on one row")
                    placed += rows.numel()
    torch.cuda.synchronize()
    check(placed > 0, "blocked lane: the placement draws placed nothing")
    errs["schedule_placements"] = max(errs["schedule_placements"], err)
    summary.append(f"schedule_placements {err}")
    s, f = random_inputs(1130, np_cap, n_nodes)
    st, ft = to_device(dev, s, f)
    ft = ft._replace(extra_ok=(torch.rand(np_cap, generator=gen) < 0.6).to(dev))
    e = max_abs_err(K.static_masks(st, ft), K._static_masks_plain(st, ft))
    errs["static_masks"] = max(errs["static_masks"], e)
    summary.append(f"static_masks with a mixed extra_ok {e}")
    print("kernels with the blocked lane vs plain (max_abs_err): " + ", ".join(summary),
          flush=True)


def capture_first_dispatch(sched, capture: dict, path=None) -> None:
    """Record the device state (a copy), plan, active pods and carry of
    `sched`'s first dispatch (with `path`: its first with active pods
    whose plan takes that reference path, K.plan_path) into `capture`."""
    from kubernetes_tpu_torch.ops import kernel as K

    dispatch = sched._dispatch

    def first(state, plan, n_active, carry):
        if not capture and (path is None or (n_active and K.plan_path(
                plan.features, plan.facts, plan.batch_pad) == path)):
            capture.update(state=K.DeviceNodeState(*[t.clone() for t in state]), plan=plan,
                           n_act=n_active, carry=carry)
        return dispatch(state, plan, n_active, carry)
    sched._dispatch = first


def features_drive(dev):
    """NodeDeclaredFeaturesEnabled/5000Nodes20DeclaredFeatures: 5000 nodes
    of 32 cpu / 256Gi / 110 pods over 50 zones, each declaring
    feature-0..19, 5000 100m init pods, 50000 100m/128Mi measured pods:
    every pod bound on the device by the lap."""
    sched, result, launches = drive(dev, FEATURES)
    check(all(len(n.declared_features) == 20 for n in sched.clientset.nodes.values()),
          f"{FEATURES}: a node does not declare its 20 features")
    if torch.device(dev).type == "cuda":
        check_launched(FEATURES, launches, result["detail"], ("static_masks", "lap_schedule"))
    print(f"{FEATURES}: {result['value']:.1f} pods/s, floor {bench_threshold(FEATURES)} pods/s",
          flush=True)
    return sched, result, launches


def bench_threshold(workload: str):
    from kubernetes_tpu_torch import bench
    return bench.WORKLOADS[workload].threshold


def gated_drive(dev):
    """SchedulingWhileGated/1Node_10000GatedPods: one node of 1000 cpu /
    4Ti / 90000 pods, 10000 gated pods, 20000 pods in namespace `deleting`
    bound, then 20000 measured pods while the deleting pods are deleted at
    50/s: every measured pod bound on the device, the gated pods parked
    (none in the pool's non-gated index), deletes during the window."""
    sched, result, launches = run_path(dev, GATED)
    d = result["detail"]
    pods = list(sched.clientset.pods.values())
    measured = [p for p in pods if p.name.startswith("bench-")]
    gated = [p for p in pods if p.scheduling_gates]
    check(len(measured) == 20000 and all(p.node_name for p in measured),
          f"{GATED}: {sum(1 for p in measured if p.node_name)} of 20000 measured pods bound")
    check(len(gated) == 10000 and not any(p.node_name for p in gated)
          and sched.queue.pending_counts() == (0, 0, 10000)
          and not sched.queue.unschedulable.non_gated,
          f"{GATED}: the gated pods left the pool (counts {sched.queue.pending_counts()})")
    check(d["deleted_pods"] > 0 and d["failures"] == 0 and d["host_path_pods"] == 0,
          f"{GATED}: deleted {d['deleted_pods']}, failures {d['failures']}, host path "
          f"{d['host_path_pods']}")
    if torch.device(dev).type == "cuda":
        check_launched(GATED, launches, d, ("static_masks", "lap_schedule"))
    print(f"{GATED}: {result['value']:.1f} pods/s (floor {bench_threshold(GATED)}), "
          f"{d['deleted_pods']} pods deleted in the window, 10000 gated pods parked", flush=True)
    return sched, result, launches


def hostport_drive(dev, capture=None):
    """HostPorts/5000Nodes_4000Pods: TopologySpreading's 5000 nodes, those of
    10 of the 50 zones reporting a 600 MiB image, 1000 init pods bound to
    nodes 0-999 holding TCP hostPort 8080, then 4000 100m/128Mi pods with
    that port and image at max_batch 1024: every pod bound, no two holding
    the port on one node, the lap launched with the blocked lane, and one
    more such pod unschedulable with a NodePorts diagnosis. `capture`
    receives the first dispatch's inputs."""
    from kubernetes_tpu_torch import bench
    from kubernetes_tpu_torch.ops import kernel as K

    w = bench.WORKLOADS[HOSTPORTS]
    sched = bench.build_cluster(5000, device=dev, node=w.node)
    bench.warm(sched, w.init_pods, HOSTPORTS)
    if capture is not None:
        capture_first_dispatch(sched, capture)
    flushes0 = sched.mirror.scatter_flushes
    K.reset_launch_counts()
    result = bench.measure(sched, w.measure_pods, workload=HOSTPORTS)
    launches = {k.__name__: k.launches for k in K.WRAPPERS}
    launches["scatter_flushes"] = sched.mirror.scatter_flushes - flushes0
    print(f"path {HOSTPORTS}: {json.dumps(result)}", flush=True)
    d = result["detail"]
    pods = list(sched.clientset.pods.values())
    nodes = [p.node_name for p in pods]
    check(len(pods) == 5000 and all(nodes) and len(set(nodes)) == 5000,
          f"{HOSTPORTS}: {sum(1 for n in nodes if n)} of 5000 pods bound on "
          f"{len(set(n for n in nodes if n))} nodes")
    check(d["failures"] == 0 and d["host_path_pods"] == 0,
          f"{HOSTPORTS}: failures {d['failures']}, host path {d['host_path_pods']}")
    if capture is not None:
        plan = capture["plan"]
        check(plan.facts.port_selfblock and bool(plan.features.il_score.any())
              and not bool(plan.features.extra_ok[:1000].any()),
              f"{HOSTPORTS}: the plan has no blocked lane, no image score or no port conflicts")
    extra = bench.make_pods(1, "extra", HOSTPORTS)[0]
    sched.clientset.create_pod(extra)
    sched.run_until_idle()
    qpi = sched.queue.unschedulable.get(extra.uid)
    check(not extra.node_name and qpi is not None and qpi.unschedulable_plugins == {"NodePorts"},
          f"{HOSTPORTS}: one more agent pod was not unschedulable by NodePorts")
    if torch.device(dev).type == "cuda":
        check_launched(HOSTPORTS, launches, d, ("static_masks", "resource_eval", "lap_schedule"))
    print(f"{HOSTPORTS}: {result['value']:.1f} pods/s, 5000 port holders on 5000 nodes, the "
          "next agent pod unschedulable (NodePorts)", flush=True)
    return sched, result, launches


def port_cut(dev, spread: bool = False, n_nodes: int = 1000, n_init: int = 200,
             n_pods: int = 600, capture=None):
    """The host-port drive cut to `n_nodes` nodes, `n_init` bound port
    holders and `n_pods` agent pods at max_batch 64 (the scan path), or
    with a zone spread on the agent pods, both on scan_general. Launch counts
    zeroed before the agent pods."""
    from kubernetes_tpu_torch import bench
    from kubernetes_tpu_torch.ops import kernel as K

    w = bench.WORKLOADS[HOSTPORTS]
    sched = bench.build_cluster(n_nodes, device=dev, max_batch=64, node=w.node)
    bench.warm(sched, n_init, HOSTPORTS)
    build = bench._agent
    if spread:
        def build(b):
            return bench._agent(b).labels({"app": "agent"}).spread_constraint(
                1, bench.ZONE, "DoNotSchedule", {"app": "agent"})
    if capture is not None:
        capture_first_dispatch(sched, capture)
    K.reset_launch_counts()
    for p in bench._clones(build, n_pods, "agent"):
        sched.clientset.create_pod(p)
    sched.run_until_idle()
    launches = {k.__name__: k.launches for k in K.WRAPPERS}
    nodes = [p.node_name for p in sched.clientset.pods.values() if p.node_name]
    check(len(nodes) == len(set(nodes)) == n_init + n_pods,
          f"host-port cut ({dev}, spread {spread}): {len(nodes)} bound on {len(set(nodes))} nodes")
    kernel = "scan_general"
    check(torch.device(dev).type == "cpu" or launches[kernel] > 0,
          f"host-port cut: {kernel} was not launched")
    return sched, None, launches


def port_gangs(dev, n_groups: int = 50, capture=None):
    """SchedulingGangsPlacement/1000Nodes_250Groups' 1000 nodes over 10
    zones under the placement plugins, cut to n_groups groups of 4 500m
    members holding hostPort 9000: every group in one zone, no two members
    on one node, one schedule_placements launch a group cycle with the
    blocked lane. `capture` receives the first launch's arguments."""
    from kubernetes_tpu_torch import bench
    from kubernetes_tpu_torch.api.types import PodGroup
    from kubernetes_tpu_torch.models import tpu_scheduler as TS
    from kubernetes_tpu_torch.ops import kernel as K

    w = bench.WORKLOADS[PLACE1K]
    sched = bench.build_cluster(1000, device=dev, node=w.node,
                                profile_factory=bench.profile_for(PLACE1K))
    member = lambda b: bench._gang_member(b).host_port(9000)  # noqa: E731
    sched.warm_for_placements(bench._clones(member, 1, "shape")[0], 4, 10)
    launch = TS.schedule_placements

    def recorded(*args):
        if capture is not None and not capture:
            capture["args"] = args
            capture["placements"] = int(args[6].any(dim=1).sum())
        return launch(*args)
    TS.schedule_placements = recorded
    K.reset_launch_counts()
    try:
        for g in range(n_groups):
            sched.clientset.create_pod_group(PodGroup(name=f"g{g}", min_count=4,
                                                      topology_keys=(bench.ZONE,)))
            for p in bench._clones(member, 4, f"g{g}"):
                p.pod_group = f"g{g}"
                sched.clientset.create_pod(p)
        sched.run_until_idle()
    finally:
        TS.schedule_placements = launch
    launches = {k.__name__: k.launches for k in K.WRAPPERS}
    pods = list(sched.clientset.pods.values())
    nodes = [p.node_name for p in pods]
    zones = {}
    for p in pods:
        zones.setdefault(p.pod_group, set()).add(
            sched.clientset.nodes[p.node_name].labels[bench.ZONE] if p.node_name else None)
    check(all(nodes) and len(set(nodes)) == len(pods) == 4 * n_groups
          and all(len(z) == 1 for z in zones.values()),
          f"{PORT_GANGS} ({dev}): not every member bound, in one zone, on a node of its own")
    check(sched.placement_device_evals == n_groups
          and (torch.device(dev).type == "cpu" or launches["schedule_placements"] == n_groups),
          f"{PORT_GANGS}: {sched.placement_device_evals} device evaluations, "
          f"{launches['schedule_placements']} launches for {n_groups} groups")
    return sched, None, launches


def gated_short(dev):
    """SchedulingWhileGated/1Node_10GatedPods, the upstream short shape: 10
    gated pods, 10 pods in `deleting` bound and then deleted while 10
    measured pods arrive."""
    from kubernetes_tpu_torch.models import TorchScheduler
    from kubernetes_tpu_torch.testing import make_node, make_pod

    s = TorchScheduler(device=dev)
    s.clientset.create_node(make_node().name("scheduler-perf-node").capacity(
        {"cpu": 1000, "memory": "4Ti", "pods": 90000}).obj())
    for i in range(10):
        s.clientset.create_pod(make_pod().name(f"gated-{i}").req({"cpu": "0", "memory": "0"})
                               .scheduling_gate("test.k8s.io/hold").obj())
    deleting = [make_pod().name(f"deleting-{i}").namespace("deleting")
                .req({"cpu": "0", "memory": "0"}).obj() for i in range(10)]
    for p in deleting:
        s.clientset.create_pod(p)
    s.run_until_idle()
    for i in range(10):
        s.clientset.create_pod(make_pod().name(f"measured-{i}")
                               .req({"cpu": "0", "memory": "0"}).obj())
        s.clientset.delete_pod(deleting[i])
    s.run_until_idle()
    check(s.queue.pending_counts() == (0, 0, 10), f"gated short shape ({dev}): counts "
                                                  f"{s.queue.pending_counts()}")
    return s


def features_cut(dev):
    """1000 of the 32-cpu nodes, only the odd ones declaring gpu-x; 1200
    pods requiring it and 20 requiring gpu-x and a feature no node
    declares: every gpu-x pod on an odd node, the others unschedulable."""
    from kubernetes_tpu_torch import bench
    from kubernetes_tpu_torch.models import TorchScheduler
    from kubernetes_tpu_torch.testing import make_pod

    s = TorchScheduler(device=dev)
    for i in range(1000):
        n = bench.cluster_node(i)
        n.declared_features = {"gpu-x": bool(i % 2)}
        s.clientset.create_node(n)
    for prefix, n, feats in (("gpu", 1200, "gpu-x"), ("none", 20, "gpu-x,missing")):
        for i in range(n):
            p = bench._basic(make_pod().name(f"{prefix}-{i}")).obj()
            p.annotations["features.k8s.io/required"] = feats
            s.clientset.create_pod(p)
        s.run_until_idle()
    on = [p.node_name for p in s.clientset.pods.values() if p.node_name]
    check(len(on) == 1200 and all(int(n.split("-")[1]) % 2 for n in on),
          f"declared-features cut ({dev}): {len(on)} bound, some on an even node")
    return s


def slice7_parity(dev, paths: dict) -> None:
    """The slice's parity cuts: each cuda run's bindings, failure and queue
    counts equal the device="cpu" run's."""
    def same(a, b, what):
        got, want = assignments(a), assignments(b)
        diffs = {k: (v, got.get(k)) for k, v in want.items() if got.get(k) != v}
        check(not diffs and set(got) == set(want),
              f"cuda/cpu divergence ({what}): {list(diffs.items())[:5]}")
        check((a.scheduled, a.failures, a.queue.pending_counts())
              == (b.scheduled, b.failures, b.queue.pending_counts()), f"counts differ ({what})")
        print(f"parity ({what}): {len(want)} pods, {b.scheduled} bound, {b.failures} failed "
              f"attempts, pending {b.queue.pending_counts()}, identical", flush=True)

    same(paths[PORT_SCAN][0], port_cut("cpu")[0], PORT_SCAN)
    same(paths[PORT_SPREAD][0], port_cut("cpu", spread=True)[0], PORT_SPREAD)
    same(paths[PORT_GANGS][0], port_gangs("cpu")[0], PORT_GANGS)
    same(gated_short(dev), gated_short("cpu"), "SchedulingWhileGated/1Node_10GatedPods")
    same(features_cut(dev), features_cut("cpu"), "declared features, odd nodes, 1000 nodes")


def lane_timing(rows: dict, caps: dict, errs: dict, lane: str, drives) -> None:
    """The lap and scan_general (on the scan path's row-local plan and on a
    general plan) with a row-local lane ("blocked": a host-port plan,
    "aux": an attach-limited one) on their own drives' first captured
    dispatch, held exact first: the `lane` entry of the lap's row and the
    `lane` and `<lane>_row_local` entries of scan_general's, with their
    bound (the lane's bytes a row added)."""
    from kubernetes_tpu_torch.ops import kernel as K

    ports, aux = lane == "blocked", lane == "aux"
    lane_bytes = 2 if ports else 12  # the blocked flag read and written; aux_cnt, aux_room
    for path, what in zip(("lap", "scan", "general"), drives):
        kname = "lap_schedule" if path == "lap" else "scan_general"
        cap = caps[path]
        check(cap, f"{what}: no dispatch captured")
        st, plan, n_act = cap["state"], cap["plan"], cap["n_act"]
        ft, strat, B, facts = plan.features, plan.fit_strategy, plan.batch_pad, plan.facts
        check((facts.port_selfblock if ports else facts.has_aux)
              and K.plan_path(ft, facts, B) == path,
              f"{what}: the captured plan does not take the {path} path with the {lane} lane")
        masks = K._static_masks_plain(st, ft)
        ext0 = cap["carry"] or K.fresh_carry(st, ft, plan.vmax, K._resource_eval_plain(
            ft, strat, st.alloc_r, st.alloc_pods, st.req_r, st.nonzero, st.pod_count))
        NP, R = st.alloc_r.shape
        FR = ft.fit_slots.shape[0]
        row_ops = 4 * R + 12 * FR + 24
        extra = {}
        if kname == "scan_general":
            k_fn = lambda: K.scan_general(st, ft, B, strat, ext0, masks, n_act, facts)  # noqa
            p_fn = lambda: K._scan_general_plain(st, ft, B, strat, ext0, masks, n_act, facts)  # noqa
            nbytes, ops = general_cost(ft, facts, K, n_act)
            nbytes += lane_bytes * NP
        else:
            args = (st, ft, B, strat, ext0, masks.static_ok, n_act, ports, aux)
            k_fn = lambda: K.lap_schedule(*args)  # noqa
            p_fn = lambda: K._lap_schedule_plain(*args)  # noqa
            stats = {}
            K._lap_schedule_plain(*args, stats=stats)
            laps = stats["laps"]
            nbytes = NP * (16 * R + 37) + NP * (8 * R + 37) + 8 * B + lane_bytes * NP
            ops = laps * (NP * (24 + 2 * aux) + K.LAP_MAX * row_ops) + NP * row_ops
            extra = dict(laps=laps)
        (o_k, c_k), (o_p, c_p) = k_fn(), p_fn()
        check(max_abs_err((o_k,) + tuple(c_k), (o_p,) + tuple(c_p)) == 0,
              f"{kname} with the {lane} lane disagrees with its plain version on the {what}")
        case = kernel_row(kname, "", errs[kname], k_fn, p_fn, nbytes, ops,
                          reps=5 if kname == "scan_general" else 20,
                          plain_reps=1 if kname == "scan_general" else 2)
        case = {k: case[k] for k in ("ms", "ms_launches_seen", "host_ms", "plain_ms",
                                     "bound_ms", "bound_by", "bytes", "ops")}
        if extra:
            extra["us_a_lap"] = case["ms"] * 1e3 / extra["laps"]
        case.update(drive=what, pods=n_act, steps=B, placed=int((o_p[0] >= 0).sum()), **extra)
        rows[kname][f"{lane}_row_local" if path == "scan" else lane] = case
        print(f"{kname} ({path} path) with the {lane} lane on the {what}'s first batch "
              f"({n_act} pods"
              + (f", {extra['laps']} laps, {extra['us_a_lap']:.2f} us a lap" if extra else "")
              + f", NP {NP}): {case['ms']:.4f} ms "
              f"on the device, {case['host_ms']:.4f} ms a call, plain {case['plain_ms']:.3f} ms, "
              f"bound {case['bound_ms']:.6f} ms ({case['bound_by']})", flush=True)


def blocked_timing(rows: dict, caps: dict, errs: dict) -> None:
    """Each schedule kernel with the blocked lane on its own drive's first
    dispatch (the host-port drive for the lap, its cuts for scan_general, the
    port gangs' first group cycle for the placements), held exact first:
    the `blocked` entry of the kernel's row, with its bound."""
    from kubernetes_tpu_torch.ops import kernel as K

    lane_timing(rows, caps, errs, "blocked", (HOSTPORTS, PORT_SCAN, PORT_SPREAD))
    cap = caps["placements"]
    check(cap, f"{PORT_GANGS}: no placement evaluation captured")
    args = cap["args"]
    state, facts, masks, n_act = args[0], args[5], args[6], args[7]
    check(facts.port_selfblock, f"{PORT_GANGS}: the placement plan has no blocked lane")
    check(max_abs_err((K.schedule_placements(*args),), (K._schedule_placements_plain(*args),))
          == 0, f"schedule_placements with the blocked lane disagrees on the {PORT_GANGS}")
    NP = state.alloc_r.shape[0]
    nbytes, ops = placement_cost(K, args)
    case = kernel_row("schedule_placements", "", errs["schedule_placements"],
                      lambda: K.schedule_placements(*args),
                      lambda: K._schedule_placements_plain(*args), nbytes, ops, plain_reps=1)
    case = {k: case[k] for k in ("ms", "ms_launches_seen", "host_ms", "plain_ms", "bound_ms",
                                 "bound_by", "bytes", "ops")}
    case.update(drive=PORT_GANGS, lanes=int(masks.shape[0]), placements=cap["placements"],
                members=n_act)
    rows["schedule_placements"]["blocked"] = case
    print(f"schedule_placements with the blocked lane on the {PORT_GANGS}' first group "
          f"({case['lanes']} lanes, {case['placements']} placements, NP {NP}): {case['ms']:.4f} "
          f"ms on the device, {case['host_ms']:.4f} ms a call, plain {case['plain_ms']:.3f} ms, "
          f"bound {case['bound_ms']:.6f} ms ({case['bound_by']})", flush=True)


# ---------------------------------------------------------------------------
# Volumes: the aux_cnt lane of the three schedule kernels (phases 2, 3, 4, 5)
# ---------------------------------------------------------------------------

CSIPVS = "SchedulingCSIPVs/5000Nodes_5000Pods"
INTREE = "SchedulingInTreePVs/5000Nodes_2000Pods"
ATTACH = "CSIAttachLimit/5000Nodes_9000Pods"
AUX_LAP = "attach limit 2 at 1000 nodes, 1950 pods"
AUX_SCAN = "attach limit 2 at 1000 nodes, 1950 pods, max_batch 64"
AUX_SPREAD = "attach limit 2 at 1000 nodes, 1950 pods, max_batch 64, zone spread"
WFFC = "WaitForFirstConsumer claims at 500 nodes, 200 pods"


def aux_phase(K, dev, np_cap: int, n_nodes: int, errs: dict) -> None:
    """The three schedule kernels with has_aux against their plain versions:
    an attach room of 0 to 3 a row (some rows unlimited), an increment of 1
    or 2, the carry's aux_cnt drawn (strategy 0) or zero (strategy 1),
    fresh and chained, padded steps; draws whose batch outnumbers their
    room fill every row and leave the last pods placed nowhere;
    schedule_placements' lanes each counting only their own members."""
    from kubernetes_tpu_torch.testing.kernel_inputs import (aux_lane, general_inputs,
                                                            placement_inputs, with_aux_lane)

    def fit(st, ft, strat):
        return K._resource_eval_plain(ft, strat, st.alloc_r, st.alloc_pods, st.req_r,
                                      st.nonzero, st.pod_count)

    summary = []
    # (case, kernel, draw, rows, live rows, steps, active pods)
    for case, kname, draw, cap, live, B, n_act in (
            ("lap", "lap_schedule", dict(), np_cap, n_nodes, 1024, 1000),
            ("lap, more pods than room", "lap_schedule", dict(), 128, 100, 512, 512),
            ("scan", "scan_general", dict(), np_cap, n_nodes, 64, 60),
            ("scan, more pods than room", "scan_general", dict(), 64, 40, 64, 64),
            ("scan_general, zone spread", "scan_general", dict(dns=1), np_cap, n_nodes, 64, 60),
            ("scan_general, soft spread", "scan_general", dict(sa=1, pns=True), np_cap, n_nodes,
             64, 64),
            ("scan_general, more pods than room", "scan_general", dict(sa=1), 64, 40, 64, 64)):
        seed = 1200 + len(summary)
        s, f, facts = general_inputs(seed, cap, live, vmax=64, **draw)
        room, inc, cnt = aux_lane(seed, cap, live, unlimited=0.0 if "room" in case else 0.1)
        facts = K.PlanFacts(**dict(facts, has_aux=True))
        st, ft = to_device(dev, s, with_aux_lane(f, room, inc))
        masks = K._static_masks_plain(st, ft)
        err = placed = 0
        for strat in (0, 1):
            ext0 = K.fresh_carry(st, ft, 64, fit(st, ft, strat))
            if strat == 0:
                ext0 = ext0._replace(aux_cnt=torch.from_numpy(cnt).to(dev))
            ck = cp = ext0
            for _chain in range(2):
                if kname == "scan_general":
                    o_k, ck = K.scan_general(st, ft, B, strat, ck, masks, n_act, facts)
                    o_p, cp = K._scan_general_plain(st, ft, B, strat, cp, masks, n_act, facts)
                else:
                    o_k, ck = K.lap_schedule(st, ft, B, strat, ck, masks.static_ok, n_act,
                                             False, True)
                    o_p, cp = K._lap_schedule_plain(st, ft, B, strat, cp, masks.static_ok, n_act,
                                                    False, True)
                err = max(err, max_abs_err((o_k,) + tuple(ck), (o_p,) + tuple(cp)))
                placed += int((o_p[0] >= 0).sum())
            if "room" in case:
                left = masks.static_ok & cp.fit_ok & (cp.aux_cnt + ft.aux_inc <= ft.aux_room)
                check(not bool(left[:live].any()) and int((o_p[0, :n_act] < 0).sum()) > 0,
                      f"aux lane, {case}: a row with room left, or no pod placed nowhere")
        torch.cuda.synchronize()
        check(placed > 0, f"aux lane, {case}: nothing placed")
        errs[kname] = max(errs[kname], err)
        summary.append(f"{case} {err}")
    err = placed = 0
    for lanes, tables, strats, acts in ((16, {}, (0, 1), (0, 8)),
                                        (16, dict(dns=1, sa=1, overrides=True), (0, 1), (0, 8)),
                                        (64, dict(dns=1, sa=1, overrides=True), (1,), (8,))):
        seed = 1220 + lanes + len(tables)
        s, f, facts, m, ov = placement_inputs(seed, np_cap, n_nodes, lanes, vmax=64, **tables)
        room, inc, _cnt = aux_lane(seed, np_cap, n_nodes)
        st, ft = to_device(dev, s, with_aux_lane(f, room, inc))
        m = torch.from_numpy(m).to(dev)
        t_ov = None if ov is None else tuple(torch.from_numpy(a).to(dev) for a in ov)
        facts = K.PlanFacts(**dict(facts, has_aux=True))
        for strat in strats:
            for n_act in acts:
                args = (st, ft, 8, strat, 64, facts, m, n_act, t_ov)
                got, want = K.schedule_placements(*args), K._schedule_placements_plain(*args)
                err = max(err, max_abs_err((got,), (want,)))
                for lane in want[:, 0, :n_act]:
                    rows = lane[lane >= 0]
                    if rows.numel():
                        taken = torch.bincount(rows.long(), minlength=np_cap) * int(inc)
                        check(bool((taken[rows.long()] <= ft.aux_room[rows.long()]).all()),
                              "schedule_placements overfilled a row's attach room in a lane")
                    placed += rows.numel()
    torch.cuda.synchronize()
    check(placed > 0, "aux lane: the placement draws placed nothing")
    errs["schedule_placements"] = max(errs["schedule_placements"], err)
    summary.append(f"schedule_placements {err}")
    print("kernels with the aux_cnt lane vs plain (max_abs_err): " + ", ".join(summary),
          flush=True)


def watch_dispatches(sched, capture=None) -> dict:
    """Count `sched`'s dispatches with active pods and those whose plan has
    the aux lane; `capture` receives the device state (a copy), plan, active
    pods and carry of the first such dispatch of more than one pod."""
    from kubernetes_tpu_torch.ops import kernel as K

    dispatch = sched._dispatch
    stats = {"dispatches": 0, "aux_dispatches": 0}

    def counted(state, plan, n_active, carry):
        if n_active:
            stats["dispatches"] += 1
            stats["aux_dispatches"] += plan.facts.has_aux
            if capture is not None and not capture and n_active > 1 and plan.facts.has_aux:
                capture.update(state=K.DeviceNodeState(*[t.clone() for t in state]), plan=plan,
                               n_act=n_active, carry=carry)
        return dispatch(state, plan, n_active, carry)
    sched._dispatch = counted
    return stats


def volumes_per_node(sched) -> dict:
    out = {}
    for p in sched.clientset.pods.values():
        if p.node_name and p.volumes:
            out[p.node_name] = out.get(p.node_name, 0) + len(p.volumes)
    return out


def volume_drive(dev, workload: str, capture=None):
    """A volume shape at full width (bench.WORKLOADS[workload]: 5000 nodes of
    32 cpu / 256Gi / 110 pods with no zone label, every pod 100m/128Mi with
    its own pre-bound 1Gi ReadOnlyMany PV and claim; the CSI shapes' nodes
    with a CSINode limit): the init pods, then one measured pod before the
    window and the measured pods in it, launch counts zeroed before. Every
    pod bound on the device, none on the host path; on the CSI shapes the
    lap runs with the aux lane and no node holds more claims than its
    limit, on the in-tree shape no plan has the lane."""
    from kubernetes_tpu_torch import bench
    from kubernetes_tpu_torch.ops import kernel as K

    w = bench.WORKLOADS[workload]
    sched = bench.build_cluster(5000, device=dev, node=w.node)
    bench.warm(sched, w.init_pods, workload)
    stats = watch_dispatches(sched, capture)
    K.reset_launch_counts()
    result = bench.measure(sched, w.measure_pods, workload=workload)
    launches = {k.__name__: k.launches for k in K.WRAPPERS}
    d = result["detail"]
    d.update(stats)
    print(f"path {workload}: {json.dumps(result)}", flush=True)
    total = w.init_pods + 1 + w.measure_pods
    bound = sum(1 for p in sched.clientset.pods.values() if p.node_name)
    check(bound == len(sched.clientset.pods) == total, f"{workload}: {bound} of {total} bound")
    check(d["failures"] == 0 and d["host_path_pods"] == 0 and d["device_batches"] > 0,
          f"{workload}: failures {d['failures']}, host path {d['host_path_pods']}, "
          f"{d['device_batches']} device batches")
    per_node = volumes_per_node(sched)
    if w.node.csi is not None:
        check(stats["aux_dispatches"] == stats["dispatches"] > 0,
              f"{workload}: {stats['aux_dispatches']} of {stats['dispatches']} dispatches with "
              "the aux lane")
        check(max(per_node.values()) <= w.node.csi[1],
              f"{workload}: a node holds {max(per_node.values())} claims, limit {w.node.csi[1]}")
    else:
        check(stats["aux_dispatches"] == 0, f"{workload}: a plan with the aux lane")
    if torch.device(dev).type == "cuda":
        check_launched(workload, launches, d, ("static_masks", "resource_eval", "lap_schedule"))
    print(f"{workload}: {result['value']:.1f} pods/s (floor {w.threshold}), {bound} pods bound, "
          f"{stats['aux_dispatches']} of {stats['dispatches']} dispatches with the aux lane, at "
          f"most {max(per_node.values())} claims a node", flush=True)
    return sched, result, launches


def aux_cut(dev, max_batch=None, spread: bool = False, n_nodes: int = 1000, n_init: int = 100,
            n_pods: int = 1950, capture=None):
    """SchedulingCSIPVs' pods on `n_nodes` nodes whose CSINodes allow 2
    ebs.csi.aws.com attachments (over 10 zones with a zone spread on the
    measured pods): `n_init` init pods, then `n_pods`, more than the slots
    left, at `max_batch`: every node ends with its 2 claims, the rest fail
    NodeVolumeLimits (with the spread, PodTopologySpread beside it). Launch
    counts zeroed before the measured pods."""
    from kubernetes_tpu_torch import bench
    from kubernetes_tpu_torch.ops import kernel as K

    node = bench.NodeTemplate(zones=10 if spread else 0, csi=(bench.EBS, 2))
    sched = bench.build_cluster(n_nodes, device=dev, max_batch=max_batch, node=node)
    build = bench._basic
    if spread:
        def build(b):
            return bench._basic(b).labels({"app": "v"}).spread_constraint(
                1, bench.ZONE, "DoNotSchedule", {"app": "v"})
    pods = bench._clones(bench._basic, n_init, "init") + bench._clones(build, n_pods, "v")
    for p in pods:
        p.volumes = [bench.Volume(name="data", pvc_name=f"pvc-{p.name}")]
    for p in pods[:n_init]:
        bench.create_volume(sched, p, bench.Volumes(csi=bench.EBS))
        sched.clientset.create_pod(p)
    sched.run_until_idle()
    stats = watch_dispatches(sched, capture)
    K.reset_launch_counts()
    for p in pods[n_init:]:
        bench.create_volume(sched, p, bench.Volumes(csi=bench.EBS))
        sched.clientset.create_pod(p)
    sched.run_until_idle()
    launches = {k.__name__: k.launches for k in K.WRAPPERS}
    per_node = volumes_per_node(sched)
    bound = sum(per_node.values())
    pending = sched.queue.unschedulable
    check(max(per_node.values()) <= 2 and (spread or bound == 2 * n_nodes),
          f"attach-limit cut ({dev}, max_batch {max_batch}, spread {spread}): {bound} bound, at "
          f"most {max(per_node.values())} a node")
    check(len(pending) == n_init + n_pods - bound
          and all("NodeVolumeLimits" in q.unschedulable_plugins for q in pending.values()),
          f"attach-limit cut ({dev}): {len(pending)} unschedulable, not all for NodeVolumeLimits")
    check(stats["aux_dispatches"] == stats["dispatches"] > 0,
          f"attach-limit cut ({dev}): {stats['aux_dispatches']} of {stats['dispatches']} "
          "dispatches with the aux lane")
    kernel = "scan_general" if max_batch else "lap_schedule"
    check(torch.device(dev).type == "cpu" or launches[kernel] > 0,
          f"attach-limit cut: {kernel} was not launched")
    return sched, None, launches


def wffc_cut(dev, n_nodes: int = 500, n_pods: int = 200):
    """The host-path cut: `n_pods` pods each with an unbound
    WaitForFirstConsumer claim, half of them matched by an available PV
    pinned to a node, half provisioned by an attached PV controller: every
    pod bound on the host path, every claim bound."""
    from kubernetes_tpu_torch import bench
    from kubernetes_tpu_torch.api.labels import IN, Requirement
    from kubernetes_tpu_torch.api.storage import (WAIT_FOR_FIRST_CONSUMER, PersistentVolume,
                                                  PersistentVolumeClaim, StorageClass)
    from kubernetes_tpu_torch.api.types import NodeSelector, NodeSelectorTerm
    from kubernetes_tpu_torch.core.pv_controller import PVController

    sched = bench.build_cluster(n_nodes, device=dev, node=bench.NO_ZONES)
    cs = sched.clientset
    ctrl = PVController(cs)
    cs.create_storage_class(StorageClass(name="local",
                                         volume_binding_mode=WAIT_FOR_FIRST_CONSUMER))
    cs.create_storage_class(StorageClass(name="dyn", provisioner=bench.EBS,
                                         volume_binding_mode=WAIT_FOR_FIRST_CONSUMER))
    for i in range(n_pods):
        sc = "local" if i % 2 == 0 else "dyn"
        if sc == "local":
            node = f"node-{(7 * i) % n_nodes}"
            cs.create_pv(PersistentVolume.of(
                f"local-{i}", "2Gi", storage_class="local",
                node_affinity=NodeSelector(terms=(NodeSelectorTerm(
                    match_fields=(Requirement("metadata.name", IN, (node,)),)),))))
        cs.create_pvc(PersistentVolumeClaim.of(f"w{i}", "1Gi", storage_class=sc))
        p = bench._basic(bench.make_pod().name(f"wp-{i}")).obj()
        p.volumes = [bench.Volume(name="data", pvc_name=f"w{i}")]
        cs.create_pod(p)
    sched.run_until_idle()
    check(all(p.node_name for p in cs.pods.values()) and ctrl.provisions == n_pods // 2
          and all(c.volume_name for c in cs.pvcs.values()) and sched.host_path_pods == n_pods,
          f"{WFFC} ({dev}): {sum(1 for p in cs.pods.values() if p.node_name)} bound, "
          f"{ctrl.provisions} provisioned, {sched.host_path_pods} on the host path")
    return sched


def volume_parity(dev, paths: dict) -> None:
    """The volume parity cells: each cuda run's bindings, failure and queue
    counts equal the device="cpu" run's."""
    def same(a, b, what):
        got, want = assignments(a), assignments(b)
        diffs = {k: (v, got.get(k)) for k, v in want.items() if got.get(k) != v}
        check(not diffs and set(got) == set(want),
              f"cuda/cpu divergence ({what}): {list(diffs.items())[:5]}")
        check((a.scheduled, a.failures, a.device_scheduled, a.host_path_pods,
               a.queue.pending_counts())
              == (b.scheduled, b.failures, b.device_scheduled, b.host_path_pods,
                  b.queue.pending_counts()), f"counts differ ({what})")
        print(f"parity ({what}): {len(want)} pods, {b.scheduled} bound, {b.failures} failed "
              f"attempts, pending {b.queue.pending_counts()}, identical", flush=True)

    same(paths[AUX_LAP][0], aux_cut("cpu")[0], AUX_LAP)
    same(paths[AUX_SCAN][0], aux_cut("cpu", max_batch=64)[0], AUX_SCAN)
    same(paths[AUX_SPREAD][0], aux_cut("cpu", max_batch=64, spread=True)[0], AUX_SPREAD)
    same(wffc_cut(dev), wffc_cut("cpu"), WFFC)


def aux_timing(rows: dict, caps: dict, errs: dict) -> None:
    """Each schedule kernel with the aux lane: the lap on SchedulingCSIPVs'
    first full measured batch, scan_general on the attach-limit cuts'
    first batch (the scan path and a zone spread), schedule_placements (which no path
    launches with the lane: volume members of a placement group take the
    host simulation) on a seeded draw at NP 8192 and 16 lanes; each held
    exact first: the `aux` entry of the kernel's row."""
    from kubernetes_tpu_torch.ops import kernel as K
    from kubernetes_tpu_torch.testing.kernel_inputs import aux_lane, placement_inputs, with_aux_lane

    lane_timing(rows, caps, errs, "aux", (CSIPVS, AUX_SCAN, AUX_SPREAD))
    np_cap = caps["lap"]["state"].alloc_r.shape[0]
    live = int(caps["lap"]["state"].valid.sum())
    s, f, facts, m, _ov = placement_inputs(1240, np_cap, live, 16, vmax=64)
    room, inc, _cnt = aux_lane(1240, np_cap, live)
    dev = caps["lap"]["state"].alloc_r.device
    st, ft = to_device(dev, s, with_aux_lane(f, room, inc))
    args = (st, ft, 8, 0, 64, K.PlanFacts(**dict(facts, has_aux=True)),
            torch.from_numpy(m).to(dev), 8, None)
    check(max_abs_err((K.schedule_placements(*args),), (K._schedule_placements_plain(*args),))
          == 0, "schedule_placements with the aux lane disagrees on the seeded draw")
    nbytes, ops = placement_cost(K, args)
    case = kernel_row("schedule_placements", "", errs["schedule_placements"],
                      lambda: K.schedule_placements(*args),
                      lambda: K._schedule_placements_plain(*args), nbytes, ops, plain_reps=1)
    case = {k: case[k] for k in ("ms", "ms_launches_seen", "host_ms", "plain_ms", "bound_ms",
                                 "bound_by", "bytes", "ops")}
    case.update(drive="seeded draw (no path launches it with the lane)",
                lanes=16, placements=int(m.any(axis=1).sum()), members=8)
    rows["schedule_placements"]["aux"] = case
    print(f"schedule_placements with the aux lane on a seeded draw (16 lanes, NP {np_cap}, 8 "
          f"members): {case['ms']:.4f} ms on the device, {case['host_ms']:.4f} ms a call, plain "
          f"{case['plain_ms']:.3f} ms, bound {case['bound_ms']:.6f} ms ({case['bound_by']})",
          flush=True)


# ---------------------------------------------------------------------------
# The node-sharded mesh: S shards on one card
# ---------------------------------------------------------------------------

BASIC = "SchedulingBasic/5000Nodes_10000Pods"
MESH_SHARDS = (2, 4, 8)     # shards of the kernel cases, all on one card
MESH_PATH_SHARDS = 4        # shards of the mesh drives
SHARDED_ABOVE_TIER = (40000, 39990)   # rows and live rows: 20000 a shard at S = 2
SHARDED = ("sharded_lap",)
MESH_BASIC = f"{BASIC}, {MESH_PATH_SHARDS} shards on one card"
MESH_SPREAD = (f"TopologySpreading cut (1000 nodes, 200 init, 600 spread pods), "
               f"{MESH_PATH_SHARDS} shards on one card")
MESH_WAVES = (f"delta-resume waves (1000 nodes, 512 warm, 4 waves of 300 pods with deletes "
              f"and taints), {MESH_PATH_SHARDS} shards on one card")
MESH_CELLS = "two cells of 4 shards on one card (sharded_schedule_batch, NP 8192, B 1024)"


def card_mesh(dev, shards: int):
    from kubernetes_tpu_torch.parallel import make_mesh
    return make_mesh(devices=[dev] * shards)


def sharded_inputs(st, ft, shards: int):
    """(mesh, sharded state, sharded features) of S shards on st's device."""
    from kubernetes_tpu_torch.parallel import shard_features, shard_node_state
    mesh = card_mesh(st.valid.device, shards)
    return mesh, shard_node_state(st, mesh), shard_features(ft, mesh)


def first_lap_size(lap, sst, sft, n_act: int) -> int:
    """L of a dispatch's first lap (one lap of the plain version)."""
    run = lap.lap_run(sst, sft, n_act)
    run.one_lap()
    return int(run.shards[0].L)


def dispatch_errs(lap, sst, sft, st, ft, fs: int, vmax: int, cuts) -> tuple:
    """The sharded_lap kernel, dispatch by dispatch, against its plain
    version (LapRun) and the one-device lap kernel on the whole state: a
    fresh dispatch then a chained one at each cut (pods a dispatch). Returns
    (largest difference from the plain version, from the one-device lap,
    sharded_lap launches a dispatch) over out and the gathered carry."""
    from kubernetes_tpu_torch.ops import kernel as K
    from kubernetes_tpu_torch.parallel import gather

    e_plain = e_one = 0
    per = set()
    for n in cuts:
        ck = cp = co = None
        for _chain in ("fresh", "chained"):
            before = K.sharded_lap.launches
            o_k, ck = lap(sst, sft, n, ck)
            per.add(K.sharded_lap.launches - before)
            got = (o_k,) + tuple(gather(ck))
            o_p, cp = lap.plain(sst, sft, n, cp)
            o_1, co = K.schedule_batch(st, ft, 1024, fs, vmax, K.PlanFacts(), n_active=n,
                                       carry_in=co)
            e_plain = max(e_plain, max_abs_err(got, (o_p,) + tuple(gather(cp))))
            e_one = max(e_one, max_abs_err(got, (o_1,) + tuple(co)))
    torch.cuda.synchronize()
    return e_plain, e_one, per


def mesh_refusals(dev) -> None:
    """What the sharded lap must refuse on the card rather than hang or
    return a result that only looks valid: more shards on a card than one
    launch keeps resident (ValueError before any launch), a wait whose
    budget runs out (a shard that never arrives: the status word raises),
    and an exchange buffer the card cannot reach (pageable host memory: the
    launcher's cudaPointerGetAttributes check; _marshal refuses it first)."""
    from kubernetes_tpu_torch.ops import kernel as K
    from kubernetes_tpu_torch.parallel import sharded_lap_schedule
    from kubernetes_tpu_torch.parallel.mesh import _lap_shards
    from kubernetes_tpu_torch.testing.kernel_inputs import random_inputs

    st, ft = to_device(dev, *random_inputs(520, 64 * (K.SHL_MAX_LOCAL + 1), 2000))
    _m, sst, sft = sharded_inputs(st, ft, K.SHL_MAX_LOCAL + 1)
    lap = sharded_lap_schedule(_m, 1024, 0, 64)
    limit = K._resident_limit(dev, 64, st.alloc_r.shape[1], ft.fit_slots.shape[0],
                              K.SHL_MAX_LOCAL + 1, False)
    before = K.sharded_lap.launches
    try:
        lap(sst, sft, 100)
        fail(f"{K.SHL_MAX_LOCAL + 1} shards on one card were not refused")
    except ValueError as e:
        check(f"at most {limit} resident" in str(e), f"the refusal does not name the limit: {e}")
    check(K.sharded_lap.launches == before, "a refused dispatch launched")
    # A dispatch of two shards whose second never launches.
    _m, sst, sft = sharded_inputs(*to_device(dev, *random_inputs(521, 8192, 5000)), 2)
    shards = _lap_shards(sharded_lap_schedule(_m, 1024, 0, 64), sst, sft, None, plain=False)
    out = torch.full((2, 1024), -1, dtype=torch.int32, device=dev)
    npl, R = shards[0].state.alloc_r.shape
    ints, feats = K._res_args(shards[0].f, 0)
    xbuf, gen = K._exchange_buffer([dev, dev])
    table = torch.tensor([K._lap_table_row(shards[0], 0, dev, npl, R)], dtype=torch.int64)
    status = torch.zeros(1, dtype=torch.int32, device=dev)
    f = shards[0].f
    args = (npl, *ints, 2, 1, 500, 1024, gen, 2, *feats, f.weights, f.num_nodes, f.to_find, table,
            xbuf, out, None, status)
    t0 = time.perf_counter()
    rc = K._build.launcher("sharded_lap")(*K._marshal("sharded_lap", dev, args), K._stream(dev))
    check(rc == 0, f"the lone shard's launch failed with cudaError {rc}")
    try:
        K._sharded_lap_status([(dev, [0], status, table)])
        fail("a wait whose budget ran out did not raise")
    except RuntimeError as e:
        waited = time.perf_counter() - t0
        check("waited past its budget at lap 0, exchange 1" in str(e), f"wrong status: {e}")
    # Pageable host memory as the exchange buffer.
    pageable = torch.zeros(xbuf.numel(), dtype=torch.int64)
    try:
        K._marshal("sharded_lap", dev, args[:-4] + (pageable,) + args[-3:])
        fail("a pageable exchange buffer passed _marshal")
    except ValueError:
        pass
    cargs = K._marshal("sharded_lap", dev, args)
    cargs[-4] = pageable.data_ptr()
    rc = K._build.launcher("sharded_lap")(*cargs, K._stream(dev))
    check(rc == K._CUDA_INVALID_DEVICE_POINTER,
          f"the launcher took an exchange buffer the card cannot reach (rc {rc})")
    torch.cuda.synchronize()
    print(f"sharded lap refusals: {K.SHL_MAX_LOCAL + 1} shards on one card refused (limit "
          f"{limit}); a lone shard's wait ran out and raised after {waited:.3f} s; pageable "
          f"host memory refused (rc {rc})", flush=True)


def mesh_kernel_phase(dev, np_cap: int, n_nodes: int, errs: dict) -> None:
    """The sharded_lap kernel against its plain version (LapRun) and the
    one-device lap kernel on the card, S = 2, 4 and 8 shards on one card
    (and 16 on the first batch): SchedulingBasic's first batch (its
    5000-node mirror, B 1024), seeded draws with the hazard cases, and a
    draw whose shards keep their rows in device memory (S = 2); each
    dispatch fresh and chained, cut after 1, L and 2L pods (L the first
    lap's) and whole; one launch a dispatch. Then the refusals."""
    from kubernetes_tpu_torch import bench
    from kubernetes_tpu_torch.ops.features import BatchFeatures
    from kubernetes_tpu_torch.parallel import sharded_lap_schedule
    from kubernetes_tpu_torch.testing.kernel_inputs import random_inputs

    first = "SchedulingBasic's first batch"
    sched = bench.build_cluster(n_nodes, device=dev, mesh=None)
    pod = bench.make_pods(1, "first")[0]
    st, plan = sched.build_plan(sched.framework_for_pod(pod), pod, 1024)
    check(plan.row_local and plan.batch_pad == 1024 and st.valid.shape[0] == np_cap,
          "SchedulingBasic's first batch is not a row-local 1024-step plan at the mirror's tier")
    draws = {first: (st, plan.features, plan.fit_strategy, plan.vmax, 1024,
                     MESH_SHARDS + (16,))}
    sel = BatchFeatures._fields.index("sel_match")
    hazards = {  # (random_inputs arguments, pods, rows [lo, hi) with no feasible row)
        "the start in a late shard": (dict(start=n_nodes * 5 // 6), 256, None),
        "start 0": (dict(start=0), 256, None),
        "LAP_MAX windows, a short final lap": (dict(to_find=7), 1021, None),
        "shards with no feasible row": (dict(to_find=13), 1000, (np_cap // 2, np_cap)),
        "truncation off": (dict(to_find=n_nodes), 24, None),
        "nothing feasible": (dict(infeasible=True), 24, None),
    }
    for i, (case, (kw, n_act, dead)) in enumerate(hazards.items()):
        s, f = random_inputs(500 + i, np_cap, n_nodes, **kw)
        if dead is not None:
            f = list(f)
            f[sel] = f[sel].copy()
            f[sel][dead[0]:dead[1]] = False
        st_h, ft_h = to_device(dev, s, f)
        draws[case] = (st_h, ft_h, i % 2, 64, n_act, MESH_SHARDS)
    # Past the on-chip tier: two shards of 20000 rows keep their rows in
    # the device-memory buffer.
    rows, live = SHARDED_ABOVE_TIER
    draws[f"{rows} rows in two shards (past the on-chip tier)"] = (
        *to_device(dev, *random_inputs(530, rows, live)), 1, 64, 256, (2,))
    errs.setdefault("sharded_lap", 0)
    dispatches = 0
    for case, (st_c, ft_c, fs, vmax, n_act, shard_counts) in draws.items():
        summary = []
        for S in shard_counts:
            _mesh, sst, sft = sharded_inputs(st_c, ft_c, S)
            lap = sharded_lap_schedule(_mesh, 1024, fs, vmax)
            L = first_lap_size(lap, sst, sft, n_act)
            cuts = sorted({min(c, n_act) for c in (1, L, 2 * L, n_act)})
            e_plain, e_one, per = dispatch_errs(lap, sst, sft, st_c, ft_c, fs, vmax, cuts)
            errs["sharded_lap"] = max(errs["sharded_lap"], e_plain, e_one)
            check(e_plain == 0, f"the sharded lap disagrees with its plain version: {case}, S {S} "
                  f"(max_abs_err {e_plain})")
            check(e_one == 0, f"the sharded lap disagrees with the one-device lap kernel: {case}, "
                  f"S {S} (max_abs_err {e_one})")
            check(per == {1}, f"{case}, S {S}: sharded_lap launches a dispatch {per}, not 1")
            dispatches += 2 * len(cuts)
            summary.append(f"S {S} cuts {cuts}")
        print(f"sharded lap, {case}: exact against the plain version and the one-device lap, "
              f"fresh and chained; {', '.join(summary)}", flush=True)
    print(f"sharded_lap vs its plain version and the one-device lap: max_abs_err "
          f"{errs['sharded_lap']} over {dispatches} dispatches ({len(draws)} draws), one launch "
          "each", flush=True)
    mesh_refusals(dev)


def cut_run(dev, workload: str, n_nodes: int, n_init: int, n_measure: int, mesh, label: str):
    """A cut of a workload on `n_nodes` nodes under `mesh` (None: one
    device): init pods, then `n_measure` measured pods, the launch counts
    zeroed between."""
    from kubernetes_tpu_torch import bench
    from kubernetes_tpu_torch.ops import kernel as K

    w = bench.WORKLOADS[workload]
    sched = bench.build_cluster(n_nodes, device=dev, node=w.node, mesh=mesh)
    bench.warm(sched, n_init, workload)
    K.reset_launch_counts()
    result = bench.measure(sched, n_measure, workload=workload, label=label)
    return sched, result, {k.__name__: k.launches for k in K.WRAPPERS}


def mesh_waves(dev, mesh, n_nodes: int = 1000, warm: int = 512, waves: int = 4,
               wave_pods: int = 300, deletes: int = 50, capture=None):
    """Completions and arrivals under `mesh`: SchedulingBasic's node shape,
    `warm` pods, then `waves` waves of `wave_pods` pods, each after
    `deletes` bound pods are deleted; wave 1 taints a node NoSchedule, wave
    2 another, wave 3 lifts the first. Every event is a row patch: one full
    rebuild in all. `capture` receives the first patch_carry_rows_pinned
    call's arguments."""
    from kubernetes_tpu_torch import bench
    from kubernetes_tpu_torch.ops import kernel as K

    rng = random.Random(77)
    sched = bench.build_cluster(n_nodes, device=dev, mesh=mesh)
    bench.warm(sched, warm)
    pinned = K.patch_carry_rows_pinned

    def recorded(*args):
        if capture is not None and not capture:
            capture["args"] = args
        return pinned(*args)
    K.patch_carry_rows_pinned = recorded
    K.reset_launch_counts()
    try:
        for w in range(1, waves + 1):
            done = sorted(p.name for p in sched.clientset.pods.values() if p.node_name)
            by_name = {p.name: p for p in sched.clientset.pods.values()}
            for name in rng.sample(done, deletes):
                sched.clientset.delete_pod(by_name[name])
            if w in (1, 2):
                sched.clientset.update_node(bench.cluster_node(
                    w * n_nodes // 3, taint=("dedicated", "infra", "NoSchedule")))
            elif w == 3:
                sched.clientset.update_node(bench.cluster_node(n_nodes // 3))
            for p in bench.make_pods(wave_pods, f"mwave{w}"):
                sched.clientset.create_pod(p)
            sched.run_until_idle()
    finally:
        K.patch_carry_rows_pinned = pinned
    launches = {k.__name__: k.launches for k in K.WRAPPERS}
    pods = list(sched.clientset.pods.values())
    check(all(p.node_name for p in pods) and sched.host_path_pods == 0 and sched.failures == 0,
          f"{MESH_WAVES} on {dev}: {sum(1 for p in pods if p.node_name)} of {len(pods)} bound, "
          f"{sched.host_path_pods} host-path pods")
    check(sched.plan_rebuilds_full == 1 and sched.plan_rebuilds_delta >= waves,
          f"{MESH_WAVES} on {dev}: {sched.plan_rebuilds_full} full rebuilds, "
          f"{sched.plan_rebuilds_delta} row patches")
    return sched, launches


def mesh_paths(dev, paths: dict) -> dict:
    """The mesh drives on the card, each against the unsharded CUDA run
    (and, for the cuts, the same cut under a CPU mesh of as many shards):
    SchedulingBasic at full size through the sharded lap, a
    TopologySpreading cut through the gathered path, delta-resume waves and
    a two-cell draw."""
    from kubernetes_tpu_torch import bench
    from kubernetes_tpu_torch.ops import kernel as K
    from kubernetes_tpu_torch.parallel import make_mesh, sharded_schedule_batch
    from kubernetes_tpu_torch.testing.kernel_inputs import random_inputs

    out = {}
    mesh = card_mesh(dev, MESH_PATH_SHARDS)
    cpu_mesh = make_mesh(devices=["cpu"] * MESH_PATH_SHARDS)

    sched, result, launches = run_path(dev, BASIC, mesh=mesh, label=MESH_BASIC)
    d = result["detail"]
    w = bench.WORKLOADS[BASIC]
    total = w.init_pods + w.measure_pods
    check(len(sched.clientset.bindings) == total and d["host_path_pods"] == 0
          and d["failures"] == 0, f"{MESH_BASIC}: {len(sched.clientset.bindings)} of {total} "
          f"bound, {d['host_path_pods']} host-path pods")
    check(assignments(sched) == assignments(paths[BASIC][0]),
          f"{MESH_BASIC}: the assignments differ from the unsharded run's")
    check(d["shard_map_dispatches"] > 0 and sched.host_path_pods == 0,
          f"{MESH_BASIC}: {d['shard_map_dispatches']} sharded-lap dispatches")
    for k in SHARDED + ("static_masks",):
        check(launches[k] > 0, f"{k} was not launched on the {MESH_BASIC} path")
    check(launches["sharded_lap"] == d["shard_map_dispatches"],
          f"{MESH_BASIC}: {launches['sharded_lap']} sharded_lap launches for "
          f"{d['shard_map_dispatches']} dispatches on one card (one a dispatch)")
    check(launches["lap_schedule"] == 0, f"{MESH_BASIC}: the one-device lap was launched")
    print(f"{MESH_BASIC}: {total} pods as the unsharded run, pod for pod; "
          f"{d['shard_map_dispatches']} sharded-lap dispatches in the window; launches "
          f"{ {k: launches[k] for k in SHARDED} }; dispatch_s {d['dispatch_s']:.4f}; pods/s "
          f"{result['value']:.1f} "
          f"({MESH_PATH_SHARDS} shards on one card, not a multi-GPU number)", flush=True)
    out[MESH_BASIC] = (sched, result, launches)

    spread = "TopologySpreading/5000Nodes_5000Pods"
    runs = {}
    for what, d_, m_ in (("mesh", dev, mesh), ("unsharded", dev, None), ("cpu mesh", "cpu",
                                                                           cpu_mesh)):
        t0 = time.perf_counter()
        runs[what] = cut_run(d_, spread, 1000, 200, 600, m_, MESH_SPREAD)
        print(f"{MESH_SPREAD}, {what} run: {time.perf_counter() - t0:.1f} s", flush=True)
    ms, mr, ml = runs["mesh"]
    for what in ("unsharded", "cpu mesh"):
        check(assignments(ms) == assignments(runs[what][0]),
              f"{MESH_SPREAD}: the card's mesh run differs from the {what} run")
    smd = mr["detail"]["shard_map_dispatches"]
    check(ms.host_path_pods == 0 and smd == 0,
          f"{MESH_SPREAD}: {ms.host_path_pods} host-path pods, {smd} sharded-lap dispatches "
          "of spread pods (the gathered path takes them)")
    check(ml["scan_general"] > 0, f"scan_general was not launched on the {MESH_SPREAD} path")
    print(f"{MESH_SPREAD}: every run equal, the gathered path (scan_general "
          f"{ml['scan_general']} launches)", flush=True)
    out[MESH_SPREAD] = (ms, mr, ml)

    capture = {}
    t0 = time.perf_counter()
    wm, wl = mesh_waves(dev, mesh, capture=capture)
    wu, _ = mesh_waves(dev, None)
    wc, _ = mesh_waves("cpu", cpu_mesh)
    check(assignments(wm) == assignments(wu) == assignments(wc),
          f"{MESH_WAVES}: the card's mesh run differs from the unsharded or the cpu mesh run")
    for k in ("scatter_rows", "patch_carry_rows") + SHARDED:
        check(wl[k] > 0, f"{k} was not launched on the {MESH_WAVES} path")
    check(capture and hasattr(capture["args"][2], "parts"),
          f"{MESH_WAVES}: no sharded carry was patched")
    print(f"{MESH_WAVES}: equal to the unsharded and the cpu mesh runs; full/delta/resume "
          f"{wm.plan_rebuilds_full}/{wm.plan_rebuilds_delta}/{wm.plan_rebuilds_resume}; launches "
          f"scatter_rows {wl['scatter_rows']}, patch_carry_rows {wl['patch_carry_rows']}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    out[MESH_WAVES] = (wm, None, wl)

    draws = [random_inputs(900 + c, 8192, 5000) for c in range(2)]
    stacked = [[np.stack([dr[k][i] for dr in draws]) for i in range(len(draws[0][k]))]
               for k in (0, 1)]
    facts = K.PlanFacts()  # row-local: the one-device lap on each cell's row
    got = {}
    for what, d_ in (("card", dev), ("cpu", "cpu")):
        st_c, ft_c = to_device(d_, *stacked)
        run = sharded_schedule_batch(make_mesh(n_cells=2, devices=[d_] * 8), 1024, 0, 64)
        got[what] = run(st_c, ft_c, facts)[0].cpu()
    for c in range(2):
        st_c, ft_c = to_device(dev, *draws[c])
        single = K.schedule_batch(st_c, ft_c, 1024, 0, 64, facts)[0].cpu()
        check(torch.equal(got["card"][c], single) and torch.equal(got["cpu"][c], single),
              f"{MESH_CELLS}: cell {c} differs from its single-device run")
    print(f"{MESH_CELLS}: each cell equal to its single-device run and to the cpu run "
          f"({int((got['card'][:, 0] >= 0).sum())} pods placed)", flush=True)
    return out, capture


def lap_dispatch_timing(lap, sst, sft, laps: int, timer, cards: int = 1) -> dict:
    """One sharded-lap dispatch of 1024 pods: its wall ms (`timer`), the
    device ms of its launches and their count from torch.profiler (kernel
    events of 20 dispatches; a trace that lost launches is taken again, up
    to three), launches a dispatch from the wrapper's counter, and the
    device-to-host copies a dispatch (the status words: no read of `done`)."""
    from kubernetes_tpu_torch.ops import kernel as K

    reps = 20
    call_ms = timer(lambda: lap(sst, sft, 1024), reps=10)
    for _attempt in range(3):
        before = K.sharded_lap.launches
        events = traced(lambda: lap(sst, sft, 1024), reps)
        counted = (K.sharded_lap.launches - before) / (2 * reps + 1)
        spans = [us for name, us in events if "sharded_lap_kernel" in name]
        if len(spans) >= reps * cards - 1:
            break
    dtoh = sum(1 for name, _us in events if "DtoH" in name or "Device -> Pageable" in name
               or "Device -> Pinned" in name)
    device_ms = sum(spans) / max(len(spans), 1) / 1e3
    return dict(call_ms=call_ms, device_ms=device_ms, us_a_lap=device_ms / laps * 1e3,
                call_us_a_lap=call_ms / laps * 1e3, laps=laps,
                launches_a_dispatch=counted, profiler_launches_a_dispatch=len(spans) / reps,
                dtoh_copies_a_dispatch=dtoh / reps)


def lap_bound(st, ft, landed: int, B: int = 1024) -> tuple:
    """(bound ms, "bytes" or "operations", bytes, ops) of one sharded-lap
    dispatch: every row's inputs read once (alloc_r and req_r 8R bytes
    each, alloc_pods, nonzero, pod_count, static_ok, il_score) and its fit
    lanes written once, the landed rows' aggregates written, the results;
    each row evaluated once and each landed row again."""
    NP, R = st.alloc_r.shape
    FR = ft.fit_slots.shape[0]
    row_ops = 4 * R + 12 * FR + 24
    nbytes = NP * (16 * R + 8 + 16 + 4 + 1 + 8 + 17) + landed * (8 * R + 20) + 8 * B
    ops = (NP + landed) * row_ops
    t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS_PER_S * 1e3
    return max(t_b, t_o), "bytes" if t_b >= t_o else "operations", nbytes, ops


def mesh_timing(paths: dict, errs: dict, capture: dict) -> dict:
    """The sharded lap on SchedulingBasic's next batch (the path's cluster
    after its measured run, NP 8192, B 1024) at S = 1, 2, 4 and 8 on one
    card: ms a dispatch, us a lap, the device time of its one launch and the
    launches a dispatch (the counter and torch.profiler), its plain version
    and its bound a dispatch, beside the one-device lap on the same batch
    (S = 1 holds the window pass over 8192 rows against the one-device
    lap's chunk summaries); the mesh waves' first sharded carry patch and
    per-shard dirty-row scatter."""
    from kubernetes_tpu_torch import bench
    from kubernetes_tpu_torch.ops import kernel as K
    from kubernetes_tpu_torch.parallel import gather, sharded_lap_schedule

    sched = paths[BASIC][0]
    pod = bench.make_pods(1, "timed")[0]
    st, plan = sched.build_plan(sched.framework_for_pod(pod), pod, sched.max_batch)
    ft, fs, vmax = plan.features, plan.fit_strategy, plan.vmax
    stats = {}
    ext0 = K.fresh_carry(st, ft, vmax, K._resource_eval_plain(
        ft, fs, st.alloc_r, st.alloc_pods, st.req_r, st.nonzero, st.pod_count))
    o_s, _c = K._lap_schedule_plain(st, ft, 1024, fs, ext0, K._static_masks_plain(st, ft).static_ok,
                                    1024, stats=stats)
    laps, landed = stats["laps"], int((o_s[0] >= 0).sum())
    one = lambda: K.schedule_batch(st, ft, 1024, fs, vmax, plan.facts)  # noqa: E731
    single = dict(call_ms=wall_ms(one, reps=5), device_ms=device_ms(one, "lap_schedule")[0])
    single["us_a_lap"] = single["device_ms"] / laps * 1e3
    bound_ms, bound_by, nbytes, ops = lap_bound(st, ft, landed)
    by_shards = {}
    for S in (1,) + MESH_SHARDS:
        mesh, sst, sft = sharded_inputs(st, ft, S)
        lap = sharded_lap_schedule(mesh, 1024, fs, vmax)
        o_k, c_k = lap(sst, sft, 1024)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o_p, c_p = lap.plain(sst, sft, 1024)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        check(max_abs_err((o_k,) + tuple(gather(c_k)), (o_p,) + tuple(gather(c_p))) == 0,
              f"the sharded lap at S {S} disagrees with its plain version on {BASIC}'s next batch")
        row = lap_dispatch_timing(lap, sst, sft, laps, wall_ms)
        check(row["launches_a_dispatch"] == 1,
              f"S {S}: {row['launches_a_dispatch']} sharded_lap launches a dispatch, not 1")
        row.update(plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, ops=ops)
        by_shards[S] = row
        print(f"sharded lap, S {S} on one card, {BASIC}'s next batch ({laps} laps): "
              f"{row['call_ms']:.4f} ms a dispatch, its launch {row['device_ms']:.4f} ms on the "
              f"device ({row['us_a_lap']:.2f} us a lap); launches a dispatch "
              f"{row['launches_a_dispatch']} (profiler {row['profiler_launches_a_dispatch']}), "
              f"device-to-host copies {row['dtoh_copies_a_dispatch']}; plain {plain_ms:.1f} ms; "
              f"bound {bound_ms:.6f} ms ({bound_by}); one-device lap {single['call_ms']:.4f} ms, "
              f"{single['device_ms']:.4f} ms on the device ({single['us_a_lap']:.2f} us a lap)",
              flush=True)
    r4 = by_shards[MESH_PATH_SHARDS]
    rows = {"sharded_lap": dict(
        name="sharded_lap", route="cuda", source="kubernetes_tpu_torch/csrc/sharded_lap.cu",
        replaces="kubernetes_tpu/parallel/mesh.py:228", launches=0,
        max_abs_err=errs["sharded_lap"], exact=errs["sharded_lap"] == 0, ms=r4["device_ms"],
        host_ms=r4["call_ms"], plain_ms=r4["plain_ms"], bound_ms=bound_ms, bound_by=bound_by,
        bytes=nbytes, ops=ops, library_ms=None, shards=MESH_PATH_SHARDS, by_shards=by_shards,
        one_device_lap=single)}
    # The two ported functions with no kernel of their own, on the mesh
    # waves' first sharded carry patch: patch_carry_rows and scatter_rows a
    # shard, in place (the same rows again give the same values).
    from kubernetes_tpu_torch.ops.staging import StagingRing

    args = state, f, carry, idx, req_rows, nz_rows, cnt_rows, strat = capture["args"]
    mirror = paths[MESH_WAVES][0].mirror
    rows_idx = sorted({int(r) for r in idx.tolist()})
    part = state.parts[0]
    d, R, T, Kx = (len(rows_idx), part.alloc_r.shape[1], part.taint_key.shape[1],
                   part.topo.shape[0])
    npl = carry.parts[0].pod_count.shape[0]

    def pinned_plain():  # patch_carry_rows' plain version a shard, in place
        shard_of = idx.to(torch.int64) // npl
        for s_, (st_s, f_s, c_s) in enumerate(zip(state.parts, f.parts, carry.parts)):
            mine = shard_of == s_
            if bool(mine.any()):
                K._patch_carry_rows_plain(st_s, f_s, c_s, idx[mine] - s_ * npl, req_rows[mine],
                                          nz_rows[mine], cnt_rows[mine], strat, in_place=True)

    rings = [StagingRing(part.valid.device) for part in mirror._device.parts]

    def scatter_plain():  # scatter_rows' plain version a shard, in place
        res = mirror._device
        for s_, part in enumerate(res.parts):
            mine = [r for r in rows_idx if r // res.block == s_]
            if mine:
                K._scatter_rows_plain(part, *K.stage_scatter(
                    rings[s_], mirror._arrays(), mirror.h_topo, mine,
                    at=[r - s_ * res.block for r in mine]), in_place=True)

    # Bytes each call needs, each distinct row once: the patch reads the
    # row's index, new aggregates and allocatable and writes six lanes; the
    # scatter reads and writes the row's packed fields.
    patch_bytes = d * (4 + 8 * R + 16 + 4 + 8 * R + 8) + d * (8 * R + 16 + 4 + 1 + 8 + 8)
    scatter_bytes = 2 * d * (8 * (2 * R + 3) + 4 * (3 * T + 2 + Kx) + 2)
    mesh_patch = {}
    for what, k_fn, p_fn, nbytes in (
            ("patch_carry_rows_pinned", lambda: K.patch_carry_rows_pinned(*args), pinned_plain,
             patch_bytes),
            ("sharded_scatter", lambda: mirror._scatter_sharded(rows_idx, in_place=True),
             scatter_plain, scatter_bytes)):
        # The device time of a shard's launch (each call launches once a
        # shard with rows), over every launch of 20 calls.
        kernel = "patch_carry_rows" if what == "patch_carry_rows_pinned" else "scatter_rows"
        ms, seen = device_ms(k_fn, kernel)
        mesh_patch[what] = dict(rows=d, shards=MESH_PATH_SHARDS, call_ms=wall_ms(k_fn, reps=20),
                                plain_ms=wall_ms(p_fn, reps=5), device_ms=ms,
                                launches_seen=seen, launches_a_call=seen / 20,
                                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                                bytes=nbytes)
    print("the mesh waves' first patch (" + ", ".join(
        f"{w}: {r['call_ms']:.4f} ms a call, {r['device_ms']:.6f} ms on the device a shard's "
        f"launch ({r['launches_a_call']:g} launches a call), plain {r['plain_ms']:.4f} ms, "
        f"bound {r['bound_ms']:.8f} ms" for w, r in mesh_patch.items())
        + f"; {d} rows over {MESH_PATH_SHARDS} shards)", flush=True)
    rows["sharded_lap"]["mesh_patch"] = mesh_patch
    return rows


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
    paths, lane_inputs, waves = paths_phase(dev)
    mesh_out, mesh_capture = mesh_paths(dev, paths)
    paths.update(mesh_out)
    print(f"paths phase: {time.perf_counter() - t1:.1f} s", flush=True)
    t1 = time.perf_counter()
    rows = timing_phase(paths, errs, lane_inputs)
    rows.update(preemption_timing(paths, errs))
    rows.update(scatter_timing(paths, errs))
    rows.update(patch_timing(waves, errs))
    rows.update(placement_timing(waves, errs))
    rows.update(whatif_timing(waves, errs))
    blocked_timing(rows, waves["blocked_captures"], errs)
    aux_timing(rows, waves["aux_captures"], errs)
    rows.update(mesh_timing(paths, errs, mesh_capture))
    floor, seen = launch_floor_ms(dev)
    short = ("static_masks", "resource_eval", "dry_run_preemption", "scatter_rows",
             "patch_carry_rows", "whatif_score")
    print(f"launch floor (a one-element fill_ on the stream, {seen} of 20 seen): {floor:.6f} ms "
          "on the device; " + ", ".join(f"{n} {rows[n]['ms']:.6f}" for n in short), flush=True)
    for name in short:
        rows[name]["launch_floor_ms"] = floor
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
    parity_phase(dev, paths)
    print(f"parity phase: {time.perf_counter() - t1:.1f} s", flush=True)

    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def sync_all() -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def cards_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean wall ms a call of `fn`, every card drained before and after:
    events on one card do not see another card's queue."""
    for _ in range(warmup):
        fn()
    sync_all()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync_all()
    return (time.perf_counter() - t0) * 1e3 / reps


def cards_main(n: int) -> int:
    """The mesh across `n` cards, one shard a card (the module docstring's
    --cards mode)."""
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < n or n < 2:
        fail(f"--cards {n} needs at least 2 and at most {torch.cuda.device_count()} cards")
    try:
        from kubernetes_tpu_torch.ops import _build
    except ImportError as e:
        fail(f"the kubernetes_tpu_torch package is not beside this script ({e})")
    from kubernetes_tpu_torch import bench
    from kubernetes_tpu_torch.ops import kernel as K
    from kubernetes_tpu_torch.parallel import (gather, make_mesh, shard_features,
                                               shard_node_state, sharded_lap_schedule)
    from kubernetes_tpu_torch.parallel.mesh import _lap_shards

    dev = torch.device("cuda", 0)
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    smi = out.stdout.strip().splitlines()[:n] if out.returncode == 0 else ["nvidia-smi unavailable"]
    print(f"cards: {smi}", flush=True)
    t0 = time.perf_counter()
    _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    mesh = make_mesh(devices=[torch.device("cuda", i) for i in range(n)])
    label = f"{BASIC}, {n} shards on {n} cards"
    res = {"cards": n, "card": smi}

    one, r1, _ = drive(dev, BASIC)
    sched, result, launches = run_path(dev, BASIC, mesh=mesh, label=label)
    d = result["detail"]
    check(assignments(sched) == assignments(one) and d["host_path_pods"] == 0
          and d["failures"] == 0, f"{label}: the assignments differ from the unsharded run's")
    check(d["shard_map_dispatches"] > 0, f"{label}: no sharded-lap dispatch")
    for k in SHARDED:
        check(launches[k] > 0, f"{k} was not launched on the {label} path")
    check(launches["sharded_lap"] == n * d["shard_map_dispatches"],
          f"{label}: {launches['sharded_lap']} sharded_lap launches for "
          f"{d['shard_map_dispatches']} dispatches on {n} cards (one a card a dispatch)")
    check(launches["lap_schedule"] == 0, f"{label}: the one-device lap was launched")
    check({p.valid.device for p in sched.mirror._device.parts} == set(mesh.nodes()),
          f"{label}: the resident state is not one shard a card")
    res["pods_per_s"] = {"unsharded": r1["value"], "mesh": result["value"]}
    res["dispatch_s"] = {"unsharded": r1["detail"]["dispatch_s"], "mesh": d["dispatch_s"]}
    res["launches"] = {k: launches[k] for k in SHARDED}
    print(f"{label}: pod for pod as the unsharded run; pods/s {result['value']:.1f} "
          f"(unsharded {r1['value']:.1f}); dispatch_s {d['dispatch_s']:.4f} (unsharded "
          f"{r1['detail']['dispatch_s']:.4f}); launches {res['launches']} for "
          f"{d['shard_map_dispatches']} dispatches", flush=True)

    wm, wl = mesh_waves(dev, mesh)
    wu, _ = mesh_waves(dev, None)
    check(assignments(wm) == assignments(wu),
          f"the delta-resume waves on {n} cards differ from the unsharded run")
    for k in ("scatter_rows", "patch_carry_rows") + SHARDED:
        check(wl[k] > 0, f"{k} was not launched on the delta-resume waves on {n} cards")
    res["waves"] = {"full": wm.plan_rebuilds_full, "delta": wm.plan_rebuilds_delta,
                    "scatter_rows": wl["scatter_rows"],
                    "patch_carry_rows": wl["patch_carry_rows"]}
    print(f"delta-resume waves on {n} cards: equal to the unsharded run; {res['waves']}",
          flush=True)

    pod = bench.make_pods(1, "timed")[0]
    st, plan = one.build_plan(one.framework_for_pod(pod), pod, one.max_batch)
    ft, fs, vmax = plan.features, plan.fit_strategy, plan.vmax
    o1, c1 = K.schedule_batch(st, ft, 1024, fs, vmax, plan.facts)
    stats = {}
    ext0 = K.fresh_carry(st, ft, vmax, K._resource_eval_plain(
        ft, fs, st.alloc_r, st.alloc_pods, st.req_r, st.nonzero, st.pod_count))
    K._lap_schedule_plain(st, ft, 1024, fs, ext0, K._static_masks_plain(st, ft).static_ok, 1024,
                          stats=stats)
    laps = stats["laps"]
    single_ms = cards_ms(lambda: K.schedule_batch(st, ft, 1024, fs, vmax, plan.facts), reps=5)
    res["one_device_call_ms"] = single_ms
    bound_ms, bound_by, _b, _o = lap_bound(st, ft, int((o1[0] >= 0).sum()))
    res["bound_ms"] = bound_ms
    for where, m, n_cards in ((f"{n} cards", mesh, n), ("one card", card_mesh(dev, n), 1)):
        sst, sft = shard_node_state(st, m), shard_features(ft, m)
        lap = sharded_lap_schedule(m, 1024, fs, vmax)
        o_k, c_k = lap(sst, sft, 1024)
        e = max_abs_err((o_k,) + tuple(gather(c_k)), (o1,) + tuple(c1))
        check(e == 0, f"the sharded lap on {where} disagrees with the one-device lap ({e})")
        o_p, c_p = lap.plain(sst, sft, 1024)
        e = max_abs_err((o_k,) + tuple(gather(c_k)), (o_p,) + tuple(gather(c_p)))
        check(e == 0, f"the sharded lap on {where} disagrees with its plain version ({e})")
        row = lap_dispatch_timing(lap, sst, sft, laps, cards_ms, cards=n_cards)
        check(row["launches_a_dispatch"] == n_cards,
              f"{where}: {row['launches_a_dispatch']} sharded_lap launches a dispatch, "
              f"not {n_cards}")
        res[f"lap_{n}_shards_on_" + where.replace(" ", "_")] = row
        print(f"sharded lap, {n} shards on {where}, {BASIC}'s next batch ({laps} laps): exact; "
              f"{row['call_ms']:.4f} ms a dispatch ({row['call_us_a_lap']:.2f} us a lap), each "
              f"launch {row['device_ms']:.4f} ms on its card; launches a dispatch "
              f"{row['launches_a_dispatch']} (profiler {row['profiler_launches_a_dispatch']}); "
              f"bound {bound_ms:.6f} ms ({bound_by}); one-device lap {single_ms:.4f} ms a call",
              flush=True)
    # A card that cannot reach the exchange buffer: another card's memory.
    sst, sft = shard_node_state(st, mesh), shard_features(ft, mesh)
    shards = _lap_shards(sharded_lap_schedule(mesh, 1024, fs, vmax), sst, sft, None, plain=False)
    npl, R = shards[0].state.alloc_r.shape
    ints, feats = K._res_args(shards[0].f, fs)
    f0 = shards[0].f
    other = torch.zeros(n * (K.SHL_PAIR_STRIDE + K.SHL_KEY_STRIDE), dtype=torch.int64,
                        device=torch.device("cuda", 1))
    table = torch.tensor([K._lap_table_row(shards[0], 0, dev, npl, R)], dtype=torch.int64)
    status = torch.zeros(1, dtype=torch.int32, device=dev)
    cargs = K._marshal("sharded_lap", dev, (npl, *ints, n, 1, 10, 1024, 1, 2, *feats, f0.weights,
                                            f0.num_nodes, f0.to_find, table,
                                            torch.zeros_like(other, device=dev), None, None,
                                            status))
    cargs[-4] = other.data_ptr()  # past _marshal, which refuses another card's tensor
    with torch.cuda.device(dev):
        rc = K._build.launcher("sharded_lap")(*cargs, K._stream(dev))
    check(rc == K._CUDA_INVALID_DEVICE_POINTER,
          f"cuda:0 took an exchange buffer in cuda:1's memory (rc {rc})")
    res["unreachable_buffer_rc"] = rc
    print(f"an exchange buffer on cuda:1 refused by cuda:0's launcher (rc {rc})", flush=True)

    print(json.dumps(res), flush=True)
    for line in smi:
        print(line, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cards"] and len(sys.argv) == 3:
        sys.exit(cards_main(int(sys.argv[2])))
    if sys.argv[1:]:
        fail("usage: chip_smoke.py [--cards N]")
    sys.exit(main())
