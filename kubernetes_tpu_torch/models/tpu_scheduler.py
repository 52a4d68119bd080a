"""TorchScheduler — the scheduler with its hot path on an NVIDIA GPU (the
port of the JAX package's TPUScheduler, trimmed to the port's slices).

Control flow:

    pop → a row-block of consecutive same-signature pods (up to max_batch)
        → Cache.update_snapshot (host, incremental)
        → NodeStateMirror.sync/flush (device, dirty-row scatter)
        → build_batch (per-batch features, once per session)
        → ops.kernel.schedule_batch (the whole greedy assignment of the
          block on the device: static masks, fit/score evaluation, sampling
          emulation, selection, carry updates)
        → per pod: assume → bind (host, unchanged semantics)

Consecutive batches of one session chain through the device carry — count
tables included, so identical spread or affinity pods (one signature: the
PodTopologySpread and InterPodAffinity Sign parts cover their labels,
namespace and terms) share one plan — and up to `pipeline_depth` batches
are in flight: the host commits batch N while the device computes batch
N+1. Each batch's results come back through a non-blocking copy into pinned
host memory, fenced by a CUDA event. Any foreign pod, node or namespace
event, and any change to the set of nominated pods, ends the session: the
next one rebuilds its plan from the snapshot (the JAX package delta-patches
pod-local plans instead; not ported yet).

Priorities and preemption. While pods are nominated (a preemption reserved
room for them), a session's plan carries the nominated-pod lane: the
nominated pods of equal or higher priority, counted against the fit filter
of their rows (the two-pass filter's first pass, resources only), and its
batches hold pods of the head's priority only. A pod that fits nowhere
gets its diagnosis and runs PostFilter (DefaultPreemption), whose per-node
dry run is the dry_run_preemption kernel here (device_dry_run_preemption);
the host re-verifies the chosen candidate and raises where it disagrees.
The victims' deletions dirty the mirror's rows, which the next plan
flushes with the scatter_rows kernel.

Pods the kernels do not cover (matchFields narrowing, a nominated node's
fast path, spread or affinity pods while pods are nominated) and pods a
session hands back take the host path in core/scheduler.py, which produces
the same assignments; so does the dry run of a preemptor with spread or
affinity terms, in a cluster with anti-affinity pods, or with more than
PREEMPT_K_CAP victims on a node.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.framework import UNSCHEDULABLE_AND_UNRESOLVABLE, CycleState, FitError, Framework
from ..core.queue import QueuedPodInfo
from ..core.scheduler import Scheduler
from ..ops.device_state import NodeStateMirror
from ..ops.features import (
    Unsupported,
    batch_supported,
    build_batch,
    build_preemption_victims,
    diagnose_unschedulable,
)
from ..ops.kernel import dry_run_preemption, schedule_batch
from ..plugins.preemption import Candidate

DEFAULT_MAX_BATCH = 1024  # the JAX package's config.max_batch
PIPELINE_DEPTH = 2        # batches in flight (double buffering)


class _Fetch:
    """A batch's [2, B] results on their way to the host."""

    def __init__(self, results: torch.Tensor):
        if results.device.type == "cuda":
            self._host = torch.empty(results.shape, dtype=results.dtype, pin_memory=True)
            self._host.copy_(results, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = results
            self._event = None

    def wait(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


class TorchScheduler(Scheduler):
    """Scheduler with the hot path on the device. `device` is "cuda" unless
    the caller asks for "cpu", where the kernels' plain PyTorch versions run."""

    def __init__(self, clientset=None, device="cuda", max_batch: Optional[int] = None,
                 percentage_of_nodes_to_score: int = 0):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("TorchScheduler: CUDA is not available "
                               "(pass device='cpu' to run the plain versions)")
        super().__init__(clientset, percentage_of_nodes_to_score)
        self.device = device
        self.max_batch = max_batch or DEFAULT_MAX_BATCH
        self.mirror = NodeStateMirror(device)
        self._holdover: Optional[QueuedPodInfo] = None
        self.device_batches = 0
        self.device_scheduled = 0
        self.host_path_pods = 0
        self.preemption_device_evals = 0  # dry runs that took the kernel
        # The priority of the session's pods while pods are nominated (the
        # nominated lane is priority-thresholded), else None.
        self._session_nom_priority: Optional[int] = None
        # Host/device time split: snapshot→features host work, popping and
        # grouping pods into batches, enqueueing the kernels, time blocked
        # on a result fetch, the host commit tails, and the session's end
        # (snapshot refresh and adopting the final carry into the mirror).
        self.plan_build_s = 0.0
        self.collect_s = 0.0
        self.dispatch_s = 0.0
        self.device_wait_s = 0.0
        self.host_commit_s = 0.0
        self.session_end_s = 0.0

    @property
    def preemption_verify_divergences(self) -> int:
        """Device dry-run candidates that the host verification refuted."""
        return self.preemption_counts()["verify_divergences"]

    # -- batch accumulation ------------------------------------------------

    def _pop(self) -> Optional[QueuedPodInfo]:
        while True:
            if self._holdover is not None:
                qpi, self._holdover = self._holdover, None
            else:
                qpi = self.queue.pop()
            if qpi is None:
                return None
            if qpi.pod.deletion_ts is not None or qpi.pod.uid in self.cache.pod_states:
                # skipPodSchedule: never dispatch deleting or placed pods.
                self.queue.done(qpi.pod.uid)
                continue
            return qpi

    def _collect_session_batch(self, fw: Framework, sig,
                               batch: Optional[List[QueuedPodInfo]] = None) -> List[QueuedPodInfo]:
        """Fill `batch` up to max_batch pods with the session's signature;
        the first other pod waits in the holdover slot."""
        batch = [] if batch is None else batch
        while len(batch) < self.max_batch:
            nxt = self._pop()
            if nxt is None:
                break
            if (nxt.pod.scheduler_name in self.profiles
                    and self.framework_for_pod(nxt.pod) is fw
                    and fw.sign_pod(nxt.pod) == sig and batch_supported(nxt.pod) is None
                    and self._session_nom_priority in (None, nxt.pod.priority)):
                batch.append(nxt)
            else:
                self._holdover = nxt
                break
        return batch

    def _collect_batch(self) -> Tuple[Optional[Framework], List[QueuedPodInfo], Optional[str]]:
        """Pop a maximal run of consecutive identical-signature pods.
        Returns (framework, batch, fallback_reason); with a reason the batch
        is the one head pod and takes the host path."""
        head = self._pop()
        if head is None:
            return None, [], None
        fw = self.framework_for_pod(head.pod)
        reason = batch_supported(head.pod) or self._nominated_device_block(head.pod)
        sig = fw.sign_pod(head.pod) if reason is None else None
        if sig is None:
            return fw, [head], reason or "unsignable pod"
        # The nominated lane counts the nominations of priority at least the
        # head's (framework.go:1280-1284): a pod of another priority would
        # need another lane, so it waits for the next session.
        nom = self.queue.nominator
        self._session_nom_priority = head.pod.priority if nom.has_nominated_pods() else None
        return fw, self._collect_session_batch(fw, sig, [head]), None

    def _nominated_device_block(self, pod) -> Optional[str]:
        """Why `pod` cannot take the device while pods are nominated (None:
        the nominated lane covers it). The lane models the two-pass filter's
        first pass for resources only, so a pod whose filters a nominated
        pod could change otherwise (spread, affinity, or a nominated pod's
        required anti-affinity) takes the host path."""
        nom = self.queue.nominator
        if not nom.has_nominated_pods():
            return None
        reason = self._resources_only_block(pod)
        if reason is not None:
            return f"nominated pods with {reason}"
        if any(pi.required_anti_affinity_terms for pi in nom.all_nominated_pod_infos()):
            return "nominated pod carries required anti-affinity"
        return None

    @staticmethod
    def _resources_only_block(pod) -> Optional[str]:
        """Why `pod`'s filter verdicts depend on more than each row's
        resource arithmetic and the batch's static masks. The nominated lane
        and the dry-run kernel model other pods (a nomination counted in, a
        victim removed) as request and count deltas, exact only for pods
        without these."""
        if pod.topology_spread_constraints:
            return "spread constraints"
        aff = pod.affinity
        if aff is not None and (aff.pod_affinity or aff.pod_anti_affinity):
            return "pod affinity"
        return None

    def _nominated_lane(self, pod) -> Optional[list]:
        """[(snapshot row, PodInfo)] of the nominated pods of priority at
        least `pod`'s on nodes of the snapshot (call after
        update_snapshot), or None when there is none."""
        nom = self.queue.nominator
        if not nom.has_nominated_pods():
            return None
        index = self.snapshot._index  # node name -> row of node_info_list
        out = [(index[node], pi) for node, pis in nom.nominated_nodes().items()
               if node in index for pi in pis
               if pi.pod.priority >= pod.priority and pi.pod.uid != pod.uid]
        return out or None

    # -- plans and dispatch --------------------------------------------------

    def _profile_weights(self, fw: Framework) -> Tuple[int, ...]:
        w = {p.name: weight for p, weight in fw.score_plugins}
        return (w.get("TaintToleration", 0), w.get("NodeResourcesFit", 0),
                w.get("PodTopologySpread", 0), w.get("InterPodAffinity", 0),
                w.get("NodeResourcesBalancedAllocation", 0), w.get("NodeAffinity", 0),
                w.get("ImageLocality", 0))

    def _profile_filters(self, fw: Framework) -> Tuple[bool, ...]:
        names = {p.name for p in fw.filter_plugins}
        return tuple(n in names for n in ("NodeName", "NodeUnschedulable", "TaintToleration",
                                          "NodeAffinity", "NodeResourcesFit"))

    def build_plan(self, fw: Framework, pod, batch_size: int):
        """Snapshot → mirror sync → batch features → device flush. Returns
        (device state, BatchPlan)."""
        self.cache.update_snapshot(self.snapshot)
        self.mirror.sync(self.snapshot.node_info_list)
        ipa = fw.plugin("InterPodAffinity")
        plan = build_batch(
            pod, batch_size, self.mirror, self.snapshot, self.cache.namespace_labels,
            percentage_of_nodes_to_score=self.percentage_of_nodes_to_score,
            start_index=self.next_start_node_index,
            weights=self._profile_weights(fw), filters_on=self._profile_filters(fw),
            hard_pod_affinity_weight=ipa.hard_pod_affinity_weight,
            ignore_preferred_terms_of_existing_pods=ipa.ignore_preferred_terms_of_existing_pods,
            fit_plugin=fw.plugin("NodeResourcesFit"), nominated=self._nominated_lane(pod))
        return self.mirror.flush(), plan

    def _dispatch(self, state, plan, n_active: int, carry):
        """The only kernel call site (warm and live dispatches alike)."""
        return schedule_batch(state, plan.features, plan.batch_pad, plan.fit_strategy,
                              plan.vmax, plan.facts, n_active=n_active, carry_in=carry)

    def warm_for(self, pod) -> None:
        """Build the kernels and run both the fresh-carry and the chained
        dispatch of a `pod`-shaped session with no active pods (fully
        inert), so that set-up lands outside a measured window. A plan
        whose anti-affinity is row-local also launches its conservative
        fallback (`anti_rowlocal` off: the general scan) once, inert, so
        that a later plan that takes it (once a node shares a value of the
        axis) does not pay the kernel's first load (the JAX package's
        warm_for, :1119-1165, which warms both carries of it because each
        is an XLA compile; here one library holds every kernel). The
        nominated-lane variant of the plan, with an empty lane, is launched
        too (:1168-1180)."""
        fw = self.framework_for_pod(pod)
        if batch_supported(pod) is not None:
            return
        state, plan = self.build_plan(fw, pod, self.max_batch)
        variants = [plan]
        if not plan.features.nom_req.shape[0]:
            f = plan.features
            variants.append(dataclasses.replace(plan, features=f._replace(
                nom_req=torch.zeros_like(state.req_r),
                nom_pods=torch.zeros_like(state.pod_count))))
        for v in variants:
            _results, carry = self._dispatch(state, v, 0, None)
            results, _ = self._dispatch(state, v, 0, carry)
            _Fetch(results).wait()
        if plan.facts.anti_rowlocal:
            fallback = dataclasses.replace(
                plan, facts=plan.facts._replace(anti_rowlocal=False))
            results, _ = self._dispatch(state, fallback, 0, None)
            _Fetch(results).wait()

    # -- device session ------------------------------------------------------

    def _run_device_session(self, fw: Framework, first_batch: List[QueuedPodInfo]) -> None:
        sig = fw.sign_pod(first_batch[0].pod)
        t0 = time.perf_counter()
        state, plan = self.build_plan(fw, first_batch[0].pod, self.max_batch)
        self.plan_build_s += time.perf_counter() - t0
        node_names = [ni.name for ni in self.snapshot.node_info_list]
        start_seq = self.cluster_event_seq
        start_nom = self.queue.nominator.version
        carry = None
        inflight: List[Tuple[List[QueuedPodInfo], _Fetch]] = []
        ok_rows: List[int] = []
        invalidated = False
        batch: Optional[List[QueuedPodInfo]] = first_batch
        while True:
            # Refill the pipeline: dispatch enqueues device work and returns.
            while not invalidated and len(inflight) < PIPELINE_DEPTH:
                if batch is None:
                    t1 = time.perf_counter()
                    batch = self._collect_session_batch(fw, sig) or None
                    self.collect_s += time.perf_counter() - t1
                    if batch is None:
                        break
                t1 = time.perf_counter()
                results, carry = self._dispatch(state, plan, len(batch), carry)
                inflight.append((batch, _Fetch(results)))
                self.dispatch_s += time.perf_counter() - t1
                self.device_batches += 1
                batch = None
            if not inflight:
                break
            # Retire the oldest batch while the device computes the next.
            b, fetch = inflight.pop(0)
            t1 = time.perf_counter()
            res = fetch.wait()
            t2 = time.perf_counter()
            self.device_wait_s += t2 - t1
            if not invalidated:
                invalidated = self._commit_batch(b, res, fw, node_names, ok_rows)
                # Any cluster change the carry does not hold, and any change
                # to the nominated set, ends the chain.
                invalidated = (invalidated or self.cluster_event_seq != start_seq
                               or self.queue.nominator.version != start_nom)
                self.host_commit_s += time.perf_counter() - t2
            else:
                # A previous batch diverged: every later device choice is stale.
                for qpi in b:
                    self.host_path_pods += 1
                    self.process_one(qpi)
        if batch:  # popped but never dispatched (invalidated mid-refill)
            for qpi in batch:
                self.host_path_pods += 1
                self.process_one(qpi)
        t3 = time.perf_counter()
        self.cache.update_snapshot(self.snapshot)
        if invalidated:
            # Staging is the authority again: full re-encode + upload.
            self.mirror.invalidate()
        elif carry is not None:
            # The final carry holds every placement: keep it resident.
            self.mirror.adopt(self.snapshot.node_info_list, ok_rows,
                              carry.req_r, carry.nonzero, carry.pod_count)
        self.session_end_s += time.perf_counter() - t3

    def _commit_batch(self, b, res, fw, node_names, ok_rows) -> bool:
        """Host tail for one retired batch. Returns True when the session
        must invalidate (host/device divergence or host-path interleaving)."""
        invalidated = False
        for i, qpi in enumerate(b):
            row = int(res[0, i])
            self.next_start_node_index = int(res[1, i])
            if invalidated:
                self.host_path_pods += 1
                self.process_one(qpi)
                continue
            if row < 0:
                if self._fail_with_vector_diagnosis(fw, qpi):
                    # Without a nomination no state moved and the session
                    # continues; a preemption ends it.
                    invalidated = bool(qpi.pod.nominated_node_name)
                    continue
                # Exact host rerun for the diagnosis; the chain cannot go on.
                self.host_path_pods += 1
                self.process_one(qpi)
                invalidated = True
                continue
            if self._commit(fw, qpi, node_names[row]):
                ok_rows.append(row)
            else:
                invalidated = True  # the host rejected what the carry applied
        return invalidated

    def _fail_with_vector_diagnosis(self, fw: Framework, qpi: QueuedPodInfo) -> bool:
        """The FitError tail for a device-infeasible pod, with the Diagnosis
        built from the mirror's staging arrays, then PostFilter. False when
        the vectorized diagnosis cannot attribute the failure or pods are
        nominated (it does not model the two-pass filter): the host rerun
        owns those."""
        if self.queue.nominator.has_nominated_pods():
            return False
        self.cache.update_snapshot(self.snapshot)
        self.mirror.sync(self.snapshot.node_info_list)
        diag = diagnose_unschedulable(qpi.pod, self.mirror, self.snapshot, fw)
        if diag is None:
            return False
        self.attempts += 1
        self.handle_fit_error(fw, CycleState(), qpi,
                              FitError(qpi.pod, self.snapshot.num_nodes(), diag))
        return True

    # -- device preemption dry run -------------------------------------------

    def device_dry_run_preemption(self, fw: Framework, state, pod, node_to_status,
                                  num_candidates: int, start: int) -> Optional[List[Candidate]]:
        """Batched DryRunPreemption: every node's minimal victim set in one
        dry_run_preemption launch, in place of the host Evaluator's per-node
        loop (preemption.go:425). Returns the candidates in rotation order
        from `start`, at most `num_candidates`, skipping the nodes whose
        rejection no eviction resolves; or None where the exact host dry
        run decides by rule: a preemptor with spread or affinity terms, a
        cluster with anti-affinity pods (a victim's removal could lift
        them), a pod the kernels do not cover, no lower-priority pod at all,
        or a node with more than PREEMPT_K_CAP of them. A kernel that fails
        raises."""
        if self._resources_only_block(pod) is not None:
            return None
        self.cache.update_snapshot(self.snapshot)
        nodes = self.snapshot.node_info_list
        if any(ni.pods_with_required_anti_affinity for ni in nodes):
            return None
        self.mirror.sync(nodes)
        built = build_preemption_victims(pod, self.snapshot, self.mirror)
        if built is None:
            return None
        vic_req, vic_valid, potential = built
        try:
            dstate, plan = self.build_plan(fw, pod, 1)
        except Unsupported:
            return None
        r_slots = self.mirror.r_slots
        if vic_req.shape[2] != r_slots:
            # build_plan interned the preemptor's own new scalar slots after
            # the victims were built: no victim requests them, so zeros are
            # exact.
            grown = np.zeros(vic_req.shape[:2] + (r_slots,), np.int64)
            grown[:, :, :vic_req.shape[2]] = vic_req
            vic_req = grown
        res = dry_run_preemption(dstate, plan.features,
                                 torch.from_numpy(vic_req).to(self.device),
                                 torch.from_numpy(vic_valid).to(self.device),
                                 vic_valid.shape[1]).cpu().numpy()
        self.preemption_device_evals += 1
        feasible, vmask = res[:, 0], res[:, 1:]
        n = len(nodes)
        out = []
        for i in range(n):
            r = (start + i) % n
            st = node_to_status.get(nodes[r].name)
            if st is not None and st.code == UNSCHEDULABLE_AND_UNRESOLVABLE:
                continue  # nodesWherePreemptionMightHelp
            if feasible[r]:
                out.append(Candidate(nodes[r].name,
                                     [pi for j, pi in enumerate(potential[r]) if vmask[r, j]]))
                if len(out) >= num_candidates:
                    break
        return out

    def _commit(self, fw: Framework, qpi: QueuedPodInfo, node_name: str) -> bool:
        """assume → bind: the host tail of the scheduling cycle
        (schedule_one.go:315 onward). False when the host rejected it."""
        pod = qpi.pod
        self.attempts += 1
        pod.node_name = node_name
        self.cache.assume_pod(pod, qpi.pod_info)
        bound = self.run_binding_cycle(fw, CycleState(), qpi, node_name)
        self.queue.done(pod.uid)
        if bound:
            self.device_scheduled += 1
        return bound

    # -- run loop ------------------------------------------------------------

    def schedule_one(self) -> bool:
        t0 = time.perf_counter()
        fw, batch, fallback_reason = self._collect_batch()
        self.collect_s += time.perf_counter() - t0
        if not batch:
            return False
        if fallback_reason is None:
            self._run_device_session(fw, batch)
            return True
        for qpi in batch:
            self.host_path_pods += 1
            self.process_one(qpi)
        return True
