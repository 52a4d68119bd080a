"""TorchScheduler — the scheduler with the fit-only hot path on an NVIDIA
GPU (the port of the JAX package's TPUScheduler, trimmed to the slice).

Control flow:

    pop → a row-block of consecutive same-signature pods (up to max_batch)
        → Cache.update_snapshot (host, incremental)
        → NodeStateMirror.sync/flush (device, dirty-row scatter)
        → build_batch (per-batch features, once per session)
        → ops.kernel.schedule_batch (the whole greedy assignment of the
          block on the device: static masks, fit/score evaluation, sampling
          emulation, selection, carry updates)
        → per pod: assume → bind (host, unchanged semantics)

Consecutive batches of one session chain through the device carry, and up
to `pipeline_depth` batches are in flight: the host commits batch N while
the device computes batch N+1. Each batch's results come back through a
non-blocking copy into pinned host memory, fenced by a CUDA event.

Pods the kernels do not cover (matchFields narrowing) and pods a session
hands back take the host path in core/scheduler.py, which produces the same
assignments.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.framework import CycleState, FitError, Framework
from ..core.queue import QueuedPodInfo
from ..core.scheduler import Scheduler
from ..ops.device_state import NodeStateMirror
from ..ops.features import batch_supported, build_batch, diagnose_unschedulable
from ..ops.kernel import schedule_batch

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
                    and fw.sign_pod(nxt.pod) == sig and batch_supported(nxt.pod) is None):
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
        reason = batch_supported(head.pod)
        sig = fw.sign_pod(head.pod) if reason is None else None
        if sig is None:
            return fw, [head], reason or "unsignable pod"
        return fw, self._collect_session_batch(fw, sig, [head]), None

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
        plan = build_batch(
            pod, batch_size, self.mirror, self.snapshot,
            percentage_of_nodes_to_score=self.percentage_of_nodes_to_score,
            start_index=self.next_start_node_index,
            weights=self._profile_weights(fw), filters_on=self._profile_filters(fw),
            fit_plugin=fw.plugin("NodeResourcesFit"))
        return self.mirror.flush(), plan

    def _dispatch(self, state, plan, n_active: int, carry):
        """The only kernel call site (warm and live dispatches alike)."""
        return schedule_batch(state, plan.features, plan.batch_pad, plan.fit_strategy,
                              plan.vmax, n_active=n_active, carry_in=carry,
                              has_pns=plan.has_pns, has_ipa_base=False)

    def warm_for(self, pod) -> None:
        """Build the kernels and run both the fresh-carry and the chained
        dispatch of a `pod`-shaped session with no active pods (fully
        inert), so that set-up lands outside a measured window."""
        fw = self.framework_for_pod(pod)
        if batch_supported(pod) is not None:
            return
        state, plan = self.build_plan(fw, pod, self.max_batch)
        _results, carry = self._dispatch(state, plan, 0, None)
        results, _ = self._dispatch(state, plan, 0, carry)
        _Fetch(results).wait()

    # -- device session ------------------------------------------------------

    def _run_device_session(self, fw: Framework, first_batch: List[QueuedPodInfo]) -> None:
        sig = fw.sign_pod(first_batch[0].pod)
        t0 = time.perf_counter()
        state, plan = self.build_plan(fw, first_batch[0].pod, self.max_batch)
        self.plan_build_s += time.perf_counter() - t0
        node_names = [ni.name for ni in self.snapshot.node_info_list]
        start_seq = self.cluster_event_seq
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
                # Any cluster change the carry does not hold ends the chain.
                invalidated = invalidated or self.cluster_event_seq != start_seq
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
                    continue  # no state moved: the session continues
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
        built from the mirror's staging arrays. False when the vectorized
        diagnosis cannot attribute the failure (the host rerun owns it)."""
        self.cache.update_snapshot(self.snapshot)
        self.mirror.sync(self.snapshot.node_info_list)
        diag = diagnose_unschedulable(qpi.pod, self.mirror, self.snapshot, fw)
        if diag is None:
            return False
        self.attempts += 1
        self.handle_fit_error(fw, qpi, FitError(qpi.pod, self.snapshot.num_nodes(), diag))
        return True

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
