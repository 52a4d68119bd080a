"""The scheduler: run loop + the one-pod host scheduling cycle, trimmed to
the fit-only slice.

Re-expresses pkg/scheduler/schedule_one.go — the host path that the device
session (models/tpu_scheduler.py) also uses for pods it hands back:

    schedule_one → scheduling_cycle:
        Cache.update_snapshot                      (cache.go:206)
        find_nodes_that_fit_pod                    (schedule_one.go:630)
            run_pre_filter_plugins
            find_nodes_that_pass_filters           (:779, adaptive sampling
                                                    :866 + rotation :816)
        prioritize_nodes                           (:945)
        select_host      (first max in evaluation order: deterministic ties)
        assume                                     (:1060)
    binding cycle → bind                           (:141)
    failure → handle_scheduling_failure → requeue  (:1152)
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

from ..api.types import Pod
from .cache import Cache, Snapshot
from .clientset import FakeClientset
from .framework import (
    UNSCHEDULABLE,
    UNSCHEDULABLE_AND_UNRESOLVABLE,
    CycleState,
    Diagnosis,
    FitError,
    Framework,
    NodeScore,
    Status,
)
from .node_info import NodeInfo
from .queue import (
    EVENT_ASSIGNED_POD_ADD,
    EVENT_ASSIGNED_POD_DELETE,
    EVENT_NODE_ADD,
    EVENT_NODE_UPDATE,
    PriorityQueue,
    QueuedPodInfo,
)
from .registry import default_profile

MIN_FEASIBLE_NODES_TO_FIND = 100
MIN_FEASIBLE_NODES_PERCENTAGE_TO_FIND = 5


def num_feasible_nodes_to_find(num_all_nodes: int, percentage: int = 0) -> int:
    """schedule_one.go:866 — adaptive 5-50% sampling, floor 100. Shared by
    the host loop and the device kernels' sampling emulation."""
    if num_all_nodes < MIN_FEASIBLE_NODES_TO_FIND:
        return num_all_nodes
    if percentage > 0:
        pct = percentage
    else:
        pct = max(50 - num_all_nodes // 125, MIN_FEASIBLE_NODES_PERCENTAGE_TO_FIND)
    return max(num_all_nodes * pct // 100, MIN_FEASIBLE_NODES_TO_FIND)


@dataclass
class ScheduleResult:
    suggested_host: str = ""
    evaluated_nodes: int = 0
    feasible_nodes: int = 0


class Scheduler:
    def __init__(self, clientset: Optional[FakeClientset] = None,
                 percentage_of_nodes_to_score: int = 0,
                 now: Callable[[], float] = time.monotonic):
        self.clientset = clientset or FakeClientset()
        self.cache = Cache()
        self.snapshot = Snapshot()
        self.now = now
        self.percentage_of_nodes_to_score = percentage_of_nodes_to_score
        self.next_start_node_index = 0
        fw = default_profile(self.clientset)
        self.profiles = {fw.profile_name: fw}
        self.queue = PriorityQueue(fw, now=now)
        self.attempts = 0
        self.scheduled = 0
        self.failures = 0
        self.error_log: List[str] = []
        # Versions node-state-relevant cluster changes: a device session's
        # carry is only valid while this stays where the session began.
        self.cluster_event_seq = 0
        self.clientset.on_pod_event(self._on_pod_event)
        self.clientset.on_node_event(self._on_node_event)

    # -- event handlers (eventhandlers.go:624 addAllEventHandlers) ---------

    def _on_pod_event(self, kind: str, old: Optional[Pod], new: Pod) -> None:
        own_confirm = (kind == "update" and new.node_name
                       and self.cache.is_assumed_pod(new))
        if not own_confirm and not (kind == "add" and not new.node_name):
            # Pending-pod adds are queue-only and our own bind confirms are
            # already in the carry (via the assume); everything else moves
            # node state under a live device session.
            self.cluster_event_seq += 1
        if kind == "add":
            if new.node_name:
                self.cache.add_pod(new)
                self.queue.move_all_to_active_or_backoff(EVENT_ASSIGNED_POD_ADD, None, new)
            elif new.scheduler_name in self.profiles:
                self.queue.add(new)
        elif kind == "update":
            if new.node_name:
                if old is not None and not old.node_name:
                    self.cache.add_pod(new)
                    self.queue.move_all_to_active_or_backoff(EVENT_ASSIGNED_POD_ADD, None, new)
                else:
                    self.cache.update_pod(old, new)
            elif new.scheduler_name in self.profiles:
                self.queue.update(old, new)
        elif kind == "delete":
            if new.node_name:
                self.cache.remove_pod(new)
                self.queue.move_all_to_active_or_backoff(EVENT_ASSIGNED_POD_DELETE, new, None)
            else:
                self.queue.delete(new)

    def _on_node_event(self, kind: str, old, new) -> None:
        self.cluster_event_seq += 1
        if kind == "add":
            self.cache.add_node(new)
            self.queue.move_all_to_active_or_backoff(EVENT_NODE_ADD, None, new)
        elif kind == "update":
            self.cache.add_node(new)
            self.queue.move_all_to_active_or_backoff(EVENT_NODE_UPDATE, old, new)
        elif kind == "delete":
            self.cache.remove_node(new.name)

    def framework_for_pod(self, pod: Pod) -> Framework:
        return self.profiles[pod.scheduler_name]

    # -- run loop ----------------------------------------------------------

    def run_until_idle(self, max_cycles: int = 1_000_000) -> int:
        """Drive schedule_one until the queue drains (test/bench harness)."""
        n = 0
        while n < max_cycles:
            if not self.schedule_one():
                self.queue.flush_backoff_completed()
                if not self.schedule_one():
                    break
            n += 1
        return n

    def schedule_one(self) -> bool:
        qpi = self.queue.pop()
        if qpi is None:
            return False
        self.process_one(qpi)
        return True

    def process_one(self, qpi: QueuedPodInfo) -> None:
        """One full scheduling+binding cycle for an already-popped pod."""
        pod = qpi.pod
        if pod.deletion_ts is not None or pod.uid in self.cache.pod_states:
            # skipPodSchedule (schedule_one.go:93).
            self.queue.done(pod.uid)
            return
        fw = self.framework_for_pod(pod)
        self.attempts += 1
        state = CycleState()
        try:
            result = self.scheduling_cycle(fw, state, qpi)
        except FitError as fe:
            self.handle_fit_error(fw, qpi, fe)
            return
        except Exception as e:  # noqa: BLE001 - a failed cycle requeues the pod
            self.error_log.append(f"{pod.namespace}/{pod.name}: {e!r}")
            self.handle_scheduling_failure(fw, qpi, Status.error(str(e)), None)
            self.queue.done(pod.uid)
            return
        self.run_binding_cycle(fw, state, qpi, result.suggested_host)
        self.queue.done(pod.uid)

    def handle_fit_error(self, fw: Framework, qpi: QueuedPodInfo, fe: FitError) -> None:
        """The scheduling-cycle FitError tail (schedule_one.go:1152). The
        slice has no PostFilter plugin: preemption is out of scope."""
        self.handle_scheduling_failure(fw, qpi, Status(UNSCHEDULABLE, (str(fe),)), fe.diagnosis)
        self.queue.done(qpi.pod.uid)

    def scheduling_cycle(self, fw: Framework, state: CycleState,
                         qpi: QueuedPodInfo) -> ScheduleResult:
        pod = qpi.pod
        self.cache.update_snapshot(self.snapshot)
        result = self.schedule_pod(fw, state, pod)
        pod.node_name = result.suggested_host
        self.cache.assume_pod(pod, qpi.pod_info)
        return result

    def schedule_pod(self, fw: Framework, state: CycleState, pod: Pod) -> ScheduleResult:
        if self.snapshot.num_nodes() == 0:
            raise FitError(pod, 0, Diagnosis(pre_filter_msg="no nodes available"))
        feasible, diagnosis = self.find_nodes_that_fit_pod(fw, state, pod)
        if not feasible:
            raise FitError(pod, self.snapshot.num_nodes(), diagnosis)
        evaluated = len(feasible) + len(diagnosis.node_to_status)
        if len(feasible) == 1:
            return ScheduleResult(feasible[0].name, evaluated, 1)
        host = self.select_host(self.prioritize_nodes(fw, state, pod, feasible))
        return ScheduleResult(host, evaluated, len(feasible))

    def find_nodes_that_fit_pod(self, fw: Framework, state: CycleState,
                                pod: Pod) -> Tuple[List[NodeInfo], Diagnosis]:
        diagnosis = Diagnosis()
        all_nodes = self.snapshot.node_info_list
        pre_res, st = fw.run_pre_filter_plugins(state, pod, all_nodes)
        if not st.is_success():
            if st.is_rejected():
                diagnosis.pre_filter_msg = st.message()
                diagnosis.unschedulable_plugins.add(st.plugin)
                return [], diagnosis
            raise RuntimeError(f"prefilter failed: {st.message()}")
        nodes = all_nodes
        if pre_res is not None and not pre_res.all_nodes():
            # Preserve snapshot order (rotation parity over the narrowed list).
            nodes = [ni for ni in all_nodes if ni.name in pre_res.node_names]
        return self.find_nodes_that_pass_filters(fw, state, pod, diagnosis, nodes), diagnosis

    def find_nodes_that_pass_filters(self, fw: Framework, state: CycleState, pod: Pod,
                                     diagnosis: Diagnosis,
                                     nodes: Sequence[NodeInfo]) -> List[NodeInfo]:
        num_nodes = len(nodes)
        to_find = num_feasible_nodes_to_find(num_nodes, self.percentage_of_nodes_to_score)
        feasible: List[NodeInfo] = []
        start = self.next_start_node_index % max(1, num_nodes)
        evaluated = 0
        for i in range(num_nodes):
            ni = nodes[(start + i) % num_nodes]
            evaluated += 1
            st = fw.run_filter_plugins(state, pod, ni)
            if st.is_success():
                feasible.append(ni)
                if len(feasible) >= to_find:
                    break
            else:
                diagnosis.node_to_status[ni.name] = st
                if st.plugin:
                    diagnosis.unschedulable_plugins.add(st.plugin)
        self.next_start_node_index = (start + evaluated) % max(1, num_nodes)
        return feasible

    def prioritize_nodes(self, fw: Framework, state: CycleState, pod: Pod,
                         nodes: Sequence[NodeInfo]) -> List[NodeScore]:
        st = fw.run_pre_score_plugins(state, pod, nodes)
        if not st.is_success():
            raise RuntimeError(f"prescore failed: {st.message()}")
        total = [NodeScore(ni.name, 0) for ni in nodes]
        for scores in fw.run_score_plugins(state, pod, nodes).values():
            for i, ns in enumerate(scores):
                total[i].score += ns.score
        return total

    @staticmethod
    def select_host(node_scores: List[NodeScore]) -> str:
        """First max-score node in evaluation order: the deterministic form
        of schedule_one.go selectHost, which the device selection matches."""
        best = node_scores[0]
        for ns in node_scores[1:]:
            if ns.score > best.score:
                best = ns
        return best.name

    # -- binding cycle (schedule_one.go:141 runBindingCycle) ---------------

    def run_binding_cycle(self, fw: Framework, state: CycleState,
                          qpi: QueuedPodInfo, node_name: str) -> bool:
        """Returns True iff the pod was bound (False: unwound + requeued)."""
        pod = qpi.pod
        st = fw.run_bind_plugins(state, pod, node_name)
        if not st.is_success():
            # handleBindingCycleError (schedule_one.go:507).
            self.cache.forget_pod(pod)
            pod.node_name = ""
            self.queue.move_all_to_active_or_backoff(EVENT_ASSIGNED_POD_DELETE, pod, None)
            self.handle_scheduling_failure(fw, qpi, st, None)
            return False
        self.scheduled += 1
        return True

    def handle_scheduling_failure(self, fw: Framework, qpi: QueuedPodInfo,
                                  status: Status, diagnosis: Optional[Diagnosis]) -> None:
        self.failures += 1
        if diagnosis is not None:
            qpi.unschedulable_plugins |= diagnosis.unschedulable_plugins
        if status.code == UNSCHEDULABLE_AND_UNRESOLVABLE and not qpi.unschedulable_plugins:
            qpi.unschedulable_plugins.add(status.plugin or "unknown")
        self.queue.add_unschedulable_if_not_present(qpi)
