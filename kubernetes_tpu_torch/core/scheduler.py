"""The scheduler: run loop + the one-pod host scheduling cycle, trimmed to
the port's plugins.

Re-expresses pkg/scheduler/schedule_one.go — the host path that the device
session (models/tpu_scheduler.py) also uses for pods it hands back:

    schedule_one → scheduling_cycle:
        Cache.update_snapshot                      (cache.go:206)
        find_nodes_that_fit_pod                    (schedule_one.go:630)
            run_pre_filter_plugins
            nominated-node fast path               (:722)
            find_nodes_that_pass_filters           (:779, adaptive sampling
                                                    :866 + rotation :816;
                                                    two-pass filter with the
                                                    nominated pods)
        prioritize_nodes                           (:945)
        select_host      (first max in evaluation order: deterministic ties)
        assume                                     (:1060)
        Reserve → Permit (WAIT parks the pod)       (:315-340)
    binding cycle → PreBindPreFlight → PreBind → bind   (:141)
    failure → PostFilter (DefaultPreemption) → nomination
            → handle_scheduling_failure → requeue  (:169, :1152)

and the pod-group cycle (schedule_one_podgroup.go; the JAX package's
core/scheduler.py:1020-1400): a group scheduled by the default algorithm
places its members one by one against the snapshot (assumed into the
snapshot only) and commits all or none; a topology-constrained group under
a profile with placement plugins runs the placement algorithm — candidate
placements generated, the group simulated against each with the visible
node list restricted to it, the feasible ones scored and the best
committed. A group that cannot schedule gets PodGroupPostFilter (pod-group
preemption) and parks.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..api.types import Pod
from .cache import (
    EV_NAMESPACE,
    EV_NODE_UPDATE,
    EV_OTHER,
    EV_POD_ADD,
    EV_POD_REMOVE,
    EV_POD_UPDATE,
    EV_QUEUE,
    EV_STRUCTURAL,
    Cache,
    EventJournal,
    Snapshot,
    pod_event_flags,
)
from .clientset import FakeClientset
from .framework import (
    UNSCHEDULABLE,
    UNSCHEDULABLE_AND_UNRESOLVABLE,
    WAIT,
    CycleState,
    Diagnosis,
    FitError,
    Framework,
    NodeScore,
    Placement,
    PlacementProgress,
    PodGroupAssignments,
    Status,
)
from .node_info import NodeInfo
from .podgroupstate import PodGroupState
from .queue import (
    EVENT_ASSIGNED_POD_ADD,
    EVENT_ASSIGNED_POD_DELETE,
    EVENT_NODE_ADD,
    EVENT_NODE_UPDATE,
    EVENT_STORAGE_ADD,
    PriorityQueue,
    QueuedPodGroupInfo,
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
    waiting: bool = False  # a Permit plugin returned WAIT


class Handle:
    """framework.Handle (interface.go:844), the subset the plugins read."""

    def __init__(self, scheduler: "Scheduler"):
        self._scheduler = scheduler
        self.clientset = scheduler.clientset

    def snapshot(self) -> Snapshot:
        return self._scheduler.snapshot

    def namespace_labels(self, name: str):
        return self._scheduler.cache.namespace_labels(name)

    @property
    def nominator(self):
        return self._scheduler.queue.nominator

    @property
    def pod_group_state(self):
        return self._scheduler.pod_group_state

    # the storage listers (plugins/volumes.py)
    @property
    def pvs(self):
        return self.clientset.pvs

    @property
    def pvcs(self):
        return self.clientset.pvcs

    @property
    def storage_classes(self):
        return self.clientset.storage_classes

    @property
    def csi_nodes(self):
        return self.clientset.csi_nodes

    # the DRA listers (plugins/dynamicresources.py)
    @property
    def resource_slices(self):
        return self.clientset.resource_slices

    @property
    def resource_claims(self):
        return self.clientset.resource_claims

    @property
    def device_classes(self):
        return self.clientset.device_classes

    def allow_waiting_pod(self, uid: str) -> bool:
        return self._scheduler.allow_waiting_pod(uid)

    def simulate_pod_group(self, group, members) -> bool:
        """Pod-group preemption's feasibility probe: would the group
        schedule against the snapshot as it stands, by the algorithm a real
        cycle would use? Leaves the snapshot unchanged."""
        return self._scheduler.group_feasible(group, members)

    def device_dry_run_preemption(self, fw, state, pod, node_to_status,
                                  num_candidates: int, start: int):
        """The batched DryRunPreemption where the scheduler has a device
        (models/tpu_scheduler.py); None sends the Evaluator to its exact
        per-node host loop."""
        fn = getattr(self._scheduler, "device_dry_run_preemption", None)
        if fn is None:
            return None
        return fn(fw, state, pod, node_to_status, num_candidates, start)


class Scheduler:
    """`profile_factory(handle)` builds the one profile (core/registry.py:
    default_profile, or gang_placement_profile for the pod-group placement
    plugins)."""

    def __init__(self, clientset: Optional[FakeClientset] = None,
                 percentage_of_nodes_to_score: int = 0,
                 now: Callable[[], float] = time.monotonic,
                 profile_factory: Callable[[Handle], Framework] = default_profile):
        self.clientset = clientset or FakeClientset()
        self.cache = Cache()
        self.snapshot = Snapshot()
        self.now = now
        self.percentage_of_nodes_to_score = percentage_of_nodes_to_score
        self.next_start_node_index = 0
        # Group members the cache holds placed (assumed or bound): placement
        # generation pins a partly scheduled gang's domain with it.
        self.pod_group_state = PodGroupState()
        self.cache.pod_group_state = self.pod_group_state
        # Pods parked at Permit WAIT: uid -> (fw, state, qpi, result,
        # deadline); expiry is checked each host cycle (O(1)) and when the
        # loop idles.
        self.waiting_pods: Dict[str, tuple] = {}
        self.permit_wait_timeout = 60.0
        self._next_wait_deadline = float("inf")
        # Cache unwinds outside a scheduling attempt (a bind failure, a
        # waiter rejected): a device session or saved plan from before one
        # no longer reflects the cache.
        self.state_unwinds = 0
        fw = profile_factory(Handle(self))
        self.profiles = {fw.profile_name: fw}
        self.queue = PriorityQueue(fw, now=now)
        self.attempts = 0
        self.scheduled = 0
        self.failures = 0
        self.error_log: List[str] = []
        # The typed journal of node-state-relevant cluster changes; its seq
        # is the cluster-event version (cluster_event_seq) that a device
        # session's plan and carry are valid against.
        self.journal = EventJournal()
        # Watch events raised off the scheduling thread wait here until the
        # loop replays them (_threaded): deque append/popleft are atomic.
        self._event_inbox: deque = deque()
        self.clientset.on_pod_event(self._threaded(self._on_pod_event))
        self.clientset.on_node_event(self._threaded(self._on_node_event))
        self.clientset.on_namespace_event(self._threaded(self._on_namespace_event))
        self.clientset.on_pod_group_event(self._threaded(self._on_pod_group_event))
        self.clientset.on_storage_event(self._threaded(self._on_storage_event))

    @property
    def cluster_event_seq(self) -> int:
        return self.journal.seq

    # -- event handlers (eventhandlers.go:624 addAllEventHandlers) ---------

    def _record_event(self, kind: str, key: str = "", pod_plain: bool = False,
                      pod_ports: bool = False, shrink: bool = False) -> None:
        """Journal one typed event (advances cluster_event_seq)."""
        self.journal.record(kind, key, pod_plain=pod_plain, pod_ports=pod_ports, shrink=shrink)

    def _threaded(self, handler):
        """Watch events raised off the scheduling thread are parked in an
        inbox and replayed by the scheduling loop (the DeltaFIFO seam of
        client-go delta_fifo.go): cache and queue mutation stay on one
        thread. Events raised on the scheduling thread dispatch inline."""
        loop_ident = threading.get_ident()

        def dispatch(*args):
            if threading.get_ident() == loop_ident:
                handler(*args)
            else:
                self._event_inbox.append((handler, args))
        return dispatch

    def drain_event_inbox(self) -> int:
        """Replay parked off-thread watch events on the scheduling loop."""
        n = 0
        while self._event_inbox:
            try:
                handler, args = self._event_inbox.popleft()
            except IndexError:
                break
            handler(*args)
            n += 1
        return n

    def _on_pod_event(self, kind: str, old: Optional[Pod], new: Pod) -> None:
        # Pending-pod adds are queue-only and our own bind confirms are
        # already in the carry (via the assume): neither is journaled.
        own_confirm = (kind == "update" and new.node_name
                       and self.cache.is_assumed_pod(new))
        if not own_confirm and not (kind == "add" and not new.node_name):
            self._record_pod_event(kind, old, new)
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

    def _record_pod_event(self, kind: str, old: Optional[Pod], new: Pod) -> None:
        """Journal classification of a pod event that moves node state (or
        a pending pod's queue entry)."""
        plain, ports = pod_event_flags(new)
        if old is not None and old is not new:
            oplain, oports = pod_event_flags(old)
            plain, ports = plain and oplain, ports or oports
        if kind == "add":
            self._record_event(EV_POD_ADD, new.node_name, pod_plain=plain, pod_ports=ports)
        elif kind == "update":
            old_node = old.node_name if old is not None else ""
            if not new.node_name:
                # A pending pod's spec update: queue-only.
                self._record_event(EV_QUEUE, new.uid)
            elif not old_node:
                # Someone else's bind: load appears on the node as an add.
                self._record_event(EV_POD_ADD, new.node_name, pod_plain=plain, pod_ports=ports)
            elif old_node == new.node_name:
                self._record_event(EV_POD_UPDATE, new.node_name, pod_plain=plain,
                                   pod_ports=ports)
            else:  # moved: the old row shrinks, the new row grows
                self._record_event(EV_POD_REMOVE, old_node, pod_plain=plain, pod_ports=ports,
                                   shrink=True)
                self._record_event(EV_POD_ADD, new.node_name, pod_plain=plain, pod_ports=ports)
        elif kind == "delete":
            if new.node_name:
                self._record_event(EV_POD_REMOVE, new.node_name, pod_plain=plain,
                                   pod_ports=ports, shrink=True)
            else:
                self._record_event(EV_QUEUE, new.uid)
        else:
            self._record_event(EV_OTHER, new.uid)

    @staticmethod
    def _node_shrink_only(old, new) -> bool:
        """True when `new` can only enlarge feasibility against `old`: no
        taint added, allocatable not reduced, unschedulable not switched on."""
        if new.unschedulable and not old.unschedulable:
            return False
        o_t = {(t.key, t.value, t.effect) for t in old.taints}
        if any((t.key, t.value, t.effect) not in o_t for t in new.taints):
            return False
        oa, na = old.allocatable, new.allocatable
        if (na.milli_cpu < oa.milli_cpu or na.memory < oa.memory
                or na.ephemeral_storage < oa.ephemeral_storage
                or na.allowed_pod_number < oa.allowed_pod_number):
            return False
        return all(na.scalar_resources.get(k, 0) >= v for k, v in oa.scalar_resources.items())

    def _on_node_event(self, kind: str, old, new) -> None:
        if (kind == "update" and old is not None and old.name == new.name
                and old.labels == new.labels and old.images == new.images
                and old.declared_features == new.declared_features):
            # Taints, allocatable or the unschedulable flag only: one row's
            # non-feature tensors, delta-patchable by a live session (labels,
            # images and declared features feed the plan's static tables).
            self._record_event(EV_NODE_UPDATE, new.name,
                               shrink=self._node_shrink_only(old, new))
        elif kind == "update":
            self._record_event(EV_OTHER, new.name)
        else:
            self._record_event(EV_STRUCTURAL, new.name)
        if kind == "add":
            self.cache.add_node(new)
            self.queue.move_all_to_active_or_backoff(EVENT_NODE_ADD, None, new)
        elif kind == "update":
            self.cache.add_node(new)
            self.queue.move_all_to_active_or_backoff(EVENT_NODE_UPDATE, old, new)
        elif kind == "delete":
            self.cache.remove_node(new.name)

    def _on_namespace_event(self, ns) -> None:
        # Namespace labels feed namespaceSelector matching.
        self._record_event(EV_NAMESPACE, ns.name)
        self.cache.add_namespace(ns)

    def _on_pod_group_event(self, group) -> None:
        # Queue-only: a group's arrival can activate its buffered members.
        self._record_event(EV_QUEUE, f"{group.namespace}/{group.name}")
        self.queue.register_pod_group(group)

    def _on_storage_event(self, kind: str, obj) -> None:
        # Only storage objects that change what a node offers (CSINode
        # limits, device pools, PV topology, binding modes) can make a
        # device session's plan stale. A claim (a PVC or a ResourceClaim)
        # is pod-side state: it unblocks waiting pods but changes no
        # decision already made, and journaling each claim a measured pod
        # creates would end a session a pod.
        if kind not in ("pvc", "resource_claim"):
            self._record_event(EV_OTHER, kind)
        self.queue.move_all_to_active_or_backoff(EVENT_STORAGE_ADD, None, obj)

    def framework_for_pod(self, pod: Pod) -> Framework:
        return self.profiles[pod.scheduler_name]

    def preemption_counts(self) -> Dict[str, int]:
        """DefaultPreemption's counters over the profiles: PostFilter
        attempts, victims evicted, and device dry-run candidates that the
        host verification refuted."""
        out = {"attempts": 0, "victims": 0, "verify_divergences": 0}
        for fw in self.profiles.values():
            p = fw.plugin("DefaultPreemption")
            for k in out:
                out[k] += getattr(p, k)
        return out

    # -- run loop ----------------------------------------------------------

    def run_until_idle(self, max_cycles: int = 1_000_000) -> int:
        """Drive schedule_one until the queue drains (test/bench harness)."""
        n = 0
        while n < max_cycles:
            if not self.schedule_one():
                self.queue.flush_backoff_completed()
                self.flush_expired_waiters()
                self.drain_event_inbox()
                if not self.schedule_one():
                    break
            n += 1
        return n

    def schedule_one(self) -> bool:
        if self.waiting_pods and self.now() >= self._next_wait_deadline:
            self.flush_expired_waiters()
        qpi = self.queue.pop()
        if qpi is None:
            return False
        self.process_one(qpi)
        return True

    def process_one(self, qpi) -> None:
        """One full scheduling+binding cycle for an already-popped entity."""
        if isinstance(qpi, QueuedPodGroupInfo):
            self.schedule_pod_group(qpi)
            return
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
            self.handle_fit_error(fw, state, qpi, fe)
            return
        except Exception as e:  # noqa: BLE001 - a failed cycle requeues the pod
            self.error_log.append(f"{pod.namespace}/{pod.name}: {e!r}")
            self.handle_scheduling_failure(fw, qpi, Status.error(str(e)), None)
            self.queue.done(pod.uid)
            return
        if result.waiting:
            # WaitOnPermit (framework.go:2097): the pod stays assumed until
            # a Permit plugin allows or rejects it, or the wait times out.
            self.park_waiting_pod(fw, state, qpi, result)
            self.queue.done(pod.uid)
            return
        self.run_binding_cycle(fw, state, qpi, result.suggested_host)
        self.queue.done(pod.uid)

    def handle_fit_error(self, fw: Framework, state: CycleState, qpi: QueuedPodInfo,
                         fe: FitError) -> None:
        """The scheduling-cycle FitError tail (schedule_one.go:169, :1152):
        PostFilter (DefaultPreemption) with the diagnosis, the nomination it
        makes recorded in the pod, its status and the nominator, then the
        requeue."""
        pod = qpi.pod
        result, st = fw.run_post_filter_plugins(state, pod, fe.diagnosis.node_to_status)
        nominated = result.nominating_info if result is not None else None
        if st.is_success() and nominated:
            pod.nominated_node_name = nominated
            self.clientset.patch_pod_status(pod, nominated_node_name=nominated)
            self.queue.nominator.add_nominated_pod(qpi.pod_info, nominated)
        self.handle_scheduling_failure(fw, qpi, Status(UNSCHEDULABLE, (str(fe),)), fe.diagnosis)
        self.queue.done(qpi.pod.uid)

    def scheduling_cycle(self, fw: Framework, state: CycleState,
                         qpi: QueuedPodInfo) -> ScheduleResult:
        pod = qpi.pod
        self.cache.update_snapshot(self.snapshot)
        result = self.schedule_pod(fw, state, pod)
        pod.node_name = host = result.suggested_host
        self.cache.assume_pod(pod, qpi.pod_info)
        st = fw.run_reserve_plugins_reserve(state, pod, host)
        if not st.is_success():
            fw.run_reserve_plugins_unreserve(state, pod, host)
            self.cache.forget_pod(pod)
            pod.node_name = ""
            raise RuntimeError(f"reserve failed: {st.message()}")
        st = fw.run_permit_plugins(state, pod, host)
        if st.is_rejected():
            fw.run_reserve_plugins_unreserve(state, pod, host)
            self.cache.forget_pod(pod)
            pod.node_name = ""
            raise RuntimeError(f"permit rejected: {st.message()}")
        if st.code == WAIT:
            result.waiting = True  # parked in waiting_pods; binds on Allow
        return result

    # -- the pod-group cycle (schedule_one_podgroup.go) ----------------------

    def schedule_pod_group(self, qgpi: QueuedPodGroupInfo) -> None:
        """scheduleOnePodGroup (:81): the placement algorithm for a
        topology-constrained group under a profile with placement plugins
        (:971), else the default algorithm (:556): members placed one by one
        against the snapshot (assumed into the snapshot only), the snapshot
        reverted LIFO on any failure, else every member committed with its
        own simulation CycleState."""
        self.attempts += 1
        members = sorted(qgpi.members, key=lambda m: (-m.pod.priority, m.timestamp))
        if not members:
            self.queue.done(qgpi.uid)
            return
        fw = self.framework_for_pod(members[0].pod)
        self.cache.update_snapshot(self.snapshot)
        group = qgpi.group
        if fw.placement_generate_plugins and group.topology_keys:
            # Only the placement algorithm may place a constrained group:
            # member-wise placement would break the constraint.
            self._schedule_group_with_placements(fw, qgpi, members)
            return
        placed: List[Tuple[QueuedPodInfo, CycleState, ScheduleResult]] = []
        failure: Optional[FitError] = None
        for m in members:
            state = CycleState()
            try:
                result = self.schedule_pod(fw, state, m.pod)
            except FitError as fe:
                failure = fe
                qgpi.unschedulable_plugins |= fe.diagnosis.unschedulable_plugins
                break
            m.pod.node_name = result.suggested_host
            self.snapshot.assume_pod(m.pod)
            placed.append((m, state, result))
        if failure is not None:
            for m, _state, _result in reversed(placed):
                self.snapshot.forget_pod(m.pod)
                m.pod.node_name = ""
            self._fail_pod_group(fw, qgpi, members, failure.diagnosis)
            return
        # submitPodGroupAlgorithmResult (:812): every attempted member leaves
        # the group buffer; a member whose commit fails requeues on its own.
        attempted = set()
        for m, state, result in placed:
            attempted.add(m.pod.uid)
            self.cache.assume_pod(m.pod)
            self._commit_group_member(fw, m, state, result)
        self.queue.clear_group_members((group.namespace, group.name), attempted)
        self.queue.done(qgpi.uid)

    def _schedule_group_with_placements(self, fw: Framework, qgpi: QueuedPodGroupInfo,
                                        members: List[QueuedPodInfo]) -> None:
        """podGroupSchedulingPlacementAlgorithm (:971) and
        findBestPodGroupPlacement (:1173): generate the candidate
        placements, evaluate each, score the feasible ones and commit the
        best (the first of equal totals), or park the group ("0/N placements
        are available")."""
        group = qgpi.group
        pg_state = CycleState()
        parent = Placement("", [ni.name for ni in self.snapshot.node_info_list])
        placements, st = fw.run_placement_generate_plugins(pg_state, group, members, parent)
        if not st.is_success() or not placements:
            self._fail_pod_group(fw, qgpi, members, None)
            return
        start_save = self.next_start_node_index
        candidates = self._evaluate_placements(fw, pg_state, group, members, placements)
        self.next_start_node_index = start_save
        if not candidates:
            self._fail_pod_group(fw, qgpi, members, None)
            return
        totals = fw.run_placement_score_plugins(pg_state, group,
                                                [pga for _p, _a, pga in candidates])
        best = max(range(len(totals)), key=lambda i: (totals[i], -i))
        best_placement, assignment, _pga = candidates[best]
        # Commit the winner; members it could not fit requeue one by one.
        # Each member keeps the CycleState of the winning simulation.
        attempted = set()
        for m in members:
            attempted.add(m.pod.uid)
            entry = assignment.get(m.pod.uid)
            if entry is None:
                self.handle_scheduling_failure(fw, m, Status.unschedulable(
                    f"did not fit placement {best_placement.name!r}"), None)
                continue
            node, m_state = entry
            m.pod.node_name = node
            self.cache.assume_pod(m.pod, m.pod_info)
            self._commit_group_member(fw, m, m_state, ScheduleResult(suggested_host=node))
        self.queue.clear_group_members((group.namespace, group.name), attempted)
        self.queue.done(qgpi.uid)

    def _evaluate_placements(self, fw: Framework, pg_state: CycleState, group,
                             members: List[QueuedPodInfo], placements) -> List[tuple]:
        """Evaluate every candidate placement one by one; returns the
        feasible ones as (placement, {uid: (node, CycleState)},
        PodGroupAssignments). TorchScheduler evaluates them all in one
        kernel launch instead (ops/kernel.py schedule_placements)."""
        candidates: List[tuple] = []
        for placement in placements:
            assignment = self._evaluate_placement(fw, pg_state, group, members, placement)
            if assignment is not None:
                candidates.append((placement, assignment, PodGroupAssignments(
                    placement,
                    proposed=[(m.pod, assignment[m.pod.uid][0]) for m in members
                              if m.pod.uid in assignment],
                    nodes=[self.snapshot.get(n) for n in placement.node_names])))
        return candidates

    def _evaluate_placement(self, fw: Framework, pg_state: CycleState, group,
                            members: List[QueuedPodInfo], placement) -> Optional[Dict[str, tuple]]:
        """Simulate the group against one placement, the visible node list
        restricted to it. {uid: (node, CycleState)} when PlacementFeasible
        passes, else None; the snapshot is always restored. Each simulation
        evaluates its whole candidate (no adaptive truncation) from rotation
        origin 0: the spec the device evaluation shares, so the two agree
        exactly."""
        self.snapshot.assume_placement(placement.node_names)
        self.next_start_node_index = 0
        pct_save = self.percentage_of_nodes_to_score
        self.percentage_of_nodes_to_score = 100
        placed: List[Tuple[QueuedPodInfo, CycleState]] = []
        failed = 0
        try:
            for m in members:
                m_state = CycleState()
                try:
                    result = self.schedule_pod(fw, m_state, m.pod)
                except FitError:
                    failed += 1
                    continue
                m.pod.node_name = result.suggested_host
                self.snapshot.assume_pod(m.pod)
                placed.append((m, m_state))
            progress = PlacementProgress(len(placed), failed, len(members))
            feasible = bool(placed) and fw.run_placement_feasible_plugins(
                pg_state, group, progress).is_success()
            assignment = {m.pod.uid: (m.pod.node_name, st) for m, st in placed}
        finally:
            for m, _st in reversed(placed):
                self.snapshot.forget_pod(m.pod)
                m.pod.node_name = ""
            self.snapshot.forget_placement()
            self.percentage_of_nodes_to_score = pct_save
        return assignment if feasible else None

    def group_feasible(self, group, members: List[QueuedPodInfo]) -> bool:
        """Would the group schedule now, by the algorithm a real cycle would
        use (a constrained group must fit some candidate placement)? The
        probe behind pod-group preemption; the snapshot is left as it was."""
        if not members:
            return False
        fw = self.framework_for_pod(members[0].pod)
        start_save = self.next_start_node_index
        try:
            if fw.placement_generate_plugins and group.topology_keys:
                pg_state = CycleState()
                parent = Placement("", [ni.name for ni in self.snapshot.node_info_list])
                placements, st = fw.run_placement_generate_plugins(pg_state, group, members,
                                                                   parent)
                return st.is_success() and any(
                    self._evaluate_placement(fw, pg_state, group, members, pl) is not None
                    for pl in placements)
            placed: List[QueuedPodInfo] = []
            try:
                for m in members:
                    try:
                        result = self.schedule_pod(fw, CycleState(), m.pod)
                    except FitError:
                        return False
                    m.pod.node_name = result.suggested_host
                    self.snapshot.assume_pod(m.pod)
                    placed.append(m)
                return True
            finally:
                for m in reversed(placed):
                    self.snapshot.forget_pod(m.pod)
                    m.pod.node_name = ""
        finally:
            self.next_start_node_index = start_save

    def _commit_group_member(self, fw: Framework, m: QueuedPodInfo, state: CycleState,
                             result: ScheduleResult) -> bool:
        """Reserve → Permit → binding cycle for a member already assumed
        into the cache with its node set. True when it is committed (bound,
        or parked at Permit WAIT)."""
        node = result.suggested_host
        st = fw.run_reserve_plugins_reserve(state, m.pod, node)
        if st.is_success():
            st = fw.run_permit_plugins(state, m.pod, node)
        if st.code == WAIT:
            self.park_waiting_pod(fw, state, m, result)
            return True
        if not st.is_success():
            fw.run_reserve_plugins_unreserve(state, m.pod, node)
            self.cache.forget_pod(m.pod)
            m.pod.node_name = ""
            self.handle_scheduling_failure(fw, m, st, None)
            return False
        return self.run_binding_cycle(fw, state, m, node)

    def _fail_pod_group(self, fw: Framework, qgpi: QueuedPodGroupInfo,
                        members: List[QueuedPodInfo], diagnosis) -> None:
        """The group-unschedulable tail of both algorithms: PodGroupPostFilter
        (framework.go:1212, pod-group preemption), then the group parks."""
        if fw.pod_group_post_filter_plugins:
            _result, st = fw.run_pod_group_post_filter_plugins(
                CycleState(), qgpi.group, members, diagnosis)
            if st.is_success():
                qgpi.timestamp = self.now()
                self.queue.add_unschedulable_if_not_present(qgpi)
                self.queue.done(qgpi.uid)
                return
        self.failures += 1
        qgpi.timestamp = self.now()
        self.queue.add_unschedulable_if_not_present(qgpi)
        self.queue.done(qgpi.uid)

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
        if pod.nominated_node_name:
            # Nominated-node fast path (schedule_one.go:722): the node a
            # preemption nominated is evaluated first.
            ni = self.snapshot.get(pod.nominated_node_name)
            if ni is not None and fw.run_filter_plugins_with_nominated_pods(
                    state, pod, ni, self.queue.nominator).is_success():
                return [ni], diagnosis
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
            st = fw.run_filter_plugins_with_nominated_pods(state, pod, ni, self.queue.nominator)
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
        if fw.pre_bind_plugins:
            # PreBindPreFlight (framework.go:1875): PreBind plugins with no
            # work for this pod are skipped, and all skipping bypasses it.
            st = fw.run_pre_bind_pre_flight(state, pod, node_name)
            if not st.is_skip():
                if st.is_success():
                    st = fw.run_pre_bind_plugins(state, pod, node_name)
                if not st.is_success():
                    self._unwind_binding(fw, state, qpi, node_name, st)
                    return False
        st = fw.run_bind_plugins(state, pod, node_name)
        if not st.is_success():
            self._unwind_binding(fw, state, qpi, node_name, st)
            return False
        self.queue.nominator.delete_nominated_pod(pod)
        self.scheduled += 1
        if fw.post_bind_plugins:
            fw.run_post_bind_plugins(state, pod, node_name)
        return True

    def _unwind_binding(self, fw: Framework, state: CycleState, qpi: QueuedPodInfo,
                        node_name: str, st: Status) -> None:
        """handleBindingCycleError (schedule_one.go:507): a failed PreBind or
        bind unreserves, forgets the assumed pod and requeues it."""
        pod = qpi.pod
        self.state_unwinds += 1
        fw.run_reserve_plugins_unreserve(state, pod, node_name)
        self.cache.forget_pod(pod)
        pod.node_name = ""
        self.queue.move_all_to_active_or_backoff(EVENT_ASSIGNED_POD_DELETE, pod, None)
        self.handle_scheduling_failure(fw, qpi, st, None)

    # -- pods parked at Permit WAIT (framework.go waitingPods) --------------

    def allow_waiting_pod(self, uid: str) -> bool:
        """A Permit plugin allowed a parked pod: its binding cycle runs."""
        entry = self.waiting_pods.pop(uid, None)
        if entry is None:
            return False
        fw, state, qpi, result, _deadline = entry
        self.run_binding_cycle(fw, state, qpi, result.suggested_host)
        return True

    def reject_waiting_pod(self, uid: str, reason: str = "rejected") -> bool:
        entry = self.waiting_pods.pop(uid, None)
        if entry is None:
            return False
        fw, state, qpi, result, _deadline = entry
        self.state_unwinds += 1
        fw.run_reserve_plugins_unreserve(state, qpi.pod, result.suggested_host)
        self.cache.forget_pod(qpi.pod)
        qpi.pod.node_name = ""
        self.handle_scheduling_failure(fw, qpi, Status.unschedulable(reason), None)
        return True

    def park_waiting_pod(self, fw: Framework, state: CycleState, qpi: QueuedPodInfo,
                         result: ScheduleResult) -> None:
        """Park a WAITing pod and arm the expiry timer (WaitOnPermit)."""
        deadline = self.now() + self.permit_wait_timeout
        self.waiting_pods[qpi.pod.uid] = (fw, state, qpi, result, deadline)
        self._next_wait_deadline = min(self._next_wait_deadline, deadline)

    def flush_expired_waiters(self) -> int:
        now = self.now()
        expired = [uid for uid, e in self.waiting_pods.items() if e[4] <= now]
        for uid in expired:
            self.reject_waiting_pod(uid, "permit wait timed out")
        self._next_wait_deadline = min((e[4] for e in self.waiting_pods.values()),
                                       default=float("inf"))
        return len(expired)

    def handle_scheduling_failure(self, fw: Framework, qpi: QueuedPodInfo,
                                  status: Status, diagnosis: Optional[Diagnosis]) -> None:
        self.failures += 1
        if diagnosis is not None:
            qpi.unschedulable_plugins |= diagnosis.unschedulable_plugins
        if status.code == UNSCHEDULABLE_AND_UNRESOLVABLE and not qpi.unschedulable_plugins:
            qpi.unschedulable_plugins.add(status.plugin or "unknown")
        self.queue.add_unschedulable_if_not_present(qpi)
