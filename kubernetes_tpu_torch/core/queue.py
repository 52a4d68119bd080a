"""PriorityQueue: the three-stage pending-pod store and the Nominator,
trimmed to the port (no composite groups).

Re-expresses pkg/scheduler/backend/queue/scheduling_queue.go (:186-269):
- activeQ   — heap ordered by the QueueSort plugin (priority, FIFO);
- backoffQ  — heap ordered by backoff expiry; exponential backoff
              1s→10s (backoff_queue.go:249 calculateBackoffDuration);
- unschedulable — tried-and-failed pods, moved to active/backoff on cluster
  events (MoveAllToActiveOrBackoffQueue :1817) filtered by per-plugin
  QueueingHints (isPodWorthRequeuing :582).

Gang scheduling (workload_forest.go / pod_group_member_pods.go, the JAX
package's core/queue.py:596-948, reduced to flat groups): a pod naming a
pod group is buffered until `min_count` members have arrived, then the
whole group enters the activeQ as one QueuedPodGroupInfo entity.

Scheduling gates (PreEnqueue, scheduling_queue.go:858): a pod that a
PreEnqueue plugin holds is parked `gated` in the unschedulable pool, which
keeps an index of its non-gated entries so that cluster events cost
O(requeue-able pods), never O(gated pods); an update that clears the gates
releases it (the JAX package's core/queue.py:455-482, :582-587, :746-755).

Single-threaded: `pop` returns None when empty instead of blocking. With
SchedulerPopFromBackoffQ (on by default in the reference), an empty activeQ
pops the earliest-expiry backoff entry.
"""

from __future__ import annotations

import heapq
import itertools
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set, Tuple, Union

from ..api.types import Pod
from .node_info import PodInfo

DEFAULT_POD_INITIAL_BACKOFF = 1.0
DEFAULT_POD_MAX_BACKOFF = 10.0
MAX_IN_UNSCHEDULABLE = 300.0  # podMaxInUnschedulablePodsDuration

# Cluster events (framework/types.go ClusterEvent).
EVENT_POD_DELETE = "Pod/Delete"
EVENT_ASSIGNED_POD_ADD = "AssignedPod/Add"
EVENT_ASSIGNED_POD_DELETE = "AssignedPod/Delete"
EVENT_NODE_ADD = "Node/Add"
EVENT_NODE_UPDATE = "Node/Update"
EVENT_STORAGE_ADD = "Storage/Add"  # a storage or DRA object written

# Static QueueingHints for plugins that register no hint functions: which
# events can unblock a pod a plugin rejected. Plugins absent from both this
# map and the framework's registrations requeue on any event.
QUEUEING_HINTS: Dict[str, Set[str]] = {
    "NodeName": {EVENT_NODE_ADD, EVENT_NODE_UPDATE},
    "NodeUnschedulable": {EVENT_NODE_ADD, EVENT_NODE_UPDATE},
    "NodePorts": {EVENT_NODE_ADD, EVENT_ASSIGNED_POD_DELETE, EVENT_POD_DELETE},
    "VolumeBinding": {EVENT_NODE_ADD, EVENT_NODE_UPDATE, EVENT_STORAGE_ADD},
    "VolumeZone": {EVENT_NODE_ADD, EVENT_NODE_UPDATE, EVENT_STORAGE_ADD},
    "NodeVolumeLimits": {EVENT_NODE_ADD, EVENT_ASSIGNED_POD_DELETE, EVENT_POD_DELETE,
                         EVENT_STORAGE_ADD},
    "VolumeRestrictions": {EVENT_ASSIGNED_POD_DELETE, EVENT_POD_DELETE},
    "DynamicResources": {EVENT_NODE_ADD, EVENT_NODE_UPDATE, EVENT_STORAGE_ADD,
                         EVENT_ASSIGNED_POD_DELETE, EVENT_POD_DELETE},
    # A topology-constrained group with no feasible placement is charged to
    # no plugin it registered events for: nothing requeues it early.
    "TopologyPlacementGenerator": set(),
}


@dataclass
class QueuedPodInfo:
    """framework/types.go QueuedPodInfo."""

    pod_info: PodInfo
    timestamp: float = 0.0
    attempts: int = 0
    unschedulable_plugins: Set[str] = field(default_factory=set)
    gated: bool = False  # held by a PreEnqueue plugin

    @property
    def pod(self) -> Pod:
        return self.pod_info.pod

    @property
    def uid(self) -> str:
        return self.pod_info.pod.uid


@dataclass
class QueuedPodGroupInfo:
    """The gang-scheduling queue entity (scheduling_queue.go
    QueuedPodGroupInfo): a PodGroup whose members have arrived pops as one
    unit and is scheduled all-or-nothing."""

    group: object  # api.types.PodGroup
    members: List[QueuedPodInfo] = field(default_factory=list)
    timestamp: float = 0.0
    attempts: int = 0
    unschedulable_plugins: Set[str] = field(default_factory=set)
    gated: bool = False

    @property
    def pod(self) -> Pod:
        """Queue-ordering shim: a group sorts by its first member's priority
        and its own arrival."""
        return self.members[0].pod if self.members else Pod(name="(empty-group)")

    @property
    def uid(self) -> str:
        return f"pg:{self.group.namespace}/{self.group.name}"


Entity = Union[QueuedPodInfo, QueuedPodGroupInfo]


class _Heap:
    """Heap with lazy delete by uid (backend/heap/heap.go); entries carry a
    plain sort-key tuple plus an insertion counter for stability."""

    def __init__(self, sort_key: Callable[[QueuedPodInfo], tuple]):
        self._sort_key = sort_key
        self._entries: List[List] = []  # [key, seq, qpi, valid]
        self._by_uid: Dict[str, List] = {}
        self._seq = itertools.count()

    def push(self, qpi: QueuedPodInfo) -> None:
        self.delete(qpi.uid)
        entry = [self._sort_key(qpi), next(self._seq), qpi, True]
        self._by_uid[qpi.uid] = entry
        heapq.heappush(self._entries, entry)

    def pop(self) -> Optional[QueuedPodInfo]:
        while self._entries:
            entry = heapq.heappop(self._entries)
            if entry[3]:
                del self._by_uid[entry[2].uid]
                return entry[2]
        return None

    def peek(self) -> Optional[QueuedPodInfo]:
        while self._entries and not self._entries[0][3]:
            heapq.heappop(self._entries)
        return self._entries[0][2] if self._entries else None

    def delete(self, uid: str) -> Optional[QueuedPodInfo]:
        entry = self._by_uid.pop(uid, None)
        if entry is not None:
            entry[3] = False
            return entry[2]
        return None

    def get(self, uid: str) -> Optional[QueuedPodInfo]:
        entry = self._by_uid.get(uid)
        return entry[2] if entry else None

    def __len__(self) -> int:
        return len(self._by_uid)


class Nominator:
    """backend/queue/nominator.go — preemption-nominated pods per node. A
    pod leaves the set when it binds or is deleted."""

    def __init__(self):
        self._node_to_pods: Dict[str, List[PodInfo]] = {}
        self._pod_to_node: Dict[str, str] = {}
        # Bumped on every change: a device session keys on the nomination
        # SET (a changed set changes two-pass filter outcomes).
        self.version = 0

    def add_nominated_pod(self, pi: PodInfo, node_name: str) -> None:
        self.delete_nominated_pod(pi.pod)
        if not node_name:
            return
        self._node_to_pods.setdefault(node_name, []).append(pi)
        self._pod_to_node[pi.pod.uid] = node_name
        self.version += 1

    def delete_nominated_pod(self, pod: Pod) -> None:
        node = self._pod_to_node.pop(pod.uid, None)
        if node is None:
            return
        rest = [p for p in self._node_to_pods[node] if p.pod.uid != pod.uid]
        if rest:
            self._node_to_pods[node] = rest
        else:
            del self._node_to_pods[node]
        self.version += 1

    def all_nominated_pod_infos(self) -> List[PodInfo]:
        return [pi for pis in self._node_to_pods.values() for pi in pis]

    def nominated_pods_for_node(self, node_name: str) -> List[PodInfo]:
        return self._node_to_pods.get(node_name, [])

    def nominated_nodes(self) -> Dict[str, List[PodInfo]]:
        return self._node_to_pods

    def has_nominated_pods(self) -> bool:
        return bool(self._pod_to_node)


class _UnschedulableMap(dict):
    """The unschedulable pool (uid -> entity) with an index of its
    non-gated uids, in insertion order. Every flow that ungates an entity
    pops it from the map first (update), so the index, keyed on the
    insert-time `gated`, cannot go stale while the entity is stored."""

    def __init__(self):
        super().__init__()
        self.non_gated: Dict[str, None] = {}

    def __setitem__(self, uid, qpi):
        super().__setitem__(uid, qpi)
        if qpi.gated:
            self.non_gated.pop(uid, None)
        else:
            self.non_gated[uid] = None

    def __delitem__(self, uid):
        super().__delitem__(uid)
        self.non_gated.pop(uid, None)

    def pop(self, uid, *default):
        self.non_gated.pop(uid, None)
        return super().pop(uid, *default)


class PriorityQueue:
    def __init__(self, framework, now: Callable[[], float] = time.monotonic,
                 initial_backoff: float = DEFAULT_POD_INITIAL_BACKOFF,
                 max_backoff: float = DEFAULT_POD_MAX_BACKOFF):
        self.framework = framework
        self.now = now
        self.initial_backoff = initial_backoff
        self.max_backoff = max_backoff
        self.active_q = _Heap(framework.queue_sort_key)
        self.backoff_q = _Heap(lambda qpi: (self.backoff_expiry(qpi),))
        self.unschedulable = _UnschedulableMap()
        self.nominator = Nominator()
        # In-flight entities + the shared event log (scheduling_queue.go
        # inFlightEvents): each popped entity records the log position; a
        # failure consults only the events that arrived while it was out.
        self._in_flight: Dict[str, int] = {}
        self._event_log: List[Tuple] = []
        # Gang scheduling: the groups seen, and each group's buffered
        # members (arrived, not yet scheduled).
        self.pod_groups: Dict[Tuple[str, str], object] = {}
        self._group_members: Dict[Tuple[str, str], List[QueuedPodInfo]] = {}

    # -- backoff (backoff_queue.go:249) ------------------------------------

    def backoff_duration(self, qpi: QueuedPodInfo) -> float:
        d = self.initial_backoff
        for _ in range(max(0, qpi.attempts - 1)):
            d *= 2
            if d >= self.max_backoff:
                return self.max_backoff
        return d

    def backoff_expiry(self, qpi: QueuedPodInfo) -> float:
        return qpi.timestamp + self.backoff_duration(qpi)

    def is_backing_off(self, qpi: QueuedPodInfo) -> bool:
        return qpi.attempts > 0 and self.backoff_expiry(qpi) > self.now()

    # -- add / pop ---------------------------------------------------------

    def add(self, pod: Pod) -> None:
        """Add (scheduling_queue.go:858) — admission of a new pending pod: a
        pod a PreEnqueue plugin holds is parked gated; a gang member joins
        its group's buffer."""
        qpi = QueuedPodInfo(pod_info=PodInfo.of(pod), timestamp=self.now())
        if self.framework.pre_enqueue_plugins:
            st = self.framework.run_pre_enqueue_plugins(pod)
            if not st.is_success():
                qpi.gated = True
                qpi.unschedulable_plugins.add(st.plugin)
                self.unschedulable[pod.uid] = qpi
                return
        if pod.pod_group:
            self._add_group_member(qpi)
            return
        self.active_q.push(qpi)

    # -- gang scheduling ---------------------------------------------------

    def register_pod_group(self, group) -> None:
        """PodGroup informer event: record it and activate the group if
        enough members are buffered."""
        key = (group.namespace, group.name)
        self.pod_groups[key] = group
        self._maybe_activate_group(key)

    def _add_group_member(self, qpi: QueuedPodInfo) -> None:
        key = (qpi.pod.namespace, qpi.pod.pod_group)
        members = self._group_members.setdefault(key, [])
        members.append(qpi)
        existing = self._group_entity(key)
        if existing is not None:
            existing.members = list(members)  # a late joiner widens the gang
            return
        self._maybe_activate_group(key)

    def _group_entity(self, key) -> Optional[QueuedPodGroupInfo]:
        if key not in self.pod_groups:
            return None
        uid = f"pg:{key[0]}/{key[1]}"
        return self.active_q.get(uid) or self.backoff_q.get(uid) or self.unschedulable.get(uid)

    def _maybe_activate_group(self, key) -> None:
        """PodGroupPodsCount gate: the group enters the activeQ once
        min_count members have arrived (and it is not queued or in flight
        already)."""
        group = self.pod_groups.get(key)
        if group is None:
            return
        members = self._group_members.get(key, [])
        if len(members) < max(1, group.min_count):
            return
        if self._group_entity(key) is not None or f"pg:{key[0]}/{key[1]}" in self._in_flight:
            return
        self.active_q.push(QueuedPodGroupInfo(group=group, members=list(members),
                                              timestamp=self.now()))

    def remove_group_member(self, pod: Pod) -> None:
        """A buffered member is deleted: it leaves the buffer and any queued
        entity, which leaves the queue once below min_count."""
        key = (pod.namespace, pod.pod_group)
        members = self._group_members.get(key)
        if not members:
            return
        self._group_members[key] = [m for m in members if m.pod.uid != pod.uid]
        ent = self._group_entity(key)
        if ent is not None:
            ent.members = [m for m in ent.members if m.pod.uid != pod.uid]
            if len(ent.members) < max(1, self.pod_groups[key].min_count):
                self.active_q.delete(ent.uid)
                self.backoff_q.delete(ent.uid)
                self.unschedulable.pop(ent.uid, None)

    def clear_group_members(self, group_key: Tuple[str, str], uids) -> None:
        """Members a group cycle attempted leave the buffer."""
        members = self._group_members.get(group_key)
        if members:
            self._group_members[group_key] = [m for m in members if m.pod.uid not in uids]

    def update(self, old: Optional[Pod], new: Pod) -> None:
        uid = new.uid
        if new.pod_group:
            # A buffered gang member updates in place.
            for m in self._group_members.get((new.namespace, new.pod_group), ()):
                if m.pod.uid == uid:
                    m.pod_info = PodInfo.of(new)
                    return
        if uid in self.unschedulable:
            qpi = self.unschedulable.pop(uid)
            qpi.pod_info = PodInfo.of(new)
            if qpi.gated:
                # PreEnqueue again: the update may have lifted the gates.
                if self.framework.run_pre_enqueue_plugins(new).is_success():
                    qpi.gated = False
                    qpi.timestamp = self.now()
                    if new.pod_group:
                        self._add_group_member(qpi)  # it joins its gang
                    else:
                        self.active_q.push(qpi)
                    return
                self.unschedulable[uid] = qpi
                return
            self._move_to_active_or_backoff(qpi)
            return
        for q in (self.active_q, self.backoff_q):
            existing = q.delete(uid)
            if existing is not None:
                existing.pod_info = PodInfo.of(new)
                q.push(existing)
                return
        if uid not in self._in_flight:
            self.add(new)

    def delete(self, pod: Pod) -> None:
        if pod.pod_group:
            self.remove_group_member(pod)
        self.active_q.delete(pod.uid)
        self.backoff_q.delete(pod.uid)
        self.unschedulable.pop(pod.uid, None)
        self.nominator.delete_nominated_pod(pod)

    def pop(self) -> Optional[Entity]:
        """Pop (scheduling_queue.go:1320) with SchedulerPopFromBackoffQ."""
        self.flush_backoff_completed()
        qpi = self.active_q.pop() or self.backoff_q.pop()
        if qpi is None:
            return None
        qpi.attempts += 1
        self._in_flight[qpi.uid] = len(self._event_log)
        return qpi

    def done(self, uid: str) -> None:
        """Done (scheduling_queue.go:1326) — scheduling attempt finished."""
        self._in_flight.pop(uid, None)
        if not self._in_flight:
            self._event_log.clear()

    def pending_counts(self) -> Tuple[int, int, int]:
        return len(self.active_q), len(self.backoff_q), len(self.unschedulable)

    # -- requeue on failure ------------------------------------------------

    def add_unschedulable_if_not_present(self, qpi: Entity) -> None:
        """AddUnschedulablePodIfNotPresent (scheduling_queue.go:1058): when a
        relevant event arrived while the entity was in flight, skip the
        unschedulable pool. Entities key by their uid (a pod's, or
        "pg:ns/name" for a group)."""
        start = self._in_flight.get(qpi.uid)
        events = self._event_log[start:] if start is not None else []
        qpi.timestamp = self.now()
        if events and self._events_relevant(qpi, events):
            self._move_to_active_or_backoff(qpi)
            return
        self.unschedulable[qpi.uid] = qpi

    def _events_relevant(self, qpi: Entity, events: List[Tuple]) -> bool:
        """isPodWorthRequeuing (scheduling_queue.go:582): does any event
        plausibly resolve one of the plugins that rejected this pod?"""
        plugins = qpi.unschedulable_plugins
        if not plugins:
            return True
        hint_map = self.framework.queueing_hint_map
        for event, old, new in events:
            for p in plugins:
                registered = hint_map.get(p)
                if registered is None:
                    hints = QUEUEING_HINTS.get(p)
                    if hints is None or event in hints:
                        return True
                    continue
                for fn in registered.get(event, ()):
                    if fn is None or fn(qpi.pod, old, new):
                        return True
        return False

    def _move_to_active_or_backoff(self, qpi: Entity) -> None:
        if self.is_backing_off(qpi):
            self.backoff_q.push(qpi)
        else:
            self.active_q.push(qpi)

    def activate(self, pod: Pod) -> None:
        """Activate (scheduling_queue.go:955): force a parked or backing-off
        pod into the activeQ. A gated pod stays parked (the JAX package's
        activate pops it from the pool and drops it)."""
        uid = pod.uid
        parked = self.unschedulable.get(uid)
        if parked is not None and parked.gated:
            return
        qpi = self.unschedulable.pop(uid, None) or self.backoff_q.delete(uid)
        if qpi is not None:
            qpi.timestamp = self.now()
            self.active_q.push(qpi)

    def move_all_to_active_or_backoff(self, event: str, old=None, new=None) -> None:
        """MoveAllToActiveOrBackoffQueue (scheduling_queue.go:1817) with
        per-plugin QueueingHint filtering over the event's (old, new). It
        walks the pool's non-gated index: gated pods cost nothing here."""
        ev = (event, old, new)
        for uid in list(self.unschedulable.non_gated):
            qpi = self.unschedulable[uid]
            if self._events_relevant(qpi, [ev]):
                del self.unschedulable[uid]
                self._move_to_active_or_backoff(qpi)
        if self._in_flight:
            self._event_log.append(ev)

    def flush_backoff_completed(self) -> None:
        """backoffQ flush loop (scheduling_queue.go Run :503)."""
        while True:
            qpi = self.backoff_q.peek()
            if qpi is None or self.backoff_expiry(qpi) > self.now():
                return
            self.backoff_q.pop()
            self.active_q.push(qpi)

    def flush_unschedulable_left_over(self) -> None:
        """flushUnschedulablePodsLeftover: entities parked longer than
        MAX_IN_UNSCHEDULABLE move on; gated pods stay."""
        now = self.now()
        for uid in list(self.unschedulable):
            qpi = self.unschedulable[uid]
            if not qpi.gated and now - qpi.timestamp > MAX_IN_UNSCHEDULABLE:
                del self.unschedulable[uid]
                self._move_to_active_or_backoff(qpi)
