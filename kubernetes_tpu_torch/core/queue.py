"""PriorityQueue: the three-stage pending-pod store, trimmed to the fit-only
slice (no gates, no pod groups, no composite groups, no nominator).

Re-expresses pkg/scheduler/backend/queue/scheduling_queue.go (:186-269):
- activeQ   — heap ordered by the QueueSort plugin (priority, FIFO);
- backoffQ  — heap ordered by backoff expiry; exponential backoff
              1s→10s (backoff_queue.go:249 calculateBackoffDuration);
- unschedulable — tried-and-failed pods, moved to active/backoff on cluster
  events (MoveAllToActiveOrBackoffQueue :1817) filtered by per-plugin
  QueueingHints (isPodWorthRequeuing :582).

Single-threaded: `pop` returns None when empty instead of blocking. With
SchedulerPopFromBackoffQ (on by default in the reference), an empty activeQ
pops the earliest-expiry backoff entry.
"""

from __future__ import annotations

import heapq
import itertools
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set, Tuple

from ..api.types import Pod
from .node_info import PodInfo
from .scope import check_pod

DEFAULT_POD_INITIAL_BACKOFF = 1.0
DEFAULT_POD_MAX_BACKOFF = 10.0

# Cluster events (framework/types.go ClusterEvent).
EVENT_POD_DELETE = "Pod/Delete"
EVENT_ASSIGNED_POD_ADD = "AssignedPod/Add"
EVENT_ASSIGNED_POD_DELETE = "AssignedPod/Delete"
EVENT_NODE_ADD = "Node/Add"
EVENT_NODE_UPDATE = "Node/Update"

# Static QueueingHints for plugins that register no hint functions: which
# events can unblock a pod a plugin rejected. Plugins absent from both this
# map and the framework's registrations requeue on any event.
QUEUEING_HINTS: Dict[str, Set[str]] = {
    "NodeName": {EVENT_NODE_ADD, EVENT_NODE_UPDATE},
    "NodeUnschedulable": {EVENT_NODE_ADD, EVENT_NODE_UPDATE},
}


@dataclass
class QueuedPodInfo:
    """framework/types.go QueuedPodInfo."""

    pod_info: PodInfo
    timestamp: float = 0.0
    attempts: int = 0
    unschedulable_plugins: Set[str] = field(default_factory=set)

    @property
    def pod(self) -> Pod:
        return self.pod_info.pod

    @property
    def uid(self) -> str:
        return self.pod_info.pod.uid


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
        self.unschedulable: Dict[str, QueuedPodInfo] = {}
        # In-flight entities + the shared event log (scheduling_queue.go
        # inFlightEvents): each popped entity records the log position; a
        # failure consults only the events that arrived while it was out.
        self._in_flight: Dict[str, int] = {}
        self._event_log: List[Tuple] = []

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
        """Add (scheduling_queue.go:858) — admission of a new pending pod."""
        check_pod(pod)
        self.active_q.push(QueuedPodInfo(pod_info=PodInfo.of(pod), timestamp=self.now()))

    def update(self, old: Optional[Pod], new: Pod) -> None:
        check_pod(new)
        uid = new.uid
        if uid in self.unschedulable:
            qpi = self.unschedulable.pop(uid)
            qpi.pod_info = PodInfo.of(new)
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
        self.active_q.delete(pod.uid)
        self.backoff_q.delete(pod.uid)
        self.unschedulable.pop(pod.uid, None)

    def pop(self) -> Optional[QueuedPodInfo]:
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

    def add_unschedulable_if_not_present(self, qpi: QueuedPodInfo) -> None:
        """AddUnschedulablePodIfNotPresent (scheduling_queue.go:1058): when a
        relevant event arrived while the pod was in flight, skip the
        unschedulable pool."""
        start = self._in_flight.get(qpi.uid)
        events = self._event_log[start:] if start is not None else []
        qpi.timestamp = self.now()
        if events and self._events_relevant(qpi, events):
            self._move_to_active_or_backoff(qpi)
            return
        self.unschedulable[qpi.uid] = qpi

    def _events_relevant(self, qpi: QueuedPodInfo, events: List[Tuple]) -> bool:
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

    def _move_to_active_or_backoff(self, qpi: QueuedPodInfo) -> None:
        if self.is_backing_off(qpi):
            self.backoff_q.push(qpi)
        else:
            self.active_q.push(qpi)

    def move_all_to_active_or_backoff(self, event: str, old=None, new=None) -> None:
        """MoveAllToActiveOrBackoffQueue (scheduling_queue.go:1817) with
        per-plugin QueueingHint filtering over the event's (old, new)."""
        ev = (event, old, new)
        for uid in list(self.unschedulable):
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
