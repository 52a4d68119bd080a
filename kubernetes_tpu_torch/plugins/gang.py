"""GangScheduling (the fork's gangscheduling.go; the JAX package's
plugins/extras.py:73-125): the Permit barrier of a pod group and its
PlacementFeasible gate.

A gang member whose placement is committed waits at Permit until min_count
members of its group hold reservations; the member that completes the
count allows every parked peer (Handle.allow_waiting_pod) and proceeds. A
placement simulation stands only if it schedules at least min_count
members. Pods without a group pass."""

from __future__ import annotations

import time
from typing import Dict, Tuple

from ..api.types import Pod
from ..core.framework import OK, WAIT, CycleState, Status


class GangScheduling:
    name = "GangScheduling"
    # Permit acts on pod-group members only: the device commit's lean tail
    # (which pod-group members never take) may skip it.
    gang_only = True

    def __init__(self, handle=None, timeout_seconds: float = 60.0, now=time.monotonic):
        self.handle = handle
        self.timeout = timeout_seconds
        self.now = now
        # group key -> {pod uid: deadline} of the members parked at Permit
        self.waiting: Dict[Tuple[str, str], Dict[str, float]] = {}

    def _group(self, pod: Pod):
        if not pod.pod_group:
            return None
        return self.handle.clientset.pod_groups.get(f"{pod.namespace}/{pod.pod_group}")

    def permit(self, state: CycleState, pod: Pod, node_name: str) -> Status:
        group = self._group(pod)
        if group is None:
            return OK
        key = (pod.namespace, pod.pod_group)
        waiters = self.waiting.setdefault(key, {})
        waiters[pod.uid] = self.now() + self.timeout
        if len(waiters) >= max(1, group.min_count):
            # The barrier is met: allow every parked peer; this pod goes on.
            for uid in self.waiting.pop(key):
                if uid != pod.uid:
                    self.handle.allow_waiting_pod(uid)
            return OK
        return Status(WAIT, (f"waiting for {group.min_count} gang members",), self.name)

    def placement_feasible(self, state: CycleState, group, progress) -> Status:
        """A candidate placement stands only if it schedules at least
        min_count members of the group."""
        need = max(1, group.min_count)
        if progress.scheduled >= need:
            return OK
        return Status.unschedulable(
            f"placement schedules {progress.scheduled}/{progress.total} members, need {need}")

    def unreserve(self, state: CycleState, pod: Pod, node_name: str) -> None:
        key = (pod.namespace, pod.pod_group)
        waiters = self.waiting.get(key)
        if waiters is not None:
            waiters.pop(pod.uid, None)
            if not waiters:
                self.waiting.pop(key, None)
