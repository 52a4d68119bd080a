"""Persistent scheduled-group-pods store (the JAX package's
core/podgroupstate.py; the fork's backend/podgroupstate/podgroupstate.go,
reduced): a generation-versioned index of the pods the cache holds placed
(assumed or bound) per PodGroup, maintained by the cache's add and remove
flow instead of re-scanned over all pods each group cycle. Placement
generation and PodGroupPodsCount scoring read it to pin a partially
scheduled gang's topology domain and to count its members.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from ..api.types import Pod


class PodGroupState:
    """group key -> {pod uid: pod} over bound (node-assigned) group members.
    Single-writer (the scheduling loop's event handlers); `generation`
    advances on every mutation so per-cycle consumers can snapshot-compare
    (podgroupstate.go's generation contract)."""

    def __init__(self):
        self._by_group: Dict[Tuple[str, str], Dict[str, Pod]] = {}
        self.generation = 0

    def _key(self, pod: Pod) -> Tuple[str, str]:
        return (pod.namespace, pod.pod_group)

    def record_bound(self, pod: Pod) -> None:
        if not pod.pod_group or not pod.node_name:
            return
        members = self._by_group.setdefault(self._key(pod), {})
        if pod.uid not in members:
            self.generation += 1  # benign re-updates of a member don't bump
        members[pod.uid] = pod

    def remove(self, pod: Pod) -> None:
        if not pod.pod_group:
            return
        members = self._by_group.get(self._key(pod))
        if members and members.pop(pod.uid, None) is not None:
            if not members:
                del self._by_group[self._key(pod)]
            self.generation += 1

    def scheduled_pods(self, namespace: str, group_name: str) -> List[Pod]:
        return list(self._by_group.get((namespace, group_name), {}).values())

    def count(self, namespace: str, group_name: str) -> int:
        return len(self._by_group.get((namespace, group_name), {}))
