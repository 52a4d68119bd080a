"""Placement-based topology-aware gang scheduling plugins (fork additions;
the JAX package's plugins/topologyaware.py).

- TopologyPlacementGenerator (framework/plugins/topologyaware/
  topology_placement.go:34-43): PlacementGenerate plugin producing one
  candidate node-subset ("placement") per topology domain of the pod group's
  scheduling constraint key; restricted to the domain of already-scheduled
  group members when any exist.
- PodGroupPodsCount (framework/plugins/podgrouppodscount/
  podgroup_pods_count.go): PlacementScore plugin preferring the placement
  that schedules the most group pods (scheduled + proposed), normalized by
  the max across candidates.
"""

from __future__ import annotations

from typing import List, Tuple

from ..api.types import Pod, PodGroup
from ..core.framework import (
    MAX_NODE_SCORE,
    OK,
    CycleState,
    Placement,
    PodGroupAssignments,
    Status,
)


_SCHEDULED_KEY = "TopologyAwareScheduledGroupPods"


def _scheduled_group_pods(handle, group: PodGroup, state=None) -> List[Pod]:
    """podgroupstate.go ScheduledPods: the placed members of the group from
    the scheduler's index (core/podgroupstate.py), O(group members) per
    cycle. Cycle-invariant, memoized on the shared CycleState."""
    if state is not None:
        cached = state.read(_SCHEDULED_KEY)
        if cached is not None:
            return cached
    out = handle.pod_group_state.scheduled_pods(group.namespace, group.name)
    if state is not None:
        state.write(_SCHEDULED_KEY, out)
    return out


class TopologyPlacementGenerator:
    name = "TopologyPlacementGenerator"

    def __init__(self, handle=None):
        self.handle = handle

    def generate_placements(
        self, state: CycleState, group: PodGroup, members, parent: Placement
    ) -> Tuple[List[Placement], Status]:
        keys = getattr(group, "topology_keys", ())
        if not keys:
            # No topology constraints: the parent placement stands
            # (topology_placement.go:61-64).
            return [parent], OK
        key = keys[0]  # single constraint supported, like the reference

        snap = self.handle.snapshot()
        required_domain = None
        scheduled = _scheduled_group_pods(self.handle, group, state)
        if scheduled:
            for p in scheduled:
                ni = snap.get(p.node_name)
                node = ni.node if ni is not None else None
                domain = node.labels.get(key) if node else None
                if domain is None:
                    return [], Status.error(
                        f"no topology domain for scheduled pod {p.name}")
                if required_domain is not None and required_domain != domain:
                    return [], Status.error(
                        "scheduled group pods span multiple domains")
                required_domain = domain

        by_domain = {}
        for name in parent.node_names:
            ni = snap.get(name)
            node = ni.node if ni is not None else None
            if node is None:
                continue
            domain = node.labels.get(key)
            if domain is None:
                continue
            if required_domain is not None and domain != required_domain:
                continue
            by_domain.setdefault(domain, []).append(name)
        # Deterministic candidate order (the reference iterates a Go map;
        # we sort so assignment equivalence is reproducible).
        return [Placement(domain, names)
                for domain, names in sorted(by_domain.items())], OK


class PodGroupPodsCount:
    name = "PodGroupPodsCount"

    def __init__(self, handle=None):
        self.handle = handle

    def score_placement(
        self, state: CycleState, group: PodGroup, pga: PodGroupAssignments
    ) -> Tuple[int, Status]:
        scheduled = len(_scheduled_group_pods(self.handle, group, state))
        return scheduled + len(pga.proposed), OK

    def normalize_placement_score(self, group: PodGroup, scores: List[int]) -> List[int]:
        """podgroup_pods_count.go:73 NormalizePlacementScore: scale by the max
        count (MinCount intentionally ignored to keep score gaps small)."""
        mx = max(scores, default=0)
        if mx == 0:
            return scores
        return [s * MAX_NODE_SCORE // mx for s in scores]
