"""PodTopologySpread (plugins/podtopologyspread/: plugin.go, filtering.go,
scoring.go, common.go): the host oracle behind the device session's
diagnosis and the host path.

Filter semantics (filtering.go:318-362): for each DoNotSchedule constraint,
node must carry the topology key; reject when
    matchNum + selfMatch − minMatchNum > maxSkew
where matchNum counts existing pods in the node's topology domain matching the
constraint selector, and minMatchNum is the global domain minimum tracked by a
two-entry criticalPaths structure (filtering.go:98-137).

Score semantics (scoring.go): per ScheduleAnyway constraint, a node earns
matchCount·w + (maxSkew−1)·1024 with w = round(log(domains+2)·1024), the
reference's float weight quantized so host and device agree exactly;
NormalizeScore inverts via MaxNodeScore * (maxScore + minScore − s) / maxScore.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from ..api.labels import IN, LabelSelector, Requirement
from ..api.types import (
    DO_NOT_SCHEDULE,
    HONOR,
    LABEL_HOSTNAME,
    SCHEDULE_ANYWAY,
    Pod,
    find_matching_untolerated_taint,
)
from ..core.framework import MAX_NODE_SCORE, OK, CycleState, NodeScore, PreFilterResult, Status
from ..core.node_info import NodeInfo, PodInfo
from ..core.queue import (
    EVENT_ASSIGNED_POD_ADD,
    EVENT_ASSIGNED_POD_DELETE,
    EVENT_NODE_ADD,
    EVENT_NODE_UPDATE,
    EVENT_POD_DELETE,
)

INVALID_SCORE = -1


@dataclass
class _Constraint:
    max_skew: int
    topology_key: str
    selector: LabelSelector
    min_domains: Optional[int]
    node_affinity_policy: str
    node_taints_policy: str


def _compile_constraints(pod: Pod, when: str) -> List[_Constraint]:
    """The pod's constraints of one kind, matchLabelKeys merged into the
    selector from the pod's own labels."""
    out = []
    for c in pod.topology_spread_constraints:
        if c.when_unsatisfiable != when:
            continue
        selector = c.label_selector or LabelSelector()
        extra = tuple(Requirement(k, IN, (pod.labels[k],))
                      for k in c.match_label_keys if k in pod.labels)
        if extra:
            selector = LabelSelector(selector.match_labels, selector.match_expressions + extra)
        out.append(_Constraint(max_skew=c.max_skew, topology_key=c.topology_key,
                               selector=selector, min_domains=c.min_domains,
                               node_affinity_policy=c.node_affinity_policy,
                               node_taints_policy=c.node_taints_policy))
    return out


def _count_pods_matching(node_info: NodeInfo, selector: LabelSelector, ns: str) -> int:
    """common.go countPodsMatchSelector: same-namespace, non-terminating pods."""
    n = 0
    for pi in node_info.pods:
        p = pi.pod
        if p.namespace == ns and p.deletion_ts is None and selector.matches(p.labels):
            n += 1
    return n


class _CriticalPaths:
    """filtering.go:98 criticalPaths — two smallest (tpVal, matchNum) entries."""

    __slots__ = ("min1_val", "min1_num", "min2_val", "min2_num")

    def __init__(self):
        self.min1_val: Optional[str] = None
        self.min1_num: int = 1 << 62
        self.min2_val: Optional[str] = None
        self.min2_num: int = 1 << 62

    def clone(self) -> "_CriticalPaths":
        c = _CriticalPaths()
        c.min1_val, c.min1_num = self.min1_val, self.min1_num
        c.min2_val, c.min2_num = self.min2_val, self.min2_num
        return c

    def update(self, tp_val: str, num: int) -> None:
        if tp_val == self.min1_val:
            self.min1_num = num
            if self.min1_num > self.min2_num:
                self.min1_val, self.min2_val = self.min2_val, self.min1_val
                self.min1_num, self.min2_num = self.min2_num, self.min1_num
        elif tp_val == self.min2_val:
            self.min2_num = num
            if self.min1_num > self.min2_num:
                self.min1_val, self.min2_val = self.min2_val, self.min1_val
                self.min1_num, self.min2_num = self.min2_num, self.min1_num
        elif num < self.min1_num:
            self.min2_val, self.min2_num = self.min1_val, self.min1_num
            self.min1_val, self.min1_num = tp_val, num
        elif num < self.min2_num:
            self.min2_val, self.min2_num = tp_val, num


@dataclass
class _PreFilterState:
    constraints: List[_Constraint]
    tp_val_to_match_num: List[Dict[str, int]]  # per constraint: domain -> count
    critical_paths: List[_CriticalPaths]
    tp_domains_num: List[int]

    def clone(self) -> "_PreFilterState":
        """Deep copy for CycleState.clone(): a what-if simulation (nominated
        pods, a preemption dry run) must not change the cycle's counts."""
        return _PreFilterState(self.constraints, [dict(m) for m in self.tp_val_to_match_num],
                               [cp.clone() for cp in self.critical_paths],
                               list(self.tp_domains_num))


class PodTopologySpread:
    name = "PodTopologySpread"
    _FKEY = "PreFilterPodTopologySpread"
    _SKEY = "PreScorePodTopologySpread"

    def __init__(self, handle=None):
        self.handle = handle

    # -- QueueingHints (isSchedulableAfterPodChange / ...NodeChange) --------

    def events_to_register(self):
        return [(EVENT_ASSIGNED_POD_ADD, self._hint_pod),
                (EVENT_ASSIGNED_POD_DELETE, self._hint_pod),
                (EVENT_POD_DELETE, self._hint_pod),
                (EVENT_NODE_ADD, self._hint_node),
                (EVENT_NODE_UPDATE, self._hint_node)]

    @staticmethod
    def _hint_constraints(pod: Pod):
        cached = pod.__dict__.get("_pts_hint_constraints")
        if cached is None:
            cached = pod._pts_hint_constraints = _compile_constraints(pod, DO_NOT_SCHEDULE)
        return cached

    def _hint_pod(self, pod: Pod, old, new) -> bool:
        """A pod change matters only if the other pod matches a constraint
        selector in this pod's namespace."""
        other = new if new is not None else old
        if other is None:
            return True
        if other.namespace != pod.namespace:
            return False
        return any(c.selector.matches(other.labels) for c in self._hint_constraints(pod))

    def _hint_node(self, pod: Pod, old, new) -> bool:
        """A node event matters if the node carries every constraint key, or
        if an update changed or removed a topology label."""
        if new is None:
            return True
        constraints = self._hint_constraints(pod)
        if old is not None and any(old.labels.get(c.topology_key) != new.labels.get(c.topology_key)
                                   for c in constraints):
            return True
        return all(c.topology_key in new.labels for c in constraints)

    # -- eligibility -------------------------------------------------------

    @staticmethod
    def _node_eligible(pod: Pod, node_info: NodeInfo, c: _Constraint) -> bool:
        node = node_info.node
        if node is None or c.topology_key not in node.labels:
            return False
        if c.node_affinity_policy == HONOR and not pod.required_node_selector_matches(node):
            return False
        if c.node_taints_policy == HONOR:
            if find_matching_untolerated_taint(node.taints, pod.tolerations) is not None:
                return False
        return True

    # -- PreFilter / Filter ------------------------------------------------

    def pre_filter(self, state: CycleState, pod: Pod,
                   nodes: Sequence[NodeInfo]) -> Tuple[Optional[PreFilterResult], Status]:
        constraints = _compile_constraints(pod, DO_NOT_SCHEDULE)
        if not constraints:
            state.write(self._FKEY, _PreFilterState([], [], [], []))
            return None, Status.skip()
        tp_maps: List[Dict[str, int]] = [dict() for _ in constraints]
        for ni in nodes:
            for i, c in enumerate(constraints):
                if not self._node_eligible(pod, ni, c):
                    continue
                tp_val = ni.node.labels[c.topology_key]
                cnt = _count_pods_matching(ni, c.selector, pod.namespace)
                tp_maps[i][tp_val] = tp_maps[i].get(tp_val, 0) + cnt
        cps = []
        for m in tp_maps:
            cp = _CriticalPaths()
            for v, n in m.items():
                cp.update(v, n)
            cps.append(cp)
        state.write(self._FKEY, _PreFilterState(constraints, tp_maps, cps,
                                                [len(m) for m in tp_maps]))
        return None, OK

    # AddPod/RemovePod PreFilterExtensions (filtering.go updateWithPod): the
    # two-pass filter and the preemption dry run add or remove a pod on a
    # node and keep the counts in step.
    def add_pod(self, state: CycleState, pod: Pod, added: PodInfo, node_info: NodeInfo) -> Status:
        self._update(state, pod, added.pod, node_info, +1)
        return OK

    def remove_pod(self, state: CycleState, pod: Pod, removed: PodInfo,
                   node_info: NodeInfo) -> Status:
        self._update(state, pod, removed.pod, node_info, -1)
        return OK

    def _update(self, state: CycleState, pod: Pod, other: Pod, node_info: NodeInfo,
                delta: int) -> None:
        s: _PreFilterState = state.read(self._FKEY)
        if s is None or not s.constraints:
            return
        for i, c in enumerate(s.constraints):
            if not self._node_eligible(pod, node_info, c):
                continue
            if other.namespace != pod.namespace or not c.selector.matches(other.labels):
                continue
            tp_val = node_info.node.labels[c.topology_key]
            n = s.tp_val_to_match_num[i].get(tp_val, 0) + delta
            s.tp_val_to_match_num[i][tp_val] = n
            s.critical_paths[i].update(tp_val, n)

    def filter(self, state: CycleState, pod: Pod, node_info: NodeInfo) -> Status:
        s: _PreFilterState = state.read(self._FKEY)
        if s is None or not s.constraints:
            return OK
        node = node_info.node
        for i, c in enumerate(s.constraints):
            tp_val = node.labels.get(c.topology_key)
            if tp_val is None:
                return Status.unresolvable("node(s) didn't have the requested topology")
            min_match = s.critical_paths[i].min1_num
            if c.min_domains is not None and s.tp_domains_num[i] < c.min_domains:
                min_match = 0
            if min_match >= (1 << 62):
                min_match = 0
            self_match = 1 if c.selector.matches(pod.labels) else 0
            match_num = s.tp_val_to_match_num[i].get(tp_val, 0)
            if match_num + self_match - min_match > c.max_skew:
                return Status.unschedulable("node(s) didn't match pod topology spread constraints")
        return OK

    # -- PreScore / Score --------------------------------------------------

    def pre_score(self, state: CycleState, pod: Pod, nodes: Sequence[NodeInfo]) -> Status:
        constraints = _compile_constraints(pod, SCHEDULE_ANYWAY)
        if not constraints:
            return Status.skip()
        all_nodes = self.handle.snapshot().node_info_list if self.handle is not None else nodes
        tp_counts: List[Dict[str, int]] = [dict() for _ in constraints]
        ignored_nodes = set()
        for ni in all_nodes:
            node = ni.node
            if node is None:
                continue
            # scoring.go initPreScoreState: nodes missing any topology key or
            # failing the pod's required node affinity are ignored.
            if (not all(c.topology_key in node.labels for c in constraints)
                    or not pod.required_node_selector_matches(node)):
                ignored_nodes.add(node.name)
                continue
            for i, c in enumerate(constraints):
                if c.topology_key == LABEL_HOSTNAME:
                    continue  # counted per node at Score time
                tp_val = node.labels[c.topology_key]
                cnt = _count_pods_matching(ni, c.selector, pod.namespace)
                tp_counts[i][tp_val] = tp_counts[i].get(tp_val, 0) + cnt
        weights = []
        for i, c in enumerate(constraints):
            if c.topology_key == LABEL_HOSTNAME:
                size = sum(1 for ni in all_nodes
                           if ni.node is not None and ni.node.name not in ignored_nodes)
            else:
                size = len(tp_counts[i])
            weights.append(int(round(math.log(size + 2) * 1024)))
        state.write(self._SKEY, (constraints, tp_counts, weights, ignored_nodes))
        return OK

    def score(self, state: CycleState, pod: Pod, node_info: NodeInfo) -> int:
        data = state.read(self._SKEY)
        if data is None:
            return 0
        constraints, tp_counts, weights, ignored = data
        node = node_info.node
        if node.name in ignored:
            return 0
        score = 0
        for i, c in enumerate(constraints):
            tp_val = node.labels.get(c.topology_key)
            if tp_val is None:
                continue
            if c.topology_key == LABEL_HOSTNAME:
                cnt = _count_pods_matching(node_info, c.selector, pod.namespace)
            else:
                cnt = tp_counts[i].get(tp_val, 0)
            score += cnt * weights[i] + (c.max_skew - 1) * 1024
        return score

    def normalize_score(self, state: CycleState, pod: Pod, scores: List[NodeScore]) -> None:
        data = state.read(self._SKEY)
        if data is None:
            return
        ignored = data[3]
        min_score = 1 << 62
        max_score = 0
        for s in scores:
            if s.name in ignored:
                s.score = INVALID_SCORE
                continue
            min_score = min(min_score, s.score)
            max_score = max(max_score, s.score)
        for s in scores:
            if s.score == INVALID_SCORE:
                s.score = 0
            elif max_score == 0:
                s.score = MAX_NODE_SCORE
            else:
                s.score = MAX_NODE_SCORE * (max_score + min_score - s.score) // max_score

    def sign(self, pod: Pod):
        return (tuple(sorted(pod.labels.items())), pod.namespace,
                tuple((c.max_skew, c.topology_key, c.when_unsatisfiable, repr(c.label_selector),
                       c.min_domains, c.node_affinity_policy, c.node_taints_policy,
                       c.match_label_keys)
                      for c in pod.topology_spread_constraints))
