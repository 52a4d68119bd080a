"""The in-tree plugins of the fit-only slice besides the resource ones:
NodeName, NodeUnschedulable, TaintToleration, NodeAffinity (required terms
and nodeSelector), PrioritySort and DefaultBinder.

Each class mirrors one reference plugin package under
pkg/scheduler/framework/plugins/. Methods follow the duck-typed
extension-point protocol in core/framework.py.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..api.types import (
    NO_SCHEDULE,
    PREFER_NO_SCHEDULE,
    Pod,
    Taint,
    find_matching_untolerated_taint,
)
from ..core.framework import (
    MAX_NODE_SCORE,
    OK,
    CycleState,
    NodeScore,
    PreFilterResult,
    Status,
    default_normalize_score,
)
from ..core.node_info import NodeInfo
from ..core.queue import EVENT_NODE_ADD, EVENT_NODE_UPDATE


class NodeName:
    """plugins/nodename: pod.spec.nodeName exact match."""

    name = "NodeName"

    def filter(self, state: CycleState, pod: Pod, node_info: NodeInfo) -> Status:
        if pod.node_name and pod.node_name != node_info.name:
            return Status.unresolvable("node(s) didn't match the requested node name")
        return OK

    def sign(self, pod: Pod):
        return pod.node_name


class NodeUnschedulable:
    """plugins/nodeunschedulable: gate on node.spec.unschedulable, tolerable
    via the unschedulable taint toleration."""

    name = "NodeUnschedulable"
    TAINT_KEY = "node.kubernetes.io/unschedulable"

    def filter(self, state: CycleState, pod: Pod, node_info: NodeInfo) -> Status:
        node = node_info.node
        if node is not None and node.unschedulable:
            if not any(t.tolerates(UNSCHED_TAINT) for t in pod.tolerations):
                return Status.unresolvable("node(s) were unschedulable")
        return OK

    def sign(self, pod: Pod):
        return tuple((t.key, t.operator, t.value, t.effect) for t in pod.tolerations)


UNSCHED_TAINT = Taint(key=NodeUnschedulable.TAINT_KEY, effect=NO_SCHEDULE)


class PrioritySort:
    """plugins/queuesort: priority desc, then enqueue timestamp asc."""

    name = "PrioritySort"

    def less(self, a, b) -> bool:
        return self.sort_key(a) < self.sort_key(b)

    @staticmethod
    def sort_key(qpi) -> tuple:
        return (-qpi.pod.priority, qpi.timestamp)


class DefaultBinder:
    """plugins/defaultbinder: POST /binding through the clientset."""

    name = "DefaultBinder"

    def __init__(self, clientset):
        self.clientset = clientset

    def bind(self, state: CycleState, pod: Pod, node_name: str) -> Status:
        try:
            self.clientset.bind(pod, node_name)
        except KeyError as e:
            return Status.error(str(e))
        return OK


class TaintToleration:
    """plugins/tainttoleration (taint_toleration.go).

    Filter: first NoSchedule/NoExecute taint not tolerated =>
    UnschedulableAndUnresolvable (:133). Score: count of PreferNoSchedule
    taints intolerable by the pod (:182-194); NormalizeScore reversed (:212).
    """

    name = "TaintToleration"
    _KEY = "PreScoreTaintToleration"

    def events_to_register(self):
        """taint_toleration.go isSchedulableAfterNodeChange."""
        return [(EVENT_NODE_ADD, self._hint_node),
                (EVENT_NODE_UPDATE, self._hint_node)]

    @staticmethod
    def _hint_node(pod: Pod, old, new) -> bool:
        if new is None:
            return True
        return find_matching_untolerated_taint(new.taints, pod.tolerations) is None

    def filter(self, state: CycleState, pod: Pod, node_info: NodeInfo) -> Status:
        node = node_info.node
        if node is None:
            return Status.error("node not found")
        taint = find_matching_untolerated_taint(node.taints, pod.tolerations)
        if taint is not None:
            return Status.unresolvable(
                f"node(s) had untolerated taint {{{taint.key}: {taint.value}}}")
        return OK

    def pre_score(self, state: CycleState, pod: Pod, nodes) -> Status:
        state.write(self._KEY, [t for t in pod.tolerations
                                if not t.effect or t.effect == PREFER_NO_SCHEDULE])
        return OK

    def score(self, state: CycleState, pod: Pod, node_info: NodeInfo) -> int:
        tolerations = state.read(self._KEY) or []
        return sum(1 for taint in node_info.node.taints
                   if taint.effect == PREFER_NO_SCHEDULE
                   and not any(t.tolerates(taint) for t in tolerations))

    def normalize_score(self, scores: List[NodeScore]) -> None:
        default_normalize_score(MAX_NODE_SCORE, True, scores)

    def sign(self, pod: Pod):
        return tuple((t.key, t.operator, t.value, t.effect) for t in pod.tolerations)


class NodeAffinity:
    """plugins/nodeaffinity (node_affinity.go), required terms and
    nodeSelector. PreFilter narrows to named nodes when every term pins
    metadata.name, and Skips when the pod expresses no node affinity.
    Preferred terms are outside the slice (refused by the scope guard), so
    the plugin scores nothing."""

    name = "NodeAffinity"

    def events_to_register(self):
        """node_affinity.go isSchedulableAfterNodeChange."""
        return [(EVENT_NODE_ADD, self._hint_node),
                (EVENT_NODE_UPDATE, self._hint_node)]

    @staticmethod
    def _hint_node(pod: Pod, old, new) -> bool:
        if new is None:
            return True
        return pod.required_node_selector_matches(new)

    def pre_filter(self, state: CycleState, pod: Pod,
                   nodes) -> Tuple[Optional[PreFilterResult], Status]:
        na = pod.affinity.node_affinity if pod.affinity else None
        if not pod.node_selector and (na is None or na.required is None):
            return None, Status.skip()
        if na is not None and na.required is not None and na.required.terms:
            node_names: Optional[set] = set()
            for term in na.required.terms:
                term_names = None
                for req in term.match_fields:
                    if req.key == "metadata.name" and req.operator == "In":
                        term_names = set(req.values)
                if term_names is None:
                    node_names = None
                    break
                node_names |= term_names
            if node_names is not None:
                return PreFilterResult(node_names), OK
        return None, OK

    def filter(self, state: CycleState, pod: Pod, node_info: NodeInfo) -> Status:
        if not pod.required_node_selector_matches(node_info.node):
            return Status.unresolvable("node(s) didn't match Pod's node affinity/selector")
        return OK

    def sign(self, pod: Pod):
        na = pod.affinity.node_affinity if pod.affinity else None
        return (tuple(sorted(pod.node_selector.items())), repr(na) if na else "")
