"""The in-tree plugins of the port besides the resource and topology ones:
NodeName, NodeUnschedulable, NodePorts, SchedulingGates, TaintToleration,
NodeAffinity (required and preferred terms, nodeSelector), ImageLocality,
PrioritySort and DefaultBinder.

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


def host_ports_conflict(ports, used_ports) -> bool:
    """nodeports.go Fits → fitsPorts, with the 0.0.0.0 wildcard: a pod port
    conflicts with a used (protocol, host_ip, port) of the same port and
    protocol when either address is the wildcard or both are equal. The
    host filter and the device path's static per-row mask
    (ops/features.py) both call it."""
    for p in ports:
        for (proto, ip, port) in used_ports:
            if port != p.host_port or proto != p.protocol:
                continue
            if ip in ("", "0.0.0.0") or p.host_ip in ("", "0.0.0.0") or ip == p.host_ip:
                return True
    return False


class NodePorts:
    """plugins/nodeports: reject nodes where a pod already holds one of the
    pod's host ports."""

    name = "NodePorts"
    _KEY = "PreFilterNodePorts"

    def pre_filter(self, state: CycleState, pod: Pod,
                   nodes) -> Tuple[Optional[PreFilterResult], Status]:
        ports = pod.host_ports()
        if not ports:
            return None, Status.skip()
        state.write(self._KEY, ports)
        return None, OK

    def filter(self, state: CycleState, pod: Pod, node_info: NodeInfo) -> Status:
        ports = state.read(self._KEY)
        if ports is None:
            ports = pod.host_ports()
        if host_ports_conflict(ports, node_info.used_ports):
            return Status.unschedulable("node(s) didn't have free ports for the requested pod ports")
        return OK

    def sign(self, pod: Pod):
        return tuple(sorted((p.protocol, p.host_ip, p.host_port) for p in pod.host_ports()))


class SchedulingGates:
    """plugins/schedulinggates: the PreEnqueue gate on spec.schedulingGates
    (a gated pod waits in the queue's unschedulable pool until an update
    removes its gates)."""

    name = "SchedulingGates"

    def pre_enqueue(self, pod: Pod) -> Status:
        if pod.scheduling_gates:
            return Status.unresolvable(
                "waiting for scheduling gates: " + ",".join(pod.scheduling_gates))
        return OK


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

    def normalize_score(self, state: CycleState, pod: Pod, scores: List[NodeScore]) -> None:
        default_normalize_score(MAX_NODE_SCORE, True, scores)

    def sign(self, pod: Pod):
        return tuple((t.key, t.operator, t.value, t.effect) for t in pod.tolerations)


class NodeAffinity:
    """plugins/nodeaffinity (node_affinity.go). Filter: nodeSelector AND
    required node affinity terms. PreFilter narrows to named nodes when
    every term pins metadata.name, and Skips when the pod expresses no node
    affinity. Score: the sum of matching preferred term weights,
    default-normalized (:337-411 of the JAX package's plugins/basic.py)."""

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

    def pre_score(self, state: CycleState, pod: Pod, nodes) -> Status:
        na = pod.affinity.node_affinity if pod.affinity else None
        if na is None or not na.preferred:
            return Status.skip()
        return OK

    def score(self, state: CycleState, pod: Pod, node_info: NodeInfo) -> int:
        na = pod.affinity.node_affinity if pod.affinity else None
        if na is None:
            return 0
        return sum(pref.weight for pref in na.preferred if pref.preference.matches(node_info.node))

    def normalize_score(self, state: CycleState, pod: Pod, scores: List[NodeScore]) -> None:
        default_normalize_score(MAX_NODE_SCORE, False, scores)

    def sign(self, pod: Pod):
        na = pod.affinity.node_affinity if pod.affinity else None
        return (tuple(sorted(pod.node_selector.items())), repr(na) if na else "")


class ImageLocality:
    """plugins/imagelocality: score nodes by the bytes of the pod's images
    they already hold, each discounted by the share of nodes that hold it,
    scaled between 23Mi and 1000Mi a container (imagelocality.go
    scaledImageScore)."""

    name = "ImageLocality"
    MIN_THRESHOLD = 23 * 1024 * 1024
    MAX_CONTAINER_THRESHOLD = 1000 * 1024 * 1024

    def __init__(self, handle):
        self.handle = handle

    @classmethod
    def scaled_score(cls, pod: Pod, node_info: NodeInfo, image_nodes: dict,
                     total_nodes: int) -> int:
        """The score of one node, for the host plugin and the device path's
        static score vector (ops/features.py). The spread discount is
        Python float arithmetic, as in the JAX package: integer arithmetic
        would round some scores one lower."""
        sum_scores = 0
        for c in pod.containers:
            size = node_info.image_states.get(c.image)
            if size is None:
                continue
            sum_scores += int(size * (image_nodes.get(c.image, 1) / total_nodes))
        max_threshold = cls.MAX_CONTAINER_THRESHOLD * max(1, len(pod.containers))
        if sum_scores < cls.MIN_THRESHOLD:
            return 0
        if sum_scores > max_threshold:
            return MAX_NODE_SCORE
        return int(MAX_NODE_SCORE * (sum_scores - cls.MIN_THRESHOLD)
                   / (max_threshold - cls.MIN_THRESHOLD))

    def score(self, state: CycleState, pod: Pod, node_info: NodeInfo) -> int:
        snap = self.handle.snapshot()
        return self.scaled_score(pod, node_info, snap.image_num_nodes,
                                 max(1, len(snap.node_info_list)))

    def sign(self, pod: Pod):
        return tuple(sorted(c.image for c in pod.containers))
