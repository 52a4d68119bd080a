"""The port's scope guard: the fit-only slice knows only the plugins in
core/registry.py, so an object that needs anything else is refused with
NotImplementedError naming the feature — never scheduled while ignoring a
constraint. Called by FakeClientset on every pod/node write and by the
queue on admission."""

from __future__ import annotations

from ..api.types import PREFER_NO_SCHEDULE, Node, Pod


def pod_unsupported(pod: Pod) -> str:
    """The first out-of-slice feature `pod` uses, or "" when it is in scope."""
    aff = pod.affinity
    if pod.topology_spread_constraints:
        return "topology spread constraints"
    if aff is not None and (aff.pod_affinity or aff.pod_anti_affinity):
        return "pod (anti-)affinity"
    if aff is not None and aff.node_affinity is not None and aff.node_affinity.preferred:
        return "preferred node affinity"
    if pod.host_ports():
        return "host ports"
    if pod.volumes:
        return "volumes/PVCs"
    if pod.resource_claims:
        return "resource claims"
    if pod.scheduling_gates:
        return "scheduling gates"
    if pod.pod_group:
        return "pod groups"
    if pod.priority != 0:
        return "non-zero priority (no preemption in this slice)"
    return ""


def node_unsupported(node: Node) -> str:
    """The first out-of-slice feature `node` uses, or "" when it is in scope."""
    if any(t.effect == PREFER_NO_SCHEDULE for t in node.taints):
        return "PreferNoSchedule taints"
    if node.images:
        return "node images (ImageLocality)"
    return ""


def check_pod(pod: Pod) -> None:
    reason = pod_unsupported(pod)
    if reason:
        raise NotImplementedError(
            f"pod {pod.namespace}/{pod.name}: {reason} is outside the "
            "kubernetes_tpu_torch fit-only slice")


def check_node(node: Node) -> None:
    reason = node_unsupported(node)
    if reason:
        raise NotImplementedError(
            f"node {node.name}: {reason} is outside the "
            "kubernetes_tpu_torch fit-only slice")
