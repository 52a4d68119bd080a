"""Fluent Pod/Node builders — the pkg/scheduler/testing/wrappers.go analogue
(st.MakePod().Name("p").Req(...).Obj() style).

Builders for features outside the fit-only slice (spread, pod affinity,
host ports, volumes, gates, pod groups, priority, preferred affinity, node
images) exist so that tests can show the scope guard refusing them."""

from __future__ import annotations

from typing import Dict, Sequence

from ..api.labels import IN, Requirement
from ..api.resource import Resource
from ..api.types import (
    Affinity,
    Container,
    ContainerPort,
    ImageState,
    Node,
    NodeAffinity,
    NodeSelector,
    NodeSelectorTerm,
    Pod,
    PreferredSchedulingTerm,
    Taint,
    Toleration,
    Volume,
)


class MakePod:
    def __init__(self):
        self._pod = Pod(name="pod", containers=[Container(name="c")])

    def name(self, n: str) -> "MakePod":
        self._pod.name = n
        return self

    def namespace(self, ns: str) -> "MakePod":
        self._pod.namespace = ns
        return self

    def label(self, k: str, v: str) -> "MakePod":
        self._pod.labels[k] = v
        return self

    def labels(self, m: Dict[str, str]) -> "MakePod":
        self._pod.labels.update(m)
        return self

    def req(self, requests: Dict[str, object]) -> "MakePod":
        self._pod.containers[0].requests = Resource.from_map(requests)
        return self

    def image(self, img: str) -> "MakePod":
        self._pod.containers[0].image = img
        return self

    def node(self, name: str) -> "MakePod":
        self._pod.node_name = name
        return self

    def priority(self, p: int) -> "MakePod":
        self._pod.priority = p
        return self

    def node_selector(self, sel: Dict[str, str]) -> "MakePod":
        self._pod.node_selector.update(sel)
        return self

    def toleration(self, key: str, value: str = "", operator: str = "Equal",
                   effect: str = "") -> "MakePod":
        self._pod.tolerations.append(
            Toleration(key=key, operator=operator, value=value, effect=effect))
        return self

    def _node_affinity(self) -> NodeAffinity:
        a = self._pod.affinity
        return (a.node_affinity if a is not None and a.node_affinity
                else NodeAffinity())

    def node_affinity_in(self, key: str, values: Sequence[str]) -> "MakePod":
        term = NodeSelectorTerm(
            match_expressions=(Requirement(key, IN, tuple(values)),))
        na = self._node_affinity()
        existing = na.required.terms if na.required else ()
        self._pod.affinity = Affinity(node_affinity=NodeAffinity(
            required=NodeSelector(existing + (term,)), preferred=na.preferred))
        return self

    # -- features the scope guard refuses ----------------------------------

    def preferred_node_affinity(self, weight: int, key: str,
                                values: Sequence[str]) -> "MakePod":
        term = PreferredSchedulingTerm(weight=weight, preference=NodeSelectorTerm(
            match_expressions=(Requirement(key, IN, tuple(values)),)))
        na = self._node_affinity()
        self._pod.affinity = Affinity(node_affinity=NodeAffinity(
            required=na.required, preferred=na.preferred + (term,)))
        return self

    def pod_affinity(self, topology_key: str, match_labels: Dict[str, str],
                     anti: bool = False) -> "MakePod":
        term = {"topologyKey": topology_key, "matchLabels": dict(match_labels)}
        a = self._pod.affinity or Affinity()
        self._pod.affinity = Affinity(
            node_affinity=a.node_affinity,
            pod_affinity=a.pod_affinity if anti else (term,),
            pod_anti_affinity=(term,) if anti else a.pod_anti_affinity)
        return self

    def spread_constraint(self, max_skew: int, topology_key: str,
                          when_unsatisfiable: str = "DoNotSchedule") -> "MakePod":
        self._pod.topology_spread_constraints.append(
            {"maxSkew": max_skew, "topologyKey": topology_key,
             "whenUnsatisfiable": when_unsatisfiable})
        return self

    def host_port(self, port: int, protocol: str = "TCP") -> "MakePod":
        c = self._pod.containers[0]
        c.ports = c.ports + (ContainerPort(host_port=port, protocol=protocol),)
        return self

    def volume(self, pvc_name: str) -> "MakePod":
        self._pod.volumes.append(Volume(name=pvc_name, pvc_name=pvc_name))
        return self

    def resource_claim(self, name: str) -> "MakePod":
        self._pod.resource_claims.append(name)
        return self

    def scheduling_gate(self, name: str) -> "MakePod":
        self._pod.scheduling_gates.append(name)
        return self

    def pod_group(self, name: str) -> "MakePod":
        self._pod.pod_group = name
        return self

    def obj(self) -> Pod:
        return self._pod


class MakeNode:
    def __init__(self):
        self._node = Node(name="node")

    def name(self, n: str) -> "MakeNode":
        self._node.name = n
        self._node.labels["kubernetes.io/hostname"] = n
        return self

    def label(self, k: str, v: str) -> "MakeNode":
        self._node.labels[k] = v
        return self

    def capacity(self, m: Dict[str, object]) -> "MakeNode":
        self._node.capacity = Resource.from_map(m)
        self._node.allocatable = Resource.from_map(m)
        if self._node.allocatable.allowed_pod_number == 0:
            self._node.allocatable.allowed_pod_number = 110
        return self

    def allocatable(self, m: Dict[str, object]) -> "MakeNode":
        self._node.allocatable = Resource.from_map(m)
        return self

    def taint(self, key: str, value: str = "",
              effect: str = "NoSchedule") -> "MakeNode":
        self._node.taints.append(Taint(key=key, value=value, effect=effect))
        return self

    def unschedulable(self, v: bool = True) -> "MakeNode":
        self._node.unschedulable = v
        return self

    def image(self, name: str, size_bytes: int) -> "MakeNode":
        self._node.images.append(ImageState(names=(name,), size_bytes=size_bytes))
        return self

    def zone(self, z: str) -> "MakeNode":
        self._node.labels["topology.kubernetes.io/zone"] = z
        return self

    def obj(self) -> Node:
        return self._node


def make_pod() -> MakePod:
    return MakePod()


def make_node() -> MakeNode:
    return MakeNode()
