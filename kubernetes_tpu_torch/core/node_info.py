"""NodeInfo / PodInfo — the per-node aggregate the scheduler filters against.

Re-expresses pkg/scheduler/framework/types.go (NodeInfo struct at types.go:173),
trimmed to the port's slices: each node carries its pod list, the sublists
of pods with (anti-)affinity terms that InterPodAffinity walks, the summed
`requested` vector, the non-zero-default aggregate that scoring reads, the
host ports its pods hold (NodePorts), the claims its pods mount
(NodeVolumeLimits, VolumeRestrictions), its images' sizes (ImageLocality),
and a monotonically increasing `generation` that drives incremental snapshotting
(backend/cache/cache.go:206 UpdateSnapshot) and the device mirror's re-encode.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from types import MappingProxyType
from typing import FrozenSet, List, Mapping, Optional, Tuple

from ..api.resource import Resource
from ..api.types import Node, Pod

_generation = itertools.count(1)


def next_generation() -> int:
    return next(_generation)


@dataclass
class PodInfo:
    """A Pod with its precomputed request, host ports, claim keys ("ns/name"
    of each PVC-backed volume) and affinity term lists (framework/types.go
    PodInfo)."""

    pod: Pod
    request: Resource
    required_affinity_terms: tuple = ()
    required_anti_affinity_terms: tuple = ()
    preferred_affinity_terms: tuple = ()
    preferred_anti_affinity_terms: tuple = ()
    host_ports: tuple = ()
    pvc_keys: tuple = ()

    @classmethod
    def of(cls, pod: Pod) -> "PodInfo":
        aff = pod.affinity
        req_aff = req_anti = pref_aff = pref_anti = ()
        if aff is not None:
            if aff.pod_affinity is not None:
                req_aff = tuple(aff.pod_affinity.required)
                pref_aff = tuple(aff.pod_affinity.preferred)
            if aff.pod_anti_affinity is not None:
                req_anti = tuple(aff.pod_anti_affinity.required)
                pref_anti = tuple(aff.pod_anti_affinity.preferred)
        return cls(pod=pod, request=pod.resource_request(),
                   required_affinity_terms=req_aff, required_anti_affinity_terms=req_anti,
                   preferred_affinity_terms=pref_aff,
                   preferred_anti_affinity_terms=pref_anti, host_ports=pod.host_ports(),
                   pvc_keys=tuple(f"{pod.namespace}/{v.pvc_name}" for v in pod.volumes
                                  if v.pvc_name) if pod.volumes else ())

    @property
    def has_affinity(self) -> bool:
        return bool(self.required_affinity_terms or self.preferred_affinity_terms
                    or self.required_anti_affinity_terms
                    or self.preferred_anti_affinity_terms)


class NodeInfo:
    """Aggregated node state. Mutable; every mutation bumps `generation`."""

    __slots__ = ("node", "pods", "pods_with_affinity", "pods_with_required_anti_affinity",
                 "requested", "non_zero_requested", "allocatable", "used_ports",
                 "pvc_ref_counts", "image_states", "generation")

    # Default requests for the "non-zero" aggregate used by scoring
    # (reference framework/types.go DefaultMilliCPURequest/DefaultMemoryRequest).
    DEFAULT_MILLI_CPU = 100
    DEFAULT_MEMORY = 200 * 1024 * 1024

    def __init__(self, node: Optional[Node] = None):
        self.node: Optional[Node] = node
        self.pods: List[PodInfo] = []
        self.pods_with_affinity: List[PodInfo] = []
        self.pods_with_required_anti_affinity: List[PodInfo] = []
        self.requested = Resource()
        self.non_zero_requested = Resource()
        self.allocatable = node.allocatable.clone() if node else Resource()
        # (protocol, host_ip, port) held by the node's pods, claim key ->
        # the node's pods that mount it, and image name -> bytes. Each is
        # replaced, never changed in place, so a snapshot clone shares them,
        # and a node without ports, claims or images allocates nothing for
        # them.
        self.used_ports: FrozenSet[Tuple[str, str, int]] = _NO_PORTS
        self.pvc_ref_counts: Mapping[str, int] = _NO_PVCS
        self.image_states: Mapping[str, int] = _image_states(node)
        self.generation = next_generation()

    def set_node(self, node: Node) -> None:
        self.node = node
        self.allocatable = node.allocatable.clone()
        self.image_states = _image_states(node)
        self.generation = next_generation()

    def add_pod(self, pi: PodInfo) -> None:
        self.pods.append(pi)
        if pi.has_affinity:
            self.pods_with_affinity.append(pi)
        if pi.required_anti_affinity_terms:
            self.pods_with_required_anti_affinity.append(pi)
        req = pi.request
        self.requested.add(req)
        self.non_zero_requested.milli_cpu += req.milli_cpu or self.DEFAULT_MILLI_CPU
        self.non_zero_requested.memory += req.memory or self.DEFAULT_MEMORY
        if pi.host_ports:
            self.used_ports = self.used_ports | {(p.protocol, p.host_ip, p.host_port)
                                                 for p in pi.host_ports}
        if pi.pvc_keys:
            counts = dict(self.pvc_ref_counts)
            for key in pi.pvc_keys:
                counts[key] = counts.get(key, 0) + 1
            self.pvc_ref_counts = MappingProxyType(counts)
        self.generation = next_generation()

    def remove_pod(self, pod: Pod) -> bool:
        for i, pi in enumerate(self.pods):
            if pi.pod.uid == pod.uid:
                self.pods.pop(i)
                self.pods_with_affinity = [p for p in self.pods_with_affinity
                                           if p.pod.uid != pod.uid]
                self.pods_with_required_anti_affinity = [
                    p for p in self.pods_with_required_anti_affinity if p.pod.uid != pod.uid]
                req = pi.request
                self.requested.sub(req)
                self.non_zero_requested.milli_cpu -= req.milli_cpu or self.DEFAULT_MILLI_CPU
                self.non_zero_requested.memory -= req.memory or self.DEFAULT_MEMORY
                if pi.host_ports:
                    self.used_ports = self.used_ports - {(p.protocol, p.host_ip, p.host_port)
                                                         for p in pi.host_ports}
                if pi.pvc_keys:
                    counts = dict(self.pvc_ref_counts)
                    for key in pi.pvc_keys:
                        n = counts.get(key, 0) - 1
                        if n <= 0:
                            counts.pop(key, None)
                        else:
                            counts[key] = n
                    self.pvc_ref_counts = MappingProxyType(counts) if counts else _NO_PVCS
                self.generation = next_generation()
                return True
        return False

    @property
    def name(self) -> str:
        return self.node.name if self.node else ""

    def snapshot_clone(self) -> "NodeInfo":
        """Clone for an immutable per-cycle snapshot; PodInfo entries shared."""
        c = NodeInfo.__new__(NodeInfo)
        c.node = self.node
        c.pods = list(self.pods)
        c.pods_with_affinity = list(self.pods_with_affinity)
        c.pods_with_required_anti_affinity = list(self.pods_with_required_anti_affinity)
        c.requested = self.requested.clone()
        c.non_zero_requested = self.non_zero_requested.clone()
        c.allocatable = self.allocatable.clone()
        c.used_ports = self.used_ports
        c.pvc_ref_counts = self.pvc_ref_counts
        c.image_states = self.image_states
        c.generation = self.generation
        return c


_NO_PORTS: FrozenSet[Tuple[str, str, int]] = frozenset()
_NO_PVCS: Mapping[str, int] = MappingProxyType({})
_NO_IMAGES: Mapping[str, int] = MappingProxyType({})


def _image_states(node: Optional[Node]) -> Mapping[str, int]:
    """Every name of the node's images -> the image's size in bytes."""
    if node is None or not node.images:
        return _NO_IMAGES
    return MappingProxyType({name: img.size_bytes for img in node.images
                             for name in img.names})
