"""NodeInfo / PodInfo — the per-node aggregate the scheduler filters against.

Re-expresses pkg/scheduler/framework/types.go (NodeInfo struct at types.go:173),
trimmed to the fit-only slice: each node carries its pod list, the summed
`requested` vector, the non-zero-default aggregate that scoring reads, and a
monotonically increasing `generation` that drives incremental snapshotting
(backend/cache/cache.go:206 UpdateSnapshot) and the device mirror's re-encode.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import List, Optional

from ..api.resource import Resource
from ..api.types import Node, Pod

_generation = itertools.count(1)


def next_generation() -> int:
    return next(_generation)


@dataclass
class PodInfo:
    """A Pod with its precomputed request (framework/types.go PodInfo)."""

    pod: Pod
    request: Resource

    @classmethod
    def of(cls, pod: Pod) -> "PodInfo":
        return cls(pod=pod, request=pod.resource_request())


class NodeInfo:
    """Aggregated node state. Mutable; every mutation bumps `generation`."""

    __slots__ = ("node", "pods", "requested", "non_zero_requested",
                 "allocatable", "generation")

    # Default requests for the "non-zero" aggregate used by scoring
    # (reference framework/types.go DefaultMilliCPURequest/DefaultMemoryRequest).
    DEFAULT_MILLI_CPU = 100
    DEFAULT_MEMORY = 200 * 1024 * 1024

    def __init__(self, node: Optional[Node] = None):
        self.node: Optional[Node] = node
        self.pods: List[PodInfo] = []
        self.requested = Resource()
        self.non_zero_requested = Resource()
        self.allocatable = node.allocatable.clone() if node else Resource()
        self.generation = next_generation()

    def set_node(self, node: Node) -> None:
        self.node = node
        self.allocatable = node.allocatable.clone()
        self.generation = next_generation()

    def add_pod(self, pi: PodInfo) -> None:
        self.pods.append(pi)
        req = pi.request
        self.requested.add(req)
        self.non_zero_requested.milli_cpu += req.milli_cpu or self.DEFAULT_MILLI_CPU
        self.non_zero_requested.memory += req.memory or self.DEFAULT_MEMORY
        self.generation = next_generation()

    def remove_pod(self, pod: Pod) -> bool:
        for i, pi in enumerate(self.pods):
            if pi.pod.uid == pod.uid:
                self.pods.pop(i)
                req = pi.request
                self.requested.sub(req)
                self.non_zero_requested.milli_cpu -= req.milli_cpu or self.DEFAULT_MILLI_CPU
                self.non_zero_requested.memory -= req.memory or self.DEFAULT_MEMORY
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
        c.requested = self.requested.clone()
        c.non_zero_requested = self.non_zero_requested.clone()
        c.allocatable = self.allocatable.clone()
        c.generation = self.generation
        return c
