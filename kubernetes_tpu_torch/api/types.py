"""The API object model — the subset of staging/src/k8s.io/api/core/v1 the
fit-only scheduling slice consumes, flattened into plain dataclasses.

Fields for features outside the slice (topology spread, pod affinity,
host ports, volumes, claims, gates, pod groups, images) stay on the objects
so that a caller who sets them is refused loudly by the scope guard
(core/scope.py) instead of having the field silently dropped.

Reference anchors:
- Pod/PodSpec/Container:    staging/src/k8s.io/api/core/v1/types.go
- Taint/Toleration:         same file; matching helpers in
                            staging/src/k8s.io/component-helpers/scheduling/corev1
- Affinity/NodeSelector:    same file; matching in component-helpers nodeaffinity
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from .resource import Resource

_uid_counter = itertools.count(1)


def _next_uid(prefix: str) -> str:
    return f"{prefix}-{next(_uid_counter)}"


# ---------------------------------------------------------------------------
# Taints & tolerations
# ---------------------------------------------------------------------------

NO_SCHEDULE = "NoSchedule"
PREFER_NO_SCHEDULE = "PreferNoSchedule"
NO_EXECUTE = "NoExecute"

TOLERATION_OP_EXISTS = "Exists"
TOLERATION_OP_EQUAL = "Equal"


@dataclass(frozen=True)
class Taint:
    key: str
    value: str = ""
    effect: str = NO_SCHEDULE


@dataclass(frozen=True)
class Toleration:
    key: str = ""
    operator: str = TOLERATION_OP_EQUAL
    value: str = ""
    effect: str = ""  # empty matches all effects
    toleration_seconds: Optional[int] = None

    def tolerates(self, taint: Taint) -> bool:
        """component-helpers/scheduling/corev1/helpers.go ToleratesTaint."""
        if self.effect and self.effect != taint.effect:
            return False
        if self.key and self.key != taint.key:
            return False
        # Empty key with Exists matches all keys & values.
        if self.operator == TOLERATION_OP_EXISTS:
            return True
        if self.operator in (TOLERATION_OP_EQUAL, ""):
            return self.value == taint.value
        return False


def find_matching_untolerated_taint(
    taints: Sequence[Taint],
    tolerations: Sequence[Toleration],
    effects: Tuple[str, ...] = (NO_SCHEDULE, NO_EXECUTE),
) -> Optional[Taint]:
    """FindMatchingUntoleratedTaint filtered to scheduling-relevant effects
    (reference tainttoleration/taint_toleration.go Filter)."""
    for taint in taints:
        if taint.effect not in effects:
            continue
        if not any(t.tolerates(taint) for t in tolerations):
            return taint
    return None


# ---------------------------------------------------------------------------
# Node affinity
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class NodeSelectorTerm:
    """matchExpressions AND matchFields, both ANDed within a term."""

    match_expressions: tuple = ()  # Requirement over node labels
    match_fields: tuple = ()  # Requirement over fields (metadata.name only)

    def matches(self, node: "Node") -> bool:
        if not self.match_expressions and not self.match_fields:
            # A term with no requirements matches nothing
            # (component-helpers nodeaffinity: nil-or-empty term => no match).
            return False
        for req in self.match_expressions:
            if not req.matches(node.labels):
                return False
        for req in self.match_fields:
            if not req.matches({"metadata.name": node.name}):
                return False
        return True


@dataclass(frozen=True)
class NodeSelector:
    """ORed list of terms (requiredDuringSchedulingIgnoredDuringExecution)."""

    terms: tuple = ()

    def matches(self, node: "Node") -> bool:
        return any(t.matches(node) for t in self.terms)


@dataclass(frozen=True)
class PreferredSchedulingTerm:
    weight: int
    preference: NodeSelectorTerm


@dataclass(frozen=True)
class NodeAffinity:
    required: Optional[NodeSelector] = None
    preferred: tuple = ()  # PreferredSchedulingTerm (refused by the scope guard)


@dataclass(frozen=True)
class Affinity:
    node_affinity: Optional[NodeAffinity] = None
    # Inter-pod (anti-)affinity: outside the slice, refused when non-empty.
    pod_affinity: Optional[object] = None
    pod_anti_affinity: Optional[object] = None


# ---------------------------------------------------------------------------
# Containers, ports, volumes (carried only so the scope guard can refuse them)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ContainerPort:
    container_port: int = 0
    host_port: int = 0
    protocol: str = "TCP"
    host_ip: str = ""


@dataclass
class Container:
    name: str = ""
    image: str = ""
    requests: Resource = field(default_factory=Resource)
    limits: Resource = field(default_factory=Resource)
    ports: tuple = ()  # ContainerPort
    restart_policy: Optional[str] = None  # "Always" => sidecar init container


@dataclass(frozen=True)
class Volume:
    name: str = ""
    pvc_name: Optional[str] = None  # persistentVolumeClaim.claimName


# ---------------------------------------------------------------------------
# Pod
# ---------------------------------------------------------------------------


@dataclass
class Pod:
    name: str = ""
    namespace: str = "default"
    uid: str = ""
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    # spec
    node_name: str = ""  # assigned node ("" = pending)
    scheduler_name: str = "default-scheduler"
    containers: List[Container] = field(default_factory=list)
    init_containers: List[Container] = field(default_factory=list)
    overhead: Resource = field(default_factory=Resource)
    node_selector: Dict[str, str] = field(default_factory=dict)
    affinity: Optional[Affinity] = None
    tolerations: List[Toleration] = field(default_factory=list)
    topology_spread_constraints: list = field(default_factory=list)
    priority: int = 0
    scheduling_gates: List[str] = field(default_factory=list)
    pod_group: str = ""
    resource_claims: List[str] = field(default_factory=list)
    volumes: List[Volume] = field(default_factory=list)
    # status
    phase: str = "Pending"
    nominated_node_name: str = ""
    # bookkeeping
    creation_ts: float = 0.0
    resource_version: int = 0
    deletion_ts: Optional[float] = None

    def __post_init__(self):
        if not self.uid:
            self.uid = _next_uid("pod")

    # -- derived -----------------------------------------------------------

    def resource_request(self) -> Resource:
        """Effective pod resource request.

        Reference semantics (k8s.io/component-helpers resource
        PodRequests, used at noderesources/fit.go PreFilter):
          total = sum(app containers) ; fold in init containers as
          max(total, each non-sidecar init container) with sidecar
          (restartPolicy=Always) init requests added to the running total;
          then add pod overhead.
        """
        cached = getattr(self, "_req_cache", None)
        if cached is not None:
            return cached
        total = Resource()
        for c in self.containers:
            total.add(c.requests)
        sidecar_sum = Resource()
        init_max = Resource()
        for ic in self.init_containers:
            if ic.restart_policy == "Always":
                sidecar_sum.add(ic.requests)
                init_max.set_max(sidecar_sum.clone())
            else:
                peek = sidecar_sum.clone()
                peek.add(ic.requests)
                init_max.set_max(peek)
        total.add(sidecar_sum)
        total.set_max(init_max)
        if self.overhead is not None:
            total.add(self.overhead)
        # Memoized: container requests are spec (immutable once created);
        # callers must not mutate the returned Resource (they clone()).
        self._req_cache = total
        return total

    def host_ports(self) -> List[ContainerPort]:
        return [p for c in self.containers for p in c.ports if p.host_port > 0]

    def __copy__(self) -> "Pod":
        new = object.__new__(Pod)
        new.__dict__.update(self.__dict__)
        return new

    def clone_from_template(self, name: str) -> "Pod":
        """Stamp a new pod from this template prototype: a fresh identity
        over SHARED spec objects, plus a shared signature-memo holder so a
        workload of N template pods signs once (Framework.sign_pod).
        Callers never mutate spec objects in place."""
        shared = self.__dict__.get("_sig_shared")
        if shared is None:
            shared = self._sig_shared = {}
            self.resource_request()
        new = object.__new__(Pod)
        new.__dict__.update(self.__dict__)
        new.name = name
        new.uid = _next_uid("pod")
        new.resource_version = 0
        return new

    def required_node_selector_matches(self, node: "Node") -> bool:
        """nodeSelector AND requiredDuringScheduling node affinity
        (component-helpers nodeaffinity GetRequiredNodeAffinity)."""
        for k, v in self.node_selector.items():
            if node.labels.get(k) != v:
                return False
        na = self.affinity.node_affinity if self.affinity else None
        if na and na.required is not None:
            if not na.required.matches(node):
                return False
        return True


# ---------------------------------------------------------------------------
# Node
# ---------------------------------------------------------------------------

LABEL_HOSTNAME = "kubernetes.io/hostname"
LABEL_ZONE = "topology.kubernetes.io/zone"
LABEL_REGION = "topology.kubernetes.io/region"


@dataclass
class ImageState:
    names: tuple = ()
    size_bytes: int = 0


@dataclass
class Node:
    name: str = ""
    uid: str = ""
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    # spec
    taints: List[Taint] = field(default_factory=list)
    unschedulable: bool = False
    # status
    capacity: Resource = field(default_factory=Resource)
    allocatable: Resource = field(default_factory=Resource)
    images: List[ImageState] = field(default_factory=list)
    resource_version: int = 0

    def __post_init__(self):
        if not self.uid:
            self.uid = _next_uid("node")
        if not self.labels.get(LABEL_HOSTNAME):
            self.labels[LABEL_HOSTNAME] = self.name
