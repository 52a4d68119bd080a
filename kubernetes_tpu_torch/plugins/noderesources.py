"""NodeResourcesFit and NodeResourcesBalancedAllocation.

Reference anchors:
- Filter semantics:  plugins/noderesources/fit.go (fitsRequest :710 — per-
  resource `request > allocatable − requested` rejection, Unresolvable when
  request > allocatable).
- LeastAllocated:    least_allocated.go:30-62.
- MostAllocated:     most_allocated.go (requested * 100 / allocatable).
- BalancedAllocation: balanced_allocation.go:204-253, two-resource form
  quantized to millionths so host and device agree bit for bit.
- Non-zero defaults: framework/types.go GetNonzeroRequests (100 mCPU / 200Mi)
  feed scoring (not filtering), via NodeInfo.non_zero_requested.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from ..api import resource as res
from ..api.resource import Resource
from ..api.types import Pod
from ..core.framework import MAX_NODE_SCORE, OK, CycleState, PreFilterResult, Status
from ..core.node_info import NodeInfo
from ..core.queue import (
    EVENT_ASSIGNED_POD_DELETE,
    EVENT_NODE_ADD,
    EVENT_NODE_UPDATE,
    EVENT_POD_DELETE,
)

LEAST_ALLOCATED = "LeastAllocated"
MOST_ALLOCATED = "MostAllocated"

DEFAULT_RESOURCES = ({"name": res.CPU, "weight": 1}, {"name": res.MEMORY, "weight": 1})


def fits_request(req: Resource, node_info: NodeInfo) -> List[Tuple[str, bool]]:
    """fit.go:710 fitsRequest: (resource, unresolvable) per shortfall."""
    out: List[Tuple[str, bool]] = []
    alloc = node_info.allocatable
    used = node_info.requested
    if len(node_info.pods) + 1 > alloc.allowed_pod_number:
        out.append((res.PODS, False))
    if req.is_zero():
        return out
    for name in (res.CPU, res.MEMORY, res.EPHEMERAL_STORAGE, *req.scalar_resources):
        amount = req.get(name)
        if amount > 0 and amount > alloc.get(name) - used.get(name):
            out.append((name, amount > alloc.get(name)))
    return out


def least_requested_score(requested: int, capacity: int) -> int:
    if capacity == 0 or requested > capacity:
        return 0
    return (capacity - requested) * MAX_NODE_SCORE // capacity


def most_requested_score(requested: int, capacity: int) -> int:
    if capacity == 0:
        return 0
    return min(requested, capacity) * MAX_NODE_SCORE // capacity


def _used(name: str, node_info: NodeInfo, req: Resource) -> int:
    """Scoring's view of usage: non-zero defaults for cpu/memory."""
    if name == res.CPU:
        return node_info.non_zero_requested.milli_cpu + (req.milli_cpu or NodeInfo.DEFAULT_MILLI_CPU)
    if name == res.MEMORY:
        return node_info.non_zero_requested.memory + (req.memory or NodeInfo.DEFAULT_MEMORY)
    return node_info.requested.get(name) + req.get(name)


class Fit:
    """NodeResourcesFit (fit.go) with the LeastAllocated and MostAllocated
    scoring strategies."""

    name = "NodeResourcesFit"
    _KEY = "PreFilterNodeResourcesFit"

    def __init__(self, scoring_strategy: str = LEAST_ALLOCATED,
                 resources: Sequence[Dict] = DEFAULT_RESOURCES):
        if scoring_strategy not in (LEAST_ALLOCATED, MOST_ALLOCATED):
            raise NotImplementedError(
                f"NodeResourcesFit strategy {scoring_strategy!r} is outside what "
                "kubernetes_tpu_torch covers")
        self.scoring_strategy = scoring_strategy
        self.resources = tuple(resources)
        self._dra = None  # set_framework: DynamicResources backing extended resources

    def set_framework(self, fw) -> None:
        """Extended resources that a DeviceClass maps are DynamicResources'
        to satisfy when its extended-resources branch is on (fit.go with
        extendeddynamicresources.go; the JAX package's DRAExtendedResource
        gate): the fit request then leaves them out."""
        dr = fw.plugin("DynamicResources")
        self._dra = dr if dr is not None and dr.extended_resources else None

    def _request(self, state: CycleState, pod: Pod) -> Resource:
        req = state.read(self._KEY) if self._dra is not None else None
        return pod.resource_request() if req is None else req

    def _effective_request(self, pod: Pod) -> Resource:
        """The pod's request without the extended resources a DeviceClass
        maps (DynamicResources.filter checks the device plugin against DRA
        split a node, so dropping them here is exact)."""
        req = pod.resource_request()
        if not req.scalar_resources:
            return req
        strip = {dc.extended_resource_name for dc in self._dra.handle.device_classes.values()
                 if dc.extended_resource_name} & set(req.scalar_resources)
        if not strip:
            return req
        eff = req.clone()
        for name in strip:
            eff.scalar_resources.pop(name, None)
        return eff

    def events_to_register(self):
        """fit.go EventsToRegister: node add/update when the node could hold
        the request outright; pod deletes always (a freed pod slot)."""
        return [(EVENT_NODE_ADD, self._hint_node_change),
                (EVENT_NODE_UPDATE, self._hint_node_change),
                (EVENT_ASSIGNED_POD_DELETE, None),
                (EVENT_POD_DELETE, None)]

    @staticmethod
    def _hint_node_change(pod: Pod, old, new) -> bool:
        if new is None:
            return True
        req = pod.resource_request()
        alloc = new.allocatable
        return all(req.get(name) <= alloc.get(name)
                   for name in (res.CPU, res.MEMORY, res.EPHEMERAL_STORAGE,
                                *req.scalar_resources))

    def pre_filter(self, state: CycleState, pod: Pod,
                   nodes) -> Tuple[Optional[PreFilterResult], Status]:
        if self._dra is not None:
            state.write(self._KEY, self._effective_request(pod))
        return None, OK

    def filter(self, state: CycleState, pod: Pod, node_info: NodeInfo) -> Status:
        insufficient = fits_request(self._request(state, pod), node_info)
        if insufficient:
            reasons = tuple(f"Insufficient {name}" for name, _ in insufficient)
            if any(u for _, u in insufficient):
                return Status.unresolvable(*reasons)
            return Status.unschedulable(*reasons)
        return OK

    def score(self, state: CycleState, pod: Pod, node_info: NodeInfo) -> int:
        req = self._request(state, pod)
        node_score = 0
        weight_sum = 0
        for spec in self.resources:
            name, weight = spec["name"], spec.get("weight", 1)
            alloc = node_info.allocatable.get(name)
            if alloc == 0:
                continue
            used = _used(name, node_info, req)
            if self.scoring_strategy == LEAST_ALLOCATED:
                rscore = least_requested_score(used, alloc)
            else:
                rscore = most_requested_score(used, alloc)
            node_score += rscore * weight
            weight_sum += weight
        return node_score // weight_sum if weight_sum else 0

    def score_placement(self, state: CycleState, group, pga) -> Tuple[int, Status]:
        """PlacementScore (resource_allocation.go:505 scorePlacement; the
        JAX package's :289-310): the strategy formula over the placement's
        aggregate allocatable and requested, the proposed members'
        requests included."""
        node_score = 0
        weight_sum = 0
        for spec in self.resources:
            name, weight = spec["name"], spec.get("weight", 1)
            used = 0
            for pod, _node in pga.proposed:
                req = pod.resource_request()
                if name == res.CPU:
                    used += req.milli_cpu or NodeInfo.DEFAULT_MILLI_CPU
                elif name == res.MEMORY:
                    used += req.memory or NodeInfo.DEFAULT_MEMORY
                else:
                    used += req.get(name)
            alloc = 0
            for ni in pga.nodes:
                alloc += ni.allocatable.get(name)
                if name == res.CPU:
                    used += ni.non_zero_requested.milli_cpu
                elif name == res.MEMORY:
                    used += ni.non_zero_requested.memory
                else:
                    used += ni.requested.get(name)
            if alloc == 0:
                continue
            if self.scoring_strategy == LEAST_ALLOCATED:
                rscore = least_requested_score(used, alloc)
            else:
                rscore = most_requested_score(used, alloc)
            node_score += rscore * weight
            weight_sum += weight
        return (node_score // weight_sum if weight_sum else 0), OK

    def sign(self, pod: Pod):
        r = pod.resource_request()
        return (r.milli_cpu, r.memory, r.ephemeral_storage,
                tuple(sorted(r.scalar_resources.items())))


class BalancedAllocation:
    """NodeResourcesBalancedAllocation (balanced_allocation.go) over cpu and
    memory, with utilization fractions quantized to millionths (integer
    math) so host and device agree bit for bit."""

    name = "NodeResourcesBalancedAllocation"
    FRACTION_SCALE = 1_000_000

    def pre_score(self, state: CycleState, pod: Pod, nodes) -> Status:
        req = pod.resource_request()
        # Best-effort pods skip BalancedAllocation (PreScore Skip).
        if req.milli_cpu == 0 and req.memory == 0:
            return Status.skip()
        return OK

    def score(self, state: CycleState, pod: Pod, node_info: NodeInfo) -> int:
        req = pod.resource_request()
        qs = []
        for name in (res.CPU, res.MEMORY):
            alloc = node_info.allocatable.get(name)
            if alloc == 0:
                continue
            qs.append(min(_used(name, node_info, req) * self.FRACTION_SCALE // alloc,
                          self.FRACTION_SCALE))
        if len(qs) < 2:
            return MAX_NODE_SCORE
        # floor(100 - 50*|f1-f2|) in exact integer arithmetic.
        return (MAX_NODE_SCORE * self.FRACTION_SCALE
                - 50 * abs(qs[0] - qs[1])) // self.FRACTION_SCALE

    def sign(self, pod: Pod):
        r = pod.resource_request()
        return (r.milli_cpu, r.memory, tuple(sorted(r.scalar_resources.items())))
