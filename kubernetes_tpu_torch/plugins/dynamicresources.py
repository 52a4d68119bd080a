"""DynamicResources: DRA claim allocation during scheduling (the JAX
package's plugins/dynamicresources.py; the reference's
plugins/dynamicresources/).

PreFilter fetches the pod's claims (a missing one is unresolvable; an
allocated one pins the node), Filter tries the allocation on each node over
its ResourceSlices (structured parameters), Reserve assumes the winning
allocation in the assume cache, Unreserve reverts it, and PreBind writes
the claims' status and reservedFor.

The reference gates two branches behind feature gates the port does not
have (the JAX package's core/features.py:59-62, both off by default):
extended resources backed by a DeviceClass (DRAExtendedResource) and
devices that consume node allocatable (DRANodeAllocatableResources). Here
they are the constructor's `extended_resources` and `node_allocatable`,
off by default as those gates are.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from ..api.dra import AllocatedDevice, DeviceRequest, ResourceClaim, compile_device_expression
from ..api.resource import cpu_to_milli, to_int
from ..api.types import Pod
from ..core.framework import OK, CycleState, PreFilterResult, Status
from ..core.node_info import NodeInfo

ERR_CLAIM_NOT_FOUND = 'resourceclaim "%s" not found'
ERR_ALLOCATED_ELSEWHERE = "resourceclaim was allocated for a different node"
ERR_NO_DEVICES = "node(s) didn't have enough free devices for the claims"


class DynamicResources:
    name = "DynamicResources"
    # Reserve and PreBind act only on CycleState written in PreFilter (no-ops
    # on a fresh state): the device commit's lean tail may skip them.
    state_driven_tail = True
    _KEY = "PreFilterDynamicResources"

    def __init__(self, handle=None, extended_resources: bool = False,
                 node_allocatable: bool = False):
        self.handle = handle
        self.extended_resources = extended_resources
        self.node_allocatable = node_allocatable
        # The assume cache (dra_manager.go): the devices of in-flight
        # reservations, and their node, a claim.
        self.assumed: Dict[str, List[AllocatedDevice]] = {}
        self.assumed_nodes: Dict[str, str] = {}
        # The in-use device set, rebuilt when the clientset's claims
        # revision moves and kept by Reserve and Unreserve in between (a
        # rebuild a cycle made the claim-template workload quadratic).
        self._iu_cache: Optional[Set[Tuple[str, str, str]]] = None
        self._iu_rv = -1

    def _extended_claim_for(self, pod: Pod) -> Optional[ResourceClaim]:
        """Extended resources backed by DRA (extendeddynamicresources.go
        preFilterExtendedResources): a pod requesting an extended resource
        that a DeviceClass maps gets an in-memory claim for that many
        devices of the class, created for real in PreBind."""
        if not self.extended_resources:
            return None
        req = pod.resource_request()
        if not req.scalar_resources:
            return None
        by_ext = {dc.extended_resource_name: dc for dc in self.handle.device_classes.values()
                  if dc.extended_resource_name}
        if not by_ext:
            return None
        requests = []
        for rname, amount in req.scalar_resources.items():
            dc = by_ext.get(rname)
            if dc is not None and amount > 0:
                requests.append(DeviceRequest(name=rname, device_class=dc.name,
                                              count=int(amount)))
        if not requests:
            return None
        # Named for its pod: the assume cache keys on claim.key.
        return ResourceClaim(name=f"{pod.name}-extended-resources", namespace=pod.namespace,
                             requests=requests)

    def _in_use(self) -> Set[Tuple[str, str, str]]:
        """(node, driver, device) of every device allocated or assumed,
        cached against the clientset's claims revision; Reserve, Unreserve
        and PreBind keep it in between (their net effect on the set is the
        triples they add or remove)."""
        rv = self.handle.clientset.resource_claims_rv
        if self._iu_cache is not None and self._iu_rv == rv:
            return self._iu_cache
        used: Set[Tuple[str, str, str]] = set()
        for claim in self.handle.resource_claims.values():
            if claim.allocated:
                for d in claim.allocations:
                    used.add((claim.allocated_node, d.driver, d.device))
        for key, devices in self.assumed.items():
            node = self.assumed_nodes.get(key, "")
            for d in devices:
                used.add((node, d.driver, d.device))
        self._iu_cache = used
        self._iu_rv = rv
        return used

    # -- PreFilter -----------------------------------------------------------

    @dataclass
    class _State:
        claims: List[ResourceClaim] = field(default_factory=list)
        pinned_node: str = ""  # an allocation already fixes the node
        # node -> [(claim, devices)]
        node_allocations: Dict[str, List[Tuple[ResourceClaim, List[AllocatedDevice]]]] = field(
            default_factory=dict)
        # The devices taken by allocations and assumptions, read once a
        # cycle in PreFilter (a scan of every claim a node would make the
        # 500-node workload O(claims x nodes x pods)).
        in_use: Optional[Set[Tuple[str, str, str]]] = None
        # The extended-resources claim (in memory until PreBind).
        special: Optional[ResourceClaim] = None

        def clone(self) -> "DynamicResources._State":
            return DynamicResources._State(
                claims=list(self.claims),
                pinned_node=self.pinned_node,
                node_allocations={k: list(v) for k, v in self.node_allocations.items()},
                in_use=set(self.in_use) if self.in_use is not None else None,
                special=self.special)

    def pre_filter(self, state: CycleState, pod: Pod,
                   nodes) -> Tuple[Optional[PreFilterResult], Status]:
        names = pod.resource_claims
        special = self._extended_claim_for(pod) if not names else None
        if not names and special is None:
            return None, Status.skip()
        s = self._State()
        if special is not None:
            s.claims.append(special)
            s.special = special
            s.in_use = self._in_use()
            state.write(self._KEY, s)
            return None, OK
        pinned: Optional[str] = None
        for name in names:
            claim = self.handle.resource_claims.get(f"{pod.namespace}/{name}")
            if claim is None:
                return None, Status.unresolvable(ERR_CLAIM_NOT_FOUND % name)
            s.claims.append(claim)
            if claim.allocated:
                if pinned is not None and claim.allocated_node != pinned:
                    return None, Status.unresolvable(ERR_ALLOCATED_ELSEWHERE)
                pinned = claim.allocated_node
        state.write(self._KEY, s)
        if pinned is not None and all(c.allocated for c in s.claims):
            # Every claim allocated: only the pinned node is checked, and the
            # in-use set (which feeds fresh allocations only) is not read.
            s.pinned_node = pinned
            return PreFilterResult({pinned}), OK
        s.in_use = self._in_use()
        if pinned is not None:
            s.pinned_node = pinned
            return PreFilterResult({pinned}), OK
        return None, OK

    # -- Filter: an allocation attempt on the node -----------------------------

    @staticmethod
    def _matcher_for(req):
        """The request's compiled expression, memoized on the request (the
        reference compiles each CEL program once)."""
        if not req.expression:
            return None
        cached = req.__dict__.get("_compiled_expr")
        if cached is None:
            cached = req._compiled_expr = compile_device_expression(req.expression)
        return cached

    def filter(self, state: CycleState, pod: Pod, node_info: NodeInfo) -> Status:
        s: Optional[DynamicResources._State] = state.read(self._KEY)
        if s is None:
            return OK
        node_name = node_info.name
        if s.pinned_node:
            return OK if node_name == s.pinned_node else Status.unschedulable(
                ERR_ALLOCATED_ELSEWHERE)
        in_use = s.in_use if s.in_use is not None else self._in_use()
        taken: Set[Tuple[str, str]] = set()
        allocations: List[Tuple[ResourceClaim, List[AllocatedDevice]]] = []
        slices = self.handle.resource_slices.get(node_name, [])
        for claim in s.claims:
            if claim.allocated:
                continue
            devices: List[AllocatedDevice] = []
            for req in claim.requests:
                count = req.count
                if claim is s.special:
                    # The node's device plugin satisfies an extended resource
                    # outright where it advertises enough
                    # (filterExtendedResources).
                    free = (node_info.allocatable.scalar_resources.get(req.name, 0)
                            - node_info.requested.scalar_resources.get(req.name, 0))
                    if free >= count:
                        continue
                found = 0
                for driver, dev in _request_devices(self.handle, node_name, slices, req,
                                                    in_use, taken):
                    if found >= count:
                        break
                    devices.append(AllocatedDevice(driver, dev))
                    taken.add((driver, dev))
                    found += 1
                if found < count:
                    return Status.unschedulable(ERR_NO_DEVICES)
            allocations.append((claim, devices))
        st = self._check_node_allocatable(pod, node_info, allocations, slices, in_use)
        if st is not None:
            return st
        s.node_allocations[node_name] = allocations
        return OK

    def _check_node_allocatable(self, pod: Pod, node_info: NodeInfo, allocations, slices,
                                in_use=None) -> Optional[Status]:
        """Devices that consume node allocatable
        (nodeallocatabledynamicresources.go): the pod's requests plus its
        chosen devices' and the node's allocated devices' consumption must
        fit the node's remaining allocatable."""
        if not self.node_allocatable:
            return None
        dev_objs = {}
        for sl in slices:
            for dev in sl.devices:
                if dev.consumes:
                    dev_objs[(sl.driver, dev.name)] = dev
        if not dev_objs:
            return None
        extra_cpu = extra_mem = 0
        for _claim, devices in allocations:
            for ad in devices:
                dev = dev_objs.get((ad.driver, ad.device))
                if dev is None:
                    continue
                if "cpu" in dev.consumes:
                    extra_cpu += cpu_to_milli(dev.consumes["cpu"])
                if "memory" in dev.consumes:
                    extra_mem += to_int(dev.consumes["memory"])
        # Devices already allocated on the node consume allocatable that
        # NodeInfo.requested (containers only) does not hold.
        node_name = node_info.name
        if in_use:
            for (driver, name), dev in dev_objs.items():
                if (node_name, driver, name) in in_use:
                    if "cpu" in dev.consumes:
                        extra_cpu += cpu_to_milli(dev.consumes["cpu"])
                    if "memory" in dev.consumes:
                        extra_mem += to_int(dev.consumes["memory"])
        if not extra_cpu and not extra_mem:
            return None
        req = pod.resource_request()
        alloc = node_info.allocatable
        used = node_info.requested
        if (req.milli_cpu + extra_cpu > alloc.milli_cpu - used.milli_cpu
                or req.memory + extra_mem > alloc.memory - used.memory):
            return Status.unschedulable("node(s) lack allocatable for DRA device consumption")
        return None

    # -- Reserve / Unreserve / PreBind -----------------------------------------

    def reserve(self, state: CycleState, pod: Pod, node_name: str) -> Status:
        s: Optional[DynamicResources._State] = state.read(self._KEY)
        if s is None:
            return OK
        for claim, devices in s.node_allocations.get(node_name, ()):
            self.assumed[claim.key] = devices
            self.assumed_nodes[claim.key] = node_name
            if self._iu_cache is not None:
                for d in devices:
                    self._iu_cache.add((node_name, d.driver, d.device))
        return OK

    def unreserve(self, state: CycleState, pod: Pod, node_name: str) -> None:
        s: Optional[DynamicResources._State] = state.read(self._KEY)
        if s is None:
            return
        for claim, devices in s.node_allocations.get(node_name, ()):
            self.assumed.pop(claim.key, None)
            self.assumed_nodes.pop(claim.key, None)
            if self._iu_cache is not None:
                for d in devices:
                    self._iu_cache.discard((node_name, d.driver, d.device))

    def pre_bind_pre_flight(self, state: CycleState, pod: Pod, node_name: str) -> Status:
        """Skip when the pod references no claim and no extended-resources
        claim was built for it this cycle (dynamicresources.go
        PreBindPreFlight)."""
        if pod.resource_claims:
            return OK
        s = state.read(self._KEY)
        if s is not None and s.special is not None:
            return OK
        return Status.skip()

    def pre_bind(self, state: CycleState, pod: Pod, node_name: str) -> Status:
        s: Optional[DynamicResources._State] = state.read(self._KEY)
        if s is None:
            return OK
        if s.special is not None and any(
                devices for claim, devices in s.node_allocations.get(node_name, ())
                if claim is s.special):
            # bindClaim (extendeddynamicresources.go): the in-memory claim
            # becomes an API object, and the pod records it. Where the
            # node's device plugin satisfied every request no claim is made.
            self.handle.clientset.create_resource_claim(s.special)
            pod.extended_resource_claim_status = {
                "claim": s.special.key, "requests": [r.name for r in s.special.requests]}
        for claim, devices in s.node_allocations.get(node_name, ()):
            claim.allocated_node = node_name
            claim.allocations = list(devices)
            if pod.uid not in claim.reserved_for:
                claim.reserved_for.append(pod.uid)
            self.assumed.pop(claim.key, None)
            self.assumed_nodes.pop(claim.key, None)
        for claim in s.claims:
            if claim.allocated and pod.uid not in claim.reserved_for:
                claim.reserved_for.append(pod.uid)
        return OK


def class_selectors(listers, device_class: str, selectors) -> Dict[str, str]:
    """A request's attribute equalities with its DeviceClass's merged in
    (a class that does not exist adds none). `listers`: the clientset or a
    handle."""
    sel = dict(selectors)
    if device_class:
        dc = listers.device_classes.get(device_class)
        if dc is not None:
            sel.update(dc.selectors)
    return sel


def matching_devices(node_name: str, slices, sel, matcher, used, taken=()):
    """(driver, device) of the node's devices that the equalities `sel` and
    the compiled expression `matcher` (None: none) match and that are in
    neither `used` ((node, driver, device)) nor `taken` ((driver, device)),
    in slice order, lazily: `taken` may grow between two."""
    for sl in slices:
        for dev in sl.devices:
            key = (sl.driver, dev.name)
            if key in taken or (node_name, sl.driver, dev.name) in used:
                continue
            if not all(dev.attributes.get(k) == v for k, v in sel.items()):
                continue
            if matcher is not None and not matcher(dev, sl.driver):
                continue
            yield key


def _request_devices(listers, node_name: str, slices, req, used, taken):
    return matching_devices(node_name, slices,
                            class_selectors(listers, req.device_class, req.selectors),
                            DynamicResources._matcher_for(req), used, taken)


def allocate_pending_claims(clientset) -> int:
    """The scheduler_perf allocResourceClaims opcode: allocate every pending
    claim greedily against the cluster's ResourceSlices, as a DRA controller
    would before the measured pods only validate their pinned node. Returns
    the number of claims allocated."""
    used: Set[Tuple[str, str, str]] = set()
    for claim in clientset.resource_claims.values():
        if claim.allocated:
            for d in claim.allocations:
                used.add((claim.allocated_node, d.driver, d.device))
    n_alloc = 0
    for claim in clientset.resource_claims.values():
        if claim.allocated:
            continue
        for node_name, slices in clientset.resource_slices.items():
            taken: Set[Tuple[str, str]] = set()
            devices: List[AllocatedDevice] = []
            ok = True
            for req in claim.requests:
                found = 0
                for driver, dev in _request_devices(clientset, node_name, slices, req, used,
                                                    taken):
                    if found >= req.count:
                        break
                    devices.append(AllocatedDevice(driver, dev))
                    taken.add((driver, dev))
                    found += 1
                if found < req.count:
                    ok = False
                    break
            if ok:
                claim.allocated_node = node_name
                claim.allocations = devices
                for d in devices:
                    used.add((node_name, d.driver, d.device))
                n_alloc += 1
                break
    if n_alloc:
        clientset.bump_resource_claims_rv()
    return n_alloc
