"""Fake control plane: an in-process pod/node store with watch-style fanout.

Plays the role of client-go fake.Clientset + informers in the reference's unit
layer: scheduler event handlers subscribe, API writes (bind, create, delete)
synchronously fan out to them — the apiserver watch streams collapsed to
function calls. Every pod-group write passes the scope guard
(core/scope.py). The storage objects (PersistentVolumes, claims, storage
classes, CSINodes) and the DRA objects (ResourceSlices, ResourceClaims,
DeviceClasses) fan out to `on_storage_event` handlers: the volume and
DynamicResources plugins' listers and the PV controller
(core/pv_controller.py).
"""

from __future__ import annotations

import copy
import itertools
import time
from typing import Callable, Dict, List, Optional

from ..api.dra import DeviceClass, ResourceClaim, ResourceSlice
from ..api.labels import IN, Requirement
from ..api.storage import (
    BIND_COMPLETED,
    SELECTED_NODE,
    CSINode,
    PersistentVolume,
    PersistentVolumeClaim,
    StorageClass,
)
from ..api.types import Namespace, Node, NodeSelector, NodeSelectorTerm, Pod, PodGroup
from .scope import check_pod_group


class FakeClientset:
    def __init__(self):
        self.pods: Dict[str, Pod] = {}
        self.nodes: Dict[str, Node] = {}
        self.bindings: Dict[str, str] = {}  # pod uid -> node name
        self.namespaces: Dict[str, Namespace] = {"default": Namespace(name="default")}
        self.pod_groups: Dict[str, PodGroup] = {}  # "ns/name" -> group
        self.pvs: Dict[str, PersistentVolume] = {}
        self.pvcs: Dict[str, PersistentVolumeClaim] = {}  # "ns/name" -> claim
        self.storage_classes: Dict[str, StorageClass] = {}
        self.csi_nodes: Dict[str, CSINode] = {}
        # The CSINode set's version: replacing a node's limits moves it too.
        self.csi_nodes_rv = 0
        # DRA (api/dra.py): node -> its ResourceSlices, "ns/name" -> claim,
        # name -> DeviceClass. The claims' revision moves on every claim
        # write and out-of-band allocation (the in-use caches key on it);
        # has_consuming_devices once any device consumes node allocatable.
        self.resource_slices: Dict[str, List[ResourceSlice]] = {}
        self.resource_claims: Dict[str, ResourceClaim] = {}
        self.device_classes: Dict[str, DeviceClass] = {}
        self.resource_claims_rv = 0
        self.has_consuming_devices = False
        self._pod_handlers: List = []
        self._node_handlers: List = []
        self._namespace_handlers: List = []
        self._pod_group_handlers: List = []
        self._storage_handlers: List = []
        self._pv_controller = None
        self._rv_counter = itertools.count(1)
        # The apiserver's /api/v1/leases surface (the descheduler's HA
        # lease). `lease_now` is injectable so lease-expiry tests need no
        # real sleeps.
        self.leases: Dict[str, dict] = {}
        self.lease_now: Callable[[], float] = time.monotonic

    # -- informer-ish registration ----------------------------------------

    def on_pod_event(self, handler: Callable[[str, Optional[Pod], Pod], None]) -> None:
        """handler(kind, old, new) with kind in add/update/delete."""
        self._pod_handlers.append(handler)

    def on_node_event(self, handler: Callable[[str, Optional[Node], Node], None]) -> None:
        self._node_handlers.append(handler)

    def on_namespace_event(self, handler: Callable[[Namespace], None]) -> None:
        """handler(namespace) on every create; existing namespaces replay
        at registration (an informer's initial list)."""
        self._namespace_handlers.append(handler)
        for ns in self.namespaces.values():
            handler(ns)

    def on_pod_group_event(self, handler: Callable[[PodGroup], None]) -> None:
        """handler(group) on every create; existing groups replay at
        registration."""
        self._pod_group_handlers.append(handler)
        for g in self.pod_groups.values():
            handler(g)

    def on_storage_event(self, handler: Callable[[str, object], None]) -> None:
        """handler(kind, obj) with kind in pv/pvc/storage_class/csi_node/
        resource_slice/resource_claim/device_class on every storage write
        (the informer feed behind the Storage/Add queueing hints)."""
        self._storage_handlers.append(handler)

    def _fire_storage(self, kind: str, obj) -> None:
        for h in self._storage_handlers:
            h(kind, obj)

    # -- writes ------------------------------------------------------------

    def create_namespace(self, ns: Namespace) -> Namespace:
        self.namespaces[ns.name] = ns
        for h in self._namespace_handlers:
            h(ns)
        return ns

    def create_pod_group(self, group: PodGroup) -> PodGroup:
        check_pod_group(group)
        self.pod_groups[f"{group.namespace}/{group.name}"] = group
        for h in self._pod_group_handlers:
            h(group)
        return group

    def create_composite_pod_group(self, cpg) -> None:
        """The JAX package's CompositePodGroup feed: always refused."""
        check_pod_group(cpg)

    # -- storage (the PV controller surface the volume plugins consume) ----

    def create_pv(self, pv: PersistentVolume) -> PersistentVolume:
        self.pvs[pv.name] = pv
        self._fire_storage("pv", pv)
        return pv

    def create_pvc(self, pvc: PersistentVolumeClaim) -> PersistentVolumeClaim:
        self.pvcs[pvc.key] = pvc
        self._fire_storage("pvc", pvc)
        return pvc

    def create_storage_class(self, sc: StorageClass) -> StorageClass:
        self.storage_classes[sc.name] = sc
        self._fire_storage("storage_class", sc)
        return sc

    def create_csi_node(self, cn: CSINode) -> CSINode:
        self.csi_nodes[cn.node_name] = cn
        self.csi_nodes_rv += 1
        self._fire_storage("csi_node", cn)
        return cn

    # -- DRA (the DynamicResources plugin's listers) ----------------------

    def create_resource_slice(self, sl: ResourceSlice) -> ResourceSlice:
        self.resource_slices.setdefault(sl.node_name, []).append(sl)
        if any(d.consumes for d in sl.devices):
            # Their allocation math is a second constraint the device's aux
            # count does not model (ops/features.py dra_device_support).
            self.has_consuming_devices = True
        self._fire_storage("resource_slice", sl)
        return sl

    def create_resource_claim(self, claim: ResourceClaim) -> ResourceClaim:
        self.resource_claims[claim.key] = claim
        self.resource_claims_rv += 1
        self._fire_storage("resource_claim", claim)
        return claim

    def bump_resource_claims_rv(self) -> None:
        """Claims changed out of band (an allocation by a controller)."""
        self.resource_claims_rv += 1

    def create_device_class(self, dc: DeviceClass) -> DeviceClass:
        self.device_classes[dc.name] = dc
        self._fire_storage("device_class", dc)
        return dc

    def attach_pv_controller(self, ctrl) -> None:
        """Register the PV controller (core/pv_controller.py): PreBind's
        provisioning then goes through it."""
        self._pv_controller = ctrl

    def bind_volume(self, pvc: PersistentVolumeClaim, pv_name: str, node_name: str) -> None:
        """VolumeBinding's PreBind writes (binder.go BindPodVolumes): bind the
        claim to the chosen PV, or, for a WaitForFirstConsumer claim to
        provision, write the selected-node annotation and let the PV
        controller provision a PV there. Without a controller attached the
        provisioning is done inline (a PV pinned to the node, bound)."""
        if pv_name:
            pv = self.pvs[pv_name]
            pv.claim_ref = pvc.key
            pvc.volume_name = pv_name
            pvc.annotations[BIND_COMPLETED] = "true"
            return
        pvc.annotations[SELECTED_NODE] = node_name
        if self._pv_controller is not None:
            self._pv_controller.provision(pvc, node_name)
            return
        provisioned = PersistentVolume(
            name=f"pvc-{pvc.uid}", capacity=pvc.request,
            access_modes=pvc.access_modes, storage_class=pvc.storage_class,
            node_affinity=NodeSelector(terms=(NodeSelectorTerm(
                match_fields=(Requirement("metadata.name", IN, (node_name,)),)),)),
            claim_ref=pvc.key)
        self.pvs[provisioned.name] = provisioned
        pvc.volume_name = provisioned.name

    def create_node(self, node: Node) -> Node:
        node.resource_version = next(self._rv_counter)
        self.nodes[node.name] = node
        for h in self._node_handlers:
            h("add", None, node)
        return node

    def update_node(self, node: Node) -> Node:
        old = self.nodes.get(node.name)
        node.resource_version = next(self._rv_counter)
        self.nodes[node.name] = node
        for h in self._node_handlers:
            h("update", old, node)
        return node

    def delete_node(self, name: str) -> None:
        node = self.nodes.pop(name, None)
        if node is not None:
            for h in self._node_handlers:
                h("delete", node, node)

    def create_pod(self, pod: Pod) -> Pod:
        pod.resource_version = next(self._rv_counter)
        self.pods[pod.uid] = pod
        for h in self._pod_handlers:
            h("add", None, pod)
        return pod

    def update_pod(self, pod: Pod) -> Pod:
        old = self.pods.get(pod.uid)
        pod.resource_version = next(self._rv_counter)
        # An in-place spec change on the same object drops the derived-spec
        # memos, including the template-shared signature holder.
        d = pod.__dict__
        d.pop("_sig_cache", None)
        d.pop("_sig_shared", None)
        d.pop("_req_cache", None)
        self.pods[pod.uid] = pod
        for h in self._pod_handlers:
            h("update", old, pod)
        return pod

    def delete_pod(self, pod: Pod) -> None:
        p = self.pods.pop(pod.uid, None)
        if p is not None:
            for h in self._pod_handlers:
                h("delete", p, p)

    def patch_pod_status(self, pod: Pod, nominated_node_name: str = "") -> None:
        """PATCH pods/{name}/status: records a preemptor's nominated node
        (no watch event, as in the JAX package's fake)."""
        stored = self.pods.get(pod.uid)
        if stored is not None and nominated_node_name:
            stored.nominated_node_name = nominated_node_name

    def bind(self, pod: Pod, node_name: str) -> None:
        """POST pods/{name}/binding (DefaultBinder target)."""
        stored = self.pods.get(pod.uid)
        if stored is None:
            raise KeyError(f"pod {pod.namespace}/{pod.name} not found")
        new = copy.copy(stored)
        new.node_name = node_name
        new.resource_version = next(self._rv_counter)
        self.pods[pod.uid] = new
        self.bindings[pod.uid] = node_name
        for h in self._pod_handlers:
            h("update", stored, new)

    # -- leases (apiserver /api/v1/leases parity) ---------------------------

    def _lease_wire(self, name: str, rec: dict, now: float) -> dict:
        age = now - rec["renew"]
        return {"name": name, "holder": rec["holder"],
                "leaseDurationSeconds": rec["duration"],
                "ageSeconds": round(age, 3),
                "transitions": rec["transitions"],
                "expired": (not rec["holder"]) or age >= rec["duration"]}

    def list_leases(self) -> List[dict]:
        now = self.lease_now()
        return [self._lease_wire(n, r, now)
                for n, r in sorted(self.leases.items())]

    def upsert_lease(self, name: str, holder: str,
                     duration: float) -> Optional[dict]:
        """Acquire-or-renew under CAS semantics (the apiserver's PUT
        /api/v1/leases/<name>): a held, unexpired lease only renews for its
        current holder; anyone else gets None."""
        now = self.lease_now()
        rec = self.leases.get(name)
        if (rec is not None and rec["holder"] and rec["holder"] != holder
                and now - rec["renew"] < rec["duration"]):
            return None
        if rec is None:
            rec = {"holder": "", "duration": float(duration),
                   "renew": now, "transitions": 0}
            self.leases[name] = rec
        if rec["holder"] != holder:
            rec["transitions"] += 1
        rec["holder"] = holder
        rec["duration"] = float(duration)
        rec["renew"] = now
        return self._lease_wire(name, rec, now)
