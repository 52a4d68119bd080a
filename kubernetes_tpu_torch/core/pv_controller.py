"""The PersistentVolume controller: the control loop that binds claims to
volumes outside the scheduler.

Re-expresses the scheduler-relevant contract of the kube-controller-manager
persistentvolume controller (pkg/controller/volume/persistentvolume/
pv_controller.go), with which the scheduler's VolumeBinding plugin
interlocks:

- an unbound Immediate claim binds to the smallest matching available PV as
  soon as both exist (syncUnboundClaim → findBestMatchForClaim); the
  scheduler refuses a pod whose Immediate claims are still unbound
  (volume_binding.go PreFilter);
- a WaitForFirstConsumer claim waits until the scheduler picks a node and
  writes the selected-node annotation (binder.go BindPodVolumes, PreBind);
  the controller then provisions a PV pinned to that node and binds it.

It subscribes to the clientset's storage events, so a created claim or
volume reconciles at once: the informer shape collapsed to synchronous
callbacks.
"""

from __future__ import annotations

from typing import Optional

from ..api.labels import IN, Requirement
from ..api.storage import (
    BIND_COMPLETED,
    IMMEDIATE,
    SELECTED_NODE,
    WAIT_FOR_FIRST_CONSUMER,
    PersistentVolume,
    PersistentVolumeClaim,
)
from ..api.types import NodeSelector, NodeSelectorTerm


class PVController:
    """The bind and provision loop, attached to a FakeClientset: every PV,
    claim or storage-class write (and every explicit sync()) reconciles
    all unbound claims."""

    def __init__(self, clientset):
        self.cs = clientset
        self.binds = 0
        self.provisions = 0
        clientset.attach_pv_controller(self)
        clientset.on_storage_event(self._on_storage_event)

    def _on_storage_event(self, kind: str, obj) -> None:
        if kind in ("pv", "pvc", "storage_class"):
            self.sync()

    def sync(self) -> int:
        """One reconcile pass; returns the number of claims progressed."""
        n = 0
        for pvc in list(self.cs.pvcs.values()):
            if pvc.volume_name:
                continue
            if self._binding_mode(pvc) == WAIT_FOR_FIRST_CONSUMER:
                node = pvc.annotations.get(SELECTED_NODE, "")
                if node:
                    self.provision(pvc, node)
                    n += 1
                continue
            pv = self._find_best_match(pvc)
            if pv is not None:
                self._bind(pvc, pv)
                n += 1
        return n

    def _binding_mode(self, pvc: PersistentVolumeClaim) -> str:
        sc = self.cs.storage_classes.get(pvc.storage_class)
        return sc.volume_binding_mode if sc is not None else IMMEDIATE

    def _find_best_match(self, pvc: PersistentVolumeClaim) -> Optional[PersistentVolume]:
        """findBestMatchForClaim: the smallest available PV of the claim's
        class, access modes and capacity. An Immediate claim binds whatever
        the PV's topology (node affinity is the scheduler's concern for
        delayed claims only), the reference's immediate-mode pitfall."""
        best = None
        for pv in self.cs.pvs.values():
            if pv.claim_ref or pv.storage_class != pvc.storage_class:
                continue
            if not set(pvc.access_modes) <= set(pv.access_modes) or pv.capacity < pvc.request:
                continue
            if best is None or pv.capacity < best.capacity:
                best = pv
        return best

    def _bind(self, pvc: PersistentVolumeClaim, pv: PersistentVolume) -> None:
        pv.claim_ref = pvc.key
        pvc.volume_name = pv.name
        pvc.annotations[BIND_COMPLETED] = "true"
        self.binds += 1

    def provision(self, pvc: PersistentVolumeClaim, node_name: str) -> PersistentVolume:
        """Dynamic provisioning of a WaitForFirstConsumer claim whose
        consumer landed on `node_name`: a PV pinned to that node (the
        external-provisioner contract), bound to the claim."""
        sc = self.cs.storage_classes.get(pvc.storage_class)
        pv = PersistentVolume(
            name=f"pvc-{pvc.uid}", capacity=pvc.request, access_modes=pvc.access_modes,
            storage_class=pvc.storage_class, csi_driver=sc.provisioner if sc is not None else "",
            node_affinity=NodeSelector(terms=(NodeSelectorTerm(
                match_fields=(Requirement("metadata.name", IN, (node_name,)),)),)))
        self.cs.pvs[pv.name] = pv
        self._bind(pvc, pv)
        self.provisions += 1
        return pv
