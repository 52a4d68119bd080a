"""The volume plugins: VolumeBinding, NodeVolumeLimits (CSI), VolumeZone and
VolumeRestrictions.

Reference anchors:
- volumebinding/ (binder.go, volume_binding.go): the claims partitioned in
  PreFilter (bound, unbound delayed, unbound immediate), FindPodVolumes per
  node in Filter (a bound PV's node affinity; a matching available PV for
  each unbound claim, or dynamic provisioning), AssumePodVolumes in
  Reserve, the BindPodVolumes writes in PreBind, the revert in Unreserve;
- nodevolumelimits/csi.go: attachments per CSI driver against the CSINode
  allocatable count;
- volumezone/: a bound PV's zone and region labels must match the node's;
- volumerestrictions/: ReadWriteOncePod conflicts (the single-attach rules
  of the legacy in-tree drivers are CSI-migrated and not modelled).

A device session covers a pod whose claims impose no per-node constraint
but one counted CSI attach limit (ops/features.py volume_device_support);
every other volume pod takes the host path through these plugins.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..api.storage import RWOP, WAIT_FOR_FIRST_CONSUMER, PersistentVolume, PersistentVolumeClaim
from ..api.types import LABEL_REGION, LABEL_ZONE, Pod
from ..core.framework import OK, SKIP_STATUS, CycleState, PreFilterResult, Status
from ..core.node_info import NodeInfo, PodInfo

ERR_UNBOUND_IMMEDIATE = "pod has unbound immediate PersistentVolumeClaims"
ERR_NODE_CONFLICT = "node(s) had volume node affinity conflict"
ERR_NO_MATCH = "node(s) didn't find available persistent volumes to bind"
ERR_ZONE = "node(s) had no available volume zone"
ERR_RWOP = "pod uses a ReadWriteOncePod PVC that is already in use by another pod"
ERR_LIMIT = "node(s) exceed max volume count"


def _pod_pvc_names(pod: Pod) -> List[str]:
    return [v.pvc_name for v in pod.volumes if v.pvc_name]


class VolumeBinding:
    """volumebinding/volume_binding.go."""

    name = "VolumeBinding"
    # Reserve and PreBind act only on the state PreFilter and Filter wrote:
    # on a fresh state (a device-path commit) they do nothing.
    state_driven_tail = True
    _KEY = "PreFilterVolumeBinding"

    def __init__(self, handle=None):
        self.handle = handle
        # The PV assume layer (binder.go AssumeCache): PV name -> claim key,
        # held until the claim's bind is written or the reservation unwinds.
        self.assumed: Dict[str, str] = {}

    @dataclass
    class _State:
        bound: List[PersistentVolumeClaim] = field(default_factory=list)
        unbound_delayed: List[PersistentVolumeClaim] = field(default_factory=list)
        # node name -> [(claim, PV name, or "" to provision)]
        node_decisions: Dict[str, List[Tuple[PersistentVolumeClaim, str]]] = field(
            default_factory=dict)

        def clone(self) -> "VolumeBinding._State":
            return VolumeBinding._State(
                bound=list(self.bound), unbound_delayed=list(self.unbound_delayed),
                node_decisions={k: list(v) for k, v in self.node_decisions.items()})

    def pre_filter(self, state: CycleState, pod: Pod,
                   nodes) -> Tuple[Optional[PreFilterResult], Status]:
        names = _pod_pvc_names(pod)
        if not names:
            return None, Status.skip()
        s = self._State()
        for name in names:
            pvc = self.handle.pvcs.get(f"{pod.namespace}/{name}")
            if pvc is None:
                return None, Status.unresolvable(f'persistentvolumeclaim "{name}" not found')
            if pvc.volume_name:
                s.bound.append(pvc)
                continue
            sc = self.handle.storage_classes.get(pvc.storage_class)
            if sc is not None and sc.volume_binding_mode == WAIT_FOR_FIRST_CONSUMER:
                s.unbound_delayed.append(pvc)
            else:
                # The PV controller binds an Immediate claim before the pod
                # may schedule (volume_binding.go PreFilter).
                return None, Status.unresolvable(ERR_UNBOUND_IMMEDIATE)
        state.write(self._KEY, s)
        return None, OK

    def filter(self, state: CycleState, pod: Pod, node_info: NodeInfo) -> Status:
        """binder.go FindPodVolumes."""
        s: Optional[VolumeBinding._State] = state.read(self._KEY)
        if s is None:
            return OK
        node = node_info.node
        for pvc in s.bound:
            pv = self.handle.pvs.get(pvc.volume_name)
            if pv is None:
                return Status.unresolvable(f'persistentvolume "{pvc.volume_name}" not found')
            if pv.node_affinity is not None and not pv.node_affinity.matches(node):
                return Status.unschedulable(ERR_NODE_CONFLICT)
        if not s.unbound_delayed:
            return OK
        decisions: List[Tuple[PersistentVolumeClaim, str]] = []
        used = set()
        for pvc in s.unbound_delayed:
            pv = self._find_matching_pv(pvc, node, used)
            if pv is not None:
                used.add(pv.name)
                decisions.append((pvc, pv.name))
                continue
            sc = self.handle.storage_classes.get(pvc.storage_class)
            if sc is not None and sc.provisioner:
                # Dynamic provisioning, within the class's allowed topologies.
                if sc.allowed_topologies is not None and not sc.allowed_topologies.matches(node):
                    return Status.unschedulable(ERR_NO_MATCH)
                decisions.append((pvc, ""))
                continue
            return Status.unschedulable(ERR_NO_MATCH)
        s.node_decisions[node.name] = decisions
        return OK

    def _find_matching_pv(self, pvc: PersistentVolumeClaim, node,
                          used) -> Optional[PersistentVolume]:
        """binder.go findMatchingVolume: the smallest available PV of the
        claim's class, access modes and capacity whose node affinity admits
        the node."""
        best = None
        for pv in self.handle.pvs.values():
            if pv.name in used or pv.claim_ref or pv.name in self.assumed:
                continue
            if pv.storage_class != pvc.storage_class:
                continue
            if not set(pvc.access_modes) <= set(pv.access_modes) or pv.capacity < pvc.request:
                continue
            if pv.node_affinity is not None and not pv.node_affinity.matches(node):
                continue
            if best is None or pv.capacity < best.capacity:
                best = pv
        return best

    def reserve(self, state: CycleState, pod: Pod, node_name: str) -> Status:
        s: Optional[VolumeBinding._State] = state.read(self._KEY)
        if s is None:
            return OK
        for pvc, pv_name in s.node_decisions.get(node_name, ()):
            if pv_name:
                self.assumed[pv_name] = pvc.key
        return OK

    def unreserve(self, state: CycleState, pod: Pod, node_name: str) -> None:
        s: Optional[VolumeBinding._State] = state.read(self._KEY)
        if s is None:
            return
        for pvc, pv_name in s.node_decisions.get(node_name, ()):
            if pv_name and self.assumed.get(pv_name) == pvc.key:
                del self.assumed[pv_name]

    def pre_bind_pre_flight(self, state: CycleState, pod: Pod, node_name: str) -> Status:
        """volume_binding.go PreBindPreFlight: Skip for a pod without
        PVC-backed volumes, whose PreBind would do nothing."""
        if not pod.volumes or not any(v.pvc_name for v in pod.volumes):
            return SKIP_STATUS
        return OK

    def pre_bind(self, state: CycleState, pod: Pod, node_name: str) -> Status:
        """binder.go BindPodVolumes: the claim-to-PV binds (and the node
        selection that provisioning waits for) written through the API."""
        s: Optional[VolumeBinding._State] = state.read(self._KEY)
        if s is None:
            return OK
        for pvc, pv_name in s.node_decisions.get(node_name, ()):
            try:
                self.handle.clientset.bind_volume(pvc, pv_name, node_name)
            except Exception as e:  # noqa: BLE001 - a failed write fails PreBind
                return Status.error(str(e))
            self.assumed.pop(pv_name, None)
        return OK


class NodeVolumeLimits:
    """nodevolumelimits/csi.go: attach limits per CSI driver."""

    name = "NodeVolumeLimits"

    def __init__(self, handle=None):
        self.handle = handle

    def _driver_of(self, pvc: PersistentVolumeClaim) -> str:
        if pvc.volume_name:
            pv = self.handle.pvs.get(pvc.volume_name)
            if pv is not None and pv.csi_driver:
                return pv.csi_driver
        sc = self.handle.storage_classes.get(pvc.storage_class)
        return sc.provisioner if sc is not None else ""

    def filter(self, state: CycleState, pod: Pod, node_info: NodeInfo) -> Status:
        names = _pod_pvc_names(pod)
        if not names:
            return OK
        csinode = self.handle.csi_nodes.get(node_info.name)
        if csinode is None or not csinode.driver_limits:
            return OK
        new_per_driver: Dict[str, int] = {}
        for name in names:
            pvc = self.handle.pvcs.get(f"{pod.namespace}/{name}")
            if pvc is None:
                continue
            d = self._driver_of(pvc)
            if d:
                new_per_driver[d] = new_per_driver.get(d, 0) + 1
        if not new_per_driver:
            return OK
        # The node's existing attachments: its pods' claims per driver.
        existing: Dict[str, int] = {}
        for key in node_info.pvc_ref_counts:
            pvc = self.handle.pvcs.get(key)
            if pvc is None:
                continue
            d = self._driver_of(pvc)
            if d:
                existing[d] = existing.get(d, 0) + 1
        for d, n_new in new_per_driver.items():
            limit = csinode.driver_limits.get(d)
            if limit is not None and existing.get(d, 0) + n_new > limit:
                return Status.unschedulable(ERR_LIMIT)
        return OK


class VolumeZone:
    """volumezone/: a bound PV's zone and region labels must match the node."""

    name = "VolumeZone"
    TOPOLOGY_KEYS = (LABEL_ZONE, LABEL_REGION, "failure-domain.beta.kubernetes.io/zone",
                     "failure-domain.beta.kubernetes.io/region")

    def __init__(self, handle=None):
        self.handle = handle

    def filter(self, state: CycleState, pod: Pod, node_info: NodeInfo) -> Status:
        node = node_info.node
        for name in _pod_pvc_names(pod):
            pvc = self.handle.pvcs.get(f"{pod.namespace}/{name}")
            if pvc is None or not pvc.volume_name:
                continue
            pv = self.handle.pvs.get(pvc.volume_name)
            if pv is None:
                continue
            for key in self.TOPOLOGY_KEYS:
                pv_val = pv.labels.get(key)
                if pv_val is not None and node.labels.get(key) != pv_val:
                    return Status.unschedulable(ERR_ZONE)
        return OK


@dataclass
class _RWOPState:
    """The ReadWriteOncePod conflict count, cloned for each what-if
    simulation."""

    rwop_keys: set
    conflicts: int

    def clone(self) -> "_RWOPState":
        return _RWOPState(self.rwop_keys, self.conflicts)


class VolumeRestrictions:
    """volumerestrictions/: ReadWriteOncePod access-mode conflicts."""

    name = "VolumeRestrictions"
    _KEY = "PreFilterVolumeRestrictions"

    def __init__(self, handle=None):
        self.handle = handle

    def pre_filter(self, state: CycleState, pod: Pod,
                   nodes) -> Tuple[Optional[PreFilterResult], Status]:
        names = _pod_pvc_names(pod)
        if not names:
            return None, Status.skip()
        # No other pod anywhere may use a ReadWriteOncePod claim. The
        # cluster-wide count rides the cycle state, so a preemption dry run
        # adjusts it through add_pod/remove_pod and finds the victims whose
        # eviction clears the conflict (isRWOPConflict, AddPod/RemovePod).
        rwop_keys = set()
        for name in names:
            pvc = self.handle.pvcs.get(f"{pod.namespace}/{name}")
            if pvc is not None and RWOP in pvc.access_modes:
                rwop_keys.add(f"{pod.namespace}/{name}")
        conflicts = 0
        if rwop_keys:
            for ni in self.handle.snapshot().node_info_list:
                for key in rwop_keys:
                    conflicts += ni.pvc_ref_counts.get(key, 0)
        state.write(self._KEY, _RWOPState(rwop_keys, conflicts))
        return None, OK

    @staticmethod
    def _uses_rwop(s: _RWOPState, pi: PodInfo) -> int:
        return sum(1 for name in _pod_pvc_names(pi.pod)
                   if f"{pi.pod.namespace}/{name}" in s.rwop_keys)

    def add_pod(self, state: CycleState, pod: Pod, added: PodInfo,
                node_info: NodeInfo) -> Status:
        s = state.read(self._KEY)
        if s is not None and s.rwop_keys:
            s.conflicts += self._uses_rwop(s, added)
        return OK

    def remove_pod(self, state: CycleState, pod: Pod, removed: PodInfo,
                   node_info: NodeInfo) -> Status:
        s = state.read(self._KEY)
        if s is not None and s.rwop_keys:
            s.conflicts -= self._uses_rwop(s, removed)
        return OK

    def filter(self, state: CycleState, pod: Pod, node_info: NodeInfo) -> Status:
        s = state.read(self._KEY)
        if s is not None and s.conflicts > 0:
            return Status.unschedulable(ERR_RWOP)
        return OK
