"""Storage API objects the volume plugins consume.

The scheduling-relevant slices of core/v1 PersistentVolume and
PersistentVolumeClaim and of storage.k8s.io/v1 StorageClass and CSINode
(staging/src/k8s.io/api/core/v1/types.go, storage/v1/types.go): the inputs
of VolumeBinding, NodeVolumeLimits, VolumeZone and VolumeRestrictions
(plugins/volumes.py) and of the PV controller (core/pv_controller.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from .resource import to_int
from .types import NodeSelector, _next_uid

# volumeBindingMode (storage/v1/types.go)
IMMEDIATE = "Immediate"
WAIT_FOR_FIRST_CONSUMER = "WaitForFirstConsumer"

# access modes
RWO = "ReadWriteOnce"
ROX = "ReadOnlyMany"
RWX = "ReadWriteMany"
RWOP = "ReadWriteOncePod"

# The claim annotations of the PV controller interlock.
BIND_COMPLETED = "pv.kubernetes.io/bind-completed"
SELECTED_NODE = "volume.kubernetes.io/selected-node"


@dataclass
class StorageClass:
    name: str = ""
    provisioner: str = ""
    volume_binding_mode: str = IMMEDIATE
    allowed_topologies: Optional[NodeSelector] = None


@dataclass
class PersistentVolume:
    name: str = ""
    uid: str = ""
    capacity: int = 0                    # bytes
    access_modes: Tuple[str, ...] = (RWO,)
    storage_class: str = ""
    node_affinity: Optional[NodeSelector] = None  # pv.spec.nodeAffinity.required
    labels: Dict[str, str] = field(default_factory=dict)
    claim_ref: str = ""                  # "ns/name" of the bound claim ("" = available)
    csi_driver: str = ""                 # spec.csi.driver ("" = not CSI)

    def __post_init__(self):
        if not self.uid:
            self.uid = _next_uid("pv")

    @classmethod
    def of(cls, name: str, capacity, **kw) -> "PersistentVolume":
        return cls(name=name, capacity=to_int(capacity), **kw)


@dataclass
class PersistentVolumeClaim:
    name: str = ""
    namespace: str = "default"
    uid: str = ""
    request: int = 0                     # bytes
    access_modes: Tuple[str, ...] = (RWO,)
    storage_class: str = ""
    volume_name: str = ""                # the bound PV ("" = pending)
    labels: Dict[str, str] = field(default_factory=dict)
    # BIND_COMPLETED and SELECTED_NODE (the PV controller interlock)
    annotations: Dict[str, str] = field(default_factory=dict)

    def __post_init__(self):
        if not self.uid:
            self.uid = _next_uid("pvc")

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"

    @classmethod
    def of(cls, name: str, request, **kw) -> "PersistentVolumeClaim":
        return cls(name=name, request=to_int(request), **kw)


@dataclass
class CSINode:
    """storage/v1 CSINode: per-node driver attach limits
    (nodevolumelimits/csi.go reads .spec.drivers[].allocatable.count)."""

    node_name: str = ""
    driver_limits: Dict[str, int] = field(default_factory=dict)  # driver -> max volumes
