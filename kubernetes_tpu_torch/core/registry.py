"""The port's default profile: the in-scope plugins of
pkg/scheduler/apis/config/v1/default_plugins.go:32-60, in the reference's
order (filter order decides which plugin a node's failure is charged to)
and with its weights (TaintToleration 3, NodeAffinity 2, NodeResourcesFit 1,
PodTopologySpread 2, InterPodAffinity 2, NodeResourcesBalancedAllocation 1,
ImageLocality 1; the four volume plugins after NodeResourcesFit filter
only, weight 0), DefaultPreemption as the PostFilter (and
PodGroupPostFilter), SchedulingGates as the PreEnqueue gate, and
NodeDeclaredFeatures last: the JAX package adds it while its feature gate
is on, which is the default (core/registry.py:119-133 there); the port has
no feature gates and always adds it.
`gang_placement_profile` adds the pod-group plugins the reference gates
behind GenericWorkload (the JAX package's GANG_PLACEMENT_PLUGINS,
core/registry.py:141-153): GangScheduling (the Permit barrier and the
PlacementFeasible gate), TopologyPlacementGenerator and PodGroupPodsCount
(weight 1); NodeResourcesFit scores placements too.
`dra_profile` appends DynamicResources at weight 0, last (after
NodeDeclaredFeatures): the JAX package's default profile has no
DynamicResources (its DynamicResourceAllocation gate is off), and its perf
harness builds DEFAULT_PLUGINS + DynamicResources for the DRA workloads
(perf/harness.py:778-785), a list without NodeDeclaredFeatures. The port's
dra_profile is that list with NodeDeclaredFeatures before DynamicResources,
the JAX package's build_framework(h, plugins=DEFAULT_PLUGINS +
(("NodeDeclaredFeatures", 0), ("DynamicResources", 0))). `handle` gives the
plugins the clientset, the scheduler's snapshot, the namespaces' labels,
the nominator, the placed-group-members index, the waiting pods, the
storage and DRA listers and the device dry run (framework.Handle)."""

from __future__ import annotations

from typing import Optional

from ..plugins.basic import (
    DefaultBinder,
    ImageLocality,
    NodeAffinity,
    NodeName,
    NodePorts,
    NodeUnschedulable,
    PrioritySort,
    SchedulingGates,
    TaintToleration,
)
from ..plugins.dynamicresources import DynamicResources
from ..plugins.extras import NodeDeclaredFeatures
from ..plugins.gang import GangScheduling
from ..plugins.interpodaffinity import InterPodAffinity
from ..plugins.noderesources import BalancedAllocation, Fit
from ..plugins.podtopologyspread import PodTopologySpread
from ..plugins.preemption import DefaultPreemption
from ..plugins.topologyaware import PodGroupPodsCount, TopologyPlacementGenerator
from ..plugins.volumes import NodeVolumeLimits, VolumeBinding, VolumeRestrictions, VolumeZone
from .framework import Framework


def default_profile(handle, profile_name: str = "default-scheduler",
                    gang_placement: bool = False,
                    dra: Optional[DynamicResources] = None) -> Framework:
    preemption = DefaultPreemption(handle)
    fit = Fit()
    extra = [(GangScheduling(handle), 0), (TopologyPlacementGenerator(handle), 0),
             (PodGroupPodsCount(handle), 1)] if gang_placement else []
    fw = Framework(profile_name=profile_name, plugins=[
        (SchedulingGates(), 0),
        (PrioritySort(), 0),
        (NodeName(), 0),
        (NodeUnschedulable(), 0),
        (TaintToleration(), 3),
        (NodeAffinity(), 2),
        (NodePorts(), 0),
        (fit, 1),
        (VolumeRestrictions(handle), 0),
        (NodeVolumeLimits(handle), 0),
        (VolumeBinding(handle), 0),
        (VolumeZone(handle), 0),
        (PodTopologySpread(handle), 2),
        (InterPodAffinity(handle), 2),
        (preemption, 0),
        (BalancedAllocation(), 1),
        (ImageLocality(handle), 1),
        (DefaultBinder(handle.clientset), 0),
    ] + extra + [(NodeDeclaredFeatures(), 0)] + ([(dra, 0)] if dra is not None else []))
    preemption.set_framework(fw)
    fit.set_framework(fw)
    return fw


def gang_placement_profile(handle) -> Framework:
    """The default profile with the pod-group placement plugins."""
    return default_profile(handle, gang_placement=True)


def dra_profile(handle, extended_resources: bool = False,
                node_allocatable: bool = False) -> Framework:
    """The default profile with DynamicResources, its two gated branches
    (extended resources backed by a DeviceClass, devices that consume node
    allocatable) off unless asked for, as the JAX package's gates are."""
    return default_profile(handle, dra=DynamicResources(
        handle, extended_resources=extended_resources, node_allocatable=node_allocatable))
