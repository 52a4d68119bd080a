"""The port's scope guard: the port knows only the plugins in
core/registry.py, so an object that needs anything else is refused with
NotImplementedError naming the feature — never scheduled while ignoring a
constraint. Every pod is in scope; FakeClientset calls check_pod_group on
every pod-group write.

In scope: resources, taints and tolerations (PreferNoSchedule included),
node selectors and node affinity (required and preferred), host ports
(NodePorts), volumes backed by PersistentVolumeClaims (VolumeBinding,
NodeVolumeLimits, VolumeZone, VolumeRestrictions, with the PV controller),
resource claims (DynamicResources under a profile that has it, such as
core/registry.py dra_profile; under one without it claims are inert, as in
the JAX package's default profile), scheduling gates, required declared
node features (NodeDeclaredFeatures), node images (ImageLocality),
topology spread and pod (anti-)affinity, pod priority with
DefaultPreemption, and pod groups (gangs, with or without a topology
constraint, and pod-group preemption). Not in scope: composite pod-group
trees."""

from __future__ import annotations

from ..api.types import PodGroup


def check_pod_group(group) -> None:
    """A PodGroup that belongs to a composite tree, or anything other than a
    PodGroup (a CompositePodGroup), is refused: the composite tree cycle
    (the JAX package's schedule_composite_group) is not ported."""
    if not isinstance(group, PodGroup):
        raise NotImplementedError(
            f"{type(group).__name__} {getattr(group, 'namespace', '')}/"
            f"{getattr(group, 'name', '')}: composite pod groups are outside what "
            "kubernetes_tpu_torch covers")
    if group.parent_name:
        raise NotImplementedError(
            f"pod group {group.namespace}/{group.name}: a parent composite pod group "
            f"({group.parent_name}) is outside what kubernetes_tpu_torch covers")
