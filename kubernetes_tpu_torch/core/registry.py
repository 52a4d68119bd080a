"""The slice's default profile: the in-scope plugins of
pkg/scheduler/apis/config/v1/default_plugins.go:32-60, in the reference's
order (filter order decides which plugin a node's failure is charged to)
and with its weights (TaintToleration 3, NodeResourcesFit 1,
NodeResourcesBalancedAllocation 1). NodeAffinity scores only preferred terms,
which are outside the slice, so it takes part as PreFilter/Filter only."""

from __future__ import annotations

from ..plugins.basic import (
    DefaultBinder,
    NodeAffinity,
    NodeName,
    NodeUnschedulable,
    PrioritySort,
    TaintToleration,
)
from ..plugins.noderesources import BalancedAllocation, Fit
from .framework import Framework


def default_profile(clientset, profile_name: str = "default-scheduler") -> Framework:
    return Framework(profile_name=profile_name, plugins=[
        (PrioritySort(), 0),
        (NodeName(), 0),
        (NodeUnschedulable(), 0),
        (TaintToleration(), 3),
        (NodeAffinity(), 2),
        (Fit(), 1),
        (BalancedAllocation(), 1),
        (DefaultBinder(clientset), 0),
    ])
