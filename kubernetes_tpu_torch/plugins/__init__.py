from .basic import (
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
from .extras import NodeDeclaredFeatures
from .noderesources import BalancedAllocation, Fit

__all__ = ["DefaultBinder", "ImageLocality", "NodeAffinity", "NodeName", "NodePorts",
           "NodeUnschedulable", "PrioritySort", "SchedulingGates", "TaintToleration",
           "NodeDeclaredFeatures", "BalancedAllocation", "Fit"]
