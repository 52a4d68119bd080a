from .basic import (
    DefaultBinder,
    NodeAffinity,
    NodeName,
    NodeUnschedulable,
    PrioritySort,
    TaintToleration,
)
from .noderesources import BalancedAllocation, Fit

__all__ = ["DefaultBinder", "NodeAffinity", "NodeName", "NodeUnschedulable",
           "PrioritySort", "TaintToleration", "BalancedAllocation", "Fit"]
