from . import labels, resource, types
from .labels import LabelSelector, Requirement
from .resource import Resource
from .types import Node, Pod, Taint, Toleration

__all__ = ["labels", "resource", "types", "LabelSelector", "Requirement",
           "Resource", "Node", "Pod", "Taint", "Toleration"]
