from . import labels, resource, types
from .labels import LabelSelector, Requirement
from .resource import Resource
from .types import Namespace, Node, Pod, PodGroup, Taint, Toleration

__all__ = ["labels", "resource", "types", "LabelSelector", "Requirement",
           "Resource", "Namespace", "Node", "Pod", "PodGroup", "Taint", "Toleration"]
