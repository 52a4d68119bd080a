from .evicting import EvictingClientset
from .wrappers import MakeNode, MakePod, make_node, make_pod

__all__ = ["EvictingClientset", "MakeNode", "MakePod", "make_node", "make_pod"]
