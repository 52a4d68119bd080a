from .wrappers import MakeNode, MakePod, make_node, make_pod

__all__ = ["MakeNode", "MakePod", "make_node", "make_pod"]
