"""Zone-interleaved node ordering (backend/cache/node_tree.go).

Nodes are bucketed by zone (topology.kubernetes.io/zone + region) and listed
round-robin across zones so that naive index-order iteration spreads load.
"""

from __future__ import annotations

from typing import Dict, List

from ..api.types import LABEL_REGION, LABEL_ZONE, Node


def _zone_key(node: Node) -> str:
    region = node.labels.get(LABEL_REGION, "")
    zone = node.labels.get(LABEL_ZONE, "")
    return f"{region}:\x00:{zone}"


class NodeTree:
    def __init__(self):
        self.tree: Dict[str, List[str]] = {}
        self.zones: List[str] = []
        self.node_zone: Dict[str, str] = {}
        self.num_nodes = 0

    def add_node(self, node: Node) -> bool:
        """Add or re-bucket a node. Returns True when tree structure changed
        (new node, or an existing node moved zones — node_tree.go updateNode)."""
        zone = _zone_key(node)
        old_zone = self.node_zone.get(node.name)
        if old_zone == zone:
            return False
        if old_zone is not None:
            self._remove_from_zone(node.name, old_zone)
        if zone not in self.tree:
            self.tree[zone] = []
            self.zones.append(zone)
        self.tree[zone].append(node.name)
        self.node_zone[node.name] = zone
        self.num_nodes += 1
        return True

    def _remove_from_zone(self, name: str, zone: str) -> None:
        names = self.tree.get(zone)
        if names and name in names:
            names.remove(name)
            self.num_nodes -= 1
            if not names:
                del self.tree[zone]
                self.zones.remove(zone)
        self.node_zone.pop(name, None)

    def remove_node(self, node: Node) -> None:
        zone = self.node_zone.get(node.name, _zone_key(node))
        self._remove_from_zone(node.name, zone)

    def list(self) -> List[str]:
        """Round-robin across zones (node_tree.go list())."""
        out: List[str] = []
        idx = [0] * len(self.zones)
        remaining = self.num_nodes
        z = 0
        while remaining > 0 and self.zones:
            zone = self.zones[z % len(self.zones)]
            nodes = self.tree[zone]
            i = idx[z % len(self.zones)]
            if i < len(nodes):
                out.append(nodes[i])
                idx[z % len(self.zones)] += 1
                remaining -= 1
            z += 1
            if z > 10 * (self.num_nodes + len(self.zones) + 1):
                break
        return out
