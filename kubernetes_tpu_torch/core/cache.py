"""Scheduler cache: assumed-pod-aware aggregate of cluster state with
generation-based incremental snapshots.

Re-expresses pkg/scheduler/backend/cache/cache.go (cacheImpl :61): the cache
holds authoritative NodeInfos, tracks pods assumed-but-not-yet-bound
(AssumePod/ForgetPod), and refreshes a per-cycle Snapshot incrementally —
only NodeInfos whose generation advanced since the last UpdateSnapshot are
re-cloned (cache.go:206,236-262). The snapshot's list order is the
zone-interleaved NodeTree order, which the device kernels' rotation
arithmetic operates on directly (row index == list position).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set

from ..api.types import Node, Pod
from .node_info import NodeInfo, PodInfo, next_generation
from .node_tree import NodeTree


class Snapshot:
    """Per-cycle view (backend/cache/snapshot.go)."""

    def __init__(self):
        self.node_info_map: Dict[str, NodeInfo] = {}
        self.node_info_list: List[NodeInfo] = []
        self.generation: int = 0
        self._index: Dict[str, int] = {}

    def get(self, name: str) -> Optional[NodeInfo]:
        return self.node_info_map.get(name)

    def num_nodes(self) -> int:
        return len(self.node_info_list)


class Cache:
    """cacheImpl (backend/cache/cache.go:61)."""

    def __init__(self):
        self.nodes: Dict[str, NodeInfo] = {}
        # Snapshot order = zone-interleaved NodeTree order + imaginary
        # placeholders (pods observed before their node), rebuilt lazily
        # when tree membership changes (node_tree.go list()).
        self.node_order: List[str] = []
        self._imaginary: List[str] = []
        self._order_dirty = False
        self.node_tree = NodeTree()
        self.assumed_pods: Set[str] = set()
        self.pod_states: Dict[str, Pod] = {}
        self._dirty: Set[str] = set()
        self._removed_since_snapshot = False

    # -- nodes -------------------------------------------------------------

    def add_node(self, node: Node) -> NodeInfo:
        ni = self.nodes.get(node.name)
        if ni is None:
            ni = NodeInfo(node)
            self.nodes[node.name] = ni
        else:
            ni.set_node(node)
        if node.name in self._imaginary:  # placeholder became real
            self._imaginary.remove(node.name)
            self._order_dirty = True
        if self.node_tree.add_node(node):
            self._order_dirty = True
        self._dirty.add(node.name)
        return ni

    def remove_node(self, node_name: str) -> None:
        ni = self.nodes.pop(node_name, None)
        if ni is not None:
            if ni.node is not None:
                self.node_tree.remove_node(ni.node)
            if node_name in self._imaginary:
                self._imaginary.remove(node_name)
            self._order_dirty = True
            self._removed_since_snapshot = True
        self._dirty.discard(node_name)

    # -- pods --------------------------------------------------------------

    def assume_pod(self, pod: Pod, pod_info: Optional[PodInfo] = None) -> None:
        """AssumePod (cache.go): place the pod on its node before the bind
        API call completes."""
        if pod.uid in self.pod_states:
            raise ValueError(f"pod {pod.uid} is already assumed/added")
        self._add_pod_to_node(pod, pod_info)
        self.assumed_pods.add(pod.uid)
        self.pod_states[pod.uid] = pod

    def forget_pod(self, pod: Pod) -> None:
        if pod.uid not in self.assumed_pods:
            return
        self._remove_pod_from_node(self.pod_states.pop(pod.uid))
        self.assumed_pods.discard(pod.uid)

    def add_pod(self, pod: Pod) -> None:
        """Confirmed (watch-observed) pod add. Replaces the assumed copy."""
        old = self.pod_states.get(pod.uid)
        if old is not None:
            if pod.uid in self.assumed_pods:
                if old.node_name != pod.node_name:
                    self._remove_pod_from_node(old)
                    self._add_pod_to_node(pod)
                self.assumed_pods.discard(pod.uid)
        else:
            self._add_pod_to_node(pod)
        self.pod_states[pod.uid] = pod

    def update_pod(self, old: Pod, new: Pod) -> None:
        if new.uid in self.assumed_pods or new.uid not in self.pod_states:
            self.add_pod(new)
            return
        self._remove_pod_from_node(self.pod_states[new.uid])
        self._add_pod_to_node(new)
        self.pod_states[new.uid] = new

    def remove_pod(self, pod: Pod) -> None:
        old = self.pod_states.pop(pod.uid, None)
        if old is not None:
            self._remove_pod_from_node(old)
        self.assumed_pods.discard(pod.uid)

    def is_assumed_pod(self, pod: Pod) -> bool:
        return pod.uid in self.assumed_pods

    def _add_pod_to_node(self, pod: Pod, pod_info: Optional[PodInfo] = None) -> None:
        ni = self.nodes.get(pod.node_name)
        if ni is None:
            # Pod on an unknown node: an imaginary placeholder NodeInfo
            # keeps its usage counted until the node arrives.
            ni = NodeInfo()
            self.nodes[pod.node_name] = ni
            self._imaginary.append(pod.node_name)
            self._order_dirty = True
        if pod_info is None or pod_info.pod is not pod:
            pod_info = PodInfo.of(pod)
        ni.add_pod(pod_info)
        self._dirty.add(pod.node_name)

    def _remove_pod_from_node(self, pod: Pod) -> None:
        ni = self.nodes.get(pod.node_name)
        if ni is not None:
            ni.remove_pod(pod)
            self._dirty.add(pod.node_name)

    # -- snapshot ----------------------------------------------------------

    def update_snapshot(self, snapshot: Snapshot) -> Snapshot:
        """UpdateSnapshot (cache.go:206): re-clone only dirty NodeInfos and
        patch them into the snapshot list in place; rebuild the list only on
        structural changes."""
        structural = self._order_dirty or self._removed_since_snapshot
        if self._order_dirty:
            self.node_order = self.node_tree.list() + list(self._imaginary)
            self._order_dirty = False
        structural = structural or len(snapshot.node_info_list) != len(self.node_order)
        replaced = []
        for name in self._dirty:
            ni = self.nodes.get(name)
            if ni is None:
                continue
            clone = ni.snapshot_clone()
            snapshot.node_info_map[name] = clone
            replaced.append((name, clone))
        if structural:
            snapshot.node_info_map = {
                name: snapshot.node_info_map.get(name) or self.nodes[name].snapshot_clone()
                for name in self.node_order
            }
            # Imaginary nodes stay in the map for accounting but are
            # excluded from the schedulable list.
            snapshot.node_info_list = [
                snapshot.node_info_map[n] for n in self.node_order
                if snapshot.node_info_map[n].node is not None
            ]
            snapshot._index = {ni.name: i for i, ni in enumerate(snapshot.node_info_list)}
        else:
            for name, clone in replaced:
                idx = snapshot._index.get(name)
                if idx is not None and clone.node is not None:
                    snapshot.node_info_list[idx] = clone
        snapshot.generation = next_generation()
        self._dirty.clear()
        self._removed_since_snapshot = False
        return snapshot
