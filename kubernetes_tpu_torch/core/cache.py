"""Scheduler cache: assumed-pod-aware aggregate of cluster state with
generation-based incremental snapshots.

Re-expresses pkg/scheduler/backend/cache/cache.go (cacheImpl :61): the cache
holds authoritative NodeInfos, tracks pods assumed-but-not-yet-bound
(AssumePod/ForgetPod), and refreshes a per-cycle Snapshot incrementally —
only NodeInfos whose generation advanced since the last UpdateSnapshot are
re-cloned (cache.go:206,236-262). The snapshot's list order is the
zone-interleaved NodeTree order, which the device kernels' rotation
arithmetic operates on directly (row index == list position).

Beside it, the typed cluster-event journal (the JAX package's
core/cache.py:30-145): the cluster-event version a device session keys on,
with what each bump was, so that a session can patch the node rows an event
dirtied instead of rebuilding its plan.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, NamedTuple, Optional, Set

from ..api.types import Namespace, Node, Pod
from .node_info import NodeInfo, PodInfo, next_generation
from .node_tree import NodeTree

# ---------------------------------------------------------------------------
# Typed cluster-event journal
# ---------------------------------------------------------------------------

# Queue-only change (a pending pod's update or delete): dirties nothing
# node-side, so a live session's state, plan and carry stay exact.
EV_QUEUE = "queue"
# Namespace created or relabelled: only namespaceSelector matching reads
# namespace labels, so it is benign for plans with no inter-pod affinity
# anywhere in play.
EV_NAMESPACE = "namespace"
# A pod appeared on, left or changed on a node (key = node name): dirties the
# node's resource aggregates, and pod-derived feature tables unless the pod
# is `plain` (pod_event_flags) and the plan carries none.
EV_POD_ADD = "pod_add"
EV_POD_REMOVE = "pod_remove"
EV_POD_UPDATE = "pod_update"
# Node object replaced with its labels, images and declared features intact
# (key = node name): dirties that row's taint, allocatable and unschedulable
# tensors only.
EV_NODE_UPDATE = "node_update"
# Node added or removed: the row order changes, never delta-patchable.
EV_STRUCTURAL = "structural"
# Everything else (a node's labels, images or declared features changed):
# full rebuild.
EV_OTHER = "other"


class ClusterEvent(NamedTuple):
    seq: int
    kind: str
    key: str = ""            # node name (pod and node kinds) or namespace name
    pod_plain: bool = False  # no affinity or spread terms, no PVCs or claims
    pod_ports: bool = False  # requests host ports
    # The event can only enlarge feasibility (a pod removed, a taint lifted,
    # capacity grown): device results computed before it stay feasible, so
    # in-flight batches may still commit while the patch waits for the
    # pipeline to drain.
    shrink: bool = False


def pod_event_flags(pod: Pod) -> tuple:
    """(pod_plain, pod_ports) for a journal record. `plain`: the pod cannot
    dirty any pod-derived feature table (no affinity or anti-affinity terms,
    no topology spread constraints, no PVC-backed volumes, no claims)."""
    aff = pod.affinity
    plain = not (
        pod.topology_spread_constraints
        or (aff is not None and (aff.pod_affinity or aff.pod_anti_affinity))
        or any(v.pvc_name for v in pod.volumes)
        or pod.resource_claims
    )
    return plain, bool(pod.host_ports())


class EventJournal:
    """Bounded journal of node-state-relevant cluster events. `seq` is the
    cluster-event version; `since(S)` answers what changed after S, or None
    when S has fallen off the retention window (treat as "anything may have
    changed": full rebuild)."""

    __slots__ = ("cap", "seq", "_events")

    def __init__(self, capacity: int = 4096):
        self.cap = capacity
        self.seq = 0
        self._events: deque = deque()

    def record(self, kind: str, key: str = "", pod_plain: bool = False,
               pod_ports: bool = False, shrink: bool = False) -> int:
        self.seq += 1
        self._events.append(ClusterEvent(self.seq, kind, key, pod_plain, pod_ports, shrink))
        if len(self._events) > self.cap:
            self._events.popleft()
        return self.seq

    def since(self, seq: int) -> Optional[List[ClusterEvent]]:
        """Events with .seq > seq in order, [] when nothing happened, or None
        when the window was truncated. Walks from the right, so a check costs
        O(new events)."""
        if seq >= self.seq:
            return []
        if not self._events or self._events[0].seq > seq + 1:
            return None
        out: List[ClusterEvent] = []
        for e in reversed(self._events):
            if e.seq <= seq:
                break
            out.append(e)
        out.reverse()
        return out


def _has_pod_affinity(pod: Pod) -> bool:
    aff = pod.affinity
    return aff is not None and bool(aff.pod_affinity or aff.pod_anti_affinity)


class Snapshot:
    """Per-cycle view (backend/cache/snapshot.go)."""

    def __init__(self):
        self.node_info_map: Dict[str, NodeInfo] = {}
        self.node_info_list: List[NodeInfo] = []
        # Nodes hosting pods with (anti-)affinity terms resp. required
        # anti-affinity terms, in list order (snapshot.go
        # havePodsWithAffinityNodeInfoList): InterPodAffinity walks only these.
        self.have_pods_with_affinity_list: List[NodeInfo] = []
        self.have_pods_with_required_anti_affinity_list: List[NodeInfo] = []
        # Image name -> the listed nodes holding it (ImageLocality's spread).
        self.image_num_nodes: Dict[str, int] = {}
        self.generation: int = 0
        self._index: Dict[str, int] = {}

    def get(self, name: str) -> Optional[NodeInfo]:
        return self.node_info_map.get(name)

    def num_nodes(self) -> int:
        return len(self.node_info_list)

    def _rebuild_lists(self) -> None:
        self.have_pods_with_affinity_list = [
            ni for ni in self.node_info_list if ni.pods_with_affinity]
        self.have_pods_with_required_anti_affinity_list = [
            ni for ni in self.node_info_list if ni.pods_with_required_anti_affinity]
        self._count_images()
        self._index = {ni.name: i for i, ni in enumerate(self.node_info_list)}

    def _count_images(self) -> None:
        self.image_num_nodes = {}
        for ni in self.node_info_list:
            for img in ni.image_states:
                self.image_num_nodes[img] = self.image_num_nodes.get(img, 0) + 1

    # -- in-cycle what-if mutation (gang simulation, snapshot.go:545/:599;
    # the JAX package's core/cache.py:184-222) ------------------------------

    def assume_pod(self, pod: Pod) -> None:
        """Place `pod` on its node in this snapshot only, keeping the
        affinity sublists in step (PreFilter reads them mid-simulation)."""
        ni = self.node_info_map.get(pod.node_name)
        if ni is None:
            return
        had_aff = bool(ni.pods_with_affinity)
        had_anti = bool(ni.pods_with_required_anti_affinity)
        ni.add_pod(PodInfo.of(pod))
        if not had_aff and ni.pods_with_affinity:
            self.have_pods_with_affinity_list.append(ni)
        if not had_anti and ni.pods_with_required_anti_affinity:
            self.have_pods_with_required_anti_affinity_list.append(ni)

    def forget_pod(self, pod: Pod) -> None:
        ni = self.node_info_map.get(pod.node_name)
        if ni is None:
            return
        had_aff = bool(ni.pods_with_affinity)
        had_anti = bool(ni.pods_with_required_anti_affinity)
        ni.remove_pod(pod)
        if had_aff and not ni.pods_with_affinity:
            self.have_pods_with_affinity_list = [
                x for x in self.have_pods_with_affinity_list if x is not ni]
        if had_anti and not ni.pods_with_required_anti_affinity:
            self.have_pods_with_required_anti_affinity_list = [
                x for x in self.have_pods_with_required_anti_affinity_list if x is not ni]

    # -- placement session (snapshot.go:708 AssumePlacement; the JAX
    # package's :225-240): the visible node list restricted to a candidate
    # placement while a pod group is simulated against it. The NodeInfos are
    # the full list's, so in-simulation assume/forget stay visible after the
    # placement is forgotten.

    def assume_placement(self, node_names) -> None:
        assert not self.placement_active(), "placement already assumed"
        wanted = set(node_names)
        self._placement_saved = self.node_info_list
        self.node_info_list = [ni for ni in self._placement_saved if ni.name in wanted]
        self._rebuild_lists()

    def forget_placement(self) -> None:
        self.node_info_list = self._placement_saved
        del self._placement_saved
        self._rebuild_lists()

    def placement_active(self) -> bool:
        return hasattr(self, "_placement_saved")


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
        self.namespaces: Dict[str, Namespace] = {}
        # Pods (assumed or bound) that carry inter-pod (anti-)affinity terms:
        # the live gate of the namespace-erased session signature and of the
        # namespace-event delta classification (models/tpu_scheduler.py).
        self.affinity_pod_refs = 0
        # Claim key ("ns/name") -> the pods (assumed or bound) that mount
        # it, cluster-wide: a claim already in use is the "shared pvc" that
        # sends a pod to the host path (ops/features.py
        # volume_device_support).
        self.pvc_refs: Dict[str, int] = {}
        # The scheduler's placed-group-members index (core/podgroupstate.py),
        # fed from the add and remove flow below.
        self.pod_group_state = None

    # -- namespaces (read by namespaceSelector matching) -------------------

    def add_namespace(self, ns: Namespace) -> None:
        self.namespaces[ns.name] = ns

    def namespace_labels(self, name: str) -> Optional[Dict[str, str]]:
        ns = self.namespaces.get(name)
        return ns.labels if ns else None

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
        if self.pod_group_state is not None:
            self.pod_group_state.record_bound(pod)
        if pod.volumes:
            for key in pod_info.pvc_keys:
                self.pvc_refs[key] = self.pvc_refs.get(key, 0) + 1
        if _has_pod_affinity(pod):
            self.affinity_pod_refs += 1
        self._dirty.add(pod.node_name)

    def _remove_pod_from_node(self, pod: Pod) -> None:
        if self.pod_group_state is not None:
            self.pod_group_state.remove(pod)
        # Dropped even when the pod's node has left the cache: a leaked
        # count would mark the claim shared for good.
        for v in pod.volumes:
            if v.pvc_name:
                key = f"{pod.namespace}/{v.pvc_name}"
                n = self.pvc_refs.get(key, 0) - 1
                if n <= 0:
                    self.pvc_refs.pop(key, None)
                else:
                    self.pvc_refs[key] = n
        if _has_pod_affinity(pod):
            self.affinity_pod_refs = max(0, self.affinity_pod_refs - 1)
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
        images_moved = structural
        for name in self._dirty:
            ni = self.nodes.get(name)
            if ni is None:
                continue
            clone = ni.snapshot_clone()
            old = snapshot.node_info_map.get(name)
            if old is None or (old.image_states is not clone.image_states
                               and old.image_states.keys() != clone.image_states.keys()):
                images_moved = True
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
        if structural or replaced:
            snapshot.have_pods_with_affinity_list = [
                ni for ni in snapshot.node_info_list if ni.pods_with_affinity]
            snapshot.have_pods_with_required_anti_affinity_list = [
                ni for ni in snapshot.node_info_list if ni.pods_with_required_anti_affinity]
        if images_moved:
            snapshot._count_images()
        snapshot.generation = next_generation()
        self._dirty.clear()
        self._removed_since_snapshot = False
        return snapshot
