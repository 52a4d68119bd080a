"""The scheduler framework: extension-point vocabulary, Status codes,
CycleState, and the plugin-dispatch runtime, trimmed to the extension points
the port's plugins implement (QueueSort, PreFilter with its AddPod/RemovePod
extensions, Filter, PostFilter, PreScore, Score, NormalizeScore, Reserve,
Unreserve, Permit, PreBind with its PreBindPreFlight, Bind, PostBind, Sign,
and the pod-group points PlacementGenerate, PlacementFeasible,
PlacementScore and PodGroupPostFilter).

Re-expresses staging/src/k8s.io/kube-scheduler/framework interface.go and
pkg/scheduler/framework/runtime/framework.go (frameworkImpl :58). Plugins are
duck-typed: a plugin implements an extension point by defining the method.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..api.types import Pod
from .node_info import NodeInfo

MAX_NODE_SCORE = 100
MIN_NODE_SCORE = 0

# Status codes (staging kube-scheduler framework/types.go Code)
SUCCESS = 0
ERROR = 1
UNSCHEDULABLE = 2
UNSCHEDULABLE_AND_UNRESOLVABLE = 3
WAIT = 4
SKIP = 5


@dataclass
class Status:
    code: int = SUCCESS
    reasons: tuple = ()
    plugin: str = ""

    @classmethod
    def unschedulable(cls, *reasons: str, plugin: str = "") -> "Status":
        return cls(UNSCHEDULABLE, tuple(reasons), plugin)

    @classmethod
    def unresolvable(cls, *reasons: str, plugin: str = "") -> "Status":
        return cls(UNSCHEDULABLE_AND_UNRESOLVABLE, tuple(reasons), plugin)

    @classmethod
    def error(cls, *reasons: str, plugin: str = "") -> "Status":
        return cls(ERROR, tuple(reasons), plugin)

    @classmethod
    def skip(cls, plugin: str = "") -> "Status":
        return cls(SKIP, (), plugin)

    def is_success(self) -> bool:
        return self.code == SUCCESS

    def is_skip(self) -> bool:
        return self.code == SKIP

    def is_rejected(self) -> bool:
        return self.code in (UNSCHEDULABLE, UNSCHEDULABLE_AND_UNRESOLVABLE)

    def message(self) -> str:
        return "; ".join(self.reasons)


OK = Status()
SKIP_STATUS = Status.skip()  # shared: callers never stamp a Skip status

_NO_SKIPS: frozenset = frozenset()

# Distinguishes "memoized as unsignable (None)" from "not memoized".
_SIG_MISS = object()


class CycleState:
    """Per-scheduling-cycle KV store + skip sets (cycle_state.go)."""

    __slots__ = ("_data", "skip_filter_plugins", "skip_score_plugins", "skip_pre_bind_plugins")

    def __init__(self):
        self._data: Dict[str, Any] = {}
        self.skip_filter_plugins: set = set()
        self.skip_score_plugins: set = set()
        # Replaced, never changed in place (PreBindPreFlight's skips).
        self.skip_pre_bind_plugins: frozenset = _NO_SKIPS

    def write(self, key: str, value: Any) -> None:
        self._data[key] = value

    def read(self, key: str) -> Any:
        return self._data.get(key)

    def clone(self) -> "CycleState":
        """cycle_state.go Clone(): values with a clone() are deep-copied, so
        a what-if simulation cannot change the real cycle's plugin state."""
        c = CycleState()
        c._data = {k: (v.clone() if hasattr(v, "clone") else v) for k, v in self._data.items()}
        c.skip_filter_plugins = set(self.skip_filter_plugins)
        c.skip_score_plugins = set(self.skip_score_plugins)
        c.skip_pre_bind_plugins = self.skip_pre_bind_plugins
        return c


@dataclass
class Diagnosis:
    node_to_status: Dict[str, Status] = field(default_factory=dict)
    unschedulable_plugins: set = field(default_factory=set)
    pre_filter_msg: str = ""


class FitError(Exception):
    """schedule_one.go FitError — pod didn't fit any node."""

    def __init__(self, pod: Pod, num_all_nodes: int, diagnosis: Diagnosis):
        self.pod = pod
        self.num_all_nodes = num_all_nodes
        self.diagnosis = diagnosis
        rejected = sum(1 for s in diagnosis.node_to_status.values() if s.is_rejected())
        super().__init__(
            f"0/{num_all_nodes} nodes are available for pod {pod.namespace}/{pod.name} "
            f"({rejected} rejected): {diagnosis.pre_filter_msg}")


@dataclass
class PreFilterResult:
    node_names: Optional[set] = None  # None => all nodes

    def all_nodes(self) -> bool:
        return self.node_names is None

    def merge(self, other: "PreFilterResult") -> "PreFilterResult":
        if self.all_nodes():
            return PreFilterResult(None if other.all_nodes() else set(other.node_names))
        if other.all_nodes():
            return PreFilterResult(set(self.node_names))
        return PreFilterResult(self.node_names & other.node_names)


@dataclass
class NodeScore:
    name: str
    score: int


@dataclass
class Placement:
    """A named candidate node subset for pod-group scheduling (one per
    topology domain, topology_placement.go)."""

    name: str
    node_names: List[str]


@dataclass
class PlacementProgress:
    """A group simulation's outcome handed to PlacementFeasible plugins
    (framework.go:2160)."""

    scheduled: int = 0
    failed: int = 0
    total: int = 0


@dataclass
class PodGroupAssignments:
    """One feasible placement simulation: the proposed member -> node
    assignments and the placement's NodeInfos, which PlacementScore plugins
    score."""

    placement: Placement
    proposed: List[Tuple[Pod, str]] = field(default_factory=list)
    nodes: List[Any] = field(default_factory=list)  # NodeInfo


def default_normalize_score(max_priority: int, reverse: bool, scores: List[NodeScore]) -> None:
    """plugins/helper/normalize_score.go DefaultNormalizeScore."""
    max_count = max((s.score for s in scores), default=0)
    max_count = max(max_count, 0)
    if max_count == 0:
        if reverse:
            for s in scores:
                s.score = max_priority
        return
    for s in scores:
        score = max_priority * s.score // max_count
        s.score = max_priority - score if reverse else score


class Framework:
    """One profile's plugin set + dispatch (frameworkImpl). `plugins` is an
    ordered list of (plugin_instance, weight)."""

    def __init__(self, profile_name: str = "default-scheduler",
                 plugins: Optional[Sequence[Tuple[Any, int]]] = None):
        self.profile_name = profile_name
        self._plugins: List[Tuple[Any, int]] = list(plugins or [])
        self.pre_enqueue_plugins = self._having("pre_enqueue")
        self.queue_sort_plugins = self._having("less")
        self.pre_filter_plugins = self._having("pre_filter")
        self.filter_plugins = self._having("filter")
        self.post_filter_plugins = self._having("post_filter")
        self.pre_score_plugins = self._having("pre_score")
        self.score_plugins = [(p, w) for p, w in self._plugins if hasattr(p, "score")]
        self.reserve_plugins = self._having("reserve")
        self.unreserve_plugins = self._having("unreserve")
        self.permit_plugins = self._having("permit")
        self.pre_bind_plugins = self._having("pre_bind")
        self.bind_plugins = self._having("bind")
        self.post_bind_plugins = self._having("post_bind")
        self.sign_plugins = self._having("sign")
        # Pod-group extension points (framework.go:2208, :2160, :1625, :1212).
        self.placement_generate_plugins = self._having("generate_placements")
        self.placement_feasible_plugins = self._having("placement_feasible")
        self.placement_score_plugins = [(p, w) for p, w in self._plugins
                                        if hasattr(p, "score_placement")]
        self.pod_group_post_filter_plugins = self._having("pod_group_post_filter")
        # Per-plugin QueueingHintFn registrations (EventsToRegister):
        # plugin name -> {event: [hint fn or None]}. Plugins without
        # events_to_register fall back to the queue's static event map.
        self.queueing_hint_map: Dict[str, Dict[str, List[Any]]] = {}
        for p, _w in self._plugins:
            etr = getattr(p, "events_to_register", None)
            if etr is None:
                continue
            m: Dict[str, List[Any]] = {}
            for event, fn in etr():
                m.setdefault(event, []).append(fn)
            self.queueing_hint_map[p.name] = m

    def _having(self, method: str) -> List[Any]:
        return [p for p, _ in self._plugins if hasattr(p, method)]

    def plugin(self, name: str) -> Optional[Any]:
        for p, _ in self._plugins:
            if p.name == name:
                return p
        return None

    def run_pre_enqueue_plugins(self, pod: Pod) -> Status:
        """PreEnqueue (framework.go RunPreEnqueuePlugins): the first gate
        that holds the pod, its plugin named in the status."""
        for p in self.pre_enqueue_plugins:
            st = p.pre_enqueue(pod)
            if not st.is_success():
                st.plugin = p.name
                return st
        return OK

    @property
    def queue_sort_key(self):
        """Tuple-key form of the queue-sort plugin's comparison."""
        if self.queue_sort_plugins:
            return self.queue_sort_plugins[0].sort_key
        return lambda qpi: (qpi.timestamp,)

    # -- filtering ---------------------------------------------------------

    def run_pre_filter_plugins(
        self, state: CycleState, pod: Pod, nodes: Sequence[NodeInfo]
    ) -> Tuple[Optional[PreFilterResult], Status]:
        """runtime/framework.go:934 RunPreFilterPlugins: merge PreFilterResults,
        collect Skip sets, short-circuit on rejection."""
        result: Optional[PreFilterResult] = None
        skipped = set()
        for p in self.pre_filter_plugins:
            r, st = p.pre_filter(state, pod, nodes)
            if st.is_skip():
                skipped.add(p.name)
                continue
            if not st.is_success():
                st.plugin = p.name
                return None, st
            if r is not None and not r.all_nodes():
                result = r if result is None else result.merge(r)
                if not result.node_names:
                    return result, Status.unresolvable(
                        "node(s) didn't satisfy plugin(s) prefilter result", plugin=p.name)
        state.skip_filter_plugins = skipped
        return result, OK

    def run_filter_plugins(self, state: CycleState, pod: Pod, node_info: NodeInfo) -> Status:
        """runtime/framework.go:1105 RunFilterPlugins (per node)."""
        for p in self.filter_plugins:
            if p.name in state.skip_filter_plugins:
                continue
            st = p.filter(state, pod, node_info)
            if not st.is_success():
                st.plugin = p.name
                return st
        return OK

    def run_filter_plugins_with_nominated_pods(self, state: CycleState, pod: Pod,
                                               node_info: NodeInfo, nominator=None) -> Status:
        """runtime/framework.go:1275, the two-pass filter: the first pass
        counts the node's nominated pods of equal or higher priority as if
        they ran there, the second filters without them."""
        nominated = []
        if nominator is not None and node_info.node is not None:
            nominated = [pi for pi in nominator.nominated_pods_for_node(node_info.node.name)
                         if pi.pod.uid != pod.uid and pi.pod.priority >= pod.priority]
        if nominated:
            state_with = state.clone()
            ni_with = node_info.snapshot_clone()
            for pi in nominated:
                ni_with.add_pod(pi)
                for p in self.pre_filter_plugins:
                    if p.name in state.skip_filter_plugins:
                        continue
                    add_pod = getattr(p, "add_pod", None)
                    if add_pod is not None:
                        st = add_pod(state_with, pod, pi, ni_with)
                        if not st.is_success():
                            st.plugin = p.name
                            return st
            st = self.run_filter_plugins(state_with, pod, ni_with)
            if not st.is_success():
                return st
        return self.run_filter_plugins(state, pod, node_info)

    def run_post_filter_plugins(self, state: CycleState, pod: Pod,
                                filtered_status_map: Dict[str, Status]):
        """runtime/framework.go:1152: the first plugin that succeeds or
        declares the pod unresolvable decides."""
        for p in self.post_filter_plugins:
            result, st = p.post_filter(state, pod, filtered_status_map)
            if st.is_success() or st.code == UNSCHEDULABLE_AND_UNRESOLVABLE:
                return result, Status(st.code, st.reasons, p.name)
        return None, Status.unschedulable("no postFilter plugin made progress")

    # -- scoring -----------------------------------------------------------

    def run_pre_score_plugins(self, state: CycleState, pod: Pod, nodes: Sequence[NodeInfo]) -> Status:
        skipped = set()
        for p in self.pre_score_plugins:
            st = p.pre_score(state, pod, nodes)
            if st.is_skip():
                skipped.add(p.name)
                continue
            if not st.is_success():
                st.plugin = p.name
                return st
        state.skip_score_plugins = skipped
        return OK

    def run_score_plugins(
        self, state: CycleState, pod: Pod, nodes: Sequence[NodeInfo]
    ) -> Dict[str, List[NodeScore]]:
        """runtime/framework.go:1405 RunScorePlugins: per-plugin score each
        node, run NormalizeScore, then apply plugin weight."""
        all_scores: Dict[str, List[NodeScore]] = {}
        for p, weight in self.score_plugins:
            if p.name in state.skip_score_plugins:
                continue
            scores = [NodeScore(ni.name, p.score(state, pod, ni)) for ni in nodes]
            normalize = getattr(p, "normalize_score", None)
            if normalize is not None:
                normalize(state, pod, scores)
            for ns in scores:
                if ns.score > MAX_NODE_SCORE or ns.score < MIN_NODE_SCORE:
                    raise RuntimeError(
                        f"plugin {p.name} returns an invalid score {ns.score} for node {ns.name}")
                ns.score *= weight
            all_scores[p.name] = scores
        return all_scores

    # -- pod-group extension points ------------------------------------------

    def run_placement_generate_plugins(self, state: CycleState, group, members,
                                       parent: Placement) -> Tuple[List[Placement], Status]:
        """RunPlacementGeneratePlugins: each plugin refines the previous
        plugin's placements."""
        placements = [parent]
        for p in self.placement_generate_plugins:
            nxt: List[Placement] = []
            for parent_pl in placements:
                out, st = p.generate_placements(state, group, members, parent_pl)
                if not st.is_success():
                    st.plugin = p.name
                    return [], st
                nxt.extend(out)
            placements = nxt
        return placements, OK

    def run_placement_feasible_plugins(self, state: CycleState, group,
                                       progress: PlacementProgress) -> Status:
        """RunPlacementFeasiblePlugins: the group-level gate on a simulation
        (GangScheduling: scheduled >= min_count)."""
        for p in self.placement_feasible_plugins:
            st = p.placement_feasible(state, group, progress)
            if not st.is_success():
                st.plugin = p.name
                return st
        return OK

    def run_placement_score_plugins(self, state: CycleState, group,
                                    assignments: List[PodGroupAssignments]) -> List[int]:
        """RunPlacementScorePlugins: score, normalize, weight and sum per
        candidate placement."""
        totals = [0] * len(assignments)
        for p, weight in self.placement_score_plugins:
            scores = []
            for pga in assignments:
                sc, st = p.score_placement(state, group, pga)
                if not st.is_success():
                    raise RuntimeError(f"placement score {p.name} failed: {st.message()}")
                scores.append(sc)
            norm = getattr(p, "normalize_placement_score", None)
            if norm is not None:
                scores = norm(group, scores)
            for i, sc in enumerate(scores):
                totals[i] += weight * sc
        return totals

    def run_pod_group_post_filter_plugins(self, state: CycleState, group, members, diagnosis):
        """RunPodGroupPostFilterPlugins (framework.go:1212): a chance to make
        room for the whole group (pod-group preemption)."""
        for p in self.pod_group_post_filter_plugins:
            result, st = p.pod_group_post_filter(state, group, members, diagnosis)
            if st.is_success() or st.code not in (UNSCHEDULABLE, UNSCHEDULABLE_AND_UNRESOLVABLE):
                st.plugin = p.name
                return result, st
        return None, Status.unschedulable("no pod-group post filter made room")

    # -- reserve / permit / bind ---------------------------------------------

    def run_reserve_plugins_reserve(self, state: CycleState, pod: Pod, node_name: str) -> Status:
        for p in self.reserve_plugins:
            st = p.reserve(state, pod, node_name)
            if not st.is_success():
                st.plugin = p.name
                return st
        return OK

    def run_reserve_plugins_unreserve(self, state: CycleState, pod: Pod, node_name: str) -> None:
        for p in reversed(self.unreserve_plugins):
            p.unreserve(state, pod, node_name)

    def run_permit_plugins(self, state: CycleState, pod: Pod, node_name: str) -> Status:
        """The first plugin that does not allow decides (a rejection, WAIT or
        an error)."""
        for p in self.permit_plugins:
            st = p.permit(state, pod, node_name)
            if not st.is_success():
                st.plugin = p.name
                return st
        return OK

    def run_pre_bind_pre_flight(self, state: CycleState, pod: Pod, node_name: str) -> Status:
        """PreBindPreFlight (interface.go:688-694, framework.go:1875): each
        PreBind plugin says whether it has work for this pod. Those that
        answer Skip are recorded in the state; Skip when every one does, so
        the binding cycle bypasses PreBind."""
        all_skip = True
        skipped = None
        for p in self.pre_bind_plugins:
            flight = getattr(p, "pre_bind_pre_flight", None)
            if flight is None:
                all_skip = False
                continue
            st = flight(state, pod, node_name)
            if st.is_skip():
                skipped = {p.name} if skipped is None else skipped | {p.name}
            elif not st.is_success():
                st.plugin = p.name
                return st
            else:
                all_skip = False
        if skipped is not None:
            state.skip_pre_bind_plugins = frozenset(skipped)
        return SKIP_STATUS if all_skip else OK

    def run_pre_bind_plugins(self, state: CycleState, pod: Pod, node_name: str) -> Status:
        for p in self.pre_bind_plugins:
            if p.name in state.skip_pre_bind_plugins:
                continue
            st = p.pre_bind(state, pod, node_name)
            if not st.is_success():
                st.plugin = p.name
                return st
        return OK

    def run_bind_plugins(self, state: CycleState, pod: Pod, node_name: str) -> Status:
        for p in self.bind_plugins:
            st = p.bind(state, pod, node_name)
            if st.is_skip():
                continue
            if st.is_success():
                return st
            return Status(st.code, st.reasons, p.name)
        return Status.error("no bind plugin bound the pod")

    def run_post_bind_plugins(self, state: CycleState, pod: Pod, node_name: str) -> None:
        """PostBind (framework.go RunPostBindPlugins): informational, after a
        successful bind."""
        for p in self.post_bind_plugins:
            p.post_bind(state, pod, node_name)

    # -- signatures (kernel row-block batching) ----------------------------

    def sign_pod(self, pod: Pod) -> Optional[tuple]:
        """Pod signature for batching (staging framework/signers.go). None =>
        unsignable. Memoized per pod object keyed by (framework, node_name),
        or per template through the `_sig_shared` holder of
        Pod.clone_from_template."""
        key = (id(self), pod.node_name)
        shared = pod.__dict__.get("_sig_shared")
        if shared is not None:
            hit = shared.get(key, _SIG_MISS)
            if hit is not _SIG_MISS:
                return hit
        else:
            cached = pod.__dict__.get("_sig_cache")
            if cached is not None and cached[0] == key:
                return cached[1]
        sig = []
        out: Optional[tuple] = None
        for p in self.sign_plugins:
            part = p.sign(pod)
            if part is None:
                break
            sig.append((p.name, part))
        else:
            out = tuple(sig) if sig else None
        if shared is not None:
            shared[key] = out
        else:
            pod._sig_cache = (key, out)
        return out
