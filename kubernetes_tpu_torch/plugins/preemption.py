"""Preemption: the DefaultPreemption PostFilter plugin and its dry-run
Evaluator, and pod-group preemption (PodGroupPostFilter, the
PodGroupEvaluator) — the JAX package's plugins/preemption.py.

Reference anchors:
- pkg/scheduler/framework/preemption/preemption.go — Evaluator.Preempt :181,
  findCandidates :201, DryRunPreemption :425 (the per-node victim
  simulation), SelectCandidate / pickOneNodeForPreemption :286;
- plugins/defaultpreemption/default_preemption.go — PostFilter → Evaluator,
  the victims' reprieve order (MoreImportantPod), PodEligibleToPreemptOthers.

Victims are deleted synchronously. Pod-group preemption is a host
simulation of the whole group (Handle.simulate_pod_group), as in the JAX
package. Where the scheduler has a device
(models/tpu_scheduler.py), the per-node dry run of every candidate node runs
as one kernel (ops/kernel.py dry_run_preemption) and the candidate it
selects is verified here by the exact host dry run of that node; a
disagreement is counted in `verify_divergences` and raises, as a failed
kernel launch does.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..api.types import Pod
from ..core.framework import OK, UNSCHEDULABLE_AND_UNRESOLVABLE, CycleState, Status
from ..core.node_info import NodeInfo, PodInfo


@dataclass
class Candidate:
    """One feasible preemption plan (preemption.go candidate)."""

    node_name: str
    victims: List[PodInfo] = field(default_factory=list)
    num_pdb_violations: int = 0


@dataclass
class PostFilterResult:
    nominating_info: Optional[str] = None  # the nominated node's name


def more_important_first(pi: PodInfo) -> tuple:
    """MoreImportantPod (preemption.go:480-520): higher priority, then the
    earlier start, first — the reprieve order."""
    return (-pi.pod.priority, pi.pod.creation_ts)


class Evaluator:
    """The preemption dry run (preemption.go Evaluator)."""

    MIN_CANDIDATE_NODES_PERCENTAGE = 10   # preemption.go minCandidateNodesPercentage
    MIN_CANDIDATE_NODES_ABSOLUTE = 100    # preemption.go minCandidateNodesAbsolute

    def __init__(self, handle, framework):
        self.handle = handle
        self.fw = framework
        self._offset = 0         # the rotating start, GetOffsetAndNumCandidates
        self.last_from_device = False  # the candidates came from the kernel

    def pod_eligible(self, pod: Pod, snapshot) -> Tuple[bool, str]:
        """default_preemption.go PodEligibleToPreemptOthers."""
        if pod.preemption_policy == "Never":
            return False, "not eligible due to preemptionPolicy=Never"
        if pod.nominated_node_name:
            ni = snapshot.get(pod.nominated_node_name)
            if ni is not None:
                # A lower-priority pod already terminating on the nominated
                # node means a preemption is in flight.
                for pi in ni.pods:
                    if pi.pod.priority < pod.priority and pi.pod.deletion_ts is not None:
                        return False, "a terminating victim already exists on the nominated node"
        return True, ""

    def dry_run_on_node(self, state: CycleState, pod: Pod,
                        node_info: NodeInfo) -> Optional[Candidate]:
        """Can `pod` fit on this node after evicting lower-priority pods?
        The minimal victim set after the reprieve pass, or None."""
        ni = node_info.snapshot_clone()
        sim_state = state.clone()
        potential = [pi for pi in ni.pods if pi.pod.priority < pod.priority]
        if not potential:
            return None

        def extend(method: str, pi: PodInfo) -> bool:
            for p in self.fw.pre_filter_plugins:
                fn = getattr(p, method, None)
                if fn is not None and not fn(sim_state, pod, pi, ni).is_success():
                    return False
            return True

        def remove_pod(pi: PodInfo) -> bool:
            return ni.remove_pod(pi.pod) and extend("remove_pod", pi)

        for pi in potential:
            if not remove_pod(pi):
                return None
        if not self.fw.run_filter_plugins(sim_state, pod, ni).is_success():
            return None
        # Reprieve: re-add the victims most important first, keeping each
        # one whose return still lets the pod fit.
        potential.sort(key=more_important_first)
        victims: List[PodInfo] = []
        for pi in potential:
            ni.add_pod(pi)
            if not extend("add_pod", pi):
                return None
            if not self.fw.run_filter_plugins(sim_state, pod, ni).is_success():
                if not remove_pod(pi):
                    return None
                victims.append(pi)
        if not victims:
            return None  # the pod fit without evicting anyone: not a preemption
        return Candidate(node_name=ni.name, victims=victims)

    def find_candidates(self, state: CycleState, pod: Pod,
                        node_to_status: Dict[str, Status]) -> List[Candidate]:
        """DryRunPreemption over the candidate nodes, capped at 10% of the
        cluster (at least 100) from a rotating offset
        (GetOffsetAndNumCandidates, preemption.go:201,425), skipping the
        nodes whose rejection no eviction can resolve. The handle's device
        dry run, where it has one, computes the same list in one kernel."""
        nodes = self.handle.snapshot().node_info_list
        n = len(nodes)
        if n == 0:
            return []
        num_candidates = max(n * self.MIN_CANDIDATE_NODES_PERCENTAGE // 100,
                             self.MIN_CANDIDATE_NODES_ABSOLUTE)
        start = self._offset % n
        self._offset += 1
        self.last_from_device = False
        device_fn = getattr(self.handle, "device_dry_run_preemption", None)
        if device_fn is not None:
            cands = device_fn(self.fw, state, pod, node_to_status, num_candidates, start)
            if cands is not None:
                self.last_from_device = True
                return cands
        candidates: List[Candidate] = []
        for i in range(n):
            ni = nodes[(start + i) % n]
            st = node_to_status.get(ni.name)
            if st is not None and st.code == UNSCHEDULABLE_AND_UNRESOLVABLE:
                continue  # nodesWherePreemptionMightHelp
            cand = self.dry_run_on_node(state, pod, ni)
            if cand is not None:
                candidates.append(cand)
                if len(candidates) >= num_candidates:
                    break
        return candidates

    @staticmethod
    def select_candidate(candidates: List[Candidate]) -> Optional[Candidate]:
        """pickOneNodeForPreemption (preemption.go:286): fewest PDB
        violations, then the lowest highest-victim priority, the lowest
        priority sum, the fewest victims, the latest victim start; the
        first in rotation order among equals."""
        if not candidates:
            return None

        def key(c: Candidate):
            return (c.num_pdb_violations,
                    max(pi.pod.priority for pi in c.victims),
                    sum(pi.pod.priority for pi in c.victims),
                    len(c.victims),
                    -max(pi.pod.creation_ts for pi in c.victims))

        return min(candidates, key=key)

    def prepare_candidate(self, cand: Candidate, pod: Pod) -> None:
        """preemption.go prepareCandidate: delete the victims, and clear the
        nominations of lower-priority pods to the same node."""
        for pi in cand.victims:
            self.handle.clientset.delete_pod(pi.pod)
        nominator = self.handle.nominator
        for pi in list(nominator.nominated_pods_for_node(cand.node_name)):
            if pi.pod.priority < pod.priority:
                nominator.delete_nominated_pod(pi.pod)
                pi.pod.nominated_node_name = ""


class PodGroupEvaluator:
    """Pod-group preemption (podgrouppreemption.go:42 PodGroupEvaluator; the
    JAX package's :264-313): the preemptor is a whole group and the domain
    the whole cluster. Remove every lower-priority pod, check that the group
    schedules, then reprieve the victims most important first while it
    still does (:139 selectVictimsOnDomain)."""

    def __init__(self, handle):
        self.handle = handle

    def preempt(self, group, members, simulate_fn) -> Tuple[List[PodInfo], Status]:
        """(victims, status). `simulate_fn()` tries the whole group against
        the snapshot and leaves it unchanged. The snapshot's NodeInfos are
        mutated while it runs and always restored."""
        snapshot = self.handle.snapshot()
        preemptor_prio = max((m.pod.priority for m in members), default=0)
        potential: List[Tuple[NodeInfo, PodInfo]] = []
        for ni in snapshot.node_info_list:
            for pi in ni.pods:
                if pi.pod.priority < preemptor_prio and pi.pod.deletion_ts is None:
                    potential.append((ni, pi))
        if not potential:
            return [], Status.unresolvable("pod-group preemption: no lower-priority pods")
        removed: List[Tuple[NodeInfo, PodInfo]] = []
        try:
            for ni, pi in potential:
                if ni.remove_pod(pi.pod):
                    removed.append((ni, pi))
            if not simulate_fn():
                return [], Status.unschedulable(
                    "pod-group preemption: the group does not fit even after removing "
                    "all lower-priority pods")
            removed.sort(key=lambda t: more_important_first(t[1]))
            victims: List[PodInfo] = []
            for ni, pi in list(removed):
                ni.add_pod(pi)
                if simulate_fn():
                    removed.remove((ni, pi))  # reprieved: stays restored
                else:
                    ni.remove_pod(pi.pod)
                    victims.append(pi)
            return victims, OK
        finally:
            for ni, pi in removed:  # restore every victim still removed
                ni.add_pod(pi)


class DefaultPreemption:
    """plugins/defaultpreemption — the PostFilter extension point."""

    name = "DefaultPreemption"

    def __init__(self, handle):
        self.handle = handle
        self.evaluator: Optional[Evaluator] = None
        self.attempts = 0             # PostFilter runs that tried to preempt
        self.victims = 0              # pods evicted
        self.verify_divergences = 0   # device candidates the host dry run refuted

    def set_framework(self, fw) -> None:
        self.evaluator = Evaluator(self.handle, fw)

    def post_filter(self, state: CycleState, pod: Pod, filtered_status_map: Dict[str, Status]
                    ) -> Tuple[Optional[PostFilterResult], Status]:
        ev = self.evaluator
        snapshot = self.handle.snapshot()
        ok, msg = ev.pod_eligible(pod, snapshot)
        if not ok:
            return None, Status.unresolvable(f"preemption: {msg}")
        self.attempts += 1
        none_available = "preemption: 0/%d nodes are available" % max(1, snapshot.num_nodes())
        best = ev.select_candidate(ev.find_candidates(state, pod, filtered_status_map))
        if best is not None and ev.last_from_device:
            # The exact host dry run of the chosen node must give the same
            # victims; where it does not, the device dry run is wrong.
            ni = snapshot.get(best.node_name)
            verified = ev.dry_run_on_node(state, pod, ni) if ni is not None else None
            if verified is None or ({pi.pod.uid for pi in verified.victims}
                                    != {pi.pod.uid for pi in best.victims}):
                self.verify_divergences += 1
                raise RuntimeError(
                    f"preemption: the device dry run chose node {best.node_name} for "
                    f"{pod.namespace}/{pod.name} with victims "
                    f"{sorted(pi.pod.name for pi in best.victims)}; the host dry run gives "
                    f"{None if verified is None else sorted(pi.pod.name for pi in verified.victims)}")
            best = Candidate(best.node_name, verified.victims, best.num_pdb_violations)
        if best is None:
            return None, Status.unresolvable(none_available)
        ev.prepare_candidate(best, pod)
        self.victims += len(best.victims)
        return PostFilterResult(nominating_info=best.node_name), OK

    def pod_group_post_filter(self, state: CycleState, group, members, diagnosis
                              ) -> Tuple[Optional[PostFilterResult], Status]:
        """PodGroupPostFilter (the JAX package's :420-454): evict the
        minimal set of lower-priority pods that lets the whole group
        schedule, by the group's own algorithm."""
        if not members:
            return None, Status.unschedulable("pod-group preemption unavailable")
        victims, st = PodGroupEvaluator(self.handle).preempt(
            group, members, lambda: self.handle.simulate_pod_group(group, members))
        if not st.is_success():
            return None, st
        if not victims:
            return None, Status.unschedulable("pod-group preemption found no victim set")
        self.attempts += 1
        self.victims += len(victims)
        for pi in victims:
            self.handle.clientset.delete_pod(pi.pod)
        return PostFilterResult(), OK
