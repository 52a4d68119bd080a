"""Descheduler — the drift-repair controller (the sig-scheduling
descheduler's sibling): the JAX package's controllers/descheduler.py, with
the what-if batch scored by the port's `whatif_score` kernel on the card.

The cluster only gets *scheduled* once; churn (node drift, evictions,
autoscaler waves, rolling updates) then moves the ground truth out from
under the placements. This controller revisits them: a reconcile tick
snapshots bound placements from the clientset, pluggable strategies
nominate drifted pods, and every nominee is rescored against EVERY node as
one dense what-if matrix (ops/whatif.py — the scheduler's own fit/BA
arithmetic, on `device`).

A move is emitted only when:

- its scored improvement clears the hysteresis floor
  (``clears_hysteresis``), and
- its gang moves WHOLE: a PodGroup member never moves alone — either
  every member has a qualifying landing or the group stays put, so the
  gang scheduler restarts the group at the new placement instead of
  tearing a partial hole in it.

Emission rides the eviction funnel (controllers/evictor.py): deterministic
``uid@node`` intents through ``RateLimitedEvictor`` per-zone buckets into
the clientset's eviction subresource. Exactly-once across failover falls
out of determinism — a standby re-plans the same snapshot, mints the same
intents, and the server's intent ledger answers the duplicates with
``already=True``.

HA: every tick races a PUT-CAS lease (`upsert_lease`); the loser idles
STANDBY.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import torch

from ..api.types import find_matching_untolerated_taint
from ..core.node_info import NodeInfo, PodInfo
from ..ops import whatif
from ..ops.staging import StagingRing
from .evictor import RateLimitedEvictor, intent_for

# The JAX package's node_lifecycle.ZONE_LABEL and workload.OWNER_LABEL.
ZONE_LABEL = "topology.kubernetes.io/zone"
OWNER_LABEL = "replicaset.kubernetes.io/name"

MANAGER_LEASE = "descheduler"

BLOCK_REASONS = ("pdb", "budget", "gang", "hysteresis")


def clears_hysteresis(improvement: int, floor: int,
                      must_move: bool = False) -> bool:
    """The scored-improvement gate. Every eviction the descheduler emits
    sits downstream of this predicate:
    a move below the floor is churn, not repair — and a floor of N
    points breaks the evict/re-bind/evict ping-pong cycle two nearly
    balanced nodes would otherwise trade forever. ``must_move``
    (violation strategies: the CURRENT seat is illegal) waives the
    floor but still requires a feasible landing upstream."""
    return must_move or improvement >= floor


class Snapshot(NamedTuple):
    node_infos: List[NodeInfo]          # sorted by node name
    row: Dict[str, int]                 # node name -> row index
    bound: List[object]                 # bound pods, sorted by uid
    gangs: Dict[str, List[object]]      # pod_group -> bound members


class Strategy:
    """One drift detector. ``candidates`` returns bound pods worth
    rescoring — detection only; the what-if matrix decides."""

    name = "strategy"
    must_move = False

    def candidates(self, snap: Snapshot) -> List[object]:
        raise NotImplementedError


class LowNodeUtilization(Strategy):
    """Spread repair: nodes whose cpu-request utilization sits more than
    ``margin`` above the cluster mean nominate their largest pods
    (largest first converges the stddev fastest; ties break by uid so
    two managers nominate identically)."""

    name = "low-node-utilization"

    def __init__(self, margin: float = 0.10, per_node: int = 4):
        self.margin = float(margin)
        self.per_node = int(per_node)

    def candidates(self, snap: Snapshot) -> List[object]:
        utils = []
        for ni in snap.node_infos:
            cap = ni.allocatable.milli_cpu
            utils.append(ni.requested.milli_cpu / cap if cap > 0 else 0.0)
        if not utils:
            return []
        mean = sum(utils) / len(utils)
        out: List[object] = []
        for ni, u in zip(snap.node_infos, utils):
            if u <= mean + self.margin:
                continue
            pods = sorted((pi.pod for pi in ni.pods),
                          key=lambda p: (-p.resource_request().milli_cpu,
                                         p.uid))
            out.extend(pods[:self.per_node])
        return out


class DuplicateReplicas(Strategy):
    """A workload's replicas co-located on one node defeat the point of
    replication (reference RemoveDuplicates): for each (node, owner)
    group keep the lowest-uid member, nominate the rest."""

    name = "duplicate-replicas"

    def candidates(self, snap: Snapshot) -> List[object]:
        groups: Dict[tuple, List[object]] = {}
        for pod in snap.bound:
            owner = (pod.labels or {}).get(OWNER_LABEL) \
                or (pod.labels or {}).get("app")
            if owner:
                groups.setdefault((pod.node_name, owner), []).append(pod)
        out: List[object] = []
        for members in groups.values():
            if len(members) > 1:
                out.extend(sorted(members, key=lambda p: p.uid)[1:])
        return out


class TaintViolation(Strategy):
    """Churn moved the ground truth: the node a pod is bound to now
    carries a NoSchedule/NoExecute taint the pod does not tolerate.
    The seat is illegal, so the hysteresis floor is waived — any
    feasible landing beats staying."""

    name = "taint-violation"
    must_move = True

    def candidates(self, snap: Snapshot) -> List[object]:
        out: List[object] = []
        for ni in snap.node_infos:
            if ni.node is None or not ni.node.taints:
                continue
            for pi in ni.pods:
                if find_matching_untolerated_taint(
                        ni.node.taints, pi.pod.tolerations) is not None:
                    out.append(pi.pod)
        return out


def default_strategies(margin: float = 0.10) -> List[Strategy]:
    return [TaintViolation(), DuplicateReplicas(),
            LowNodeUtilization(margin=margin)]


class _Plan(NamedTuple):
    pod: object
    strategy: str
    improvement: int


class DeschedulerController:
    """The descheduler process body: HA lease tick → snapshot → detect →
    one what-if batch → gang-whole hysteresis-gated planning → the
    eviction funnel. Single reconcile thread; tests drive ``tick_once``
    directly. `device` is "cuda" unless the caller asks for "cpu", where
    the kernel's plain version scores the batch; it never falls back.
    Besides the JAX controller's counters it splits the what-if batches'
    wall seconds (`time.perf_counter`, not the injectable clock) into
    `whatif_encode_s`, `whatif_score_s` (launch and fetch) and
    `whatif_moves_s`."""

    def __init__(self, clientset, identity: str = "descheduler-0",
                 lease_ttl: float = 2.0, tick: float = 0.25,
                 hysteresis: int = 5,
                 strategies: Optional[Sequence[Strategy]] = None,
                 primary_qps: float = 20.0, secondary_qps: float = 0.1,
                 unhealthy_threshold: float = 0.55, burst: float = 8.0,
                 max_moves_per_tick: int = 64, device="cuda",
                 now: Callable[[], float] = time.monotonic):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("DeschedulerController: CUDA is not available "
                               "(pass device='cpu' to run the plain version)")
        self.cs = clientset
        self.identity = identity
        self.lease_ttl = float(lease_ttl)
        self.tick = float(tick)
        self.hysteresis = int(hysteresis)
        self.strategies = list(strategies if strategies is not None
                               else default_strategies())
        self.max_moves_per_tick = int(max_moves_per_tick)
        self.device = device
        self._ring = StagingRing(device)   # the what-if batches' uploads
        self._now = now
        self.evictor = RateLimitedEvictor(
            clientset, primary_qps=primary_qps, secondary_qps=secondary_qps,
            unhealthy_threshold=unhealthy_threshold, burst=burst, now=now)
        self.active = False
        self.ticks = 0
        self.active_ticks = 0
        self.standby_ticks = 0
        self.takeovers = 0
        self.lease_errors = 0
        self.moves_total: Dict[str, int] = {
            s.name: 0 for s in self.strategies}
        self.blocked_total: Dict[str, int] = {r: 0 for r in BLOCK_REASONS}
        self.no_target = 0          # nominee with no feasible other row
        self.whatif_batches = 0
        self.whatif_seconds = 0.0
        self.whatif_encode_s = 0.0
        self.whatif_score_s = 0.0
        self.whatif_moves_s = 0.0
        self.drift: Dict[str, int] = {s.name: 0 for s in self.strategies}
        # uid -> deterministic uid@node intent, as planned. Two managers
        # over one snapshot build identical maps — the chaos suite's
        # takeover assertion reads this seam.
        self.planned_intents: Dict[str, str] = {}
        self.util_stddev_milli = 0  # last measured cpu-util stddev x1000
        self.errors = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- the HA tick ---------------------------------------------------------

    def tick_once(self) -> None:
        self.ticks += 1
        try:
            got = self.cs.upsert_lease(MANAGER_LEASE, self.identity,
                                       self.lease_ttl)
        except Exception:  # noqa: BLE001 - leader churn mid-failover
            self.lease_errors += 1
            got = None
        if got is None:
            self.active = False
            self.standby_ticks += 1
            return
        if not self.active:
            self.takeovers += 1
            self.active = True
        self.active_ticks += 1
        try:
            self.reconcile_once()
        except Exception:  # noqa: BLE001 - transient read-plane races
            self.errors += 1

    # -- snapshot ------------------------------------------------------------

    def _snapshot(self) -> Snapshot:
        nodes = sorted(self.cs.nodes.values(), key=lambda n: n.name)
        infos = [NodeInfo(n) for n in nodes]
        row = {ni.name: i for i, ni in enumerate(infos)}
        bound = sorted(
            (p for p in self.cs.pods.values()
             if p.node_name in row and p.deletion_ts is None),
            key=lambda p: p.uid)
        gangs: Dict[str, List[object]] = {}
        for p in bound:
            infos[row[p.node_name]].add_pod(PodInfo.of(p))
            if p.pod_group:
                gangs.setdefault(p.pod_group, []).append(p)
        return Snapshot(infos, row, bound, gangs)

    @staticmethod
    def _util_stddev_milli(snap: Snapshot) -> int:
        utils = [ni.requested.milli_cpu / ni.allocatable.milli_cpu
                 for ni in snap.node_infos if ni.allocatable.milli_cpu > 0]
        if not utils:
            return 0
        mean = sum(utils) / len(utils)
        var = sum((u - mean) ** 2 for u in utils) / len(utils)
        return int(var ** 0.5 * 1000)

    # -- one reconcile pass --------------------------------------------------

    def reconcile_once(self) -> int:
        """Detect → score → plan → emit. Returns moves enqueued."""
        snap = self._snapshot()
        self.util_stddev_milli = self._util_stddev_milli(snap)
        nominated: Dict[str, str] = {}   # uid -> strategy (first wins)
        by_uid: Dict[str, object] = {}
        must: Dict[str, bool] = {}
        for strat in self.strategies:
            found = strat.candidates(snap)
            self.drift[strat.name] = len(found)
            for pod in found:
                if pod.uid not in nominated:
                    nominated[pod.uid] = strat.name
                    by_uid[pod.uid] = pod
                    must[pod.uid] = strat.must_move
        # gang-whole expansion: a nominated member drags every bound
        # member of its PodGroup into the batch under the same strategy.
        for uid in list(nominated):
            pod = by_uid[uid]
            if pod.pod_group:
                for member in snap.gangs.get(pod.pod_group, ()):
                    if member.uid not in nominated:
                        nominated[member.uid] = nominated[uid]
                        by_uid[member.uid] = member
                        must[member.uid] = must[uid]
        if not nominated:
            return 0
        candidates = sorted(by_uid.values(), key=lambda p: p.uid)
        # batch cap: 2x the per-tick move budget leaves headroom for
        # hysteresis/gang rejections without unbounded matrix growth
        candidates = candidates[:self.max_moves_per_tick * 2]
        kept = {p.uid for p in candidates}
        t0 = self._now()
        w0 = time.perf_counter()
        batch = whatif.encode_batch(snap.node_infos, candidates)
        w1 = time.perf_counter()
        fit_ok, score = whatif.whatif_scores(batch, device=self.device, ring=self._ring)
        w2 = time.perf_counter()
        moves = whatif.best_moves(batch, fit_ok, score)
        w3 = time.perf_counter()
        self.whatif_batches += 1
        self.whatif_seconds += max(0.0, self._now() - t0)
        self.whatif_encode_s += w1 - w0
        self.whatif_score_s += w2 - w1
        self.whatif_moves_s += w3 - w2
        plans: List[_Plan] = []
        gang_plans: Dict[str, List[Optional[_Plan]]] = {}
        for pod, move in zip(candidates, moves):
            strat = nominated[pod.uid]
            plan = None
            if move is None:
                self.no_target += 1
            elif clears_hysteresis(move.improvement, self.hysteresis,
                                   must[pod.uid]):
                plan = _Plan(pod, strat, move.improvement)
            else:
                self.blocked_total["hysteresis"] += 1
            if pod.pod_group:
                gang_plans.setdefault(pod.pod_group, []).append(plan)
            elif plan is not None:
                plans.append(plan)
        # gang-whole: every bound member must hold a qualifying landing,
        # and the whole gang must be in this batch — else nothing moves.
        for gang, gplans in gang_plans.items():
            members = snap.gangs.get(gang, ())
            whole = (len(gplans) == len(members)
                     and all(m.uid in kept for m in members)
                     and all(p is not None for p in gplans))
            if whole:
                plans.extend(gplans)
            else:
                self.blocked_total["gang"] += 1
        emitted = 0
        for plan in plans[:self.max_moves_per_tick]:
            if self._emit(plan, snap):
                emitted += 1
        self.evictor.run_once()
        # server-side gates observed through the funnel's own counters
        self.blocked_total["pdb"] = self.evictor.evictions_budget_blocked
        self.blocked_total["budget"] = self.evictor.evictions_throttled_total
        return emitted

    def _emit(self, plan: _Plan, snap: Snapshot) -> bool:
        """One approved move into the funnel. The intent the server will
        ledger is minted here — deterministic ``uid@node`` — purely for
        the plan's observability seam; `RateLimitedEvictor._evict_one`
        mints the identical id when the token grants."""
        pod = plan.pod
        node = pod.node_name
        self.planned_intents[pod.uid] = intent_for(pod.uid, node)
        ni = snap.node_infos[snap.row[node]]
        zone = (ni.node.labels or {}).get(ZONE_LABEL, "") if ni.node else ""
        if self.evictor.enqueue(zone, node, pod.uid):
            self.moves_total[plan.strategy] = (
                self.moves_total.get(plan.strategy, 0) + 1)
            return True
        return False

    # -- standing loop -------------------------------------------------------

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="descheduler", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            self.tick_once()
            if self._stop.wait(self.tick):
                return

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    # -- observability -------------------------------------------------------

    def stats(self) -> dict:
        ev = self.evictor
        return {"identity": self.identity, "active": self.active,
                "ticks": self.ticks, "active_ticks": self.active_ticks,
                "standby_ticks": self.standby_ticks,
                "takeovers": self.takeovers,
                "lease_errors": self.lease_errors,
                "moves": dict(self.moves_total),
                "blocked": dict(self.blocked_total),
                "no_target": self.no_target,
                "planned_intents": dict(self.planned_intents),
                "whatif_batches": self.whatif_batches,
                "whatif_seconds": round(self.whatif_seconds, 6),
                "drift": dict(self.drift),
                "util_stddev_milli": self.util_stddev_milli,
                "errors": self.errors,
                "evictions_total": ev.evictions_total,
                "evictions_replayed": ev.evictions_replayed,
                "evictions_cancelled": ev.evictions_cancelled,
                "eviction_errors": ev.eviction_errors,
                "pending_evictions": ev.pending_count()}

    def metrics_text(self) -> str:
        out = ["# TYPE descheduler_moves_total counter"]
        for strat, v in sorted(self.moves_total.items()):
            out.append(f'descheduler_moves_total{{strategy="{strat}"}} {v}')
        out.append("# TYPE descheduler_moves_blocked_total counter")
        for reason in BLOCK_REASONS:
            out.append(f'descheduler_moves_blocked_total'
                       f'{{reason="{reason}"}} '
                       f'{self.blocked_total.get(reason, 0)}')
        out.append(
            "# TYPE descheduler_whatif_batch_duration_seconds summary")
        out.append(f"descheduler_whatif_batch_duration_seconds_sum "
                   f"{self.whatif_seconds:.6f}")
        out.append(f"descheduler_whatif_batch_duration_seconds_count "
                   f"{self.whatif_batches}")
        out.append("# TYPE descheduler_drift_candidates gauge")
        for strat, v in sorted(self.drift.items()):
            out.append(
                f'descheduler_drift_candidates{{strategy="{strat}"}} {v}')
        for name, v in (
                ("descheduler_ticks_total", self.ticks),
                ("descheduler_takeovers_total", self.takeovers),
                ("descheduler_lease_errors_total", self.lease_errors),
                ("descheduler_evictions_total",
                 self.evictor.evictions_total),
                ("descheduler_evictions_replayed_total",
                 self.evictor.evictions_replayed)):
            out.append(f"# TYPE {name} counter")
            out.append(f"{name} {v}")
        out.append("# TYPE descheduler_util_stddev_milli gauge")
        out.append(f"descheduler_util_stddev_milli {self.util_stddev_milli}")
        out.append("# TYPE descheduler_manager_active gauge")
        out.append(f"descheduler_manager_active {int(self.active)}")
        return "\n".join(out) + "\n"
