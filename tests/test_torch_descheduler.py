"""The PyTorch port's descheduler (kubernetes_tpu_torch/controllers/) against
the JAX package's DeschedulerController, on the CPU.

Every controller case of the JAX package's descheduler tests runs twice, on
the same cluster built with each package's builders and the same fake clock
(the controller's `now` and the clientset's `lease_now`): once through the
JAX controller (its numpy host walker) and once through the port's with
`device="cpu"` (the whatif_score kernel's plain version). The two must plan
the same `uid@node` intents and keep the same counters: `stats()` and
`metrics_text()` are compared whole, with the eviction ledger and every
pod's placement. The JAX cases' own assertions hold on the port too.

Two eviction contracts: the JAX tests' light one (an eviction clears
`node_name` in place; kept here, for both packages), and the port's
`EvictingClientset`, which deletes the pod and recreates it pending so
that a scheduler places it again — held against the same contract on the
JAX clientset with the JAX TPUScheduler, over a seeded 60-node cluster."""

import copy
import random
from urllib.error import HTTPError

import pytest
import torch

from kubernetes_tpu.api.types import PodGroup as JaxPodGroup
from kubernetes_tpu.controllers import descheduler as JD
from kubernetes_tpu.controllers import evictor as JE
from kubernetes_tpu.core import FakeClientset as JaxFakeClientset
from kubernetes_tpu.core.node_info import NodeInfo as JaxNodeInfo
from kubernetes_tpu.core.node_info import PodInfo as JaxPodInfo
from kubernetes_tpu.models.tpu_scheduler import TPUScheduler
from kubernetes_tpu.testing import make_node as jax_make_node
from kubernetes_tpu.testing import make_pod as jax_make_pod
from kubernetes_tpu_torch import controllers
from kubernetes_tpu_torch.api.types import PodGroup
from kubernetes_tpu_torch.controllers import descheduler as PD
from kubernetes_tpu_torch.controllers import evictor as PE
from kubernetes_tpu_torch.core.clientset import FakeClientset
from kubernetes_tpu_torch.core.node_info import NodeInfo, PodInfo
from kubernetes_tpu_torch.models import TorchScheduler
from kubernetes_tpu_torch.testing import EvictingClientset, make_node, make_pod


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small inputs: one intra-op thread keeps this module from crowding
    the other test workers' CPUs."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# the two clientset contracts, for both packages
# ---------------------------------------------------------------------------


def _light(base):
    """The JAX descheduler tests' eviction contract (tests/test_descheduler.py
    EvictingClientset): ledgered, replay answers already=True, 409 on a node
    mismatch, the eviction clears node_name in place."""

    class Light(base):
        def __init__(self):
            super().__init__()
            self.eviction_ledger = {}
            self.evictions_committed = 0

        def evict_pod(self, uid, node, intent):
            pod = self.pods.get(uid)
            if pod is None:
                raise HTTPError("", 404, "gone", {}, None)
            if self.eviction_ledger.get(uid) == intent:
                return {"evicted": True, "already": True}
            if not pod.node_name:
                return {"evicted": False, "pending": True}
            if pod.node_name != node:
                raise HTTPError("", 409, "NodeMismatch", {}, None)
            self.eviction_ledger[uid] = intent
            pod.node_name = ""
            self.evictions_committed += 1
            return {"evicted": True}

    return Light


JaxLight, PortLight = _light(JaxFakeClientset), _light(FakeClientset)


class JaxEvictingClientset(JaxFakeClientset):
    """The port's EvictingClientset on the JAX clientset (delete, then
    recreate pending; the ledger entry dropped on the next bind)."""

    def __init__(self):
        super().__init__()
        self.eviction_ledger = {}
        self.evictions_committed = 0
        self.evictions_replayed = 0

    def evict_pod(self, uid, node, intent):
        if self.eviction_ledger.get(uid) == intent:
            self.evictions_replayed += 1
            return {"evicted": True, "already": True}
        pod = self.pods.get(uid)
        if pod is None:
            raise HTTPError("", 404, "pod not found", {}, None)
        if not pod.node_name:
            return {"evicted": False, "pending": True}
        if node and pod.node_name != node:
            raise HTTPError("", 409, "NodeMismatch", {}, None)
        bound_to = pod.node_name
        self.delete_pod(pod)
        self.bindings.pop(uid, None)
        fresh = copy.copy(pod)
        fresh.node_name = ""
        fresh.nominated_node_name = ""
        self.create_pod(fresh)
        self.eviction_ledger[uid] = intent
        self.evictions_committed += 1
        return {"evicted": True, "node": bound_to}

    def bind(self, pod, node_name):
        super().bind(pod, node_name)
        self.eviction_ledger.pop(pod.uid, None)


class Kit:
    """One package's side of a case: its builders, controller and
    strategies, a clientset and a fake clock shared by the controller and
    the lease."""

    def __init__(self, pkg, cs=None):
        self.pkg = pkg
        jax = pkg == "jax"
        self.mk_node = jax_make_node if jax else make_node
        self.mk_pod = jax_make_pod if jax else make_pod
        self.D = JD if jax else PD
        self.node_info, self.pod_info = (JaxNodeInfo, JaxPodInfo) if jax else (NodeInfo, PodInfo)
        self.cs = cs if cs is not None else (JaxLight() if jax else PortLight())
        self.clock = {"t": 100.0}
        self.cs.lease_now = lambda: self.clock["t"]

    def ctrl(self, **kw):
        if self.pkg == "port":
            kw.setdefault("device", "cpu")
        return self.D.DeschedulerController(self.cs, now=lambda: self.clock["t"], **kw)

    def node(self, name, cpu="8", taint=None, **cap):
        b = self.mk_node().name(name).capacity({"cpu": cpu, "memory": "16Gi", "pods": 32,
                                                **cap})
        if taint:
            b = b.taint(*taint)
        return b.obj()

    def bound_pod(self, name, node, cpu="1", labels=None, group="", created_bound=False):
        """A pod bound to `node`: created, then bound (the JAX tests' way),
        or created already bound, where a scheduler watches the clientset
        and must not queue it."""
        b = self.mk_pod().name(name).uid(name).req({"cpu": cpu})
        if labels:
            b = b.labels(labels)
        p = b.obj()
        p.pod_group = group
        if created_bound:
            p.node_name = node
            self.cs.create_pod(p)
        else:
            self.cs.create_pod(p)
            self.cs.bind(p, node)
        return p

    def snapshot(self):
        cs = self.cs
        nodes = sorted(cs.nodes.values(), key=lambda n: n.name)
        infos = [self.node_info(n) for n in nodes]
        row = {ni.name: i for i, ni in enumerate(infos)}
        bound = sorted((p for p in cs.pods.values()
                        if p.node_name in row and p.deletion_ts is None),
                       key=lambda p: p.uid)
        gangs = {}
        for p in bound:
            infos[row[p.node_name]].add_pod(self.pod_info.of(p))
            if p.pod_group:
                gangs.setdefault(p.pod_group, []).append(p)
        return self.D.Snapshot(infos, row, bound, gangs)

    def placements(self):
        return {uid: p.node_name for uid, p in self.cs.pods.items()}


def _cluster(kit, n_nodes=4, cpu="8", pods_on_first=6, pod_cpu="1"):
    """n_nodes identical nodes; `pods_on_first` pods piled on node 0."""
    for i in range(n_nodes):
        kit.cs.create_node(kit.node(f"n{i}", cpu=cpu))
    for i in range(pods_on_first):
        kit.bound_pod(f"p{i}", "n0", cpu=pod_cpu)
    return kit


def _pair(build, **kw):
    """(jax kit, port kit), each with `build(kit, **kw)` applied."""
    return tuple(build(Kit(pkg), **kw) for pkg in ("jax", "port"))


def _same(jk, pk, jc, pc):
    """The two controllers planned, counted and evicted the same."""
    assert pc.stats() == jc.stats()
    assert pc.metrics_text() == jc.metrics_text()
    assert pk.cs.eviction_ledger == jk.cs.eviction_ledger
    assert pk.cs.evictions_committed == jk.cs.evictions_committed
    assert pk.placements() == jk.placements()


def _both(kits, make_ctrl, act):
    """Build a controller on each kit, apply `act(kit, ctrl)`, compare;
    return the port's (kit, ctrl)."""
    ctrls = [make_ctrl(k) for k in kits]
    for k, c in zip(kits, ctrls):
        act(k, c)
    _same(kits[0], kits[1], ctrls[0], ctrls[1])
    return kits[1], ctrls[1]


def _ticks(n, tick=0.25):
    def act(kit, ctrl):
        for _ in range(n):
            ctrl.tick_once()
            kit.clock["t"] += tick
    return act


# ---------------------------------------------------------------------------
# hysteresis + strategies
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("must", [False, True])
def test_clears_hysteresis(must):
    for imp in range(-3, 8):
        for floor in (0, 1, 5):
            assert PD.clears_hysteresis(imp, floor, must) == JD.clears_hysteresis(imp, floor, must)
    assert PD.clears_hysteresis(5, 5) and not PD.clears_hysteresis(4, 5)
    assert PD.clears_hysteresis(-3, 5, must_move=True)


def _candidates(kits, strategy):
    got = [[p.uid for p in strategy(k.D).candidates(k.snapshot())] for k in kits]
    assert got[0] == got[1]
    return got[1]


def test_low_node_utilization_nominates_largest_first():
    def build(kit):
        _cluster(kit, n_nodes=3, pods_on_first=0)
        for name, cpu in {"pa": "4", "pb": "1", "pc": "2"}.items():
            kit.bound_pod(name, "n0", cpu=cpu)
        return kit
    got = _candidates(_pair(build), lambda D: D.LowNodeUtilization(margin=0.10, per_node=2))
    assert got == ["pa", "pc"]


def test_duplicate_replicas_keeps_lowest_uid():
    def build(kit):
        _cluster(kit, n_nodes=2, pods_on_first=0)
        for name in ("r2", "r0", "r1"):
            kit.bound_pod(name, "n0", labels={"app": "web"})
        kit.bound_pod("solo", "n1", labels={"app": "web"})
        kit.bound_pod("o1", "n1", labels={PD.OWNER_LABEL: "rs"})
        kit.bound_pod("o0", "n1", labels={PD.OWNER_LABEL: "rs", "app": "x"})
        return kit
    got = _candidates(_pair(build), lambda D: D.DuplicateReplicas())
    assert sorted(got) == ["o1", "r1", "r2"]


def test_taint_violation_detects_untolerated_seat():
    def build(kit):
        _cluster(kit, n_nodes=2, pods_on_first=1)
        kit.cs.update_node(kit.node("n0", taint=("maintenance", "true", "NoExecute")))
        return kit
    kits = _pair(build)
    assert _candidates(kits, lambda D: D.TaintViolation()) == ["p0"]
    assert PD.TaintViolation().must_move and PD.TaintViolation.must_move == JD.TaintViolation.must_move


def test_default_strategies_order_is_violations_first():
    names = [s.name for s in PD.default_strategies()]
    assert names == [s.name for s in JD.default_strategies()] == [
        "taint-violation", "duplicate-replicas", "low-node-utilization"]
    assert PD.BLOCK_REASONS == JD.BLOCK_REASONS and PD.MANAGER_LEASE == JD.MANAGER_LEASE
    assert (PD.ZONE_LABEL, PD.OWNER_LABEL) == (
        "topology.kubernetes.io/zone", "replicaset.kubernetes.io/name")


# ---------------------------------------------------------------------------
# controller
# ---------------------------------------------------------------------------


def test_controller_converges_imbalanced_cluster():
    """6 pods piled on one of 4 nodes: reconcile ticks drain the hot node
    through the eviction funnel."""
    def make(kit):
        return kit.ctrl(strategies=[kit.D.LowNodeUtilization()], hysteresis=1,
                        primary_qps=1000.0, burst=16.0)
    pk, ctrl = _both(_pair(_cluster), make, _ticks(8))
    assert ctrl.active and ctrl.takeovers == 1
    assert pk.cs.evictions_committed > 0
    assert sum(ctrl.moves_total.values()) == pk.cs.evictions_committed
    assert ctrl.util_stddev_milli == 0 and ctrl.whatif_batches > 0
    for uid, intent in pk.cs.eviction_ledger.items():
        assert intent == f"{uid}@n0" and ctrl.planned_intents[uid] == intent


def test_two_managers_plan_identical_intents():
    plans = []
    for _ in range(2):
        def make(kit):
            return kit.ctrl(strategies=[kit.D.LowNodeUtilization()], hysteresis=1)
        _pk, ctrl = _both(_pair(_cluster), make, lambda k, c: c.reconcile_once())
        plans.append(dict(ctrl.planned_intents))
    assert plans[0] == plans[1] and plans[0]


def test_replayed_intent_counts_already_not_double_evict():
    def make(kit):
        return kit.ctrl(strategies=[kit.D.LowNodeUtilization()], hysteresis=1,
                        primary_qps=1000.0, burst=16.0)

    def act(kit, ctrl):
        ctrl.tick_once()
        first = kit.cs.evictions_committed
        assert first > 0
        for uid, intent in list(kit.cs.eviction_ledger.items()):
            got = kit.cs.evict_pod(uid, intent.split("@", 1)[1], intent)
            assert got == {"evicted": True, "already": True}
        assert kit.cs.evictions_committed == first
    _both(_pair(_cluster), make, act)


def test_hysteresis_floor_blocks_churn_moves():
    def make(kit):
        return kit.ctrl(strategies=[kit.D.LowNodeUtilization()], hysteresis=10_000)
    pk, ctrl = _both(_pair(_cluster), make, lambda k, c: c.reconcile_once())
    assert sum(ctrl.moves_total.values()) == 0
    assert ctrl.blocked_total["hysteresis"] > 0
    assert pk.cs.evictions_committed == 0


def test_gang_moves_whole_or_not_at_all():
    """One member with no feasible landing pins the entire PodGroup."""
    def build(kit):
        _cluster(kit, n_nodes=2, pods_on_first=0)
        kit.cs.update_node(kit.node("n1", taint=("dedicated", "infra")))
        for i in range(3):
            kit.bound_pod(f"g{i}", "n0", cpu="2", group="team")
        return kit

    def make(kit):
        return kit.ctrl(strategies=[kit.D.LowNodeUtilization()], hysteresis=1)
    pk, ctrl = _both(_pair(build), make, lambda k, c: c.reconcile_once())
    assert pk.cs.evictions_committed == 0
    assert ctrl.blocked_total["gang"] >= 1 and ctrl.no_target == 3
    assert all(p.node_name == "n0" for p in pk.cs.pods.values())


def test_gang_with_feasible_landings_moves_every_member():
    def build(kit):
        _cluster(kit, n_nodes=3, pods_on_first=0)
        for i in range(2):
            kit.bound_pod(f"g{i}", "n0", cpu="3", group="team")
        return kit

    def make(kit):
        return kit.ctrl(strategies=[kit.D.LowNodeUtilization()], hysteresis=1,
                        primary_qps=1000.0, burst=16.0)
    pk, ctrl = _both(_pair(build), make, _ticks(1))
    assert pk.cs.evictions_committed == 2
    assert ctrl.blocked_total["gang"] == 0
    assert all(not p.node_name for p in pk.cs.pods.values())


def test_gang_cut_by_the_batch_cap_stays_put():
    """The gang-whole rule's second half: a gang whose members did not all
    fit under the batch cap (2 x max_moves_per_tick candidates) moves
    nothing, while the pods that made the cut do."""
    def build(kit):
        _cluster(kit, n_nodes=3, pods_on_first=0)
        kit.bound_pod("a0", "n0", cpu="2")
        for i in range(3):
            kit.bound_pod(f"z{i}", "n0", cpu="2", group="team")
        return kit

    def make(kit):
        return kit.ctrl(strategies=[kit.D.LowNodeUtilization(per_node=8)], hysteresis=1,
                        max_moves_per_tick=1, primary_qps=1000.0, burst=16.0)
    pk, ctrl = _both(_pair(build), make, _ticks(1))
    assert ctrl.blocked_total["gang"] == 1
    assert pk.cs.eviction_ledger == {"a0": "a0@n0"}


def test_emit_cap_can_split_a_gang_as_in_jax():
    """The reference's own behaviour, held as it is: whole gangs are
    planned after the single pods, and the per-tick emit cap
    (`plans[:max_moves_per_tick]`) may then cut a planned gang, so one
    member leaves alone."""
    def build(kit):
        _cluster(kit, n_nodes=3, pods_on_first=0)
        kit.bound_pod("a0", "n0", cpu="2")
        for i in range(3):
            kit.bound_pod(f"z{i}", "n0", cpu="2", group="team")
        return kit

    def make(kit):
        return kit.ctrl(strategies=[kit.D.LowNodeUtilization(per_node=8)], hysteresis=1,
                        max_moves_per_tick=2, primary_qps=1000.0, burst=16.0)
    pk, ctrl = _both(_pair(build), make, _ticks(1))
    assert ctrl.blocked_total["gang"] == 0
    assert pk.cs.eviction_ledger == {"a0": "a0@n0", "z0": "z0@n0"}


def test_standby_idles_until_lease_expires_then_takes_over():
    def act(kit, _ctrl):
        a = kit.ctrl(identity="dm-0", lease_ttl=2.0)
        b = kit.ctrl(identity="dm-1", lease_ttl=2.0)
        a.tick_once()
        b.tick_once()
        assert a.active and not b.active and b.standby_ticks == 1
        kit.clock["t"] += 5.0           # dm-0 dies: its lease expires
        b.tick_once()
        assert b.active and b.takeovers == 1
        kit.result = (a.stats(), b.stats(), kit.cs.list_leases())
    jk, pk = _pair(_cluster, pods_on_first=0)
    for k in (jk, pk):
        act(k, None)
    assert pk.result == jk.result
    (lease,) = pk.result[2]
    assert lease["holder"] == "dm-1" and lease["transitions"] == 2 and not lease["expired"]


def test_lease_cas_matches_the_jax_clientset():
    """upsert_lease/list_leases: renew by the holder, refusal while held,
    takeover after expiry, with the same wire records."""
    out = []
    for cs in (JaxFakeClientset(), FakeClientset()):
        t = {"t": 10.0}
        cs.lease_now = lambda t=t: t["t"]
        seq = [cs.upsert_lease("l", "a", 2.0), cs.upsert_lease("l", "b", 2.0)]
        t["t"] += 1.0
        seq += [cs.upsert_lease("l", "a", 3.0), cs.list_leases()]
        t["t"] += 3.5
        seq += [cs.list_leases(), cs.upsert_lease("l", "b", 1.0), cs.list_leases()]
        out.append(seq)
    assert out[0] == out[1]
    assert out[1][1] is None and out[1][5]["holder"] == "b"


def test_must_move_strategy_waives_hysteresis():
    def build(kit):
        _cluster(kit, n_nodes=2, pods_on_first=1)
        kit.cs.update_node(kit.node("n0", taint=("maintenance", "true", "NoExecute")))
        return kit

    def make(kit):
        return kit.ctrl(hysteresis=10_000, primary_qps=1000.0, burst=16.0)
    pk, ctrl = _both(_pair(build), make, _ticks(1))
    assert pk.cs.evictions_committed == 1
    assert ctrl.moves_total["taint-violation"] == 1


def test_metrics_text_carries_every_series():
    def make(kit):
        return kit.ctrl(strategies=[kit.D.LowNodeUtilization()], hysteresis=1,
                        primary_qps=1000.0, burst=16.0)
    _pk, ctrl = _both(_pair(_cluster), make, _ticks(1))
    text = ctrl.metrics_text()
    for series in ("descheduler_moves_total{strategy=",
                   "descheduler_whatif_batch_duration_seconds_sum",
                   "descheduler_whatif_batch_duration_seconds_count",
                   "descheduler_drift_candidates{strategy=",
                   "descheduler_ticks_total",
                   "descheduler_util_stddev_milli",
                   "descheduler_manager_active 1"):
        assert series in text, series
    for reason in PD.BLOCK_REASONS:
        assert f'descheduler_moves_blocked_total{{reason="{reason}"}}' in text


def test_stats_shape():
    jk, pk = _pair(_cluster, pods_on_first=0)
    jc, pc = jk.ctrl(), pk.ctrl()
    jc.tick_once()
    pc.tick_once()
    assert set(pc.stats()) == set(jc.stats())
    _same(jk, pk, jc, pc)
    for key in ("identity", "active", "ticks", "moves", "blocked",
                "planned_intents", "whatif_batches", "drift",
                "util_stddev_milli", "evictions_total",
                "evictions_replayed", "pending_evictions"):
        assert key in pc.stats(), key


def test_a_failing_tick_counts_an_error():
    """tick_once swallows a reconcile failure into `errors`, as the JAX
    controller does (a fault in the scorer shows there)."""
    for kit in _pair(_cluster):
        ctrl = kit.ctrl(strategies=[kit.D.LowNodeUtilization()], hysteresis=1)
        ctrl.reconcile_once = lambda: 1 // 0
        ctrl.tick_once()
        assert ctrl.errors == 1 and ctrl.active


def test_controllers_package_exports():
    from kubernetes_tpu import controllers as jax_controllers

    for name in ("DeschedulerController", "LowNodeUtilization", "DuplicateReplicas",
                 "TaintViolation", "clears_hysteresis", "RateLimitedEvictor", "TokenBucket"):
        assert hasattr(controllers, name) and hasattr(jax_controllers, name)
    assert set(controllers.__all__) <= set(jax_controllers.__all__)


def test_cuda_is_the_default_device():
    if torch.cuda.is_available():
        assert PD.DeschedulerController(FakeClientset()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            PD.DeschedulerController(FakeClientset())


# ---------------------------------------------------------------------------
# the eviction funnel
# ---------------------------------------------------------------------------


def test_token_bucket_matches_jax():
    out = []
    for E in (JE, PE):
        t = {"t": 0.0}
        b = E.TokenBucket(2.0, burst=3.0, now=lambda t=t: t["t"])
        seq = []
        for step in range(12):
            seq.append(b.try_take())
            t["t"] += 0.2
            if step == 5:
                b.set_rate(0.0)
            if step == 8:
                b.set_rate(10.0)
        out.append((seq, b.qps))
    assert out[0] == out[1] and any(out[1][0]) and not all(out[1][0])


class _Answers:
    """A clientset whose eviction subresource answers from a script."""

    def __init__(self, answers):
        self.answers = answers
        self.calls = []

    def evict_pod(self, uid, node, intent):
        self.calls.append(intent)
        a = self.answers[uid]
        if isinstance(a, int):
            raise HTTPError("", a, "scripted", {}, None)
        if isinstance(a, Exception):
            raise a
        return a


def test_evictor_answer_handling_and_zone_states_match_jax():
    answers = {"ok": {"evicted": True}, "again": {"evicted": True, "already": True},
               "pend": {"evicted": False, "pending": True}, "gone": 404, "moved": 409,
               "pdb": 429, "boom": 500, "wire": ConnectionError("reset"),
               "held": {"evicted": True}}
    zone = {"pend": "z2", "moved": "z2", "held": "z3"}   # the rest in z1
    out = []
    for E in (JE, PE):
        t = {"t": 0.0}
        cs = _Answers(answers)
        ev = E.RateLimitedEvictor(cs, primary_qps=1.0, secondary_qps=0.5, burst=4.0,
                                  now=lambda t=t: t["t"])
        states = [ev.set_zone_state("z1", 0, 10), ev.set_zone_state("z2", 6, 10),
                  ev.set_zone_state("z3", 10, 10), ev.set_zone_state(E.GC_ZONE, 10, 10)]
        for i, uid in enumerate(answers):
            assert ev.enqueue(zone.get(uid, "z1"), f"n{i}", uid)
        assert not ev.enqueue("z1", "n0", "ok")          # deduplicated by uid
        runs = []
        for _ in range(4):
            runs.append(ev.run_once())
            t["t"] += 1.0
        dropped = ev.cancel_node("n2")
        out.append((states, runs, dropped, cs.calls, ev.evictions_total,
                    ev.evictions_throttled_total, ev.evictions_replayed,
                    ev.evictions_cancelled, ev.eviction_errors,
                    ev.evictions_budget_blocked, ev.pending_count(), dict(ev.zone_states)))
    assert out[0] == out[1]
    assert out[1][0] == [PE.ZONE_NORMAL, PE.ZONE_PARTIAL, PE.ZONE_FULL, PE.ZONE_NORMAL]
    assert out[1][4] == 1 and out[1][9] > 0 and out[1][8] > 0 and "held@n8" not in out[1][3]


# ---------------------------------------------------------------------------
# the port's EvictingClientset under TorchScheduler, against the JAX pair
# ---------------------------------------------------------------------------


def test_evicting_clientset_contract():
    cs = EvictingClientset()
    cs.create_node(make_node().name("n0").capacity({"cpu": 4}).obj())
    cs.create_node(make_node().name("n1").capacity({"cpu": 4}).obj())
    seen = []
    cs.on_pod_event(lambda kind, old, new: seen.append((kind, new.node_name)))
    p = make_pod().name("p").uid("p").req({"cpu": "1"}).obj()
    cs.create_pod(p)
    cs.bind(p, "n0")
    with pytest.raises(HTTPError) as e:
        cs.evict_pod("p", "n1", "p@n1")
    assert e.value.code == 409
    with pytest.raises(HTTPError) as e:
        cs.evict_pod("nope", "n0", "nope@n0")
    assert e.value.code == 404
    assert cs.evict_pod("p", "n0", "p@n0") == {"evicted": True, "node": "n0"}
    assert seen[-2:] == [("delete", "n0"), ("add", "")]
    assert cs.pods["p"].node_name == "" and "p" not in cs.bindings
    assert cs.evict_pod("p", "n0", "p@n0") == {"evicted": True, "already": True}
    assert cs.evict_pod("p", "n0", "p@n1") == {"evicted": False, "pending": True}
    cs.bind(cs.pods["p"], "n0")                 # re-placed: the ledger entry goes
    assert cs.eviction_ledger == {}
    assert cs.evict_pod("p", "n0", "p@n0") == {"evicted": True, "node": "n0"}
    assert (cs.evictions_committed, cs.evictions_replayed) == (2, 1)


ZONES = 3


@pytest.fixture(params=[False, True], ids=["hints-off", "hints-on"])
def hints(request):
    """Score hints off (the dispatch path alone) and on (both packages'
    defaults): each parity case runs both ways."""
    return request.param


def _skewed_side(pkg, seed=6, hints=False):
    """A seeded 60-node cluster over 3 zones, scheduled, then skewed: 40
    pods placed by the scheduler, 8 `app: api` replicas bound two by two
    onto 4 nodes, a 3-member gang bound onto one node; then every node
    re-registered with its cpu and memory scaled by 1 +- 0.4 (the hollow
    plane's imbalance formula) and every 10th node tainted NoSchedule."""
    jax = pkg == "jax"
    cs = JaxEvictingClientset() if jax else EvictingClientset()
    if jax:
        sched = TPUScheduler(clientset=cs, mesh=None)
        sched._hints.enabled = hints
    else:
        sched = TorchScheduler(clientset=cs, device="cpu", score_hints=hints)
    kit = Kit(pkg, cs)
    rng = random.Random(seed)
    caps = [(rng.choice([8, 16, 32]), rng.choice([16, 32, 64])) for _ in range(60)]

    def node(i, factor=1.0, taint=False):
        cpu, mem = caps[i]
        b = kit.mk_node().name(f"node-{i:02d}").capacity(
            {"cpu": f"{max(1000, int(cpu * 1000 * factor))}m",
             "memory": max(1 << 20, int(mem * (1 << 30) * factor)), "pods": 110}).zone(
                f"zone-{i % ZONES}")
        if taint:
            b = b.taint("maintenance", "true", "NoSchedule")
        return b.obj()

    for i in range(60):
        cs.create_node(node(i))
    for i in range(40):
        cs.create_pod(kit.mk_pod().name(f"pod-{i:02d}").uid(f"pod-{i:02d}")
                      .req({"cpu": rng.choice(["500m", "1", "2"]), "memory": "1Gi"}).obj())
    sched.run_until_idle()
    for i in range(8):
        kit.bound_pod(f"api-{i}", f"node-{(i // 2) * 7 + 1:02d}", labels={"app": "api"},
                      created_bound=True)
    cs.create_pod_group((JaxPodGroup if jax else PodGroup)(name="team", min_count=3))
    for i in range(3):
        kit.bound_pod(f"gang-{i}", "node-05", cpu="2", group="team", created_bound=True)
    sched.run_until_idle()
    for i in range(60):
        rnd = random.Random(f"20:node-{i:02d}")
        cs.update_node(node(i, 1.0 + 0.4 * (2.0 * rnd.random() - 1.0), taint=i % 10 == 0))
    sched.run_until_idle()
    return kit, sched


def test_skewed_cluster_rebalances_like_jax(hints):
    """Four descheduler ticks (hysteresis 2, margin 0.02, the default
    strategies), each followed by a scheduler round that places the pods
    the tick evicted: the JAX controller over the JAX TPUScheduler and the
    port's over TorchScheduler(device="cpu") plan, evict and re-place the
    same pods, tick by tick."""
    sides = [_skewed_side(pkg, hints=hints) for pkg in ("jax", "port")]
    ctrls = [kit.ctrl(hysteresis=2, strategies=kit.D.default_strategies(margin=0.02),
                      max_moves_per_tick=8) for kit, _s in sides]
    assert sides[1][0].placements() == sides[0][0].placements()
    drifted = set()
    for _tick in range(4):
        for (kit, sched), ctrl in zip(sides, ctrls):
            ctrl.tick_once()
            kit.clock["t"] += 0.5
            sched.run_until_idle()
        _same(sides[0][0], sides[1][0], ctrls[0], ctrls[1])
        drifted |= {s for s, n in ctrls[1].drift.items() if n}
    pk, ctrl = sides[1][0], ctrls[1]
    assert ctrl.errors == 0 and ctrl.whatif_batches == 4
    assert drifted == set(ctrl.drift)       # every strategy nominated at some tick
    assert all(v > 0 for v in ctrl.moves_total.values()), ctrl.moves_total
    assert pk.cs.evictions_committed >= 4
    assert all(p.node_name for p in pk.cs.pods.values())   # every evicted pod re-placed
    assert not any(p.node_name.endswith("0") and int(p.node_name[-2:]) % 10 == 0
                   for p in pk.cs.pods.values() if p.uid.startswith("api"))
