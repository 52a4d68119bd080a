"""The port's score-hint walker (kubernetes_tpu_torch/models/score_hints.py)
held against the JAX package's (kubernetes_tpu/models/score_hints.py).

Each case drives the same cluster through three schedulers: the JAX
TPUScheduler with hints on (its default), TorchScheduler(device="cpu") with
hints on (the port's default on the CPU) and TorchScheduler with
score_hints=False (the always-dispatch baseline). The bindings of all three are equal, and the
port's hint_hits, hint_misses and hint_invalidations, its attempts, failures,
host-path pods, device batches and queue counts equal the JAX scheduler's:
the counterparts of tests/test_hint_cache.py's cases that the port's paths
reach. (The bind-conflict cases wait for a conflict path in the port's
scheduler.)
"""

import random

import numpy as np
import pytest
import torch

from kubernetes_tpu.api.types import Namespace as JaxNamespace
from kubernetes_tpu.core.framework import OK as JAX_OK
from kubernetes_tpu.core.framework import WAIT as JAX_WAIT
from kubernetes_tpu.core.framework import Status as JaxStatus
from kubernetes_tpu.core.registry import build_framework
from kubernetes_tpu.models.tpu_scheduler import TPUScheduler
from kubernetes_tpu.parallel import make_mesh as jax_make_mesh
from kubernetes_tpu.testing.wrappers import make_node as jax_make_node
from kubernetes_tpu.testing.wrappers import make_pod as jax_make_pod
from kubernetes_tpu_torch.api.types import Namespace
from kubernetes_tpu_torch.core.framework import OK, WAIT, Status
from kubernetes_tpu_torch.core.registry import default_profile
from kubernetes_tpu_torch.models import TorchScheduler
from kubernetes_tpu_torch.models import score_hints as port_hints
from kubernetes_tpu_torch.parallel.mesh import make_mesh
from kubernetes_tpu_torch.testing import make_node, make_pod

COUNTERS = ("hint_hits", "hint_misses", "hint_invalidations", "attempts", "scheduled",
            "failures", "host_path_pods", "device_batches", "device_scheduled")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class Side:
    """One scheduler with its package's builders and namespace type."""

    def __init__(self, kind, max_batch=64, jax_kw=None, port_kw=None):
        self.kind = kind
        if kind == "jax":
            self.s = TPUScheduler(max_batch=max_batch, **({"mesh": None} | (jax_kw or {})))
            self.mk_node, self.mk_pod, self.ns = jax_make_node, jax_make_pod, JaxNamespace
        else:
            kw = dict(port_kw or {})
            if kind == "ref":
                kw["score_hints"] = False
            self.s = TorchScheduler(device="cpu", max_batch=max_batch, **kw)
            self.mk_node, self.mk_pod, self.ns = make_node, make_pod, Namespace
        self.cs = self.s.clientset

    def node(self, name, cpu=8, taint=None, pods=110):
        b = (self.mk_node().name(name).capacity({"cpu": cpu, "memory": "32Gi", "pods": pods})
             .zone(f"zone-{len(name) % 3}"))
        if taint:
            b = b.taint(*taint)
        return b.obj()

    def pod(self, name, ns="default", cpu="200m", labels=None, anti=None):
        b = self.mk_pod().name(name).namespace(ns).req({"cpu": cpu, "memory": "128Mi"})
        if labels:
            b = b.labels(dict(labels))
        if anti:
            b = b.pod_affinity("kubernetes.io/hostname", anti, anti=True)
        return b.obj()

    def pods(self, prefix, n, **kw):
        for i in range(n):
            self.cs.create_pod(self.pod(f"{prefix}-{i}", **kw))

    def invalidations(self, reason):
        if self.kind == "jax":
            return self.s.metrics.hint_cache_invalidations.value(reason)
        return self.s._hints.counts["invalidation", reason]

    def misses(self, reason):
        if self.kind == "jax":
            return self.s.metrics.hint_cache_misses.value(reason)
        return self.s._hints.counts["miss", reason]

    def hits(self, kind):
        if self.kind == "jax":
            return self.s.metrics.hint_cache_hits.value(kind)
        return self.s._hints.counts["hit", kind]


class Trio:
    """The JAX scheduler, the port and the port's hints-off baseline over
    identical clusters of `n_nodes` nodes."""

    def __init__(self, n_nodes=24, max_batch=64, jax_kw=None, port_kw=None, nodes=True):
        self.sides = [Side(k, max_batch, jax_kw, port_kw) for k in ("jax", "port", "ref")]
        self.jax, self.port, self.ref = self.sides
        if nodes:
            self.each(lambda x: [x.cs.create_node(x.node(f"node-{i}")) for i in range(n_nodes)])

    def each(self, fn):
        for x in self.sides:
            fn(x)

    def both(self, fn):
        """Apply `fn` to every side, then run each to idle."""
        for x in self.sides:
            fn(x)
            x.s.run_until_idle()

    def check(self):
        """Equal bindings on all three; the port's counters equal JAX's."""
        want = {f"{p.namespace}/{p.name}": p.node_name for p in self.jax.cs.pods.values()}
        for x in (self.port, self.ref):
            got = {f"{p.namespace}/{p.name}": p.node_name for p in x.cs.pods.values()}
            diffs = {k: (want[k], got.get(k)) for k in want if want[k] != got.get(k)}
            assert not diffs and set(got) == set(want), f"{x.kind} diverged: {diffs}"
        j, p = self.jax.s, self.port.s
        assert {c: getattr(p, c) for c in COUNTERS} == {c: getattr(j, c) for c in COUNTERS}
        assert p.queue.pending_counts() == j.queue.pending_counts()
        assert self.ref.s.hint_hits == 0


# -- the fast path ----------------------------------------------------------------


def test_identical_replicas_bind_without_dispatch():
    """After one seeding session every identical replica binds through the
    walker: hits move, dispatches do not."""
    t = Trio()
    t.both(lambda x: x.pods("seed", 8))
    assert t.port.s._hints.entry is not None
    b0 = t.port.s.device_batches
    t.both(lambda x: x.pods("rep", 40))
    t.check()
    assert t.port.s.hint_hits >= 40 and t.port.s.device_batches == b0
    assert t.port.hits("exact") == t.jax.hits("exact") >= 40
    assert t.ref.s.device_batches > b0


def test_neutral_signature_serves_across_namespaces():
    """Replicas that differ only in namespace and labels ride one hint (the
    namespace-erased signature)."""
    t = Trio()
    t.both(lambda x: x.pods("seed", 6, ns="ns-a"))
    b0 = t.port.s.device_batches
    t.both(lambda x: [x.cs.create_pod(x.pod(f"rep-{i}", ns=f"ns-{i % 5}",
                                            labels={"app": f"dep-{i % 5}"}))
                      for i in range(30)])
    t.check()
    assert t.port.s.device_batches == b0
    assert t.port.hits("neutral") == t.jax.hits("neutral") > 0


def test_infeasible_replica_falls_through_to_the_exact_diagnosis():
    """Capacity runs out mid-run: the walk finds no node, the pod falls
    through to the batch path for its diagnosis, and the rest park
    identically."""
    t = Trio(n_nodes=3)
    t.both(lambda x: x.pods("seed", 4, cpu="2000m"))
    t.both(lambda x: x.pods("rep", 12, cpu="2000m"))
    t.check()
    assert t.port.s.hint_hits > 0
    assert t.port.misses("infeasible") == t.jax.misses("infeasible") > 0
    assert len(t.port.s.queue.unschedulable) == len(t.jax.s.queue.unschedulable) > 0


# -- freshness: the event-kind matrix -------------------------------------------


def test_node_update_revalidates_one_row():
    """A NoSchedule taint toggled on a node is a node_update: the walker
    re-validates that row and keeps serving."""
    t = Trio()
    t.both(lambda x: x.pods("seed", 8))
    for rnd in range(3):
        def taint(x, rnd=rnd):
            x.cs.update_node(x.node(f"node-{rnd}", taint=("maint", "", "NoSchedule")))
            x.pods(f"r{rnd}", 10)

        def lift(x, rnd=rnd):
            x.cs.update_node(x.node(f"node-{rnd}"))
            x.pods(f"l{rnd}", 4)
        t.both(taint)
        t.both(lift)
    t.check()
    assert t.port.s._hints.entry is not None and t.port.s.hint_hits >= 40


def test_bound_pod_delete_reencodes_its_row():
    t = Trio()
    t.both(lambda x: x.pods("seed", 10, cpu="1500m"))
    for rnd in range(3):
        def step(x, rnd=rnd):
            bound = sorted((p for p in x.cs.pods.values() if p.node_name), key=lambda p: p.name)
            x.cs.delete_pod(bound[rnd])
            x.pods(f"r{rnd}", 6, cpu="1500m")
        t.both(step)
    t.check()
    assert t.port.s.hint_hits > 0 and t.port.s._hints.entry is not None


def _pns_taint(x):
    x.cs.update_node(x.node("node-1", taint=("soft", "", "PreferNoSchedule")))
    x.pods("r", 10)


def _new_node(x):
    x.cs.create_node(x.node("node-new"))
    x.pods("r", 10)


def _affinity_pod(x):
    x.cs.create_pod(x.pod("anti-0", labels={"app": "web"}, anti={"app": "web"}))
    x.pods("r", 10, labels={"app": "web"})


def _journal_gap(x):
    for _ in range(x.s.journal.cap + 8):
        x.s._record_event("queue", "x")
    x.pods("r", 8)


def _foreign_attempt(x):
    # A host-port pod's session is not eligible to install (a port-aware
    # plan), so its attempt is foreign to the live entry.
    x.cs.create_pod(x.mk_pod().name("ported").req({"cpu": "200m"}).host_port(8080).obj())


@pytest.mark.parametrize("step,reason", [
    (_pns_taint, "pns_taint"), (_new_node, "structural"),
    (_affinity_pod, "affinity_transition"), (_journal_gap, "journal_gap"),
    (_foreign_attempt, "foreign_attempt")],
    ids=["prefer-no-schedule-taint", "structural", "affinity-transition", "journal-gap",
         "foreign-attempt"])
def test_event_kills_the_hint(step, reason):
    """A PreferNoSchedule taint (the plan has no such lane), a node added, the
    0→1 affinity-pod transition, a journal gap and a pod the walker did not
    place each end the hint, for the same reason as in the JAX package; the
    batch path takes over with the same bindings."""
    t = Trio()
    t.both(lambda x: x.pods("seed", 6, labels={"app": "web"}))
    assert t.port.s._hints.entry is not None
    t.both(step)
    t.both(lambda x: x.pods("after", 8, labels={"app": "web"}))
    t.check()
    assert t.port.invalidations(reason) == t.jax.invalidations(reason) >= 1
    if reason == "affinity_transition":
        # No session installs while an affinity-term pod lives.
        assert t.port.s._hints.entry is None and t.port.s.cache.affinity_pod_refs > 0


# -- Permit WAIT and the switch ----------------------------------------------------


class _ParkNamed:
    """A Permit plugin that holds the pod named `waitme`."""

    name = "ParkNamed"

    def __init__(self, wait, status, ok):
        self.wait, self.status, self.ok = wait, status, ok

    def permit(self, state, pod, node_name):
        if pod.name == "waitme":
            return self.status(self.wait, ("parked",), self.name)
        return self.ok


def test_permit_wait_park_is_not_a_hit():
    """The walker applies a parked pod's placement (it holds the node) but
    counts no hit: hits count binds. Allowing the pod binds it there."""
    def jax_profiles(h):
        fw = build_framework(h)
        fw.permit_plugins.append(_ParkNamed(JAX_WAIT, JaxStatus, JAX_OK))
        return {"default-scheduler": fw}

    def port_profile(h):
        fw = default_profile(h)
        fw.permit_plugins.append(_ParkNamed(WAIT, Status, OK))
        return fw
    t = Trio(n_nodes=8, jax_kw={"profile_factory": jax_profiles},
             port_kw={"profile_factory": port_profile})
    t.both(lambda x: x.pods("seed", 6))
    assert t.port.s._hints.entry is not None
    hits = t.port.s.hint_hits
    t.both(lambda x: x.cs.create_pod(x.pod("waitme")))
    assert len(t.port.s.waiting_pods) == len(t.jax.s.waiting_pods) == 1
    assert t.port.s.hint_hits == hits
    t.check()
    for x in t.sides:
        assert x.s.allow_waiting_pod(next(iter(x.s.waiting_pods)))
    t.check()
    assert all(p.node_name for p in t.port.cs.pods.values())


def test_disabling_hints_stops_a_warm_entry():
    """Hints switched off after a wave installed an entry: the next wave
    dispatches, on both packages."""
    t = Trio()
    t.both(lambda x: x.pods("seed", 6))
    assert t.port.s._hints.entry is not None
    for x in (t.jax, t.port):
        x.s._hints.enabled = False
    b0 = t.port.s.device_batches
    t.both(lambda x: x.pods("rep", 8))
    t.check()
    assert t.port.s.hint_hits == 0 and t.port.s._hints.entry is None
    assert t.port.s.device_batches > b0


# -- the LRU --------------------------------------------------------------------


def test_two_shapes_alternate_without_thrash():
    """Two replica shapes interleaving through one queue bind with no
    dispatch after seeding; both entries place onto the same nodes, so a
    stale sibling row would diverge."""
    t = Trio()
    t.both(lambda x: x.pods("seed-a", 6, cpu="200m"))
    t.both(lambda x: x.pods("seed-b", 6, cpu="400m"))
    assert len(t.port.s._hints.entries) == 2
    b0, h0 = t.port.s.device_batches, t.port.s.hint_hits
    t.both(lambda x: [x.cs.create_pod(x.pod(f"alt-{i}", cpu="200m" if i % 2 == 0 else "400m"))
                      for i in range(40)])
    t.check()
    assert t.port.s.device_batches == b0 and t.port.s.hint_hits - h0 >= 40


def test_lru_capacity_one_is_the_single_slot_cache(monkeypatch):
    """Capacity 1: the second shape's install evicts the first."""
    monkeypatch.setenv("TPU_SCHED_HINT_LRU", "1")
    monkeypatch.setattr(port_hints, "HINT_LRU", 1)
    t = Trio()
    assert t.jax.s._hints.capacity == 1
    t.both(lambda x: x.pods("seed-a", 6, cpu="200m"))
    t.both(lambda x: x.pods("seed-b", 6, cpu="400m"))
    assert len(t.port.s._hints.entries) == 1
    assert t.port.invalidations("lru_evict") == t.jax.invalidations("lru_evict") >= 1
    t.both(lambda x: [x.cs.create_pod(x.pod(f"alt-{i}", cpu="200m" if i % 2 == 0 else "400m"))
                      for i in range(20)])
    t.check()


def test_third_shape_evicts_the_coldest():
    t = Trio()
    for shape, cpu in (("a", "200m"), ("b", "400m"), ("c", "600m")):
        t.both(lambda x, shape=shape, cpu=cpu: x.pods(f"seed-{shape}", 6, cpu=cpu))
    assert len(t.port.s._hints.entries) == 2
    assert t.port.invalidations("lru_evict") == t.jax.invalidations("lru_evict") >= 1
    b0 = t.port.s.device_batches
    t.both(lambda x: x.pods("rep-c", 10, cpu="600m"))
    t.check()
    assert t.port.s.device_batches == b0


# -- the lap-batched walk and the mesh --------------------------------------------


@pytest.mark.parametrize("lap", [True, False], ids=["lap-walk", "per-pod-walk"])
def test_lap_batched_walk_against_the_per_pod_walk(lap, monkeypatch):
    """With the sampling cut live (to_find 20 of 200 nodes) the walk takes a
    lap of placements a cumsum; pinned to the per-pod walk it takes none.
    Both equal the JAX walk of the same switch and the dispatch baseline."""
    monkeypatch.setenv("TPU_SCHED_HINT_LAP", "1" if lap else "0")
    t = Trio(n_nodes=200, max_batch=32)
    t.port.s._hints.lap = lap
    for x in t.sides:
        x.s.percentage_of_nodes_to_score = 10
    t.both(lambda x: x.pods("a", 8, cpu="100m"))
    entry = t.port.s._hints.entry
    assert entry is not None and entry.lap_enabled == lap
    t.both(lambda x: x.pods("b", 60, cpu="100m"))
    t.check()
    e, je = t.port.s._hints.entry, t.jax.s._hints.entry
    assert e.lap_walks == je.lap_walks
    if lap:
        assert 1 <= e.lap_walks and e.lap_walks * 2 <= t.port.s.hint_hits
    else:
        assert e.lap_walks == 0


def test_mesh_session_installs_from_the_sharded_carry():
    """Under a node mesh of 8 CPU shards the session's carry is sharded; the
    install gathers it, and the replicas bind from it with no dispatch."""
    t = Trio(jax_kw={"mesh": jax_make_mesh(n_cells=1)},
             port_kw={"mesh": make_mesh(devices=["cpu"] * 8)})
    assert t.port.s.mesh is not None and t.jax.s.mesh is not None
    t.both(lambda x: x.pods("a", 8))
    assert t.port.s._hints.entry is not None
    b0 = t.port.s.device_batches
    t.both(lambda x: x.pods("b", 12))
    t.check()
    assert t.port.s.hint_hits >= 12 and t.port.s.device_batches == b0


# -- the churn fuzz (tests/test_hint_cache.py:583-645, the same seeds) -----------


@pytest.mark.parametrize("seed", [3, 11, 42])
def test_churn_fuzz(seed):
    """Random journal event streams interleaved with walker binds: taints,
    lifts, capacity drift, bound-pod deletes, namespaces, floods and
    namespace sweeps. Bindings and counters equal JAX's; the walker served."""
    rng = random.Random(seed)
    t = Trio()
    t.both(lambda x: x.pods("seed", 8))
    tainted = {}
    wave = 0
    for rnd in range(12):
        action = rng.choice(["replicas", "replicas", "replicas", "taint", "lift", "drift",
                             "delete_bound", "namespace", "flood", "ns_sweep"])
        if action == "replicas":
            n = rng.randrange(1, 12)
            wave += 1
            t.both(lambda x, n=n, w=wave: x.pods(f"w{w}", n))
        elif action == "taint":
            i = rng.randrange(24)
            tainted[i] = ("maint", "", "NoSchedule")
            t.both(lambda x, i=i: x.cs.update_node(x.node(f"node-{i}", taint=tainted[i])))
        elif action == "lift":
            if tainted:
                i = rng.choice(list(tainted))
                del tainted[i]
                t.both(lambda x, i=i: x.cs.update_node(x.node(f"node-{i}")))
        elif action == "drift":
            i = rng.randrange(24)
            cpu = rng.choice([6, 8, 10])
            t.both(lambda x, i=i, cpu=cpu: x.cs.update_node(
                x.node(f"node-{i}", cpu=cpu, taint=tainted.get(i))))
        elif action == "delete_bound":
            def step(x):
                vs = sorted((p for p in x.cs.pods.values() if p.node_name), key=lambda p: p.name)
                if vs:
                    x.cs.delete_pod(vs[0])
            t.both(step)
        elif action == "namespace":
            t.both(lambda x, r=rnd: x.cs.create_namespace(
                x.ns(name=f"fuzz-ns-{r}", labels={"round": str(r)})))
        elif action == "flood":
            wave += 1
            t.both(lambda x, w=wave: x.pods(f"big{w}", 2, cpu="32000m"))
        else:
            n = rng.randrange(2, 8)
            wave += 1
            t.both(lambda x, n=n, w=wave: [x.cs.create_pod(x.pod(f"ns{w}-{i}", ns=f"ns-{i % 3}"))
                                           for i in range(n)])
    t.check()
    assert t.port.s.hint_hits > 0


# -- one entry of each package, stepped side by side ---------------------------


_ENTRY_FIELDS = ("NP", "num", "to_find", "request", "nz_request", "has_request", "ba_skip",
                 "fit_slots", "fit_weights", "fit_strategy", "w_tt", "w_fit", "w_ba", "w_il",
                 "tolerates_unsched", "enable", "alloc_r", "alloc_pods", "req_r", "nonzero",
                 "pod_count", "static_ok", "fit_ok", "fit_sc", "ba", "total", "ok", "il_score",
                 "sel_ok", "extra_ok", "name_ok", "valid", "node_names")


def _same_entry(a, b):
    for name in _ENTRY_FIELDS:
        va, vb = getattr(a, name), getattr(b, name)
        if isinstance(va, np.ndarray):
            assert va.shape == vb.shape and (va == vb).all(), name
        else:
            assert va == vb, name


@pytest.mark.parametrize("lap,pct", [(True, 10), (False, 10), (True, 0)],
                         ids=["lap-walk", "per-pod-walk", "no-sampling-cut"])
def test_hint_entries_step_identically(lap, pct):
    """Both packages' HintEntry built from the same session (a cluster with
    taints, a cordoned node, drifted capacity and bound load), then select
    and apply stepped over a sequence of starts, 150 placements: every
    selection, every `evaluated` and every array of the walk state equal."""
    t = Trio(n_nodes=0, max_batch=32, nodes=False)
    rng = random.Random(7)
    specs = [(rng.choice([4, 8, 16]), rng.random() < 0.15, rng.random() < 0.05)
             for _ in range(120)]

    def cluster(x):
        for i, (cpu, tainted, cordon) in enumerate(specs):
            b = (x.mk_node().name(f"node-{i}").capacity({"cpu": cpu, "memory": f"{cpu * 4}Gi",
                                                          "pods": 20 + i % 7})
                 .zone(f"zone-{i % 4}"))
            if tainted:
                b = b.taint("maint", "", "NoSchedule")
            node = b.obj()
            node.unschedulable = cordon
            x.cs.create_node(node)
        x.s.percentage_of_nodes_to_score = pct
        x.pods("load", 40, cpu="700m")
    t.both(cluster)
    t.both(lambda x: x.pods("seed", 5, cpu="300m"))
    e, je = t.port.s._hints.entry, t.jax.s._hints.entry
    assert e is not None and je is not None
    e.lap_enabled = je.lap_enabled = lap
    _same_entry(e, je)
    start = 0
    for step in range(150):
        got, want = e.select(start), je.select(start)
        assert got == want, (step, got, want)
        row, evaluated = got
        if row < 0:
            break
        e.apply(row)
        je.apply(row)
        if step % 37 == 11:
            start = (start + 5) % e.num   # a rotation moved outside the walk
        else:
            start = (start % e.num + evaluated) % e.num
    _same_entry(e, je)
    assert e.lap_walks == je.lap_walks
    assert step > 20


@pytest.mark.parametrize("strategy,ba_skip", [(0, 0), (1, 0), (0, 1), (1, 1)],
                         ids=["least", "most", "least-no-ba", "most-no-ba"])
def test_row_reevaluation_vectorised_equals_row_by_row(strategy, ba_skip):
    """_reval_rows (the resync's one numpy pass) and _reval_row (the walk's
    per-placement step) give the same fit verdict, scores, total and
    feasibility on every row of random states: zero and full allocatable,
    rows over their pod count, requests above what is free."""
    s = TorchScheduler(device="cpu")
    for i in range(40):
        s.clientset.create_node(make_node().name(f"node-{i}").capacity(
            {"cpu": 8, "memory": "32Gi", "pods": 20}).obj())
    for i in range(4):
        s.clientset.create_pod(make_pod().name(f"seed-{i}").req({"cpu": "300m",
                                                                  "memory": "1Gi"}).obj())
    s.run_until_idle()
    e = s._hints.entry
    assert e is not None
    e.fit_strategy, e.ba_skip = strategy, ba_skip
    rng = np.random.default_rng(strategy * 2 + ba_skip)
    n = e.NP
    e.alloc_r[:, 0] = rng.choice([0, 1, 4000, 32000, 32000, 32000], n)
    e.alloc_r[:, 1] = rng.choice([0, 1 << 20, 64 << 30, 64 << 30], n)
    e.req_r[:, 0] = rng.integers(0, 36000, n)
    e.req_r[:, 1] = rng.integers(0, 72 << 30, n)
    e.nonzero[:] = e.req_r[:, :2] + rng.integers(0, 200, (n, 2))
    e.alloc_pods[:] = rng.integers(10, 30, n)
    e.pod_count[:] = rng.integers(0, 24, n)
    e.static_ok[:] = rng.random(n) < 0.9
    lanes = ("fit_ok", "fit_sc", "ba", "total", "ok")
    rows = np.arange(n)
    for r in rows:
        e._reval_row(int(r))
    want = [getattr(e, k).copy() for k in lanes]
    for k in lanes:
        getattr(e, k)[:] = 0
    e._reval_rows(rows)
    for k, w in zip(lanes, want):
        assert (getattr(e, k) == w).all(), k
    assert want[0].any() and not want[0].all()


def test_a_sibling_resyncs_the_landed_rows_as_a_full_resync_would(monkeypatch):
    """At an install, a sibling entry that was in line when the session
    began re-encodes only the rows the session landed pods on; its state is
    then what re-encoding every row from the cache gives. Held against JAX
    (which re-encodes every row) over alternating shapes."""
    import copy

    partial = []
    resync = port_hints.HintEntry.resync_rows

    def checked(self, cache, rows=None):
        if rows is None:
            return resync(self, cache)
        full = copy.deepcopy(self)
        assert resync(self, cache, rows) is None and resync(full, cache) is None
        _same_entry(self, full)
        partial.append(len(rows))
        return None

    monkeypatch.setattr(port_hints.HintEntry, "resync_rows", checked)
    t = Trio(max_batch=8)
    t.both(lambda x: x.pods("seed-a", 6, cpu="200m"))
    for r in range(3):
        t.both(lambda x, r=r: x.pods(f"b{r}", 12, cpu="400m"))
        t.both(lambda x, r=r: x.pods(f"c{r}", 12, cpu="700m"))
    t.check()
    assert partial and 0 < max(partial) < 24


def test_a_sibling_that_missed_a_session_resyncs_every_row():
    """A session that seeds no hint (hostPort pods, which self-block) lands
    load while entry a stands: the next install's sibling was not in line
    at that session's start, so it re-encodes every row, and a's replicas
    then avoid the loaded nodes exactly as JAX's do."""
    t = Trio()
    t.both(lambda x: x.pods("seed-a", 6, cpu="200m"))
    t.both(lambda x: [x.cs.create_pod(x.mk_pod().name(f"hp-{i}").req(
        {"cpu": "3", "memory": "128Mi"}).host_port(8080).obj()) for i in range(12)])
    t.both(lambda x: x.pods("seed-b", 6, cpu="400m"))
    assert len(t.port.s._hints.entries) == 2
    h0 = t.port.s.hint_hits
    t.both(lambda x: x.pods("rep-a", 20, cpu="200m"))
    t.check()
    assert t.port.s.hint_hits - h0 == 20


# -- the bench shape, cut ----------------------------------------------------------


def test_replica_surge_cut_like_the_jax_harness(monkeypatch):
    """HomogeneousReplicaSurge at 50 nodes, 20 init and 200 measured pods:
    the JAX perf harness's own workload (its creates run synchronously, as
    the port's bench makes them) and the port's bench bind the same pods,
    with the same hits; the window binds through the walker (rate 1, above
    the shape's 0.9 floor) and dispatches nothing, and the port with hints
    off binds the same pods through dispatches."""
    from kubernetes_tpu.perf import harness
    from kubernetes_tpu_torch import bench

    wl = next(w for w in harness.load_config("kubernetes_tpu/perf/configs/"
                                             "performance-config.yaml")
              if w.testcase == "HomogeneousReplicaSurge" and w.name == "5000Nodes_10000Replicas")
    wl.params = {"nodes": 50, "initPods": 20, "measurePods": 200}

    class Synchronous:
        blocks_idle = False

        def __init__(self, fn):
            fn()

        def tick(self):
            return False

    monkeypatch.setattr(harness, "_ThreadedCreator", Synchronous)
    jax_s = TPUScheduler(mesh=None)
    result = harness.run_workload(wl, sched=jax_s)
    W = "HomogeneousReplicaSurge/5000Nodes_10000Replicas"
    runs = []
    for hints in (True, False):
        s = bench.build_cluster(50, device="cpu", score_hints=hints)
        bench.warm(s, 20, W)
        runs.append((s, bench.measure(s, 200, workload=W)["detail"]))
    (on, d_on), (off, d_off) = runs
    for c in ("scheduled", "hint_hits", "hint_misses", "hint_invalidations", "failures"):
        assert getattr(on, c) == getattr(jax_s, c), c
    assert (sorted(p.node_name for p in on.clientset.pods.values())
            == sorted(p.node_name for p in jax_s.clientset.pods.values()))
    assert ({p.name: p.node_name for p in on.clientset.pods.values()}
            == {p.name: p.node_name for p in off.clientset.pods.values()})
    assert d_on["hint_hit_rate"] == 1.0 >= d_on["hint_hit_rate_floor"] == 0.9
    assert d_on["device_batches"] == 0 and d_on["scheduled"] == 200
    assert result.metrics["HintHitRate"]["Average"] == 1.0
    assert d_off["hint_hits"] == 0 and d_off["device_batches"] >= 1
