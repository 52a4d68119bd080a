"""The PyTorch port's incremental session resume against the JAX reference,
on the CPU.

Scheduler: the same scripted event streams — bound-pod deletes between
sessions, taint lifts and adds, unclassifiable events, events parked in the
inbox while a session runs, namespace sweeps, seeded churn — go through
kubernetes_tpu's TPUScheduler(mesh=None) and through
TorchScheduler(device="cpu"), with score hints off in both and on in both.
The assignments, the four plan-acquisition counters (plan_rebuilds_full /
_delta / _resume, delta_dirty_rows) and the hint counters must be
identical, and with hints off each stream must take the path it is about
(the cases about a session's own path run with hints off only). Kernel:
the JAX package's patch_carry_rows against the port's plain version on
seeded numpy inputs, exact (int64 and bool, no tolerance). Also the
journal's truncation, patch_tier's tiers, and that both patches write
copies."""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from kubernetes_tpu.api.types import Namespace as JaxNamespace
from kubernetes_tpu.models.tpu_scheduler import TPUScheduler
from kubernetes_tpu.ops.device_state import DeviceNodeState as JaxState
from kubernetes_tpu.ops.features import BatchFeatures as JaxFeatures
from kubernetes_tpu.ops.kernel import ScanCarry as JaxCarry
from kubernetes_tpu.ops.kernel import patch_carry_rows as jax_patch_carry_rows
from kubernetes_tpu.ops.kernel import schedule_batch as jax_schedule_batch
from kubernetes_tpu.testing.wrappers import make_node as jax_make_node
from kubernetes_tpu.testing.wrappers import make_pod as jax_make_pod
from kubernetes_tpu_torch.api.types import Namespace
from kubernetes_tpu_torch.core.cache import EV_QUEUE, EventJournal
from kubernetes_tpu_torch.models import TorchScheduler
from kubernetes_tpu_torch.ops import kernel as K
from kubernetes_tpu_torch.ops.device_state import patch_tier, state_from_jax_numpy
from kubernetes_tpu_torch.ops.features import features_from_jax_numpy
from kubernetes_tpu_torch.ops.kernel import carry_from_jax_numpy
from kubernetes_tpu_torch.testing import make_node, make_pod
from kubernetes_tpu_torch.testing.kernel_inputs import (
    nominated_lane,
    patch_inputs,
    random_inputs,
    with_nominated_lane,
)

COUNTERS = ("plan_rebuilds_full", "plan_rebuilds_delta", "plan_rebuilds_resume",
            "delta_dirty_rows", "hint_hits", "hint_misses", "hint_invalidations")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small inputs: one intra-op thread keeps this module from crowding
    the other test workers' CPUs."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(params=[False, True], ids=["hints-off", "hints-on"])
def hints(request):
    """Score hints off (the dispatch path alone) and on (both packages'
    defaults): each parity case runs both ways."""
    return request.param


# ---------------------------------------------------------------------------
# the pair: the JAX package's device scheduler and the port's
# ---------------------------------------------------------------------------


class Side:
    """One scheduler with its package's builders."""

    def __init__(self, sched, mk_node, mk_pod, namespace_cls):
        self.s, self.mk_node, self.mk_pod, self.ns = sched, mk_node, mk_pod, namespace_cls

    def node(self, name, taint=None, cpu=8, label=None):
        b = (self.mk_node().name(name).capacity({"cpu": cpu, "memory": "32Gi", "pods": 110})
             .zone(f"zone-{len(name) % 3}"))
        if taint:
            b = b.taint(*taint)
        if label:
            b = b.label(*label)
        return b.obj()

    def pod(self, name, ns="default", cpu="200m", labels=None, tolerate=None):
        b = self.mk_pod().name(name).namespace(ns).req({"cpu": cpu, "memory": "128Mi"})
        if labels:
            b = b.labels(dict(labels))
        if tolerate:
            b = b.toleration(tolerate, "", "Exists", "NoSchedule")
        return b.obj()

    @property
    def cs(self):
        return self.s.clientset

    def bound(self):
        return sorted((p for p in self.cs.pods.values() if p.node_name),
                      key=lambda p: (p.namespace, p.name))


def _pair(n_nodes=24, max_batch=64, taints=None, hints=False):
    """The two schedulers with score hints on or off in both (with them, a
    replica after a clean session binds before any session starts)."""
    jax_s = TPUScheduler(max_batch=max_batch, mesh=None)
    jax_s._hints.enabled = hints
    sides = (Side(jax_s, jax_make_node, jax_make_pod, JaxNamespace),
             Side(TorchScheduler(device="cpu", max_batch=max_batch, score_hints=hints),
                  make_node, make_pod, Namespace))
    taints = taints or {}
    for side in sides:
        for i in range(n_nodes):
            side.cs.create_node(side.node(f"node-{i}", taint=taints.get(i)))
    return sides


def _both(sides, fn):
    """Apply one scripted step to both schedulers, then drain both."""
    for side in sides:
        fn(side)
        side.s.run_until_idle()


def _park_in_session(side, fn):
    """Park a clientset mutation as an off-thread watch delivery made while
    the next session runs: at the session's first dispatch it goes into the
    inbox, which the session's refill drains on the loop thread."""
    sched = side.s
    dispatch = sched._dispatch

    def first_dispatch(*args):
        del sched._dispatch  # back to the class's method
        sched._event_inbox.append((lambda: fn(side), ()))
        return dispatch(*args)
    sched._dispatch = first_dispatch


def _assignments(side):
    return {f"{p.namespace}/{p.name}": p.node_name for p in side.cs.pods.values()}


def _counters(side):
    return {c: getattr(side.s, c) for c in COUNTERS}


def _sessions(side):
    s = side.s
    return s.plan_rebuilds_full + s.plan_rebuilds_delta + s.plan_rebuilds_resume


def _assert_identical(sides):
    jax_side, port = sides
    a_jax, a_port = _assignments(jax_side), _assignments(port)
    diffs = {k: (v, a_port.get(k)) for k, v in a_jax.items() if v != a_port.get(k)}
    assert not diffs and a_jax.keys() == a_port.keys(), f"JAX/port divergence: {diffs}"
    assert _counters(jax_side) == _counters(port)
    assert (jax_side.s.scheduled, jax_side.s.failures) == (port.s.scheduled, port.s.failures)
    assert jax_side.s.device_scheduled == port.s.device_scheduled
    assert jax_side.s.host_path_pods == port.s.host_path_pods


# ---------------------------------------------------------------------------
# between sessions
# ---------------------------------------------------------------------------


def test_bound_pod_delete_takes_delta_path():
    """Bound pods deleted between sessions are row patches, not rebuilds."""
    sides = _pair()
    _both(sides, lambda x: [x.cs.create_pod(x.pod(f"victim-{i}")) for i in range(10)])
    for r in range(4):
        def step(x, r=r):
            vs = [p for p in x.bound() if p.name.startswith("victim-")]
            x.cs.delete_pod(vs[0])
            for i in range(6):
                x.cs.create_pod(x.pod(f"wave{r}-{i}"))
        _both(sides, step)
    _assert_identical(sides)
    port = sides[1].s
    assert port.plan_rebuilds_full == 1 and port.plan_rebuilds_delta == 4
    assert port.delta_dirty_rows == 4 and port.host_path_pods == 0


def test_taint_lift_and_taint_add_take_delta_path():
    """Taint-only node updates patch the resident taint rows: a lift (it
    only enlarges feasibility) and an add (applied at the session's start,
    with no batch in flight) both keep the plan."""
    sides = _pair(taints={0: ("dedicated", "infra", "NoSchedule")})
    _both(sides, lambda x: [x.cs.create_pod(x.pod(f"a-{i}")) for i in range(8)])
    _both(sides, lambda x: x.cs.update_node(x.node("node-0")))
    _both(sides, lambda x: [x.cs.create_pod(x.pod(f"b-{i}")) for i in range(8)])
    _both(sides, lambda x: x.cs.update_node(
        x.node("node-3", taint=("dedicated", "infra", "NoSchedule"))))
    _both(sides, lambda x: [x.cs.create_pod(x.pod(f"c-{i}")) for i in range(8)])
    _assert_identical(sides)
    port = sides[1]
    assert port.s.plan_rebuilds_full == 1 and port.s.plan_rebuilds_delta == 2
    assert port.s.host_path_pods == 0
    on = _assignments(port)
    assert "node-0" in on.values(), "the lifted taint's node took no pod"
    assert not any(on[f"default/c-{i}"] == "node-3" for i in range(8))


@pytest.mark.parametrize("event", ["node-add", "node-label", "node-delete"])
def test_unclassified_event_falls_back_to_full_rebuild(event, hints):
    """A structural event (a node added or deleted) or a node's label change
    cannot be patched: the next session rebuilds its plan in full."""
    sides = _pair(n_nodes=12, hints=hints)
    _both(sides, lambda x: [x.cs.create_pod(x.pod(f"a-{i}")) for i in range(6)])
    step = {"node-add": lambda x: x.cs.create_node(x.node("node-99")),
            "node-label": lambda x: x.cs.update_node(x.node("node-5", label=("rack", "r1"))),
            "node-delete": lambda x: x.cs.delete_node("node-11")}[event]
    _both(sides, step)
    _both(sides, lambda x: [x.cs.create_pod(x.pod(f"b-{i}")) for i in range(6)])
    _assert_identical(sides)
    assert sides[1].s.plan_rebuilds_full == 2 and sides[1].s.plan_rebuilds_delta == 0


def test_prefer_no_schedule_taint_rebuilds_with_its_lane(hints):
    """A PreferNoSchedule taint under a plan built without that lane cannot
    be patched in: the next plan is rebuilt and carries it."""
    sides = _pair(n_nodes=12, hints=hints)
    _both(sides, lambda x: [x.cs.create_pod(x.pod(f"a-{i}")) for i in range(6)])
    _both(sides, lambda x: x.cs.update_node(x.node("node-2", taint=("soft", "", "PreferNoSchedule"))))
    _both(sides, lambda x: [x.cs.create_pod(x.pod(f"b-{i}")) for i in range(6)])
    _assert_identical(sides)
    port = sides[1].s
    assert port.plan_rebuilds_full == 2
    assert port._resume[2][1].facts.has_pns


def test_nomination_change_misses_the_resume_key(hints):
    """The nominated set is part of the resume key: after a preemption
    nominates a pod, the next session does not resume the old plan."""
    sides = _pair(n_nodes=4, hints=hints)
    for x in sides:
        for i in range(4):
            x.cs.update_node(x.node(f"node-{i}", cpu=2))
    _both(sides, lambda x: [x.cs.create_pod(x.pod(f"low-{i}", cpu="1500m")) for i in range(4)])

    def preempt(x):
        b = x.mk_pod().name("high").req({"cpu": "1500m", "memory": "128Mi"}).priority(100)
        x.cs.create_pod(b.obj())
    _both(sides, preempt)
    _assert_identical(sides)
    port = sides[1]
    assert port.s.preemption_counts()["victims"] == 1
    assert _assignments(port)["default/high"]


# ---------------------------------------------------------------------------
# within a live session: events parked in the inbox
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("event", ["namespace", "foreign-pending-pod"])
def test_session_continues_across_parked_benign_event(event, hints):
    """A namespace event (the plan has no inter-pod affinity) or a pending
    pod's delete (queue-only) parked while a session runs is consumed
    without ending it or dirtying a row."""
    sides = _pair(hints=hints)
    foreign = {}
    if event == "foreign-pending-pod":
        def mk_foreign(x):
            p = x.pod("foreign")
            p.scheduler_name = "another-scheduler"
            foreign[id(x)] = p
            x.cs.create_pod(p)
        _both(sides, mk_foreign)

    def fire(x):
        if event == "namespace":
            x.cs.create_namespace(x.ns(name="team-a", labels={"team": "a"}))
        else:
            x.cs.delete_pod(foreign[id(x)])
    for x in sides:
        for i in range(12):
            x.cs.create_pod(x.pod(f"w1-{i}"))
        _park_in_session(x, fire)
        x.s.run_until_idle()
    _assert_identical(sides)
    port = sides[1]
    assert port.s.journal.since(0)[-1].kind == ("namespace" if event == "namespace" else EV_QUEUE)
    assert port.s.plan_rebuilds_full == 1 and _sessions(port) == 1
    assert port.s.delta_dirty_rows == 0


def _parked_delete_stream(sides, delete_before: bool):
    """Seeds, then a wave whose session gets a bound-pod delete and new pods
    parked while it runs; `delete_before`: a bound pod is deleted before the
    wave too, so that its session starts with a row patch, not a resume."""
    _both(sides, lambda x: [x.cs.create_pod(x.pod(f"seed-{i}")) for i in range(6)])

    def kill_seed(x):
        x.cs.delete_pod(next(p for p in x.bound() if p.name == "seed-0"))
        for i in range(12):
            x.cs.create_pod(x.pod(f"w2-{i}"))
    for x in sides:
        if delete_before:
            x.cs.delete_pod(next(p for p in x.bound() if p.name == "seed-1"))
        for i in range(12):
            x.cs.create_pod(x.pod(f"w1-{i}"))
        _park_in_session(x, kill_seed)
        x.s.run_until_idle()


def test_session_continues_across_parked_pod_delete():
    """A bound-pod delete and pod creations parked while a session runs:
    the delete (it only enlarges feasibility) waits for the batch in flight
    to commit, then patches the live carry; the new pods join the session."""
    sides = _pair()
    _parked_delete_stream(sides, delete_before=True)
    _assert_identical(sides)
    port = sides[1]
    assert port.s.plan_rebuilds_full == 1 and port.s.plan_rebuilds_resume == 0
    assert port.s.plan_rebuilds_delta == 2 and port.s.delta_dirty_rows == 2
    assert port.s.host_path_pods == 0
    assert _assignments(port)["default/w2-0"] == "node-0", "the freed row was not patched in"


def test_parked_delete_in_a_resumed_session_keeps_it():
    """The one place where the port's counters part from the JAX package's,
    by design: a session that resumed its plan as it was, then patches an
    event parked mid-session. The JAX package's resident state is the
    adopted carry, which the next dispatch donates to the kernel, so its
    patch_rows finds the resident deleted and the session ends (ops/
    device_state.py:394-404); the port's patches write copies and the
    session goes on. Assignments are identical; the port counts one row
    patch where the JAX package counts a full rebuild."""
    sides = _pair()
    _parked_delete_stream(sides, delete_before=False)
    jax_side, port = sides
    a_jax, a_port = _assignments(jax_side), _assignments(port)
    assert a_jax == a_port
    want = _counters(jax_side)
    want["plan_rebuilds_full"] -= 1
    want["plan_rebuilds_delta"] += 1
    want["delta_dirty_rows"] += 1
    assert _counters(port) == want
    assert port.s.plan_rebuilds_full == 1 and port.s.plan_rebuilds_resume == 1
    assert port.s.plan_rebuilds_delta == 1


def test_parked_taint_add_ends_the_busy_session():
    """A taint added while a batch is in flight may shrink feasibility: the
    session ends and the next one rebuilds its plan."""
    sides = _pair()
    _both(sides, lambda x: [x.cs.create_pod(x.pod(f"seed-{i}")) for i in range(4)])

    def taint_and_add(x):
        x.cs.update_node(x.node("node-7", taint=("dedicated", "infra", "NoSchedule")))
        for i in range(70):
            x.cs.create_pod(x.pod(f"w2-{i}"))
    for x in sides:
        for i in range(70):
            x.cs.create_pod(x.pod(f"w1-{i}"))
        _park_in_session(x, taint_and_add)
        x.s.run_until_idle()
    _assert_identical(sides)
    port = sides[1]
    assert port.s.plan_rebuilds_full == 2 and port.s.plan_rebuilds_delta == 0
    assert not any(n == "node-7" for k, n in _assignments(port).items() if "/w2-" in k)


# ---------------------------------------------------------------------------
# neutral signatures
# ---------------------------------------------------------------------------


def test_cross_namespace_pods_share_one_session(hints):
    """Pods identical but for labels and namespace (the *WithNSSelector
    init shape) ride one session while no pod carries affinity terms."""
    sides = _pair(hints=hints)

    def create(x):
        for n in range(5):
            for i in range(8):
                x.cs.create_pod(x.pod(f"p-{i}", ns=f"ns-{n}", labels={"team": f"t{n}"}))
    _both(sides, create)
    _assert_identical(sides)
    port = sides[1].s
    assert port.device_scheduled == 40 and port.plan_rebuilds_full == 1
    assert port.device_batches == 1


def test_neutral_batching_disabled_when_affinity_pods_exist(hints):
    """One pod with affinity terms in the cluster makes labels and
    namespaces matter: one session per namespace again."""
    sides = _pair(hints=hints)

    def create(x):
        x.cs.create_pod(x.mk_pod().name("anchor").req({"cpu": "100m"}).label("color", "red")
                        .pod_affinity("kubernetes.io/hostname", {"color": "red"}, anti=True)
                        .obj())
        for n in range(3):
            for i in range(4):
                x.cs.create_pod(x.pod(f"p-{i}", ns=f"ns-{n}"))
    _both(sides, create)
    _assert_identical(sides)
    assert sides[1].s.cache.affinity_pod_refs == 1
    assert sides[1].s.plan_rebuilds_full >= 3


# ---------------------------------------------------------------------------
# seeded churn
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_mixed_churn_matches_jax(seed):
    """A seeded stream of pod waves across namespaces, bound-pod deletes,
    namespace creations, foreign pending pods, taint flips, some events
    parked mid-session, and (rarely) node adds; then a shrink event after a
    clean session (it must patch) and a node add (it must rebuild)."""
    rng = random.Random(seed)
    sides = _pair(n_nodes=16)
    seq = 0

    def wave(x, w, ns, k):
        # The pods tolerate the churn taint, so that no pod is left
        # unschedulable (its retries would change the resume key each cycle).
        for i in range(k):
            x.cs.create_pod(x.pod(f"f{w}-{i}", ns=ns, tolerate="dedicated"))

    def kill(x):
        if x.bound():
            x.cs.delete_pod(x.bound()[0])

    for _ in range(16):
        op = rng.random()
        if op < 0.35:
            k, ns, w = rng.randint(2, 6), rng.choice(["default", "ns-a", "ns-b"]), seq
            seq += 1
            if rng.random() < 0.3:
                # A bound pod deleted, then the wave with another delete
                # parked in its session.
                for x in sides:
                    kill(x)
                    wave(x, w, ns, k)
                    _park_in_session(x, kill)
                    x.s.run_until_idle()
            else:
                _both(sides, lambda x, w=w, ns=ns, k=k: wave(x, w, ns, k))
        elif op < 0.55:
            _both(sides, kill)
        elif op < 0.62:
            name = f"ns-{seq}"
            seq += 1
            _both(sides, lambda x, name=name: x.cs.create_namespace(
                x.ns(name=name, labels={"team": "t"})))
        elif op < 0.70:
            name = f"foreign-{seq}"
            seq += 1

            def foreign(x, name=name):
                p = x.pod(name)
                p.scheduler_name = "another-scheduler"
                x.cs.create_pod(p)
            _both(sides, foreign)
        elif op < 0.93:
            i, tainted = rng.randint(0, 15), rng.random() < 0.5
            _both(sides, lambda x, i=i, t=tainted: x.cs.update_node(x.node(
                f"node-{i}", taint=("dedicated", "x", "NoSchedule") if t else None)))
        else:
            name = f"extra-{seq}"
            seq += 1
            _both(sides, lambda x, name=name: x.cs.create_node(x.node(name)))
    _both(sides, lambda x: wave(x, "tail0", "default", 4))
    delta0 = sides[1].s.plan_rebuilds_delta

    def shrink_step(x):
        kill(x)
        wave(x, "tail1", "default", 4)
    _both(sides, shrink_step)
    assert sides[1].s.plan_rebuilds_delta > delta0, "a shrink after a clean session rebuilt"
    full0 = sides[1].s.plan_rebuilds_full

    def structural_step(x):
        x.cs.create_node(x.node("tail-node"))
        wave(x, "tail2", "default", 4)
    _both(sides, structural_step)
    _assert_identical(sides)
    port = sides[1].s
    assert port.failures == 0 and port.host_path_pods == 0
    assert port.plan_rebuilds_full > full0, "a node add did not rebuild"


# ---------------------------------------------------------------------------
# patch_carry_rows, the journal, the tiers and the copies
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k,tier", [(5, 32), (32, 32), (40, 256), (180, 256), (1, 32),
                                    (150, 2048)])
@pytest.mark.parametrize("lane", [False, True], ids=["no-lane", "lane"])
@pytest.mark.parametrize("fit_strategy", [0, 1], ids=["least", "most"])
def test_patch_carry_rows_matches_jax(fit_strategy, lane, k, tier):
    """The carry patch on a chained carry from a real schedule_batch, with
    padded duplicate indices: every lane equal to the JAX function's."""
    seed = 70 + k + tier + 2 * fit_strategy + lane
    s, f = random_inputs(seed, 256, 200)
    if lane:
        f = with_nominated_lane(f, nominated_lane(seed, 256, 200))
    js, jf = [jnp.asarray(a) for a in s], [jnp.asarray(a) for a in f]
    js, jf = JaxState(*js), JaxFeatures(*jf)
    _res, jcarry = jax_schedule_batch(js, jf, 512, fit_strategy, 64, n_active=np.int32(300),
                                      has_nom=lane, has_pns=False, has_ipa_base=False)
    jcarry_np = [np.asarray(a) for a in jcarry]
    idx, req_rows, nz_rows, cnt_rows = patch_inputs(seed, s, 200, k, tier)
    assert len(set(idx.tolist())) == k and (idx == idx[-1]).sum() == tier - k + 1
    want = jax_patch_carry_rows(js, jf, JaxCarry(*[jnp.asarray(a) for a in jcarry_np]),
                                jnp.asarray(idx), jnp.asarray(req_rows), jnp.asarray(nz_rows),
                                jnp.asarray(cnt_rows), fit_strategy=fit_strategy, has_nom=lane)
    carry = carry_from_jax_numpy(jcarry_np)
    got = K.patch_carry_rows(state_from_jax_numpy(s), features_from_jax_numpy(f), carry,
                             torch.from_numpy(idx), torch.from_numpy(req_rows),
                             torch.from_numpy(nz_rows), torch.from_numpy(cnt_rows), fit_strategy)
    for i, (a, b) in enumerate(zip(want, got)):
        a = np.asarray(a)
        assert a.dtype == b.numpy().dtype and a.shape == tuple(b.shape), i
        np.testing.assert_array_equal(a, b.numpy(), err_msg=f"carry lane {i}")
    # The patch moved the rows: fit verdicts flip and the untouched rows stay.
    changed = np.asarray(want.fit_ok)[idx] != jcarry_np[3][idx]
    assert changed.any() or k < 32
    rest = np.setdiff1d(np.arange(256), idx)
    np.testing.assert_array_equal(np.asarray(want.fit_sc)[rest], jcarry_np[4][rest])
    # A copy: the carry given keeps its values.
    np.testing.assert_array_equal(carry.req_r.numpy(), jcarry_np[0])


@pytest.mark.parametrize("k,tier", [(1, 32), (40, 256), (150, 2048)])
def test_patch_carry_rows_staged_in_place_matches_jax(k, tier):
    """The carry patch's inputs staged in one upload (stage_carry_patch, as
    the scheduler sends them) and written in place: every lane equal to the
    JAX function's, in the carry's own tensors."""
    from kubernetes_tpu_torch.ops.staging import StagingRing

    seed = 90 + k + tier
    s, f = random_inputs(seed, 256, 200)
    js, jf = JaxState(*[jnp.asarray(a) for a in s]), JaxFeatures(*[jnp.asarray(a) for a in f])
    _res, jcarry = jax_schedule_batch(js, jf, 512, 1, 64, n_active=np.int32(300), has_nom=False,
                                      has_pns=False, has_ipa_base=False)
    jcarry_np = [np.asarray(a) for a in jcarry]
    idx, req_rows, nz_rows, cnt_rows = patch_inputs(seed, s, 200, k, tier)
    want = jax_patch_carry_rows(js, jf, JaxCarry(*[jnp.asarray(a) for a in jcarry_np]),
                                jnp.asarray(idx), jnp.asarray(req_rows), jnp.asarray(nz_rows),
                                jnp.asarray(cnt_rows), fit_strategy=1, has_nom=False)
    # Host staging holding the post-event aggregates at the patched rows.
    req_r, nonzero, pod_count = (np.array(a) for a in (s[2], s[3], s[4]))
    req_r[idx], nonzero[idx], pod_count[idx] = req_rows, nz_rows, cnt_rows
    staged = K.stage_carry_patch(StagingRing("cpu"), idx, req_r, nonzero, pod_count)
    carry = carry_from_jax_numpy(jcarry_np)
    ptrs = [t.data_ptr() for t in carry]
    got = K.patch_carry_rows(state_from_jax_numpy(s), features_from_jax_numpy(f), carry,
                             *staged, 1, in_place=True)
    assert [t.data_ptr() for t in got] == ptrs
    for i, (a, b) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=f"carry lane {i}")


def test_event_journal_since_and_truncation():
    j = EventJournal(capacity=4)
    assert j.since(0) == []
    for i in range(3):
        j.record("pod_add", f"n{i}", pod_plain=True)
    assert [e.key for e in j.since(1)] == ["n1", "n2"] and j.since(3) == []
    for i in range(3, 7):
        j.record("pod_remove", f"n{i}", shrink=True)
    assert j.seq == 7 and [e.seq for e in j.since(3)] == [4, 5, 6, 7]
    assert j.since(2) is None, "a window that lost events must say so"
    assert j.since(7) == [] and j.since(9) == []


@pytest.mark.parametrize("n,tier", [(1, 32), (32, 32), (33, 256), (256, 256), (257, 2048),
                                    (2048, 2048), (2049, 4096), (5000, 8192)])
def test_patch_tier(n, tier):
    assert patch_tier(n) == tier


def test_patches_write_copies_and_resume_reads_them():
    """patch_rows scatters into a copy of the resident state and
    patch_carry_rows returns copied lanes: the saved plan's tensors keep
    their values, and the resumed session's state and carry hold the
    patched rows. (Hints off: the next pod must start a session, not bind
    from the walker.)"""
    port = TorchScheduler(device="cpu", max_batch=64, score_hints=False)
    for i in range(8):
        port.clientset.create_node(make_node().name(f"node-{i}")
                                   .capacity({"cpu": 4, "memory": "8Gi", "pods": 10}).obj())
    for i in range(8):
        port.clientset.create_pod(make_pod().name(f"a-{i}").req({"cpu": "1"}).obj())
    port.run_until_idle()
    key, seq, (state, plan, carry, names), _nom = port._resume
    before = [t.clone() for t in carry[:6]], [t.clone() for t in state]
    victim = next(p for p in port.clientset.pods.values() if p.node_name == "node-3")
    port.clientset.delete_pod(victim)
    port.clientset.update_node(make_node().name("node-5").capacity(
        {"cpu": 4, "memory": "8Gi", "pods": 10}).taint("k", "v", "NoSchedule").obj())
    captured = {}
    dispatch = port._dispatch

    def spy(st, pl, n, c):
        captured.setdefault("first", (st, c))
        return dispatch(st, pl, n, c)
    port._dispatch = spy
    port.clientset.create_pod(make_pod().name("b-0").req({"cpu": "1"}).obj())
    port.run_until_idle()
    assert port.plan_rebuilds_delta == 1 and port.delta_dirty_rows == 2
    for old, t in zip(before[0] + before[1], list(carry[:6]) + list(state)):
        assert torch.equal(old, t), "a patch wrote into the saved tensors"
    st, c = captured["first"]
    r3, r5 = names.index("node-3"), names.index("node-5")
    assert int(c.pod_count[r3]) == int(carry.pod_count[r3]) - 1
    assert int(st.taint_eff[r5].max()) > 0 and int(state.taint_eff[r5].max()) == 0
    assert port.clientset.pods[next(uid for uid, p in port.clientset.pods.items()
                                    if p.name == "b-0")].node_name == "node-3"
