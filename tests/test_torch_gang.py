"""The PyTorch port's pod-group slice against the JAX reference, end to end.

The same cluster and pod groups go through three schedulers: the JAX
package's host Scheduler (deterministic ties), its TPUScheduler (CPU JAX, no
mesh) and the port's TorchScheduler on the CPU (the kernels' plain
versions), the last two with score hints off in both and on in both. Their bindings
must be identical pod for pod: gang device sessions (groups of the default
algorithm), the placement algorithm with its stacked device evaluation
(schedule_placements), pod-group preemption and the Permit barrier. The
cases are those of the JAX package's tests/test_gang_device.py (without
PVCs), tests/test_placement_gang.py and tests/test_podgroup_preemption.py,
at the same small sizes."""

import random

import pytest
import torch

from kubernetes_tpu.api.types import CompositePodGroup as JaxCompositePodGroup
from kubernetes_tpu.api.types import PodGroup as JaxPodGroup
from kubernetes_tpu.core import FakeClientset as JaxClientset
from kubernetes_tpu.core import Scheduler as JaxScheduler
from kubernetes_tpu.core.registry import gang_placement_profiles
from kubernetes_tpu.models import TPUScheduler
from kubernetes_tpu.testing.wrappers import make_node as jax_make_node
from kubernetes_tpu.testing.wrappers import make_pod as jax_make_pod
from kubernetes_tpu_torch.api.types import PodGroup
from kubernetes_tpu_torch.core.registry import default_profile, gang_placement_profile
from kubernetes_tpu_torch.models import TorchScheduler
from kubernetes_tpu_torch.testing import make_node, make_pod

ZONE = "topology.kubernetes.io/zone"
HOSTNAME = "kubernetes.io/hostname"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(params=[False, True], ids=["hints-off", "hints-on"])
def hints(request):
    """Score hints off (the dispatch path alone) and on (both packages'
    defaults): each parity case runs both ways."""
    return request.param


class Kit:
    """One scheduler with the builders of its package."""

    def __init__(self, kind, placement=False, max_batch=None, hints=False):
        self.kind = kind
        if kind == "port":
            self.sched = TorchScheduler(
                device="cpu", max_batch=max_batch, score_hints=hints,
                profile_factory=gang_placement_profile if placement else default_profile)
            self.node, self.pod, self.group = make_node, make_pod, PodGroup
        else:
            cs = JaxClientset()
            kw = {"profile_factory": gang_placement_profiles} if placement else {}
            if kind == "jax":
                self.sched = TPUScheduler(clientset=cs, mesh=None, max_batch=max_batch, **kw)
                self.sched._hints.enabled = hints
            else:
                self.sched = JaxScheduler(clientset=cs, deterministic_ties=True, **kw)
            self.node, self.pod, self.group = jax_make_node, jax_make_pod, JaxPodGroup
        self.cs = self.sched.clientset

    def nodes(self, n, cpu="8", memory="16Gi", zones=4, prefix="n"):
        for i in range(n):
            b = self.node().name(f"{prefix}{i}").capacity({"cpu": cpu, "memory": memory,
                                                           "pods": 110})
            if zones:
                b = b.zone(f"z{i % zones}")
            self.cs.create_node(b.obj())

    def gang(self, name, size, cpu="500m", min_count=None, keys=(), build=None, clone=True):
        self.cs.create_pod_group(self.group(name=name, topology_keys=tuple(keys),
                                            min_count=size if min_count is None else min_count))
        proto = self.pod().name(f"{name}-proto").req({"cpu": cpu, "memory": "128Mi"})
        if build is not None:
            proto = build(proto)
        proto = proto.obj()
        pods = []
        for j in range(size):
            if clone:
                p = proto.clone_from_template(f"{name}-{j}")
            else:
                b = self.pod().name(f"{name}-{j}").req({"cpu": cpu, "memory": "128Mi"})
                p = (build(b) if build is not None else b).obj()
            p.pod_group = name
            self.cs.create_pod(p)
            pods.append(p)
        return pods

    def bindings(self):
        return {p.name: p.node_name for p in self.cs.pods.values()}

    def zones_of(self, names):
        by_name = {p.name: p for p in self.cs.pods.values()}
        return {self.cs.nodes[by_name[n].node_name].labels[ZONE] for n in names
                if by_name[n].node_name}


def trio(populate, placement=False, max_batch=None, kinds=("host", "jax", "port"), hints=False):
    """Run populate(kit) then run_until_idle on each scheduler kind (`hints`:
    score hints on in the JAX and port schedulers); assert identical
    bindings; return the kits by kind."""
    kits = {}
    for kind in kinds:
        kit = Kit(kind, placement, max_batch=None if kind == "host" else max_batch, hints=hints)
        populate(kit)
        kit.sched.run_until_idle()
        kits[kind] = kit
    want = kits["host"].bindings() if "host" in kits else kits["jax"].bindings()
    for kind, kit in kits.items():
        got = kit.bindings()
        diffs = {k: (want[k], got.get(k)) for k in want if want[k] != got.get(k)}
        assert not diffs and set(got) == set(want), f"{kind} diverged: {diffs}"
    return kits


# -- gang device sessions (tests/test_gang_device.py) -------------------------

@pytest.mark.parametrize("max_batch", [None, 8], ids=["one-pack", "packs-of-two-groups"])
def test_gang_device_assignments_match_host_oracle(max_batch, hints):
    kits = trio(lambda k: (k.nodes(40), [k.gang(f"g{g}", 4) for g in range(12)]),
                max_batch=max_batch, hints=hints)
    port, jax_s = kits["port"].sched, kits["jax"].sched
    assert all(kits["port"].bindings().values())
    assert port.device_scheduled == jax_s.device_scheduled == 48
    assert port.host_path_pods == jax_s.host_path_pods == 0
    assert port.device_batches == jax_s.device_batches


def test_gang_device_interleaved_with_plain_pods(hints):
    def populate(k):
        k.nodes(40)
        for g in range(6):
            k.gang(f"g{g}", 3)
        proto = k.pod().name("pp").req({"cpu": "250m"}).obj()
        for i in range(20):
            k.cs.create_pod(proto.clone_from_template(f"plain-{i}"))
    kits = trio(populate, hints=hints)
    assert kits["port"].sched.scheduled == kits["jax"].sched.scheduled == 38


def test_gang_device_infeasible_group_parks_and_session_recovers(hints):
    def populate(k):
        k.nodes(4)
        k.gang("ok1", 2, cpu="1")
        k.gang("nofit", 2, cpu="16")  # no node has 16 cpu
        k.sched.run_until_idle()
        k.gang("late", 2, cpu="1")
    kits = trio(populate, hints=hints)
    b = kits["port"].bindings()
    assert all(b[f"ok1-{j}"] and b[f"late-{j}"] for j in range(2))
    assert not any(b[f"nofit-{j}"] for j in range(2))
    assert kits["port"].sched.failures == kits["jax"].sched.failures > 0


def test_gang_member_anti_affinity_rides_the_device(hints):
    """Hostname anti-affinity is kernel-supported: the group still rides a
    gang session, and its members never share a node."""
    kits = trio(lambda k: (k.nodes(6), k.gang(
        "anti", 3, cpu="100m",
        build=lambda b: b.labels({"app": "x"}).pod_affinity(HOSTNAME, {"app": "x"}, anti=True))), hints=hints)
    nodes = list(kits["port"].bindings().values())
    assert None not in nodes and "" not in nodes and len(set(nodes)) == 3
    assert kits["port"].sched.device_scheduled == 3


def test_gang_sessions_resume_like_the_reference(hints):
    """A second wave of gangs resumes the first wave's plan: the
    plan-acquisition counters equal the JAX package's."""
    def populate(k):
        k.nodes(24)
        for g in range(4):
            k.gang(f"a{g}", 4)
        k.sched.run_until_idle()
        for g in range(4):
            k.gang(f"b{g}", 4)
    kits = trio(populate, kinds=("jax", "port"), hints=hints)
    counters = ("plan_rebuilds_full", "plan_rebuilds_delta", "plan_rebuilds_resume")
    got = {c: getattr(kits["port"].sched, c) for c in counters}
    assert got == {c: getattr(kits["jax"].sched, c) for c in counters}
    assert got["plan_rebuilds_full"] == 1


def _mixed_members(k):
    k.nodes(8)
    k.cs.create_pod_group(k.group(name="mixed", min_count=3))
    for j, cpu in enumerate(("500m", "1", "2")):
        p = k.pod().name(f"mixed-{j}").req({"cpu": cpu, "memory": "128Mi"}).obj()
        p.pod_group = "mixed"
        k.cs.create_pod(p)


def _placement_with_affinity(k):
    k.nodes(9, zones=3)
    k.gang("aff", 3, keys=(ZONE,), clone=False, build=lambda b: b.labels({"app": "a"})
           .pod_affinity(HOSTNAME, {"app": "a"}, anti=True))


@pytest.mark.parametrize("populate,placement", [
    (_mixed_members, False), (_placement_with_affinity, True)],
    ids=["mixed-members", "placement-with-anti-affinity"])
def test_groups_outside_the_device_take_the_host_cycle(populate, placement, hints):
    """A group whose members differ, and a placement group whose plan
    carries inter-pod-affinity tables (outside the placement restriction),
    are scheduled by the host group cycle: the same bindings, the group
    counted once as a host-path entity (as the JAX package counts it), no
    device placement evaluation."""
    kits = trio(populate, placement=placement, hints=hints)
    port = kits["port"].sched
    assert all(kits["port"].bindings().values())
    assert port.host_path_pods == kits["jax"].sched.host_path_pods == 1
    assert port.placement_device_evals == 0
    assert port.device_scheduled == 0


# -- the placement algorithm (tests/test_placement_gang.py) -------------------

def test_placement_gang_device_matches_host_oracle(hints):
    def populate(k):
        k.nodes(30, zones=3)
        for g in range(6):
            k.gang(f"g{g}", 3, keys=(ZONE,))
    kits = trio(populate, placement=True, hints=hints)
    port = kits["port"]
    assert port.sched.placement_device_evals == kits["jax"].sched.placement_device_evals == 6
    assert port.sched.host_path_pods == 0
    for g in range(6):
        assert len(port.zones_of([f"g{g}-{j}" for j in range(3)])) == 1


def _packs(k):
    k.nodes(12, cpu="8", memory="32Gi", zones=3)
    k.gang("train", 4, cpu="1", keys=(ZONE,), clone=False)


def _zoned(k, prefix, n, cpu, zone):
    for i in range(n):
        k.cs.create_node(k.node().name(f"{prefix}{i}").capacity(
            {"cpu": cpu, "memory": "32Gi", "pods": 110}).zone(zone).obj())


def _best_placement(k):
    # z0 fits two members, z1 all four: PodGroupPodsCount picks z1 though z0
    # sorts first.
    _zoned(k, "small", 2, 4, "z0")
    _zoned(k, "big", 4, 8, "z1")
    k.gang("train", 4, cpu="4", min_count=2, keys=(ZONE,), clone=False)


def _min_count_gate(k):
    # Every zone fits two of three required members: nothing commits.
    k.nodes(4, cpu="2", memory="32Gi", zones=2)
    k.gang("train", 3, cpu="2", min_count=3, keys=(ZONE,), clone=False)


def _partial(k):
    # One zone fits three of four members, min_count 2: three commit.
    _zoned(k, "n", 3, 2, "z0")
    k.gang("train", 4, cpu="2", min_count=2, keys=(ZONE,), clone=False)


def _pinned(k):
    # A member already bound in z2 pins the group's domain.
    k.nodes(6, cpu="8", memory="32Gi", zones=3)
    k.cs.create_pod_group(k.group(name="train", min_count=2, topology_keys=(ZONE,)))
    bound = k.pod().name("train-bound").req({"cpu": "1"}).obj()
    bound.pod_group = "train"
    bound.node_name = "n2"
    k.cs.create_pod(bound)
    for i in range(2):
        p = k.pod().name(f"train-{i}").req({"cpu": "1"}).obj()
        p.pod_group = "train"
        k.cs.create_pod(p)


def _no_keys(k):
    k.nodes(4, cpu="8", memory="32Gi", zones=2)
    k.gang("plain", 4, cpu="1", clone=False)


PLACEMENT_CASES = {
    "packs-into-one-zone": (_packs, lambda b: all(b.values()), 1),
    "most-members": (_best_placement, lambda b: sum(map(bool, b.values())) == 4, 1),
    "min-count-gate": (_min_count_gate, lambda b: not any(b.values()), 0),
    "partial-when-min-count-met": (_partial, lambda b: sum(map(bool, b.values())) == 3, 1),
    "scheduled-members-pin-the-domain": (_pinned, lambda b: all(b.values()), 1),
    "no-keys-default-algorithm": (_no_keys, lambda b: all(b.values()), 2),
}


@pytest.mark.parametrize("case", list(PLACEMENT_CASES))
def test_placement_algorithm(case, hints):
    populate, check, zones = PLACEMENT_CASES[case]
    kits = trio(populate, placement=True, hints=hints)
    port = kits["port"]
    b = port.bindings()
    assert check(b), b
    assert len(port.zones_of([n for n, v in b.items() if v])) == zones
    evals = port.sched.placement_device_evals
    assert evals == kits["jax"].sched.placement_device_evals
    assert (evals > 0) == (case != "no-keys-default-algorithm")
    if case == "most-members":
        assert port.zones_of(list(b)) == {"z1"}


def test_pod_group_state_tracks_placed_members():
    k = Kit("port", placement=True)
    k.nodes(6, cpu="8", zones=2)
    pods = k.gang("g", 2, cpu="1", keys=(ZONE,), clone=False)
    k.sched.run_until_idle()
    store = k.sched.pod_group_state
    assert store.count("default", "g") == 2
    gen = store.generation
    k.cs.delete_pod(pods[0])
    assert store.count("default", "g") == 1 and store.generation > gen


# -- placement gangs whose members carry spread constraints -------------------

def _spread_gang(k, name, size, max_skew=1, key=HOSTNAME, soft=False):
    def build(b):
        b = b.labels({"gang": name}).spread_constraint(max_skew, key, "DoNotSchedule",
                                                       {"gang": name})
        if soft:
            b = b.spread_constraint(1, ZONE, "ScheduleAnyway", {"gang": name})
        return b
    k.gang(name, size, cpu="1", keys=(ZONE,), build=build, clone=False)


SPREAD_CASES = {
    "hostname-spread": lambda k: (k.nodes(12, cpu=8, memory="32Gi", zones=3),
                                  _spread_gang(k, "train", 4)),
    "skew-infeasible-domain": lambda k: (_zoned(k, "s", 2, 8, "z0"), _zoned(k, "b", 4, 8, "z1"),
                                         _spread_gang(k, "train", 4)),
    "hostname-and-soft-zone": lambda k: (k.nodes(12, cpu=8, memory="32Gi", zones=3),
                                         _spread_gang(k, "a", 3, soft=True),
                                         _spread_gang(k, "b", 4, soft=True)),
}


@pytest.mark.parametrize("case", list(SPREAD_CASES))
def test_placement_gang_with_spread_members(case, hints):
    kits = trio(SPREAD_CASES[case], placement=True, hints=hints)
    port = kits["port"]
    b = port.bindings()
    assert all(b.values())
    assert port.sched.placement_device_evals == kits["jax"].sched.placement_device_evals > 0
    assert port.sched.host_path_pods == 0
    if case == "skew-infeasible-domain":
        assert all(v.startswith("b") for v in b.values()), b


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_spread_placement_gangs(seed, hints):
    def populate(k):
        rng = random.Random(seed)
        zones, per = rng.choice([2, 3, 4]), rng.choice([3, 4, 5])
        k.nodes(zones * per, cpu=rng.choice([4, 8]), memory="32Gi", zones=zones)
        for g in range(3):
            _spread_gang(k, f"g{g}", rng.choice([2, 3]), max_skew=rng.choice([1, 2]),
                         key=rng.choice([HOSTNAME, ZONE]))
    kits = trio(populate, placement=True, hints=hints)
    assert kits["port"].sched.placement_device_evals == kits["jax"].sched.placement_device_evals


# -- pod-group preemption (tests/test_podgroup_preemption.py) -----------------

def _full(k, n_nodes, fill_prio=1):
    for i in range(n_nodes):
        k.cs.create_node(k.node().name(f"n{i}").capacity(
            {"cpu": 4, "memory": "32Gi", "pods": 110}).zone(f"z{i % 2}").obj())
    for i in range(n_nodes):
        p = k.pod().name(f"low-{i}").req({"cpu": "4"}).priority(fill_prio).obj()
        p.node_name = f"n{i}"
        k.cs.create_pod(p)


def _preemptors(k, prio, keys=()):
    k.cs.create_pod_group(k.group(name="train", min_count=2, topology_keys=keys))
    for i in range(2):
        p = k.pod().name(f"hi-{i}").req({"cpu": "4"}).priority(prio).obj()
        p.pod_group = "train"
        k.cs.create_pod(p)


PREEMPTION_CASES = {
    "preempts-enough-victims": (lambda k: (_full(k, 4), _preemptors(k, 100)), 2),
    "no-preemption-for-lower-priority": (lambda k: (_full(k, 2, 50), _preemptors(k, 10)), 0),
    "placement-constrained-within-domain": (
        lambda k: (_full(k, 4), _preemptors(k, 100, (ZONE,))), 2),
}


@pytest.mark.parametrize("case", list(PREEMPTION_CASES))
def test_pod_group_preemption(case, hints):
    populate, victims = PREEMPTION_CASES[case]
    kits = trio(populate, placement=True, hints=hints)
    port = kits["port"]
    b = port.bindings()
    assert sum(1 for n in b if n.startswith("low-")) == 4 - victims if victims else True
    assert port.sched.preemption_counts()["victims"] == victims
    hi = [n for n in b if n.startswith("hi-")]
    assert all(b[n] for n in hi) == (victims > 0)
    if case == "placement-constrained-within-domain":
        assert len(port.zones_of(hi)) == 1


# -- the Permit barrier ------------------------------------------------------

def _record_waiters(sched):
    """Wrap park/allow: the (event, pod name) sequence of the barrier."""
    seen = []
    park, allow = sched.park_waiting_pod, sched.allow_waiting_pod

    def parked(fw, state, qpi, result):
        seen.append(("park", qpi.pod.name))
        return park(fw, state, qpi, result)

    def allowed(uid):
        name = sched.waiting_pods[uid][2].pod.name if uid in sched.waiting_pods else uid
        seen.append(("allow", name))
        return allow(uid)
    sched.park_waiting_pod, sched.allow_waiting_pod = parked, allowed
    return seen


def test_permit_barrier_parks_members_until_the_group_is_complete(hints):
    """Under the placement profile a committed member waits at Permit until
    min_count members hold reservations; the last one releases the rest.
    The park/allow sequence and the bindings equal the JAX package's."""
    seqs = {}

    def populate(k):
        seqs[k.kind] = _record_waiters(k.sched)
        k.nodes(9, zones=3)
        k.gang("g", 3, keys=(ZONE,))
    kits = trio(populate, placement=True, hints=hints)
    assert seqs["port"] == seqs["jax"] == seqs["host"]
    assert [e for e, _ in seqs["port"]] == ["park", "park", "allow", "allow"]
    assert not kits["port"].sched.waiting_pods and all(kits["port"].bindings().values())


def test_members_parked_at_permit_are_released_by_a_late_member(hints):
    """Three of four members fit (min_count 2): the first two pass the
    barrier, the third parks at Permit, assumed on its node and unbound.
    The fourth requeues alone; once a node is added it is placed, completes
    the count and releases the third. At both points the waiting pods and
    the bindings equal the JAX package's."""
    parked = {}

    def populate(k):
        _partial(k)
        k.sched.run_until_idle()
        parked[k.kind] = ({e[2].pod.name: e[3].suggested_host
                           for e in k.sched.waiting_pods.values()},
                          sorted(p.name for p in k.cs.pods.values() if p.uid in k.cs.bindings))
        _zoned(k, "extra", 1, 2, "z0")
    kits = trio(populate, placement=True, hints=hints)
    assert parked["port"] == parked["jax"] == parked["host"]
    waiting, bound = parked["port"]
    assert len(waiting) == 1 and len(bound) == 2
    assert not kits["port"].sched.waiting_pods and all(kits["port"].bindings().values())
    assert len(kits["port"].cs.bindings) == 4


# -- scope --------------------------------------------------------------------

def test_pod_groups_are_in_scope_but_composite_trees_are_not():
    k = Kit("port")
    k.cs.create_pod_group(PodGroup(name="ok", min_count=1))
    p = make_pod().name("member").req({"cpu": "1"}).obj()
    p.pod_group = "ok"
    k.cs.create_pod(p)  # no longer refused
    with pytest.raises(NotImplementedError, match="parent composite pod group"):
        k.cs.create_pod_group(PodGroup(name="leaf", min_count=1, parent_name="root"))
    with pytest.raises(NotImplementedError, match="composite pod groups"):
        k.cs.create_composite_pod_group(JaxCompositePodGroup(name="root"))


# -- the bench drives, small ----------------------------------------------------

@pytest.mark.parametrize("workload,n_nodes", [
    ("SchedulingGangs/1000Nodes_250Groups", 50),
    ("SchedulingGangsPlacement/5000Nodes_250Groups", 100),
], ids=["gangs", "placement"])
def test_gang_bench_workloads_match_jax(workload, n_nodes, hints):
    """bench.py's gang workloads at 10 groups (the shapes' nodes, fewer of
    them) bind as the JAX TPUScheduler binds the same cluster and groups;
    the placement workload evaluates each group cycle on the device path
    (the kernels' plain versions here) and the gang workload puts no pod
    on the host path."""
    from kubernetes_tpu_torch import bench

    w = bench.WORKLOADS[workload]
    port = bench.build_cluster(n_nodes, device="cpu", node=w.node,
                               profile_factory=bench.profile_for(workload), score_hints=hints)
    bench.warm(port, 0, workload)
    result = bench.measure(port, 40, workload=workload)
    jax_kit = Kit("jax", placement=bool(w.gang.topology_key), hints=hints)
    for i in range(n_nodes):
        jax_kit.cs.create_node(jax_make_node().name(f"node-{i}").capacity(
            {"cpu": w.node.cpu, "memory": w.node.memory, "pods": w.node.pods})
            .zone(f"zone-{i % w.node.zones}").obj())
    for g in range(10):
        jax_kit.cs.create_pod_group(JaxPodGroup(name=f"bench-group-{g}", min_count=4,
                                                topology_keys=(w.gang.topology_key,)
                                                if w.gang.topology_key else ()))
        for j in range(4):
            p = jax_make_pod().name(f"bench-{4 * g + j}").req(
                {"cpu": "500m", "memory": "256Mi"}).obj()
            p.pod_group = f"bench-group-{g}"
            jax_kit.cs.create_pod(p)
    jax_kit.sched.run_until_idle()
    assert {p.name: p.node_name for p in port.clientset.pods.values()} == jax_kit.bindings()
    d = result["detail"]
    assert d["scheduled"] == 40 and d["host_path_pods"] == 0
    if w.gang.topology_key:
        assert d["placement_device_evals"] == 10 and result["vs_baseline"] is None
    else:
        assert d["device_scheduled"] == 40
