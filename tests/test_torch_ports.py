"""NodePorts in the PyTorch port against the JAX reference, on the CPU.

Kernels: the plain versions of the three schedule kernels with the
`port_selfblock` lane (lap_schedule, scan_general, schedule_placements)
against the JAX package's schedule_batch and schedule_placements on seeded
numpy draws, from a carry whose `blocked` lane is drawn at random, fresh
and chained: results and every ScanCarry lane, `blocked` included, are
equal. Scheduler: pods with host ports go
through the JAX package's TPUScheduler (CPU JAX, no mesh) and the port's
TorchScheduler(device="cpu"), score hints off in both and on in both, on
each kernel path, against existing pods' ports (the 0.0.0.0 wildcard,
TCP against UDP), through resume and through the four faults the slice
repaired. Every comparison is exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from kubernetes_tpu.api.types import Namespace as JaxNamespace
from kubernetes_tpu.api.types import PodGroup as JaxPodGroup
from kubernetes_tpu.core.registry import gang_placement_profiles
from kubernetes_tpu.models.tpu_scheduler import TPUScheduler
from kubernetes_tpu.ops.device_state import DeviceNodeState as JaxState
from kubernetes_tpu.ops.features import BatchFeatures as JaxFeatures
from kubernetes_tpu.ops.kernel import ScanCarry as JaxCarry
from kubernetes_tpu.ops.kernel import _static_masks as jax_static_masks
from kubernetes_tpu.ops.kernel import schedule_batch as jax_schedule_batch
from kubernetes_tpu.ops.kernel import schedule_placements as jax_schedule_placements
from kubernetes_tpu.testing.wrappers import make_node as jax_make_node
from kubernetes_tpu.testing.wrappers import make_pod as jax_make_pod
from kubernetes_tpu_torch.api.types import Namespace, PodGroup
from kubernetes_tpu_torch.core.registry import default_profile, gang_placement_profile
from kubernetes_tpu_torch.models import TorchScheduler
from kubernetes_tpu_torch.ops import kernel as K
from kubernetes_tpu_torch.ops.device_state import state_from_jax_numpy
from kubernetes_tpu_torch.ops.features import features_from_jax_numpy
from kubernetes_tpu_torch.ops.kernel import carry_from_jax_numpy
from kubernetes_tpu_torch.testing import make_node, make_pod
from kubernetes_tpu_torch.testing.kernel_inputs import (
    HOST_AXIS,
    general_inputs,
    placement_inputs,
    random_inputs,
)

ZONE = "topology.kubernetes.io/zone"
VMAX = 256


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
# the kernels' plain versions against the JAX package
# ---------------------------------------------------------------------------


def _convert(s, f):
    js = JaxState(*[jnp.asarray(a) for a in s])
    jf = JaxFeatures(*[jnp.asarray(a) for a in f])
    return js, jf, state_from_jax_numpy(s), features_from_jax_numpy(f)


def _same(jax_arrays, torch_arrays, what):
    for i, (a, b) in enumerate(zip(jax_arrays, torch_arrays)):
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, (what, i, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"{what} lane {i}")


@pytest.fixture
def paths(monkeypatch):
    """The plain kernel versions schedule_batch ran."""
    seen = []
    for name in ("_lap_schedule_plain", "_scan_general_plain"):
        fn = getattr(K, name)
        monkeypatch.setattr(K, name, lambda *a, _fn=fn, _n=name[1:-6], **kw:
                            seen.append(_n) or _fn(*a, **kw))
    return seen


def _blocked_chain(js, jf, ts, tf, batch_pad, strategy, n_active, facts, seed):
    """A fresh JAX carry with a random third of its rows blocked, then two
    batches chained from it through both packages. Returns [(jax results,
    jax carry, port results, port carry)]."""
    _r, jc = jax_schedule_batch(js, jf, batch_pad, strategy, VMAX, n_active=np.int32(0),
                                **facts)
    jc_np = [np.array(a) for a in jc]
    rng = np.random.default_rng(seed)
    jc_np[12] = rng.random(jc_np[12].shape[0]) < 0.3
    tc = carry_from_jax_numpy(jc_np)
    jc = JaxCarry(*[jnp.asarray(a) for a in jc_np])
    out = []
    for _ in range(2):
        jr, jc_new = jax_schedule_batch(js, jf, batch_pad, strategy, VMAX,
                                        n_active=np.int32(n_active), carry_in=jc, **facts)
        jr, jc_np = np.asarray(jr), [np.asarray(a) for a in jc_new]
        tr, tc = K.schedule_batch(ts, tf, batch_pad, strategy, VMAX, K.PlanFacts(**facts),
                                  n_active=n_active, carry_in=tc)
        out.append((jr, jc_np, tr, tc))
        jc = JaxCarry(*[jnp.asarray(a) for a in jc_np])
    return out


# (draw arguments of general_inputs, steps, active pods, the kernel it takes)
BLOCKED = {
    "lap": (dict(), 512, 512, "lap_schedule"),          # more pods than rows
    "lap-padded": (dict(), 512, 150, "lap_schedule"),
    "lap-hostname-anti": (dict(anti=1, anti_axis=HOST_AXIS), 512, 120, "lap_schedule"),
    "scan": (dict(), 64, 64, "scan_general"),
    "scan-padded": (dict(), 64, 40, "scan_general"),
    "general-spread": (dict(dns=1), 64, 40, "scan_general"),       # full feasibility
    "general-soft-pns": (dict(sa=1, pns=True), 64, 40, "scan_general"),  # incremental
}


@pytest.mark.parametrize("strategy", [0, 1], ids=["least", "most"])
@pytest.mark.parametrize("case", list(BLOCKED))
def test_schedule_batch_with_the_blocked_lane(case, strategy, paths):
    """Each schedule kernel's plain version with port_selfblock equals the
    JAX package's on every result and carry lane, from a pre-blocked carry,
    fresh and chained: no pod lands on a blocked row, every landing blocks
    its row, and the plan takes the path it takes without the lane."""
    lanes, batch_pad, n_active, kernel = BLOCKED[case]
    s, f, facts = general_inputs(51 + strategy, 256, 200, vmax=VMAX, **lanes)
    facts = dict(facts, port_selfblock=True)
    js, jf, ts, tf = _convert(s, f)
    blocked0 = None
    for step, (jr, jc, tr, tc) in enumerate(_blocked_chain(js, jf, ts, tf, batch_pad, strategy,
                                                           n_active, facts, 61 + strategy)):
        np.testing.assert_array_equal(jr, tr.numpy(), err_msg=f"results, batch {step}")
        _same(jc, tc, f"carry, batch {step}")
        rows = jr[0][jr[0] >= 0]
        assert len(set(rows.tolist())) == len(rows), "two pods of a port plan share a row"
        assert tc.blocked[torch.from_numpy(rows).long()].all()
        if blocked0 is not None:
            assert not blocked0[torch.from_numpy(rows).long()].any()
        blocked0 = tc.blocked.clone()
    assert paths == [kernel, kernel]
    assert K.plan_path(tf, K.PlanFacts(**facts), batch_pad) == K.plan_path(
        tf, K.PlanFacts(**dict(facts, port_selfblock=False)), batch_pad)


def test_blocked_lane_is_inert_without_port_selfblock():
    """Without port_selfblock a blocked row stays feasible and the lane
    rides the carry unchanged, as in JAX."""
    s, f = random_inputs(55, 256, 200, vmax=VMAX)
    js, jf, ts, tf = _convert(s, f)
    facts = dict(has_pns=False, has_ipa_base=False)
    for jr, jc, tr, tc in _blocked_chain(js, jf, ts, tf, 512, 0, 300, facts, 56):
        np.testing.assert_array_equal(jr, tr.numpy())
        _same(jc, tc, "carry")
    assert int(tc.blocked.sum()) == int(np.asarray(jc[12]).sum()) > 0


def test_static_masks_with_mixed_extra_ok():
    """static_masks folds a mixed extra_ok (NodeDeclaredFeatures and
    NodePorts verdicts) into static_ok as the JAX package does."""
    s, f = random_inputs(57, 256, 200, vmax=VMAX)
    f = list(f)
    f[11] = np.random.default_rng(58).random(256) < 0.6
    js, jf, ts, tf = _convert(s, tuple(f))
    want = jax_static_masks(js, jf)
    got = K.static_masks(ts, tf)
    _same(want, got[:6], "static_masks")
    static_ok = js.valid & want[0] & want[2] & want[3] & want[4] & want[5] & jf.extra_ok
    _same([static_ok], [got.static_ok], "static_ok")
    assert not bool(got.static_ok[~tf.extra_ok].any())


@pytest.mark.parametrize("tables", [{}, dict(dns=1, sa=1, overrides=True)],
                         ids=["no-tables", "overrides"])
@pytest.mark.parametrize("lanes", [4, 16])
def test_schedule_placements_with_the_blocked_lane(lanes, tables):
    """The stacked placement evaluation with port_selfblock equals JAX's
    on every lane: each lane's members block only that lane's rows."""
    placed = 0
    for strategy in (0, 1):
        s, f, facts, masks, ov = placement_inputs(71 + lanes, 256, 200, lanes, vmax=VMAX,
                                                  **tables)
        js, jf, ts, tf = _convert(s, f)
        t_ov = None if ov is None else tuple(torch.from_numpy(a) for a in ov)
        j_ov = None if ov is None else tuple(jnp.asarray(a) for a in ov)
        want = np.asarray(jax_schedule_placements(
            js, jf, 8, strategy, VMAX, jnp.asarray(masks), n_active=np.int32(6),
            has_pns=facts["has_pns"], has_na_pref=facts["has_na_pref"], port_selfblock=True,
            spread_overrides=j_ov))
        got = K.schedule_placements(ts, tf, 8, strategy, VMAX,
                                    K.PlanFacts(**dict(facts, port_selfblock=True)),
                                    torch.from_numpy(masks), 6, t_ov)
        np.testing.assert_array_equal(want, got.numpy(), err_msg=f"strategy {strategy}")
        for lane in got[:, 0, :6]:
            rows = lane[lane >= 0].tolist()
            assert len(set(rows)) == len(rows), "a lane put two port pods on one row"
            placed += len(rows)
    assert placed > 0


# ---------------------------------------------------------------------------
# the scheduler against the JAX package
# ---------------------------------------------------------------------------


class Pair:
    """The JAX package's TPUScheduler and the port's TorchScheduler, each
    with its package's builders."""

    def __init__(self, max_batch=None, placement=False, resume=True, hints=False):
        self.jax = TPUScheduler(mesh=None, max_batch=max_batch,
                                **({"profile_factory": gang_placement_profiles}
                                   if placement else {}))
        self.jax._hints.enabled = hints
        self.port = TorchScheduler(
            device="cpu", max_batch=max_batch, resume=resume, score_hints=hints,
            profile_factory=gang_placement_profile if placement else default_profile)
        self.sides = ((self.jax, jax_make_node, jax_make_pod, JaxPodGroup),
                      (self.port, make_node, make_pod, PodGroup))

    def each(self, fn):
        """fn(scheduler, make_node, make_pod, PodGroup) on both, then drain."""
        for s, mk_node, mk_pod, group in self.sides:
            fn(s, mk_node, mk_pod, group)
            s.run_until_idle()

    def check(self):
        a = {p.name: p.node_name for p in self.jax.clientset.pods.values()}
        b = {p.name: p.node_name for p in self.port.clientset.pods.values()}
        diffs = {k: (v, b.get(k)) for k, v in a.items() if b.get(k) != v}
        assert not diffs and set(a) == set(b), f"JAX/port divergence: {diffs}"
        assert (self.jax.scheduled, self.jax.failures) == (self.port.scheduled,
                                                           self.port.failures)
        assert self.jax.queue.pending_counts() == self.port.queue.pending_counts()
        return b


def _nodes(n, zones=4, cpu=8):
    def build(s, mk_node, _mk_pod, _group):
        for i in range(n):
            s.clientset.create_node(mk_node().name(f"node-{i}").capacity(
                {"cpu": cpu, "memory": "16Gi", "pods": 110}).zone(f"zone-{i % zones}").obj())
    return build


def _port_pods(n, prefix="p", port=8080, build=None, namespace="default"):
    def create(s, _mk_node, mk_pod, _group):
        for i in range(n):
            b = (mk_pod().name(f"{prefix}-{i}").namespace(namespace)
                 .req({"cpu": "500m", "memory": "256Mi"}).host_port(port))
            s.clientset.create_pod((build(b) if build else b).obj())
    return create


def _bound_port_pod(name, node, port=8080, protocol="TCP", host_ip=""):
    """A pod already bound to `node` that holds a host port."""
    def create(s, _mk_node, mk_pod, _group):
        p = (mk_pod().name(name).req({"cpu": "100m"})
             .host_port(port, protocol, host_ip).obj())
        p.node_name = node
        s.clientset.create_pod(p)
    return create


def _no_shared_port(bound):
    nodes = [n for n in bound.values() if n]
    assert len(nodes) == len(set(nodes)), "two pods holding one port share a node"


# (max_batch, nodes, pods, extra pod build, the kernel the sessions take)
PORT_PATHS = {
    "lap": (None, 40, 48, None, "lap_schedule"),
    "scan": (64, 30, 36, None, "scan_general"),
    "general-spread": (64, 40, 48, lambda b: b.labels({"app": "agent"}).spread_constraint(
        1, ZONE, "DoNotSchedule", {"app": "agent"}), "scan_general"),
}


@pytest.mark.parametrize("case", list(PORT_PATHS))
def test_host_port_pods_bind_like_jax(case, paths, hints):
    """Pods holding one host port, more than the nodes: one a node (the
    node that already holds the port excluded), the rest unschedulable with
    a NodePorts diagnosis, exactly as the JAX package binds them."""
    max_batch, n, n_pods, build, kernel = PORT_PATHS[case]
    pair = Pair(max_batch=max_batch, hints=hints)
    pair.each(_nodes(n))
    pair.each(_bound_port_pod("holder", "node-3"))
    pair.each(_port_pods(n_pods, build=build))
    bound = pair.check()
    _no_shared_port(bound)
    if build is None:
        assert sum(1 for v in bound.values() if v) == n  # the holder and n - 1 pods
    assert kernel in paths
    assert pair.port.device_scheduled > 0 and pair.port.failures > 0
    assert bound["holder"] == "node-3"


def test_host_port_gangs_with_placements(hints):
    """Pod groups whose members request hostPort 9000, constrained to a
    zone, under the placement plugins: the device evaluates every group's
    placements with the blocked lane, and the bindings equal JAX's (two
    groups a zone fit, the rest do not)."""
    pair = Pair(placement=True, hints=hints)
    pair.each(_nodes(24, zones=3))

    def groups(s, _mk_node, mk_pod, group):
        for g in range(8):
            s.clientset.create_pod_group(group(name=f"g{g}", min_count=4,
                                               topology_keys=(ZONE,)))
            for j in range(4):
                p = mk_pod().name(f"g{g}-{j}").req({"cpu": "1", "memory": "1Gi"}) \
                    .host_port(9000).obj()
                p.pod_group = f"g{g}"
                s.clientset.create_pod(p)
    pair.each(groups)
    bound = pair.check()
    _no_shared_port(bound)
    assert sum(1 for v in bound.values() if v) == 24
    assert pair.port.placement_device_evals > 0


@pytest.mark.parametrize("existing,want", [
    (("0.0.0.0", "TCP"), False),     # the wildcard conflicts with any address
    (("10.0.0.1", "TCP"), True),     # another address: no conflict
    (("10.0.0.2", "TCP"), False),    # the same address
    (("", "UDP"), True),             # another protocol: no conflict
], ids=["wildcard", "other-ip", "same-ip", "udp"])
def test_conflicts_with_existing_pods(existing, want, hints):
    """A pod asking for TCP 10.0.0.2:8080 against an existing pod's port on
    node-0: the conflicts of nodeports.go's fitsPorts, as in the JAX
    package."""
    host_ip, protocol = existing
    pair = Pair(hints=hints)
    pair.each(_nodes(2, zones=1))
    pair.each(_bound_port_pod("holder", "node-0", protocol=protocol, host_ip=host_ip))

    def pods(s, _mk_node, mk_pod, _group):
        for i in range(2):
            s.clientset.create_pod(mk_pod().name(f"ip-{i}").req({"cpu": "500m"})
                                   .host_port(8080, "TCP", "10.0.0.2").obj())
    pair.each(pods)
    bound = pair.check()
    assert ("node-0" in {bound["ip-0"], bound["ip-1"]}) == want


def test_host_port_preemptor_takes_the_host_dry_run(hints):
    """Fault 1: a preemptor with host ports is sent to the host dry run (a
    victim's removal frees its port), with the JAX package's victims. On
    node-0 one low-priority pod holds the port (one victim frees it); the
    other nodes hold two pods each. The dry-run kernel, which sees node-0's
    port as static, would evict two pods elsewhere."""
    pair = Pair(hints=hints)
    pair.each(_nodes(4, zones=1, cpu=4))

    def fill(s, _mk_node, mk_pod, _group):
        p = mk_pod().name("low-port").req({"cpu": "4"}).priority(1).host_port(8080).obj()
        p.node_name = "node-0"
        s.clientset.create_pod(p)
        for i in range(1, 4):
            for j in range(2):
                q = mk_pod().name(f"low-{i}-{j}").req({"cpu": "2"}).priority(1).obj()
                q.node_name = f"node-{i}"
                s.clientset.create_pod(q)

    def preemptor(s, _mk_node, mk_pod, _group):
        s.clientset.create_pod(mk_pod().name("hi").req({"cpu": "4"}).priority(100)
                               .host_port(8080).obj())
        for _ in range(5):
            s.run_until_idle()
    pair.each(fill)
    pair.each(preemptor)
    bound = pair.check()
    assert bound["hi"] == "node-0" and "low-port" not in bound
    assert pair.port.preemption_counts()["victims"] == 1
    assert pair.port.preemption_device_evals == 0


def test_pod_ports_event_forces_a_rebuild(hints):
    """Fault 2: a pod holding the port appears on a free node between two
    sessions of a port-aware plan. The plan's extra_ok is stale, so the
    next session rebuilds in full (JAX's classifier refuses the patch)
    and leaves that node alone."""
    pair = Pair(max_batch=64, hints=hints)
    pair.each(_nodes(10))
    pair.each(_port_pods(4, prefix="w1"))
    free = sorted({f"node-{i}" for i in range(10)}
                  - {p.node_name for p in pair.port.clientset.pods.values()})[0]
    full = pair.port.plan_rebuilds_full
    pair.each(_bound_port_pod("holder", free))
    pair.each(_port_pods(6, prefix="w2"))
    bound = pair.check()
    _no_shared_port(bound)
    assert bound["holder"] == free
    assert pair.port.plan_rebuilds_full == full + 1 and pair.port.failures > 0


def test_resume_keeps_the_blocked_lane(hints):
    """A second wave of the same port pods resumes the first wave's plan
    and carry (exact signature, then a namespace-erased one): only the
    carry's blocked lane keeps them off the rows the first wave took, and
    the bindings and plan acquisitions equal JAX's."""
    pair = Pair(max_batch=64, hints=hints)
    for s, ns in ((pair.jax, JaxNamespace), (pair.port, Namespace)):
        s.clientset.create_namespace(ns(name="other"))
    pair.each(_nodes(12))
    pair.each(_port_pods(4, prefix="w1"))
    resumes = pair.port.plan_rebuilds_resume
    pair.each(_port_pods(4, prefix="w2"))
    pair.each(_port_pods(4, prefix="w3", namespace="other"))
    bound = pair.check()
    _no_shared_port(bound)
    assert pair.port.plan_rebuilds_resume == resumes + 2
    for c in ("plan_rebuilds_full", "plan_rebuilds_delta", "plan_rebuilds_resume"):
        assert getattr(pair.port, c) == getattr(pair.jax, c), c


def test_port_aware_placement_plan_is_not_cached(hints):
    """Fault 4: consecutive group cycles of port-holding members. Our own
    binds move no cluster-event version, so a kept plan would keep the
    extra_ok of before the first group's binds and double-book its nodes;
    the port, like JAX, keeps no port-aware plan."""
    pair = Pair(placement=True, hints=hints)
    pair.each(_nodes(8, zones=2))

    def groups(s, _mk_node, mk_pod, group):
        for g in range(4):
            s.clientset.create_pod_group(group(name=f"g{g}", min_count=2,
                                               topology_keys=(ZONE,)))
            for j in range(2):
                # 10m members barely move a node's score: a stale plan
                # would pick the first group's nodes again.
                p = mk_pod().name(f"g{g}-{j}").req({"cpu": "10m"}).host_port(9000).obj()
                p.pod_group = f"g{g}"
                s.clientset.create_pod(p)
    pair.each(groups)
    bound = pair.check()
    _no_shared_port(bound)
    assert all(bound.values())
    assert pair.port.placement_device_evals == 4 and pair.port._placement_plan_cache is None


def test_pods_differing_only_in_ports_never_share_a_batch(hints):
    """NodePorts signs the pod's ports: two pods alike but for their port
    split into two batches (one session each), and bind as in JAX."""
    pair = Pair(hints=hints)
    pair.each(_nodes(6))
    fw = pair.port.profiles["default-scheduler"]
    a = make_pod().name("a").req({"cpu": "500m"}).host_port(8080).obj()
    b = make_pod().name("b").req({"cpu": "500m"}).host_port(9090).obj()
    assert fw.sign_pod(a) != fw.sign_pod(b)
    for p in (a, b):
        pair.port.clientset.create_pod(p)
    fw_, batch, reason = pair.port._collect_batch()
    assert reason is None and [q.pod.name for q in batch] == ["a"]
    pair.port._run_device_session(fw_, batch)
    pair.port.run_until_idle()
    for p in (jax_make_pod().name("a").req({"cpu": "500m"}).host_port(8080).obj(),
              jax_make_pod().name("b").req({"cpu": "500m"}).host_port(9090).obj()):
        pair.jax.clientset.create_pod(p)
    pair.jax.run_until_idle()
    pair.check()
    assert pair.port.device_batches == 2
