"""Volumes in the PyTorch port against the JAX reference, on the CPU.

Kernels: the plain versions of the three schedule kernels with the `has_aux`
lane (lap_schedule, scan_general, schedule_placements) against the JAX package's schedule_batch and schedule_placements on seeded
numpy draws with an attach room of 0 to 3 a row, an increment of 1 or 2 and
a drawn aux_cnt in the carry, fresh and chained: results and every
ScanCarry lane, aux_cnt included, are equal. Features: build_batch's
aux_room, aux_inc and has_aux equal the JAX package's on one cluster.
Scheduler: each scenario of tests/test_volumes.py, and the attach-limit and
host-path cuts of the volume drives, go through the JAX package's
TPUScheduler (CPU JAX, no mesh) and the port's TorchScheduler(device="cpu"),
score hints off in both and on in both: bindings,
device_scheduled, host_path_pods and queue counts are equal. Every
comparison is exact."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from kubernetes_tpu.api import storage as jax_storage
from kubernetes_tpu.api.labels import IN as JAX_IN
from kubernetes_tpu.api.labels import Requirement as JaxRequirement
from kubernetes_tpu.api.types import NodeSelector as JaxNodeSelector
from kubernetes_tpu.api.types import NodeSelectorTerm as JaxNodeSelectorTerm
from kubernetes_tpu.api.types import PodGroup as JaxPodGroup
from kubernetes_tpu.api.types import Volume as JaxVolume
from kubernetes_tpu.core.pv_controller import PVController as JaxPVController
from kubernetes_tpu.models.tpu_scheduler import TPUScheduler
from kubernetes_tpu.ops.device_state import DeviceNodeState as JaxState
from kubernetes_tpu.ops.features import BatchFeatures as JaxFeatures
from kubernetes_tpu.ops.kernel import ScanCarry as JaxCarry
from kubernetes_tpu.ops.kernel import schedule_batch as jax_schedule_batch
from kubernetes_tpu.ops.kernel import schedule_placements as jax_schedule_placements
from kubernetes_tpu.testing.wrappers import make_node as jax_make_node
from kubernetes_tpu.testing.wrappers import make_pod as jax_make_pod
from kubernetes_tpu_torch import bench
from kubernetes_tpu_torch.api import storage
from kubernetes_tpu_torch.api.labels import IN, Requirement
from kubernetes_tpu_torch.api.types import NodeSelector, NodeSelectorTerm, PodGroup, Volume
from kubernetes_tpu_torch.core.pv_controller import PVController
from kubernetes_tpu_torch.models import TorchScheduler
from kubernetes_tpu_torch.ops import kernel as K
from kubernetes_tpu_torch.ops.device_state import state_from_jax_numpy
from kubernetes_tpu_torch.ops.features import AUX_BIG, features_from_jax_numpy
from kubernetes_tpu_torch.ops.kernel import carry_from_jax_numpy
from kubernetes_tpu_torch.testing import make_node, make_pod
from kubernetes_tpu_torch.testing.kernel_inputs import (
    HOST_AXIS,
    aux_lane,
    general_inputs,
    placement_inputs,
    with_aux_lane,
)

ZONE = "topology.kubernetes.io/zone"
VMAX = 256
AUX_CNT = 13  # the aux_cnt lane's position in ScanCarry


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


def _aux_chain(js, jf, ts, tf, batch_pad, strategy, n_active, facts, cnt):
    """A fresh JAX carry whose aux_cnt lane is `cnt` (None: left at zero),
    then two batches chained from it through both packages. Returns
    [(jax results, jax carry, port results, port carry)]."""
    _r, jc = jax_schedule_batch(js, jf, batch_pad, strategy, VMAX, n_active=np.int32(0),
                                **facts)
    jc_np = [np.array(a) for a in jc]
    if cnt is not None:
        jc_np[AUX_CNT] = cnt
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
AUX = {
    "lap": (dict(), 512, 512, "lap_schedule"),          # more pods than room
    "lap-padded": (dict(), 512, 150, "lap_schedule"),
    "lap-hostname-anti": (dict(anti=1, anti_axis=HOST_AXIS), 512, 120, "lap_schedule"),
    "scan": (dict(), 64, 64, "scan_general"),
    "scan-padded": (dict(), 64, 40, "scan_general"),
    "general-spread": (dict(dns=1), 64, 40, "scan_general"),       # full feasibility
    "general-soft-pns": (dict(sa=1, pns=True), 64, 40, "scan_general"),  # incremental
}


@pytest.mark.parametrize("drawn", [False, True], ids=["fresh", "drawn-count"])
@pytest.mark.parametrize("strategy", [0, 1], ids=["least", "most"])
@pytest.mark.parametrize("case", list(AUX))
def test_schedule_batch_with_the_aux_lane(case, strategy, drawn, paths):
    """Each schedule kernel's plain version with has_aux equals the JAX
    package's on every result and carry lane, from a fresh carry or one
    whose aux_cnt is drawn, over two chained batches: no row takes more
    pods than its room leaves, each landing adds aux_inc, and the plan takes
    the path it takes without the lane."""
    lanes, batch_pad, n_active, kernel = AUX[case]
    seed = 81 + strategy + 2 * drawn
    s, f, facts = general_inputs(seed, 256, 200, vmax=VMAX, **lanes)
    room, inc, cnt = aux_lane(seed, 256, 200)
    f = with_aux_lane(f, room, inc)
    facts = dict(facts, has_aux=True)
    js, jf, ts, tf = _convert(s, f)
    start = cnt if drawn else np.zeros(256, np.int32)
    for step, (jr, jc, tr, tc) in enumerate(_aux_chain(js, jf, ts, tf, batch_pad, strategy,
                                                       n_active, facts,
                                                       cnt if drawn else None)):
        np.testing.assert_array_equal(jr, tr.numpy(), err_msg=f"results, batch {step}")
        _same(jc, tc, f"carry, batch {step}")
    landed = np.zeros(256, np.int64)
    for row in tc.aux_cnt.numpy().nonzero()[0]:
        landed[row] = int(tc.aux_cnt[row]) - int(start[row])
    assert (landed >= 0).all() and (landed % int(inc) == 0).all()
    grew = landed > 0
    assert grew.any(), "no pod landed"
    assert (tc.aux_cnt.numpy()[grew] <= room[grew]).all(), "a row took more than its room"
    assert paths == [kernel, kernel]
    assert K.plan_path(tf, K.PlanFacts(**facts), batch_pad) == K.plan_path(
        tf, K.PlanFacts(**dict(facts, has_aux=False)), batch_pad)


def test_aux_lane_with_the_blocked_lane():
    """Both row-local lanes at once (host ports and an attach limit) on the
    lap and the scan path (scan_general), as in JAX."""
    for batch_pad, n_active in ((512, 300), (64, 64)):
        s, f, facts = general_inputs(91, 256, 200, vmax=VMAX)
        room, inc, cnt = aux_lane(91, 256, 200)
        js, jf, ts, tf = _convert(s, with_aux_lane(f, room, inc))
        facts = dict(facts, has_aux=True, port_selfblock=True)
        for jr, jc, tr, tc in _aux_chain(js, jf, ts, tf, batch_pad, 0, n_active, facts, cnt):
            np.testing.assert_array_equal(jr, tr.numpy())
            _same(jc, tc, "carry")


def test_aux_lane_is_inert_without_has_aux():
    """Without has_aux a row past its room stays feasible and the lane rides
    the carry unchanged, as in JAX."""
    s, f, facts = general_inputs(93, 256, 200, vmax=VMAX)
    room, inc, cnt = aux_lane(93, 256, 200)
    js, jf, ts, tf = _convert(s, with_aux_lane(f, np.zeros_like(room), inc))
    for jr, jc, tr, tc in _aux_chain(js, jf, ts, tf, 512, 0, 300, facts, cnt):
        np.testing.assert_array_equal(jr, tr.numpy())
        _same(jc, tc, "carry")
    assert (tr[0] >= 0).sum() > 0
    np.testing.assert_array_equal(tc.aux_cnt.numpy(), cnt)


@pytest.mark.parametrize("tables", [{}, dict(dns=1, sa=1, overrides=True)],
                         ids=["no-tables", "overrides"])
@pytest.mark.parametrize("lanes", [4, 16])
def test_schedule_placements_with_the_aux_lane(lanes, tables):
    """The stacked placement evaluation with has_aux equals JAX's on every
    lane: each lane counts only its own members' attachments, from zero."""
    placed = 0
    for strategy in (0, 1):
        s, f, facts, masks, ov = placement_inputs(95 + lanes, 256, 200, lanes, vmax=VMAX,
                                                  **tables)
        room, inc, _cnt = aux_lane(95 + lanes, 256, 200)
        js, jf, ts, tf = _convert(s, with_aux_lane(f, room, inc))
        t_ov = None if ov is None else tuple(torch.from_numpy(a) for a in ov)
        j_ov = None if ov is None else tuple(jnp.asarray(a) for a in ov)
        want = np.asarray(jax_schedule_placements(
            js, jf, 8, strategy, VMAX, jnp.asarray(masks), n_active=np.int32(6),
            has_pns=facts["has_pns"], has_na_pref=facts["has_na_pref"], has_aux=True,
            spread_overrides=j_ov))
        got = K.schedule_placements(ts, tf, 8, strategy, VMAX,
                                    K.PlanFacts(**dict(facts, has_aux=True)),
                                    torch.from_numpy(masks), 6, t_ov)
        np.testing.assert_array_equal(want, got.numpy(), err_msg=f"strategy {strategy}")
        for lane in got[:, 0, :6]:
            rows = lane[lane >= 0].numpy()
            per_row = np.bincount(rows, minlength=256) * int(inc)
            assert (per_row[rows] <= room[rows]).all(), "a lane overfilled a row's room"
            placed += rows.size
    assert placed > 0


# ---------------------------------------------------------------------------
# the two packages' storage objects
# ---------------------------------------------------------------------------

JAX = SimpleNamespace(
    make_node=jax_make_node, make_pod=jax_make_pod, st=jax_storage, Volume=JaxVolume,
    NodeSelector=JaxNodeSelector, NodeSelectorTerm=JaxNodeSelectorTerm,
    Requirement=JaxRequirement, IN=JAX_IN, PVController=JaxPVController, PodGroup=JaxPodGroup)
PORT = SimpleNamespace(
    make_node=make_node, make_pod=make_pod, st=storage, Volume=Volume,
    NodeSelector=NodeSelector, NodeSelectorTerm=NodeSelectorTerm, Requirement=Requirement,
    IN=IN, PVController=PVController, PodGroup=PodGroup)


def _pinned(kit, node_name):
    return kit.NodeSelector(terms=(kit.NodeSelectorTerm(
        match_fields=(kit.Requirement("metadata.name", kit.IN, (node_name,)),)),))


def _pv_on(kit, name, node_name, capacity="10Gi", sc="fast", **kw):
    return kit.st.PersistentVolume.of(name, capacity, storage_class=sc,
                                      node_affinity=_pinned(kit, node_name), **kw)


def _pod_with_pvc(kit, name, pvc_name, cpu="100m", priority=0):
    p = kit.make_pod().name(name).req({"cpu": cpu}).priority(priority).obj()
    p.volumes.append(kit.Volume(name="data", pvc_name=pvc_name))
    return p


def _bound_claim(kit, cs, name, driver="", modes=("ReadOnlyMany",), namespace="default"):
    """A PV and its claim, pre-bound (the perf harness's pair)."""
    pv = kit.st.PersistentVolume.of(f"pv-{name}", "1Gi", access_modes=modes, csi_driver=driver)
    pvc = kit.st.PersistentVolumeClaim.of(name, "1Gi", access_modes=modes, namespace=namespace)
    pv.claim_ref = pvc.key
    pvc.volume_name = pv.name
    cs.create_pv(pv)
    cs.create_pvc(pvc)


class Pair:
    """The JAX package's TPUScheduler and the port's TorchScheduler."""

    def __init__(self, max_batch=None, controller=False, hints=False):
        self.jax = TPUScheduler(mesh=None, max_batch=max_batch)
        self.jax._hints.enabled = hints
        self.port = TorchScheduler(device="cpu", max_batch=max_batch, score_hints=hints)
        self.sides = ((self.jax, JAX), (self.port, PORT))
        self.controllers = ([kit.PVController(s.clientset) for s, kit in self.sides]
                            if controller else None)

    def each(self, fn):
        """fn(scheduler, kit) on both, then drain."""
        for s, kit in self.sides:
            fn(s, kit)
            s.run_until_idle()

    def check(self, device=True):
        a = {p.name: p.node_name for p in self.jax.clientset.pods.values()}
        b = {p.name: p.node_name for p in self.port.clientset.pods.values()}
        diffs = {k: (v, b.get(k)) for k, v in a.items() if b.get(k) != v}
        assert not diffs and set(a) == set(b), f"JAX/port divergence: {diffs}"
        for c in ("scheduled", "failures", "device_scheduled", "host_path_pods"):
            assert getattr(self.jax, c) == getattr(self.port, c), c
        assert self.jax.queue.pending_counts() == self.port.queue.pending_counts()
        if device:
            assert self.port.device_scheduled > 0
        return b


def _nodes(n, cpu="4", zones=0, pods=10):
    def build(s, kit):
        for i in range(n):
            b = kit.make_node().name(f"n{i}").capacity({"cpu": cpu, "memory": "16Gi",
                                                        "pods": pods})
            if zones:
                b = b.zone(f"z{i % zones}")
            s.clientset.create_node(b.obj())
    return build


# ---------------------------------------------------------------------------
# the scenarios of tests/test_volumes.py
# ---------------------------------------------------------------------------


def test_bound_pvc_node_affinity(hints):
    pair = Pair(hints=hints)
    pair.each(_nodes(3))

    def w(s, kit):
        s.clientset.create_pv(_pv_on(kit, "pv-1", "n2"))
        s.clientset.create_pvc(kit.st.PersistentVolumeClaim.of(
            "claim", "5Gi", storage_class="fast", volume_name="pv-1"))
        s.clientset.create_pod(_pod_with_pvc(kit, "p", "claim"))
    pair.each(w)
    assert pair.check(device=False) == {"p": "n2"}
    assert pair.port.host_path_pods == 1


def test_unbound_immediate_is_unresolvable(hints):
    pair = Pair(hints=hints)
    pair.each(_nodes(1))

    def w(s, kit):
        s.clientset.create_storage_class(kit.st.StorageClass(name="std", provisioner="x"))
        s.clientset.create_pvc(kit.st.PersistentVolumeClaim.of("c", "1Gi", storage_class="std"))
        s.clientset.create_pod(_pod_with_pvc(kit, "p", "c"))
    pair.each(w)
    assert pair.check(device=False) == {"p": ""}
    assert pair.port.failures >= 1 and pair.port.queue.pending_counts() == (0, 0, 1)


def test_wait_for_first_consumer_binds_pv(hints):
    pair = Pair(hints=hints)
    pair.each(_nodes(2))

    def w(s, kit):
        s.clientset.create_storage_class(kit.st.StorageClass(
            name="wffc", volume_binding_mode=kit.st.WAIT_FOR_FIRST_CONSUMER))
        s.clientset.create_pv(_pv_on(kit, "pv-a", "n1", sc="wffc"))
        s.clientset.create_pvc(kit.st.PersistentVolumeClaim.of("c", "5Gi", storage_class="wffc"))
        s.clientset.create_pod(_pod_with_pvc(kit, "p", "c"))
    pair.each(w)
    assert pair.check(device=False) == {"p": "n1"}
    pvc = pair.port.clientset.pvcs["default/c"]
    assert pvc.volume_name == "pv-a" and pair.port.clientset.pvs["pv-a"].claim_ref == "default/c"


def test_wffc_dynamic_provisioning(hints):
    pair = Pair(hints=hints)
    pair.each(_nodes(1))

    def w(s, kit):
        s.clientset.create_storage_class(kit.st.StorageClass(
            name="wffc", provisioner="csi.example.com",
            volume_binding_mode=kit.st.WAIT_FOR_FIRST_CONSUMER))
        s.clientset.create_pvc(kit.st.PersistentVolumeClaim.of("c", "5Gi", storage_class="wffc"))
        s.clientset.create_pod(_pod_with_pvc(kit, "p", "c"))
    pair.each(w)
    assert pair.check(device=False) == {"p": "n0"}
    assert pair.port.clientset.pvcs["default/c"].volume_name.startswith("pvc-")


def test_two_claims_one_pv_conflict(hints):
    """The second pod must not reuse the PV the first pod's claim assumed."""
    pair = Pair(hints=hints)
    pair.each(_nodes(2))

    def w(s, kit):
        s.clientset.create_storage_class(kit.st.StorageClass(
            name="wffc", volume_binding_mode=kit.st.WAIT_FOR_FIRST_CONSUMER))
        s.clientset.create_pv(_pv_on(kit, "only-pv", "n0", sc="wffc"))
        for i in (1, 2):
            s.clientset.create_pvc(kit.st.PersistentVolumeClaim.of(f"c{i}", "1Gi",
                                                                   storage_class="wffc"))
        for i in (1, 2):
            s.clientset.create_pod(_pod_with_pvc(kit, f"p{i}", f"c{i}"))
    pair.each(w)
    bound = pair.check(device=False)
    assert sum(1 for v in bound.values() if v) == 1


def test_zone_mismatch_rejected(hints):
    pair = Pair(hints=hints)
    pair.each(_nodes(2, zones=2))

    def w(s, kit):
        s.clientset.create_pv(kit.st.PersistentVolume.of("pv-z", "10Gi", storage_class="fast",
                                                         labels={ZONE: "z1"}))
        s.clientset.create_pvc(kit.st.PersistentVolumeClaim.of(
            "c", "5Gi", storage_class="fast", volume_name="pv-z"))
        s.clientset.create_pod(_pod_with_pvc(kit, "p", "c"))
    pair.each(w)
    assert pair.check(device=False) == {"p": "n1"}


def test_csi_attach_limit_with_provisioning(hints):
    """Limit 1 volume a node for driver csi.x, two WaitForFirstConsumer
    claims of that class: one pod schedules."""
    pair = Pair(hints=hints)
    pair.each(_nodes(1, cpu="8"))

    def w(s, kit):
        s.clientset.create_csi_node(kit.st.CSINode(node_name="n0", driver_limits={"csi.x": 1}))
        s.clientset.create_storage_class(kit.st.StorageClass(
            name="csi", provisioner="csi.x", volume_binding_mode=kit.st.WAIT_FOR_FIRST_CONSUMER))
        for i in range(2):
            s.clientset.create_pvc(kit.st.PersistentVolumeClaim.of(f"c{i}", "1Gi",
                                                                   storage_class="csi"))
            s.clientset.create_pod(_pod_with_pvc(kit, f"p{i}", f"c{i}"))
    pair.each(w)
    bound = pair.check(device=False)
    assert sum(1 for v in bound.values() if v) == 1


def test_rwop_conflict(hints):
    pair = Pair(hints=hints)
    pair.each(_nodes(1, cpu="8"))

    def w(s, kit):
        s.clientset.create_pv(_pv_on(kit, "pv-1", "n0"))
        s.clientset.create_pvc(kit.st.PersistentVolumeClaim.of(
            "c", "1Gi", storage_class="fast", volume_name="pv-1", access_modes=(kit.st.RWOP,)))
        for i in (1, 2):
            s.clientset.create_pod(_pod_with_pvc(kit, f"p{i}", "c"))
    pair.each(w)
    bound = pair.check(device=False)
    assert sum(1 for v in bound.values() if v) == 1


def test_rwop_conflict_resolved_by_preemption(hints):
    """The RWOP count rides the cycle state: the host dry run evicts the
    claim's current user (volumerestrictions AddPod/RemovePod)."""
    pair = Pair(hints=hints)
    pair.each(_nodes(1, cpu="8"))

    def w(s, kit):
        s.clientset.create_pv(_pv_on(kit, "pv-1", "n0"))
        s.clientset.create_pvc(kit.st.PersistentVolumeClaim.of(
            "c", "1Gi", storage_class="fast", volume_name="pv-1", access_modes=(kit.st.RWOP,)))
        s.clientset.create_pod(_pod_with_pvc(kit, "low", "c", priority=1))
    pair.each(w)

    def high(s, kit):
        s.clientset.create_pod(_pod_with_pvc(kit, "high", "c", priority=100))
        for _ in range(3):
            s.run_until_idle()
    pair.each(high)
    bound = pair.check(device=False)
    assert bound == {"high": "n0"}
    assert pair.port.preemption_counts()["victims"] == 1
    assert pair.port.preemption_device_evals == 0


def test_pv_controller_binds_immediate_claims(hints):
    pair = Pair(controller=True, hints=hints)
    pair.each(_nodes(1, cpu="8"))

    def w(s, kit):
        s.clientset.create_storage_class(kit.st.StorageClass(name="std"))
        s.clientset.create_pv(kit.st.PersistentVolume.of("big", "10Gi", storage_class="std"))
        s.clientset.create_pv(kit.st.PersistentVolume.of("small", "2Gi", storage_class="std"))
        s.clientset.create_pvc(kit.st.PersistentVolumeClaim.of("data", "1Gi",
                                                               storage_class="std"))
        s.clientset.create_pod(_pod_with_pvc(kit, "p", "data", cpu="1"))
    pair.each(w)
    assert pair.check() == {"p": "n0"}
    pvc = pair.port.clientset.pvcs["default/data"]
    assert pvc.volume_name == "small" and pvc.annotations[storage.BIND_COMPLETED] == "true"
    assert [c.binds for c in pair.controllers] == [1, 1]


def test_pv_controller_wffc_provisions_on_selected_node(hints):
    pair = Pair(controller=True, hints=hints)
    pair.each(_nodes(3, cpu="8"))

    def w(s, kit):
        s.clientset.create_storage_class(kit.st.StorageClass(
            name="wffc", volume_binding_mode=kit.st.WAIT_FOR_FIRST_CONSUMER,
            provisioner="csi.example.com"))
        s.clientset.create_pvc(kit.st.PersistentVolumeClaim.of("data", "1Gi",
                                                               storage_class="wffc"))
        s.clientset.create_pod(_pod_with_pvc(kit, "p", "data", cpu="1"))
    pair.each(w)
    node = pair.check(device=False)["p"]
    cs = pair.port.clientset
    pvc = cs.pvcs["default/data"]
    pv = cs.pvs[pvc.volume_name]
    assert [c.provisions for c in pair.controllers] == [1, 1]
    assert pvc.annotations[storage.SELECTED_NODE] == node and pv.csi_driver == "csi.example.com"
    assert pv.node_affinity.matches(cs.nodes[node])


def test_bound_pvc_pods_ride_the_device(hints):
    """Bound claims without node affinity, zone labels or limits impose no
    per-node constraint: 60 pods on the device, none on the host path."""
    pair = Pair(hints=hints)
    pair.each(_nodes(30, cpu="8", pods=110))

    def w(s, kit):
        for i in range(60):
            _bound_claim(kit, s.clientset, f"pvc-{i}")
            s.clientset.create_pod(_pod_with_pvc(kit, f"vp-{i}", f"pvc-{i}"))
    pair.each(w)
    pair.check()
    assert pair.port.device_scheduled == 60 and pair.port.host_path_pods == 0


def _csi_cluster(n_nodes, limit, zones=0):
    def build(s, kit):
        _nodes(n_nodes, cpu="8", pods=110, zones=zones)(s, kit)
        for i in range(n_nodes):
            s.clientset.create_csi_node(kit.st.CSINode(node_name=f"n{i}",
                                                       driver_limits={"csi.x": limit}))
    return build


def _csi_pods(n, prefix="vp", build=None):
    def create(s, kit):
        for i in range(n):
            _bound_claim(kit, s.clientset, f"{prefix}-c{i}", driver="csi.x")
            b = kit.make_pod().name(f"{prefix}-{i}").req({"cpu": "100m", "memory": "64Mi"})
            p = (build(b) if build else b).obj()
            p.volumes.append(kit.Volume(name="data", pvc_name=f"{prefix}-c{i}"))
            s.clientset.create_pod(p)
    return create


def test_csi_attach_limits_enforced_on_the_device(paths, hints):
    """The kernels' counted aux lane: limit 2 on 3 nodes, 6 of 8 pods bind,
    on the device, as in JAX."""
    pair = Pair(hints=hints)
    pair.each(_csi_cluster(3, 2))
    pair.each(_csi_pods(8))
    bound = pair.check()
    assert sum(1 for v in bound.values() if v) == 6
    assert pair.port.device_scheduled >= 6 and "lap_schedule" in paths


def test_shared_claim_pods_fall_back_to_host(hints):
    """Two pods sharing one bound claim: the kernels would count the claim
    twice, so the second takes the host path; both schedule."""
    pair = Pair(hints=hints)
    pair.each(_csi_cluster(4, 5))

    def w(s, kit):
        _bound_claim(kit, s.clientset, "shared", driver="csi.x")
        for i in range(2):
            s.clientset.create_pod(_pod_with_pvc(kit, f"sh-{i}", "shared"))
    pair.each(w)
    bound = pair.check()
    assert all(bound.values()) and pair.port.host_path_pods == 1


# ---------------------------------------------------------------------------
# build_batch's aux lane against the JAX package's
# ---------------------------------------------------------------------------


def _features_cluster(s, kit):
    """Six nodes: n0 allows 39 ebs and 5 other attachments, n1 0 ebs, n2
    has no CSINode, n3 2 ebs, n4 only another driver, n5 39 ebs; bound pods
    hold claims of both drivers (one through its storage class's
    provisioner) on n0, n3 and n4."""
    cs = s.clientset
    for i in range(6):
        cs.create_node(kit.make_node().name(f"n{i}").capacity(
            {"cpu": "8", "memory": "16Gi", "pods": 110}).obj())
    limits = {"n0": {"ebs": 39, "other": 5}, "n1": {"ebs": 0}, "n3": {"ebs": 2},
              "n4": {"other": 1}, "n5": {"ebs": 39}}
    for node, lim in limits.items():
        cs.create_csi_node(kit.st.CSINode(node_name=node, driver_limits=lim))
    cs.create_storage_class(kit.st.StorageClass(name="ebs-class", provisioner="ebs"))
    existing = [("n0", "ebs"), ("n0", "other"), ("n0", "ebs"), ("n3", "ebs"),
                ("n4", "other"), ("n3", "class")]
    for i, (node, driver) in enumerate(existing):
        if driver == "class":
            pv = kit.st.PersistentVolume.of(f"pv-e{i}", "1Gi", storage_class="ebs-class")
            pvc = kit.st.PersistentVolumeClaim.of(f"e{i}", "1Gi", storage_class="ebs-class")
            pv.claim_ref, pvc.volume_name = pvc.key, pv.name
            cs.create_pv(pv)
            cs.create_pvc(pvc)
        else:
            _bound_claim(kit, cs, f"e{i}", driver=driver)
        p = _pod_with_pvc(kit, f"existing-{i}", f"e{i}")
        p.node_name = node
        cs.create_pod(p)


@pytest.mark.parametrize("claims", [("ebs",), ("ebs", "ebs"), ("other",), ("",)],
                         ids=["one-ebs", "two-ebs", "other-driver", "no-driver"])
def test_build_batch_aux_lane_like_jax(claims):
    """build_batch's aux_room, aux_inc and has_aux equal the JAX package's:
    the room is each limited row's limit less its existing claims of the
    driver, AUX_BIG where no limit applies, at least 0."""
    plans = []
    for s, kit in ((TPUScheduler(mesh=None), JAX), (TorchScheduler(device="cpu"), PORT)):
        _features_cluster(s, kit)
        pod = kit.make_pod().name("batch").req({"cpu": "100m"}).obj()
        for j, driver in enumerate(claims):
            _bound_claim(kit, s.clientset, f"b{j}", driver=driver)
            pod.volumes.append(kit.Volume(name=f"d{j}", pvc_name=f"b{j}"))
        fw = s.profiles["default-scheduler"]
        _state, plan = s.build_plan(fw, pod, 8)
        plans.append(plan)
    jplan, tplan = plans
    np.testing.assert_array_equal(np.asarray(jplan.features.aux_room),
                                  tplan.features.aux_room.numpy())
    assert int(np.asarray(jplan.features.aux_inc)) == int(tplan.features.aux_inc)
    assert jplan.has_aux == tplan.facts.has_aux == (claims[0] != "")
    if claims == ("ebs",):
        room = tplan.features.aux_room.numpy()[:6].tolist()
        assert room == [37, 0, AUX_BIG, 0, AUX_BIG, 39]


# ---------------------------------------------------------------------------
# the volume drives' cuts (chip_smoke.py's parity cells, at CPU size)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("max_batch,spread,kernel,want", [
    (None, False, "lap_schedule", 60),
    (64, False, "scan_general", 60),
    (64, True, "scan_general", 55),
], ids=["lap", "scan", "general-spread"])
def test_attach_limit_cut_like_jax(max_batch, spread, kernel, want, paths, hints):
    """30 nodes with an attach limit of 2 and 10 init pods, then 55 pods
    (60 slots for 65): the last pods fail NodeVolumeLimits on the host
    rerun (with a zone spread over 10 zones, the full zones' pods fail it
    beside PodTopologySpread); bindings and counts equal JAX's on each
    kernel."""
    build = None
    if spread:
        def build(b):
            return b.labels({"app": "v"}).spread_constraint(1, ZONE, "DoNotSchedule",
                                                            {"app": "v"})
    pair = Pair(max_batch=max_batch, hints=hints)
    pair.each(_csi_cluster(30, 2, zones=10 if spread else 0))
    pair.each(_csi_pods(10, prefix="init"))
    pair.each(_csi_pods(55, build=build))
    bound = pair.check()
    assert sum(1 for v in bound.values() if v) == want
    assert kernel in paths and pair.port.failures > 0
    pending = pair.port.queue.unschedulable
    assert pending and all("NodeVolumeLimits" in q.unschedulable_plugins
                           for q in pending.values())


def test_volume_session_never_resumes_for_plain_pods(hints):
    """A wave of attach-limited volume pods, then a wave of plain pods of
    the same spec, then volume pods again: the attach shape in the resume
    key keeps each wave on its own plan, and the plan acquisitions equal
    JAX's."""
    pair = Pair(hints=hints)
    pair.each(_csi_cluster(20, 3))
    pair.each(_csi_pods(30, prefix="w1"))

    def plain(s, kit):
        for i in range(30):
            s.clientset.create_pod(kit.make_pod().name(f"plain-{i}")
                                   .req({"cpu": "100m", "memory": "64Mi"}).obj())
    pair.each(plain)
    pair.each(_csi_pods(20, prefix="w2"))
    pair.check()
    for c in ("plan_rebuilds_full", "plan_rebuilds_delta", "plan_rebuilds_resume"):
        assert getattr(pair.port, c) == getattr(pair.jax, c), c
    assert pair.port.plan_rebuilds_resume == 0


def test_wffc_host_path_cut_like_jax(hints):
    """The host-path cut: 20 pods with unbound WaitForFirstConsumer claims,
    half matched by available PVs pinned to nodes, half provisioned by the
    attached PV controller."""
    pair = Pair(controller=True, hints=hints)
    pair.each(_nodes(10, cpu="8", pods=110))

    def w(s, kit):
        cs = s.clientset
        cs.create_storage_class(kit.st.StorageClass(
            name="local", volume_binding_mode=kit.st.WAIT_FOR_FIRST_CONSUMER))
        cs.create_storage_class(kit.st.StorageClass(
            name="dyn", volume_binding_mode=kit.st.WAIT_FOR_FIRST_CONSUMER,
            provisioner="csi.example.com"))
        for i in range(20):
            sc = "local" if i % 2 == 0 else "dyn"
            if sc == "local":
                cs.create_pv(_pv_on(kit, f"local-{i}", f"n{i % 10}", capacity="2Gi", sc="local"))
            cs.create_pvc(kit.st.PersistentVolumeClaim.of(f"w{i}", "1Gi", storage_class=sc))
            cs.create_pod(_pod_with_pvc(kit, f"wp-{i}", f"w{i}"))
    pair.each(w)
    bound = pair.check(device=False)
    assert all(bound.values()) and pair.port.host_path_pods == 20
    assert [c.provisions for c in pair.controllers] == [10, 10]
    cs = pair.port.clientset
    for i in range(0, 20, 2):
        assert cs.pvcs[f"default/w{i}"].volume_name.startswith("local-")


def test_volume_gangs_ride_the_gang_session_like_jax(hints):
    """Pod groups whose members each hold their own attach-limited claim
    ride gang device sessions, as in JAX."""
    pair = Pair(hints=hints)
    pair.each(_csi_cluster(12, 2))

    def groups(s, kit):
        for g in range(4):
            s.clientset.create_pod_group(kit.PodGroup(name=f"g{g}", min_count=4))
            for j in range(4):
                _bound_claim(kit, s.clientset, f"g{g}-c{j}", driver="csi.x")
                p = _pod_with_pvc(kit, f"g{g}-{j}", f"g{g}-c{j}")
                p.pod_group = f"g{g}"
                s.clientset.create_pod(p)
    pair.each(groups)
    bound = pair.check()
    assert all(bound.values()) and pair.port.host_path_pods == 0


def test_bench_csi_attach_limit_at_small_size():
    """bench's CSIAttachLimit/5000Nodes_9000Pods shape on 60 nodes: every
    init and measured pod (and the one scheduled before the window) binds
    on the device, no node past its limit of 3."""
    w = bench.WORKLOADS["CSIAttachLimit/5000Nodes_9000Pods"]
    sched = bench.build_cluster(60, device="cpu", node=w.node)
    bench.warm(sched, 60, "CSIAttachLimit/5000Nodes_9000Pods")
    result = bench.measure(sched, 110, workload="CSIAttachLimit/5000Nodes_9000Pods")
    pods = list(sched.clientset.pods.values())
    assert len(pods) == 171 and all(p.node_name for p in pods)
    per_node = {}
    for p in pods:
        per_node[p.node_name] = per_node.get(p.node_name, 0) + 1
    assert max(per_node.values()) <= 3
    assert result["detail"]["host_path_pods"] == 0 and result["detail"]["failures"] == 0


def test_volume_gang_never_joins_a_plain_gang_session_like_jax(hints):
    """A gang session whose head group has no attach limit takes no group
    of attach-limited members: its plan has no aux lane, so they would land
    past the CSINode limit of 1. The plain gang binds; the six-member
    volume gang, which three attachment slots cannot hold, stays pending
    after its host group cycle, in both packages."""
    pair = Pair(hints=hints)
    pair.each(_csi_cluster(3, 1))

    def groups(s, kit):
        s.clientset.create_pod_group(kit.PodGroup(name="plain", min_count=2))
        for j in range(2):
            p = kit.make_pod().name(f"plain-{j}").req({"cpu": "100m"}).obj()
            p.pod_group = "plain"
            s.clientset.create_pod(p)
        s.clientset.create_pod_group(kit.PodGroup(name="vol", min_count=6))
        for j in range(6):
            _bound_claim(kit, s.clientset, f"vol-c{j}", driver="csi.x")
            p = _pod_with_pvc(kit, f"vol-{j}", f"vol-c{j}")
            p.pod_group = "vol"
            s.clientset.create_pod(p)
    pair.each(groups)
    bound = pair.check()
    assert {k for k, v in bound.items() if v} == {"plain-0", "plain-1"}
    assert pair.port.host_path_pods == 6
