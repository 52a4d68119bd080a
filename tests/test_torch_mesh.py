"""The PyTorch port's node-sharded mesh against the JAX reference, on the CPU.

The JAX package shards the node axis over its 8-device virtual CPU mesh
(tests/conftest.py); the port's mesh here is eight (or two, or four) shards
on the CPU (`make_mesh(devices=["cpu"] * S)`), where the sharded lap runs
its three phases' plain versions and the exchanges are real copies.

- The sharded lap: the port's ShardedLap against the JAX package's
  sharded_lap_schedule at S = 2, 4 and 8, fresh and chained, on seeded numpy
  draws with the hazard cases (floored arithmetic, the start's owner past
  shard 0 and a start of 0, shards with no feasible row, padded rows, a
  final lap shorter than L, nothing feasible), and against the port's own
  single-device lap.
- The scheduler: TorchScheduler(device="cpu", mesh=...) against
  TPUScheduler(mesh=make_mesh(n_cells=1)) on tests/test_sharded_mesh.py's
  shapes (the gathered path's chained sessions, the sharded lap's
  production dispatch, a spread and anti-affinity mix), two cells through
  sharded_schedule_batch, and delta resume under the mesh
  (tests/test_incremental_resume.py:194-322's counterparts).

Every comparison is exact: all of it is integer arithmetic."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.models.tpu_scheduler import TPUScheduler
from kubernetes_tpu.ops.device_state import DeviceNodeState as JaxState
from kubernetes_tpu.ops.features import BatchFeatures as JaxFeatures
from kubernetes_tpu.parallel import make_mesh as jax_make_mesh
from kubernetes_tpu.parallel import shard_features as jax_shard_features
from kubernetes_tpu.parallel import shard_node_state as jax_shard_node_state
from kubernetes_tpu.parallel import sharded_lap_schedule as jax_sharded_lap_schedule
from kubernetes_tpu.parallel.mesh import sharded_schedule_batch as jax_sharded_schedule_batch
from kubernetes_tpu.testing.wrappers import make_node as jax_make_node
from kubernetes_tpu.testing.wrappers import make_pod as jax_make_pod
from kubernetes_tpu_torch.models import TorchScheduler
from kubernetes_tpu_torch.ops import kernel as K
from kubernetes_tpu_torch.ops.device_state import DeviceNodeState, state_from_jax_numpy
from kubernetes_tpu_torch.ops.features import BatchFeatures, features_from_jax_numpy
from kubernetes_tpu_torch.parallel import (
    Sharded,
    gather,
    make_mesh,
    shard_features,
    shard_node_state,
    sharded_lap_schedule,
    sharded_schedule_batch,
)
from kubernetes_tpu_torch.testing import make_node, make_pod
from kubernetes_tpu_torch.testing.kernel_inputs import random_inputs

VMAX = 64
NP_CAP, NODES = 256, 200
B = 512
ZONE = "topology.kubernetes.io/zone"
SEL_MATCH = list(BatchFeatures._fields).index("sel_match")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small inputs: one intra-op thread keeps this module from crowding
    the other test workers' CPUs."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# the sharded lap
# ---------------------------------------------------------------------------

# (random_inputs arguments, pods a dispatch, rows [lo, hi) with no feasible row)
LAP_CASES = {
    "default": (dict(), 61, None),
    # to_find 7: L reaches LAP_MAX, every window and boundary lane is live,
    # and 301 pods end on a lap shorter than L.
    "full-windows": (dict(to_find=7), 301, None),
    # The rotation start's row in a later shard (its owner is not shard 0).
    "start-in-late-shard": (dict(start=170, to_find=11), 300, None),
    # start 0: (start - 1) // NPl is -1, the owner clips to shard 0.
    "start-zero": (dict(start=0, to_find=9), 257, None),
    # Rows 128.. infeasible: the upper shards have no feasible row.
    "empty-shards": (dict(to_find=5), 300, (128, NP_CAP)),
    "truncation-off": (dict(to_find=NODES), 45, None),
    # Nothing fits: every lap is clipped to L = 1 and lands nothing.
    "all-infeasible": (dict(infeasible=True), 40, None),
}


def _draw(seed, case):
    kw, n_act, dead = LAP_CASES[case]
    s, f = random_inputs(seed, NP_CAP, NODES, vmax=VMAX, **kw)
    if dead is not None:
        f = list(f)
        f[SEL_MATCH] = f[SEL_MATCH].copy()
        f[SEL_MATCH][dead[0]:dead[1]] = False
    return s, tuple(f), n_act


def _port_lap(s, f, shards, fs, n_act):
    """(fresh results, fresh carry, chained results, chained carry) of the
    port's sharded lap on the CPU, each carry gathered whole."""
    mesh = make_mesh(devices=["cpu"] * shards)
    st = shard_node_state(state_from_jax_numpy(s), mesh)
    ft = shard_features(features_from_jax_numpy(f), mesh)
    lap = sharded_lap_schedule(mesh, B, fs, VMAX)
    o1, c1 = lap(st, ft, n_act)
    fresh = [t.clone() for t in gather(c1)]
    o2, c2 = lap(st, ft, n_act, c1)
    assert c2 is c1, "a chained carry is updated in place"
    return o1.clone(), fresh, o2, list(gather(c2))


def _jax_lap(s, f, shards, fs, n_act):
    mesh = jax_make_mesh(devices=jax.devices()[:shards])
    js = jax_shard_node_state(JaxState(*[jnp.asarray(a) for a in s]), mesh)
    jf = jax_shard_features(JaxFeatures(*[jnp.asarray(a) for a in f]), mesh)
    lap = jax_sharded_lap_schedule(mesh, B, fs, VMAX)
    o1, c1 = lap(js, jf, np.int32(n_act))
    o1, fresh = np.asarray(o1), [np.asarray(a) for a in c1]  # fetch: the chain donates c1
    o2, c2 = lap(js, jf, np.int32(n_act), c1)
    return o1, fresh, np.asarray(o2), [np.asarray(a) for a in c2]


def _same(want, got, what):
    assert len(want) == len(got), what
    for i, (a, b) in enumerate(zip(want, got)):
        a = np.asarray(a)
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (what, i, a.dtype, b.dtype,
                                                           a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=f"{what} lane {i}")


@pytest.mark.parametrize("case", list(LAP_CASES))
@pytest.mark.parametrize("shards", [2, 4, 8])
def test_sharded_lap_matches_jax(shards, case):
    # LeastAllocated throughout: one JAX compile a shard count and carry
    # kind; MostAllocated is held against the one-device lap below.
    fs = 0
    s, f, n_act = _draw(40 + list(LAP_CASES).index(case), case)
    got = _port_lap(s, f, shards, fs, n_act)
    want = _jax_lap(s, f, shards, fs, n_act)
    for i, what in enumerate(("fresh results", "fresh carry", "chained results",
                              "chained carry")):
        _same(want[i] if i % 2 else [want[i]], got[i] if i % 2 else [got[i]],
              f"{what} S={shards} {case}")
    if case == "all-infeasible":
        assert (got[0][0] == -1).all()
    else:
        assert (got[0][0] >= 0).sum() > 0


@pytest.mark.parametrize("case", ["default", "full-windows", "start-in-late-shard",
                                  "empty-shards"])
@pytest.mark.parametrize("shards", [2, 4, 8])
def test_sharded_lap_matches_the_single_device_lap(shards, case):
    """The shards' lap gives what the port's one-device lap gives, under
    both fit strategies."""
    fs = list(LAP_CASES).index(case) % 2
    s, f, n_act = _draw(60 + list(LAP_CASES).index(case), case)
    o1, c1, o2, c2 = _port_lap(s, f, shards, fs, n_act)
    st, ft = state_from_jax_numpy(s), features_from_jax_numpy(f)
    assert K.plan_path(ft, K.PlanFacts(), B) == "lap"
    r1, k1 = K.schedule_batch(st, ft, B, fs, VMAX, K.PlanFacts(), n_active=n_act)
    r2, k2 = K.schedule_batch(st, ft, B, fs, VMAX, K.PlanFacts(), n_active=n_act, carry_in=k1)
    for want, got, what in ((r1, o1, "fresh results"), (k1, c1, "fresh carry"),
                            (r2, o2, "chained results"), (k2, c2, "chained carry")):
        want = [want] if isinstance(want, torch.Tensor) else list(want)
        got = [got] if isinstance(got, torch.Tensor) else got
        _same([t.numpy() for t in want], got, f"{what} S={shards} {case}")


def test_sharded_lap_phases_are_inert_once_done():
    """Laps launched past the last pod change nothing: each phase reads
    `done` and returns (the host reads done once a chunk)."""
    from kubernetes_tpu_torch.parallel.mesh import LapRun

    s, f, n_act = _draw(7, "full-windows")
    mesh = make_mesh(devices=["cpu"] * 4)
    st = shard_node_state(state_from_jax_numpy(s), mesh)
    ft = shard_features(features_from_jax_numpy(f), mesh)
    lap = sharded_lap_schedule(mesh, B, 0, VMAX)
    want, wc = lap(st, ft, n_act)
    run = LapRun(lap, st, ft, n_act, None)
    out, carry = run.run()
    before = [t.clone() for t in gather(carry)] + [out.clone()]
    for _ in range(3):
        run.one_lap()
    assert int(run.shards[0].done) >= n_act
    after = list(gather(carry)) + [out]
    for a, b in zip(before[:3], after[:3]):  # the landed lanes
        assert torch.equal(a, b)
    assert torch.equal(before[-1], after[-1]) and torch.equal(out, want)


def test_plain_phases_run_as_the_wrappers_on_cpu():
    """The ShardedLap's plain mode (how the card's run checks the kernels)
    equals the wrappers' CPU path, and the wrappers count no CPU launch."""
    s, f, n_act = _draw(9, "start-in-late-shard")
    mesh = make_mesh(devices=["cpu"] * 2)
    st = shard_node_state(state_from_jax_numpy(s), mesh)
    ft = shard_features(features_from_jax_numpy(f), mesh)
    lap = sharded_lap_schedule(mesh, B, 1, VMAX)
    K.reset_launch_counts()
    o1, c1 = lap(st, ft, n_act)
    o2, c2 = lap.plain(st, ft, n_act)
    assert torch.equal(o1, o2)
    for a, b in zip(gather(c1), gather(c2)):
        assert torch.equal(a, b)
    assert all(w.launches == 0 for w in K.WRAPPERS)


def test_mesh_layout_cuts_rows_and_replicates_the_rest():
    s, f = random_inputs(3, NP_CAP, NODES, vmax=VMAX)
    state, feats = state_from_jax_numpy(s), features_from_jax_numpy(f)
    mesh = make_mesh(devices=["cpu"] * 4)
    st, ft = shard_node_state(state, mesh), shard_features(feats, mesh)
    assert st.block == 64 and len(st.parts) == 4
    for i, p in enumerate(st.parts):
        assert torch.equal(p.alloc_r, state.alloc_r[64 * i:64 * (i + 1)])
        assert torch.equal(p.topo, state.topo[:, 64 * i:64 * (i + 1)])
        assert p.topo.is_contiguous()
    for name in ("sel_match", "extra_ok", "il_score", "exist_anti", "aux_room"):
        assert getattr(ft.parts[1], name).shape[0] == 64, name
    assert ft.parts[1].nom_req.shape[0] == 0  # no lane: nothing to cut
    assert ft.parts[2].request is ft.parts[3].request  # one copy a device
    for a, b in zip(gather(st), state):
        assert torch.equal(a, b)
    assert gather(ft) is feats


def test_launcher_phases_are_read_from_one_source():
    from kubernetes_tpu_torch.ops import _build

    assert "sharded_lap" in _build.KERNELS
    assert [n for n in _build.LAUNCHERS if _build.SOURCE[n] == "sharded_lap"] == [
        "sharded_lap_count", "sharded_lap_windows", "sharded_lap_land"]
    land = {p.name: p for p in _build.signature("sharded_lap_land")}
    assert land["out"].optional and land["keys"].dtype == torch.int64
    assert _build.signature("sharded_lap_count")[0] == _build.Param("NPl", None)


# ---------------------------------------------------------------------------
# the scheduler under a mesh
# ---------------------------------------------------------------------------


def _jax_sched(mesh=True, max_batch=64):
    s = TPUScheduler(max_batch=max_batch, mesh=jax_make_mesh(n_cells=1) if mesh else None)
    # The port has no score-hint walker; with it the JAX scheduler binds
    # identical replicas before any session starts.
    s._hints.enabled = False
    s._hints.entry = None
    return s


def _port_sched(max_batch=64, shards=8):
    return TorchScheduler(device="cpu", max_batch=max_batch,
                          mesh=make_mesh(devices=["cpu"] * shards))


def _assignments(s):
    return {f"{p.namespace}/{p.name}": p.node_name for p in s.clientset.pods.values()}


def _run_both(build, max_batch):
    """The same scripted cluster through the JAX mesh scheduler and the
    port's, each with its package's builders."""
    out = []
    for sched, mk_node, mk_pod in ((_jax_sched(max_batch=max_batch), jax_make_node, jax_make_pod),
                                   (_port_sched(max_batch), make_node, make_pod)):
        build(sched, mk_node, mk_pod)
        sched.run_until_idle()
        out.append(sched)
    jax_s, port = out
    assert _assignments(jax_s) == _assignments(port)
    assert jax_s.host_path_pods == port.host_path_pods == 0
    assert port.mesh is not None and isinstance(port.mirror._device, Sharded)
    return jax_s, port


def test_chained_sessions_match_jax_under_mesh():
    """60 nodes, 90 spread pods, max_batch 32: three chained batches on the
    gathered path (a spread plan is not row-local)."""
    def build(s, mk_node, mk_pod):
        for i in range(60):
            s.clientset.create_node(mk_node().name(f"n{i}").capacity(
                {"cpu": 16, "memory": "64Gi", "pods": 110}).zone(f"z{i % 5}").obj())
        for i in range(90):
            s.clientset.create_pod(mk_pod().name(f"p{i}").req({"cpu": "250m"}).label("app", "s")
                                   .spread_constraint(1, ZONE, "DoNotSchedule", {"app": "s"})
                                   .obj())
    jax_s, port = _run_both(build, 32)
    assert port.device_batches >= 3 and port.shard_map_dispatches == 0


def test_sharded_lap_is_the_production_dispatch_of_row_local_plans():
    """96 nodes, 300 identical pods, max_batch 128: the row-local plan's
    dispatches take the sharded lap, as many as the JAX shard_map's."""
    def build(s, mk_node, mk_pod):
        for i in range(96):
            s.clientset.create_node(mk_node().name(f"n{i}").capacity(
                {"cpu": 16, "memory": "64Gi", "pods": 110}).zone(f"z{i % 5}").obj())
        proto = mk_pod().name("proto").req({"cpu": "250m", "memory": "128Mi"}).labels(
            {"app": "rl"}).obj()
        for i in range(300):
            s.clientset.create_pod(proto.clone_from_template(f"p{i}"))
    jax_s, port = _run_both(build, 128)
    assert port.shard_map_dispatches == jax_s.shard_map_dispatches >= 3
    assert port.scheduled == 300


def test_spread_and_anti_affinity_mix_matches_jax_under_mesh():
    def build(s, mk_node, mk_pod):
        for i in range(40):
            s.clientset.create_node(mk_node().name(f"n{i}").capacity(
                {"cpu": 8, "memory": "32Gi", "pods": 110}).zone(f"z{i % 4}").obj())
        for i in range(24):
            s.clientset.create_pod(mk_pod().name(f"s{i}").req({"cpu": "500m"}).label("app", "s")
                                   .spread_constraint(1, ZONE, "DoNotSchedule", {"app": "s"})
                                   .obj())
        for i in range(12):
            s.clientset.create_pod(mk_pod().name(f"a{i}").req({"cpu": "250m"}).label("app", "x")
                                   .pod_affinity("kubernetes.io/hostname", {"app": "x"},
                                                 anti=True).obj())
        for i in range(80):
            s.clientset.create_pod(mk_pod().name(f"b{i}").req({"cpu": "100m"}).obj())
    _run_both(build, 128)


@pytest.mark.parametrize("batch", [8, 128])
def test_two_cells_schedule_independently(batch):
    """n_cells=2 over eight CPU shards: each cell's results equal the JAX
    package's two-cell run and the cell's own single-device run."""
    draws = [random_inputs(70 + c, NP_CAP, NODES, vmax=VMAX) for c in range(2)]
    stacked_s = [np.stack([d[0][i] for d in draws]) for i in range(len(draws[0][0]))]
    stacked_f = [np.stack([d[1][i] for d in draws]) for i in range(len(draws[0][1]))]
    run = sharded_schedule_batch(make_mesh(n_cells=2, devices=["cpu"] * 8), batch, 0, VMAX)
    out, carries = run(DeviceNodeState(*[torch.from_numpy(a) for a in stacked_s]),
                       BatchFeatures(*[torch.from_numpy(a) for a in stacked_f]))
    jrun = jax_sharded_schedule_batch(jax_make_mesh(n_cells=2), batch, 0, VMAX)
    jout, _jc = jrun(JaxState(*[jnp.asarray(a) for a in stacked_s]),
                     JaxFeatures(*[jnp.asarray(a) for a in stacked_f]))
    np.testing.assert_array_equal(np.asarray(jout), out.numpy())
    for c, (s, f) in enumerate(draws):
        # The JAX run's statics: schedule_batch's defaults, has_pns and
        # has_ipa_base on.
        single, _ = K.schedule_batch(state_from_jax_numpy(s), features_from_jax_numpy(f), batch,
                                     0, VMAX, K.PlanFacts(has_pns=True, has_ipa_base=True))
        assert torch.equal(out[c], single)
        assert (single[0] >= 0).any()
    assert len(carries) == 2


def test_mesh_auto_is_none_on_the_cpu():
    assert TorchScheduler(device="cpu").mesh is None
    assert TorchScheduler(device="cpu", mesh=None).mesh is None
    with pytest.raises(ValueError):
        TorchScheduler(device="cpu", mesh="everywhere")


def test_mesh_auto_keeps_the_requested_card_on_a_multi_card_host(monkeypatch):
    """On a host with several cards "auto" shards nothing and keeps the
    card the caller named: the sharded path is opt-in (mesh=make_mesh())."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    sched = TorchScheduler(device="cuda:1")
    assert sched.mesh is None and sched.device == torch.device("cuda", 1)
    assert sched.mirror.device == torch.device("cuda", 1)


# ---------------------------------------------------------------------------
# delta resume under the mesh
# ---------------------------------------------------------------------------


def _node(mk, name, taint=None):
    b = mk().name(name).capacity({"cpu": 8, "memory": "32Gi", "pods": 110}).zone(
        f"zone-{len(name) % 3}")
    return (b.taint(*taint) if taint else b).obj()


def _pod(mk, name, tolerate=None):
    b = mk().name(name).req({"cpu": "200m", "memory": "128Mi"})
    if tolerate:
        b = b.toleration(tolerate, "", "Exists", "NoSchedule")
    return b.obj()


class _Pair:
    """The JAX mesh scheduler and the port's over identical clusters."""

    def __init__(self, n_nodes=24, max_batch=64, taints=None):
        self.sides = ((_jax_sched(max_batch=max_batch), jax_make_node, jax_make_pod),
                      (_port_sched(max_batch), make_node, make_pod))
        for s, mk_node, _mk_pod in self.sides:
            for i in range(n_nodes):
                s.clientset.create_node(_node(mk_node, f"node-{i}", (taints or {}).get(i)))

    def step(self, fn):
        for s, mk_node, mk_pod in self.sides:
            fn(s, mk_node, mk_pod)
            s.run_until_idle()

    def pods(self, prefix, k, tolerate=None):
        self.step(lambda s, _n, mk: [s.clientset.create_pod(_pod(mk, f"{prefix}-{i}", tolerate))
                                     for i in range(k)])

    @property
    def port(self):
        return self.sides[1][0]

    def assert_identical(self):
        jax_s, port = self.sides[0][0], self.port
        assert _assignments(jax_s) == _assignments(port)
        assert jax_s.plan_rebuilds_full == port.plan_rebuilds_full
        assert jax_s.host_path_pods == port.host_path_pods == 0
        assert (jax_s.scheduled, jax_s.failures) == (port.scheduled, port.failures)


def _delete_first_bound(s, _mk_node, _mk_pod):
    bound = sorted((p for p in s.clientset.pods.values() if p.node_name),
                   key=lambda p: (p.namespace, p.name))
    if bound:
        s.clientset.delete_pod(bound[0])


@pytest.mark.parametrize("max_batch", [64, 128], ids=["gathered", "sharded-lap"])
def test_taint_updates_take_delta_path_under_mesh(max_batch):
    pair = _Pair(max_batch=max_batch, taints={0: ("dedicated", "infra", "NoSchedule")})
    pair.pods("a", 8)
    assert pair.port.plan_rebuilds_full == 1
    pair.step(lambda s, mk, _p: s.clientset.update_node(_node(mk, "node-0")))
    pair.pods("b", 8)
    pair.step(lambda s, mk, _p: s.clientset.update_node(
        _node(mk, "node-3", ("dedicated", "infra", "NoSchedule"))))
    pair.pods("c", 8)
    pair.assert_identical()
    port = pair.port
    assert port.plan_rebuilds_full == 1 and port.plan_rebuilds_delta >= 2
    assert "node-0" in _assignments(port).values()
    assert port.shard_map_dispatches == (3 if max_batch > 64 else 0)


@pytest.mark.parametrize("max_batch", [64, 128], ids=["gathered", "sharded-lap"])
def test_pod_events_take_delta_path_under_mesh(max_batch):
    pair = _Pair(max_batch=max_batch)
    pair.pods("a", 8)
    full0, delta0 = pair.port.plan_rebuilds_full, pair.port.plan_rebuilds_delta
    pair.step(_delete_first_bound)
    pair.pods("b", 8)
    pair.assert_identical()
    assert pair.port.plan_rebuilds_full == full0
    assert pair.port.plan_rebuilds_delta > delta0


@pytest.mark.parametrize("max_batch", [64, 128], ids=["gathered", "sharded-lap"])
def test_mesh_churn_fuzz_takes_no_full_rebuild(max_batch):
    rng = random.Random(7)
    pair = _Pair(n_nodes=16, max_batch=max_batch)
    pair.pods("seed", 8, tolerate="dedicated")
    for r in range(10):
        op = rng.random()
        if op < 0.4:
            pair.step(_delete_first_bound)
        elif op < 0.7:
            i, tainted = rng.randint(0, 15), rng.random() < 0.5
            pair.step(lambda s, mk, _p, i=i, t=tainted: s.clientset.update_node(_node(
                mk, f"node-{i}", ("dedicated", "x", "NoSchedule") if t else None)))
        pair.pods(f"w{r}", rng.randint(2, 5), tolerate="dedicated")
    pair.assert_identical()
    port = pair.port
    assert port.failures == 0 and port.plan_rebuilds_full == 1
    assert port.plan_rebuilds_delta >= 3


@pytest.mark.parametrize("max_batch", [64, 128], ids=["gathered", "sharded-lap"])
def test_patch_that_is_not_busy_reuses_the_residents_storage(max_batch):
    """A patch with no dispatched batch in flight writes the sharded resident
    in place (the counterpart of the JAX donation): the same object, every
    shard's tensors at the same addresses, the patched rows in them."""
    pair = _Pair(max_batch=max_batch)
    pair.pods("a", 8)
    port = pair.port
    res = port.mirror._device
    ptrs = [[t.data_ptr() for t in p] for p in res.parts]
    launches = K.patch_carry_rows.launches
    pair.step(_delete_first_bound)
    pair.pods("b", 8)
    pair.assert_identical()
    assert port.plan_rebuilds_delta >= 1
    assert port.mirror._device is res
    assert [[t.data_ptr() for t in p] for p in res.parts] == ptrs
    whole = gather(res)
    m = port.mirror
    n = m.num_nodes
    assert torch.equal(whole.req_r[:n], torch.from_numpy(m.h_req_r[:n]))
    assert torch.equal(whole.pod_count[:n], torch.from_numpy(m.h_pod_count[:n]))
    assert K.patch_carry_rows.launches == launches  # the CPU counts no launch
