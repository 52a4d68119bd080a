"""The PyTorch port's batch kernels against the JAX reference, on the CPU.

One seeded numpy draw (kubernetes_tpu_torch.testing.kernel_inputs) feeds
the JAX package's functions (as jnp arrays) and the port's (through the
carry-across functions state_from_jax_numpy / features_from_jax_numpy /
carry_from_jax_numpy). On CPU tensors the port's wrappers run their plain
PyTorch versions, so this holds the plain versions equal to JAX; the CUDA
kernels are held equal to the plain versions on the card by chip_smoke.py.
Every comparison is exact: all quantities are integers or booleans."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from kubernetes_tpu.ops.device_state import DeviceNodeState as JaxState
from kubernetes_tpu.ops.features import BatchFeatures as JaxFeatures
from kubernetes_tpu.ops.kernel import ScanCarry as JaxCarry
from kubernetes_tpu.ops.kernel import _resource_eval as jax_resource_eval
from kubernetes_tpu.ops.kernel import _static_masks as jax_static_masks
from kubernetes_tpu.ops.kernel import schedule_batch as jax_schedule_batch
from kubernetes_tpu.ops.kernel import schedule_placements as jax_schedule_placements
from kubernetes_tpu_torch.ops import kernel as K
from kubernetes_tpu_torch.ops import whatif as W
from kubernetes_tpu_torch.ops.device_state import state_from_jax_numpy
from kubernetes_tpu_torch.ops.features import features_from_jax_numpy, victims_from_jax_numpy
from kubernetes_tpu_torch.ops.kernel import carry_from_jax_numpy
from kubernetes_tpu_torch.testing.kernel_inputs import (
    HOST_AXIS,
    RACK_AXIS,
    aux_lane,
    general_inputs,
    nominated_lane,
    placement_inputs,
    random_inputs,
    victim_inputs,
    whatif_inputs,
    with_aux_lane,
    with_nominated_lane,
)

VMAX = 64
GVMAX = 256  # the general draws' value tier: a hostname-like axis of 200 rows


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The inputs are small: one intra-op thread is enough, and it keeps
    this module from crowding the other test workers' CPUs."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _both(seed, np_cap=256, num_nodes=200, **kw):
    """(JAX state, JAX features, port state, port features) from one draw."""
    s, f = random_inputs(seed, np_cap, num_nodes, vmax=VMAX, **kw)
    return _convert(s, f)


def _convert(s, f):
    js = JaxState(*[jnp.asarray(a) for a in s])
    jf = JaxFeatures(*[jnp.asarray(a) for a in f])
    ts = state_from_jax_numpy([np.asarray(a) for a in js])
    tf = features_from_jax_numpy([np.asarray(a) for a in jf])
    return js, jf, ts, tf


def _same(jax_arrays, torch_arrays, what):
    for i, (a, b) in enumerate(zip(jax_arrays, torch_arrays)):
        a = np.asarray(a)
        b = b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, (what, i, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"{what} lane {i}")


CASES = {
    "default": dict(),
    "start-past-rows": dict(start=199),
    "truncation-off": dict(to_find=200),
    "zero-request": dict(zero_request=True),
    "all-infeasible": dict(infeasible=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_static_masks(case):
    js, jf, ts, tf = _both(11, **CASES[case])
    want = jax_static_masks(js, jf)
    got = K.static_masks(ts, tf)
    _same(want, got[:6], "static_masks")
    static_ok = (js.valid & want[0] & want[2] & want[3] & want[4] & want[5] & jf.extra_ok)
    _same([static_ok], [got.static_ok], "static_ok")


@pytest.mark.parametrize("fit_strategy", [0, 1], ids=["least", "most"])
@pytest.mark.parametrize("case", ["default", "zero-request", "all-infeasible"])
def test_resource_eval(case, fit_strategy):
    js, jf, ts, tf = _both(12, **CASES[case])
    want = jax_resource_eval(jf, fit_strategy, js.alloc_r, js.alloc_pods, js.req_r,
                             js.nonzero, js.pod_count)
    got = K.resource_eval(tf, fit_strategy, ts.alloc_r, ts.alloc_pods, ts.req_r,
                          ts.nonzero, ts.pod_count)
    _same(want, got, "resource_eval")


def _chain(js, jf, ts, tf, batch_pad, fit_strategy, n_active, vmax=VMAX, facts=None):
    """Fresh batch, then a second one chained through carry_in; both
    packages. Returns [(jax results, jax carry, port results, port carry)]."""
    facts = facts or dict(has_pns=False, has_ipa_base=False)
    out = []
    jc = tc = None
    for _ in range(2):
        jr, jc_new = jax_schedule_batch(js, jf, batch_pad, fit_strategy, vmax,
                                        n_active=np.int32(n_active), carry_in=jc, **facts)
        # Fetch before the next call: JAX donates carry_in.
        jr = np.asarray(jr)
        jc_np = [np.asarray(a) for a in jc_new]
        port_facts = {k: v for k, v in facts.items() if k != "has_nom"}
        tr, tc = K.schedule_batch(ts, tf, batch_pad, fit_strategy, vmax,
                                  K.PlanFacts(**port_facts), n_active=n_active, carry_in=tc)
        out.append((jr, jc_np, tr, tc))
        jc = JaxCarry(*[jnp.asarray(a) for a in jc_np])
    return out


@pytest.mark.parametrize("fit_strategy", [0, 1], ids=["least", "most"])
@pytest.mark.parametrize("batch_pad,n_active", [(512, 512), (512, 300), (64, 64), (64, 40)],
                         ids=["lap", "lap-padded", "scan", "scan-padded"])
@pytest.mark.parametrize("case", list(CASES))
def test_schedule_batch(case, batch_pad, n_active, fit_strategy):
    js, jf, ts, tf = _both(13, **CASES[case])
    for step, (jr, jc, tr, tc) in enumerate(_chain(js, jf, ts, tf, batch_pad,
                                                   fit_strategy, n_active)):
        assert tr.dtype == torch.int32 and tuple(tr.shape) == (2, batch_pad)
        np.testing.assert_array_equal(jr, tr.numpy(), err_msg=f"results, batch {step}")
        assert len(tc) == 14
        _same(jc, tc, f"carry, batch {step}")


# Plans with count tables and normalized score lanes: (general_inputs
# arguments, the kernel the plan takes at 64 steps, fit strategy).
GENERAL = {
    "spread-dns": (dict(dns=2), "scan_general", 0),              # full feasibility, carried
    "spread-sa-pns": (dict(sa=2, pns=True), "scan_general", 1),  # incremental, normalized
    "anti-aff-landing": (dict(anti=1, aff=2, kd=2), "scan_general", 0),
    "aff-bootstrap": (dict(aff=1, kd=1, bootstrap=True), "scan_general", 1),
    "ipa-base-na": (dict(ipa_base=True, na=True), "scan_general", 0),
    "all-lanes": (dict(dns=1, sa=1, anti=1, aff=1, kd=1, pns=True, ipa_base=True, na=True),
                  "scan_general", 1),
    "hostname-anti": (dict(anti=1, anti_axis=HOST_AXIS), "scan_general", 0),
}


@pytest.fixture
def paths(monkeypatch):
    """The plain kernel versions schedule_batch ran."""
    seen = []
    for name in ("_lap_schedule_plain", "_scan_schedule_plain", "_scan_general_plain"):
        fn = getattr(K, name)
        monkeypatch.setattr(K, name, lambda *a, _fn=fn, _n=name[1:-6], **kw:
                            seen.append(_n) or _fn(*a, **kw))
    return seen


def _general(seed, case, **kw):
    lanes, _path, _strategy = GENERAL[case]
    s, f, facts = general_inputs(seed, 256, 200, vmax=GVMAX, **lanes, **kw)
    return _convert(s, f) + (facts,)


@pytest.mark.parametrize("case", list(GENERAL))
def test_scan_general(case, paths):
    """The plain general scan equals JAX schedule_batch on every result and
    ScanCarry lane, fresh and chained, with padded steps."""
    js, jf, ts, tf, facts = _general(31, case)
    _lanes, path, strategy = GENERAL[case]
    placed = 0
    for step, (jr, jc, tr, tc) in enumerate(_chain(js, jf, ts, tf, 64, strategy, 40,
                                                   vmax=GVMAX, facts=facts)):
        np.testing.assert_array_equal(jr, tr.numpy(), err_msg=f"results, batch {step}")
        assert len(tc) == 14
        _same(jc, tc, f"carry, batch {step}")
        placed += int((jr[0, :40] >= 0).sum())
    assert paths == [path, path]
    assert placed > 0, "the draw must place pods"


def test_lap_with_anti_lanes(paths):
    """Hostname anti-affinity (row-local) above 64 steps takes the lap; its
    anti lanes equal JAX's _lap_schedule, fresh and chained."""
    js, jf, ts, tf, facts = _general(32, "hostname-anti")
    for step, (jr, jc, tr, tc) in enumerate(_chain(js, jf, ts, tf, 512, 1, 150,
                                                   vmax=GVMAX, facts=facts)):
        np.testing.assert_array_equal(jr, tr.numpy(), err_msg=f"results, batch {step}")
        _same(jc, tc, f"carry, batch {step}")
    assert paths == ["lap_schedule", "lap_schedule"]
    assert int(tc.anti_counts.sum()) > int(tf.anti_counts.sum())


def test_general_converters_carry_every_table():
    """features_from_jax_numpy / state_from_jax_numpy / carry_from_jax_numpy
    bring the topology rows, count tables and score lanes across exactly."""
    js, jf, ts, tf, facts = _general(33, "all-lanes")
    _same(js, ts, "state")
    _same(jf, tf, "features")
    _jr, jc = jax_schedule_batch(js, jf, 64, 0, GVMAX, n_active=np.int32(30), **facts)
    jc_np = [np.asarray(a) for a in jc]
    _same(jc_np, carry_from_jax_numpy(jc_np), "carry")
    assert int(np.abs(jc_np[10]).sum()) > 0  # ipa_delta moved


def test_carry_across_round_trips_a_jax_carry():
    js, jf, ts, tf = _both(14)
    _jr, jc = jax_schedule_batch(js, jf, 512, 0, VMAX, n_active=np.int32(100),
                                 has_pns=False, has_ipa_base=False)
    jc_np = [np.asarray(a) for a in jc]
    tc = carry_from_jax_numpy(jc_np)
    _same(jc_np, tc, "carry_from_jax_numpy")
    # A JAX carry continues on the port exactly as it would on JAX.
    jr2, jc2 = jax_schedule_batch(js, jf, 512, 0, VMAX, n_active=np.int32(100),
                                  carry_in=JaxCarry(*[jnp.asarray(a) for a in jc_np]),
                                  has_pns=False, has_ipa_base=False)
    tr2, tc2 = K.schedule_batch(ts, tf, 512, 0, VMAX, K.PlanFacts(), n_active=100,
                                carry_in=tc)
    np.testing.assert_array_equal(np.asarray(jr2), tr2.numpy())
    _same(jc2, tc2, "chained from a JAX carry")


def test_general_plan_is_refused():
    # The nominated-pod lane (preemption's nominations) is read, not
    # refused: with a lane drawn on the features, the lap's results and
    # every carry lane equal the JAX package's has_nom plan, fresh and
    # chained, and differ from the plan without the lane.
    s, f = random_inputs(15, 256, 200, vmax=VMAX)
    js, jf, ts, tf = _convert(s, with_nominated_lane(f, nominated_lane(15, 256, 200)))
    facts = dict(has_pns=False, has_ipa_base=False, has_nom=True)
    for jr, jc, tr, tc in _chain(js, jf, ts, tf, 512, 0, 300, facts=facts):
        np.testing.assert_array_equal(jr, tr.numpy())
        _same(jc, tc, "lap with the nominated lane")
    plain, _ = K.schedule_batch(*_both(15)[2:], 512, 0, VMAX, K.PlanFacts(), n_active=300)
    assert not torch.equal(plain, tr)


def test_wrappers_count_only_kernel_launches():
    # CPU tensors take the plain versions: no launch is counted.
    _js, _jf, ts, tf = _both(16)
    K.reset_launch_counts()
    K.schedule_batch(ts, tf, 64, 0, VMAX, K.PlanFacts(), n_active=10)
    s, f, vr, vv = victim_inputs(16, 256, 200, 8)
    vs, vf = state_from_jax_numpy(s), features_from_jax_numpy(f)
    K.dry_run_preemption(vs, vf, *victims_from_jax_numpy(vr, vv), 8)
    K.scatter_rows(ts, torch.tensor([3], dtype=torch.int32), *K.pack_rows(
        K.DeviceNodeState(*[t[:1] for t in ts[:-1]], ts.topo[:, :1])))
    assert [w.launches for w in K.WRAPPERS] == [0] * len(K.WRAPPERS)
    # Neither CPU nor CUDA: refused, never silently computed elsewhere.
    meta = ts._replace(valid=ts.valid.to("meta"))
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        K.static_masks(meta, tf)


@pytest.fixture
def recorded_launches(monkeypatch):
    """A stand-in for the built library that records each launcher's C
    arguments, so the CUDA wrappers' marshalling runs on CPU tensors."""
    calls = []
    monkeypatch.setattr(K._build, "launcher",
                        lambda name: lambda *args: calls.append((name, args)) or 0)
    monkeypatch.setattr(K, "_stream", lambda device: 0)
    return calls


def test_launcher_signatures_are_read_from_the_sources():
    # Every source exports the one launcher of its own name.
    for name in K._build.KERNELS:
        sig = K._build.signature(name)
        # The batch kernels take the node rows first (a shard's rows for the
        # sharded lap), the what-if its candidates x nodes.
        first = (("P", "N", "R") if name == "whatif_score" else
                 ("NPl",) if name.startswith("sharded_lap") else ("NP",))
        assert sig[:len(first)] == tuple(K._build.Param(n, None) for n in first)
        assert all(p.dtype is not None for p in sig if p.name not in
                   ("NP", "T", "L", "R", "FR", "fit_strategy", "B", "n_act", "V",
                    "C1", "C2", "A1", "A2", "KD", "incremental", "carried", "has_pns",
                    "has_ipa_base", "has_na_pref", "K", "D", "P", "per_lane", "N", "NPl",
                    "S", "n_loc", "gen", "wait_mcycles"))
        optional = {p.name for p in sig if p.optional}
        lane = name in ("resource_eval", "lap_schedule", "scan_schedule", "scan_general",
                        "patch_carry_rows", "schedule_placements")
        # The schedule kernels' blocked lane (host ports) and aux_cnt lane
        # (CSI attach limits) are nullable too, and so is the lap's
        # device-memory buffer (null: its row state fits shared memory); the
        # sharded lap writes the results only on the card of shard 0, and
        # takes a device-memory buffer only past its on-chip tier.
        lanes = {"lap_schedule": {"blocked", "aux_cnt", "work"},
                 "scan_schedule": {"blocked", "aux_cnt"},
                 "scan_general": {"blocked", "aux_cnt"},
                 "schedule_placements": {"blocked_s", "aux_cnt_s"}}
        assert optional == ({"nom_req", "nom_pods"} | lanes.get(name, set())
                            if lane else {"out", "work"} if name == "sharded_lap" else set())
        # The sharded lap's shard table is read on the host; its exchange
        # buffer may be pinned host memory.
        assert {p.name for p in sig if p.host} == ({"table"} if name == "sharded_lap" else set())
        assert {p.name for p in sig if p.mapped} == ({"xbuf"} if name == "sharded_lap"
                                                     else set())


def _two_lap_shards(ts, tf, static_ok):
    """The sharded lap's two shards of rows 0..127 and 128..255, each with a
    fresh carry of its own (fit lanes to be written)."""
    shards = []
    for lo in (0, 128):
        st = K.DeviceNodeState(*[t[lo:lo + 128].clone() for t in ts[:-1]],
                               ts.topo[:, lo:lo + 128].contiguous())
        f = tf._replace(sel_match=tf.sel_match[lo:lo + 128], il_score=tf.il_score[lo:lo + 128])
        fit = K._resource_eval_plain(f, 0, st.alloc_r, st.alloc_pods, st.req_r, st.nonzero,
                                     st.pod_count)
        carry = K.fresh_carry(st, f, VMAX, [t.clone() for t in fit])._replace(
            req_r=st.req_r.clone(), nonzero=st.nonzero.clone(), pod_count=st.pod_count.clone(),
            start=tf.start_index.clone())
        shards.append(K.LapShard(st, f, carry, static_ok[lo:lo + 128].clone()))
    return shards


def test_sharded_lap_refuses_more_shards_than_stay_resident(recorded_launches, monkeypatch):
    """More shards on one card than one launch keeps resident: refused
    before any card launches (a block waiting on one that never runs would
    hang)."""
    monkeypatch.setattr(K, "_resident_limit", lambda *a: K.SHL_MAX_LOCAL)
    _js, _jf, ts, tf = _both(17)
    shards = _two_lap_shards(ts, tf, K._static_masks_plain(ts, tf).static_ok)
    with pytest.raises(ValueError, match=f"at most {K.SHL_MAX_LOCAL} resident"):
        K._sharded_lap_cuda(shards * 17, 0, 300, torch.full((2, 512), -1, dtype=torch.int32))
    assert recorded_launches == []


def test_sharded_lap_status_words_raise():
    """A block whose wait ran out of budget leaves ((lap << 1) | exchange)
    + 1 in its status word: the wrapper raises, naming the shard, the lap
    and the exchange; all-zero words pass."""
    cpu = torch.device("cpu")
    K._sharded_lap_status([(cpu, [0, 1], torch.zeros(2, dtype=torch.int32), None)])
    with pytest.raises(RuntimeError, match="shard 3 .* lap 2, exchange 2"):
        K._sharded_lap_status([(cpu, [2, 3], torch.tensor([0, (2 << 1 | 1) + 1],
                                                          dtype=torch.int32), None)])


def test_cuda_wrappers_pass_what_their_launchers_declare(recorded_launches, monkeypatch):
    _js, _jf, ts, tf = _both(17)
    fit = K._resource_eval_plain(tf, 0, ts.alloc_r, ts.alloc_pods, ts.req_r, ts.nonzero,
                                 ts.pod_count)
    ext0 = K.fresh_carry(ts, tf, VMAX, fit)
    static_ok = K._static_masks_plain(ts, tf).static_ok
    K._static_masks_cuda(ts, tf)
    K._resource_eval_cuda(tf, 1, ts.alloc_r, ts.alloc_pods, ts.req_r, ts.nonzero, ts.pod_count)
    K._lap_schedule_cuda(ts, tf, 512, 0, ext0, static_ok, 300)
    K._scan_schedule_cuda(ts, tf, 64, 0, ext0, static_ok, 40)
    K._scan_general_cuda(ts, tf, 64, 0, ext0, K._static_masks_plain(ts, tf), 40,
                         K.PlanFacts(has_pns=True))
    s, f, vr, vv = victim_inputs(17, 256, 200, 16)
    K._dry_run_preemption_cuda(state_from_jax_numpy(s), features_from_jax_numpy(f),
                               *victims_from_jax_numpy(vr, vv), 16)
    rows = K.DeviceNodeState(*[t[:2] for t in ts[:-1]], ts.topo[:, :2])
    K._scatter_rows_cuda(ts, torch.tensor([5, 9], dtype=torch.int32), *K.pack_rows(rows))
    K._patch_carry_rows_cuda(ts, tf, ext0, torch.tensor([5, 9], dtype=torch.int32),
                             ts.req_r[:2], ts.nonzero[:2], ts.pod_count[:2], 0)
    masks = torch.zeros((4, ts.valid.shape[0]), dtype=torch.bool)
    K._schedule_placements_cuda(ts, tf, 8, 0, VMAX, K.PlanFacts(), masks, 5)
    W._whatif_score_cuda(*[torch.from_numpy(a) for a in whatif_inputs(17, 3, 40)])
    # The sharded lap: one launch for the two shards of one device, each
    # shard's tensors in its row of the host table.
    monkeypatch.setattr(K, "_resident_limit", lambda *a: K.SHL_MAX_LOCAL)
    shards = _two_lap_shards(ts, tf, static_ok)
    out = torch.full((2, 512), -1, dtype=torch.int32)
    cards = K._sharded_lap_cuda(shards, 0, 300, out)
    K._sharded_lap_status(cards)
    assert [name for name, _ in recorded_launches] == list(K._build.KERNELS)
    for name, args in recorded_launches:
        sig = K._build.signature(name)
        assert len(args) == len(sig) + 1  # and the stream
        for p, a in zip(sig, args):
            given = name == "sharded_lap" and p.name == "out"  # shard 0 is on this card
            assert (a is None) if p.optional and not given else isinstance(a, int), (name, p)
    sl = {p.name: a for p, a in zip(K._build.signature("sharded_lap"), recorded_launches[-1][1])}
    assert (sl["S"], sl["n_loc"], sl["NPl"], sl["gen"] > 0) == (2, 2, 128, True)
    assert sl["out"] == out.data_ptr() and sl["table"] == cards[0][3].data_ptr()
    table = cards[0][3]
    assert table[:, 0].tolist() == [0, 1]
    assert table[1, 1:].tolist() == [t.data_ptr() for t in (
        shards[1].state.alloc_r, shards[1].state.alloc_pods, *shards[1].carry[:3],
        shards[1].static_ok, shards[1].f.il_score, *shards[1].carry[3:6], shards[1].carry.start)]
    # With a nominated lane the schedule kernels get its two pointers.
    lane = tf._replace(nom_req=torch.zeros_like(ts.req_r),
                       nom_pods=torch.zeros_like(ts.pod_count))
    recorded_launches.clear()
    K._lap_schedule_cuda(ts, lane, 512, 0, ext0, static_ok, 300)
    K._scan_schedule_cuda(ts, lane, 64, 0, ext0, static_ok, 40)
    K._scan_general_cuda(ts, lane, 64, 0, ext0, K._static_masks_plain(ts, tf), 40,
                         K.PlanFacts(has_pns=True))
    K._patch_carry_rows_cuda(ts, lane, ext0, torch.tensor([5, 9], dtype=torch.int32),
                             ts.req_r[:2], ts.nonzero[:2], ts.pod_count[:2], 0)
    K._schedule_placements_cuda(ts, lane, 8, 0, VMAX, K.PlanFacts(), masks, 5)
    for name, args in recorded_launches:
        sig = {p.name: a for p, a in zip(K._build.signature(name), args)}
        assert (sig["nom_req"], sig["nom_pods"]) == (lane.nom_req.data_ptr(),
                                                     lane.nom_pods.data_ptr()), name
    # With the aux lane on, the schedule kernels get a copy of the carry's
    # aux_cnt (placements: a scratch lane) and the batch's room and increment.
    aux = K.PlanFacts(has_aux=True)
    recorded_launches.clear()
    K._lap_schedule_cuda(ts, tf, 512, 0, ext0, static_ok, 300, has_aux=True)
    K._scan_schedule_cuda(ts, tf, 64, 0, ext0, static_ok, 40, has_aux=True)
    K._scan_general_cuda(ts, tf, 64, 0, ext0, K._static_masks_plain(ts, tf), 40,
                         aux._replace(has_pns=True))
    K._schedule_placements_cuda(ts, tf, 8, 0, VMAX, aux, masks, 5)
    for name, args in recorded_launches:
        sig = {p.name: a for p, a in zip(K._build.signature(name), args)}
        cnt = sig.get("aux_cnt", sig.get("aux_cnt_s"))
        assert isinstance(cnt, int) and cnt != ext0.aux_cnt.data_ptr(), name
        assert (sig["aux_room"], sig["aux_inc"]) == (tf.aux_room.data_ptr(),
                                                     tf.aux_inc.data_ptr()), name


@pytest.mark.parametrize("case", ["all-lanes", "hostname-anti", "aff-bootstrap"])
def test_scan_general_wrapper_marshals_every_table(recorded_launches, case):
    """The scan_general wrapper passes each table, flag and scratch buffer
    in its launcher's order: the recorded arguments are the data pointers
    of the tensors the plan holds (cloned carry lanes excepted), the table
    sizes are the features' own, and the flags are the plan's modes."""
    _js, _jf, ts, tf, facts = _general(34, case)
    facts = K.PlanFacts(**facts)
    masks = K._static_masks_plain(ts, tf)
    fit = K._resource_eval_plain(tf, 1, ts.alloc_r, ts.alloc_pods, ts.req_r, ts.nonzero,
                                 ts.pod_count)
    ext0 = K.fresh_carry(ts, tf, GVMAX, fit)
    _out, carry = K._scan_general_cuda(ts, tf, 64, 1, ext0, masks, 40, facts)
    [(name, args)] = recorded_launches
    sig = {p.name: a for p, a in zip(K._build.signature(name), args)}
    incremental, carried = K.plan_modes(tf, facts)
    assert (sig["NP"], sig["B"], sig["n_act"], sig["V"], sig["fit_strategy"]) == (256, 64, 40,
                                                                                 GVMAX, 1)
    assert (sig["C1"], sig["C2"], sig["A1"], sig["A2"], sig["KD"]) == tuple(
        t.shape[0] for t in (tf.dns_axis, tf.sa_axis, tf.anti_axis, tf.aff_axis, tf.ipa_axis))
    assert (sig["incremental"], sig["carried"], sig["has_pns"], sig["has_ipa_base"],
            sig["has_na_pref"]) == (int(incremental), int(carried), int(facts.has_pns),
                                    int(facts.has_ipa_base), int(facts.has_na_pref))
    for field in ("dns_axis", "dns_dom", "sa_wq", "anti_self", "aff_own_all", "ipa_wland",
                  "na_raw", "ipa_base", "weights", "to_find"):
        assert sig[field] == getattr(tf, field).data_ptr(), field
    for field in ("topo", "alloc_r"):
        assert sig[field] == getattr(ts, field).data_ptr(), field
    assert sig["static_ok"] == masks.static_ok.data_ptr()
    assert sig["taint_ok"] == masks.taint_ok.data_ptr()
    assert sig["pns_cnt"] == masks.pns_cnt.data_ptr()
    # The carry's lanes are fresh copies the kernel updates in place.
    for lane in ("dns_counts", "sa_counts", "anti_counts", "aff_counts", "ipa_delta",
                 "req_r", "fit_ok"):
        assert sig[lane] == getattr(carry, lane).data_ptr(), lane
        assert sig[lane] != getattr(ext0, lane).data_ptr() or getattr(ext0, lane).numel() == 0
    assert sig["start"] == ext0.start.data_ptr()
    assert sig["start_out"] == carry.start.data_ptr()


# Placement evaluations: the spread tables of a lane (none, the plan's
# shared tables, or per-lane overrides), as placement_inputs arguments.
PLACEMENT_TABLES = {
    "no-tables": {},
    "shared-tables": dict(dns=1, sa=1),
    "overrides": dict(dns=2, sa=1, overrides=True),
}


@pytest.mark.parametrize("fit_strategy", [0, 1], ids=["least", "most"])
@pytest.mark.parametrize("tables", list(PLACEMENT_TABLES))
@pytest.mark.parametrize("lanes", [1, 4, 16])
def test_schedule_placements(lanes, tables, fit_strategy):
    """The plain stacked placement evaluation equals the JAX package's
    schedule_placements on every lane, for two seeds (the second with
    PreferNoSchedule and preferred node-affinity lanes), with no active
    member (every lane inert) and with six, and leaves its inputs as they
    were. Lane 0 of a multi-lane draw is a padded lane (no row)."""
    placed = 0
    for seed in (41, 42):
        s, f, facts, masks, ov = placement_inputs(seed, 256, 200, lanes, vmax=GVMAX,
                                                  pns=seed == 42, na=seed == 42,
                                                  **PLACEMENT_TABLES[tables])
        js, jf, ts, tf = _convert(s, f)
        t_ov = None if ov is None else tuple(torch.from_numpy(a) for a in ov)
        j_ov = None if ov is None else tuple(jnp.asarray(a) for a in ov)
        before = [t.clone() for t in list(ts) + list(tf) + list(t_ov or ())]
        for n_active in (0, 6):
            want = np.asarray(jax_schedule_placements(
                js, jf, 8, fit_strategy, GVMAX, jnp.asarray(masks), n_active=np.int32(n_active),
                has_pns=facts["has_pns"], has_na_pref=facts["has_na_pref"],
                spread_overrides=j_ov))
            got = K.schedule_placements(ts, tf, 8, fit_strategy, GVMAX, K.PlanFacts(**facts),
                                        torch.from_numpy(masks), n_active, t_ov)
            assert got.dtype == torch.int32 and tuple(got.shape) == (lanes, 2, 8)
            np.testing.assert_array_equal(want, got.numpy(), err_msg=f"seed {seed}, "
                                          f"{n_active} members")
            if n_active == 0 or lanes > 1:
                inert = got if n_active == 0 else got[:1]
                assert (inert[:, 0] == -1).all() and (inert[:, 1] == 0).all()
            placed += int((got[:, 0] >= 0).sum())
        for a, b in zip(before, list(ts) + list(tf) + list(t_ov or ())):
            assert torch.equal(a, b), "schedule_placements wrote into an input"
    assert placed > 0, "the draws must place members"


@pytest.mark.parametrize("overrides", [False, True], ids=["shared-tables", "overrides"])
def test_schedule_placements_wrapper_marshals_lanes(recorded_launches, overrides):
    """The CUDA wrapper passes the plan's tables (per_lane 0) or the
    overrides (per_lane 1), the masks, the shared node state and one
    scratch slice per lane."""
    s, f, facts, masks, ov = placement_inputs(43, 256, 200, 4, vmax=GVMAX, dns=1, sa=1,
                                              overrides=overrides)
    _js, _jf, ts, tf = _convert(s, f)
    t_ov = None if ov is None else tuple(torch.from_numpy(a) for a in ov)
    t_masks = torch.from_numpy(masks)
    out = K._schedule_placements_cuda(ts, tf, 8, 1, GVMAX, K.PlanFacts(**facts), t_masks, 6, t_ov)
    [(name, args)] = recorded_launches
    sig = {p.name: a for p, a in zip(K._build.signature(name), args)}
    assert (sig["NP"], sig["P"], sig["B"], sig["n_act"], sig["V"], sig["C1"], sig["C2"],
            sig["per_lane"]) == (256, 4, 8, 6, GVMAX, 1, 1, int(overrides))
    tables = t_ov or (tf.dns_counts, tf.dns_dom, tf.dns_forced0, tf.sa_counts, tf.sa_wq)
    for field, t in zip(("dns_counts", "dns_dom", "dns_forced0", "sa_counts", "sa_wq"), tables):
        assert sig[field] == t.data_ptr(), field
    assert sig["masks"] == t_masks.data_ptr() and sig["out"] == out.data_ptr()
    for field in ("req_r", "nonzero", "pod_count", "alloc_r", "topo"):
        assert sig[field] == getattr(ts, field).data_ptr(), field
    assert tuple(out.shape) == (4, 2, 8)
    # A plan outside the placement restriction is refused before a launch.
    s, f, facts = general_inputs(44, 256, 200, vmax=GVMAX, anti=1)
    _js, _jf, ts, tf = _convert(s, f)
    with pytest.raises(ValueError, match="placement restriction"):
        K._schedule_placements_cuda(ts, tf, 8, 0, GVMAX, K.PlanFacts(**facts), t_masks, 6)
    assert len(recorded_launches) == 1


def _wrong_dtype(ts, tf):
    K._static_masks_cuda(ts, tf._replace(enable=tf.enable.to(torch.int64)))


def _wrong_feature_dtype(ts, tf):
    K._resource_eval_cuda(tf._replace(fit_weights=tf.fit_weights.to(torch.int32)), 0,
                          ts.alloc_r, ts.alloc_pods, ts.req_r, ts.nonzero, ts.pod_count)


def _null_pointer(ts, tf):
    K._marshal("static_masks", torch.device("cpu"), (8, 4, 2) + (None,) * 23)


def _wrong_count(ts, tf):
    K._marshal("lap_schedule", torch.device("cpu"), (8,))


def _wrong_device(ts, tf):
    # A feature left on another device than the node state.
    K._resource_eval_cuda(tf._replace(request=tf.request.to("meta")), 0, ts.alloc_r,
                          ts.alloc_pods, ts.req_r, ts.nonzero, ts.pod_count)


def _not_an_int(ts, tf):
    K._marshal("static_masks", torch.device("cpu"), (8.0,) + (None,) * 25)


@pytest.mark.parametrize("bad,err,match", [
    (_wrong_dtype, TypeError, "enable must be a torch.int32"),
    (_wrong_feature_dtype, TypeError, "fit_weights must be a torch.int64"),
    (_null_pointer, TypeError, "taint_key may not be null"),
    (_wrong_count, TypeError, "takes 42 arguments"),
    (_wrong_device, ValueError, "request on meta, expected cpu"),
    (_not_an_int, TypeError, "NP must be an int"),
], ids=["dtype", "feature-dtype", "null", "count", "device", "int"])
def test_launch_arguments_are_checked_before_the_launch(recorded_launches, bad, err, match):
    _js, _jf, ts, tf = _both(18)
    with pytest.raises(err, match=match):
        bad(ts, tf)
    assert recorded_launches == []


# ---------------------------------------------------------------------------
# The scan_general kernel's shortcuts (csrc/scan_general.cu), modelled in
# numpy and held against the plain version's from-scratch arithmetic, so a
# wrong shortcut shows here and not only on the card.
# ---------------------------------------------------------------------------


class _MaintainedMin:
    """The kernel's spread minimum: per constraint the minimum count over
    its eligible domains (capped at BIG) and the number of domains at it,
    moved by each landing and rescanned only when that number reaches 0."""

    def __init__(self, counts, dom):
        self.counts, self.dom = counts, dom
        self.mn = np.zeros(counts.shape[0], np.int64)
        self.at_min = np.zeros(counts.shape[0], np.int64)
        self.rescans = 0
        for c in range(counts.shape[0]):
            self._rescan(c)

    def _rescan(self, c):
        vals = self.counts[c][self.dom[c]]
        self.mn[c] = min(K.BIG, int(vals.min())) if vals.size else K.BIG
        self.at_min[c] = int((vals == self.mn[c]).sum())
        self.rescans += 1

    def land(self, c, v, add):
        o = int(self.counts[c, v])
        n = o + add
        self.counts[c, v] = n
        if not self.dom[c, v] or n == o:
            return
        if n < self.mn[c]:
            self.mn[c], self.at_min[c] = n, 1
        elif o == self.mn[c]:
            self.at_min[c] -= 1
            if self.at_min[c] == 0:
                self._rescan(c)
        elif n == self.mn[c]:
            self.at_min[c] += 1


@pytest.mark.parametrize("seed,case", [(s, c) for c in ("zone", "hostname", "gen-maxc")
                                       for s in (0, 1)])
def test_maintained_spread_minimum_equals_the_plain_minimum(seed, case):
    """Landings stepped over a general draw: the maintained minimum equals
    the plain version's from-scratch `where(dns_dom, counts, BIG).amin`
    after every landing (domains outside dns_dom, rows that are not
    eligible, dns_self 0, dns_forced0 and max skews padded at 2^40
    included), and the kernel's row test count <= thr equals the plain
    version's skew test on every domain."""
    kw = {"zone": dict(dns=2), "hostname": dict(dns=1, dns_axis=HOST_AXIS),
          "gen-maxc": dict(dns=9)}[case]
    s, f, _facts = general_inputs(900 + seed, 256, 200, vmax=GVMAX, **kw)
    _js, _jf, ts, tf = _convert(s, f)
    counts = tf.dns_counts.numpy().astype(np.int64)
    dom = tf.dns_dom.numpy()
    model = _MaintainedMin(counts, dom)
    vid = K._vids(ts, tf.dns_axis).numpy()
    sel = (tf.sel_match.numpy()) | (tf.enable[3].item() == 0)
    taint = np.random.default_rng(seed).random(256) < 0.8
    C1 = counts.shape[0]
    cap = np.minimum(tf.dns_max_skew.numpy(), K.BIG)
    self_ = tf.dns_self.numpy().astype(np.int64)
    forced0 = tf.dns_forced0.numpy() == 1
    if seed == 1:
        forced0[0] = True  # the draw's first constraint under dns_forced0
    rng = np.random.default_rng(seed + 17)
    landed_at_min = 0
    for _step in range(600):
        row = int(rng.integers(0, 200))
        for c in range(C1):
            v = int(vid[c, row])
            elig = (v > 0 and (tf.dns_honor_aff[c] != 1 or sel[row])
                    and (tf.dns_honor_taints[c] != 1 or taint[row]))
            if elig:
                landed_at_min += bool(dom[c, v] and counts[c, v] == model.mn[c] and self_[c])
                model.land(c, v, int(self_[c]))
        plain_min = torch.where(torch.from_numpy(dom), torch.from_numpy(counts),
                                K.BIG).amin(dim=1).numpy()
        np.testing.assert_array_equal(model.mn, plain_min)
        eff = np.where(forced0, 0, plain_min)
        plain_ok = counts + self_[:, None] - eff[:, None] <= cap[:, None]
        thr = np.where(forced0, 0, model.mn) + cap - self_
        np.testing.assert_array_equal(counts <= thr[:, None], plain_ok)
    assert (tf.dns_max_skew.numpy() == 1 << 40).any() == (case == "gen-maxc")
    assert model.rescans - C1 < landed_at_min, "the minimum must not be rescanned each landing"


def _warp_ranks(okd, nrows, num, start, to_find, nt):
    """The kernel's ranks (pass 1, the chunk prefixes and pass 2 of
    csrc/scan_general.cu): rows come in 32-row chunks and chunk k * nw + w
    is warp w's k-th, its ballot mask[k, w]. Each warp sums the chunk rows,
    32 at a time with the total carried between groups, into pfx[k, w] =
    the feasible rows of the chunk rows before k plus those of the warps
    before w in row k; f_start adds, at row start-1's chunk (chunk row ks,
    warp wsx), the warps before wsx and the ballot's bits up to its lane. A
    row's inclusive prefix is pfx plus its ballot's popcount at or below
    its lane. Returns (rank of each visited row, -1 elsewhere; the boundary;
    the kept rows), with the chunks pass 2 skips left unvisited."""
    nw = nt // 32
    kw = ((nrows + 31) // 32 + nw - 1) // nw
    rows = kw * nw * 32
    ok = np.zeros(max(rows, okd.shape[0]), bool)
    ok[:nrows] = okd[:nrows]
    bits = ok[:rows].reshape(kw, nw, 32)  # [chunk row k, warp w, lane]
    pop = bits.sum(axis=2)
    cs = (start - 1) >> 5 if 0 < start and start - 1 < nrows else -1
    ks, wsx = (cs // nw, cs % nw) if cs >= 0 else (-1, 0)
    pfx = np.zeros((kw, nw), np.int64)
    total = fbase = 0
    for g in range(0, kw, 32):  # lane k - g of each warp takes chunk row k
        k = np.arange(g, min(g + 32, kw))
        T = pop[k].sum(axis=1)
        incl = np.cumsum(T)
        excl = total + incl - T
        for w in range(nw):
            pfx[k, w] = excl + pop[k, :w].sum(axis=1)
        if g <= ks < g + 32:
            fbase = int(excl[ks - g] + pop[ks, :wsx].sum())
        total += int(incl[-1])
    f_start = (0 if start == 0 else total if cs < 0
               else fbase + int(bits[ks, wsx, :((start - 1) & 31) + 1].sum()))
    s_mod = start % num
    rank = np.full(ok.shape[0], -1)
    kept = np.zeros(ok.shape[0], bool)
    bound = 0
    for w in range(nw):
        for k in range(kw):
            m = bits[k, w]
            if not m.any():
                continue
            c0 = int(pfx[k, w])
            cb = 32 * (k * nw + w)
            if (c0 + 1 - f_start > to_find) if cb >= start else (
                    cb + 31 < start and c0 + 1 + total - f_start > to_find):
                continue
            for lane in np.nonzero(m)[0]:
                r = cb + lane
                Fi = c0 + int(m[:lane + 1].sum())
                rk = Fi - f_start if r >= start else Fi + total - f_start
                rank[r] = rk
                if rk <= to_find:
                    kept[r] = True
                    rot = r - s_mod + (num if r < s_mod else 0)
                    assert rot == (r - start) % num
                    if rk == to_find:
                        bound = num - 1 - rot
    return rank, bound, kept


@pytest.mark.parametrize("nt", [64, 512])
@pytest.mark.parametrize("case", ["start-0", "start-mid", "start-last", "start-past-rows",
                                  "start-past-num", "few-feasible", "to-find-0"])
def test_warp_ranks_equal_the_plain_prefix_sum(case, nt):
    """The kernel's chunk-dealt ranks, window boundary and kept set equal
    the plain version's cumsum ranks (rank by raw start, rotation by start
    mod num) for every row pass 2 can keep; the chunks it skips hold no
    kept row and no boundary. 5000 rows make 79 chunk rows a warp at 64
    threads, so the prefixes cross three 32-row groups."""
    rng = np.random.default_rng(len(case) * 7 + nt)
    NP, num = 5000, 4937
    nrows = min(NP, num)
    okd = rng.random(NP) < (0.05 if case == "few-feasible" else 0.7)
    okd[nrows:] = False
    start = {"start-0": 0, "start-mid": 2411, "start-last": num - 1, "start-past-rows": 4960,
             "start-past-num": 4940, "few-feasible": 3000, "to-find-0": 25}[case]
    to_find = {"few-feasible": 100, "to-find-0": 0}.get(case, 500)
    rank, bound, kept = _warp_ranks(okd, nrows, num, start, to_find, nt)
    idx = torch.arange(NP)
    F = torch.cumsum(torch.from_numpy(okd).to(torch.int32), 0)
    total = F[-1]
    f_start = F[start - 1] if start > 0 else 0
    plain_rank = torch.where(idx >= start, F - f_start, F + total - f_start).numpy()
    plain_kept = okd & (plain_rank <= to_find)
    rot = ((idx - start) % num).numpy()
    plain_bound = int(np.where(okd & (plain_rank == to_find), num - 1 - rot, 0).max())
    np.testing.assert_array_equal(kept[:NP], plain_kept)
    visited = rank[:NP] >= 0
    np.testing.assert_array_equal(rank[:NP][visited], plain_rank[visited])
    assert bound == plain_bound
    assert plain_kept.any() == (to_find > 0)


# ---------------------------------------------------------------------------
# The lap kernel's bookkeeping (csrc/lap_schedule.cu), modelled in numpy on
# its own layout and stepped lap by lap, then held against the plain
# version's dense laps: a shortcut that drifts from the reference shows
# here and not only on the card.
# ---------------------------------------------------------------------------

I64_MIN = np.iinfo(np.int64).min


def _popc(m: int) -> int:
    return bin(m).count("1")


class _LapModel:
    """The lap kernel's on-chip state and its steps: a 32-bit feasibility
    mask a 32-row chunk (the base verdict apart from the anti one), each
    chunk's count, maximum total and first row at it, the chunk prefixes of
    one warp's scan, the 32-way search of a rank's row, a window's best row
    over its edge rows and the summaries between, its cut at the rotation
    origin, every lane's boundary, the landings' re-evaluation and the
    refresh of the chunks they changed (idempotent when two share a chunk),
    and the dense anti recheck. Row evaluations go through the plain
    resource_eval, as the kernel's go through resource_eval_row."""

    def __init__(self, st, f, strat, ext0, static_ok, ports, aux):
        self.st, self.f, self.strat = st, f, strat
        self.ports, self.aux = ports, aux
        self.NP = NP = static_ok.shape[0]
        self.NC = (NP + 31) // 32
        self.num = max(int(f.num_nodes), 1)
        self.tf = max(int(f.to_find), 1)
        self.static_ok = static_ok.numpy()
        self.req_r, self.nonzero, self.pod_count = (t.clone() for t in ext0[:3])
        self.blocked = ext0.blocked.clone()
        self.aux_cnt = ext0.aux_cnt.clone()
        self.anti_counts = ext0.anti_counts.clone().numpy()
        self.vid = K._vids(st, f.anti_axis).numpy()
        self.A1 = self.vid.shape[0]
        self.start = int(ext0.start)
        self.fit_ok, self.fit_sc, self.ba = (t.clone() for t in K._resource_eval_plain(
            f, strat, st.alloc_r, st.alloc_pods, self.req_r, self.nonzero, self.pod_count,
            *K._nom_lane(f)))
        self.total = K._total(f, self.fit_sc, self.ba).numpy().copy()
        base = self._base_rows(np.arange(NP))
        self.base = self._pack(base)
        self.mask = self.base & self._pack(self._anti_rows())
        self.cnt = np.zeros(self.NC, np.int64)
        self.mx = np.full(self.NC, I64_MIN, np.int64)
        self.arg = np.full(self.NC, -1, np.int64)
        self.pfx = np.zeros(self.NC, np.int64)
        self.dirty = np.zeros(self.NC, bool)
        for c in range(self.NC):
            self._summary(c, int(self.mask[c]))
        self.shared_refreshes = self.anti_refreshes = self.cut_ranges = self.multi_round = 0
        self.sizes = []

    # -- verdicts -----------------------------------------------------------
    def _base_rows(self, rows):
        ok = self.static_ok[rows] & self.fit_ok.numpy()[rows] & (rows < self.num)
        if self.ports:
            ok &= ~self.blocked.numpy()[rows]
        if self.aux:
            ok &= (self.aux_cnt.numpy()[rows] + int(self.f.aux_inc)
                   <= self.f.aux_room.numpy()[rows])
        return ok

    def _anti_rows(self):
        ok = np.ones(self.NP, bool)
        for c in range(self.A1):
            v = self.vid[c]
            ok &= ~((v > 0) & (self.anti_counts[c][v] > 0))
        return ok

    def _pack(self, ok):
        """One ballot a chunk; lanes past NP hold no row and stay clear."""
        pad = np.zeros(self.NC * 32, bool)
        pad[:self.NP] = ok
        bits = pad.reshape(self.NC, 32).astype(np.uint64) << np.arange(32, dtype=np.uint64)
        return bits.sum(axis=1).astype(np.uint64)

    def _summary(self, c, m):
        rows = [c * 32 + lane for lane in range(32) if (m >> lane) & 1]
        before = (int(self.mask[c]), int(self.cnt[c]), int(self.mx[c]), int(self.arg[c]))
        self.mask[c] = m
        self.cnt[c] = len(rows)
        if rows:
            best = max(int(self.total[r]) for r in rows)
            self.mx[c], self.arg[c] = best, min(r for r in rows if self.total[r] == best)
        else:
            self.mx[c], self.arg[c] = I64_MIN, -1
        return before

    # -- one lap ------------------------------------------------------------
    def _scan(self):
        """Warp 0: a contiguous run of chunks a lane, an inclusive scan of
        the lanes' sums, the runs' exclusive prefixes."""
        cpl = (self.NC + 31) // 32
        sums = [int(self.cnt[min(l * cpl, self.NC):min(l * cpl + cpl, self.NC)].sum())
                for l in range(32)]
        incl = np.cumsum(sums)
        for l in range(32):
            run = int(incl[l] - sums[l])
            for c in range(min(l * cpl, self.NC), min(l * cpl + cpl, self.NC)):
                self.pfx[c] = run
                run += int(self.cnt[c])
        return int(incl[-1])

    def _find_row(self, g):
        lo, hi = 0, self.NC
        while hi - lo > 32:
            self.multi_round += 1
            step = (hi - lo + 31) // 32
            j = max(l for l in range(32) if lo + l * step < hi and self.pfx[lo + l * step] <= g)
            lo, hi = lo + j * step, min(lo + j * step + step, hi)
        c = lo + max(l for l in range(32) if lo + l < hi and self.pfx[lo + l] <= g)
        k, m = g - int(self.pfx[c]), int(self.mask[c])
        [lane] = [l for l in range(32) if (m >> l) & 1 and _popc(m & ((1 << l) - 1)) == k]
        return c * 32 + lane

    def _range_best(self, a, b):
        """(total, row) of the best feasible row of rows [a, b]: edge chunks
        from their rows, the chunks between from their summaries."""
        ca, cb = a >> 5, b >> 5
        cands = []
        for c, lo, hi in ((ca, a, b), (cb, a, b)) if ca != cb else ((ca, a, b),):
            m = int(self.mask[c])
            cands += [(int(self.total[r]), r) for r in range(c * 32, c * 32 + 32)
                      if lo <= r <= hi and (m >> (r & 31)) & 1]
        cands += [(int(self.mx[c]), int(self.arg[c])) for c in range(ca + 1, cb)
                  if self.cnt[c] > 0]
        if not cands:
            return None
        best = max(t for t, _ in cands)
        return best, min(r for t, r in cands if t == best)

    def _rot(self, row):
        return (row - self.start) % self.num

    def _window(self, w, L, T, f_start):
        """(key, row or -1, start after) of window lane w."""
        key, row, last = -1, -1, -1
        any_ = False
        if w < L and T > 0:
            r0 = w * self.tf
            length = min(self.tf, T - r0)
            g0 = (f_start + r0) % T
            end = g0 + length - 1
            pieces = [(g0, end)] if end < T else [(g0, T - 1), (0, end - T)]
            so = self.start % self.num
            for ga, gb in pieces:
                a, b = self._find_row(ga), self._find_row(gb)
                last = b
                ranges = [(so, b), (a, so - 1)] if a < so <= b else [(a, b)]
                self.cut_ranges += len(ranges) - 1
                for lo, hi in ranges:
                    got = self._range_best(lo, hi)
                    if got is not None:
                        k = got[0] * self.NP + (self.NP - 1 - self._rot(got[1]))
                        if not any_ or k > key:
                            key, row = k, got[1]
                        any_ = True
        rb = (w + 1) * self.tf
        ev = self.num
        if rb <= T:
            brow = last if w < L else self._find_row((f_start + rb - 1) % T)
            ev = self._rot(brow) + 1
        has = w < L and any_ and key >= 0
        return (row if has else -1), (self.start + ev) % self.num

    def _land(self, row):
        f, st = self.f, self.st
        self.req_r[row] += f.request
        self.nonzero[row] += f.nz_request
        self.pod_count[row] += 1
        if self.ports:
            self.blocked[row] = True
        if self.aux:
            self.aux_cnt[row] += f.aux_inc
        for c in range(self.A1):
            v = self.vid[c, row]
            if v > 0:
                self.anti_counts[c, v] += int(f.anti_self[c])
        sl = slice(row, row + 1)
        nom_r, nom_p = K._nom_lane(f)
        ok, sc, ba = K._resource_eval_plain(
            f, self.strat, st.alloc_r[sl], st.alloc_pods[sl], self.req_r[sl], self.nonzero[sl],
            self.pod_count[sl], None if nom_r is None else nom_r[sl],
            None if nom_p is None else nom_p[sl])
        self.fit_ok[row], self.fit_sc[row], self.ba[row] = ok[0], sc[0], ba[0]
        self.total[row] = int(K._total(f._replace(il_score=f.il_score[sl]), sc, ba)[0])
        return bool(self._base_rows(np.array([row]))[0])

    def _apply(self, m, c, land, land_ok):
        clr = sum(1 << (r & 31) for r in land if r >= 0 and r >> 5 == c)
        st = sum(1 << (r & 31) for r, k in zip(land, land_ok) if r >= 0 and r >> 5 == c and k)
        return (m & ~clr & 0xffffffff) | st

    def lap(self, done, n_act, out, B):
        T = self._scan()
        L = max(1, min(T // self.tf, n_act - done, K.LAP_MAX))
        self.sizes.append(L)
        ra = self.start if 0 < self.start < self.num else 0
        f_start = 0 if ra == 0 else int(self.pfx[ra >> 5]) + _popc(
            int(self.mask[ra >> 5]) & ((1 << (ra & 31)) - 1))
        # Every window's search reads the lap's masks before any landing;
        # lanes past L run only in the last lap (the next lap rewrites their
        # out[] positions).
        n_lanes = K.LAP_MAX if done + L >= n_act else L
        lanes = [self._window(w, L, T, f_start) for w in range(n_lanes)]
        land = [row for row, _ in lanes] + [-1] * (K.LAP_MAX - n_lanes)
        land_ok = [False] * K.LAP_MAX
        for w, (row, start_w) in enumerate(lanes):
            if done + w < B:
                out[0, done + w], out[1, done + w] = row, start_w
            if row >= 0:
                land_ok[w] = self._land(row)
                self.dirty[row >> 5] = True
        self.start = lanes[L - 1][1]
        if self.A1:
            anti = self._pack(self._anti_rows())
            for c in range(self.NC):
                d = bool(self.dirty[c])
                b = self._apply(int(self.base[c]), c, land, land_ok) if d else int(self.base[c])
                m = b & int(anti[c])
                if d or m != int(self.mask[c]):
                    self.anti_refreshes += not d
                    self._summary(c, m)
                    self.base[c], self.dirty[c] = b, False
        else:
            seen = {}
            for w in range(L):
                if land[w] < 0:
                    continue
                c = land[w] >> 5
                m = self._apply(int(self.mask[c]), c, land, land_ok)
                before = self._summary(c, m)
                if c in seen:
                    # The second landing's warp writes what the first wrote.
                    assert before == seen[c] == (int(self.mask[c]), int(self.cnt[c]),
                                                 int(self.mx[c]), int(self.arg[c]))
                    self.shared_refreshes += 1
                seen[c] = (int(self.mask[c]), int(self.cnt[c]), int(self.mx[c]),
                           int(self.arg[c]))
            self.dirty[:] = False
        return L

    def check_summaries(self):
        """The kept masks and summaries equal ones computed afresh from the
        state after the lap's landings."""
        fresh = self._base_rows(np.arange(self.NP)) & self._anti_rows()
        mask = self._pack(fresh)
        np.testing.assert_array_equal(self.mask, mask)
        for c in range(self.NC):
            rows = [r for r in range(c * 32, min(c * 32 + 32, self.NP)) if fresh[r]]
            assert self.cnt[c] == len(rows)
            if rows:
                best = max(self.total[r] for r in rows)
                assert (self.mx[c], self.arg[c]) == (best, min(r for r in rows
                                                              if self.total[r] == best))

    def run(self, B, n_act, ext0):
        out = torch.full((2, B), -1, dtype=torch.int32)
        done = 0
        while done < n_act:
            done += self.lap(done, n_act, out, B)
            self.check_summaries()
        carry = ext0._replace(
            req_r=self.req_r, nonzero=self.nonzero, pod_count=self.pod_count,
            fit_ok=self.fit_ok, fit_sc=self.fit_sc, ba=self.ba,
            anti_counts=torch.from_numpy(self.anti_counts), blocked=self.blocked,
            aux_cnt=self.aux_cnt, start=torch.tensor(self.start, dtype=torch.int32))
        return out, carry


# (draw: random_inputs, or general_inputs with anti terms; rows, live rows,
# steps, active pods, lanes)
LAP_MODEL = {
    "tf-1": (dict(to_find=1), 256, 200, 256, 256, {}),
    "feasible-0": (dict(infeasible=True), 256, 200, 64, 40, {}),
    "feasible-below-tf": (dict(to_find=200), 256, 200, 64, 64, {}),
    "lap-max-spill": (dict(to_find=2), 256, 230, 256, 250, {}),
    "start-in-chunk": (dict(start=77, to_find=9), 256, 200, 128, 128, {}),
    "start-0": (dict(start=0, to_find=7), 256, 200, 128, 128, {}),
    "start-past-num": (dict(start=230, to_find=9), 256, 200, 128, 100, {}),
    "num-below-np-odd": (dict(to_find=5), 250, 190, 128, 128, {}),
    "many-chunks": (dict(to_find=40), 2048, 1990, 256, 256, {}),
    "nominated": (dict(to_find=8), 256, 200, 256, 200, dict(nom=True)),
    "blocked": (dict(to_find=8), 256, 200, 256, 200, dict(ports=True)),
    "aux": (dict(to_find=8), 256, 200, 256, 200, dict(aux=True)),
    "anti-hostname": (dict(to_find=6, anti=1, anti_axis=HOST_AXIS), 256, 200, 256, 200, {}),
    "anti-repeated": (dict(to_find=6, anti=2, anti_axis=RACK_AXIS), 256, 200, 256, 200, {}),
    "every-lane": (dict(to_find=6, anti=2, anti_axis=RACK_AXIS), 256, 200, 256, 200,
                   dict(nom=True, ports=True, aux=True)),
}


def _lap_model_draw(seed, case):
    kw, cap, live, B, n_act, lanes = LAP_MODEL[case]
    if "anti" in kw:
        s, f, _facts = general_inputs(seed, cap, live, vmax=GVMAX, **kw)
    else:
        s, f = random_inputs(seed, cap, live, vmax=VMAX, **kw)
    if lanes.get("nom"):
        f = with_nominated_lane(f, nominated_lane(seed, cap, live))
    cnt = None
    if lanes.get("aux"):
        room, inc, cnt = aux_lane(seed, cap, live)
        f = with_aux_lane(f, room, inc)
    ts, tf = state_from_jax_numpy(s), features_from_jax_numpy(f)
    if "anti" in kw:
        tf = tf._replace(anti_self=torch.ones_like(tf.anti_self))
    ext0 = K.fresh_carry(ts, tf, max(tf.anti_counts.shape[1], 1), K._resource_eval_plain(
        tf, 0, ts.alloc_r, ts.alloc_pods, ts.req_r, ts.nonzero, ts.pod_count, *K._nom_lane(tf)))
    rng = np.random.default_rng(seed)
    if lanes.get("ports"):
        ext0 = ext0._replace(blocked=torch.from_numpy(rng.random(cap) < 0.3))
    if cnt is not None:
        ext0 = ext0._replace(aux_cnt=torch.from_numpy(cnt))
    return ts, tf, ext0, B, n_act, lanes.get("ports", False), lanes.get("aux", False)


@pytest.mark.parametrize("case", list(LAP_MODEL))
def test_lap_model_equals_the_plain_laps(case):
    """The kernel's bookkeeping, stepped lap by lap (its masks and summaries
    checked against fresh ones after every lap), gives the plain version's
    whole `out` and every carry lane, over two chained batches, with the
    same lap count and sizes."""
    ts, tf, ext0, B, n_act, ports, aux = _lap_model_draw(1500 + len(case), case)
    static_ok = K._static_masks_plain(ts, tf).static_ok
    strat = 1 if case in ("start-0", "aux") else 0
    mc = pc = ext0
    placed = 0
    for batch in range(2):
        model = _LapModel(ts, tf, strat, mc, static_ok, ports, aux)
        m_out, mc = model.run(B, n_act, mc)
        stats = {}
        p_out, pc = K._lap_schedule_plain(ts, tf, B, strat, pc, static_ok, n_act, ports, aux,
                                          stats=stats)
        assert torch.equal(m_out, p_out), f"out, batch {batch}"
        for name, a, b in zip(K.ScanCarry._fields, mc, pc):
            assert a.dtype == b.dtype and torch.equal(a, b), f"{name}, batch {batch}"
        assert model.sizes == stats["lap_sizes"]
        placed += int((p_out[0] >= 0).sum())
        if batch == 0:
            first = model
    assert placed > 0 or case == "feasible-0"
    want = {"tf-1": first.shared_refreshes > 0 and max(first.sizes) == K.LAP_MAX,
            "lap-max-spill": max(first.sizes) == K.LAP_MAX,
            "feasible-below-tf": max(first.sizes) == 1,
            "start-past-num": first.cut_ranges > 0,
            "many-chunks": first.multi_round > 0,
            "anti-repeated": first.anti_refreshes > 0}
    assert want.get(case, True), f"the {case} draw misses the edge it is named for"


@pytest.mark.parametrize("NP,R,FR,on_chip", [(8192, 7, 2, True), (16384, 7, 2, True),
                                             (16385, 7, 2, False), (5000, 600, 2, False)],
                         ids=["np-8192", "np-16384", "np-16385", "wide-rows"])
def test_lap_row_state_tier(recorded_launches, monkeypatch, NP, R, FR, on_chip):
    """The lap's row state stays in shared memory (a null `work`) up to
    16384 rows and 220 KB, and takes a device-memory buffer of its layout's
    size above either; the wrapper passes it in the launcher's slot."""
    assert (K._lap_work(NP, R, FR, "cpu") is None) == on_chip
    nc = (NP + 31) // 32
    assert K._lap_layout_bytes(NP, R, FR) >= 8 * NP + 8 * nc + 24 * nc + 256 * (3 * R + 2)
    if not on_chip:
        assert K._lap_work(NP, R, FR, "cpu").numel() * 8 == K._lap_layout_bytes(NP, R, FR)
    if NP != 8192:
        return
    _js, _jf, ts, tf = _both(19)
    static_ok = K._static_masks_plain(ts, tf).static_ok
    ext0 = K.fresh_carry(ts, tf, VMAX, K._resource_eval_plain(
        tf, 0, ts.alloc_r, ts.alloc_pods, ts.req_r, ts.nonzero, ts.pod_count))
    K._lap_schedule_cuda(ts, tf, 512, 0, ext0, static_ok, 300)
    monkeypatch.setattr(K, "LAP_SMEM_ROWS", 0)  # every draw above the tier
    K._lap_schedule_cuda(ts, tf, 512, 0, ext0, static_ok, 300)
    (_n1, on), (_n2, off) = recorded_launches
    work = [p.name for p in K._build.signature("lap_schedule")].index("work")
    assert on[work] is None and isinstance(off[work], int)


def _lap_floor_div(a: int, b: int) -> int:
    """csrc/lap_schedule.cu's lap_floor_div in Python: float is IEEE
    float64, float(int) rounds to nearest like the kernel's conversion, and
    the remainder's true value fits int64, so the kernel's wrapping product
    gives it exactly."""
    if 0 < b < 1 << 62:
        d = float(a) / float(b)
        if abs(d) < 2.0 ** 50:
            q = math.floor(d)
            r = a - q * b
            assert -b <= r < 2 * b
            return q - (r < 0) + (r >= b)
    return a // b


@pytest.mark.parametrize("kind", ["fit-scores", "shares", "exact-multiples", "wide"])
def test_lap_floor_div_equals_floored_division(kind):
    """The landing's division (a float64 quotient and one exact correction)
    equals Python's floored // on the operands the fit and
    BalancedAllocation scores give it and on wide int64 draws, the fast
    path's edges (|quotient| near 2^50, exact multiples, negative
    numerators) included."""
    rng = np.random.default_rng(len(kind))
    n = 20000
    if kind == "fit-scores":     # (alloc - used) * 100 over max(alloc, 1)
        b = rng.integers(1, 1 << 45, n)
        a = (b - rng.integers(-(1 << 20), 1 << 45, n)) * 100
    elif kind == "shares":       # used * 1e6 over an allocatable, and the fit sum
        b = rng.integers(1, 1 << 40, n)
        a = rng.integers(0, 1 << 40, n) * 1_000_000
    elif kind == "exact-multiples":
        b = rng.integers(1, 1 << 31, n)
        a = b * rng.integers(-(1 << 31), 1 << 31, n) + rng.integers(-1, 2, n)
    else:
        b = np.where(rng.random(n) < 0.5, rng.integers(1, 1 << 62, n), rng.integers(1, 1 << 12, n))
        a = rng.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64)
    cases = list(zip(a.tolist(), b.tolist()))
    cases += [(2 ** 50 * 7 - 1, 7), (2 ** 50 * 7, 7), (-(2 ** 50) * 7 + 1, 7), (-1, 1 << 61),
              ((1 << 63) - 1, 1), (-(1 << 63), 3), (0, 5), (-5, 5), (-6, 5)]
    for x, y in cases:
        assert _lap_floor_div(x, y) == x // y, (x, y)
