"""The PyTorch port's batch kernels against the JAX reference, on the CPU.

One seeded numpy draw (kubernetes_tpu_torch.testing.kernel_inputs) feeds
the JAX package's functions (as jnp arrays) and the port's (through the
carry-across functions state_from_jax_numpy / features_from_jax_numpy /
carry_from_jax_numpy). On CPU tensors the port's wrappers run their plain
PyTorch versions, so this holds the plain versions equal to JAX; the CUDA
kernels are held equal to the plain versions on the card by chip_smoke.py.
Every comparison is exact: all quantities are integers or booleans."""

import ctypes
import math
import shutil
import subprocess

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
    patch_inputs,
    placement_inputs,
    random_inputs,
    scatter_inputs,
    stage_rows,
    static_edge_inputs,
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


# The edges of static_masks' design: static_edge_inputs arguments.
MASK_EDGES = {
    "no-taints": dict(taints=0),
    "no-tolerations": dict(tolerations=0),
    "neither": dict(taints=0, tolerations=0),
    "padded-taints": dict(pad_taints=True),
    "wide-taints": dict(taints=16, tolerations=5),
    **{f"gate-{i}-off": dict(enable_off=(i,)) for i in range(4)},
}


@pytest.mark.parametrize("case", list(CASES) + list(MASK_EDGES))
def test_static_masks(case):
    if case in MASK_EDGES:
        js, jf, ts, tf = _convert(*static_edge_inputs(11, 256, 200, **MASK_EDGES[case]))
    else:
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
    for name in ("_lap_schedule_plain", "_scan_general_plain"):
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
    K.scatter_rows(ts, *stage_rows(K.DeviceNodeState(*[t[:1] for t in ts[:-1]],
                                                     ts.topo[:, :1]), [3]))
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
                    "S", "n_loc", "gen", "wait_mcycles", "port_selfblock", "has_aux",
                    "rows_cap", "lane_bytes")
                   + tuple(f"off_{f}" for f in K.DeviceNodeState._fields))
        optional = {p.name for p in sig if p.optional}
        lane = name in ("resource_eval", "lap_schedule", "scan_general", "patch_carry_rows",
                        "schedule_placements")
        # The schedule kernels' blocked lane (host ports) and aux_cnt lane
        # (CSI attach limits) are nullable too, and so is the lap's
        # device-memory buffer (null: its row state fits shared memory) and
        # the placement lanes' (null: every lane fits shared memory); the
        # sharded lap writes the results only on the card of shard 0, and
        # takes a device-memory buffer only past its on-chip tier.
        lanes = {"lap_schedule": {"blocked", "aux_cnt", "work"},
                 "scan_general": {"blocked", "aux_cnt"},
                 "schedule_placements": {"lane_scratch"}}
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
    K._scan_general_cuda(ts, tf, 64, 0, ext0, K._static_masks_plain(ts, tf), 40,
                         K.PlanFacts(has_pns=True))
    s, f, vr, vv = victim_inputs(17, 256, 200, 16)
    K._dry_run_preemption_cuda(state_from_jax_numpy(s), features_from_jax_numpy(f),
                               *victims_from_jax_numpy(vr, vv), 16)
    rows = K.DeviceNodeState(*[t[:2] for t in ts[:-1]], ts.topo[:, :2])
    new_state = K._scatter_rows_cuda(ts, *stage_rows(rows, [5, 9]))
    new_carry = K._patch_carry_rows_cuda(ts, tf, ext0, torch.tensor([5, 9], dtype=torch.int32),
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
    # The row patches read the old tensors and write new ones: the
    # wrappers return the new ones, and in place both are the given ones.
    sc = dict(zip([p.name for p in K._build.signature("scatter_rows")], recorded_launches[5][1]))
    assert [sc[n] for n in ("alloc_r", "topo", "out_alloc_r", "out_topo")] == [
        ts.alloc_r.data_ptr(), ts.topo.data_ptr(), new_state.alloc_r.data_ptr(),
        new_state.topo.data_ptr()]
    assert not {t.data_ptr() for t in ts} & {t.data_ptr() for t in new_state}
    pc = dict(zip([p.name for p in K._build.signature("patch_carry_rows")],
                  recorded_launches[6][1]))
    assert [pc[n] for n in ("req_r", "ba", "out_req_r", "out_ba")] == [
        ext0.req_r.data_ptr(), ext0.ba.data_ptr(), new_carry.req_r.data_ptr(),
        new_carry.ba.data_ptr()]
    assert new_carry.dns_counts is ext0.dns_counts
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
    # aux_cnt (placements: the flag, each lane counting its own landings)
    # and the batch's room and increment.
    aux = K.PlanFacts(has_aux=True)
    recorded_launches.clear()
    K._lap_schedule_cuda(ts, tf, 512, 0, ext0, static_ok, 300, has_aux=True)
    K._scan_general_cuda(ts, tf, 64, 0, ext0, K._static_masks_plain(ts, tf), 40,
                         aux._replace(has_pns=True))
    K._schedule_placements_cuda(ts, tf, 8, 0, VMAX, aux, masks, 5)
    for name, args in recorded_launches:
        sig = {p.name: a for p, a in zip(K._build.signature(name), args)}
        if name == "schedule_placements":
            assert sig["has_aux"] == 1
        else:
            cnt = sig["aux_cnt"]
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
    were. Lane 0 of a multi-lane draw is a padded lane (no row), lane 1 a
    row, lane 2 ~100 rows; the last lane holds every row, the padded rows
    past num_nodes too (never feasible)."""
    placed = 0
    for seed in (41, 42):
        s, f, facts, masks, ov = placement_inputs(seed, 256, 200, lanes, vmax=GVMAX,
                                                  pns=seed == 42, na=seed == 42,
                                                  **PLACEMENT_TABLES[tables])
        masks[-1, 200:] = True
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
def test_schedule_placements_wrapper_marshals_lanes(recorded_launches, monkeypatch, overrides):
    """The CUDA wrapper passes the plan's tables (per_lane 0) or the
    overrides (per_lane 1), the masks, the shared node state, the lanes'
    modes and the out buffer, and no scratch of the node rows: while a lane
    of every row fits on chip no other tensor at all, and past the on-chip
    budget one slice a lane, sized for the widest placement."""
    s, f, facts, masks, ov = placement_inputs(43, 256, 200, 4, vmax=GVMAX, dns=1, sa=1,
                                              overrides=overrides)
    _js, _jf, ts, tf = _convert(s, f)
    t_ov = None if ov is None else tuple(torch.from_numpy(a) for a in ov)
    t_masks = torch.from_numpy(masks)
    m = K._static_masks_plain(ts, tf)
    monkeypatch.setattr(K, "static_masks", lambda st, ft: m)
    facts = K.PlanFacts(**dict(facts, port_selfblock=True))
    out = K._schedule_placements_cuda(ts, tf, 8, 1, GVMAX, facts, t_masks, 6, t_ov)
    [(name, args)] = recorded_launches
    sig = {p.name: a for p, a in zip(K._build.signature(name), args)}
    assert (sig["NP"], sig["P"], sig["B"], sig["n_act"], sig["V"], sig["C1"], sig["C2"],
            sig["per_lane"]) == (256, 4, 8, 6, GVMAX, 1, 1, int(overrides))
    assert (sig["port_selfblock"], sig["has_aux"], sig["rows_cap"]) == (1, 0, 256)
    tables = t_ov or (tf.dns_counts, tf.dns_dom, tf.dns_forced0, tf.sa_counts, tf.sa_wq)
    for field, t in zip(("dns_counts", "dns_dom", "dns_forced0", "sa_counts", "sa_wq"), tables):
        assert sig[field] == t.data_ptr(), field
    assert sig["masks"] == t_masks.data_ptr() and sig["out"] == out.data_ptr()
    for field in ("req_r", "nonzero", "pod_count", "alloc_r", "topo"):
        assert sig[field] == getattr(ts, field).data_ptr(), field
    assert tuple(out.shape) == (4, 2, 8)
    given = {t.data_ptr() for t in list(ts) + list(tf) + list(m) + list(tables)}
    pointers = [a for p, a in zip(K._build.signature(name), args) if p.dtype is not None]
    assert sig["lane_scratch"] is None and sig["lane_bytes"] == 0
    assert set(pointers) - {None} <= given | {t_masks.data_ptr(), out.data_ptr()}
    # Past the budget the widest placement (one read of the card) sizes a
    # slice a lane; the rows of a lane are never the node rows'.
    monkeypatch.setattr(K, "PLACEMENT_SMEM_MAX", 1024)
    recorded_launches.clear()
    K._schedule_placements_cuda(ts, tf, 8, 1, GVMAX, facts, t_masks, 6, t_ov)
    [(name, args)] = recorded_launches
    sig = {p.name: a for p, a in zip(K._build.signature(name), args)}
    widest = int(t_masks.sum(dim=1).max())
    assert sig["rows_cap"] == widest < 256
    assert isinstance(sig["lane_scratch"], int)
    assert sig["lane_bytes"] == K._placement_lane_bytes(widest, GVMAX, 1, 1, False) > 1024
    assert K._placement_lane_bytes(widest, GVMAX, 1, 1, False) < K._placement_lane_bytes(
        256, GVMAX, 1, 1, False)
    # A plan outside the placement restriction is refused before a launch.
    s, f, facts = general_inputs(44, 256, 200, vmax=GVMAX, anti=1)
    _js, _jf, ts, tf = _convert(s, f)
    with pytest.raises(ValueError, match="placement restriction"):
        K._schedule_placements_cuda(ts, tf, 8, 0, GVMAX, K.PlanFacts(**facts), t_masks, 6)
    assert len(recorded_launches) == 1


@pytest.fixture(scope="module")
def gen_sizes_lib(tmp_path_factory):
    """csrc/gen_sizes.h built alone by the host compiler: lane_layout's
    device-memory bytes and the on-chip budget, as the launcher reads them."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host C++ compiler to build csrc/gen_sizes.h")
    d = tmp_path_factory.mktemp("gen_sizes")
    src, so = d / "sizes.cpp", d / "libsizes.so"
    src.write_text('#include "gen_sizes.h"\n'
                   'extern "C" long long lane_bytes(int n, int V, int C1, int C2, int carried) {\n'
                   '  return (long long)lane_layout(n, V, C1, C2, carried != 0, 0).off_chip;\n}\n'
                   'extern "C" long long smem_max() { return (long long)GEN2_SMEM_MAX; }\n'
                   'extern "C" long long gen_maxc() { return GEN_MAXC; }\n')
    subprocess.run([gxx, "-std=c++17", "-shared", "-fPIC", "-I", K._build.CSRC, "-o", str(so),
                    str(src)], check=True)
    lib = ctypes.CDLL(str(so))
    lib.lane_bytes.argtypes = [ctypes.c_int] * 5
    lib.lane_bytes.restype = lib.smem_max.restype = lib.gen_maxc.restype = ctypes.c_longlong
    return lib


@pytest.mark.parametrize("carried", [False, True], ids=["normalized", "carried"])
def test_placement_lane_bytes_match_the_c_layout(gen_sizes_lib, carried):
    """The wrapper's copy of a placement lane's layout, which sizes the
    scratch slice a lane, equals lane_layout's count over row counts
    around the chunk and warp boundaries, table widths and table counts up
    to GEN_MAXC; the on-chip budget and GEN_MAXC are the header's."""
    assert (K.PLACEMENT_SMEM_MAX, K.GEN_MAXC) == (gen_sizes_lib.smem_max(),
                                                  gen_sizes_lib.gen_maxc())
    for n in (0, 1, 31, 32, 33, 100, 511, 512, 513, 8192, 19990, 50000):
        for V in (1, 3, 64, 8192):
            for C1 in (0, 1, 2, K.GEN_MAXC):
                for C2 in (0, 1, K.GEN_MAXC):
                    assert K._placement_lane_bytes(n, V, C1, C2, carried) == \
                        gen_sizes_lib.lane_bytes(n, V, C1, C2, int(carried)), (n, V, C1, C2)


# ---------------------------------------------------------------------------
# The row patches: scatter_rows and patch_carry_rows, copy-on-write in one
# launch, and the staging ring their uploads go through
# ---------------------------------------------------------------------------


def _bytes(t: torch.Tensor) -> np.ndarray:
    """A contiguous tensor's bytes as a flat writable numpy view."""
    return t.numpy().reshape(-1).view(np.uint8)


class _CowModel:
    """A numpy model of the copy-on-write row patch kernels, with their
    constants read from the sources: a block owns `block_rows` rows of
    every field (scatter_rows.cu, patch_carry_rows.cu); cow_copy
    (kernels.cuh) copies the block's segments, COW_CHUNK at a time, as one
    range of 16-byte vectors, `threads` x COW_UNROLL a round, where dst and
    src are both aligned, and bytes for the rest; pass_hits walks idx
    `threads` x <prefix>_HIT_UNROLL entries a pass, thread t taking
    entries t, t + threads, ..., and compacts the entries that land in the
    block thread by thread (the carry patch skipping an entry equal to the
    one before it); the hits' elements are then written. The new tensors
    start filled with a poison byte, so a byte no block copies or writes
    shows. `misalign` shifts the modelled addresses of the new tensors (the
    byte path)."""

    def __init__(self, source: str, prefix: str, misalign: int = 0):
        d = K._build.defines(source)
        c = K._build.defines("kernels.cuh")
        self.threads, self.block_rows = d[f"{prefix}_THREADS"], d[f"{prefix}_BLOCK_ROWS"]
        self.chunk, self.unroll = c["COW_CHUNK"], c["COW_UNROLL"]
        self.hit_unroll = d[f"{prefix}_HIT_UNROLL"]
        self.dedup = prefix == "PATCH"  # an entry equal to the one before it is skipped
        self.misalign = misalign
        self.vector_bytes = self.byte_copies = 0

    def blocks(self, NP: int):
        for lo in range(0, NP, self.block_rows):
            yield lo, min(lo + self.block_rows, NP)

    def cow_copy(self, segs) -> None:
        """segs: (dst bytes, src bytes, dst address, src address), each the
        block's range of one field, src None in place."""
        for c0 in range(0, len(segs), self.chunk):
            chunk = segs[c0:c0 + self.chunk]
            vecs = [len(d) >> 4 if src is not None and ((da | sa) & 15) == 0 else 0
                    for d, src, da, sa in chunk]
            pre = np.concatenate([[0], np.cumsum(vecs)]).astype(np.int64)
            # Every vector index of the range is one thread's in one round.
            t = np.arange(self.threads)[:, None, None]
            rounds = np.arange(-(-int(pre[-1]) // (self.threads * self.unroll)))[None, :, None]
            u = np.arange(self.unroll)[None, None, :]
            i = (t + rounds * self.threads * self.unroll + u * self.threads).reshape(-1)
            i = np.sort(i[i < pre[-1]])
            assert np.array_equal(i, np.arange(pre[-1])), "a vector copied twice or never"
            for (dst, src, _da, _sa), n_vec in zip(chunk, vecs):
                if src is None:
                    continue
                dst[:16 * n_vec] = src[:16 * n_vec]
                dst[16 * n_vec:] = src[16 * n_vec:]
                self.vector_bytes += 16 * n_vec
                self.byte_copies += len(dst) - 16 * n_vec

    def hits(self, idx: np.ndarray, lo: int, hi: int):
        """The entries of idx in [lo, hi), a pass at a time, each pass's
        compacted thread by thread (a thread's own in entry order)."""
        size = self.threads * self.hit_unroll
        for p0 in range(0, len(idx), size):
            j = p0 + np.arange(self.hit_unroll)[None, :] * self.threads \
                + np.arange(self.threads)[:, None]
            j = j[j < len(idx)]  # thread-major: thread t's entries, then t + 1's
            keep = (idx[j] >= lo) & (idx[j] < hi)
            if self.dedup:
                keep &= (j == 0) | (idx[j] != idx[np.maximum(j - 1, 0)])
            yield from j[keep].tolist()

    def segs(self, new, old, lo, hi, row_bytes, strides=None):
        """The block's segments of each field: rows [lo, hi) of a
        row-major field (`row_bytes` a row), or of each of `strides`' axis
        rows (topo: a row of `row_bytes` bytes per axis every stride)."""
        out = []
        for f, (n, o, rb) in enumerate(zip(new, old, row_bytes)):
            nb, ob = _bytes(n), None if o is n else _bytes(o)
            starts = [lo * rb] if strides is None or strides[f] is None else \
                [k * strides[f] + lo * rb for k in range(n.shape[0])]
            for off in starts:
                out.append((nb[off:off + (hi - lo) * rb],
                            None if ob is None else ob[off:off + (hi - lo) * rb],
                            512 + self.misalign + off, 512 + off))
        return out

    def fresh(self, tensors, in_place: bool):
        if in_place:
            return list(tensors)
        out = [torch.empty_like(t) for t in tensors]
        for t in out:
            _bytes(t)[:] = 0xA5
        return out

    def scatter(self, state, idx: np.ndarray, packed: torch.Tensor, in_place: bool):
        NP, D = state.valid.shape[0], len(idx)
        R, T, Kx = state.alloc_r.shape[1], state.taint_key.shape[1], state.topo.shape[0]
        rows = K.unpack_rows(packed, D, R, T, Kx)
        new = self.fresh(state, in_place)
        widths = [1 if t.dim() == 1 else t.shape[1] for t in state[:-1]] + [1]
        row_bytes = [w * t.element_size() for w, t in zip(widths, state)]
        strides = [None] * 11 + [4 * NP]
        for lo, hi in self.blocks(NP):
            self.cow_copy(self.segs(new, state, lo, hi, row_bytes, strides))
            for j in self.hits(idx, lo, hi):
                r = int(idx[j])
                for f in range(11):
                    new[f][r] = rows[f][j]
                new[11][:, r] = rows.topo[:, j]
        return K.DeviceNodeState(*new)

    def patch(self, state, f, carry, idx: np.ndarray, req_rows, nz_rows, cnt_rows,
              fit_strategy: int, in_place: bool):
        NP, R = state.alloc_r.shape
        new = self.fresh(carry[:6], in_place)
        row_bytes = [8 * R, 16, 4, 1, 8, 8]
        for lo, hi in self.blocks(NP):
            self.cow_copy(self.segs(new, carry[:6], lo, hi, row_bytes))
            for j in self.hits(idx, lo, hi):
                r = int(idx[j])
                at = torch.tensor([r])
                ok, sc, ba = K._resource_eval_plain(
                    f, fit_strategy, state.alloc_r[at], state.alloc_pods[at], req_rows[j:j + 1],
                    nz_rows[j:j + 1], cnt_rows[j:j + 1], *K._nom_lane(f, at))
                for lane, v in zip(new, (req_rows[j], nz_rows[j], cnt_rows[j], ok[0], sc[0],
                                         ba[0])):
                    lane[r] = v
        return carry._replace(req_r=new[0], nonzero=new[1], pod_count=new[2], fit_ok=new[3],
                              fit_sc=new[4], ba=new[5])


def _scatter_draw(seed: int, NP: int, D: int, R: int, T: int, Kx: int, order: str):
    """(state, idx [D] i32, rows) of one scatter_inputs draw, as tensors."""
    s, at, rows = scatter_inputs(seed, NP, D, r_slots=R, taints=T, axes=Kx, order=order,
                                 block_rows=K._build.defines("scatter_rows.cu")[
                                     "SCATTER_BLOCK_ROWS"])
    return (state_from_jax_numpy(s), torch.from_numpy(at.astype(np.int32)),
            state_from_jax_numpy(rows))


SCATTER_MODEL_CASES = [
    # NP, D, R, T, K, order, in_place, misalign
    (256, 1, 7, 4, 4, "sorted", False, 0),
    (200, 64, 7, 4, 4, "shuffled", False, 0),     # NP not a multiple of the block
    (4100, 2048, 7, 4, 4, "shuffled", False, 0),
    (4100, 2500, 7, 4, 4, "shuffled", False, 0),  # two passes of idx
    (203, 9, 1, 0, 0, "sorted", False, 0),        # R 1, no taint slot, no topology axis
    (300, 40, 9, 3, 5, "shuffled", True, 0),
    (256, 64, 7, 4, 4, "sorted", True, 0),
    (130, 12, 7, 4, 4, "shuffled", False, 4),     # the new tensors off a 16-byte boundary
]


@pytest.mark.parametrize("NP,D,R,T,Kx,order,in_place,misalign", SCATTER_MODEL_CASES)
def test_scatter_rows_block_model_steps_like_the_plain_version(NP, D, R, T, Kx, order, in_place,
                                                               misalign):
    """The block decomposition of scatter_rows, modelled in numpy, equals
    its plain version (clone and index_copy_ per field): every byte of the
    new state copied or patched once, the old state unchanged unless in
    place."""
    state, idx, rows = _scatter_draw(90 + NP + D, NP, D, R, T, Kx, order)
    _at, packed = stage_rows(rows, idx)
    before = [t.clone() for t in state]
    want = K._scatter_rows_plain(K.DeviceNodeState(*[t.clone() for t in state]), idx, packed,
                                 in_place)
    model = _CowModel("scatter_rows.cu", "SCATTER", misalign)
    got = model.scatter(state, idx.numpy(), packed, in_place)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and torch.equal(a, b), i
    # The copy took the vectors (none in place), and bytes where the
    # modelled addresses are off a 16-byte boundary.
    assert (model.vector_bytes > 0) == (not in_place and not misalign)
    assert (model.byte_copies > 0) == (not in_place and bool(misalign or NP % 16))
    if not in_place:
        for i, (a, b) in enumerate(zip(state, before)):
            assert torch.equal(a, b), i
        # The plain version's new state is equal to what the rows say.
        at = idx.long()
        assert torch.equal(want.topo[:, at], rows.topo)
        assert torch.equal(want.alloc_r[at], rows.alloc_r)


PATCH_MODEL_CASES = [
    # NP, live rows, rows, tier, R, fit strategy, nominated lane, in_place
    (256, 200, 1, 32, 7, 0, False, False),
    (256, 200, 5, 32, 7, 0, False, False),
    (256, 200, 150, 256, 9, 1, True, False),
    (200, 190, 100, 2048, 7, 0, True, True),
    (4100, 4000, 1500, 2048, 7, 1, False, False),
    (4100, 4000, 3000, 4096, 7, 0, False, False),  # two passes of idx
    (130, 120, 64, 256, 3, 1, False, True),
]


@pytest.mark.parametrize("NP,nn,k,tier,R,strat,lane,in_place", PATCH_MODEL_CASES)
def test_patch_carry_rows_block_model_steps_like_the_plain_version(NP, nn, k, tier, R, strat,
                                                                   lane, in_place):
    """The block decomposition of patch_carry_rows, modelled in numpy, equals
    its plain version on a chained carry, with the tier's duplicate padding;
    the given carry keeps its values unless in place."""
    seed = 300 + NP + k + tier
    s, f = random_inputs(seed, NP, nn, r_slots=R)
    if lane:
        f = with_nominated_lane(f, nominated_lane(seed, NP, nn, r_slots=R))
    st, ft = state_from_jax_numpy(s), features_from_jax_numpy(f)
    carry = None
    for _chain in range(2):
        _out, carry = K.schedule_batch(st, ft, 64, strat, VMAX, K.PlanFacts(), n_active=40,
                                       carry_in=carry)
    carry = carry._replace(**{n: getattr(carry, n).clone() for n in
                              ("req_r", "nonzero", "pod_count", "fit_ok", "fit_sc", "ba")})
    idx, req, nz, cnt = [torch.from_numpy(a) for a in patch_inputs(seed, s, nn, k, tier)]
    before = [t.clone() for t in carry[:6]]
    want = K._patch_carry_rows_plain(st, ft, K.ScanCarry(*[t.clone() for t in carry]), idx, req,
                                     nz, cnt, strat, in_place)
    got = _CowModel("patch_carry_rows.cu", "PATCH").patch(st, ft, carry, idx.numpy(), req, nz,
                                                          cnt, strat, in_place)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and torch.equal(a, b), i
    if not in_place:
        for i, (a, b) in enumerate(zip(carry[:6], before)):
            assert torch.equal(a, b), i
    assert bool((want.fit_ok != before[3]).any()) or k < 32


def test_scatter_wrapper_passes_each_fields_rows_as_a_view_of_the_upload(recorded_launches):
    """The kernel reads each field's packed rows at a byte offset into the
    one upload that the wrapper passes: where the plain version reads them
    (unpack_rows), over row counts and widths around the 16-byte
    boundaries, K and T 0 included."""
    names = [p.name for p in K._build.signature("scatter_rows")]
    fields = K.DeviceNodeState._fields
    assert [n for n in names if n.startswith("off_")] == [f"off_{f}" for f in fields]
    n = 0
    for D in (1, 3, 4, 5, 31, 64, 2049):
        for R, T, Kx in ((7, 4, 4), (1, 0, 0), (9, 3, 5), (2, 1, 1), (7, 40, 16)):
            s, at, rows = scatter_inputs(990 + D, 2112, D, r_slots=R, taints=T, axes=Kx)
            state = K.DeviceNodeState(*[torch.from_numpy(np.ascontiguousarray(a)) for a in s])
            idx, packed = stage_rows(rows, at)
            K._scatter_rows_cuda(state, idx, packed)
            args = dict(zip(names, recorded_launches[n][1]))
            n += 1
            views = K.unpack_rows(packed, D, R, T, Kx)
            assert args["packed"] == packed.data_ptr()
            assert [args["packed"] + args[f"off_{f}"] for f, v in zip(fields, views)
                    if v.numel()] == [v.data_ptr() for v in views if v.numel()]
            for f, v, r in zip(fields, views, rows):
                np.testing.assert_array_equal(v.numpy(), r, err_msg=f"{f} D {D} R {R}")
            end = packed.data_ptr() + packed.numel()
            assert all(v.data_ptr() + v.numel() * v.element_size() <= end
                       for v in views if v.numel())
            assert args["D"] == D and args["idx"] == idx.data_ptr()


class _FakeEvent:
    """An upload's event in the ring model: complete once `done` is set;
    synchronize() waits for it (here: records the wait and completes)."""

    def __init__(self, log, slot):
        self.log, self.slot, self.done = log, slot, False

    def query(self):
        return self.done

    def synchronize(self):
        self.log.append(("wait", self.slot))
        self.done = True


def test_staging_ring_rewrites_a_buffer_only_after_its_event():
    """The staging ring hands its buffers out in turn; a buffer is written
    again only after the event recorded at its last upload, and each upload
    carries the bytes packed for it (on the CPU: a copy, so a later
    take cannot change it)."""
    from kubernetes_tpu_torch.ops.staging import SLOTS, StagingRing

    log, events = [], []

    def record(device, spent):
        # The slot's last event comes back once it completed.
        assert spent is None or (spent.done and spent.slot == len(events) % SLOTS)
        ev = _FakeEvent(log, len(events) % SLOTS)
        events.append(ev)
        return ev

    ring = StagingRing("cpu", record=record)
    uploads, n_up = [], 3 * SLOTS + 1
    for n in range(n_up):
        size = 16 + 8 * n
        buf = ring.take(size)
        slot = n % SLOTS
        if n >= SLOTS:
            # The slot's previous upload was waited on before this take
            # handed its buffer out, and only that one.
            assert log[-1] == ("wait", slot) and events[n - SLOTS].done
            assert not any(e.done for e in events[n - SLOTS + 1:n])
        buf[:] = n
        log.append(("write", slot))
        uploads.append(ring.upload(size))
    for n, up in enumerate(uploads):
        assert up.numel() == 16 + 8 * n and bool((up == n).all())
    writes = [(i, s) for i, (kind, s) in enumerate(log) if kind == "write"]
    for (i, s), (j, _s) in zip(writes[SLOTS:], writes):
        # Between two writes of one slot lies a wait on that slot.
        assert ("wait", s) in log[j:i]
    assert ring.uploads == n_up
    # Every event was still pending when its buffer came round.
    assert ring.waits == n_up - SLOTS
    # A completed event is not waited on.
    events[-SLOTS].done = True
    n_log = len(log)
    ring.take(8)
    assert len(log) == n_log and ring.waits == n_up - SLOTS
    # A buffer grows to the size asked for.
    assert ring.take(10000).nbytes == 10000


def test_stage_scatter_and_carry_patch_upload_what_they_pack():
    """One staging buffer a patch: idx and the packed rows of a flush, and
    idx and the aggregates of a carry patch, are views of one upload, equal
    to the host rows."""
    from kubernetes_tpu_torch.ops.staging import StagingRing

    s, _f = random_inputs(95, 256, 200)
    fields, topo = [np.ascontiguousarray(a) for a in s[:-1]], np.asarray(s[-1])
    ring = StagingRing("cpu")
    rows = [250, 3, 77, 0]
    idx, packed = K.stage_scatter(ring, fields, topo, rows, at=[5, 6, 7, 8])
    assert idx.tolist() == [5, 6, 7, 8] and ring.uploads == 1
    got = K.unpack_rows(packed, 4, fields[0].shape[1], fields[5].shape[1], topo.shape[0])
    for a, g in zip(fields, got[:-1]):
        np.testing.assert_array_equal(a[rows], g.numpy())
    np.testing.assert_array_equal(topo[:, rows], got.topo.numpy())
    staged = K.stage_carry_patch(ring, rows + [0] * 28, fields[2], fields[3], fields[4])
    assert ring.uploads == 2 and staged[0].tolist() == rows + [0] * 28
    for a, g in zip((fields[2], fields[3], fields[4]), staged[1:]):
        np.testing.assert_array_equal(a[rows + [0] * 28], g.numpy())
    assert len({t.untyped_storage().data_ptr() for t in staged}) == 1


def test_row_patches_in_place_pass_the_old_tensors_as_the_new(recorded_launches):
    """In place, the launchers get the given tensors as old and new (the
    kernels then write only the rows), and the wrappers return them."""
    _js, _jf, ts, tf = _both(18)
    fit = K._resource_eval_plain(tf, 0, ts.alloc_r, ts.alloc_pods, ts.req_r, ts.nonzero,
                                 ts.pod_count)
    ext0 = K.fresh_carry(ts, tf, VMAX, fit)
    rows = K.DeviceNodeState(*[t[:2] for t in ts[:-1]], ts.topo[:, :2])
    idx = torch.tensor([5, 9], dtype=torch.int32)
    packed = stage_rows(rows, idx)[1]
    assert K._scatter_rows_cuda(ts, idx, packed, in_place=True) is ts
    carry = K._patch_carry_rows_cuda(ts, tf, ext0, idx, ts.req_r[:2], ts.nonzero[:2],
                                     ts.pod_count[:2], 0, in_place=True)
    assert all(a is b for a, b in zip(carry, ext0))
    for (name, args), n in zip(recorded_launches, (12, 6)):
        sig = [p.name for p in K._build.signature(name)]
        old = [args[sig.index(p)] for p in sig if f"out_{p}" in sig]
        new = [args[sig.index(p)] for p in sig if p.startswith("out_")]
        assert len(old) == len(new) == n and old == new, name
    with pytest.raises(ValueError, match="packed rows"):
        K._scatter_rows_cuda(ts, idx, packed[:-16])


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


# ---------------------------------------------------------------------------
# schedule_placements' lanes (csrc/schedule_placements.cu): a block holds
# only its placement's rows, as an ascending list of row ids. The kernel's
# bookkeeping over that list is modelled in numpy and stepped against the
# plain version, so a position that drifts from its row shows here.
# ---------------------------------------------------------------------------


def _compact_rows(mask, static_ok, nrows, nw=16):
    """The kernel's compaction of one lane: warp w counts the rows of its
    run of 32-row chunks (a ballot a chunk), the block prefix of the
    counts places each warp's rows, and a row's position is its warp's
    offset plus the rows before it in the warp's run."""
    nchunks = (nrows + 31) // 32
    cpw = -(-nchunks // nw)
    keep = np.zeros(nchunks * 32, bool)
    keep[:nrows] = mask[:nrows] & static_ok[:nrows]
    runs = [range(w * cpw, min(nchunks, (w + 1) * cpw)) for w in range(nw)]
    counts = [sum(int(keep[32 * k:32 * k + 32].sum()) for k in run) for run in runs]
    rows = np.full(sum(counts), -1, np.int64)
    for w, run in enumerate(runs):
        pos = sum(counts[:w])
        for k in run:
            ballot = keep[32 * k:32 * k + 32]
            for lane in np.nonzero(ballot)[0]:
                rows[pos + int(ballot[:lane].sum())] = 32 * k + lane
            pos += int(ballot.sum())
    return rows


def _lower_bound32(rows, x):
    """warp_lower_bound: the positions whose row is below x, found in
    rounds of 32 samples (one ballot each)."""
    lanes = np.arange(32)

    def below(idx, valid):
        return int((valid & (rows[np.minimum(idx, len(rows) - 1)] < x)).sum())

    lo, n = 0, len(rows)
    while n > 32:
        stride = (n + 31) >> 5
        c = below(lo + lanes * stride, lo + lanes * stride < lo + n)
        if c == 0:
            return lo
        nlo = lo + (c - 1) * stride + 1
        lo, n = nlo, min(lo + c * stride, lo + n) - nlo
    return lo + below(lo + lanes, lanes < n)


def _compact_ranks(ok, rows, start, num, to_find, NP):
    """Ranks, kept set and boundary over a lane's positions (start as a
    row and as its first position), each asserted equal to the plain
    version's dense arithmetic over every row (cumsum ranks from `start`,
    rotation by start mod num). Returns (rank, kept, rot, bound)."""
    cstart = _lower_bound32(rows, start) if len(rows) else 0
    assert cstart == np.searchsorted(rows, start)
    F = np.cumsum(ok)
    total = int(F[-1]) if len(F) else 0
    f_start = int(F[cstart - 1]) if cstart > 0 else 0
    pos = np.arange(len(rows))
    rank = np.where(pos >= cstart, F - f_start, F + total - f_start)
    rot = (rows - start) % num
    kept = ok & (rank <= to_find)
    at = ok & (rank == to_find)
    bound = int((num - 1 - rot[at]).max()) if at.any() else 0
    dense = np.zeros(NP, bool)
    dense[rows] = ok
    D = torch.cumsum(torch.from_numpy(dense).to(torch.int32), 0).numpy()
    d_start = D[start - 1] if start > 0 else 0
    idx = np.arange(NP)
    d_rank = np.where(idx >= start, D - d_start, D + D[-1] - d_start)
    d_rot = (idx - start) % num
    np.testing.assert_array_equal(rank[ok], d_rank[rows][ok])
    np.testing.assert_array_equal(kept, (dense & (d_rank <= to_find))[rows])
    d_at = dense & (d_rank == to_find)
    assert bound == (int((num - 1 - d_rot[d_at]).max()) if d_at.any() else 0)
    return rank, kept, rot, bound


class _LaneModel:
    """One placement lane as the kernel holds it: the compact row list, a
    base verdict, value ids and a landing count k a position, the lane's
    own count tables, and the start as a row. A landing re-evaluates its
    row at the resident aggregates plus k of the lane's pods (every member
    requests the same), blocks it under `port_selfblock` and counts k
    attachments under `has_aux`; nothing else moves. Each step's ranks,
    kept set and boundary are checked against the dense arithmetic, the
    landed position against its row."""

    def __init__(self, st, f, facts, strat, mask, tables):
        self.st, self.f, self.facts, self.strat = st, f, facts, strat
        self.NP = mask.shape[0]
        self.num = max(int(f.num_nodes), 1)
        self.m = K._static_masks_plain(st, f)
        nrows = min(self.NP, self.num)
        self.rows = _compact_rows(mask.numpy(), self.m.static_ok.numpy(), nrows)
        np.testing.assert_array_equal(
            self.rows, np.nonzero((mask & self.m.static_ok).numpy()[:nrows])[0])
        counts, dom, forced0, sa_counts, self.sa_wq = (t.numpy() for t in tables)
        self.dns, self.sa = counts.astype(np.int64), sa_counts.astype(np.int64)
        self.dom, self.forced0 = dom, forced0
        self.dvid = K._vids(st, f.dns_axis).numpy()[:, self.rows]
        self.svid = K._vids(st, f.sa_axis).numpy()[:, self.rows]
        self.k = np.zeros(len(self.rows), np.int64)
        self.sel = self.m.sel_ok.numpy()[self.rows]
        self.taint = self.m.taint_ok.numpy()[self.rows]
        self.ign = ((self.svid <= 0).any(axis=0) | ~self.sel) if self.sa.shape[0] else \
            np.zeros(len(self.rows), bool)
        self.ok, self.fsc, self.ba = self._eval(np.arange(len(self.rows)))
        self.start = 0

    def _eval(self, pos):
        st, f, r = self.st, self.f, torch.from_numpy(self.rows[pos])
        k = torch.from_numpy(self.k[pos])
        nom = K._nom_lane(f, r)
        ok, fsc, ba = K._resource_eval_plain(
            f, self.strat, st.alloc_r[r], st.alloc_pods[r], st.req_r[r] + k[:, None] * f.request,
            st.nonzero[r] + k[:, None] * f.nz_request, st.pod_count[r] + k.to(torch.int32), *nom)
        ok = ok.numpy() & (self.rows[pos] < self.num)
        if self.facts.port_selfblock:
            ok &= self.k[pos] == 0
        if self.facts.has_aux:
            inc = int(f.aux_inc)
            ok &= (self.k[pos] + 1) * inc <= f.aux_room.numpy()[self.rows[pos]]
        return ok, fsc.numpy(), ba.numpy()

    def _feasible(self):
        f, ok = self.f, self.ok.copy()
        for c in range(self.dns.shape[0]):
            if int(f.dns_active[c]) != 1:
                continue
            eligible = self.dns[c][self.dom[c]]
            mn = min(K.BIG, int(eligible.min())) if eligible.size else K.BIG
            eff = 0 if self.forced0[c] == 1 else mn
            cap = min(int(f.dns_max_skew[c]), K.BIG)
            v = self.dvid[c]
            ok &= (v > 0) & (self.dns[c][np.maximum(v, 0)] + int(f.dns_self[c]) - eff <= cap)
        return ok

    def _scores(self, kept):
        f, rows, w = self.f, self.rows, self.f.weights.numpy().astype(np.int64)
        il = f.il_score.numpy()[rows]
        if not (self.sa.shape[0] or self.facts.has_pns or self.facts.has_na_pref):
            return w[0] * K.MAX_NODE_SCORE + w[1] * self.fsc + w[4] * self.ba + w[6] * il
        tt = pts = na = 0
        if self.facts.has_pns:
            pns = self.m.pns_cnt.numpy()[rows]
            mx = int(pns[kept].max()) if kept.any() else 0
            tt = K.MAX_NODE_SCORE - K.MAX_NODE_SCORE * pns // mx if mx > 0 else K.MAX_NODE_SCORE
        if self.sa.shape[0]:
            raw = sum(self.sa[c][self.svid[c]] * int(self.sa_wq[c])
                      + (int(f.sa_skew[c]) - 1) * 1024 for c in range(self.sa.shape[0]))
            live = kept & ~self.ign
            mx = int(raw[live].max()) if live.any() else 0
            mn = int(raw[live].min()) if live.any() else K.INF64
            norm = (K.MAX_NODE_SCORE * (mx + min(mn, mx) - raw) // mx if mx > 0
                    else np.full(len(rows), K.MAX_NODE_SCORE))
            pts = np.where(self.ign, 0, norm)
        if self.facts.has_na_pref:
            raw = f.na_raw.numpy()[rows]
            mx = int(raw[kept].max()) if kept.any() else 0
            na = K.MAX_NODE_SCORE * raw // mx if mx > 0 else 0
        return (w[0] * tt + w[1] * self.fsc + w[4] * self.ba + w[2] * pts + w[5] * na
                + w[6] * il)

    def step(self):
        NP, num, start = self.NP, self.num, self.start
        if not len(self.rows):  # a padded lane: nothing lands, the start stays
            return -1, start
        ok = self._feasible()
        _rank, kept, rot, bound = _compact_ranks(ok, self.rows, start, num, int(self.f.num_nodes),
                                                 NP)
        key = np.where(kept, self._scores(kept) * NP + (NP - 1 - rot), -1)
        chosen = -1
        if key.max() >= 0:
            chosen = (start + NP - 1 - int(key.max()) % NP) % num
            p = _lower_bound32(self.rows, chosen)
            assert self.rows[p] == chosen and key[p] == key.max()
            self._land(p)
        self.start = (start + num - bound) % num
        return chosen, self.start

    def _land(self, p):
        f = self.f
        for c in range(self.dns.shape[0]):
            v = self.dvid[c][p]
            if v > 0 and (int(f.dns_honor_aff[c]) != 1 or self.sel[p]) and (
                    int(f.dns_honor_taints[c]) != 1 or self.taint[p]):
                self.dns[c][v] += int(f.dns_self[c])
        if not self.ign[p]:
            for c in range(self.sa.shape[0]):
                self.sa[c][self.svid[c][p]] += int(f.sa_self[c])
        self.k[p] += 1
        (ok,), (fsc,), (ba,) = self._eval(np.array([p]))
        self.ok[p], self.fsc[p], self.ba[p] = ok, fsc, ba


# (placement_inputs arguments, plan lanes, nominated lane, mask rows past num_nodes)
LANE_MODEL = {
    "no-tables": (dict(), {}, False, False),
    "shared-tables": (dict(dns=1, sa=1, pns=True), {}, False, False),
    "overrides": (dict(dns=2, sa=1, overrides=True, na=True), {}, False, False),
    "blocked": (dict(dns=1), dict(port_selfblock=True), False, False),
    "aux": (dict(sa=1, overrides=True), dict(has_aux=True), False, False),
    "nominated-past-num": (dict(dns=1, sa=1), {}, True, True),
}


@pytest.mark.parametrize("case", list(LANE_MODEL))
def test_compact_lanes_step_like_the_plain_placements(case):
    """Each lane of a placement draw (an empty lane, one row, ~100 rows,
    random subsets and every live row), modelled on its compact row list
    and stepped member by member, gives the plain version's chosen rows and
    starts; every step's ranks, kept set and boundary over the positions
    equal the dense ones, and each landed position holds its row. Rows
    past num_nodes in a mask never enter a list."""
    from kubernetes_tpu_torch.testing.kernel_inputs import aux_lane, with_aux_lane
    draw, lane_facts, nom, past = LANE_MODEL[case]
    seed = 70 + len(case)
    s, f, facts, masks, ov = placement_inputs(seed, 256, 200, 6, vmax=VMAX, **draw)
    if lane_facts.get("has_aux"):
        room, inc, _cnt = aux_lane(seed, 256, 200)
        f = with_aux_lane(f, room, inc)
    if nom:
        f = with_nominated_lane(f, nominated_lane(seed, 256, 200))
    if past:
        masks[-2:, 200:] = True
    _js, _jf, ts, tf = _convert(s, f)
    facts = K.PlanFacts(**dict(facts, **lane_facts))
    t_ov = None if ov is None else tuple(torch.from_numpy(a) for a in ov)
    t_masks = torch.from_numpy(masks)
    B, n_act = 8, 6
    want = K._schedule_placements_plain(ts, tf, B, 1, VMAX, facts, t_masks, n_act, t_ov)
    placed = 0
    for p in range(masks.shape[0]):
        tables = ([t[p] for t in t_ov] if t_ov is not None else
                  [tf.dns_counts, tf.dns_dom, tf.dns_forced0, tf.sa_counts, tf.sa_wq])
        model = _LaneModel(ts, tf, facts, 1, t_masks[p], tables)
        assert len(model.rows) <= int(t_masks[p, :200].sum())
        got = np.array([model.step() for _ in range(n_act)]).T
        np.testing.assert_array_equal(got, want[p, :, :n_act].numpy(), err_msg=f"lane {p}")
        placed += int((got[0] >= 0).sum())
    assert placed > 0


@pytest.mark.parametrize("case", ["one-row", "hundred-rows", "every-row-boundary",
                                  "start-between-rows", "start-past-rows", "wide"])
def test_compact_ranks_equal_the_dense_ranks(case):
    """The rank arithmetic over a lane's positions (the start's first
    position from the 32-way search) against the dense cumsum ranks, on
    lanes of one row, ~100 rows, every row with every row feasible (the
    boundary at rank == to_find == num_nodes), starts between and past
    the lane's rows, and a 5000-row lane (three rounds of the search)."""
    rng = np.random.default_rng(len(case))
    NP, num = (8192, 5000) if case == "wide" else (256, 200)
    if case == "one-row":
        rows = np.array([137])
    elif case == "every-row-boundary":
        rows = np.arange(num)
    else:
        rows = np.sort(rng.choice(num, 4000 if case == "wide" else 100, replace=False))
    ok = np.ones(len(rows), bool) if case == "every-row-boundary" else rng.random(len(rows)) < 0.7
    starts = ([int(rows[40]) + 1, int(rows[0]), int(rows[-1])] if case == "start-between-rows"
              else [int(rows[-1]) + 1, num - 1] if case == "start-past-rows" else [0, 17, num // 2])
    bounds = []
    for start in starts:
        for to_find in (0, 5, int(ok.sum()), num):
            bounds.append(_compact_ranks(ok, rows, start, num, to_find, NP)[3])
    for x in range(-1, NP + 2, 7):
        assert _lower_bound32(rows, x) == np.searchsorted(rows, x)
    if case == "every-row-boundary":
        assert any(b > 0 for b in bounds)  # rank == to_find == num_nodes lands a boundary


# ---------------------------------------------------------------------------
# static_masks: the kernel's decomposition, modelled in numpy
# ---------------------------------------------------------------------------


def _taint_verdicts(keys, vals, effs, tols):
    """taint_verdict over a row's taints: (an untolerated NoSchedule or
    NoExecute taint, the untolerated PreferNoSchedule taints)."""
    lk, lv, le, lo = tols
    untolerated, pns = False, 0
    for k, v, e in zip(keys, vals, effs):
        match = (((le == 0) | (le == e)) & ((lk == 0) | (lk == k)) & ((lo == 1) | (lv == v)))
        if e in (1, 3) and not match.any():
            untolerated = True
        if e == 2 and not (match & ((le == 0) | (le == 2))).any():
            pns += 1
    return untolerated, pns


class _StaticMasksModel:
    """static_masks as the kernel runs it: a block of SM_ROWS rows (a thread
    a row) stages the L tolerations in shared memory, the first L threads
    a word each (a barrier only when L > 0); a thread reads its own row's
    taints in device memory and its gates, and writes its verdicts into
    the one output buffer (14 * NPa bytes: six masks NPa bytes apart, the
    int64 counts from byte 6 * NPa), read back through the wrapper's
    views."""

    def __init__(self, st, f):
        self.c = {**K._build.defines("kernels.cuh"), **K._build.defines("static_masks.cu")}
        self.st, self.f = st, f

    def run(self):
        st, f, SM = self.st, self.f, self.c["SM_ROWS"]
        NP, T = st.taint_key.shape
        L = f.tol_key.shape[0]
        assert 16 * L <= self.c["STAGE_SMEM_MAX"]
        NPa = -(-NP // 8) * 8
        buf = np.full(14 * NPa, 0xA5, np.uint8)  # what an allocation holds
        masks = buf[:6 * NPa].reshape(6, NPa)
        counts = buf[6 * NPa:].view(np.int64)
        tk, tv, te = (a.numpy() for a in (st.taint_key, st.taint_val, st.taint_eff))
        e = f.enable.numpy()
        for n0 in range(0, NP, SM):
            shared = np.full(4 * L, -7, np.int32)  # the block's stage
            for tid in range(SM):
                for l in range(tid, L, SM):
                    for a, src in enumerate((f.tol_key, f.tol_val, f.tol_eff, f.tol_op)):
                        shared[a * L + l] = int(src[l])
            tols = tuple(shared[a * L:(a + 1) * L] for a in range(4))
            for n in range(n0, min(n0 + SM, NP)):
                untolerated, pns = _taint_verdicts(tk[n], tv[n], te[n], tols)
                want = int(f.node_name_id)
                taint_ok = not untolerated or e[2] == 0
                sel_ok = bool(f.sel_match[n]) or e[3] == 0
                name_ok = want == 0 or int(st.name_id[n]) == want or e[0] == 0
                unsched_ok = not bool(st.unsched[n]) or int(f.tolerates_unsched) == 1 or e[1] == 0
                anti_ok = int(f.exist_anti[n]) == 0
                ok = (bool(st.valid[n]) and bool(f.extra_ok[n]) and taint_ok and sel_ok
                      and name_ok and unsched_ok and anti_ok)
                for i, v in enumerate((taint_ok, sel_ok, name_ok, unsched_ok, anti_ok, ok)):
                    masks[i, n] = v
                counts[n] = pns
        return K._static_mask_views(torch.from_numpy(buf), NP)


@pytest.mark.parametrize("NP,n,kw", [
    (256, 200, {}), (300, 250, {}), (37, 30, dict(tolerations=0)), (256, 200, dict(taints=0)),
    (256, 200, dict(taints=0, tolerations=0)), (256, 200, dict(pad_taints=True)),
    (260, 200, dict(taints=16, tolerations=7)), (256, 200, dict(enable_off=(0, 2))),
    (256, 200, dict(enable_off=(1, 3)))],
    ids=["base", "partial-block", "odd-rows", "no-taints", "neither", "padded-taints",
         "wide", "gates-0-2-off", "gates-1-3-off"])
def test_static_masks_model_equals_the_plain_masks(NP, n, kw):
    """The kernel's decomposition (tolerations staged a block, a thread a
    row, the outputs one buffer read through the wrapper's views) gives the
    plain version's seven masks on the edges of its design: rows not a
    multiple of the block or of 8, no taint or toleration, padded and wide
    taints, gates off."""
    ts, tf = _convert(*static_edge_inputs(23 + NP, NP, n, **kw))[2:]
    got = _StaticMasksModel(ts, tf).run()
    want = K._static_masks_plain(ts, tf)
    for name, a, b in zip(K.StaticMasks._fields, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
    assert any(bool(m.any()) and not bool(m.all()) for m in want if m.dtype == torch.bool)


@pytest.mark.parametrize("NP", [1, 7, 8, 200, 8192])
def test_static_mask_views_are_seven_disjoint_aligned_outputs(NP):
    """The one output buffer's views: seven contiguous tensors of NP
    elements, pairwise disjoint, the bool masks NPa bytes apart and the
    int64 counts 8-byte aligned after them."""
    NPa = -(-NP // 8) * 8
    buf = torch.zeros(14 * NPa, dtype=torch.uint8)
    m = K._static_mask_views(buf, NP)
    assert [t.dtype for t in m] == [torch.bool, torch.int64] + [torch.bool] * 5
    assert all(t.shape == (NP,) and t.is_contiguous() for t in m)
    spans = sorted((t.data_ptr(), t.data_ptr() + t.numel() * t.element_size()) for t in m)
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert (m.pns_cnt.data_ptr() - buf.data_ptr()) == 6 * NPa
    assert m.pns_cnt.data_ptr() % 8 == 0
    m.static_ok.fill_(True)
    m.pns_cnt.fill_(-1)
    assert int(m.taint_ok.sum()) == 0 and int(m.exist_anti_ok.sum()) == 0


def test_static_masks_wrapper_makes_one_allocation(recorded_launches, monkeypatch):
    """A static_masks launch allocates one buffer, and its seven output
    pointers are the buffer's views in the launcher's order."""
    _js, _jf, ts, tf = _both(18, np_cap=200)
    made = []
    real = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, **kw: made.append(a) or real(*a, **kw))
    out = K._static_masks_cuda(ts, tf)
    assert len(made) == 1
    (name, args), = recorded_launches
    sig = [p.name for p in K._build.signature("static_masks")]
    ptrs = dict(zip(sig, args))
    assert [ptrs[k] for k in ("taint_ok", "pns_cnt", "sel_ok", "name_ok", "unsched_ok",
                              "exist_anti_ok", "static_ok")] == [t.data_ptr() for t in out]
    base = out.taint_ok.data_ptr()
    assert [t.data_ptr() - base for t in out] == [0, 6 * 200, 200, 400, 600, 800, 1000]
