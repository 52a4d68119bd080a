"""The PyTorch port's priority and preemption path against the JAX
reference, on the CPU.

Kernels: seeded numpy draws (kubernetes_tpu_torch.testing.kernel_inputs)
feed the JAX package's dry_run_preemption and schedule_batch (with the
nominated-pod lane, `has_nom`) and the port's wrappers, which run their
plain PyTorch versions on CPU tensors; every comparison is exact (integers
and booleans, tolerance 0). The mirror's dirty-row scatter is held against a
full re-upload of the same staging. Scheduler: the JAX package's
TestDevicePreemptionEquivalence pair run (tests/test_preemption.py:132-172)
on the port's host Scheduler, on TorchScheduler(device="cpu") and on the
JAX TPUScheduler; PreemptionAsync/50Nodes end to end; and the nominated
node's reserved room under the two-pass filter."""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from kubernetes_tpu.core.scheduler import Scheduler as JaxHostScheduler
from kubernetes_tpu.models.tpu_scheduler import TPUScheduler
from kubernetes_tpu.ops.device_state import DeviceNodeState as JaxState
from kubernetes_tpu.ops.device_state import _scatter_rows_impl as jax_scatter_rows
from kubernetes_tpu.ops.features import BatchFeatures as JaxFeatures
from kubernetes_tpu.ops.kernel import ScanCarry as JaxCarry
from kubernetes_tpu.ops.kernel import dry_run_preemption as jax_dry_run_preemption
from kubernetes_tpu.ops.kernel import schedule_batch as jax_schedule_batch
from kubernetes_tpu.testing.wrappers import make_node as jax_make_node
from kubernetes_tpu.testing.wrappers import make_pod as jax_make_pod
from kubernetes_tpu_torch import bench
from kubernetes_tpu_torch.core import Scheduler
from kubernetes_tpu_torch.models import TorchScheduler
from kubernetes_tpu_torch.ops import kernel as K
from kubernetes_tpu_torch.ops.device_state import NodeStateMirror, state_from_jax_numpy
from kubernetes_tpu_torch.ops.features import features_from_jax_numpy, victims_from_jax_numpy
from kubernetes_tpu_torch.testing import make_node, make_pod
from kubernetes_tpu_torch.testing.kernel_inputs import (
    general_inputs,
    nominated_lane,
    random_inputs,
    stage_rows,
    victim_edge_inputs,
    victim_inputs,
    with_nominated_lane,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small inputs: one intra-op thread keeps this module from crowding
    the other test workers' CPUs."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jax(arrays, cls):
    return cls(*[jnp.asarray(a) for a in arrays])


def _same(jax_arrays, torch_arrays, what):
    for i, (a, b) in enumerate(zip(jax_arrays, torch_arrays)):
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, (what, i, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"{what} lane {i}")


# ---------------------------------------------------------------------------
# dry_run_preemption
# ---------------------------------------------------------------------------


# The edges of the dry run's design: victim_edge_inputs arguments (resource
# slots from 1 to 64, two a lane past 32; victims on rows past num_nodes;
# a pod without requests; the fit and static gates off; no taint or
# toleration; padded taints).
DRY_EDGES = {
    "r1": dict(r_slots=1), "r8": dict(r_slots=8), "r9": dict(r_slots=9),
    "r33-past-num": dict(r_slots=33, past_num=True), "r64": dict(r_slots=64),
    "no-request": dict(no_request=True), "fit-gate-off": dict(enable_off=(4,)),
    "static-gates-off": dict(enable_off=(0, 1, 2, 3)),
    "no-taints-no-tolerations": dict(taints=0, tolerations=0),
    "padded-taints": dict(pad_taints=True),
}


def _dry_parity(s, f, vic_req, vic_valid, k):
    """The JAX package's dry run and the port's on one draw, both returned."""
    want = np.asarray(jax_dry_run_preemption(_jax(s, JaxState), _jax(f, JaxFeatures),
                                             jnp.asarray(vic_req), jnp.asarray(vic_valid), k))
    got = K.dry_run_preemption(state_from_jax_numpy(s), features_from_jax_numpy(f),
                               *victims_from_jax_numpy(vic_req, vic_valid), k)
    assert got.dtype == torch.bool and got.shape == (vic_valid.shape[0], 1 + k)
    np.testing.assert_array_equal(want, got.numpy())
    return want


@pytest.mark.parametrize("case", ["victims", "no-fit-anywhere"] + list(DRY_EDGES))
@pytest.mark.parametrize("k", [8, 16])
@pytest.mark.parametrize("np_cap,num_nodes", [(64, 50), (256, 200)])
def test_dry_run_preemption(np_cap, num_nodes, k, case):
    if case in DRY_EDGES:
        s, f, vic_req, vic_valid = victim_edge_inputs(40 + k + np_cap, np_cap, num_nodes, k,
                                                      **DRY_EDGES[case])
        want = _dry_parity(s, f, vic_req, vic_valid, k)
        if case == "fit-gate-off":
            assert not want.any(), "every victim reprieved while the fit gate is off"
        elif case != "no-request":  # without requests a reprieve fails only on the pod cap
            assert want[:, 0].any(), "a candidate row"
        assert not want[num_nodes:].any(), "no verdict past num_nodes"
        return
    s, f, vic_req, vic_valid = victim_inputs(40 + k + np_cap, np_cap, num_nodes, k,
                                             infeasible=case == "no-fit-anywhere")
    want = _dry_parity(s, f, vic_req, vic_valid, k)
    # The draw holds the cases the kernel must get right.
    live = np.arange(np_cap) < num_nodes
    n_vic = vic_valid.sum(axis=1)
    assert (live & (n_vic == 0)).any(), "a node with no victim"
    assert ((vic_req.any(axis=2)) & ~vic_valid).any(), "an invalid slot with a request"
    assert (vic_req[..., 3] * vic_valid).any(), "a scalar-resource victim"
    assert (s[5][live] != 0).any() and s[8][live].any(), "tainted and unschedulable rows"
    if case == "victims":
        assert want[:, 0].any() and (live & (n_vic > 0) & ~want[:, 0]).any()
        reprieved = vic_valid & ~want[:, 1:] & want[:, :1]
        assert reprieved.any(), "a candidate that keeps some of its pods"
    else:
        assert not want.any(), "no removal fits a pod larger than every node"


@pytest.mark.parametrize("case", ["victims", "r33-past-num", "padded-taints"])
@pytest.mark.parametrize("k", [64, 256])
def test_dry_run_preemption_wide_k(k, case):
    """K up to PREEMPT_K_CAP: rows with more victims than the kernel's
    register tier, against the JAX package."""
    if case == "victims":
        draw = victim_inputs(90 + k, 64, 50, k)
    else:
        draw = victim_edge_inputs(90 + k, 64, 50, k, **DRY_EDGES[case])
    want = _dry_parity(*draw, k)
    assert want[:, 0].any() and (draw[3].sum(axis=1) > 8).any()


class _DryTileModel:
    """dry_run_preemption as the kernel decomposes it, in numpy. A block of
    DRY_THREADS threads takes DRY_THREADS / G rows, a tile of G lanes a row
    (G the smallest power of two >= R, at most 32; lane l owns slots l,
    l + G). The block stages its rows' [rows, T] taint slabs and the
    tolerations in shared memory (stage_static: 16-byte vectors i = tid,
    tid + blockDim of each slab, the tail a word a thread; device memory
    past STAGE_SMEM_MAX) and lane 0 takes the row's static verdict there.
    The tile turns the K flags into bit words (lane l ORs the nibbles of
    quads l, l + G, ... of each 32 slots; the words are the OR over the
    lanes), walks the set bits in slot order twice (the removal, the
    reprieve), holds the first DRY_VREG victims' requests from the removal
    to the reprieve and reads the rest again, and votes each fit test's
    violation over its lanes (a masked ballot). Lane l writes output bytes
    l, l + G, ... Counts each victim read (`reads`)."""

    def __init__(self, st, f, vic_req, vic_valid, K_):
        c = {**K._build.defines("kernels.cuh"), **K._build.defines("dry_run_preemption.cu")}
        self.THREADS, self.VREG, self.SMEM = c["DRY_THREADS"], c["DRY_VREG"], c["STAGE_SMEM_MAX"]
        assert K_ <= c["DRY_KMAX"] and f.request.shape[0] <= c["DRY_RMAX"] and K_ % 4 == 0
        self.st, self.f = st, f
        self.vr, self.vv, self.K = vic_req.numpy(), vic_valid.numpy(), K_
        R = f.request.shape[0]
        self.G = min(32, 1 << max(0, R - 1).bit_length())
        self.S = -(-R // self.G)
        self.reads = 0

    def _stage(self, n0, rows, cap):
        """(taint rows as the kernel reads them, tolerations, staged?)."""
        st, f = self.st, self.f
        T, L = st.taint_key.shape[1], f.tol_key.shape[0]
        KW = -(-self.K // 32)
        staged = 4 * cap * KW + 12 * cap * T + 16 * L <= self.SMEM
        src = [a.numpy()[n0:n0 + rows].reshape(-1) for a in (st.taint_key, st.taint_val,
                                                              st.taint_eff)]
        tols = tuple(a.numpy() for a in (f.tol_key, f.tol_val, f.tol_eff, f.tol_op))
        if not staged:
            return [a.reshape(rows, T) for a in src], tols, False
        sm = np.full(3 * cap * T + 4 * L, -7, np.int32)
        nv, count = (rows * T) // 4, rows * T
        for tid in range(self.THREADS):
            for i in range(tid, nv, self.THREADS):
                for a in range(3):
                    sm[a * cap * T + 4 * i:a * cap * T + 4 * i + 4] = src[a][4 * i:4 * i + 4]
            for i in range(4 * nv + tid, count, self.THREADS):
                for a in range(3):
                    sm[a * cap * T + i] = src[a][i]
            for i in range(tid, L, self.THREADS):
                for a in range(4):
                    sm[3 * cap * T + a * L + i] = tols[a][i]
        slabs = [sm[a * cap * T:a * cap * T + rows * T].reshape(rows, T) for a in range(3)]
        lk = 3 * cap * T
        return slabs, tuple(sm[lk + a * L:lk + (a + 1) * L] for a in range(4)), True

    def _static_ok(self, n, taints, tols):
        st, f, e = self.st, self.f, self.f.enable.numpy()
        lk, lv, le, lo = tols
        untolerated = False
        for k, v, eff in zip(*taints):
            match = ((le == 0) | (le == eff)) & ((lk == 0) | (lk == k)) & ((lo == 1) | (lv == v))
            untolerated |= eff in (1, 3) and not match.any()
        want = int(f.node_name_id)
        return ((not untolerated or e[2] == 0) and (bool(f.sel_match[n]) or e[3] == 0)
                and (want == 0 or int(st.name_id[n]) == want or e[0] == 0)
                and (not bool(st.unsched[n]) or int(f.tolerates_unsched) == 1 or e[1] == 0)
                and int(f.exist_anti[n]) == 0 and bool(st.valid[n]) and bool(f.extra_ok[n]))

    def _lanes(self, row):
        """A length-R vector as the tile holds it: [G lanes, S slots], 0 past R."""
        out = np.zeros((self.G, self.S), np.int64)
        for l in range(self.G):
            for s_ in range(self.S):
                if l + self.G * s_ < row.shape[0]:
                    out[l, s_] = row[l + self.G * s_]
        return out

    def _fits(self, alloc, used, pods, pods_cap):
        f = self.f
        q = self._lanes(f.request.numpy())
        lane_viol = ((q > 0) & (q > alloc - used)).any(axis=1)   # each lane's slots
        ballot = sum(1 << l for l in range(self.G) if lane_viol[l])
        return (((pods + 1) <= pods_cap and (ballot == 0 or int(f.has_request) == 0))
                or int(f.enable[4]) == 0)

    def _words(self, n):
        K_, G = self.K, self.G
        flags = self.vv[n]
        words = []
        for w in range(-(-K_ // 32)):
            lane_bits = [0] * G
            for l in range(G):
                for qi in range(8 * w + l, min(8 * w + 8, K_ // 4), G):
                    nib = sum(1 << b for b in range(4) if flags[4 * qi + b])
                    lane_bits[l] |= nib << (4 * (qi & 7))
            word = 0
            for b in lane_bits:  # __reduce_or_sync over the tile
                word |= b
            words.append(word)
        return words

    @staticmethod
    def _walk(words):
        for w, word in enumerate(words):
            while word:
                b = (word & -word).bit_length() - 1
                word &= word - 1
                yield 32 * w + b

    def run(self):
        st, f, K_, G = self.st, self.f, self.K, self.G
        NP = st.valid.shape[0]
        RB = self.THREADS // G
        num = max(int(f.num_nodes), 1)
        out = np.full((NP, 1 + K_), 2, np.uint8)  # 2: never written
        for n0 in range(0, NP, RB):
            rows = min(RB, NP - n0)
            slabs, tols, _staged = self._stage(n0, rows, RB)
            for tile in range(rows):
                n = n0 + tile
                feasible0, n_pot, kept_cnt, words = False, 0, 0, [0]
                if n < num:
                    words = self._words(n)
                    n_pot = sum(bin(w).count("1") for w in words)
                    alloc = self._lanes(st.alloc_r.numpy()[n])
                    base = self._lanes(st.req_r.numpy()[n])
                    cnt, pods_cap = int(st.pod_count[n]), int(st.alloc_pods[n])
                    held = []
                    if n_pot:
                        for j, i in enumerate(self._walk(words)):
                            v = self._lanes(self.vr[n, i])
                            self.reads += 1
                            if j < self.VREG:
                                held.append(v)
                            base = base - v
                        feasible0 = self._fits(alloc, base, cnt - n_pot, pods_cap)
                    ok = self._static_ok(n, [a[tile] for a in slabs], tols)  # lane 0, shuffled
                    feasible0 = feasible0 and ok
                if feasible0:
                    kept = np.zeros_like(base)
                    cnt0 = cnt - n_pot
                    for j, i in enumerate(list(self._walk(words))):
                        if j < len(held):
                            v = held[j]
                        else:
                            v = self._lanes(self.vr[n, i])
                            self.reads += 1
                        if self._fits(alloc, base + kept + v, cnt0 + kept_cnt + 1, pods_cap):
                            kept, kept_cnt = kept + v, kept_cnt + 1
                            words[i >> 5] &= ~(1 << (i & 31))
                for lane in range(G):
                    for b in range(lane, K_ + 1, G):
                        out[n, b] = (feasible0 and kept_cnt < n_pot) if b == 0 else (
                            feasible0 and (words[(b - 1) >> 5] >> ((b - 1) & 31)) & 1)
        assert (out < 2).all(), "every byte written once"
        return torch.from_numpy(out.astype(bool))


DRY_MODEL = {
    "base": (8, dict()), "r1": (8, dict(r_slots=1)), "r7-past-num": (8, dict(past_num=True)),
    "r8": (8, dict(r_slots=8)), "r9": (8, dict(r_slots=9)), "r33": (8, dict(r_slots=33)),
    "r64-past-num": (8, dict(r_slots=64, past_num=True)), "k64": (64, dict()),
    "k256-r33": (256, dict(r_slots=33)), "no-request": (8, dict(no_request=True)),
    "fit-gate-off": (8, dict(enable_off=(4,))),
    "static-gates-off": (16, dict(enable_off=(0, 1, 2, 3))),
    "no-taints": (8, dict(taints=0)), "no-tolerations": (8, dict(tolerations=0)),
    "padded-taints": (8, dict(pad_taints=True)),
    "past-the-stage": (8, dict(taints=160, pad_taints=True)),
}


@pytest.mark.parametrize("case", list(DRY_MODEL))
def test_dry_run_tile_model_equals_the_plain_dry_run(case):
    """The kernel's decomposition (G-lane tiles with masked ballots, the
    flags as bit words walked by their set bits, the register tier of
    DRY_VREG victims and the re-read past it, the block-staged taint
    slabs) gives the plain version's [NP, 1 + K] verdicts on the edges of
    its design: 1 to 64 resource slots, K 8 to 256, victims on rows past
    num_nodes, rows without a victim, the gates off, no taint or
    toleration, padded taints and 160 taint slots (past the stage)."""
    k, kw = DRY_MODEL[case]
    s, f, vr, vv = victim_edge_inputs(60 + len(case), 96, 80, k, **kw)
    ts, tf = state_from_jax_numpy(s), features_from_jax_numpy(f)
    args = (ts, tf, *victims_from_jax_numpy(vr, vv), k)
    model = _DryTileModel(*args)
    got = model.run()
    want = K._dry_run_preemption_plain(*args)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    live = vv[:80]
    assert (live.sum(axis=1) == 0).any(), "rows without a victim"
    # Each valid victim of a live row is read once, and again in the
    # reprieve past the register tier when the row is feasible.
    assert model.reads >= int(live.sum())
    if k > model.VREG:
        assert model.reads > int(live.sum()), "no victim was read past the register tier"


# ---------------------------------------------------------------------------
# the nominated-pod lane in the three schedule kernels
# ---------------------------------------------------------------------------

PLANS = {
    # (draw, batch_pad, n_active, JAX plan flags): the lap, the <= 64-step
    # scan, and a general plan (hard zone spread, full feasibility).
    "lap": ("fit", 512, 300, {}),
    "scan": ("fit", 64, 50, {}),
    "general": ("spread", 64, 50, {}),
}


def _lane_inputs(plan, seed):
    draw = PLANS[plan][0]
    if draw == "fit":
        s, f = random_inputs(seed, 256, 200, vmax=64)
        facts = dict(has_pns=False, has_ipa_base=False)
        vmax = 64
    else:
        s, f, facts = general_inputs(seed, 256, 200, vmax=256, dns=1)
        vmax = 256
    f = with_nominated_lane(f, nominated_lane(seed, 256, 200))
    return s, f, facts, vmax


@pytest.mark.parametrize("fit_strategy", [0, 1], ids=["least", "most"])
@pytest.mark.parametrize("plan", list(PLANS))
def test_schedule_batch_with_nominated_lane(plan, fit_strategy):
    _draw, batch_pad, n_act, _ = PLANS[plan]
    s, f, facts, vmax = _lane_inputs(plan, 60)
    js, jf = _jax(s, JaxState), _jax(f, JaxFeatures)
    ts, tf = state_from_jax_numpy(s), features_from_jax_numpy(f)
    pf = K.PlanFacts(**facts)
    incremental, carried = K.plan_modes(tf, pf)
    if plan == "general":
        assert not incremental
    else:
        assert incremental and carried and (batch_pad > K.SCAN_MAX_STEPS) == (plan == "lap")
    jc = tc = None
    for _chain in range(2):  # fresh, then chained through the carry
        jr, jc_new = jax_schedule_batch(js, jf, batch_pad, fit_strategy, vmax,
                                        n_active=np.int32(n_act), carry_in=jc, has_nom=True,
                                        **facts)
        jr = np.asarray(jr)
        jc_np = [np.asarray(a) for a in jc_new]
        tr, tc = K.schedule_batch(ts, tf, batch_pad, fit_strategy, vmax, pf, n_active=n_act,
                                  carry_in=tc)
        np.testing.assert_array_equal(jr, tr.numpy())
        _same(jc_np, tc, f"{plan} carry")
        jc = JaxCarry(*[jnp.asarray(a) for a in jc_np])
    # The lane is live: without it the same batch lands elsewhere.
    no_lane = tf._replace(nom_req=tf.nom_req[:0], nom_pods=tf.nom_pods[:0])
    tr0, _ = K.schedule_batch(ts, no_lane, batch_pad, fit_strategy, vmax, pf, n_active=n_act)
    tr1, _ = K.schedule_batch(ts, tf, batch_pad, fit_strategy, vmax, pf, n_active=n_act)
    assert not torch.equal(tr0, tr1)


# ---------------------------------------------------------------------------
# the mirror's dirty-row scatter
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dirty", [1, 9, 2, 16])
def test_scatter_rows_matches_a_full_upload(dirty):
    """The plain scatter of a mirror's dirty rows leaves the device state
    equal to a full re-upload of the same staging."""
    rng = random.Random(dirty)
    s = Scheduler()
    for i in range(40):
        s.clientset.create_node(make_node().name(f"n{i}").zone(f"z{i % 3}")
                                .capacity({"cpu": 8, "memory": "16Gi", "pods": 20}).obj())
    mirror = NodeStateMirror("cpu")
    mirror.ensure_axis("topology.kubernetes.io/zone")
    s.cache.update_snapshot(s.snapshot)
    mirror.sync(s.snapshot.node_info_list)
    mirror.flush()
    for j, i in enumerate(rng.sample(range(40), dirty)):
        if j % 3 == 0:
            s.clientset.create_pod(make_pod().name(f"p{j}").req({"cpu": "1"}).node(f"n{i}").obj())
        elif j % 3 == 1:
            s.clientset.update_node(make_node().name(f"n{i}").zone(f"z{i % 3}").label("rack", "r1")
                                    .capacity({"cpu": 4, "memory": "8Gi", "pods": 20})
                                    .taint("k", "v", "NoSchedule").obj())
        else:
            s.clientset.update_node(make_node().name(f"n{i}").zone(f"z{i % 3}")
                                    .capacity({"cpu": 8, "memory": "16Gi", "pods": 20})
                                    .unschedulable().obj())
    s.cache.update_snapshot(s.snapshot)
    mirror.sync(s.snapshot.node_info_list)
    assert len(mirror._dirty) == dirty
    flushes = mirror.scatter_flushes
    got = mirror.flush()
    assert mirror.scatter_flushes == flushes + 1
    for i, (a, b) in enumerate(zip(got, mirror._upload())):
        assert a.dtype == b.dtype and torch.equal(a, b), i


def test_scatter_rows_writes_every_field():
    """stage_rows / scatter_rows round trip on a seeded state: the rows
    written are the packed ones in every field (topo along its node axis),
    the other rows are untouched; the scatter returns a new state and the
    given one keeps its values, and in place the state's own tensors are
    updated."""
    s, _f = random_inputs(70, 256, 200)
    state = state_from_jax_numpy(s)
    state = state._replace(topo=torch.randint(0, 9, state.topo.shape, dtype=torch.int32))
    src = state_from_jax_numpy(random_inputs(71, 256, 200)[0])
    src = src._replace(topo=torch.randint(0, 9, state.topo.shape, dtype=torch.int32))
    idx = torch.tensor([0, 17, 255, 100], dtype=torch.int32)
    rows = K.DeviceNodeState(*[t[idx.long()] for t in src[:-1]], src.topo[:, idx.long()])
    want = [t.clone() for t in state]
    for field, r in zip(want[:-1], rows[:-1]):
        field[idx.long()] = r
    want[-1][:, idx.long()] = rows.topo
    before = [t.clone() for t in state]
    packed = stage_rows(rows, idx)[1]
    got = K.scatter_rows(state, idx, packed)
    for i, (a, b, old) in enumerate(zip(got, want, state)):
        assert torch.equal(a, b) and a.data_ptr() != old.data_ptr(), i
    for i, (a, b) in enumerate(zip(state, before)):
        assert torch.equal(a, b), i
    ptrs = [t.data_ptr() for t in state]
    got = K.scatter_rows(state, idx, packed, in_place=True)
    assert [t.data_ptr() for t in state] == ptrs and got is state
    for i, (a, b) in enumerate(zip(state, want)):
        assert torch.equal(a, b), i


@pytest.mark.parametrize("d,order,taints,axes,in_place", [
    (1, "sorted", 4, 4, False), (64, "shuffled", 4, 4, False), (200, "shuffled", 4, 2, False),
    (17, "sorted", 0, 0, False), (33, "shuffled", 4, 4, True)])
def test_scatter_rows_matches_jax(d, order, taints, axes, in_place):
    """The dirty-row scatter through the staging path (the rows and their
    indices packed into one buffer and uploaded at once) equals the JAX
    package's _scatter_rows_impl on the same state and rows, in any row
    order; the state given keeps its values unless in place."""
    rng = np.random.default_rng(400 + d)
    s = list(random_inputs(400 + d, 256, 200, taints=taints)[0])
    src = list(random_inputs(401 + d, 256, 200, taints=taints)[0])
    s[-1] = rng.integers(0, 9, (axes, 256)).astype(np.int32)
    src[-1] = rng.integers(0, 9, (axes, 256)).astype(np.int32)
    at = rng.choice(256, d, replace=False)
    if order == "sorted":
        at = np.sort(at)
    rows = [a[at] for a in src[:-1]] + [src[-1][:, at]]
    want = jax_scatter_rows(JaxState(*[jnp.asarray(a) for a in s]), jnp.asarray(at),
                            JaxState(*[jnp.asarray(a) for a in rows]))
    from kubernetes_tpu_torch.ops.staging import StagingRing

    host = [np.ascontiguousarray(a) for a in src]
    idx, packed = K.stage_scatter(StagingRing("cpu"), host[:-1], host[-1], at)
    state = state_from_jax_numpy(s)
    before = [t.clone() for t in state]
    got = K.scatter_rows(state, idx, packed, in_place=in_place)
    for i, (a, b) in enumerate(zip(want, got)):
        a = np.asarray(a)
        assert a.dtype == b.numpy().dtype and a.shape == tuple(b.shape), i
        np.testing.assert_array_equal(a, b.numpy(), err_msg=f"field {i}")
    assert (got is state) == in_place
    if not in_place:
        for i, (a, b) in enumerate(zip(state, before)):
            assert torch.equal(a, b), i


# ---------------------------------------------------------------------------
# the scheduler: host, TorchScheduler on the CPU, and the JAX TPUScheduler
# ---------------------------------------------------------------------------


def _populate(sched, mk_node, mk_pod, seed, n_nodes=12, preemptors=4):
    """The JAX package's TestDevicePreemptionEquivalence._pair_run cluster:
    every node saturated by two lower-priority fillers, then preemptors."""
    rng = random.Random(seed)
    caps = []
    for i in range(n_nodes):
        cpu = rng.choice([2, 4])
        caps.append(cpu)
        b = mk_node().name(f"node-{i}").capacity({"cpu": cpu, "memory": "8Gi", "pods": 12})
        if rng.random() < 0.2:
            b = b.taint("team", "infra", "NoSchedule")
        sched.clientset.create_node(b.obj())
    f_i = 0
    for i, cpu in enumerate(caps):
        for _ in range(2):
            sched.clientset.create_pod(
                mk_pod().name(f"low-{f_i}").req({"cpu": f"{cpu * 500}m", "memory": "1Gi"})
                .node_selector({"kubernetes.io/hostname": f"node-{i}"})
                .toleration("team", "infra").priority(rng.choice([0, 1, 5])).obj())
            f_i += 1
    sched.run_until_idle()
    for i in range(preemptors):
        p = mk_pod().name(f"hi-{i}").req({"cpu": "2", "memory": "2Gi"}).priority(100)
        if rng.random() < 0.5:
            p = p.toleration("team", "infra")
        sched.clientset.create_pod(p.obj())
    for _ in range(30):
        sched.run_until_idle()
    return sched


def _outcome(sched):
    """({pod: (node, nominated node)}, survivors)."""
    pods = {p.name: (p.node_name, p.nominated_node_name) for p in sched.clientset.pods.values()}
    return pods, set(pods)


@pytest.mark.parametrize("seed", range(6))
def test_device_preemption_equivalence(seed):
    host = _populate(Scheduler(), make_node, make_pod, seed)
    port = _populate(TorchScheduler(device="cpu"), make_node, make_pod, seed)
    jax_dev = _populate(TPUScheduler(mesh=None), jax_make_node, jax_make_pod, seed)
    want = _outcome(jax_dev)
    assert _outcome(host) == want, f"seed {seed}: the port's host path diverged from JAX"
    assert _outcome(port) == want, f"seed {seed}: the port's device path diverged from JAX"
    assert port.preemption_device_evals > 0 and jax_dev.preemption_device_evals > 0
    assert port.preemption_verify_divergences == 0
    assert port.preemption_counts()["victims"] == host.preemption_counts()["victims"] > 0


def test_preemption_async_50_nodes():
    """PreemptionAsync/50Nodes (performance-config.yaml:345-348): 50 nodes
    of 4 cpu, 40 priority-1 init pods, 20 priority-100 measured pods: ten
    land on the empty nodes, ten preempt. The port's bench drive against
    the JAX TPUScheduler on the same cluster."""
    name = "PreemptionAsync/5000Nodes"
    w = bench.WORKLOADS[name]
    port = bench.build_cluster(50, device="cpu", node=w.node)
    bench.warm(port, 40, name)
    result = bench.measure(port, 20, workload=name)
    jax_dev = TPUScheduler(mesh=None)
    for i in range(50):
        jax_dev.clientset.create_node(jax_make_node().name(f"node-{i}")
                                      .capacity({"cpu": 4, "memory": "16Gi", "pods": 32}).obj())
    for prefix, prio, n in (("init", 1, 40), ("bench", 100, 20)):
        for i in range(n):
            jax_dev.clientset.create_pod(jax_make_pod().name(f"{prefix}-{i}")
                                         .req({"cpu": 4}).priority(prio).obj())
        jax_dev.run_until_idle()
    for _ in range(5):
        jax_dev.run_until_idle()
    assert _outcome(port) == _outcome(jax_dev)
    pre = result["detail"]["preemption"]
    assert pre["victims"] == 10 and pre["device_evals"] >= 10 and pre["verify_divergences"] == 0
    assert len(port.clientset.bindings) == 60 and len(port.clientset.pods) == 50
    nominated = [p for p in port.clientset.pods.values() if p.nominated_node_name]
    assert len(nominated) == 10 and all(p.node_name == p.nominated_node_name for p in nominated)
    assert not port.queue.nominator.has_nominated_pods()


def test_refuted_device_candidate_raises():
    """A candidate from the device dry run that the host dry run of its node
    refutes is counted and raises, as a failed kernel launch does; nothing
    is evicted and no host dry run takes its place."""
    s = TorchScheduler(device="cpu")
    for i in range(2):
        s.clientset.create_node(make_node().name(f"n{i}").capacity({"cpu": 4, "pods": 10}).obj())
        s.clientset.create_pod(make_pod().name(f"low-{i}").req({"cpu": 4}).priority(1).obj())
    s.run_until_idle()
    true_dry_run = s.device_dry_run_preemption

    def wrong_victims(*args):
        cands = true_dry_run(*args)
        assert len(cands) == 2
        # Each node's candidate names the other node's victim.
        return [type(c)(c.node_name, o.victims) for c, o in zip(cands, cands[::-1])]

    s.device_dry_run_preemption = wrong_victims
    s.clientset.create_pod(make_pod().name("high").req({"cpu": 4}).priority(100).obj())
    with pytest.raises(RuntimeError, match="device dry run"):
        s.run_until_idle()
    assert s.preemption_verify_divergences == 1
    assert {p.name for p in s.clientset.pods.values()} == {"low-0", "low-1", "high"}
    assert not s.queue.nominator.has_nominated_pods()


def test_measure_label_names_a_run_that_is_not_the_workload():
    """bench.measure with a label (chip_smoke's preempting case: the
    workload's templates, other init pods) heads the metric with the label
    and gives no vs_baseline, since the upstream threshold is the
    workload's own."""
    name = "PreemptionAsync/5000Nodes"
    sched = bench.build_cluster(8, device="cpu", node=bench.WORKLOADS[name].node)
    bench.warm(sched, 8, name)
    plain = bench.measure(sched, 0, workload=name)
    result = bench.measure(sched, 2, workload=name, label="preempting case")
    assert plain["vs_baseline"] == 0.0 and name in plain["metric"]
    assert result["vs_baseline"] is None
    assert result["metric"].startswith("pods scheduled/sec (preempting case: 8 nodes, 2 pods")
    assert result["detail"]["preemption"]["victims"] == 2


@pytest.mark.parametrize("make", [Scheduler, lambda: TorchScheduler(device="cpu")],
                         ids=["host", "device"])
def test_nomination_holds_its_room(make):
    """A preemptor's nominated node keeps the room it freed: a pod of lower
    priority that arrives before the preemptor's retry is kept off it by
    the two-pass filter (on the device, by the nominated lane) and lands on
    another node, or stays pending; the preemptor then takes the fast path
    to its node."""
    s = make()
    s.clientset.create_node(make_node().name("n0").capacity({"cpu": 4, "pods": 10}).obj())
    s.clientset.create_pod(make_pod().name("low").req({"cpu": 4}).priority(1).obj())
    s.run_until_idle()
    s.clientset.create_pod(make_pod().name("high").req({"cpu": 4}).priority(100).obj())
    assert s.schedule_one()  # fails, preempts "low", is nominated to n0
    pods = {p.name: p for p in s.clientset.pods.values()}
    assert set(pods) == {"high"} and pods["high"].nominated_node_name == "n0"
    assert s.queue.nominator.has_nominated_pods()
    # Lower-priority pods arrive before the preemptor's retry; one node more
    # has room for one of them.
    s.clientset.create_node(make_node().name("n1").capacity({"cpu": 2, "pods": 10}).obj())
    for i in range(2):
        s.clientset.create_pod(make_pod().name(f"mid-{i}").req({"cpu": 2}).priority(50).obj())
    s.run_until_idle()
    placed = {p.name: p.node_name for p in s.clientset.pods.values()}
    assert placed["high"] == "n0"
    assert sorted(placed[n] for n in ("mid-0", "mid-1")) == ["", "n1"]
    assert not s.queue.nominator.has_nominated_pods()
    jax_host = JaxHostScheduler(deterministic_ties=True)
    jax_host.clientset.create_node(jax_make_node().name("n0").capacity({"cpu": 4, "pods": 10})
                                   .obj())
    jax_host.clientset.create_pod(jax_make_pod().name("low").req({"cpu": 4}).priority(1).obj())
    jax_host.run_until_idle()
    jax_host.clientset.create_pod(jax_make_pod().name("high").req({"cpu": 4}).priority(100)
                                  .obj())
    jax_host.schedule_one()
    jax_host.clientset.create_node(jax_make_node().name("n1").capacity({"cpu": 2, "pods": 10})
                                   .obj())
    for i in range(2):
        jax_host.clientset.create_pod(jax_make_pod().name(f"mid-{i}").req({"cpu": 2})
                                      .priority(50).obj())
    jax_host.run_until_idle()
    assert placed == {p.name: p.node_name for p in jax_host.clientset.pods.values()}


def _gpu_case(sched, mk_node, mk_pod):
    """A victim with an extended scalar resource (the JAX package's
    test_scalar_resource_victims): its slot interns before the victim
    tensors are built."""
    sched.clientset.create_node(mk_node().name("n0").capacity(
        {"cpu": "4", "memory": "8Gi", "pods": 10, "example.com/gpu": 2}).obj())
    sched.clientset.create_pod(mk_pod().name("low").req({"cpu": "1", "example.com/gpu": 2})
                               .priority(0).obj())
    sched.run_until_idle()
    sched.clientset.create_pod(mk_pod().name("hi").req({"cpu": "1", "example.com/gpu": 1})
                               .priority(10).obj())


def _spread_case(sched, mk_node, mk_pod):
    """A preemptor with a zone spread: the dry run stays on the host (its
    verdicts couple rows), with PodTopologySpread's RemovePod/AddPod."""
    for i in range(2):
        sched.clientset.create_node(mk_node().name(f"node-{i}").zone(f"z{i}").capacity(
            {"cpu": "2", "memory": "4Gi", "pods": 10}).obj())
    for i in range(2):
        sched.clientset.create_pod(mk_pod().name(f"low-{i}").req({"cpu": "2"}).priority(1)
                                   .labels({"app": "w"}).obj())
    sched.run_until_idle()
    sched.clientset.create_pod(
        mk_pod().name("spread").req({"cpu": "1"}).priority(100).labels({"app": "w"})
        .spread_constraint(1, "topology.kubernetes.io/zone", "DoNotSchedule", {"app": "w"})
        .obj())


def _anti_case(sched, mk_node, mk_pod):
    """A cluster with a required anti-affinity pod: removing it could lift a
    verdict the kernel takes as static, so the dry run stays on the host."""
    for i in range(3):
        sched.clientset.create_node(mk_node().name(f"node-{i}").capacity(
            {"cpu": "2", "memory": "4Gi", "pods": 10}).obj())
    sched.clientset.create_pod(mk_pod().name("guard").req({"cpu": "2"}).priority(1)
                               .labels({"app": "g"})
                               .pod_affinity("kubernetes.io/hostname", {"app": "x"}, anti=True)
                               .obj())
    for i in range(2):
        sched.clientset.create_pod(mk_pod().name(f"low-{i}").req({"cpu": "2"}).priority(i)
                                   .obj())
    sched.run_until_idle()
    sched.clientset.create_pod(mk_pod().name("x").req({"cpu": "2"}).priority(100)
                               .labels({"app": "x"}).obj())


@pytest.mark.parametrize("case,device_evals", [(_gpu_case, True), (_spread_case, False),
                                               (_anti_case, False)],
                         ids=["scalar-victim", "spread-preemptor", "anti-affinity-cluster"])
def test_preemption_cases_match_jax(case, device_evals):
    """Each case on the port's host Scheduler and TorchScheduler(cpu)
    against the JAX TPUScheduler: the same survivors, assignments and
    nominations; the device dry run runs where the JAX package runs it and
    the host Evaluator where it sends the dry run by rule."""
    runs = []
    for sched, mk_node, mk_pod in ((Scheduler(), make_node, make_pod),
                                   (TorchScheduler(device="cpu"), make_node, make_pod),
                                   (TPUScheduler(mesh=None), jax_make_node, jax_make_pod)):
        case(sched, mk_node, mk_pod)
        for _ in range(10):
            sched.run_until_idle()
        runs.append(sched)
    host, port, jax_dev = runs
    assert _outcome(host) == _outcome(port) == _outcome(jax_dev)
    assert port.preemption_counts()["victims"] == 1
    assert (port.preemption_device_evals > 0) == device_evals
    assert (jax_dev.preemption_device_evals > 0) == device_evals
    assert port.preemption_verify_divergences == 0
