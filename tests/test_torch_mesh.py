"""The PyTorch port's node-sharded mesh against the JAX reference, on the CPU.

The JAX package shards the node axis over its 8-device virtual CPU mesh
(tests/conftest.py); the port's mesh here is eight (or two, or four) shards
on the CPU (`make_mesh(devices=["cpu"] * S)`), where the sharded lap runs
its plain version (LapRun: the JAX body's three phases a shard, the
exchanges as real copies).

- The sharded lap: the port's ShardedLap against the JAX package's
  sharded_lap_schedule at S = 2, 4 and 8, fresh and chained, on seeded numpy
  draws with the hazard cases (floored arithmetic, the start's owner past
  shard 0 and a start of 0, shards with no feasible row, padded rows, a
  final lap shorter than L, nothing feasible), and against the port's own
  single-device lap.
- What only the card runs, modelled: the sharded_lap kernel's kept row
  state (each row evaluated once, landed rows again) stepped lap by lap
  against LapRun at S = 1, 2, 4 and 8; its exchange protocol under random
  schedules of shard progress, and a shard that never arrives; the
  exchange medium of a device list and the refusal of more shards than a
  card keeps resident.
- The scheduler: TorchScheduler(device="cpu", mesh=...) against
  TPUScheduler(mesh=make_mesh(n_cells=1)) on tests/test_sharded_mesh.py's
  shapes (the gathered path's chained sessions, the sharded lap's
  production dispatch, a spread and anti-affinity mix; score hints off in
  both and on in both), two cells through sharded_schedule_batch, and
  delta resume under the mesh (tests/test_incremental_resume.py:194-322's
  counterparts, hints off).

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


@pytest.fixture(params=[False, True], ids=["hints-off", "hints-on"])
def hints(request):
    """Score hints off (the dispatch path alone) and on (both packages'
    defaults): each parity case runs both ways."""
    return request.param


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
    """Laps stepped past the last pod change nothing: each phase of the
    plain version reads `done` and returns."""
    s, f, n_act = _draw(7, "full-windows")
    mesh = make_mesh(devices=["cpu"] * 4)
    st = shard_node_state(state_from_jax_numpy(s), mesh)
    ft = shard_features(features_from_jax_numpy(f), mesh)
    lap = sharded_lap_schedule(mesh, B, 0, VMAX)
    want, wc = lap(st, ft, n_act)
    run = lap.lap_run(st, ft, n_act)
    run.run()
    out = run.out
    before = [t.clone() for io in run.io for t in io.carry] + [out.clone()]
    for _ in range(3):
        run.one_lap()
    assert int(run.shards[0].done) >= n_act
    after = [t for io in run.io for t in io.carry] + [out]
    for a, b in zip(before, after):
        assert torch.equal(a, b)
    assert torch.equal(out, want)
    for a, b in zip(gather(Sharded([io.carry for io in run.io], st.block)), gather(wc)):
        assert torch.equal(a, b)


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
    """The sharded lap is one launcher, read from its source: the three
    per-phase launchers are gone, and its table, exchange buffer, results
    and device-memory tier are marked as the wrapper passes them."""
    from kubernetes_tpu_torch.ops import _build

    assert "sharded_lap" in _build.KERNELS
    assert not any(n.startswith("sharded_lap_") for n in _build.KERNELS)
    assert not hasattr(_build, "PHASES")
    sig = {p.name: p for p in _build.signature("sharded_lap")}
    assert _build.signature("sharded_lap")[0] == _build.Param("NPl", None)
    assert sig["table"].host and sig["table"].dtype == torch.int64
    assert sig["xbuf"].mapped and not sig["xbuf"].host
    assert {n for n, p in sig.items() if p.optional} == {"out", "work"}
    assert not any(hasattr(K, n) for n in ("sharded_lap_count", "sharded_lap_windows",
                                           "sharded_lap_land"))
    assert K.sharded_lap in K.WRAPPERS


# ---------------------------------------------------------------------------
# models of what only the card runs: the sharded_lap kernel's kept state
# and its exchange protocol (csrc/sharded_lap.cu)
# ---------------------------------------------------------------------------


class _ShardModel:
    """One block of the sharded_lap kernel in numpy: the shard's rows
    evaluated once (the prologue), its feasibility and totals kept, the
    threads' contiguous runs of rows and their block scan, the pair's one
    writer, the window pass, and landings that re-evaluate only the landed
    rows. `threads` is the block's size (the kernel takes any multiple of
    32; fewer threads give each one several rows)."""

    def __init__(self, sh: K.LapShard, s: int, S: int, fs: int, threads: int = 32):
        self.sh, self.s, self.S, self.fs = sh, s, S, fs
        c = sh.carry
        self.npl = npl = sh.static_ok.shape[0]
        self.req_r, self.nonzero, self.pod_count = (t.clone() for t in c[:3])
        self.fit = list(K._resource_eval_plain(sh.f, fs, sh.state.alloc_r, sh.state.alloc_pods,
                                               self.req_r, self.nonzero, self.pod_count))
        self.num = max(int(sh.f.num_nodes), 1)
        self.tf = max(int(sh.f.to_find), 1)
        self.base = s * npl
        gidx = self.base + torch.arange(npl)
        self.okd = (sh.static_ok & self.fit[0] & (gidx < self.num)).numpy().astype(np.int64)
        self.total = K._total(sh.f, self.fit[1], self.fit[2]).numpy().copy()
        self.start = int(c.start)
        self.rpt = -(-npl // threads)
        self.threads = threads

    def _scan(self):
        counts = np.array([self.okd[t * self.rpt:(t + 1) * self.rpt].sum()
                           for t in range(self.threads)], dtype=np.int64)
        return np.cumsum(counts) - counts, int(counts.sum())

    def pair(self):
        excl, count = self._scan()
        sidx = self.start - 1
        if self.start > 0 and self.base <= sidx < self.base + self.npl:
            lpos = sidx - self.base
            t = lpos // self.rpt
            return count, int(excl[t] + self.okd[t * self.rpt:lpos + 1].sum())
        return count, 0

    def windows(self, pairs, done: int, n_act: int):
        S, s, start, tf, num = self.S, self.s, self.start, self.tf, self.num
        NP = self.npl * S
        tots = [int(p[0]) for p in pairs]
        total_feas, offset = sum(tots), sum(tots[:s])
        owner = min(max((start - 1) // self.npl, 0), S - 1)
        f_start = sum(tots[:owner]) + int(pairs[owner][1]) if start > 0 else 0
        L = max(1, min(total_feas // tf, n_act - done, K.LAP_MAX))
        key, ev = [-1] * K.LAP_MAX, [num] * K.LAP_MAX
        excl, _ = self._scan()
        for t in range(self.threads):
            F = int(excl[t]) + offset
            for i in range(t * self.rpt, min((t + 1) * self.rpt, self.npl)):
                if not self.okd[i]:
                    continue
                F += 1
                g = self.base + i
                rank = F - f_start if g >= start else F + total_feas - f_start
                rot = (g - start) % num
                w = min((rank - 1) // tf, K.LAP_MAX)
                if w < L:
                    key[w] = max(key[w], int(self.total[i]) * NP + (NP - 1 - rot))
                if rank % tf == 0:
                    sb = min(rank // tf - 1, K.LAP_MAX)
                    if sb < K.LAP_MAX:
                        ev[sb] = min(ev[sb], rot + 1)
        return key + [-e for e in ev], L

    def land(self, gathered, L: int, done: int, out) -> None:
        NP, num, start = self.npl * self.S, self.num, self.start
        f = self.sh.f
        for w in range(K.LAP_MAX):
            kw = max(int(row[w]) for row in gathered)
            nb = max(int(row[K.LAP_MAX + w]) for row in gathered)
            has = w < L and kw >= 0
            row = (start + (NP - 1 - kw % NP)) % num if has else -1
            start_w = (start - nb) % num
            if out is not None and done + w < out.shape[1]:
                out[:, done + w] = torch.tensor([row, start_w], dtype=torch.int32)
            if w == L - 1:
                self.start = start_w
            i = row - self.base
            if has and 0 <= i < self.npl:
                self.req_r[i] += f.request
                self.nonzero[i] += f.nz_request
                self.pod_count[i] += 1
                st = self.sh.state
                fit = K._resource_eval_plain(f, self.fs, st.alloc_r[i:i + 1],
                                             st.alloc_pods[i:i + 1], self.req_r[i:i + 1],
                                             self.nonzero[i:i + 1], self.pod_count[i:i + 1])
                for lane, new in zip(self.fit, fit):
                    lane[i] = new[0]
                self.total[i] = int(K._total(f._replace(il_score=f.il_score[i:i + 1]),
                                             fit[1], fit[2])[0])
                self.okd[i] = int(bool(self.sh.static_ok[i]) and bool(fit[0][0]) and row < num)


@pytest.mark.parametrize("case", list(LAP_CASES))
@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_sharded_lap_kept_state_model_matches_the_plain_laps(shards, case):
    """The kernel's design, modelled: each shard's rows evaluated once,
    only landed rows re-evaluated, the counts and prefixes from the kept
    state. Stepped lap by lap against LapRun, which re-evaluates every row
    every lap: the kept feasibility and totals, the pairs, the keys and L,
    the landings, the results and the final fit lanes are equal."""
    fs = list(LAP_CASES).index(case) % 2
    s, f, n_act = _draw(80 + list(LAP_CASES).index(case), case)
    mesh = make_mesh(devices=["cpu"] * shards)
    st = shard_node_state(state_from_jax_numpy(s), mesh)
    ft = shard_features(features_from_jax_numpy(f), mesh)
    run = sharded_lap_schedule(mesh, B, fs, VMAX).lap_run(st, ft, n_act)
    models = [_ShardModel(io, i, shards, fs, threads=32 if i % 2 else 1024)
              for i, io in enumerate(run.io)]
    out = torch.full((2, B), -1, dtype=torch.int32)
    done = laps = 0
    while done < n_act:
        run.count_phase()
        for m, b in zip(models, run.shards):
            assert (m.okd == b.okd.numpy()).all() and (m.total == b.total.numpy()).all()
            assert m.pair() == tuple(b.pair.tolist())
        pairs = [m.pair() for m in models]
        run.exchange_pairs()
        run.windows_phase()
        keys = [m.windows(pairs, done, n_act) for m in models]
        for (k, L), b in zip(keys, run.shards):
            assert k == b.keys.tolist() and L == int(b.L)
        run.exchange_keys()
        run.land_phase()
        L = keys[0][1]
        for i, m in enumerate(models):
            m.land([k for k, _L in keys], L, done, out if i == 0 else None)
            c = run.io[i].carry
            assert torch.equal(m.req_r, c.req_r) and torch.equal(m.nonzero, c.nonzero)
            assert torch.equal(m.pod_count, c.pod_count) and m.start == int(c.start)
        done += L
        laps += 1
    run.run()  # no lap left: the fit lanes from the final aggregates
    assert torch.equal(out, run.out) and laps > 0
    for m, io in zip(models, run.io):
        for mine, lane in zip(m.fit, (io.carry.fit_ok, io.carry.fit_sc, io.carry.ba)):
            assert torch.equal(mine, lane)


def _protocol(s, S, mem, dispatches, budget, status, trace):
    """One block of the kernel's exchange protocol over `dispatches` (a list
    of (generation, per-lap values)): one memory action a step. A slot is
    {"tag", "payload", "readers"}; an arrival word is (generation, lap + 1).
    A wait that spins past `budget` steps writes the status and ends."""
    for gen, values in dispatches:
        done, lap = 0, 0
        n_act = values["n_act"]
        while done < n_act:
            tag = (gen, lap + 1)
            got = {}
            for region in ("pair", "key"):
                slot = mem[(region, s)]
                assert slot["payload"] is None or len(slot["readers"]) == S, (
                    f"shard {s} rewrote its {region} slot before every shard read it")
                slot["payload"] = (gen, lap, values["count"](s, lap))
                slot["readers"] = set()
                yield
                slot["tag"] = tag  # the release, after the payload
                yield
                for t in range(S):
                    spins = 0
                    while mem[(region, t)]["tag"] != tag:
                        spins += 1
                        if spins > budget:
                            status[s] = (gen, lap, region)
                            return
                        yield
                    g, l_, v = mem[(region, t)]["payload"]
                    assert (g, l_) == (gen, lap), f"shard {s} read lap {l_} for lap {lap}"
                    mem[(region, t)]["readers"].add(s)
                    got[(region, t)] = v
                    yield
            total = sum(got[("pair", t)] for t in range(S))
            L = max(1, min(total // values["to_find"], n_act - done, K.LAP_MAX))
            done += L
            lap += 1
        trace.append((s, gen, lap, done))


def _run_protocol(S, dispatches, seed, budget=10 ** 6, dead=()):
    rng = random.Random(seed)
    mem = {(r, t): {"tag": None, "payload": None, "readers": set()}
           for r in ("pair", "key") for t in range(S)}
    status, trace = {}, []
    live = {s: _protocol(s, S, mem, dispatches, budget, status, trace)
            for s in range(S) if s not in dead}
    steps = 0
    while live:
        s = rng.choice(sorted(live))
        try:
            next(live[s])
        except StopIteration:
            del live[s]
        steps += 1
        assert steps < 10 ** 7, "the protocol did not end"
    return status, trace


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("shards", [2, 4, 8])
def test_sharded_lap_exchange_protocol_under_random_schedules(shards, seed):
    """The exchanges as the kernel makes them, two dispatches back to back
    with no barrier between the shards' dispatches (cards run apart), each
    shard's steps interleaved at random: no shard reads a slot of another
    lap or dispatch, no slot is rewritten before every shard has read it,
    and every shard leaves each dispatch at the same lap with the same
    count."""
    r = random.Random(1000 + seed)
    table = {(s, lap): r.randint(0, 12) for s in range(shards) for lap in range(200)}
    dispatches = [(gen, {"n_act": r.randint(1, 150), "to_find": r.randint(1, 9),
                         "count": lambda s, lap: table[(s, lap)]}) for gen in (1, 2)]
    status, trace = _run_protocol(shards, dispatches, seed)
    assert status == {}
    for gen in (1, 2):
        ends = {(lap, done) for s, g, lap, done in trace if g == gen}
        assert len(ends) == 1 and len([t for t in trace if t[1] == gen]) == shards


@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_lap_waits_end_with_a_status_when_a_shard_never_arrives(shards):
    """A shard that never runs: every other shard's wait runs out of budget,
    writes its status and ends; none finishes the dispatch."""
    dispatches = [(1, {"n_act": 50, "to_find": 3, "count": lambda s, lap: 5})]
    status, trace = _run_protocol(shards, dispatches, 3, budget=50, dead=(shards - 1,))
    assert trace == [] and set(status) == set(range(shards - 1))
    assert all(st == (1, 0, "pair") for st in status.values())


def test_exchange_medium_and_cards_of_a_device_list():
    c0, c1 = torch.device("cuda", 0), torch.device("cuda", 1)
    assert K.exchange_medium([c0] * 4) == c0
    assert K.exchange_medium([c0, c1]) is None  # pinned host memory
    assert K.exchange_medium([c0, c1, c0, c1]) is None
    assert K.shards_per_card([c0, c1, c0, c1]) == {c0: [0, 2], c1: [1, 3]}
    assert list(K.shards_per_card([c1, c0, c0])) == [c1, c0]


def test_a_card_asked_for_more_shards_than_stay_resident_is_refused():
    K.check_resident(torch.device("cuda", 0), 32, 32)
    with pytest.raises(ValueError, match="at most 32 resident"):
        K.check_resident(torch.device("cuda", 0), 33, 32)
    with pytest.raises(ValueError, match="at most 0 resident"):
        K.check_resident(torch.device("cuda", 0), 1, 0)


# ---------------------------------------------------------------------------
# the scheduler under a mesh
# ---------------------------------------------------------------------------


def _jax_sched(mesh=True, max_batch=64, hints=False):
    """The JAX mesh scheduler, score hints on or off (with them, a replica
    after a clean session binds before any session starts)."""
    s = TPUScheduler(max_batch=max_batch, mesh=jax_make_mesh(n_cells=1) if mesh else None)
    s._hints.enabled = hints
    return s


def _port_sched(max_batch=64, shards=8, hints=False):
    return TorchScheduler(device="cpu", max_batch=max_batch, score_hints=hints,
                          mesh=make_mesh(devices=["cpu"] * shards))


def _assignments(s):
    return {f"{p.namespace}/{p.name}": p.node_name for p in s.clientset.pods.values()}


def _run_both(build, max_batch, hints=False):
    """The same scripted cluster through the JAX mesh scheduler and the
    port's, each with its package's builders, score hints on or off in
    both."""
    out = []
    for sched, mk_node, mk_pod in ((_jax_sched(max_batch=max_batch, hints=hints), jax_make_node,
                                    jax_make_pod),
                                   (_port_sched(max_batch, hints=hints), make_node, make_pod)):
        build(sched, mk_node, mk_pod)
        sched.run_until_idle()
        out.append(sched)
    jax_s, port = out
    assert _assignments(jax_s) == _assignments(port)
    assert jax_s.host_path_pods == port.host_path_pods == 0
    assert port.mesh is not None and isinstance(port.mirror._device, Sharded)
    return jax_s, port


def test_chained_sessions_match_jax_under_mesh(hints):
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
    jax_s, port = _run_both(build, 32, hints=hints)
    assert port.device_batches >= 3 and port.shard_map_dispatches == 0


def test_sharded_lap_is_the_production_dispatch_of_row_local_plans(hints):
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
    jax_s, port = _run_both(build, 128, hints=hints)
    assert port.shard_map_dispatches == jax_s.shard_map_dispatches >= 3
    assert port.scheduled == 300


def test_spread_and_anti_affinity_mix_matches_jax_under_mesh(hints):
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
    _run_both(build, 128, hints=hints)


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
    """The JAX mesh scheduler and the port's over identical clusters, score
    hints off in both: the cases are about the sessions' own delta path."""

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
