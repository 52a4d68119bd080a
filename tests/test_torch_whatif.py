"""The PyTorch port's what-if scorer (kubernetes_tpu_torch/ops/whatif.py)
against the JAX package's (kubernetes_tpu/ops/whatif.py), on the CPU.

The port's plain version of the whatif_score kernel must be bit-equal, on
the fit mask and the int64 score, to BOTH JAX paths — the numpy host walker
(`device=False`) and the jitted mirror (`device=True`, padded to
power-of-two tiers) — on seeded batches and on the kernel's hazards: int64
wrap-around on a 16 TiB node, floored division of negative numerators,
sizes that are not powers of two, and empty batches. `encode_batch` and
`best_moves` must give the JAX arrays and move lists on the same cluster.
The kernel itself is held equal to the plain version on the card by
chip_smoke.py. Every comparison is exact."""

import math

import numpy as np
import pytest
import torch

from kubernetes_tpu.core.node_info import NodeInfo as JaxNodeInfo
from kubernetes_tpu.core.node_info import PodInfo as JaxPodInfo
from kubernetes_tpu.ops import whatif as J
from kubernetes_tpu.testing.wrappers import make_node as jax_make_node
from kubernetes_tpu.testing.wrappers import make_pod as jax_make_pod
from kubernetes_tpu_torch.core.node_info import NodeInfo, PodInfo
from kubernetes_tpu_torch.ops import whatif as W
from kubernetes_tpu_torch.testing import make_node, make_pod
from kubernetes_tpu_torch.testing.kernel_inputs import whatif_inputs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small inputs: one intra-op thread keeps this module from crowding
    the other test workers' CPUs."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _three_ways(arrays):
    """(JAX host, JAX device, port plain) results of one batch."""
    jb = J.WhatIfBatch(*[np.array(a) for a in arrays])
    return (J.whatif_scores(jb, device=False), J.whatif_scores(jb, device=True),
            W.whatif_scores(W.batch_from_jax_numpy(jb), device="cpu"))


def _assert_equal(results):
    (fh, sh), (fd, sd), (fp, sp) = results
    np.testing.assert_array_equal(fh, fd)
    np.testing.assert_array_equal(sh, sd)
    np.testing.assert_array_equal(fp, fh)
    np.testing.assert_array_equal(sp, sh)
    assert fp.dtype == bool and sp.dtype == np.int64
    return fp, sp


# ---------------------------------------------------------------------------
# the score: port plain version == JAX host walker == JAX jitted mirror
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(12))
def test_plain_score_equals_both_jax_paths(seed):
    rng = np.random.default_rng(0xD35C + seed)
    n_nodes, n_pods = int(rng.integers(1, 40)), int(rng.integers(1, 20))
    fit, score = _assert_equal(_three_ways(whatif_inputs(seed, n_pods, n_nodes)))
    assert fit.shape == score.shape == (n_pods, n_nodes)


def test_16tib_node_wraps_identically():
    """`used * BA_SCALE` passes 2^63 on a node with 12+ TiB of non-zero
    memory: numpy and XLA both wrap, and so must the port."""
    arrays = whatif_inputs(40, 17, 30, huge=True)
    nonzero, alloc_r = arrays[3], arrays[0]
    used = nonzero[:, 1].astype(object) + int(arrays[6][:, 1].max())
    assert max(used) * J.BA_SCALE > np.iinfo(np.int64).max
    assert (alloc_r[:, 1] == 16 * 1024 ** 4).sum() == 10
    fit, score = _assert_equal(_three_ways(arrays))
    assert fit.any()


def test_negative_numerators_floor():
    """Negative non-zero and requested aggregates (the function defines
    them though encode_batch never makes them): every `//` floors."""
    arrays = whatif_inputs(41, 13, 25, negative=True)
    assert (arrays[3] < 0).any() and (arrays[2] < 0).any()
    _fit, score = _assert_equal(_three_ways(arrays))
    assert score.max() > 2 * J.MAX_NODE_SCORE  # the unclamped fit score shows


@pytest.mark.parametrize("shape", [(1, 1), (1, 3), (3, 37), (37, 3), (2, 5000)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_sizes_off_the_power_of_two_tiers(shape):
    """The JAX device path pads to power-of-two tiers and slices back; the
    port does not pad. No padding may leak into either result."""
    P, N = shape
    _assert_equal(_three_ways(whatif_inputs(50 + P + N, P, N)))


@pytest.mark.parametrize("shape", [(0, 0), (0, 7), (5, 0)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_empty_batch(shape):
    P, N = shape
    fit, score = _assert_equal(_three_ways(whatif_inputs(60, P, N)))
    assert fit.shape == score.shape == shape
    if P == 0:
        assert W.best_moves(W.WhatIfBatch(*whatif_inputs(60, P, N)), fit, score) == []


def test_wrapper_on_cpu_tensors_runs_the_plain_version():
    arrays = whatif_inputs(70, 9, 20)
    ts = [torch.from_numpy(a) for a in arrays]
    before = [t.clone() for t in ts]
    launches = W.whatif_score.launches
    fit, score = W.whatif_score(*ts)
    want = W._whatif_score_plain(*ts)
    assert torch.equal(fit, want[0]) and torch.equal(score, want[1])
    assert W.whatif_score.launches == launches  # plain runs count no launch
    assert all(torch.equal(a, b) for a, b in zip(ts, before))


# ---------------------------------------------------------------------------
# encode_batch on the same cluster
# ---------------------------------------------------------------------------


def _cluster(mk_node, mk_pod, node_info, pod_info):
    """Nodes: tainted, cordoned, clean, one with a scalar resource and one
    with a PreferNoSchedule taint; bound pods on them. Candidates: a plain
    pod, a tolerating pod, a zero-request pod, a pod with a scalar the
    nodes do not list, and a pod bound to a node outside the snapshot."""
    nodes = [
        mk_node().name("bad").capacity({"cpu": "8", "memory": "16Gi", "pods": 10})
        .taint("dedicated", "infra").obj(),
        mk_node().name("cordon").capacity({"cpu": "8", "memory": "16Gi", "pods": 10})
        .unschedulable().obj(),
        mk_node().name("ok").capacity({"cpu": "4", "memory": "8Gi", "pods": 10}).obj(),
        mk_node().name("gpu").capacity({"cpu": "16", "memory": "64Gi", "pods": 20,
                                        "example.com/gpu": 4,
                                        "ephemeral-storage": "100Gi"}).obj(),
        mk_node().name("soft").capacity({"cpu": "2", "memory": "4Gi", "pods": 5})
        .taint("soft", "", "PreferNoSchedule").obj(),
    ]
    infos = [node_info(n) for n in nodes]
    bound = [
        mk_pod().name("b0").req({"cpu": "1"}).node("ok").obj(),
        mk_pod().name("b1").node("ok").obj(),
        mk_pod().name("b2").req({"cpu": "2", "memory": "1Gi", "example.com/gpu": 1})
        .node("gpu").obj(),
    ]
    row = {ni.name: ni for ni in infos}
    for p in bound:
        row[p.node_name].add_pod(pod_info.of(p))
    candidates = [
        mk_pod().name("plain").req({"cpu": "1"}).node("ok").obj(),
        mk_pod().name("tol").req({"cpu": "1", "memory": "512Mi"}).node("bad")
        .toleration("dedicated", "infra").obj(),
        mk_pod().name("zero").node("gpu").obj(),
        mk_pod().name("fpga").req({"cpu": "500m", "example.com/fpga": 1}).node("soft").obj(),
        mk_pod().name("lost").req({"cpu": "1"}).node("gone").obj(),
    ]
    return infos, candidates


def test_encode_batch_equals_jax():
    jb = J.encode_batch(*_cluster(jax_make_node, jax_make_pod, JaxNodeInfo, JaxPodInfo))
    pb = W.encode_batch(*_cluster(make_node, make_pod, NodeInfo, PodInfo))
    for field, a, b in zip(J.WhatIfBatch._fields, jb, pb):
        assert a.dtype == b.dtype and a.shape == b.shape, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    # the cases are there: 3 base slots + gpu (node) + fpga (candidate)
    assert pb.alloc_r.shape == (5, 5)
    assert pb.alloc_r[3, 3] == 4 and pb.request[3, 4] == 1
    assert list(pb.mask[0]) == [False, False, True, True, True]   # taint, cordon
    assert list(pb.mask[1]) == [True, False, True, True, True]    # tolerated
    assert tuple(pb.nz_request[2]) == (NodeInfo.DEFAULT_MILLI_CPU, NodeInfo.DEFAULT_MEMORY)
    assert pb.src[4] == 0   # bound outside the snapshot: row 0
    assert pb.pod_count[2] == 2 and pb.nonzero[2, 0] == 1000 + NodeInfo.DEFAULT_MILLI_CPU
    fit, score = W.whatif_scores(pb, device="cpu")
    jfit, jscore = J.whatif_scores(jb)
    np.testing.assert_array_equal(fit, jfit)
    np.testing.assert_array_equal(score, jscore)
    assert W.best_moves(pb, fit, score) == [tuple(m) if m else None
                                            for m in J.best_moves(jb, jfit, jscore)]


# ---------------------------------------------------------------------------
# best_moves
# ---------------------------------------------------------------------------


def _moves_both(fit, score, src):
    P = fit.shape[0]
    z = [np.zeros((P, 3), np.int64), np.zeros((P, 2), np.int64), np.asarray(src, np.int64), fit]
    jm = J.best_moves(J.WhatIfBatch(*[None] * 5, *z), fit, score)
    pm = W.best_moves(W.WhatIfBatch(*[None] * 5, *z), fit, score)
    assert pm == [None if m is None else W.Move(*m) for m in jm]
    return pm


def test_best_moves_tie_breaks_to_lowest_row():
    (mv,) = _moves_both(np.ones((1, 4), bool), np.array([[10, 50, 50, 50]], np.int64), [0])
    assert (mv.src, mv.dst, mv.improvement) == (0, 1, 40)


def test_best_moves_unfit_source_scores_current_minus_one():
    (mv,) = _moves_both(np.array([[False, True]]), np.array([[50, 50]], np.int64), [0])
    assert mv.dst == 1 and mv.improvement == 1


def test_best_moves_no_feasible_other_row_is_none():
    assert _moves_both(np.array([[True, False]]), np.array([[50, 99]], np.int64), [0]) == [None]


@pytest.mark.parametrize("seed", range(3))
def test_best_moves_equal_jax_on_scored_batches(seed):
    arrays = whatif_inputs(80 + seed, 30, 40)
    jb = J.WhatIfBatch(*arrays)
    fit, score = J.whatif_scores(jb)
    jm = J.best_moves(jb, fit, score)
    pm = W.best_moves(W.WhatIfBatch(*arrays), *W.whatif_scores(W.WhatIfBatch(*arrays), "cpu"))
    assert pm == [None if m is None else W.Move(*m) for m in jm]
    assert any(m is not None for m in pm)


def test_batch_from_jax_numpy_round_trips():
    jb = J.encode_batch(*_cluster(jax_make_node, jax_make_pod, JaxNodeInfo, JaxPodInfo))
    pb = W.batch_from_jax_numpy(jb)
    assert isinstance(pb, W.WhatIfBatch) and pb._fields == J.WhatIfBatch._fields
    for a, b in zip(jb, pb):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
        assert not np.shares_memory(a, b)
    assert (pb.n_pods, pb.n_nodes) == (jb.n_pods, jb.n_nodes)


# ---------------------------------------------------------------------------
# the kernel's blocks (csrc/whatif_score.cu): a tile of WI_NODES node
# columns across a chunk of WI_CANDS candidates, each node's constants once,
# the divisions by a node's reciprocal with one exact correction. Modelled
# in numpy and held against the plain version.
# ---------------------------------------------------------------------------

WRAP = 1 << 64


def _wrap(x: int) -> int:
    return (x + (1 << 63)) % WRAP - (1 << 63)


def _recip_floor_div(a: int, d: int) -> int:
    """recip_floor_div of csrc/whatif_score.cu in Python: Python floats are
    IEEE float64 and round to nearest as the kernel's conversions and
    product do, the reciprocal is one correctly rounded division, and the
    remainder's true value fits int64, so the kernel's wrapping product
    gives it exactly."""
    e = float(a) * (1.0 / float(d))
    if d < 1 << 62 and abs(e) < 2.0 ** 50:
        q = math.floor(e)
        r = a - q * d
        assert -d <= r < 2 * d, (a, d)
        assert r == _wrap(a - _wrap(q * d))
        return q - (r < 0) + (r >= d)
    return a // d


def _recip_floor_div_v(a: np.ndarray, d: np.ndarray) -> np.ndarray:
    """_recip_floor_div element-wise on int64 arrays (d broadcast), the
    fast path vectorized; the model's divisions."""
    d = np.broadcast_to(d, a.shape)
    e = a.astype(np.float64) * (1.0 / d.astype(np.float64))
    fast = (d < 1 << 62) & (np.abs(e) < 2.0 ** 50)
    q = np.floor(np.where(fast, e, 0.0)).astype(np.int64)
    with np.errstate(over="ignore"):
        r = a - q * d
    out = q - (r < 0) + (r >= d)
    for i in zip(*np.nonzero(~fast)):
        out[i] = int(a[i]) // int(d[i])
    return out


@pytest.mark.parametrize("kind", ["fit-scores", "shares", "edge-2^31", "edge-2^50",
                                  "near-2^63", "wrapped-products", "negative", "wide-divisors"])
def test_recip_floor_div_equals_floored_division(kind):
    """The what-if's division (a node's float64 reciprocal, the product's
    floor and one exact correction) equals Python's floored // on the
    operands the fit and BalancedAllocation scores give it, at the 2^31 and
    2^50 edges, numerators near 2^63, wrapped products, negative
    numerators and divisors up to and past 2^62 (the exact fallback)."""
    rng = np.random.default_rng(100 + len(kind))
    n = 20000
    if kind == "fit-scores":     # (a - used) * 100 over a
        d = rng.integers(1, 1 << 45, n)
        a = (d - rng.integers(0, 1 << 45, n) % d) * 100
    elif kind == "shares":       # used * 1e6 over max(a, 1)
        d = rng.integers(1, 1 << 40, n)
        a = rng.integers(0, 1 << 40, n) * 1_000_000
    elif kind == "edge-2^31":
        d = (1 << 31) + rng.integers(-4, 5, n)
        a = d * rng.integers(-(1 << 31), 1 << 31, n) + rng.integers(-2, 3, n)
    elif kind == "edge-2^50":
        d = rng.integers(1, 1 << 12, n)
        a = d * ((1 << 50) + rng.integers(-3, 4, n)) * rng.choice([-1, 1], n) \
            + rng.integers(-2, 3, n)
    elif kind == "near-2^63":
        d = np.where(rng.random(n) < 0.5, rng.integers(1, 1 << 20, n),
                     rng.integers(1 << 40, 1 << 62, n))
        a = np.where(rng.random(n) < 0.5, np.int64((1 << 63) - 1) - rng.integers(0, 1 << 20, n),
                     np.int64(-(1 << 63)) + rng.integers(0, 1 << 20, n))
    elif kind == "wrapped-products":  # used * 1e6 past 2^63, as a 16 TiB node's
        d = rng.integers(1, 1 << 45, n)
        with np.errstate(over="ignore"):
            a = rng.integers(1 << 43, 1 << 46, n) * np.int64(1_000_000)
    elif kind == "negative":
        d = rng.integers(1, 1 << 40, n)
        a = -rng.integers(0, 1 << 62, n)
    else:
        d = rng.integers((1 << 62) - (1 << 20), (1 << 63) - 1, n)
        a = rng.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64)
    cases = list(zip(a.tolist(), d.tolist()))
    cases += [(2 ** 50 * 7 - 1, 7), (2 ** 50 * 7, 7), (-(2 ** 50) * 7 + 1, 7), (-1, 1 << 61),
              ((1 << 63) - 1, 1), (-(1 << 63), 3), (0, 5), (-5, 5), (-6, 5), (1 << 31, 1),
              ((1 << 31) - 1, (1 << 31) - 1), ((1 << 63) - 1, (1 << 62) - 1), (-1, (1 << 62))]
    for x, y in cases:
        assert _recip_floor_div(x, y) == x // y, (x, y)
    got = _recip_floor_div_v(np.array([x for x, _ in cases], np.int64),
                             np.array([y for _, y in cases], np.int64))
    assert got.tolist() == [x // y for x, y in cases]


class _WhatIfModel:
    """whatif_score as the kernel runs it: a block of WI_NODES node columns
    (a thread a node) across WI_CANDS candidates. A thread keeps its node's
    slack a - req of each slot (registers up to WI_REG_R, a shared tile
    past that while the stage fits STAGE_SMEM_MAX, device memory past the
    tile's room), one more pod's fit with and without the vacated one, the
    non-zero sums, the two divisors and fit_den; the chunk's candidate rows
    are staged; a cell divides by the node's reciprocals, takes
    BalancedAllocation's division in 32 bits while 50 * diff <= 10^8, and
    writes the one output buffer (the scores, then the fit bytes), read
    back through the wrapper's views."""

    def __init__(self, arrays):
        self.c = {**_defines("kernels.cuh"), **_defines("whatif_score.cu")}
        self.a = [np.asarray(x) for x in arrays]
        self.tiers = set()

    def tier(self, R):
        c = self.c
        if R <= c["WI_REG_R"]:
            return 0
        stage = 8 * (c["WI_CANDS"] * (R + 3) + R * c["WI_NODES"])
        return 1 if stage <= c["STAGE_SMEM_MAX"] else 2

    def run(self):
        alloc_r, alloc_pods, req_r, nonzero, pod_count, request, nz_request, src, mask = self.a
        P, N = mask.shape
        R = alloc_r.shape[1]
        TN, TC = self.c["WI_NODES"], self.c["WI_CANDS"]
        self.tiers.add(self.tier(R))
        out = np.full(9 * P * N, 0xA5, np.uint8)
        score = out[:8 * P * N].view(np.int64).reshape(P, N)
        fit = out[8 * P * N:].view(bool).reshape(P, N)
        with np.errstate(over="ignore"):
            for n0 in range(0, N, TN):
                nodes = slice(n0, min(n0 + TN, N))
                n = np.arange(n0, nodes.stop)
                slack = alloc_r[nodes] - req_r[nodes]                     # [T, R]
                pods_ok, pods_ok_vac = pod_count[nodes] + 1 <= alloc_pods[nodes], \
                    pod_count[nodes] <= alloc_pods[nodes]
                nz0, nz1 = nonzero[nodes, 0], nonzero[nodes, 1]
                a_cpu, a_mem = alloc_r[nodes, 0], alloc_r[nodes, 1]
                d_cpu, d_mem = np.maximum(a_cpu, 1), np.maximum(a_mem, 1)
                fit_den = (a_cpu > 0).astype(np.int64) + (a_mem > 0)
                both = (a_cpu > 0) & (a_mem > 0)
                for c0 in range(0, P, TC):
                    c = slice(c0, min(c0 + TC, P))
                    creq, cnz, csrc = request[c], nz_request[c], src[c]   # the stage
                    vac = csrc[:, None] == n[None, :]                    # [C, T]
                    q = creq[:, None, :]
                    avail = np.where(vac[..., None], slack[None] + q, slack[None])
                    viol = ((q > 0) & (q > avail)).any(axis=-1)
                    fit[c, nodes] = np.where(vac, pods_ok_vac, pods_ok) & ~viol & mask[c, nodes]
                    used0 = np.where(vac, nz0, nz0 + cnz[:, 0:1])
                    used1 = np.where(vac, nz1, nz1 + cnz[:, 1:2])
                    num = np.zeros(used0.shape, np.int64)
                    for a_, d_, u in ((a_cpu, d_cpu, used0), (a_mem, d_mem, used1)):
                        on = (a_ > 0) & (u <= a_)
                        num = num + np.where(on, _recip_floor_div_v((a_ - u) * 100, d_), 0)
                    fit_sc = np.where(fit_den == 2, num >> 1, num)
                    sh = [np.minimum(_recip_floor_div_v(u * 1_000_000, d_), 1_000_000)
                          for d_, u in ((d_cpu, used0), (d_mem, used1))]
                    diff = np.abs(sh[0] - sh[1])
                    small = (diff >= 0) & (diff <= 2_000_000)
                    narrow = (100_000_000 - 50 * np.where(small, diff, 0)).astype(np.uint32)
                    ba = np.where(both, np.where(small, narrow // np.uint32(1_000_000),
                                                 (100_000_000 - 50 * diff) // 1_000_000), 100)
                    score[c, nodes] = fit_sc + ba
        return W._score_views(torch.from_numpy(out), P, N)


def _defines(source):
    from kubernetes_tpu_torch.ops import _build

    return _build.defines(source)


def _edge_rows():
    """Source rows on every tile edge of the kernel's node tiles."""
    T = _defines("whatif_score.cu")["WI_NODES"]
    return [0, T - 1, T, T + 1, 2 * T - 1, 2 * T, 39 * T + 7, 10 ** 9]


def _model_holds(arrays):
    ts = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    model = _WhatIfModel(arrays)
    got, want = model.run(), W._whatif_score_plain(*ts)
    for name, a, b in zip(("fit_ok", "score"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
    return model, want


@pytest.mark.parametrize("P,N", [(P, 129) for P in (1, 15, 16, 17, 128, 600)]
                         + [(17, N) for N in (1, 127, 128, 5003)] + [(128, 5003)],
                         ids=lambda v: str(v))
def test_whatif_block_model_equals_the_plain_score(P, N):
    """The kernel's tiles over candidate counts below, at and past one
    chunk and node counts below, at and past one tile, the sources on
    every tile edge: the plain version's fit mask and scores."""
    _model, (fit, score) = _model_holds(whatif_inputs(300 + P + N, P, N,
                                                      src_rows=_edge_rows()))
    assert bool(fit.any())


@pytest.mark.parametrize("R", [2, 3, 7, 8, 9, 20, 85, 86])
@pytest.mark.parametrize("hazard", ["plain", "huge", "negative", "both"])
def test_whatif_block_model_slots_and_hazards(R, hazard):
    """Every tier of the slack (registers up to R 8, the shared tile up to
    R 85, device memory past it) on the drive's hazards: 16 TiB nodes
    (products wrap), negative numerators (floored), both at odd sizes."""
    kw = dict(huge=hazard in ("huge", "both"), negative=hazard in ("negative", "both"))
    model, _want = _model_holds(whatif_inputs(400 + R, 37, 261, R, src_rows=_edge_rows(), **kw))
    assert model.tiers == {0 if R <= 8 else 1 if R <= 85 else 2}


def test_whatif_score_at_the_drive_slots_equals_jax():
    """At the rebalance drive's R 3, P 17 over N 129 (past a chunk and a
    tile), the port equals both JAX paths."""
    fit, _score = _assert_equal(_three_ways(whatif_inputs(500, 17, 129,
                                                          src_rows=_edge_rows())))
    assert fit.any() and not fit.all()


def test_two_calls_leave_the_first_result_intact():
    """A result of whatif_scores is never written by the next call: two
    calls of one shape in a row through one staging ring (as the
    descheduler makes them), the first result as scored, sharing no memory
    with the second."""
    from kubernetes_tpu_torch.ops.staging import StagingRing

    ring = StagingRing("cpu")
    b1, b2 = (W.WhatIfBatch(*whatif_inputs(seed, 24, 300)) for seed in (600, 601))
    want1 = W._whatif_score_plain(*[torch.from_numpy(a) for a in b1])
    first = W.whatif_scores(b1, device="cpu", ring=ring)
    kept = [a.copy() for a in first]
    second = W.whatif_scores(b2, device="cpu", ring=ring)
    assert ring.uploads == 2
    for a, k, w in zip(first, kept, want1):
        np.testing.assert_array_equal(a, k)
        np.testing.assert_array_equal(a, w.numpy())
    assert not any(np.shares_memory(a, b) for a in first for b in second)
    assert not np.array_equal(first[1], second[1])


def test_stage_batch_is_one_upload_of_the_nine_arrays():
    """stage_batch packs the nine arrays into one ring buffer (16-byte
    aligned sections) and uploads it at once: the inputs are views of that
    one upload, equal to the arrays."""
    from kubernetes_tpu_torch.ops.staging import StagingRing

    batch = W.WhatIfBatch(*whatif_inputs(602, 5, 33, 4))
    ring = StagingRing("cpu")
    ts = W.stage_batch(ring, batch)
    assert ring.uploads == 1
    base = ts[0].untyped_storage().data_ptr()
    assert all(t.untyped_storage().data_ptr() == base for t in ts)
    assert all((t.data_ptr() - base) % 16 == 0 for t in ts)
    for t, a in zip(ts, batch):
        np.testing.assert_array_equal(t.numpy(), a)
