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
