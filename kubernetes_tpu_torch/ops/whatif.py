"""What-if rescore of BOUND pods — the descheduler's scoring core.

The scheduler answers "where should this pending pod land?"; the
descheduler asks the inverse: "for a pod already bound, does a strictly
better row exist?". Both share one arithmetic — the fit filter,
LeastAllocated over cpu and memory and the integer-quantized
BalancedAllocation — evaluated here as ONE dense candidate-pods × nodes
matrix, with each candidate's own usage subtracted from its source row
first (the move vacates it).

The batch is encoded on the host in numpy (`encode_batch`), scored by the
`whatif_score` kernel (csrc/whatif_score.cu) on a CUDA device or by its
plain PyTorch version on the CPU, and the moves are picked on the host
(`best_moves`). Both score paths are bit-identical to the JAX package's
host walker and jitted mirror (kubernetes_tpu/ops/whatif.py): a standby
descheduler re-deriving a dead ACTIVE's plan must mint the SAME
``uid@node`` move set, or the exactly-once eviction ledger stops absorbing
the replay.

Every integer division floors (numpy's and XLA's ``//``; the kernel takes
a node's float64 reciprocal and corrects the quotient exactly), and every
int64 product wraps as numpy's and XLA's do: a node whose non-zero memory
passes 2^63 / 10^6 bytes (~8.4 TiB) overflows ``used * BA_SCALE``
identically on every path.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..api.types import find_matching_untolerated_taint
from ..core.node_info import NodeInfo
from .staging import StagingRing

MAX_NODE_SCORE = 100
BA_SCALE = 1_000_000

# Resource slot layout — the NodeStateMirror row convention
# (ops/device_state.py): [cpu_milli, memory, ephemeral_storage, *scalars].
SLOT_CPU = 0
SLOT_MEMORY = 1
SLOT_EPHEMERAL = 2
BASE_RESOURCES = 3

i64 = torch.int64


class WhatIfBatch(NamedTuple):
    """One dense candidates × nodes what-if problem (all int64/bool numpy).

    Node rows use the mirror's encoding; ``mask[p, n]`` folds the
    host-evaluated static gates (row validity, taint toleration) so both
    score paths consume one shared feasibility plane and parity reduces
    to the fit/BA arithmetic alone.
    """

    alloc_r: np.ndarray      # [N, R] allocatable per slot
    alloc_pods: np.ndarray   # [N]    allocatable pod count
    req_r: np.ndarray        # [N, R] requested per slot (bound pods)
    nonzero: np.ndarray      # [N, 2] non-zero-default cpu/mem aggregate
    pod_count: np.ndarray    # [N]    bound pods per node
    request: np.ndarray      # [P, R] candidate request vector
    nz_request: np.ndarray   # [P, 2] candidate non-zero cpu/mem
    src: np.ndarray          # [P]    candidate's current row index
    mask: np.ndarray         # [P, N] landing eligibility

    @property
    def n_pods(self) -> int:
        return int(self.request.shape[0])

    @property
    def n_nodes(self) -> int:
        return int(self.alloc_r.shape[0])


def batch_from_jax_numpy(arrays: Sequence[np.ndarray]) -> WhatIfBatch:
    """The JAX package's WhatIfBatch, fetched field by field with
    np.asarray, as the port's batch."""
    return WhatIfBatch(*[np.array(a) for a in arrays])


def _resource_vec(r, slots: Dict[str, int], out: np.ndarray) -> None:
    out[SLOT_CPU] = r.milli_cpu
    out[SLOT_MEMORY] = r.memory
    out[SLOT_EPHEMERAL] = r.ephemeral_storage
    for name, amount in r.scalar_resources.items():
        out[slots[name]] = amount


def encode_batch(node_infos: Sequence[NodeInfo],
                 candidates: Sequence[object]) -> WhatIfBatch:
    """Encode a snapshot + candidate pod list into one WhatIfBatch.

    Rows follow NodeStateMirror's slot layout with the scalar-slot map
    rebuilt per batch, in first-seen order (nodes, then candidates). The
    taint gate is evaluated here once and folded into ``mask``. A candidate
    bound to a node outside the snapshot takes row 0 as its source.
    """
    slots: Dict[str, int] = {}
    for ni in node_infos:
        for name in ni.allocatable.scalar_resources:
            slots.setdefault(name, BASE_RESOURCES + len(slots))
    for pod in candidates:
        for name in pod.resource_request().scalar_resources:
            slots.setdefault(name, BASE_RESOURCES + len(slots))
    R = BASE_RESOURCES + len(slots)
    N, P = len(node_infos), len(candidates)
    alloc_r = np.zeros((N, R), np.int64)
    alloc_pods = np.zeros(N, np.int64)
    req_r = np.zeros((N, R), np.int64)
    nonzero = np.zeros((N, 2), np.int64)
    pod_count = np.zeros(N, np.int64)
    by_name = {ni.name: i for i, ni in enumerate(node_infos)}
    for i, ni in enumerate(node_infos):
        _resource_vec(ni.allocatable, slots, alloc_r[i])
        alloc_pods[i] = ni.allocatable.allowed_pod_number
        _resource_vec(ni.requested, slots, req_r[i])
        nonzero[i, 0] = ni.non_zero_requested.milli_cpu
        nonzero[i, 1] = ni.non_zero_requested.memory
        pod_count[i] = len(ni.pods)
    request = np.zeros((P, R), np.int64)
    nz_request = np.zeros((P, 2), np.int64)
    src = np.zeros(P, np.int64)
    mask = np.zeros((P, N), bool)
    for p, pod in enumerate(candidates):
        req = pod.resource_request()
        _resource_vec(req, slots, request[p])
        nz_request[p, 0] = req.milli_cpu or NodeInfo.DEFAULT_MILLI_CPU
        nz_request[p, 1] = req.memory or NodeInfo.DEFAULT_MEMORY
        src[p] = by_name.get(pod.node_name, 0)
        for i, ni in enumerate(node_infos):
            node = ni.node
            if node is None or getattr(node, "unschedulable", False):
                continue
            if find_matching_untolerated_taint(
                    node.taints, pod.tolerations) is not None:
                continue
            mask[p, i] = True
    return WhatIfBatch(alloc_r, alloc_pods, req_r, nonzero, pod_count,
                       request, nz_request, src, mask)


# ---------------------------------------------------------------------------
# whatif_score: the kernel and its plain version
# ---------------------------------------------------------------------------


def _whatif_score_plain(alloc_r, alloc_pods, req_r, nonzero, pod_count, request,
                        nz_request, src, mask):
    """Plain PyTorch version of the whatif_score kernel: the JAX package's
    `_score_host` / jitted `score` (kubernetes_tpu/ops/whatif.py:142-182,
    :208-246) on int64 tensors — the fit filter (fit.go:710), LeastAllocated
    over (cpu, memory) with weight 1 each and BalancedAllocation quantized
    at BA_SCALE, on the state with each candidate vacated from its source
    row."""
    P, N = mask.shape
    vacate = torch.zeros((P, N), dtype=i64, device=mask.device)
    vacate[torch.arange(P, device=mask.device), src] = 1
    req_v = req_r[None, :, :] - vacate[:, :, None] * request[:, None, :]
    nz_v = nonzero[None, :, :] - vacate[:, :, None] * nz_request[:, None, :]
    count_v = pod_count[None, :] - vacate
    alloc = alloc_r[None, :, :]
    pods_ok = count_v + 1 <= alloc_pods[None, :]
    req = request[:, None, :]
    viol = ((req > 0) & (req > alloc - req_v)).any(dim=-1)
    fit_ok = pods_ok & ~viol & mask
    used0 = nz_v[..., 0] + nz_request[:, 0, None]
    used1 = nz_v[..., 1] + nz_request[:, 1, None]
    fit_num = torch.zeros_like(used0)
    fit_den = torch.zeros_like(used0)
    for slot, used in ((SLOT_CPU, used0), (SLOT_MEMORY, used1)):
        a = alloc[..., slot]
        rscore = torch.where((a > 0) & (used <= a),
                             (a - used) * MAX_NODE_SCORE // a.clamp_min(1), 0)
        fit_num = fit_num + torch.where(a > 0, rscore, 0)
        fit_den = fit_den + torch.where(a > 0, 1, 0)
    fit_sc = torch.where(fit_den > 0, fit_num // fit_den.clamp_min(1), 0)
    a_cpu = alloc[..., SLOT_CPU]
    a_mem = alloc[..., SLOT_MEMORY]
    q_cpu = (used0 * BA_SCALE // a_cpu.clamp_min(1)).clamp_max(BA_SCALE)
    q_mem = (used1 * BA_SCALE // a_mem.clamp_min(1)).clamp_max(BA_SCALE)
    both = (a_cpu > 0) & (a_mem > 0)
    ba = torch.where(both, (MAX_NODE_SCORE * BA_SCALE - 50 * (q_cpu - q_mem).abs()) // BA_SCALE,
                     MAX_NODE_SCORE)
    return fit_ok, (fit_sc + ba).to(i64)


def _score_views(buf: torch.Tensor, P: int, N: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(fit_ok [P, N] bool, score [P, N] i64) as contiguous views of one byte
    buffer (a tensor or a numpy array) of 9 * P * N bytes: the int64 scores
    first, then the fit bytes at byte 8 * P * N."""
    cut = 8 * P * N
    if isinstance(buf, np.ndarray):
        return buf[cut:].view(bool).reshape(P, N), buf[:cut].view(np.int64).reshape(P, N)
    return buf[cut:].view(torch.bool).view(P, N), buf[:cut].view(i64).view(P, N)


def _whatif_score_cuda(alloc_r, alloc_pods, req_r, nonzero, pod_count, request,
                       nz_request, src, mask, out):
    from .kernel import _launch

    P, N = mask.shape
    _launch("whatif_score", alloc_r.device, P, N, alloc_r.shape[1], alloc_r, alloc_pods, req_r,
            nonzero, pod_count, request, nz_request, src, mask, out)
    return _score_views(out, P, N)


def whatif_score(alloc_r, alloc_pods, req_r, nonzero, pod_count, request, nz_request, src,
                 mask, out: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(fit_ok [P, N] bool, score [P, N] i64, 0..200) of every candidate on
    every node row, `src` in [0, N): views of one byte buffer of 9 * P * N
    bytes on the inputs' device (_score_views), `out` where given (one
    allocation a call otherwise). An empty batch (P or N 0) launches
    nothing."""
    from .kernel import _on_cpu

    P, N = mask.shape
    if out is None:
        out = torch.empty(9 * P * N, dtype=torch.uint8, device=mask.device)
    if P == 0 or N == 0:
        out.zero_()
        return _score_views(out, P, N)
    if _on_cpu(alloc_r):
        views = _score_views(out, P, N)
        for view, got in zip(views, _whatif_score_plain(alloc_r, alloc_pods, req_r, nonzero,
                                                        pod_count, request, nz_request, src,
                                                        mask)):
            view.copy_(got)
        return views
    views = _whatif_score_cuda(alloc_r, alloc_pods, req_r, nonzero, pod_count, request,
                               nz_request, src, mask, out)
    whatif_score.launches += 1
    return views


whatif_score.launches = 0


def batch_tensors(batch: WhatIfBatch, device) -> tuple:
    """The batch's nine arrays as tensors on `device`, in whatif_score's
    argument order."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in batch)


def _batch_spec(batch: WhatIfBatch) -> tuple:
    """(dtype, shape) of the batch's nine arrays in one upload."""
    return tuple((torch.bool if a.dtype == bool else i64, a.shape) for a in batch)


def stage_batch(ring: StagingRing, batch: WhatIfBatch) -> list:
    """The batch's nine arrays packed straight into one buffer of the
    StagingRing `ring` and copied to its device at once: whatif_score's
    inputs as views of that one upload."""
    from .kernel import _layout, _views

    spec = _batch_spec(batch)
    offs, total = _layout(spec)
    for view, a in zip(_views(ring.take(total), spec, offs), batch):
        view[...] = a
    return _views(ring.upload(total), spec, offs)


def whatif_scores(batch: WhatIfBatch, device="cuda",
                  ring: Optional[StagingRing] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Score the batch on `device`: returns ``(fit_ok [P, N] bool,
    score [P, N] i64)`` on the host, ``score = fit_sc + ba`` (0..200).
    A CUDA device launches the kernel; "cpu" runs its plain version.

    The call is one upload (stage_batch, through `ring`, the caller's
    StagingRing of `device`: a caller that scores batch after batch keeps
    one; a new one where None), the launch into one output allocation, and
    one copy of it into a new pinned host block that the returned arrays
    are views of: the caching host allocator hands the block out again only
    once those arrays are gone, so a later call never writes into them."""
    if batch.n_pods == 0 or batch.n_nodes == 0:
        shape = (batch.n_pods, batch.n_nodes)
        return np.zeros(shape, bool), np.zeros(shape, np.int64)
    device = torch.device(device)
    P, N = batch.n_pods, batch.n_nodes
    out = torch.empty(9 * P * N, dtype=torch.uint8, device=device)
    whatif_score(*stage_batch(ring or StagingRing(device), batch), out=out)
    if device.type == "cpu":
        host = out
    else:
        host = torch.empty(out.shape, dtype=torch.uint8, pin_memory=True)
        host.copy_(out, non_blocking=True)
        torch.cuda.current_stream(device).synchronize()
    return _score_views(host.numpy(), P, N)


class Move(NamedTuple):
    pod_index: int        # index into the candidate list
    src: int              # current row
    dst: int              # best landing row
    improvement: int      # score(dst) - score(src); >= 1 when src unfit


def best_moves(batch: WhatIfBatch, fit_ok: np.ndarray,
               score: np.ndarray) -> List[Optional[Move]]:
    """Pick each candidate's best strictly-different landing row.

    Deterministic: ties break to the LOWEST row index (numpy argmax
    first-occurrence), so two managers scoring the same snapshot plan
    the same move set — the exactly-once replay contract. A candidate
    whose source row no longer fits it (drift shrank the node under a
    bound pod) scores its current seat as ``current - 1``, so a
    merely-equal landing row still registers a positive improvement.
    """
    out: List[Optional[Move]] = []
    P = batch.n_pods
    for p in range(P):
        row_ok = fit_ok[p].copy()
        s = int(batch.src[p])
        cur_fit = bool(row_ok[s])
        cur = int(score[p, s]) if cur_fit else int(score[p, s]) - 1
        row_ok[s] = False
        if not row_ok.any():
            out.append(None)
            continue
        masked = np.where(row_ok, score[p], np.int64(-1))
        dst = int(masked.argmax())
        out.append(Move(p, s, dst, int(masked[dst]) - cur))
    return out
