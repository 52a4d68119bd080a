"""The batch scheduling kernels: the Filter→Score hot path
(schedule_one.go findNodesThatFitPod :630 / prioritizeNodes :945) for a batch
of identical pods, with the greedy sequential assignment on the device.

Hand-written CUDA kernels (csrc/), each beside a plain PyTorch version of
the same function in this module (whatif_score, the descheduler's what-if
rescore, lives in ops/whatif.py and is counted and reset with these):

- static_masks   <- the JAX package's _static_masks + _tolerates
                    (ops/kernel.py:105-150), once per batch;
- resource_eval  <- _resource_eval (:160-208), the fresh-carry seed;
- lap_schedule   <- _lap_schedule (:799-925): plans whose landings change
                    only their own row (fit-only, hostname anti-affinity),
                    batches of more than 64 steps;
- scan_general   <- the schedule_batch scan step and feasibility_proj
                    (:314-523) with its prologue (:545-575) for every other
                    plan: spread and affinity count tables, kept-set
                    normalized score lanes, full or incremental feasibility,
                    and the row-local plans of at most 64 steps (the
                    reference's scan path for them, :273);
- dry_run_preemption <- dry_run_preemption (:726-789): DefaultPreemption's
                    per-node victim selection for every row at once;
- scatter_rows   <- the mirror's dirty-row scatter, _scatter_rows_impl
                    (ops/device_state.py:130-135), copy-on-write in one
                    launch from one staged upload (stage_scatter);
- patch_carry_rows <- patch_carry_rows (:584-621): a journal delta patch of
                    a live session's carry, the dirty rows' aggregates
                    installed and their resource lanes re-evaluated,
                    copy-on-write in one launch (stage_carry_patch);
- schedule_placements <- schedule_placements (:655-723): a pod group's
                    greedy scan against each of P candidate placements at
                    once, a block a placement running scan_general's step
                    (csrc/scan_general.cuh) over its placement's rows only;
- sharded_lap    <- the node-sharded lap, _lap_body (parallel/mesh.py:228-351):
                    one persistent launch a card a dispatch, a block a
                    shard, every lap and both exchanges of a lap on the
                    device (LapRun, its plain version, runs the body's
                    three phases with the exchanges as copies).

The two schedule kernels take the nominated-pod lane (features whose
`nom_req` has rows): the fit filter of every re-evaluated row counts the
row's nominated pods, as the JAX package's `has_nom` plans do. They and
schedule_placements take the `blocked` lane of a `port_selfblock` plan (a
pod with host ports): a row where a pod of the session landed is
infeasible for the rest of it; and the `aux_cnt` lane of a `has_aux` plan
(a pod whose claims count against a CSI attach limit): each landing adds
the pod's attachments `aux_inc` to its row's count, and a row is feasible
only while `aux_cnt + aux_inc <= aux_room` (the JAX package's :322-325,
:485-498, :843-846, :887-890). Both lanes are row-local, so neither picks
another kernel.

A wrapper runs the plain version only because the tensors it was given lie
on the CPU; on CUDA tensors it launches its kernel (building it at first
use) or raises. Each wrapper counts its launches in `<wrapper>.launches`.

Semantics are the JAX package's, bit for bit: exact int64 score math,
floored division and modulo, `ScanCarry`'s lane dtypes (cumsums pinned to
int32), inert padded steps, and the dump lane LAP_MAX that never lands.
Padded steps land nothing and keep the rotation start, so the plain
versions and the kernels stop at the last active step and fill the rest.
"""

from __future__ import annotations

import functools
import math
from contextlib import nullcontext
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build
from .codebook import (
    EFFECT_NO_EXECUTE,
    EFFECT_NO_SCHEDULE,
    EFFECT_PREFER_NO_SCHEDULE,
    OP_EXISTS,
)
from .device_state import DeviceNodeState
from .features import BatchFeatures, PlanFacts
from .whatif import whatif_score

MAX_NODE_SCORE = 100
BIG = 1 << 30      # the JAX package's _BIG: "no eligible domain" minimum (i32)
INF64 = 1 << 60    # _INF64: the empty side of a min/max score lane
LAP_MAX = 32  # max pods placed per lap; window LAP_MAX is the dump lane
SCAN_MAX_STEPS = 64  # batches up to this many steps take the scan path (:273)

i32, i64 = torch.int32, torch.int64


class ScanCarry(NamedTuple):
    """The kernels' dynamic state (the JAX package's ScanCarry, same lanes
    and dtypes). Returned by schedule_batch and accepted back as `carry_in`,
    so consecutive same-signature batches chain on the device."""

    req_r: torch.Tensor        # [NP, R] i64 requested per node
    nonzero: torch.Tensor      # [NP, 2] i64 non-zero-default cpu/mem
    pod_count: torch.Tensor    # [NP]    i32
    fit_ok: torch.Tensor       # [NP]    bool
    fit_sc: torch.Tensor       # [NP]    i64
    ba: torch.Tensor           # [NP]    i64
    dns_counts: torch.Tensor   # [C1, V] i32
    sa_counts: torch.Tensor    # [C2, V] i32
    anti_counts: torch.Tensor  # [A1, V] i32
    aff_counts: torch.Tensor   # [A2, V] i32
    ipa_delta: torch.Tensor    # [KD, V] i64
    start: torch.Tensor        # i32 rotation index
    blocked: torch.Tensor      # [NP] bool
    aux_cnt: torch.Tensor      # [NP] i32


def carry_from_jax_numpy(arrays: Sequence[np.ndarray], device="cpu") -> ScanCarry:
    """The JAX package's ScanCarry, fetched lane by lane with np.asarray,
    as the port's tensors."""
    return ScanCarry(*[torch.from_numpy(np.array(a)).to(device) for a in arrays])


class StaticMasks(NamedTuple):
    """_static_masks' six outputs plus the folded static_ok (:304)."""

    taint_ok: torch.Tensor       # [NP] bool
    pns_cnt: torch.Tensor        # [NP] i64
    sel_ok: torch.Tensor         # [NP] bool
    name_ok: torch.Tensor        # [NP] bool
    unsched_ok: torch.Tensor     # [NP] bool
    exist_anti_ok: torch.Tensor  # [NP] bool
    static_ok: torch.Tensor      # [NP] bool


# ---------------------------------------------------------------------------
# Launch plumbing
# ---------------------------------------------------------------------------


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise RuntimeError(f"kubernetes_tpu_torch kernels run on cuda or cpu, not {t.device}")
    return False


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _marshal(name: str, device: torch.device, args) -> list:
    """The C arguments of `launch_<name>` (its stream aside), each checked
    against the launcher's C signature: the count, an int where it takes an
    int, and a contiguous tensor on `device` of the pointee's dtype where it
    takes a pointer (None only where the pointer is OPTIONAL; a CPU tensor
    where it is HOST; a pinned CPU tensor also where it is MAPPED)."""
    sig = _build.signature(name)
    if len(args) != len(sig):
        raise TypeError(f"launch_{name} takes {len(sig)} arguments and a stream, "
                        f"got {len(args)}")
    out = []
    for p, a in zip(sig, args):
        if p.dtype is None:
            if not isinstance(a, int):
                raise TypeError(f"launch_{name}: {p.name} must be an int, got {type(a)}")
            out.append(a)
        elif a is None:
            if not p.optional:
                raise TypeError(f"launch_{name}: {p.name} may not be null")
            out.append(None)
        elif not isinstance(a, torch.Tensor) or a.dtype != p.dtype:
            raise TypeError(f"launch_{name}: {p.name} must be a {p.dtype} tensor, got "
                            f"{getattr(a, 'dtype', type(a))}")
        elif a.device != (torch.device("cpu") if p.host else device) and not (
                p.mapped and a.device.type == "cpu" and a.is_pinned()):
            where = "the CPU" if p.host else device
            raise ValueError(f"launch_{name}: {p.name} on {a.device}, expected {where}")
        elif not a.is_contiguous():
            raise ValueError(f"launch_{name}: {p.name} must be contiguous")
        else:
            out.append(a.data_ptr())
    return out


def _launch(name: str, device: torch.device, *args) -> None:
    cargs = _marshal(name, device, args)
    rc = _build.launcher(name)(*cargs, _stream(device))
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {rc}")


def _res_args(f: BatchFeatures, fit_strategy: int) -> tuple:
    """The ResFeat arguments every launcher but static_masks takes first:
    (R, FR, fit_strategy) and the batch's seven resource features."""
    return (f.request.shape[0], f.fit_slots.shape[0], fit_strategy), (
        f.request, f.nz_request, f.has_request, f.ba_skip, f.enable, f.fit_slots,
        f.fit_weights)


# ---------------------------------------------------------------------------
# static_masks
# ---------------------------------------------------------------------------


def _static_masks_plain(state: DeviceNodeState, f: BatchFeatures) -> StaticMasks:
    """Plain PyTorch version of the static_masks kernel."""
    tk, tv = f.tol_key[None, None, :], f.tol_val[None, None, :]
    te, to = f.tol_eff[None, None, :], f.tol_op[None, None, :]
    k, v = state.taint_key[:, :, None], state.taint_val[:, :, None]
    e = state.taint_eff[:, :, None]
    m = ((te == 0) | (te == e)) & ((tk == 0) | (tk == k)) & ((to == OP_EXISTS) | (tv == v))
    tolerated = m.any(dim=2)
    sched_relevant = (state.taint_eff == EFFECT_NO_SCHEDULE) | (state.taint_eff == EFFECT_NO_EXECUTE)
    taint_ok = ~(sched_relevant & ~tolerated).any(dim=1) | (f.enable[2] == 0)
    pns_tol_ok = (f.tol_eff == 0) | (f.tol_eff == EFFECT_PREFER_NO_SCHEDULE)
    pns_tolerated = (m & pns_tol_ok[None, None, :]).any(dim=2)
    pns_cnt = ((state.taint_eff == EFFECT_PREFER_NO_SCHEDULE) & ~pns_tolerated).sum(dim=1).to(i64)
    sel_ok = f.sel_match | (f.enable[3] == 0)
    name_ok = (f.node_name_id == 0) | (state.name_id == f.node_name_id) | (f.enable[0] == 0)
    unsched_ok = ~state.unsched | (f.tolerates_unsched == 1) | (f.enable[1] == 0)
    exist_anti_ok = f.exist_anti == 0
    static_ok = (state.valid & name_ok & unsched_ok & taint_ok & sel_ok
                 & exist_anti_ok & f.extra_ok)
    return StaticMasks(taint_ok, pns_cnt, sel_ok, name_ok, unsched_ok, exist_anti_ok, static_ok)


def _static_mask_views(buf: torch.Tensor, NP: int) -> StaticMasks:
    """The seven outputs of one static_masks launch as views of one byte
    buffer of 14 * NPa bytes (NPa: NP rounded up to 8): the six bool masks
    NPa bytes apart, then the int64 pns_cnt at byte 6 * NPa. Four view
    operations in all where NP is a multiple of 8, as the mirror's row
    tiers are."""
    NPa = buf.shape[0] // 14
    *b, pns = buf.view(torch.bool).split([NPa] * 6 + [8 * NPa])
    pns = pns.view(i64)
    if NPa != NP:
        b, pns = [t[:NP] for t in b], pns[:NP]
    return StaticMasks(b[0], pns, b[1], b[2], b[3], b[4], b[5])


def _static_masks_cuda(state: DeviceNodeState, f: BatchFeatures) -> StaticMasks:
    dev = state.valid.device
    NP, T = state.taint_key.shape
    L = f.tol_key.shape[0]
    # One allocation a launch.
    buf = torch.empty(14 * (-(-NP // 8) * 8), dtype=torch.uint8, device=dev)
    outs = _static_mask_views(buf, NP)
    _launch("static_masks", dev, NP, T, L, state.taint_key, state.taint_val,
            state.taint_eff, f.tol_key, f.tol_val, f.tol_eff, f.tol_op, f.sel_match,
            f.node_name_id, state.name_id, state.unsched, f.tolerates_unsched,
            f.exist_anti, f.enable, state.valid, f.extra_ok, *outs)
    return outs


def static_masks(state: DeviceNodeState, f: BatchFeatures) -> StaticMasks:
    """Per-batch node predicates that no assignment can change."""
    if _on_cpu(state.valid):
        return _static_masks_plain(state, f)
    out = _static_masks_cuda(state, f)
    static_masks.launches += 1
    return out


static_masks.launches = 0


# ---------------------------------------------------------------------------
# resource_eval
# ---------------------------------------------------------------------------


def _fit_ok_plain(f: BatchFeatures, alloc_r, alloc_pods, req_r, pod_count, nom_r=None,
                  nom_p=None):
    """The fit filter of resource_eval (fit.go:710) for any leading shape,
    the nominated lane counted when given."""
    eff_count = pod_count if nom_p is None else pod_count + nom_p
    pods_ok = (eff_count + 1).to(i64) <= alloc_pods
    avail = alloc_r - req_r if nom_r is None else alloc_r - req_r - nom_r
    viol = ((f.request > 0) & (f.request > avail)).any(dim=-1)
    return (pods_ok & (~viol | (f.has_request == 0))) | (f.enable[4] == 0)


def _resource_eval_plain(f: BatchFeatures, fit_strategy: int, alloc_r, alloc_pods,
                         req_r, nonzero, pod_count, nom_r=None, nom_p=None):
    """Plain PyTorch version of the resource_eval kernel, for any leading
    shape: the fit filter (fit.go:710, with the nominated lane counted
    against the filter only), the LeastAllocated/MostAllocated score and
    BalancedAllocation quantized at SCALE = 1e6."""
    fit_ok = _fit_ok_plain(f, alloc_r, alloc_pods, req_r, pod_count, nom_r, nom_p)
    used0 = nonzero[..., 0] + f.nz_request[0]
    used1 = nonzero[..., 1] + f.nz_request[1]
    fit_num = torch.zeros_like(used0)
    fit_den = torch.zeros_like(used0)
    for j in range(f.fit_slots.shape[0]):
        slot = f.fit_slots[j].to(i64)
        w = f.fit_weights[j]
        alloc = alloc_r[..., slot]
        used = torch.where(slot == 0, used0,
                           torch.where(slot == 1, used1, req_r[..., slot] + f.request[slot]))
        a1 = alloc.clamp_min(1)
        if fit_strategy == 0:  # LeastAllocated
            rscore = torch.where((alloc > 0) & (used <= alloc),
                                 (alloc - used) * MAX_NODE_SCORE // a1, 0)
        else:  # MostAllocated
            rscore = torch.where(alloc > 0, torch.minimum(used, alloc) * MAX_NODE_SCORE // a1, 0)
        fit_num = fit_num + torch.where(alloc > 0, rscore * w, 0)
        fit_den = fit_den + torch.where(alloc > 0, w, 0)
    fit_sc = torch.where(fit_den > 0, fit_num // fit_den.clamp_min(1), 0)
    scale = 1_000_000
    a_cpu, a_mem = alloc_r[..., 0], alloc_r[..., 1]
    q_cpu = (used0 * scale // a_cpu.clamp_min(1)).clamp_max(scale)
    q_mem = (used1 * scale // a_mem.clamp_min(1)).clamp_max(scale)
    both = (a_cpu > 0) & (a_mem > 0)
    ba_val = torch.where(both, (MAX_NODE_SCORE * scale - 50 * (q_cpu - q_mem).abs()) // scale,
                         MAX_NODE_SCORE)
    ba = torch.where(f.ba_skip == 1, 0, ba_val)
    return fit_ok, fit_sc, ba


def _nom_lane(f: BatchFeatures, row=None):
    """(nom_r, nom_p) of the nominated-pod lane, at `row` or for all rows,
    or (None, None) when the features carry no lane."""
    if not f.nom_req.shape[0]:
        return None, None
    if row is None:
        return f.nom_req, f.nom_pods
    return f.nom_req[row], f.nom_pods[row]


def _resource_eval_cuda(f, fit_strategy, alloc_r, alloc_pods, req_r, nonzero,
                        pod_count, nom_r=None, nom_p=None):
    dev = alloc_r.device
    NP = alloc_r.shape[0]
    fit_ok = torch.empty(NP, dtype=torch.bool, device=dev)
    fit_sc = torch.empty(NP, dtype=i64, device=dev)
    ba = torch.empty(NP, dtype=i64, device=dev)
    ints, feats = _res_args(f, fit_strategy)
    _launch("resource_eval", dev, NP, *ints, *feats, alloc_r, alloc_pods, req_r, nonzero,
            pod_count, nom_r, nom_p, fit_ok, fit_sc, ba)
    return fit_ok, fit_sc, ba


def resource_eval(f: BatchFeatures, fit_strategy: int, alloc_r, alloc_pods, req_r,
                  nonzero, pod_count, nom_r=None, nom_p=None):
    """(fit_ok, fit_sc, ba) for every node row."""
    if _on_cpu(alloc_r):
        return _resource_eval_plain(f, fit_strategy, alloc_r, alloc_pods, req_r,
                                    nonzero, pod_count, nom_r, nom_p)
    out = _resource_eval_cuda(f, fit_strategy, alloc_r, alloc_pods, req_r, nonzero,
                              pod_count, nom_r, nom_p)
    resource_eval.launches += 1
    return out


resource_eval.launches = 0


# ---------------------------------------------------------------------------
# lap_schedule
# ---------------------------------------------------------------------------


def _total(f: BatchFeatures, fit_sc, ba):
    """The carried total score of a plan with no kept-set normalization:
    TaintToleration at its maximum (no PreferNoSchedule terms), Fit,
    BalancedAllocation and the static ImageLocality term."""
    w = f.weights
    return w[0] * MAX_NODE_SCORE + w[1] * fit_sc + w[4] * ba + w[6] * f.il_score


def _vids(state: DeviceNodeState, axis: torch.Tensor) -> torch.Tensor:
    """[C, NP] i32 topology value ids of each table row's axis."""
    return state.topo[axis.to(i64)]


def _lap_schedule_plain(state: DeviceNodeState, f: BatchFeatures, batch_pad: int,
                        fit_strategy: int, ext0: ScanCarry, static_ok, n_act: int,
                        port_selfblock: bool = False, has_aux: bool = False,
                        stats: Optional[dict] = None) -> Tuple[torch.Tensor, ScanCarry]:
    """Plain PyTorch version of the lap_schedule kernel (the lap-vectorized
    greedy assignment, with the required anti-affinity lanes of a
    singleton-per-node axis, under `port_selfblock` the blocked lane and
    under `has_aux` the aux_cnt lane). `stats`, when given, receives the lap
    count and each lap's pods L."""
    dev = static_ok.device
    NP = static_ok.shape[0]
    A1 = f.anti_axis.shape[0]
    idx = torch.arange(NP, dtype=i32, device=dev)
    num = f.num_nodes.clamp_min(1)
    tf = f.to_find.clamp_min(1)
    lanes = torch.arange(LAP_MAX, dtype=i32, device=dev)
    anti_vid = _vids(state, f.anti_axis)
    req_r, nonzero, pod_count, start = ext0.req_r, ext0.nonzero, ext0.pod_count, ext0.start
    anti_counts = ext0.anti_counts.clone()
    blocked = ext0.blocked
    aux_cnt = ext0.aux_cnt
    out = torch.full((2, batch_pad + LAP_MAX), -1, dtype=i32, device=dev)
    done = laps = 0
    sizes = []
    nom_r, nom_p = _nom_lane(f)
    while done < n_act:
        laps += 1
        fit_ok, fit_sc, ba = _resource_eval_plain(
            f, fit_strategy, state.alloc_r, state.alloc_pods, req_r, nonzero, pod_count,
            nom_r, nom_p)
        okd = static_ok & fit_ok & (idx < num)
        if port_selfblock:
            okd &= ~blocked
        if has_aux:
            okd &= aux_cnt + f.aux_inc <= f.aux_room
        if A1:
            acnt = torch.gather(anti_counts, 1, anti_vid.to(i64))
            okd &= ~((anti_vid > 0) & (acnt > 0)).any(dim=0)
        F = torch.cumsum(okd.to(i32), 0, dtype=i32)
        total = _total(f, fit_sc, ba)
        total_feas = F[-1]
        f_start = torch.where(start > 0, F[(start - 1).clamp_min(0).to(i64)], 0)
        rank = torch.where(idx >= start, F - f_start, F + total_feas - f_start)
        rot = (idx - start) % num
        L = max(1, min(int(total_feas // tf), n_act - done, LAP_MAX))
        sizes.append(L)
        w = torch.clamp_max((rank - 1) // tf, LAP_MAX)
        seg = torch.where(okd & (w < L), w, LAP_MAX)
        in_w = seg[None, :] == lanes[:, None]
        key = total * NP + ((NP - 1) - rot)
        key_w = torch.where(in_w, key[None, :], -1).amax(dim=1)
        has_w = (lanes < L) & (key_w >= 0)
        rot_w = (NP - 1) - (key_w % NP).to(i32)
        row_w = torch.where(has_w, (start + rot_w) % num, -1).to(i32)
        is_b = okd & (rank % tf == 0)
        seg_b = torch.where(is_b, torch.clamp_max(rank // tf - 1, LAP_MAX), LAP_MAX)
        in_b = seg_b[None, :] == lanes[:, None]
        ev_w = torch.where(in_b, rot[None, :] + 1, num).amin(dim=1)
        start_w = (start + ev_w) % num
        cnt = ((idx[None, :] == row_w[:, None]) & has_w[:, None]).any(dim=0)
        c64 = cnt.to(i64)
        req_r = req_r + f.request[None, :] * c64[:, None]
        nonzero = nonzero + f.nz_request[None, :] * c64[:, None]
        pod_count = pod_count + cnt.to(i32)
        if port_selfblock:
            blocked = blocked | cnt  # a lap's windows share no row
        if has_aux:
            aux_cnt = aux_cnt + f.aux_inc * cnt.to(i32)
        if A1:
            # +anti_self at each landed row's own value (the axis is
            # singleton per node, so no two windows share a value).
            vid_w = anti_vid[:, row_w.clamp_min(0).to(i64)]               # [A1, LAP_MAX]
            upd = f.anti_self[:, None] * (vid_w > 0).to(i32) * has_w[None, :].to(i32)
            rows = torch.arange(A1, device=dev)[:, None].expand_as(vid_w)
            anti_counts.index_put_((rows, vid_w.to(i64)), upd, accumulate=True)
        out[:, done:done + LAP_MAX] = torch.stack([torch.where(has_w, row_w, -1),
                                                   start_w.to(i32)])
        start = start_w[L - 1].to(i32)
        done += L
    if stats is not None:
        stats["laps"] = laps
        stats["lap_sizes"] = sizes
    fit_ok, fit_sc, ba = _resource_eval_plain(
        f, fit_strategy, state.alloc_r, state.alloc_pods, req_r, nonzero, pod_count,
        nom_r, nom_p)
    carry = ext0._replace(req_r=req_r, nonzero=nonzero, pod_count=pod_count,
                          fit_ok=fit_ok, fit_sc=fit_sc, ba=ba, anti_counts=anti_counts,
                          start=start, blocked=blocked, aux_cnt=aux_cnt)
    return out[:, :batch_pad], carry


def _blocked_lane(ext0: ScanCarry, port_selfblock: bool) -> Optional[torch.Tensor]:
    """The kernel's copy of the carry's blocked lane, or None (a null
    pointer: the lane is off) without port_selfblock."""
    return ext0.blocked.clone() if port_selfblock else None


def _aux_lane(ext0: ScanCarry, has_aux: bool) -> Optional[torch.Tensor]:
    """The kernel's copy of the carry's aux_cnt lane, or None (a null
    pointer: the lane is off) without has_aux."""
    return ext0.aux_cnt.clone() if has_aux else None


def _lanes_out(ext0: ScanCarry, blocked, aux_cnt) -> dict:
    """The carry's blocked and aux_cnt lanes after a launch: the kernel's
    copies where the lanes were on, the input's lanes where they were off."""
    return dict(blocked=ext0.blocked if blocked is None else blocked,
                aux_cnt=ext0.aux_cnt if aux_cnt is None else aux_cnt)


# The lap kernel keeps a batch's row state in shared memory up to this many
# rows and this many bytes (csrc/lap_schedule.cu LAP_SMEM_ROWS,
# LAP_SMEM_MAX, lap_layout for a block of LAP_WARPS warps); above either it
# takes a device-memory buffer of the same layout.
LAP_SMEM_ROWS = 16384
LAP_SMEM_MAX = 220 * 1024
LAP_WARPS = 32


def _lap_layout_bytes(NP: int, R: int, FR: int) -> int:
    """Bytes of the lap kernel's row state (lap_layout in csrc/lap_schedule.cu):
    totals, chunk maxima, a landing stage a warp, the batch's constants and
    six int32 arrays a 32-row chunk, each rounded up to 16 bytes."""
    nc = (NP + 31) // 32
    parts = [8 * NP, 8 * nc, 8 * LAP_WARPS * (3 * R + 2), 8 * (R + 4 + FR),
             4 * (5 + FR)] + [4 * nc] * 6
    return sum((b + 15) // 16 * 16 for b in parts)


def _lap_work(NP: int, R: int, FR: int, dev) -> Optional[torch.Tensor]:
    """None when the lap kernel's row state fits shared memory (a null
    pointer), else the device-memory buffer that holds it."""
    nbytes = _lap_layout_bytes(NP, R, FR)
    if NP <= LAP_SMEM_ROWS and nbytes <= LAP_SMEM_MAX:
        return None
    return torch.empty(nbytes // 8, dtype=i64, device=dev)


def _lap_schedule_cuda(state, f, batch_pad, fit_strategy, ext0, static_ok, n_act,
                       port_selfblock=False, has_aux=False):
    dev = static_ok.device
    NP, R = state.alloc_r.shape
    req_r, nonzero, pod_count = (t.clone() for t in ext0[:3])
    anti_counts = ext0.anti_counts.clone()
    blocked = _blocked_lane(ext0, port_selfblock)
    aux_cnt = _aux_lane(ext0, has_aux)
    fit_ok = torch.empty(NP, dtype=torch.bool, device=dev)
    fit_sc = torch.empty(NP, dtype=i64, device=dev)
    ba = torch.empty(NP, dtype=i64, device=dev)
    start = torch.empty((), dtype=i32, device=dev)
    out = torch.full((2, batch_pad), -1, dtype=i32, device=dev)
    ints, feats = _res_args(f, fit_strategy)
    _launch("lap_schedule", dev, NP, *ints, batch_pad, n_act, anti_counts.shape[0],
            anti_counts.shape[1], *feats, state.alloc_r,
            state.alloc_pods, req_r, nonzero, pod_count, *_nom_lane(f), blocked, aux_cnt,
            f.aux_room, f.aux_inc, static_ok,
            f.il_score, f.weights, f.num_nodes, f.to_find, ext0.start, state.topo, f.anti_axis,
            f.anti_self, anti_counts, _lap_work(NP, R, ints[1], dev), out, fit_ok, fit_sc, ba,
            start)
    carry = ext0._replace(req_r=req_r, nonzero=nonzero, pod_count=pod_count,
                          fit_ok=fit_ok, fit_sc=fit_sc, ba=ba, anti_counts=anti_counts,
                          start=start, **_lanes_out(ext0, blocked, aux_cnt))
    return out, carry


def lap_schedule(state: DeviceNodeState, f: BatchFeatures, batch_pad: int,
                 fit_strategy: int, ext0: ScanCarry, static_ok: torch.Tensor,
                 n_act: int, port_selfblock: bool = False,
                 has_aux: bool = False) -> Tuple[torch.Tensor, ScanCarry]:
    """Lap-vectorized greedy assignment of up to `batch_pad` pods (`n_act`
    real): returns the [2, batch_pad] (row or -1, start after) results and
    the final carry. With `port_selfblock` the carry's blocked lane is read
    and each landing blocks its row; with `has_aux` a row takes a pod only
    while its aux_cnt leaves room for the pod's aux_inc, and each landing
    adds it (copies: `ext0` keeps its lanes)."""
    if _on_cpu(static_ok):
        return _lap_schedule_plain(state, f, batch_pad, fit_strategy, ext0, static_ok, n_act,
                                   port_selfblock, has_aux)
    out = _lap_schedule_cuda(state, f, batch_pad, fit_strategy, ext0, static_ok, n_act,
                             port_selfblock, has_aux)
    lap_schedule.launches += 1
    return out


lap_schedule.launches = 0


# ---------------------------------------------------------------------------
# scan_general
# ---------------------------------------------------------------------------


def plan_modes(f: BatchFeatures, facts: PlanFacts) -> Tuple[bool, bool]:
    """(incremental_feas, scores_carried) of the JAX package's
    schedule_batch (:262-266): feasibility can change only at the landed
    row when no cross-window topology filter is live, and the total score
    rides the carry when no kept-set normalization term is live."""
    C1, C2 = f.dns_axis.shape[0], f.sa_axis.shape[0]
    A1, A2, KD = f.anti_axis.shape[0], f.aff_axis.shape[0], f.ipa_axis.shape[0]
    incremental = C1 == 0 and A2 == 0 and (A1 == 0 or facts.anti_rowlocal)
    carried = (C2 == 0 and KD == 0 and not facts.has_pns and not facts.has_ipa_base
               and not facts.has_na_pref)
    return incremental, carried


def _scan_general_plain(state: DeviceNodeState, f: BatchFeatures, batch_pad: int,
                        fit_strategy: int, ext0: ScanCarry, masks: StaticMasks, n_act: int,
                        facts: PlanFacts) -> Tuple[torch.Tensor, ScanCarry]:
    """Plain PyTorch version of the scan_general kernel: the JAX package's
    scan step and feasibility_proj (:314-523) with its prologue (:545-575),
    one pod per step, the count tables' per-node projections kept fresh
    elementwise."""
    dev = masks.static_ok.device
    NP = masks.static_ok.shape[0]
    C1, C2 = f.dns_axis.shape[0], f.sa_axis.shape[0]
    A1, A2, KD = f.anti_axis.shape[0], f.aff_axis.shape[0], f.ipa_axis.shape[0]
    incremental, carried = plan_modes(f, facts)
    idx = torch.arange(NP, dtype=i32, device=dev)
    num = f.num_nodes.clamp_min(1)
    static_ok, sel_ok, taint_ok = masks.static_ok, masks.sel_ok, masks.taint_ok
    dns_vid, sa_vid = _vids(state, f.dns_axis), _vids(state, f.sa_axis)
    anti_vid, aff_vid = _vids(state, f.anti_axis), _vids(state, f.aff_axis)
    ipa_vid = _vids(state, f.ipa_axis)
    dns_elig = ((dns_vid > 0) & torch.where(f.dns_honor_aff[:, None] == 1, sel_ok[None, :], True)
                & torch.where(f.dns_honor_taints[:, None] == 1, taint_ok[None, :], True))
    sa_ignored = (~(sa_vid > 0).all(dim=0) | ~sel_ok) if C2 else torch.zeros(
        NP, dtype=torch.bool, device=dev)
    aff_has_keys = ((f.aff_active[:, None] == 0) | (aff_vid > 0)).all(dim=0)
    w = f.weights
    il_term = w[6] * f.il_score
    big = torch.tensor(BIG, dtype=i32, device=dev)

    req_r, nonzero, pod_count, fit_ok, fit_sc, ba = (t.clone() for t in ext0[:6])
    dns_counts, sa_counts, anti_counts, aff_counts, ipa_delta = (
        t.clone() for t in ext0[6:11])
    blocked = ext0.blocked.clone() if facts.port_selfblock else ext0.blocked
    aux_cnt = ext0.aux_cnt.clone() if facts.has_aux else ext0.aux_cnt
    start = ext0.start
    # prologue: per-node projections of the count tables, okd/F seeds
    mnum = torch.gather(dns_counts, 1, dns_vid.to(i64))
    scnt = torch.gather(sa_counts, 1, sa_vid.to(i64))
    acnt = torch.gather(anti_counts, 1, anti_vid.to(i64))
    fcnt = torch.gather(aff_counts, 1, aff_vid.to(i64))
    dproj = torch.gather(ipa_delta, 1, ipa_vid.to(i64)) * (ipa_vid > 0)
    aff_total = (aff_counts.to(i64) * (f.aff_active[:, None] == 1)).sum()

    def feasibility():
        ok = static_ok & fit_ok & (idx < num)
        if facts.port_selfblock:
            ok &= ~blocked
        if facts.has_aux:
            ok &= aux_cnt + f.aux_inc <= f.aux_room
        if C1:
            min_match = torch.where(f.dns_dom, dns_counts, big).amin(dim=1)
            min_match = torch.where(f.dns_forced0 == 1, 0, min_match)
            skew_bad = ((mnum + f.dns_self[:, None] - min_match[:, None]).to(i64)
                        > f.dns_max_skew.clamp_max(BIG)[:, None])
            reject = (f.dns_active[:, None] == 1) & (~(dns_vid > 0) | skew_bad)
            ok &= ~reject.any(dim=0)
        if A1:
            ok &= ~((anti_vid > 0) & (acnt > 0)).any(dim=0)
        if A2:
            term_ok = (f.aff_active[:, None] == 0) | ((aff_vid > 0) & (fcnt > 0))
            bootstrap = (aff_total == 0) & (f.aff_own_all == 1) & aff_has_keys
            ok &= term_ok.all(dim=0) | bootstrap
        return ok

    okd = feasibility()
    F = torch.cumsum(okd.to(i32), 0, dtype=i32)
    total = _total(f, fit_sc, ba) if carried else None
    out = torch.full((2, batch_pad), -1, dtype=i32, device=dev)
    neg_inf = torch.tensor(-INF64, dtype=i64, device=dev)
    for t in range(n_act):
        if not incremental:
            okd = feasibility()
            F = torch.cumsum(okd.to(i32), 0, dtype=i32)
        total_feas = F[-1]
        f_start = torch.where(start > 0, F[(start - 1).clamp_min(0).to(i64)], 0)
        rank = torch.where(idx >= start, F - f_start, F + total_feas - f_start)
        kept = okd & (rank <= f.to_find)
        rot = (idx - start) % num
        bound = torch.where(okd & (rank == f.to_find), (num - 1 - rot).to(i64), 0).amax()
        evaluated = (num - bound).to(i32)
        if not carried:
            tt = torch.tensor(MAX_NODE_SCORE, dtype=i64, device=dev)
            if facts.has_pns:
                mx = torch.where(kept, masks.pns_cnt, 0).amax()
                tt = torch.where(mx > 0, MAX_NODE_SCORE - MAX_NODE_SCORE * masks.pns_cnt
                                 // mx.clamp_min(1), MAX_NODE_SCORE)
            pts = ipa = na = 0
            if C2:
                raw_sa = (scnt.to(i64) * f.sa_wq[:, None] + (f.sa_skew[:, None] - 1) * 1024).sum(0)
                live = kept & ~sa_ignored
                mx = torch.where(live, raw_sa, 0).amax()
                mn = -torch.where(live, -raw_sa, neg_inf).amax()
                norm = torch.where(mx > 0, MAX_NODE_SCORE * (mx + torch.minimum(mn, mx) - raw_sa)
                                   // mx.clamp_min(1), MAX_NODE_SCORE)
                pts = torch.where(sa_ignored, 0, norm)
            if KD or facts.has_ipa_base:
                raw_ipa = f.ipa_base + dproj.sum(dim=0) if KD else f.ipa_base
                mx = torch.where(kept, raw_ipa, neg_inf).amax()
                mn = -torch.where(kept, -raw_ipa, neg_inf).amax()
                diff = mx - mn
                ipa = torch.where(diff > 0, MAX_NODE_SCORE * (raw_ipa - mn)
                                  // diff.clamp_min(1), 0)
            if facts.has_na_pref:
                mx = torch.where(kept, f.na_raw, 0).amax()
                na = torch.where(mx > 0, MAX_NODE_SCORE * f.na_raw // mx.clamp_min(1), 0)
            total = (w[0] * tt + w[1] * fit_sc + w[4] * ba + w[2] * pts + w[3] * ipa
                     + w[5] * na + il_term)
        key = total * NP + ((NP - 1) - rot)
        best_key = torch.where(kept, key, -1).amax()
        any_kept = bool(best_key >= 0)
        chosen_rot = (NP - 1) - (best_key % NP).to(i32)
        chosen = ((start + chosen_rot) % num).to(i32) if any_kept else torch.tensor(
            -1, dtype=i32, device=dev)
        if any_kept:
            row = int(chosen)
            req_r[row] += f.request
            nonzero[row] += f.nz_request
            pod_count[row] += 1
            r_ok, r_fit, r_ba = _resource_eval_plain(
                f, fit_strategy, state.alloc_r[row], state.alloc_pods[row],
                req_r[row], nonzero[row], pod_count[row], *_nom_lane(f, row))
            fit_ok[row], fit_sc[row], ba[row] = r_ok, r_fit, r_ba
            if C1:
                upd = f.dns_self * dns_elig[:, row].to(i32)
                dns_counts[torch.arange(C1, device=dev), dns_vid[:, row].to(i64)] += upd
                mnum += upd[:, None] * (dns_vid == dns_vid[:, row][:, None])
            if C2:
                upd = f.sa_self * int(not bool(sa_ignored[row]))
                sa_counts[torch.arange(C2, device=dev), sa_vid[:, row].to(i64)] += upd
                scnt += upd[:, None] * (sa_vid == sa_vid[:, row][:, None])
            if A1:
                upd = f.anti_self * (anti_vid[:, row] > 0).to(i32)
                anti_counts[torch.arange(A1, device=dev), anti_vid[:, row].to(i64)] += upd
                acnt += upd[:, None] * (anti_vid == anti_vid[:, row][:, None])
            if A2:
                upd = f.aff_self * (aff_vid[:, row] > 0).to(i32)
                aff_counts[torch.arange(A2, device=dev), aff_vid[:, row].to(i64)] += upd
                fcnt += upd[:, None] * (aff_vid == aff_vid[:, row][:, None])
                aff_total = aff_total + upd.sum()
            if KD:
                upd = f.ipa_wland * (ipa_vid[:, row] > 0)
                ipa_delta[torch.arange(KD, device=dev), ipa_vid[:, row].to(i64)] += upd
                dproj += upd[:, None] * (ipa_vid == ipa_vid[:, row][:, None])
            if facts.port_selfblock:
                blocked[row] = True
            if facts.has_aux:
                aux_cnt[row] += f.aux_inc
            if incremental:
                new_ok = bool(static_ok[row] & r_ok) and row < int(num)
                new_ok &= not (facts.port_selfblock and bool(blocked[row]))
                new_ok &= not (facts.has_aux and bool(aux_cnt[row] + f.aux_inc > f.aux_room[row]))
                if A1:
                    new_ok &= not bool(((anti_vid[:, row] > 0) & (acnt[:, row] > 0)).any())
                delta = int(new_ok) - int(okd[row])
                okd[row] = new_ok
                F[row:] += delta
            if carried:
                total[row] = (w[0] * MAX_NODE_SCORE + w[1] * r_fit + w[4] * r_ba
                              + il_term[row])
        start = ((start + evaluated) % num).to(i32)
        out[0, t] = chosen
        out[1, t] = start
    out[1, n_act:] = start  # padded steps: nothing lands, the start stays
    carry = ext0._replace(req_r=req_r, nonzero=nonzero, pod_count=pod_count, fit_ok=fit_ok,
                          fit_sc=fit_sc, ba=ba, dns_counts=dns_counts, sa_counts=sa_counts,
                          anti_counts=anti_counts, aff_counts=aff_counts,
                          ipa_delta=ipa_delta, start=start, blocked=blocked, aux_cnt=aux_cnt)
    return out, carry


def _scan_general_cuda(state, f, batch_pad, fit_strategy, ext0, masks, n_act, facts):
    dev = masks.static_ok.device
    NP = masks.static_ok.shape[0]
    incremental, carried = plan_modes(f, facts)
    req_r, nonzero, pod_count, fit_ok, fit_sc, ba = (t.clone() for t in ext0[:6])
    dns_counts, sa_counts, anti_counts, aff_counts, ipa_delta = (
        t.clone() for t in ext0[6:11])
    blocked = _blocked_lane(ext0, facts.port_selfblock)
    aux_cnt = _aux_lane(ext0, facts.has_aux)
    start = torch.empty((), dtype=i32, device=dev)
    okd_s = torch.empty(NP, dtype=torch.uint8, device=dev)
    F_s = torch.empty(NP, dtype=i32, device=dev)
    total_s = torch.empty(NP, dtype=i64, device=dev)
    out = torch.empty((2, batch_pad), dtype=i32, device=dev)
    ints, feats = _res_args(f, fit_strategy)
    _launch("scan_general", dev, NP, *ints, batch_pad, n_act, dns_counts.shape[1],
            dns_counts.shape[0], sa_counts.shape[0],
            anti_counts.shape[0], aff_counts.shape[0], ipa_delta.shape[0], int(incremental),
            int(carried), int(facts.has_pns), int(facts.has_ipa_base),
            int(facts.has_na_pref), *feats, state.alloc_r, state.alloc_pods, req_r, nonzero,
            pod_count, *_nom_lane(f), blocked, aux_cnt, f.aux_room, f.aux_inc, fit_ok, fit_sc, ba,
            masks.static_ok, masks.sel_ok,
            masks.taint_ok, masks.pns_cnt, state.topo, f.il_score, f.na_raw, f.ipa_base, f.weights,
            f.num_nodes, f.to_find, ext0.start, f.dns_axis, f.dns_active, f.dns_max_skew,
            f.dns_self, f.dns_forced0, f.dns_honor_aff, f.dns_honor_taints, f.dns_dom,
            dns_counts, f.sa_axis, f.sa_wq, f.sa_skew, f.sa_self, sa_counts, f.anti_axis,
            f.anti_self, anti_counts, f.aff_axis, f.aff_self, f.aff_active, f.aff_own_all,
            aff_counts, f.ipa_axis, f.ipa_wland, ipa_delta, okd_s, F_s, total_s, out, start)
    carry = ext0._replace(req_r=req_r, nonzero=nonzero, pod_count=pod_count, fit_ok=fit_ok,
                          fit_sc=fit_sc, ba=ba, dns_counts=dns_counts, sa_counts=sa_counts,
                          anti_counts=anti_counts, aff_counts=aff_counts,
                          ipa_delta=ipa_delta, start=start, **_lanes_out(ext0, blocked, aux_cnt))
    return out, carry


def scan_general(state: DeviceNodeState, f: BatchFeatures, batch_pad: int, fit_strategy: int,
                 ext0: ScanCarry, masks: StaticMasks, n_act: int,
                 facts: PlanFacts) -> Tuple[torch.Tensor, ScanCarry]:
    """One-pod-per-step greedy assignment for every plan the lap does not
    take: returns the [2, batch_pad] results and the
    final carry, every count table included."""
    if _on_cpu(masks.static_ok):
        return _scan_general_plain(state, f, batch_pad, fit_strategy, ext0, masks, n_act, facts)
    out = _scan_general_cuda(state, f, batch_pad, fit_strategy, ext0, masks, n_act, facts)
    scan_general.launches += 1
    return out


scan_general.launches = 0

# ---------------------------------------------------------------------------
# dry_run_preemption
# ---------------------------------------------------------------------------


def _dry_run_preemption_plain(state: DeviceNodeState, f: BatchFeatures, vic_req: torch.Tensor,
                              vic_valid: torch.Tensor, k: int) -> torch.Tensor:
    """Plain PyTorch version of the dry_run_preemption kernel."""
    NP = state.valid.shape[0]
    idx = torch.arange(NP, dtype=i32, device=state.valid.device)
    static_ok = _static_masks_plain(state, f).static_ok & (idx < f.num_nodes.clamp_min(1))
    n_pot = vic_valid.sum(dim=1).to(i32)
    base_req = state.req_r - (vic_req * vic_valid[:, :, None]).sum(dim=1)
    cnt0 = state.pod_count - n_pot

    def fit(req_r, pod_cnt):
        # No nominated lane: the host dry run ignores nominations too.
        return _fit_ok_plain(f, state.alloc_r, state.alloc_pods, req_r, pod_cnt)

    feasible0 = static_ok & fit(base_req, cnt0) & (n_pot > 0)
    kept_req = torch.zeros_like(base_req)
    kept_cnt = torch.zeros(NP, dtype=i32, device=idx.device)
    victims = []
    for i in range(k):
        vr, valid = vic_req[:, i], vic_valid[:, i]
        keep = valid & feasible0 & fit(base_req + kept_req + vr, cnt0 + kept_cnt + 1)
        kept_req = kept_req + vr * keep[:, None]
        kept_cnt = kept_cnt + keep.to(i32)
        victims.append(valid & feasible0 & ~keep)
    mask = torch.stack(victims, dim=1)
    return torch.cat([(feasible0 & mask.any(dim=1))[:, None], mask], dim=1)


def _dry_run_preemption_cuda(state, f, vic_req, vic_valid, k):
    dev = state.valid.device
    NP, R = state.alloc_r.shape
    if vic_req.shape != (NP, k, R) or vic_valid.shape != (NP, k):
        raise ValueError(f"dry_run_preemption: victims {tuple(vic_req.shape)} and "
                         f"{tuple(vic_valid.shape)} for {NP} rows, K {k}, R {R}")
    out = torch.empty((NP, 1 + k), dtype=torch.bool, device=dev)
    ints, feats = _res_args(f, 0)
    _launch("dry_run_preemption", dev, NP, *ints[:2], state.taint_key.shape[1],
            f.tol_key.shape[0], k, *feats, state.taint_key, state.taint_val, state.taint_eff,
            f.tol_key, f.tol_val, f.tol_eff, f.tol_op, f.sel_match, f.node_name_id,
            state.name_id, state.unsched, f.tolerates_unsched, f.exist_anti, state.valid,
            f.extra_ok, f.num_nodes, state.alloc_r, state.alloc_pods, state.req_r,
            state.pod_count, vic_req, vic_valid, out)
    return out


def dry_run_preemption(state: DeviceNodeState, f: BatchFeatures, vic_req: torch.Tensor,
                       vic_valid: torch.Tensor, k: int) -> torch.Tensor:
    """Batched DryRunPreemption (preemption.go:425 SelectVictimsOnNode on
    every row): per row, remove every lower-priority pod (the K columns of
    `vic_req` [NP, K, R], in MoreImportantPod order, `vic_valid` [NP, K]),
    test that the pod fits, then reprieve the victims most important first.
    Returns [NP, 1 + K] bool: column 0 the row is a candidate (feasible with
    a non-empty victim set), columns 1..K its victims. The pod's other
    filters are static per row here: the caller keeps topology-coupled
    preemptors and clusters with anti-affinity pods on the host."""
    if _on_cpu(state.valid):
        return _dry_run_preemption_plain(state, f, vic_req, vic_valid, k)
    out = _dry_run_preemption_cuda(state, f, vic_req, vic_valid, k)
    dry_run_preemption.launches += 1
    return out


dry_run_preemption.launches = 0

# ---------------------------------------------------------------------------
# scatter_rows
# ---------------------------------------------------------------------------


# Bytes an element of each dtype the staged buffers hold, and numpy's dtype.
_ITEMSIZE = {i64: 8, i32: 4, torch.bool: 1}
_NP_DTYPE = {i64: np.int64, i32: np.int32, torch.bool: np.bool_}


@functools.lru_cache(maxsize=256)
def _layout(spec) -> Tuple[Tuple[int, ...], int]:
    """(byte offsets, total bytes) of the arrays of `spec` ((dtype, shape),
    ...) laid one after another in one byte buffer, each on a 16-byte
    boundary."""
    offs, off = [], 0
    for dt, shape in spec:
        offs.append(off)
        off = _align16(off + _ITEMSIZE[dt] * math.prod(shape))
    return tuple(offs), off


def _views(buf, spec, offs) -> list:
    """The arrays of `spec` as views of the byte buffer `buf` (a numpy
    uint8 array or a torch uint8 tensor) at the byte offsets `offs`."""
    out = []
    for (dt, shape), off in zip(spec, offs):
        part = buf[off:off + _ITEMSIZE[dt] * math.prod(shape)]
        if isinstance(buf, np.ndarray):
            out.append(part.view(_NP_DTYPE[dt]).reshape(shape))
        else:
            out.append(part.view(dt).view(shape))
    return out


def _row_spec(D: int, R: int, T: int, K: int) -> tuple:
    """The packed rows of a scatter: D rows of each DeviceNodeState field in
    field order, topo's as [K, D]. The kernel gets each section's byte
    offset from the wrapper, so this is the layout's one statement."""
    return ((i64, (D, R)), (i64, (D,)), (i64, (D, R)), (i64, (D, 2)), (i32, (D,)),
            (i32, (D, T)), (i32, (D, T)), (i32, (D, T)), (torch.bool, (D,)), (torch.bool, (D,)),
            (i32, (D,)), (i32, (K, D)))


def _widths(state: DeviceNodeState) -> Tuple[int, int, int]:
    return state.alloc_r.shape[1], state.taint_key.shape[1], state.topo.shape[0]


def unpack_rows(packed: torch.Tensor, D: int, R: int, T: int, K: int) -> DeviceNodeState:
    """The D rows of each field (topo's as [K, D]) as views of `packed`."""
    spec = _row_spec(D, R, T, K)
    return DeviceNodeState(*_views(packed, spec, _layout(spec)[0]))


def stage_scatter(ring, fields: Sequence[np.ndarray], topo: np.ndarray, rows,
                  at=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One flush's upload: the host rows `rows` of the mirror's staging
    arrays (`fields`, its eleven [NP, ...] arrays, and `topo` [K, NP]) and
    their target indices `at` (default: `rows`) packed straight into one
    buffer of the StagingRing `ring` and copied to its device at once.
    Returns (idx [D] i32, packed), views of that one upload, as
    scatter_rows takes them."""
    rows = np.asarray(rows, dtype=np.int64)
    D = rows.shape[0]
    spec = ((i32, (D,)),) + _row_spec(D, fields[0].shape[1], fields[5].shape[1], topo.shape[0])
    offs, total = _layout(spec)
    views = _views(ring.take(total), spec, offs)
    views[0][:] = rows if at is None else at
    # mode="clip" writes straight into `out` (the default buffers it); the
    # rows are the mirror's own, all in range.
    for a, view in zip(fields, views[1:-1]):
        a.take(rows, axis=0, out=view, mode="clip")
    topo.take(rows, axis=1, out=views[-1], mode="clip")
    staged = ring.upload(total)
    return staged[:4 * D].view(i32), staged[offs[1]:]


def _scatter_rows_plain(state: DeviceNodeState, idx: torch.Tensor, packed: torch.Tensor,
                        in_place: bool = False) -> DeviceNodeState:
    """Plain PyTorch version of the scatter_rows kernel: a clone of each
    field (none in place) and one index_copy_ per field."""
    rows = unpack_rows(packed, idx.shape[0], *_widths(state))
    out = state if in_place else DeviceNodeState(*[t.clone() for t in state])
    at = idx.to(i64)
    for field, r in zip(out[:-1], rows[:-1]):
        field.index_copy_(0, at, r)
    out.topo.index_copy_(1, at, rows.topo)
    return out


def _scatter_rows_cuda(state, idx, packed, in_place=False) -> DeviceNodeState:
    dev = state.valid.device
    NP, D, (R, T, K) = state.valid.shape[0], idx.shape[0], _widths(state)
    offs, total = _layout(_row_spec(D, R, T, K))
    if packed.shape != (total,):
        raise ValueError("scatter_rows: packed rows do not match the state's widths")
    out = state if in_place else DeviceNodeState(*[torch.empty_like(t) for t in state])
    # Each field's section as its byte offset: ints marshal for a fraction
    # of what twelve tensor views cost on the host.
    _launch("scatter_rows", dev, NP, D, R, T, K, idx, packed, *offs, *state, *out)
    return out


def scatter_rows(state: DeviceNodeState, idx: torch.Tensor, packed: torch.Tensor,
                 in_place: bool = False) -> DeviceNodeState:
    """`state` with the packed rows (stage_scatter) written at the
    rows `idx` [D] i32, in any order: a new state, the given one keeping
    its values (a dispatched batch or a saved plan may read it); `in_place`
    writes the rows into `state`'s own tensors and returns it (a mesh
    shard that no dispatched batch reads)."""
    if _on_cpu(state.valid):
        return _scatter_rows_plain(state, idx, packed, in_place)
    out = _scatter_rows_cuda(state, idx, packed, in_place)
    scatter_rows.launches += 1
    return out


scatter_rows.launches = 0

# ---------------------------------------------------------------------------
# patch_carry_rows
# ---------------------------------------------------------------------------


def _patch_carry_rows_plain(state: DeviceNodeState, f: BatchFeatures, carry: ScanCarry,
                            idx: torch.Tensor, req_rows: torch.Tensor, nz_rows: torch.Tensor,
                            cnt_rows: torch.Tensor, fit_strategy: int,
                            in_place: bool = False) -> ScanCarry:
    """Plain PyTorch version of the patch_carry_rows kernel."""
    at = idx.to(i64)
    ok, sc, ba = _resource_eval_plain(f, fit_strategy, state.alloc_r[at], state.alloc_pods[at],
                                      req_rows, nz_rows, cnt_rows, *_nom_lane(f, at))
    lanes = list(carry[:6]) if in_place else [t.clone() for t in carry[:6]]
    for lane, rows in zip(lanes, (req_rows, nz_rows, cnt_rows, ok, sc, ba)):
        lane[at] = rows
    return carry._replace(req_r=lanes[0], nonzero=lanes[1], pod_count=lanes[2],
                          fit_ok=lanes[3], fit_sc=lanes[4], ba=lanes[5])


def _patch_carry_rows_cuda(state, f, carry, idx, req_rows, nz_rows, cnt_rows, fit_strategy,
                           in_place=False):
    dev = idx.device
    NP, R = state.alloc_r.shape
    K = idx.shape[0]
    if req_rows.shape != (K, R) or nz_rows.shape != (K, 2) or cnt_rows.shape != (K,):
        raise ValueError(f"patch_carry_rows: rows {tuple(req_rows.shape)}, "
                         f"{tuple(nz_rows.shape)}, {tuple(cnt_rows.shape)} for K {K}, R {R}")
    lanes = list(carry[:6]) if in_place else [torch.empty_like(t) for t in carry[:6]]
    ints, feats = _res_args(f, fit_strategy)
    _launch("patch_carry_rows", dev, NP, K, *ints, *feats, idx, req_rows, nz_rows, cnt_rows,
            state.alloc_r, state.alloc_pods, *_nom_lane(f), *carry[:6], *lanes)
    return carry._replace(req_r=lanes[0], nonzero=lanes[1], pod_count=lanes[2],
                          fit_ok=lanes[3], fit_sc=lanes[4], ba=lanes[5])


def stage_carry_patch(ring, rows, req_r: np.ndarray, nonzero: np.ndarray,
                      pod_count: np.ndarray) -> list:
    """One carry patch's upload: the rows `rows` (padded to their tier) and
    their aggregates from host staging (`req_r` [NP, R], `nonzero` [NP, 2],
    `pod_count` [NP]) packed straight into one buffer of the StagingRing
    `ring` and copied to its device at once. Returns [idx, req_rows,
    nz_rows, cnt_rows], views of that one upload, as patch_carry_rows takes
    them."""
    rows = np.asarray(rows, dtype=np.int64)
    K = rows.shape[0]
    spec = ((i32, (K,)), (i64, (K, req_r.shape[1])), (i64, (K, 2)), (i32, (K,)))
    offs, total = _layout(spec)
    views = _views(ring.take(total), spec, offs)
    views[0][:] = rows
    for a, view in zip((req_r, nonzero, pod_count), views[1:]):
        a.take(rows, axis=0, out=view, mode="clip")
    return _views(ring.upload(total), spec, offs)


def patch_carry_rows(state: DeviceNodeState, f: BatchFeatures, carry: ScanCarry,
                     idx: torch.Tensor, req_rows: torch.Tensor, nz_rows: torch.Tensor,
                     cnt_rows: torch.Tensor, fit_strategy: int = 0,
                     in_place: bool = False) -> ScanCarry:
    """Event-delta patch of a live session's carry: install the post-event
    aggregates of the rows `idx` [K] i32 (`req_rows` [K, R] i64, `nz_rows`
    [K, 2] i64, `cnt_rows` [K] i32) and re-evaluate those rows' fit_ok,
    fit_sc and ba against `state` (already patched), with the nominated-pod
    lane where the features carry one. Valid only for pod-local plans (no
    count table to touch). Duplicate indices must carry identical rows (the
    padding of patch_tier). Returns a new carry: the six patched lanes are
    copies, so the carry given — which may be the mirror's adopted state
    or a queued kernel's input — keeps its values; the other lanes are
    shared. `in_place` writes the carry's own six lanes instead (the
    sharded carry's pinned patch, patch_carry_rows_pinned). The kernel
    writes the new lanes whole (the old rows copied, the patched ones
    written) in one launch; the inputs may be views of one upload
    (stage_carry_patch)."""
    if _on_cpu(idx):
        return _patch_carry_rows_plain(state, f, carry, idx, req_rows, nz_rows, cnt_rows,
                                       fit_strategy, in_place)
    out = _patch_carry_rows_cuda(state, f, carry, idx, req_rows, nz_rows, cnt_rows, fit_strategy,
                                 in_place)
    patch_carry_rows.launches += 1
    return out


patch_carry_rows.launches = 0


def patch_carry_rows_pinned(state, f, carry, idx: torch.Tensor, req_rows: torch.Tensor,
                            nz_rows: torch.Tensor, cnt_rows: torch.Tensor,
                            fit_strategy: int = 0):
    """patch_carry_rows for a carry that lives on a mesh (the JAX package's
    patch_carry_rows_pinned, :624-652), patched where it lies. A sharded
    carry (parallel/mesh.py Sharded) is patched in place, shard by shard:
    each dirty row goes to its shard by `row // NPl`, and the shard's
    patch_carry_rows launch takes the shard's local indices, its state and
    its features (`state` and `f` Sharded too) — the counterpart of the JAX
    out_shardings pin and of its donated carry. A carry that is whole on
    one device (the mesh's gathered path) takes patch_carry_rows unchanged,
    on the whole state and features. Returns the patched carry."""
    from ..parallel.mesh import Sharded, gather

    if not isinstance(carry, Sharded):
        return patch_carry_rows(gather(state), gather(f), carry, idx, req_rows, nz_rows,
                                cnt_rows, fit_strategy)
    npl = carry.parts[0].pod_count.shape[0]
    shard_of = idx.to(i64) // npl
    for s, (st_s, f_s, c_s) in enumerate(zip(state.parts, f.parts, carry.parts)):
        mine = shard_of == s
        if not bool(mine.any()):
            continue
        dev = c_s.pod_count.device
        with on_device(dev):
            patch_carry_rows(st_s, f_s, c_s, (idx[mine] - s * npl).to(dev),
                             req_rows[mine].to(dev), nz_rows[mine].to(dev),
                             cnt_rows[mine].to(dev), fit_strategy, in_place=True)
    carry.touched()
    return carry

# ---------------------------------------------------------------------------
# schedule_batch
# ---------------------------------------------------------------------------


def fresh_carry(state: DeviceNodeState, f: BatchFeatures, vmax: int, fit) -> ScanCarry:
    """The carry a batch starts from when none is chained in (the JAX
    package's :525-536): the resident node aggregates and `fit`, the
    (fit_ok, fit_sc, ba) that resource_eval gives for them (with the
    nominated-pod lane, where the features carry one)."""
    NP = state.valid.shape[0]
    dev = state.valid.device
    return ScanCarry(state.req_r, state.nonzero, state.pod_count, *fit,
                     f.dns_counts, f.sa_counts, f.anti_counts, f.aff_counts,
                     torch.zeros((f.ipa_axis.shape[0], vmax), dtype=i64, device=dev),
                     f.start_index, torch.zeros(NP, dtype=torch.bool, device=dev),
                     torch.zeros(NP, dtype=i32, device=dev))


def schedule_batch(state: DeviceNodeState, f: BatchFeatures, batch_pad: int,
                   fit_strategy: int, vmax: int, facts: PlanFacts,
                   n_active: Optional[int] = None,
                   carry_in: Optional[ScanCarry] = None) -> Tuple[torch.Tensor, ScanCarry]:
    """Greedy-assign up to `batch_pad` identical pods (`n_active` of them
    real; padded steps are inert so the returned carry stays exact) — the
    JAX package's schedule_batch, its four static plan arguments given as
    one `facts`, with the same results:
    (the [2, batch_pad] array of (chosen row or -1, start index after),
    the final ScanCarry). Passing the carry back as `carry_in` chains the
    next batch of the same plan.

    The plan picks the kernel (:262-273): a plan whose landings change only
    their own row and score takes the lap above 64 steps; every other plan,
    the reference's scan path for such a plan at or below 64 steps
    included, takes scan_general (a row-local plan is its incremental,
    carried mode). Features whose `nom_req` has rows carry the
    nominated-pod lane (the JAX package's `has_nom`): every kernel counts a
    row's nominated pods against the fit filter of that row. A
    `port_selfblock` plan reads the carry's blocked lane and blocks each
    landed row, and a `has_aux` plan counts each landing's attachments in
    the carry's aux_cnt lane against the row's aux_room; neither picks
    another path (a landing still changes only its own row)."""
    n_act = batch_pad if n_active is None else int(n_active)
    masks = static_masks(state, f)
    if carry_in is None:
        ext0 = fresh_carry(state, f, vmax, resource_eval(
            f, fit_strategy, state.alloc_r, state.alloc_pods, state.req_r,
            state.nonzero, state.pod_count, *_nom_lane(f)))
    else:
        ext0 = carry_in
    path = plan_path(f, facts, batch_pad)
    if path == "lap":
        return lap_schedule(state, f, batch_pad, fit_strategy, ext0, masks.static_ok, n_act,
                            facts.port_selfblock, facts.has_aux)
    return scan_general(state, f, batch_pad, fit_strategy, ext0, masks, n_act, facts)


def plan_path(f: BatchFeatures, facts: PlanFacts, batch_pad: int) -> str:
    """The reference's path for a plan (the JAX package's :262-273): "lap"
    (lap_schedule) for a plan whose landings change only their own row and
    score above 64 steps, "scan" for such a plan without count tables at or
    below 64 steps, "general" for every other plan. "scan" and "general"
    plans both take scan_general."""
    incremental, carried = plan_modes(f, facts)
    if incremental and carried and batch_pad > SCAN_MAX_STEPS:
        return "lap"
    if incremental and carried and f.anti_axis.shape[0] == 0:
        return "scan"
    return "general"


# ---------------------------------------------------------------------------
# schedule_placements
# ---------------------------------------------------------------------------

GEN_MAXC = 16  # spread-table rows a general scan takes (csrc/gen_sizes.h)


def _lane_features(f: BatchFeatures, mask: torch.Tensor, tables=None) -> BatchFeatures:
    """One placement lane's features (the JAX package's :705-720): the
    candidate's rows as the extra filter, rotation start 0, no truncation,
    and the lane's own spread tables where `tables` gives them."""
    f2 = f._replace(extra_ok=f.extra_ok & mask,
                    start_index=torch.zeros((), dtype=i32, device=mask.device),
                    to_find=f.num_nodes)
    if tables is not None:
        dns_counts, dns_dom, dns_forced0, sa_counts, sa_wq = tables
        f2 = f2._replace(dns_counts=dns_counts, dns_dom=dns_dom, dns_forced0=dns_forced0,
                         sa_counts=sa_counts, sa_wq=sa_wq)
    return f2


def _schedule_placements_plain(state: DeviceNodeState, f: BatchFeatures, batch_pad: int,
                               fit_strategy: int, vmax: int, facts: PlanFacts,
                               masks: torch.Tensor, n_active: int,
                               spread_overrides=None) -> torch.Tensor:
    """Plain PyTorch version of the schedule_placements kernel: per lane,
    schedule_batch's plain path on the lane's features from a fresh carry
    (the JAX package's vmap over the lanes), stacked [P, 2, B]. The static
    masks and the fresh carry's resource lanes do not depend on the lane
    (its mask only narrows static_ok), so they are computed once."""
    lane_facts = facts._replace(has_ipa_base=False, anti_rowlocal=False)
    m = _static_masks_plain(state, f)
    fit = _resource_eval_plain(f, fit_strategy, state.alloc_r, state.alloc_pods, state.req_r,
                               state.nonzero, state.pod_count, *_nom_lane(f))
    out = []
    for p in range(masks.shape[0]):
        tables = None if spread_overrides is None else [t[p] for t in spread_overrides]
        f2 = _lane_features(f, masks[p], tables)
        ext0 = fresh_carry(state, f2, vmax, fit)
        lm = m._replace(static_ok=m.static_ok & masks[p])
        if plan_path(f2, lane_facts, batch_pad) == "lap":
            res, _ = _lap_schedule_plain(state, f2, batch_pad, fit_strategy, ext0, lm.static_ok,
                                         n_active, facts.port_selfblock, facts.has_aux)
        else:
            res, _ = _scan_general_plain(state, f2, batch_pad, fit_strategy, ext0, lm, n_active,
                                         lane_facts)
        out.append(res)
    return torch.stack(out)


PLACEMENT_SMEM_MAX = 220 * 1024  # a lane's on-chip budget (GEN2_SMEM_MAX, csrc/gen_sizes.h)


def _align16(n: int) -> int:
    return (n + 15) & ~15


def _placement_lane_bytes(n: int, V: int, C1: int, C2: int, carried: bool) -> int:
    """The bytes of a placement lane's arrays at `n` rows (lane_layout in
    csrc/gen_sizes.h, every array aligned to 16): the chunk masks and
    prefixes, the flags, the row list, each dns table with its domains and
    each sa table, a value id a row a table, the carried total (or the fit
    score and BalancedAllocation) and the landing count a row. The launcher
    refuses a slice shorter than its own count, and a test holds the two
    equal."""
    kw = ((n + 31) // 32 + 15) // 16
    sizes = [2 * kw * 17 * 4, n, 4 * n] + [4 * V, V] * C1 + [4 * V] * C2
    sizes += [4 * n] * (C1 + C2) + ([8 * n] if carried else [8 * n, 8 * n]) + [4 * n]
    return sum(_align16(x) for x in sizes)


def _schedule_placements_cuda(state, f, batch_pad, fit_strategy, vmax, facts, masks, n_active,
                              spread_overrides=None):
    dev = masks.device
    P, NP = masks.shape
    C1, C2, V = f.dns_axis.shape[0], f.sa_axis.shape[0], f.dns_counts.shape[1]
    if f.anti_axis.shape[0] or f.aff_axis.shape[0] or f.ipa_axis.shape[0]:
        raise ValueError("schedule_placements: a plan with inter-pod-affinity tables is "
                         "outside the placement restriction")
    if C1 > GEN_MAXC or C2 > GEN_MAXC:
        raise ValueError(f"schedule_placements: {C1} and {C2} spread-table rows, at most "
                         f"{GEN_MAXC} each")
    lane_facts = facts._replace(has_ipa_base=False, anti_rowlocal=False)
    incremental, carried = plan_modes(f, lane_facts)
    if spread_overrides is None:
        tables, per_lane = (f.dns_counts, f.dns_dom, f.dns_forced0, f.sa_counts, f.sa_wq), 0
    else:
        tables, per_lane = tuple(spread_overrides), 1
        want = ((P, C1, V), (P, C1, V), (P, C1), (P, C2, V), (P, C2))
        if tuple(tuple(t.shape) for t in tables) != want:
            raise ValueError(f"schedule_placements: spread overrides "
                             f"{[tuple(t.shape) for t in tables]}, expected {list(want)}")
    dns_counts, dns_dom, dns_forced0, sa_counts, sa_wq = tables
    m = static_masks(state, f)
    # A lane keeps its rows' state on chip. Only where a lane of every row
    # could outgrow the budget does the widest placement decide (one read
    # of the card), and only a lane past the budget takes device memory: a
    # slice of its own, sized for the widest placement.
    rows_cap, need, scratch = NP, 0, None
    if _placement_lane_bytes(NP, V, C1, C2, carried) > PLACEMENT_SMEM_MAX:
        rows_cap = int(masks.sum(dim=1).amax())
        need = _placement_lane_bytes(rows_cap, V, C1, C2, carried)
        if need > PLACEMENT_SMEM_MAX:
            scratch = torch.empty((P, need), dtype=torch.uint8, device=dev)
        else:
            need = 0
    out = torch.empty((P, 2, batch_pad), dtype=i32, device=dev)
    ints, feats = _res_args(f, fit_strategy)
    _launch("schedule_placements", dev, NP, *ints, P, batch_pad, int(n_active), V, C1, C2,
            int(incremental), int(carried), int(facts.has_pns), int(facts.has_na_pref), per_lane,
            int(facts.port_selfblock), int(facts.has_aux), rows_cap,
            *feats, state.alloc_r, state.alloc_pods, state.req_r, state.nonzero, state.pod_count,
            *_nom_lane(f), m.static_ok, m.sel_ok, m.taint_ok, m.pns_cnt, masks, state.topo,
            f.il_score, f.na_raw, f.weights, f.num_nodes, f.dns_axis, f.dns_active,
            f.dns_max_skew, f.dns_self, dns_forced0, f.dns_honor_aff, f.dns_honor_taints,
            dns_dom, dns_counts, f.sa_axis, sa_wq, f.sa_skew, f.sa_self, sa_counts,
            f.aux_room, f.aux_inc, need, scratch, out)
    return out


def schedule_placements(state: DeviceNodeState, f: BatchFeatures, batch_pad: int,
                        fit_strategy: int, vmax: int, facts: PlanFacts, masks: torch.Tensor,
                        n_active: int, spread_overrides=None) -> torch.Tensor:
    """Evaluate a pod group against P candidate placements at once (the
    JAX package's schedule_placements, :655-723): lane p runs the group's
    `n_active` members through schedule_batch restricted to the rows of
    `masks[p]` ([P, NP] bool), from a fresh carry of `state`, rotation start
    0 and no truncation. `spread_overrides`, a tuple (dns_counts [P, C1, V],
    dns_dom [P, C1, V], dns_forced0 [P, C1], sa_counts [P, C2, V], sa_wq
    [P, C2]), gives each lane its placement-restricted spread tables.
    Returns [P, 2, batch_pad] i32 (chosen row or -1, start after). No input
    is written. The plan must carry no inter-pod-affinity table and no base
    score (the caller's restriction invariant). Under `port_selfblock` each
    lane blocks only the rows its own members land on (a fresh carry's
    blocked lane is empty); under `has_aux` each lane counts only its own
    members' attachments (a fresh carry's aux_cnt lane is zero)."""
    if _on_cpu(masks):
        return _schedule_placements_plain(state, f, batch_pad, fit_strategy, vmax, facts,
                                          masks, n_active, spread_overrides)
    out = _schedule_placements_cuda(state, f, batch_pad, fit_strategy, vmax, facts, masks,
                                    n_active, spread_overrides)
    schedule_placements.launches += 1
    return out


schedule_placements.launches = 0


# ---------------------------------------------------------------------------
# sharded_lap: the node-sharded lap, one persistent launch a card a dispatch
# ---------------------------------------------------------------------------
#
# The plain version is LapRun: the JAX body's three phases a shard (count,
# windows, land), cut at its two exchanges, which it makes as copies. Each
# phase reads the shard's `done` and does nothing once done >= n_act.


class LapShard(NamedTuple):
    """One shard of a sharded-lap dispatch: its rows of the node state and
    of the features (parts of a Sharded cut, parallel/mesh.py), its carry,
    whose req_r, nonzero, pod_count, fit_ok, fit_sc, ba and start the
    dispatch writes in place, and its static_ok."""

    state: DeviceNodeState
    f: BatchFeatures
    carry: ScanCarry
    static_ok: torch.Tensor


def _sharded_lap_count_plain(state: DeviceNodeState, f: BatchFeatures, fit_strategy: int,
                             req_r, nonzero, pod_count, static_ok, n_act: int, shard: int,
                             done, start, okd, Fl, total, pair) -> None:
    """Phase (a) of a lap on shard `shard` (NPl rows, global row shard *
    NPl + local): re-evaluate the carry's rows (fit_ok, fit_sc, ba), write
    okd = static_ok & fit_ok & (row < num_nodes) [NPl] u8, its inclusive
    prefix sum Fl [NPl] i32, the carried total score [NPl] i64, and the
    shard's pair [2] i32: (Fl[-1], Fl at row start-1 where the shard owns
    it, else 0), what exchange 1 gathers. `done` and `start` are the
    shard's 0-d i32 copies of the loop state."""
    if int(done) >= n_act:
        return
    npl = static_ok.shape[0]
    gidx = shard * npl + torch.arange(npl, dtype=i32, device=static_ok.device)
    fit_ok, fit_sc, ba = _resource_eval_plain(f, fit_strategy, state.alloc_r, state.alloc_pods,
                                              req_r, nonzero, pod_count)
    ok = static_ok & fit_ok & (gidx < f.num_nodes.clamp_min(1))
    F = torch.cumsum(ok.to(i32), 0, dtype=i32)
    sidx = start - 1
    own = (start > 0) & (sidx >= shard * npl) & (sidx < (shard + 1) * npl)
    lpos = (sidx - shard * npl).clamp(0, npl - 1).to(i64)
    okd.copy_(ok)
    Fl.copy_(F)
    total.copy_(_total(f, fit_sc, ba))
    pair.copy_(torch.stack([F[-1], torch.where(own, F[lpos], 0)]))


def _sharded_lap_windows_plain(f: BatchFeatures, n_act: int, shard: int, pairs, okd, Fl, total,
                               done, start, keys, L) -> None:
    """Phase (b) of a lap on shard `shard`: from exchange 1's gathered
    pairs [S, 2] i32, the feasible total, the shard's global prefix offset
    and the rank origin F[start - 1] of the start's owner, clip((start - 1)
    // NPl, 0, S - 1); the lap's L = clip(min(total // to_find, n_act -
    done), 1, LAP_MAX) into `L` (0-d i32); and the shard's packed keys
    [2 * LAP_MAX] i64 — each window's max of total * NP + (NP - 1 - rot)
    (-1 where empty), then each window's negated boundary min of rot + 1
    (-num where empty): what exchange 2 gathers."""
    d = int(done)
    if d >= n_act:
        return
    dev = okd.device
    npl, S = okd.shape[0], pairs.shape[0]
    NP = npl * S
    gidx = shard * npl + torch.arange(npl, dtype=i32, device=dev)
    num = f.num_nodes.clamp_min(1)
    tf = f.to_find.clamp_min(1)
    svec = torch.arange(S, dtype=i32, device=dev)
    tots = pairs[:, 0]
    total_feas = tots.sum().to(i32)
    F = Fl + torch.where(svec < shard, tots, 0).sum().to(i32)
    owner = ((start - 1) // npl).clamp(0, S - 1)
    f_start = torch.where(start > 0, torch.where(svec < owner, tots, 0).sum().to(i32)
                          + pairs[owner.to(i64), 1], 0)
    rank = torch.where(gidx >= start, F - f_start, F + total_feas - f_start)
    rot = (gidx - start) % num
    lap_l = max(1, min(int(total_feas // tf), n_act - d, LAP_MAX))
    lanes = torch.arange(LAP_MAX, dtype=i32, device=dev)
    ok = okd.bool()
    w = torch.clamp_max((rank - 1) // tf, LAP_MAX)
    seg = torch.where(ok & (w < lap_l), w, LAP_MAX)
    key = total * NP + ((NP - 1) - rot)
    keys[:LAP_MAX] = torch.where(seg[None, :] == lanes[:, None], key[None, :], -1).amax(dim=1)
    is_b = ok & (rank % tf == 0)
    seg_b = torch.where(is_b, torch.clamp_max(rank // tf - 1, LAP_MAX), LAP_MAX)
    ev_w = torch.where(seg_b[None, :] == lanes[:, None], rot[None, :] + 1, num).amin(dim=1)
    keys[LAP_MAX:] = -ev_w.to(i64)
    L.fill_(lap_l)


def _sharded_lap_land_plain(f: BatchFeatures, n_act: int, shard: int, keys, L, req_r, nonzero,
                            pod_count, out, start, done) -> None:
    """Phase (c) of a lap on shard `shard`: the max over exchange 2's
    gathered keys [S, 2 * LAP_MAX] (the JAX pmax), each window's landed row
    and start after, the landings on the shard's own rows (req_r, nonzero
    and pod_count, in place), the [2, B] results block at column `done`
    where `out` is given (the shard that keeps the results; None on the
    others), the new start and done += L."""
    d = int(done)
    if d >= n_act:
        return
    dev = pod_count.device
    npl, S = pod_count.shape[0], keys.shape[0]
    NP = npl * S
    num = f.num_nodes.clamp_min(1)
    lap_l = int(L)
    red = keys.amax(dim=0)
    key_w, ev_w = red[:LAP_MAX], (-red[LAP_MAX:]).to(i32)
    lanes = torch.arange(LAP_MAX, dtype=i32, device=dev)
    has_w = (lanes < lap_l) & (key_w >= 0)
    rot_w = (NP - 1) - (key_w % NP).to(i32)
    row_w = torch.where(has_w, (start + rot_w) % num, -1).to(i32)
    start_w = ((start + ev_w) % num).to(i32)
    local = row_w.to(i64) - shard * npl
    mine = has_w & (local >= 0) & (local < npl)
    rows = torch.arange(npl, dtype=i64, device=dev)
    cnt = ((rows[None, :] == local[:, None]) & mine[:, None]).any(dim=0)
    c64 = cnt.to(i64)
    req_r.add_(f.request[None, :] * c64[:, None])
    nonzero.add_(f.nz_request[None, :] * c64[:, None])
    pod_count.add_(cnt.to(i32))
    if out is not None:
        n = max(0, min(LAP_MAX, out.shape[1] - d))
        out[0, d:d + n] = torch.where(has_w, row_w, -1)[:n]
        out[1, d:d + n] = start_w[:n]
    start.copy_(start_w[lap_l - 1])
    done.fill_(d + lap_l)


def on_device(dev: torch.device):
    """The launch context of a shard's kernels: its card made current."""
    return torch.cuda.device(dev) if dev.type == "cuda" else nullcontext()


def _all_gather(src: Sequence[torch.Tensor], dst: dict) -> None:
    """Every shard's tensor stacked into each device's buffer."""
    for dev, buf in dst.items():
        with on_device(dev):
            torch.stack([t if t.device == dev else t.to(dev, non_blocking=True) for t in src],
                        out=buf)


class _PlainShard:
    """One shard's per-lap buffers in LapRun."""

    __slots__ = ("done", "okd", "Fl", "total", "pair", "keys", "L")

    def __init__(self, npl: int, dev):
        self.done = torch.zeros((), dtype=i32, device=dev)
        self.okd = torch.empty(npl, dtype=torch.uint8, device=dev)
        self.Fl = torch.empty(npl, dtype=i32, device=dev)
        self.total = torch.empty(npl, dtype=i64, device=dev)
        self.pair = torch.zeros(2, dtype=i32, device=dev)
        self.keys = torch.empty(2 * LAP_MAX, dtype=i64, device=dev)
        self.L = torch.ones((), dtype=i32, device=dev)


class LapRun:
    """The plain version of the sharded_lap kernel, lap by lap: the JAX
    body's three phases a shard and its two exchanges as copies (an
    all-gather of each shard's pair, then of its packed keys, stacked onto
    every distinct device). `run()` writes what the kernel writes: the
    shards' carries in place (the landed rows' aggregates, every row's fit
    lanes, start) and `out`, the [2, B] results on shard 0's device. It
    runs on any device."""

    def __init__(self, shards: Sequence[LapShard], fit_strategy: int, n_act: int,
                 out: torch.Tensor):
        self.io, self.fit_strategy, self.n_act, self.out = list(shards), fit_strategy, int(n_act), out
        S = len(self.io)
        self.shards = [_PlainShard(sh.static_ok.shape[0], sh.static_ok.device) for sh in self.io]
        devs = dict.fromkeys(sh.static_ok.device for sh in self.io)
        self.pairs = {d: torch.empty((S, 2), dtype=i32, device=d) for d in devs}
        self.keys = {d: torch.empty((S, 2 * LAP_MAX), dtype=i64, device=d) for d in devs}

    def count_phase(self) -> None:
        for s, (io, b) in enumerate(zip(self.io, self.shards)):
            c = io.carry
            with on_device(io.static_ok.device):
                _sharded_lap_count_plain(io.state, io.f, self.fit_strategy, c.req_r, c.nonzero,
                                         c.pod_count, io.static_ok, self.n_act, s, b.done,
                                         c.start, b.okd, b.Fl, b.total, b.pair)

    def exchange_pairs(self) -> None:
        _all_gather([b.pair for b in self.shards], self.pairs)

    def windows_phase(self) -> None:
        for s, (io, b) in enumerate(zip(self.io, self.shards)):
            dev = io.static_ok.device
            with on_device(dev):
                _sharded_lap_windows_plain(io.f, self.n_act, s, self.pairs[dev], b.okd, b.Fl,
                                           b.total, b.done, io.carry.start, b.keys, b.L)

    def exchange_keys(self) -> None:
        _all_gather([b.keys for b in self.shards], self.keys)

    def land_phase(self) -> None:
        for s, (io, b) in enumerate(zip(self.io, self.shards)):
            c, dev = io.carry, io.static_ok.device
            with on_device(dev):
                _sharded_lap_land_plain(io.f, self.n_act, s, self.keys[dev], b.L, c.req_r,
                                        c.nonzero, c.pod_count, self.out if s == 0 else None,
                                        c.start, b.done)

    def one_lap(self) -> None:
        self.count_phase()
        self.exchange_pairs()
        self.windows_phase()
        self.exchange_keys()
        self.land_phase()

    def run(self) -> None:
        """Laps until done >= n_act (read a lap), then every row's fit
        lanes from the final aggregates."""
        while int(self.shards[0].done) < self.n_act:
            self.one_lap()
        for io in self.io:
            c = io.carry
            with on_device(io.static_ok.device):
                fit = _resource_eval_plain(io.f, self.fit_strategy, io.state.alloc_r,
                                           io.state.alloc_pods, c.req_r, c.nonzero, c.pod_count)
                for lane, new in zip((c.fit_ok, c.fit_sc, c.ba), fit):
                    lane.copy_(new)


def _sharded_lap_plain(shards: Sequence[LapShard], fit_strategy: int, n_act: int,
                       out: torch.Tensor) -> None:
    """Plain PyTorch version of the sharded_lap kernel."""
    LapRun(shards, fit_strategy, n_act, out).run()


# csrc/sharded_lap.cu's limits and exchange layout.
SHL_MAX_LOCAL = 32        # shards one card's launch holds
SHL_SMEM_ROWS = 16384     # a shard's kept rows in shared memory up to this many
SHL_PAIR_STRIDE = 16      # int64 words a shard's pair slot
SHL_KEY_STRIDE = 80       # int64 words a shard's key slot
SHL_WAIT_MCYCLES = 8000   # a wait's budget, millions of clock64 cycles (~4 s at 1.98 GHz)
_CUDA_INVALID_DEVICE_POINTER = 17
_CUDA_COOPERATIVE_LAUNCH_TOO_LARGE = 82


def _shl_work_words(npl: int) -> int:
    """int64 words of one shard's kept arrays in device memory (shl_work_words)."""
    return npl + (npl + 7) // 8


def shards_per_card(devices: Sequence[torch.device]) -> dict:
    """{card: [its shards' indices]}, cards in the order of their first
    shard: what each card's one launch holds."""
    groups: dict = {}
    for s, dev in enumerate(devices):
        groups.setdefault(dev, []).append(s)
    return groups


def check_resident(dev, n_local: int, limit: int) -> None:
    """Refuse a card asked to hold more shards than one cooperative launch
    keeps resident there (`limit`, at most SHL_MAX_LOCAL): its blocks could
    not all run at once, and a block waiting on one that never runs hangs."""
    if n_local > limit:
        raise ValueError(f"sharded_lap: {n_local} shards on {dev}, but one launch there keeps "
                         f"at most {limit} resident; use fewer shards a card")


def exchange_medium(devices: Sequence[torch.device]) -> Optional[torch.device]:
    """Where a dispatch's exchange buffer lives: the card's own memory when
    every shard is on one card, else pinned host memory (None), which every
    card reads and writes directly under unified addressing."""
    distinct = set(devices)
    return next(iter(distinct)) if len(distinct) == 1 else None


# {shards' devices: [exchange buffer, last generation]}: a buffer serves
# every dispatch of its mesh; the generation in each arrival word tells one
# dispatch's slots from another's, so nothing is reset between them.
_EXCHANGES: dict = {}


def _exchange_buffer(devices: Sequence[torch.device]) -> Tuple[torch.Tensor, int]:
    entry = _EXCHANGES.get(tuple(devices))
    if entry is None:
        words = len(devices) * (SHL_PAIR_STRIDE + SHL_KEY_STRIDE)
        medium = exchange_medium(devices)
        buf = (torch.zeros(words, dtype=i64, pin_memory=True) if medium is None
               else torch.zeros(words, dtype=i64, device=medium))
        entry = _EXCHANGES[tuple(devices)] = [buf, 0]
    entry[1] = entry[1] % (2 ** 31 - 1) + 1
    return entry[0], entry[1]


@functools.lru_cache(maxsize=None)
def _resident_limit(dev: torch.device, npl: int, R: int, FR: int, S: int, tiered: bool) -> int:
    """The most shards one launch keeps resident on `dev` (the source's
    sharded_lap_resident_limit, which also loads the kernel there)."""
    with torch.cuda.device(dev):
        rc = _build.build().sharded_lap_resident_limit(npl, R, FR, S, int(tiered))
    if rc < 0:
        raise RuntimeError(f"sharded_lap: occupancy query failed on {dev} with cudaError {-rc}")
    return rc


def _lap_table_row(sh: LapShard, s: int, dev, npl: int, R: int) -> list:
    """Shard s's row of the launcher's table: its index, then the addresses
    of its tensors, each checked as _marshal checks a launcher's."""
    c = sh.carry
    fields = (("alloc_r", sh.state.alloc_r, i64, (npl, R)),
              ("alloc_pods", sh.state.alloc_pods, i64, (npl,)),
              ("req_r", c.req_r, i64, (npl, R)), ("nonzero", c.nonzero, i64, (npl, 2)),
              ("pod_count", c.pod_count, i32, (npl,)),
              ("static_ok", sh.static_ok, torch.bool, (npl,)),
              ("il_score", sh.f.il_score, i64, (npl,)), ("fit_ok", c.fit_ok, torch.bool, (npl,)),
              ("fit_sc", c.fit_sc, i64, (npl,)), ("ba", c.ba, i64, (npl,)),
              ("start", c.start, i32, ()))
    row = [s]
    for name, t, dtype, shape in fields:
        if t.dtype != dtype or tuple(t.shape) != shape or t.device != dev or not t.is_contiguous():
            raise ValueError(f"sharded_lap: shard {s}'s {name} must be a contiguous {dtype} "
                             f"{shape} tensor on {dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
        row.append(t.data_ptr())
    return row


def _sharded_lap_cuda(shards: Sequence[LapShard], fit_strategy: int, n_act: int,
                      out: torch.Tensor) -> list:
    """One launch a card; returns [(card, its shards, status words, table)]. Every
    buffer is made and every card's kernel loaded before the first launch,
    and nothing between two launches waits for a card: a card whose blocks
    already wait on the others' exchanges would otherwise deadlock."""
    S = len(shards)
    npl, R = shards[0].state.alloc_r.shape
    ints, _ = _res_args(shards[0].f, fit_strategy)
    tiered = npl > SHL_SMEM_ROWS
    devices = [sh.static_ok.device for sh in shards]
    groups = shards_per_card(devices)
    for dev, idx in groups.items():
        check_resident(dev, len(idx), _resident_limit(dev, npl, R, ints[1], S, tiered))
    xbuf, gen = _exchange_buffer(devices)
    cards = []
    for dev, idx in groups.items():
        table = torch.tensor([_lap_table_row(shards[s], s, dev, npl, R) for s in idx], dtype=i64)
        status = torch.zeros(len(idx), dtype=i32, device=dev)
        work = (torch.empty(len(idx) * _shl_work_words(npl), dtype=i64, device=dev) if tiered
                else None)
        cards.append((dev, idx, table, work, status))
    for dev, idx, table, work, status in cards:
        f = shards[idx[0]].f
        _, feats = _res_args(f, fit_strategy)
        with on_device(dev):
            cargs = _marshal("sharded_lap", dev, (
                npl, *ints, S, len(idx), n_act, out.shape[1], gen, SHL_WAIT_MCYCLES, *feats,
                f.weights, f.num_nodes, f.to_find, table, xbuf, out if 0 in idx else None, work,
                status))
            rc = _build.launcher("sharded_lap")(*cargs, _stream(dev))
        if rc == _CUDA_INVALID_DEVICE_POINTER:
            raise RuntimeError(f"sharded_lap: {dev} cannot reach the exchange buffer on "
                               f"{xbuf.device} (cudaPointerGetAttributes)")
        if rc == _CUDA_COOPERATIVE_LAUNCH_TOO_LARGE:
            raise ValueError(f"sharded_lap: {len(idx)} shards on {dev} are more than one "
                             "launch keeps resident there")
        if rc != 0:
            raise RuntimeError(f"sharded_lap: kernel launch failed with cudaError {rc}")
    return [(dev, idx, status, table) for dev, idx, table, _w, status in cards]


def _sharded_lap_status(cards: list) -> None:
    """Raise for a block whose wait ran past its budget (its status word:
    ((lap << 1) | exchange) + 1): the dispatch's results are void."""
    for dev, idx, status, _table in cards:
        for s, word in zip(idx, status.tolist()):
            if word:
                raise RuntimeError(f"sharded_lap: shard {s} on {dev} waited past its budget at "
                                   f"lap {(word - 1) >> 1}, exchange {((word - 1) & 1) + 1}; "
                                   "the dispatch's results are void")


def sharded_lap(shards: Sequence[LapShard], fit_strategy: int, n_act: int,
                out: torch.Tensor) -> None:
    """One dispatch of the node-sharded lap over `shards` (shard s holds
    global rows [s * NPl, (s + 1) * NPl)): the JAX package's _lap_body laps
    until `n_act` pods are placed, both exchanges of each lap included.
    Writes each shard's carry in place (the landed rows' req_r, nonzero and
    pod_count; every row's fit_ok, fit_sc and ba from the final aggregates;
    start) and the [2, B] results into `out` (on shard 0's device, filled
    with -1 by the caller). On CUDA shards each card launches its kernel
    once, one block a shard, and the status words are read after the last
    launch; CPU shards run LapRun."""
    on_cpu = [_on_cpu(sh.static_ok) for sh in shards]
    if all(on_cpu):
        _sharded_lap_plain(shards, fit_strategy, n_act, out)
        return
    if any(on_cpu):
        raise ValueError("sharded_lap: the shards must all be on the CPU or all on cards")
    cards = _sharded_lap_cuda(shards, fit_strategy, n_act, out)
    sharded_lap.launches += len(cards)
    _sharded_lap_status(cards)


sharded_lap.launches = 0

WRAPPERS = (static_masks, resource_eval, lap_schedule, scan_general,
            dry_run_preemption, scatter_rows, patch_carry_rows, schedule_placements,
            whatif_score, sharded_lap)


def reset_launch_counts() -> None:
    for w in WRAPPERS:
        w.launches = 0
