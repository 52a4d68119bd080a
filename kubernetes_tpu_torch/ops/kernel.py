"""The batch scheduling kernels: the Filter→Score hot path
(schedule_one.go findNodesThatFitPod :630 / prioritizeNodes :945) for a batch
of identical pods, with the greedy sequential assignment on the device.

Four hand-written CUDA kernels (csrc/) carry the fit-only slice, each
beside a plain PyTorch version of the same function in this module:

- static_masks   <- the JAX package's _static_masks + _tolerates
                    (ops/kernel.py:105-150), once per batch;
- resource_eval  <- _resource_eval (:160-208), the fresh-carry seed;
- lap_schedule   <- _lap_schedule (:799-925), batches of more than 64 steps;
- scan_schedule  <- the schedule_batch scan step (:314-523) specialised to
                    the slice's row-local, carried-score plan, batches of at
                    most 64 steps.

A wrapper runs the plain version only because the tensors it was given lie
on the CPU; on CUDA tensors it launches its kernel (building it at first
use) or raises. Each wrapper counts its launches in `<wrapper>.launches`.

Semantics are the JAX package's, bit for bit: exact int64 score math,
floored division and modulo, `ScanCarry`'s lane dtypes (cumsums pinned to
int32), inert padded steps, and the dump lane LAP_MAX that never lands.
"""

from __future__ import annotations

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
from .features import BatchFeatures

MAX_NODE_SCORE = 100
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
    takes a pointer (None only where the pointer is OPTIONAL)."""
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
        elif a.device != device:
            raise ValueError(f"launch_{name}: {p.name} on {a.device}, expected {device}")
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


def _static_masks_cuda(state: DeviceNodeState, f: BatchFeatures) -> StaticMasks:
    dev = state.valid.device
    NP, T = state.taint_key.shape
    L = f.tol_key.shape[0]
    b = [torch.empty(NP, dtype=torch.bool, device=dev) for _ in range(6)]
    pns = torch.empty(NP, dtype=i64, device=dev)
    outs = StaticMasks(b[0], pns, b[1], b[2], b[3], b[4], b[5])
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


def _resource_eval_plain(f: BatchFeatures, fit_strategy: int, alloc_r, alloc_pods,
                         req_r, nonzero, pod_count, nom_r=None, nom_p=None):
    """Plain PyTorch version of the resource_eval kernel, for any leading
    shape: the fit filter (fit.go:710, with the nominated lane counted
    against the filter only), the LeastAllocated/MostAllocated score and
    BalancedAllocation quantized at SCALE = 1e6."""
    eff_count = pod_count if nom_p is None else pod_count + nom_p
    pods_ok = (eff_count + 1).to(i64) <= alloc_pods
    avail = alloc_r - req_r if nom_r is None else alloc_r - req_r - nom_r
    viol = ((f.request > 0) & (f.request > avail)).any(dim=-1)
    fit_ok = (pods_ok & (~viol | (f.has_request == 0))) | (f.enable[4] == 0)
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
    """The carried total score of the slice's plan: TaintToleration at its
    maximum (no PreferNoSchedule terms), Fit, BalancedAllocation and the
    static ImageLocality term."""
    w = f.weights
    return w[0] * MAX_NODE_SCORE + w[1] * fit_sc + w[4] * ba + w[6] * f.il_score


def _lap_schedule_plain(state: DeviceNodeState, f: BatchFeatures, batch_pad: int,
                        fit_strategy: int, ext0: ScanCarry, static_ok, n_act: int,
                        stats: Optional[dict] = None) -> Tuple[torch.Tensor, ScanCarry]:
    """Plain PyTorch version of the lap_schedule kernel (the lap-vectorized
    greedy assignment). `stats`, when given, receives the lap count."""
    dev = static_ok.device
    NP = static_ok.shape[0]
    idx = torch.arange(NP, dtype=i32, device=dev)
    num = f.num_nodes.clamp_min(1)
    tf = f.to_find.clamp_min(1)
    lanes = torch.arange(LAP_MAX, dtype=i32, device=dev)
    req_r, nonzero, pod_count, start = ext0.req_r, ext0.nonzero, ext0.pod_count, ext0.start
    out = torch.full((2, batch_pad + LAP_MAX), -1, dtype=i32, device=dev)
    done = laps = 0
    while done < n_act:
        laps += 1
        fit_ok, fit_sc, ba = _resource_eval_plain(
            f, fit_strategy, state.alloc_r, state.alloc_pods, req_r, nonzero, pod_count)
        okd = static_ok & fit_ok & (idx < num)
        F = torch.cumsum(okd.to(i32), 0, dtype=i32)
        total = _total(f, fit_sc, ba)
        total_feas = F[-1]
        f_start = torch.where(start > 0, F[(start - 1).clamp_min(0).to(i64)], 0)
        rank = torch.where(idx >= start, F - f_start, F + total_feas - f_start)
        rot = (idx - start) % num
        L = max(1, min(int(total_feas // tf), n_act - done, LAP_MAX))
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
        out[:, done:done + LAP_MAX] = torch.stack([torch.where(has_w, row_w, -1),
                                                   start_w.to(i32)])
        start = start_w[L - 1].to(i32)
        done += L
    if stats is not None:
        stats["laps"] = laps
    fit_ok, fit_sc, ba = _resource_eval_plain(
        f, fit_strategy, state.alloc_r, state.alloc_pods, req_r, nonzero, pod_count)
    carry = ext0._replace(req_r=req_r, nonzero=nonzero, pod_count=pod_count,
                          fit_ok=fit_ok, fit_sc=fit_sc, ba=ba, start=start)
    return out[:, :batch_pad], carry


def _lap_schedule_cuda(state, f, batch_pad, fit_strategy, ext0, static_ok, n_act):
    dev = static_ok.device
    NP = static_ok.shape[0]
    req_r, nonzero, pod_count = (t.clone() for t in ext0[:3])
    fit_ok = torch.empty(NP, dtype=torch.bool, device=dev)
    fit_sc = torch.empty(NP, dtype=i64, device=dev)
    ba = torch.empty(NP, dtype=i64, device=dev)
    start = torch.empty((), dtype=i32, device=dev)
    okd_s = torch.empty(NP, dtype=torch.uint8, device=dev)
    F_s = torch.empty(NP, dtype=i32, device=dev)
    total_s = torch.empty(NP, dtype=i64, device=dev)
    out = torch.full((2, batch_pad), -1, dtype=i32, device=dev)
    ints, feats = _res_args(f, fit_strategy)
    _launch("lap_schedule", dev, NP, *ints, batch_pad, n_act, *feats, state.alloc_r,
            state.alloc_pods, req_r, nonzero, pod_count, static_ok, f.il_score, f.weights,
            f.num_nodes, f.to_find, ext0.start, okd_s, F_s, total_s, out, fit_ok, fit_sc,
            ba, start)
    carry = ext0._replace(req_r=req_r, nonzero=nonzero, pod_count=pod_count,
                          fit_ok=fit_ok, fit_sc=fit_sc, ba=ba, start=start)
    return out, carry


def lap_schedule(state: DeviceNodeState, f: BatchFeatures, batch_pad: int,
                 fit_strategy: int, ext0: ScanCarry, static_ok: torch.Tensor,
                 n_act: int) -> Tuple[torch.Tensor, ScanCarry]:
    """Lap-vectorized greedy assignment of up to `batch_pad` pods (`n_act`
    real): returns the [2, batch_pad] (row or -1, start after) results and
    the final carry."""
    if _on_cpu(static_ok):
        return _lap_schedule_plain(state, f, batch_pad, fit_strategy, ext0, static_ok, n_act)
    out = _lap_schedule_cuda(state, f, batch_pad, fit_strategy, ext0, static_ok, n_act)
    lap_schedule.launches += 1
    return out


lap_schedule.launches = 0


# ---------------------------------------------------------------------------
# scan_schedule
# ---------------------------------------------------------------------------


def _scan_schedule_plain(state: DeviceNodeState, f: BatchFeatures, batch_pad: int,
                         fit_strategy: int, ext0: ScanCarry, static_ok,
                         n_act: int) -> Tuple[torch.Tensor, ScanCarry]:
    """Plain PyTorch version of the scan_schedule kernel: one pod per step,
    feasibility patched at the landed row, total score carried."""
    dev = static_ok.device
    NP = static_ok.shape[0]
    idx = torch.arange(NP, dtype=i32, device=dev)
    num = f.num_nodes.clamp_min(1)
    req_r, nonzero, pod_count, fit_ok, fit_sc, ba = (t.clone() for t in ext0[:6])
    start = ext0.start
    okd = static_ok & fit_ok & (idx < num)
    F = torch.cumsum(okd.to(i32), 0, dtype=i32)
    total = _total(f, fit_sc, ba)
    out = torch.full((2, batch_pad), -1, dtype=i32, device=dev)
    for t in range(batch_pad):
        active = t < n_act
        total_feas = F[-1]
        f_start = torch.where(start > 0, F[(start - 1).clamp_min(0).to(i64)], 0)
        rank = torch.where(idx >= start, F - f_start, F + total_feas - f_start)
        kept = okd & (rank <= f.to_find)
        rot = (idx - start) % num
        bound = torch.where(okd & (rank == f.to_find), (num - 1 - rot).to(i64), 0).amax()
        key = total * NP + ((NP - 1) - rot)
        best_key = torch.where(kept, key, -1).amax()
        evaluated = (num - bound).to(i32)
        any_kept = (best_key >= 0) & active
        chosen_rot = (NP - 1) - (best_key % NP).to(i32)
        chosen = torch.where(any_kept, (start + chosen_rot) % num, -1).to(i32)
        row = chosen.clamp_min(0).to(i64)
        apply = any_kept.to(i64)
        req_r[row] += f.request * apply
        nonzero[row] += f.nz_request * apply
        pod_count[row] += apply.to(i32)
        r_ok, r_fit, r_ba = _resource_eval_plain(
            f, fit_strategy, state.alloc_r[row], state.alloc_pods[row],
            req_r[row], nonzero[row], pod_count[row])
        fit_ok[row] = r_ok
        fit_sc[row] = r_fit
        ba[row] = r_ba
        new_ok_row = static_ok[row] & r_ok & (row < num)
        delta = new_ok_row.to(i32) - okd[row].to(i32)
        okd[row] = new_ok_row
        F = F + torch.where(idx >= row, delta, 0)
        total[row] = (f.weights[0] * MAX_NODE_SCORE + f.weights[1] * r_fit
                      + f.weights[4] * r_ba + f.weights[6] * f.il_score[row])
        if active:
            start = ((start + evaluated) % num).to(i32)
        out[:, t] = torch.stack([chosen, start])
    carry = ext0._replace(req_r=req_r, nonzero=nonzero, pod_count=pod_count,
                          fit_ok=fit_ok, fit_sc=fit_sc, ba=ba, start=start)
    return out, carry


def _scan_schedule_cuda(state, f, batch_pad, fit_strategy, ext0, static_ok, n_act):
    dev = static_ok.device
    NP = static_ok.shape[0]
    req_r, nonzero, pod_count, fit_ok, fit_sc, ba = (t.clone() for t in ext0[:6])
    start = torch.empty((), dtype=i32, device=dev)
    okd_s = torch.empty(NP, dtype=torch.uint8, device=dev)
    F_s = torch.empty(NP, dtype=i32, device=dev)
    total_s = torch.empty(NP, dtype=i64, device=dev)
    out = torch.full((2, batch_pad), -1, dtype=i32, device=dev)
    ints, feats = _res_args(f, fit_strategy)
    _launch("scan_schedule", dev, NP, *ints, batch_pad, n_act, *feats, state.alloc_r,
            state.alloc_pods, req_r, nonzero, pod_count, fit_ok, fit_sc, ba, static_ok,
            f.il_score, f.weights, f.num_nodes, f.to_find, ext0.start, okd_s, F_s, total_s,
            out, start)
    carry = ext0._replace(req_r=req_r, nonzero=nonzero, pod_count=pod_count,
                          fit_ok=fit_ok, fit_sc=fit_sc, ba=ba, start=start)
    return out, carry


def scan_schedule(state: DeviceNodeState, f: BatchFeatures, batch_pad: int,
                  fit_strategy: int, ext0: ScanCarry, static_ok: torch.Tensor,
                  n_act: int) -> Tuple[torch.Tensor, ScanCarry]:
    """One-pod-per-step greedy assignment for small batches: returns the
    [2, batch_pad] results and the final carry."""
    if _on_cpu(static_ok):
        return _scan_schedule_plain(state, f, batch_pad, fit_strategy, ext0, static_ok, n_act)
    out = _scan_schedule_cuda(state, f, batch_pad, fit_strategy, ext0, static_ok, n_act)
    scan_schedule.launches += 1
    return out


scan_schedule.launches = 0

WRAPPERS = (static_masks, resource_eval, lap_schedule, scan_schedule)


def reset_launch_counts() -> None:
    for w in WRAPPERS:
        w.launches = 0


# ---------------------------------------------------------------------------
# schedule_batch
# ---------------------------------------------------------------------------


def fresh_carry(state: DeviceNodeState, f: BatchFeatures, vmax: int, fit) -> ScanCarry:
    """The carry a batch starts from when none is chained in (the JAX
    package's :525-536): the resident node aggregates and `fit`, the
    (fit_ok, fit_sc, ba) that resource_eval gives for them."""
    NP = state.valid.shape[0]
    dev = state.valid.device
    return ScanCarry(state.req_r, state.nonzero, state.pod_count, *fit,
                     f.dns_counts, f.sa_counts, f.anti_counts, f.aff_counts,
                     torch.zeros((f.ipa_axis.shape[0], vmax), dtype=i64, device=dev),
                     f.start_index, torch.zeros(NP, dtype=torch.bool, device=dev),
                     torch.zeros(NP, dtype=i32, device=dev))


def schedule_batch(state: DeviceNodeState, f: BatchFeatures, batch_pad: int,
                   fit_strategy: int, vmax: int, n_active: Optional[int] = None,
                   carry_in: Optional[ScanCarry] = None, has_pns: bool = True,
                   has_ipa_base: bool = True) -> Tuple[torch.Tensor, ScanCarry]:
    """Greedy-assign up to `batch_pad` identical pods (`n_active` of them
    real; padded steps are inert so the returned carry stays exact) — the
    JAX package's schedule_batch with the same arguments and results:
    (the [2, batch_pad] array of (chosen row or -1, start index after),
    the final ScanCarry). Passing the carry back as `carry_in` chains the
    next batch of the same plan.

    The port covers the plan of the fit-only slice: no count tables and no
    kept-set normalization terms, so a landing changes feasibility and score
    only at its own row. Such a plan takes the lap kernel above 64 steps and
    the scan kernel at or below (:262-273); any other plan raises."""
    C1, C2 = f.dns_axis.shape[0], f.sa_axis.shape[0]
    A1, A2, KD = f.anti_axis.shape[0], f.aff_axis.shape[0], f.ipa_axis.shape[0]
    general = [name for name, on in (
        ("spread count tables", C1 or C2), ("pod-affinity count tables", A1 or A2),
        ("landing score deltas", KD), ("PreferNoSchedule scoring", has_pns),
        ("inter-pod affinity base scores", has_ipa_base)) if on]
    if general:
        raise NotImplementedError(
            "the general scan plan (" + ", ".join(general) + ") is not ported yet")
    n_act = batch_pad if n_active is None else int(n_active)
    masks = static_masks(state, f)
    if carry_in is None:
        ext0 = fresh_carry(state, f, vmax, resource_eval(
            f, fit_strategy, state.alloc_r, state.alloc_pods, state.req_r,
            state.nonzero, state.pod_count))
    else:
        ext0 = carry_in
    kernel = lap_schedule if batch_pad > SCAN_MAX_STEPS else scan_schedule
    return kernel(state, f, batch_pad, fit_strategy, ext0, masks.static_ok, n_act)
