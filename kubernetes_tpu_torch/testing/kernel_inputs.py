"""Seeded numpy inputs for the batch kernels, in the field order and dtypes
of DeviceNodeState and BatchFeatures (the JAX package's and the port's are
the same), so one draw can feed both packages and the port's kernels and
their plain versions.

The draw is a cluster of `num_nodes` live rows padded to `np_cap`, with
random allocatable/requested vectors, taints, tolerations, unschedulable
flags and selector verdicts; the keyword arguments pick the cases the
parity checks need (rotation start past a row, truncation on or off,
zero-request pods, no feasible row at all). `general_inputs` adds topology
axes and the count-table and score lanes of spread and inter-pod affinity;
`nominated_lane` draws the nominated-pod lane, `aux_lane` the counted
attach-limit lane and `victim_inputs` the preemption dry run's victim
tensors; `static_edge_inputs` and `victim_edge_inputs` draw the edges of
static_masks' and the dry run's designs (no taint or toleration, gates
off, padded taints, 1 to 64 resource slots, victims past num_nodes).
`scatter_inputs` and `patch_inputs` draw the two halves of a row patch
(the mirror's dirty rows, a carry's post-event aggregates) and
`stage_rows` stages a scatter's rows as a flush does;
`resource_edge_inputs` draws the edges of resource_eval's design (2 to
many resource slots, 0 to R fit slots, a lane on every slot, divisions off
their fast paths); `whatif_inputs` draws the descheduler's what-if batch
(the JAX package's WhatIfBatch field order).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..core.scheduler import num_feasible_nodes_to_find

GI = 1024 ** 3


def random_inputs(seed: int, np_cap: int, num_nodes: int, *, r_slots: int = 7,
                  taints: int = 4, tolerations: int = 2, start: Optional[int] = None,
                  to_find: Optional[int] = None, zero_request: bool = False,
                  infeasible: bool = False, vmax: int = 64) -> Tuple[tuple, tuple]:
    """(state arrays, feature arrays) for one batch."""
    rng = np.random.default_rng(seed)
    n, npc, R = num_nodes, np_cap, r_slots
    i32, i64 = np.int32, np.int64
    live = np.arange(npc) < n

    alloc_r = np.zeros((npc, R), i64)
    alloc_r[:, 0] = rng.choice([2000, 4000, 8000, 16000, 32000], npc)
    alloc_r[:, 1] = rng.choice([4, 8, 16, 32, 256], npc) * GI
    alloc_r[:, 2] = rng.choice([0, 100 * GI], npc)
    alloc_r[:, 3:] = rng.integers(0, 8, (npc, R - 3)) * (rng.random((npc, R - 3)) < 0.3)
    alloc_r[~live] = 0
    alloc_pods = np.where(live, rng.choice([4, 16, 110], npc), 0).astype(i64)
    frac = rng.random((npc, 1)) * 0.9
    req_r = (alloc_r * frac).astype(i64)
    pod_count = np.minimum(rng.integers(0, 12, npc), alloc_pods).astype(i32) * live
    nonzero = np.stack([req_r[:, 0] + 100 * pod_count,
                        req_r[:, 1] + 200 * 1024 * 1024 * pod_count], 1).astype(i64)
    taint_key = rng.integers(1, 4, (npc, taints)).astype(i32)
    taint_val = rng.integers(0, 3, (npc, taints)).astype(i32)
    # Effects 0 (pad), NoSchedule and NoExecute; PreferNoSchedule rarely.
    taint_eff = rng.choice([0] * 12 + [1, 3, 2], (npc, taints)).astype(i32)
    unsched = (rng.random(npc) < 0.1) & live
    valid = live.copy()
    name_id = np.where(live, np.arange(npc) + 1, 0).astype(i32)
    topo = np.zeros((4, npc), i32)
    state = (alloc_r, alloc_pods, req_r, nonzero, pod_count, taint_key, taint_val,
             taint_eff, unsched, valid, name_id, topo)

    request = np.zeros(R, i64)
    if not zero_request:
        request[0] = rng.choice([100, 250, 500, 1000])
        request[1] = rng.choice([128, 256, 512]) * 1024 * 1024
        if infeasible:
            request[0] = 10 ** 6  # more cpu than any node has
    nz_request = np.array([request[0] or 100, request[1] or 200 * 1024 * 1024], i64)
    lt = tolerations
    tol_key = rng.integers(0, 4, lt).astype(i32)
    tol_val = rng.integers(0, 3, lt).astype(i32)
    tol_eff = rng.choice([-1, 0, 1, 2, 3], lt).astype(i32)
    tol_op = rng.integers(0, 2, lt).astype(i32)
    z32, z64 = np.zeros(0, i32), np.zeros(0, i64)
    ztab = np.zeros((0, vmax), i32)
    feats = (
        request, nz_request, np.array(0 if zero_request else 1, i64),
        np.array(1 if zero_request else 0, i64),
        tol_key, tol_val, tol_eff, tol_op,
        np.array(0, i32), np.array(int(rng.integers(0, 2)), i32),
        (rng.random(npc) < 0.85) & live,              # sel_match
        np.ones(npc, bool),                           # extra_ok
        np.zeros(npc, i64), np.zeros(npc, i64),       # il_score, na_raw
        z32, z32, z64, z32, z32, z32, z32, ztab, np.zeros((0, vmax), bool),
        z32, z64, z64, z32, ztab,
        z32, z32, ztab, np.zeros(npc, i32), z32, z32, z32, ztab, np.array(0, i32),
        np.zeros(npc, i64), z32, z64,
        np.array([0, 1], i32), np.array([1, 1], i64),
        np.array([3, 1, 2, 2, 1, 2, 1], i64),
        np.array([1, 1, 1, 1, 1], i32),
        np.full(npc, 1 << 30, i32), np.array(0, i32),
        np.zeros((0, R), i64), z32,
        np.array(n, i32),
        np.array(int(rng.integers(1, max(2, n))) if start is None else start, i32),
        np.array(num_feasible_nodes_to_find(n) if to_find is None else to_find, i32),
    )
    return state, feats


# Field positions in BatchFeatures (the JAX package's order).
_F = ("request nz_request has_request ba_skip tol_key tol_val tol_eff tol_op node_name_id "
      "tolerates_unsched sel_match extra_ok il_score na_raw dns_axis dns_active dns_max_skew "
      "dns_self dns_forced0 dns_honor_aff dns_honor_taints dns_counts dns_dom sa_axis sa_wq "
      "sa_skew sa_self sa_counts anti_axis anti_self anti_counts exist_anti aff_axis aff_self "
      "aff_active aff_counts aff_own_all ipa_base ipa_axis ipa_wland fit_slots fit_weights "
      "weights enable aux_room aux_inc nom_req nom_pods num_nodes start_index to_find").split()

# Topology axes of a general draw: a zone-like axis (a few values, some
# rows without the key), a hostname-like one (one value per live row) and a
# rack-like one.
ZONE_AXIS, HOST_AXIS, RACK_AXIS = 0, 1, 2


def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length() if n > 0 else 0


def general_inputs(seed: int, np_cap: int, num_nodes: int, *, vmax: int = 256,
                   dns: int = 0, sa: int = 0, anti: int = 0, aff: int = 0, kd: int = 0,
                   pns: bool = False, ipa_base: bool = False, na: bool = False,
                   anti_axis: Optional[int] = None, dns_axis: Optional[int] = None,
                   bootstrap: bool = False, **kw) -> Tuple[tuple, tuple, Dict[str, bool]]:
    """(state arrays, feature arrays, plan facts) for one batch whose plan
    has `dns`/`sa` spread constraints, `anti`/`aff` required terms and `kd`
    landing-delta axes (each table padded to a power of two with inert
    rows), and optionally PreferNoSchedule scoring (`pns`), base
    inter-pod-affinity scores and preferred node-affinity raw scores.
    `anti_axis` pins every anti term to one axis (HOST_AXIS makes the plan
    row-local), `dns_axis` every DoNotSchedule constraint; `bootstrap`
    leaves the affinity tables empty with the pod matching its own terms.
    The hostname-like axis needs `vmax` above `num_nodes`; below, its row
    stays empty (no node has the key) and no table may name it. The facts are a dict of PlanFacts' fields (the JAX
    package's schedule_batch keyword flags)."""
    rng = np.random.default_rng(seed + 7919)
    state, feats = random_inputs(seed, np_cap, num_nodes, vmax=vmax, **kw)
    state, feats = list(state), dict(zip(_F, feats))
    n, npc = num_nodes, np_cap
    i32, i64 = np.int32, np.int64
    live = np.arange(npc) < n
    hosts = vmax > n
    assert hosts or HOST_AXIS not in (anti_axis, dns_axis), \
        "a hostname-like axis needs vmax > num_nodes"
    topo = np.zeros((4, npc), i32)
    topo[ZONE_AXIS] = np.where(rng.random(npc) < 0.95, rng.integers(1, 7, npc), 0)
    topo[HOST_AXIS] = np.arange(npc) + 1 if hosts else 0
    topo[RACK_AXIS] = rng.integers(1, 21, npc)
    topo[:, ~live] = 0
    state[11] = topo
    taint_eff = state[7]
    if not pns:
        taint_eff[taint_eff == 2] = 0
    elif not (taint_eff[live] == 2).any():
        taint_eff[0, 0] = 2

    def axes(rows: int, pinned: Optional[int] = None) -> np.ndarray:
        out = np.zeros(_pow2(rows), i32)
        if pinned is not None:
            out[:rows] = pinned
        else:
            out[:rows] = rng.choice([ZONE_AXIS, HOST_AXIS, RACK_AXIS] if hosts
                                    else [ZONE_AXIS, RACK_AXIS], rows)
        return out

    def counts(ax: np.ndarray, rows: int, hi: int, p: float) -> np.ndarray:
        t = np.zeros((ax.shape[0], vmax), i32)
        for c in range(rows):
            present = np.unique(topo[ax[c], :n])
            present = present[present > 0]
            hit = present[rng.random(present.size) < p]
            t[c, hit] = rng.integers(1, hi + 1, hit.size)
        return t

    c1 = _pow2(dns)
    f = feats
    f["dns_axis"] = axes(dns, dns_axis)
    f["dns_active"] = (np.arange(c1) < dns).astype(i32)
    f["dns_max_skew"] = np.where(np.arange(c1) < dns, rng.integers(1, 4, c1), 1 << 40).astype(i64)
    f["dns_self"] = ((np.arange(c1) < dns) & (rng.random(c1) < 0.8)).astype(i32)
    f["dns_forced0"] = np.where(np.arange(c1) < dns, rng.random(c1) < 0.25, 1).astype(i32)
    f["dns_honor_aff"] = ((np.arange(c1) < dns) & (rng.random(c1) < 0.5)).astype(i32)
    f["dns_honor_taints"] = ((np.arange(c1) < dns) & (rng.random(c1) < 0.5)).astype(i32)
    f["dns_counts"] = counts(f["dns_axis"], dns, 2, 0.5)
    dom = np.zeros((c1, vmax), bool)
    for c in range(dns):
        vids = topo[f["dns_axis"][c], :n]
        dom[c, vids[vids > 0]] = rng.random((vids > 0).sum()) < 0.97
    f["dns_dom"] = dom

    c2 = _pow2(sa)
    f["sa_axis"] = axes(sa)
    f["sa_wq"] = np.array([int(round(math.log(rng.integers(2, 60) + 2) * 1024)) if c < sa else 0
                           for c in range(c2)], i64)
    f["sa_skew"] = np.where(np.arange(c2) < sa, rng.integers(1, 3, c2), 1).astype(i64)
    f["sa_self"] = ((np.arange(c2) < sa) & (rng.random(c2) < 0.8)).astype(i32)
    f["sa_counts"] = counts(f["sa_axis"], sa, 6, 0.6)

    a1 = _pow2(anti)
    f["anti_axis"] = axes(anti, anti_axis)
    f["anti_self"] = ((np.arange(a1) < anti) & (rng.random(a1) < 0.8)).astype(i32)
    f["anti_counts"] = counts(f["anti_axis"], anti, 1,
                              0.02 if anti_axis == HOST_AXIS else 0.15)
    f["exist_anti"] = (live & (rng.random(npc) < 0.03)).astype(i32)

    a2 = _pow2(aff)
    f["aff_axis"] = axes(aff)
    f["aff_self"] = ((np.arange(a2) < aff) & (rng.random(a2) < 0.8)).astype(i32)
    f["aff_active"] = (np.arange(a2) < aff).astype(i32)
    f["aff_counts"] = (np.zeros((a2, vmax), i32) if bootstrap
                       else counts(f["aff_axis"], aff, 3, 0.5))
    if bootstrap:
        f["aff_self"] = f["aff_active"].copy()
    f["aff_own_all"] = np.array(1 if aff and (bootstrap or rng.random() < 0.5) else 0, i32)

    k = _pow2(kd)
    f["ipa_axis"] = axes(kd)
    f["ipa_wland"] = np.where(np.arange(k) < kd, rng.integers(-6, 11, k), 0).astype(i64)
    f["ipa_base"] = (np.where(live & (rng.random(npc) < 0.4), rng.integers(-20, 60, npc), 0)
                     if ipa_base else np.zeros(npc)).astype(i64)
    f["na_raw"] = (np.where(live, rng.integers(0, 4, npc) * rng.integers(1, 8, npc), 0)
                   if na else np.zeros(npc)).astype(i64)
    facts = dict(has_pns=pns, has_ipa_base=ipa_base, has_na_pref=na,
                 anti_rowlocal=anti_axis == HOST_AXIS)
    return tuple(state), tuple(f[name] for name in _F), facts


def nominated_lane(seed: int, np_cap: int, num_nodes: int, r_slots: int = 7,
                   share: float = 0.15) -> Tuple[np.ndarray, np.ndarray]:
    """(nom_req [np_cap, R] i64, nom_pods [np_cap] i32): about `share` of
    the live rows hold one to three nominated pods, some with a scalar
    resource."""
    rng = np.random.default_rng(seed + 31337)
    nom_req = np.zeros((np_cap, r_slots), np.int64)
    nom_pods = np.zeros(np_cap, np.int32)
    for row in np.nonzero(rng.random(num_nodes) < share)[0]:
        for _ in range(int(rng.integers(1, 4))):
            nom_req[row, 0] += rng.choice([250, 1000, 4000])
            nom_req[row, 1] += rng.choice([256, 1024, 4096]) * 1024 * 1024
            if rng.random() < 0.2:
                nom_req[row, 3] += 1
            nom_pods[row] += 1
    return nom_req, nom_pods


def with_nominated_lane(feats: tuple, lane: Tuple[np.ndarray, np.ndarray]) -> tuple:
    """`feats` (a feature-array tuple) with its nominated-pod lane set."""
    f = dict(zip(_F, feats))
    f["nom_req"], f["nom_pods"] = lane
    return tuple(f[name] for name in _F)


def aux_lane(seed: int, np_cap: int, num_nodes: int,
             unlimited: float = 0.1) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(aux_room [np_cap] i32, aux_inc i32 scalar, aux_cnt [np_cap] i32) of
    the counted attach-limit lane: a room of 0 to 3 attachments a live row
    (about `unlimited` of them without a limit: 1 << 30), an increment of 1
    or 2, and a carry count of 0 to 2 attachments already taken (a row may
    start over its room)."""
    rng = np.random.default_rng(seed + 65537)
    live = np.arange(np_cap) < num_nodes
    room = rng.integers(0, 4, np_cap)
    room = np.where(live & (rng.random(np_cap) < unlimited), 1 << 30, room).astype(np.int32)
    cnt = np.where(live, rng.integers(0, 3, np_cap), 0).astype(np.int32)
    return room, np.array(int(rng.integers(1, 3)), np.int32), cnt


def with_aux_lane(feats: tuple, room: np.ndarray, inc: np.ndarray) -> tuple:
    """`feats` (a feature-array tuple) with its aux_room and aux_inc set."""
    f = dict(zip(_F, feats))
    f["aux_room"], f["aux_inc"] = room, inc
    return tuple(f[name] for name in _F)


def victim_inputs(seed: int, np_cap: int, num_nodes: int, k: int, *, r_slots: int = 7,
                  **kw) -> Tuple[tuple, tuple, np.ndarray, np.ndarray]:
    """(state arrays, feature arrays, vic_req [np_cap, k, R] i64, vic_valid
    [np_cap, k] bool) for one preemption dry run: a large pod and, per live
    row, up to `k` lower-priority pods
    whose requests are part of the row's requested vector and count. Some
    rows have no victim, some slots inside a row's victims are invalid (with
    non-zero requests that must not count), some victims carry a scalar
    resource, and the random_inputs draw adds tainted, unschedulable and
    unselected rows (`infeasible=True`: a pod no removal can fit)."""
    state, feats = random_inputs(seed, np_cap, num_nodes, r_slots=r_slots, **kw)
    rng = np.random.default_rng(seed + 104729)
    state, f = list(state), dict(zip(_F, feats))
    alloc_r, alloc_pods = state[0], state[1]
    live = np.arange(np_cap) < num_nodes
    n_vic = np.where(live & (rng.random(np_cap) < 0.85), rng.integers(1, k + 1, np_cap), 0)
    vic_req = np.zeros((np_cap, k, r_slots), np.int64)
    vic_req[:, :, 0] = rng.choice([250, 500, 1000, 2000], (np_cap, k))
    vic_req[:, :, 1] = rng.choice([256, 512, 1024, 2048], (np_cap, k)) * 1024 * 1024
    scalar = (rng.random((np_cap, k)) < 0.2) & (alloc_r[:, None, 3] > 0)
    vic_req[:, :, 3] = scalar * rng.integers(1, 3, (np_cap, k))
    vic_valid = np.arange(k)[None, :] < n_vic[:, None]
    vic_req[~vic_valid] = 0
    holes = vic_valid & (rng.random((np_cap, k)) < 0.08)
    vic_valid &= ~holes  # invalid slots keep their (non-zero) requests
    other = (alloc_r * rng.random((np_cap, 1)) * 0.5).astype(np.int64)
    req_r = other + (vic_req * vic_valid[:, :, None]).sum(axis=1)
    pod_count = (rng.integers(0, 4, np_cap) + vic_valid.sum(axis=1)).astype(np.int32) * live
    state[2] = req_r * live[:, None]
    state[3] = np.stack([req_r[:, 0] + 100 * pod_count,
                         req_r[:, 1] + 200 * 1024 * 1024 * pod_count], 1).astype(np.int64)
    state[4] = pod_count
    state[1] = np.maximum(alloc_pods, np.where(live & (rng.random(np_cap) < 0.9),
                                               pod_count + 1, 0)).astype(np.int64)
    if not kw.get("infeasible") and not kw.get("zero_request"):
        f["request"] = f["request"].copy()
        f["request"][0] = rng.choice([1000, 2000, 4000])
        f["request"][1] = rng.choice([1, 2, 4]) * GI
        f["nz_request"] = f["request"][:2].copy()
    return tuple(state), tuple(f[name] for name in _F), vic_req, vic_valid


def static_edge_inputs(seed: int, np_cap: int, num_nodes: int, *, taints: int = 4,
                       tolerations: int = 2, enable_off: Tuple[int, ...] = (),
                       pad_taints: bool = False) -> Tuple[tuple, tuple]:
    """random_inputs' draw on the edges of static_masks: `taints` taint
    slots a row and `tolerations` tolerations (0 for none; a PreferNoSchedule
    taint and toleration on some rows), the gates of `enable_off` switched
    off, and `pad_taints`: every taint but a row's first padded."""
    state, feats = random_inputs(seed, np_cap, num_nodes, taints=taints,
                                 tolerations=tolerations)
    rng = np.random.default_rng(seed + 86028121)
    state, f = list(state), dict(zip(_F, feats))
    if taints:
        eff = state[7].copy()
        eff[rng.random(eff.shape) < 0.1] = 2  # PreferNoSchedule
        if pad_taints:
            eff[:, 1:] = 0
        state[7] = eff
    if tolerations:
        f["tol_eff"] = f["tol_eff"].copy()
        f["tol_eff"][0] = 2
    enable = f["enable"].copy()
    enable[list(enable_off)] = 0
    f["enable"] = enable
    f["node_name_id"] = np.array(int(rng.integers(0, num_nodes + 1)) if rng.random() < 0.5 else 0,
                                 np.int32)
    f["exist_anti"] = ((np.arange(np_cap) < num_nodes) & (rng.random(np_cap) < 0.05)).astype(
        np.int32)
    f["extra_ok"] = rng.random(np_cap) < 0.95
    return tuple(state), tuple(f[name] for name in _F)


def victim_edge_inputs(seed: int, np_cap: int, num_nodes: int, k: int, *, r_slots: int = 7,
                       past_num: bool = False, enable_off: Tuple[int, ...] = (),
                       no_request: bool = False, taints: int = 4, tolerations: int = 2,
                       pad_taints: bool = False) -> Tuple[tuple, tuple, np.ndarray, np.ndarray]:
    """victim_inputs' draw on the edges of the dry run: `r_slots` resource
    slots from 1 up (below 4 the draw keeps its first slots; past 8 the
    preemptor and some victims also request the last slot, with room for
    it on some rows), victims on the padded rows at or past num_nodes too
    (`past_num`), the gates of `enable_off` switched off, a pod without
    requests (`no_request`: has_request 0), `taints` taint slots a row and
    `tolerations` tolerations (0 for none), and `pad_taints`: every taint
    but a row's first padded."""
    R = r_slots
    state, feats, vic_req, vic_valid = victim_inputs(seed, np_cap, num_nodes, k,
                                                     r_slots=max(R, 4), taints=taints,
                                                     tolerations=tolerations)
    rng = np.random.default_rng(seed + 15485863)
    state, f = list(state), dict(zip(_F, feats))
    live = np.arange(np_cap) < num_nodes
    vic_req = np.ascontiguousarray(vic_req[:, :, :R])
    if past_num:
        more = ~live[:, None] & (rng.random((np_cap, k)) < 0.5)
        vic_req[~live] = rng.integers(1, 1000, (int((~live).sum()), k, R))
        vic_valid = vic_valid | more
    if R > 8:
        last = (rng.random((np_cap, k)) < 0.3) & vic_valid
        vic_req[:, :, R - 1] = np.where(vic_valid, last.astype(np.int64), vic_req[:, :, R - 1])
    alloc_r = np.ascontiguousarray(state[0][:, :R])
    if R > 8:
        alloc_r[:, R - 1] = np.where(live, rng.integers(0, 4, np_cap), 0)
    req_r = np.ascontiguousarray(state[2][:, :R])
    if R > 8:
        req_r[:, R - 1] = (vic_req[:, :, R - 1] * vic_valid).sum(axis=1) * live
    state[0], state[2] = alloc_r, req_r
    state[3] = np.ascontiguousarray(state[3])
    if pad_taints and taints:
        state[7] = state[7].copy()
        state[7][:, 1:] = 0
    request = np.zeros(R, np.int64)
    request[:min(R, 4)] = f["request"][:min(R, 4)]
    if R > 8:
        request[R - 1] = 1
    f["request"] = request
    if no_request:
        f["has_request"] = np.array(0, np.int64)
    enable = f["enable"].copy()
    enable[list(enable_off)] = 0
    f["enable"] = enable
    return tuple(state), tuple(f[name] for name in _F), vic_req, vic_valid


def resource_edge_inputs(seed: int, np_cap: int, num_nodes: int, *, r_slots: int = 7,
                         fit_slots: int = 2, lane: bool = False,
                         extremes: bool = True) -> Tuple[tuple, tuple]:
    """random_inputs' draw on the edges of resource_eval's design: `r_slots`
    resource slots (2 or more: cpu and memory are slots 0 and 1, which
    BalancedAllocation reads), a request on some scalar slots, `fit_slots`
    distinct slots scored (0 to R of them, weights 1 to 3), with `lane` a
    nominated-pod lane on about a fifth of the live rows with requests on
    every slot, and with `extremes` a sixteenth of the live rows at an
    allocatable of 0, 1 or 3 cpu and memory under non-zero aggregates near
    2^40, so that quotients pass 2^50 and numerators 2^31 (the floored
    division's slow paths)."""
    R = r_slots
    state, feats = random_inputs(seed, np_cap, num_nodes, r_slots=max(R, 4))
    rng = np.random.default_rng(seed + 15485863)
    state, f = list(state), dict(zip(_F, feats))
    state[0] = np.ascontiguousarray(state[0][:, :R])
    state[2] = np.ascontiguousarray(state[2][:, :R])
    request = f["request"][:R].copy()
    if R > 2:
        request[2:] = rng.integers(0, 3, R - 2) * (rng.random(R - 2) < 0.5)
    f["request"] = request
    f["fit_slots"] = rng.permutation(R)[:fit_slots].astype(np.int32)
    f["fit_weights"] = rng.integers(1, 4, fit_slots).astype(np.int64)
    if extremes and num_nodes:
        rows = rng.choice(num_nodes, max(1, num_nodes // 16), replace=False)
        for slot in (0, 1):
            state[0][rows, slot] = rng.choice([0, 1, 3], rows.size)
            state[3][rows, slot] = rng.integers(1 << 30, 1 << 40, rows.size)
    if lane:
        live = np.arange(np_cap) < num_nodes
        held = live & (rng.random(np_cap) < 0.2)
        f["nom_req"] = (state[0] * rng.random((np_cap, R)) * 0.5).astype(np.int64) * held[:, None]
        f["nom_pods"] = (rng.integers(1, 4, np_cap) * held).astype(np.int32)
    return tuple(state), tuple(f[name] for name in _F)


def scatter_inputs(seed: int, np_cap: int, d: int, *, r_slots: int = 7, taints: int = 4,
                   axes: int = 4, order: str = "sorted",
                   block_rows: int = 64) -> Tuple[tuple, np.ndarray, tuple]:
    """(state arrays, at [d] i64, rows arrays) of one dirty-row scatter: a
    state of `np_cap` rows at the widths given and `d` distinct rows of
    another draw (each field's rows, topo's as [axes, d]) to write at `at`.
    The rows include the first and the last row of a `block_rows` range
    and of the state where `d` allows; `order` "sorted" or "shuffled"."""
    rng = np.random.default_rng(seed)
    n, R, T = np_cap, r_slots, taints

    def draw():
        return (rng.integers(0, 1 << 40, (n, R)), rng.integers(0, 110, n),
                rng.integers(0, 1 << 40, (n, R)), rng.integers(0, 1 << 40, (n, 2)),
                rng.integers(0, 110, n).astype(np.int32),
                *[rng.integers(0, 9, (n, T)).astype(np.int32) for _ in range(3)],
                rng.random(n) < 0.5, rng.random(n) < 0.5,
                rng.integers(0, 1 << 30, n).astype(np.int32),
                rng.integers(0, 50, (axes, n)).astype(np.int32))

    state, src = draw(), draw()
    edges = list(dict.fromkeys((block_rows - 1, 0, block_rows, n - 1,
                                min(2 * block_rows - 1, n - 1))))[:d]
    rest = rng.permutation(np.setdiff1d(np.arange(n), edges))[:d - len(edges)]
    at = np.concatenate([edges, rest]).astype(np.int64)
    at = np.sort(at) if order == "sorted" else rng.permutation(at)
    return state, at, tuple(a[at] for a in src[:-1]) + (src[-1][:, at],)


def stage_rows(rows, at, ring=None):
    """(idx [d] i32, packed) of the rows `rows` (each field's d rows,
    topo's as [K, d], numpy arrays or CPU tensors) written at `at`, staged
    as a flush stages them (kernel.stage_scatter: one buffer of `ring`, by
    default a new StagingRing on the CPU, one upload)."""
    from ..ops.kernel import stage_scatter
    from ..ops.staging import StagingRing

    host = [np.ascontiguousarray(np.asarray(a)) for a in rows]
    return stage_scatter(ring or StagingRing("cpu"), host[:-1], host[-1],
                         np.arange(host[0].shape[0]), at=np.asarray(at))


def patch_inputs(seed: int, state: tuple, num_nodes: int, k: int,
                 tier: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(idx [tier] i32, req_rows [tier, R] i64, nz_rows [tier, 2] i64,
    cnt_rows [tier] i32) of one carry delta patch: `k` distinct live rows of
    `state` (the random_inputs arrays) with post-event aggregates — pods
    removed from some rows, added to others, some rows emptied or filled to
    their pod cap — padded to `tier` with copies of the last real row, as
    the scheduler pads a patch tier."""
    rng = np.random.default_rng(seed + 7919)
    alloc_r, alloc_pods, req_r, pod_count = state[0], state[1], state[2], state[4]
    rows = np.sort(rng.choice(num_nodes, size=k, replace=False))
    scale = rng.choice([0.0, 0.3, 1.0, 1.4], (k, 1))
    req_rows = np.minimum((req_r[rows] * scale).astype(np.int64) + rng.integers(0, 2, (k, 1))
                          * (alloc_r[rows] // 8), alloc_r[rows] * 2)
    cnt_rows = np.where(scale[:, 0] == 1.4, alloc_pods[rows],
                        (pod_count[rows] * scale[:, 0]).astype(np.int64)).astype(np.int32)
    nz_rows = np.stack([req_rows[:, 0] + 100 * cnt_rows,
                        req_rows[:, 1] + 200 * 1024 * 1024 * cnt_rows], 1).astype(np.int64)
    pad = tier - k
    return (np.concatenate([rows, np.full(pad, rows[-1])]).astype(np.int32),
            np.concatenate([req_rows, np.repeat(req_rows[-1:], pad, 0)]),
            np.concatenate([nz_rows, np.repeat(nz_rows[-1:], pad, 0)]),
            np.concatenate([cnt_rows, np.repeat(cnt_rows[-1:], pad)]))


def placement_inputs(seed: int, np_cap: int, num_nodes: int, lanes: int, *, vmax: int = 256,
                     dns: int = 0, sa: int = 0, overrides: bool = False, pns: bool = False,
                     na: bool = False, **kw):
    """(state arrays, feature arrays, plan facts, masks [lanes, np_cap]
    bool, spread overrides or None) for one stacked placement evaluation:
    a general_inputs draw with `dns`/`sa` spread tables and no inter-pod
    affinity (the placement restriction), and one row mask per lane — lane
    0 empty (a padded lane), lane 1 a single row, lane 2 about 100 rows,
    the last every live row, the others random subsets (a lane count of 1
    is the every-row lane). `overrides` draws each lane's own dns_counts,
    dns_dom, dns_forced0, sa_counts and sa_wq over its rows (padded table
    rows: forced0 1, sa_wq 0)."""
    state, feats, facts = general_inputs(seed, np_cap, num_nodes, vmax=vmax, dns=dns, sa=sa,
                                         pns=pns, na=na, **kw)
    rng = np.random.default_rng(seed + 15485863)
    n = num_nodes
    masks = np.zeros((lanes, np_cap), bool)
    for p in range(lanes):
        if p == lanes - 1:
            masks[p, :n] = True
        elif p == 0:
            continue
        elif p == 1:
            masks[p, rng.integers(0, n)] = True
        elif p == 2:
            masks[p, rng.choice(n, size=min(100, n), replace=False)] = True
        else:
            masks[p, :n] = rng.random(n) < rng.choice([0.1, 0.3, 0.6])
    if not overrides:
        return state, feats, facts, masks, None
    f = dict(zip(_F, feats))
    topo = state[11]
    c1, c2 = f["dns_axis"].shape[0], f["sa_axis"].shape[0]
    dns_counts = np.zeros((lanes, c1, vmax), np.int32)
    dns_dom = np.zeros((lanes, c1, vmax), bool)
    dns_forced0 = np.ones((lanes, c1), np.int32)
    sa_counts = np.zeros((lanes, c2, vmax), np.int32)
    sa_wq = np.zeros((lanes, c2), np.int64)
    for p in range(lanes):
        rows = np.nonzero(masks[p, :n])[0]
        for c in range(dns):
            vids = topo[f["dns_axis"][c], rows]
            vids = vids[vids > 0]
            dns_dom[p, c, vids] = rng.random(vids.size) < 0.95
            np.add.at(dns_counts[p, c], vids, rng.integers(0, 3, vids.size).astype(np.int32))
            dns_forced0[p, c] = int(rng.random() < 0.2 or not dns_dom[p, c].any())
        for c in range(sa):
            vids = topo[f["sa_axis"][c], rows]
            np.add.at(sa_counts[p, c], vids, rng.integers(0, 4, vids.size).astype(np.int32))
            sa_wq[p, c] = int(round(math.log(np.unique(vids).size + 2) * 1024))
    return state, feats, facts, masks, (dns_counts, dns_dom, dns_forced0, sa_counts, sa_wq)


TIB = 1024 ** 4


def whatif_inputs(seed: int, P: int, N: int, R: int = 3, *, huge: bool = False,
                  negative: bool = False, src_rows: Optional[Sequence[int]] = None) -> tuple:
    """The nine arrays of a what-if batch (alloc_r, alloc_pods, req_r,
    nonzero, pod_count, request, nz_request, src, mask), drawn as the JAX
    package's descheduler fuzz draws them (tests/test_descheduler.py:87-104).
    `huge` gives every third node 16 TiB of memory with 12 TiB or more of it
    requested, so that `used * BA_SCALE` passes 2^63 and wraps; `negative`
    negates the non-zero and requested aggregates of every other node,
    which encode_batch never makes but the function defines (floored
    division of negative numerators). `src_rows`: the candidates' source
    rows cycle through these (each clipped to [0, N)), where a design's
    tile edges lie."""
    rng = np.random.default_rng(seed)
    alloc_r = rng.integers(0, 64_000, (N, R)).astype(np.int64)
    alloc_pods = rng.integers(1, 40, N).astype(np.int64)
    req_r = np.minimum(rng.integers(0, 48_000, (N, R)).astype(np.int64), alloc_r)
    nonzero = np.maximum(req_r[:, :2], 1)
    pod_count = rng.integers(0, 20, N).astype(np.int64)
    request = rng.integers(0, 8_000, (P, R)).astype(np.int64)
    nz_request = np.maximum(request[:, :2], 100)
    src = rng.integers(0, max(N, 1), P).astype(np.int64)
    mask = rng.random((P, N)) < 0.9
    if huge:
        rows = np.arange(0, N, 3)
        alloc_r[rows, 1] = 16 * TIB
        req_r[rows, 1] = 12 * TIB + rng.integers(0, 4 * TIB, rows.size)
        nonzero[rows, 1] = req_r[rows, 1]
        request[:, 1] = rng.integers(0, 64 << 30, P)
        nz_request[:, 1] = np.maximum(request[:, 1], 100)
    if negative:
        rows = np.arange(0, N, 2)
        nonzero[rows] = -nonzero[rows]
        req_r[rows] = -req_r[rows]
    if src_rows is not None and P and N:
        src = np.resize(np.clip(np.asarray(src_rows, np.int64), 0, N - 1), P)
    return alloc_r, alloc_pods, req_r, nonzero, pod_count, request, nz_request, src, mask
