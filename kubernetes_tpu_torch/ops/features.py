"""Per-batch pod feature extraction for the device kernels.

A *batch* is a row-block of consecutive same-signature pending pods
(identical scheduling-relevant spec — the reference's OpportunisticBatching
signatures, runtime/batch.go:33, generalized to kernel batches). Every pod
in the batch is identical, so the per-node static verdicts (node selector,
taints) are computed once here on the host; the sequential dependence —
each placement changing the node the next pod sees — runs on the device in
the kernels' carry (ops/kernel.py).

`BatchFeatures` keeps every field of the JAX package's BatchFeatures, in its
order and dtypes, so the two can be fed identical inputs. Lanes this slice
never fills (spread, pod affinity, preferred terms, images, host ports,
counted claims, nominated pods) are zero-length tables or zero vectors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..api import resource as res
from ..api.types import Pod, find_matching_untolerated_taint
from ..core.framework import Diagnosis, Status
from ..core.node_info import NodeInfo
from ..core.scheduler import num_feasible_nodes_to_find
from ..plugins.basic import UNSCHED_TAINT
from .codebook import EFFECT_IDS, EFFECT_PREFER_NO_SCHEDULE, OP_EQUAL, OP_EXISTS
from .device_state import NodeStateMirror


def _pow2(n: int, floor: int = 1) -> int:
    if n <= 0:
        return 0
    c = floor
    while c < n:
        c *= 2
    return c


class BatchFeatures(NamedTuple):
    """Kernel inputs for one batch. Count tables are [*, VMAX]; VMAX and
    every leading dimension are power-of-two tiers, as in the JAX package."""

    # resources
    request: torch.Tensor          # [R] i64
    nz_request: torch.Tensor       # [2] i64 (cpu/mem with non-zero defaults)
    has_request: torch.Tensor      # i64 scalar (0 => all-zero request)
    ba_skip: torch.Tensor          # i64 scalar (BalancedAllocation PreScore skip)
    # tolerations (pad eff = -1 rows never tolerate)
    tol_key: torch.Tensor          # [LT] i32
    tol_val: torch.Tensor          # [LT] i32
    tol_eff: torch.Tensor          # [LT] i32
    tol_op: torch.Tensor           # [LT] i32
    # cheap filters
    node_name_id: torch.Tensor     # i32 (0 = unset)
    tolerates_unsched: torch.Tensor  # i32
    sel_match: torch.Tensor        # [NP] bool node selector + required affinity
    extra_ok: torch.Tensor         # [NP] bool (all true in the slice)
    # static score inputs (zero in the slice)
    il_score: torch.Tensor         # [NP] i64
    na_raw: torch.Tensor           # [NP] i64
    # PodTopologySpread DoNotSchedule (zero-length in the slice)
    dns_axis: torch.Tensor         # [C1] i32
    dns_active: torch.Tensor       # [C1] i32
    dns_max_skew: torch.Tensor     # [C1] i64
    dns_self: torch.Tensor         # [C1] i32
    dns_forced0: torch.Tensor      # [C1] i32
    dns_honor_aff: torch.Tensor    # [C1] i32
    dns_honor_taints: torch.Tensor  # [C1] i32
    dns_counts: torch.Tensor       # [C1, V] i32
    dns_dom: torch.Tensor          # [C1, V] bool
    # PodTopologySpread ScheduleAnyway (zero-length in the slice)
    sa_axis: torch.Tensor          # [C2] i32
    sa_wq: torch.Tensor            # [C2] i64
    sa_skew: torch.Tensor          # [C2] i64
    sa_self: torch.Tensor          # [C2] i32
    sa_counts: torch.Tensor        # [C2, V] i32
    # InterPodAffinity required (zero-length in the slice)
    anti_axis: torch.Tensor        # [A1] i32
    anti_self: torch.Tensor        # [A1] i32
    anti_counts: torch.Tensor      # [A1, V] i32
    exist_anti: torch.Tensor       # [NP] i32
    aff_axis: torch.Tensor         # [A2] i32
    aff_self: torch.Tensor         # [A2] i32
    aff_active: torch.Tensor       # [A2] i32
    aff_counts: torch.Tensor       # [A2, V] i32
    aff_own_all: torch.Tensor      # i32
    # InterPodAffinity scoring (zero in the slice)
    ipa_base: torch.Tensor         # [NP] i64
    ipa_axis: torch.Tensor         # [KD] i32
    ipa_wland: torch.Tensor        # [KD] i64
    # Fit / BalancedAllocation scoring config
    fit_slots: torch.Tensor        # [FR] i32 resource slot per scored resource
    fit_weights: torch.Tensor      # [FR] i64
    # plugin weights: [tt, fit, pts, ipa, ba, na, il]
    weights: torch.Tensor          # [7] i64
    # filter enablement:
    # [NodeName, NodeUnschedulable, TaintToleration, NodeAffinity, NodeResourcesFit]
    enable: torch.Tensor           # [5] i32
    # counted aux constraint (unused in the slice)
    aux_room: torch.Tensor         # [NP] i32
    aux_inc: torch.Tensor          # i32
    # nominated-pod lane (empty in the slice)
    nom_req: torch.Tensor          # [0, R] i64
    nom_pods: torch.Tensor         # [0] i32
    # sampling / loop
    num_nodes: torch.Tensor        # i32
    start_index: torch.Tensor      # i32
    to_find: torch.Tensor          # i32


def features_from_jax_numpy(arrays: Sequence[np.ndarray], device="cpu") -> BatchFeatures:
    """The JAX package's BatchFeatures, fetched field by field with
    np.asarray, as the port's tensors (same layout, same dtypes)."""
    return BatchFeatures(*[torch.from_numpy(np.array(a)).to(device) for a in arrays])


@dataclass
class BatchPlan:
    """A built batch: kernel inputs + the host-known plan facts that pick
    the kernel path (ops/kernel.py schedule_batch)."""

    features: BatchFeatures
    batch_pad: int                # steps (>= len(pods))
    fit_strategy: int             # 0 = LeastAllocated, 1 = MostAllocated
    vmax: int
    has_pns: bool = False         # any PreferNoSchedule taint staged


class Unsupported(Exception):
    """Pod needs the host path (the JAX package's batch_supported)."""


def batch_supported(pod: Pod) -> Optional[str]:
    """A reason string when the pod must take the host path, else None.
    matchFields metadata.name pins narrow the node list in PreFilter
    (node_affinity.go), which the kernels' full-cluster rotation cannot
    reproduce — and the narrowed universe is tiny."""
    na = pod.affinity.node_affinity if pod.affinity is not None else None
    if na is not None and na.required is not None:
        if any(t.match_fields for t in na.required.terms):
            return "node-affinity metadata.name narrowing"
    return None


def _resource_vec(mirror: NodeStateMirror, r: "res.Resource") -> np.ndarray:
    out = np.zeros(mirror.r_slots, np.int64)
    out[0] = r.milli_cpu
    out[1] = r.memory
    out[2] = r.ephemeral_storage
    for name, amount in r.scalar_resources.items():
        out[mirror.scalar_slot(name)] = amount
    return out


def _batch_tier(n: int) -> int:
    """Coarse step-count tiers {8, 64, 512, 1024, ...} (the JAX package's
    compile tiers; padded steps are inert)."""
    if n <= 8:
        return 8
    if n <= 64:
        return 64
    return _pow2(n, 512)


def build_batch(pod: Pod, batch_size: int, mirror: NodeStateMirror, snapshot, *,
                percentage_of_nodes_to_score: int = 0, start_index: int = 0,
                weights: Tuple[int, ...] = (3, 1, 0, 0, 1, 0, 0),
                filters_on: Tuple[bool, ...] = (True, True, True, True, True),
                fit_plugin=None) -> BatchPlan:
    """Build kernel inputs for a batch of `batch_size` pods identical to
    `pod`. `mirror` must already be synced to `snapshot`."""
    reason = batch_supported(pod)
    if reason:
        raise Unsupported(reason)
    nodes: List[NodeInfo] = snapshot.node_info_list
    n = len(nodes)
    i32, i64 = np.int32, np.int64
    dev = mirror.device

    # Scalar-resource slots intern before any vector is built: interning can
    # grow the slot tier, which resets staging (re-synced below).
    req = pod.resource_request()
    for name in req.scalar_resources:
        mirror.scalar_slot(name)
    if fit_plugin is not None:
        specs = fit_plugin.resources
        strategy = {"LeastAllocated": 0, "MostAllocated": 1}[fit_plugin.scoring_strategy]
    else:
        specs = ({"name": res.CPU, "weight": 1}, {"name": res.MEMORY, "weight": 1})
        strategy = 0
    slot_of = {res.CPU: 0, res.MEMORY: 1, res.EPHEMERAL_STORAGE: 2}
    for spec in specs:
        if spec["name"] not in slot_of and spec["name"] != res.PODS:
            mirror.scalar_slot(spec["name"])
    if mirror._full_flush:
        mirror.sync(nodes)

    npc = mirror.np_cap
    r = mirror.r_slots
    tols = pod.tolerations
    lt = _pow2(len(tols))
    tol_key = np.zeros(lt, i32)
    tol_val = np.zeros(lt, i32)
    tol_eff = np.full(lt, -1, i32)  # pad: never tolerates
    tol_op = np.zeros(lt, i32)
    for j, t in enumerate(tols):
        tol_key[j] = mirror.keys.intern(t.key)
        tol_val[j] = mirror.vals.intern(t.value)
        tol_eff[j] = EFFECT_IDS.get(t.effect, 0)
        tol_op[j] = OP_EXISTS if t.operator == "Exists" else OP_EQUAL
    node_name_id = mirror.names.lookup(pod.node_name) if pod.node_name else 0
    if pod.node_name and node_name_id == -1:
        node_name_id = -2  # requested node not in the snapshot: nothing matches
    sel_match = np.zeros(npc, bool)
    sel_match[:n] = [pod.required_node_selector_matches(ni.node) for ni in nodes]

    fr = _pow2(len(specs))
    fit_slots = np.zeros(fr, i32)
    fit_weights = np.zeros(fr, i64)  # pad weight 0: excluded
    for j, spec in enumerate(specs):
        name = spec["name"]
        fit_slots[j] = slot_of[name] if name in slot_of else mirror.scalar_slot(name)
        fit_weights[j] = spec.get("weight", 1)

    vmax = 64  # the JAX tier floor: the slice registers no topology axes
    z32 = np.zeros(0, i32)
    z64 = np.zeros(0, i64)
    ztab = np.zeros((0, vmax), i32)
    host = dict(
        request=_resource_vec(mirror, req),
        nz_request=np.array([req.milli_cpu or NodeInfo.DEFAULT_MILLI_CPU,
                             req.memory or NodeInfo.DEFAULT_MEMORY], i64),
        has_request=np.array(0 if req.is_zero() else 1, i64),
        ba_skip=np.array(1 if (req.milli_cpu == 0 and req.memory == 0) else 0, i64),
        tol_key=tol_key, tol_val=tol_val, tol_eff=tol_eff, tol_op=tol_op,
        node_name_id=np.array(node_name_id, i32),
        tolerates_unsched=np.array(
            1 if any(t.tolerates(UNSCHED_TAINT) for t in tols) else 0, i32),
        sel_match=sel_match,
        extra_ok=np.ones(npc, bool),
        il_score=np.zeros(npc, i64), na_raw=np.zeros(npc, i64),
        dns_axis=z32, dns_active=z32, dns_max_skew=z64, dns_self=z32,
        dns_forced0=z32, dns_honor_aff=z32, dns_honor_taints=z32,
        dns_counts=ztab, dns_dom=np.zeros((0, vmax), bool),
        sa_axis=z32, sa_wq=z64, sa_skew=z64, sa_self=z32, sa_counts=ztab,
        anti_axis=z32, anti_self=z32, anti_counts=ztab,
        exist_anti=np.zeros(npc, i32),
        aff_axis=z32, aff_self=z32, aff_active=z32, aff_counts=ztab,
        aff_own_all=np.array(0, i32),
        ipa_base=np.zeros(npc, i64), ipa_axis=z32, ipa_wland=z64,
        fit_slots=fit_slots, fit_weights=fit_weights,
        weights=np.array(weights, i64),
        enable=np.array([1 if b else 0 for b in filters_on], i32),
        aux_room=np.full(npc, 1 << 30, i32), aux_inc=np.array(0, i32),
        nom_req=np.zeros((0, r), i64), nom_pods=z32,
        num_nodes=np.array(n, i32),
        start_index=np.array(start_index % max(1, n), i32),
        to_find=np.array(num_feasible_nodes_to_find(n, percentage_of_nodes_to_score), i32),
    )
    feats = BatchFeatures(**{k: torch.from_numpy(v).to(dev) for k, v in host.items()})
    return BatchPlan(
        features=feats, batch_pad=_batch_tier(batch_size), fit_strategy=strategy,
        vmax=vmax,
        has_pns=bool((mirror.h_taint_eff[:n] == EFFECT_PREFER_NO_SCHEDULE).any()))


def diagnose_unschedulable(pod: Pod, mirror: NodeStateMirror, snapshot, fw) -> Optional[Diagnosis]:
    """Per-node failure Diagnosis for a pod the device found infeasible
    everywhere, vectorized over the mirror's staging arrays instead of the
    per-node Python filter loop. Verdicts and plugin attributions match the
    host plugins in profile filter order."""
    nodes: List[NodeInfo] = snapshot.node_info_list
    n = len(nodes)
    if n == 0:
        return None
    names = {p.name for p in fw.filter_plugins}
    checks: List[Tuple[str, bool, np.ndarray, str]] = []
    if "NodeName" in names and pod.node_name:
        checks.append(("NodeName", True,
                       np.array([ni.name != pod.node_name for ni in nodes]),
                       "node(s) didn't match the requested node name"))
    if "NodeUnschedulable" in names:
        unsched = mirror.h_unsched[:n].copy()
        if any(t.tolerates(UNSCHED_TAINT) for t in pod.tolerations):
            unsched[:] = False
        checks.append(("NodeUnschedulable", True, unsched, "node(s) were unschedulable"))
    if "TaintToleration" in names:
        fails = np.zeros(n, bool)
        for r_i in np.nonzero((mirror.h_taint_eff[:n] != 0).any(axis=1))[0]:
            fails[r_i] = find_matching_untolerated_taint(
                nodes[r_i].node.taints, pod.tolerations) is not None
        checks.append(("TaintToleration", True, fails, "node(s) had untolerated taint(s)"))
    if "NodeAffinity" in names and (
            pod.node_selector or (pod.affinity and pod.affinity.node_affinity
                                  and pod.affinity.node_affinity.required)):
        checks.append(("NodeAffinity", True,
                       np.array([not pod.required_node_selector_matches(ni.node)
                                 for ni in nodes]),
                       "node(s) didn't match Pod's node affinity/selector"))
    if "NodeResourcesFit" in names:
        req_vec = _resource_vec(mirror, pod.resource_request())
        alloc = mirror.h_alloc_r[:n]
        pos = req_vec > 0
        insufficient = (req_vec[None, :] > (alloc - mirror.h_req_r[:n])) & pos[None, :]
        over_capacity = (req_vec[None, :] > alloc) & pos[None, :]
        pods_full = (mirror.h_pod_count[:n] + 1) > mirror.h_alloc_pods[:n]
        # Unresolvable when the request exceeds allocatable outright.
        checks.append(("NodeResourcesFit", True, over_capacity.any(axis=1),
                       "Insufficient resources (request exceeds allocatable)"))
        checks.append(("NodeResourcesFit", False, insufficient.any(axis=1) | pods_full,
                       "Insufficient resources"))
    if not checks:
        return None
    fail_stack = np.stack([c[2] for c in checks])          # [C, n]
    if not fail_stack.any(axis=0).all():
        return None  # some node passes every static filter: not our case
    first = np.argmax(fail_stack, axis=0)                  # first failing check
    statuses = []
    for plugin, unresolvable, _f, msg in checks:
        st = Status.unresolvable(msg) if unresolvable else Status.unschedulable(msg)
        st.plugin = plugin
        statuses.append(st)
    diag = Diagnosis()
    diag.unschedulable_plugins = {checks[ci][0] for ci in set(first.tolist())}
    for r_i, ni in enumerate(nodes):
        diag.node_to_status[ni.name] = statuses[int(first[r_i])]
    return diag
