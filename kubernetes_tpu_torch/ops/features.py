"""Per-batch pod feature extraction for the device kernels.

A *batch* is a row-block of consecutive same-signature pending pods
(identical scheduling-relevant spec — the reference's OpportunisticBatching
signatures, runtime/batch.go:33, generalized to kernel batches). Every pod
in the batch is identical, so the per-node static verdicts (node selector,
taints) are computed once here on the host; the sequential dependence —
each placement changing the node the next pod sees — runs on the device in
the kernels' carry (ops/kernel.py).

The expensive O(all pods) PreFilter aggregations of PodTopologySpread
(filtering.go:241 calPreFilterState) and InterPodAffinity (filtering.go:287)
are computed once per batch here, as per-domain count tables over the
mirror's topology axes; each landing's effect on them runs in the kernels'
carry.

The nominated-pod lane (`nom_req`/`nom_pods`) holds, per row, the requests
and count of the pods a preemption nominated there with a priority at least
the batch pod's: pass one of the two-pass filter, for resources only. It is
zero-length when no such pod exists. `build_preemption_victims` builds the
preemption dry run's victim tensors.

`extra_ok` folds in the static filters of NodeDeclaredFeatures (the pod's
required features) and NodePorts (conflicts with the host ports of the pods
already on a node); `il_score` is ImageLocality's static score. A pod with
host ports always conflicts with an identical pod, so its plan carries
`port_selfblock`: a landing blocks its row for the rest of the session (the
kernels' `blocked` lane).

A pod whose PVC-backed volumes impose one counted CSI attach limit
(volume_device_support) carries the counted aux lane: `aux_room` is, per
row, the attachments the driver's CSINode limit leaves (`AUX_BIG` on a row
without a limit), `aux_inc` the attachments one pod adds, and the plan's
`has_aux` turns on the kernels' `aux_cnt` lane, which counts each
landing's attachments against the row's room. A claim-template pod under
a profile with DynamicResources (dra_device_support: one unallocated,
unshared claim of one request) rides the same lane: `aux_room` is the
row's free devices that the request matches
(count_free_matching_devices), `aux_inc` the request's count.

`BatchFeatures` keeps every field of the JAX package's BatchFeatures, in its
order and dtypes, so the two can be fed identical inputs.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..api import resource as res
from ..api.dra import compile_device_expression
from ..api.storage import RWOP
from ..api.types import (
    DO_NOT_SCHEDULE,
    HONOR,
    LABEL_HOSTNAME,
    SCHEDULE_ANYWAY,
    Pod,
    find_matching_untolerated_taint,
)
from ..core.framework import Diagnosis, Status
from ..core.node_info import NodeInfo, PodInfo
from ..core.scheduler import num_feasible_nodes_to_find
from ..plugins.basic import UNSCHED_TAINT, ImageLocality, host_ports_conflict
from ..plugins.dynamicresources import class_selectors, matching_devices
from ..plugins.extras import required_features
from ..plugins.helpers import compile_terms
from ..plugins.podtopologyspread import _compile_constraints, _count_pods_matching
from ..plugins.volumes import VolumeZone
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
    extra_ok: torch.Tensor         # [NP] bool NodeDeclaredFeatures and NodePorts
    # static score inputs
    il_score: torch.Tensor         # [NP] i64 ImageLocality
    na_raw: torch.Tensor           # [NP] i64 preferred-node-affinity raw sum
    # PodTopologySpread DoNotSchedule
    dns_axis: torch.Tensor         # [C1] i32 axis row in state.topo
    dns_active: torch.Tensor       # [C1] i32 (0 = padding row, never rejects)
    dns_max_skew: torch.Tensor     # [C1] i64
    dns_self: torch.Tensor         # [C1] i32 selector matches the batch pod itself
    dns_forced0: torch.Tensor      # [C1] i32 min-match forced to 0 (minDomains)
    dns_honor_aff: torch.Tensor    # [C1] i32 nodeAffinityPolicy == Honor
    dns_honor_taints: torch.Tensor  # [C1] i32 nodeTaintsPolicy == Honor
    dns_counts: torch.Tensor       # [C1, V] i32
    dns_dom: torch.Tensor          # [C1, V] bool eligible-domain mask
    # PodTopologySpread ScheduleAnyway
    sa_axis: torch.Tensor          # [C2] i32
    sa_wq: torch.Tensor            # [C2] i64 round(log(size+2)*1024)
    sa_skew: torch.Tensor          # [C2] i64
    sa_self: torch.Tensor          # [C2] i32
    sa_counts: torch.Tensor        # [C2, V] i32
    # InterPodAffinity required
    anti_axis: torch.Tensor        # [A1] i32
    anti_self: torch.Tensor        # [A1] i32
    anti_counts: torch.Tensor      # [A1, V] i32 (own anti terms vs existing pods)
    exist_anti: torch.Tensor       # [NP] i32 existing pods' anti-affinity hits
    aff_axis: torch.Tensor         # [A2] i32
    aff_self: torch.Tensor         # [A2] i32
    aff_active: torch.Tensor       # [A2] i32 (0 = padding row, auto-pass)
    aff_counts: torch.Tensor       # [A2, V] i32
    aff_own_all: torch.Tensor      # i32 the pod matches all its own terms
    # InterPodAffinity scoring
    ipa_base: torch.Tensor         # [NP] i64 preferred/existing-term base score
    ipa_axis: torch.Tensor         # [KD] i32
    ipa_wland: torch.Tensor        # [KD] i64 score delta per landing at axis value
    # Fit / BalancedAllocation scoring config
    fit_slots: torch.Tensor        # [FR] i32 resource slot per scored resource
    fit_weights: torch.Tensor      # [FR] i64
    # plugin weights: [tt, fit, pts, ipa, ba, na, il]
    weights: torch.Tensor          # [7] i64
    # filter enablement:
    # [NodeName, NodeUnschedulable, TaintToleration, NodeAffinity, NodeResourcesFit]
    enable: torch.Tensor           # [5] i32
    # counted aux constraint (a CSI attach limit)
    aux_room: torch.Tensor         # [NP] i32 (AUX_BIG: no limit on the row)
    aux_inc: torch.Tensor          # i32 (0: no counted constraint)
    # nominated-pod lane ([0, R] and [0] when no pod is nominated)
    nom_req: torch.Tensor          # [NP, R] i64
    nom_pods: torch.Tensor         # [NP] i32
    # sampling / loop
    num_nodes: torch.Tensor        # i32
    start_index: torch.Tensor      # i32
    to_find: torch.Tensor          # i32


def features_from_jax_numpy(arrays: Sequence[np.ndarray], device="cpu") -> BatchFeatures:
    """The JAX package's BatchFeatures, fetched field by field with
    np.asarray, as the port's tensors (same layout, same dtypes)."""
    return BatchFeatures(*[torch.from_numpy(np.array(a)).to(device) for a in arrays])


def victims_from_jax_numpy(vic_req: np.ndarray, vic_valid: np.ndarray,
                          device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's dry-run victim arrays (build_preemption_victims'
    vic_req [NP, K, R] i64 and vic_valid [NP, K] bool) as the port's
    tensors. The nominated-pod lane rides BatchFeatures
    (features_from_jax_numpy)."""
    return (torch.from_numpy(np.array(vic_req)).to(device),
            torch.from_numpy(np.array(vic_valid)).to(device))


class PlanFacts(NamedTuple):
    """The host-known batch facts that pick the kernel path and its lanes
    (ops/kernel.py schedule_batch; the JAX package's static arguments of
    the same names)."""

    has_pns: bool = False         # any PreferNoSchedule taint staged
    has_ipa_base: bool = False    # any nonzero inter-pod-affinity base score
    # Every required anti-affinity term is keyed to a singleton-per-node
    # axis (kubernetes.io/hostname-like): a landing blocks only its own row.
    anti_rowlocal: bool = False
    has_na_pref: bool = False     # the pod has preferred node-affinity terms
    # The pod requests host ports: a landing occupies them, so the landed
    # row blocks itself for the rest of the session (identical pods always
    # conflict with each other's ports). Row-local: the lap stays exact.
    port_selfblock: bool = False
    # The pod's claims count against one CSI driver's attach limit: each
    # landing adds aux_inc to its row's aux_cnt, which must stay within the
    # row's aux_room. Row-local: the lap stays exact.
    has_aux: bool = False


@dataclass
class BatchPlan:
    """A built batch: kernel inputs + the host-known plan facts."""

    features: BatchFeatures
    batch_pad: int                # steps (>= len(pods))
    fit_strategy: int             # 0 = LeastAllocated, 1 = MostAllocated
    vmax: int
    facts: PlanFacts = PlanFacts()
    # No pod-derived coupling anywhere in the plan (no count tables, landing
    # deltas, base scores or existing-pod anti hits): a pod arriving on or
    # leaving node n changes only row n's aggregates.
    pod_local: bool = False
    # The spread tables' per-node columns (snapshot rows), from which a
    # placement evaluation rebuilds each placement's restricted tables
    # (models/tpu_scheduler.py _placement_spread_overrides); None without
    # such constraints.
    dns_node_counts: Optional[np.ndarray] = None   # [C1, n] i32 matching pods
    dns_node_elig: Optional[np.ndarray] = None     # [C1, n] bool key and policies
    dns_min_domains: Optional[list] = None         # minDomains per C1 row
    sa_node_counts: Optional[np.ndarray] = None    # [C2, n] i32
    sa_node_live: Optional[np.ndarray] = None      # [n] bool (not ignored)
    sa_hostname_axis: Optional[list] = None        # per C2 row: the hostname key
    # Under a node mesh: `features` cut over the mesh's shards
    # (parallel/mesh.py shard_features); None on one device.
    shards: Optional[object] = None
    # The host arrays `features` were uploaded from, by field name: the
    # score-hint walker (models/score_hints.py) reads the pod's facts there
    # instead of copying them back from the device.
    host: Optional[dict] = None

    @property
    def row_local(self) -> bool:
        """A landing changes feasibility and scores only at its own row (the
        JAX package's BatchPlan.row_local, ops/features.py:189-199): a
        pod-local plan with no PreferNoSchedule, preferred-node-affinity,
        nominated-pod, host-port or attach-limit lane — the precondition of
        the node-sharded lap (parallel/mesh.py ShardedLap)."""
        f = self.facts
        return (self.pod_local and not f.has_pns and not f.has_na_pref
                and not self.features.nom_req.shape[0] and not f.port_selfblock
                and not f.has_aux)


class Unsupported(Exception):
    """Pod needs the host path (the JAX package's batch_supported)."""


AUX_BIG = 1 << 30  # aux_room of a row without an attach limit
NO_VOLUMES = (None, "", 0)  # volume_device_support of a pod without claims


def volume_device_support(pod: Pod, clientset, pvc_refs=None,
                          limited_drivers=frozenset()) -> Tuple[Optional[str], str, int]:
    """(reason, limited driver, attachments) for a pod's PVC-backed volumes
    (the JAX package's :227-276). The reason is None when the volumes
    impose no per-node constraint (every claim bound to a PV without node
    affinity or zone labels, none ReadWriteOncePod, none already in use)
    but at most one counted CSI attach limit: the driver, among those with
    any CSINode limit, and the pod's attachments to it, which build_batch
    turns into the aux lane. Then the volume plugins' Filter verdicts pass
    everywhere but NodeVolumeLimits', whose count of distinct claims equals
    the kernels' count a landing over unshared claims."""
    names = [v.pvc_name for v in pod.volumes if v.pvc_name]
    if not names:
        return NO_VOLUMES
    if clientset is None:
        return "pvc-backed volumes", "", 0
    driver_incs: Dict[str, int] = {}
    for name in names:
        key = f"{pod.namespace}/{name}"
        pvc = clientset.pvcs.get(key)
        if pvc is None or not pvc.volume_name:
            return "unbound pvc", "", 0
        if RWOP in pvc.access_modes:
            return "rwop pvc", "", 0
        if pvc_refs is not None and pvc_refs.get(key, 0) > 0:
            return "shared pvc", "", 0
        pv = clientset.pvs.get(pvc.volume_name)
        if pv is None:
            return "missing pv", "", 0
        if pv.node_affinity is not None:
            return "pv node affinity", "", 0
        if any(k in pv.labels for k in VolumeZone.TOPOLOGY_KEYS):
            return "pv zone labels", "", 0
        driver = pv.csi_driver
        if not driver:
            sc = clientset.storage_classes.get(pvc.storage_class)
            driver = sc.provisioner if sc is not None else ""
        if driver and driver in limited_drivers:
            driver_incs[driver] = driver_incs.get(driver, 0) + 1
    if len(driver_incs) > 1:
        return "multiple attach-limited drivers", "", 0
    if driver_incs:
        d, inc = next(iter(driver_incs.items()))
        return None, d, inc
    return NO_VOLUMES


NO_CLAIMS = (None, None, 0)  # dra_device_support of a pod without resource claims


def dra_device_support(pod: Pod, clientset,
                       session_claims=None) -> Tuple[Optional[str], Optional[tuple], int]:
    """(reason, claim shape, devices) for a pod's resource claims (the JAX
    package's :278-315). The reason is None for the claim-template shape:
    exactly one claim, unallocated, reserved for no pod, with one request,
    in a cluster without devices that consume node allocatable (a second
    constraint the count cannot model), and not taken by a pod of the
    session (`session_claims` holds "dra:<ns>/<name>" keys). The kernels
    then count the row's free matching devices (the aux lane) and the host
    commit picks the devices on the chosen node. The shape (device class,
    count, selectors, expression) is what every pod of a session shares."""
    names = pod.resource_claims
    if not names:
        return NO_CLAIMS
    if clientset is None or len(names) != 1:
        return "dynamic resource claims", None, 0
    key = f"{pod.namespace}/{names[0]}"
    claim = clientset.resource_claims.get(key)
    if claim is None:
        return "resource claim not found", None, 0
    if claim.allocated or claim.reserved_for:
        return "allocated resource claim", None, 0
    if clientset.has_consuming_devices:
        return "node-allocatable-consuming devices", None, 0
    if session_claims is not None and f"dra:{key}" in session_claims:
        return "claim shared within session", None, 0
    if len(claim.requests) != 1:
        return "multi-request claim", None, 0
    r = claim.requests[0]
    shape = (r.device_class, r.count, tuple(sorted(r.selectors.items())), r.expression)
    return None, shape, int(r.count)


def count_free_matching_devices(clientset, node_name: str, shape, dra_in_use) -> int:
    """The devices on `node_name` that the claim shape matches and no
    allocation or assumption holds: a row's aux_room under a DRA plan (the
    per-device predicate of DynamicResources.filter)."""
    device_class, _count, sel_items, expression = shape
    return sum(1 for _ in matching_devices(
        node_name, clientset.resource_slices.get(node_name, ()),
        class_selectors(clientset, device_class, sel_items),
        _compiled_expr(expression) if expression else None, dra_in_use))


@lru_cache(maxsize=256)
def _compiled_expr(expression: str):
    """Compiled selectors by expression (bounded: a long-lived process may
    see many claim shapes)."""
    return compile_device_expression(expression)


def batch_supported(pod: Pod, volume=None, dra=None) -> Optional[str]:
    """A reason string when the pod must take the host path, else None: a
    pod with a nominated node takes the host's fast path to it; matchFields
    metadata.name pins narrow the node list in PreFilter (node_affinity.go),
    which the kernels' full-cluster rotation cannot reproduce — and the
    narrowed universe is tiny; volumes that volume_device_support does
    not admit need the stateful host plugins, and so do claims that
    dra_device_support does not admit, or admits beside an attach limit
    (the lane counts one constraint). `volume`: the pod's
    volume_device_support triple, which the caller computes against live
    claim state (None: no storage context, so PVC-backed volumes take the
    host path). `dra`: its dra_device_support triple under a profile with
    DynamicResources; None under one without, where claims are inert and
    the pod batches as plain (the JAX package's :384-388)."""
    if pod.nominated_node_name:
        return "nominated node fast path"
    na = pod.affinity.node_affinity if pod.affinity is not None else None
    if na is not None and na.required is not None:
        if any(t.match_fields for t in na.required.terms):
            return "node-affinity metadata.name narrowing"
    if pod.volumes:
        volume = volume or volume_device_support(pod, None)
        if volume[0] is not None:
            return volume[0]
    if dra is not None and pod.resource_claims:
        if dra[0] is not None:
            return dra[0]
        if dra[2] and volume is not None and volume[1] and volume[2]:
            return "volume and DRA counted constraints together"
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


def build_batch(pod: Pod, batch_size: int, mirror: NodeStateMirror, snapshot,
                ns_labels_fn=None, *, percentage_of_nodes_to_score: int = 0,
                start_index: int = 0, weights: Tuple[int, ...] = (3, 1, 2, 2, 1, 2, 1),
                filters_on: Tuple[bool, ...] = (True, True, True, True, True),
                extra_filters: Optional[Dict[str, bool]] = None,
                hard_pod_affinity_weight: int = 1,
                ignore_preferred_terms_of_existing_pods: bool = False,
                fit_plugin=None, clientset=None, volume=None, dra_in_use=None,
                nominated=None) -> BatchPlan:
    """Build kernel inputs for a batch of `batch_size` pods identical to
    `pod`. `mirror` must already be synced to `snapshot`; `ns_labels_fn(ns)`
    gives a namespace's labels for namespaceSelector matching.
    `extra_filters`: {"NodePorts": on, "NodeDeclaredFeatures": on}, the
    profile's filter set (a name left out counts as on).
    `volume`: the pod's volume_device_support triple (None: no storage
    context); a pod with an attach-limited CSI driver gets its aux lane,
    whose room per row reads `clientset`'s CSINodes, claims and volumes.
    `dra_in_use`: the devices DynamicResources holds allocated or assumed,
    under a profile with the plugin (None: without, claims inert); a
    claim-template pod gets the aux lane over the rows' free matching
    devices in place of any attach limit.
    `nominated`: [(snapshot row, PodInfo)] of the nominated pods whose
    priority is at least `pod`'s (the caller filters them, and sends pods
    that a nominated pod could affect beyond resources to the host)."""
    dra = (dra_device_support(pod, clientset)
           if dra_in_use is not None and pod.resource_claims else None)
    reason = batch_supported(pod, volume, dra)
    if reason:
        raise Unsupported(reason)
    _r, aux_driver, aux_inc = volume or NO_VOLUMES
    dra_shape = dra[1] if dra is not None else None
    if dra_shape is not None and dra[2]:
        aux_driver, aux_inc = "", 0  # the DRA room replaces the attach room
    nodes: List[NodeInfo] = snapshot.node_info_list
    n = len(nodes)
    i32, i64 = np.int32, np.int64
    dev = mirror.device

    # Scalar-resource slots and topology axes intern before any vector is
    # built: interning can grow a capacity tier, which resets staging
    # (re-synced below).
    req = pod.resource_request()
    for name in req.scalar_resources:
        mirror.scalar_slot(name)
    nom_reqs = [(row, pi.pod.resource_request()) for row, pi in (nominated or ())]
    for _row, nr in nom_reqs:
        for name in nr.scalar_resources:
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

    dns = _compile_constraints(pod, DO_NOT_SCHEDULE)
    sa = _compile_constraints(pod, SCHEDULE_ANYWAY)
    pi = PodInfo.of(pod)
    aff_terms = compile_terms(pi.required_affinity_terms, pod)
    anti_terms = compile_terms(pi.required_anti_affinity_terms, pod)
    pref_aff = [(w.weight, compile_terms((w.term,), pod)[0]) for w in pi.preferred_affinity_terms]
    pref_anti = [(w.weight, compile_terms((w.term,), pod)[0])
                 for w in pi.preferred_anti_affinity_terms]
    for key in ([c.topology_key for c in dns + sa]
                + [t.topology_key for t in list(aff_terms) + list(anti_terms)]
                + [t.topology_key for _, t in pref_aff + pref_anti]):
        mirror.ensure_axis(key)
    # Existing pods' terms name axes too.
    for ni in nodes:
        for epi in ni.pods_with_affinity:
            for t in epi.required_anti_affinity_terms + epi.required_affinity_terms:
                mirror.ensure_axis(t.topology_key)
            for w in epi.preferred_affinity_terms + epi.preferred_anti_affinity_terms:
                mirror.ensure_axis(w.term.topology_key)
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
    # Host-side per-node predicates, shared with the topology aggregations.
    sel_host = [pod.required_node_selector_matches(ni.node) for ni in nodes]
    taint_ok_host = [find_matching_untolerated_taint(ni.node.taints, tols) is None
                     for ni in nodes]
    sel_match = np.zeros(npc, bool)
    sel_match[:n] = sel_host

    # -- NodeDeclaredFeatures and NodePorts: static per-row filters --------
    extra = extra_filters or {}
    extra_ok = np.ones(npc, bool)
    feats_req = required_features(pod)
    if feats_req and extra.get("NodeDeclaredFeatures", True):
        for r_i, ni in enumerate(nodes):
            declared = ni.node.declared_features if ni.node else {}
            extra_ok[r_i] &= all(declared.get(ft, False) for ft in feats_req)
    ports = pod.host_ports()
    port_selfblock = bool(ports) and extra.get("NodePorts", True)
    if port_selfblock:
        for r_i, ni in enumerate(nodes):
            if host_ports_conflict(ports, ni.used_ports):
                extra_ok[r_i] = False

    # -- ImageLocality static score (imagelocality.go scaledImageScore) ----
    il_score = np.zeros(npc, i64)
    if weights[6] and any(c.image for c in pod.containers):
        for r_i, ni in enumerate(nodes):
            il_score[r_i] = ImageLocality.scaled_score(pod, ni, snapshot.image_num_nodes,
                                                       max(1, n))

    fr = _pow2(len(specs))
    fit_slots = np.zeros(fr, i32)
    fit_weights = np.zeros(fr, i64)  # pad weight 0: excluded
    for j, spec in enumerate(specs):
        name = spec["name"]
        fit_slots[j] = slot_of[name] if name in slot_of else mirror.scalar_slot(name)
        fit_weights[j] = spec.get("weight", 1)

    # -- preferred node affinity raw score (node_affinity.go Score) ---------
    na_raw = np.zeros(npc, i64)
    na_spec = pod.affinity.node_affinity if pod.affinity else None
    has_na_pref = bool(na_spec is not None and na_spec.preferred and weights[5])
    if has_na_pref:
        for r_i, ni in enumerate(nodes):
            na_raw[r_i] = sum(p.weight for p in na_spec.preferred if p.preference.matches(ni.node))

    vmax = mirror.vmax
    topo = mirror.h_topo

    # -- PodTopologySpread DoNotSchedule (filtering.go:241) ----------------
    c1 = _pow2(len(dns))
    dns_axis = np.zeros(c1, i32)
    dns_active = np.zeros(c1, i32)            # pad rows: inert
    dns_max_skew = np.full(c1, 1 << 40, i64)  # pad: never rejects
    dns_self = np.zeros(c1, i32)
    dns_forced0 = np.ones(c1, i32)            # pad: min 0
    dns_honor_aff = np.zeros(c1, i32)
    dns_honor_taints = np.zeros(c1, i32)
    dns_counts = np.zeros((c1, vmax), i32)
    dns_dom = np.zeros((c1, vmax), bool)
    dns_node_counts = np.zeros((len(dns), n), i32) if dns else None
    dns_node_elig = np.zeros((len(dns), n), bool) if dns else None
    for ci, c in enumerate(dns):
        ax = mirror.axes[c.topology_key]
        dns_axis[ci] = ax.index
        dns_active[ci] = 1
        dns_max_skew[ci] = c.max_skew
        dns_self[ci] = 1 if c.selector.matches(pod.labels) else 0
        dns_honor_aff[ci] = 1 if c.node_affinity_policy == HONOR else 0
        dns_honor_taints[ci] = 1 if c.node_taints_policy == HONOR else 0
        domains = set()
        for r_i, ni in enumerate(nodes):
            if c.topology_key not in ni.node.labels:
                continue
            if (dns_honor_aff[ci] and not sel_host[r_i]) or (
                    dns_honor_taints[ci] and not taint_ok_host[r_i]):
                continue
            vid = topo[ax.index, r_i]
            dns_dom[ci, vid] = True
            domains.add(vid)
            cnt = _count_pods_matching(ni, c.selector, pod.namespace)
            dns_counts[ci, vid] += cnt
            dns_node_counts[ci, r_i] = cnt
            dns_node_elig[ci, r_i] = True
        forced = c.min_domains is not None and len(domains) < c.min_domains
        dns_forced0[ci] = 1 if (forced or not domains) else 0

    # -- PodTopologySpread ScheduleAnyway (scoring.go initPreScoreState) ---
    c2 = _pow2(len(sa))
    sa_axis = np.zeros(c2, i32)
    sa_wq = np.zeros(c2, i64)
    sa_skew = np.ones(c2, i64)
    sa_self = np.zeros(c2, i32)
    sa_counts = np.zeros((c2, vmax), i32)
    sa_node_counts = np.zeros((len(sa), n), i32) if sa else None
    sa_node_live = None
    if sa:
        # A node is ignored when it misses any constraint's key or fails the
        # pod's required node affinity.
        sa_ignored = [not all(c.topology_key in ni.node.labels for c in sa) or not sel_host[r_i]
                      for r_i, ni in enumerate(nodes)]
        sa_node_live = ~np.asarray(sa_ignored, bool)
        for ci, c in enumerate(sa):
            ax = mirror.axes[c.topology_key]
            sa_axis[ci] = ax.index
            sa_skew[ci] = c.max_skew
            sa_self[ci] = 1 if c.selector.matches(pod.labels) else 0
            domains = set()
            live = 0
            for r_i, ni in enumerate(nodes):
                if sa_ignored[r_i]:
                    continue
                vid = topo[ax.index, r_i]
                cnt = _count_pods_matching(ni, c.selector, pod.namespace)
                sa_counts[ci, vid] += cnt
                sa_node_counts[ci, r_i] = cnt
                domains.add(vid)
                live += 1
            size = live if c.topology_key == LABEL_HOSTNAME else len(domains)
            sa_wq[ci] = int(round(math.log(size + 2) * 1024))

    # -- InterPodAffinity required (filtering.go:217-284) ------------------
    a1 = _pow2(len(anti_terms))
    anti_axis = np.zeros(a1, i32)
    anti_self = np.zeros(a1, i32)
    anti_counts = np.zeros((a1, vmax), i32)
    a2 = _pow2(len(aff_terms))
    aff_axis = np.zeros(a2, i32)
    aff_self = np.zeros(a2, i32)
    aff_active = np.zeros(a2, i32)
    aff_counts = np.zeros((a2, vmax), i32)
    exist_anti = np.zeros(npc, i32)
    anti_rowlocal = bool(anti_terms)
    for ti, t in enumerate(anti_terms):
        ax = mirror.axes[t.topology_key]
        anti_axis[ti] = ax.index
        anti_self[ti] = 1 if t.matches(pod, ns_labels_fn) else 0
        vids = topo[ax.index, :n]
        nz = vids[vids > 0]
        if anti_rowlocal and nz.size and np.bincount(nz).max() > 1:
            anti_rowlocal = False  # shared domains: cross-window coupling
    for ti, t in enumerate(aff_terms):
        aff_axis[ti] = mirror.axes[t.topology_key].index
        aff_self[ti] = 1 if t.matches(pod, ns_labels_fn) else 0
        aff_active[ti] = 1
    aff_own_all = 1 if aff_terms and all(t.matches(pod, ns_labels_fn) for t in aff_terms) else 0

    term_cache: Dict[tuple, tuple] = {}

    def existing_terms(epi: PodInfo, which: str) -> tuple:
        key = (epi.pod.uid, which)
        if key not in term_cache:
            term_cache[key] = compile_terms(getattr(epi, which), epi.pod)
        return term_cache[key]

    # Existing pods' required anti-affinity vs the incoming pod, per
    # (axis, value), broadcast to a per-row hit count.
    exist_pairs: Dict[Tuple[int, int], int] = {}
    for ni in nodes:
        for epi in ni.pods_with_required_anti_affinity:
            for term in existing_terms(epi, "required_anti_affinity_terms"):
                tp_val = ni.node.labels.get(term.topology_key)
                if tp_val is not None and term.matches(pod, ns_labels_fn):
                    ax = mirror.axes[term.topology_key]
                    key = (ax.index, ax.lookup_value(tp_val))
                    exist_pairs[key] = exist_pairs.get(key, 0) + 1
    for (ax_i, vid), cnt in exist_pairs.items():
        if cnt > 0 and vid >= 0:
            exist_anti[:n] += (topo[ax_i, :n] == vid).astype(i32)
    # The incoming pod's required terms vs every existing pod.
    if aff_terms or anti_terms:
        for r_i, ni in enumerate(nodes):
            for epi in ni.pods:
                for ti, term in enumerate(aff_terms):
                    vid = topo[aff_axis[ti], r_i]
                    if vid > 0 and term.matches(epi.pod, ns_labels_fn):
                        aff_counts[ti, vid] += 1
                for ti, term in enumerate(anti_terms):
                    vid = topo[anti_axis[ti], r_i]
                    if vid > 0 and term.matches(epi.pod, ns_labels_fn):
                        anti_counts[ti, vid] += 1

    # -- InterPodAffinity scoring (scoring.go PreScore) ---------------------
    topology_score: Dict[str, Dict[str, int]] = {}

    def add_score(tp_key: str, tp_val: str, w: int) -> None:
        if w:
            vals = topology_score.setdefault(tp_key, {})
            vals[tp_val] = vals.get(tp_val, 0) + w

    has_pref = bool(pref_aff or pref_anti)
    for ni in (nodes if has_pref else snapshot.have_pods_with_affinity_list):
        node = ni.node
        for epi in (ni.pods if has_pref else ni.pods_with_affinity):
            ep = epi.pod
            for weight, term in pref_aff:
                tp_val = node.labels.get(term.topology_key)
                if tp_val is not None and term.matches(ep, ns_labels_fn):
                    add_score(term.topology_key, tp_val, weight)
            for weight, term in pref_anti:
                tp_val = node.labels.get(term.topology_key)
                if tp_val is not None and term.matches(ep, ns_labels_fn):
                    add_score(term.topology_key, tp_val, -weight)
            if hard_pod_affinity_weight > 0:
                for term in existing_terms(epi, "required_affinity_terms"):
                    tp_val = node.labels.get(term.topology_key)
                    if tp_val is not None and term.matches(pod, ns_labels_fn):
                        add_score(term.topology_key, tp_val, hard_pod_affinity_weight)
            if not ignore_preferred_terms_of_existing_pods:
                for sign, wts in ((1, epi.preferred_affinity_terms),
                                  (-1, epi.preferred_anti_affinity_terms)):
                    for wt in wts:
                        term = compile_terms((wt.term,), ep)[0]
                        tp_val = node.labels.get(term.topology_key)
                        if tp_val is not None and term.matches(pod, ns_labels_fn):
                            add_score(term.topology_key, tp_val, sign * wt.weight)
    ipa_base = np.zeros(npc, i64)
    for tp_key, vals in topology_score.items():
        ax = mirror.axes.get(tp_key)
        if ax is None:
            continue  # key only on deleted nodes: no live node can match
        col = np.zeros(vmax, i64)
        for v, w in vals.items():
            vid = ax.lookup_value(v)
            if vid >= 0:
                col[vid] = w
        ipa_base[:n] += col[np.clip(topo[ax.index, :n], 0, vmax - 1)]
        ipa_base[:n][topo[ax.index, :n] == 0] -= col[0]  # an absent key adds nothing
    # Landing deltas: what a landed batch pod adds to the next batch pod's
    # topology score, per axis (both directions of each preferred term).
    land: Dict[int, int] = {}
    mult = 1 if ignore_preferred_terms_of_existing_pods else 2
    for sign, terms in ((1, pref_aff), (-1, pref_anti)):
        for weight, term in terms:
            if term.matches(pod, ns_labels_fn):
                ax_i = mirror.axes[term.topology_key].index
                land[ax_i] = land.get(ax_i, 0) + sign * weight * mult
    if hard_pod_affinity_weight > 0:
        for term in aff_terms:
            if term.matches(pod, ns_labels_fn):
                ax_i = mirror.axes[term.topology_key].index
                land[ax_i] = land.get(ax_i, 0) + hard_pod_affinity_weight
    kd = _pow2(len(land))
    ipa_axis = np.zeros(kd, i32)
    ipa_wland = np.zeros(kd, i64)
    for j, (ax_i, w) in enumerate(sorted(land.items())):
        ipa_axis[j] = ax_i
        ipa_wland[j] = w

    # -- nominated-pod lane (two-pass filter pass one, resources only) -----
    nom_rows = npc if nom_reqs else 0
    nom_req = np.zeros((nom_rows, r), i64)
    nom_pods = np.zeros(nom_rows, i32)
    for row, nr in nom_reqs:
        nom_req[row] += _resource_vec(mirror, nr)
        nom_pods[row] += 1

    # -- counted aux constraint: DRA free devices, or a CSI driver's attach
    # room (csi.go) --------------------------------------------------------
    aux_room = np.full(npc, AUX_BIG, i32)
    has_aux = dra_shape is not None
    if has_aux:
        for r_i, ni in enumerate(nodes):
            aux_room[r_i] = count_free_matching_devices(clientset, ni.name, dra_shape,
                                                        dra_in_use)
        aux_inc = dra_shape[1]
    if aux_driver and aux_inc:
        has_aux = True
        driver_of: Dict[str, Optional[str]] = {}

        def claim_driver(key: str) -> Optional[str]:
            if key not in driver_of:
                pvc = clientset.pvcs.get(key)
                d = None
                if pvc is not None:
                    pv = clientset.pvs.get(pvc.volume_name) if pvc.volume_name else None
                    if pv is not None and pv.csi_driver:
                        d = pv.csi_driver
                    else:
                        sc = clientset.storage_classes.get(pvc.storage_class)
                        d = sc.provisioner if sc is not None else None
                driver_of[key] = d
            return driver_of[key]

        for r_i, ni in enumerate(nodes):
            cn = clientset.csi_nodes.get(ni.name)
            limit = cn.driver_limits.get(aux_driver) if cn is not None else None
            if limit is None:
                continue
            existing = sum(1 for key in ni.pvc_ref_counts if claim_driver(key) == aux_driver)
            aux_room[r_i] = max(0, limit - existing)

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
        extra_ok=extra_ok, il_score=il_score, na_raw=na_raw,
        dns_axis=dns_axis, dns_active=dns_active, dns_max_skew=dns_max_skew,
        dns_self=dns_self, dns_forced0=dns_forced0, dns_honor_aff=dns_honor_aff,
        dns_honor_taints=dns_honor_taints, dns_counts=dns_counts, dns_dom=dns_dom,
        sa_axis=sa_axis, sa_wq=sa_wq, sa_skew=sa_skew, sa_self=sa_self, sa_counts=sa_counts,
        anti_axis=anti_axis, anti_self=anti_self, anti_counts=anti_counts,
        exist_anti=exist_anti,
        aff_axis=aff_axis, aff_self=aff_self, aff_active=aff_active, aff_counts=aff_counts,
        aff_own_all=np.array(aff_own_all, i32),
        ipa_base=ipa_base, ipa_axis=ipa_axis, ipa_wland=ipa_wland,
        fit_slots=fit_slots, fit_weights=fit_weights,
        weights=np.array(weights, i64),
        enable=np.array([1 if b else 0 for b in filters_on], i32),
        aux_room=aux_room, aux_inc=np.array(aux_inc, i32),
        nom_req=nom_req, nom_pods=nom_pods,
        num_nodes=np.array(n, i32),
        start_index=np.array(start_index % max(1, n), i32),
        to_find=np.array(num_feasible_nodes_to_find(n, percentage_of_nodes_to_score), i32),
    )
    feats = BatchFeatures(**{k: torch.from_numpy(v).to(dev) for k, v in host.items()})
    has_ipa_base = bool((ipa_base != 0).any())
    return BatchPlan(
        features=feats, batch_pad=_batch_tier(batch_size), fit_strategy=strategy,
        vmax=vmax,
        facts=PlanFacts(
            has_pns=bool((mirror.h_taint_eff[:n] == EFFECT_PREFER_NO_SCHEDULE).any()),
            has_ipa_base=has_ipa_base, anti_rowlocal=anti_rowlocal, has_na_pref=has_na_pref,
            port_selfblock=port_selfblock, has_aux=has_aux),
        pod_local=bool(c1 == 0 and c2 == 0 and a1 == 0 and a2 == 0 and kd == 0
                       and not has_ipa_base and not (exist_anti != 0).any()),
        dns_node_counts=dns_node_counts, dns_node_elig=dns_node_elig,
        dns_min_domains=[c.min_domains for c in dns] if dns else None,
        sa_node_counts=sa_node_counts, sa_node_live=sa_node_live,
        sa_hostname_axis=[c.topology_key == LABEL_HOSTNAME for c in sa] if sa else None,
        host=host)


PREEMPT_K_CAP = 256  # victims per node beyond which the host dry run decides


def build_preemption_victims(pod: Pod, snapshot, mirror: NodeStateMirror):
    """The dry-run kernel's victim tensors: per node, every pod of lower
    priority than `pod`, in the reprieve order (MoreImportantPod:
    higher priority, then the earlier start). Returns (vic_req [npc, K, R]
    i64, vic_valid [npc, K] bool, the victims' PodInfos per snapshot row in
    the same order), K a power of two of at least 8; or None when no node
    has a victim or one has more than PREEMPT_K_CAP (the host dry run
    decides)."""
    potential = []
    kmax = 0
    for ni in snapshot.node_info_list:
        pis = sorted((pi for pi in ni.pods if pi.pod.priority < pod.priority),
                     key=lambda pi: (-pi.pod.priority, pi.pod.creation_ts))
        potential.append(pis)
        kmax = max(kmax, len(pis))
    if kmax == 0 or kmax > PREEMPT_K_CAP:
        return None
    k = _pow2(kmax, 8)
    # Every victim's scalar slot interns before the arrays are allocated:
    # interning can grow the resource tier.
    reqs = [[pi.pod.resource_request() for pi in pis] for pis in potential]
    for rs in reqs:
        for r in rs:
            for name in r.scalar_resources:
                mirror.scalar_slot(name)
    vic_req = np.zeros((mirror.np_cap, k, mirror.r_slots), np.int64)
    vic_valid = np.zeros((mirror.np_cap, k), bool)
    for row, rs in enumerate(reqs):
        for j, r in enumerate(rs):
            vic_req[row, j] = _resource_vec(mirror, r)
            vic_valid[row, j] = True
    return vic_req, vic_valid, potential


def diagnose_unschedulable(pod: Pod, mirror: NodeStateMirror, snapshot, fw) -> Optional[Diagnosis]:
    """Per-node failure Diagnosis for a pod the device found infeasible
    everywhere, vectorized over the mirror's staging arrays instead of the
    per-node Python filter loop. Verdicts and plugin attributions match the
    host plugins in profile filter order. Pods with topology spread or pod
    (anti-)affinity return None: their verdicts depend on the count tables,
    and the exact host rerun owns them (the JAX package's :1050)."""
    if (pod.topology_spread_constraints
            or (pod.affinity is not None
                and (pod.affinity.pod_affinity or pod.affinity.pod_anti_affinity))):
        return None
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
    ports = pod.host_ports()
    if "NodePorts" in names and ports:
        # Resolvable: a preemption can free a port.
        checks.append(("NodePorts", False,
                       np.array([host_ports_conflict(ports, ni.used_ports) for ni in nodes]),
                       "node(s) didn't have free ports for the requested pod ports"))
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
    feats_req = required_features(pod)
    if "NodeDeclaredFeatures" in names and feats_req:
        checks.append(("NodeDeclaredFeatures", False, np.array([
            not all((ni.node.declared_features if ni.node else {}).get(ft, False)
                    for ft in feats_req) for ni in nodes]),
            "node(s) didn't declare required features"))
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
