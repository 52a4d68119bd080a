"""TorchScheduler — the scheduler with its hot path on an NVIDIA GPU (the
port of the JAX package's TPUScheduler, trimmed to the port's slices).

Control flow:

    pop → a row-block of consecutive same-signature pods (up to max_batch)
        → Cache.update_snapshot (host, incremental)
        → NodeStateMirror.sync/flush (device, dirty-row scatter)
        → build_batch (per-batch features, once per session)
        → ops.kernel.schedule_batch (the whole greedy assignment of the
          block on the device: static masks, fit/score evaluation, sampling
          emulation, selection, carry updates)
        → per pod: assume → bind (host, unchanged semantics)

Consecutive batches of one session chain through the device carry — count
tables included, so identical spread or affinity pods (one signature: the
PodTopologySpread and InterPodAffinity Sign parts cover their labels,
namespace and terms) share one plan — and up to `pipeline_depth` batches
are in flight: the host commits batch N while the device computes batch
N+1. Each batch's results come back through a non-blocking copy into pinned
host memory, fenced by a CUDA event. Pods that differ only in labels and
namespace join one session under their namespace-erased signature
(_neutral_sig) while no pod in the cluster carries affinity terms.

Incremental resume (the JAX package's journal protocol). Cluster events go
into the typed journal (core/cache.py EventJournal). A session consumes the
events since its watermark at each commit (_note_session_events):
queue-only events and, for plans without inter-pod affinity, namespace
events are benign; pod events of plain pods and taint/allocatable node
updates on a pod-local plan are row patches — the mirror's rows re-encoded
and scattered (NodeStateMirror.patch_rows, the scatter_rows kernel) and the
carry's rows re-evaluated (the patch_carry_rows kernel) — applied once no
dispatched batch is in flight (a patch from host staging would erase the
in-flight placements): an event that only enlarges feasibility waits for
the pipeline to drain, one that may shrink it ends the session. Anything
else, a truncated journal, a patch that cannot apply (a regrown tier, a
pending full upload, a PreferNoSchedule taint under a plan compiled
without that lane) and any change to the set of nominated pods end it. A
clean session leaves its plan and carry for the next one
(_resume_or_rebuild): the same signature (exact or neutral), no host
attempt and the same nominations since resume it as it is or after the
journal's row patches; otherwise the plan is rebuilt from the snapshot.
plan_rebuilds_full / _delta / _resume count each acquisition.

Priorities and preemption. While pods are nominated (a preemption reserved
room for them), a session's plan carries the nominated-pod lane: the
nominated pods of equal or higher priority, counted against the fit filter
of their rows (the two-pass filter's first pass, resources only), and its
batches hold pods of the head's priority only. A pod that fits nowhere
gets its diagnosis and runs PostFilter (DefaultPreemption), whose per-node
dry run is the dry_run_preemption kernel here (device_dry_run_preemption);
the host re-verifies the chosen candidate and raises where it disagrees.
The victims' deletions dirty the mirror's rows, which the next plan
flushes with the scatter_rows kernel.

Pod groups. A group scheduled by the default algorithm (no topology
constraint) is member-wise greedy placement with an all-or-nothing commit,
which is the kernels' scan with a group-granular commit barrier: groups of
identical members ride gang device sessions, whole groups packed into each
dispatch, the carry chained across packs, each retired group committed at
once; a group with a member the device finds no node for takes the exact
host group cycle (its diagnosis and pod-group preemption) and ends the
session. A topology-constrained group under the placement plugins runs the
host placement algorithm, whose evaluation of every candidate placement is
one schedule_placements launch (_evaluate_placements); PlacementFeasible,
the PlacementScore plugins and the commit stay on the host.

Volumes. A pod whose claims are all bound, to PVs without node affinity
or zone labels, none ReadWriteOncePod or in use by another pod, rides a
session; where its claims count against one CSI driver's attach limit the
plan carries the kernels' aux_cnt lane (ops/features.py
volume_device_support). Every pod of a session has the head's attach shape
(driver and attachments, _aux_shape), and no two share a claim (the
kernels count a landing's attachments, NodeVolumeLimits each distinct
claim once); the resume key holds the shape. Pods with other volumes take
the host path through the volume plugins, as do a volume pod's preemption
dry run and its placement evaluation, and a volume pod while pods are
nominated.

Resource claims (the JAX package's DRA path). Under a profile with
DynamicResources (core/registry.py dra_profile), a claim-template pod (one
unallocated, unshared claim of one request: ops/features.py
dra_device_support) rides a session on the same aux_cnt lane: each row's
room is its free devices that the request matches, a landing takes the
request's count. The commit then runs DynamicResources' PreFilter and
Filter on the chosen node alone and the full tail on that state, which
allocates the devices; a miss sends the pod to the host path. A
session's pods share the head's claim shape (_aux_shape is the pair of
attach shape and claim shape) and no claim; the resume key holds the
claims' revision. Under a profile without DynamicResources claims are
inert and a claim pod batches as plain. Other claims take the host path,
as do claim pods of a gang, of a placement group or while pods are
nominated.

The commit. A pod with no DRA state and no pod group, under a profile
whose Reserve and PreBind plugins act only on the state their PreFilter
wrote (`state_driven_tail`), whose Permit plugins act only on gang
members (`gang_only`), with no PostBind plugin and DefaultBinder alone,
takes the lean tail: assume and bind (_commit_fast_eligible, the JAX
package's :2087-2165), which leaves what the full tail would.

Host fast paths (the JAX package's :1950-2085, :2209-2321). A clean
session on a row-local plan leaves a score hint (models/score_hints.py):
its final carry on the host, keyed by signature, from which the next
identical pods bind with no dispatch (_try_hint_binds, ahead of batch
collection), each where the next lap would have put it (where the walker
serves: `score_hints`, by default on the CPU and not on a card, where the
dispatch is the faster path). A pod the device
places nowhere is diagnosed once against a state; an identical pod against
the same state parks from the failure memo (_fail_from_memo), and the
session goes on.

Node mesh (the JAX package's mesh code, :88-123, :1081-1116, :1233-1275,
:1505-1565). With a NodeMesh (parallel/mesh.py make_mesh, passed as
`mesh`; the default keeps one device) the mirror's resident state
and each plan's features are cut along the node axis over the mesh's
shards. A row-local plan above 64 steps dispatches the sharded lap (one
sharded_lap launch a card, both exchanges of each lap on the device); every other
plan runs schedule_batch on the state and features gathered onto the
mesh's first device, its carry staying there for the session. Delta
patches route each dirty row to its shard (scatter_rows a shard) and patch
a sharded carry in place (patch_carry_rows a shard). One device may repeat
in a mesh, so several shards can share one card or the CPU.

Pods the kernels do not cover (matchFields narrowing, a nominated node's
fast path, spread, affinity, host-port or volume pods while pods are
nominated, volumes that need stateful binding) and
pods a session hands back take the host path in core/scheduler.py, which
produces the same assignments; so does the dry run of a preemptor with
spread or affinity terms or host ports, in a cluster with anti-affinity
pods, or with more than
PREEMPT_K_CAP victims on a node; so do groups whose members differ or are
not covered, groups while pods are nominated, placement groups whose plan
carries inter-pod-affinity tables, and pod-group preemption.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.cache import (
    EV_NAMESPACE,
    EV_NODE_UPDATE,
    EV_POD_ADD,
    EV_POD_REMOVE,
    EV_POD_UPDATE,
    EV_QUEUE,
)
from ..core.framework import (
    UNSCHEDULABLE_AND_UNRESOLVABLE,
    WAIT,
    CycleState,
    FitError,
    Framework,
    PlacementProgress,
    PodGroupAssignments,
    Status,
)
from ..core.queue import QueuedPodGroupInfo, QueuedPodInfo
from ..core.registry import default_profile
from ..core.scheduler import Scheduler, ScheduleResult
from ..ops.codebook import EFFECT_PREFER_NO_SCHEDULE
from ..ops.device_state import NodeStateMirror
from ..ops.features import (
    NO_VOLUMES,
    Unsupported,
    _pow2,
    batch_supported,
    build_batch,
    build_preemption_victims,
    diagnose_unschedulable,
    dra_device_support,
    volume_device_support,
)
from ..ops.kernel import (
    SCAN_MAX_STEPS,
    dry_run_preemption,
    schedule_batch,
    schedule_placements,
)
from ..ops.staging import Fetch
from ..parallel.mesh import (
    Sharded,
    gather,
    mesh_shard_count,
    shard_features,
    sharded_lap_schedule,
)
from ..plugins.basic import DefaultBinder
from ..plugins.preemption import Candidate
from .score_hints import ScoreHintCache, hint_eligible

DEFAULT_MAX_BATCH = 1024  # the JAX package's config.max_batch
PIPELINE_DEPTH = 2        # batches in flight (double buffering)
FAIL_MEMO_CAP = 64        # failure diagnoses kept (_memoize_failure)

# _collect_batch's reasons for a group entity: it rides a gang device
# session, or it is a topology-constrained group whose host cycle evaluates
# its placements on the device.
_GANG_SESSION = "gang device session"
_PLACEMENT_GROUP = "placement group"

_EMPTY_STATE = CycleState()  # the lean commit tail's state: no plugin reads or writes it


def _attach_shape(volume) -> Optional[tuple]:
    """(driver, attachments a pod) of the attach-limited CSI claims of a pod
    whose volume_device_support triple is `volume`, or None."""
    _r, driver, inc = volume
    return (driver, inc) if driver else None


class _SessionDelta:
    """A live session's journal-patchable view: the device state and carry
    that delta patches rewrite, the journal seq already consumed, and
    whether a patch waits for the pipeline to drain."""

    __slots__ = ("state", "carry", "start_seq", "patch_pending")

    def __init__(self, state, carry, start_seq: int):
        self.state = state
        self.carry = carry
        self.start_seq = start_seq
        self.patch_pending = False


class TorchScheduler(Scheduler):
    """Scheduler with the hot path on the device. `device` is "cuda" unless
    the caller asks for "cpu", where the kernels' plain PyTorch versions run.
    `resume=False` turns incremental resume off, as the port ran before it:
    every session rebuilds its plan, any journaled event ends it, and only
    pods of one exact signature share it (a baseline to measure against).
    `profile_factory` builds the profile (core/registry.py default_profile,
    or gang_placement_profile for the pod-group placement plugins).
    `mesh` (the JAX package's TPUScheduler mesh, :88-123): a NodeMesh
    (parallel/mesh.py make_mesh) is used as given, its first device then
    the scheduler's device; None keeps `device` alone. "auto" keeps
    `device` alone too, on any number of cards: where the JAX package
    shards over every device, a host with several cards opts in with
    mesh=make_mesh().
    `score_hints` (the JAX package's TPU_SCHED_SCORE_HINTS): True lets a
    clean session's final carry seed the host walker of
    models/score_hints.py, which binds the next identical pods without a
    dispatch; False keeps every pod on the dispatch path. None, the default,
    takes the faster of the two on the device: on a CUDA card a lap dispatch
    binds replicas for less host time a pod than the walk (PERF.md § 5), so
    the dispatch path; on the CPU, where the lap runs its plain version,
    the walker, as the JAX package's default."""

    def __init__(self, clientset=None, device="cuda", max_batch: Optional[int] = None,
                 percentage_of_nodes_to_score: int = 0, resume: bool = True,
                 profile_factory=default_profile, mesh="auto",
                 score_hints: Optional[bool] = None):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("TorchScheduler: CUDA is not available "
                               "(pass device='cpu' to run the plain versions)")
        if isinstance(mesh, str):
            if mesh != "auto":
                raise ValueError(f"mesh must be 'auto', a NodeMesh or None, not {mesh!r}")
            # On one card and across cards alike the sharded path is slower
            # than the single-device lap (PERF.md): until it is not, "auto"
            # keeps the requested device alone.
            mesh = None
        if mesh is not None:
            if mesh.first.type != device.type:
                raise ValueError(f"a {device.type} scheduler on a mesh of {mesh.first.type} "
                                 "devices")
            device = mesh.first
        super().__init__(clientset, percentage_of_nodes_to_score,
                         profile_factory=profile_factory)
        self.device = device
        self.mesh = mesh
        self.max_batch = max_batch or DEFAULT_MAX_BATCH
        self.mirror = NodeStateMirror(device)
        self._holdover: Optional[QueuedPodInfo] = None
        self.device_batches = 0
        self.device_scheduled = 0
        self.host_path_pods = 0
        self.shard_map_dispatches = 0     # dispatches that took the sharded lap
        self.preemption_device_evals = 0  # dry runs that took the kernel
        # Group cycles whose candidate placements were evaluated in one
        # schedule_placements launch, and their seconds (plan, masks, the
        # launch and the fetch).
        self.placement_device_evals = 0
        self.placement_eval_s = 0.0
        # Across group cycles: the placement plan (keyed on the cluster-event
        # version; spread-carrying and port-aware plans are not kept) and
        # the candidates' row masks on the device.
        self._placement_plan_cache = None
        self._placement_mask_cache = None
        self.resume = resume
        # Plan acquisitions by kind: a full snapshot→features rebuild, the
        # previous session's plan resumed as it is, or resumed (or kept
        # live) after a journal row patch; and the rows those patches wrote.
        self.plan_rebuilds_full = 0
        self.plan_rebuilds_delta = 0
        self.plan_rebuilds_resume = 0
        self.delta_dirty_rows = 0
        # The previous clean session's (key, seq, payload, nomination key).
        self._resume = None
        # The live session's namespace-erased signature (None: exact only),
        # and its node-name → row map for delta patches.
        self._session_neutral_sig = None
        self._session_row_of = None
        # The priority of the session's pods while pods are nominated (the
        # nominated lane is priority-thresholded), else None.
        self._session_nom_priority: Optional[int] = None
        # The live session's counted-constraint shape (_aux_shape) and the
        # claims of the pods it took (PVC keys, "dra:" ResourceClaim keys):
        # the kernels count a landing's attachments or devices, so a pod
        # sharing a claim with one of them must not join.
        self._session_volume = NO_VOLUMES  # the head's volume_device_support
        self._session_aux_shape = (None, None)
        self._session_claims: set = set()
        # _commit_fast_eligible's verdict a profile (id(fw) -> bool).
        self._fast_tail: dict = {}
        # The drivers with any CSINode limit, at the CSINode set's version.
        self._limited_drivers = frozenset()
        self._limited_drivers_rv = -1
        # Host/device time split: snapshot→features host work, popping and
        # grouping pods into batches, enqueueing the kernels, time blocked
        # on a result fetch, the host commit tails, and the session's end
        # (snapshot refresh and adopting the final carry into the mirror).
        self.plan_build_s = 0.0
        self.plan_acquire_s = 0.0  # every acquisition and in-session patch
        self.collect_s = 0.0
        self.dispatch_s = 0.0
        self.device_wait_s = 0.0
        self.host_commit_s = 0.0
        self.session_end_s = 0.0
        # Failure diagnoses of pods that fit nowhere, keyed by everything the
        # outcome depends on (_fail_state_key) -> (unschedulable plugins,
        # message): an identical pod against the same state parks from here
        # without a rerun. A small LRU, not one slot, so that floods of
        # alternating signatures each stay memoized.
        self._fail_memo: dict = {}
        self.memo_hits = 0  # pods parked from it
        # The score-hint walker (models/score_hints.py) and its counters.
        if score_hints is None:
            score_hints = device.type != "cuda"
        self._hints = ScoreHintCache(self, enabled=score_hints)
        self.hint_hits = 0
        self.hint_misses = 0
        self.hint_invalidations = 0
        self.hint_s = 0.0  # seconds in the walker's bind loop

    @property
    def preemption_verify_divergences(self) -> int:
        """Device dry-run candidates that the host verification refuted."""
        return self.preemption_counts()["verify_divergences"]

    # -- batch accumulation ------------------------------------------------

    def _pop(self) -> Optional[QueuedPodInfo]:
        while True:
            if self._holdover is not None:
                qpi, self._holdover = self._holdover, None
            else:
                qpi = self.queue.pop()
            if qpi is None:
                return None
            if not isinstance(qpi, QueuedPodGroupInfo) and (
                    qpi.pod.deletion_ts is not None or qpi.pod.uid in self.cache.pod_states):
                # skipPodSchedule: never dispatch deleting or placed pods. (A
                # group is never skipped whole: its .pod is its first member.)
                self.queue.done(qpi.pod.uid)
                continue
            return qpi

    def _collect_session_batch(self, fw: Framework, sig,
                               batch: Optional[List[QueuedPodInfo]] = None) -> List[QueuedPodInfo]:
        """Fill `batch` up to max_batch pods with the session's signature;
        the first other pod waits in the holdover slot."""
        batch = [] if batch is None else batch
        while len(batch) < self.max_batch:
            nxt = self._pop()
            if nxt is None:
                break
            if (not isinstance(nxt, QueuedPodGroupInfo)
                    and nxt.pod.scheduler_name in self.profiles
                    and self.framework_for_pod(nxt.pod) is fw
                    and self._sig_joins(fw, nxt.pod, sig)
                    and self._session_nom_priority in (None, nxt.pod.priority)
                    and self._joins_session_claims(fw, nxt.pod)):
                batch.append(nxt)
            else:
                self._holdover = nxt
                break
        return batch

    def _collect_batch(self) -> Tuple[Optional[Framework], List[QueuedPodInfo], Optional[str]]:
        """Pop a maximal run of consecutive identical-signature pods.
        Returns (framework, batch, fallback_reason); with a reason the batch
        is the one head pod and takes the host path."""
        head = self._pop()
        if head is None:
            return None, [], None
        if isinstance(head, QueuedPodGroupInfo):
            fw, _sig = self._gang_device_eligible(head)
            if fw is not None:
                return fw, [head], _GANG_SESSION
            fw = self.framework_for_pod(head.pod)
            if fw.placement_generate_plugins and head.group.topology_keys:
                return fw, [head], _PLACEMENT_GROUP
            return fw, [head], "pod group outside the gang device session"
        fw = self.framework_for_pod(head.pod)
        volume = self._volume_support(head.pod)
        # (The head's claims are checked against the previous session's,
        # as the JAX package's _collect_batch checks them.)
        reason = (self._batch_supported(fw, head.pod, volume)
                  or self._device_unsupported_profile(fw, head.pod)
                  or self._nominated_device_block(head.pod))
        sig = fw.sign_pod(head.pod) if reason is None else None
        if sig is None:
            return fw, [head], reason or "unsignable pod"
        # The nominated lane counts the nominations of priority at least the
        # head's (framework.go:1280-1284): a pod of another priority would
        # need another lane, so it waits for the next session.
        nom = self.queue.nominator
        self._session_nom_priority = head.pod.priority if nom.has_nominated_pods() else None
        self._session_claims = set(self._claims_of(head.pod))
        self._session_volume = volume
        self._session_aux_shape = self._aux_shape(head.pod, volume)
        self._session_neutral_sig = self._neutral_sig(fw, head.pod, sig)
        return fw, self._collect_session_batch(fw, sig, [head]), None

    # -- volumes and resource claims: the session's shape and claims ----------

    def limited_drivers(self) -> frozenset:
        """The CSI drivers with an attach limit on any CSINode."""
        rv = self.clientset.csi_nodes_rv
        if rv != self._limited_drivers_rv:
            self._limited_drivers = frozenset(
                d for cn in self.clientset.csi_nodes.values() for d in cn.driver_limits)
            self._limited_drivers_rv = rv
        return self._limited_drivers

    def _volume_support(self, pod) -> tuple:
        """features.volume_device_support against live claim and volume
        state (so never memoized); a pod without volumes answers at once.
        One call a pod: the collection passes the triple on."""
        if not pod.volumes:
            return NO_VOLUMES
        return volume_device_support(pod, self.clientset, self.cache.pvc_refs,
                                     self.limited_drivers())

    @staticmethod
    def _dra_ctx(fw: Framework):
        """The devices DynamicResources holds (allocated or assumed) under
        `fw`, or None when the profile has no DynamicResources: claims are
        then inert (the JAX package's :1643-1650)."""
        dr = fw.plugin("DynamicResources")
        return None if dr is None else dr._in_use()

    def _dra_support(self, fw: Framework, pod):
        """features.dra_device_support of `pod` against live claim state and
        the session's claims, or None where claims are inert (no claim, or
        no DynamicResources in `fw`)."""
        if not pod.resource_claims or fw.plugin("DynamicResources") is None:
            return None
        return dra_device_support(pod, self.clientset, self._session_claims)

    def _batch_supported(self, fw: Framework, pod, volume=None) -> Optional[str]:
        """features.batch_supported with the storage and claim context the
        pod needs (`volume`: its volume_device_support triple where the
        caller has it), memoized on the template's shared holder a profile
        (the JAX package's _batch_supported_memo, :1681-1713): clones never
        change their spec, so a workload of N clones asks once. A nominated
        pod is answered outside the memo, and a pod with a PVC or a resource
        claim never from it: its verdict reads live claim state."""
        if pod.nominated_node_name:
            return "nominated node fast path"
        shared = pod.__dict__.get("_sig_shared")
        if shared is None or pod.resource_claims or any(v.pvc_name for v in pod.volumes):
            return batch_supported(pod, volume or self._volume_support(pod),
                                   self._dra_support(fw, pod))
        key = ("_bsup", id(fw))
        if key not in shared:
            shared[key] = batch_supported(pod)
        return shared[key]

    def _claim_shape(self, pod) -> Optional[tuple]:
        """The request shape of the pod's first resource claim: (device
        class, count, selectors, expression); ("?",) for a missing or
        multi-request claim; None without claims (the JAX package's
        :1655-1665)."""
        if not pod.resource_claims:
            return None
        claim = self.clientset.resource_claims.get(f"{pod.namespace}/{pod.resource_claims[0]}")
        if claim is None or len(claim.requests) != 1:
            return ("?",)
        r = claim.requests[0]
        return (r.device_class, r.count, tuple(sorted(r.selectors.items())), r.expression)

    def _aux_shape(self, pod, volume) -> tuple:
        """The counted-constraint shape a plan models for `pod` (its
        volume_device_support triple `volume`): the attach shape and the
        claim shape. Every pod of a session has the head's: the plan counts
        one constraint and one increment."""
        return (_attach_shape(volume), self._claim_shape(pod))

    @staticmethod
    def _claims_of(pod) -> list:
        """The pod's PVC keys and its resource claims' "dra:" keys."""
        return ([f"{pod.namespace}/{v.pvc_name}" for v in pod.volumes if v.pvc_name]
                + [f"dra:{pod.namespace}/{n}" for n in pod.resource_claims])

    def _joins_session_claims(self, fw: Framework, pod) -> bool:
        """The kernels cover `pod`, it has the session's counted-constraint
        shape and it shares no claim with a pod the session took; it is then
        recorded as taken."""
        if not pod.volumes and not pod.resource_claims:
            return self._batch_supported(fw, pod) is None and self._session_aux_shape == (None, None)
        volume = self._volume_support(pod)
        if batch_supported(pod, volume, self._dra_support(fw, pod)) is not None:
            return False
        if self._aux_shape(pod, volume) != self._session_aux_shape:
            return False
        claims = self._claims_of(pod)
        if claims:
            if any(c in self._session_claims for c in claims):
                return False
            self._session_claims.update(claims)
        return True

    def _sig_joins(self, fw: Framework, pod, sig) -> bool:
        """`pod` may join the session of signature `sig`: the same
        signature, or the same namespace-erased one (_session_compatible of
        the JAX package, :1715-1735) while that is live."""
        psig = fw.sign_pod(pod)
        if psig == sig:
            return True
        return (psig is not None and self._session_neutral_sig is not None
                and self._neutral_sig(fw, pod, psig) == self._session_neutral_sig)

    def _neutral_sig(self, fw: Framework, pod, sig):
        """The session signature with labels and namespace erased, or None
        when they may matter. The InterPodAffinity and PodTopologySpread
        Sign parts carry (labels, namespace) in [0:2] because affinity terms
        and spread selectors read them, which splits pods that build the
        same plan (a namespace sweep) into one session each. For a pod with
        no affinity or spread terms, no volumes or claims, while no pod in
        the cluster carries affinity terms (cache.affinity_pod_refs, live
        state, not the snapshot), they are scheduling-inert. The erased
        tuple is pure spec, memoized on the template's shared holder."""
        if sig is None or self.cache.affinity_pod_refs or not self.resume:
            return None
        shared = pod.__dict__.get("_sig_shared")
        key = ("_nsig", id(fw), pod.node_name)
        if shared is not None and key in shared:
            return shared[key]
        aff = pod.affinity
        if (pod.topology_spread_constraints or pod.volumes or pod.resource_claims
                or (aff is not None and (aff.pod_affinity or aff.pod_anti_affinity))):
            out = None
        else:
            out = tuple((name, part[2:] if name in ("InterPodAffinity", "PodTopologySpread")
                         else part) for name, part in sig)
        if shared is not None:
            shared[key] = out
        return out

    def _nominated_device_block(self, pod) -> Optional[str]:
        """Why `pod` cannot take the device while pods are nominated (None:
        the nominated lane covers it). The lane models the two-pass filter's
        first pass for resources only, so a pod whose filters a nominated
        pod could change otherwise (spread, affinity, or a nominated pod's
        required anti-affinity) takes the host path."""
        nom = self.queue.nominator
        if not nom.has_nominated_pods():
            return None
        reason = self._resources_only_block(pod)
        if reason is not None:
            return f"nominated pods with {reason}"
        if any(pi.required_anti_affinity_terms for pi in nom.all_nominated_pod_infos()):
            return "nominated pod carries required anti-affinity"
        return None

    def _device_unsupported_profile(self, fw: Framework, pod) -> Optional[str]:
        """Why `pod` takes the host path under `fw` (None: the device
        covers it): the kernels enforce a pod's spread constraints and
        affinity terms whatever the profile, while the host path ignores a
        term whose plugin the profile lacks; and the kernels' fit would
        count an extended resource that a DeviceClass maps as a node scalar,
        which DynamicResources may satisfy from ResourceSlices instead (the
        JAX package's :1044-1069; its branch for plugin-level default
        constraints waits for PodTopologySpread's arguments)."""
        names = {p.name for p in fw.filter_plugins}
        if pod.topology_spread_constraints and "PodTopologySpread" not in names:
            return "spread constraints without PodTopologySpread plugin"
        aff = pod.affinity
        if (aff is not None and (aff.pod_affinity or aff.pod_anti_affinity)
                and "InterPodAffinity" not in names):
            return "pod affinity without InterPodAffinity plugin"
        if fw.plugin("DynamicResources") is not None:
            req = pod.resource_request()
            if req.scalar_resources and any(
                    dc.extended_resource_name in req.scalar_resources
                    for dc in self.clientset.device_classes.values()
                    if dc.extended_resource_name):
                return "extended resources backed by DRA"
        return None

    @staticmethod
    def _resources_only_block(pod) -> Optional[str]:
        """Why `pod`'s filter verdicts depend on more than each row's
        resource arithmetic and the batch's static masks. The nominated lane
        and the dry-run kernel model other pods (a nomination counted in, a
        victim removed) as request and count deltas, exact only for pods
        without these: a victim removed can also free a host port, an
        attachment, a ReadWriteOncePod claim or a device."""
        if pod.topology_spread_constraints:
            return "spread constraints"
        aff = pod.affinity
        if aff is not None and (aff.pod_affinity or aff.pod_anti_affinity):
            return "pod affinity"
        if pod.host_ports():
            return "host ports"
        if any(v.pvc_name for v in pod.volumes) or pod.resource_claims:
            return "counted claims"
        return None

    def _nominated_lane(self, pod) -> Optional[list]:
        """[(snapshot row, PodInfo)] of the nominated pods of priority at
        least `pod`'s on nodes of the snapshot (call after
        update_snapshot), or None when there is none."""
        nom = self.queue.nominator
        if not nom.has_nominated_pods():
            return None
        index = self.snapshot._index  # node name -> row of node_info_list
        out = [(index[node], pi) for node, pis in nom.nominated_nodes().items()
               if node in index for pi in pis
               if pi.pod.priority >= pod.priority and pi.pod.uid != pod.uid]
        return out or None

    # -- plans and dispatch --------------------------------------------------

    def _profile_weights(self, fw: Framework) -> Tuple[int, ...]:
        w = {p.name: weight for p, weight in fw.score_plugins}
        return (w.get("TaintToleration", 0), w.get("NodeResourcesFit", 0),
                w.get("PodTopologySpread", 0), w.get("InterPodAffinity", 0),
                w.get("NodeResourcesBalancedAllocation", 0), w.get("NodeAffinity", 0),
                w.get("ImageLocality", 0))

    def _profile_filters(self, fw: Framework) -> Tuple[bool, ...]:
        names = {p.name for p in fw.filter_plugins}
        return tuple(n in names for n in ("NodeName", "NodeUnschedulable", "TaintToleration",
                                          "NodeAffinity", "NodeResourcesFit"))

    def build_plan(self, fw: Framework, pod, batch_size: int, volume=None):
        """Snapshot → mirror sync → batch features → device flush. Returns
        (device state, BatchPlan). `volume`: the pod's
        volume_device_support triple where the caller has it."""
        if volume is None:
            volume = self._volume_support(pod)
        self.cache.update_snapshot(self.snapshot)
        if self.mesh is not None:
            self.mirror.commit_mesh(self.mesh)
        self.mirror.sync(self.snapshot.node_info_list)
        ipa = fw.plugin("InterPodAffinity")
        names = {p.name for p in fw.filter_plugins}
        plan = build_batch(
            pod, batch_size, self.mirror, self.snapshot, self.cache.namespace_labels,
            percentage_of_nodes_to_score=self.percentage_of_nodes_to_score,
            start_index=self.next_start_node_index,
            weights=self._profile_weights(fw), filters_on=self._profile_filters(fw),
            extra_filters={n: n in names for n in ("NodePorts", "NodeDeclaredFeatures")},
            hard_pod_affinity_weight=getattr(ipa, "hard_pod_affinity_weight", 1),
            ignore_preferred_terms_of_existing_pods=getattr(
                ipa, "ignore_preferred_terms_of_existing_pods", False),
            fit_plugin=fw.plugin("NodeResourcesFit"), clientset=self.clientset,
            volume=volume, dra_in_use=self._dra_ctx(fw), nominated=self._nominated_lane(pod))
        state = self.mirror.flush()
        if self.mesh is not None:
            plan.shards = shard_features(plan.features, self.mesh)
        return state, plan

    def _shard_map_fn(self, plan):
        """The sharded lap for this plan under the mesh, or None where the
        gathered schedule_batch owns the dispatch (the JAX package's
        :1233-1248): a row-local plan above 64 steps whose rows divide over
        the shards."""
        if (self.mesh is None or not plan.row_local or plan.batch_pad <= SCAN_MAX_STEPS
                or self.mirror.np_cap % mesh_shard_count(self.mesh)):
            return None
        return sharded_lap_schedule(self.mesh, plan.batch_pad, plan.fit_strategy, plan.vmax)

    def _dispatch(self, state, plan, n_active: int, carry):
        """The only kernel call site (warm and live dispatches alike). Under a
        mesh the path is a pure function of (mesh, plan facts), so a
        session keeps one path and warm_for warms the one it runs."""
        if self.mesh is None:
            return schedule_batch(state, plan.features, plan.batch_pad, plan.fit_strategy,
                                  plan.vmax, plan.facts, n_active=n_active, carry_in=carry)
        fn = self._shard_map_fn(plan)
        if fn is not None:
            self.shard_map_dispatches += 1
            return fn(state, plan.shards, n_active, carry)
        # The counterpart of the JAX GSPMD path: the state gathered onto the
        # mesh's first device, where the carry stays for the session.
        return schedule_batch(gather(state), plan.features, plan.batch_pad, plan.fit_strategy,
                              plan.vmax, plan.facts, n_active=n_active, carry_in=carry)

    def warm_for(self, pod) -> None:
        """Build the kernels and run both the fresh-carry and the chained
        dispatch of a `pod`-shaped session with no active pods (fully
        inert), so that set-up lands outside a measured window. A plan
        whose anti-affinity is row-local also launches its conservative
        fallback (`anti_rowlocal` off: the general scan) once, inert, so
        that a later plan that takes it (once a node shares a value of the
        axis) does not pay the kernel's first load (the JAX package's
        warm_for, :1119-1165, which warms both carries of it because each
        is an XLA compile; here one library holds every kernel). The
        nominated-lane variant of the plan, with an empty lane, is launched
        too (:1168-1180)."""
        fw = self.framework_for_pod(pod)
        if self._batch_supported(fw, pod) is not None:
            return
        state, plan = self.build_plan(fw, pod, self.max_batch)
        whole = state if self.mesh is None else gather(state)
        variants = [plan]
        if not plan.features.nom_req.shape[0]:
            f = plan.features._replace(nom_req=torch.zeros_like(whole.req_r),
                                       nom_pods=torch.zeros_like(whole.pod_count))
            # Under a mesh the lane is sharded like the live one (:1178-1186).
            variants.append(dataclasses.replace(
                plan, features=f, shards=None if self.mesh is None else shard_features(
                    f, self.mesh)))
        dispatches = self.shard_map_dispatches  # warm dispatches are not engagement
        for v in variants:
            _results, carry = self._dispatch(state, v, 0, None)
            results, _ = self._dispatch(state, v, 0, carry)
            Fetch(results).wait()
        self.shard_map_dispatches = dispatches
        if plan.facts.anti_rowlocal:
            fallback = dataclasses.replace(
                plan, facts=plan.facts._replace(anti_rowlocal=False))
            results, _ = self._dispatch(state, fallback, 0, None)
            Fetch(results).wait()

    # -- incremental session resume (typed event journal) --------------------

    def _count_rebuild(self, kind: str) -> None:
        if kind == "full":
            self.plan_rebuilds_full += 1
        elif kind == "delta":
            self.plan_rebuilds_delta += 1
        else:
            self.plan_rebuilds_resume += 1

    def _nom_resume_key(self, priority: int):
        """The nomination part of the resume key: the nominated set's
        version, and the lane's priority threshold while a lane is live."""
        nom = self.queue.nominator
        return (nom.version, priority if nom.has_nominated_pods() else None)

    def _classify_delta(self, events, plan):
        """Map journal events onto what they dirty under `plan`: (level,
        dirty node names) with level 'benign' (nothing node-side moved),
        'safe' (row patches whose events only enlarge feasibility, so
        in-flight results stay committable) or 'strict' (row patches that
        may shrink it: applied with an empty pipeline only), or None when an
        event needs the full rebuild."""
        level = 0
        names = set()
        for ev in events:
            if ev.kind == EV_QUEUE:
                continue
            if ev.kind == EV_NAMESPACE:
                # Namespace labels feed only affinity namespaceSelector
                # matching: inert while no term exists on either side.
                if plan.pod_local and self.cache.affinity_pod_refs == 0:
                    continue
                return None
            if ev.kind in (EV_POD_ADD, EV_POD_REMOVE, EV_POD_UPDATE):
                # pod_local: a pod on node n dirties only row n's aggregates;
                # pod_plain: it brings no term a feature table would count.
                if not (plan.pod_local and ev.pod_plain):
                    return None
                if ev.pod_ports and plan.facts.port_selfblock:
                    return None  # the ports in use moved under a port-aware plan
            elif ev.kind == EV_NODE_UPDATE:
                if not plan.pod_local:
                    return None  # the spread tables' Honor policies read taints
            else:
                return None
            names.add(ev.key)
            level = max(level, 1 if ev.shrink else 2)
        return ("benign", "safe", "strict")[level], names

    def _note_session_events(self, sd: _SessionDelta, plan, node_names, busy: bool) -> bool:
        """Consume the journal since the session's watermark. True when the
        session stays valid (a benign advance, a patch applied, or a patch
        deferred until the pipeline drains), False when it must end. `busy`:
        dispatched batches whose results are not committed yet."""
        if self.cluster_event_seq == sd.start_seq and not sd.patch_pending:
            return True
        if not self.resume:
            return False
        events = self.journal.since(sd.start_seq)
        cls = self._classify_delta(events, plan) if events is not None else None
        if cls is None:
            return False
        level, names = cls
        if not names:
            sd.start_seq = self.cluster_event_seq
            sd.patch_pending = False
            return True
        if busy:
            if level == "strict":
                return False  # in-flight results may no longer fit
            # The in-flight placements are in the carry but not yet in host
            # staging: patch once they are committed.
            sd.patch_pending = True
            return True
        t0 = time.perf_counter()
        patched = self._apply_delta_patch(plan, node_names, names, sd.state, sd.carry)
        self.plan_acquire_s += time.perf_counter() - t0
        if patched is None:
            return False
        sd.state, sd.carry = patched
        sd.start_seq = self.cluster_event_seq
        sd.patch_pending = False
        self._count_rebuild("delta")
        return True

    def _apply_delta_patch(self, plan, node_names, names, state, carry):
        """Patch the dirty rows of `names` into host staging, the device
        state (NodeStateMirror.patch_rows) and the carry
        (NodeStateMirror.patch_carry): one upload and one launch each.
        Returns (state, carry), or None when the patch cannot apply; the
        caller then rebuilds in full, which recovers from every such case.
        Under a mesh (the JAX package's :1534-1561) the sharded resident is
        patched shard by shard, in place, and the carry where it lies
        (patch_carry_rows_pinned): no dispatched batch reads the state here,
        since _note_session_events defers a patch while one is in flight."""
        if not names:
            return state, carry
        row_of = self._session_row_of
        if row_of is None or row_of[0] is not node_names:
            row_of = (node_names, {n: i for i, n in enumerate(node_names)})
            self._session_row_of = row_of
        updates = []
        for nm in sorted(names):
            row = row_of[1].get(nm)
            ni = self.cache.nodes.get(nm)
            if row is None or ni is None or ni.node is None:
                return None  # the row set changed shape: structural after all
            updates.append((row, ni))
        if self.mesh is not None:
            new_state = self.mirror.patch_rows(updates, sharded_state=state)
        else:
            new_state = self.mirror.patch_rows(updates)
        if new_state is None:
            return None
        m = self.mirror
        rows = sorted({r for r, _ in updates})
        if not plan.facts.has_pns and (m.h_taint_eff[rows] == EFFECT_PREFER_NO_SCHEDULE).any():
            # The plan was built without the PreferNoSchedule lane; staging
            # is patched already, so the full rebuild starts from truth.
            return None
        if carry is not None:
            carry = m.patch_carry(new_state, plan.features if self.mesh is None else plan.shards,
                                  carry, rows, plan.fit_strategy)
        self.delta_dirty_rows += len(rows)
        return new_state, carry

    def _resume_or_rebuild(self, fw: Framework, head_pod, sig, nsig, volume):
        """A session's plan: the previous clean session's, resumed as it is
        or after the journal's row patches, else a full rebuild. The
        signature covers no volume or claim, so the key also holds the
        head's counted-constraint shape (_aux_shape, from its
        volume_device_support triple `volume`): a volume or claim plan never
        resumes for plain pods, nor a plain plan for them; and the claims'
        revision, since a plan's free-device counts are stale once a claim
        is written or allocated out of band. Returns (state, plan, carry,
        node_names, kind)."""
        t0 = time.perf_counter()
        aux_shape = self._aux_shape(head_pod, volume)
        resume, self._resume = self._resume, None
        kind = "full"
        state = plan = carry = node_names = None
        if resume is not None and self.resume:
            rkey, rseq, payload, rnom = resume
            sig_ok = rkey[1] == (sig if rkey[0] == "exact" else nsig)
            if (sig_ok and rkey[2:] == (id(fw), aux_shape, self.clientset.resource_claims_rv,
                                        self.attempts, self.state_unwinds)
                    and rnom == self._nom_resume_key(head_pod.priority)):
                state, plan, carry, node_names = payload
                if rseq == self.cluster_event_seq:
                    kind = "resume"
                else:
                    events = self.journal.since(rseq)
                    cls = self._classify_delta(events, plan) if events is not None else None
                    if cls is not None:
                        # No batch is in flight at a session's start: every
                        # level may patch here.
                        patched = self._apply_delta_patch(plan, node_names, cls[1], state, carry)
                        if patched is not None:
                            state, carry = patched
                            kind = "delta"
                if kind == "full":
                    carry = None
        if kind == "full":
            t1 = time.perf_counter()
            state, plan = self.build_plan(fw, head_pod, self.max_batch, volume)
            self.plan_build_s += time.perf_counter() - t1
            node_names = [ni.name for ni in self.snapshot.node_info_list]
        self._count_rebuild(kind)
        self.plan_acquire_s += time.perf_counter() - t0
        return state, plan, carry, node_names, kind

    def _save_resume(self, fw: Framework, head_pod, sig, aux_shape, state, plan, carry,
                     node_names, neutral: bool = True) -> None:
        """Keep a clean session's end state for the next session's resume
        check, under the neutral signature where it is eligible (and
        `neutral`: gang sessions stay exact)."""
        nsig = self._neutral_sig(fw, head_pod, sig) if neutral else None
        mode = ("neutral", nsig) if nsig is not None else ("exact", sig)
        self._resume = (mode + (id(fw), aux_shape, self.clientset.resource_claims_rv,
                                self.attempts, self.state_unwinds),
                        self.cluster_event_seq,
                        (state, plan, carry, node_names),
                        self._nom_resume_key(head_pod.priority))

    # -- device session ------------------------------------------------------

    def _run_device_session(self, fw: Framework, first_batch: List[QueuedPodInfo]) -> None:
        head = first_batch[0].pod
        sig = fw.sign_pod(head)
        nsig = self._neutral_sig(fw, head, sig)
        self._session_neutral_sig = nsig
        volume = self._session_volume  # the head's, from _collect_batch
        aux_shape = self._aux_shape(head, volume)
        state, plan, carry, node_names, _kind = self._resume_or_rebuild(fw, head, sig, nsig,
                                                                        volume)
        sd = _SessionDelta(state, carry, self.cluster_event_seq)
        del state, carry
        start_nom = self.queue.nominator.version
        start_attempts = self.attempts
        inflight: List[Tuple[List[QueuedPodInfo], Fetch]] = []
        ok_rows: List[int] = []
        dirty_rows: List[int] = []
        invalidated = False
        batch: Optional[List[QueuedPodInfo]] = first_batch
        while True:
            # Refill the pipeline: dispatch enqueues device work and returns.
            while not invalidated and len(inflight) < PIPELINE_DEPTH:
                if sd.patch_pending:
                    if inflight:
                        break  # retire the dispatched batches before patching
                    if not self._note_session_events(sd, plan, node_names, busy=False):
                        invalidated = True
                        break
                if batch is None:
                    t1 = time.perf_counter()
                    batch = self._collect_session_batch(fw, sig) or None
                    if batch is None and self._event_inbox and self.resume:
                        # Events parked while the session ran (pod creations
                        # among them): replay them here, so that a creation
                        # burst does not end the session, and patch or end
                        # it on what they changed. (Without resume they wait
                        # for the next session.)
                        self.drain_event_inbox()
                        if not self._note_session_events(sd, plan, node_names,
                                                         busy=bool(inflight)):
                            invalidated = True
                        elif not sd.patch_pending:
                            batch = self._collect_session_batch(fw, sig) or None
                    self.collect_s += time.perf_counter() - t1
                    if sd.patch_pending and batch is None and not invalidated:
                        continue  # patch (or drain) before collecting
                    if batch is None:
                        break
                t1 = time.perf_counter()
                results, sd.carry = self._dispatch(sd.state, plan, len(batch), sd.carry)
                inflight.append((batch, Fetch(results)))
                self.dispatch_s += time.perf_counter() - t1
                self.device_batches += 1
                batch = None
            if not inflight:
                break
            # Retire the oldest batch while the device computes the next.
            b, fetch = inflight.pop(0)
            t1 = time.perf_counter()
            res = fetch.wait()
            t2 = time.perf_counter()
            self.device_wait_s += t2 - t1
            if not invalidated:
                invalidated = self._commit_batch(b, res, fw, node_names, ok_rows, dirty_rows)
                # A change to the nominated set, or a cluster event the
                # journal cannot patch in, ends the chain.
                if not invalidated and (
                        self.queue.nominator.version != start_nom
                        or not self._note_session_events(sd, plan, node_names,
                                                         busy=bool(inflight))):
                    invalidated = True
                self.host_commit_s += time.perf_counter() - t2
            else:
                # A previous batch diverged: every later device choice is
                # stale. Host-path the pods and charge their rows dirty.
                for i, qpi in enumerate(b):
                    if int(res[0, i]) >= 0:
                        dirty_rows.append(int(res[0, i]))
                    self.host_path_pods += 1
                    self.process_one(qpi)
        if batch:  # popped but never dispatched (invalidated mid-refill)
            for qpi in batch:
                self.host_path_pods += 1
                self.process_one(qpi)
        t3 = time.perf_counter()
        self.cache.update_snapshot(self.snapshot)
        if invalidated:
            # Staging is the authority again: full re-encode + upload.
            self.mirror.invalidate()
        elif sd.carry is not None:
            # The final carry holds every placement: keep it resident, and
            # keep the session's plan for the next one.
            self._adopt(ok_rows, sd.carry, dirty_rows)
            if not dirty_rows:
                self._save_resume(fw, head, sig, aux_shape, sd.state, plan, sd.carry, node_names)
                # The last commit went through cleanly, so the carry is the
                # kernel's truth for the next identical pod: seed the walker.
                if self._hints.enabled and hint_eligible(
                        plan, aux_shape, head, self.queue.nominator,
                        self.cache.affinity_pod_refs):
                    self._hints.install(fw, head, sig, nsig, plan, node_names, sd.carry,
                                        landed=(start_attempts, ok_rows))
        self.session_end_s += time.perf_counter() - t3

    def _adopt(self, ok_rows: List[int], carry, dirty_rows: List[int]) -> None:
        """Keep the session's final carry as the mirror's resident aggregates
        (a sharded carry's lanes shard by shard)."""
        if isinstance(carry, Sharded):
            lanes = ([p.req_r for p in carry.parts], [p.nonzero for p in carry.parts],
                     [p.pod_count for p in carry.parts])
        else:
            lanes = (carry.req_r, carry.nonzero, carry.pod_count)
        self.mirror.adopt(self.snapshot.node_info_list, ok_rows, *lanes, dirty_rows=dirty_rows)

    def _commit_batch(self, b, res, fw, node_names, ok_rows, dirty_rows) -> bool:
        """Host tail for one retired batch. Returns True when the session
        must invalidate (host/device divergence or host-path interleaving);
        rows the carry charged but the host did not are added to
        `dirty_rows`."""
        invalidated = False
        for i, qpi in enumerate(b):
            row = int(res[0, i])
            self.next_start_node_index = int(res[1, i])
            if invalidated:
                if row >= 0:
                    dirty_rows.append(row)
                self.host_path_pods += 1
                self.process_one(qpi)
                continue
            if row < 0:
                if self._fail_from_memo(fw, qpi):
                    # An identical pod failed against this very state: park
                    # it with that diagnosis. Nothing moved, so the session
                    # goes on (an unschedulable flood does not end it).
                    continue
                if self._fail_with_vector_diagnosis(fw, qpi):
                    # Without a nomination no state moved and the session
                    # continues; a preemption ends it.
                    if qpi.pod.nominated_node_name or qpi.pod.node_name:
                        invalidated = True
                    else:
                        self._memoize_failure(fw, qpi)
                    continue
                # Exact host rerun for the diagnosis; the chain cannot go on.
                self.host_path_pods += 1
                self.process_one(qpi)
                self._memoize_failure(fw, qpi)
                invalidated = True
                continue
            if self._commit(fw, qpi, node_names[row]):
                ok_rows.append(row)
            else:
                dirty_rows.append(row)
                invalidated = True  # the host rejected what the carry applied
        return invalidated

    def _fail_state_key(self, fw: Framework, pod) -> tuple:
        """Everything a pod's failure can depend on, versioned: its spec
        (the signature), its priority (PostFilter's preemption reads it),
        cluster events, our own binds, cache unwinds and the nominated set
        (the JAX package's :2016-2026)."""
        return (fw.sign_pod(pod), pod.priority, self.cluster_event_seq, self.scheduled,
                self.state_unwinds, self.queue.nominator.version)

    def _fail_from_memo(self, fw: Framework, qpi: QueuedPodInfo) -> bool:
        """An identical pod was diagnosed unschedulable against this state
        with no side effect (no nomination, no bind): a rerun would give the
        same diagnosis, so park the pod with it. Counts an attempt and a
        failure, as the rerun would."""
        memo = self._fail_memo.get(self._fail_state_key(fw, qpi.pod))
        if memo is None:
            return False
        plugins, message = memo
        self.memo_hits += 1
        self.attempts += 1
        qpi.unschedulable_plugins |= plugins
        self.handle_scheduling_failure(fw, qpi, Status.unschedulable(message), None)
        self.queue.done(qpi.pod.uid)
        return True

    def _memoize_failure(self, fw: Framework, qpi: QueuedPodInfo) -> None:
        """Keep a diagnosis that ended the attempt with no side effect, keyed
        on the state after it. An attempt that moved state (a bind, a
        nomination) changes the key, so a stale entry is never served; the
        cap only bounds memory."""
        pod = qpi.pod
        if pod.node_name or pod.nominated_node_name:
            return  # scheduled after all, or nominated: state moved
        if len(self._fail_memo) >= FAIL_MEMO_CAP:
            self._fail_memo.pop(next(iter(self._fail_memo)))
        self._fail_memo[self._fail_state_key(fw, pod)] = (
            frozenset(qpi.unschedulable_plugins),
            f"0/{self.snapshot.num_nodes()} nodes are available")

    def _fail_with_vector_diagnosis(self, fw: Framework, qpi: QueuedPodInfo) -> bool:
        """The FitError tail for a device-infeasible pod, with the Diagnosis
        built from the mirror's staging arrays, then PostFilter. False when
        the vectorized diagnosis cannot attribute the failure or pods are
        nominated (it does not model the two-pass filter): the host rerun
        owns those."""
        if self.queue.nominator.has_nominated_pods():
            return False
        self.cache.update_snapshot(self.snapshot)
        self.mirror.sync(self.snapshot.node_info_list)
        diag = diagnose_unschedulable(qpi.pod, self.mirror, self.snapshot, fw)
        if diag is None:
            return False
        self.attempts += 1
        self.handle_fit_error(fw, CycleState(), qpi,
                              FitError(qpi.pod, self.snapshot.num_nodes(), diag))
        return True

    # -- gang device sessions ------------------------------------------------
    #
    # A pod group of the default algorithm (no topology constraint) is
    # member-wise greedy placement with an all-or-nothing commit
    # (schedule_one_podgroup.go:556): the kernels' scan with a group-granular
    # commit barrier. Groups of identical members ride a session like plain
    # pods (the JAX package's models/tpu_scheduler.py:302-563): whole groups
    # pack into each dispatch, the carry chains across packs, and each
    # retired group commits at once; a group with a member the device placed
    # nowhere takes the exact host group cycle (diagnosis, PodGroupPostFilter)
    # and the session ends.

    def _gang_device_eligible(self, qgpi: QueuedPodGroupInfo, session=None):
        """(fw, sig) when the whole group can ride a gang device session:
        the default algorithm, no nominated pods, members of one profile
        and one signature that the kernels cover, no more than max_batch of
        them, one attach shape, claims distinct among the members, and no
        resource claims (a member's device allocation at the commit could
        fail halfway through the group).
        `session`: the live session's (claims, attach shape), which the
        group must share the shape of (None, no attach limit, included) and
        none of the claims of. Else (None, None)."""
        if not qgpi.members or len(qgpi.members) > self.max_batch:
            return None, None
        if self.queue.nominator.has_nominated_pods():
            return None, None
        p0 = qgpi.members[0].pod
        if p0.scheduler_name not in self.profiles:
            return None, None
        fw = self.framework_for_pod(p0)
        if fw.placement_generate_plugins and qgpi.group.topology_keys:
            return None, None  # the placement algorithm
        sig = fw.sign_pod(p0)
        if sig is None:
            return None, None
        volumes = [self._volume_support(m.pod) for m in qgpi.members]
        aux_shape = self._aux_shape(p0, volumes[0])
        if session is not None and aux_shape != session[1]:
            return None, None  # the live session's plan models one shape
        group_claims: set = set()
        for m, volume in zip(qgpi.members, volumes):
            if (m.pod.scheduler_name != p0.scheduler_name or fw.sign_pod(m.pod) != sig
                    or m.pod.resource_claims
                    or batch_supported(m.pod, volume) is not None
                    or self._device_unsupported_profile(fw, m.pod) is not None
                    or self._aux_shape(m.pod, volume) != aux_shape):
                return None, None
            for c in self._claims_of(m.pod):
                if c in group_claims or (session is not None and c in session[0]):
                    return None, None  # a shared claim: the host counts it once
                group_claims.add(c)
        return fw, sig

    @staticmethod
    def _sorted_members(qgpi: QueuedPodGroupInfo) -> List[QueuedPodInfo]:
        """The host group cycle's member order (schedule_pod_group)."""
        return sorted(qgpi.members, key=lambda m: (-m.pod.priority, m.timestamp))

    def _run_gang_device_session(self, fw: Framework, first: QueuedPodGroupInfo) -> None:
        """A gang device session from the group `first`: packs of eligible
        groups of its signature, up to max_batch members a dispatch, up to
        PIPELINE_DEPTH dispatches in flight, each retired group committed
        whole. The journal is consumed as in _run_device_session (patch,
        defer or end); an event parked in the inbox is replayed when the
        queue runs dry. A failing kernel raises: there is no host fallback
        to hide it."""
        head = first.members[0].pod
        sig = fw.sign_pod(head)
        self._session_neutral_sig = None  # gang sessions stay exact-signature
        volume = self._volume_support(head)
        aux_shape = self._aux_shape(head, volume)
        self._session_claims = {c for m in first.members for c in self._claims_of(m.pod)}
        state, plan, carry, node_names, _kind = self._resume_or_rebuild(fw, head, sig, None,
                                                                        volume)
        sd = _SessionDelta(state, carry, self.cluster_event_seq)
        del state, carry
        start_unwinds = self.state_unwinds
        inflight: List[Tuple[List[QueuedPodGroupInfo], Fetch]] = []
        ok_rows: List[int] = []
        dirty_rows: List[int] = []
        invalidated = False
        pack: Optional[List[QueuedPodGroupInfo]] = [first]

        def collect_pack() -> List[QueuedPodGroupInfo]:
            groups, total = [], 0
            while True:
                nxt = self._pop()
                if nxt is None:
                    break
                if isinstance(nxt, QueuedPodGroupInfo):
                    gfw, gsig = self._gang_device_eligible(
                        nxt, session=(self._session_claims, aux_shape))
                    if gfw is fw and gsig == sig and total + len(nxt.members) <= self.max_batch:
                        groups.append(nxt)
                        total += len(nxt.members)
                        self._session_claims.update(c for m in nxt.members
                                                    for c in self._claims_of(m.pod))
                        continue
                self._holdover = nxt
                break
            return groups

        while True:
            while not invalidated and len(inflight) < PIPELINE_DEPTH:
                if sd.patch_pending:
                    if inflight:
                        break  # retire the dispatched packs before patching
                    if not self._note_session_events(sd, plan, node_names, busy=False):
                        invalidated = True
                        break
                if pack is None:
                    t1 = time.perf_counter()
                    pack = collect_pack() or None
                    if pack is None and self._event_inbox and self.resume:
                        self.drain_event_inbox()
                        if not self._note_session_events(sd, plan, node_names,
                                                         busy=bool(inflight)):
                            invalidated = True
                        elif not sd.patch_pending:
                            pack = collect_pack() or None
                    self.collect_s += time.perf_counter() - t1
                    if sd.patch_pending and pack is None and not invalidated:
                        continue
                    if pack is None:
                        break
                members = [m for g in pack for m in self._sorted_members(g)]
                t1 = time.perf_counter()
                results, sd.carry = self._dispatch(sd.state, plan, len(members), sd.carry)
                inflight.append((pack, Fetch(results)))
                self.dispatch_s += time.perf_counter() - t1
                self.device_batches += 1
                pack = None
            if not inflight:
                break
            groups, fetch = inflight.pop(0)
            t1 = time.perf_counter()
            res = fetch.wait()
            t2 = time.perf_counter()
            self.device_wait_s += t2 - t1
            # The pack's placements are not in the cache yet: a patch waits.
            if (invalidated or self.state_unwinds != start_unwinds
                    or not self._note_session_events(sd, plan, node_names, busy=True)):
                invalidated = True
                for g in groups:
                    self.host_path_pods += len(g.members)
                    self.process_one(g)
                continue
            i = 0
            for g in groups:
                ms = self._sorted_members(g)
                rows = res[0, i:i + len(ms)]
                self.next_start_node_index = int(res[1, i + len(ms) - 1])
                i += len(ms)
                if invalidated or (rows < 0).any():
                    # A member placed nowhere (or an earlier group diverged):
                    # the rows the carry took are dirty, and the exact host
                    # group cycle owns the group.
                    dirty_rows.extend(int(r) for r in rows if r >= 0)
                    self.host_path_pods += len(ms)
                    self.process_one(g)
                    invalidated = True
                    continue
                if not self._commit_gang_group(fw, g, ms, rows, node_names, ok_rows, dirty_rows):
                    invalidated = True  # the host rejected a placement the carry applied
                if (self.state_unwinds != start_unwinds
                        or not self._note_session_events(sd, plan, node_names, busy=True)):
                    invalidated = True
                    sd.start_seq = self.cluster_event_seq
                    start_unwinds = self.state_unwinds
            self.host_commit_s += time.perf_counter() - t2
        if pack:  # popped but never dispatched (invalidated mid-refill)
            for g in pack:
                self.host_path_pods += len(g.members)
                self.process_one(g)
        t3 = time.perf_counter()
        self.cache.update_snapshot(self.snapshot)
        if invalidated:
            self.mirror.invalidate()
        elif sd.carry is not None:
            self._adopt(ok_rows, sd.carry, dirty_rows)
            if not dirty_rows:
                self._save_resume(fw, head, sig, aux_shape, sd.state, plan, sd.carry,
                                  node_names, neutral=False)
        self.session_end_s += time.perf_counter() - t3

    def _commit_gang_group(self, fw: Framework, qgpi: QueuedPodGroupInfo,
                           members: List[QueuedPodInfo], rows, node_names,
                           ok_rows: List[int], dirty_rows: List[int]) -> bool:
        """Every member placed on the device: the group commit of
        schedule_pod_group's tail (assume, Reserve → Permit → binding cycle
        per member, the group's bookkeeping). False when a member's commit
        failed: the carry holds that placement, so the session must end."""
        self.attempts += 1
        committed = 0
        attempted = set()
        for m, r in zip(members, rows):
            attempted.add(m.pod.uid)
            node = node_names[int(r)]
            m.pod.node_name = node
            self.cache.assume_pod(m.pod, m.pod_info)
            if self._commit_group_member(fw, m, CycleState(), ScheduleResult(suggested_host=node)):
                committed += 1
                ok_rows.append(int(r))
                self.device_scheduled += 1
            else:
                dirty_rows.append(int(r))
        self.queue.clear_group_members((qgpi.group.namespace, qgpi.group.name), attempted)
        self.queue.done(qgpi.uid)
        return committed == len(members)

    # -- placement groups: every candidate placement in one launch -------------

    @staticmethod
    def _placement_plan_restriction_invariant(plan) -> bool:
        """The plan can be evaluated per placement on the device: restricting
        the node universe to a placement's rows restricts it exactly. Fit,
        balance, taints and node-affinity preference are row-local; the
        spread tables are rebuilt per placement (_placement_spread_overrides).
        Inter-pod-affinity tables (term matches against the restricted pod
        sets) and image locality stay on the host."""
        f = plan.features
        return (f.anti_axis.shape[0] == 0 and f.aff_axis.shape[0] == 0
                and f.ipa_axis.shape[0] == 0 and not plan.facts.has_ipa_base
                and not bool(f.il_score.any()))

    def _placement_spread_overrides(self, plan, placements, index):
        """Each placement's restricted spread tables (the host's PreFilter
        and PreScore spread state over assume_placement's node list), from
        the plan's per-node columns: the spread_overrides of
        schedule_placements, or None when the plan has no spread table."""
        f = plan.features
        c1p, c2p = f.dns_axis.shape[0], f.sa_axis.shape[0]
        if c1p == 0 and c2p == 0:
            return None
        vmax = plan.vmax
        p_pad = _pow2(len(placements))
        n = len(self.snapshot.node_info_list)
        dns_axis = f.dns_axis.cpu().numpy()
        sa_axis = f.sa_axis.cpu().numpy()
        dns_counts = np.zeros((p_pad, c1p, vmax), np.int32)
        dns_dom = np.zeros((p_pad, c1p, vmax), bool)
        dns_forced0 = np.ones((p_pad, c1p), np.int32)  # padded rows: minimum 0
        sa_counts = np.zeros((p_pad, c2p, vmax), np.int32)
        sa_wq = np.zeros((p_pad, c2p), np.int64)
        nc1 = 0 if plan.dns_node_counts is None else plan.dns_node_counts.shape[0]
        nc2 = 0 if plan.sa_node_counts is None else plan.sa_node_counts.shape[0]
        for pi, placement in enumerate(placements):
            rows = np.array([r for name in placement.node_names
                             if (r := index.get(name)) is not None and r < n], np.int64)
            for ci in range(nc1):
                vids = self.mirror.h_topo[dns_axis[ci], rows]
                elig = plan.dns_node_elig[ci, rows]
                ev = vids[elig]
                np.add.at(dns_counts[pi, ci], ev, plan.dns_node_counts[ci, rows][elig])
                dns_dom[pi, ci, ev] = True
                nd = np.unique(ev).size
                md = plan.dns_min_domains[ci]
                dns_forced0[pi, ci] = 1 if (nd == 0 or (md is not None and nd < md)) else 0
            for ci in range(nc2):
                vids = self.mirror.h_topo[sa_axis[ci], rows]
                live = plan.sa_node_live[rows]
                lv = vids[live]
                np.add.at(sa_counts[pi, ci], lv, plan.sa_node_counts[ci, rows][live])
                size = int(live.sum()) if plan.sa_hostname_axis[ci] else np.unique(lv).size
                sa_wq[pi, ci] = int(round(math.log(size + 2) * 1024))
        dev = self.device
        return tuple(torch.from_numpy(a).to(dev)
                     for a in (dns_counts, dns_dom, dns_forced0, sa_counts, sa_wq))

    def _evaluate_placements(self, fw: Framework, pg_state, group, members, placements):
        """Every candidate placement evaluated in one schedule_placements
        launch (the JAX package's :635-758), then gated with
        PlacementFeasible as the host loop does. The host loop evaluates
        them instead (its members counted as host-path pods) while pods are
        nominated, for members of differing or uncovered specs or with
        PVC-backed volumes (the simulation does not count a claim two
        members share once), and for a plan outside the restriction
        invariant, and for members with resource claims (the commit
        allocates their devices from the simulation's DynamicResources
        state)."""
        host = False
        if self.queue.nominator.has_nominated_pods():
            host = True
        p0 = members[0].pod
        sig = fw.sign_pod(p0)
        if sig is None or any(fw.sign_pod(m.pod) != sig
                              or self._batch_supported(fw, m.pod) is not None
                              or self._device_unsupported_profile(fw, m.pod) is not None
                              or any(v.pvc_name for v in m.pod.volumes) or m.pod.resource_claims
                              for m in members):
            host = True
        plan = None
        if not host:
            # Across group cycles the plan depends only on node state and
            # the pod spec, while the cluster-event version stands: our own
            # commits move per-node aggregates, which reach the device
            # through the mirror's dirty rows, not the feature tables.
            cache = self._placement_plan_cache
            ckey = (id(fw), sig, len(members), self.cluster_event_seq, self.mirror.np_cap)
            if cache is not None and cache[0] == ckey:
                plan = cache[1]
                self.cache.update_snapshot(self.snapshot)
                self.mirror.sync(self.snapshot.node_info_list)
                state = self.mirror.flush()
            else:
                state, plan = self.build_plan(fw, p0, len(members))
                host = not self._placement_plan_restriction_invariant(plan)
                # Spread-carrying plans are not kept: their per-node match
                # counts move with every commit of a matching pod; nor are
                # port-aware or attach-counting ones: their extra_ok and
                # aux_room move with every commit of a member.
                keep = (not host and not plan.facts.port_selfblock and not plan.facts.has_aux
                        and plan.dns_node_counts is None and plan.sa_node_counts is None)
                self._placement_plan_cache = ((id(fw), sig, len(members), self.cluster_event_seq,
                                               self.mirror.np_cap), plan) if keep else None
            if self.mesh is not None:
                state = gather(state)
        if host:
            self.host_path_pods += 1  # the group entity, once (as the JAX package counts it)
            return super()._evaluate_placements(fw, pg_state, group, members, placements)
        t0 = time.perf_counter()
        index = self.snapshot._index
        if len(index) != len(self.snapshot.node_info_list):
            index = {ni.name: i for i, ni in enumerate(self.snapshot.node_info_list)}
        npc = self.mirror.np_cap
        p_pad = _pow2(len(placements))
        # The candidates of one topology key repeat across a stream of
        # identical groups: their row masks stay on the device.
        mkey = (self.cluster_event_seq, p_pad, npc,
                tuple(tuple(p.node_names) for p in placements))
        if self._placement_mask_cache is not None and self._placement_mask_cache[0] == mkey:
            masks = self._placement_mask_cache[1]
        else:
            host_masks = np.zeros((p_pad, npc), bool)
            for pi, placement in enumerate(placements):
                for name in placement.node_names:
                    row = index.get(name)
                    if row is not None:
                        host_masks[pi, row] = True
            masks = torch.from_numpy(host_masks).to(self.device)
            self._placement_mask_cache = (mkey, masks)
        res = schedule_placements(
            state, plan.features, plan.batch_pad, plan.fit_strategy, plan.vmax, plan.facts,
            masks, len(members), self._placement_spread_overrides(plan, placements, index))
        res = Fetch(res).wait()  # [P, 2, B]
        self.placement_device_evals += 1
        self.placement_eval_s += time.perf_counter() - t0
        node_names = [ni.name for ni in self.snapshot.node_info_list]
        candidates = []
        for pi, placement in enumerate(placements):
            placed = [(m, int(r)) for m, r in zip(members, res[pi, 0, :len(members)]) if r >= 0]
            progress = PlacementProgress(len(placed), len(members) - len(placed), len(members))
            if not placed or not fw.run_placement_feasible_plugins(
                    pg_state, group, progress).is_success():
                continue
            # Covered members carry no plugin simulation state: a fresh
            # CycleState is what the host simulation leaves them.
            assignment = {m.pod.uid: (node_names[r], CycleState()) for m, r in placed}
            candidates.append((placement, assignment, PodGroupAssignments(
                placement,
                proposed=[(m.pod, assignment[m.pod.uid][0]) for m in members
                          if m.pod.uid in assignment],
                nodes=[self.snapshot.get(n) for n in placement.node_names])))
        return candidates

    def warm_for_placements(self, pod, group_size: int, n_placements: int) -> None:
        """Build the kernels and launch schedule_placements once with no
        active member (every lane inert) at the tiers a placement workload
        of `pod`-shaped groups of `group_size` over `n_placements`
        candidates will use, so that set-up lands outside a measured window
        (the JAX package's warm_for_placements, :1193-1228)."""
        fw = self.framework_for_pod(pod)
        if self._batch_supported(fw, pod) is not None:
            return
        state, plan = self.build_plan(fw, pod, group_size)
        if not self._placement_plan_restriction_invariant(plan):
            return
        if self.mesh is not None:
            state = gather(state)
        p_pad = _pow2(max(1, n_placements))
        f, dev = plan.features, self.device
        masks = torch.zeros((p_pad, self.mirror.np_cap), dtype=torch.bool, device=dev)
        overrides = None
        if f.dns_axis.shape[0] or f.sa_axis.shape[0]:
            c1, c2, v = f.dns_axis.shape[0], f.sa_axis.shape[0], plan.vmax
            overrides = (torch.zeros((p_pad, c1, v), dtype=torch.int32, device=dev),
                         torch.zeros((p_pad, c1, v), dtype=torch.bool, device=dev),
                         torch.ones((p_pad, c1), dtype=torch.int32, device=dev),
                         torch.zeros((p_pad, c2, v), dtype=torch.int32, device=dev),
                         torch.zeros((p_pad, c2), dtype=torch.int64, device=dev))
        res = schedule_placements(state, f, plan.batch_pad, plan.fit_strategy, plan.vmax,
                                  plan.facts, masks, 0, overrides)
        Fetch(res).wait()

    # -- device preemption dry run -------------------------------------------

    def device_dry_run_preemption(self, fw: Framework, state, pod, node_to_status,
                                  num_candidates: int, start: int) -> Optional[List[Candidate]]:
        """Batched DryRunPreemption: every node's minimal victim set in one
        dry_run_preemption launch, in place of the host Evaluator's per-node
        loop (preemption.go:425). Returns the candidates in rotation order
        from `start`, at most `num_candidates`, skipping the nodes whose
        rejection no eviction resolves; or None where the exact host dry
        run decides by rule: a preemptor with spread or affinity terms or
        host ports, a cluster with anti-affinity pods (a victim's removal could lift
        them), a pod the kernels do not cover, no lower-priority pod at all,
        or a node with more than PREEMPT_K_CAP of them. A kernel that fails
        raises."""
        if (self._resources_only_block(pod) is not None
                or self._device_unsupported_profile(fw, pod) is not None):
            return None
        self.cache.update_snapshot(self.snapshot)
        nodes = self.snapshot.node_info_list
        if any(ni.pods_with_required_anti_affinity for ni in nodes):
            return None
        self.mirror.sync(nodes)
        built = build_preemption_victims(pod, self.snapshot, self.mirror)
        if built is None:
            return None
        vic_req, vic_valid, potential = built
        try:
            dstate, plan = self.build_plan(fw, pod, 1)
        except Unsupported:
            return None
        if self.mesh is not None:
            dstate = gather(dstate)
        r_slots = self.mirror.r_slots
        if vic_req.shape[2] != r_slots:
            # build_plan interned the preemptor's own new scalar slots after
            # the victims were built: no victim requests them, so zeros are
            # exact.
            grown = np.zeros(vic_req.shape[:2] + (r_slots,), np.int64)
            grown[:, :, :vic_req.shape[2]] = vic_req
            vic_req = grown
        res = dry_run_preemption(dstate, plan.features,
                                 torch.from_numpy(vic_req).to(self.device),
                                 torch.from_numpy(vic_valid).to(self.device),
                                 vic_valid.shape[1]).cpu().numpy()
        self.preemption_device_evals += 1
        feasible, vmask = res[:, 0], res[:, 1:]
        n = len(nodes)
        out = []
        for i in range(n):
            r = (start + i) % n
            st = node_to_status.get(nodes[r].name)
            if st is not None and st.code == UNSCHEDULABLE_AND_UNRESOLVABLE:
                continue  # nodesWherePreemptionMightHelp
            if feasible[r]:
                out.append(Candidate(nodes[r].name,
                                     [pi for j, pi in enumerate(potential[r]) if vmask[r, j]]))
                if len(out) >= num_candidates:
                    break
        return out

    def _commit_fast_eligible(self, fw: Framework) -> bool:
        """True when `fw`'s commit tail is assume and bind for a device pod
        without DRA state or pod group (the JAX package's :2087-2109): every
        Reserve and PreBind plugin acts only on the state its PreFilter or
        Filter wrote (`state_driven_tail`: a device pod's state is fresh, so
        their runs do nothing), every Permit plugin acts only on gang members
        (`gang_only`), no PostBind plugin, and DefaultBinder binds alone."""
        ok = self._fast_tail.get(id(fw))
        if ok is None:
            ok = (all(getattr(p, "state_driven_tail", False) for p in fw.reserve_plugins)
                  and all(getattr(p, "state_driven_tail", False) for p in fw.pre_bind_plugins)
                  and all(getattr(p, "gang_only", False) for p in fw.permit_plugins)
                  and not fw.post_bind_plugins
                  and len(fw.bind_plugins) == 1
                  and isinstance(fw.bind_plugins[0], DefaultBinder))
            self._fast_tail[id(fw)] = ok
        return ok

    def _commit(self, fw: Framework, qpi: QueuedPodInfo, node_name: str) -> bool:
        """assume → reserve → permit → bind: the host tail of the scheduling
        cycle (schedule_one.go:315 onward; the JAX package's :2113-2165). A
        claim pod first runs DynamicResources' PreFilter and Filter on the
        chosen node alone, which picks its devices; a miss (the carry's
        count diverged from the live devices) sends it to the host path. A
        pod a Permit plugin holds (a gang member short of its group's count)
        parks assumed. False when the host rejected the placement."""
        pod = qpi.pod
        self.attempts += 1
        dra_state = None
        if pod.resource_claims:
            dr = fw.plugin("DynamicResources")
            if dr is not None:
                dra_state = CycleState()
                ni = self.snapshot.get(node_name)
                _r, st = dr.pre_filter(dra_state, pod, [ni] if ni is not None else [])
                if st.is_success() and ni is not None:
                    st = dr.filter(dra_state, pod, ni)
                if ni is None or not st.is_success():
                    self.host_path_pods += 1
                    self.process_one(qpi)
                    return False
        if dra_state is None and not pod.pod_group and self._commit_fast_eligible(fw):
            # The lean tail: what the full tail below leaves for this
            # profile (the plugin runs it skips do nothing on a fresh state).
            pod.node_name = node_name
            self.cache.assume_pod(pod, qpi.pod_info)
            st = fw.bind_plugins[0].bind(_EMPTY_STATE, pod, node_name)
            if st.is_success():
                nom = self.queue.nominator
                if nom.has_nominated_pods():
                    nom.delete_nominated_pod(pod)
                self.scheduled += 1
                self.device_scheduled += 1
                self.queue.done(pod.uid)
                return True
            self._unwind_binding(fw, CycleState(), qpi, node_name, st)
            self.queue.done(pod.uid)
            return False
        state = dra_state if dra_state is not None else CycleState()
        pod.node_name = node_name
        self.cache.assume_pod(pod, qpi.pod_info)
        st = fw.run_reserve_plugins_reserve(state, pod, node_name)
        if st.is_success():
            st = fw.run_permit_plugins(state, pod, node_name)
            if st.code == WAIT:
                # Parked assumed on the node: the carry stays right.
                self.park_waiting_pod(fw, state, qpi, ScheduleResult(suggested_host=node_name))
                self.queue.done(pod.uid)
                return True
            failed = st.is_rejected()  # a Permit error goes on to the binding cycle
        else:
            failed = True
        if failed:
            fw.run_reserve_plugins_unreserve(state, pod, node_name)
            self.cache.forget_pod(pod)
            pod.node_name = ""
            self.handle_scheduling_failure(fw, qpi, st, None)
            self.queue.done(pod.uid)
            return False
        bound = self.run_binding_cycle(fw, state, qpi, node_name)
        self.queue.done(pod.uid)
        if bound:
            self.device_scheduled += 1
        return bound

    # -- the score-hint walker (models/score_hints.py) -----------------------

    def _try_hint_binds(self) -> int:
        """Bind a run of identical replicas on the host off a live hint (the
        JAX package's :2209-2300): for each pod a validation (counters and a
        journal replay) and the lap's selection in numpy, then the usual
        commit tail. The first miss (signature, validation, no feasible
        node) leaves the pod in the holdover slot for the batch path.
        Returns the pods it handled."""
        hints = self._hints
        handled = 0
        while True:
            qpi = self._pop()
            if qpi is None:
                if self._event_inbox:
                    # Pods created off the scheduling thread: replay them so
                    # that a creation burst does not end the run early.
                    self.drain_event_inbox()
                    qpi = self._pop()
                if qpi is None:
                    break
            if isinstance(qpi, QueuedPodGroupInfo) or qpi.pod.scheduler_name not in self.profiles:
                self._holdover = qpi
                break
            fw = self.framework_for_pod(qpi.pod)
            served = hints.serve(fw, qpi.pod)
            if served is None:
                self._holdover = qpi
                break
            entry, kind = served
            row, evaluated = entry.select(self.next_start_node_index)
            if row < 0:
                # No feasible node under the hint: the batch path owns the
                # exact diagnosis.
                hints._miss("infeasible")
                self._holdover = qpi
                break
            node = entry.node_names[row]
            committed = self._commit(fw, qpi, node)
            hints.note_own_attempt(node if committed else "", entry)
            handled += 1
            if not committed:
                break  # the rejection moved state that the next serve fences
            entry.apply(row)
            self.next_start_node_index = (self.next_start_node_index % entry.num
                                          + evaluated) % entry.num
            if qpi.pod.uid not in self.waiting_pods:
                # Hits count binds. A pod a Permit plugin holds is assumed on
                # the node (the walk applies it) but not bound yet.
                hints._hit(kind)
            if hints.entry is not entry:
                break
        return handled

    # -- run loop ------------------------------------------------------------

    def schedule_one(self) -> bool:
        # Events parked off the scheduling thread land before the next
        # session collects its pods.
        self.drain_event_inbox()
        if self._hints.entry is not None:
            # While a live hint matches the queue's head, identical replicas
            # bind on the host with no dispatch; the first miss waits in the
            # holdover slot for the batch path below.
            t0 = time.perf_counter()
            handled = self._try_hint_binds()
            self.hint_s += time.perf_counter() - t0
            if handled:
                return True
        t0 = time.perf_counter()
        fw, batch, fallback_reason = self._collect_batch()
        self.collect_s += time.perf_counter() - t0
        if not batch:
            return False
        if fallback_reason is None:
            self._run_device_session(fw, batch)
            return True
        if fallback_reason is _GANG_SESSION:
            self._run_gang_device_session(fw, batch[0])
            return True
        for qpi in batch:
            if fallback_reason is not _PLACEMENT_GROUP:
                # A pod, or a group entity once, as the JAX package counts
                # them. (A placement group's cycle counts its own host path:
                # _evaluate_placements.)
                self.host_path_pods += 1
            self.process_one(qpi)
        return True
