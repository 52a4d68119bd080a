"""Signature-keyed score hints: bind identical replicas without a dispatch
(the JAX package's models/score_hints.py, on the port's plan and carry).

The reference's opportunistic batching (KEP-5598, framework/runtime/batch.go
OpportunisticBatch) keeps the previous cycle's sorted scores keyed by pod
signature, so that the next identical pod gets a node hint and skips filter
and score. Here, when a device session ends cleanly, its final carry (each
node's requested aggregates and the carried fit and BalancedAllocation
scores: the lap kernel's own truth) is fetched to the host in one copy and
kept, keyed by the session's exact and namespace-erased signatures and
stamped with the cluster-event version it reflects. The next identical pod
then walks those scores on the host: a numpy replica of the lap kernel's
selection (the only plans eligible: ``hint_eligible``) picks the node the
next dispatch would pick, the pod binds through the usual commit tail, and
the walk applies the placement to its own rows.

Exactness: a hinted placement equals the always-dispatch one. Eligible plans
are those whose total score and feasibility the kernel itself proves
row-local (no spread, inter-pod-affinity or preferred-node-affinity lanes,
no PreferNoSchedule counts, no anti- or affinity axes: ``BatchPlan.pod_local``),
so the walk is the lap with the dead lanes removed: the same int64 fit and
BalancedAllocation arithmetic (ops/kernel.py resource_eval), the same
adaptive-sampling cut at `to_find` and rotation, the same choice of the
highest score and then the lowest rotation.

Freshness follows the event journal (core/cache.py EventJournal), not a
timer:

    event kind          hint survival
    ------------------  ------------------------------------------------
    queue               free (nothing node-side moved)
    namespace           free while no affinity-term pod exists
    pod_add/remove/upd  plain pod: re-encode that ROW from cache truth;
                        terms: killed
    node_update         re-validate that ROW's taints, allocatable and
                        unschedulable flag (labels and images are intact by
                        the kind's contract); a PreferNoSchedule taint kills
                        the hint (the plan has no PreferNoSchedule lane)
    structural/other    killed
    journal gap         killed (anything may have changed)

State moves outside the journal are fenced by counters that `serve` checks:
a scheduling attempt the walker did not make (`attempts`), a cache unwind
(`state_unwinds`), a change to the nominated set (`Nominator.version`) and
the cluster-wide 0→1 affinity-pod transition (`cache.affinity_pod_refs`)
each invalidate. (The JAX package's bind-conflict half, a bind 409 blocking
one row, waits for a conflict path in the port's scheduler: every entry's
`blocked` row stays False.)
"""

from __future__ import annotations

from collections import Counter
from typing import Optional, Tuple

import numpy as np
import torch

from ..api.types import PREFER_NO_SCHEDULE
from ..core.cache import EV_NAMESPACE, EV_NODE_UPDATE, EV_POD_ADD, EV_POD_REMOVE, EV_POD_UPDATE, EV_QUEUE
from ..ops.codebook import EFFECT_NO_EXECUTE, EFFECT_NO_SCHEDULE, OP_EXISTS
# The lap kernel's own bound: windows of consecutive pods are disjoint until
# the rotation laps the cluster. One shared constant, so that the host walk's
# batching cannot drift from the device lap's.
from ..ops.kernel import LAP_MAX
from ..ops.staging import Fetch
from ..parallel.mesh import Sharded

MAX_NODE_SCORE = 100
_BA_SCALE = 1_000_000
_LANES = ("req_r", "nonzero", "pod_count", "fit_ok", "fit_sc", "ba")
# The LRU's size: two replica shapes alternating through one queue both stay
# on the host path.
HINT_LRU = 2


def hint_eligible(plan, aux_shape, head_pod, nominator, affinity_pod_refs: int) -> bool:
    """Can a clean session of this plan seed a score hint? The lap's
    row-local preconditions (the walk replicates exactly that path), plus
    the host state the walk does not model: counted claims, nominated pods
    and any live affinity-term pod (the 0→1 transition disables hints
    cluster-wide). A mesh session is eligible too: its carry is gathered
    (from_session), and the sharded carry equals the unsharded one."""
    f = plan.facts
    return (plan.pod_local
            and not (f.has_pns or f.has_ipa_base or f.has_na_pref or f.port_selfblock
                     or f.has_aux or plan.features.nom_req.shape[0])
            and aux_shape == (None, None)
            and not head_pod.volumes
            and not head_pod.resource_claims
            and not nominator.has_nominated_pods()
            and affinity_pod_refs == 0)


def fetch_lanes(carry) -> np.ndarray:
    """The carry's six walk lanes on the host, [NP, R + 6] int64 (req_r,
    nonzero, then pod_count, fit_ok, fit_sc and ba as columns), in one
    device→host copy. A sharded carry's parts are gathered onto the first
    shard's device first. The copy is ordered after the dispatches that
    wrote the carry and read only once its event has completed."""
    parts = carry.parts if isinstance(carry, Sharded) else [carry]
    dev = parts[0].req_r.device
    cols = []
    for name in _LANES:
        lane = torch.cat([getattr(p, name).to(dev) for p in parts])
        cols.append(lane.to(torch.int64).reshape(lane.shape[0], -1))
    return Fetch(torch.cat(cols, 1)).wait()


class HintEntry:
    """One live hint: the per-node walk state for one pod signature."""

    __slots__ = (
        "keys", "fw_id", "pod", "node_names", "row_of",
        "NP", "num", "to_find",
        # the pod's facts (ints and small vectors)
        "request", "nz_request", "has_request", "ba_skip",
        "fit_slots", "fit_weights", "fit_strategy",
        "w_tt", "w_fit", "w_ba", "w_il", "tolerates_unsched", "enable",
        # per-node state (numpy arrays the entry owns)
        "alloc_r", "alloc_pods", "req_r", "nonzero", "pod_count",
        "static_ok", "fit_ok", "fit_sc", "ba", "total", "ok", "blocked",
        "il_score", "sel_ok", "extra_ok", "name_ok", "valid", "_idx",
        # freshness watermarks
        "seq", "attempts", "unwinds", "nom_version",
        # the mirror's scalar-slot map (read only: a slot it lacks cannot
        # affect this plan, whose request for it is zero)
        "scalar_slots",
        # the lap-batched walk: (row, evaluated, expected start) of the
        # rest of the current lap. Adaptive-sampling windows of consecutive
        # pods are disjoint, so one cumsum serves up to total_feas //
        # to_find pods; any row change other than the served pod's own
        # apply() clears it. `lap_enabled` False pins the per-pod walk.
        "_pending", "lap_enabled", "lap_walks",
    )

    # -- construction -------------------------------------------------------

    @classmethod
    def from_session(cls, sched, fw, head_pod, sig, nsig, plan, node_names,
                     carry, lap: bool = True) -> "HintEntry":
        """The session's end state. `carry` is the final ScanCarry: its
        req_r, nonzero, pod_count, fit_ok, fit_sc and ba are the kernel's
        post-commit truth, so the walk equals what the next dispatch would
        compute. The pod's facts come from the plan's host arrays and the
        static rows from the mirror's host staging (in line after adopt)."""
        e = cls()
        e.keys = {("exact", sig)}
        if nsig is not None:
            e.keys.add(("neutral", nsig))
        e.fw_id = id(fw)
        e.pod = head_pod
        e.node_names = list(node_names)
        e.row_of = {n: i for i, n in enumerate(node_names)}
        h = plan.host
        mirror = sched.mirror
        e.NP = int(mirror.np_cap)
        e.num = max(int(h["num_nodes"]), 1)
        e.to_find = int(h["to_find"])
        e._idx = np.arange(e.NP, dtype=np.int64)
        e.request = h["request"].astype(np.int64)
        e.nz_request = h["nz_request"].astype(np.int64)
        e.has_request = int(h["has_request"])
        e.ba_skip = int(h["ba_skip"])
        e.fit_slots = h["fit_slots"].astype(np.int64)
        e.fit_weights = h["fit_weights"].astype(np.int64)
        e.fit_strategy = int(plan.fit_strategy)
        w = h["weights"]
        e.w_tt, e.w_fit, e.w_ba, e.w_il = int(w[0]), int(w[1]), int(w[4]), int(w[6])
        e.tolerates_unsched = int(h["tolerates_unsched"])
        e.enable = tuple(int(x) for x in h["enable"])
        e.scalar_slots = mirror.scalar_slots
        lanes = fetch_lanes(carry)
        r = lanes.shape[1] - 6
        e.req_r = lanes[:, :r].copy()
        e.nonzero = lanes[:, r:r + 2].copy()
        e.pod_count = lanes[:, r + 2].copy()
        e.fit_ok = lanes[:, r + 3].astype(bool)
        e.fit_sc = lanes[:, r + 4].copy()
        e.ba = lanes[:, r + 5].copy()
        e.alloc_r = mirror.h_alloc_r.astype(np.int64)
        e.alloc_pods = mirror.h_alloc_pods.astype(np.int64)
        e.il_score = h["il_score"].astype(np.int64)
        e.sel_ok = h["sel_match"].astype(bool)
        e.extra_ok = h["extra_ok"].astype(bool)
        e.valid = mirror.h_valid.copy() & (e._idx < e.num)
        nid = int(h["node_name_id"])
        e.name_ok = (nid == 0) | (mirror.h_name_id == nid) | (e.enable[0] == 0)
        e.static_ok = (e.valid & e.name_ok & e.sel_ok_effective() & e.extra_ok
                       & e._taint_unsched_ok(mirror, h))
        e.blocked = np.zeros(e.NP, bool)
        e.total = (e.w_tt * MAX_NODE_SCORE + e.w_fit * e.fit_sc
                   + e.w_ba * e.ba + e.w_il * e.il_score)
        e.ok = e.static_ok & e.fit_ok & ~e.blocked
        e.seq = sched.cluster_event_seq
        e.attempts = sched.attempts
        e.unwinds = sched.state_unwinds
        e.nom_version = sched.queue.nominator.version
        e._pending = []
        e.lap_enabled = lap
        e.lap_walks = 0
        return e

    def sel_ok_effective(self) -> np.ndarray:
        return self.sel_ok | (self.enable[3] == 0)

    def _taint_unsched_ok(self, mirror, h) -> np.ndarray:
        """The static_masks taint and unschedulable verdicts over the
        staging arrays (ops/kernel.py semantics, in numpy)."""
        tk, tv, te, to = h["tol_key"], h["tol_val"], h["tol_eff"], h["tol_op"]
        k = mirror.h_taint_key[:, :, None]
        v = mirror.h_taint_val[:, :, None]
        ef = mirror.h_taint_eff[:, :, None]
        if tk.shape[0]:
            eff_ok = (te[None, None, :] == 0) | (te[None, None, :] == ef)
            key_ok = (tk[None, None, :] == 0) | (tk[None, None, :] == k)
            val_ok = (to[None, None, :] == OP_EXISTS) | (tv[None, None, :] == v)
            tolerated = (eff_ok & key_ok & val_ok).any(axis=2)
        else:
            tolerated = np.zeros(mirror.h_taint_key.shape, bool)
        relevant = ((mirror.h_taint_eff == EFFECT_NO_SCHEDULE)
                    | (mirror.h_taint_eff == EFFECT_NO_EXECUTE))
        taint_ok = ~(relevant & ~tolerated).any(axis=1) | (self.enable[2] == 0)
        unsched_ok = (~mirror.h_unsched | (self.tolerates_unsched == 1)
                      | (self.enable[1] == 0))
        return taint_ok & unsched_ok

    # -- the walk (the lap kernel's selection, on the host) ----------------

    def select(self, start: int) -> Tuple[int, int]:
        """One pod's selection against the walk state: (row or -1,
        evaluated), `evaluated` advancing the rotation as the kernel's
        window boundary does. With adaptive-sampling truncation live
        (total_feas // to_find >= 2) consecutive pods examine disjoint
        windows, so one cumsum segments up to a lap of placements
        (_lap_select) and later pods pop them off `_pending`."""
        num, NP, to_find = self.num, self.NP, self.to_find
        start = start % num
        if self._pending:
            if self._pending[0][2] == start:
                row, evaluated, _ = self._pending.pop(0)
                return row, evaluated
            self._pending = []  # the rotation moved outside the walk
        ok = self.ok
        F = np.cumsum(ok, dtype=np.int64)
        total_feas = int(F[-1])
        idx = self._idx
        f_start = int(F[start - 1]) if start > 0 else 0
        rank = np.where(idx >= start, F - f_start, F + total_feas - f_start)
        rot = (idx - start) % num
        if total_feas:
            tf = max(to_find, 1)
            L = min(total_feas // tf, LAP_MAX)
            if self.lap_enabled and L >= 2:
                got = self._lap_select(start, ok, rank, rot, int(L), tf, num, NP)
                if got is not None:
                    return got
        boundary = ok & (rank == to_find)
        mx = int(np.max(np.where(boundary, num - 1 - rot, 0))) if NP else 0
        evaluated = num - mx
        if not total_feas:
            return -1, evaluated
        kept = ok & (rank <= to_find)
        key = np.where(kept, self.total * NP + (NP - 1 - rot), -1)
        best = int(key.max())
        if best < 0:
            return -1, evaluated
        chosen_rot = (NP - 1) - (best % NP)
        return (start + chosen_rot) % num, evaluated

    def _lap_select(self, start, ok, rank, rot, L, tf, num, NP):
        """Segment the feasible rotation into L disjoint sampling windows
        (window w: feasible ranks (w·tf, (w+1)·tf]) and take each window's
        highest-score, lowest-rotation key in one pass, the lap's segmented
        argmax. Each window holds tf feasible rows, so its boundary row
        exists and its `evaluated` is the rotation span from boundary to
        boundary, the scan's advance a pod. Returns the first (row,
        evaluated) and keeps the rest on `_pending`, or None for the
        single-pod path."""
        key = np.where(ok, self.total * NP + (NP - 1 - rot), -1)
        w = np.zeros_like(rank)
        np.floor_divide(rank - 1, tf, out=w, where=ok)
        sel = ok & (w < L)
        best = np.full(L, -1, np.int64)
        np.maximum.at(best, w[sel], key[sel])
        is_b = ok & (rank % tf == 0) & (rank >= tf) & (rank // tf <= L)
        # Sentinel num + 1: a boundary at the last rotation slot is ev ==
        # num (the scan's full-wrap case) and must be kept.
        ev_abs = np.full(L, num + 1, np.int64)
        np.minimum.at(ev_abs, rank[is_b] // tf - 1, rot[is_b] + 1)
        entries = []
        cur, prev_abs = start, 0
        for wi in range(L):
            k = int(best[wi])
            if k < 0 or ev_abs[wi] > num:
                break  # an empty or unbounded window ends the lap
            row = (start + (NP - 1 - k % NP)) % num
            entries.append((int(row), int(ev_abs[wi]) - prev_abs, cur))
            prev_abs = int(ev_abs[wi])
            cur = (start + prev_abs) % num
        if not entries:
            return None
        self.lap_walks += 1
        row, evaluated, _ = entries.pop(0)
        self._pending = entries
        return row, evaluated

    def apply(self, row: int) -> None:
        """Commit one placement into the walk state (the carry update of
        the landed row)."""
        self.req_r[row] += self.request
        self.nonzero[row] += self.nz_request
        self.pod_count[row] += 1
        self._reval_row(row)

    # -- one row re-evaluated (ops/kernel.py resource_eval) -----------------

    def _reval_row(self, row: int) -> None:
        alloc = self.alloc_r[row]
        pods_ok = int(self.pod_count[row]) + 1 <= int(self.alloc_pods[row])
        avail = alloc - self.req_r[row]
        viol = bool(((self.request > 0) & (self.request > avail)).any())
        fit_ok = (pods_ok and (not viol or self.has_request == 0)) or self.enable[4] == 0
        used0 = int(self.nonzero[row, 0]) + int(self.nz_request[0])
        used1 = int(self.nonzero[row, 1]) + int(self.nz_request[1])
        num_ = den = 0
        for j in range(self.fit_slots.shape[0]):
            slot = int(self.fit_slots[j])
            wj = int(self.fit_weights[j])
            a = int(alloc[slot])
            if slot == 0:
                used = used0
            elif slot == 1:
                used = used1
            else:
                used = int(self.req_r[row, slot]) + int(self.request[slot])
            if self.fit_strategy == 0:  # LeastAllocated
                rscore = (a - used) * MAX_NODE_SCORE // max(a, 1) if (a > 0 and used <= a) else 0
            else:  # MostAllocated
                rscore = min(used, a) * MAX_NODE_SCORE // max(a, 1) if a > 0 else 0
            if a > 0:
                num_ += rscore * wj
                den += wj
        fit_sc = num_ // max(den, 1) if den > 0 else 0
        a_cpu, a_mem = int(alloc[0]), int(alloc[1])
        q_cpu = min(used0 * _BA_SCALE // max(a_cpu, 1), _BA_SCALE)
        q_mem = min(used1 * _BA_SCALE // max(a_mem, 1), _BA_SCALE)
        if self.ba_skip == 1:
            ba = 0
        elif a_cpu > 0 and a_mem > 0:
            ba = (MAX_NODE_SCORE * _BA_SCALE - 50 * abs(q_cpu - q_mem)) // _BA_SCALE
        else:
            ba = MAX_NODE_SCORE
        self.fit_ok[row] = fit_ok
        self.fit_sc[row] = fit_sc
        self.ba[row] = ba
        self.total[row] = (self.w_tt * MAX_NODE_SCORE + self.w_fit * fit_sc
                           + self.w_ba * ba + self.w_il * int(self.il_score[row]))
        self.ok[row] = bool(self.static_ok[row]) and fit_ok and not self.blocked[row]

    def _reval_rows(self, rows: np.ndarray) -> None:
        """_reval_row over many rows in one int64 numpy pass (the same
        arithmetic, held equal to it by tests/test_torch_hints.py): the
        resync of a whole session's rows, where one row at a time costs
        some forty times more."""
        alloc = self.alloc_r[rows]
        req = self.req_r[rows]
        pods_ok = self.pod_count[rows] + 1 <= self.alloc_pods[rows]
        viol = ((self.request > 0) & (self.request > alloc - req)).any(axis=1)
        fit_ok = (pods_ok & (~viol | (self.has_request == 0))) | (self.enable[4] == 0)
        used0 = self.nonzero[rows, 0] + self.nz_request[0]
        used1 = self.nonzero[rows, 1] + self.nz_request[1]
        num_ = np.zeros(len(rows), np.int64)
        den = np.zeros(len(rows), np.int64)
        for slot, wj in zip(self.fit_slots.tolist(), self.fit_weights.tolist()):
            a = alloc[:, slot]
            if slot == 0:
                used = used0
            elif slot == 1:
                used = used1
            else:
                used = req[:, slot] + self.request[slot]
            if self.fit_strategy == 0:  # LeastAllocated
                rscore = np.where(used <= a, (a - used) * MAX_NODE_SCORE // np.maximum(a, 1), 0)
            else:  # MostAllocated
                rscore = np.minimum(used, a) * MAX_NODE_SCORE // np.maximum(a, 1)
            num_ += np.where(a > 0, rscore * wj, 0)
            den += np.where(a > 0, wj, 0)
        fit_sc = num_ // np.maximum(den, 1)
        a_cpu, a_mem = alloc[:, 0], alloc[:, 1]
        q_cpu = np.minimum(used0 * _BA_SCALE // np.maximum(a_cpu, 1), _BA_SCALE)
        q_mem = np.minimum(used1 * _BA_SCALE // np.maximum(a_mem, 1), _BA_SCALE)
        if self.ba_skip == 1:
            ba = np.zeros(len(rows), np.int64)
        else:
            ba = np.where((a_cpu > 0) & (a_mem > 0),
                          (MAX_NODE_SCORE * _BA_SCALE - 50 * np.abs(q_cpu - q_mem)) // _BA_SCALE,
                          MAX_NODE_SCORE)
        self.fit_ok[rows] = fit_ok
        self.fit_sc[rows] = fit_sc
        self.ba[rows] = ba
        self.total[rows] = (self.w_tt * MAX_NODE_SCORE + self.w_fit * fit_sc + self.w_ba * ba
                            + self.w_il * self.il_score[rows])
        self.ok[rows] = self.static_ok[rows] & fit_ok & ~self.blocked[rows]

    # -- freshness (the journal replayed) -----------------------------------

    def _resource_vec(self, r) -> np.ndarray:
        """An entry-width resource vector. Scalar resources the slot map
        lacks are left out: this plan requests none of them, so they move
        neither its fit filter nor its scores."""
        out = np.zeros(self.req_r.shape[1], np.int64)
        out[0] = r.milli_cpu
        out[1] = r.memory
        out[2] = r.ephemeral_storage
        for name, amount in r.scalar_resources.items():
            slot = self.scalar_slots.get(name)
            if slot is not None and slot < out.shape[0]:
                out[slot] = amount
        return out

    def _encode_pod_row(self, cache, key: str) -> Optional[int]:
        """Write one row's pod aggregates from cache truth. Its row, or None
        when the row set changed shape after all."""
        row = self.row_of.get(key)
        ni = cache.nodes.get(key)
        if row is None or ni is None or ni.node is None:
            return None
        self.req_r[row] = self._resource_vec(ni.requested)
        self.nonzero[row, 0] = ni.non_zero_requested.milli_cpu
        self.nonzero[row, 1] = ni.non_zero_requested.memory
        self.pod_count[row] = len(ni.pods)
        return row

    def _reencode_pod_row(self, cache, key: str) -> Optional[str]:
        row = self._encode_pod_row(cache, key)
        if row is None:
            return "structural"
        self._reval_row(row)
        self._pending = []  # a row moved outside the walk: segment again
        return None

    def resync_rows(self, cache, rows=None) -> Optional[str]:
        """Re-encode pod aggregates from cache truth: a device session this
        entry did not watch just committed placements (our own binds are
        not journaled, so there are no events to replay). `rows` are the
        rows that session landed pods on, when nothing else moved since this
        entry was last in line; None re-encodes every row. Paid once an
        install, only when a sibling entry survives."""
        names = self.node_names if rows is None else [self.node_names[r] for r in rows]
        idx = np.empty(len(names), np.int64)
        for i, name in enumerate(names):
            row = self._encode_pod_row(cache, name)
            if row is None:
                return "structural"
            idx[i] = row
        self._reval_rows(idx)
        self._pending = []  # rows moved outside the walk: segment again
        return None

    def _revalidate_node_row(self, cache, key: str) -> Optional[str]:
        """EV_NODE_UPDATE: one row's taints, allocatable or unschedulable
        flag moved (labels, images and declared features are intact by the
        kind's contract, so the selector, extra and name verdicts stand)."""
        row = self.row_of.get(key)
        ni = cache.nodes.get(key)
        if row is None or ni is None or ni.node is None:
            return "structural"
        node = ni.node
        if any(t.effect == PREFER_NO_SCHEDULE for t in node.taints):
            # The plan has no PreferNoSchedule lane (has_pns False); the
            # dispatch would now count such taints.
            return "pns_taint"
        tols = self.pod.tolerations
        taint_ok = (self.enable[2] == 0) or all(
            any(tol.tolerates(t) for tol in tols)
            for t in node.taints if t.effect != PREFER_NO_SCHEDULE)
        unsched_ok = (not node.unschedulable) or self.tolerates_unsched == 1 or self.enable[1] == 0
        self.static_ok[row] = (bool(self.valid[row]) and bool(self.name_ok[row])
                               and bool(self.sel_ok_effective()[row])
                               and bool(self.extra_ok[row]) and taint_ok and unsched_ok)
        self.alloc_r[row] = self._resource_vec(ni.allocatable)
        self.alloc_pods[row] = ni.allocatable.allowed_pod_number
        self._reval_row(row)
        self._pending = []  # a row moved outside the walk: segment again
        return None

    def consume(self, sched, events) -> Optional[str]:
        """Replay journal events into the walk state. None when the hint
        survives (rows patched as needed), else the invalidation reason."""
        cache = sched.cache
        for ev in events:
            if ev.kind == EV_QUEUE:
                continue
            if ev.kind == EV_NAMESPACE:
                if cache.affinity_pod_refs == 0:
                    continue  # namespace labels feed only affinity selectors
                return "namespace"
            if ev.kind in (EV_POD_ADD, EV_POD_REMOVE, EV_POD_UPDATE):
                if not ev.pod_plain:
                    return "pod_terms"
                reason = self._reencode_pod_row(cache, ev.key)
            elif ev.kind == EV_NODE_UPDATE:
                reason = self._revalidate_node_row(cache, ev.key)
            else:
                return ev.kind  # structural or other
            if reason:
                return reason
        return None


class ScoreHintCache:
    """The scheduler's live hints and their serve, install and invalidate
    protocol: a signature-keyed LRU of HINT_LRU entries, most recent first,
    so that two replica shapes alternating through one queue both stay on
    the host path. The counters live on the scheduler (`hint_hits`,
    `hint_misses`, `hint_invalidations`); `counts` holds them by (kind,
    reason). Entries stay coherent by push, not by the journal, since our
    own binds are not journaled: every own attempt bumps every entry's
    attempt watermark, and a committed bind re-encodes the landed row on the
    other entries from cache truth (note_own_attempt). `lap` False pins the
    per-pod walk on the entries installed after: the reference that the
    lap-batched walk is tested against, not a setting to run with."""

    def __init__(self, sched, enabled: bool = True, lap: bool = True):
        self.sched = sched
        self.enabled = enabled
        self.lap = lap
        self.entries: list = []  # HintEntry, most recently used first
        self.counts: Counter = Counter()

    @property
    def entry(self) -> Optional[HintEntry]:
        """The most recently used entry, or None: whether any hint is live."""
        return self.entries[0] if self.entries else None

    # -- counters -----------------------------------------------------------

    def _miss(self, reason: str) -> None:
        self.sched.hint_misses += 1
        self.counts["miss", reason] += 1

    def _hit(self, kind: str) -> None:
        self.sched.hint_hits += 1
        self.counts["hit", kind] += 1

    def _count_invalidation(self, reason: str) -> None:
        self.sched.hint_invalidations += 1
        self.counts["invalidation", reason] += 1

    def _drop(self, e: HintEntry, reason: str) -> None:
        self.entries.remove(e)
        self._count_invalidation(reason)

    def invalidate(self, reason: str) -> None:
        while self.entries:
            self._drop(self.entries[-1], reason)

    # -- lifecycle ----------------------------------------------------------

    def install(self, fw, head_pod, sig, nsig, plan, node_names, carry,
                landed: Tuple[int, list]) -> None:
        """Seed an entry from a clean session's final carry. `landed` is
        (the scheduler's attempts when the session began, the rows it
        landed pods on): a sibling that was in line then re-encodes only
        those rows."""
        if not self.enabled:
            return
        e = HintEntry.from_session(self.sched, fw, head_pod, sig, nsig, plan, node_names,
                                   carry, lap=self.lap)
        # An entry of the same signature is superseded (the fresh carry is
        # the newer truth for that shape); a new shape pushes the coldest
        # out. Surviving siblings absorb the session that just ended, its
        # attempts and (re-encoded from cache truth) its placements, or the
        # attempts fence would read every sibling as foreign at its next
        # serve. A sibling whose attempt watermark stood at the session's
        # start, over the same rows, missed only the session's landings
        # (journaled events it replays at its next serve); any other
        # re-encodes every row. The unwind and nomination fences are not
        # absorbed: a session that moved those leaves the sibling stale.
        rows = sorted(set(landed[1]))
        kept = []
        for x in self.entries:
            if x.keys & e.keys:
                continue
            in_line = x.attempts == landed[0] and x.node_names == e.node_names
            x.attempts = self.sched.attempts
            if x.resync_rows(self.sched.cache, rows if in_line else None) is None:
                kept.append(x)
            else:
                self._count_invalidation("cross_reencode")
        self.entries = [e] + kept
        while len(self.entries) > HINT_LRU:
            self._drop(self.entries[-1], "lru_evict")

    def note_own_attempt(self, node: str = "", served: Optional[HintEntry] = None) -> None:
        """One walker attempt ran: every entry absorbs the attempt counter's
        bump (otherwise one entry serving reads as a foreign attempt to its
        siblings). A committed bind passes the landed `node`, whose row the
        other entries re-encode from cache truth (the assumed pod is in it
        already); a failed attempt passes ""."""
        cache = self.sched.cache
        for e in list(self.entries):
            e.attempts += 1
            if e is served or not node:
                continue
            if e._reencode_pod_row(cache, node) is not None:
                # The sibling's rows do not cover the node: its world no
                # longer has the cluster's shape.
                self._drop(e, "cross_reencode")

    # -- serve --------------------------------------------------------------

    def serve(self, fw, pod) -> Optional[Tuple[HintEntry, str]]:
        """The signature-matched entry, validated against `pod` and the
        world: (entry, hit kind) when the walk may bind the pod, else None
        (a miss; stale entries are dropped as invalidations). A served entry
        moves to the front."""
        if not self.enabled:
            # Switched off on a warm scheduler: live entries stop serving
            # too, or the dispatch-only baseline would not be one.
            self.entries = []
            return None
        s = self.sched
        if not self.entries:
            self._miss("empty")
            return None
        if s.cache.affinity_pod_refs:
            # The 0→1 affinity-pod transition: labels and namespaces just
            # became scheduling-relevant; hints are off cluster-wide.
            self.invalidate("affinity_transition")
            self._miss("affinity_gate")
            return None
        sig = fw.sign_pod(pod)
        if sig is None:
            self._miss("unsignable")
            return None
        same_fw = [x for x in self.entries if id(fw) == x.fw_id]
        if not same_fw:
            self._miss("profile")
            return None
        # The exact key beats the neutral one across entries; recency
        # breaks ties within a kind.
        e = kind = None
        for x in same_fw:
            if ("exact", sig) in x.keys:
                e, kind = x, "exact"
                break
        if e is None:
            nsig = s._neutral_sig(fw, pod, sig)
            for x in same_fw:
                if nsig is not None and ("neutral", nsig) in x.keys:
                    e, kind = x, "neutral"
                    break
        if e is None:
            self._miss("signature")
            return None
        if pod.volumes or pod.resource_claims:
            self._miss("claims")
            return None
        if s._batch_supported(fw, pod) is not None:
            self._miss("unsupported")
            return None
        if s.queue.nominator.version != e.nom_version:
            self._drop(e, "nomination")
            self._miss("stale")
            return None
        if s.attempts != e.attempts:
            # An attempt the walker did not make (host path, device session)
            # moved cache state that the journal does not record.
            self._drop(e, "foreign_attempt")
            self._miss("stale")
            return None
        if s.state_unwinds != e.unwinds:
            self._drop(e, "state_unwind")
            self._miss("stale")
            return None
        if s.cluster_event_seq != e.seq:
            events = s.journal.since(e.seq)
            if events is None:
                self._drop(e, "journal_gap")
                self._miss("stale")
                return None
            reason = e.consume(s, events)
            if reason is not None:
                self._drop(e, reason)
                self._miss("stale")
                return None
            e.seq = s.cluster_event_seq
        if self.entries[0] is not e:
            self.entries.remove(e)
            self.entries.insert(0, e)
        return e, kind
