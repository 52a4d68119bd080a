"""Rate-limited, zone-aware pod eviction (NodeLifecycleController's
RateLimitedTimedQueue + DisruptionState, upstream node_lifecycle_controller.go)
— the JAX package's controllers/evictor.py, kept line for line.

Every eviction leaves through ONE funnel: `run_once` takes a token from the
zone's bucket (the rate limiter) and `_evict_one` stamps the deterministic
intent id (the idempotency record) before calling the clientset's eviction
subresource (`evict_pod(uid, node, intent)`).

Zone disruption states (upstream's large-cluster semantics): a zone whose
unhealthy fraction crosses `unhealthy_threshold` drops to the SECONDARY
eviction rate (partial disruption); a fully-unhealthy zone stops evicting
entirely (full disruption) — a partitioned zone, or a dead network
segment, must never trigger a mass-eviction storm for what is probably an
infrastructure failure, not 500 simultaneous node deaths.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, Optional, Tuple

ZONE_NORMAL = "Normal"
ZONE_PARTIAL = "PartialDisruption"
ZONE_FULL = "FullDisruption"

# Deleted-node pod GC drains through this reserved queue at the primary
# rate, always: its source node no longer EXISTS, so no zone census can
# legitimately brake it. The "/" makes the key impossible as a
# topology.kubernetes.io/zone label VALUE (label values reject "/"), so a
# health census can never collide with — and throttle — the GC funnel;
# set_zone_state refuses the key outright as a second line of defense.
GC_ZONE = "gc/deleted-node"


class TokenBucket:
    """Eviction token bucket (flowcontrol.NewTokenBucketRateLimiter).
    Injectable clock so the unit suite drives it without sleeps; a rate
    change (zone state transition) keeps the accumulated balance, capped
    at the new burst — upstream's SwapLimiter semantics."""

    def __init__(self, qps: float, burst: float = 1.0,
                 now: Callable[[], float] = time.monotonic):
        self._now = now
        self._qps = max(0.0, float(qps))
        self._burst = max(1.0, float(burst))
        self._tokens = self._burst
        self._last = now()

    @property
    def qps(self) -> float:
        return self._qps

    def set_rate(self, qps: float) -> None:
        self._refill()
        self._qps = max(0.0, float(qps))

    def _refill(self) -> None:
        t = self._now()
        self._tokens = min(self._burst,
                           self._tokens + (t - self._last) * self._qps)
        self._last = t

    def try_take(self) -> bool:
        """One eviction token, non-blocking. A zero-qps bucket (full
        disruption) never grants — its balance was spent or capped and
        refills at 0/s."""
        if self._qps <= 0.0:
            self._last = self._now()
            self._tokens = 0.0
            return False
        self._refill()
        if self._tokens >= 1.0:
            self._tokens -= 1.0
            return True
        return False


def intent_for(uid: str, node: str) -> str:
    """Deterministic eviction intent id: (pod, planned source node).
    Deterministic is what makes restart replay exactly-once WITHOUT any
    controller-local persistence — a restarted controller re-plans the
    same wave, mints the same ids, and the apiserver's WAL'd ledger
    answers the already-done ones with already=True."""
    return f"{uid}@{node}"


class RateLimitedEvictor:
    """Per-zone token-bucket eviction queues. Thread-safe: the lifecycle
    reconcile loop enqueues/cancels while tests (or the metrics surface)
    read counters."""

    def __init__(self, clientset, primary_qps: float = 2.0,
                 secondary_qps: float = 0.1,
                 unhealthy_threshold: float = 0.55,
                 burst: float = 1.0,
                 now: Callable[[], float] = time.monotonic):
        self.cs = clientset
        self.primary_qps = float(primary_qps)
        self.secondary_qps = float(secondary_qps)
        self.unhealthy_threshold = float(unhealthy_threshold)
        self._burst = float(burst)
        self._now = now
        self._lock = threading.Lock()
        self._buckets: Dict[str, TokenBucket] = {}
        self._pending: Dict[str, deque] = {}   # zone -> deque[(node, uid)]
        # uid -> (zone, node): dedupe/cancel, and the zone a transport-
        # failure retry re-enqueues into (losing it would drain the retry
        # through the wrong bucket, bypassing a disrupted zone's brake).
        self._queued: Dict[str, Tuple[str, str]] = {}
        self.zone_states: Dict[str, str] = {}
        self.evictions_total = 0
        self.evictions_throttled_total = 0
        self.evictions_replayed = 0   # server answered already=True
        self.evictions_cancelled = 0  # taint lift / pod moved / pod gone
        self.eviction_errors = 0      # transient failures (retried next tick)
        self.evictions_budget_blocked = 0  # PDB 429s (requeued, retried)

    # -- zone disruption state machine --------------------------------------

    def set_zone_state(self, zone: str, unhealthy: int, total: int) -> str:
        """Fold one zone's health census into its eviction rate. Returns
        the state name (observability + tests). The reserved GC queue is
        not a zone: it never slows down, whatever a census claims."""
        if zone == GC_ZONE:
            return ZONE_NORMAL
        frac = (unhealthy / total) if total > 0 else 0.0
        if total > 0 and unhealthy >= total:
            state, qps = ZONE_FULL, 0.0
        elif frac > self.unhealthy_threshold:
            state, qps = ZONE_PARTIAL, self.secondary_qps
        else:
            state, qps = ZONE_NORMAL, self.primary_qps
        with self._lock:
            self.zone_states[zone] = state
            bucket = self._buckets.get(zone)
            if bucket is None:
                self._buckets[zone] = TokenBucket(
                    qps, burst=self._burst, now=self._now)
            elif bucket.qps != qps:
                bucket.set_rate(qps)
        return state

    # -- queue management ----------------------------------------------------

    def enqueue(self, zone: str, node: str, uid: str) -> bool:
        """Queue one pod for eviction off `node`. Deduplicated by uid —
        the reconcile loop re-plans every tick and must not stack
        duplicate work."""
        with self._lock:
            if uid in self._queued:
                return False
            self._queued[uid] = (zone, node)
            if zone not in self._buckets:
                self._buckets[zone] = TokenBucket(
                    self.primary_qps, burst=self._burst, now=self._now)
            self._pending.setdefault(zone, deque()).append((node, uid))
            return True

    def cancel_node(self, node: str) -> int:
        """Drop every pending eviction planned off `node` — the taint
        lifted (node heartbeats again) mid-wave, so its still-queued pods
        must NOT be evicted."""
        dropped = 0
        with self._lock:
            for zone, q in self._pending.items():
                kept = [(n, u) for (n, u) in q if n != node]
                dropped += len(q) - len(kept)
                self._pending[zone] = deque(kept)
            for uid in [u for u, (_z, n) in self._queued.items()
                        if n == node]:
                del self._queued[uid]
            self.evictions_cancelled += dropped
        return dropped

    def pending_count(self) -> int:
        with self._lock:
            return sum(len(q) for q in self._pending.values())

    # -- the eviction funnel -------------------------------------------------

    def run_once(self) -> int:
        """Drain each zone's queue as far as its token bucket allows.
        Returns evictions committed this pass. A zone with work but no
        token counts one throttle observation (the `_throttled_total`
        series the zone-outage chaos scenario asserts). Each zone's drain
        is bounded to the items pending at pass start: a transport-failed
        eviction re-enqueues at the tail and waits for the NEXT reconcile
        (retrying inside the same pass would spin tokens against a dead
        wire)."""
        done = 0
        with self._lock:
            budget = {z: len(q) for z, q in self._pending.items() if q}
        for zone, n in budget.items():
            for _ in range(n):
                with self._lock:
                    q = self._pending.get(zone)
                    if not q:
                        break
                    if not self._buckets[zone].try_take():
                        self.evictions_throttled_total += 1
                        break
                    node, uid = q.popleft()
                    self._queued.pop(uid, None)
                if self._evict_one(zone, node, uid):
                    done += 1
        return done

    def _evict_one(self, zone: str, node: str, uid: str) -> bool:
        """One rate-limit-granted eviction: deterministic intent, then the
        idempotent subresource. Every terminal server answer (evicted /
        already / pending / mismatch / gone) resolves this pod's work;
        only a transport failure re-queues it — into its ORIGINAL zone,
        so the retry still pays that zone's (possibly disrupted) rate."""
        from urllib.error import HTTPError

        intent = intent_for(uid, node)
        try:
            got = self.cs.evict_pod(uid, node, intent) or {}
        except HTTPError as e:
            if e.code == 404:
                self.evictions_cancelled += 1  # pod gone: nothing to evict
                return False
            if e.code == 409:
                # NodeMismatch (pod moved since the plan) or finalizer
                # parked — either way this plan is stale, not retryable.
                self.evictions_cancelled += 1
                return False
            if e.code == 429:
                # DisruptionBudget: committing this eviction would take a
                # workload below its PDB's minAvailable. NOT stale and NOT
                # an error — re-queue into the ORIGINAL zone and retry
                # after the workload controller has healed the slack.
                self.evictions_budget_blocked += 1
                self.enqueue(zone, node, uid)
                return False
            self.eviction_errors += 1
            return False
        except Exception:  # noqa: BLE001 - transport: retry next tick
            self.eviction_errors += 1
            self.enqueue(zone, node, uid)
            return False
        if got.get("already"):
            self.evictions_replayed += 1
            return False
        if got.get("evicted"):
            self.evictions_total += 1
            return True
        self.evictions_cancelled += 1  # pending=True: already unbound
        return False
