"""A FakeClientset with the eviction subresource the descheduler's funnel
calls (the JAX package's apiserver `_evict_locked`,
kubernetes_tpu/core/apiserver.py:1793-1866, without PodDisruptionBudgets
or finalizers).

An eviction deletes the bound pod and recreates it pending under the same
uid, through the clientset's own `delete_pod` and `create_pod`, so a
scheduler subscribed to the clientset sees both events and places the pod
again. Exactly-once by intent id: the (uid, intent) pair is ledgered, a
replay answers `already=True` without touching the pod, and the entry is
dropped once the pod binds again (a pod that returns to a node can be
evicted again under the same intent)."""

from __future__ import annotations

import copy
from typing import Dict
from urllib.error import HTTPError

from ..core.clientset import FakeClientset


class EvictingClientset(FakeClientset):
    def __init__(self):
        super().__init__()
        self.eviction_ledger: Dict[str, str] = {}   # uid -> intent
        self.evictions_committed = 0
        self.evictions_replayed = 0

    def evict_pod(self, uid: str, node: str, intent: str) -> dict:
        """POST pods/<uid>/eviction: 404 for a missing pod, `pending` for an
        unbound one, 409 NodeMismatch when the pod is bound elsewhere than
        `node`."""
        if self.eviction_ledger.get(uid) == intent:
            self.evictions_replayed += 1
            return {"evicted": True, "already": True}
        pod = self.pods.get(uid)
        if pod is None:
            raise HTTPError("", 404, "pod not found", {}, None)
        if not pod.node_name:
            return {"evicted": False, "pending": True}
        if node and pod.node_name != node:
            raise HTTPError("", 409, "NodeMismatch", {}, None)
        bound_to = pod.node_name
        self.delete_pod(pod)
        self.bindings.pop(uid, None)
        fresh = copy.copy(pod)
        fresh.node_name = ""
        fresh.nominated_node_name = ""
        self.create_pod(fresh)
        self.eviction_ledger[uid] = intent
        self.evictions_committed += 1
        return {"evicted": True, "node": bound_to}

    def bind(self, pod, node_name: str) -> None:
        super().bind(pod, node_name)
        self.eviction_ledger.pop(pod.uid, None)
