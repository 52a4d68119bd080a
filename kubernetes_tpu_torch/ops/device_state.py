"""Device mirror of the scheduler snapshot: fixed-capacity SoA node tensors.

The device form of the reference's incremental snapshot refresh
(pkg/scheduler/backend/cache/cache.go:206 UpdateSnapshot): the mirror keeps
one row per node in `snapshot.node_info_list` order, re-encodes only rows
whose NodeInfo.generation advanced (or whose list position changed), and
flushes them to the device with an `index_copy_` row scatter when few rows
are dirty, a full upload otherwise.

Row order == snapshot list order, so the kernels' rotation arithmetic
(schedule_one.go:816 nextStartNodeIndex) operates directly on row indices.
Capacities grow in powers of two, as in the JAX mirror, so the port's
tensors have the reference's shapes.

All quantities are int64 (explicit dtypes; memory in bytes exceeds int32):
resource units are integers by construction and the kernels' score math is
specified in exact integer arithmetic, so host and device agree bit for bit.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..api import resource as res
from ..core.node_info import NodeInfo
from .codebook import EFFECT_IDS, Codebook

# Resource slot layout: [cpu_milli, memory, ephemeral_storage, *scalar_slots].
BASE_RESOURCES = 3
SLOT_CPU = 0
SLOT_MEMORY = 1
SLOT_EPHEMERAL = 2


class DeviceNodeState(NamedTuple):
    """The node tensors the kernels consume (field order = the JAX
    package's DeviceNodeState)."""

    alloc_r: torch.Tensor      # [NP, R] i64 allocatable per resource slot
    alloc_pods: torch.Tensor   # [NP]    i64 allocatable pod count
    req_r: torch.Tensor        # [NP, R] i64 requested (assumed+bound pods)
    nonzero: torch.Tensor      # [NP, 2] i64 non-zero-default cpu/mem aggregate
    pod_count: torch.Tensor    # [NP]    i32
    taint_key: torch.Tensor    # [NP, T] i32 interned taint keys (0 pad)
    taint_val: torch.Tensor    # [NP, T] i32
    taint_eff: torch.Tensor    # [NP, T] i32 (EFFECT_* ids; 0 pad = inert)
    unsched: torch.Tensor      # [NP]    bool node.spec.unschedulable
    valid: torch.Tensor        # [NP]    bool row holds a live node
    name_id: torch.Tensor      # [NP]    i32 interned node name
    topo: torch.Tensor         # [K, NP] i32 per-axis topology value ids (0 = absent)


def state_from_jax_numpy(arrays: Sequence[np.ndarray], device="cpu") -> DeviceNodeState:
    """The JAX package's DeviceNodeState, fetched field by field with
    np.asarray, as the port's tensors (same layout, same dtypes)."""
    return DeviceNodeState(*[torch.from_numpy(np.array(a)).to(device) for a in arrays])


def _pow2(n: int, floor: int) -> int:
    c = floor
    while c < n:
        c *= 2
    return c


class _Regrown(Exception):
    """Internal: a capacity tier changed mid-encode; re-walk the snapshot."""


class NodeStateMirror:
    """Host-side staging + device flush for DeviceNodeState."""

    def __init__(self, device, node_capacity: int = 64, taint_capacity: int = 4,
                 scalar_capacity: int = 4, axis_capacity: int = 4,
                 scatter_threshold: float = 0.25):
        self.device = torch.device(device)
        self.np_cap = node_capacity
        self.t_cap = taint_capacity
        self.s_cap = scalar_capacity
        self.k_cap = axis_capacity
        self.scatter_threshold = scatter_threshold
        self.keys = Codebook()        # taint keys (shared with tolerations)
        self.vals = Codebook()        # taint values
        self.names = Codebook()       # node names
        self.scalar_slots: Dict[str, int] = {}  # scalar resource -> slot >= BASE_RESOURCES
        self._alloc_storage()
        self._row_names: List[str] = []
        self._row_gen: List[int] = []
        self._dirty: set = set()
        self._full_flush = True
        self._device: Optional[DeviceNodeState] = None
        self.num_nodes = 0

    # -- storage -----------------------------------------------------------

    @property
    def r_slots(self) -> int:
        return BASE_RESOURCES + self.s_cap

    def _alloc_storage(self) -> None:
        npc, t, r, k = self.np_cap, self.t_cap, self.r_slots, self.k_cap
        self.h_alloc_r = np.zeros((npc, r), np.int64)
        self.h_alloc_pods = np.zeros(npc, np.int64)
        self.h_req_r = np.zeros((npc, r), np.int64)
        self.h_nonzero = np.zeros((npc, 2), np.int64)
        self.h_pod_count = np.zeros(npc, np.int32)
        self.h_taint_key = np.zeros((npc, t), np.int32)
        self.h_taint_val = np.zeros((npc, t), np.int32)
        self.h_taint_eff = np.zeros((npc, t), np.int32)
        self.h_unsched = np.zeros(npc, bool)
        self.h_valid = np.zeros(npc, bool)
        self.h_name_id = np.zeros(npc, np.int32)
        # The slice registers no topology axes (spread and pod affinity are
        # outside it); the tensor keeps the reference's [K, NP] shape.
        self.h_topo = np.zeros((k, npc), np.int32)

    def _grow(self, node_capacity=None, taint_capacity=None, scalar_capacity=None) -> None:
        """Capacity tier change: reallocate staging and force a full
        re-encode + full upload."""
        self.np_cap = node_capacity or self.np_cap
        self.t_cap = taint_capacity or self.t_cap
        self.s_cap = scalar_capacity or self.s_cap
        self._alloc_storage()
        self._row_names = []
        self._row_gen = []
        self._full_flush = True
        self._device = None

    def scalar_slot(self, resource_name: str) -> int:
        slot = self.scalar_slots.get(resource_name)
        if slot is not None:
            return slot
        if len(self.scalar_slots) >= self.s_cap:
            self._grow(scalar_capacity=self.s_cap * 2)
        slot = BASE_RESOURCES + len(self.scalar_slots)
        self.scalar_slots[resource_name] = slot
        return slot

    # -- row encoding ------------------------------------------------------

    def resource_vec(self, r: "res.Resource", out: np.ndarray) -> None:
        out[:] = 0
        out[SLOT_CPU] = r.milli_cpu
        out[SLOT_MEMORY] = r.memory
        out[SLOT_EPHEMERAL] = r.ephemeral_storage
        for name, amount in r.scalar_resources.items():
            slot = self.scalar_slot(name)
            if slot >= out.shape[0]:
                # scalar_slot grew the tier: `out` points into orphaned arrays.
                raise _Regrown()
            out[slot] = amount

    def _encode_row(self, i: int, ni: NodeInfo) -> None:
        node = ni.node
        self.resource_vec(ni.allocatable, self.h_alloc_r[i])
        self.h_alloc_pods[i] = ni.allocatable.allowed_pod_number
        self.resource_vec(ni.requested, self.h_req_r[i])
        self.h_nonzero[i, 0] = ni.non_zero_requested.milli_cpu
        self.h_nonzero[i, 1] = ni.non_zero_requested.memory
        self.h_pod_count[i] = len(ni.pods)
        taints = node.taints if node else []
        if len(taints) > self.t_cap:
            self._grow(taint_capacity=_pow2(len(taints), self.t_cap * 2))
            raise _Regrown()
        self.h_taint_key[i] = 0
        self.h_taint_val[i] = 0
        self.h_taint_eff[i] = 0
        for j, t in enumerate(taints):
            self.h_taint_key[i, j] = self.keys.intern(t.key)
            self.h_taint_val[i, j] = self.vals.intern(t.value)
            self.h_taint_eff[i, j] = EFFECT_IDS.get(t.effect, 0)
        self.h_unsched[i] = bool(node and node.unschedulable)
        self.h_valid[i] = node is not None
        self.h_name_id[i] = self.names.intern(node.name) if node else 0

    # -- sync --------------------------------------------------------------

    def sync(self, node_info_list: Sequence[NodeInfo]) -> None:
        """Re-encode rows whose generation or position changed (the device
        analogue of cache.go:236-262's generation walk)."""
        n = len(node_info_list)
        if n > self.np_cap:
            self._grow(node_capacity=_pow2(n, self.np_cap * 2))
        while True:
            try:
                self._sync_rows(node_info_list)
                break
            except _Regrown:
                continue  # capacity tier changed: staging reset, re-walk
        self.num_nodes = n

    def _sync_rows(self, node_info_list: Sequence[NodeInfo]) -> None:
        n = len(node_info_list)
        names, gens = self._row_names, self._row_gen
        for i, ni in enumerate(node_info_list):
            if i < len(names) and names[i] == ni.name and gens[i] == ni.generation:
                continue
            self._encode_row(i, ni)
            if i < len(names):
                names[i] = ni.name
                gens[i] = ni.generation
            else:
                names.append(ni.name)
                gens.append(ni.generation)
            self._dirty.add(i)
        if len(names) > n:  # shrink: invalidate tail rows
            for i in range(n, len(names)):
                self.h_valid[i] = False
                self._dirty.add(i)
            del names[n:]
            del gens[n:]

    # -- flush -------------------------------------------------------------

    def _arrays(self):
        return (self.h_alloc_r, self.h_alloc_pods, self.h_req_r, self.h_nonzero,
                self.h_pod_count, self.h_taint_key, self.h_taint_val,
                self.h_taint_eff, self.h_unsched, self.h_valid, self.h_name_id)

    def _upload(self) -> DeviceNodeState:
        return DeviceNodeState(*[torch.from_numpy(a.copy()).to(self.device)
                                 for a in self._arrays() + (self.h_topo,)])

    def _scatter_dirty(self, dirty: List[int]) -> DeviceNodeState:
        """Dirty-row scatter into the resident device state (a fresh
        tensor per field: a dispatched batch may still read the old one)."""
        idx = torch.as_tensor(dirty, dtype=torch.int64).to(self.device)
        fields = []
        for arr, a in zip(self._device[:-1], self._arrays()):
            rows = torch.from_numpy(a[dirty]).to(self.device)
            fields.append(arr.index_copy(0, idx, rows))
        topo = self._device.topo.index_copy(
            1, idx, torch.from_numpy(self.h_topo[:, dirty]).to(self.device))
        return DeviceNodeState(*fields, topo)

    def flush(self) -> DeviceNodeState:
        """Upload pending changes and return the device state: a row
        scatter when the dirty fraction is small, a full upload otherwise."""
        if self._device is None or self._full_flush:
            self._device = self._upload()
        elif self._dirty:
            if len(self._dirty) > self.scatter_threshold * self.np_cap:
                self._device = self._upload()
            else:
                self._device = self._scatter_dirty(sorted(self._dirty))
        self._dirty.clear()
        self._full_flush = False
        return self._device

    def invalidate(self) -> None:
        """Force a full staging re-encode + full upload on the next
        sync/flush (a device session diverged from the host)."""
        self._full_flush = True
        self._row_gen = [-1] * len(self._row_gen)

    def adopt(self, node_info_list: Sequence[NodeInfo], rows: Sequence[int],
              req_r: torch.Tensor, nonzero: torch.Tensor, pod_count: torch.Tensor) -> None:
        """After a clean device session: the final carry already holds the
        updated per-node aggregates, so install those tensors directly and
        bring host staging + generations in line without marking rows
        dirty — the next flush uploads nothing (the device-resident
        analogue of cache.go's incremental UpdateSnapshot)."""
        if self._device is None or self._full_flush:
            return  # a full upload from (authoritative) staging is pending
        try:
            for i in rows:
                ni = node_info_list[i]
                self.resource_vec(ni.requested, self.h_req_r[i])
                self.h_nonzero[i, 0] = ni.non_zero_requested.milli_cpu
                self.h_nonzero[i, 1] = ni.non_zero_requested.memory
                self.h_pod_count[i] = len(ni.pods)
                self._row_gen[i] = ni.generation
        except _Regrown:
            return  # staging reset; the full flush rebuilds everything
        self._device = self._device._replace(
            req_r=req_r, nonzero=nonzero, pod_count=pod_count)
