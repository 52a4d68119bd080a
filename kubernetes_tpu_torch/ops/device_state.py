"""Device mirror of the scheduler snapshot: fixed-capacity SoA node tensors.

The device form of the reference's incremental snapshot refresh
(pkg/scheduler/backend/cache/cache.go:206 UpdateSnapshot): the mirror keeps
one row per node in `snapshot.node_info_list` order, re-encodes only rows
whose NodeInfo.generation advanced (or whose list position changed), and
flushes them to the device with the scatter_rows kernel (ops/kernel.py)
when few rows are dirty, a full upload otherwise.

Under a node mesh (commit_mesh, parallel/mesh.py) the resident device copy
is the sharded state: each shard's rows are uploaded to its own device,
dirty rows are routed to their shards and scattered there (the JAX
package's _sharded_scatter), and row patches and the session-end adoption
write the shards in place.

Row order == snapshot list order, so the kernels' rotation arithmetic
(schedule_one.go:816 nextStartNodeIndex) operates directly on row indices.
Topology keys that a batch's spread constraints or affinity terms name are
registered as axes (`ensure_axis`): row `ax.index` of `topo` holds each
node's interned value id for that key, 0 where the node lacks it.
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
from .staging import StagingRing

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


class TopoAxis:
    """One registered topology key (e.g. topology.kubernetes.io/zone): its
    value codebook and its row in the mirror's `topo` tensor. Value id 0
    means "key absent"; a label present with an EMPTY value (a real domain
    for topology spreading) is interned under a private token so that it
    gets a distinct non-zero id."""

    __slots__ = ("key", "index", "values")

    _EMPTY_TOKEN = "\x00empty"

    def __init__(self, key: str, index: int):
        self.key = key
        self.index = index
        self.values = Codebook()

    def intern_value(self, val: str) -> int:
        return self.values.intern(val if val != "" else self._EMPTY_TOKEN)

    def lookup_value(self, val: str) -> int:
        return self.values.lookup(val if val != "" else self._EMPTY_TOKEN)


def state_from_jax_numpy(arrays: Sequence[np.ndarray], device="cpu") -> DeviceNodeState:
    """The JAX package's DeviceNodeState, fetched field by field with
    np.asarray, as the port's tensors (same layout, same dtypes)."""
    return DeviceNodeState(*[torch.from_numpy(np.array(a)).to(device) for a in arrays])


def _pow2(n: int, floor: int) -> int:
    c = floor
    while c < n:
        c *= 2
    return c


def patch_tier(n: int) -> int:
    """Padded length of a delta patch's dirty-row index (the JAX package's
    patch_tier, ops/device_state.py:83-96): 32, 256, then powers of two from
    2048. Padding repeats the last real row, whose duplicates write
    identical values, so a coarse tier is exact."""
    if n <= 32:
        return 32
    if n <= 256:
        return 256
    return _pow2(n, 2048)


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
        self.axes: Dict[str, TopoAxis] = {}
        self._alloc_storage()
        self._row_names: List[str] = []
        self._row_gen: List[int] = []
        self._dirty: set = set()
        self._full_flush = True
        self._device: Optional[DeviceNodeState] = None
        self.mesh = None  # a parallel/mesh.py NodeMesh: the resident is Sharded
        self.num_nodes = 0
        self.scatter_flushes = 0  # flushes that took the dirty-row scatter
        self.scatter_rows = 0     # rows those flushes wrote
        self._rings: Dict[torch.device, StagingRing] = {}

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
        self.h_topo = np.zeros((k, npc), np.int32)

    def _grow(self, node_capacity=None, taint_capacity=None, scalar_capacity=None,
              axis_capacity=None) -> None:
        """Capacity tier change: reallocate staging and force a full
        re-encode + full upload."""
        self.np_cap = node_capacity or self.np_cap
        self.t_cap = taint_capacity or self.t_cap
        self.s_cap = scalar_capacity or self.s_cap
        self.k_cap = axis_capacity or self.k_cap
        self._alloc_storage()
        self._row_names = []
        self._row_gen = []
        self._full_flush = True
        self._device = None

    def ensure_axis(self, key: str) -> TopoAxis:
        """The axis of topology key `key`, registering it on first use: a new
        axis re-encodes every row at the next sync (a full upload)."""
        ax = self.axes.get(key)
        if ax is not None:
            return ax
        if len(self.axes) >= self.k_cap:
            self._grow(axis_capacity=self.k_cap * 2)
        ax = TopoAxis(key, len(self.axes))
        self.axes[key] = ax
        self._full_flush = True
        self._row_gen = [-1] * len(self._row_gen)
        return ax

    @property
    def vmax(self) -> int:
        """The count tables' value tier: every axis' value ids (plus the
        absent id 0) fit, at least 64, a power of two."""
        return _pow2(max((len(ax.values) for ax in self.axes.values()), default=1) + 1, 64)

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
        labels = node.labels if node else {}
        for ax in self.axes.values():
            val = labels.get(ax.key)
            self.h_topo[ax.index, i] = ax.intern_value(val) if val is not None else 0

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

    def commit_mesh(self, mesh) -> None:
        """Commit the resident device copy to `mesh`'s node shards (None:
        the one device) — the JAX package's commit_shardings (:371-380).
        Under a mesh the resident is a parallel/mesh.py Sharded state. A
        changed commitment forces a full upload at the new placement."""
        if mesh != self.mesh:
            self.mesh = mesh
            self._device = None
            self._full_flush = True

    def _upload(self) -> DeviceNodeState:
        if self.mesh is not None:
            return self._upload_sharded()
        return DeviceNodeState(*[torch.from_numpy(a.copy()).to(self.device)
                                 for a in self._arrays() + (self.h_topo,)])

    def _upload_sharded(self):
        """Full upload straight to the shards: each shard's rows to its own
        device, no whole copy on any device."""
        from ..parallel.mesh import Sharded, row_blocks

        devs = self.mesh.nodes(0)
        blocks = row_blocks(self.np_cap, len(devs))
        parts = [DeviceNodeState(*[torch.from_numpy(a[lo:hi].copy()).to(d) for a in self._arrays()],
                                 torch.from_numpy(self.h_topo[:, lo:hi].copy()).to(d))
                 for d, (lo, hi) in zip(devs, blocks)]
        return Sharded(parts, blocks[0][1] - blocks[0][0])

    def ring(self, device) -> StagingRing:
        """The staging ring of `device`'s uploads (one a device: the mesh's
        shards may sit on several)."""
        device = torch.device(device)
        ring = self._rings.get(device)
        if ring is None:
            ring = self._rings[device] = StagingRing(device)
        return ring

    def _scatter_sharded(self, dirty: List[int], in_place: bool):
        """The mesh's dirty-row scatter (the JAX package's _sharded_scatter,
        ops/device_state.py:138-164): each dirty row goes to its shard by
        row // NPl, and each shard with dirty rows takes one upload of its
        rows and local indices and one scatter_rows launch, writing the
        shard's own tensors (`in_place`: no dispatched batch reads them) or
        new ones. Shards without dirty rows keep their tensors."""
        from ..parallel.mesh import Sharded, on_device
        from .kernel import scatter_rows, stage_scatter

        res = self._device
        b = res.block
        parts = list(res.parts)
        by_shard: Dict[int, List[int]] = {}
        for row in dirty:
            by_shard.setdefault(row // b, []).append(row)
        for s, rows in sorted(by_shard.items()):
            dev = parts[s].valid.device
            idx, packed = stage_scatter(self.ring(dev), self._arrays(), self.h_topo, rows,
                                        [r - s * b for r in rows])
            with on_device(dev):
                parts[s] = scatter_rows(parts[s], idx, packed, in_place=in_place)
        if in_place:
            res.touched()
            return res
        return Sharded(parts, b)

    def _scatter_dirty(self, dirty: List[int]) -> DeviceNodeState:
        """Dirty-row scatter into a new device state (a dispatched batch may
        still read the resident one): the rows and their indices packed on
        the host into one staging buffer, one upload, one scatter_rows
        launch that writes the new state whole."""
        if self.mesh is not None:
            return self._scatter_sharded(dirty, in_place=False)
        # ops/kernel.py imports this module for DeviceNodeState.
        from .kernel import scatter_rows, stage_scatter

        idx, packed = stage_scatter(self.ring(self.device), self._arrays(), self.h_topo, dirty)
        return scatter_rows(self._device, idx, packed)

    def flush(self) -> DeviceNodeState:
        """Upload pending changes and return the device state: a row
        scatter when the dirty fraction is small, a full upload otherwise."""
        if (self._device is None or self._full_flush
                or len(self._dirty) > self.scatter_threshold * self.np_cap):
            self._device = self._upload()
        elif self._dirty:
            self._device = self._scatter_dirty(sorted(self._dirty))
            self.scatter_flushes += 1
            self.scatter_rows += len(self._dirty)
        self._dirty.clear()
        self._full_flush = False
        return self._device

    def patch_rows(self, updates: Sequence, sharded_state=None) -> Optional[DeviceNodeState]:
        """Event-delta row flush (the JAX package's NodeStateMirror.patch_rows,
        ops/device_state.py:431-492): re-encode the given (row, NodeInfo)
        pairs from the live cache's NodeInfos and scatter them into the
        resident device state without a snapshot refresh. Returns the
        patched state, or None where a row patch cannot apply (no resident
        copy or a full upload pending, a capacity tier grown mid-encode, a
        row out of range or holding another node): the caller then rebuilds
        its plan in full.

        On one device the scatter writes a new state (_scatter_dirty): the
        state a resumed session or a queued kernel holds keeps its values,
        and the returned state becomes the resident. Under a mesh the
        session passes its state as `sharded_state`: when that is the
        resident, the shards are patched in place, in the resident's own
        storage (the counterpart of the JAX donation; the caller patches
        only while no dispatched batch reads it); otherwise into new tensors.
        The resident is returned either way."""
        if self._device is None or self._full_flush:
            return None
        # Validate every row before encoding any: a late failure after
        # earlier rows were encoded with current generations would leave
        # them stale on the device, unseen by the next sync.
        for row, ni in updates:
            if (row >= self.np_cap or row >= len(self._row_names)
                    or ni.name != self._row_names[row]):
                return None
        try:
            for row, ni in updates:
                self._encode_row(row, ni)
                self._row_gen[row] = ni.generation
        except _Regrown:
            return None  # staging reset: the next flush uploads everything
        dirty = sorted({row for row, _ in updates})
        if self.mesh is not None:
            self._device = self._scatter_sharded(
                dirty, in_place=sharded_state is self._device)
        else:
            self._device = self._scatter_dirty(dirty)
        self._dirty.difference_update(dirty)
        self.scatter_flushes += 1
        self.scatter_rows += len(dirty)
        return self._device

    def patch_carry(self, state, f, carry, rows: Sequence[int], fit_strategy: int):
        """The carry half of a row patch (after patch_rows): the rows'
        aggregates from host staging, padded to their patch_tier with
        copies of the last row, staged and uploaded at once, and one
        patch_carry_rows launch on them into a new carry (under a mesh
        patch_carry_rows_pinned, with `f` and `carry` as the mesh holds
        them). Returns the patched carry."""
        from .kernel import patch_carry_rows, patch_carry_rows_pinned, stage_carry_patch

        rows = list(rows)
        rows += [rows[-1]] * (patch_tier(len(rows)) - len(rows))
        staged = stage_carry_patch(self.ring(self.device), rows, self.h_req_r, self.h_nonzero,
                                   self.h_pod_count)
        patch = patch_carry_rows if self.mesh is None else patch_carry_rows_pinned
        return patch(state, f, carry, *staged, fit_strategy)

    def invalidate(self) -> None:
        """Force a full staging re-encode + full upload on the next
        sync/flush (a device session diverged from the host)."""
        self._full_flush = True
        self._row_gen = [-1] * len(self._row_gen)

    def adopt(self, node_info_list: Sequence[NodeInfo], rows: Sequence[int],
              req_r: torch.Tensor, nonzero: torch.Tensor, pod_count: torch.Tensor,
              dirty_rows: Sequence[int] = ()) -> None:
        """After a clean device session: the final carry already holds the
        updated per-node aggregates, so install those tensors directly and
        bring host staging + generations in line without marking rows
        dirty — the next flush uploads nothing (the device-resident
        analogue of cache.go's incremental UpdateSnapshot). `dirty_rows`
        (rows whose host commit diverged from the carry) go through the
        normal dirty path. Under a mesh the aggregates are copied into the
        resident's shards in place; each lane is then a whole tensor or a
        list of one tensor a shard."""
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
        if self.mesh is not None:
            res = self._device
            for s, part in enumerate(res.parts):
                lo = s * res.block
                hi = lo + part.valid.shape[0]
                for dst, src in ((part.req_r, req_r), (part.nonzero, nonzero),
                                 (part.pod_count, pod_count)):
                    dst.copy_(src[s] if isinstance(src, (list, tuple)) else src[lo:hi])
            res.touched()
        else:
            self._device = self._device._replace(
                req_r=req_r, nonzero=nonzero, pod_count=pod_count)
        self._dirty.update(dirty_rows)
