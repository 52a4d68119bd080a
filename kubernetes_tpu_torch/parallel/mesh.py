"""The node-sharded mesh: the JAX package's parallel/mesh.py in one process.

A NodeMesh is a ("cells", "nodes") grid of torch devices, driven by one
process as the JAX mesh is: every shard's tensors live on its device and
every shard's kernels are launched from here. One device may repeat in the
grid — `make_mesh(devices=["cuda:0"] * 4)` puts four shards on one card,
`make_mesh(devices=["cpu"] * 8)` eight on the CPU — so the whole sharded
algorithm, its exchanges included, runs on one device; with one card a
shard each, the same code spans cards.

Layout (the JAX package's _state_specs, _feature_specs, _carry_specs,
:81-100, :217-226). Shard s of S holds global rows [s * NPl, (s + 1) * NPl)
of:

- every per-node array of DeviceNodeState (`topo`, [K, NP], along dim 1);
- the per-node features exist_anti, ipa_base, sel_match, extra_ok,
  il_score, na_raw, aux_room, nom_pods and nom_req;
- a session carry's per-node lanes (req_r, nonzero, pod_count, fit_ok,
  fit_sc, ba, blocked, aux_cnt).

Count tables, pod-level values and the carry's `start` are copied to each
distinct device. The shard index is outer-axis-major, as in the JAX mesh;
the scheduler shards over the first cell's row.

The row-local lap (ShardedLap) runs each shard's three sharded_lap
launchers (ops/kernel.py, csrc/sharded_lap.cu) with exactly two exchanges a
lap, each a copy between the phases: an all-gather of an int32 pair per
shard, and an all-gather of each shard's [2 * LAP_MAX] int64 window keys,
whose max the last phase takes itself.

Not ported (ROADMAP): make_multihost_mesh, mesh_host_split and
collective_report (:52-71, :146-190, :204-215), which parse XLA's HLO over
a (dcn, ici) host grid; a multi-process exchange for meshes across hosts.
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..ops import kernel as K
from ..ops.device_state import DeviceNodeState
from ..ops.features import BatchFeatures, PlanFacts
from ..ops.kernel import LAP_MAX, ScanCarry

i32, i64 = torch.int32, torch.int64


def _norm(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class NodeMesh:
    """A cells x nodes grid of torch devices (the JAX Mesh with axes
    ("cells", "nodes")). A device may appear more than once."""

    def __init__(self, grid: Sequence[Sequence]):
        self.grid = tuple(tuple(_norm(d) for d in row) for row in grid)
        if not self.grid or not self.grid[0] or len({len(r) for r in self.grid}) != 1:
            raise ValueError("a mesh is a non-empty rectangular grid of devices")
        self.shape = {"cells": len(self.grid), "nodes": len(self.grid[0])}

    def nodes(self, cell: int = 0) -> List[torch.device]:
        """The devices of one cell's node shards, in shard order."""
        return list(self.grid[cell])

    @property
    def first(self) -> torch.device:
        return self.grid[0][0]

    def __eq__(self, other):
        return isinstance(other, NodeMesh) and self.grid == other.grid

    def __hash__(self):
        return hash(self.grid)

    def __repr__(self):
        return f"NodeMesh({[[str(d) for d in row] for row in self.grid]})"


def make_mesh(n_cells: int = 1, devices: Optional[Sequence] = None) -> NodeMesh:
    """A mesh over every visible card (or the given devices): ("cells",
    "nodes"). With n_cells=1 every device shards the node axis of one
    cluster. `devices` may repeat a device, e.g. ["cuda:0"] * 4 or
    ["cpu"] * 8: that is how one card or the CPU holds several shards."""
    devs = list(devices) if devices is not None else [
        torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if not devs:
        raise RuntimeError("make_mesh: no device (pass devices=...)")
    n = len(devs)
    if n_cells <= 0 or n % n_cells:
        raise ValueError(f"{n} devices not divisible into {n_cells} cells")
    per = n // n_cells
    return NodeMesh([devs[c * per:(c + 1) * per] for c in range(n_cells)])


def mesh_shard_count(mesh: NodeMesh) -> int:
    """Shards along the node axis (the state's rows must divide by this for
    the sharded lap)."""
    return mesh.shape["nodes"]


def on_device(dev: torch.device):
    """The launch context of a shard's kernels: its card made current."""
    return torch.cuda.device(dev) if dev.type == "cuda" else nullcontext()


def row_blocks(n: int, shards: int) -> List[Tuple[int, int]]:
    """The [lo, hi) rows of each shard: blocks of ceil(n / shards) rows, the
    last one shorter where `shards` does not divide `n`."""
    b = -(-n // shards)
    return [(min(s * b, n), min((s + 1) * b, n)) for s in range(shards)]


# Per-node fields (and their row dimension) of each sharded value.
_STATE_ROWS = dict({name: 0 for name in DeviceNodeState._fields}, topo=1)
_FEATURE_ROWS = {name: 0 for name in ("exist_anti", "ipa_base", "sel_match", "extra_ok",
                                      "il_score", "na_raw", "aux_room", "nom_pods", "nom_req")}
_CARRY_ROWS = {name: 0 for name in ("req_r", "nonzero", "pod_count", "fit_ok", "fit_sc", "ba",
                                    "blocked", "aux_cnt")}
_ROWS = {DeviceNodeState: _STATE_ROWS, BatchFeatures: _FEATURE_ROWS, ScanCarry: _CARRY_ROWS}


class Sharded:
    """A DeviceNodeState, BatchFeatures or ScanCarry cut over a mesh's node
    axis: `parts[s]`, on the shard's device, holds rows [s * block, (s + 1)
    * block) of each per-node field, and its own device's copy of every
    other field. `whole()` gathers it onto the first shard's device,
    memoized; code that writes a part in place calls `touched()`."""

    __slots__ = ("parts", "block", "_whole")

    def __init__(self, parts, block: int, whole=None):
        self.parts = list(parts)
        self.block = block
        self._whole = whole

    @property
    def devices(self) -> List[torch.device]:
        return [p[0].device for p in self.parts]

    def whole(self):
        if self._whole is None:
            first = self.parts[0]
            rows = _ROWS[type(first)]
            dev = first[0].device
            fields = []
            for i, name in enumerate(first._fields):
                dim = rows.get(name)
                if dim is None:
                    fields.append(first[i])
                else:
                    fields.append(torch.cat([p[i].to(dev) for p in self.parts], dim=dim))
            self._whole = type(first)(*fields)
        return self._whole

    def touched(self) -> None:
        self._whole = None


def gather(x):
    """The whole value of a Sharded one, on the mesh's first device (the
    value itself when it is not sharded)."""
    return x.whole() if isinstance(x, Sharded) else x


def _cut(value, mesh: NodeMesh, copy: bool) -> Sharded:
    """`value` cut over the mesh's first cell: per-node fields in row
    blocks, the rest copied once to each distinct device. `copy` gives each
    shard storage of its own; otherwise a block on the value's own device
    is a view of it."""
    rows = _ROWS[type(value)]
    devs = mesh.nodes(0)
    n = None
    for name, dim in rows.items():
        t = getattr(value, name)
        if t.dim() > dim and t.shape[dim] > 0:
            n = t.shape[dim]
            break
    blocks = row_blocks(n or 0, len(devs))
    replicas: Dict[torch.device, list] = {}
    parts = []
    for dev, (lo, hi) in zip(devs, blocks):
        fields = []
        for i, name in enumerate(value._fields):
            t = value[i]
            dim = rows.get(name)
            if dim is not None and t.dim() > dim and t.shape[dim] == n:
                part = t.narrow(dim, lo, hi - lo).to(dev)
                fields.append(part.clone(memory_format=torch.contiguous_format) if copy
                              else part.contiguous())
            else:
                rep = replicas.setdefault(dev, [None] * len(value._fields))
                if rep[i] is None:
                    rep[i] = t.to(dev) if t.device != dev else (t.clone() if copy else t)
                fields.append(rep[i])
        parts.append(type(value)(*fields))
    return Sharded(parts, blocks[0][1] - blocks[0][0])


def shard_node_state(state: DeviceNodeState, mesh: NodeMesh) -> Sharded:
    """A cell's node state placed onto the mesh's node axis (each shard's
    rows copied to its device)."""
    return _cut(state, mesh, copy=True)


def shard_features(feats: BatchFeatures, mesh: NodeMesh) -> Sharded:
    """Batch features placed like the state: per-node vectors in row
    blocks, count tables and pod-level values on each distinct device. The
    gathered whole is `feats` itself."""
    out = _cut(feats, mesh, copy=False)
    out._whole = feats
    return out


def _exchange(src: List[torch.Tensor], dst: Dict[torch.device, torch.Tensor]) -> None:
    """All-gather: every shard's tensor stacked into each device's buffer."""
    for dev, buf in dst.items():
        with on_device(dev):
            torch.stack([t if t.device == dev else t.to(dev, non_blocking=True) for t in src],
                        out=buf)


class _LapShard:
    """One shard's inputs, carry and per-lap buffers."""

    __slots__ = ("dev", "state", "f", "carry", "static_ok", "done", "okd", "Fl", "total", "pair",
                 "keys", "L")

    def __init__(self, dev, state, f, carry, static_ok):
        npl = static_ok.shape[0]
        self.dev, self.state, self.f, self.carry, self.static_ok = dev, state, f, carry, static_ok
        self.done = torch.zeros((), dtype=i32, device=dev)
        self.okd = torch.empty(npl, dtype=torch.uint8, device=dev)
        self.Fl = torch.empty(npl, dtype=i32, device=dev)
        self.total = torch.empty(npl, dtype=i64, device=dev)
        self.pair = torch.zeros(2, dtype=i32, device=dev)
        self.keys = torch.empty(2 * LAP_MAX, dtype=i64, device=dev)
        self.L = torch.ones((), dtype=i32, device=dev)


_PHASES = {
    False: (K.static_masks, K.resource_eval, K.sharded_lap_count, K.sharded_lap_windows,
            K.sharded_lap_land),
    True: (K._static_masks_plain, K._resource_eval_plain, K._sharded_lap_count_plain,
           K._sharded_lap_windows_plain, K._sharded_lap_land_plain),
}


class LapRun:
    """One dispatch of the sharded lap, lap by lap: the shards' buffers,
    the exchange buffers of each distinct device and the [2, B] results on
    shard 0's device. `plain` runs the phases' plain versions (on any
    device) in place of the kernels."""

    def __init__(self, lap: "ShardedLap", state: Sharded, feats: Sharded, n_active: int,
                 carry_in: Optional[Sharded], plain: bool = False):
        S = len(state.parts)
        npl = state.block
        if S != mesh_shard_count(lap.mesh) or any(p.valid.shape[0] != npl for p in state.parts):
            raise ValueError(f"the sharded lap needs {mesh_shard_count(lap.mesh)} shards of "
                             "equal rows")
        if feats.parts[0].nom_req.shape[0]:
            raise ValueError("the sharded lap takes row-local plans: no nominated-pod lane")
        self.lap, self.n_act, self.carry_in = lap, int(n_active), carry_in
        self.masks, self.resource_eval, self.count, self.windows, self.land = _PHASES[plain]
        fs, vmax = lap.fit_strategy, lap.vmax
        self.shards: List[_LapShard] = []
        for s, (dev, st, f) in enumerate(zip(state.devices, state.parts, feats.parts)):
            with on_device(dev):
                static_ok = self.masks(st, f).static_ok
                if carry_in is None:
                    # The fresh carry (:377-388): the shard's own copies of
                    # the resident aggregates, which the landings update.
                    fit = self.resource_eval(f, fs, st.alloc_r, st.alloc_pods, st.req_r,
                                             st.nonzero, st.pod_count)
                    ext = ScanCarry(st.req_r.clone(), st.nonzero.clone(), st.pod_count.clone(),
                                    *fit, f.dns_counts, f.sa_counts, f.anti_counts,
                                    f.aff_counts, torch.zeros((0, vmax), dtype=i64, device=dev),
                                    f.start_index.clone(),
                                    torch.zeros(npl, dtype=torch.bool, device=dev),
                                    torch.zeros(npl, dtype=i32, device=dev))
                else:
                    ext = carry_in.parts[s]
                self.shards.append(_LapShard(dev, st, f, ext, static_ok))
        self.pairs = {d: torch.empty((S, 2), dtype=i32, device=d) for d in dict.fromkeys(
            state.devices)}
        self.keys = {d: torch.empty((S, 2 * LAP_MAX), dtype=i64, device=d) for d in self.pairs}
        self.out = torch.full((2, lap.batch_pad), -1, dtype=i32, device=state.devices[0])
        self.laps = 0  # laps launched, the inert ones of a last chunk included

    def count_phase(self) -> None:
        for s, sh in enumerate(self.shards):
            c = sh.carry
            with on_device(sh.dev):
                self.count(sh.state, sh.f, self.lap.fit_strategy, c.req_r, c.nonzero, c.pod_count,
                           sh.static_ok, self.n_act, s, sh.done, c.start, sh.okd, sh.Fl, sh.total,
                           sh.pair)

    def exchange_pairs(self) -> None:
        _exchange([sh.pair for sh in self.shards], self.pairs)

    def windows_phase(self) -> None:
        for s, sh in enumerate(self.shards):
            with on_device(sh.dev):
                self.windows(sh.f, self.n_act, s, self.pairs[sh.dev], sh.okd, sh.Fl, sh.total,
                             sh.done, sh.carry.start, sh.keys, sh.L)

    def exchange_keys(self) -> None:
        _exchange([sh.keys for sh in self.shards], self.keys)

    def land_phase(self) -> None:
        for s, sh in enumerate(self.shards):
            c = sh.carry
            with on_device(sh.dev):
                self.land(sh.f, self.n_act, s, self.keys[sh.dev], sh.L, c.req_r, c.nonzero,
                          c.pod_count, self.out if s == 0 else None, c.start, sh.done)

    def one_lap(self) -> None:
        self.count_phase()
        self.exchange_pairs()
        self.windows_phase()
        self.exchange_keys()
        self.land_phase()
        self.laps += 1

    def run(self) -> Tuple[torch.Tensor, Sharded]:
        """Laps until done >= n_active: chunks of laps, `done` read once a
        chunk. The first chunk is the fewest laps that could place every pod
        (LAP_MAX a lap); later ones extrapolate the pods a lap so far. Laps
        past the end are inert."""
        known = 0
        while known < self.n_act:
            left = self.n_act - known
            chunk = -(-left // LAP_MAX) if known == 0 else min(left, -(-left * self.laps // known))
            for _ in range(chunk):
                self.one_lap()
            known = int(self.shards[0].done)
        fs = self.lap.fit_strategy
        parts = []
        for sh in self.shards:
            c = sh.carry
            with on_device(sh.dev):
                fit = self.resource_eval(sh.f, fs, sh.state.alloc_r, sh.state.alloc_pods,
                                         c.req_r, c.nonzero, c.pod_count)
                if self.carry_in is None:
                    parts.append(c._replace(fit_ok=fit[0], fit_sc=fit[1], ba=fit[2]))
                else:
                    for lane, new in zip((c.fit_ok, c.fit_sc, c.ba), fit):
                        lane.copy_(new)
        if self.carry_in is None:
            return self.out, Sharded(parts, self.shards[0].static_ok.shape[0])
        self.carry_in.touched()
        return self.out, self.carry_in


class ShardedLap:
    """The node-sharded lap for one (mesh, batch_pad, fit_strategy, vmax),
    the JAX package's _ShardedLap (:354-426): `__call__(state, feats,
    n_active, carry_in=None)` with schedule_batch's contract — (the [2,
    batch_pad] results on shard 0's device, the final carry, Sharded). A
    fresh carry (carry_in None) starts from the shards' resident aggregates;
    a chained carry is updated in place and returned (the counterpart of
    the JAX chained trace's donate_argnums=3). The plan must be row-local
    (ops/features.py BatchPlan.row_local): a landing changes only its own
    row. On CUDA shards every phase launches its kernel; on CPU shards the
    plain versions run."""

    def __init__(self, mesh: NodeMesh, batch_pad: int, fit_strategy: int, vmax: int):
        self.mesh, self.batch_pad, self.fit_strategy, self.vmax = (mesh, batch_pad, fit_strategy,
                                                                   vmax)

    def __call__(self, state: Sharded, feats: Sharded, n_active: int,
                 carry_in: Optional[Sharded] = None) -> Tuple[torch.Tensor, Sharded]:
        return LapRun(self, state, feats, n_active, carry_in).run()

    def plain(self, state: Sharded, feats: Sharded, n_active: int,
              carry_in: Optional[Sharded] = None) -> Tuple[torch.Tensor, Sharded]:
        """The same lap through the phases' plain versions, whatever the
        tensors' device (how the card's run holds the kernels exact)."""
        return LapRun(self, state, feats, n_active, carry_in, plain=True).run()


# The counterpart of the JAX package's sharded_lap_schedule: a ShardedLap
# holds only its statics, so there is nothing to cache.
sharded_lap_schedule = ShardedLap


# The JAX package's schedule_batch defaults (has_pns and has_ipa_base on),
# which its sharded_schedule_batch runs with.
JAX_DEFAULT_FACTS = PlanFacts(has_pns=True, has_ipa_base=True)


def sharded_schedule_batch(mesh: NodeMesh, batch_pad: int, fit_strategy: int, vmax: int):
    """The counterpart of the JAX package's sharded_schedule_batch
    (:429-454): `run(state, feats, facts=JAX_DEFAULT_FACTS, n_active=None)` takes a
    state and features whose every field has a leading cell dimension
    (mesh.shape["cells"] of them) and schedules each cell independently —
    the JAX vmap over cells written out as a loop. Cell c's state and
    features go to row c of the grid, and schedule_batch runs on the row's
    first device, where the JAX GSPMD path gathers them. Returns ([cells,
    2, batch_pad] results on the mesh's first device, [each cell's final
    carry]); each cell's results equal its single-device run."""

    def run(state: DeviceNodeState, feats: BatchFeatures, facts: PlanFacts = JAX_DEFAULT_FACTS,
            n_active: Optional[int] = None):
        outs, carries = [], []
        for c in range(mesh.shape["cells"]):
            dev = mesh.grid[c][0]
            st = DeviceNodeState(*[x[c].to(dev) for x in state])
            ft = BatchFeatures(*[x[c].to(dev) for x in feats])
            with on_device(dev):
                out, carry = K.schedule_batch(st, ft, batch_pad, fit_strategy, vmax, facts,
                                              n_active=n_active)
            outs.append(out.to(mesh.first))
            carries.append(carry)
        return torch.stack(outs), carries

    return run
