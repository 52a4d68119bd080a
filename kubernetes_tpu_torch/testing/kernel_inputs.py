"""Seeded numpy inputs for the batch kernels, in the field order and dtypes
of DeviceNodeState and BatchFeatures (the JAX package's and the port's are
the same), so one draw can feed both packages and the port's kernels and
their plain versions.

The draw is a cluster of `num_nodes` live rows padded to `np_cap`, with
random allocatable/requested vectors, taints, tolerations, unschedulable
flags and selector verdicts; the keyword arguments pick the cases the
parity checks need (rotation start past a row, truncation on or off,
zero-request pods, no feasible row at all).
"""

from __future__ import annotations

from typing import Optional, Tuple

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
