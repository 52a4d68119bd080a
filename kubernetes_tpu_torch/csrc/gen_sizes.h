// The general step's sizes: the block, the table slots, the on-chip budget,
// the bytes of the chunk masks, and the layout of a placement lane's arrays
// (schedule_placements.cu). Plain C++ with no CUDA header, so a host
// compiler reads it alone: the CPU tests build it with g++ and hold the
// wrapper's copy of the layout (ops/kernel.py _placement_lane_bytes,
// PLACEMENT_SMEM_MAX) against it. The launcher checks the slice the
// wrapper allocated against it too.
#pragma once

#include <stddef.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#endif

#define GEN_MAXC 16        // table rows per kind that have a slot (the wrappers check C1, C2)

constexpr int GEN2_THREADS = 512;
constexpr int GEN2_WARPS = GEN2_THREADS / 32;
constexpr size_t GEN2_SMEM_MAX = 220 * 1024;     // dynamic shared memory a launch may plan

// The chunk masks and prefixes of n positions: [chunk rows][warps + 1] each.
static __host__ __device__ inline size_t gen_mask_bytes(int n) {
  const size_t kw = ((size_t)(n + 31) / 32 + GEN2_WARPS - 1) / GEN2_WARPS;
  return 2 * kw * (GEN2_WARPS + 1) * 4;
}

// Where each array of a placement lane lives: a byte offset into the
// block's dynamic shared memory (>= 0), or ~offset into the lane's slice of
// the scratch. Arrays go on chip in order of use while they fit the budget.
struct LaneLayout {
  int mask, flags, rows, total, fsc, fba, land;
  int cnt[2 * GEN_MAXC];  // the dns tables, then the sa tables
  int vid[2 * GEN_MAXC];
  int dom[GEN_MAXC];
  size_t on_chip, off_chip;  // bytes of each part
};

struct LaneCursor {
  size_t budget, on, off;
  __host__ __device__ int take(size_t bytes) {
    const size_t o = (on + 15) & ~(size_t)15;
    if (o + bytes <= budget) {
      on = o + bytes;
      return (int)o;
    }
    const size_t g = (off + 15) & ~(size_t)15;
    off = g + bytes;
    return ~(int)g;
  }
};

// A lane of n positions: the chunk masks and prefixes, the flags, the row
// list, each dns table with its domains and each sa table, a value id a
// position a table, the carried total (or the fit score and
// BalancedAllocation) and the landing count a position.
static __host__ __device__ inline LaneLayout lane_layout(int n, int V, int C1, int C2,
                                                         bool carried, size_t budget) {
  LaneLayout L;
  LaneCursor cur{budget, 0, 0};
  const size_t m = (size_t)n;
  L.mask = cur.take(gen_mask_bytes(n));
  L.flags = cur.take(m);
  L.rows = cur.take(4 * m);
  for (int c = 0; c < C1; ++c) {
    L.cnt[c] = cur.take((size_t)V * 4);
    L.dom[c] = cur.take((size_t)V);
  }
  for (int c = 0; c < C2; ++c) L.cnt[GEN_MAXC + c] = cur.take((size_t)V * 4);
  for (int c = 0; c < C1; ++c) L.vid[c] = cur.take(4 * m);
  for (int c = 0; c < C2; ++c) L.vid[GEN_MAXC + c] = cur.take(4 * m);
  L.total = carried ? cur.take(8 * m) : 0;
  L.fsc = carried ? 0 : cur.take(8 * m);
  L.fba = carried ? 0 : cur.take(8 * m);
  L.land = cur.take(4 * m);
  L.on_chip = (cur.on + 15) & ~(size_t)15;
  L.off_chip = (cur.off + 15) & ~(size_t)15;
  return L;
}
