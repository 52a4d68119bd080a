// lap_schedule: the JAX package's _lap_schedule
// (kubernetes_tpu/ops/kernel.py:799-925) as one persistent single-block
// kernel that runs the whole while_loop with the batch's row state on chip.
//
// What it computes. With adaptive sampling, pod i examines the window of the
// first to_find feasible rows after its start index, and pod i+1's window
// begins where pod i's ended. A lap takes L = clamp(min(total_feasible //
// to_find, n_act - done), 1, LAP_MAX) windows at once: window w holds the
// rows of rotation ranks w*tf + 1 .. (w+1)*tf, its pod lands on the row of
// the largest key total*NP + (NP-1-rot) (highest score, then first in
// rotation order), and lane w's next start follows the row of rank
// (w+1)*tf (every lane w < LAP_MAX writes it, L or not).
//
// Why it is exact with no per-lap pass over the rows. A landing changes its
// own row only (:809-822): the row's requests, non-zero requests, pod
// count, blocked flag and aux_cnt, hence its fit verdict, fit score,
// BalancedAllocation and total, and nothing of any other row. So each row
// is evaluated once, in a prologue, and a lap re-evaluates only the rows
// that landed (at most L <= 32), with resource_eval_row's arithmetic. The
// one input that couples rows is the required anti-affinity lane (A1 > 0):
// a landing adds anti_self at its row's value, and every row with that
// value reads the count. The lap's plans have a singleton-per-node axis
// there (ops/features.py), but the kernel does not rely on it: with A1 > 0
// it redoes every row's anti verdict each lap (an int32 gather of topo and
// anti_counts, no int64 evaluation) and refreshes the chunks whose verdicts
// changed, so repeated values stay exact.
//
// What bounds a lap on this card. The bytes are few: each row is read once
// and the carry written once (0.0006 ms at NP 8192, bytes over 3.35 TB/s).
// The floor is the lap's serial chain on one SM: three block barriers, one
// warp's scan of the chunk counts, a window's searches and reduction (about
// twenty dependent shared-memory loads, ballots and warp reductions), one
// round trip to L2 for the landed row and two levels of divisions to
// re-evaluate it, then its chunk's refresh. That chain, times the laps
// (~B * to_find / feasible rows), bounds the kernel; rows and bytes do not.
// Measured on an H100 (chip_smoke.py): ~4.7 us a lap on SchedulingBasic's
// next batch (103 laps), where a dense pass over every row each lap took
// ~98 us a lap.
//
// The design, point by point:
// - Every row is evaluated once, in the prologue; rows are dealt so that
//   neighbouring lanes take neighbouring rows (row tid + k*1024): chunk c
//   of 32 rows belongs to warp c mod 32. The prologue writes the carry's
//   fit_ok / fit_sc / ba, keeps each row's total (int64) and each chunk's
//   feasible rows as a 32-bit ballot mask on chip, and keeps the base
//   verdict (static, fit, i < num, blocked, aux) apart from the anti one.
//   There is no epilogue pass: a landing rewrites its row's fit outputs.
// - A summary a chunk: its feasible count (popcount of the mask), the
//   maximum total over its feasible rows and the first row at it. For a
//   chunk wholly on one side of the rotation origin, rotation order is row
//   order, so the first row at the maximum is the chunk's tie-break.
// - A lap: (1) one warp scans the chunk counts (256 at NP 8192) into chunk
//   prefixes, giving total_feasible and L; f_start is a prefix plus the
//   popcount of the mask below `start`. (2) Warp w takes window lane w: it
//   finds the rows of its first and last rank by a 32-way search of the
//   chunk prefixes and the rank's bit in the mask (the two searches in one
//   instruction stream), and takes the best row over whole chunks from
//   their summaries and over the edge chunks from their rows. A window that
//   wraps in rank order (past `num` back to row 0) is two row ranges; a
//   range that holds the rotation origin (only when start lies outside
//   [0, num)) is cut there. Lanes past L write out[] positions that the
//   next lap writes again, so they run only in the last lap. (3) The same
//   warp lands its pod: its lanes load the row into shared memory in one
//   round trip, and the warp re-evaluates it, its divisions spread over the
//   lanes. Windows are disjoint rows, so no two warps write one row; the
//   mask bits wait for the barrier, since the other warps' searches read
//   the masks. (4) After one barrier each landing's warp recomputes its
//   chunk's mask and summary from the lap's landings; two landings in one
//   chunk compute the same values, so the writes are idempotent. With
//   A1 > 0 the dense anti pass does this for every chunk instead.
// - Divisions by a row's values take a float64 quotient with one exact
//   correction (lap_floor_div): int64 division is a long instruction
//   sequence, and the prologue and the landings are made of it.
// - The lanes are template parameters: the nominated-pod lane, blocked,
//   aux_cnt and A1 > 0, so SchedulingBasic's plan compiles with none. The
//   nominated lane is constant within a batch and enters only the row
//   evaluations. So is the tier: on chip up to NP 16384 (220 KB), above it
//   the same arrays in a device-memory buffer that the wrapper passes
//   (`work`), read coalesced; a compile-time tier keeps the on-chip arrays
//   shared-memory accesses. 32 instantiations (ops/_build.py compiles
//   them in parallel threads).
// All arithmetic is the reference's: int64 scores, int32 counts, Python's
// floored // and % (floor_div / floor_mod, or lap_floor_div's equal).
#include "kernels.cuh"

#include <climits>

constexpr int LAP_THREADS = 1024;               // 32 warps: one a window lane
constexpr int LAP_SMEM_ROWS = 16384;            // the on-chip tier (ops/kernel.py mirrors it)
constexpr size_t LAP_SMEM_MAX = 220 * 1024;     // dynamic shared memory a launch may take
#define FULL 0xffffffffu

// The batch's row state: in dynamic shared memory, or in `work`.
struct LapMem {
  int64_t* total;   // [NP] each row's carried total
  int64_t* mx;      // [NC] a chunk's max total over its feasible rows (INT64_MIN: none)
  int64_t* stage;   // [warps][3R + 2] a landing's row: alloc_r, req_r, nom_req, nonzero
  int64_t* c64;     // request [R], nz_request [2], has_request, ba_skip, fit_weights [FR]
  int32_t* c32;     // enable [5], fit_slots [FR]
  uint32_t* mask;   // [NC] a chunk's feasible rows, one bit a row
  uint32_t* base;   // [NC] the same without the anti verdict (used with A1 > 0)
  int* cnt;         // [NC] popcount of mask
  int* pfx;         // [NC] feasible rows before the chunk
  int* arg;         // [NC] the chunk's first row at mx (-1: none)
  int* dirty;       // [NC] the chunk holds a landing of this lap (A1 > 0)
};

__host__ __device__ inline size_t lap_take(size_t& off, size_t bytes) {
  const size_t o = off;
  off = (off + bytes + 15) & ~(size_t)15;
  return o;
}

// The layout of LapMem in `buf` for NP rows and `warps` warps; returns its
// bytes (buf null: the size only). ops/kernel.py `_lap_layout_bytes`
// computes the same sum.
__host__ __device__ inline size_t lap_layout(int NP, int R, int FR, int warps,
                                             unsigned char* buf, LapMem* m) {
  const size_t NC = ((size_t)NP + 31) / 32;
  size_t off = 0;
  const size_t o_total = lap_take(off, 8 * (size_t)NP);
  const size_t o_mx = lap_take(off, 8 * NC);
  const size_t o_stage = lap_take(off, 8 * (size_t)warps * (3 * R + 2));
  const size_t o_c64 = lap_take(off, 8 * (size_t)(R + 4 + FR));
  const size_t o_c32 = lap_take(off, 4 * (size_t)(5 + FR));
  const size_t o_mask = lap_take(off, 4 * NC);
  const size_t o_base = lap_take(off, 4 * NC);
  const size_t o_cnt = lap_take(off, 4 * NC);
  const size_t o_pfx = lap_take(off, 4 * NC);
  const size_t o_arg = lap_take(off, 4 * NC);
  const size_t o_dirty = lap_take(off, 4 * NC);
  if (buf != nullptr) {
    m->total = (int64_t*)(buf + o_total);
    m->mx = (int64_t*)(buf + o_mx);
    m->stage = (int64_t*)(buf + o_stage);
    m->c64 = (int64_t*)(buf + o_c64);
    m->c32 = (int32_t*)(buf + o_c32);
    m->mask = (uint32_t*)(buf + o_mask);
    m->base = (uint32_t*)(buf + o_base);
    m->cnt = (int*)(buf + o_cnt);
    m->pfx = (int*)(buf + o_pfx);
    m->arg = (int*)(buf + o_arg);
    m->dirty = (int*)(buf + o_dirty);
  }
  return off;
}

struct LapArgs {
  const int64_t* alloc_r;
  const int64_t* alloc_pods;
  int64_t* req_r;
  int64_t* nonzero;
  int32_t* pod_count;
  const int64_t* nom_req;
  const int32_t* nom_pods;
  uint8_t* blocked;
  int32_t* aux_cnt;
  const int32_t* aux_room;
  const int32_t* aux_inc;
  const uint8_t* static_ok;
  const int64_t* il_score;
  const int64_t* weights;
  const int32_t* num_nodes;
  const int32_t* to_find;
  const int32_t* start;
  const int32_t* topo;
  const int32_t* anti_axis;
  const int32_t* anti_self;
  int32_t* anti_counts;
  int64_t* work;
  int32_t* out;
  uint8_t* fit_ok;
  int64_t* fit_sc;
  int64_t* ba;
  int32_t* start_out;
  int NP, B, n_act, A1, V;
};

// Max of an int64 over the warp: the high words' max (signed), then the
// low words' max (unsigned) among the lanes at it.
__device__ __forceinline__ int64_t warp_max_i64(int64_t v) {
  const int hi = __reduce_max_sync(FULL, (int)(v >> 32));
  const unsigned lo = __reduce_max_sync(FULL, (int)(v >> 32) == hi ? (unsigned)v : 0u);
  return (int64_t)(((uint64_t)(uint32_t)hi << 32) | lo);
}

// The warp's best (highest total, then lowest row) over the lanes with
// `has`; false when no lane has one.
__device__ __forceinline__ bool warp_best(bool has, int64_t t, int row, int64_t& bt, int& br) {
  if (__ballot_sync(FULL, has) == 0) return false;
  bt = warp_max_i64(has ? t : INT64_MIN);
  br = (int)__reduce_min_sync(FULL, (has && t == bt) ? (unsigned)row : 0xffffffffu);
  return true;
}

// A lane's running best (highest total, then lowest row).
__device__ __forceinline__ void lane_best(bool& has, int64_t& t, int& r, int64_t tt, int rr) {
  if (!has || tt > t || (tt == t && rr < r)) {
    has = true;
    t = tt;
    r = rr;
  }
}

// Chunk c's mask and summary from its rows' feasibility bits `m` and each
// lane's row total `t` (read where the lane's bit is set).
__device__ __forceinline__ void lap_summary(const LapMem& M, int c, uint32_t m, int64_t t,
                                            int lane) {
  int64_t bt = INT64_MIN;
  int br = -1;
  warp_best((m >> lane) & 1u, t, c * 32 + lane, bt, br);
  if (lane == 0) {
    M.mask[c] = m;
    M.cnt[c] = __popc(m);
    M.mx[c] = bt;
    M.arg[c] = br;
  }
}

// The rows of the g0-th and g1-th feasible rows in row order (0-based,
// below the feasible count), both searches in one instruction stream: the
// last chunk whose prefix is <= g, by 32-way search of the prefixes, then
// the (g - prefix)-th set bit of its mask. A range of at most 32 chunks
// narrows to one chunk in a round, so the two need the same rounds.
__device__ __forceinline__ void lap_find_rows(const LapMem& M, int NC, int g0, int g1, int lane,
                                              int& r0, int& r1) {
  int lo0 = 0, hi0 = NC, lo1 = 0, hi1 = NC;
  while (hi0 - lo0 > 32 || hi1 - lo1 > 32) {
    const int s0 = (hi0 - lo0 + 31) >> 5, s1 = (hi1 - lo1 + 31) >> 5;
    const int c0 = lo0 + lane * s0, c1 = lo1 + lane * s1;
    const uint32_t b0 = __ballot_sync(FULL, c0 < hi0 && M.pfx[c0] <= g0);
    const uint32_t b1 = __ballot_sync(FULL, c1 < hi1 && M.pfx[c1] <= g1);
    lo0 += (31 - __clz(b0)) * s0;
    lo1 += (31 - __clz(b1)) * s1;
    hi0 = min(lo0 + s0, hi0);
    hi1 = min(lo1 + s1, hi1);
  }
  const uint32_t b0 = __ballot_sync(FULL, lo0 + lane < hi0 && M.pfx[lo0 + lane] <= g0);
  const uint32_t b1 = __ballot_sync(FULL, lo1 + lane < hi1 && M.pfx[lo1 + lane] <= g1);
  const int c0 = lo0 + 31 - __clz(b0), c1 = lo1 + 31 - __clz(b1);
  const int k0 = g0 - M.pfx[c0], k1 = g1 - M.pfx[c1];
  const uint32_t m0 = M.mask[c0], m1 = M.mask[c1];
  const uint32_t below = (1u << lane) - 1u;
  const uint32_t h0 = __ballot_sync(FULL, ((m0 >> lane) & 1u) && __popc(m0 & below) == k0);
  const uint32_t h1 = __ballot_sync(FULL, ((m1 >> lane) & 1u) && __popc(m1 & below) == k1);
  r0 = c0 * 32 + __ffs(h0) - 1;
  r1 = c1 * 32 + __ffs(h1) - 1;
}

// The best feasible row of rows [a, b]: the edge chunks from their rows,
// the chunks between from their summaries.
__device__ __forceinline__ bool lap_range_best(const LapMem& M, int a, int b, int lane,
                                               int64_t& bt, int& br) {
  const int ca = a >> 5, cb = b >> 5;
  bool has = false;
  int64_t t = INT64_MIN;
  int r = INT_MAX;
  const int i = ca * 32 + lane;
  if (i >= a && i <= b && ((M.mask[ca] >> lane) & 1u)) lane_best(has, t, r, M.total[i], i);
  if (cb != ca) {
    const int j = cb * 32 + lane;
    if (j <= b && ((M.mask[cb] >> lane) & 1u)) lane_best(has, t, r, M.total[j], j);
    for (int c = ca + 1 + lane; c < cb; c += 32)
      if (M.cnt[c] > 0) lane_best(has, t, r, M.mx[c], M.arg[c]);
  }
  return warp_best(has, t, r, bt, br);
}

// Row i's anti verdict: no required anti-affinity term's count positive at
// the row's own value (counts read from L2: landings add to them).
__device__ __forceinline__ bool lap_anti_ok(const LapArgs& a, int i) {
  for (int c = 0; c < a.A1; ++c) {
    const int v = a.topo[(int64_t)a.anti_axis[c] * a.NP + i];
    if (v > 0 && __ldcg(&a.anti_counts[(int64_t)c * a.V + v]) > 0) return false;
  }
  return true;
}

// The bits this lap's landings set and clear in chunk c (lane j < L reads
// landing j).
__device__ __forceinline__ uint32_t lap_apply(uint32_t m, int c, const int* land,
                                              const int* land_ok, int L, int lane) {
  const int r = lane < L ? land[lane] : -1;
  const bool in = r >= 0 && (r >> 5) == c;
  const uint32_t bit = in ? 1u << (r & 31) : 0u;
  const uint32_t clr = __reduce_or_sync(FULL, bit);
  const uint32_t set = __reduce_or_sync(FULL, land_ok[lane] ? bit : 0u);
  return (m & ~clr) | set;
}

template <bool SMEM, bool NOM, bool BLK, bool AUX, bool ANTI>
__global__ void __launch_bounds__(LAP_THREADS) lap_schedule_kernel(ResFeat f, LapArgs a) {
  extern __shared__ __align__(16) unsigned char lap_smem[];
  __shared__ int s_land[LAP_MAX], s_land_ok[LAP_MAX];
  __shared__ int s_start, s_T, s_L;
  const int tid = threadIdx.x, nt = blockDim.x, nw = nt >> 5;
  const int warp = tid >> 5, lane = tid & 31;
  const int NP = a.NP, R = f.R, FR = f.FR;
  const int NC = (NP + 31) >> 5;
  LapMem M;
  // A compile-time choice, so that the on-chip arrays are shared-memory
  // accesses to the compiler (LDS/STS), not generic ones.
  lap_layout(NP, R, FR, nw, SMEM ? lap_smem : (unsigned char*)a.work, &M);
  const int num = max(*a.num_nodes, 1);
  const int tf = max(*a.to_find, 1);
  const int64_t w_tt = a.weights[0], w_fit = a.weights[1], w_ba = a.weights[4],
                w_il = a.weights[6];
  const int32_t aux_inc = AUX ? *a.aux_inc : 0;

  // The batch's constants on chip; the evaluations read them there.
  for (int j = tid; j < R; j += nt) M.c64[j] = f.request[j];
  if (tid < 2) M.c64[R + tid] = f.nz_request[tid];
  if (tid == 2) M.c64[R + 2] = *f.has_request;
  if (tid == 3) M.c64[R + 3] = *f.ba_skip;
  for (int j = tid; j < FR; j += nt) {
    M.c64[R + 4 + j] = f.fit_weights[j];
    M.c32[5 + j] = f.fit_slots[j];
  }
  if (tid < 5) M.c32[tid] = f.enable[tid];
  __syncthreads();
  const ResFeat fs{M.c64, M.c64 + R, M.c64 + R + 2, M.c64 + R + 3, M.c32, M.c32 + 5,
                   M.c64 + R + 4, R, FR, f.fit_strategy};

  // Prologue: every row once; a chunk's rows lie on one warp's lanes.
  for (int c = warp; c < NC; c += nw) {
    const int i = c * 32 + lane;
    bool okb = false, oka = true;
    int64_t tot = 0;
    if (i < NP) {
      bool ok;
      int64_t sc, bav;
      resource_eval_row(fs, a.alloc_r + (int64_t)i * R, a.alloc_pods[i], a.req_r + (int64_t)i * R,
                        a.nonzero + 2 * (int64_t)i, a.pod_count[i],
                        NOM ? a.nom_req + (int64_t)i * R : nullptr, NOM ? a.nom_pods[i] : 0, ok,
                        sc, bav, LapDiv());
      a.fit_ok[i] = ok;
      a.fit_sc[i] = sc;
      a.ba[i] = bav;
      tot = w_tt * MAX_NODE_SCORE + w_fit * sc + w_ba * bav + w_il * a.il_score[i];
      M.total[i] = tot;
      okb = a.static_ok[i] && ok && i < num && !(BLK && a.blocked[i]) &&
            !(AUX && a.aux_cnt[i] + aux_inc > a.aux_room[i]);
      if (ANTI) oka = lap_anti_ok(a, i);
    }
    const uint32_t b = __ballot_sync(FULL, okb);
    const uint32_t am = ANTI ? __ballot_sync(FULL, oka) : FULL;
    if (ANTI && lane == 0) {
      M.base[c] = b;
      M.dirty[c] = 0;
    }
    lap_summary(M, c, b & am, tot, lane);
  }
  if (tid == 0) s_start = *a.start;
  __syncthreads();

  int done = 0;
  while (done < a.n_act) {
    const int start = s_start;
    // 1. The chunk prefixes: one warp, a contiguous run of chunks a lane.
    if (warp == 0) {
      const int cpl = (NC + 31) >> 5;
      const int c0 = min(lane * cpl, NC), c1 = min(c0 + cpl, NC);
      int s = 0;
      for (int c = c0; c < c1; ++c) s += M.cnt[c];
      int incl = s;
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(FULL, incl, off);
        if (lane >= off) incl += y;
      }
      int run = incl - s;
      for (int c = c0; c < c1; ++c) {
        const int k = M.cnt[c];
        M.pfx[c] = run;
        run += k;
      }
      const int T = __shfl_sync(FULL, incl, 31);
      if (lane == 0) {
        s_T = T;
        s_L = max(1, min(min(T / tf, a.n_act - done), LAP_MAX));
      }
    }
    __syncthreads();
    const int T = s_T, L = s_L;
    // Ranks count from `ra` (start, or 0 when start is outside [0, num): the
    // reference's f_start is then 0 or every feasible row); rotation counts
    // from `so` = start mod num.
    const int ra = (start > 0 && start < num) ? start : 0;
    const int so = (int)floor_mod(start, num);
    // A row's rotation (row - start) mod num, for rows in [0, num).
    auto rot = [so, num](int r) { return r >= so ? r - so : r - so + num; };
    int f_start = 0;
    if (ra > 0) f_start = M.pfx[ra >> 5] + __popc(M.mask[ra >> 5] & ((1u << (ra & 31)) - 1u));

    // 2-3. Window lane w on warp w: its best row, its boundary, its landing.
    // Lanes past L write out[] positions that the next lap writes again, so
    // they run only in the last lap.
    const int lanes = done + L >= a.n_act ? LAP_MAX : L;
    for (int w = warp; w < lanes; w += nw) {
      bool any = false;
      int64_t key = -1;
      int row = -1, last = -1;
      if (w < L && T > 0) {
        const int64_t r0 = (int64_t)w * tf;
        const int64_t len = min((int64_t)tf, (int64_t)T - r0);
        const int g0 = (int)(f_start + r0 - (f_start + r0 >= T ? T : 0));  // both < T
        const int64_t end = g0 + len - 1;
        // One range of feasible-row indices, or two when the window wraps.
        const int ga[2] = {g0, 0};
        const int gb[2] = {end < T ? (int)end : T - 1, (int)(end - T)};
        for (int p = 0; p < (end < T ? 1 : 2); ++p) {
          int ra_row, rb_row;
          lap_find_rows(M, NC, ga[p], gb[p], lane, ra_row, rb_row);
          last = rb_row;
          const bool cut = ra_row < so && so <= rb_row;
          for (int q = 0; q < (cut ? 2 : 1); ++q) {
            const int lo = cut ? (q == 0 ? so : ra_row) : ra_row;
            const int hi = cut ? (q == 0 ? rb_row : so - 1) : rb_row;
            int64_t bt;
            int br;
            if (lap_range_best(M, lo, hi, lane, bt, br)) {
              const int64_t k = bt * NP + (NP - 1 - rot(br));
              if (!any || k > key) {
                key = k;
                row = br;
              }
              any = true;
            }
          }
        }
      }
      // The boundary: the row of rank (w+1)*tf, when there is one.
      const int64_t rb = (int64_t)(w + 1) * tf;
      int ev = num;
      if (rb <= T) {
        const int g = (int)(f_start + rb - 1 - (f_start + rb - 1 >= T ? T : 0));
        if (w >= L) lap_find_rows(M, NC, g, g, lane, last, last);
        ev = rot(last) + 1;
      }
      const int start_w = so + ev - (so + ev >= num ? num : 0);
      const bool has = w < L && any && key >= 0;
      if (lane == 0) {
        const int pos = done + w;
        if (pos < a.B) {
          a.out[pos] = has ? row : -1;
          a.out[a.B + pos] = start_w;
        }
        s_land[w] = has ? row : -1;
        s_land_ok[w] = 0;
        if (w == L - 1) s_start = start_w;
      }
      if (has) {
        // The landing: the row into this warp's stage in one round trip,
        // then the warp re-evaluates it.
        const int64_t rR = (int64_t)row * R;
        int64_t* sa = M.stage + (int64_t)warp * (3 * R + 2);
        int64_t* sq = sa + R;
        int64_t* sn = sq + R;
        int64_t* sz = sn + R;
        // Every load is issued before the first store, so that the row
        // takes one round trip.
        int64_t apods = 0, il = 0, nz0 = 0, nz1 = 0;
        int32_t pc = 0, npods = 0, ac = 0, room = 0;
        bool sok = false;
        if (lane == 0) {
          nz0 = a.nonzero[2 * (int64_t)row] + fs.nz_request[0];
          nz1 = a.nonzero[2 * (int64_t)row + 1] + fs.nz_request[1];
          pc = a.pod_count[row] + 1;
          apods = a.alloc_pods[row];
          if (NOM) npods = a.nom_pods[row];
          sok = a.static_ok[row];
          il = a.il_score[row];
          if (AUX) {
            ac = a.aux_cnt[row] + aux_inc;
            room = a.aux_room[row];
          }
        }
        for (int j = lane; j < R; j += 32) {
          const int64_t al = a.alloc_r[rR + j];
          const int64_t q = a.req_r[rR + j] + fs.request[j];
          const int64_t nm = NOM ? a.nom_req[rR + j] : 0;
          a.req_r[rR + j] = q;
          sa[j] = al;
          sq[j] = q;
          if (NOM) sn[j] = nm;
        }
        if (ANTI)
          for (int c = lane; c < a.A1; c += 32) {
            const int v = a.topo[(int64_t)a.anti_axis[c] * NP + row];
            if (v > 0) atomicAdd(&a.anti_counts[(int64_t)c * a.V + v], a.anti_self[c]);
          }
        if (lane == 0) {
          a.nonzero[2 * (int64_t)row] = nz0;
          a.nonzero[2 * (int64_t)row + 1] = nz1;
          a.pod_count[row] = pc;
          if (AUX) a.aux_cnt[row] = ac;
          if (BLK) a.blocked[row] = 1;
          sz[0] = nz0;
          sz[1] = nz1;
        }
        __syncwarp();
        bool ok = false;
        int64_t sc = 0, bav = 0;
        lap_eval_landed<NOM>(fs, sa, apods, sq, sz, pc, sn, npods, lane, ok, sc, bav);
        if (lane == 0) {
          a.fit_ok[row] = ok;
          a.fit_sc[row] = sc;
          a.ba[row] = bav;
          M.total[row] = w_tt * MAX_NODE_SCORE + w_fit * sc + w_ba * bav + w_il * il;
          s_land_ok[w] = sok && ok && row < num && !BLK && !(AUX && ac + aux_inc > room);
          if (ANTI) M.dirty[row >> 5] = 1;
        }
        __syncwarp();
      }
    }
    __syncthreads();

    // 4. The chunks that changed: their masks and summaries.
    if (ANTI) {
      for (int c = warp; c < NC; c += nw) {
        const int i = c * 32 + lane;
        const uint32_t am = __ballot_sync(FULL, i >= NP || lap_anti_ok(a, i));
        const bool d = M.dirty[c] != 0;
        uint32_t b = M.base[c];
        if (d) b = lap_apply(b, c, s_land, s_land_ok, L, lane);
        const uint32_t m = b & am;
        if (d || m != M.mask[c]) {
          lap_summary(M, c, m, ((m >> lane) & 1u) ? M.total[i] : 0, lane);
          if (lane == 0) {
            M.base[c] = b;
            M.dirty[c] = 0;
          }
        }
      }
    } else {
      for (int w = warp; w < L; w += nw) {
        const int r = s_land[w];
        if (r < 0) continue;
        const int c = r >> 5, i = c * 32 + lane;
        const uint32_t m = lap_apply(M.mask[c], c, s_land, s_land_ok, L, lane);
        lap_summary(M, c, m, ((m >> lane) & 1u) ? M.total[i] : 0, lane);
      }
    }
    __syncthreads();
    done += L;
  }
  if (tid == 0) *a.start_out = s_start;
}

typedef void (*LapKernel)(ResFeat, LapArgs);

// The 32 instantiations, indexed by the launch's bits: on chip, nominated,
// blocked, aux_cnt, A1 > 0.
#define LAP_K2(s, n, b, x) lap_schedule_kernel<s, n, b, x, false>, lap_schedule_kernel<s, n, b, x, true>
#define LAP_K4(s, n, b) LAP_K2(s, n, b, false), LAP_K2(s, n, b, true)
#define LAP_K8(s, n) LAP_K4(s, n, false), LAP_K4(s, n, true)
#define LAP_K16(s) LAP_K8(s, false), LAP_K8(s, true)
static const LapKernel LAP_KERNELS[32] = {LAP_K16(false), LAP_K16(true)};
#undef LAP_K16
#undef LAP_K8
#undef LAP_K4
#undef LAP_K2

extern "C" int launch_lap_schedule(
    int NP, int R, int FR, int fit_strategy, int B, int n_act, int A1, int V,
    const int64_t* request, const int64_t* nz_request, const int64_t* has_request,
    const int64_t* ba_skip, const int32_t* enable, const int32_t* fit_slots,
    const int64_t* fit_weights, const int64_t* alloc_r, const int64_t* alloc_pods,
    int64_t* req_r, int64_t* nonzero, int32_t* pod_count, OPTIONAL const int64_t* nom_req,
    OPTIONAL const int32_t* nom_pods, OPTIONAL bool* blocked, OPTIONAL int32_t* aux_cnt,
    const int32_t* aux_room, const int32_t* aux_inc, const bool* static_ok,
    const int64_t* il_score, const int64_t* weights, const int32_t* num_nodes,
    const int32_t* to_find, const int32_t* start, const int32_t* topo,
    const int32_t* anti_axis, const int32_t* anti_self, int32_t* anti_counts,
    OPTIONAL int64_t* work, int32_t* out, bool* fit_ok, int64_t* fit_sc, int64_t* ba,
    int32_t* start_out, cudaStream_t stream) {
  if (NP <= 0 || R < 2 || FR < 0 || A1 < 0) return (int)cudaErrorInvalidValue;
  // Without `work` the row state must fit the block's shared memory.
  const size_t bytes = lap_layout(NP, R, FR, LAP_THREADS / 32, nullptr, nullptr);
  if (work == nullptr && (NP > LAP_SMEM_ROWS || bytes > LAP_SMEM_MAX))
    return (int)cudaErrorInvalidValue;
  const size_t smem = work == nullptr ? bytes : 0;
  ResFeat f{request, nz_request, has_request, ba_skip, enable, fit_slots, fit_weights,
            R, FR, fit_strategy};
  LapArgs a{alloc_r, alloc_pods, req_r, nonzero, pod_count, nom_req, nom_pods,
            (uint8_t*)blocked, aux_cnt, aux_room, aux_inc, (const uint8_t*)static_ok,
            il_score, weights, num_nodes, to_find, start, topo, anti_axis, anti_self,
            anti_counts, work, out, (uint8_t*)fit_ok, fit_sc, ba, start_out,
            NP, B, n_act, A1, V};
  const LapKernel kern = LAP_KERNELS[(work == nullptr) * 16 + (nom_req != nullptr) * 8 +
                                     (blocked != nullptr) * 4 +
                                     (aux_cnt != nullptr) * 2 + (A1 > 0)];
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<1, LAP_THREADS, smem, stream>>>(f, a);
  return (int)cudaGetLastError();
}
