// scan_general: the JAX package's schedule_batch scan `step` and
// `feasibility_proj` (kubernetes_tpu/ops/kernel.py:314-523) with the
// prologue (:545-575) for every plan that the lap and scan_schedule do not
// cover: PodTopologySpread DoNotSchedule skew (count tables [C1, V] with the
// _BIG / dns_forced0 minimum), ScheduleAnyway scoring ([C2, V]),
// InterPodAffinity required anti-affinity ([A1, V]) and affinity with the
// bootstrap case ([A2, V]), landing score deltas ([KD, V]), and the kept-set
// normalized score lanes (PreferNoSchedule reverse-normalized, spread
// min/max, inter-pod min/max, preferred node affinity) beside the static
// ImageLocality term; the nominated-pod, blocked and aux_cnt lanes as in
// the other schedule kernels (:322-325, :448, :485-498).
//
// What bounds it. A batch is a dependent sequence of up to 1024 steps: each
// step's feasibility, rotation-order ranks and arg-max depend on the last
// landing. The bytes are few (a step touches each row's verdict and value
// ids and the landed row: general_cost in chip_smoke.py gives 0.035 ms for
// 1024 steps at NP 8192), so the bound is the step's serial floor: its
// barriers and the dependent loads of the landing. One block of 512 threads
// on one SM runs the whole batch (a grid-wide barrier a step would cost more
// than the rows it spreads). Each step is
//   pass 1  every row's feasibility from on-chip state, one ballot per
//           32 rows; barrier;
//   pass 2  each warp's chunk prefixes from the ballots, the ranks in
//           rotation order, the kept set (rank <= to_find), the window
//           boundary, and the arg-max key (or, for normalized scores, the
//           live normalization lanes, a barrier, then the key), over the
//           chunks that can hold kept rows only; barrier;
//   landing warp 0 takes the max, lands the pod and updates the state;
//           barrier.
// Three barriers a step (four with normalized scores). Each phase is a
// chain of dependent latencies that the block's 16 warps do not hide:
// shared-memory loads, the shuffle rounds of the chunk prefixes and the
// int64 max, two int64 divisions and one round trip to L2 for the landed
// row. Measured on an H100 (chip_smoke.py), a step takes ~6.5 us on
// TopologySpreading's next batch at NP 8192 and ~5.3 us on scan_schedule's
// row-local plan, which filters no table: that floor, not rows or bytes,
// bounds the batch.
//
// The design, point by point:
// - A batch's row state stays on chip. In the prologue each row's base
//   verdict (static, fit, blocked and aux as one flag; with incremental
//   feasibility the row's verdict itself), its ScheduleAnyway-ignored and
//   affinity-keys flags, its value id in each table, and its carried total
//   are loaded once into shared memory, with the count tables (and the
//   spread domains). Only the landing's row and table entries change
//   between steps. A launch plan (gen_layout) places these arrays in order
//   — chunk masks, flags, tables, value ids, totals — while they fit the
//   block's shared memory; what does not fit stays in device memory and is
//   read there, coalesced (NP above ~16384 with big tables, or many
//   tables). The tables placed on chip are written back at the end. A
//   kind's tables past GEN_MAXC (ScheduleAnyway, anti-affinity, affinity
//   and landing deltas take any count, as gen_scan does) stay in device
//   memory; only the spread constraints are capped at GEN_MAXC.
// - Rows are coalesced: rows come in 32-row chunks, lane l of a warp takes
//   row l of a chunk, and the chunks go round the warps (chunk c to warp
//   c mod 16), so a window of kept rows spreads over every warp. Each warp
//   stores its chunks' ballots; after the barrier it sums them (a warp scan
//   over chunk rows) into the feasible rows before each of its chunks, and
//   a row's rank is that plus the popcount below it in its ballot: the
//   inclusive prefix sum of the reference, exact, with no block scan.
// - The spread minimum is maintained across steps: each constraint keeps
//   its minimum over eligible domains (capped at _BIG) and the count of
//   eligible domains at it. A landing moves one domain by dns_self; V is
//   rescanned (by the landing warp) only when the last domain at the
//   minimum leaves it. A row is feasible for a constraint while its
//   domain's count <= min' + min(max_skew, _BIG) - self, with min' 0 under
//   dns_forced0: the reference's test, rearranged in int64.
// - The plan's modes are template parameters (carried score, incremental
//   feasibility: four instantiations, picked by the launcher), so a carried
//   plan reduces one key lane and writes the window boundary directly (its
//   rank is unique); only normalized plans reduce their live lanes. Lane
//   presence (tables, nominated, blocked, aux) stays a uniform branch
//   outside the row loops.
// - The landing runs on one warp that keeps the batch's constants in
//   registers and issues every load of the landed row at once: a lane per
//   resource for the fit filter, a lane per fit slot for the score (warp
//   sums of exact int64 terms) and two lanes for BalancedAllocation's
//   shares, their divisions one division across the lanes, a lane per
//   table for the count updates (tables k, k + 32, ... past 32). All arithmetic is the reference's: int32
//   counts, int64 scores, Python's floored // and % as floor_div /
//   floor_mod.
// The plan's value tier V may be up to 8192 (a hostname axis); a table of
// that width is 32 KB, so a few fit beside the rows at NP 8192. At NP
// 16384 (SchedulingDaemonset's 15000 nodes) a zone spread's whole state
// fits (~218 KB); with a hostname table the totals stay in device memory.
// A thread-block cluster is not needed for that.
//
// schedule_placements runs the first port of this step, gen_scan in
// scan_general.cuh (one candidate placement a block): each thread a
// contiguous run of rows, the verdicts and their prefix sum written to
// device memory and read back every step, the spread minimum recomputed
// over V every step, eight int64 lanes in every reduction and a landing on
// one thread — 28.5 us a step at NP 8192 as scan_general (PERF.md). This
// source uses the header only for GenPlan and its constants.
#include "scan_general.cuh"

constexpr int GEN2_THREADS = 512;
constexpr int GEN2_WARPS = GEN2_THREADS / 32;
constexpr int GEN2_TABLES = 5 * GEN_MAXC;        // a slot per table: the first GEN_MAXC a kind
constexpr size_t GEN2_SMEM_MAX = 220 * 1024;     // dynamic shared memory a launch may plan
#define FULL 0xffffffffu

// Table kinds: table t = kind * GEN_MAXC + c.
#define K_DNS 0
#define K_SA 1
#define K_ANTI 2
#define K_AFF 3
#define K_IPA 4

// A row's flags.
#define GF_OK 1        // full feasibility: the base verdict; incremental: the verdict
#define GF_SA_IGN 2    // ScheduleAnyway ignores the row (scoring.go initPreScoreState)
#define GF_AFF_KEYS 4  // the row has every active affinity term's key

// Where each array of a launch lives: a byte offset into the block's
// dynamic shared memory, or -1 for device memory. Planned by gen_layout.
struct GenLayout {
  int mask, flags, total;
  int cnt[GEN2_TABLES];
  int vid[GEN2_TABLES];
  int dom[GEN_MAXC];
  int bytes;
};

struct GenShared {
  const int32_t* vid[GEN2_TABLES];  // row -> value id, per table
  int32_t* cnt[4 * GEN_MAXC];       // the int32 count tables (dns, sa, anti, aff)
  int64_t* dlt[GEN_MAXC];           // the ipa_delta rows
  const uint8_t* dom[GEN_MAXC];     // the spread domains
  uint8_t* flags;
  uint32_t* mask;                   // [chunk rows][warps + 1] feasibility ballots
  int* pfx;                         // [chunk rows][warps + 1] feasible rows before a chunk
  int64_t* total;
  long long thr[GEN_MAXC];          // a spread row is feasible while count <= thr
  int mn[GEN_MAXC], at_min[GEN_MAXC];
  long long part[7][GEN2_WARPS];
  long long aff_total;
  int start, bound;
};

__device__ __forceinline__ long long lmax(long long a, long long b) { return a > b ? a : b; }

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

__device__ __forceinline__ int ifloor_mod(int a, int b) {
  int r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}

// Bits 0..b of a 32-bit word.
__device__ __forceinline__ uint32_t mask_le(int b) { return b >= 31 ? FULL : (2u << b) - 1u; }

__device__ __forceinline__ long long warp_max(long long x) {
  for (int off = 16; off > 0; off >>= 1) x = lmax(x, __shfl_xor_sync(FULL, x, off));
  return x;
}

__device__ __forceinline__ long long warp_sum(long long x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}

// The max over the block's warps of part[l] (every warp computes it).
__device__ __forceinline__ long long parts_max(const GenShared& S, int l, int nw, int lane) {
  return warp_max(lane < nw ? S.part[l][lane] : LLONG_MIN);
}

__device__ __forceinline__ long long gen_thr(const GenPlan& p, int c, int mn) {
  const long long cap = p.dns_max_skew[c] < GEN_BIG ? p.dns_max_skew[c] : GEN_BIG;
  return (long long)(p.dns_forced0[c] == 1 ? 0 : mn) + cap - p.dns_self[c];
}

// Constraint c's minimum over its eligible domains (_BIG when none) and the
// domains at it, by one warp; lane 0 stores them and the row threshold.
__device__ void gen_rescan(GenShared& S, const GenPlan& p, int c, int lane) {
  const int32_t* cnt = S.cnt[K_DNS * GEN_MAXC + c];
  const uint8_t* dom = S.dom[c];
  int m = (int)GEN_BIG, n = 0;
  for (int v = lane; v < p.V; v += 32) {
    if (!dom[v]) continue;
    const int x = cnt[v];
    if (x < m) {
      m = x;
      n = 1;
    } else if (x == m) {
      ++n;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const int m2 = __shfl_xor_sync(FULL, m, off), n2 = __shfl_xor_sync(FULL, n, off);
    if (m2 < m) {
      m = m2;
      n = n2;
    } else if (m2 == m) {
      n += n2;
    }
  }
  if (lane == 0) {
    S.mn[c] = m;
    S.at_min[c] = n;
    S.thr[c] = gen_thr(p, c, m);
  }
}

__device__ __forceinline__ const int32_t* gen_axis(const GenPlan& p, int kind) {
  return kind == K_DNS ? p.dns_axis : kind == K_SA ? p.sa_axis : kind == K_ANTI ? p.anti_axis
       : kind == K_AFF ? p.aff_axis : p.ipa_axis;
}

__device__ __forceinline__ int32_t* gen_counts(const GenPlan& p, int kind) {
  return kind == K_DNS ? p.dns_counts : kind == K_SA ? p.sa_counts : kind == K_ANTI
       ? p.anti_counts : p.aff_counts;
}

__device__ __forceinline__ int gen_tables(const GenPlan& p, int kind) {
  return kind == K_DNS ? p.C1 : kind == K_SA ? p.C2 : kind == K_ANTI ? p.A1
       : kind == K_AFF ? p.A2 : p.KD;
}

// Table c of a kind: its value id by row and its counts (ipa_delta rows for
// K_IPA). A kind's first GEN_MAXC tables have a slot, on chip or in device
// memory as the launch plan says; the tables past them (C2, A1, A2 and KD
// take any count) are read in device memory.
__device__ __forceinline__ const int32_t* vid_of(const GenShared& S, const GenPlan& p, int kind,
                                                 int c) {
  return c < GEN_MAXC ? S.vid[kind * GEN_MAXC + c]
                      : p.topo + (int64_t)gen_axis(p, kind)[c] * p.NP;
}

__device__ __forceinline__ int32_t* cnt_of(const GenShared& S, const GenPlan& p, int kind, int c) {
  return c < GEN_MAXC ? S.cnt[kind * GEN_MAXC + c] : gen_counts(p, kind) + (int64_t)c * p.V;
}

__device__ __forceinline__ int64_t* dlt_of(const GenShared& S, const GenPlan& p, int c) {
  return c < GEN_MAXC ? S.dlt[c] : p.ipa_delta + (int64_t)c * p.V;
}

// ScheduleAnyway's raw score of a row and the inter-pod raw score
// (the reference's gen_raw_sa / gen_raw_ipa on the on-chip tables). They
// run for every kept row twice a step, so the slotted tables are read
// without vid_of's test; the tables past GEN_MAXC follow.
__device__ __forceinline__ long long raw_sa(const GenShared& S, const GenPlan& p, int i) {
  long long raw = 0;
  const int n = imin(p.C2, GEN_MAXC);
  for (int c = 0; c < n; ++c) {
    const int v = S.vid[K_SA * GEN_MAXC + c][i];
    raw += (long long)S.cnt[K_SA * GEN_MAXC + c][v] * p.sa_wq[c] + (p.sa_skew[c] - 1) * 1024;
  }
  for (int c = GEN_MAXC; c < p.C2; ++c) {
    const int v = vid_of(S, p, K_SA, c)[i];
    raw += (long long)cnt_of(S, p, K_SA, c)[v] * p.sa_wq[c] + (p.sa_skew[c] - 1) * 1024;
  }
  return raw;
}

__device__ __forceinline__ long long raw_ipa(const GenShared& S, const GenPlan& p, int i) {
  long long raw = p.ipa_base[i];
  const int n = imin(p.KD, GEN_MAXC);
  for (int k = 0; k < n; ++k) {
    const int v = S.vid[K_IPA * GEN_MAXC + k][i];
    if (v > 0) raw += S.dlt[k][v];
  }
  for (int k = GEN_MAXC; k < p.KD; ++k) {
    const int v = vid_of(S, p, K_IPA, k)[i];
    if (v > 0) raw += dlt_of(S, p, k)[v];
  }
  return raw;
}

// Clear the bits of okm (bit j: row rb + 32 * GEN2_WARPS * j) whose row fails a
// count-table test (feasibility_proj, :314-341). Per lane, no collective;
// every row of the group is read (rows past nrows as row 0, their bits are
// clear already), so the loads carry no branch.
__device__ __forceinline__ uint32_t table_filter(const GenShared& S, const GenPlan& p,
                                                 uint32_t okm, int kn, int rb, int nrows,
                                                 int aff_own_all) {
  constexpr int rs = 32 * GEN2_WARPS;  // rows between a lane's chunks
  for (int c = 0; c < p.C1; ++c) {
    if (p.dns_active[c] != 1) continue;
    const int32_t* vid = S.vid[K_DNS * GEN_MAXC + c];
    const int32_t* cnt = S.cnt[K_DNS * GEN_MAXC + c];
    const long long thr = S.thr[c];
    uint32_t bad = 0;
#pragma unroll 8
    for (int j = 0; j < kn; ++j) {
      const int r = rb + rs * j;
      const int v = vid[r < nrows ? r : 0];
      const int x = cnt[v > 0 ? v : 0];
      bad |= (uint32_t)((v <= 0) | ((long long)x > thr)) << j;
    }
    okm &= ~bad;
  }
  for (int c = 0; c < p.A1; ++c) {
    const int32_t* vid = vid_of(S, p, K_ANTI, c);
    const int32_t* cnt = cnt_of(S, p, K_ANTI, c);
    uint32_t bad = 0;
#pragma unroll 8
    for (int j = 0; j < kn; ++j) {
      const int r = rb + rs * j;
      const int v = vid[r < nrows ? r : 0];
      const int x = cnt[v > 0 ? v : 0];
      bad |= (uint32_t)((v > 0) & (x > 0)) << j;
    }
    okm &= ~bad;
  }
  if (p.A2) {
    uint32_t all = okm;  // every active term has a pod in the row's domain
    for (int c = 0; c < p.A2; ++c) {
      if (p.aff_active[c] == 0) continue;
      const int32_t* vid = vid_of(S, p, K_AFF, c);
      const int32_t* cnt = cnt_of(S, p, K_AFF, c);
      uint32_t bad = 0;
#pragma unroll 8
      for (int j = 0; j < kn; ++j) {
        const int r = rb + rs * j;
        const int v = vid[r < nrows ? r : 0];
        const int x = cnt[v > 0 ? v : 0];
        bad |= (uint32_t)((v <= 0) | (x <= 0)) << j;
      }
      all &= ~bad;
    }
    if (!(S.aff_total == 0 && aff_own_all == 1)) {
      okm = all;
    } else {
      uint32_t keys = 0;  // bootstrap: rows with every active term's key
      for (int j = 0; j < kn; ++j) {
        const int r = rb + rs * j;
        keys |= (uint32_t)((S.flags[r < nrows ? r : 0] & GF_AFF_KEYS) != 0) << j;
      }
      okm &= all | keys;
    }
  }
  return okm;
}

// Visit the warp's kept rows (feasible, rank <= to_find), calling
// fn(row, rot) on the row's lane; the row of rank to_find stores the window
// boundary when `bound` is set. The warp's chunk k is chunk k * GEN2_WARPS
// + w, its ballot and the feasible rows before it at [k][w] of mask and
// pfx. Chunks that can hold no kept row are skipped whole. Per lane, no
// collective.
template <class Fn>
__device__ __forceinline__ void visit_kept(const uint32_t* mask, const int* pfx, int* bound,
                                           int kw, int w, int lane, int start, int s_mod,
                                           int num, int to_find, int total, int f_start, Fn fn) {
  const uint32_t le = mask_le(lane);
  for (int k = 0; k < kw; ++k) {
    const uint32_t m = mask[k * (GEN2_WARPS + 1) + w];
    if (m == 0) continue;
    const int c0 = pfx[k * (GEN2_WARPS + 1) + w];
    const int cb = 32 * (k * GEN2_WARPS + w);
    if (cb >= start ? c0 + 1 - f_start > to_find
                    : (cb + 31 < start && c0 + 1 + total - f_start > to_find))
      continue;
    if (!((m >> lane) & 1u)) continue;
    const int r = cb + lane;
    const int Fi = c0 + __popc(m & le);
    const int rank = r >= start ? Fi - f_start : Fi + total - f_start;
    if (rank > to_find) continue;
    int rot = r - s_mod;
    if (rot < 0) rot += num;
    if (bound != nullptr && rank == to_find) *bound = num - 1 - rot;
    fn(r, rot);
  }
}

// x mod n, floored, for the small ints of rotation arithmetic.
__device__ __forceinline__ int small_mod(int x, int n) {
  if (x >= 0 && x < n) return x;
  if (x >= n && x - n < n) return x - n;
  return ifloor_mod(x, n);
}

// What a lane of the landing warp keeps in registers for the whole batch:
// its fit slot (lanes below min(FR, 30)), its resource's request (lanes
// below R), its spread constraint's parameters and, for each other kind,
// the increment of the kind's table `lane` (tables past 32 read theirs).
struct LandLane {
  int fit_s;
  long long fit_w, fit_q, q, nzq, nzq0, nzq1;
  long long has_request, ba_skip;
  int enable4;
  long long w0, w1, w4, w6;
  int d_aff, d_taint, d_self, d_forced0, sa_self, anti_self, aff_self;
  long long d_cap, ipa_w;
};

__device__ __forceinline__ LandLane land_lane(const ResFeat& f, const GenPlan& p, int lane) {
  LandLane c;
  const bool slot = lane < f.FR && lane < 30;
  c.fit_s = slot ? f.fit_slots[lane] : 0;
  c.fit_w = slot ? f.fit_weights[lane] : 0;
  c.fit_q = slot ? f.request[c.fit_s] : 0;
  c.q = lane < f.R ? f.request[lane] : 0;
  c.nzq = lane < 2 ? f.nz_request[lane] : 0;
  c.nzq0 = f.nz_request[0];
  c.nzq1 = f.nz_request[1];
  c.has_request = *f.has_request;
  c.ba_skip = *f.ba_skip;
  c.enable4 = f.enable[4];
  c.w0 = p.weights[0];
  c.w1 = p.weights[1];
  c.w4 = p.weights[4];
  c.w6 = p.weights[6];
  c.d_aff = lane < p.C1 ? p.dns_honor_aff[lane] : 0;
  c.d_taint = lane < p.C1 ? p.dns_honor_taints[lane] : 0;
  c.d_self = lane < p.C1 ? p.dns_self[lane] : 0;
  c.d_forced0 = lane < p.C1 ? p.dns_forced0[lane] : 0;
  c.d_cap = lane < p.C1 ? (p.dns_max_skew[lane] < GEN_BIG ? p.dns_max_skew[lane] : GEN_BIG) : 0;
  c.sa_self = lane < p.C2 ? p.sa_self[lane] : 0;
  c.anti_self = lane < p.A1 ? p.anti_self[lane] : 0;
  c.aff_self = lane < p.A2 ? p.aff_self[lane] : 0;
  c.ipa_w = lane < p.KD ? p.ipa_wland[lane] : 0;
  return c;
}

// The fit score's terms of fit slot j for `used` on a row allocating `a`
// (resource_eval_row's LeastAllocated / MostAllocated), as numerator and
// denominator of one floored division (0 / 1 where the term is 0).
__device__ __forceinline__ void fit_term(int strategy, long long a, long long used,
                                         long long& dn, long long& dd) {
  dn = 0;
  dd = 1;
  if (strategy == 0) {
    if (a > 0 && used <= a) {
      dn = (a - used) * MAX_NODE_SCORE;
      dd = a > 1 ? a : 1;
    }
  } else if (a > 0) {
    dn = (used < a ? used : a) * MAX_NODE_SCORE;
    dd = a > 1 ? a : 1;
  }
}

// Land the pod on `row` (every lane of one warp): the row's aggregates and
// fit/score lanes (resource_eval_row after the +1 pod), the +self (+weight)
// at the row's value of every table with the maintained spread minimum,
// the blocked and aux lanes, the row's new flag and carried total. Every
// load of the row is issued first (one round trip to device memory); the
// fit slots' divisions and BalancedAllocation's two shares are one
// division across the lanes.
template <bool CARRIED, bool INCR>
__device__ __forceinline__ void gen_land(const ResFeat& f, const GenPlan& p, GenShared& S,
                                         const LandLane& c, int row, int num, int lane,
                                         int aux_inc) {
  const int R = f.R;
  const int64_t* al = p.alloc_r + (int64_t)row * R;
  int64_t* rq = p.req_r + (int64_t)row * R;
  const int64_t* nom = p.nom_req ? p.nom_req + (int64_t)row * R : nullptr;
  const bool slot = lane < f.FR && lane < 30;
  // -- loads (nothing is written before the __syncwarp below) -------------------
  const long long a_r = lane < R ? al[lane] : 0;
  const long long q_r = lane < R ? rq[lane] : 0;
  const long long n_r = nom != nullptr && lane < R ? nom[lane] : 0;
  const long long a_s = slot ? al[c.fit_s] : 0;
  const long long q_s = slot ? rq[c.fit_s] : 0;
  const long long a_ba = lane >= 30 ? al[lane - 30] : 0;
  const long long nz = lane < 2 ? p.nonzero[2 * (int64_t)row + lane] : 0;
  const int pods = p.pod_count[row] + 1;
  const long long alloc_pods = p.alloc_pods[row];
  const int nom_pods = p.nom_req ? p.nom_pods[row] : 0;
  const bool static_ok = p.static_ok[row], sel = p.sel_ok[row], taint = p.taint_ok[row];
  const long long il = CARRIED ? p.il_score[row] : 0;
  const int aux = p.aux_cnt ? p.aux_cnt[row] + aux_inc : 0;
  const int room = p.aux_cnt ? p.aux_room[row] : 0;
  const uint8_t flags = S.flags[row];
  const int v_d = lane < p.C1 ? S.vid[K_DNS * GEN_MAXC + lane][row] : 0;
  const int v_s = lane < p.C2 ? vid_of(S, p, K_SA, lane)[row] : 0;  // table k = lane
  const int v_a = lane < p.A1 ? vid_of(S, p, K_ANTI, lane)[row] : 0;
  const int v_f = lane < p.A2 ? vid_of(S, p, K_AFF, lane)[row] : 0;
  const int v_i = lane < p.KD ? vid_of(S, p, K_IPA, lane)[row] : 0;
  // -- the fit filter (:175-179) and the score (:180-208) ----------------------
  bool viol = lane < R && c.q > 0 && c.q > a_r - (q_r + c.q) - n_r;
  for (int r = lane + 32; r < R; r += 32) {
    const long long q = f.request[r];
    viol |= q > 0 && q > al[r] - (rq[r] + q) - (nom != nullptr ? nom[r] : 0);
  }
  viol = __any_sync(FULL, viol);
  const long long used0 = __shfl_sync(FULL, nz, 0) + 2 * c.nzq0;
  const long long used1 = __shfl_sync(FULL, nz, 1) + 2 * c.nzq1;
  const bool pods_ok = (int64_t)(pods + nom_pods + 1) <= alloc_pods;
  const bool ok = (pods_ok && (!viol || c.has_request == 0)) || c.enable4 == 0;
  long long dn = 0, dd = 1;
  if (slot) {
    const int s = c.fit_s;
    fit_term(f.fit_strategy, a_s, s == 0 ? used0 : (s == 1 ? used1 : q_s + 2 * c.fit_q), dn, dd);
  } else if (lane >= 30) {
    dn = (lane == 30 ? used0 : used1) * BA_SCALE;
    dd = a_ba > 1 ? a_ba : 1;
  }
  const long long qd = floor_div(dn, dd);
  long long num_s = slot && a_s > 0 ? qd * c.fit_w : 0;
  long long den_s = slot && a_s > 0 ? c.fit_w : 0;
  for (int j = 30 + lane; j < f.FR; j += 32) {  // fit slots past the 30 lanes
    const int s = f.fit_slots[j];
    const long long a = al[s];
    if (a <= 0) continue;
    long long tn, td;
    fit_term(f.fit_strategy, a, s == 0 ? used0 : (s == 1 ? used1 : rq[s] + 2 * f.request[s]),
             tn, td);
    num_s += floor_div(tn, td) * f.fit_weights[j];
    den_s += f.fit_weights[j];
  }
  num_s = warp_sum(num_s);
  den_s = warp_sum(den_s);
  const long long share = qd < BA_SCALE ? qd : BA_SCALE;
  const long long q_cpu = __shfl_sync(FULL, share, 30), q_mem = __shfl_sync(FULL, share, 31);
  const long long a_cpu = __shfl_sync(FULL, a_ba, 30), a_mem = __shfl_sync(FULL, a_ba, 31);
  // The weights' sum is mostly a power of two (1 + 1): a shift is the floored
  // division then.
  const long long d1 = den_s > 1 ? den_s : 1;
  const long long sc = den_s <= 0 ? 0
      : (d1 & (d1 - 1)) == 0 ? num_s >> (63 - __clzll(d1)) : floor_div(num_s, d1);
  const long long diff = q_cpu > q_mem ? q_cpu - q_mem : q_mem - q_cpu;
  const long long b = c.ba_skip == 1 ? 0
      : (a_cpu > 0 && a_mem > 0) ? floor_div(MAX_NODE_SCORE * BA_SCALE - 50 * diff, BA_SCALE)
                                 : (long long)MAX_NODE_SCORE;
  __syncwarp();
  // -- writes ----------------------------------------------------------------------
  if (lane < R) rq[lane] = q_r + c.q;
  for (int r = lane + 32; r < R; r += 32) rq[r] += f.request[r];
  if (lane < 2) p.nonzero[2 * (int64_t)row + lane] = nz + c.nzq;
  if (lane == 0) {
    p.pod_count[row] = pods;
    p.fit_ok[row] = ok;
    p.fit_sc[row] = sc;
    p.ba[row] = b;
  }
  // Spread DoNotSchedule: a lane a constraint; the minimum follows.
  bool rescan = false;
  if (lane < p.C1 && v_d > 0 && (c.d_aff != 1 || sel) && (c.d_taint != 1 || taint)) {
    int32_t* cnt = S.cnt[K_DNS * GEN_MAXC + lane];
    const int o = cnt[v_d], n = o + c.d_self;
    cnt[v_d] = n;
    if (n != o && S.dom[lane][v_d]) {
      const int mn = S.mn[lane];
      int am = S.at_min[lane];
      if (n < mn) {
        S.mn[lane] = n;
        S.thr[lane] = (long long)(c.d_forced0 == 1 ? 0 : n) + c.d_cap - c.d_self;
        am = 1;
      } else if (o == mn) {
        rescan = --am == 0;
      } else if (n == mn) {
        ++am;
      }
      S.at_min[lane] = am;
    }
  }
  uint32_t todo = __ballot_sync(FULL, rescan);
  if (todo) __syncwarp();
  while (todo) {
    const int t = __ffs(todo) - 1;
    todo &= todo - 1;
    gen_rescan(S, p, t, lane);
  }
  // The other tables: a lane a table (k, k + 32, ...).
  if (!(flags & GF_SA_IGN))
    for (int k = lane; k < p.C2; k += 32)
      cnt_of(S, p, K_SA, k)[k < 32 ? v_s : vid_of(S, p, K_SA, k)[row]] +=
          k < 32 ? c.sa_self : p.sa_self[k];
  bool anti_hit = false;
  for (int k = lane; k < p.A1; k += 32) {
    const int v = k < 32 ? v_a : vid_of(S, p, K_ANTI, k)[row];
    if (v <= 0) continue;
    int32_t* cnt = cnt_of(S, p, K_ANTI, k);
    const int n = cnt[v] + (k < 32 ? c.anti_self : p.anti_self[k]);
    cnt[v] = n;
    anti_hit |= n > 0;
  }
  const bool anti_any = INCR && __any_sync(FULL, anti_hit);
  if (p.A2) {
    long long add = 0;
    for (int k = lane; k < p.A2; k += 32) {
      const int v = k < 32 ? v_f : vid_of(S, p, K_AFF, k)[row];
      if (v <= 0) continue;
      const int self = k < 32 ? c.aff_self : p.aff_self[k];
      cnt_of(S, p, K_AFF, k)[v] += self;
      add += self;
    }
    add = warp_sum(add);
    if (lane == 0) S.aff_total += add;
  }
  for (int k = lane; k < p.KD; k += 32) {
    const int v = k < 32 ? v_i : vid_of(S, p, K_IPA, k)[row];
    if (v > 0) dlt_of(S, p, k)[v] += k < 32 ? c.ipa_w : p.ipa_wland[k];
  }
  if (lane == 0) {
    if (p.blocked) p.blocked[row] = 1;
    if (p.aux_cnt) p.aux_cnt[row] = aux;
    bool now_ok = static_ok && ok && row < num && !p.blocked &&
                  !(p.aux_cnt && aux + aux_inc > room);
    if (INCR) now_ok = now_ok && !anti_any;
    S.flags[row] = (uint8_t)((flags & ~GF_OK) | (now_ok ? GF_OK : 0));
    if (CARRIED) S.total[row] = c.w0 * MAX_NODE_SCORE + c.w1 * sc + c.w4 * b + c.w6 * il;
  }
}

template <bool CARRIED, bool INCR>
__global__ void __launch_bounds__(GEN2_THREADS, 1) scan_general_kernel(
    ResFeat f, GenPlan p, GenLayout L, const int32_t* __restrict__ num_nodes_p,
    const int32_t* __restrict__ to_find_p, const int32_t* __restrict__ start_p,
    int32_t* start_out) {
  extern __shared__ __align__(16) unsigned char gen_smem[];
  __shared__ GenShared S;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, w = tid >> 5;
  constexpr int nw = GEN2_WARPS, ms = GEN2_WARPS + 1;  // the launch's warps; mask row stride
  const int NP = p.NP, V = p.V;
  const int num = max(*num_nodes_p, 1);
  const int to_find = *to_find_p;
  const int nrows = imin(NP, num);  // rows at or past num are never feasible
  // Warp w owns the 32-row chunks w, w + nw, w + 2 nw, ...: kw of them.
  const int kw = ((nrows + 31) / 32 + nw - 1) / nw;
  const int aux_inc = p.aux_cnt ? *p.aux_inc : 0;
  const int aff_own_all = p.A2 ? *p.aff_own_all : 0;

  // -- prologue: where each array lives ----------------------------------------
  for (int t = tid; t < GEN2_TABLES; t += nt) {
    const int kind = t / GEN_MAXC, c = t % GEN_MAXC;
    if (c < gen_tables(p, kind)) {
      S.vid[t] = L.vid[t] >= 0 ? (const int32_t*)(gen_smem + L.vid[t])
                               : p.topo + (int64_t)gen_axis(p, kind)[c] * NP;
      if (kind == K_IPA) {
        S.dlt[c] = L.cnt[t] >= 0 ? (int64_t*)(gen_smem + L.cnt[t])
                                 : p.ipa_delta + (int64_t)c * V;
      } else {
        S.cnt[t] = L.cnt[t] >= 0 ? (int32_t*)(gen_smem + L.cnt[t])
                                 : gen_counts(p, kind) + (int64_t)c * V;
      }
      if (kind == K_DNS)
        S.dom[c] = L.dom[c] >= 0 ? gen_smem + L.dom[c] : p.dns_dom + (int64_t)c * V;
    }
  }
  if (tid == 0) {
    S.flags = L.flags >= 0 ? gen_smem + L.flags : p.okd;
    S.mask = L.mask >= 0 ? (uint32_t*)(gen_smem + L.mask) : (uint32_t*)p.F;
    S.pfx = (int*)(S.mask + kw * ms);
    S.total = L.total >= 0 ? (int64_t*)(gen_smem + L.total) : p.total;
    S.start = *start_p;
    S.bound = 0;
    S.aff_total = 0;
  }
  __syncthreads();
  // -- prologue: the tables and value ids placed on chip -----------------------
  for (int t = 0; t < GEN2_TABLES; ++t) {
    const int kind = t / GEN_MAXC, c = t % GEN_MAXC;
    if (L.cnt[t] >= 0) {
      if (kind == K_IPA) {
        const int64_t* g = p.ipa_delta + (int64_t)c * V;
        for (int v = tid; v < V; v += nt) S.dlt[c][v] = g[v];
      } else {
        const int32_t* g = gen_counts(p, kind) + (int64_t)c * V;
        for (int v = tid; v < V; v += nt) S.cnt[t][v] = g[v];
      }
    }
    if (kind == K_DNS && c < p.C1 && L.dom[c] >= 0) {
      const uint8_t* g = p.dns_dom + (int64_t)c * V;
      uint8_t* s = gen_smem + L.dom[c];
      for (int v = tid; v < V; v += nt) s[v] = g[v];
    }
    if (L.vid[t] >= 0) {
      const int32_t* g = p.topo + (int64_t)gen_axis(p, kind)[c] * NP;
      int32_t* s = (int32_t*)(gen_smem + L.vid[t]);
      for (int i = tid; i < nrows; i += nt) s[i] = g[i];
    }
  }
  __syncthreads();
  // -- prologue: each row's flags and carried total; the spread minima ----------
  for (int i = tid; i < nrows; i += nt) {
    bool ok = p.static_ok[i] && p.fit_ok[i];
    if (p.blocked && p.blocked[i]) ok = false;
    if (p.aux_cnt && p.aux_cnt[i] + aux_inc > p.aux_room[i]) ok = false;
    if (INCR) {  // the first step's verdict in full: C1 and A2 are 0 here
      for (int c = 0; c < p.A1; ++c) {
        const int v = vid_of(S, p, K_ANTI, c)[i];
        if (v > 0 && cnt_of(S, p, K_ANTI, c)[v] > 0) ok = false;
      }
    }
    uint8_t fl = ok ? GF_OK : 0;
    if (p.C2) {
      bool ign = !p.sel_ok[i];
      for (int c = 0; c < p.C2; ++c) ign = ign || vid_of(S, p, K_SA, c)[i] <= 0;
      if (ign) fl |= GF_SA_IGN;
    }
    if (p.A2) {
      bool keys = true;
      for (int c = 0; c < p.A2; ++c)
        if (p.aff_active[c] != 0 && vid_of(S, p, K_AFF, c)[i] <= 0) keys = false;
      if (keys) fl |= GF_AFF_KEYS;
    }
    S.flags[i] = fl;
    if (CARRIED) {
      const int64_t* wt = p.weights;
      S.total[i] = wt[0] * MAX_NODE_SCORE + wt[1] * p.fit_sc[i] + wt[4] * p.ba[i] +
                   wt[6] * p.il_score[i];
    }
  }
  for (int c = w; c < p.C1; c += nw) gen_rescan(S, p, c, lane);
  if (w == nw - 1 && p.A2) {  // aff_total0 (:561)
    long long s = 0;
    for (int c = 0; c < p.A2; ++c) {
      if (p.aff_active[c] != 1) continue;
      const int32_t* cnt = cnt_of(S, p, K_AFF, c);
      for (int v = lane; v < V; v += 32) s += cnt[v];
    }
    s = warp_sum(s);
    if (lane == 0) S.aff_total = s;
  }
  __syncthreads();

  const LandLane lc = land_lane(f, p, lane);
  const bool np_pow2 = (NP & (NP - 1)) == 0;
  uint32_t* const mask = S.mask;
  int* const pfx = S.pfx;
  for (int t = 0; t < p.n_act; ++t) {
    const int start = S.start;
    // -- pass 1: feasibility, a ballot per chunk ------------------------------
    for (int g = 0; g < kw; g += 32) {
      const int kn = imin(32, kw - g);
      const int rb = 32 * (g * nw + w) + lane;  // bit j: row rb + 32 * nw * j
      uint32_t okm = 0;
#pragma unroll 8
      for (int j = 0; j < kn; ++j) {
        const int r = rb + 32 * nw * j;
        okm |= (uint32_t)((r < nrows) & S.flags[r < nrows ? r : 0] & GF_OK) << j;
      }
      if (!INCR) okm = table_filter(S, p, okm, kn, rb, nrows, aff_own_all);
      uint32_t mine = 0;
      for (int j = 0; j < kn; ++j) {
        const uint32_t m = __ballot_sync(FULL, (okm >> j) & 1u);
        mine = lane == j ? m : mine;
      }
      if (lane < kn) mask[(g + lane) * ms + w] = mine;
    }
    __syncthreads();
    // -- ranks: each warp sums the ballots into its chunks' prefixes ---------
    const int cs = start > 0 && start - 1 < nrows ? (start - 1) >> 5 : -1;  // row start-1's
    const int ks = cs >= 0 ? cs / nw : -1, wsx = cs >= 0 ? cs % nw : 0;
    int total = 0, fbase = 0;
    for (int g = 0; g < kw; g += 32) {
      const int k = g + lane;
      int T = 0, cp = 0, cps = 0;  // chunk row k: all, before w, before wsx
      if (k < kw) {
#pragma unroll
        for (int w2 = 0; w2 < nw; ++w2) {
          const int x = __popc(mask[k * ms + w2]);
          T += x;
          cp += w2 < w ? x : 0;
          cps += w2 < wsx ? x : 0;
        }
      }
      int incl = T;
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(FULL, incl, off);
        if (lane >= off) incl += y;
      }
      const int excl = total + incl - T;
      if (k < kw) pfx[k * ms + w] = excl + cp;
      if (ks >= g && ks < g + 32) fbase = __shfl_sync(FULL, excl + cps, ks - g);
      total += __shfl_sync(FULL, incl, 31);
    }
    __syncwarp();
    const int f_start = start == 0 ? 0 : cs < 0 ? total
        : fbase + __popc(mask[ks * ms + wsx] & mask_le((start - 1) & 31));
    const int s_mod = small_mod(start, num);
    // -- pass 2: the kept set, the boundary and the arg-max key --------------
    long long best = -1;
    if (CARRIED) {
      const int64_t* tot = S.total;
      visit_kept(mask, pfx, &S.bound, kw, w, lane, start, s_mod, num, to_find, total,
                 f_start, [&](int r, int rot) { best = lmax(best, tot[r] * NP + (NP - 1 - rot)); });
    } else {
      // normalization lanes over the kept set, then the scores
      long long l1 = 0, l2 = 0, l3 = -GEN_INF64, l4 = -GEN_INF64, l5 = -GEN_INF64, l6 = 0;
      const bool ipa_on = p.KD || p.has_ipa_base;
      visit_kept(mask, pfx, &S.bound, kw, w, lane, start, s_mod, num, to_find, total,
                 f_start, [&](int r, int) {
                   if (p.has_pns) l1 = lmax(l1, p.pns_cnt[r]);
                   if (p.C2 && !(S.flags[r] & GF_SA_IGN)) {
                     const long long raw = raw_sa(S, p, r);
                     l2 = lmax(l2, raw);
                     l3 = lmax(l3, -raw);
                   }
                   if (ipa_on) {
                     const long long raw = raw_ipa(S, p, r);
                     l4 = lmax(l4, raw);
                     l5 = lmax(l5, -raw);
                   }
                   if (p.has_na_pref) l6 = lmax(l6, p.na_raw[r]);
                 });
      if (p.has_pns) l1 = warp_max(l1);
      if (p.C2) {
        l2 = warp_max(l2);
        l3 = warp_max(l3);
      }
      if (ipa_on) {
        l4 = warp_max(l4);
        l5 = warp_max(l5);
      }
      if (p.has_na_pref) l6 = warp_max(l6);
      if (lane == 0) {
        S.part[1][w] = l1;
        S.part[2][w] = l2;
        S.part[3][w] = l3;
        S.part[4][w] = l4;
        S.part[5][w] = l5;
        S.part[6][w] = l6;
      }
      __syncthreads();
      const long long mx_pns = p.has_pns ? parts_max(S, 1, nw, lane) : 0;
      const long long mx_sa = p.C2 ? parts_max(S, 2, nw, lane) : 0;
      const long long mn_sa = p.C2 ? -parts_max(S, 3, nw, lane) : 0;
      const long long mx_i = ipa_on ? parts_max(S, 4, nw, lane) : 0;
      const long long mn_i = ipa_on ? -parts_max(S, 5, nw, lane) : 0;
      const long long mx_na = p.has_na_pref ? parts_max(S, 6, nw, lane) : 0;
      const int64_t* wt = p.weights;
      visit_kept(mask, pfx, nullptr, kw, w, lane, start, s_mod, num, to_find, total,
                 f_start, [&](int r, int rot) {
                   long long tt = MAX_NODE_SCORE;
                   if (p.has_pns && mx_pns > 0)
                     tt = MAX_NODE_SCORE - floor_div(MAX_NODE_SCORE * p.pns_cnt[r], mx_pns);
                   long long pts = 0;
                   if (p.C2 && !(S.flags[r] & GF_SA_IGN)) {
                     const long long raw = raw_sa(S, p, r);
                     pts = mx_sa > 0 ? floor_div(MAX_NODE_SCORE *
                                                 (mx_sa + (mn_sa < mx_sa ? mn_sa : mx_sa) - raw),
                                                 mx_sa)
                                     : (long long)MAX_NODE_SCORE;
                   }
                   long long ipa = 0;
                   if (ipa_on) {
                     const long long d = mx_i - mn_i;
                     if (d > 0) ipa = floor_div(MAX_NODE_SCORE * (raw_ipa(S, p, r) - mn_i), d);
                   }
                   long long na = 0;
                   if (p.has_na_pref && mx_na > 0)
                     na = floor_div(MAX_NODE_SCORE * p.na_raw[r], mx_na);
                   const long long tot = wt[0] * tt + wt[1] * p.fit_sc[r] + wt[4] * p.ba[r] +
                                         wt[2] * pts + wt[3] * ipa + wt[5] * na +
                                         wt[6] * p.il_score[r];
                   best = lmax(best, tot * NP + (NP - 1 - rot));
                 });
    }
    best = warp_max(best);
    if (lane == 0) S.part[0][w] = best;
    __syncthreads();
    // -- the landing (warp 0) ----------------------------------------------------
    if (w == 0) {
      const long long key = parts_max(S, 0, nw, lane);
      const int evaluated = num - S.bound;
      int chosen = -1;
      if (key >= 0) {
        const int chosen_rot = NP - 1 - (int)(np_pow2 ? key & (NP - 1) : floor_mod(key, NP));
        chosen = small_mod(start + chosen_rot, num);
        gen_land<CARRIED, INCR>(f, p, S, lc, chosen, num, lane, aux_inc);
      }
      const int new_start = small_mod(start + evaluated, num);
      if (lane == 0) {
        p.out[t] = chosen;
        p.out[p.B + t] = new_start;
        S.start = new_start;
        S.bound = 0;
      }
    }
    __syncthreads();
  }

  // -- epilogue: the on-chip tables back to the carry; padded steps -------------
  for (int t = 0; t < GEN2_TABLES; ++t) {
    if (L.cnt[t] < 0) continue;
    const int kind = t / GEN_MAXC, c = t % GEN_MAXC;
    if (kind == K_IPA) {
      int64_t* g = p.ipa_delta + (int64_t)c * V;
      for (int v = tid; v < V; v += nt) g[v] = S.dlt[c][v];
    } else {
      int32_t* g = gen_counts(p, kind) + (int64_t)c * V;
      for (int v = tid; v < V; v += nt) g[v] = S.cnt[t][v];
    }
  }
  const int final_start = S.start;
  for (int t = p.n_act + tid; t < p.B; t += nt) {
    p.out[t] = -1;
    p.out[p.B + t] = final_start;
  }
  if (tid == 0 && start_out != nullptr) *start_out = final_start;
}

// The chunk masks and prefixes of NP rows: [chunk rows][warps + 1] each.
static size_t gen_mask_bytes(int NP) {
  const size_t kw = ((size_t)(NP + 31) / 32 + GEN2_WARPS - 1) / GEN2_WARPS;
  return 2 * kw * (GEN2_WARPS + 1) * 4;
}

// The launch plan: what of a batch's row state and tables fits the block's
// shared memory, in order of use per step (chunk masks, flags, the count
// tables with the spread domains, the value ids, the carried totals).
static GenLayout gen_layout(int NP, int V, const int (&n)[5], bool carried) {
  GenLayout L;
  L.mask = L.flags = L.total = -1;
  for (int t = 0; t < GEN2_TABLES; ++t) L.cnt[t] = L.vid[t] = -1;
  for (int c = 0; c < GEN_MAXC; ++c) L.dom[c] = -1;
  size_t off = 0;
  auto take = [&](size_t bytes) -> int {
    const size_t o = (off + 15) & ~(size_t)15;
    if (o + bytes > GEN2_SMEM_MAX) return -1;
    off = o + bytes;
    return (int)o;
  };
  L.mask = take(gen_mask_bytes(NP));
  L.flags = take((size_t)NP);
  const int order[5] = {K_DNS, K_ANTI, K_AFF, K_SA, K_IPA};
  for (int kind : order)
    for (int c = 0; c < n[kind] && c < GEN_MAXC; ++c) {
      const int t = kind * GEN_MAXC + c;
      L.cnt[t] = take((size_t)V * (kind == K_IPA ? 8 : 4));
      if (kind == K_DNS && L.cnt[t] >= 0) L.dom[c] = take((size_t)V);
    }
  for (int kind : order)
    for (int c = 0; c < n[kind] && c < GEN_MAXC; ++c)
      L.vid[kind * GEN_MAXC + c] = take((size_t)NP * 4);
  if (carried) L.total = take((size_t)NP * 8);
  L.bytes = (int)((off + 15) & ~(size_t)15);
  return L;
}

typedef void (*GenKernel)(ResFeat, GenPlan, GenLayout, const int32_t*, const int32_t*,
                          const int32_t*, int32_t*);

extern "C" int launch_scan_general(
    int NP, int R, int FR, int fit_strategy, int B, int n_act, int V, int C1, int C2,
    int A1, int A2, int KD, int incremental, int carried, int has_pns, int has_ipa_base,
    int has_na_pref, const int64_t* request, const int64_t* nz_request,
    const int64_t* has_request, const int64_t* ba_skip, const int32_t* enable,
    const int32_t* fit_slots, const int64_t* fit_weights, const int64_t* alloc_r,
    const int64_t* alloc_pods, int64_t* req_r, int64_t* nonzero, int32_t* pod_count,
    OPTIONAL const int64_t* nom_req, OPTIONAL const int32_t* nom_pods, OPTIONAL bool* blocked,
    OPTIONAL int32_t* aux_cnt, const int32_t* aux_room, const int32_t* aux_inc, bool* fit_ok, int64_t* fit_sc, int64_t* ba, const bool* static_ok, const bool* sel_ok,
    const bool* taint_ok, const int64_t* pns_cnt, const int32_t* topo, const int64_t* il_score,
    const int64_t* na_raw, const int64_t* ipa_base, const int64_t* weights,
    const int32_t* num_nodes, const int32_t* to_find, const int32_t* start,
    const int32_t* dns_axis, const int32_t* dns_active, const int64_t* dns_max_skew,
    const int32_t* dns_self, const int32_t* dns_forced0, const int32_t* dns_honor_aff,
    const int32_t* dns_honor_taints, const bool* dns_dom, int32_t* dns_counts,
    const int32_t* sa_axis, const int64_t* sa_wq, const int64_t* sa_skew,
    const int32_t* sa_self, int32_t* sa_counts, const int32_t* anti_axis,
    const int32_t* anti_self, int32_t* anti_counts, const int32_t* aff_axis,
    const int32_t* aff_self, const int32_t* aff_active, const int32_t* aff_own_all,
    int32_t* aff_counts, const int32_t* ipa_axis, const int64_t* ipa_wland,
    int64_t* ipa_delta, uint8_t* okd_s, int32_t* F_s, int64_t* total_s, int32_t* out,
    int32_t* start_out, cudaStream_t stream) {
  // The spread minima are kept for GEN_MAXC constraints; the other kinds
  // take any count.
  const int n[5] = {C1, C2, A1, A2, KD};
  for (int k = 0; k < 5; ++k)
    if (n[k] < 0) return (int)cudaErrorInvalidValue;
  if (NP <= 0 || C1 > GEN_MAXC) return (int)cudaErrorInvalidValue;
  const GenLayout L = gen_layout(NP, V, n, carried != 0);
  // Off chip, the flags use okd_s (NP bytes), the masks and prefixes F_s
  // (NP ints), the carried totals total_s.
  if (L.mask < 0 && gen_mask_bytes(NP) > (size_t)NP * 4) return (int)cudaErrorInvalidValue;
  ResFeat f{request, nz_request, has_request, ba_skip, enable, fit_slots, fit_weights,
            R, FR, fit_strategy};
  GenPlan p{NP, B, n_act, V, C1, C2, A1, A2, KD, incremental, carried, has_pns,
            has_ipa_base, has_na_pref, alloc_r, alloc_pods, req_r, nonzero, pod_count,
            nom_req, nom_pods, (uint8_t*)blocked, aux_cnt, aux_room, aux_inc,
            (uint8_t*)fit_ok, fit_sc, ba,
            (const uint8_t*)static_ok,
            (const uint8_t*)sel_ok, (const uint8_t*)taint_ok, pns_cnt, topo, il_score, na_raw,
            ipa_base, weights,
            dns_axis, dns_active, dns_max_skew, dns_self, dns_forced0, dns_honor_aff,
            dns_honor_taints, (const uint8_t*)dns_dom, dns_counts, sa_axis, sa_wq, sa_skew,
            sa_self, sa_counts, anti_axis, anti_self, anti_counts, aff_axis, aff_self,
            aff_active, aff_own_all, aff_counts, ipa_axis, ipa_wland, ipa_delta, okd_s, F_s,
            total_s, out};
  GenKernel kern = carried ? (incremental ? scan_general_kernel<true, true>
                                          : scan_general_kernel<true, false>)
                           : (incremental ? scan_general_kernel<false, true>
                                          : scan_general_kernel<false, false>);
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       L.bytes);
  if (e != cudaSuccess) return (int)e;
  kern<<<1, GEN2_THREADS, L.bytes, stream>>>(f, p, L, num_nodes, to_find, start, start_out);
  return (int)cudaGetLastError();
}
