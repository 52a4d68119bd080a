// The general scan step, written once for the two kernels that run it:
// scan_general (csrc/scan_general.cu: one batch, grid 1, every row of the
// node state) and schedule_placements (csrc/schedule_placements.cu: grid P,
// one candidate placement a block, only the rows of its placement). It is
// the JAX package's schedule_batch scan `step` and `feasibility_proj`
// (kubernetes_tpu/ops/kernel.py:314-523); scan_general.cu's header comment
// gives its design and its bound.
//
// A block runs the step over S.n positions. Position i is row i under
// scan_general's identity map, or row S.rows[i] of an ascending list of
// original row ids under a placement's compact map (COMPACT). Every array
// of the step's row state (flags, value ids, carried totals, the chunk
// ballots) is indexed by position; the node state and the batch's
// per-row inputs (allocatable, requests, static masks, scores) by row. The
// rotation, the selection key and the window boundary use the original
// row: rows left out of a compact list are never feasible, so the ranks
// over its positions from the first position at or past `start` equal the
// reference's ranks over every row.
//
// Functions here are inline, templates or static: each source that
// includes the header keeps its own copy (two objects, one library).
#pragma once

#include <climits>

#include "gen_sizes.h"
#include "kernels.cuh"

#define GEN_BIG (1LL << 30)
#define GEN_INF64 (1LL << 60)

constexpr int GEN2_TABLES = 5 * GEN_MAXC;        // a slot per table: the first GEN_MAXC a kind
#define FULL 0xffffffffu

// Table kinds: table t = kind * GEN_MAXC + c.
#define K_DNS 0
#define K_SA 1
#define K_ANTI 2
#define K_AFF 3
#define K_IPA 4

// A position's flags.
#define GF_OK 1        // full feasibility: the base verdict; incremental: the verdict
#define GF_SA_IGN 2    // ScheduleAnyway ignores the row (scoring.go initPreScoreState)
#define GF_AFF_KEYS 4  // the row has every active affinity term's key

struct GenPlan {
  int NP, B, n_act, V, C1, C2, A1, A2, KD;
  int incremental, carried, has_pns, has_ipa_base, has_na_pref;
  int blocked_on, aux_on;  // the blocked lane (host ports), the aux_cnt lane (attach limits)
  const int64_t* alloc_r;
  const int64_t* alloc_pods;
  int64_t* req_r;          // scan_general: the carry, landed in place; placements: read only
  int64_t* nonzero;
  int32_t* pod_count;
  const int64_t* nom_req;  // the nominated-pod lane, or null
  const int32_t* nom_pods;
  uint8_t* blocked;        // scan_general's blocked lane (blocked_on), else null
  int32_t* aux_cnt;        // scan_general's aux_cnt lane (aux_on), else null
  const int32_t* aux_room; // [NP] attach room a row (aux_on)
  const int32_t* aux_inc;  // device scalar: attachments a pod adds
  uint8_t* fit_ok;         // scan_general's carry lanes; null for placements
  int64_t* fit_sc;
  int64_t* ba;
  const uint8_t* static_ok;
  const uint8_t* sel_ok;
  const uint8_t* taint_ok;
  const int64_t* pns_cnt;
  const int32_t* topo;
  const int64_t* il_score;
  const int64_t* na_raw;
  const int64_t* ipa_base;
  const int64_t* weights;
  const int32_t* dns_axis;
  const int32_t* dns_active;
  const int64_t* dns_max_skew;
  const int32_t* dns_self;
  const int32_t* dns_forced0;
  const int32_t* dns_honor_aff;
  const int32_t* dns_honor_taints;
  const uint8_t* dns_dom;
  int32_t* dns_counts;
  const int32_t* sa_axis;
  const int64_t* sa_wq;
  const int64_t* sa_skew;
  const int32_t* sa_self;
  int32_t* sa_counts;
  const int32_t* anti_axis;
  const int32_t* anti_self;
  int32_t* anti_counts;
  const int32_t* aff_axis;
  const int32_t* aff_self;
  const int32_t* aff_active;
  const int32_t* aff_own_all;  // device scalar
  int32_t* aff_counts;
  const int32_t* ipa_axis;
  const int64_t* ipa_wland;
  int64_t* ipa_delta;
  uint8_t* okd;            // scan_general's device-memory tier: flags, chunk masks, totals
  int32_t* F;
  int64_t* total;
  int32_t* out;
};

// A block's view of its row state: on chip or in device memory, as the
// kernel's launch plan placed each array.
struct GenShared {
  const int32_t* vid[GEN2_TABLES];  // position -> value id, per table
  int32_t* cnt[4 * GEN_MAXC];       // the int32 count tables (dns, sa, anti, aff)
  int64_t* dlt[GEN_MAXC];           // the ipa_delta rows
  const uint8_t* dom[GEN_MAXC];     // the spread domains
  const int32_t* rows;              // position -> row (COMPACT), else null
  uint8_t* flags;
  uint32_t* mask;                   // [chunk rows][warps + 1] feasibility ballots
  int* pfx;                         // [chunk rows][warps + 1] feasible positions before a chunk
  int64_t* total;                   // carried totals (CARRIED)
  int64_t* fsc;                     // fit score and BalancedAllocation by position (normalized
  int64_t* fba;                     //   scores read them; scan_general: the carry's lanes)
  int32_t* land;                    // COMPACT: the lane's own landings on a position
  long long thr[GEN_MAXC];          // a spread row is feasible while count <= thr
  int mn[GEN_MAXC], at_min[GEN_MAXC];
  long long part[7][GEN2_WARPS];
  long long aff_total;
  int n;                            // positions
  int start, cstart, bound;         // rotation start (a row), its first position, boundary
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

// The number of positions whose row is below x (rows ascending, one
// warp): a 32-way search, one ballot a round.
__device__ __forceinline__ int warp_lower_bound(const int32_t* rows, int n, int x, int lane) {
  int lo = 0, len = n;
  while (len > 32) {
    const int stride = (len + 31) >> 5;
    const int s = lo + lane * stride;
    const int c = __popc(__ballot_sync(FULL, s < lo + len && rows[s] < x));
    if (c == 0) return lo;
    const int nlo = lo + (c - 1) * stride + 1;
    const int hi = lo + c * stride < lo + len ? lo + c * stride : lo + len;
    lo = nlo;
    len = hi - nlo;
  }
  return lo + __popc(__ballot_sync(FULL, lane < len && rows[lo + lane] < x));
}

__device__ __forceinline__ long long gen_thr(const GenPlan& p, int c, int mn) {
  const long long cap = p.dns_max_skew[c] < GEN_BIG ? p.dns_max_skew[c] : GEN_BIG;
  return (long long)(p.dns_forced0[c] == 1 ? 0 : mn) + cap - p.dns_self[c];
}

// Constraint c's minimum over its eligible domains (_BIG when none) and the
// domains at it, by one warp; lane 0 stores them and the row threshold.
static __device__ void gen_rescan(GenShared& S, const GenPlan& p, int c, int lane) {
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

// Table c of a kind: its value id by position and its counts (ipa_delta
// rows for K_IPA). A kind's first GEN_MAXC tables have a slot, on chip or
// in device memory as the launch plan says; the tables past them (C2, A1,
// A2 and KD take any count in scan_general) are read in device memory by
// row, which is the position only under the identity map: placements take
// at most GEN_MAXC tables of a kind.
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

// ScheduleAnyway's raw score of position i and the inter-pod raw score of
// position i on row r (the reference's raw lanes on the on-chip tables).
// They run for every kept row twice a step, so the slotted tables are read
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

__device__ __forceinline__ long long raw_ipa(const GenShared& S, const GenPlan& p, int i, int r) {
  long long raw = p.ipa_base[r];
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

// Clear the bits of okm (bit j: position rb + 32 * GEN2_WARPS * j) whose
// row fails a count-table test (feasibility_proj, :314-341). Per lane, no
// collective; every position of the group is read (those past n as
// position 0, their bits are clear already), so the loads carry no branch.
__device__ __forceinline__ uint32_t table_filter(const GenShared& S, const GenPlan& p,
                                                 uint32_t okm, int kn, int rb, int n,
                                                 int aff_own_all) {
  constexpr int rs = 32 * GEN2_WARPS;  // positions between a lane's chunks
  for (int c = 0; c < p.C1; ++c) {
    if (p.dns_active[c] != 1) continue;
    const int32_t* vid = S.vid[K_DNS * GEN_MAXC + c];
    const int32_t* cnt = S.cnt[K_DNS * GEN_MAXC + c];
    const long long thr = S.thr[c];
    uint32_t bad = 0;
#pragma unroll 8
    for (int j = 0; j < kn; ++j) {
      const int r = rb + rs * j;
      const int v = vid[r < n ? r : 0];
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
      const int v = vid[r < n ? r : 0];
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
        const int v = vid[r < n ? r : 0];
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
        keys |= (uint32_t)((S.flags[r < n ? r : 0] & GF_AFF_KEYS) != 0) << j;
      }
      okm &= all | keys;
    }
  }
  return okm;
}

// Visit the warp's kept positions (feasible, rank <= to_find), calling
// fn(position, row, rot) on the position's lane; the position of rank
// to_find stores the window boundary when `bound` is set. The warp's chunk
// k is chunk k * GEN2_WARPS + w, its ballot and the feasible positions
// before it at [k][w] of mask and pfx. Chunks that can hold no kept
// position are skipped whole. Per lane, no collective.
template <bool COMPACT, class Fn>
__device__ __forceinline__ void visit_kept(const uint32_t* mask, const int* pfx,
                                           const int32_t* rows, int* bound, int kw, int w,
                                           int lane, int cstart, int s_mod, int num, int to_find,
                                           int total, int f_start, Fn fn) {
  const uint32_t le = mask_le(lane);
  for (int k = 0; k < kw; ++k) {
    const uint32_t m = mask[k * (GEN2_WARPS + 1) + w];
    if (m == 0) continue;
    const int c0 = pfx[k * (GEN2_WARPS + 1) + w];
    const int cb = 32 * (k * GEN2_WARPS + w);
    if (cb >= cstart ? c0 + 1 - f_start > to_find
                     : (cb + 31 < cstart && c0 + 1 + total - f_start > to_find))
      continue;
    if (!((m >> lane) & 1u)) continue;
    const int i = cb + lane;
    const int Fi = c0 + __popc(m & le);
    const int rank = i >= cstart ? Fi - f_start : Fi + total - f_start;
    if (rank > to_find) continue;
    const int r = COMPACT ? rows[i] : i;
    int rot = r - s_mod;
    if (rot < 0) rot += num;
    if (bound != nullptr && rank == to_find) *bound = num - 1 - rot;
    fn(i, r, rot);
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

// Land the pod on `row`, at position `pos` (every lane of one warp): the
// row's aggregates and fit/score lanes (resource_eval_row after the +1
// pod), the +self (+weight) at the row's value of every table with the
// maintained spread minimum, the blocked and aux lanes, the position's new
// flag and carried total. Under the identity map the row's aggregates are
// the carry's and are written back; under a placement's compact map they
// are the resident node state's plus k of the lane's own pods (every pod
// of a batch requests the same), k = S.land[pos], and only k moves: a
// lane writes no input. Every load of the row is issued first (one round
// trip to device memory); the fit slots' divisions and
// BalancedAllocation's two shares are one division across the lanes.
template <bool CARRIED, bool INCR, bool COMPACT>
__device__ __forceinline__ void gen_land(const ResFeat& f, const GenPlan& p, GenShared& S,
                                         const LandLane& c, int row, int pos, int num, int lane,
                                         int aux_inc) {
  const int R = f.R;
  const int64_t* al = p.alloc_r + (int64_t)row * R;
  int64_t* rq = p.req_r + (int64_t)row * R;
  const int64_t* nom = p.nom_req ? p.nom_req + (int64_t)row * R : nullptr;
  const bool slot = lane < f.FR && lane < 30;
  // -- loads (nothing is written before the __syncwarp below) -------------------
  const int k = COMPACT ? S.land[pos] : 0;  // the lane's own pods on the row
  const long long a_r = lane < R ? al[lane] : 0;
  const long long q_r = lane < R ? rq[lane] + k * c.q : 0;
  const long long n_r = nom != nullptr && lane < R ? nom[lane] : 0;
  const long long a_s = slot ? al[c.fit_s] : 0;
  const long long q_s = slot ? rq[c.fit_s] + k * c.fit_q : 0;
  const long long a_ba = lane >= 30 ? al[lane - 30] : 0;
  const long long nz = lane < 2 ? p.nonzero[2 * (int64_t)row + lane] + k * c.nzq : 0;
  const int pods = p.pod_count[row] + k + 1;
  const long long alloc_pods = p.alloc_pods[row];
  const int nom_pods = p.nom_req ? p.nom_pods[row] : 0;
  const bool static_ok = p.static_ok[row], sel = p.sel_ok[row], taint = p.taint_ok[row];
  const long long il = CARRIED ? p.il_score[row] : 0;
  const int aux = !p.aux_on ? 0 : COMPACT ? (k + 1) * aux_inc : p.aux_cnt[row] + aux_inc;
  const int room = p.aux_on ? p.aux_room[row] : 0;
  const uint8_t flags = S.flags[pos];
  const int v_d = lane < p.C1 ? S.vid[K_DNS * GEN_MAXC + lane][pos] : 0;
  const int v_s = lane < p.C2 ? vid_of(S, p, K_SA, lane)[pos] : 0;  // table k = lane
  const int v_a = lane < p.A1 ? vid_of(S, p, K_ANTI, lane)[pos] : 0;
  const int v_f = lane < p.A2 ? vid_of(S, p, K_AFF, lane)[pos] : 0;
  const int v_i = lane < p.KD ? vid_of(S, p, K_IPA, lane)[pos] : 0;
  // -- the fit filter (:175-179) and the score (:180-208) ----------------------
  bool viol = lane < R && c.q > 0 && c.q > a_r - (q_r + c.q) - n_r;
  for (int r = lane + 32; r < R; r += 32) {
    const long long q = f.request[r];
    viol |= q > 0 && q > al[r] - (rq[r] + (k + 1) * q) - (nom != nullptr ? nom[r] : 0);
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
    fit_term(f.fit_strategy, a, s == 0 ? used0 : (s == 1 ? used1
                                                  : rq[s] + (k + 2) * f.request[s]), tn, td);
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
  if (!COMPACT) {
    if (lane < R) rq[lane] = q_r + c.q;
    for (int r = lane + 32; r < R; r += 32) rq[r] += f.request[r];
    if (lane < 2) p.nonzero[2 * (int64_t)row + lane] = nz + c.nzq;
  }
  if (lane == 0) {
    if (COMPACT) {
      S.land[pos] = k + 1;
    } else {
      p.pod_count[row] = pods;
      p.fit_ok[row] = ok;
    }
    if (!COMPACT || !CARRIED) {
      S.fsc[pos] = sc;
      S.fba[pos] = b;
    }
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
    for (int t = lane; t < p.C2; t += 32)
      cnt_of(S, p, K_SA, t)[t < 32 ? v_s : vid_of(S, p, K_SA, t)[pos]] +=
          t < 32 ? c.sa_self : p.sa_self[t];
  bool anti_hit = false;
  for (int t = lane; t < p.A1; t += 32) {
    const int v = t < 32 ? v_a : vid_of(S, p, K_ANTI, t)[pos];
    if (v <= 0) continue;
    int32_t* cnt = cnt_of(S, p, K_ANTI, t);
    const int n = cnt[v] + (t < 32 ? c.anti_self : p.anti_self[t]);
    cnt[v] = n;
    anti_hit |= n > 0;
  }
  const bool anti_any = INCR && __any_sync(FULL, anti_hit);
  if (p.A2) {
    long long add = 0;
    for (int t = lane; t < p.A2; t += 32) {
      const int v = t < 32 ? v_f : vid_of(S, p, K_AFF, t)[pos];
      if (v <= 0) continue;
      const int self = t < 32 ? c.aff_self : p.aff_self[t];
      cnt_of(S, p, K_AFF, t)[v] += self;
      add += self;
    }
    add = warp_sum(add);
    if (lane == 0) S.aff_total += add;
  }
  for (int t = lane; t < p.KD; t += 32) {
    const int v = t < 32 ? v_i : vid_of(S, p, K_IPA, t)[pos];
    if (v > 0) dlt_of(S, p, t)[v] += t < 32 ? c.ipa_w : p.ipa_wland[t];
  }
  if (lane == 0) {
    if (!COMPACT && p.blocked_on) p.blocked[row] = 1;
    if (!COMPACT && p.aux_on) p.aux_cnt[row] = aux;
    bool now_ok = static_ok && ok && row < num && !p.blocked_on &&
                  !(p.aux_on && aux + aux_inc > room);
    if (INCR) now_ok = now_ok && !anti_any;
    S.flags[pos] = (uint8_t)((flags & ~GF_OK) | (now_ok ? GF_OK : 0));
    if (CARRIED) S.total[pos] = c.w0 * MAX_NODE_SCORE + c.w1 * sc + c.w4 * b + c.w6 * il;
  }
}

// Every active step of the batch (scan_general.cu's pass 1, ranks, pass 2
// and landing) over S's S.n positions, from S.start (a row) and S.cstart
// (its first position: the positions before it hold the rows below it),
// over `num` live rows (num_nodes, at least 1) with the window `to_find`;
// each step writes p.out[t] and p.out[B + t]. Every thread of the block
// calls it, after the prologue placed and filled S's arrays and the spread
// minima; it ends with a block barrier.
template <bool CARRIED, bool INCR, bool COMPACT>
__device__ __forceinline__ void gen_steps(const ResFeat& f, const GenPlan& p, GenShared& S,
                                          int num, int to_find, int aff_own_all, int aux_inc) {
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  constexpr int nw = GEN2_WARPS, ms = GEN2_WARPS + 1;  // the launch's warps; mask row stride
  const int NP = p.NP, n = S.n;
  // Warp w owns the 32-position chunks w, w + nw, w + 2 nw, ...: kw of them.
  const int kw = ((n + 31) / 32 + nw - 1) / nw;
  const LandLane lc = land_lane(f, p, lane);
  const bool np_pow2 = (NP & (NP - 1)) == 0;
  uint32_t* const mask = S.mask;
  int* const pfx = S.pfx;
  const int32_t* const rows = S.rows;
  for (int t = 0; t < p.n_act; ++t) {
    const int start = S.start, cstart = S.cstart;
    // -- pass 1: feasibility, a ballot per chunk ------------------------------
    for (int g = 0; g < kw; g += 32) {
      const int kn = imin(32, kw - g);
      const int rb = 32 * (g * nw + w) + lane;  // bit j: position rb + 32 * nw * j
      uint32_t okm = 0;
#pragma unroll 8
      for (int j = 0; j < kn; ++j) {
        const int r = rb + 32 * nw * j;
        okm |= (uint32_t)((r < n) & S.flags[r < n ? r : 0] & GF_OK) << j;
      }
      if (!INCR) okm = table_filter(S, p, okm, kn, rb, n, aff_own_all);
      uint32_t mine = 0;
      for (int j = 0; j < kn; ++j) {
        const uint32_t m = __ballot_sync(FULL, (okm >> j) & 1u);
        mine = lane == j ? m : mine;
      }
      if (lane < kn) mask[(g + lane) * ms + w] = mine;
    }
    __syncthreads();
    // -- ranks: each warp sums the ballots into its chunks' prefixes ---------
    // (position cstart - 1's chunk: chunk row ks, warp wsx)
    const int cs = cstart > 0 && cstart - 1 < n ? (cstart - 1) >> 5 : -1;
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
    const int f_start = cstart == 0 ? 0 : cs < 0 ? total
        : fbase + __popc(mask[ks * ms + wsx] & mask_le((cstart - 1) & 31));
    const int s_mod = small_mod(start, num);
    // -- pass 2: the kept set, the boundary and the arg-max key --------------
    long long best = -1;
    if (CARRIED) {
      const int64_t* tot = S.total;
      visit_kept<COMPACT>(mask, pfx, rows, &S.bound, kw, w, lane, cstart, s_mod, num, to_find,
                          total, f_start, [&](int i, int, int rot) {
                            best = lmax(best, tot[i] * NP + (NP - 1 - rot));
                          });
    } else {
      // normalization lanes over the kept set, then the scores
      long long l1 = 0, l2 = 0, l3 = -GEN_INF64, l4 = -GEN_INF64, l5 = -GEN_INF64, l6 = 0;
      const bool ipa_on = p.KD || p.has_ipa_base;
      visit_kept<COMPACT>(mask, pfx, rows, &S.bound, kw, w, lane, cstart, s_mod, num, to_find,
                          total, f_start, [&](int i, int r, int) {
                            if (p.has_pns) l1 = lmax(l1, p.pns_cnt[r]);
                            if (p.C2 && !(S.flags[i] & GF_SA_IGN)) {
                              const long long raw = raw_sa(S, p, i);
                              l2 = lmax(l2, raw);
                              l3 = lmax(l3, -raw);
                            }
                            if (ipa_on) {
                              const long long raw = raw_ipa(S, p, i, r);
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
      visit_kept<COMPACT>(mask, pfx, rows, nullptr, kw, w, lane, cstart, s_mod, num, to_find,
                          total, f_start, [&](int i, int r, int rot) {
                            long long tt = MAX_NODE_SCORE;
                            if (p.has_pns && mx_pns > 0)
                              tt = MAX_NODE_SCORE - floor_div(MAX_NODE_SCORE * p.pns_cnt[r],
                                                              mx_pns);
                            long long pts = 0;
                            if (p.C2 && !(S.flags[i] & GF_SA_IGN)) {
                              const long long raw = raw_sa(S, p, i);
                              pts = mx_sa > 0 ? floor_div(MAX_NODE_SCORE *
                                                          (mx_sa + (mn_sa < mx_sa ? mn_sa : mx_sa)
                                                           - raw), mx_sa)
                                              : (long long)MAX_NODE_SCORE;
                            }
                            long long ipa = 0;
                            if (ipa_on) {
                              const long long d = mx_i - mn_i;
                              if (d > 0)
                                ipa = floor_div(MAX_NODE_SCORE * (raw_ipa(S, p, i, r) - mn_i), d);
                            }
                            long long na = 0;
                            if (p.has_na_pref && mx_na > 0)
                              na = floor_div(MAX_NODE_SCORE * p.na_raw[r], mx_na);
                            const long long tot = wt[0] * tt + wt[1] * S.fsc[i] + wt[4] * S.fba[i]
                                                  + wt[2] * pts + wt[3] * ipa + wt[5] * na +
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
        const int pos = COMPACT ? warp_lower_bound(rows, n, chosen, lane) : chosen;
        gen_land<CARRIED, INCR, COMPACT>(f, p, S, lc, chosen, pos, num, lane, aux_inc);
      }
      const int new_start = small_mod(start + evaluated, num);
      const int new_cs = COMPACT ? warp_lower_bound(rows, n, new_start, lane) : new_start;
      if (lane == 0) {
        p.out[t] = chosen;
        p.out[p.B + t] = new_start;
        S.start = new_start;
        S.cstart = new_cs;
        S.bound = 0;
      }
    }
    __syncthreads();
  }
}
