// The general scan step shared by scan_general (one batch, grid 1) and
// schedule_placements (one candidate placement per block, grid P): the JAX
// package's schedule_batch scan `step` and `feasibility_proj`
// (ops/kernel.py:314-523) with the prologue (:545-575), as gen_scan over a
// GenPlan of pointers. See scan_general.cu for the step's design and bound.
// The functions are static: each source that includes this header keeps
// its own copy.
#pragma once

#include <climits>

#include "kernels.cuh"

#define GEN_BLOCK 512
#define GEN_MAXC 16        // table rows per kind (the wrapper checks)
#define GEN_LANES 8
#define GEN_BIG (1LL << 30)
#define GEN_INF64 (1LL << 60)

struct GenPlan {
  int NP, B, n_act, V, C1, C2, A1, A2, KD;
  int incremental, carried, has_pns, has_ipa_base, has_na_pref;
  const int64_t* alloc_r;
  const int64_t* alloc_pods;
  int64_t* req_r;
  int64_t* nonzero;
  int32_t* pod_count;
  const int64_t* nom_req;  // the nominated-pod lane, or null
  const int32_t* nom_pods;
  uint8_t* blocked;        // the blocked lane of a host-port plan, or null
  int32_t* aux_cnt;        // the aux_cnt lane of a has_aux plan, or null
  const int32_t* aux_room; // [NP] attach room a row (with aux_cnt)
  const int32_t* aux_inc;  // device scalar: attachments a pod adds
  uint8_t* fit_ok;
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
  uint8_t* okd;
  int32_t* F;
  int64_t* total;
  int32_t* out;
};

__device__ __forceinline__ int gvid(const GenPlan& p, const int32_t* axis, int c, int i) {
  return p.topo[(int64_t)axis[c] * p.NP + i];
}

// Row i's feasibility (feasibility_proj, :314-341) against the current
// tables; s_min holds each spread constraint's minimum (forced0 applied).
static __device__ bool gen_feasible(const GenPlan& p, int i, int num, const int* s_min,
                             long long aff_total) {
  if (!(p.static_ok[i] && p.fit_ok[i] && i < num)) return false;
  if (p.blocked && p.blocked[i]) return false;
  if (p.aux_cnt && p.aux_cnt[i] + *p.aux_inc > p.aux_room[i]) return false;
  for (int c = 0; c < p.C1; ++c) {
    if (p.dns_active[c] != 1) continue;
    const int v = gvid(p, p.dns_axis, c, i);
    if (v <= 0) return false;
    const long long skew = (long long)p.dns_counts[(int64_t)c * p.V + v] + p.dns_self[c] - s_min[c];
    const long long max_skew = p.dns_max_skew[c] < GEN_BIG ? p.dns_max_skew[c] : GEN_BIG;
    if (skew > max_skew) return false;
  }
  for (int c = 0; c < p.A1; ++c) {
    const int v = gvid(p, p.anti_axis, c, i);
    if (v > 0 && p.anti_counts[(int64_t)c * p.V + v] > 0) return false;
  }
  if (p.A2) {
    bool all_terms = true, has_keys = true;
    for (int c = 0; c < p.A2; ++c) {
      if (p.aff_active[c] == 0) continue;
      const int v = gvid(p, p.aff_axis, c, i);
      if (v <= 0) {
        has_keys = false;
        all_terms = false;
      } else if (p.aff_counts[(int64_t)c * p.V + v] <= 0) {
        all_terms = false;
      }
    }
    const bool bootstrap = aff_total == 0 && *p.aff_own_all == 1 && has_keys;
    if (!(all_terms || bootstrap)) return false;
  }
  return true;
}

// scoring.go initPreScoreState: a row missing any constraint's key (padding
// rows included, as in the JAX package) or failing node affinity.
static __device__ bool gen_sa_ignored(const GenPlan& p, int i) {
  if (!p.sel_ok[i]) return true;
  for (int c = 0; c < p.C2; ++c)
    if (gvid(p, p.sa_axis, c, i) <= 0) return true;
  return false;
}

static __device__ long long gen_raw_sa(const GenPlan& p, int i) {
  long long raw = 0;
  for (int c = 0; c < p.C2; ++c) {
    const int v = gvid(p, p.sa_axis, c, i);
    raw += (long long)p.sa_counts[(int64_t)c * p.V + v] * p.sa_wq[c] + (p.sa_skew[c] - 1) * 1024;
  }
  return raw;
}

static __device__ long long gen_raw_ipa(const GenPlan& p, int i) {
  long long raw = p.ipa_base[i];
  for (int k = 0; k < p.KD; ++k) {
    const int v = gvid(p, p.ipa_axis, k, i);
    if (v > 0) raw += p.ipa_delta[(int64_t)k * p.V + v];
  }
  return raw;
}

// Max over the block of GEN_LANES int64 lanes (warp shuffles, then one warp
// over the warps' partials); the results land in out[] for every thread.
__device__ __forceinline__ void block_max_lanes(long long (&v)[GEN_LANES],
                                                long long (*part)[32], long long* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
#pragma unroll
  for (int l = 0; l < GEN_LANES; ++l) {
    for (int off = 16; off > 0; off >>= 1) {
      const long long o = __shfl_down_sync(0xffffffffu, v[l], off);
      v[l] = o > v[l] ? o : v[l];
    }
    if (lane == 0) part[l][warp] = v[l];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int l = 0; l < GEN_LANES; ++l) {
      long long x = lane < nw ? part[l][lane] : LLONG_MIN;
      for (int off = 16; off > 0; off >>= 1) {
        const long long o = __shfl_down_sync(0xffffffffu, x, off);
        x = o > x ? o : x;
      }
      if (lane == 0) out[l] = x;
    }
  }
  __syncthreads();
}

// The whole greedy scan of one batch by one block: every active step of
// scan_general's loop (the block comment of scan_general.cu), from rotation
// start `start0`, over `num` live rows (num_nodes, at least 1) with the
// window `to_find`. Every thread of the block calls it; it uses static
// shared memory, so a block runs one scan at a time. The final start goes
// to *start_out (when not null).
static __device__ void gen_scan(const ResFeat& f, const GenPlan& p, int num, int to_find,
                                int start0, int32_t* start_out) {
  __shared__ int scan_sm[GEN_BLOCK];
  __shared__ long long part[GEN_LANES][32];
  __shared__ long long red[GEN_LANES];
  __shared__ int s_min[GEN_MAXC];
  __shared__ long long s_aff_total;
  __shared__ int s_start, s_row, s_delta;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int NP = p.NP;
  const int rpt = (NP + nt - 1) / nt;
  const int lo = min(tid * rpt, NP), hi = min(lo + rpt, NP);
  const int64_t* w = p.weights;  // [tt, fit, pts, ipa, ba, na, il]

  // -- prologue: aff_total0 (:561), the start --------------------------------
  if (tid == 0) {
    long long s = 0;
    for (int c = 0; c < p.A2; ++c)
      if (p.aff_active[c] == 1)
        for (int v = 0; v < p.V; ++v) s += p.aff_counts[(int64_t)c * p.V + v];
    s_aff_total = s;
    s_start = start0;
  }
  __syncthreads();

  for (int t = 0; t < p.n_act; ++t) {
    if (t == 0 || !p.incremental) {
      // spread minima: min over eligible domains, _BIG when none (:329-330)
      if (tid < p.C1) s_min[tid] = (int)GEN_BIG;
      __syncthreads();
      for (int c = 0; c < p.C1; ++c) {
        int m = (int)GEN_BIG;
        for (int v = tid; v < p.V; v += nt)
          if (p.dns_dom[(int64_t)c * p.V + v]) m = min(m, p.dns_counts[(int64_t)c * p.V + v]);
        atomicMin(&s_min[c], m);
      }
      __syncthreads();
      if (tid < p.C1 && p.dns_forced0[tid] == 1) s_min[tid] = 0;
      __syncthreads();
      const long long aff_total = s_aff_total;
      int cnt = 0;
      for (int i = lo; i < hi; ++i) {
        const bool ok = gen_feasible(p, i, num, s_min, aff_total);
        p.okd[i] = ok;
        cnt += ok;
        if (t == 0 && p.carried)
          p.total[i] = w[0] * MAX_NODE_SCORE + w[1] * p.fit_sc[i] + w[4] * p.ba[i] +
                       w[6] * p.il_score[i];
      }
      const int incl = block_inclusive_scan(cnt, scan_sm);
      int run = incl - cnt;
      for (int i = lo; i < hi; ++i) {
        run += p.okd[i];
        p.F[i] = run;
      }
      __syncthreads();
    }
    const int start = s_start;
    const int total_feas = p.F[NP - 1];
    const int f_start = start > 0 ? p.F[start - 1] : 0;

    // -- reduction round one ---------------------------------------------------
    long long lanes[GEN_LANES] = {0, 0, 0, -GEN_INF64, -GEN_INF64, -GEN_INF64, 0, -1};
    for (int i = lo; i < hi; ++i) {
      if (!p.okd[i]) continue;
      const int rank = i >= start ? p.F[i] - f_start : p.F[i] + total_feas - f_start;
      const int rot = (int)floor_mod(i - start, num);
      if (rank == to_find && num - 1 - rot > lanes[0]) lanes[0] = num - 1 - rot;
      if (rank > to_find) continue;
      if (p.carried) {
        const long long key = p.total[i] * NP + (NP - 1 - rot);
        if (key > lanes[7]) lanes[7] = key;
        continue;
      }
      if (p.has_pns && p.pns_cnt[i] > lanes[1]) lanes[1] = p.pns_cnt[i];
      if (p.C2 && !gen_sa_ignored(p, i)) {
        const long long raw = gen_raw_sa(p, i);
        if (raw > lanes[2]) lanes[2] = raw;
        if (-raw > lanes[3]) lanes[3] = -raw;
      }
      if (p.KD || p.has_ipa_base) {
        const long long raw = gen_raw_ipa(p, i);
        if (raw > lanes[4]) lanes[4] = raw;
        if (-raw > lanes[5]) lanes[5] = -raw;
      }
      if (p.has_na_pref && p.na_raw[i] > lanes[6]) lanes[6] = p.na_raw[i];
    }
    block_max_lanes(lanes, part, red);
    const int evaluated = num - (int)red[0];
    long long best_key = red[7];

    // -- score assembly and reduction round two (runtime/framework.go:1526) ---
    if (!p.carried) {
      const long long mx_pns = red[1], mx_sa = red[2], mn_sa = -red[3];
      const long long mx_i = red[4], mn_i = -red[5], mx_na = red[6];
      long long best[GEN_LANES] = {-1, -1, -1, -1, -1, -1, -1, -1};
      for (int i = lo; i < hi; ++i) {
        if (!p.okd[i]) continue;
        const int rank = i >= start ? p.F[i] - f_start : p.F[i] + total_feas - f_start;
        if (rank > to_find) continue;
        const int rot = (int)floor_mod(i - start, num);
        long long tt = MAX_NODE_SCORE;
        if (p.has_pns && mx_pns > 0)
          tt = MAX_NODE_SCORE - floor_div(MAX_NODE_SCORE * p.pns_cnt[i], mx_pns);
        long long pts = 0;
        if (p.C2 && !gen_sa_ignored(p, i)) {
          const long long raw = gen_raw_sa(p, i);
          pts = mx_sa > 0
              ? floor_div(MAX_NODE_SCORE * (mx_sa + (mn_sa < mx_sa ? mn_sa : mx_sa) - raw), mx_sa)
              : (long long)MAX_NODE_SCORE;
        }
        long long ipa = 0;
        if (p.KD || p.has_ipa_base) {
          const long long diff = mx_i - mn_i;
          if (diff > 0) ipa = floor_div(MAX_NODE_SCORE * (gen_raw_ipa(p, i) - mn_i), diff);
        }
        long long na = 0;
        if (p.has_na_pref && mx_na > 0) na = floor_div(MAX_NODE_SCORE * p.na_raw[i], mx_na);
        const long long total = w[0] * tt + w[1] * p.fit_sc[i] + w[4] * p.ba[i] + w[2] * pts +
                                w[3] * ipa + w[5] * na + w[6] * p.il_score[i];
        const long long key = total * NP + (NP - 1 - rot);
        if (key > best[0]) best[0] = key;
      }
      block_max_lanes(best, part, red);
      best_key = red[0];
    }

    // -- the landing (one thread) ---------------------------------------------
    if (tid == 0) {
      int chosen = -1, row = 0, delta = 0;
      if (best_key >= 0) {
        const int chosen_rot = NP - 1 - (int)floor_mod(best_key, NP);
        chosen = (int)floor_mod(start + chosen_rot, num);
        row = chosen;
        for (int r = 0; r < f.R; ++r) p.req_r[(int64_t)row * f.R + r] += f.request[r];
        p.nonzero[2 * (int64_t)row] += f.nz_request[0];
        p.nonzero[2 * (int64_t)row + 1] += f.nz_request[1];
        p.pod_count[row] += 1;
        bool ok;
        int64_t sc, b;
        resource_eval_row(f, p.alloc_r + (int64_t)row * f.R, p.alloc_pods[row],
                          p.req_r + (int64_t)row * f.R, p.nonzero + 2 * (int64_t)row,
                          p.pod_count[row],
                          p.nom_req ? p.nom_req + (int64_t)row * f.R : nullptr,
                          p.nom_req ? p.nom_pods[row] : 0, ok, sc, b);
        p.fit_ok[row] = ok;
        p.fit_sc[row] = sc;
        p.ba[row] = b;
        for (int c = 0; c < p.C1; ++c) {
          const int v = gvid(p, p.dns_axis, c, row);
          const bool elig = v > 0 && (p.dns_honor_aff[c] != 1 || p.sel_ok[row]) &&
                            (p.dns_honor_taints[c] != 1 || p.taint_ok[row]);
          if (elig) p.dns_counts[(int64_t)c * p.V + v] += p.dns_self[c];
        }
        if (p.C2 && !gen_sa_ignored(p, row))
          for (int c = 0; c < p.C2; ++c)
            p.sa_counts[(int64_t)c * p.V + gvid(p, p.sa_axis, c, row)] += p.sa_self[c];
        for (int c = 0; c < p.A1; ++c) {
          const int v = gvid(p, p.anti_axis, c, row);
          if (v > 0) p.anti_counts[(int64_t)c * p.V + v] += p.anti_self[c];
        }
        for (int c = 0; c < p.A2; ++c) {
          const int v = gvid(p, p.aff_axis, c, row);
          if (v > 0) {
            p.aff_counts[(int64_t)c * p.V + v] += p.aff_self[c];
            s_aff_total += p.aff_self[c];
          }
        }
        for (int k = 0; k < p.KD; ++k) {
          const int v = gvid(p, p.ipa_axis, k, row);
          if (v > 0) p.ipa_delta[(int64_t)k * p.V + v] += p.ipa_wland[k];
        }
        if (p.blocked) p.blocked[row] = 1;
        if (p.aux_cnt) p.aux_cnt[row] += *p.aux_inc;
        if (p.incremental) {
          bool new_ok = p.static_ok[row] && ok && row < num && !(p.blocked && p.blocked[row]) &&
                        !(p.aux_cnt && p.aux_cnt[row] + *p.aux_inc > p.aux_room[row]);
          for (int c = 0; c < p.A1; ++c) {
            const int v = gvid(p, p.anti_axis, c, row);
            if (v > 0 && p.anti_counts[(int64_t)c * p.V + v] > 0) new_ok = false;
          }
          delta = (int)new_ok - (int)p.okd[row];
          p.okd[row] = new_ok;
        }
        if (p.carried)
          p.total[row] = w[0] * MAX_NODE_SCORE + w[1] * sc + w[4] * b + w[6] * p.il_score[row];
      }
      const int new_start = (int)floor_mod(start + evaluated, num);
      p.out[t] = chosen;
      p.out[p.B + t] = new_start;
      s_start = new_start;
      s_row = row;
      s_delta = delta;
    }
    __syncthreads();
    if (p.incremental && s_delta != 0) {
      const int row = s_row, delta = s_delta;
      for (int i = max(lo, row); i < hi; ++i) p.F[i] += delta;
    }
    __syncthreads();
  }
  // padded steps: nothing lands, the start stays
  for (int t = p.n_act + tid; t < p.B; t += nt) {
    p.out[t] = -1;
    p.out[p.B + t] = s_start;
  }
  if (tid == 0 && start_out != nullptr) *start_out = s_start;
}

