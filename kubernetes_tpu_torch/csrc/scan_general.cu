// scan_general: the JAX package's schedule_batch scan `step` and
// `feasibility_proj` (kubernetes_tpu/ops/kernel.py:314-523) with the
// prologue (:545-575) for every plan that the lap does not take: PodTopologySpread
// DoNotSchedule skew (count tables [C1, V] with the _BIG / dns_forced0
// minimum), ScheduleAnyway scoring ([C2, V]), InterPodAffinity required
// anti-affinity ([A1, V]) and affinity with the bootstrap case ([A2, V]),
// landing score deltas ([KD, V]), and the kept-set normalized score lanes
// (PreferNoSchedule reverse-normalized, spread min/max, inter-pod min/max,
// preferred node affinity) beside the static ImageLocality term; the
// nominated-pod, blocked and aux_cnt lanes as in the lap (:322-325, :448,
// :485-498). Row-local plans of at most 64 steps (the reference's scan
// path for them, :273) take it too: their plan is its incremental, carried
// mode.
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
// TopologySpreading's next batch at NP 8192 and ~5.3 us on a row-local
// plan, which filters no table: that floor, not rows or bytes, bounds the
// batch.
//
// The design, point by point (the step itself is gen_steps in
// scan_general.cuh, shared with schedule_placements, which runs it over a
// placement's rows only; this kernel runs it over the identity map):
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
//   and landing deltas take any count) stay in device memory; only the
//   spread constraints are capped at GEN_MAXC.
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
//   table for the count updates (tables k, k + 32, ... past 32). All
//   arithmetic is the reference's: int32 counts, int64 scores, Python's
//   floored // and % as floor_div / floor_mod.
// The plan's value tier V may be up to 8192 (a hostname axis); a table of
// that width is 32 KB, so a few fit beside the rows at NP 8192. At NP
// 16384 (SchedulingDaemonset's 15000 nodes) a zone spread's whole state
// fits (~218 KB); with a hostname table the totals stay in device memory.
// A thread-block cluster is not needed for that.
#include "scan_general.cuh"

// Where each array of a launch lives: a byte offset into the block's
// dynamic shared memory, or -1 for device memory. Planned by gen_layout.
struct GenLayout {
  int mask, flags, total;
  int cnt[GEN2_TABLES];
  int vid[GEN2_TABLES];
  int dom[GEN_MAXC];
  int bytes;
};

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
  const int nrows = imin(NP, num);  // rows at or past num are never feasible
  const int kw = ((nrows + 31) / 32 + nw - 1) / nw;
  const int aux_inc = p.aux_on ? *p.aux_inc : 0;
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
    S.rows = nullptr;  // the identity map
    S.n = nrows;
    S.flags = L.flags >= 0 ? gen_smem + L.flags : p.okd;
    S.mask = L.mask >= 0 ? (uint32_t*)(gen_smem + L.mask) : (uint32_t*)p.F;
    S.pfx = (int*)(S.mask + kw * ms);
    S.total = L.total >= 0 ? (int64_t*)(gen_smem + L.total) : p.total;
    S.fsc = p.fit_sc;
    S.fba = p.ba;
    S.land = nullptr;
    S.start = S.cstart = *start_p;
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
    if (p.blocked_on && p.blocked[i]) ok = false;
    if (p.aux_on && p.aux_cnt[i] + aux_inc > p.aux_room[i]) ok = false;
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

  gen_steps<CARRIED, INCR, false>(f, p, S, num, *to_find_p, aff_own_all, aux_inc);

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
            has_ipa_base, has_na_pref, blocked != nullptr, aux_cnt != nullptr, alloc_r,
            alloc_pods, req_r, nonzero, pod_count, nom_req, nom_pods, (uint8_t*)blocked,
            aux_cnt, aux_room, aux_inc, (uint8_t*)fit_ok, fit_sc, ba,
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
