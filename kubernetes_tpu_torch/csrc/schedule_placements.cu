// schedule_placements: the JAX package's schedule_placements
// (kubernetes_tpu/ops/kernel.py:655-723), the stacked evaluation of a pod
// group against P candidate placements. Lane p is schedule_batch's greedy
// scan for the group's members restricted to placement p's rows: the
// batch's static mask and'ed with masks[p] (the JAX package's
// extra_ok & mask), from a fresh carry of the resident node state, rotation
// start 0 and no truncation (to_find = num_nodes), with the lane's own
// restricted spread tables where the caller gives them (dns_counts,
// dns_dom, dns_forced0, sa_counts, sa_wq per lane; otherwise the plan's).
// The caller's placement restriction
// (models/tpu_scheduler.py _placement_plan_restriction_invariant) leaves no
// inter-pod-affinity table and no base score in such a plan, so a lane
// carries only the spread tables. Results [P, 2, B]: chosen row or -1, the
// start after. No input is written.
//
// What bounds it. Each lane is the general scan's dependent chain of steps
// (scan_general.cu: ~5-7 us a step over 8192 rows, a chain of barriers and
// dependent loads) plus its fresh carry; the bytes are a lane's mask row
// and the fresh carry of its own rows. A placement holds a small share of
// the rows (SchedulingGangsPlacement: a zone of 100 nodes out of 1000 or
// 5000, groups of 4), so a lane that walks every row pays for rows that can
// never be feasible. The lanes run side by side, one block an SM, so a
// launch takes about as long as its slowest lane while P is at most the SM
// count (132 on an H100), in waves above.
//
// The design: one block of 512 threads a lane (grid P), running
// scan_general's step (gen_steps in scan_general.cuh) over its
// placement's rows only.
// - The prologue compacts the lane's mask row, and'ed with the static
//   mask, into an ascending list of original row ids: a ballot a 32-row
//   chunk, each warp a contiguous run of chunks, a block prefix of the
//   warps' counts. Rows outside the list are never feasible, so the ranks
//   over its positions equal the reference's; rows at or past num_nodes
//   stay out of it. Rotation, the selection key (total * NP +
//   NP - 1 - rot) and the window boundary use the original row; the start
//   is kept as a row and as the first position at or past it (a 32-way
//   search of the list), and a landed row's position is found the same way.
// - A lane's fresh carry covers its own rows: resource_eval_row (with the
//   nominated-pod lane) on each listed row once, into flags and carried
//   totals (or fit score and BalancedAllocation for normalized plans) by
//   position; its value ids and count tables are copied into the lane's
//   state. A landing's changes stay lane-private: every member requests
//   the same, so a row's aggregates are the resident state's plus k of
//   the lane's own pods, and only k (a position's landing count) is kept;
//   the blocked lane is k > 0 and the aux_cnt lane k * aux_inc.
// - Tiers: a lane plans its arrays for its own row count (lane_layout in
//   gen_sizes.h: the chunk masks, flags, the row list, the tables, the
//   value ids, the totals or scores, the landing counts) in the launch's
//   shared memory, and what does not fit in its slice of a device-memory
//   scratch, lane_bytes a lane. The wrapper allocates the scratch only when
//   its widest lane can need it (17 bytes a row with a carried score and no
//   table, 41 with a spread and a ScheduleAnyway table and normalized
//   scores: past ~13000 or ~5000 rows); the launcher refuses a slice
//   shorter than lane_layout's.
// - A padded lane (an empty mask) and n_act = 0 land nothing and keep start
//   0: the block leaves after the compaction.
#include "scan_general.cuh"

// The lane tables' sources: [C, V] / [C] shared by every lane, or
// [P, C, V] / [P, C] one per lane (per_lane).
struct LaneTables {
  int per_lane;
  const int32_t* dns_counts;
  const uint8_t* dns_dom;
  const int32_t* dns_forced0;
  const int32_t* sa_counts;
  const int64_t* sa_wq;
};

__device__ __forceinline__ unsigned char* lane_at(int off, unsigned char* smem,
                                                  unsigned char* slice) {
  return off >= 0 ? smem + off : slice + ~off;
}

template <bool CARRIED, bool INCR>
__global__ void __launch_bounds__(GEN2_THREADS, 1) schedule_placements_kernel(
    ResFeat f, GenPlan base, LaneTables tab, const uint8_t* __restrict__ masks,
    const int32_t* __restrict__ num_nodes_p, unsigned char* scratch, int stride, int budget) {
  extern __shared__ __align__(16) unsigned char gen_smem[];
  __shared__ GenShared S;
  __shared__ int wcnt[GEN2_WARPS];
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, w = tid >> 5;
  constexpr int nw = GEN2_WARPS, ms = GEN2_WARPS + 1;
  const int64_t lid = blockIdx.x;
  const int NP = base.NP, R = f.R, V = base.V, C1 = base.C1, C2 = base.C2;
  const int num = max(*num_nodes_p, 1);
  const int nrows = imin(NP, num);
  GenPlan p = base;
  p.out = base.out + lid * 2 * base.B;
  if (tab.per_lane) {
    p.dns_forced0 = tab.dns_forced0 + lid * C1;
    p.sa_wq = tab.sa_wq + lid * C2;
  }
  const uint8_t* mrow = masks + lid * NP;

  // -- the compaction: warp w counts the rows of its chunks ---------------------
  const int nchunks = (nrows + 31) / 32, cpw = (nchunks + nw - 1) / nw;
  const int k0 = w * cpw, k1 = imin(nchunks, k0 + cpw);
  int cnt = 0;
  for (int k = k0; k < k1; ++k) {
    const int r = 32 * k + lane;
    cnt += __popc(__ballot_sync(FULL, r < nrows && mrow[r] && p.static_ok[r]));
  }
  if (lane == 0) wcnt[w] = cnt;
  __syncthreads();
  int n = 0, pos = 0;
  for (int k = 0; k < nw; ++k) {
    pos += k < w ? wcnt[k] : 0;
    n += wcnt[k];
  }
  if (n == 0 || p.n_act == 0) {  // a padded lane or no member: nothing lands, start 0
    for (int t = tid; t < p.B; t += nt) {
      p.out[t] = -1;
      p.out[p.B + t] = 0;
    }
    return;
  }
  const LaneLayout L = lane_layout(n, V, C1, C2, CARRIED, (size_t)budget);
  unsigned char* const slice = scratch != nullptr ? scratch + lid * (int64_t)stride : nullptr;
  int32_t* const rows = (int32_t*)lane_at(L.rows, gen_smem, slice);
  // ... then writes them, in ascending order, at its warp's offset.
  for (int k = k0; k < k1; ++k) {
    const int r = 32 * k + lane;
    const bool in = r < nrows && mrow[r] && p.static_ok[r];
    const uint32_t b = __ballot_sync(FULL, in);
    if (in) rows[pos + __popc(b & ((1u << lane) - 1u))] = r;
    pos += __popc(b);
  }
  // -- where the lane's arrays live -------------------------------------------------
  const int kw = ((n + 31) / 32 + nw - 1) / nw;
  if (tid == 0) {
    S.rows = rows;
    S.n = n;
    S.flags = lane_at(L.flags, gen_smem, slice);
    S.mask = (uint32_t*)lane_at(L.mask, gen_smem, slice);
    S.pfx = (int*)(S.mask + kw * ms);
    S.total = CARRIED ? (int64_t*)lane_at(L.total, gen_smem, slice) : nullptr;
    S.fsc = CARRIED ? nullptr : (int64_t*)lane_at(L.fsc, gen_smem, slice);
    S.fba = CARRIED ? nullptr : (int64_t*)lane_at(L.fba, gen_smem, slice);
    S.land = (int32_t*)lane_at(L.land, gen_smem, slice);
    S.start = S.cstart = S.bound = 0;
    S.aff_total = 0;
  }
  for (int c = tid; c < C1; c += nt) {
    S.cnt[K_DNS * GEN_MAXC + c] = (int32_t*)lane_at(L.cnt[c], gen_smem, slice);
    S.dom[c] = lane_at(L.dom[c], gen_smem, slice);
    S.vid[K_DNS * GEN_MAXC + c] = (const int32_t*)lane_at(L.vid[c], gen_smem, slice);
  }
  for (int c = tid; c < C2; c += nt) {
    S.cnt[K_SA * GEN_MAXC + c] = (int32_t*)lane_at(L.cnt[GEN_MAXC + c], gen_smem, slice);
    S.vid[K_SA * GEN_MAXC + c] = (const int32_t*)lane_at(L.vid[GEN_MAXC + c], gen_smem, slice);
  }
  __syncthreads();
  // -- the lane's tables ------------------------------------------------------------
  const int64_t t1 = tab.per_lane ? lid * C1 * V : 0, t2 = tab.per_lane ? lid * C2 * V : 0;
  for (int c = 0; c < C1; ++c) {
    int32_t* cnt_c = S.cnt[K_DNS * GEN_MAXC + c];
    uint8_t* dom_c = (uint8_t*)S.dom[c];
    for (int v = tid; v < V; v += nt) {
      cnt_c[v] = tab.dns_counts[t1 + (int64_t)c * V + v];
      dom_c[v] = tab.dns_dom[t1 + (int64_t)c * V + v];
    }
  }
  for (int c = 0; c < C2; ++c) {
    int32_t* cnt_c = S.cnt[K_SA * GEN_MAXC + c];
    for (int v = tid; v < V; v += nt) cnt_c[v] = tab.sa_counts[t2 + (int64_t)c * V + v];
  }
  // -- the fresh carry of the lane's rows (schedule_batch :525-536) ---------------
  const int aux_inc = p.aux_on ? *p.aux_inc : 0;
  const int64_t* wt = p.weights;
  for (int i = tid; i < n; i += nt) {
    const int r = rows[i];
    bool ok;
    int64_t sc, b;
    resource_eval_row(f, p.alloc_r + (int64_t)r * R, p.alloc_pods[r], p.req_r + (int64_t)r * R,
                      p.nonzero + 2 * (int64_t)r, p.pod_count[r],
                      p.nom_req ? p.nom_req + (int64_t)r * R : nullptr,
                      p.nom_req ? p.nom_pods[r] : 0, ok, sc, b);
    if (p.aux_on && aux_inc > p.aux_room[r]) ok = false;  // a fresh aux_cnt lane is 0
    uint8_t fl = ok ? GF_OK : 0;
    for (int c = 0; c < C1; ++c)
      ((int32_t*)S.vid[K_DNS * GEN_MAXC + c])[i] = p.topo[(int64_t)p.dns_axis[c] * NP + r];
    if (C2) {
      bool ign = !p.sel_ok[r];
      for (int c = 0; c < C2; ++c) {
        const int v = p.topo[(int64_t)p.sa_axis[c] * NP + r];
        ((int32_t*)S.vid[K_SA * GEN_MAXC + c])[i] = v;
        ign = ign || v <= 0;
      }
      if (ign) fl |= GF_SA_IGN;
    }
    S.flags[i] = fl;
    if (CARRIED) {
      S.total[i] = wt[0] * MAX_NODE_SCORE + wt[1] * sc + wt[4] * b + wt[6] * p.il_score[r];
    } else {
      S.fsc[i] = sc;
      S.fba[i] = b;
    }
    S.land[i] = 0;
  }
  __syncthreads();
  for (int c = w; c < C1; c += nw) gen_rescan(S, p, c, lane);
  __syncthreads();

  gen_steps<CARRIED, INCR, true>(f, p, S, num, *num_nodes_p, 0, aux_inc);

  const int final_start = S.start;  // padded steps: nothing lands, the start stays
  for (int t = p.n_act + tid; t < p.B; t += nt) {
    p.out[t] = -1;
    p.out[p.B + t] = final_start;
  }
}

typedef void (*LaneKernel)(ResFeat, GenPlan, LaneTables, const uint8_t*, const int32_t*,
                           unsigned char*, int, int);

extern "C" int launch_schedule_placements(
    int NP, int R, int FR, int fit_strategy, int P, int B, int n_act, int V, int C1, int C2,
    int incremental, int carried, int has_pns, int has_na_pref, int per_lane,
    int port_selfblock, int has_aux, int rows_cap,
    const int64_t* request, const int64_t* nz_request, const int64_t* has_request,
    const int64_t* ba_skip, const int32_t* enable, const int32_t* fit_slots,
    const int64_t* fit_weights, const int64_t* alloc_r, const int64_t* alloc_pods,
    const int64_t* req_r, const int64_t* nonzero, const int32_t* pod_count,
    OPTIONAL const int64_t* nom_req, OPTIONAL const int32_t* nom_pods, const bool* static_ok,
    const bool* sel_ok, const bool* taint_ok, const int64_t* pns_cnt, const bool* masks,
    const int32_t* topo, const int64_t* il_score, const int64_t* na_raw,
    const int64_t* weights, const int32_t* num_nodes, const int32_t* dns_axis,
    const int32_t* dns_active, const int64_t* dns_max_skew, const int32_t* dns_self,
    const int32_t* dns_forced0, const int32_t* dns_honor_aff, const int32_t* dns_honor_taints,
    const bool* dns_dom, const int32_t* dns_counts, const int32_t* sa_axis,
    const int64_t* sa_wq, const int64_t* sa_skew, const int32_t* sa_self,
    const int32_t* sa_counts, const int32_t* aux_room, const int32_t* aux_inc,
    int lane_bytes, OPTIONAL uint8_t* lane_scratch, int32_t* out, cudaStream_t stream) {
  if (NP <= 0 || P <= 0 || C1 < 0 || C2 < 0 || C1 > GEN_MAXC || C2 > GEN_MAXC || V <= 0 ||
      rows_cap < 0 || rows_cap > NP)
    return (int)cudaErrorInvalidValue;
  // Every array of a lane of rows_cap rows in device memory: what a lane of
  // the launch may need past its shared memory. The scratch, where there is
  // one, holds a slice of lane_bytes a lane, which must hold all of it.
  const size_t all = lane_layout(rows_cap, V, C1, C2, carried != 0, 0).off_chip;
  const size_t smem = all < GEN2_SMEM_MAX ? all : GEN2_SMEM_MAX;
  if (all > smem && (lane_scratch == nullptr || lane_bytes < 0 || (size_t)lane_bytes < all))
    return (int)cudaErrorInvalidValue;
  ResFeat f{request, nz_request, has_request, ba_skip, enable, fit_slots, fit_weights,
            R, FR, fit_strategy};
  // The shared inputs; each block points at its lane's tables and results.
  GenPlan p{};
  p.NP = NP;
  p.B = B;
  p.n_act = n_act;
  p.V = V;
  p.C1 = C1;
  p.C2 = C2;
  p.incremental = incremental;
  p.carried = carried;
  p.has_pns = has_pns;
  p.has_na_pref = has_na_pref;
  p.blocked_on = port_selfblock;
  p.aux_on = has_aux;
  p.alloc_r = alloc_r;
  p.alloc_pods = alloc_pods;
  p.req_r = const_cast<int64_t*>(req_r);  // read only: a lane keeps its landings apart
  p.nonzero = const_cast<int64_t*>(nonzero);
  p.pod_count = const_cast<int32_t*>(pod_count);
  p.nom_req = nom_req;
  p.nom_pods = nom_pods;
  p.aux_room = aux_room;
  p.aux_inc = aux_inc;
  p.static_ok = (const uint8_t*)static_ok;
  p.sel_ok = (const uint8_t*)sel_ok;
  p.taint_ok = (const uint8_t*)taint_ok;
  p.pns_cnt = pns_cnt;
  p.topo = topo;
  p.il_score = il_score;
  p.na_raw = na_raw;
  p.weights = weights;
  p.dns_axis = dns_axis;
  p.dns_active = dns_active;
  p.dns_max_skew = dns_max_skew;
  p.dns_self = dns_self;
  p.dns_forced0 = dns_forced0;
  p.dns_honor_aff = dns_honor_aff;
  p.dns_honor_taints = dns_honor_taints;
  p.sa_axis = sa_axis;
  p.sa_wq = sa_wq;
  p.sa_skew = sa_skew;
  p.sa_self = sa_self;
  p.out = out;
  LaneTables tab{per_lane, dns_counts, (const uint8_t*)dns_dom, dns_forced0, sa_counts, sa_wq};
  LaneKernel kern = carried ? (incremental ? schedule_placements_kernel<true, true>
                                           : schedule_placements_kernel<true, false>)
                            : (incremental ? schedule_placements_kernel<false, true>
                                           : schedule_placements_kernel<false, false>);
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<P, GEN2_THREADS, smem, stream>>>(f, p, tab, (const uint8_t*)masks, num_nodes,
                                          lane_scratch, lane_bytes, (int)smem);
  return (int)cudaGetLastError();
}
