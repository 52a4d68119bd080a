// schedule_placements: the JAX package's schedule_placements
// (ops/kernel.py:655-723), the stacked evaluation of a pod group against
// P candidate placements. Lane p is schedule_batch's greedy scan for the
// group's members restricted to placement p's rows: the batch's static mask
// and'ed with masks[p] (the JAX package's extra_ok & mask), from a fresh
// carry of the resident node state, rotation start 0 and no truncation
// (to_find = num_nodes), with the lane's own restricted spread tables where
// the caller gives them (dns_counts, dns_dom, dns_forced0, sa_counts,
// sa_wq per lane; otherwise the plan's). The caller's placement restriction
// (models/tpu_scheduler.py _placement_plan_restriction_invariant) leaves
// no inter-pod-affinity table and no base score in such a plan, so a lane
// carries only the spread tables.
//
// One block per lane (gridDim.x = P) of GEN_BLOCK threads. The block first
// writes its lane's copy of the fresh carry into its own slice of the
// scratch: the node aggregates, each row's fit verdict and scores through
// resource_eval_row (the nominated-pod lane where the plan has one), its
// static mask, its spread tables and, for a plan whose members request host
// ports (blocked_s non-null), its blocked lane, empty as in a fresh carry,
// which only its own members' landings set, and for a plan whose claims
// count against a CSI attach limit (aux_cnt_s non-null) its aux_cnt lane,
// zero as in a fresh carry, which only its own members' landings add to;
// then it runs gen_scan
// (scan_general.cuh), the step scan_general runs, on that slice, and
// writes results[p] ([2, B]: chosen row or -1, start after). A lane reads
// only the shared inputs and writes only its own slice, so lanes never
// see each other and no input is written: the simulations leave the
// resident state as it was. Padded lanes (an all-false mask) and n_act = 0
// land nothing and keep start 0.
//
// Bound: per lane, the fresh-carry copy (~110 B a row at R = 7) and
// gen_scan's steps (a pass over the rows each, a reduction or two); lanes
// run side by side on the SMs, so a launch takes about as long as its
// slowest lane when P is at most the SM count. Scratch: P x NP x (8R + 51)
// bytes plus P x (C1 + C2) x V x 4 for the tables (~57 MB at P 64,
// NP 8192, R 7, no tables).
#include "scan_general.cuh"

struct LaneScratch {
  int64_t* req_r;       // [P, NP, R]
  int64_t* nonzero;     // [P, NP, 2]
  int32_t* pod_count;   // [P, NP]
  uint8_t* fit_ok;      // [P, NP]
  int64_t* fit_sc;      // [P, NP]
  int64_t* ba;          // [P, NP]
  uint8_t* static_ok;   // [P, NP]
  uint8_t* okd;         // [P, NP]
  int32_t* F;           // [P, NP]
  int64_t* total;       // [P, NP]
  int32_t* dns_counts;  // [P, C1, V]
  int32_t* sa_counts;   // [P, C2, V]
  uint8_t* blocked;     // [P, NP], or null: no host ports
  int32_t* aux_cnt;     // [P, NP], or null: no counted attach limit
};

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

__global__ void __launch_bounds__(GEN_BLOCK) schedule_placements_kernel(
    ResFeat f, GenPlan base, LaneScratch s, LaneTables tab,
    const uint8_t* __restrict__ static_ok, const uint8_t* __restrict__ masks,
    const int32_t* __restrict__ num_nodes_p) {
  const int64_t lane = blockIdx.x;
  const int NP = base.NP, R = f.R, V = base.V, C1 = base.C1, C2 = base.C2;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int64_t row0 = lane * NP;

  GenPlan p = base;
  p.req_r = s.req_r + row0 * R;
  p.nonzero = s.nonzero + row0 * 2;
  p.pod_count = s.pod_count + row0;
  p.fit_ok = s.fit_ok + row0;
  p.fit_sc = s.fit_sc + row0;
  p.ba = s.ba + row0;
  p.static_ok = s.static_ok + row0;
  p.okd = s.okd + row0;
  p.F = s.F + row0;
  p.total = s.total + row0;
  p.out = base.out + lane * 2 * base.B;
  p.dns_counts = s.dns_counts + lane * C1 * V;
  p.sa_counts = s.sa_counts + lane * C2 * V;
  p.blocked = s.blocked ? s.blocked + row0 : nullptr;
  p.aux_cnt = s.aux_cnt ? s.aux_cnt + row0 : nullptr;
  const int64_t t1 = tab.per_lane ? lane * C1 * V : 0, t2 = tab.per_lane ? lane * C2 * V : 0;
  p.dns_dom = tab.dns_dom + t1;
  p.dns_forced0 = tab.dns_forced0 + (tab.per_lane ? lane * C1 : 0);
  p.sa_wq = tab.sa_wq + (tab.per_lane ? lane * C2 : 0);

  // -- the lane's fresh carry (schedule_batch :525-536 with carry_in None) --
  const uint8_t* mask = masks + row0;
  uint8_t* lane_ok = s.static_ok + row0;
  for (int i = tid; i < NP; i += nt) {
    const int64_t* req = base.req_r + (int64_t)i * R;
    for (int r = 0; r < R; ++r) p.req_r[(int64_t)i * R + r] = req[r];
    p.nonzero[2 * (int64_t)i] = base.nonzero[2 * (int64_t)i];
    p.nonzero[2 * (int64_t)i + 1] = base.nonzero[2 * (int64_t)i + 1];
    p.pod_count[i] = base.pod_count[i];
    bool ok;
    int64_t sc, b;
    resource_eval_row(f, base.alloc_r + (int64_t)i * R, base.alloc_pods[i], req,
                      base.nonzero + 2 * (int64_t)i, base.pod_count[i],
                      base.nom_req ? base.nom_req + (int64_t)i * R : nullptr,
                      base.nom_req ? base.nom_pods[i] : 0, ok, sc, b);
    p.fit_ok[i] = ok;
    p.fit_sc[i] = sc;
    p.ba[i] = b;
    lane_ok[i] = static_ok[i] && mask[i];
    if (p.blocked) p.blocked[i] = 0;
    if (p.aux_cnt) p.aux_cnt[i] = 0;
  }
  for (int64_t k = tid; k < (int64_t)C1 * V; k += nt) p.dns_counts[k] = tab.dns_counts[t1 + k];
  for (int64_t k = tid; k < (int64_t)C2 * V; k += nt) p.sa_counts[k] = tab.sa_counts[t2 + k];
  __syncthreads();

  const int num = max(*num_nodes_p, 1);
  gen_scan(f, p, num, *num_nodes_p, 0, nullptr);
}

extern "C" int launch_schedule_placements(
    int NP, int R, int FR, int fit_strategy, int P, int B, int n_act, int V, int C1, int C2,
    int incremental, int carried, int has_pns, int has_na_pref, int per_lane,
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
    const int32_t* sa_counts, int64_t* req_r_s, int64_t* nonzero_s, int32_t* pod_count_s,
    bool* fit_ok_s, int64_t* fit_sc_s, int64_t* ba_s, bool* static_ok_s, uint8_t* okd_s,
    int32_t* F_s, int64_t* total_s, int32_t* dns_counts_s, int32_t* sa_counts_s,
    OPTIONAL bool* blocked_s, OPTIONAL int32_t* aux_cnt_s, const int32_t* aux_room,
    const int32_t* aux_inc, int32_t* out, cudaStream_t stream) {
  if (NP <= 0 || P <= 0 || C1 > GEN_MAXC || C2 > GEN_MAXC) return (int)cudaErrorInvalidValue;
  ResFeat f{request, nz_request, has_request, ba_skip, enable, fit_slots, fit_weights,
            R, FR, fit_strategy};
  // The shared inputs: the resident aggregates in the carry lanes (each
  // block copies them into its slice); no inter-pod-affinity table. The
  // per-lane pointers are set by each block.
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
  p.alloc_r = alloc_r;
  p.alloc_pods = alloc_pods;
  p.req_r = const_cast<int64_t*>(req_r);
  p.nonzero = const_cast<int64_t*>(nonzero);
  p.pod_count = const_cast<int32_t*>(pod_count);
  p.nom_req = nom_req;
  p.nom_pods = nom_pods;
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
  p.dns_honor_aff = dns_honor_aff;
  p.dns_honor_taints = dns_honor_taints;
  p.sa_axis = sa_axis;
  p.sa_skew = sa_skew;
  p.sa_self = sa_self;
  p.aux_room = aux_room;
  p.aux_inc = aux_inc;
  p.out = out;
  LaneScratch s{req_r_s, nonzero_s, pod_count_s, (uint8_t*)fit_ok_s, fit_sc_s, ba_s,
                (uint8_t*)static_ok_s, okd_s, F_s, total_s, dns_counts_s, sa_counts_s,
                (uint8_t*)blocked_s, aux_cnt_s};
  LaneTables tab{per_lane, dns_counts, (const uint8_t*)dns_dom, dns_forced0, sa_counts, sa_wq};
  schedule_placements_kernel<<<P, GEN_BLOCK, 0, stream>>>(
      f, p, s, tab, (const uint8_t*)static_ok, (const uint8_t*)masks, num_nodes);
  return (int)cudaGetLastError();
}
