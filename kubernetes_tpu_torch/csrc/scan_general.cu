// scan_general: the JAX package's schedule_batch scan `step` and
// `feasibility_proj` (ops/kernel.py:314-523) with the prologue (:545-575)
// for every plan that the lap and scan_schedule do not cover: PodTopologySpread
// DoNotSchedule skew (count tables [C1, V] with the _BIG / dns_forced0
// minimum), ScheduleAnyway scoring ([C2, V]), InterPodAffinity required
// anti-affinity ([A1, V]) and affinity with the bootstrap case ([A2, V]),
// landing score deltas ([KD, V]), and the kept-set normalized score lanes
// (PreferNoSchedule reverse-normalized, spread min/max, inter-pod min/max,
// preferred node affinity) beside the static ImageLocality term.
//
// One persistent single-block kernel runs all active steps of a batch. Per
// step:
//   1. (full feasibility) each spread constraint's minimum over its
//      eligible domains, then every row's feasibility and a block prefix sum
//      of the feasible rows; with incremental feasibility the landed row's
//      verdict is patched and the prefix sum's tail shifted instead;
//   2. rank in rotation order, the kept set (rank <= to_find), and one
//      block max-reduction of eight int64 lanes: the window boundary, the
//      normalization maxima (minima ride negated), and — when the score is
//      carried — the packed key total*NP + (NP-1-rot);
//   3. (normalized scores) a second pass assembles each kept row's total
//      and a second reduction selects the packed key;
//   4. one thread lands the pod: the row's aggregates and fit/score lanes
//      (the fit filter counting the row's nominated pods when the plan has
//      a nominated-pod lane, :448),
//      the +1 (or +weight) at the row's value of every table, the row's
//      blocked flag when the plan's pods request host ports (blocked
//      non-null; a blocked row is infeasible, :322-323, :485-498), the
//      row's attachments when the plan's claims count against a CSI attach
//      limit (aux_cnt non-null: aux_inc added at the landed row, and a row
//      whose aux_cnt + aux_inc exceeds its aux_room is infeasible, :324-325,
//      :487-488, :497-498), the carried total and the next rotation start.
// Padded steps land nothing and keep the start, so the loop ends at n_act
// and the rest of the results are filled.
//
// The JAX package carries per-node projections of every table (mnum, scnt,
// acnt, fcnt, dproj) to avoid gathers, which serialize on a TPU. Here the
// projection of row i is read from the table at the row's value id,
// table[c * V + topo[axis[c] * NP + i]]: the same number by construction
// (a landing adds to the table at the landed row's value, and a projection
// changes exactly where the row shares that value), and a gather from a
// table of a few KB to a few hundred KB that stays in L1/L2 costs no more
// than the projection's own load. The tables stay in device memory: at
// V = 8192 (a hostname axis) and several tables they do not fit the 227 KB
// of shared memory, and a step touches only the rows' own entries.
//
// Bound: a dependent sequence of steps, each one or two passes over the
// node rows (~20-60 B a row, depending on the live lanes) and two to four
// block reductions; the single block keeps every reduction in shared memory
// without a grid synchronisation, at the cost of using one SM. Counts are
// int32 (pods per domain) and every score is int64, as in the JAX package;
// Python's floored // and % are floor_div / floor_mod.
//
// The step itself is gen_scan in scan_general.cuh, which schedule_placements
// runs once per candidate placement.
#include "scan_general.cuh"

__global__ void __launch_bounds__(GEN_BLOCK) scan_general_kernel(
    ResFeat f, GenPlan p, const int32_t* __restrict__ num_nodes_p,
    const int32_t* __restrict__ to_find_p, const int32_t* __restrict__ start_p,
    int32_t* start_out) {
  gen_scan(f, p, max(*num_nodes_p, 1), *to_find_p, *start_p, start_out);
}

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
  if (NP <= 0 || C1 > GEN_MAXC) return (int)cudaErrorInvalidValue;
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
  scan_general_kernel<<<1, GEN_BLOCK, 0, stream>>>(f, p, num_nodes, to_find, start, start_out);
  return (int)cudaGetLastError();
}
