// lap_schedule: the JAX package's _lap_schedule (ops/kernel.py:799-925) as
// ONE persistent single-block kernel that runs the whole while_loop.
//
// With adaptive sampling, pod i examines the window of the first to_find
// feasible rows after its start index and pod i+1's window begins where
// pod i's ended; with no cross-row coupling a landing changes only its own
// row, so the L = total_feasible / to_find windows of one lap are
// independent and one segmented argmax places L pods. Each lap:
//   1. re-evaluates fit, fit score and BalancedAllocation on every row;
//   2. takes a block prefix sum of the feasible rows (row order);
//   3. ranks rows in rotation order from `start` and assigns each feasible
//      row to window (rank-1)/to_find, window LAP_MAX being the dump lane;
//   4. takes each window's max of the packed key total*NP + (NP-1-rot)
//      (max score, then first in rotation) and its boundary min with
//      shared-memory atomics;
//   5. applies the landings and emits (row, start_after) per window.
// After the loop the carry's fit/score lanes are evaluated once more.
// With a nominated-pod lane (nom_req non-null) every evaluation counts the
// row's nominated pods against the fit filter (:840, :919).
//
// A plan whose pods request host ports (port_selfblock) passes the carry's
// `blocked` lane (non-null): a blocked row is infeasible, read once a lap
// before the prefix sum (:843-844), and each landing blocks its row after
// the landings are applied (:887-888). No two windows of a lap share a row,
// so a lap's own landings never block a window of the same lap; the dump
// lane LAP_MAX never lands and never blocks.
//
// A plan whose pods' claims count against a CSI attach limit (has_aux)
// passes the carry's `aux_cnt` lane (non-null) with the batch's `aux_room`
// [NP] and `aux_inc`: a row is infeasible once aux_cnt + aux_inc exceeds its
// room, read once a lap beside the blocked flag (:845-846), and each landing
// adds aux_inc at its row (:889-890). A lap lands at most one pod on a row,
// so one add a landing is exact; the dump lane LAP_MAX never writes it. The
// lane is int32: the room is at most 1 << 30 and the count stays far below
// 2^31.
//
// Required anti-affinity on a singleton-per-node axis (hostname) rides the
// lap too (:818-820, :847-849, :891-899): a row is infeasible while its own
// value's count in anti_counts [A1, V] is positive, and each landing adds
// the term's anti_self at the landed row's value. No two windows share a
// row, and on such an axis no two rows share a value, so a lap's landings
// never block a window of the same lap; the counts are read afresh each lap.
//
// Bound: the laps are a dependent sequence (~B*to_find/N of them); per lap
// the block streams the node tensors (~80 B per row at R=7) from L2. One
// block keeps every lap's reductions inside shared memory with no grid
// synchronisation; the cost is that only one SM works. Faster multi-block
// forms are later work.
#include "kernels.cuh"

__global__ void __launch_bounds__(KTT_BLOCK) lap_schedule_kernel(
    ResFeat f, const int64_t* __restrict__ alloc_r, const int64_t* __restrict__ alloc_pods,
    int64_t* req_r, int64_t* nonzero, int32_t* pod_count,
    const int64_t* __restrict__ nom_req, const int32_t* __restrict__ nom_pods,
    uint8_t* blocked, int32_t* aux_cnt, const int32_t* __restrict__ aux_room,
    const int32_t* __restrict__ aux_inc_p, const uint8_t* __restrict__ static_ok,
    const int64_t* __restrict__ il_score,
    const int64_t* __restrict__ weights, const int32_t* __restrict__ num_nodes_p,
    const int32_t* __restrict__ to_find_p, const int32_t* __restrict__ start_p,
    int NP, int B, int n_act, int A1, int V, const int32_t* __restrict__ topo,
    const int32_t* __restrict__ anti_axis, const int32_t* __restrict__ anti_self,
    int32_t* anti_counts, uint8_t* okd_s, int32_t* F_s, int64_t* total_s,
    int32_t* out, uint8_t* fit_ok_out, int64_t* fit_sc_out, int64_t* ba_out,
    int32_t* start_out) {
  __shared__ int scan_sm[KTT_BLOCK];
  __shared__ long long key_w[LAP_MAX];
  __shared__ int ev_w[LAP_MAX];
  __shared__ int s_start, s_done, s_total;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int rpt = (NP + nt - 1) / nt;
  const int lo = min(tid * rpt, NP), hi = min(lo + rpt, NP);
  const int num = max(*num_nodes_p, 1);
  const int tf = max(*to_find_p, 1);
  const int64_t w_tt = weights[0], w_fit = weights[1], w_ba = weights[4], w_il = weights[6];
  const int32_t aux_inc = *aux_inc_p;
  if (tid == 0) {
    s_start = *start_p;
    s_done = 0;
  }
  __syncthreads();
  while (true) {
    const int done = s_done;
    if (done >= n_act) break;
    const int start = s_start;
    // 1. dense per-lap re-evaluation
    int cnt = 0;
    for (int i = lo; i < hi; ++i) {
      bool ok;
      int64_t sc, ba;
      resource_eval_row(f, alloc_r + (int64_t)i * f.R, alloc_pods[i], req_r + (int64_t)i * f.R,
                        nonzero + 2 * (int64_t)i, pod_count[i],
                        nom_req ? nom_req + (int64_t)i * f.R : nullptr,
                        nom_req ? nom_pods[i] : 0, ok, sc, ba);
      bool okd = static_ok[i] && ok && i < num && !(blocked && blocked[i]) &&
                 !(aux_cnt && aux_cnt[i] + aux_inc > aux_room[i]);
      for (int c = 0; c < A1 && okd; ++c) {
        const int v = topo[(int64_t)anti_axis[c] * NP + i];
        if (v > 0 && anti_counts[(int64_t)c * V + v] > 0) okd = false;
      }
      okd_s[i] = okd;
      total_s[i] = w_tt * MAX_NODE_SCORE + w_fit * sc + w_ba * ba + w_il * il_score[i];
      cnt += okd;
    }
    if (tid < LAP_MAX) {
      key_w[tid] = -1;
      ev_w[tid] = num;
    }
    // 2. prefix sum of feasible rows in row order
    const int incl = block_inclusive_scan(cnt, scan_sm);
    if (tid == nt - 1) s_total = incl;
    int run = incl - cnt;
    for (int i = lo; i < hi; ++i) {
      run += okd_s[i];
      F_s[i] = run;
    }
    __syncthreads();
    const int total_feas = s_total;
    const int f_start = start > 0 ? F_s[start - 1] : 0;
    int L = min(total_feas / tf, n_act - done);
    L = max(1, min(L, LAP_MAX));
    // 3-4. windows, packed-key maxima and boundary minima
    for (int i = lo; i < hi; ++i) {
      if (!okd_s[i]) continue;
      const int rank = i >= start ? F_s[i] - f_start : F_s[i] + total_feas - f_start;
      const int rot = (int)floor_mod(i - start, num);
      const int w = (int)min(floor_div(rank - 1, tf), (int64_t)LAP_MAX);
      if (w < L) atomicMax(&key_w[w], (long long)(total_s[i] * NP + (NP - 1 - rot)));
      if (floor_mod(rank, tf) == 0) {
        const int sb = (int)min(floor_div(rank, tf) - 1, (int64_t)LAP_MAX);
        if (sb < LAP_MAX) atomicMin(&ev_w[sb], rot + 1);
      }
    }
    __syncthreads();
    // 5. landings: windows are disjoint, so each row takes at most one pod
    if (tid < LAP_MAX) {
      const int w = tid;
      const long long kw = key_w[w];
      const bool has = w < L && kw >= 0;
      const int rot_w = NP - 1 - (int)floor_mod(kw, NP);
      const int row = has ? (int)floor_mod(start + rot_w, num) : -1;
      const int start_w = (int)floor_mod(start + ev_w[w], num);
      const int pos = done + w;
      if (pos < B) {
        out[pos] = row;
        out[B + pos] = start_w;
      }
      if (has) {
        for (int r = 0; r < f.R; ++r) req_r[(int64_t)row * f.R + r] += f.request[r];
        nonzero[2 * (int64_t)row] += f.nz_request[0];
        nonzero[2 * (int64_t)row + 1] += f.nz_request[1];
        pod_count[row] += 1;
        if (blocked) blocked[row] = 1;
        if (aux_cnt) aux_cnt[row] += aux_inc;
        for (int c = 0; c < A1; ++c) {
          const int v = topo[(int64_t)anti_axis[c] * NP + row];
          if (v > 0) atomicAdd(&anti_counts[(int64_t)c * V + v], anti_self[c]);
        }
      }
      if (w == L - 1) s_start = start_w;
      if (w == 0) s_done = done + L;
    }
    __syncthreads();
  }
  // The carry's fit/score lanes after the last landing (:916-920).
  for (int i = lo; i < hi; ++i) {
    bool ok;
    int64_t sc, ba;
    resource_eval_row(f, alloc_r + (int64_t)i * f.R, alloc_pods[i], req_r + (int64_t)i * f.R,
                      nonzero + 2 * (int64_t)i, pod_count[i],
                        nom_req ? nom_req + (int64_t)i * f.R : nullptr,
                        nom_req ? nom_pods[i] : 0, ok, sc, ba);
    fit_ok_out[i] = ok;
    fit_sc_out[i] = sc;
    ba_out[i] = ba;
  }
  if (tid == 0) *start_out = s_start;
}

extern "C" int launch_lap_schedule(
    int NP, int R, int FR, int fit_strategy, int B, int n_act, int A1, int V,
    const int64_t* request,
    const int64_t* nz_request, const int64_t* has_request, const int64_t* ba_skip,
    const int32_t* enable, const int32_t* fit_slots, const int64_t* fit_weights,
    const int64_t* alloc_r, const int64_t* alloc_pods, int64_t* req_r, int64_t* nonzero,
    int32_t* pod_count, OPTIONAL const int64_t* nom_req, OPTIONAL const int32_t* nom_pods,
    OPTIONAL bool* blocked, OPTIONAL int32_t* aux_cnt, const int32_t* aux_room,
    const int32_t* aux_inc, const bool* static_ok, const int64_t* il_score,
    const int64_t* weights, const int32_t* num_nodes, const int32_t* to_find,
    const int32_t* start, const int32_t* topo, const int32_t* anti_axis,
    const int32_t* anti_self, int32_t* anti_counts, uint8_t* okd_s, int32_t* F_s,
    int64_t* total_s, int32_t* out, bool* fit_ok, int64_t* fit_sc, int64_t* ba,
    int32_t* start_out, cudaStream_t stream) {
  ResFeat f{request, nz_request, has_request, ba_skip, enable, fit_slots, fit_weights,
            R, FR, fit_strategy};
  lap_schedule_kernel<<<1, KTT_BLOCK, 0, stream>>>(
      f, alloc_r, alloc_pods, req_r, nonzero, pod_count, nom_req, nom_pods,
      (uint8_t*)blocked, aux_cnt, aux_room, aux_inc, (const uint8_t*)static_ok,
      il_score, weights, num_nodes, to_find, start, NP, B, n_act, A1, V, topo, anti_axis,
      anti_self, anti_counts, okd_s, F_s, total_s, out, (uint8_t*)fit_ok, fit_sc, ba,
      start_out);
  return (int)cudaGetLastError();
}
