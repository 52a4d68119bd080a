// scan_schedule: the JAX package's schedule_batch scan `step` +
// `feasibility_proj` (ops/kernel.py:314-523), specialised to the plan of
// the fit-only slice — no spread, pod-affinity or landing-delta tables
// (C1 = C2 = A1 = A2 = KD = 0), no PreferNoSchedule, preferred-affinity or
// base inter-pod terms — so feasibility changes only at the landed row
// (incremental_feas) and the total score rides the carry (scores_carried).
// Batches of at most 64 steps take this path (the gate at :273).
//
// One persistent single-block kernel over all batch_pad steps. Per step:
// rotation rank from the row-order prefix sum, windowed truncation
// (rank <= to_find), selection by the packed max-score-then-min-rotation
// key, the window boundary, then — in one thread — the landed row's carry
// update and re-evaluation, and the prefix-sum shift of the rows after it.
// Padded steps (t >= n_active) land nothing and keep `start` (:348, :506).
//
// Bound: a dependent sequence of steps, each a pass over the node rows
// (~13 B per row from L2) and two block reductions; single block for the
// same reason as lap_schedule.
#include "kernels.cuh"

__global__ void __launch_bounds__(KTT_BLOCK) scan_schedule_kernel(
    ResFeat f, const int64_t* __restrict__ alloc_r, const int64_t* __restrict__ alloc_pods,
    int64_t* req_r, int64_t* nonzero, int32_t* pod_count, uint8_t* fit_ok,
    int64_t* fit_sc, int64_t* ba, const uint8_t* __restrict__ static_ok,
    const int64_t* __restrict__ il_score, const int64_t* __restrict__ weights,
    const int32_t* __restrict__ num_nodes_p, const int32_t* __restrict__ to_find_p,
    const int32_t* __restrict__ start_p, int NP, int B, int n_act, uint8_t* okd_s,
    int32_t* F_s, int64_t* total_s, int32_t* out, int32_t* start_out) {
  __shared__ int scan_sm[KTT_BLOCK];
  __shared__ long long red_a[KTT_BLOCK];
  __shared__ long long red_b[KTT_BLOCK];
  __shared__ int s_start, s_row, s_delta;
  const int tid = threadIdx.x;
  const int rpt = (NP + blockDim.x - 1) / blockDim.x;
  const int lo = min(tid * rpt, NP), hi = min(lo + rpt, NP);
  const int num = max(*num_nodes_p, 1);
  const int to_find = *to_find_p;
  const int64_t w_tt = weights[0], w_fit = weights[1], w_ba = weights[4], w_il = weights[6];
  // okd / F / carried total seeds
  int cnt = 0;
  for (int i = lo; i < hi; ++i) {
    const bool okd = static_ok[i] && fit_ok[i] && i < num;
    okd_s[i] = okd;
    total_s[i] = w_tt * MAX_NODE_SCORE + w_fit * fit_sc[i] + w_ba * ba[i] + w_il * il_score[i];
    cnt += okd;
  }
  const int incl = block_inclusive_scan(cnt, scan_sm);
  int run = incl - cnt;
  for (int i = lo; i < hi; ++i) {
    run += okd_s[i];
    F_s[i] = run;
  }
  if (tid == 0) s_start = *start_p;
  __syncthreads();
  for (int t = 0; t < B; ++t) {
    const int start = s_start;
    const int total_feas = F_s[NP - 1];
    const int f_start = start > 0 ? F_s[start - 1] : 0;
    long long best = -1, bound = 0;
    for (int i = lo; i < hi; ++i) {
      if (!okd_s[i]) continue;
      const int rank = i >= start ? F_s[i] - f_start : F_s[i] + total_feas - f_start;
      const int rot = (int)floor_mod(i - start, num);
      if (rank <= to_find) {
        const long long key = total_s[i] * NP + (NP - 1 - rot);
        if (key > best) best = key;
      }
      if (rank == to_find && num - 1 - rot > bound) bound = num - 1 - rot;
    }
    block_max2(best, bound, red_a, red_b);
    if (tid == 0) {
      const long long best_key = red_a[0];
      const int evaluated = num - (int)red_b[0];
      const bool active = t < n_act;
      const bool any_kept = best_key >= 0 && active;
      const int chosen_rot = NP - 1 - (int)floor_mod(best_key, NP);
      const int chosen = any_kept ? (int)floor_mod(start + chosen_rot, num) : -1;
      const int row = chosen > 0 ? chosen : 0;
      if (any_kept) {
        for (int r = 0; r < f.R; ++r) req_r[(int64_t)row * f.R + r] += f.request[r];
        nonzero[2 * (int64_t)row] += f.nz_request[0];
        nonzero[2 * (int64_t)row + 1] += f.nz_request[1];
        pod_count[row] += 1;
      }
      bool ok;
      int64_t sc, b;
      resource_eval_row(f, alloc_r + (int64_t)row * f.R, alloc_pods[row],
                        req_r + (int64_t)row * f.R, nonzero + 2 * (int64_t)row,
                        pod_count[row], nullptr, 0, ok, sc, b);
      fit_ok[row] = ok;
      fit_sc[row] = sc;
      ba[row] = b;
      const bool new_ok = static_ok[row] && ok && row < num;
      s_delta = (int)new_ok - (int)okd_s[row];
      okd_s[row] = new_ok;
      s_row = row;
      total_s[row] = w_tt * MAX_NODE_SCORE + w_fit * sc + w_ba * b + w_il * il_score[row];
      const int new_start = active ? (int)floor_mod(start + evaluated, num) : start;
      s_start = new_start;
      out[t] = chosen;
      out[B + t] = new_start;
    }
    __syncthreads();
    const int row = s_row, delta = s_delta;
    if (delta != 0) {
      for (int i = max(lo, row); i < hi; ++i) F_s[i] += delta;
    }
    __syncthreads();
  }
  if (tid == 0) *start_out = s_start;
}

extern "C" int launch_scan_schedule(
    int NP, int R, int FR, int fit_strategy, int B, int n_act, const int64_t* request,
    const int64_t* nz_request, const int64_t* has_request, const int64_t* ba_skip,
    const int32_t* enable, const int32_t* fit_slots, const int64_t* fit_weights,
    const int64_t* alloc_r, const int64_t* alloc_pods, int64_t* req_r, int64_t* nonzero,
    int32_t* pod_count, bool* fit_ok, int64_t* fit_sc, int64_t* ba, const bool* static_ok,
    const int64_t* il_score, const int64_t* weights, const int32_t* num_nodes,
    const int32_t* to_find, const int32_t* start, uint8_t* okd_s, int32_t* F_s,
    int64_t* total_s, int32_t* out, int32_t* start_out, cudaStream_t stream) {
  ResFeat f{request, nz_request, has_request, ba_skip, enable, fit_slots, fit_weights,
            R, FR, fit_strategy};
  scan_schedule_kernel<<<1, KTT_BLOCK, 0, stream>>>(
      f, alloc_r, alloc_pods, req_r, nonzero, pod_count, (uint8_t*)fit_ok, fit_sc, ba,
      (const uint8_t*)static_ok, il_score, weights, num_nodes, to_find, start, NP, B, n_act,
      okd_s, F_s, total_s, out, start_out);
  return (int)cudaGetLastError();
}
