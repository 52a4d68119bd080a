// dry_run_preemption: the JAX package's dry_run_preemption
// (ops/kernel.py:726-789) — DefaultPreemption's SelectVictimsOnNode
// (preemption.go:425) for every node row at once.
//
// One thread per node row. The row's static verdicts (static_row, shared
// with static_masks) and the preemptor's fit filter (fit_ok_row, shared
// with every schedule kernel, fit strategy 0 and no nominated lane: the
// host dry run ignores nominations) decide, as in the JAX function:
//   1. remove every lower-priority pod (the K victim columns, already in
//      MoreImportantPod order): base = requested - their sum, with
//      pod_count - their count pods; feasible0 = static_ok & fit & a victim;
//   2. reprieve most important first: victim i is kept when it is valid,
//      the row is feasible0 and the pod still fits at base + kept + its
//      request with cnt0 + kept + 1 pods; kept requests and the kept count
//      stay in registers (local memory for R above a few) across the loop;
//   3. out[n, 1 + i] = valid & feasible0 & not kept; out[n, 0] = feasible0 &
//      any victim.
// The nominated pods' own filters never enter: the device gate sends every
// preemptor whose filters couple rows (spread, pod affinity) and every
// cluster with anti-affinity pods to the host dry run.
//
// Bound: bytes. A row reads its K x R victim requests (int64) once, its K
// valid flags, its allocatable, requested, count and static inputs, and
// writes 1 + K bytes; the arithmetic is a few int64 operations per victim
// and slot. Threads of a warp read rows K*R*8 bytes apart, so a load is one
// sector per thread: the simple form, not the fast one.
#include "kernels.cuh"

#define DRY_RMAX 64  // resource slots a row can hold in its local arrays

__global__ void dry_run_preemption_kernel(
    ResFeat f, StaticFeat s, int NP, int K, const int32_t* __restrict__ num_nodes_p,
    const int64_t* __restrict__ alloc_r, const int64_t* __restrict__ alloc_pods,
    const int64_t* __restrict__ req_r, const int32_t* __restrict__ pod_count,
    const int64_t* __restrict__ vic_req, const uint8_t* __restrict__ vic_valid,
    uint8_t* out) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= NP) return;
  const int R = f.R;
  const int num = max(*num_nodes_p, 1);
  const int64_t* alloc_row = alloc_r + (int64_t)n * R;
  const int64_t* vic_row = vic_req + (int64_t)n * K * R;
  const uint8_t* valid_row = vic_valid + (int64_t)n * K;
  uint8_t* out_row = out + (int64_t)n * (K + 1);
  int64_t base[DRY_RMAX], kept[DRY_RMAX], req[DRY_RMAX];
  for (int r = 0; r < R; ++r) {
    base[r] = req_r[(int64_t)n * R + r];
    kept[r] = 0;
  }
  int32_t n_pot = 0;
  for (int i = 0; i < K; ++i) {
    if (!valid_row[i]) continue;
    ++n_pot;
    for (int r = 0; r < R; ++r) base[r] -= vic_row[(int64_t)i * R + r];
  }
  const int32_t cnt0 = pod_count[n] - n_pot;
  const bool feasible0 = static_row(s, n).static_ok && n < num && n_pot > 0 &&
                         fit_ok_row(f, alloc_row, alloc_pods[n], base, cnt0, nullptr, 0);
  int32_t kept_cnt = 0;
  bool any = false;
  for (int i = 0; i < K; ++i) {
    const bool valid = valid_row[i];
    bool keep = false;
    if (valid && feasible0) {
      for (int r = 0; r < R; ++r) req[r] = base[r] + kept[r] + vic_row[(int64_t)i * R + r];
      keep = fit_ok_row(f, alloc_row, alloc_pods[n], req, cnt0 + kept_cnt + 1, nullptr, 0);
    }
    if (keep) {
      for (int r = 0; r < R; ++r) kept[r] += vic_row[(int64_t)i * R + r];
      ++kept_cnt;
    }
    const bool victim = valid && feasible0 && !keep;
    out_row[1 + i] = victim;
    any |= victim;
  }
  out_row[0] = feasible0 && any;
}

extern "C" int launch_dry_run_preemption(
    int NP, int R, int FR, int T, int L, int K, const int64_t* request,
    const int64_t* nz_request, const int64_t* has_request, const int64_t* ba_skip,
    const int32_t* enable, const int32_t* fit_slots, const int64_t* fit_weights,
    const int32_t* taint_key, const int32_t* taint_val, const int32_t* taint_eff,
    const int32_t* tol_key, const int32_t* tol_val, const int32_t* tol_eff,
    const int32_t* tol_op, const bool* sel_match, const int32_t* node_name_id,
    const int32_t* name_id, const bool* unsched, const int32_t* tolerates_unsched,
    const int32_t* exist_anti, const bool* valid, const bool* extra_ok,
    const int32_t* num_nodes, const int64_t* alloc_r, const int64_t* alloc_pods,
    const int64_t* req_r, const int32_t* pod_count, const int64_t* vic_req,
    const bool* vic_valid, bool* out, cudaStream_t stream) {
  if (R > DRY_RMAX) return (int)cudaErrorInvalidValue;
  if (NP == 0) return 0;
  const ResFeat f{request, nz_request, has_request, ba_skip, enable, fit_slots, fit_weights,
                  R, FR, 0};
  const StaticFeat s{T, L, taint_key, taint_val, taint_eff, tol_key, tol_val, tol_eff,
                     tol_op, (const uint8_t*)sel_match, node_name_id, name_id,
                     (const uint8_t*)unsched, tolerates_unsched, exist_anti, enable,
                     (const uint8_t*)valid, (const uint8_t*)extra_ok};
  const int threads = 128;
  const int blocks = (NP + threads - 1) / threads;
  dry_run_preemption_kernel<<<blocks, threads, 0, stream>>>(
      f, s, NP, K, num_nodes, alloc_r, alloc_pods, req_r, pod_count, vic_req,
      (const uint8_t*)vic_valid, (uint8_t*)out);
  return (int)cudaGetLastError();
}
