// patch_carry_rows: the JAX package's patch_carry_rows (ops/kernel.py:584-621),
// the carry-side half of a journal delta patch. A live session's carry gets
// the post-event aggregates of K dirty node rows (requested, non-zero
// requested, pod count) and those rows' resource-derived lanes are
// re-evaluated: the fit filter (with the nominated-pod lane where the plan
// carries one), the Fit score and BalancedAllocation, through the same
// resource_eval_row that every other kernel inlines (kernels.cuh).
//
// One thread per entry of idx. A thread computes only from its own inputs
// (its row of req_rows/nz_rows/cnt_rows and the state's allocatable at
// idx[k]) and never reads a carry lane, so the duplicate indices that pad a
// patch tier (copies of the last real row, with identical inputs) write
// identical values and the result is exact whatever order they land in.
//
// Bound: bytes, ~250 B a patched row (its inputs read once, six lanes
// written once) — well under a microsecond at the tiers the scheduler uses
// (32, 256, 2048 rows); the launch itself dominates.
#include "kernels.cuh"

__global__ void patch_carry_rows_kernel(
    ResFeat f, int NP, int K, const int32_t* __restrict__ idx,
    const int64_t* __restrict__ req_rows, const int64_t* __restrict__ nz_rows,
    const int32_t* __restrict__ cnt_rows, const int64_t* __restrict__ alloc_r,
    const int64_t* __restrict__ alloc_pods, const int64_t* __restrict__ nom_req,
    const int32_t* __restrict__ nom_pods, int64_t* req_r, int64_t* nonzero,
    int32_t* pod_count, uint8_t* fit_ok, int64_t* fit_sc, int64_t* ba) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  const int64_t row = idx[k];
  if (row < 0 || row >= NP) return;  // outside the carry: the caller's bug, never written
  const int64_t* req = req_rows + (int64_t)k * f.R;
  const int64_t* nz = nz_rows + 2 * (int64_t)k;
  const int32_t cnt = cnt_rows[k];
  bool ok;
  int64_t sc, b;
  resource_eval_row(f, alloc_r + row * f.R, alloc_pods[row], req, nz, cnt,
                    nom_req ? nom_req + row * f.R : nullptr, nom_pods ? nom_pods[row] : 0,
                    ok, sc, b);
  for (int r = 0; r < f.R; ++r) req_r[row * f.R + r] = req[r];
  nonzero[2 * row] = nz[0];
  nonzero[2 * row + 1] = nz[1];
  pod_count[row] = cnt;
  fit_ok[row] = ok;
  fit_sc[row] = sc;
  ba[row] = b;
}

extern "C" int launch_patch_carry_rows(
    int NP, int K, int R, int FR, int fit_strategy, const int64_t* request,
    const int64_t* nz_request, const int64_t* has_request, const int64_t* ba_skip,
    const int32_t* enable, const int32_t* fit_slots, const int64_t* fit_weights,
    const int32_t* idx, const int64_t* req_rows, const int64_t* nz_rows,
    const int32_t* cnt_rows, const int64_t* alloc_r, const int64_t* alloc_pods,
    OPTIONAL const int64_t* nom_req, OPTIONAL const int32_t* nom_pods, int64_t* req_r,
    int64_t* nonzero, int32_t* pod_count, bool* fit_ok, int64_t* fit_sc, int64_t* ba,
    cudaStream_t stream) {
  if (K == 0) return 0;
  ResFeat f{request, nz_request, has_request, ba_skip, enable, fit_slots, fit_weights,
            R, FR, fit_strategy};
  const int threads = 128;
  const int blocks = (K + threads - 1) / threads;
  patch_carry_rows_kernel<<<blocks, threads, 0, stream>>>(
      f, NP, K, idx, req_rows, nz_rows, cnt_rows, alloc_r, alloc_pods, nom_req, nom_pods,
      req_r, nonzero, pod_count, (uint8_t*)fit_ok, fit_sc, ba);
  return (int)cudaGetLastError();
}
