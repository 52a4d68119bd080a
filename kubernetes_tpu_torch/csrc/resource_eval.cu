// resource_eval: the JAX package's _resource_eval (ops/kernel.py:160-208)
// over every node row — the fresh-carry seed of schedule_batch (:525-536).
// The row function itself lives in kernels.cuh and is inlined into
// lap_schedule and scan_schedule.
//
// Bound: bytes. Each row reads its allocatable, requested and non-zero
// vectors (~16 B per resource slot) and does a few dozen int64 operations;
// one thread per row with coalesced row-major loads.
#include "kernels.cuh"

__global__ void resource_eval_kernel(
    ResFeat f, int NP, const int64_t* __restrict__ alloc_r,
    const int64_t* __restrict__ alloc_pods, const int64_t* __restrict__ req_r,
    const int64_t* __restrict__ nonzero, const int32_t* __restrict__ pod_count,
    const int64_t* __restrict__ nom_req, const int32_t* __restrict__ nom_pods,
    uint8_t* fit_ok, int64_t* fit_sc, int64_t* ba) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= NP) return;
  bool ok;
  int64_t sc, b;
  resource_eval_row(f, alloc_r + (int64_t)n * f.R, alloc_pods[n], req_r + (int64_t)n * f.R,
                    nonzero + 2 * (int64_t)n, pod_count[n],
                    nom_req ? nom_req + (int64_t)n * f.R : nullptr,
                    nom_pods ? nom_pods[n] : 0, ok, sc, b);
  fit_ok[n] = ok;
  fit_sc[n] = sc;
  ba[n] = b;
}

extern "C" int launch_resource_eval(
    int NP, int R, int FR, int fit_strategy, const int64_t* request,
    const int64_t* nz_request, const int64_t* has_request, const int64_t* ba_skip,
    const int32_t* enable, const int32_t* fit_slots, const int64_t* fit_weights,
    const int64_t* alloc_r, const int64_t* alloc_pods, const int64_t* req_r,
    const int64_t* nonzero, const int32_t* pod_count, OPTIONAL const int64_t* nom_req,
    OPTIONAL const int32_t* nom_pods, bool* fit_ok, int64_t* fit_sc, int64_t* ba,
    cudaStream_t stream) {
  if (NP == 0) return 0;
  ResFeat f{request, nz_request, has_request, ba_skip, enable, fit_slots, fit_weights,
            R, FR, fit_strategy};
  const int threads = 256;
  const int blocks = (NP + threads - 1) / threads;
  resource_eval_kernel<<<blocks, threads, 0, stream>>>(
      f, NP, alloc_r, alloc_pods, req_r, nonzero, pod_count, nom_req, nom_pods,
      (uint8_t*)fit_ok, fit_sc, ba);
  return (int)cudaGetLastError();
}
