// resource_eval: the JAX package's _resource_eval (ops/kernel.py:160-208)
// over every node row — the fresh-carry seed of schedule_batch (:525-536).
// The row function itself lives in kernels.cuh and is inlined into the
// schedule kernels.
//
// Bound: bytes. Each row reads its allocatable, requested and non-zero
// vectors (~16 B per resource slot) and writes 17 B. The work a row is a
// few dozen int64 operations and FR + 3 floored divisions by the row's own
// values, one after another: at NP 8192 the kernel is the latency of one
// thread's chain (its row's loads, then its divisions), not a rate.
//
// Design: a thread a row in blocks of RE_ROWS, so that the rows of a
// 5000-node mirror (NP 8192) spread over 128 blocks, nearly one an SM of
// the card (blocks of 256 left 100 of the 132 SMs idle). A row's
// divisions (by max(alloc, 1) and max(den, 1), both positive) take
// lap_floor_div (LapDiv): a 32-bit division where both operands fit, else
// a float64 quotient with one exact int64 correction, in place of int64
// software division. A thread reads its row's slots in device memory, all
// its loads in flight at once. Staging a block's rows and the batch's
// features in shared memory (cow_copy's 16-byte copies) measured 0.004858
// against 0.003085 ms a launch on SchedulingBasic's next batch, in turns
// (ab_windows.py --evals against that layout; NVIDIA H100 80GB HBM3,
// 700.00 W): the chain gains a copy and barriers and loses nothing it
// waited on, so nothing is staged. The three outputs stay three
// allocations: one buffer viewed as the three cost the wrapper more host
// time than the two allocations it saves (0.02593 against 0.01494 ms a
// call, chip_smoke.py's call split, same card).
#include "kernels.cuh"

#define RE_ROWS 64  // rows (threads) a block

template <bool NOM>
__global__ void __launch_bounds__(RE_ROWS) resource_eval_kernel(
    ResFeat f, int NP, const int64_t* __restrict__ alloc_r,
    const int64_t* __restrict__ alloc_pods, const int64_t* __restrict__ req_r,
    const int64_t* __restrict__ nonzero, const int32_t* __restrict__ pod_count,
    const int64_t* __restrict__ nom_req, const int32_t* __restrict__ nom_pods, uint8_t* fit_ok,
    int64_t* fit_sc, int64_t* ba) {
  const int n = blockIdx.x * RE_ROWS + threadIdx.x;
  if (n >= NP) return;
  bool ok;
  int64_t sc, b;
  resource_eval_row<LapDiv>(f, alloc_r + (int64_t)n * f.R, alloc_pods[n],
                            req_r + (int64_t)n * f.R, nonzero + 2 * (int64_t)n, pod_count[n],
                            NOM ? nom_req + (int64_t)n * f.R : nullptr, NOM ? nom_pods[n] : 0,
                            ok, sc, b);
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
  if ((nom_req == nullptr) != (nom_pods == nullptr)) return (int)cudaErrorInvalidValue;
  const ResFeat f{request, nz_request, has_request, ba_skip, enable, fit_slots, fit_weights,
                  R, FR, fit_strategy};
  const int blocks = (NP + RE_ROWS - 1) / RE_ROWS;
  if (nom_req != nullptr) {
    resource_eval_kernel<true><<<blocks, RE_ROWS, 0, stream>>>(
        f, NP, alloc_r, alloc_pods, req_r, nonzero, pod_count, nom_req, nom_pods,
        (uint8_t*)fit_ok, fit_sc, ba);
  } else {
    resource_eval_kernel<false><<<blocks, RE_ROWS, 0, stream>>>(
        f, NP, alloc_r, alloc_pods, req_r, nonzero, pod_count, nom_req, nom_pods,
        (uint8_t*)fit_ok, fit_sc, ba);
  }
  return (int)cudaGetLastError();
}
