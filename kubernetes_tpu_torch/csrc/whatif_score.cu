// whatif_score: the descheduler's what-if rescore of bound pods — the JAX
// package's whatif._device_fn.score (kubernetes_tpu/ops/whatif.py:197-249)
// for every (candidate p, node n) cell: vacate the candidate's request from
// its source row src[p], then the fit filter (pod count and every resource
// slot), LeastAllocated over cpu and memory (weight 1 each, fit_den counting
// the slots with allocatable > 0) and BalancedAllocation quantized at
// BA_SCALE (no ba_skip). This is not resource_eval_row: the what-if's fit
// score is fixed to those two slots.
//
// Bound: bytes. A cell reads its node row (~8R + 40 B, shared by the P
// blocks that read it) and writes 9 B; the outputs alone are 9 B x P x N.
// Three int64 divisions a cell. One thread a cell, grid (ceil(N/256), P):
// blockIdx.y is the candidate, whose request row, non-zero request and
// source row are read once a block into shared memory; the node rows load
// coalesced along n; the results go straight into the [P, N] outputs.
//
// Exactness: every `//` floors (floor_div), and the sums, differences and
// products wrap in uint64_t, as numpy's and XLA's int64 arithmetic wraps
// (signed overflow is undefined in C++): `used * BA_SCALE` passes 2^63 once
// a node's non-zero memory passes ~8.4 TiB.
#include "kernels.cuh"

namespace {

__device__ __forceinline__ int64_t wadd(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a + (uint64_t)b);
}

__device__ __forceinline__ int64_t wsub(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a - (uint64_t)b);
}

__device__ __forceinline__ int64_t wmul(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a * (uint64_t)b);
}

// numpy's abs: |INT64_MIN| wraps to itself.
__device__ __forceinline__ int64_t wabs(int64_t a) {
  return a < 0 ? (int64_t)((uint64_t)0 - (uint64_t)a) : a;
}

__device__ __forceinline__ int64_t max1(int64_t a) { return a > 1 ? a : 1; }

}  // namespace

__global__ void whatif_score_kernel(
    int P, int N, int R, const int64_t* __restrict__ alloc_r,
    const int64_t* __restrict__ alloc_pods, const int64_t* __restrict__ req_r,
    const int64_t* __restrict__ nonzero, const int64_t* __restrict__ pod_count,
    const int64_t* __restrict__ request, const int64_t* __restrict__ nz_request,
    const int64_t* __restrict__ src, const uint8_t* __restrict__ mask, uint8_t* fit_ok,
    int64_t* score) {
  extern __shared__ int64_t s_req[];  // [R] the candidate's request row
  __shared__ int64_t s_nz[2];
  __shared__ int64_t s_src;
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  for (int p = blockIdx.y; p < P; p += gridDim.y) {
    for (int r = threadIdx.x; r < R; r += blockDim.x) s_req[r] = request[(int64_t)p * R + r];
    if (threadIdx.x == 0) {
      s_nz[0] = nz_request[2 * (int64_t)p];
      s_nz[1] = nz_request[2 * (int64_t)p + 1];
      s_src = src[p];
    }
    __syncthreads();
    if (n < N) {
      const int64_t vac = (s_src == n) ? 1 : 0;
      const int64_t* a_row = alloc_r + (int64_t)n * R;
      const int64_t* q_row = req_r + (int64_t)n * R;
      // fit filter (fit.go:710) on the vacated row
      const bool pods_ok = wadd(wsub(pod_count[n], vac), 1) <= alloc_pods[n];
      bool viol = false;
      for (int r = 0; r < R; ++r) {
        const int64_t q = s_req[r];
        const int64_t req_v = wsub(q_row[r], wmul(vac, q));
        viol |= (q > 0) && (q > wsub(a_row[r], req_v));
      }
      const int64_t cell = (int64_t)p * N + n;
      fit_ok[cell] = pods_ok && !viol && mask[cell];
      const int64_t used0 = wadd(wsub(nonzero[2 * (int64_t)n], wmul(vac, s_nz[0])), s_nz[0]);
      const int64_t used1 =
          wadd(wsub(nonzero[2 * (int64_t)n + 1], wmul(vac, s_nz[1])), s_nz[1]);
      // LeastAllocated over (cpu, memory), weight 1 each
      const int64_t a_cpu = a_row[0];
      const int64_t a_mem = a_row[1];
      int64_t fit_num = 0, fit_den = 0;
      if (a_cpu > 0) {
        if (used0 <= a_cpu)
          fit_num = wadd(fit_num, floor_div(wmul(wsub(a_cpu, used0), MAX_NODE_SCORE), a_cpu));
        fit_den += 1;
      }
      if (a_mem > 0) {
        if (used1 <= a_mem)
          fit_num = wadd(fit_num, floor_div(wmul(wsub(a_mem, used1), MAX_NODE_SCORE), a_mem));
        fit_den += 1;
      }
      const int64_t fit_sc = fit_den > 0 ? floor_div(fit_num, fit_den) : 0;
      // integer-quantized BalancedAllocation
      int64_t q_cpu = floor_div(wmul(used0, BA_SCALE), max1(a_cpu));
      int64_t q_mem = floor_div(wmul(used1, BA_SCALE), max1(a_mem));
      q_cpu = q_cpu < BA_SCALE ? q_cpu : BA_SCALE;
      q_mem = q_mem < BA_SCALE ? q_mem : BA_SCALE;
      const int64_t ba =
          (a_cpu > 0 && a_mem > 0)
              ? floor_div(wsub(MAX_NODE_SCORE * BA_SCALE, wmul(50, wabs(wsub(q_cpu, q_mem)))),
                          BA_SCALE)
              : MAX_NODE_SCORE;
      score[cell] = wadd(fit_sc, ba);
    }
    __syncthreads();  // s_req is rewritten for the next candidate
  }
}

extern "C" int launch_whatif_score(
    int P, int N, int R, const int64_t* alloc_r, const int64_t* alloc_pods,
    const int64_t* req_r, const int64_t* nonzero, const int64_t* pod_count,
    const int64_t* request, const int64_t* nz_request, const int64_t* src, const bool* mask,
    bool* fit_ok, int64_t* score, cudaStream_t stream) {
  if (P == 0 || N == 0) return 0;
  const int threads = 256;
  const dim3 grid((N + threads - 1) / threads, P < 65535 ? P : 65535);
  whatif_score_kernel<<<grid, threads, (size_t)R * sizeof(int64_t), stream>>>(
      P, N, R, alloc_r, alloc_pods, req_r, nonzero, pod_count, request, nz_request, src,
      (const uint8_t*)mask, (uint8_t*)fit_ok, score);
  return (int)cudaGetLastError();
}
