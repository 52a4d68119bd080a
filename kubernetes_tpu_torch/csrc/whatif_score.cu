// whatif_score: the descheduler's what-if rescore of bound pods — the JAX
// package's whatif._device_fn.score (kubernetes_tpu/ops/whatif.py:197-249)
// for every (candidate p, node n) cell: vacate the candidate's request from
// its source row src[p], then the fit filter (pod count and every resource
// slot), LeastAllocated over cpu and memory (weight 1 each, fit_den counting
// the slots with allocatable > 0) and BalancedAllocation quantized at
// BA_SCALE (no ba_skip). This is not resource_eval_row: the what-if's fit
// score is fixed to those two slots.
//
// Bound: bytes. A cell reads its mask byte and writes 9 B (the int64 score
// and the fit byte); a node row (~16R + 32 B) and a candidate row (~8R +
// 24 B) are read once each. The outputs alone are 9 B x P x N.
//
// Design: a block owns a tile of WI_NODES node columns (a thread a node)
// across a chunk of WI_CANDS candidates. Each thread reads its node once
// and keeps what no candidate changes: the fit filter's slack a - req of
// each slot (in registers up to WI_REG_R slots, an instantiation a width,
// in a shared-memory tile past that, re-read from device memory past the
// tile's room), whether one more pod fits with and without the vacated
// one, the non-zero sums, the divisors max(a_cpu, 1) and max(a_mem, 1)
// with their float64 reciprocals, fit_den and whether both shares count.
// The chunk's candidate rows (request, non-zero request, source row) sit
// in shared memory and the node's mask bytes of the chunk are loaded
// together. A cell then costs the vacate test, R comparisons (avail =
// slack + vac * q), four floored divisions by the node's two divisors
// (recip_floor_div: the reciprocal's quotient and one exact int64
// correction), fit_num // fit_den as a copy or a shift (fit_den is 0, 1
// or 2) and BalancedAllocation's division by BA_SCALE in 32 bits. A
// warp's cells of one candidate are 32 neighbouring nodes: its mask reads
// and its writes into the [P, N] outputs coalesce along n. The kernel is
// bound by its instructions, not its bytes (an int64 add, product or
// compare is two or three instructions, and a cell takes four
// divisions). The tile of 64 nodes x 8 candidates (the rebalance drive's
// 128 x 5000 batch: 79 x 16 = 1264 blocks of 2 warps) keeps enough warps
// on an SM to issue them: 128 x 16 tiles, whose threads each walk twice
// the cells, measured 0.014683 against 0.010712 ms on the drive's batch,
// in turns (ab_windows.py --evals; NVIDIA H100 80GB HBM3, 700.00 W).
//
// Exactness: every `//` floors, and the sums, differences and products
// wrap in uint64_t, as numpy's and XLA's int64 arithmetic wraps (signed
// overflow is undefined in C++): `used * BA_SCALE` passes 2^63 once a
// node's non-zero memory passes ~8.4 TiB. The vacated forms are the same
// values modulo 2^64: used = nz - vac * q + q is nz when vac, and avail =
// a - (req - vac * q) is slack + q.
#include "kernels.cuh"

#define WI_NODES 64   // node columns (threads) a block
#define WI_CANDS 8    // candidates a block
#define WI_REG_R 8    // slots whose slack a thread keeps in registers

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

// A node's divisor d = max(a, 1) with its float64 reciprocal; `fast` when
// d < 2^62, so that a remainder in [-d, 2d) fits int64.
struct Divisor {
  int64_t d;
  double inv;
  bool fast;
};

__device__ __forceinline__ Divisor divisor(int64_t a) {
  const int64_t d = max1(a);
  return Divisor{d, 1.0 / (double)d, d < ((int64_t)1 << 62)};
}

// floor(a / d), as lap_floor_div (kernels.cuh) but from the reciprocal the
// node computed once: a, d, the reciprocal and the product each round
// once, so while the quotient's magnitude is below 2^50 the estimate is
// within 0.5 of the true one, its floor off by at most one, and the exact
// remainder (in [-d, 2d): it fits int64, and the wrapping product gives
// it) corrects it. Other operands take floor_div.
__device__ __forceinline__ int64_t recip_floor_div(int64_t a, const Divisor& v) {
  const double e = (double)a * v.inv;
  if (v.fast && fabs(e) < 1125899906842624.0) {  // 2^50
    const int64_t q = (int64_t)floor(e);
    const int64_t r = wsub(a, wmul(q, v.d));
    return q - (r < 0) + (r >= v.d);
  }
  return lap_floor_div_wide(a, v.d);
}

// floor((MAX_NODE_SCORE * BA_SCALE - 50 * diff) / BA_SCALE) for diff =
// |q_cpu - q_mem| (wrapping): in 32 bits while 50 * diff <= 10^8 (both
// shares in [0, BA_SCALE], as every non-negative node gives), else in
// int64.
__device__ __forceinline__ int64_t ba_score(int64_t diff) {
  if ((uint64_t)diff <= 2000000u)
    return (int64_t)((100000000u - 50u * (uint32_t)diff) / 1000000u);
  return floor_div(wsub(MAX_NODE_SCORE * BA_SCALE, wmul(50, diff)), BA_SCALE);
}

// Shared memory of a block: the chunk's candidate rows (request [WI_CANDS,
// R], nz_request [WI_CANDS, 2], src [WI_CANDS]) and, in the tile tier, the
// slack tile [R, WI_NODES]. The register tier (R <= WI_REG_R, an
// instantiation a width) keeps the slack in registers; the device-memory
// tier (the tile past STAGE_SMEM_MAX: R > 85) stages nothing.
enum { WI_TILE = 0, WI_DEVICE = -1 };

__host__ __device__ __forceinline__ int wi_tier(int R) {
  if (R <= WI_REG_R) return R;
  return (size_t)8 * (WI_CANDS * (R + 3) + R * WI_NODES) <= STAGE_SMEM_MAX ? WI_TILE : WI_DEVICE;
}

__host__ __device__ __forceinline__ size_t wi_stage_bytes(int R, int tier) {
  return tier == WI_DEVICE ? 0
                           : (size_t)8 * (WI_CANDS * (R + 3) + (tier == WI_TILE ? R * WI_NODES : 0));
}

}  // namespace

// TIER: R itself (2 <= R <= WI_REG_R: the slack in registers), WI_TILE or
// WI_DEVICE.
template <int TIER>
__global__ void __launch_bounds__(WI_NODES) whatif_score_kernel(
    int P, int N, int R, const int64_t* __restrict__ alloc_r,
    const int64_t* __restrict__ alloc_pods, const int64_t* __restrict__ req_r,
    const int64_t* __restrict__ nonzero, const int64_t* __restrict__ pod_count,
    const int64_t* __restrict__ request, const int64_t* __restrict__ nz_request,
    const int64_t* __restrict__ src, const uint8_t* __restrict__ mask, uint8_t* out) {
  constexpr bool REG = TIER > 0;
  if (REG) R = TIER;
  extern __shared__ int4 wi_smem[];
  int64_t* s_req = reinterpret_cast<int64_t*>(wi_smem);
  int64_t* s_nz = s_req + WI_CANDS * R;
  int64_t* s_src = s_nz + 2 * WI_CANDS;
  int64_t* s_slack = s_src + WI_CANDS;
  const int tid = threadIdx.x;
  const int n = blockIdx.x * WI_NODES + tid;
  const bool live = n < N;
  const int64_t* a_row = alloc_r + (int64_t)n * R;
  const int64_t* q_row = req_r + (int64_t)n * R;
  // The node's constants, once.
  int64_t slack[REG ? TIER : 1];
  int64_t nz0 = 0, nz1 = 0, a_cpu = 0, a_mem = 0;
  bool pods_ok = false, pods_ok_vac = false;
  if (live) {
    if (REG) {
#pragma unroll
      for (int r = 0; r < (REG ? TIER : 1); ++r) slack[r] = wsub(a_row[r], q_row[r]);
    } else if (TIER == WI_TILE) {
      for (int r = 0; r < R; ++r) s_slack[r * WI_NODES + tid] = wsub(a_row[r], q_row[r]);
    }
    const int64_t pc = pod_count[n], ap = alloc_pods[n];
    pods_ok = wadd(pc, 1) <= ap;  // one more pod on the row
    pods_ok_vac = pc <= ap;       // the candidate's own row: (pc - 1) + 1
    nz0 = nonzero[2 * (int64_t)n];
    nz1 = nonzero[2 * (int64_t)n + 1];
    a_cpu = a_row[0];
    a_mem = a_row[1];
  }
  const Divisor v_cpu = divisor(a_cpu), v_mem = divisor(a_mem);
  const int fit_den = (a_cpu > 0) + (a_mem > 0);
  const bool both = a_cpu > 0 && a_mem > 0;
  int64_t* score = reinterpret_cast<int64_t*>(out);
  uint8_t* fit_ok = out + 8 * (int64_t)P * N;
  for (int c0 = blockIdx.y * WI_CANDS; c0 < P; c0 += gridDim.y * WI_CANDS) {
    const int nc = P - c0 < WI_CANDS ? P - c0 : WI_CANDS;
    if (TIER != WI_DEVICE) {
      __syncthreads();  // the last chunk's rows are read
      for (int i = tid; i < nc * R; i += WI_NODES) s_req[i] = request[(int64_t)c0 * R + i];
      for (int i = tid; i < 2 * nc; i += WI_NODES) s_nz[i] = nz_request[2 * (int64_t)c0 + i];
      for (int i = tid; i < nc; i += WI_NODES) s_src[i] = src[c0 + i];
      __syncthreads();
    }
    if (!live) continue;
    // The chunk's mask bytes of this node, their loads in flight together
    // (a load a cell would leave each cell waiting on its own), packed
    // four to a word.
    uint32_t mk[WI_CANDS / 4];
#pragma unroll
    for (int w = 0; w < WI_CANDS / 4; ++w) {
      uint32_t word = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int c = 4 * w + b;
        if (c < nc) word |= (uint32_t)mask[(int64_t)(c0 + c) * N + n] << (8 * b);
      }
      mk[w] = word;
    }
#pragma unroll 1
    for (int c = 0; c < nc; ++c) {
      const int p = c0 + c;
      const int64_t* creq = TIER != WI_DEVICE ? s_req + c * R : request + (int64_t)p * R;
      const int64_t* cnz = TIER != WI_DEVICE ? s_nz + 2 * c : nz_request + 2 * (int64_t)p;
      const bool vac = (TIER != WI_DEVICE ? s_src[c] : src[p]) == n;
      // fit filter (fit.go:710) on the vacated row
      bool viol = false;
      if (REG) {
#pragma unroll
        for (int r = 0; r < (REG ? TIER : 1); ++r) {
          const int64_t q = creq[r];
          viol |= (q > 0) && (q > (vac ? wadd(slack[r], q) : slack[r]));
        }
      } else {
        for (int r = 0; r < R; ++r) {
          const int64_t q = creq[r];
          const int64_t s =
              TIER == WI_TILE ? s_slack[r * WI_NODES + tid] : wsub(a_row[r], q_row[r]);
          viol |= (q > 0) && (q > (vac ? wadd(s, q) : s));
        }
      }
      uint32_t word = mk[0];
#pragma unroll
      for (int w = 1; w < WI_CANDS / 4; ++w) word = c >= 4 * w ? mk[w] : word;
      const bool m = (word >> (8 * (c & 3))) & 0xff;
      const int64_t cell = (int64_t)p * N + n;
      fit_ok[cell] = (vac ? pods_ok_vac : pods_ok) && !viol && m;
      const int64_t used0 = vac ? nz0 : wadd(nz0, cnz[0]);
      const int64_t used1 = vac ? nz1 : wadd(nz1, cnz[1]);
      // LeastAllocated over (cpu, memory), weight 1 each
      int64_t fit_num = 0;
      if (a_cpu > 0 && used0 <= a_cpu)
        fit_num = recip_floor_div(wmul(wsub(a_cpu, used0), MAX_NODE_SCORE), v_cpu);
      if (a_mem > 0 && used1 <= a_mem)
        fit_num = wadd(fit_num, recip_floor_div(wmul(wsub(a_mem, used1), MAX_NODE_SCORE), v_mem));
      // floor(fit_num / fit_den); fit_den 0 leaves fit_num 0
      const int64_t fit_sc = fit_den == 2 ? fit_num >> 1 : fit_num;
      // integer-quantized BalancedAllocation
      int64_t q_cpu = recip_floor_div(wmul(used0, BA_SCALE), v_cpu);
      int64_t q_mem = recip_floor_div(wmul(used1, BA_SCALE), v_mem);
      q_cpu = q_cpu < BA_SCALE ? q_cpu : BA_SCALE;
      q_mem = q_mem < BA_SCALE ? q_mem : BA_SCALE;
      const int64_t ba = both ? ba_score(wabs(wsub(q_cpu, q_mem))) : MAX_NODE_SCORE;
      score[cell] = wadd(fit_sc, ba);
    }
  }
}

template <int TIER>
static void wi_launch(dim3 grid, size_t smem, cudaStream_t stream, int P, int N, int R,
                      const int64_t* alloc_r, const int64_t* alloc_pods, const int64_t* req_r,
                      const int64_t* nonzero, const int64_t* pod_count, const int64_t* request,
                      const int64_t* nz_request, const int64_t* src, const bool* mask,
                      uint8_t* out) {
  whatif_score_kernel<TIER><<<grid, WI_NODES, smem, stream>>>(
      P, N, R, alloc_r, alloc_pods, req_r, nonzero, pod_count, request, nz_request, src,
      (const uint8_t*)mask, out);
}

// `out`: 9 * P * N bytes — score [P, N] int64, then fit_ok [P, N]. R >= 2:
// slots 0 and 1 are cpu and memory.
extern "C" int launch_whatif_score(
    int P, int N, int R, const int64_t* alloc_r, const int64_t* alloc_pods,
    const int64_t* req_r, const int64_t* nonzero, const int64_t* pod_count,
    const int64_t* request, const int64_t* nz_request, const int64_t* src, const bool* mask,
    uint8_t* out, cudaStream_t stream) {
  if (P == 0 || N == 0) return 0;
  if (R < 2) return (int)cudaErrorInvalidValue;
  const int chunks = (P + WI_CANDS - 1) / WI_CANDS;
  const dim3 grid((N + WI_NODES - 1) / WI_NODES, chunks < 65535 ? chunks : 65535);
  const int tier = wi_tier(R);
  const size_t smem = wi_stage_bytes(R, tier);
#define WI_ARGS grid, smem, stream, P, N, R, alloc_r, alloc_pods, req_r, nonzero, pod_count, \
                request, nz_request, src, mask, out
  switch (tier) {
    case 2: wi_launch<2>(WI_ARGS); break;
    case 3: wi_launch<3>(WI_ARGS); break;
    case 4: wi_launch<4>(WI_ARGS); break;
    case 5: wi_launch<5>(WI_ARGS); break;
    case 6: wi_launch<6>(WI_ARGS); break;
    case 7: wi_launch<7>(WI_ARGS); break;
    case 8: wi_launch<8>(WI_ARGS); break;
    case WI_TILE: wi_launch<WI_TILE>(WI_ARGS); break;
    default: wi_launch<WI_DEVICE>(WI_ARGS); break;
  }
#undef WI_ARGS
  return (int)cudaGetLastError();
}
