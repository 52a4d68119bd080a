// patch_carry_rows: the JAX package's patch_carry_rows (ops/kernel.py:584-621),
// the carry-side half of a journal delta patch. A live session's carry gets
// the post-event aggregates of K dirty node rows (requested, non-zero
// requested, pod count) and those rows' resource-derived lanes are
// re-evaluated: the fit filter (with the nominated-pod lane where the plan
// carries one), the Fit score and BalancedAllocation, through the same
// resource_eval_row that every other kernel inlines (kernels.cuh). The
// result is a new carry (six new lanes) and the old one keeps its values;
// in place (every new lane the old one: a sharded carry patched where it
// lies) only the rows are written.
//
// The host stages idx, req_rows, nz_rows and cnt_rows in one pinned buffer
// and uploads it in one copy. A block owns PATCH_BLOCK_ROWS consecutive rows
// of the six lanes: it copies them from the old carry as 16-byte vectors
// (cow_copy), then walks idx a pass at a time (pass_hits: PATCH_THREADS *
// PATCH_HIT_UNROLL entries, a whole 2048 tier; the first pass loaded
// before the copy). The entries that land in the block's rows are
// compacted into shared memory and evaluated side by side, each from its
// own staged inputs and the state's allocatable, never from a carry lane,
// the evaluating thread writing the row's three verdicts; the block writes
// the rows' aggregates, neighbouring threads on neighbouring elements (a
// row's R req_r slots side by side). Duplicate indices carry identical
// inputs (a patch tier pads with copies of its last real row), so an entry
// equal to the one before it is skipped: the tier's padding, all in one
// block, costs that block nothing. A row outside [0, NP) is never
// written.
//
// Bound: bytes — the six lanes read once and written once (8R + 37 bytes a
// row) and each staged row (8R + 20 bytes) and its allocatable read once:
// ~1.5 MB at NP 8192, R 7, under half a microsecond at 3.35 TB/s; the
// launch and a few device-memory latencies dominate.
#include "kernels.cuh"

#define PATCH_THREADS 256
#define PATCH_BLOCK_ROWS 64   // rows a block owns in each lane
#define PATCH_HIT_UNROLL 8    // idx entries a thread takes a pass: 2048 a pass
#define PATCH_LANES 6         // req_r, nonzero, pod_count, fit_ok, fit_sc, ba

struct CarryLanes {
  const uint8_t* old_l[PATCH_LANES];
  uint8_t* new_l[PATCH_LANES];
};

__global__ void __launch_bounds__(PATCH_THREADS) patch_carry_rows_kernel(
    ResFeat f, int NP, int K, const int32_t* __restrict__ idx,
    const int64_t* __restrict__ req_rows, const int64_t* __restrict__ nz_rows,
    const int32_t* __restrict__ cnt_rows, const int64_t* __restrict__ alloc_r,
    const int64_t* __restrict__ alloc_pods, const int64_t* __restrict__ nom_req,
    const int32_t* __restrict__ nom_pods, const __grid_constant__ CarryLanes c) {
  constexpr int PASS = PATCH_THREADS * PATCH_HIT_UNROLL;
  __shared__ CowSeg seg[COW_CHUNK];
  __shared__ int hits[PASS], hit_row[PASS];
  __shared__ int scratch[PATCH_THREADS / 32];
  const int lo = blockIdx.x * PATCH_BLOCK_ROWS;
  const int hi = min(lo + PATCH_BLOCK_ROWS, NP);
  int row[PATCH_HIT_UNROLL];
  pass_load<PATCH_HIT_UNROLL, true>(idx, K, 0, row);  // in flight with the copy
  if (threadIdx.x < PATCH_LANES) {
    const int l = threadIdx.x;
    const long long rb = l == 0 ? 8LL * f.R : l == 1 ? 16 : l == 2 ? 4 : l == 3 ? 1 : 8;
    seg[l] = CowSeg{c.new_l[l] + lo * rb, c.old_l[l] + lo * rb, (hi - lo) * rb};
  }
  cow_copy(seg, PATCH_LANES);
  int64_t* req_r = reinterpret_cast<int64_t*>(c.new_l[0]);
  int64_t* nonzero = reinterpret_cast<int64_t*>(c.new_l[1]);
  int32_t* pod_count = reinterpret_cast<int32_t*>(c.new_l[2]);
  bool* fit_ok = reinterpret_cast<bool*>(c.new_l[3]);
  int64_t* fit_sc = reinterpret_cast<int64_t*>(c.new_l[4]);
  int64_t* ba = reinterpret_cast<int64_t*>(c.new_l[5]);
  const int W = f.R + 3;  // req_r's R slots, nonzero's two, pod_count
  for (int p0 = 0; p0 < K; p0 += PASS) {
    if (p0 > 0) pass_load<PATCH_HIT_UNROLL, true>(idx, K, p0, row);
    const int nh = pass_hits(p0, row, lo, hi, hits, hit_row, scratch);
    // The hits' verdicts side by side, each from its own staged inputs,
    // written by the thread that evaluated it.
    for (int h = threadIdx.x; h < nh; h += blockDim.x) {
      const int64_t k = hits[h], r = hit_row[h];
      bool ok;
      int64_t sc, b;
      resource_eval_row(f, alloc_r + r * f.R, alloc_pods[r], req_rows + k * f.R, nz_rows + 2 * k,
                        cnt_rows[k], nom_req ? nom_req + r * f.R : nullptr,
                        nom_pods ? nom_pods[r] : 0, ok, sc, b);
      fit_ok[r] = ok;
      fit_sc[r] = sc;
      ba[r] = b;
    }
    // The aggregates, neighbouring threads on neighbouring elements.
    for (int e = threadIdx.x; e < nh * W; e += blockDim.x) {
      const int h = e / W;
      const int col = e - h * W;
      const int64_t k = hits[h], r = hit_row[h];
      if (col < f.R) req_r[r * f.R + col] = req_rows[k * f.R + col];
      else if (col < f.R + 2) nonzero[2 * r + col - f.R] = nz_rows[2 * k + col - f.R];
      else pod_count[r] = cnt_rows[k];
    }
    __syncthreads();
  }
}

extern "C" int launch_patch_carry_rows(
    int NP, int K, int R, int FR, int fit_strategy, const int64_t* request,
    const int64_t* nz_request, const int64_t* has_request, const int64_t* ba_skip,
    const int32_t* enable, const int32_t* fit_slots, const int64_t* fit_weights,
    const int32_t* idx, const int64_t* req_rows, const int64_t* nz_rows,
    const int32_t* cnt_rows, const int64_t* alloc_r, const int64_t* alloc_pods,
    OPTIONAL const int64_t* nom_req, OPTIONAL const int32_t* nom_pods, const int64_t* req_r,
    const int64_t* nonzero, const int32_t* pod_count, const bool* fit_ok, const int64_t* fit_sc,
    const int64_t* ba, int64_t* out_req_r, int64_t* out_nonzero, int32_t* out_pod_count,
    bool* out_fit_ok, int64_t* out_fit_sc, int64_t* out_ba, cudaStream_t stream) {
  CarryLanes c;
  const void* olds[PATCH_LANES] = {req_r, nonzero, pod_count, fit_ok, fit_sc, ba};
  void* news[PATCH_LANES] = {out_req_r, out_nonzero, out_pod_count, out_fit_ok, out_fit_sc,
                             out_ba};
  bool in_place = true;
  for (int l = 0; l < PATCH_LANES; ++l) {
    c.old_l[l] = static_cast<const uint8_t*>(olds[l]);
    c.new_l[l] = static_cast<uint8_t*>(news[l]);
    in_place &= olds[l] == news[l];
  }
  if (NP == 0 || (in_place && K == 0)) return 0;
  ResFeat f{request, nz_request, has_request, ba_skip, enable, fit_slots, fit_weights,
            R, FR, fit_strategy};
  const int blocks = (NP + PATCH_BLOCK_ROWS - 1) / PATCH_BLOCK_ROWS;
  patch_carry_rows_kernel<<<blocks, PATCH_THREADS, 0, stream>>>(
      f, NP, K, idx, req_rows, nz_rows, cnt_rows, alloc_r, alloc_pods, nom_req, nom_pods, c);
  return (int)cudaGetLastError();
}
