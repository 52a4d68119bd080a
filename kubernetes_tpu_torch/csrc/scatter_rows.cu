// scatter_rows: the device mirror's dirty-row scatter, the JAX package's
// _scatter_rows_impl (ops/device_state.py:130-135): a new DeviceNodeState
// equal to the old one with the D rows idx replaced by the host's
// re-encoded rows — the twelve per-row fields, and `topo` along its node
// axis — while the old state keeps its values (a dispatched batch or a
// saved plan may still read it). In place (every new pointer the old one:
// a mesh shard patched where it lies) only the rows are written.
//
// The host packs the rows into one pinned staging buffer, field by field,
// and uploads it with idx in one copy; the launcher gets each field's
// section as a byte offset into that upload, computed by the wrapper, and
// reads it [D, width] row-major (topo's [K, D]). A block owns
// SCATTER_BLOCK_ROWS consecutive rows in every field and in each of topo's
// K axis rows: it copies that slab from the old state to the new one as
// 16-byte vectors (cow_copy, kernels.cuh), then walks idx a pass at a
// time, compacts the entries that land in its rows into shared memory
// (pass_hits) and writes those rows from the packed buffer, neighbouring
// threads on neighbouring elements of a row. Each row is written by one
// block only, and the copy of a row lands before its patch (cow_copy ends
// with a barrier). idx may come in any order; a row outside [0, NP) is
// never written. The first pass of idx (SCATTER_THREADS *
// SCATTER_HIT_UNROLL entries, 2048, eight a thread) is loaded before the
// copy, so that its latency hides under the copy's; a flush of more rows
// takes more passes.
//
// Bound: bytes — the old state read once and the new one written once
// (16R + 34 + 12T + 4K bytes a row), and the packed rows and idx read once:
// ~3.4 MB at NP 8192, R 7, T 4, K 4, ~1 us at 3.35 TB/s. A block's copy is
// one round of loads in flight (COW_UNROLL vectors a thread), so the
// kernel is a few device-memory latencies plus the launch.
#include "kernels.cuh"

#define SCATTER_THREADS 256
#define SCATTER_BLOCK_ROWS 64   // rows a block owns in every field
#define SCATTER_HIT_UNROLL 8    // idx entries a thread takes a pass: 2048 a pass
#define ROW_FIELDS 12           // DeviceNodeState's fields, topo last

// The kernel's parameter (__grid_constant__: indexed where it lies, not
// copied per thread).
struct ScatterFields {
  const uint8_t* old_f[ROW_FIELDS];
  uint8_t* new_f[ROW_FIELDS];
  const uint8_t* row_f[ROW_FIELDS];  // the D packed rows of each field
  int width[ROW_FIELDS];             // elements a row (topo: K)
  int esize[ROW_FIELDS];             // bytes an element
};

__global__ void __launch_bounds__(SCATTER_THREADS) scatter_rows_kernel(
    const __grid_constant__ ScatterFields a, int NP, int D, const int32_t* __restrict__ idx) {
  __shared__ CowSeg seg[COW_CHUNK];
  __shared__ int hits[SCATTER_THREADS * SCATTER_HIT_UNROLL], hit_row[SCATTER_THREADS * SCATTER_HIT_UNROLL];
  __shared__ int scratch[SCATTER_THREADS / 32];
  const int lo = blockIdx.x * SCATTER_BLOCK_ROWS;
  const int hi = min(lo + SCATTER_BLOCK_ROWS, NP);
  int row[SCATTER_HIT_UNROLL];
  pass_load<SCATTER_HIT_UNROLL, false>(idx, D, 0, row);  // in flight with the copy
  const int K = a.width[ROW_FIELDS - 1];
  const int S = ROW_FIELDS - 1 + K;  // eleven row-major fields, then topo's K axis rows
  for (int s0 = 0; s0 < S; s0 += COW_CHUNK) {
    const int n = min(COW_CHUNK, S - s0);
    if (threadIdx.x < n) {
      const int s = s0 + threadIdx.x;
      const int f = min(s, ROW_FIELDS - 1);
      long long off, bytes;
      if (f < ROW_FIELDS - 1) {
        const long long rb = (long long)a.width[f] * a.esize[f];
        off = lo * rb;
        bytes = (hi - lo) * rb;
      } else {
        off = ((long long)(s - (ROW_FIELDS - 1)) * NP + lo) * 4;
        bytes = (long long)(hi - lo) * 4;
      }
      seg[threadIdx.x] = CowSeg{a.new_f[f] + off, a.old_f[f] + off, bytes};
    }
    cow_copy(seg, n);
  }
  int W = 0;  // elements a packed row: every field's width, topo's K last
  for (int f = 0; f < ROW_FIELDS; ++f) W += a.width[f];
  for (int p0 = 0; p0 < D; p0 += SCATTER_THREADS * SCATTER_HIT_UNROLL) {
    if (p0 > 0) pass_load<SCATTER_HIT_UNROLL, false>(idx, D, p0, row);
    const int nh = pass_hits(p0, row, lo, hi, hits, hit_row, scratch);
    for (int e = threadIdx.x; e < nh * W; e += blockDim.x) {
      const int h = e / W;
      int c = e - h * W;
      const long long j = hits[h], r = hit_row[h];
      int f = 0;
      while (c >= a.width[f]) c -= a.width[f++];
      const int es = a.esize[f];
      const uint8_t* src;
      uint8_t* dst;
      if (f < ROW_FIELDS - 1) {
        src = a.row_f[f] + (j * a.width[f] + c) * es;
        dst = a.new_f[f] + (r * a.width[f] + c) * es;
      } else {
        src = a.row_f[f] + ((long long)c * D + j) * 4;
        dst = a.new_f[f] + ((long long)c * NP + r) * 4;
      }
      if (es == 8) *reinterpret_cast<int64_t*>(dst) = *reinterpret_cast<const int64_t*>(src);
      else if (es == 4) *reinterpret_cast<int32_t*>(dst) = *reinterpret_cast<const int32_t*>(src);
      else *dst = *src;
    }
    __syncthreads();
  }
}

extern "C" int launch_scatter_rows(
    int NP, int D, int R, int T, int K, const int32_t* idx, const uint8_t* packed,
    int off_alloc_r, int off_alloc_pods, int off_req_r, int off_nonzero, int off_pod_count,
    int off_taint_key, int off_taint_val, int off_taint_eff, int off_unsched, int off_valid,
    int off_name_id, int off_topo, const int64_t* alloc_r, const int64_t* alloc_pods, const int64_t* req_r,
    const int64_t* nonzero, const int32_t* pod_count, const int32_t* taint_key,
    const int32_t* taint_val, const int32_t* taint_eff, const bool* unsched, const bool* valid,
    const int32_t* name_id, const int32_t* topo, int64_t* out_alloc_r, int64_t* out_alloc_pods,
    int64_t* out_req_r, int64_t* out_nonzero, int32_t* out_pod_count, int32_t* out_taint_key,
    int32_t* out_taint_val, int32_t* out_taint_eff, bool* out_unsched, bool* out_valid,
    int32_t* out_name_id, int32_t* out_topo, cudaStream_t stream) {
  ScatterFields a;
  const void* olds[ROW_FIELDS] = {alloc_r, alloc_pods, req_r, nonzero, pod_count, taint_key,
                                  taint_val, taint_eff, unsched, valid, name_id, topo};
  void* news[ROW_FIELDS] = {out_alloc_r, out_alloc_pods, out_req_r, out_nonzero,
                            out_pod_count, out_taint_key, out_taint_val, out_taint_eff,
                            out_unsched, out_valid, out_name_id, out_topo};
  const int offs[ROW_FIELDS] = {off_alloc_r, off_alloc_pods, off_req_r, off_nonzero,
                                off_pod_count, off_taint_key, off_taint_val, off_taint_eff,
                                off_unsched, off_valid, off_name_id, off_topo};
  // alloc_r [R] i64, alloc_pods i64, req_r [R] i64, nonzero [2] i64,
  // pod_count i32, taint_key / taint_val / taint_eff [T] i32, unsched and
  // valid bool, name_id i32, topo [K] i32 (stored [K, NP]).
  const int width[ROW_FIELDS] = {R, 1, R, 2, 1, T, T, T, 1, 1, 1, K};
  const int esize[ROW_FIELDS] = {8, 8, 8, 8, 4, 4, 4, 4, 1, 1, 4, 4};
  bool in_place = true;
  for (int f = 0; f < ROW_FIELDS; ++f) {
    a.old_f[f] = static_cast<const uint8_t*>(olds[f]);
    a.new_f[f] = static_cast<uint8_t*>(news[f]);
    a.row_f[f] = packed + offs[f];
    a.width[f] = width[f];
    a.esize[f] = esize[f];
    in_place &= olds[f] == news[f];
  }
  if (NP == 0 || (in_place && D == 0)) return 0;
  const int blocks = (NP + SCATTER_BLOCK_ROWS - 1) / SCATTER_BLOCK_ROWS;
  scatter_rows_kernel<<<blocks, SCATTER_THREADS, 0, stream>>>(a, NP, D, idx);
  return (int)cudaGetLastError();
}
