// scatter_rows: the device mirror's dirty-row scatter, the JAX package's
// _scatter_rows (ops/device_state.py:128-135): the re-encoded host rows of
// D dirty nodes written into every DeviceNodeState field at once — the
// twelve per-row fields, and `topo` along its node axis.
//
// The host packs the dirty rows by element type: src64 [D, 2R + 3] holds
// alloc_r | alloc_pods | req_r | nonzero, src32 [D, 3T + 2 + K] holds
// pod_count | taint_key | taint_val | taint_eff | name_id | topo's K axis
// values, srcb [D, 2] holds unsched | valid. One launch, one thread per
// (dirty row, packed element), writes each element to its field at
// idx[d]; topo's element k of row d goes to topo[k, idx[d]].
//
// Bound: bytes. Each dirty row is read once from the packs and written
// once into the fields, (2R + 3) * 8 + (3T + 2 + K) * 4 + 2 bytes a row;
// a thread moves one element, so neighbouring threads write neighbouring
// elements of a row's field.
#include "kernels.cuh"

__global__ void scatter_rows_kernel(
    int NP, int D, int R, int T, int K, const int32_t* __restrict__ idx,
    const int64_t* __restrict__ src64, const int32_t* __restrict__ src32,
    const uint8_t* __restrict__ srcb, int64_t* alloc_r, int64_t* alloc_pods, int64_t* req_r,
    int64_t* nonzero, int32_t* pod_count, int32_t* taint_key, int32_t* taint_val,
    int32_t* taint_eff, uint8_t* unsched, uint8_t* valid, int32_t* name_id, int32_t* topo) {
  const int W64 = 2 * R + 3, W32 = 3 * T + 2 + K, W = W64 + W32 + 2;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= (int64_t)D * W) return;
  const int d = (int)(tid / W);
  int c = (int)(tid % W);
  const int64_t row = idx[d];
  if (c < W64) {
    const int64_t v = src64[(int64_t)d * W64 + c];
    if (c < R) alloc_r[row * R + c] = v;
    else if (c == R) alloc_pods[row] = v;
    else if (c < 2 * R + 1) req_r[row * R + (c - R - 1)] = v;
    else nonzero[row * 2 + (c - 2 * R - 1)] = v;
    return;
  }
  c -= W64;
  if (c < W32) {
    const int32_t v = src32[(int64_t)d * W32 + c];
    if (c == 0) pod_count[row] = v;
    else if (c < 1 + T) taint_key[row * T + (c - 1)] = v;
    else if (c < 1 + 2 * T) taint_val[row * T + (c - 1 - T)] = v;
    else if (c < 1 + 3 * T) taint_eff[row * T + (c - 1 - 2 * T)] = v;
    else if (c == 1 + 3 * T) name_id[row] = v;
    else topo[(int64_t)(c - 2 - 3 * T) * NP + row] = v;
    return;
  }
  c -= W32;
  const uint8_t v = srcb[(int64_t)d * 2 + c];
  if (c == 0) unsched[row] = v;
  else valid[row] = v;
}

extern "C" int launch_scatter_rows(
    int NP, int D, int R, int T, int K, const int32_t* idx, const int64_t* src64,
    const int32_t* src32, const bool* srcb, int64_t* alloc_r, int64_t* alloc_pods,
    int64_t* req_r, int64_t* nonzero, int32_t* pod_count, int32_t* taint_key,
    int32_t* taint_val, int32_t* taint_eff, bool* unsched, bool* valid, int32_t* name_id,
    int32_t* topo, cudaStream_t stream) {
  const int64_t total = (int64_t)D * (2 * R + 3 + 3 * T + 2 + K + 2);
  if (total == 0) return 0;
  const int threads = 256;
  const int blocks = (int)((total + threads - 1) / threads);
  scatter_rows_kernel<<<blocks, threads, 0, stream>>>(
      NP, D, R, T, K, idx, src64, src32, (const uint8_t*)srcb, alloc_r, alloc_pods, req_r,
      nonzero, pod_count, taint_key, taint_val, taint_eff, (uint8_t*)unsched,
      (uint8_t*)valid, name_id, topo);
  return (int)cudaGetLastError();
}
