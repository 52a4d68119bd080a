// static_masks: the per-batch node gates of the JAX package's
// _static_masks + _tolerates (ops/kernel.py:105-150), plus the folded
// static_ok that schedule_batch derives from them (:304).
//
// Bound: bytes. One thread per node row reads its T taints and the batch's
// L tolerations (a few hundred bytes a row) and writes seven bytes-wide
// verdicts; there is no reuse across rows to exploit, so the kernel is a
// single coalesced pass. The row function (static_row in kernels.cuh) is
// shared with dry_run_preemption.
#include "kernels.cuh"

__global__ void static_masks_kernel(
    StaticFeat s, int NP, uint8_t* taint_ok, int64_t* pns_cnt, uint8_t* sel_ok,
    uint8_t* name_ok, uint8_t* unsched_ok, uint8_t* exist_anti_ok, uint8_t* static_ok) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= NP) return;
  const StaticRow r = static_row(s, n);
  taint_ok[n] = r.taint_ok;
  pns_cnt[n] = r.pns_cnt;
  sel_ok[n] = r.sel_ok;
  name_ok[n] = r.name_ok;
  unsched_ok[n] = r.unsched_ok;
  exist_anti_ok[n] = r.exist_anti_ok;
  static_ok[n] = r.static_ok;
}

extern "C" int launch_static_masks(
    int NP, int T, int L, const int32_t* taint_key, const int32_t* taint_val,
    const int32_t* taint_eff, const int32_t* tol_key, const int32_t* tol_val,
    const int32_t* tol_eff, const int32_t* tol_op, const bool* sel_match,
    const int32_t* node_name_id, const int32_t* name_id, const bool* unsched,
    const int32_t* tolerates_unsched, const int32_t* exist_anti, const int32_t* enable,
    const bool* valid, const bool* extra_ok, bool* taint_ok, int64_t* pns_cnt,
    bool* sel_ok, bool* name_ok, bool* unsched_ok, bool* exist_anti_ok,
    bool* static_ok, cudaStream_t stream) {
  if (NP == 0) return 0;
  const int threads = 256;
  const int blocks = (NP + threads - 1) / threads;
  const StaticFeat s{T, L, taint_key, taint_val, taint_eff, tol_key, tol_val, tol_eff,
                      tol_op, (const uint8_t*)sel_match, node_name_id, name_id,
                      (const uint8_t*)unsched, tolerates_unsched, exist_anti, enable,
                      (const uint8_t*)valid, (const uint8_t*)extra_ok};
  static_masks_kernel<<<blocks, threads, 0, stream>>>(
      s, NP, (uint8_t*)taint_ok, pns_cnt, (uint8_t*)sel_ok, (uint8_t*)name_ok,
      (uint8_t*)unsched_ok, (uint8_t*)exist_anti_ok, (uint8_t*)static_ok);
  return (int)cudaGetLastError();
}
