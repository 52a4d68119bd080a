// static_masks: the per-batch node gates of the JAX package's
// _static_masks + _tolerates (ops/kernel.py:105-150), plus the folded
// static_ok that schedule_batch derives from them (:304).
//
// Bound: bytes. A row reads its T taints of each kind and its flags, the
// batch's L tolerations are read once, and a row writes six byte-wide
// verdicts and an int64 count; nothing but the tolerations is read by
// more than one row. So the kernel is one pass, a thread a row: the block
// stages the L tolerations in shared memory once (stage_tolerations; a
// batch without tolerations takes an instantiation with no shared memory
// and no barrier) and each thread reads its row's taints in
// device memory, T words apart from its neighbours': a warp's first load
// of a kind brings its 32 rows' taints into L1 (four 128-byte lines at
// T = 4), its other T - 1 loads hit there. It runs taint_verdict and
// static_verdicts (kernels.cuh, shared with dry_run_preemption's
// static_row) and writes its verdicts, neighbouring threads on
// neighbouring bytes. Staging the rows' taint slabs in shared memory
// (128- and 256-row blocks) measured 0.35-0.45 us slower a launch at
// L = 0, and 16-byte vector loads of a row 0.07-0.2 us slower
// (ab_windows.py --gates against this layout, NVIDIA H100 80GB HBM3,
// 700.00 W).
#include "kernels.cuh"

#define SM_ROWS 256  // rows (threads) a block

// TOLS: the batch has tolerations (L > 0), staged once a block; a batch
// without takes the instantiation with no shared memory and no barrier.
template <bool TOLS>
__global__ void static_masks_kernel(
    StaticFeat s, int NP, uint8_t* taint_ok, int64_t* pns_cnt, uint8_t* sel_ok,
    uint8_t* name_ok, uint8_t* unsched_ok, uint8_t* exist_anti_ok, uint8_t* static_ok) {
  extern __shared__ int4 sm_tol[];
  int32_t* lk = reinterpret_cast<int32_t*>(sm_tol);
  const int L = TOLS ? s.L : 0;
  const int n = blockIdx.x * SM_ROWS + threadIdx.x;
  if (TOLS) {
    stage_tolerations(s, lk);
    __syncthreads();
  }
  if (n >= NP) return;
  const int64_t at = (int64_t)n * s.T;
  bool untolerated = false;
  int64_t pns = 0;
  for (int t = 0; t < s.T; ++t) {
    taint_verdict(s.taint_key[at + t], s.taint_val[at + t], s.taint_eff[at + t], L, lk,
                  lk + L, lk + 2 * L, lk + 3 * L, untolerated, pns);
  }
  const StaticRow r = static_verdicts(static_gates(s, n), untolerated, pns);
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
  const int blocks = (NP + SM_ROWS - 1) / SM_ROWS;
  const StaticFeat s{T, L, taint_key, taint_val, taint_eff, tol_key, tol_val, tol_eff,
                      tol_op, (const uint8_t*)sel_match, node_name_id, name_id,
                      (const uint8_t*)unsched, tolerates_unsched, exist_anti, enable,
                      (const uint8_t*)valid, (const uint8_t*)extra_ok};
  const size_t smem = (size_t)16 * L;
  if (smem > STAGE_SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (L > 0) {
    static_masks_kernel<true><<<blocks, SM_ROWS, smem, stream>>>(
        s, NP, (uint8_t*)taint_ok, pns_cnt, (uint8_t*)sel_ok, (uint8_t*)name_ok,
        (uint8_t*)unsched_ok, (uint8_t*)exist_anti_ok, (uint8_t*)static_ok);
  } else {
    static_masks_kernel<false><<<blocks, SM_ROWS, 0, stream>>>(
        s, NP, (uint8_t*)taint_ok, pns_cnt, (uint8_t*)sel_ok, (uint8_t*)name_ok,
        (uint8_t*)unsched_ok, (uint8_t*)exist_anti_ok, (uint8_t*)static_ok);
  }
  return (int)cudaGetLastError();
}
