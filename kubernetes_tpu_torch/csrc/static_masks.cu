// static_masks: the per-batch node gates of the JAX package's
// _static_masks + _tolerates (ops/kernel.py:105-150), plus the folded
// static_ok that schedule_batch derives from them (:304).
//
// Bound: bytes. One thread per node row reads its T taints and the batch's
// L tolerations (a few hundred bytes a row) and writes seven bytes-wide
// verdicts; there is no reuse across rows to exploit, so the kernel is a
// single coalesced pass.
#include "kernels.cuh"

__global__ void static_masks_kernel(
    int NP, int T, int L,
    const int32_t* __restrict__ taint_key, const int32_t* __restrict__ taint_val,
    const int32_t* __restrict__ taint_eff,
    const int32_t* __restrict__ tol_key, const int32_t* __restrict__ tol_val,
    const int32_t* __restrict__ tol_eff, const int32_t* __restrict__ tol_op,
    const uint8_t* __restrict__ sel_match, const int32_t* __restrict__ node_name_id,
    const int32_t* __restrict__ name_id, const uint8_t* __restrict__ unsched,
    const int32_t* __restrict__ tolerates_unsched, const int32_t* __restrict__ exist_anti,
    const int32_t* __restrict__ enable, const uint8_t* __restrict__ valid,
    const uint8_t* __restrict__ extra_ok,
    uint8_t* taint_ok, int64_t* pns_cnt, uint8_t* sel_ok, uint8_t* name_ok,
    uint8_t* unsched_ok, uint8_t* exist_anti_ok, uint8_t* static_ok) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= NP) return;
  bool untolerated = false;
  int64_t pns = 0;
  for (int t = 0; t < T; ++t) {
    const int32_t k = taint_key[(int64_t)n * T + t];
    const int32_t v = taint_val[(int64_t)n * T + t];
    const int32_t e = taint_eff[(int64_t)n * T + t];
    bool tolerated = false, pns_tolerated = false;
    for (int l = 0; l < L; ++l) {
      const int32_t te = tol_eff[l];
      const bool match = (te == 0 || te == e) && (tol_key[l] == 0 || tol_key[l] == k) &&
                         (tol_op[l] == OP_EXISTS || tol_val[l] == v);
      tolerated |= match;
      pns_tolerated |= match && (te == 0 || te == EFFECT_PREFER_NO_SCHEDULE);
    }
    if ((e == EFFECT_NO_SCHEDULE || e == EFFECT_NO_EXECUTE) && !tolerated) untolerated = true;
    if (e == EFFECT_PREFER_NO_SCHEDULE && !pns_tolerated) ++pns;
  }
  const int32_t want = *node_name_id;
  const bool t_ok = !untolerated || enable[2] == 0;
  const bool s_ok = sel_match[n] || enable[3] == 0;
  const bool nm_ok = want == 0 || name_id[n] == want || enable[0] == 0;
  const bool u_ok = !unsched[n] || *tolerates_unsched == 1 || enable[1] == 0;
  const bool ea_ok = exist_anti[n] == 0;
  taint_ok[n] = t_ok;
  pns_cnt[n] = pns;
  sel_ok[n] = s_ok;
  name_ok[n] = nm_ok;
  unsched_ok[n] = u_ok;
  exist_anti_ok[n] = ea_ok;
  static_ok[n] = valid[n] && nm_ok && u_ok && t_ok && s_ok && ea_ok && extra_ok[n];
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
  static_masks_kernel<<<blocks, threads, 0, stream>>>(
      NP, T, L, taint_key, taint_val, taint_eff, tol_key, tol_val, tol_eff, tol_op,
      (const uint8_t*)sel_match, node_name_id, name_id, (const uint8_t*)unsched,
      tolerates_unsched, exist_anti, enable, (const uint8_t*)valid, (const uint8_t*)extra_ok,
      (uint8_t*)taint_ok, pns_cnt, (uint8_t*)sel_ok, (uint8_t*)name_ok,
      (uint8_t*)unsched_ok, (uint8_t*)exist_anti_ok, (uint8_t*)static_ok);
  return (int)cudaGetLastError();
}
