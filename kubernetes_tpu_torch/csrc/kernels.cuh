// Shared device code for the port's hand-written Hopper kernels: exact
// floored integer division, the fit/score row evaluation that every kernel
// inlines, and the single-block scan and reduction the persistent kernels
// use. All arithmetic is int64/int32, matching the JAX package bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <cmath>

// Block size of the single-CTA persistent kernels (lap_schedule,
// scan_schedule). A power of two: the reductions below halve it.
#ifndef KTT_BLOCK
#define KTT_BLOCK 1024
#endif

#define LAP_MAX 32
#define MAX_NODE_SCORE 100
#define BA_SCALE 1000000LL

// Marks a launcher's pointer argument that may be null. The launchers'
// signatures are the port's single statement of each kernel's arguments:
// ops/_build.py reads them to type the ctypes call and to check every
// tensor's dtype before the launch, so a launcher takes typed pointers
// (bool* for torch.bool) and never void*.
#define OPTIONAL
// Marks a pointer the launcher reads on the host (a CPU tensor), never
// the kernel.
#define HOST
// Marks a pointer that may be device memory of the launch's card or
// pinned host memory mapped into its address space (a pinned CPU tensor).
#define MAPPED

// Taint-effect and toleration-operator ids (ops/codebook.py).
#define EFFECT_NO_SCHEDULE 1
#define EFFECT_PREFER_NO_SCHEDULE 2
#define EFFECT_NO_EXECUTE 3
#define OP_EXISTS 1

// The reference relies on Python's floored `//` and `%`; C++ truncates
// toward zero. These give the floored results for any signs.
__device__ __forceinline__ int64_t floor_div(int64_t a, int64_t b) {
  int64_t q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

__device__ __forceinline__ int64_t floor_mod(int64_t a, int64_t b) {
  int64_t r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}

// The batch's resource features (ops/features.py BatchFeatures fields).
struct ResFeat {
  const int64_t* request;      // [R]
  const int64_t* nz_request;   // [2]
  const int64_t* has_request;  // scalar
  const int64_t* ba_skip;      // scalar
  const int32_t* enable;       // [5]
  const int32_t* fit_slots;    // [FR]
  const int64_t* fit_weights;  // [FR]
  int R;
  int FR;
  int fit_strategy;            // 0 = LeastAllocated, 1 = MostAllocated
};

// The fit filter of _resource_eval (ops/kernel.py of the JAX package,
// :175-179) for one node row, with the nominated lane (nom_row may be null:
// no lane) counted against the filter only.
__device__ __forceinline__ bool fit_ok_row(
    const ResFeat& f, const int64_t* alloc_row, int64_t alloc_pods,
    const int64_t* req_row, int32_t pod_count, const int64_t* nom_row, int32_t nom_pods) {
  const bool pods_ok = (int64_t)(pod_count + nom_pods + 1) <= alloc_pods;
  bool viol = false;
  for (int r = 0; r < f.R; ++r) {
    const int64_t avail = alloc_row[r] - req_row[r] - (nom_row ? nom_row[r] : 0);
    const int64_t q = f.request[r];
    viol |= (q > 0) && (q > avail);
  }
  return (pods_ok && (!viol || *f.has_request == 0)) || f.enable[4] == 0;
}

// Python's floored //, resource_eval_row's division by a row's values.
struct FloorDiv {
  __device__ __forceinline__ int64_t operator()(int64_t a, int64_t b) const {
    return floor_div(a, b);
  }
};

// _resource_eval (:160-208) for one node row: the fit filter, the
// LeastAllocated/MostAllocated score over fit_slots, and BalancedAllocation
// quantized at BA_SCALE. `div` divides by the row's values; a kernel may
// pass another exact floored division (LapDiv, below).
template <class Div = FloorDiv>
__device__ __forceinline__ void resource_eval_row(
    const ResFeat& f, const int64_t* alloc_row, int64_t alloc_pods,
    const int64_t* req_row, const int64_t* nz_row, int32_t pod_count,
    const int64_t* nom_row, int32_t nom_pods,
    bool& fit_ok, int64_t& fit_sc, int64_t& ba, Div div = Div()) {
  fit_ok = fit_ok_row(f, alloc_row, alloc_pods, req_row, pod_count, nom_row, nom_pods);
  const int64_t used0 = nz_row[0] + f.nz_request[0];
  const int64_t used1 = nz_row[1] + f.nz_request[1];
  int64_t num = 0, den = 0;
  for (int j = 0; j < f.FR; ++j) {
    const int s = f.fit_slots[j];
    const int64_t w = f.fit_weights[j];
    const int64_t alloc = alloc_row[s];
    const int64_t used = s == 0 ? used0 : (s == 1 ? used1 : req_row[s] + f.request[s]);
    const int64_t a1 = alloc > 1 ? alloc : 1;
    int64_t rs;
    if (f.fit_strategy == 0) {
      rs = (alloc > 0 && used <= alloc) ? div((alloc - used) * MAX_NODE_SCORE, a1) : 0;
    } else {
      rs = alloc > 0 ? div((used < alloc ? used : alloc) * MAX_NODE_SCORE, a1) : 0;
    }
    if (alloc > 0) {
      num += rs * w;
      den += w;
    }
  }
  fit_sc = den > 0 ? div(num, den > 1 ? den : 1) : 0;
  const int64_t a_cpu = alloc_row[0], a_mem = alloc_row[1];
  int64_t q_cpu = div(used0 * BA_SCALE, a_cpu > 1 ? a_cpu : 1);
  int64_t q_mem = div(used1 * BA_SCALE, a_mem > 1 ? a_mem : 1);
  q_cpu = q_cpu < BA_SCALE ? q_cpu : BA_SCALE;
  q_mem = q_mem < BA_SCALE ? q_mem : BA_SCALE;
  const int64_t diff = q_cpu > q_mem ? q_cpu - q_mem : q_mem - q_cpu;
  const int64_t ba_val = (a_cpu > 0 && a_mem > 0)
      ? floor_div(MAX_NODE_SCORE * BA_SCALE - 50 * diff, BA_SCALE)
      : (int64_t)MAX_NODE_SCORE;
  ba = *f.ba_skip == 1 ? 0 : ba_val;
}

// The batch's static-filter inputs (_static_masks + _tolerates, :105-150):
// per-node taints [NP, T] and flags, the pod's tolerations [L] and gates.
struct StaticFeat {
  int T, L;
  const int32_t* taint_key;
  const int32_t* taint_val;
  const int32_t* taint_eff;
  const int32_t* tol_key;
  const int32_t* tol_val;
  const int32_t* tol_eff;
  const int32_t* tol_op;
  const uint8_t* sel_match;
  const int32_t* node_name_id;  // scalar
  const int32_t* name_id;
  const uint8_t* unsched;
  const int32_t* tolerates_unsched;  // scalar
  const int32_t* exist_anti;
  const int32_t* enable;
  const uint8_t* valid;
  const uint8_t* extra_ok;
};

struct StaticRow {
  bool taint_ok, sel_ok, name_ok, unsched_ok, exist_anti_ok, static_ok;
  int64_t pns_cnt;
};

// Row n's static verdicts and the folded static_ok (:304).
__device__ __forceinline__ StaticRow static_row(const StaticFeat& s, int n) {
  bool untolerated = false;
  int64_t pns = 0;
  for (int t = 0; t < s.T; ++t) {
    const int32_t k = s.taint_key[(int64_t)n * s.T + t];
    const int32_t v = s.taint_val[(int64_t)n * s.T + t];
    const int32_t e = s.taint_eff[(int64_t)n * s.T + t];
    bool tolerated = false, pns_tolerated = false;
    for (int l = 0; l < s.L; ++l) {
      const int32_t te = s.tol_eff[l];
      const bool match = (te == 0 || te == e) && (s.tol_key[l] == 0 || s.tol_key[l] == k) &&
                         (s.tol_op[l] == OP_EXISTS || s.tol_val[l] == v);
      tolerated |= match;
      pns_tolerated |= match && (te == 0 || te == EFFECT_PREFER_NO_SCHEDULE);
    }
    if ((e == EFFECT_NO_SCHEDULE || e == EFFECT_NO_EXECUTE) && !tolerated) untolerated = true;
    if (e == EFFECT_PREFER_NO_SCHEDULE && !pns_tolerated) ++pns;
  }
  const int32_t want = *s.node_name_id;
  StaticRow r;
  r.taint_ok = !untolerated || s.enable[2] == 0;
  r.sel_ok = s.sel_match[n] || s.enable[3] == 0;
  r.name_ok = want == 0 || s.name_id[n] == want || s.enable[0] == 0;
  r.unsched_ok = !s.unsched[n] || *s.tolerates_unsched == 1 || s.enable[1] == 0;
  r.exist_anti_ok = s.exist_anti[n] == 0;
  r.static_ok = s.valid[n] && r.name_ok && r.unsched_ok && r.taint_ok && r.sel_ok &&
                r.exist_anti_ok && s.extra_ok[n];
  r.pns_cnt = pns;
  return r;
}

// Inclusive prefix sum over the block (Hillis-Steele in shared memory);
// every thread of the block must call it. sm holds blockDim.x ints.
__device__ __forceinline__ int block_inclusive_scan(int v, int* sm) {
  const int tid = threadIdx.x, nt = blockDim.x;
  sm[tid] = v;
  __syncthreads();
  for (int off = 1; off < nt; off <<= 1) {
    const int t = tid >= off ? sm[tid - off] : 0;
    __syncthreads();
    sm[tid] += t;
    __syncthreads();
  }
  return sm[tid];
}

// Max of two int64 lanes over the block (tree in shared memory, blockDim.x
// a power of two); the results are left in a[0] and b[0].
__device__ __forceinline__ void block_max2(long long va, long long vb,
                                          long long* a, long long* b) {
  const int tid = threadIdx.x;
  a[tid] = va;
  b[tid] = vb;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (tid < s) {
      if (a[tid + s] > a[tid]) a[tid] = a[tid + s];
      if (b[tid + s] > b[tid]) b[tid] = b[tid + s];
    }
    __syncthreads();
  }
}

// The landed-row helpers of the persistent laps (lap_schedule.cu and
// sharded_lap.cu): static, so that each object keeps its own copy.

// floor_div for a positive divisor, from a float64 quotient: while the
// quotient's magnitude is below 2^50 its float64 value is within 0.4 of
// the true one, so its floor is off by at most one, and the exact int64
// remainder (which then lies in [-b, 2b)) corrects it. Operands that fit
// 31 bits take an unsigned 32-bit division, others floor_div. The same
// results, without int64 division's long sequence.
static __device__ __noinline__ int64_t lap_floor_div_wide(int64_t a, int64_t b) { return floor_div(a, b); }

static __device__ __forceinline__ int64_t lap_floor_div(int64_t a, int64_t b) {
  if (a >= 0 && a <= INT_MAX && b > 0 && b <= INT_MAX) return (uint32_t)a / (uint32_t)b;
  if (b > 0 && b < ((int64_t)1 << 62)) {
    const double d = (double)a / (double)b;
    if (fabs(d) < 1125899906842624.0) {  // 2^50
      const int64_t q = (int64_t)floor(d);
      const int64_t r = a - q * b;
      return q - (r < 0) + (r >= b);
    }
  }
  return lap_floor_div_wide(a, b);  // a call: rare, and the kernel stays small
}

struct LapDiv {
  __device__ __forceinline__ int64_t operator()(int64_t a, int64_t b) const {
    return lap_floor_div(a, b);
  }
};

// resource_eval_row of a landed row on the 32 lanes of its warp, so that
// its int64 divisions run side by side: lane r tests resource r of the fit
// filter, lane j scores fit slot j, the next two lanes take
// BalancedAllocation's cpu and memory shares, and lane 0 sums the slots
// (int64 sums wrap the same in any order) and returns (fit_ok, fit_sc, ba),
// bit for bit resource_eval_row's (its divisions by a row's values as
// lap_floor_div).
// The scalars (alloc_pods, pod_count, nom_pods) are read on lane 0 only.
template <bool NOM>
static __device__ __forceinline__ void lap_eval_landed(
    const ResFeat& f, const int64_t* alloc_row, int64_t alloc_pods, const int64_t* req_row,
    const int64_t* nz_row, int32_t pod_count, const int64_t* nom_row, int32_t nom_pods,
    int lane, bool& fit_ok, int64_t& fit_sc, int64_t& ba) {
  bool viol = false;
  for (int r = lane; r < f.R; r += 32) {
    const int64_t avail = alloc_row[r] - req_row[r] - (NOM ? nom_row[r] : 0);
    const int64_t q = f.request[r];
    viol |= (q > 0) && (q > avail);
  }
  viol = __any_sync(0xffffffffu, viol);
  const int64_t used0 = nz_row[0] + f.nz_request[0];
  const int64_t used1 = nz_row[1] + f.nz_request[1];
  // Division jobs: job k < FR scores fit slot k, jobs FR and FR + 1 take
  // the cpu and memory shares; lane k mod 32 runs job k, and the jobs'
  // divisions run as one pass of the warp.
  int64_t num = 0, den = 0, share = 0;
  for (int k = lane; k < f.FR + 2; k += 32) {
    const bool slot = k < f.FR;
    const int s = slot ? f.fit_slots[k] : k - f.FR;
    const int64_t alloc = alloc_row[s];
    const int64_t used = s == 0 ? used0 : (s == 1 ? used1 : req_row[s] + f.request[s]);
    const int64_t a1 = alloc > 1 ? alloc : 1;
    const int64_t n = !slot ? used * BA_SCALE
                    : f.fit_strategy == 0 ? (alloc - used) * MAX_NODE_SCORE
                                          : (used < alloc ? used : alloc) * MAX_NODE_SCORE;
    const int64_t q = lap_floor_div(n, a1);
    if (!slot) {
      share = q < BA_SCALE ? q : BA_SCALE;
    } else if (alloc > 0) {
      const bool scored = f.fit_strategy != 0 || used <= alloc;
      num += (scored ? q : 0) * f.fit_weights[k];
      den += f.fit_weights[k];
    }
  }
  for (int j = 1; j < 32 && j < f.FR; ++j) {
    const int64_t nj = __shfl_sync(0xffffffffu, num, j), dj = __shfl_sync(0xffffffffu, den, j);
    if (lane == 0) {
      num += nj;
      den += dj;
    }
  }
  const int64_t q_cpu = __shfl_sync(0xffffffffu, share, f.FR & 31);
  const int64_t q_mem = __shfl_sync(0xffffffffu, share, (f.FR + 1) & 31);
  if (lane == 0) {
    const bool pods_ok = (int64_t)(pod_count + nom_pods + 1) <= alloc_pods;
    fit_ok = (pods_ok && (!viol || *f.has_request == 0)) || f.enable[4] == 0;
    fit_sc = den > 0 ? lap_floor_div(num, den > 1 ? den : 1) : 0;
    const int64_t diff = q_cpu > q_mem ? q_cpu - q_mem : q_mem - q_cpu;
    const int64_t ba_val = (alloc_row[0] > 0 && alloc_row[1] > 0)
        ? floor_div(MAX_NODE_SCORE * BA_SCALE - 50 * diff, BA_SCALE)
        : (int64_t)MAX_NODE_SCORE;
    ba = *f.ba_skip == 1 ? 0 : ba_val;
  }
}
