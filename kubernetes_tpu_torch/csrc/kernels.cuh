// Shared device code for the port's hand-written Hopper kernels: exact
// floored integer division, the fit/score row evaluation that every kernel
// inlines, and the single-block scan and reduction the persistent kernels
// use. All arithmetic is int64/int32, matching the JAX package bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

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

// _resource_eval (ops/kernel.py of the JAX package, :160-208) for one node
// row: the fit filter (with the nominated lane; nom_row may be null), the
// LeastAllocated/MostAllocated score over fit_slots, and BalancedAllocation
// quantized at BA_SCALE.
__device__ __forceinline__ void resource_eval_row(
    const ResFeat& f, const int64_t* alloc_row, int64_t alloc_pods,
    const int64_t* req_row, const int64_t* nz_row, int32_t pod_count,
    const int64_t* nom_row, int32_t nom_pods,
    bool& fit_ok, int64_t& fit_sc, int64_t& ba) {
  const bool pods_ok = (int64_t)(pod_count + nom_pods + 1) <= alloc_pods;
  bool viol = false;
  for (int r = 0; r < f.R; ++r) {
    const int64_t avail = alloc_row[r] - req_row[r] - (nom_row ? nom_row[r] : 0);
    const int64_t q = f.request[r];
    viol |= (q > 0) && (q > avail);
  }
  fit_ok = (pods_ok && (!viol || *f.has_request == 0)) || f.enable[4] == 0;
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
      rs = (alloc > 0 && used <= alloc) ? floor_div((alloc - used) * MAX_NODE_SCORE, a1) : 0;
    } else {
      rs = alloc > 0 ? floor_div((used < alloc ? used : alloc) * MAX_NODE_SCORE, a1) : 0;
    }
    if (alloc > 0) {
      num += rs * w;
      den += w;
    }
  }
  fit_sc = den > 0 ? floor_div(num, den > 1 ? den : 1) : 0;
  const int64_t a_cpu = alloc_row[0], a_mem = alloc_row[1];
  int64_t q_cpu = floor_div(used0 * BA_SCALE, a_cpu > 1 ? a_cpu : 1);
  int64_t q_mem = floor_div(used1 * BA_SCALE, a_mem > 1 ? a_mem : 1);
  q_cpu = q_cpu < BA_SCALE ? q_cpu : BA_SCALE;
  q_mem = q_mem < BA_SCALE ? q_mem : BA_SCALE;
  const int64_t diff = q_cpu > q_mem ? q_cpu - q_mem : q_mem - q_cpu;
  const int64_t ba_val = (a_cpu > 0 && a_mem > 0)
      ? floor_div(MAX_NODE_SCORE * BA_SCALE - 50 * diff, BA_SCALE)
      : (int64_t)MAX_NODE_SCORE;
  ba = *f.ba_skip == 1 ? 0 : ba_val;
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
