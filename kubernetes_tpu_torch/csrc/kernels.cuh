// Shared device code for the port's hand-written Hopper kernels: exact
// floored integer division, the fit/score row evaluation that every kernel
// inlines, and the landed-row helpers of the laps. All arithmetic is
// int64/int32, matching the JAX package bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <cmath>

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

// Where a block reads its rows' taints (the [rows, T] slab of each taint
// array from row `first` on) and the batch's L tolerations: shared memory
// once stage_static has copied them there, else device memory.
struct StaticStage {
  int first;
  const int32_t *tk, *tv, *te;
  const int32_t *lk, *lv, *le, *lo;
};

// Dynamic shared memory a block may take without an opt-in attribute.
#define STAGE_SMEM_MAX (48 * 1024)

// Shared memory stage_static takes for `rows` rows: three [rows, T] int32
// taint slabs and four [L] int32 toleration arrays. With rows a multiple
// of 4 every slab starts 16-byte aligned.
static __host__ __device__ __forceinline__ size_t static_stage_bytes(int rows, int T, int L) {
  return (size_t)12 * rows * T + (size_t)16 * L;
}

// Every thread of the block copies tolerations tid, tid + blockDim, ...
// into lk[0, L) (keys), [L, 2L) (values), [2L, 3L) (effects) and [3L, 4L)
// (operators) of shared memory, its loads issued before its stores.
static __device__ __forceinline__ void stage_tolerations(const StaticFeat& s, int32_t* lk) {
  const int L = s.L;
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    const int32_t a = __ldg(s.tol_key + l), b = __ldg(s.tol_val + l);
    const int32_t c = __ldg(s.tol_eff + l), d = __ldg(s.tol_op + l);
    lk[l] = a;
    lk[L + l] = b;
    lk[2 * L + l] = c;
    lk[3 * L + l] = d;
  }
}

// The stage of a block's rows [n0, n0 + rows). STAGED: every thread of
// the block copies the tolerations and the rows' taint slabs (contiguous
// in each [NP, T] array) into `sm` (static_stage_bytes(cap, T, L),
// 16-byte aligned, cap >= rows), a thread's loads issued before its
// stores: 16-byte vector loads where the slabs are 16-byte aligned, one
// word a thread for the tail. The caller syncs the block before reading.
// Otherwise the stage points into device memory.
template <bool STAGED>
static __device__ __forceinline__ StaticStage stage_static(const StaticFeat& s, int n0, int rows,
                                                           int cap, int32_t* sm) {
  const int64_t off = (int64_t)n0 * s.T;
  const int32_t* __restrict__ sk = s.taint_key + off;
  const int32_t* __restrict__ sv = s.taint_val + off;
  const int32_t* __restrict__ se = s.taint_eff + off;
  if (!STAGED) return StaticStage{n0, sk, sv, se, s.tol_key, s.tol_val, s.tol_eff, s.tol_op};
  const int slab = cap * s.T, count = rows * s.T, L = s.L, tid = threadIdx.x;
  int32_t* dk = sm;
  int32_t* dv = sm + slab;
  int32_t* de = sm + 2 * slab;
  int32_t* lk = sm + 3 * slab;
  stage_tolerations(s, lk);
  const bool vec = ((reinterpret_cast<uintptr_t>(sk) | reinterpret_cast<uintptr_t>(sv) |
                     reinterpret_cast<uintptr_t>(se)) & 15) == 0;
  const int nv = vec ? count >> 2 : 0;
  for (int i = tid; i < nv; i += blockDim.x) {
    const int4 a = __ldg(reinterpret_cast<const int4*>(sk) + i);
    const int4 b = __ldg(reinterpret_cast<const int4*>(sv) + i);
    const int4 c = __ldg(reinterpret_cast<const int4*>(se) + i);
    reinterpret_cast<int4*>(dk)[i] = a;
    reinterpret_cast<int4*>(dv)[i] = b;
    reinterpret_cast<int4*>(de)[i] = c;
  }
  for (int i = 4 * nv + tid; i < count; i += blockDim.x) {
    const int32_t a = __ldg(sk + i), b = __ldg(sv + i), c = __ldg(se + i);
    dk[i] = a;
    dv[i] = b;
    de[i] = c;
  }
  return StaticStage{n0, dk, dv, de, lk, lk + L, lk + 2 * L, lk + 3 * L};
}

// Row n's gates other than its taints (:304): node name, unschedulable,
// selector and existing anti-affinity, valid & extra_ok, and whether the
// taint gate is on. Read apart
// from the taints so that a kernel can issue these loads with its stage.
struct StaticGates {
  bool sel_ok, name_ok, unsched_ok, exist_anti_ok, live, taints_off;
};

static __device__ __forceinline__ StaticGates static_gates(const StaticFeat& s, int n) {
  const int32_t want = *s.node_name_id;
  StaticGates g;
  g.sel_ok = s.sel_match[n] || s.enable[3] == 0;
  g.name_ok = want == 0 || s.name_id[n] == want || s.enable[0] == 0;
  g.unsched_ok = !s.unsched[n] || *s.tolerates_unsched == 1 || s.enable[1] == 0;
  g.exist_anti_ok = s.exist_anti[n] == 0;
  g.live = s.valid[n] && s.extra_ok[n];
  g.taints_off = s.enable[2] == 0;
  return g;
}

// One taint (key k, value v, effect e) against the L tolerations: an
// untolerated NoSchedule or NoExecute taint sets `untolerated`, an
// untolerated PreferNoSchedule taint counts in `pns`.
static __device__ __forceinline__ void taint_verdict(int32_t k, int32_t v, int32_t e, int L,
                                                     const int32_t* lk, const int32_t* lv,
                                                     const int32_t* le, const int32_t* lo,
                                                     bool& untolerated, int64_t& pns) {
  bool tolerated = false, pns_tolerated = false;
  for (int l = 0; l < L; ++l) {
    const int32_t te = le[l];
    const bool match = (te == 0 || te == e) && (lk[l] == 0 || lk[l] == k) &&
                       (lo[l] == OP_EXISTS || lv[l] == v);
    tolerated |= match;
    pns_tolerated |= match && (te == 0 || te == EFFECT_PREFER_NO_SCHEDULE);
  }
  if ((e == EFFECT_NO_SCHEDULE || e == EFFECT_NO_EXECUTE) && !tolerated) untolerated = true;
  if (e == EFFECT_PREFER_NO_SCHEDULE && !pns_tolerated) ++pns;
}

// A row's static verdicts and the folded static_ok (:304) from its gates
// and its taints' verdicts.
static __device__ __forceinline__ StaticRow static_verdicts(const StaticGates& g,
                                                            bool untolerated, int64_t pns) {
  StaticRow r;
  r.taint_ok = !untolerated || g.taints_off;
  r.sel_ok = g.sel_ok;
  r.name_ok = g.name_ok;
  r.unsched_ok = g.unsched_ok;
  r.exist_anti_ok = g.exist_anti_ok;
  r.static_ok = g.live && r.name_ok && r.unsched_ok && r.taint_ok && r.sel_ok &&
                r.exist_anti_ok;
  r.pns_cnt = pns;
  return r;
}

// Row n's static verdicts with its taints and the tolerations read where
// `st` holds them (dry_run_preemption; static_masks runs the same
// taint_verdict and static_verdicts over a row in device memory).
static __device__ __forceinline__ StaticRow static_row(const StaticFeat& s, const StaticStage& st,
                                                       int n, const StaticGates& g) {
  const int64_t at = (int64_t)(n - st.first) * s.T;
  bool untolerated = false;
  int64_t pns = 0;
  for (int t = 0; t < s.T; ++t) {
    taint_verdict(st.tk[at + t], st.tv[at + t], st.te[at + t], s.L, st.lk, st.lv, st.le, st.lo,
                  untolerated, pns);
  }
  return static_verdicts(g, untolerated, pns);
}

// The landed-row helpers of the persistent laps (lap_schedule.cu and
// sharded_lap.cu): static, so that each object keeps its own copy.
// resource_eval.cu divides through LapDiv too, and whatif_score.cu falls
// back on lap_floor_div_wide.

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

// ---------------------------------------------------------------------------
// Copy-on-write of a row patch (scatter_rows, patch_carry_rows): a block owns
// a contiguous range of node rows, copies that range of every field from the
// old tensors into the new ones (cow_copy), then writes the patched rows of
// the range (pass_hits finds them in idx). Each row belongs to one block, so
// no ordering across blocks is needed; the barrier that ends cow_copy puts
// the copy of a row before its patch.
// ---------------------------------------------------------------------------

#define COW_CHUNK 32   // segments one cow_copy call takes (one warp's lanes)
#define COW_UNROLL 4   // 16-byte loads a thread keeps in flight

// One contiguous byte range of a field: the block's rows of it.
struct CowSeg {
  uint8_t* dst;
  const uint8_t* src;
  long long bytes;
};

// Exclusive prefix of v over the block's threads in thread order, and the
// total on every thread. `scratch`: blockDim.x / 32 ints of shared memory.
// Every thread calls it (blockDim.x a multiple of 32, at most 1024); it
// has two barriers, and the caller puts one before the next call.
static __device__ __forceinline__ int block_exclusive_scan(int v, int* scratch, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < warps ? scratch[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < warps) scratch[lane] = w;
  }
  __syncthreads();
  total = scratch[warps - 1];
  return x - v + (warp > 0 ? scratch[warp - 1] : 0);
}

// The block copies the n <= COW_CHUNK segments `seg` (shared memory, filled
// by the caller before the call): as 16-byte vectors where dst and src are
// both 16-byte aligned, COW_UNROLL loads a thread issued before their
// stores, all segments' vectors numbered as one range so that the block's
// loads are in flight together; bytes for a segment's tail past its last
// whole vector and for a segment that is not aligned (that loop is skipped
// when no segment has such bytes). A segment whose dst is its src (an
// in-place patch) is skipped. Every thread of the block calls it; it
// begins and ends with a barrier.
static __device__ void cow_copy(const CowSeg* seg, int n) {
  __shared__ long long vec_pre[COW_CHUNK + 1];  // vectors before each segment
  __shared__ int any_bytes;
  __syncthreads();
  if (threadIdx.x < 32) {
    const int s = threadIdx.x;
    long long v = 0, rest = 0;
    if (s < n && seg[s].dst != seg[s].src) {
      const bool aligned = ((reinterpret_cast<uintptr_t>(seg[s].dst) |
                             reinterpret_cast<uintptr_t>(seg[s].src)) & 15) == 0;
      v = aligned ? seg[s].bytes >> 4 : 0;
      rest = seg[s].bytes - (v << 4);
    }
    long long x = v;
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(0xffffffffu, x, o);
      if (s >= o) x += y;
    }
    if (s < n) vec_pre[s] = x - v;
    if (s == n - 1) vec_pre[n] = x;
    const bool bytes = __any_sync(0xffffffffu, rest != 0);
    if (s == 0) any_bytes = bytes;
  }
  __syncthreads();
  const long long total = vec_pre[n];
  int s = 0;
  for (long long base = threadIdx.x; base < total; base += (long long)blockDim.x * COW_UNROLL) {
    int4 v[COW_UNROLL];
    int4* d[COW_UNROLL];
#pragma unroll
    for (int u = 0; u < COW_UNROLL; ++u) {
      const long long i = base + (long long)u * blockDim.x;
      d[u] = nullptr;
      if (i < total) {
        while (i >= vec_pre[s + 1]) ++s;
        const long long k = i - vec_pre[s];
        v[u] = reinterpret_cast<const int4*>(seg[s].src)[k];
        d[u] = reinterpret_cast<int4*>(seg[s].dst) + k;
      }
    }
#pragma unroll
    for (int u = 0; u < COW_UNROLL; ++u)
      if (d[u] != nullptr) *d[u] = v[u];
  }
  if (any_bytes) {
    for (int t = 0; t < n; ++t) {
      if (seg[t].dst == seg[t].src) continue;
      const long long from = (vec_pre[t + 1] - vec_pre[t]) << 4;
      for (long long b = from + threadIdx.x; b < seg[t].bytes; b += blockDim.x)
        seg[t].dst[b] = seg[t].src[b];
    }
  }
  __syncthreads();
}

// This thread's U entries of the idx pass that starts at p0: entry
// j = p0 + u * blockDim.x + threadIdx.x (-1 past D). With DEDUP, an entry
// equal to the one before it in idx is -1 too: the caller's duplicates
// carry identical rows (a patch tier's padding repeats its last row), so
// one of a run of them writes what all of them would. A kernel issues its
// first pass's loads before its copy, so that they are in flight with it.
template <int U, bool DEDUP>
static __device__ __forceinline__ void pass_load(const int32_t* idx, int D, int p0, int (&row)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int j = p0 + u * blockDim.x + threadIdx.x;
    row[u] = j < D ? idx[j] : -1;
    if (DEDUP && j > 0 && j < D && idx[j - 1] == row[u]) row[u] = -1;
  }
}

// The entries of the pass (pass_load's `row`) whose row lies in [lo, hi),
// compacted into hits[0, n) (the entry) and hit_row[0, n) (its row), thread
// by thread, each thread's in entry order; n is returned on every thread.
// hits and hit_row hold blockDim.x * U ints each, `scratch` blockDim.x /
// 32. Every thread calls it; it ends with a barrier after the stores, and
// the caller puts one before the next call. A row outside [lo, hi) — one
// outside [0, NP) included — is no block's hit and is never written.
template <int U>
static __device__ __forceinline__ int pass_hits(int p0, const int (&row)[U], int lo, int hi,
                                                int* hits, int* hit_row, int* scratch) {
  int c = 0;
#pragma unroll
  for (int u = 0; u < U; ++u) c += row[u] >= lo && row[u] < hi;
  int total;
  int pos = block_exclusive_scan(c, scratch, total);
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (row[u] >= lo && row[u] < hi) {
      hits[pos] = p0 + u * blockDim.x + threadIdx.x;
      hit_row[pos++] = row[u];
    }
  }
  __syncthreads();
  return total;
}
