// dry_run_preemption: the JAX package's dry_run_preemption
// (ops/kernel.py:726-789) — DefaultPreemption's SelectVictimsOnNode
// (preemption.go:425) for every node row at once.
//
// As in the JAX function, a row
//   1. removes every lower-priority pod (the K victim columns, already in
//      MoreImportantPod order): base = requested - their sum, with
//      cnt0 = pod_count - their count pods; feasible0 = static_ok & row <
//      num_nodes & a victim & the preemptor fits at base with cnt0 pods;
//   2. reprieves most important first: victim i is kept when the pod still
//      fits at base + kept + its request with cnt0 + kept + 1 pods;
//   3. writes out[n, 1 + i] = valid & feasible0 & not kept and out[n, 0] =
//      feasible0 & any victim.
// The fit test is _resource_eval's filter at fit strategy 0 with no
// nominated lane (the host dry run ignores nominations). The preemptor's
// other filters are the row's static verdicts: the device gate sends every
// preemptor whose filters couple rows (spread, pod affinity) and every
// cluster with anti-affinity pods to the host dry run.
//
// Bound: bytes. A row reads its K valid flags, the R requests of each
// valid victim, its allocatable, requested, count and static inputs, and
// writes 1 + K bytes; the arithmetic is a few int64 operations a victim
// and slot. The design keeps each byte to one read and the reads
// coalesced:
// - a tile of G lanes takes a row (G the smallest power of two >= R, at
//   most 32; R 7 gives 8 lanes, 4 rows a warp); lane l owns resource
//   slots l, l + G (two a lane for 32 < R <= 64), so base, kept, the
//   allocatable and the request are registers, and a victim's R requests
//   are one contiguous read by the tile;
// - the fit test's violation is a masked __any_sync over the tile; the
//   pods test and the has_request / enable[4] bypasses are row values;
// - the tile reads the row's K flags once, four a lane a load, into bit
//   words (a __reduce_or_sync over the tile each 32 slots) in shared
//   memory, and walks only the set bits, twice: the removal, then the
//   reprieve. The first DRY_VREG victims' requests stay in registers from
//   the removal to the reprieve (the victims of a row on the timed paths:
//   one or two); later ones are read again, from cache;
// - the block stages its rows' taints and the tolerations in shared memory
//   once (stage_static, as static_masks); lane 0 of a tile takes the row's
//   static verdict there (static_row, shared with static_masks) and the
//   tile reads it by a shuffle; rows at or past num_nodes read no victim;
// - every read that depends on nothing else (the stage, the gates, the
//   flags, the row's vectors) is issued first, and the removal's reads
//   need only the flags, so a row costs two dependent round trips;
// - the tile writes the row's 1 + K bytes, lane l bytes l, l + G, ...
// R above DRY_RMAX or K above DRY_KMAX (PREEMPT_K_CAP) is refused.
#include "kernels.cuh"

#define DRY_THREADS 256   // threads a block: DRY_THREADS / G rows
#define DRY_KMAX 256      // victim slots a row (ops/features.py PREEMPT_K_CAP)
#define DRY_RMAX 64       // resource slots a row: two a lane of a 32-lane tile
#define DRY_VREG 8        // victims a row whose requests stay in registers

// Shared memory of a block of `rows` rows before the static stage: a row's
// ceil(K / 32) victim words (a multiple of 16 bytes for rows a multiple of
// 4).
static __host__ __device__ __forceinline__ size_t dry_words_bytes(int rows, int K) {
  return (size_t)4 * rows * ((K + 31) >> 5);
}

// The set bits of a row's victim words in ascending slot order, the same
// on every lane of the tile. `vict` is word w's victims: a reprieve clears
// its bit, and a writer stores the word back as the walk leaves it.
struct BitWalk {
  uint32_t* words;
  int nw, w;
  uint32_t rest, vict;
  bool writer;

  __device__ __forceinline__ BitWalk(uint32_t* words_, int nw_, bool writer_)
      : words(words_), nw(nw_), w(0), rest(words_[0]), vict(words_[0]), writer(writer_) {}

  __device__ __forceinline__ int next() {
    while (rest == 0) {
      if (writer) words[w] = vict;
      if (w + 1 >= nw) return -1;
      ++w;
      rest = vict = words[w];
    }
    const int b = __ffs(rest) - 1;
    rest &= rest - 1;
    return 32 * w + b;
  }

  __device__ __forceinline__ void reprieve(int i) { vict &= ~(1u << (i & 31)); }
};

// Lane `lane`'s slots (lane + G * s) of the R-slot row at `row`; 0 past R.
template <int G, int S>
static __device__ __forceinline__ void load_slots(const int64_t* __restrict__ row, int lane, int R,
                                                  int64_t (&v)[S]) {
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int slot = lane + G * s;
    v[s] = slot < R ? (int64_t)__ldg(reinterpret_cast<const long long*>(row) + slot) : 0;
  }
}

template <int G, int S, bool STAGED>
__global__ void __launch_bounds__(DRY_THREADS) dry_run_preemption_kernel(
    ResFeat f, StaticFeat s, int NP, int K, const int32_t* __restrict__ num_nodes_p,
    const int64_t* __restrict__ alloc_r, const int64_t* __restrict__ alloc_pods,
    const int64_t* __restrict__ req_r, const int32_t* __restrict__ pod_count,
    const int64_t* __restrict__ vic_req, const uint8_t* __restrict__ vic_valid,
    uint8_t* out) {
  constexpr int RB = DRY_THREADS / G;  // rows a block
  extern __shared__ int4 dry_smem[];
  const int KW = (K + 31) >> 5;
  uint32_t* words = reinterpret_cast<uint32_t*>(dry_smem) + (threadIdx.x / G) * KW;
  int32_t* stage = reinterpret_cast<int32_t*>(reinterpret_cast<uint8_t*>(dry_smem) +
                                              dry_words_bytes(RB, K));
  const int R = f.R;
  const int tile = threadIdx.x / G, lane = threadIdx.x % G;
  const unsigned tmask = G == 32 ? 0xffffffffu
                                 : ((1u << G) - 1) << ((threadIdx.x & 31) & ~(G - 1));
  const int n0 = blockIdx.x * RB;
  const int rows = min(RB, NP - n0);
  const int n = n0 + tile;
  const int num = max(*num_nodes_p, 1);
  const bool live = tile < rows && n < num;

  // Every read that needs nothing of another is issued first, in one
  // round trip: lane 0's row gates, the block's stage, the row's flag
  // quads (lane l reads quads l, l + G, ... of each 32 slots), its
  // allocatable, requested and counts, and the request.
  StaticGates g{};
  if (live && lane == 0) g = static_gates(s, n);
  const StaticStage st = stage_static<STAGED>(s, n0, rows, RB, stage);
  int n_pot = 0;
  int64_t alloc[S] = {}, base[S] = {}, q[S];
  int64_t pods_cap = 0;
  int32_t cnt = 0;
  load_slots<G, S>(f.request, lane, R, q);
  const bool no_request = *f.has_request == 0, fit_off = f.enable[4] == 0;
  if (live) {
    load_slots<G, S>(alloc_r + (int64_t)n * R, lane, R, alloc);
    load_slots<G, S>(req_r + (int64_t)n * R, lane, R, base);
    pods_cap = alloc_pods[n];
    cnt = pod_count[n];
    const uint32_t* quads = reinterpret_cast<const uint32_t*>(vic_valid + (int64_t)n * K);
    const int nq = K >> 2;
    for (int w = 0; w < KW; ++w) {
      uint32_t bits = 0;
      for (int qi = 8 * w + lane; qi < min(8 * w + 8, nq); qi += G) {
        const uint32_t v = __ldg(quads + qi);
        const uint32_t nib = ((v & 0xffu) ? 1u : 0u) | ((v & 0xff00u) ? 2u : 0u) |
                             ((v & 0xff0000u) ? 4u : 0u) | ((v & 0xff000000u) ? 8u : 0u);
        bits |= nib << (4 * (qi & 7));
      }
      bits = __reduce_or_sync(tmask, bits);
      if (lane == 0) words[w] = bits;
      n_pot += __popc(bits);
    }
    __syncwarp(tmask);
  }

  // The removal: base -= every valid victim's requests, the first
  // DRY_VREG held in registers for the reprieve. It needs only the flags,
  // so it runs before the static verdict; rows past num_nodes read none.
  const int64_t* vrow = vic_req + (int64_t)n * K * R;
  int64_t vreg[DRY_VREG][S];
  int held = 0;
  bool feasible0 = false;
  const int32_t cnt0 = cnt - n_pot;
  auto fits = [&](const int64_t (&used)[S], int32_t pods) {
    bool viol = false;
#pragma unroll
    for (int s2 = 0; s2 < S; ++s2) viol |= q[s2] > 0 && q[s2] > alloc[s2] - used[s2];
    viol = __any_sync(tmask, viol);
    return ((int64_t)(pods + 1) <= pods_cap && (!viol || no_request)) || fit_off;
  };
  if (live && n_pot > 0) {
    BitWalk it(words, KW, false);
#pragma unroll
    for (int j = 0; j < DRY_VREG; ++j) {
      const int i = it.next();
      if (i < 0) break;
      load_slots<G, S>(vrow + (int64_t)i * R, lane, R, vreg[j]);
#pragma unroll
      for (int s2 = 0; s2 < S; ++s2) base[s2] -= vreg[j][s2];
      held = j + 1;
    }
    for (int i = it.next(); i >= 0; i = it.next()) {
      int64_t v[S];
      load_slots<G, S>(vrow + (int64_t)i * R, lane, R, v);
#pragma unroll
      for (int s2 = 0; s2 < S; ++s2) base[s2] -= v[s2];
    }
    feasible0 = fits(base, cnt0);
  }

  // The static verdict: lane 0 evaluates the row from the stage and the
  // tile takes it by a shuffle.
  if (STAGED) __syncthreads();
  if (tile >= rows) return;
  if (live) {
    const bool ok = lane == 0 && static_row(s, st, n, g).static_ok;
    feasible0 = __shfl_sync(tmask, (int)ok, 0, G) && feasible0;
  }

  // The reprieve, most important first.
  int32_t kept_cnt = 0;
  if (feasible0) {
    BitWalk it(words, KW, lane == 0);
    int64_t kept[S];
#pragma unroll
    for (int s2 = 0; s2 < S; ++s2) kept[s2] = 0;
    auto reprieve = [&](int i, const int64_t (&v)[S]) {
      int64_t used[S];
#pragma unroll
      for (int s2 = 0; s2 < S; ++s2) used[s2] = base[s2] + kept[s2] + v[s2];
      if (fits(used, cnt0 + kept_cnt + 1)) {
#pragma unroll
        for (int s2 = 0; s2 < S; ++s2) kept[s2] += v[s2];
        ++kept_cnt;
        it.reprieve(i);
      }
    };
#pragma unroll
    for (int j = 0; j < DRY_VREG; ++j) {
      if (j >= held) break;
      reprieve(it.next(), vreg[j]);
    }
    for (int i = it.next(); i >= 0; i = it.next()) {
      int64_t v[S];
      load_slots<G, S>(vrow + (int64_t)i * R, lane, R, v);
      reprieve(i, v);
    }
    __syncwarp(tmask);  // lane 0's victim words
  }

  // The row's 1 + K verdicts, lane l writing bytes l, l + G, ...
  uint8_t* out_row = out + (int64_t)n * (K + 1);
  const bool any = feasible0 && kept_cnt < n_pot;
  for (int b = lane; b <= K; b += G) {
    out_row[b] = b == 0 ? any : (feasible0 && ((words[(b - 1) >> 5] >> ((b - 1) & 31)) & 1u));
  }
}

template <int G, int S>
static int launch_tiles(const ResFeat& f, const StaticFeat& s, int NP, int K, int T, int L,
                        const int32_t* num_nodes, const int64_t* alloc_r,
                        const int64_t* alloc_pods, const int64_t* req_r,
                        const int32_t* pod_count, const int64_t* vic_req,
                        const uint8_t* vic_valid, uint8_t* out, cudaStream_t stream) {
  constexpr int RB = DRY_THREADS / G;
  const int blocks = (NP + RB - 1) / RB;
  const size_t words = dry_words_bytes(RB, K);
  const size_t staged = words + static_stage_bytes(RB, T, L);
  if (staged <= STAGE_SMEM_MAX) {
    dry_run_preemption_kernel<G, S, true><<<blocks, DRY_THREADS, staged, stream>>>(
        f, s, NP, K, num_nodes, alloc_r, alloc_pods, req_r, pod_count, vic_req, vic_valid, out);
  } else {
    dry_run_preemption_kernel<G, S, false><<<blocks, DRY_THREADS, words, stream>>>(
        f, s, NP, K, num_nodes, alloc_r, alloc_pods, req_r, pod_count, vic_req, vic_valid, out);
  }
  return (int)cudaGetLastError();
}

extern "C" int launch_dry_run_preemption(
    int NP, int R, int FR, int T, int L, int K, const int64_t* request,
    const int64_t* nz_request, const int64_t* has_request, const int64_t* ba_skip,
    const int32_t* enable, const int32_t* fit_slots, const int64_t* fit_weights,
    const int32_t* taint_key, const int32_t* taint_val, const int32_t* taint_eff,
    const int32_t* tol_key, const int32_t* tol_val, const int32_t* tol_eff,
    const int32_t* tol_op, const bool* sel_match, const int32_t* node_name_id,
    const int32_t* name_id, const bool* unsched, const int32_t* tolerates_unsched,
    const int32_t* exist_anti, const bool* valid, const bool* extra_ok,
    const int32_t* num_nodes, const int64_t* alloc_r, const int64_t* alloc_pods,
    const int64_t* req_r, const int32_t* pod_count, const int64_t* vic_req,
    const bool* vic_valid, bool* out, cudaStream_t stream) {
  // The flags are read four to a 32-bit load.
  if (R < 1 || R > DRY_RMAX || K < 4 || K > DRY_KMAX || (K & 3) ||
      (reinterpret_cast<uintptr_t>(vic_valid) & 3)) {
    return (int)cudaErrorInvalidValue;
  }
  if (NP == 0) return 0;
  const ResFeat f{request, nz_request, has_request, ba_skip, enable, fit_slots, fit_weights,
                  R, FR, 0};
  const StaticFeat s{T, L, taint_key, taint_val, taint_eff, tol_key, tol_val, tol_eff,
                     tol_op, (const uint8_t*)sel_match, node_name_id, name_id,
                     (const uint8_t*)unsched, tolerates_unsched, exist_anti, enable,
                     (const uint8_t*)valid, (const uint8_t*)extra_ok};
  const uint8_t* vv = (const uint8_t*)vic_valid;
  uint8_t* o = (uint8_t*)out;
#define DRY_TILES(G, S) \
  launch_tiles<G, S>(f, s, NP, K, T, L, num_nodes, alloc_r, alloc_pods, req_r, pod_count, \
                     vic_req, vv, o, stream)
  if (R > 32) return DRY_TILES(32, 2);
  if (R > 16) return DRY_TILES(32, 1);
  if (R > 8) return DRY_TILES(16, 1);
  if (R > 4) return DRY_TILES(8, 1);
  if (R > 2) return DRY_TILES(4, 1);
  if (R > 1) return DRY_TILES(2, 1);
  return DRY_TILES(1, 1);
#undef DRY_TILES
}
