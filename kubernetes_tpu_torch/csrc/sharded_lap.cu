// sharded_lap: the per-shard body of the JAX package's node-sharded lap
// (parallel/mesh.py _lap_body, :228-351), cut at its two exchanges into
// three launchers. A shard holds NPl consecutive rows of the NP = S * NPl
// node rows (global row = shard * NPl + local row) and computes, for its
// own rows only, what lap_schedule computes for all of them:
//
//   (a) sharded_lap_count   — re-evaluate fit, the fit score and
//       BalancedAllocation on the shard's rows, okd = static_ok & fit_ok &
//       (gidx < num), a block prefix sum Fl of okd, and the shard's int32
//       pair (Fl[-1], Fl at start-1 if the shard owns row start-1, else 0);
//   -- exchange 1: the S pairs gathered [S, 2] onto every shard's device
//      (a copy outside the kernels, parallel/mesh.py);
//   (b) sharded_lap_windows — from the gathered pairs the total feasible
//       count, the shard's global prefix offset, the start's owner and its
//       rank origin f_start, the lap's L; then each row's rank, rotation and
//       window, and the shard's packed [2 * LAP_MAX] int64 keys: each
//       window's max of total * NP + (NP - 1 - rot) (-1 where empty), then
//       each window's negated boundary min of rot + 1 (-num where empty);
//   -- exchange 2: the S packed rows gathered [S, 2 * LAP_MAX];
//   (c) sharded_lap_land    — the max over the S rows (the JAX pmax: the
//       exchange only moves bytes), each window's landed row and start
//       after, the landings on the shard's own rows (req_r, nonzero,
//       pod_count), the (row, start after) block at `done` (the shard that
//       owns the results), the new start and done += L.
//
// Loop control stays on the device: every phase reads the shard's `done`
// and returns at once when done >= n_act, so the host may launch laps in
// chunks and read `done` once a chunk. L is clipped to at least 1, so each
// active lap makes progress. Floored `//` and `%` throughout (kernels.cuh):
// gidx - start and rank - 1 may be negative. No two windows of a lap share
// a row, so a landing is a plain add; the dump lane LAP_MAX never lands.
//
// One block a shard per phase (the shard's rows are at most a few thousand):
// a simple form that is right. A persistent multi-shard kernel is later
// work.
#include "kernels.cuh"

__global__ void __launch_bounds__(KTT_BLOCK) sharded_lap_count_kernel(
    ResFeat f, int NPl, int n_act, int shard, const int64_t* __restrict__ alloc_r,
    const int64_t* __restrict__ alloc_pods, const int64_t* __restrict__ req_r,
    const int64_t* __restrict__ nonzero, const int32_t* __restrict__ pod_count,
    const uint8_t* __restrict__ static_ok, const int64_t* __restrict__ il_score,
    const int64_t* __restrict__ weights, const int32_t* __restrict__ num_nodes_p,
    const int32_t* __restrict__ done_p, const int32_t* __restrict__ start_p,
    uint8_t* okd_s, int32_t* Fl, int64_t* total_s, int32_t* pair) {
  __shared__ int scan_sm[KTT_BLOCK];
  if (*done_p >= n_act) return;  // the same for every thread: no barrier skipped
  const int tid = threadIdx.x, nt = blockDim.x;
  const int rpt = (NPl + nt - 1) / nt;
  const int lo = min(tid * rpt, NPl), hi = min(lo + rpt, NPl);
  const int num = max(*num_nodes_p, 1);
  const int64_t base = (int64_t)shard * NPl;
  const int64_t w_tt = weights[0], w_fit = weights[1], w_ba = weights[4], w_il = weights[6];
  int cnt = 0;
  for (int i = lo; i < hi; ++i) {
    bool ok;
    int64_t sc, ba;
    resource_eval_row(f, alloc_r + (int64_t)i * f.R, alloc_pods[i], req_r + (int64_t)i * f.R,
                      nonzero + 2 * (int64_t)i, pod_count[i], nullptr, 0, ok, sc, ba);
    const bool okd = static_ok[i] && ok && base + i < num;
    okd_s[i] = okd;
    total_s[i] = w_tt * MAX_NODE_SCORE + w_fit * sc + w_ba * ba + w_il * il_score[i];
    cnt += okd;
  }
  const int incl = block_inclusive_scan(cnt, scan_sm);
  int run = incl - cnt;
  for (int i = lo; i < hi; ++i) {
    run += okd_s[i];
    Fl[i] = run;
  }
  __syncthreads();
  if (tid == 0) {
    const int start = *start_p;
    const int64_t sidx = (int64_t)start - 1;
    const bool own = start > 0 && sidx >= base && sidx < base + NPl;
    int64_t lpos = sidx - base;
    lpos = lpos < 0 ? 0 : (lpos > NPl - 1 ? NPl - 1 : lpos);
    pair[0] = NPl > 0 ? Fl[NPl - 1] : 0;
    pair[1] = own ? Fl[lpos] : 0;
  }
}

__global__ void __launch_bounds__(KTT_BLOCK) sharded_lap_windows_kernel(
    int NPl, int S, int shard, int n_act, const int32_t* __restrict__ num_nodes_p,
    const int32_t* __restrict__ to_find_p, const int32_t* __restrict__ pairs,
    const uint8_t* __restrict__ okd_s, const int32_t* __restrict__ Fl,
    const int64_t* __restrict__ total_s, const int32_t* __restrict__ done_p,
    const int32_t* __restrict__ start_p, int64_t* keys, int32_t* L_out) {
  __shared__ long long key_w[LAP_MAX];
  __shared__ int ev_w[LAP_MAX];
  const int done = *done_p;
  if (done >= n_act) return;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int rpt = (NPl + nt - 1) / nt;
  const int lo = min(tid * rpt, NPl), hi = min(lo + rpt, NPl);
  const int num = max(*num_nodes_p, 1);
  const int tf = max(*to_find_p, 1);
  const int start = *start_p;
  const int64_t NP = (int64_t)NPl * S;
  // Exchange 1's pairs: the feasible total, the shard's global prefix
  // offset, and the rank origin F[start - 1] from the start's owner.
  int64_t owner = floor_div((int64_t)start - 1, NPl);
  owner = owner < 0 ? 0 : (owner > S - 1 ? S - 1 : owner);
  int total_feas = 0, offset = 0, before_owner = 0;
  for (int s = 0; s < S; ++s) {
    const int t = pairs[2 * s];
    total_feas += t;
    if (s < shard) offset += t;
    if (s < owner) before_owner += t;
  }
  const int f_start = start > 0 ? before_owner + pairs[2 * owner + 1] : 0;
  int L = min(total_feas / tf, n_act - done);  // total_feas >= 0: truncation is floor
  L = max(1, min(L, LAP_MAX));
  if (tid < LAP_MAX) {
    key_w[tid] = -1;
    ev_w[tid] = num;
  }
  __syncthreads();
  for (int i = lo; i < hi; ++i) {
    if (!okd_s[i]) continue;
    const int64_t g = (int64_t)shard * NPl + i;
    const int F = Fl[i] + offset;
    const int rank = g >= start ? F - f_start : F + total_feas - f_start;
    const int rot = (int)floor_mod(g - start, num);
    const int w = (int)min(floor_div(rank - 1, tf), (int64_t)LAP_MAX);
    if (w < L) atomicMax(&key_w[w], (long long)(total_s[i] * NP + (NP - 1 - rot)));
    if (floor_mod(rank, tf) == 0) {
      const int sb = (int)min(floor_div(rank, tf) - 1, (int64_t)LAP_MAX);
      if (sb < LAP_MAX) atomicMin(&ev_w[sb], rot + 1);
    }
  }
  __syncthreads();
  if (tid < LAP_MAX) {
    keys[tid] = key_w[tid];
    keys[LAP_MAX + tid] = -(long long)ev_w[tid];
  }
  if (tid == 0) *L_out = L;
}

__global__ void __launch_bounds__(LAP_MAX) sharded_lap_land_kernel(
    int NPl, int R, int S, int shard, int n_act, int B, const int64_t* __restrict__ request,
    const int64_t* __restrict__ nz_request, const int32_t* __restrict__ num_nodes_p,
    const int64_t* __restrict__ keys, const int32_t* __restrict__ L_p, int64_t* req_r,
    int64_t* nonzero, int32_t* pod_count, int32_t* out, int32_t* start_p, int32_t* done_p) {
  const int w = threadIdx.x;  // one thread a window
  const int done = *done_p;
  if (done >= n_act) return;
  const int start = *start_p;
  const int L = *L_p;
  const int num = max(*num_nodes_p, 1);
  const int64_t NP = (int64_t)NPl * S;
  // Exchange 2's rows reduced here: window maxima and negated boundary minima.
  int64_t kw = keys[w], nb = keys[LAP_MAX + w];
  for (int s = 1; s < S; ++s) {
    const int64_t* row = keys + (int64_t)s * 2 * LAP_MAX;
    kw = row[w] > kw ? row[w] : kw;
    nb = row[LAP_MAX + w] > nb ? row[LAP_MAX + w] : nb;
  }
  const bool has = w < L && kw >= 0;
  const int64_t rot_w = NP - 1 - floor_mod(kw, NP);
  const int row = has ? (int)floor_mod((int64_t)start + rot_w, num) : -1;
  const int start_w = (int)floor_mod((int64_t)start - nb, num);
  const int pos = done + w;
  if (out != nullptr && pos < B) {
    out[pos] = row;
    out[B + pos] = start_w;
  }
  const int64_t local = (int64_t)row - (int64_t)shard * NPl;
  if (has && local >= 0 && local < NPl) {
    for (int r = 0; r < R; ++r) req_r[local * R + r] += request[r];
    nonzero[2 * local] += nz_request[0];
    nonzero[2 * local + 1] += nz_request[1];
    pod_count[local] += 1;
  }
  __syncthreads();  // every window has read start and done
  if (w == L - 1) *start_p = start_w;
  if (w == 0) *done_p = done + L;
}

extern "C" int launch_sharded_lap_count(
    int NPl, int R, int FR, int fit_strategy, int n_act, int shard, const int64_t* request,
    const int64_t* nz_request, const int64_t* has_request, const int64_t* ba_skip,
    const int32_t* enable, const int32_t* fit_slots, const int64_t* fit_weights,
    const int64_t* alloc_r, const int64_t* alloc_pods, const int64_t* req_r,
    const int64_t* nonzero, const int32_t* pod_count, const bool* static_ok,
    const int64_t* il_score, const int64_t* weights, const int32_t* num_nodes,
    const int32_t* done, const int32_t* start, uint8_t* okd, int32_t* Fl, int64_t* total,
    int32_t* pair, cudaStream_t stream) {
  ResFeat f{request, nz_request, has_request, ba_skip, enable, fit_slots, fit_weights,
            R, FR, fit_strategy};
  sharded_lap_count_kernel<<<1, KTT_BLOCK, 0, stream>>>(
      f, NPl, n_act, shard, alloc_r, alloc_pods, req_r, nonzero, pod_count,
      (const uint8_t*)static_ok, il_score, weights, num_nodes, done, start, okd, Fl, total,
      pair);
  return (int)cudaGetLastError();
}

extern "C" int launch_sharded_lap_windows(
    int NPl, int S, int shard, int n_act, const int32_t* num_nodes, const int32_t* to_find,
    const int32_t* pairs, const uint8_t* okd, const int32_t* Fl, const int64_t* total,
    const int32_t* done, const int32_t* start, int64_t* keys, int32_t* L,
    cudaStream_t stream) {
  sharded_lap_windows_kernel<<<1, KTT_BLOCK, 0, stream>>>(
      NPl, S, shard, n_act, num_nodes, to_find, pairs, okd, Fl, total, done, start, keys, L);
  return (int)cudaGetLastError();
}

extern "C" int launch_sharded_lap_land(
    int NPl, int R, int S, int shard, int n_act, int B, const int64_t* request,
    const int64_t* nz_request, const int32_t* num_nodes, const int64_t* keys,
    const int32_t* L, int64_t* req_r, int64_t* nonzero, int32_t* pod_count,
    OPTIONAL int32_t* out, int32_t* start, int32_t* done, cudaStream_t stream) {
  sharded_lap_land_kernel<<<1, LAP_MAX, 0, stream>>>(
      NPl, R, S, shard, n_act, B, request, nz_request, num_nodes, keys, L,
      req_r, nonzero, pod_count, out, start, done);
  return (int)cudaGetLastError();
}
