// sharded_lap: the JAX package's node-sharded lap (parallel/mesh.py
// _lap_body, :228-351, run by _ShardedLap, :354-426) as one persistent
// cooperative launch a card a dispatch. A shard holds NPl consecutive rows
// of the NP = S * NPl node rows (global row = shard * NPl + local row); a
// card launches one block for each shard it holds, and every block runs
// every lap of the dispatch, its two exchanges included, until done >=
// n_act. The host reads nothing while a dispatch runs.
//
// What a lap computes (the JAX body, bit for bit). Each shard counts its
// feasible rows and takes the prefix at row start - 1 where it owns that
// row: exchange 1 (the JAX all_gather of an int32 pair a shard) gives every
// shard the feasible total, its global prefix offset and the rank origin
// f_start, hence the same L = clip(min(total // to_find, n_act - done), 1,
// LAP_MAX). Each shard then takes, for its own rows, each window's max of
// total * NP + (NP - 1 - rot) and each window's boundary min of rot + 1:
// exchange 2 (the JAX packed pmax over 2 * LAP_MAX lanes, here a gather of
// every shard's lanes and the max taken by each shard) gives every shard
// each window's landed row and start after. The owner of a landed row
// applies the landing; every shard computes the same L, done and start, so
// every block leaves at the same lap.
//
// The row state is kept on chip. A landing changes its own row only (a
// row-local plan: no count table, no nominated lane), so the prologue
// evaluates each of the shard's rows once (fit, fit score and
// BalancedAllocation, with resource_eval_row's arithmetic) and writes the
// carry's fit_ok / fit_sc / ba; it keeps each row's feasibility (static_ok
// & fit_ok & row < num) and total on chip. After a lap only the rows that
// landed on the shard are re-evaluated (lap_eval_landed, one warp a
// landing) and their fit lanes, feasibility and total refreshed, so the
// carry's fit lanes are final when the last lap ends. The window search is
// a pass over the shard's rows each lap (NPl / 1024 rows a thread, 2 at S =
// 4 and NP 8192): a block scan of the threads' feasible counts gives each
// row its rank, and shared-memory atomics take each window's maxima. The
// kept arrays are in shared memory up to SHL_SMEM_ROWS rows a shard; above
// it the same arrays are in a device-memory buffer (`work`).
//
// The exchanges. Each shard owns a slot in each of two regions of the
// exchange buffer: the pair region (exchange 1) and the key region
// (exchange 2). A shard writes its slot's payload, publishes it with a
// release store of the slot's arrival word at the medium's scope (after a
// block barrier: the release carries every thread's payload stores), and
// waits with acquire loads until it has seen the arrival word of every
// shard's slot; a barrier then orders the block's reads of the payloads
// after the acquire. No separate fence: one before the release or after
// the acquire would order nothing more and costs time in every exchange. The arrival word is the dispatch
// generation (host-chosen, in its high 32 bits) and the lap + 1, so
// nothing is reset between dispatches and no lap reads another lap's slot.
// A slot is rewritten only after every shard has read it: a shard writes
// its pair slot of lap l after it has seen every shard arrive at the key
// exchange of lap l - 1, which each shard does only after reading the
// pairs of lap l - 1; likewise the key slots one exchange later. When every
// shard is on one card the buffer is in that card's memory (gpu scope);
// when the shards span cards it is pinned host memory that every card
// reads and writes directly under unified addressing (system scope), with
// no peer access. Every wait has a budget of clock64 cycles: when it runs
// out the block writes its status word ((lap << 1 | exchange) + 1) and
// returns, and the wrapper, which reads the status words with the results,
// raises. The cooperative launch guarantees that a card's blocks are
// resident together; the launcher refuses more shards than that.
//
// What bounds a dispatch on this card. The bytes are few: each row of the
// shard read once and the carry written once (~0.0006 ms at NP 8192 over
// 3.35 TB/s). A lap is a chain of dependent latencies: a block scan (two
// barriers), two exchanges (a fence, a store and a poll of L2, or of host
// memory over PCIe across cards), the window pass, the reduction of the S
// slots and one warp's landing (an L2 round trip and the row's divisions).
// Floored // and % throughout; no two windows of a lap share a row, so a
// landing is a plain add, and the dump lane LAP_MAX never lands.
#include "kernels.cuh"

constexpr int SHL_THREADS = 1024;      // 32 warps: one a window lane's landing
constexpr int SHL_MAX_LOCAL = 32;      // shards one launch holds (its table is a kernel parameter)
constexpr int SHL_SMEM_ROWS = 16384;   // a shard's kept rows in shared memory up to this many
constexpr int SHL_NF = 12;             // columns of the launcher's shard table
constexpr int SHL_PAIR_STRIDE = 16;    // int64 words a pair slot: arrival word, pair (128 bytes)
constexpr int SHL_KEY_STRIDE = 80;     // arrival word and 2 * LAP_MAX keys, in 128-byte lines
#define FULL 0xffffffffu

// One shard's tensors (a row of the launcher's table).
struct ShardIO {
  const int64_t* alloc_r;
  const int64_t* alloc_pods;
  int64_t* req_r;
  int64_t* nonzero;
  int32_t* pod_count;
  const uint8_t* static_ok;
  const int64_t* il_score;
  uint8_t* fit_ok;
  int64_t* fit_sc;
  int64_t* ba;
  int32_t* start;
  int shard;
};

struct ShlArgs {
  ShardIO sh[SHL_MAX_LOCAL];
  const int64_t* weights;
  const int32_t* num_nodes;
  const int32_t* to_find;
  int64_t* xbuf;     // [S][SHL_PAIR_STRIDE] pair slots, then [S][SHL_KEY_STRIDE] key slots
  int32_t* out;      // [2, B] on the card of shard 0 (null on the others)
  int64_t* work;     // the kept arrays of each block (null: shared memory)
  int32_t* status;   // [blocks] 0, or the failed wait
  long long budget;  // clock64 cycles a wait may take
  long long gen;     // the dispatch generation
  int NPl, S, n_act, B;
};

// The block's arrays in dynamic shared memory: the batch's constants, a
// landing stage a warp, the gathered pairs, and (SMEM) the kept arrays.
struct ShlMem {
  int64_t* c64;    // request [R], nz_request [2], has_request, ba_skip, fit_weights [FR]
  int32_t* c32;    // enable [5], fit_slots [FR]
  int64_t* stage;  // [warps][2R + 2]: a landing's alloc_r, req_r and nonzero
  int32_t* pairs;  // [S][2] exchange 1's pairs
  int64_t* total;  // [NPl] each row's total
  uint8_t* okd;    // [NPl] each row's feasibility
};

__host__ __device__ inline size_t shl_take(size_t& off, size_t bytes) {
  const size_t o = off;
  off = (off + bytes + 15) & ~(size_t)15;
  return o;
}

// The layout of ShlMem in `buf`; returns its bytes (buf null: the size only).
__host__ __device__ inline size_t shl_layout(int NPl, int R, int FR, int S, bool kept,
                                             unsigned char* buf, ShlMem* m) {
  size_t off = 0;
  const size_t o_c64 = shl_take(off, 8 * (size_t)(R + 4 + FR));
  const size_t o_c32 = shl_take(off, 4 * (size_t)(5 + FR));
  const size_t o_stage = shl_take(off, 8 * (size_t)(SHL_THREADS / 32) * (2 * R + 2));
  const size_t o_pairs = shl_take(off, 8 * (size_t)S);
  const size_t o_total = kept ? shl_take(off, 8 * (size_t)NPl) : 0;
  const size_t o_okd = kept ? shl_take(off, (size_t)NPl) : 0;
  if (buf != nullptr) {
    m->c64 = (int64_t*)(buf + o_c64);
    m->c32 = (int32_t*)(buf + o_c32);
    m->stage = (int64_t*)(buf + o_stage);
    m->pairs = (int32_t*)(buf + o_pairs);
    m->total = (int64_t*)(buf + o_total);
    m->okd = buf + o_okd;
  }
  return off;
}

// int64 words of one block's kept arrays in `work` (ops/kernel.py mirrors it).
__host__ __device__ inline int64_t shl_work_words(int NPl) { return NPl + (NPl + 7) / 8; }

// Strong (non-caching) loads and stores, and the release and acquire of an
// arrival word, at gpu scope (one card) or system scope (across cards). A
// release is cumulative: the payload stores that a block barrier ordered
// before it are visible to whoever acquires the arrival word.
template <bool SYS>
__device__ __forceinline__ int64_t shl_load(const int64_t* p) {
  int64_t v;
  if (SYS)
    asm volatile("ld.relaxed.sys.b64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  else
    asm volatile("ld.relaxed.gpu.b64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

template <bool SYS>
__device__ __forceinline__ void shl_store(int64_t* p, int64_t v) {
  if (SYS)
    asm volatile("st.relaxed.sys.b64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
  else
    asm volatile("st.relaxed.gpu.b64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

template <bool SYS>
__device__ __forceinline__ void shl_publish(int64_t* arrival, int64_t tag) {
  if (SYS)
    asm volatile("st.release.sys.b64 [%0], %1;" ::"l"(arrival), "l"(tag) : "memory");
  else
    asm volatile("st.release.gpu.b64 [%0], %1;" ::"l"(arrival), "l"(tag) : "memory");
}

// Acquire loads of `arrival` until it holds `tag`; false when the budget
// runs out first.
template <bool SYS>
__device__ __forceinline__ bool shl_wait(const int64_t* arrival, int64_t tag, long long budget) {
  const long long t0 = clock64();
  for (;;) {
    int64_t v;
    if (SYS)
      asm volatile("ld.acquire.sys.b64 %0, [%1];" : "=l"(v) : "l"(arrival) : "memory");
    else
      asm volatile("ld.acquire.gpu.b64 %0, [%1];" : "=l"(v) : "l"(arrival) : "memory");
    if (v == tag) break;
    if (clock64() - t0 > budget) return false;
  }
  return true;
}

// Floored // and % of int32 operands by a positive divisor (the JAX body's
// int32 arithmetic).
__device__ __forceinline__ int shl_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ int shl_mod(int a, int b) {
  const int r = a % b;
  return r < 0 ? r + b : r;
}

// Inclusive prefix sum over the block (warp shuffles, one warp for the
// warps' sums); `total` receives the block's sum. Every thread calls it.
__device__ __forceinline__ int shl_block_scan(int v, int* warp_sums, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < nw ? warp_sums[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, s, o);
      if (lane >= o) s += y;
    }
    if (lane < nw) warp_sums[lane] = s;
  }
  __syncthreads();
  total = warp_sums[nw - 1];
  return (warp > 0 ? warp_sums[warp - 1] : 0) + x;
}

template <bool SMEM, bool SYS>
__global__ void __launch_bounds__(SHL_THREADS) sharded_lap_kernel(ResFeat f, ShlArgs a) {
  extern __shared__ __align__(16) unsigned char shl_smem[];
  __shared__ int s_warp[32];
  __shared__ long long s_key[LAP_MAX];
  __shared__ int s_ev[LAP_MAX], s_row[LAP_MAX];
  __shared__ int s_start, s_fail;
  const int tid = threadIdx.x, nt = blockDim.x, nw = nt >> 5;
  const int warp = tid >> 5, lane = tid & 31;
  const int blk = blockIdx.x;
  const ShardIO io = a.sh[blk];
  const int NPl = a.NPl, S = a.S, R = f.R, FR = f.FR;
  ShlMem M;
  shl_layout(NPl, R, FR, S, SMEM, shl_smem, &M);
  if (!SMEM) {
    M.total = a.work + (int64_t)blk * shl_work_words(NPl);
    M.okd = (uint8_t*)(M.total + NPl);
  }
  const int num = max(*a.num_nodes, 1);
  const int tf = max(*a.to_find, 1);
  const int base = io.shard * NPl;  // global rows are int32, as in the JAX body
  const int64_t NP = (int64_t)NPl * S;
  const int64_t w_tt = a.weights[0], w_fit = a.weights[1], w_ba = a.weights[4],
                w_il = a.weights[6];

  // The batch's constants on chip; the evaluations read them there.
  for (int j = tid; j < R; j += nt) M.c64[j] = f.request[j];
  if (tid < 2) M.c64[R + tid] = f.nz_request[tid];
  if (tid == 2) M.c64[R + 2] = *f.has_request;
  if (tid == 3) M.c64[R + 3] = *f.ba_skip;
  for (int j = tid; j < FR; j += nt) {
    M.c64[R + 4 + j] = f.fit_weights[j];
    M.c32[5 + j] = f.fit_slots[j];
  }
  if (tid < 5) M.c32[tid] = f.enable[tid];
  if (tid == 0) {
    s_start = *io.start;
    s_fail = 0;
  }
  __syncthreads();
  const ResFeat fs{M.c64, M.c64 + R, M.c64 + R + 2, M.c64 + R + 3, M.c32, M.c32 + 5,
                   M.c64 + R + 4, R, FR, f.fit_strategy};

  // Prologue: every row of the shard once; its fit lanes are final unless
  // a pod lands on it.
  for (int i = tid; i < NPl; i += nt) {
    bool ok;
    int64_t sc, bav;
    resource_eval_row(fs, io.alloc_r + (int64_t)i * R, io.alloc_pods[i],
                      io.req_r + (int64_t)i * R, io.nonzero + 2 * (int64_t)i, io.pod_count[i],
                      nullptr, 0, ok, sc, bav, LapDiv());
    io.fit_ok[i] = ok;
    io.fit_sc[i] = sc;
    io.ba[i] = bav;
    M.total[i] = w_tt * MAX_NODE_SCORE + w_fit * sc + w_ba * bav + w_il * io.il_score[i];
    M.okd[i] = io.static_ok[i] && ok && base + i < num;
  }
  __syncthreads();

  // The thread's rows in the lap passes: a contiguous run, for the scan.
  const int rpt = (NPl + nt - 1) / nt;
  const int lo = min(tid * rpt, NPl), hi = min(lo + rpt, NPl);
  int64_t* const pair_x = a.xbuf;
  int64_t* const key_x = a.xbuf + (int64_t)S * SHL_PAIR_STRIDE;
  int done = 0;
  for (int lap = 0; done < a.n_act; ++lap) {
    const int64_t tag = (a.gen << 32) | (int64_t)(lap + 1);
    const int start = s_start;
    if (tid < LAP_MAX) {
      s_key[tid] = -1;
      s_ev[tid] = num;
    }
    // (a) The shard's feasible count and its prefix at row start - 1.
    int cnt = 0;
    for (int i = lo; i < hi; ++i) cnt += M.okd[i];
    int count;
    const int excl = shl_block_scan(cnt, s_warp, count) - cnt;
    const int sidx = start - 1;
    const bool own = start > 0 && sidx >= base && sidx < base + NPl;
    // The pair's one writer: the thread that holds row start - 1 when the
    // shard owns it, else thread 0.
    if (tid == (own ? (sidx - base) / rpt : 0)) {
      int fl = 0;
      if (own) {
        fl = excl;
        for (int i = lo; i <= sidx - base; ++i) fl += M.okd[i];
      }
      int64_t* slot = pair_x + (int64_t)io.shard * SHL_PAIR_STRIDE;
      shl_store<SYS>(slot + 1, ((int64_t)fl << 32) | (uint32_t)count);
      shl_publish<SYS>(slot, tag);
    }
    // Exchange 1: every shard's pair.
    for (int s = tid; s < S; s += nt) {
      const int64_t* slot = pair_x + (int64_t)s * SHL_PAIR_STRIDE;
      if (shl_wait<SYS>(slot, tag, a.budget)) {
        const int64_t v = shl_load<SYS>(slot + 1);
        M.pairs[2 * s] = (int)(uint32_t)v;
        M.pairs[2 * s + 1] = (int)(v >> 32);
      } else {
        s_fail = 1;
      }
    }
    __syncthreads();
    if (s_fail) {
      if (tid == 0) a.status[blk] = ((lap << 1) | 0) + 1;
      return;
    }
    // The feasible total, the shard's global prefix offset and the rank
    // origin F[start - 1] from the start's owner, clip((start - 1) // NPl,
    // 0, S - 1).
    const int owner = min(max(shl_div(sidx, NPl), 0), S - 1);
    int total_feas = 0, offset = 0, before_owner = 0;
    for (int s = 0; s < S; ++s) {
      const int t = M.pairs[2 * s];
      total_feas += t;
      if (s < io.shard) offset += t;
      if (s < owner) before_owner += t;
    }
    const int f_start = start > 0 ? before_owner + M.pairs[2 * owner + 1] : 0;
    const int L = max(1, min(min(total_feas / tf, a.n_act - done), LAP_MAX));

    // (b) Each window's key maximum and boundary minimum over the shard's rows.
    int F = excl + offset;
    for (int i = lo; i < hi; ++i) {
      if (!M.okd[i]) continue;
      ++F;
      const int g = base + i;
      const int rank = g >= start ? F - f_start : F + total_feas - f_start;
      const int rot = shl_mod(g - start, num);
      const int w = min(shl_div(rank - 1, tf), LAP_MAX);
      if (w < L) atomicMax(&s_key[w], (long long)(M.total[i] * NP + (NP - 1 - rot)));
      if (shl_mod(rank, tf) == 0) {
        const int sb = min(shl_div(rank, tf) - 1, LAP_MAX);
        if (sb < LAP_MAX) atomicMin(&s_ev[sb], rot + 1);
      }
    }
    __syncthreads();
    // Exchange 2: every shard's keys and negated boundaries.
    int64_t* kslot = key_x + (int64_t)io.shard * SHL_KEY_STRIDE;
    for (int j = tid; j < 2 * LAP_MAX; j += nt)
      shl_store<SYS>(kslot + 1 + j, j < LAP_MAX ? (int64_t)s_key[j] : -(int64_t)s_ev[j - LAP_MAX]);
    __syncthreads();
    if (tid == 0) shl_publish<SYS>(kslot, tag);
    for (int s = tid; s < S; s += nt)
      if (!shl_wait<SYS>(key_x + (int64_t)s * SHL_KEY_STRIDE, tag, a.budget)) s_fail = 1;
    __syncthreads();
    if (s_fail) {
      if (tid == 0) a.status[blk] = ((lap << 1) | 1) + 1;
      return;
    }
    // The max over the shards (the JAX pmax): each window's landed row and
    // start after, the results block at `done` (shard 0's block) and the
    // new start.
    if (tid < LAP_MAX) {
      const int w = tid;
      int64_t kw = INT64_MIN, nb = INT64_MIN;
      for (int s = 0; s < S; ++s) {
        const int64_t* slot = key_x + (int64_t)s * SHL_KEY_STRIDE;
        const int64_t k = shl_load<SYS>(slot + 1 + w), b = shl_load<SYS>(slot + 1 + LAP_MAX + w);
        kw = k > kw ? k : kw;
        nb = b > nb ? b : nb;
      }
      const bool has = w < L && kw >= 0;
      const int64_t rot_w = NP - 1 - floor_mod(kw, NP);
      const int row = has ? (int)floor_mod((int64_t)start + rot_w, num) : -1;
      const int start_w = (int)floor_mod((int64_t)start - nb, num);
      s_row[w] = row;
      const int pos = done + w;
      if (io.shard == 0 && a.out != nullptr && pos < a.B) {
        a.out[pos] = row;
        a.out[a.B + pos] = start_w;
      }
      if (w == L - 1) s_start = start_w;  // every thread read this lap's start above
    }
    __syncthreads();

    // (c) The landings on the shard's rows, one warp a window: the row's
    // aggregates, then its re-evaluation, fit lanes, feasibility and total.
    for (int w = warp; w < L; w += nw) {
      const int row = s_row[w];
      if (row < base || row >= base + NPl) continue;  // -1 or another shard's row
      const int i = row - base;
      const int64_t rR = (int64_t)i * R;
      int64_t* sa = M.stage + (int64_t)warp * (2 * R + 2);
      int64_t* sq = sa + R;
      int64_t* sz = sq + R;
      int64_t apods = 0, il = 0, nz0 = 0, nz1 = 0;
      int32_t pc = 0;
      bool sok = false;
      if (lane == 0) {
        nz0 = io.nonzero[2 * (int64_t)i] + fs.nz_request[0];
        nz1 = io.nonzero[2 * (int64_t)i + 1] + fs.nz_request[1];
        pc = io.pod_count[i] + 1;
        apods = io.alloc_pods[i];
        sok = io.static_ok[i];
        il = io.il_score[i];
      }
      for (int j = lane; j < R; j += 32) {
        const int64_t al = io.alloc_r[rR + j];
        const int64_t q = io.req_r[rR + j] + fs.request[j];
        io.req_r[rR + j] = q;
        sa[j] = al;
        sq[j] = q;
      }
      if (lane == 0) {
        io.nonzero[2 * (int64_t)i] = nz0;
        io.nonzero[2 * (int64_t)i + 1] = nz1;
        io.pod_count[i] = pc;
        sz[0] = nz0;
        sz[1] = nz1;
      }
      __syncwarp();
      bool ok = false;
      int64_t sc = 0, bav = 0;
      lap_eval_landed<false>(fs, sa, apods, sq, sz, pc, nullptr, 0, lane, ok, sc, bav);
      if (lane == 0) {
        io.fit_ok[i] = ok;
        io.fit_sc[i] = sc;
        io.ba[i] = bav;
        M.total[i] = w_tt * MAX_NODE_SCORE + w_fit * sc + w_ba * bav + w_il * il;
        M.okd[i] = sok && ok && row < num;
      }
      __syncwarp();
    }
    __syncthreads();
    done += L;
  }
  if (tid == 0) *io.start = s_start;
}

typedef void (*ShlKernel)(ResFeat, ShlArgs);

// Indexed by the launch's bits: kept arrays on chip, system scope.
static const ShlKernel SHL_KERNELS[4] = {sharded_lap_kernel<false, false>,
                                         sharded_lap_kernel<false, true>,
                                         sharded_lap_kernel<true, false>,
                                         sharded_lap_kernel<true, true>};

// The most blocks of one launch the current card keeps resident together
// (at most SHL_MAX_LOCAL), or a negated cudaError. Setting the kernels'
// shared-memory size loads them, so a card that calls this before any
// card launches loads nothing while another card's blocks wait.
extern "C" int sharded_lap_resident_limit(int NPl, int R, int FR, int S, int tiered) {
  const bool kept = tiered == 0;
  const size_t bytes = shl_layout(NPl, R, FR, S, kept, nullptr, nullptr);
  int dev = 0, coop = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return -(int)e;
  if (!coop) return 0;
  int limit = SHL_MAX_LOCAL;
  for (int sys = 0; sys < 2; ++sys) {
    const ShlKernel kern = SHL_KERNELS[kept * 2 + sys];
    int per_sm = 0;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, SHL_THREADS, bytes);
    if (e != cudaSuccess) return -(int)e;
    limit = per_sm * sms < limit ? per_sm * sms : limit;
  }
  return limit;
}

// One card's launch: blocks for the n_loc shards of `table` ([n_loc, SHL_NF]
// host int64: the shard's index, then the addresses of its alloc_r,
// alloc_pods, req_r, nonzero, pod_count, static_ok, il_score, fit_ok,
// fit_sc, ba and start). `xbuf` is the exchange buffer: this card's memory,
// or pinned host memory when the shards span cards.
extern "C" int launch_sharded_lap(
    int NPl, int R, int FR, int fit_strategy, int S, int n_loc, int n_act, int B, int gen,
    int wait_mcycles, const int64_t* request, const int64_t* nz_request,
    const int64_t* has_request, const int64_t* ba_skip, const int32_t* enable,
    const int32_t* fit_slots, const int64_t* fit_weights, const int64_t* weights,
    const int32_t* num_nodes, const int32_t* to_find, HOST const int64_t* table,
    MAPPED int64_t* xbuf, OPTIONAL int32_t* out, OPTIONAL int64_t* work, int32_t* status,
    cudaStream_t stream) {
  if (NPl <= 0 || R < 2 || FR < 0 || n_loc < 1 || n_loc > SHL_MAX_LOCAL || S < n_loc ||
      n_act < 0 || wait_mcycles <= 0 || gen <= 0)
    return (int)cudaErrorInvalidValue;
  const bool kept = work == nullptr;
  if (kept && NPl > SHL_SMEM_ROWS) return (int)cudaErrorInvalidValue;
  // The exchange buffer: this card's memory (gpu scope) or mapped pinned
  // host memory (system scope); anything else this card cannot reach.
  int dev = 0;
  cudaPointerAttributes pa;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaPointerGetAttributes(&pa, xbuf);
  if (e != cudaSuccess) return (int)e;
  bool sys;
  int64_t* x;
  if (pa.type == cudaMemoryTypeDevice && pa.device == dev) {
    sys = false;
    x = xbuf;
  } else if (pa.type == cudaMemoryTypeHost && pa.devicePointer != nullptr) {
    sys = true;
    x = (int64_t*)pa.devicePointer;
  } else {
    return (int)cudaErrorInvalidDevicePointer;
  }
  ResFeat f{request, nz_request, has_request, ba_skip, enable, fit_slots, fit_weights,
            R, FR, fit_strategy};
  ShlArgs a;
  for (int k = 0; k < n_loc; ++k) {
    const int64_t* t = table + (int64_t)k * SHL_NF;
    if (t[0] < 0 || t[0] >= S) return (int)cudaErrorInvalidValue;
    ShardIO& io = a.sh[k];
    io.shard = (int)t[0];
    io.alloc_r = (const int64_t*)t[1];
    io.alloc_pods = (const int64_t*)t[2];
    io.req_r = (int64_t*)t[3];
    io.nonzero = (int64_t*)t[4];
    io.pod_count = (int32_t*)t[5];
    io.static_ok = (const uint8_t*)t[6];
    io.il_score = (const int64_t*)t[7];
    io.fit_ok = (uint8_t*)t[8];
    io.fit_sc = (int64_t*)t[9];
    io.ba = (int64_t*)t[10];
    io.start = (int32_t*)t[11];
  }
  a.weights = weights;
  a.num_nodes = num_nodes;
  a.to_find = to_find;
  a.xbuf = x;
  a.out = out;
  a.work = work;
  a.status = status;
  a.budget = (long long)wait_mcycles * 1000000LL;
  a.gen = gen;
  a.NPl = NPl;
  a.S = S;
  a.n_act = n_act;
  a.B = B;
  const size_t bytes = shl_layout(NPl, R, FR, S, kept, nullptr, nullptr);
  const ShlKernel kern = SHL_KERNELS[kept * 2 + sys];
  int sms = 0, per_sm = 0;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, SHL_THREADS, bytes);
  if (e != cudaSuccess) return (int)e;
  if (n_loc > per_sm * sms) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&f, &a};
  e = cudaLaunchCooperativeKernel((void*)kern, dim3(n_loc), dim3(SHL_THREADS), args, bytes,
                                  stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
