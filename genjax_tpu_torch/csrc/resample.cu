// K2: the ancestors of systematic resampling, from K float32 log weights to
// n int64 ancestor indices, for Hopper (sm_90a).
//
// Replaces the chain that genjax_tpu/inference/smc.py::systematic_cum_counts
// and _blocks_to_ancestors (scatter and cummax) compute, and with it
// genjax_tpu/ops/expand.py::expand_cols, the Pallas kernel that expands
// block counts into indices. The port ran it as about 17 PyTorch operations
// a call: exp, a float64 cumsum, seven elementwise passes, arange, minimum
// and searchsorted (inference/smc.py::systematic_ancestors_plain, the plain
// twin, which this kernel reproduces).
//
// What it computes, as the twin does: w_i = expf(lw_i - lse) in float32;
// the cdf, the float64 prefix sums of w over their total; the block counts
// N_i = clamp(floor(n * cdf_i - u0) + 1, 0, n); and slot s gets the particle
// i with N_{i-1} <= s < N_i. Two rules make exact what the twin makes only
// likely: a particle of zero weight takes its predecessor's count (it owns
// no slot), and the counts never decrease. The last particle of positive
// weight ends at cdf = 1 exactly, so its block ends at n; where no particle
// has positive weight, every slot gets particle 0, as in the twin.
//
// Bound: it reads 4K bytes and writes 8n. At K = n = 4M that is 50 MB, 15 us
// of HBM time at 3.35 TB/s; the twin moves about ten times that in seven to
// nine full passes and a binary search per slot.
//
// Design, two launches; no block waits for another:
//
//   k2_tiles  one block per tile of kTile = 4096 particles, kItems = 16
//             consecutive ones a thread. Each thread sums its weights in
//             float64 in order; a block scan (shuffles, then the warps'
//             totals added in order) gives its offset e in the tile, and a
//             block max-scan the largest in-tile prefix of a positive weight
//             before it; the thread keeps both in the workspace. The block
//             writes its tile's sum and largest prefix and takes a ticket
//             (as K1 does): the block that takes the last one scans the
//             tiles' sums into each tile's offset P_t, takes the running
//             maximum F_t of the tiles' largest prefixes (P_t + the tile's
//             own) before tile t, the total (the last F), each tile's first
//             slot a_t = count(F_t), and a table of the tiles with more than
//             kHeavy slots by chunk of kChunk slots, and resets the ticket.
//   k2_write  one block per tile with at most kHeavy slots, and one per
//             chunk of slots for the heavy tiles in it, so that a particle
//             that owns many slots is written by many blocks. A block reads
//             its tile's 16 KB of log weights again (from L2) and forms each
//             positive weight's prefix as k2_tiles rounded it, P_t + (e +
//             own sum); a particle's count is that of the running maximum
//             of the prefixes up to it. A maximum is exact in any order, so
//             the counts never decrease, whatever order the float64 sums
//             were rounded in, and the count at a tile's start is the one
//             the tile before it ends on: the tiles' runs of slots neither
//             gap nor overlap. The block writes its slots kChunk at a time:
//             each run marks its first slot in the chunk in shared memory, a
//             block max-scan of the marks fills the runs (a particle's index
//             grows with its slots), and the chunk goes out in coalesced
//             int64 stores; a chunk inside one run is written at once.
//
// The counts are those of the twin except where a particle's n * cdf - u0
// lies within the float64 rounding of the two sums' orders (about 1e-9 at
// K = 4M) of an integer: there a block boundary may move by one slot. None
// did on the tests' weights at 4096, 1M and 4M.
//
// Measured on an H100 80GB HBM3 at 700 W (device time a call, K = n, the
// weights warm in L2): 0.017 ms at 4096, 0.027 ms at 1M, 0.064 ms at 4M
// (23.5% of the bound), against the twin's 0.045, 0.120 and 0.446 ms. What
// holds it above its bound is each block's chain of dependent steps (loads,
// block scans, barriers), not the bytes. K and n are below 2^31 (the
// wrapper checks).
//
// The wrapper allocates the workspace (5 doubles a tile, 2 a thread of a
// tile, one a chunk of slots and a few more, zeroed) once per (device,
// stream) and grows it for a larger K or n; a launch allocates nothing and
// never synchronises. lse and u0 come by pointer (a 0-d float32 tensor on
// the card) or by value.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;             // ops/resample.py::_THREADS
constexpr int kItems = 16;                // consecutive particles a thread
constexpr int kTile = kThreads * kItems;  // ops/resample.py::_TILE
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 8192;              // slots staged in shared memory
constexpr int kChunkPerThread = kChunk / kThreads;
constexpr int64_t kHeavy = 2 * kChunk;    // more slots than this: written by chunk
constexpr double kNegInf = -(double)INFINITY;

struct Scalars {
  const float* lse_ptr;  // the log-sum-exp on the card, or null: then lse
  float lse;
  const float* u0_ptr;   // the uniform on the card, or null: then u0
  float u0;
  int64_t n;             // output slots
};

struct Workspace {
  double* sum;            // [cap] each tile's sum of weights
  double* top;            // [cap] its largest in-tile prefix of a positive weight
  double* offset;         // [cap] P_t, the sum of the tiles before it
  double* floor_;         // [cap] F_t, the largest prefix before it
  int64_t* start;         // [cap + 1] a_t, its first slot
  double* total;          // the largest prefix of all
  int64_t* last;          // the last tile that owns a slot, else 0
  unsigned int* counter;  // the ticket counter, 0 between launches
  int* heavy;             // [2 * chunk cap] per chunk of slots, the heavy tiles in it
  double2* threads;       // [cap * kThreads] per thread of a tile: its offset e in
                          // the tile, and the largest in-tile prefix of a positive
                          // weight before its first particle
};

struct Add {
  __device__ double operator()(double a, double b) const { return __dadd_rn(a, b); }
};
struct MaxD {
  __device__ double operator()(double a, double b) const { return fmax(a, b); }
};
struct MaxI {
  __device__ long long operator()(long long a, long long b) const { return a > b ? a : b; }
};

// Exclusive scan of one value per thread, in a fixed order (each warp by
// shuffles, then the warps' totals combined in warp order): the combination
// of the threads before this one, `identity` for thread 0; `total` gets the
// whole block's. Every thread of the block must call it.
template <typename T, typename Op>
__device__ __forceinline__ T block_exclusive_scan(T x, T identity, Op op, T& total) {
  __shared__ T warp_totals[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc = op(y, inc);
  }
  T exc = __shfl_up_sync(0xffffffffu, inc, 1);
  if (lane == 0) exc = identity;
  if (lane == 31) warp_totals[warp] = inc;
  __syncthreads();
  T before = identity, all = identity;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) {
    if (k == warp) before = all;
    all = op(all, warp_totals[k]);
  }
  __syncthreads();  // warp_totals may be written again
  total = all;
  return lane == 0 ? before : op(before, exc);
}

// What a prefix's block count needs: the total, the uniform, n, n / total
// and the margin `tol` (below).
struct Counter {
  double total, u0, scale, tol;
  int64_t n;
};

__device__ __forceinline__ Counter make_counter(double total, double u0, int64_t n) {
  const double t = fmax(total, 1e-300);
  return Counter{t, u0, __ddiv_rn((double)n, t), (double)n * 0x1p-40, n};
}

// The block count of a prefix p: clamp(floor(n * (p / total) - u0) + 1, 0,
// n), each operation rounded once as the twin's separate operations round
// it (no fused multiply-add). One multiply by n / total gives the same
// floor unless its value lies within tol = n 2^-40 of an integer, far above
// how far the two ways round apart (at most 6 n 2^-53); there the twin's
// operations decide. A prefix of -inf (no positive weight yet) counts 0, as
// does NaN.
__device__ __forceinline__ int count_at(double p, const Counter& k) {
  if (p == kNegInf) return 0;
  const double y = __dsub_rn(__dmul_rn(p, k.scale), k.u0);
  double f = floor(y);
  if (!(y - f > k.tol && f + 1.0 - y > k.tol)) {
    f = floor(__dsub_rn(__dmul_rn((double)k.n, __ddiv_rn(p, k.total)), k.u0));
  }
  if (!(f >= 0.0)) return 0;
  if (f >= (double)k.n) return (int)k.n;
  return (int)f + 1;
}

// The thread's kItems weights, expf(lw - lse) as torch.exp rounds it; past K
// they are 0.
__device__ __forceinline__ void load_weights(const float* __restrict__ lw, int64_t K, int64_t first, float lse,
                                             float (&w)[kItems]) {
  if (first + kItems <= K && (reinterpret_cast<uintptr_t>(lw + first) & 15) == 0) {
    const float4* p = reinterpret_cast<const float4*>(lw + first);
#pragma unroll
    for (int k = 0; k < kItems / 4; ++k) {
      const float4 q = __ldg(p + k);
      w[4 * k] = q.x;
      w[4 * k + 1] = q.y;
      w[4 * k + 2] = q.z;
      w[4 * k + 3] = q.w;
    }
#pragma unroll
    for (int i = 0; i < kItems; ++i) w[i] = expf(__fsub_rn(w[i], lse));
  } else {
#pragma unroll
    for (int i = 0; i < kItems; ++i) w[i] = first + i < K ? expf(__fsub_rn(__ldg(lw + first + i), lse)) : 0.0f;
  }
}

__device__ __forceinline__ float read_lse(const Scalars& sc) { return sc.lse_ptr ? *sc.lse_ptr : sc.lse; }
__device__ __forceinline__ double read_u0(const Scalars& sc) { return (double)(sc.u0_ptr ? *sc.u0_ptr : sc.u0); }

// The last slot, plus one, of tile t's runs: a_{t+1}, but for the last tile
// with a slot, n (slots past the last run's end go to its particle).
__device__ __forceinline__ int64_t tile_end(const Workspace& ws, int64_t t, int64_t n) {
  return t == *ws.last ? n : ws.start[t + 1];
}

// The last block of k2_tiles: every tile's offset, floor and first slot,
// the total, the last tile with a slot, and the table of heavy tiles (more
// slots than kHeavy) by chunk of kChunk slots: for chunk j, the heavy tile
// that holds its first slot and the one that starts inside it (at most one
// of each; -1 for none). Thread j takes a run of consecutive tiles.
__device__ void scan_tiles(int64_t tiles, const Scalars& sc, const Workspace& ws) {
  const int64_t per = (tiles + kThreads - 1) / kThreads;
  const int64_t lo = tiles < threadIdx.x * per ? tiles : threadIdx.x * per;
  const int64_t hi = tiles < lo + per ? tiles : lo + per;
  double s = 0.0;
  for (int64_t t = lo; t < hi; ++t) s = __dadd_rn(s, __ldcg(ws.sum + t));
  double unused;
  double r = block_exclusive_scan(s, 0.0, Add(), unused);
  double top = kNegInf;
  for (int64_t t = lo; t < hi; ++t) {
    const double b = __ldcg(ws.top + t);
    const double c = b == kNegInf ? kNegInf : __dadd_rn(r, b);
    ws.offset[t] = r;
    ws.floor_[t] = c;  // the tile's own largest prefix, until the next loop
    top = fmax(top, c);
    r = __dadd_rn(r, __ldcg(ws.sum + t));
  }
  double total;
  double m = block_exclusive_scan(top, kNegInf, MaxD(), total);
  const Counter k = make_counter(total, read_u0(sc), sc.n);
  long long last = -1;
  for (int64_t t = lo; t < hi; ++t) {
    const double c = ws.floor_[t];
    const int a = count_at(m, k);
    ws.floor_[t] = m;
    ws.start[t] = a;
    m = fmax(m, c);
    if (count_at(m, k) > a) last = t;
  }
  long long last_all;
  block_exclusive_scan(last, -1LL, MaxI(), last_all);
  const int64_t chunks = (sc.n + kChunk - 1) / kChunk;
  for (int64_t j = threadIdx.x; j < 2 * chunks; j += kThreads) ws.heavy[j] = -1;
  if (threadIdx.x == 0) {
    ws.start[tiles] = count_at(total, k);
    *ws.total = total;
    *ws.last = last_all < 0 ? 0 : last_all;
  }
  __syncthreads();
  for (int64_t t = lo; t < hi; ++t) {
    const int64_t a = ws.start[t], e = tile_end(ws, t, sc.n);
    if (e - a <= kHeavy) continue;
    if (a % kChunk) ws.heavy[2 * (a / kChunk) + 1] = (int)t;
    for (int64_t j = (a + kChunk - 1) / kChunk; j * kChunk < e; ++j) ws.heavy[2 * j] = (int)t;
  }
}

__global__ void __launch_bounds__(kThreads)
k2_tiles(const float* __restrict__ lw, int64_t K, Scalars sc, Workspace ws) {
  const int64_t first = (int64_t)blockIdx.x * kTile + (int64_t)threadIdx.x * kItems;
  float w[kItems];
  load_weights(lw, K, first, read_lse(sc), w);
  double s = 0.0, at_last = kNegInf;  // the running sum, and at the last positive weight
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    s = __dadd_rn(s, (double)w[i]);
    if (w[i] > 0.0f) at_last = s;
  }
  double tile_sum, top;
  const double e = block_exclusive_scan(s, 0.0, Add(), tile_sum);
  const double g = block_exclusive_scan(at_last == kNegInf ? kNegInf : __dadd_rn(e, at_last), kNegInf, MaxD(), top);
  ws.threads[(int64_t)blockIdx.x * kThreads + threadIdx.x] = make_double2(e, g);

  __shared__ bool is_last;
  if (threadIdx.x == 0) {
    ws.sum[blockIdx.x] = tile_sum;
    ws.top[blockIdx.x] = top;
    __threadfence();  // the tile's values are visible before the ticket is taken
    is_last = atomicAdd(ws.counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  scan_tiles(gridDim.x, sc, ws);
  if (threadIdx.x == 0) *ws.counter = 0u;
}

// The counts of this thread's particles of `tile`: `before`, the count
// before its first, and cnt[i], the count after particle i. k2_tiles's
// prefixes again, each positive weight's as P_t + (e + own sum), from the
// thread's offset e that k2_tiles kept; the count of the running maximum of
// the prefixes of positive weight, which a zero weight leaves as it was.
// Before the thread's first particle that maximum is the larger of the
// tiles' before (F_t) and P_t + the largest in-tile prefix of the threads'
// before it, as rounding P_t + x keeps the order of x.
__device__ __forceinline__ void tile_counts(const float* __restrict__ lw, int64_t K, int64_t tile, const Scalars& sc,
                                            const Workspace& ws, const Counter& k, int64_t first, int& before,
                                            int (&cnt)[kItems]) {
  const double2 mine = ws.threads[tile * kThreads + threadIdx.x];
  const double offset = ws.offset[tile];
  float w[kItems];
  load_weights(lw, K, first, read_lse(sc), w);
  double run = fmax(ws.floor_[tile], __dadd_rn(offset, mine.y));
  int c = count_at(run, k);
  before = c;
  double s = 0.0;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    s = __dadd_rn(s, (double)w[i]);
    if (w[i] > 0.0f) {
      const double v = __dadd_rn(offset, __dadd_rn(mine.x, s));
      if (v > run) {  // the count only grows with the running maximum
        run = v;
        c = count_at(run, k);
      }
    }
    cnt[i] = c;
  }
}

// Shared memory index of chunk slot j: one word of padding every 32, so the
// threads of a warp, each on its own run of kChunkPerThread slots, fall in
// different banks.
__device__ __forceinline__ int padded(int j) { return j + (j >> 5); }

// Write slots [lo, hi) of one tile's runs: particle first + i owns
// [cnt[i-1], cnt[i]), and the run that ends at `stretch_from`, where it is
// not -1, ends at hi instead. kChunk slots at a time: each run in the chunk
// marks its first slot there in shared memory, a block max-scan of the
// marks fills the runs (the particles' indices grow with the slots), and
// the block writes the chunk out in coalesced stores. With `whole_chunks`,
// a chunk inside one run is written from its particle at once.
__device__ void write_runs(int64_t lo, int64_t hi, int64_t first, int before, const int (&cnt)[kItems],
                           int64_t stretch_from, bool whole_chunks, int64_t* __restrict__ out) {
  __shared__ int marks[kChunk + kChunk / 32];
  __shared__ int whole;
  for (int64_t c = lo; c < hi; c += kChunk) {
    const int64_t end = hi < c + kChunk ? hi : c + kChunk;
    const int len = (int)(end - c);
    int64_t prev = before;
    if (whole_chunks) {
      if (threadIdx.x == 0) whole = -1;
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const int64_t stop = cnt[i] == stretch_from && prev < cnt[i] ? hi : cnt[i];
        if (prev <= c && stop >= end && prev < stop) whole = (int)(first + i);
        prev = cnt[i];
      }
      __syncthreads();
      const int owner = whole;
      __syncthreads();  // `whole` is written again in the next chunk
      if (owner >= 0) {
        for (int64_t j = c + threadIdx.x; j < end; j += kThreads) out[j] = owner;
        continue;
      }
      prev = before;
    }
    for (int j = threadIdx.x; j < len; j += kThreads) marks[padded(j)] = -1;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int64_t stop = cnt[i] == stretch_from && prev < cnt[i] ? hi : cnt[i];
      if (prev < stop && prev < end && stop > c) marks[padded((int)((prev > c ? prev : c) - c))] = (int)(first + i);
      prev = cnt[i];
    }
    __syncthreads();
    const int base = threadIdx.x * kChunkPerThread;
    int m = -1;
#pragma unroll
    for (int j = 0; j < kChunkPerThread; ++j) {
      if (base + j < len) m = max(m, marks[padded(base + j)]);
    }
    long long unused;
    int r = (int)block_exclusive_scan((long long)m, -1LL, MaxI(), unused);
#pragma unroll
    for (int j = 0; j < kChunkPerThread; ++j) {
      if (base + j < len) {
        r = max(r, marks[padded(base + j)]);
        marks[padded(base + j)] = r;
      }
    }
    __syncthreads();
    for (int64_t j = c + threadIdx.x; j < end; j += kThreads) out[j] = marks[padded((int)(j - c))];
    __syncthreads();  // the marks are written again in the next chunk
  }
}

// Write tile t's slots in [lo, hi), which lie in its runs' range. Where no
// particle of any tile has a positive weight, the last tile is 0 and owns
// every slot, and every slot gets particle 0, as in the twin.
__device__ void write_tile(const float* __restrict__ lw, int64_t K, const Scalars& sc, const Workspace& ws,
                           int64_t t, int64_t lo, int64_t hi, bool whole_chunks, int64_t* __restrict__ out) {
  const int64_t stretch_from = t == *ws.last ? ws.start[t + 1] : -1;
  if (stretch_from == ws.start[t]) {
    for (int64_t j = lo + threadIdx.x; j < hi; j += kThreads) out[j] = 0;
    return;
  }
  const Counter k = make_counter(*ws.total, read_u0(sc), sc.n);
  const int64_t first = t * kTile + (int64_t)threadIdx.x * kItems;
  int before, cnt[kItems];
  tile_counts(lw, K, t, sc, ws, k, first, before, cnt);
  write_runs(lo, hi, first, before, cnt, stretch_from, whole_chunks, out);
}

// Blocks [0, tiles): each tile's slots, where it has at most kHeavy. Blocks
// [tiles, tiles + chunks): chunk j's slots of the heavy tiles in it.
// At most 80 registers a thread, so that three blocks share an SM: 5-15%
// faster at 4M than at the compiler's 126 registers (H100 80GB HBM3).
__global__ void __launch_bounds__(kThreads, 3)
k2_write(const float* __restrict__ lw, int64_t K, int64_t tiles, Scalars sc, Workspace ws,
         int64_t* __restrict__ out) {
  const bool helper = blockIdx.x >= tiles;
  const int64_t j = blockIdx.x - tiles, c0 = j * kChunk, c1 = sc.n < c0 + kChunk ? sc.n : c0 + kChunk;
#pragma unroll 1
  for (int task = 0; task < (helper ? 2 : 1); ++task) {
    const int64_t t = helper ? (int64_t)ws.heavy[2 * j + task] : (int64_t)blockIdx.x;
    if (t < 0) continue;
    const int64_t a = ws.start[t], e = tile_end(ws, t, sc.n);
    const int64_t lo = helper && a < c0 ? c0 : a, hi = helper && e > c1 ? c1 : e;
    if (hi > lo && (helper || hi - lo <= kHeavy)) write_tile(lw, K, sc, ws, t, lo, hi, helper || hi - lo > kChunk, out);
  }
}

}  // namespace

// Where the per-thread pairs start in a workspace for `cap` tiles and
// `chunk_cap` chunks of kChunk slots, in doubles: 16-byte aligned.
static int64_t threads_at(int64_t cap, int64_t chunk_cap) {
  const int64_t at = 5 * cap + 4 + chunk_cap;
  return at + (at & 1);
}

// The doubles such a workspace holds.
extern "C" int64_t genjax_k2_workspace_doubles(int64_t cap, int64_t chunk_cap) {
  return threads_at(cap, chunk_cap) + 2 * kThreads * cap;
}

// lw: K float32 log weights, 4-byte aligned; lse_ptr / u0_ptr: a float32 on
// the card, or null, and then lse / u0 by value; n: output slots;
// workspace: genjax_k2_workspace_doubles(cap, chunk_cap) doubles, zeroed
// before its first launch, with cap >= ceil(K / 4096) and chunk_cap >=
// ceil(n / 8192); out: n int64. Launches the two kernels on `stream` and
// returns the first cudaGetLastError() that is not 0.
extern "C" int genjax_k2_systematic(const void* lw, int64_t K, const void* lse_ptr, float lse, const void* u0_ptr,
                                    float u0, int64_t n, void* workspace, int64_t cap, int64_t chunk_cap, void* out,
                                    void* stream) {
  const int64_t tiles = (K + kTile - 1) / kTile, chunks = (n + kChunk - 1) / kChunk;
  if (K <= 0 || n <= 0 || tiles > cap || chunks > chunk_cap || K > INT32_MAX || n > INT32_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  double* base = static_cast<double*>(workspace);
  const Workspace ws{base,
                     base + cap,
                     base + 2 * cap,
                     base + 3 * cap,
                     reinterpret_cast<int64_t*>(base + 4 * cap),
                     base + 5 * cap + 1,
                     reinterpret_cast<int64_t*>(base + 5 * cap + 2),
                     reinterpret_cast<unsigned int*>(base + 5 * cap + 3),
                     reinterpret_cast<int*>(base + 5 * cap + 4),
                     reinterpret_cast<double2*>(base + threads_at(cap, chunk_cap))};
  const Scalars sc{static_cast<const float*>(lse_ptr), lse, static_cast<const float*>(u0_ptr), u0, n};
  const float* x = static_cast<const float*>(lw);
  k2_tiles<<<(unsigned)tiles, kThreads, 0, s>>>(x, K, sc, ws);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  k2_write<<<(unsigned)(tiles + chunks), kThreads, 0, s>>>(x, K, tiles, sc, ws, static_cast<int64_t*>(out));
  return (int)cudaGetLastError();
}
