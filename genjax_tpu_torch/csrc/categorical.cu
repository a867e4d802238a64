// K4: the categorical's draw and score over rows of float32 logits, for
// Hopper (sm_90a).
//
// Replaces no kernel of the JAX package: there `categorical`
// (genjax_tpu/distributions/library.py::_categorical_sample and
// _categorical_logpdf) is jax.random.categorical and a log-softmax, which
// XLA fuses. The port ran them eagerly over (rows, C) logits: the draw as a
// (rows, C) Exp(1) draw, its log, a subtraction and an argmax (Gumbel-max);
// the score as about nine launches (a support test, two wheres, an expand
// and gather, torch.logsumexp's max, subtraction, exp, sum and log, and a
// subtraction). Each entry point here is one launch and one read of the
// rows.
//
// What it computes (ops/categorical.py's plain twins compute the same):
//
//   draw   for row r and the uniform u_r in [0, 1): m = max_j x_j; e_j =
//          expf(x_j - m) in float32; S_j = e_0 + ... + e_j and the total
//          S in float64; the value is the first column j of positive mass
//          (e_j > 0) with S_j > u_r * S. Where none is (u_r * S rounds to
//          S or above), the last column of positive mass; where the row has
//          none (all -inf), 0. A column of zero mass is never drawn. This
//          is inverse-CDF sampling: the same law as the Gumbel-max draw it
//          replaces, with the row's probabilities rounded to float32.
//   score  x_v - (log(sum_j exp(x_j - s)) + s) with s = m, or 0 where m is
//          infinite, as torch.logsumexp computes it; -inf where the int64
//          value v is not in 0..C-1.
//
// Both take a row stride, so one row shared by every draw has stride 0,
// and the score a value stride, so one shared value has stride 0.
//
// Bound: each reads 4C bytes a row, and the draw 4 more (u) and writes 8
// (its int64 value); the score reads 8 (an int64 value; nothing more where
// it is shared) and writes 4. At C = 64 and 2^20 rows: 268 MB, 80 us at
// 3.35 TB/s. The work (about 3C operations a row) is far below the card's
// rate; what matters is keeping enough bytes in flight.
//
// Design: rows of up to kMaxC = 64 columns (the HMM's states; wider rows
// keep the eager path). A row is held by a group of kLanes = 8 lanes in
// registers, kItems = 8 consecutive columns a lane (two 16-byte loads
// where the row is 16-byte aligned), four rows a warp. Rows are taken in a
// grid-stride loop by one resident wave of blocks (kBlocksPerSm of 256
// threads a SM), and a warp loads its next rows before it works on the
// current ones, so two rows a group are in flight. Every lane runs the
// same shuffles: the max and the sum are butterflies within the group; the
// draw's prefix sums are each lane's running sum in float64 over its
// columns on top of a group scan of the lanes' sums, and the first hit and
// the last column of positive mass are a group min and max. A lane's own
// columns share its running sum, so a column of zero mass gets its
// predecessor's; across lanes the scan rounds in another order, so a hit
// also asks for positive mass. The score reads x_v once more, from cache.
// Outputs are written by each group's first lane. A launch allocates
// nothing and never synchronises. (A warp a row with two columns a lane
// ran at 35% of the bound at 2^20 rows of 64: its chain of dependent
// shuffles a row, not the bytes, set the pace.)

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 8;                   // lanes a row
constexpr int kItems = 8;                   // consecutive columns a lane holds
constexpr int kMaxC = kLanes * kItems;      // ops/categorical.py::MAX_CATEGORIES
constexpr int kRows = 32 / kLanes;          // rows a warp
constexpr int kBlocksPerSm = 8;             // 64 warps a SM: one resident wave
constexpr unsigned kAll = 0xffffffffu;

// Lane g's columns of a row: x[i] = row[g * kItems + i]; -inf past C, and
// everywhere where the row is not `here` (past the last).
__device__ __forceinline__ void load_row(const float* __restrict__ row, bool here, int C, int g, float (&x)[kItems]) {
  const int j = g * kItems;
  if (here && (reinterpret_cast<uintptr_t>(row) & 15) == 0 && j + kItems <= C) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(row + j));
    const float4 b = __ldg(reinterpret_cast<const float4*>(row + j + 4));
    x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
    x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < kItems; ++i) x[i] = here && j + i < C ? __ldg(row + j + i) : -INFINITY;
  }
}

// Butterflies within the groups of kLanes lanes (an xor below kLanes stays
// in the group): every lane gets its group's result.
template <typename T, typename Op>
__device__ __forceinline__ T group_reduce(T v, Op op) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(kAll, v, o));
  return v;
}

struct MaxF {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};
struct SumD {
  __device__ double operator()(double a, double b) const { return a + b; }
};
struct MinI {
  __device__ int operator()(int a, int b) const { return min(a, b); }
};
struct MaxI {
  __device__ int operator()(int a, int b) const { return max(a, b); }
};

__device__ __forceinline__ float row_max(const float (&x)[kItems]) {
  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < kItems; ++i) m = fmaxf(m, x[i]);
  return group_reduce(m, MaxF());
}

// x[i] becomes expf(x[i] - shift); lane_sum, the lane's sum in float64;
// returns the row's sum, in every lane of the group.
__device__ __forceinline__ double exp_sum(float (&x)[kItems], float shift, double& lane_sum) {
  lane_sum = 0.0;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    x[i] = expf(__fsub_rn(x[i], shift));
    lane_sum += (double)x[i];
  }
  return group_reduce(lane_sum, SumD());
}

// The draw of one row whose lane columns are x (lane g of its group), with
// the uniform u.
__device__ __forceinline__ int64_t draw_row(float (&x)[kItems], float u, int g) {
  double lane_sum;
  const float m = row_max(x);
  const double t = (double)u * exp_sum(x, m, lane_sum);  // x now holds the masses e
  double inc = lane_sum;
#pragma unroll
  for (int o = 1; o < kLanes; o <<= 1) {
    const double y = __shfl_up_sync(kAll, inc, o, kLanes);
    if (g >= o) inc += y;
  }
  double p = __shfl_up_sync(kAll, inc, 1, kLanes);
  if (g == 0) p = 0.0;
  int first = kMaxC, last = -1;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    p += (double)x[i];
    if (x[i] > 0.0f) {
      const int col = g * kItems + i;
      last = col;
      if (first == kMaxC && p > t) first = col;
    }
  }
  first = group_reduce(first, MinI());
  last = group_reduce(last, MaxI());
  return first < kMaxC ? first : (last >= 0 ? last : 0);
}

// The row's log-sum-exp as torch.logsumexp takes it (the shift 0 where the
// max is infinite), in every lane of the group.
__device__ __forceinline__ float row_lse(float (&x)[kItems]) {
  double lane_sum;
  const float m = row_max(x);
  const float shift = fabsf(m) == INFINITY ? 0.0f : m;
  return __fadd_rn((float)log(exp_sum(x, shift, lane_sum)), shift);
}

// The grid-stride loop of both entry points: each warp takes kRows
// consecutive rows at a time, one a group, and loads the next ones
// (rows + step) before it hands the current ones to `row_fn(x, r, here,
// item, g)`; `item_of(r)` reads a row's own input (its uniform or its
// value) ahead with its logits.
template <typename Item, typename ItemOf, typename RowFn>
__device__ __forceinline__ void each_row(const float* __restrict__ logits, int64_t rows, int C, int64_t stride,
                                         ItemOf item_of, RowFn row_fn) {
  const int lane = threadIdx.x & 31, g = lane % kLanes, sub = lane / kLanes;
  const int64_t step = (int64_t)gridDim.x * kWarps * kRows;
  int64_t base = ((int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5)) * kRows;
  if (base >= rows) return;  // the whole warp
  float x[kItems];
  int64_t r = base + sub;
  load_row(logits + (r < rows ? r : 0) * stride, r < rows, C, g, x);
  Item item = r < rows ? item_of(r) : Item();
  for (; base < rows; base += step) {
    r = base + sub;
    const int64_t n = r + step;
    float next[kItems];
    Item item_n = Item();
    if (base + step < rows) {  // the whole warp
      load_row(logits + (n < rows ? n : 0) * stride, n < rows, C, g, next);
      if (n < rows) item_n = item_of(n);
    }
    row_fn(x, r, r < rows, item, g);
#pragma unroll
    for (int i = 0; i < kItems; ++i) x[i] = next[i];
    item = item_n;
  }
}

__global__ void __launch_bounds__(kThreads)
k4_draw(const float* __restrict__ logits, int64_t rows, int C, int64_t stride, const float* __restrict__ u,
        int64_t* __restrict__ out) {
  each_row<float>(
      logits, rows, C, stride, [=](int64_t r) { return __ldg(u + r); },
      [=](float (&x)[kItems], int64_t r, bool here, float ur, int g) {
        const int64_t v = draw_row(x, ur, g);
        if (here && g == 0) out[r] = v;
      });
}

__global__ void __launch_bounds__(kThreads)
k4_score(const float* __restrict__ logits, int64_t rows, int C, int64_t stride, const int64_t* __restrict__ values,
         int64_t value_stride, float* __restrict__ out) {
  each_row<long long>(
      logits, rows, C, stride,
      [=](int64_t r) { return __ldg(reinterpret_cast<const long long*>(values) + r * value_stride); },
      [=](float (&x)[kItems], int64_t r, bool here, long long v, int g) {
        const float lse = row_lse(x);
        if (here && g == 0) out[r] = v < 0 || v >= C ? -INFINITY : __fsub_rn(__ldg(logits + r * stride + v), lse);
      });
}

// One resident wave of blocks, or fewer where the rows need fewer.
unsigned blocks_for(int64_t rows) {
  int device = 0, sms = 132;
  if (cudaGetDevice(&device) == cudaSuccess) cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int64_t per_block = (int64_t)kWarps * kRows;
  const int64_t want = (rows + per_block - 1) / per_block, wave = (int64_t)sms * kBlocksPerSm;
  return (unsigned)(want < wave ? want : wave);
}

}  // namespace

// logits: rows of C float32 (2 <= C <= 64), row r at logits + r * stride
// (stride >= 0, in floats; its C entries contiguous); u: rows float32
// uniforms in [0, 1); out: rows int64. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int genjax_k4_draw(const void* logits, int64_t rows, int64_t C, int64_t stride, const void* u, void* out,
                              void* stream) {
  if (rows <= 0 || C < 2 || C > kMaxC || stride < 0) return (int)cudaErrorInvalidValue;
  k4_draw<<<blocks_for(rows), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), rows, (int)C, stride, static_cast<const float*>(u), static_cast<int64_t*>(out));
  return (int)cudaGetLastError();
}

// logits as for genjax_k4_draw; values: row r's int64 value at values +
// r * value_stride (value_stride >= 0, in elements); out: rows float32.
extern "C" int genjax_k4_score(const void* logits, int64_t rows, int64_t C, int64_t stride, const void* values,
                               int64_t value_stride, void* out, void* stream) {
  if (rows <= 0 || C < 2 || C > kMaxC || stride < 0 || value_stride < 0) return (int)cudaErrorInvalidValue;
  k4_score<<<blocks_for(rows), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), rows, (int)C, stride, static_cast<const int64_t*>(values), value_stride,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}
