// One-launch logsumexp of a 1-D float32 vector for Hopper (sm_90a), and the
// same read returning the effective sample size of the vector as log weights.
//
// Replaces the Pallas TPU kernel genjax_tpu/ops/logsumexp.py::_lse_kernel
// (dispatched by fused_logsumexp, pallas_call at :65). That kernel streams
// (512, 128) tiles through one core in grid order and carries a running
// (max, sum) pair from one grid step to the next. Blocks on a GPU run in
// parallel and in no order, so each block folds its own range into a
// partial and the partials are merged at the end.
//
// Bound: the kernel reads 4*N bytes once and writes 4 or 8. At N = 1M that
// is 1.2 us of HBM time at 3.35 TB/s, below the fixed cost of any launch
// (an empty kernel takes 2.0 us per launch on an H100 80GB HBM3 at 700 W),
// so the design spends one launch per call and keeps the bytes in flight:
//
//   grid    at most SMs x kBlocksPerSm blocks (one resident wave, from the
//           wrapper's launch_geometry), fewer when N is small; a grid-stride
//           loop covers the rest;
//   loads   each thread starts all kVec 16-byte loads of a step into
//           registers before it folds any (64 B in flight per thread, about
//           8 MB across the card, over the ~3 MB that HBM3 needs to run at
//           its rate). Up to 3 scalars are peeled at the head, so an
//           unaligned start is vectorised too, and up to 3 at the tail.
//           Register loads suffice: each value is read once by one thread,
//           so staging through shared memory buys no reuse; a ring filled
//           by cp.async.bulk (TMA) measured 5-70% slower, and prefetching
//           the next step, 8 loads per thread or more blocks per SM within
//           2% (genjax_tpu_torch/k1_probe.py);
//   fold    per chunk (the 4*kVec values a thread holds): the chunk's max,
//           one rescale of the running sums if the max grew, then one
//           exp2 per value. The rescale is paid per chunk, not per element;
//   merge   each block merges its threads (warp shuffles, then shared
//           memory; the max first, then the rescaled sums) and writes one
//           partial; then it fences and takes a ticket from a counter with
//           atomicAdd. The block that takes the last ticket merges every
//           partial, writes the result and resets the counter to 0 for the
//           next call. A grid of one block (N <= 4096) writes at once.
//
// Measured on that card: 3.1 us at N = 4096, 5.7 us at 1M, 27.9 us at 16M
// (72% of the bound: the launch floor and about 1.6 us of ticket and final
// merge come on top of streaming at about 82% of the HBM rate).
//
// Why a ticket: a second pass costs a second launch, the fixed cost that a
// one-launch design removes. A thread block cluster merges through
// distributed shared memory only within one cluster (8 blocks portably,
// 16 at most), and a grid of hundreds of blocks spans many clusters, so
// their partials would still meet in global memory. The ticket costs one
// atomic per block, and no block ever waits for another, so the result
// does not depend on how many blocks are resident at once.
//
// The partials and the counter live in a workspace that the wrapper
// allocates and zeroes once per (device, stream): calls on one stream run
// in order, so every launch finds the counter at 0, and a second stream
// has its own. A launch allocates nothing and never synchronises, so it
// can be captured in a CUDA graph once its workspace exists.
//
// Special values. The running max is taken over min(x, FLT_MAX), so +inf
// and NaN raise it to FLT_MAX while their own terms, exp(+inf - FLT_MAX)
// = +inf and NaN, carry them into the sums; -inf adds exp(-inf) = 0, and
// an all -inf range keeps the max at -inf and shifts by 0 instead of
// forming -inf - -inf. So the log-sum-exp follows
// jax.scipy.special.logsumexp: all -inf gives -inf, any +inf gives +inf,
// NaN gives NaN, N = 0 gives -inf (fault R1 of the Pallas kernel, NaN
// after a leading all -inf tile, is not inherited). The ESS s1^2 / s2
// follows genjax_tpu/inference/smc.py::ess: N = 0 gives +inf, all -inf
// gives 0/0 = NaN, any +inf gives inf/inf = NaN, NaN gives NaN.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;     // ops/logsumexp.py::_THREADS
constexpr int kVec = 4;           // 16-byte loads per thread per step; _VEC
constexpr int kBlocksPerSm = 4;   // resident blocks per SM; _BLOCKS_PER_SM
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kFloatMax = 3.402823466e+38f;

// 2^x on the special function unit: -inf -> 0, +inf -> +inf, NaN -> NaN.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

struct Acc {
  float m;   // running max of min(x, FLT_MAX); -inf while every x is -inf
  float s1;  // sum of exp(x - shift), shift = m, or 0 while m is -inf
  float s2;  // sum of exp(2 (x - shift)); kept by the ESS variant only
};

template <bool kEss, int C>
__device__ __forceinline__ void fold(Acc& a, const float (&v)[C]) {
  float cm = a.m;
#pragma unroll
  for (int k = 0; k < C; ++k) cm = fmaxf(cm, fminf(v[k], kFloatMax));
  if (cm > a.m) {
    // A max of -inf held only -inf terms, whose sums are 0: factor 0 keeps them.
    const float f = exp2_approx((a.m - cm) * kLog2e);
    a.s1 *= f;
    if (kEss) a.s2 *= f * f;
    a.m = cm;
  }
  const float shift = a.m == -INFINITY ? 0.0f : a.m;
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const float e = exp2_approx((v[k] - shift) * kLog2e);
    a.s1 += e;
    if (kEss) a.s2 = fmaf(e, e, a.s2);
  }
}

// Neither max is NaN or +inf (see fold), so only an all -inf pair needs care.
template <bool kEss>
__device__ __forceinline__ Acc merge(Acc a, Acc b) {
  const float m = fmaxf(a.m, b.m);
  if (m == -INFINITY) return a;
  const float fa = exp2_approx((a.m - m) * kLog2e);
  const float fb = exp2_approx((b.m - m) * kLog2e);
  Acc r{m, a.s1 * fa + b.s1 * fb, 0.0f};
  if (kEss) r.s2 = a.s2 * (fa * fa) + b.s2 * (fb * fb);
  return r;
}

// Merge the warp's 32 Accs in two passes: the max alone first (five
// shuffles of fmaxf), then each sum rescaled once to it and added (five
// shuffles of adds). Five full merges, each with two exp2 on the critical
// path, took 0.5 us more per call at N = 1M (k1_probe.py, variant 1-pass).
template <bool kEss>
__device__ __forceinline__ Acc warp_merge(Acc v) {
  float m = v.m;
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, offset));
  // An all -inf warp has only zero sums: factor 0 instead of exp2(-inf - -inf).
  const float f = m == -INFINITY ? 0.0f : exp2_approx((v.m - m) * kLog2e);
  Acc r{m, v.s1 * f, kEss ? v.s2 * (f * f) : 0.0f};
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    r.s1 += __shfl_xor_sync(0xffffffffu, r.s1, offset);
    if (kEss) r.s2 += __shfl_xor_sync(0xffffffffu, r.s2, offset);
  }
  return r;
}

// One Acc per thread into one Acc, valid in thread 0. Every thread of the
// block must call it; a second call needs a __syncthreads() in between.
template <bool kEss>
__device__ __forceinline__ Acc block_merge(Acc v) {
  __shared__ Acc shared[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_merge<kEss>(v);
  if (lane == 0) shared[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kThreads / 32 ? shared[lane] : Acc{-INFINITY, 0.0f, 0.0f};
    v = warp_merge<kEss>(v);
  }
  return v;
}

// Fold the scalars before the first 16-byte boundary of x (x is 4-byte
// aligned) and after the last one, in threads 0-3 of block 0. Returns the
// number of float4s between them, which start at x + head.
template <bool kEss>
__device__ __forceinline__ int64_t fold_ends(Acc& acc, const float* x, int64_t n, int64_t& head) {
  head = (4 - ((reinterpret_cast<uintptr_t>(x) >> 2) & 3)) & 3;
  if (head > n) head = n;
  const int64_t body = (n - head) >> 2;
  const int64_t tail = head + 4 * body;  // first scalar after the body
  if (blockIdx.x == 0 && threadIdx.x < 4) {
    const int64_t t = threadIdx.x;
    const float v[2] = {t < head ? x[t] : -INFINITY, tail + t < n ? x[tail + t] : -INFINITY};
    fold<kEss>(acc, v);
  }
  return body;
}

template <bool kEss>
__device__ __forceinline__ void write_result(Acc total, int64_t n, float* out) {
  const float shift = total.m == -INFINITY ? 0.0f : total.m;
  out[0] = shift + logf(total.s1);
  if (kEss) out[1] = n == 0 ? INFINITY : total.s1 * total.s1 / total.s2;
}

// Merge the block into one partial, take a ticket, and in the block that
// takes the last one merge every partial and write the result. A grid of
// one block writes its result at once: the fences, the atomic and the
// second merge cost about 2 us, which is most of a call at N <= 4096.
template <bool kEss>
__device__ __forceinline__ void finish(Acc acc, int64_t n, float4* partials, unsigned int* counter,
                                       float* out) {
  acc = block_merge<kEss>(acc);
  if (gridDim.x == 1) {
    if (threadIdx.x == 0) write_result<kEss>(acc, n, out);
    return;
  }
  __shared__ bool is_last;
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = make_float4(acc.m, acc.s1, acc.s2, 0.0f);
    __threadfence();  // the partial is visible before the ticket is taken
    is_last = atomicAdd(counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  Acc total{-INFINITY, 0.0f, 0.0f};
  for (int j = threadIdx.x; j < (int)gridDim.x; j += kThreads) {
    const float4 p = __ldcg(partials + j);  // from L2, past this SM's L1
    total = merge<kEss>(total, Acc{p.x, p.y, p.z});
  }
  total = block_merge<kEss>(total);
  if (threadIdx.x == 0) {
    write_result<kEss>(total, n, out);
    *counter = 0u;
  }
}

// Load the kVec float4s of the step that starts at float4 i (one every
// kThreads float4s, so a warp reads 512 contiguous bytes per load), all
// started before any is used; past `body` they read as -inf.
__device__ __forceinline__ void load_step(float4 (&q)[kVec], const float4* x4, int64_t i, int64_t body) {
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const int64_t j = i + (int64_t)k * kThreads;
    q[k] = j < body ? __ldg(x4 + j) : make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
  }
}

template <bool kEss>
__device__ __forceinline__ void fold_step(Acc& acc, const float4 (&q)[kVec]) {
  float v[4 * kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    v[4 * k] = q[k].x;
    v[4 * k + 1] = q[k].y;
    v[4 * k + 2] = q[k].z;
    v[4 * k + 3] = q[k].w;
  }
  fold<kEss>(acc, v);
}

template <bool kEss>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
genjax_lse(const float* __restrict__ x, int64_t n, float4* __restrict__ partials,
           unsigned int* __restrict__ counter, float* __restrict__ out) {
  Acc acc{-INFINITY, 0.0f, 0.0f};
  int64_t head;
  const int64_t body = fold_ends<kEss>(acc, x, n, head);
  const float4* x4 = reinterpret_cast<const float4*>(x + head);
  const int64_t stride = (int64_t)gridDim.x * (kThreads * kVec);
  for (int64_t i = (int64_t)blockIdx.x * (kThreads * kVec) + threadIdx.x; i < body; i += stride) {
    float4 q[kVec];
    load_step(q, x4, i, body);
    fold_step<kEss>(acc, q);
  }
  finish<kEss>(acc, n, partials, counter, out);
}

}  // namespace

// x: n float32 values, 4-byte aligned; partials: room for `blocks` float4;
// counter: one uint32 that is 0; out: one float32 (the log-sum-exp), or two
// (then the ESS) when `ess` is nonzero. Launches one kernel of `blocks`
// blocks on `stream` and returns cudaGetLastError().
extern "C" int genjax_logsumexp_f32(const void* x, int64_t n, void* partials, void* counter,
                                     void* out, int64_t blocks, int ess, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float4* p = static_cast<float4*>(partials);
  unsigned int* c = static_cast<unsigned int*>(counter);
  float* o = static_cast<float*>(out);
  if (ess) {
    genjax_lse<true><<<(unsigned)blocks, kThreads, 0, s>>>(xf, n, p, c, o);
  } else {
    genjax_lse<false><<<(unsigned)blocks, kThreads, 0, s>>>(xf, n, p, c, o);
  }
  return (int)cudaGetLastError();
}
