// Two-pass logsumexp of a 1-D float32 vector, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel genjax_tpu/ops/logsumexp.py::_lse_kernel
// (dispatched by fused_logsumexp). That kernel streams (512, 128) tiles
// through one core in grid order and carries a running (max, sum) pair in
// scratch memory from one grid step to the next. Blocks on a GPU run in
// parallel and in no order, so nothing can be carried between them:
//
//   pass 1  a grid of blocks, each thread folding a grid-stride range
//           (float4 loads when the vector is 16-byte aligned) into its own
//           (m, s) pair, merged across the warp with __shfl_xor_sync and
//           across warps through shared memory into one partial per block;
//   pass 2  one block merges the partials and writes m + log(s) to a 0-d
//           device tensor. Nothing returns to the host.
//
// Bound: it reads 4*N bytes once (4 MB at N = 1M, about 1.2 us of HBM time
// at 3.35 TB/s), so at the particle path's sizes the two launches cost
// more than the read. Fusing the pair into one launch is left for later.
//
// Semantics are those of jax.scipy.special.logsumexp, not of the Pallas
// kernel: a pair whose max is -inf contributes nothing (exp(-inf - -inf)
// is never evaluated, which is where the Pallas kernel returns NaN after
// a leading all -inf tile), all -inf gives -inf, any +inf gives +inf, any
// NaN gives NaN, and N = 0 gives -inf.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFinishThreads = 1024;

struct MaxSum {
  float m;  // running max
  float s;  // sum of exp(x - m) over the values folded in
};

// Merge two (m, s) pairs. An element x enters as (x, 1).
__device__ __forceinline__ MaxSum merge(MaxSum a, MaxSum b) {
  if (a.m != a.m || b.m != b.m) return MaxSum{NAN, NAN};
  if (b.m > a.m) {
    MaxSum t = a;
    a = b;
    b = t;
  }
  // b contributes nothing when its max is -inf; when a's max is +inf the
  // result is +inf whatever b holds (and inf - inf must not be formed).
  if (b.m == -INFINITY || a.m == INFINITY) return a;
  return MaxSum{a.m, a.s + b.s * expf(b.m - a.m)};
}

__device__ __forceinline__ MaxSum warp_merge(MaxSum v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    MaxSum o{__shfl_xor_sync(0xffffffffu, v.m, offset),
             __shfl_xor_sync(0xffffffffu, v.s, offset)};
    v = merge(v, o);
  }
  return v;
}

// Merge one pair per thread into one pair, valid in thread 0.
__device__ __forceinline__ MaxSum block_merge(MaxSum v) {
  __shared__ float shared_m[32];
  __shared__ float shared_s[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_merge(v);
  if (lane == 0) {
    shared_m[warp] = v.m;
    shared_s[warp] = v.s;
  }
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x >> 5;
    v = lane < n_warps ? MaxSum{shared_m[lane], shared_s[lane]}
                       : MaxSum{-INFINITY, 0.0f};
    v = warp_merge(v);
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
lse_partials(const float* __restrict__ x, int64_t n, float2* __restrict__ partials) {
  MaxSum acc{-INFINITY, 0.0f};
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t head = 0;
  if ((reinterpret_cast<uintptr_t>(x) & 15u) == 0) {
    const int64_t n4 = n / 4;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    for (int64_t j = i; j < n4; j += stride) {
      const float4 v = __ldg(x4 + j);
      acc = merge(acc, MaxSum{v.x, 1.0f});
      acc = merge(acc, MaxSum{v.y, 1.0f});
      acc = merge(acc, MaxSum{v.z, 1.0f});
      acc = merge(acc, MaxSum{v.w, 1.0f});
    }
    head = n4 * 4;
  }
  for (int64_t j = head + i; j < n; j += stride) {
    acc = merge(acc, MaxSum{__ldg(x + j), 1.0f});
  }
  acc = block_merge(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = make_float2(acc.m, acc.s);
}

__global__ void __launch_bounds__(kFinishThreads)
lse_finish(const float2* __restrict__ partials, int n_partials, float* __restrict__ out) {
  MaxSum acc{-INFINITY, 0.0f};
  for (int j = threadIdx.x; j < n_partials; j += blockDim.x) {
    const float2 p = partials[j];
    acc = merge(acc, MaxSum{p.x, p.y});
  }
  acc = block_merge(acc);
  // m + log(s) covers every case: (-inf, 0) -> -inf, (+inf, s >= 1) ->
  // +inf, NaN -> NaN.
  if (threadIdx.x == 0) out[0] = acc.m + logf(acc.s);
}

}  // namespace

// x: n float32 values; partials: 2 * blocks float32 scratch; out: one
// float32. Launches both passes on `stream` and returns cudaGetLastError().
extern "C" int genjax_logsumexp_f32(const void* x, void* partials, void* out,
                                     int64_t n, int64_t blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  lse_partials<<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const float*>(x), n, static_cast<float2*>(partials));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  lse_finish<<<1, kFinishThreads, 0, s>>>(
      static_cast<const float2*>(partials), (int)blocks, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
