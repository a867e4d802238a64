// Variants of K1 (logsumexp.cu), for measurement only: the package never
// launches them. genjax_tpu_torch/k1_probe.py builds this file, checks each
// variant against the plain logsumexp and times it beside K1 itself.
//
//   prefetch  K1 with the loads of the next grid step started before the
//             current step is folded (two steps in registers per thread);
//   bulk      each block streams its tiles into a 4-stage ring in shared
//             memory with cp.async.bulk (the 1-D bulk copy of the Tensor
//             Memory Accelerator), one mbarrier per stage, and its threads
//             fold from shared memory;
//   even      K1's grid, each block reading one contiguous range of equal
//             length instead of striding over the vector with the grid;
//   vec8      8 loads of 16 bytes in flight per thread instead of 4;
//   6/SM, 8/SM  K1 with 6 or 8 resident blocks per SM instead of 4;
//   1-pass    K1 whose warp merges take five full (max, rescale, add)
//             merges instead of the max first and the rescaled sums after;
//   acq_rel   K1 with fence.acq_rel.gpu where it has __threadfence();
//   empty     one thread writes one float: the floor of any launch;
//   noop      a C function that returns at once: the floor of a ctypes call.
//
// All reuse K1's fold, merge and finish, so they compute the same function
// (the log-sum-exp; K1's ESS variant is timed by chip_smoke.py).

#include "logsumexp.cu"

namespace {

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
probe_prefetch(const float* __restrict__ x, int64_t n, float4* __restrict__ partials,
               unsigned int* __restrict__ counter, float* __restrict__ out) {
  Acc acc{-INFINITY, 0.0f, 0.0f};
  int64_t head;
  const int64_t body = fold_ends<false>(acc, x, n, head);
  const float4* x4 = reinterpret_cast<const float4*>(x + head);
  const int64_t stride = (int64_t)gridDim.x * (kThreads * kVec);
  int64_t i = (int64_t)blockIdx.x * (kThreads * kVec) + threadIdx.x;
  float4 q[kVec];
  load_step(q, x4, i, body);
  for (; i < body; i += stride) {
    float4 next[kVec];
    load_step(next, x4, i + stride, body);
    fold_step<false>(acc, q);
#pragma unroll
    for (int k = 0; k < kVec; ++k) q[k] = next[k];
  }
  finish<false>(acc, n, partials, counter, out);
}

constexpr int kStages = 4;
constexpr int kTile = 2 * kThreads;  // float4s per stage: 8 KB

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void wait_parity(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem(bar)),
      "r"(parity)
      : "memory");
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
probe_bulk(const float* __restrict__ x, int64_t n, float4* __restrict__ partials,
           unsigned int* __restrict__ counter, float* __restrict__ out) {
  __shared__ __align__(128) float4 ring[kStages][kTile];
  __shared__ __align__(8) uint64_t full[kStages];
  Acc acc{-INFINITY, 0.0f, 0.0f};
  int64_t head;
  const int64_t body = fold_ends<false>(acc, x, n, head);
  const float4* x4 = reinterpret_cast<const float4*>(x + head);
  const int64_t tiles = (body + kTile - 1) / kTile;
  const int64_t b = blockIdx.x, g = gridDim.x;
  const int64_t mine = tiles > b ? (tiles - b + g - 1) / g : 0;  // tiles b, b + g, ...

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem(&full[s])) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto fetch = [&](int64_t k) {  // this block's k-th tile into stage k % kStages
    const int64_t first = (b + k * g) * kTile;
    const int64_t count = body - first < kTile ? body - first : kTile;
    const uint32_t bytes = static_cast<uint32_t>(count * 16);
    const uint32_t bar = smem(&full[k % kStages]);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
            smem(&ring[k % kStages][0])),
        "l"(x4 + first), "r"(bytes), "r"(bar)
        : "memory");
  };
  if (threadIdx.x == 0) {
    for (int64_t k = 0; k < kStages && k < mine; ++k) fetch(k);
  }
  for (int64_t k = 0; k < mine; ++k) {
    const int s = static_cast<int>(k % kStages);
    wait_parity(&full[s], static_cast<uint32_t>((k / kStages) & 1));
    const int64_t first = (b + k * g) * kTile;
    const int64_t count = body - first < kTile ? body - first : kTile;
    float v[8];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = threadIdx.x + r * kThreads;
      const float4 q = j < count ? ring[s][j] : make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
      v[4 * r] = q.x;
      v[4 * r + 1] = q.y;
      v[4 * r + 2] = q.z;
      v[4 * r + 3] = q.w;
    }
    fold<false>(acc, v);
    __syncthreads();  // every thread is done with stage s
    if (threadIdx.x == 0 && k + kStages < mine) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      fetch(k + kStages);
    }
  }
  finish<false>(acc, n, partials, counter, out);
}

template <int V, int kMinBlocks, bool kEven>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
probe_stream(const float* __restrict__ x, int64_t n, float4* __restrict__ partials,
             unsigned int* __restrict__ counter, float* __restrict__ out) {
  Acc acc{-INFINITY, 0.0f, 0.0f};
  int64_t head;
  const int64_t body = fold_ends<false>(acc, x, n, head);
  const float4* x4 = reinterpret_cast<const float4*>(x + head);
  int64_t start, end = body, stride;
  if (kEven) {
    const int64_t per = (body + gridDim.x - 1) / gridDim.x;
    const int64_t begin = (int64_t)blockIdx.x * per < body ? (int64_t)blockIdx.x * per : body;
    end = begin + per < body ? begin + per : body;
    start = begin + threadIdx.x;
    stride = kThreads * V;
  } else {
    start = (int64_t)blockIdx.x * (kThreads * V) + threadIdx.x;
    stride = (int64_t)gridDim.x * (kThreads * V);
  }
  for (int64_t i = start; i < end; i += stride) {
    float4 q[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int64_t j = i + (int64_t)k * kThreads;
      q[k] = j < end ? __ldg(x4 + j) : make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
    }
    float v[4 * V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      v[4 * k] = q[k].x;
      v[4 * k + 1] = q[k].y;
      v[4 * k + 2] = q[k].z;
      v[4 * k + 3] = q[k].w;
    }
    fold<false>(acc, v);
  }
  finish<false>(acc, n, partials, counter, out);
}

__device__ __forceinline__ Acc warp_merge_1pass(Acc v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    Acc o{__shfl_xor_sync(0xffffffffu, v.m, offset), __shfl_xor_sync(0xffffffffu, v.s1, offset),
          0.0f};
    v = merge<false>(v, o);
  }
  return v;
}

template <bool kOnePass>
__device__ __forceinline__ Acc block_merge_v(Acc v) {
  __shared__ Acc shared[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = kOnePass ? warp_merge_1pass(v) : warp_merge<false>(v);
  if (lane == 0) shared[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kThreads / 32 ? shared[lane] : Acc{-INFINITY, 0.0f, 0.0f};
    v = kOnePass ? warp_merge_1pass(v) : warp_merge<false>(v);
  }
  return v;
}

__device__ __forceinline__ void fence_gpu(bool acq_rel) {
  if (acq_rel) {
    asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
  } else {
    __threadfence();
  }
}

template <bool kOnePass, bool kAcqRel>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
probe_finish(const float* __restrict__ x, int64_t n, float4* __restrict__ partials,
             unsigned int* __restrict__ counter, float* __restrict__ out) {
  Acc acc{-INFINITY, 0.0f, 0.0f};
  int64_t head;
  const int64_t body = fold_ends<false>(acc, x, n, head);
  const float4* x4 = reinterpret_cast<const float4*>(x + head);
  const int64_t stride = (int64_t)gridDim.x * (kThreads * kVec);
  for (int64_t i = (int64_t)blockIdx.x * (kThreads * kVec) + threadIdx.x; i < body; i += stride) {
    float4 q[kVec];
    load_step(q, x4, i, body);
    fold_step<false>(acc, q);
  }
  acc = block_merge_v<kOnePass>(acc);
  if (gridDim.x == 1) {
    if (threadIdx.x == 0) write_result<false>(acc, n, out);
    return;
  }
  __shared__ bool is_last;
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = make_float4(acc.m, acc.s1, acc.s2, 0.0f);
    fence_gpu(kAcqRel);
    is_last = atomicAdd(counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!is_last) return;
  fence_gpu(kAcqRel);
  Acc total{-INFINITY, 0.0f, 0.0f};
  for (int j = threadIdx.x; j < (int)gridDim.x; j += kThreads) {
    const float4 p = __ldcg(partials + j);
    total = merge<false>(total, Acc{p.x, p.y, p.z});
  }
  total = block_merge_v<kOnePass>(total);
  if (threadIdx.x == 0) {
    write_result<false>(total, n, out);
    *counter = 0u;
  }
}

__global__ void probe_empty(float* out) {
  if (threadIdx.x == 0) out[0] = 0.0f;
}

}  // namespace

// variant: 0 prefetch, 1 bulk, 2 even, 3 vec8, 4 6/SM, 5 8/SM, 6 empty,
// 7 1-pass, 8 acq_rel;
// the log-sum-exp only. Otherwise the arguments of genjax_logsumexp_f32.
extern "C" int k1_probe_f32(int variant, const void* x, int64_t n, void* partials, void* counter,
                            void* out, int64_t blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float4* p = static_cast<float4*>(partials);
  unsigned int* c = static_cast<unsigned int*>(counter);
  float* o = static_cast<float*>(out);
  const unsigned grid = static_cast<unsigned>(blocks);
  switch (variant) {
    case 0: probe_prefetch<<<grid, kThreads, 0, s>>>(xf, n, p, c, o); break;
    case 1: probe_bulk<<<grid, kThreads, 0, s>>>(xf, n, p, c, o); break;
    case 2: probe_stream<4, 4, true><<<grid, kThreads, 0, s>>>(xf, n, p, c, o); break;
    case 3: probe_stream<8, 4, false><<<grid, kThreads, 0, s>>>(xf, n, p, c, o); break;
    case 4: probe_stream<4, 6, false><<<grid, kThreads, 0, s>>>(xf, n, p, c, o); break;
    case 5: probe_stream<4, 8, false><<<grid, kThreads, 0, s>>>(xf, n, p, c, o); break;
    case 7: probe_finish<true, false><<<grid, kThreads, 0, s>>>(xf, n, p, c, o); break;
    case 8: probe_finish<false, true><<<grid, kThreads, 0, s>>>(xf, n, p, c, o); break;
    default: probe_empty<<<1, 32, 0, s>>>(o);
  }
  return (int)cudaGetLastError();
}

extern "C" int k1_probe_noop(const void*, int64_t, void*, void*, void*, int64_t, int, void*) { return 0; }
