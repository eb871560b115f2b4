// Small device helpers shared by the kernels of this directory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace qeft {

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 f2bf(float v) { return __float2bfloat16(v); }

// Nibble p of a packed word as an exact float: the 4-bit code is OR-ed into
// the mantissa of 2^23 and 2^23 is subtracted again (one logic op and one add,
// no integer-to-float conversion).  The shift is unsigned, so nibble 7 of a
// negative word is read like any other.
__device__ __forceinline__ float nibble(uint32_t w, int p) {
  return __uint_as_float(((w >> (4 * p)) & 0xFu) | 0x4B000000u) - 8388608.0f;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum (or max) over a whole block of blockDim.x threads (a multiple of 32,
// at most 1024).  ``red`` holds 32 floats of shared memory; every thread
// receives the result.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  const int n_warps = blockDim.x >> 5;
  float t = lane < n_warps ? red[lane] : 0.f;
  return warp_sum(t);
}

__device__ __forceinline__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  const int n_warps = blockDim.x >> 5;
  float t = lane < n_warps ? red[lane] : -CUDART_INF_F;
  return warp_max(t);
}

// d += A * B: m16n8k16, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// mbarriers of a block's shared memory, at shared address `bar`, that
// complete when the bytes announced by mbar_expect have arrived
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// the card's SM count (0 if it cannot be queried), read once
inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 0;
  }
  return n;
}

// splits of a contraction of `units` over `tiles` column tiles: the largest
// power of two, at most `most` (a cluster's size) and `units`, that keeps the
// grid within `per_sm` blocks an SM
inline int k_splits(int tiles, int units, int most, int per_sm) {
  int s = 1;
  while (2 * s <= most && 2 * s <= units && tiles * 2 * s <= per_sm * sm_count()) s *= 2;
  return s;
}

// the launch of a (tiles, splits) grid of `threads`-thread blocks whose
// splits form one thread block cluster; `attr` holds the cluster attribute
inline cudaLaunchConfig_t split_cluster_config(int tiles, int splits, int threads,
                                               cudaStream_t st, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles, splits);
  cfg.blockDim = dim3(threads);
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 1;
  attr->val.clusterDim.y = splits;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// this thread's shared-memory accesses, ordered before later ones of the
// async proxy (wgmma, bulk copies)
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

}  // namespace qeft
