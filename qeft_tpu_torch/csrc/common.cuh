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

// four 8x8 bf16 matrices from shared memory, one row address a lane (lanes
// 8i..8i+7: matrix i); .trans gives each the transposed fragment
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// two floats as a bf16 pair, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const bf162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
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

// one arrival on mbarrier `bar` (no bytes announced)
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// one bulk asynchronous copy of `bytes` (a multiple of 16) from global
// `src` to shared `dst`, both 16-byte aligned, completing on mbarrier `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// 16 bytes of shared memory at shared address `addr` (16-byte aligned)
__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

// nibble pair q (0..3) of a packed word in two 16-bit lanes: nibble q in the
// low lane, nibble q + 4 in the high one (one shift, one mask)
__device__ __forceinline__ uint32_t nibble_pair(uint32_t w, int q) {
  return (w >> (4 * q)) & 0x000F000Fu;
}

// A ring of word rows in shared memory fed by bulk asynchronous copies (the
// probes of csrc/probes.cu).  A block walks `rows` rows of a column tile
// (`row_bytes` each, a multiple of 16, `ld` bytes apart in global memory)
// in stages of `stage_rows` rows; stage k sits in slot k % stages.  One
// thread produces: it issues one bulk copy a row, the stage's bytes
// announced on the slot's full barrier, and reuses a slot once its empty
// barrier says that the `consumers` warps have released it.  A consumer
// warp waits on the full barrier, reads, and releases the slot: nothing but
// the mbarriers orders the two sides.  Both sides step their slot and its
// phase parity along: no integer division a stage, which costs hundreds of
// cycles on each side's serial walk.  Shared memory: the slots from a
// 16-byte aligned base, then 2 x stages mbarriers (full, then empty).
struct RowRing {
  const unsigned char* src;  // the tile's first row in global memory
  size_t ld;
  int rows, row_bytes, stage_rows, stages, consumers;
  unsigned char* slots;

  __host__ __device__ static int smem_bytes(int row_bytes, int stage_rows, int stages) {
    return stages * stage_rows * row_bytes + 16 * stages;
  }
  __device__ int stage_bytes() const { return stage_rows * row_bytes; }
  __device__ unsigned char* slot(int s) const { return slots + s * stage_bytes(); }
  __device__ uint32_t full(int s) const {
    return smem_u32(slots) + stages * stage_bytes() + 8 * s;
  }
  __device__ uint32_t empty(int s) const { return full(s) + 8 * stages; }

  // one thread, then a block-wide barrier before any other use
  __device__ void init() const {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), consumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // the producer thread: every stage in order; slot s's use u has parity
  // `phase`, and its use u - 1 must have been released first
  __device__ void produce() const {
    const uint32_t base = smem_u32(slots), bars = base + stages * stage_bytes();
    int s = 0;
    uint32_t phase = 0;
    for (int r = 0, k = 0; r < rows; r += stage_rows, ++k) {
      if (k >= stages) mbar_wait(bars + 8 * (stages + s), phase ^ 1u);
      const int n = min(stage_rows, rows - r);
      const uint32_t bar = bars + 8 * s, dst = base + s * stage_bytes();
      mbar_expect(bar, n * row_bytes);
      for (int i = 0; i < n; ++i)
        bulk_load(dst + i * row_bytes, src + (size_t)(r + i) * ld, row_bytes, bar);
      if (++s == stages) s = 0, phase ^= 1u;
    }
  }

  // a consumer warp: use(slot, first row of the stage, its rows) once the
  // stage has landed, for every stage in order (so every copy has completed
  // when this returns), each slot released after its use
  template <class Use>
  __device__ void consume(Use use) const {
    const uint32_t bars = smem_u32(slots) + stages * stage_bytes();
    int s = 0;
    uint32_t phase = 0;
    for (int r = 0; r < rows; r += stage_rows) {
      mbar_wait(bars + 8 * s, phase);
      use(s, r, min(stage_rows, rows - r));
      __syncwarp();
      if ((threadIdx.x & 31) == 0) mbar_arrive(bars + 8 * (stages + s));
      if (++s == stages) s = 0, phase ^= 1u;
    }
  }
};

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
