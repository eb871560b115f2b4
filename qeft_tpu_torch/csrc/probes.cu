// The four probe kernels of scripts/, for Hopper: small kernels that answer
// questions about the card rather than compute model outputs.
//
// add_one (P1) replaces scripts/entry_overhead_probe.py::_tiny_call
//   (_tiny_kernel): y = x + 1 on an f32 [8, 128] tile.  It exists to be
//   launched: chained 512 times, eagerly or inside one CUDA graph, it prices
//   one kernel entry.  Bound: 8 KB in and out, 2.4 ns at 3.35 TB/s -- the
//   launch itself is the whole cost, which is what the probe measures.
//   Design: one thread per element, four blocks of 256.
//
// dma_only, unpack_only (P2) replace scripts/dma_probe.py::dma_only
//   (dma_kernel) and ::unpack_only (unpack_kernel): per-column sums over all
//   K/8 rows of an int32 [K/8, N] word matrix, broadcast to f32 [8, N].
//   dma_only sums the words themselves in int32 (wrapping, as jnp.sum of
//   int32) and casts the total to f32; unpack_only sums the 8 nibble planes
//   (w >> 4p) & 0xF of every word, an integer below 2^24 (exact in f32).
//   Bound: the K/2 * N bytes of words over 3.35 TB/s (6.7 us at [1376,
//   4096]); unpack_only adds the extraction, mostly integer instructions.
//   dma_only, the register-stream reference: a block covers 128 columns (a
//   lane reads 4 with one 16-byte load) and a slice of the rows
//   (blockIdx.y), so about four blocks per SM stream at once; 8 warps split
//   the slice, each keeping four loads in flight.
//   unpack_only takes its words through the bulk-copy ring of dma_tile
//   below (RowRing, common.cuh), a column tile of bn words (the widest
//   multiple of 4 up to 512 that divides N) and a split of its rows a
//   block, one block of 8 consumer warps an SM, 16 KB stages in a 64 KB
//   ring.  Two consumer lanes own each 4 columns (one 16-byte shared load a
//   row), one the even rows of a stage and one the odd, and form each
//   word's 4 nibble pairs as the decode matvec forms its A registers
//   (nibble_pair: one shift and one mask a pair, planes q and q + 4 in two
//   16-bit lanes), summed into one lane accumulator per column: a lane
//   gains at most 4 x 15 a word, so the lanes are widened into a 32-bit
//   total before they pass kLaneRows word rows.  Integer sums throughout,
//   so the result is exact in any order.  Its hot loop takes about 9.7
//   instructions a word, 9 of them integer logic, shift and add.
//   Both meet across blocks the same way (dma_only's 8 warps, unpack_only's
//   two row halves first in shared memory): each block adds its partial
//   column sums to a word-per-column workspace with atomics (integer sums,
//   so the order does not matter), and the last block of a column tile --
//   counted by a ticket per tile -- writes the 8 output rows and zeroes the
//   workspace and its ticket for the next launch.
//
// dma_tile (P3) replaces scripts/dma_probe2.py::make(bn).f (kern): out =
//   float(qw[:8, :]) + s, where the TPU's BlockSpec moves the whole
//   [K/8, bn] block of words into VMEM for every grid step although only 8
//   rows are used.  Here every byte of the tile likewise passes through
//   shared memory.  Bound: the K/2 * N bytes of words (plus s and out), as
//   P2.  Design: a ring of bulk asynchronous copies (RowRing, common.cuh):
//   one elected producer thread a block issues one cp.async.bulk a word row
//   (bn x 4 bytes) into stages of 32 KB, one full and one empty mbarrier a
//   stage; 4 consumer warps wait on the mbarriers only, and the blocks
//   holding rows 0..7 add s and write the output from the ring.  The plan
//   (probes/common.py:stream_plan) sizes the grid from the SM count --
//   three blocks an SM, each a column tile of bn words and an equal split
//   of its rows -- and the ring at 64 KB a block, so the bytes in flight an
//   SM (192 KB, against the ~24 KB that 3 TB/s x 1 us over 132 SMs asks
//   for) and the blocks an SM holds do not depend on bn: bn stays the
//   column width of the tile a block walks.  Stages, blocks an SM and ring
//   were chosen by a sweep on the H100 (`probes/ring_sweep.py`, PERF.md §6).

// gemv_ablation<V> (P4) replaces scripts/gemv_ablation_probe.py::build
//   (make_kernel): x bf16 [8, K] in plane order (column p*K/8 + w meets
//   nibble plane p of word row w), words int32 [K/8, N], scales f32
//   [K/g, N] tiled over the word rows as pltpu.repeat tiles them (word row w
//   takes scale row w mod K/g), out bf16 [8, N].  The variants cut the
//   dequantization work at constant bytes: V0 full (plane f32 * scale ->
//   bf16, bf16 products summed in f32), V1 no scale, V2 / V3 the first 4 / 2
//   planes, V4 no dequantization (the column sums of the words plus
//   x[:, :bn], the same bn columns for every N tile as the script has it),
//   V5 mask without shift, V6 f32 weights, V7 / V8 the telescoped extraction
//   (16- or 8-bit fields shifted down 4 bits a plane against activation
//   differences x_p - 16 x_{p-1}).  Bound: K/2 * N bytes of words plus the
//   scales, 7.1 us at 11008 -> 4096; the 2*8*K*N operations are a tenth of
//   that at the bf16 tensor rate.  Design: the work split as the script
//   splits it between the TPU's units -- the dequantization on the CUDA
//   cores, the dot on the tensor cores -- in the block structure of the
//   port's decode matvec (csrc/qmm.cu, qgemv_mma_kernel), so the probe asks
//   its question of that design.  A block of 8 warps covers 256 columns and
//   a split of the word rows in units of 8; lane (gid, t) owns 4 columns
//   (one 16-byte load of words and one of scales per word row) and word
//   rows 8u + t and 8u + 4 + t of each unit, whose words and scales it loads
//   one unit ahead into registers.  The bf16 variants (V0, V1, V2, V3, V5)
//   build each weight as the variant defines it on the CUDA cores and pair
//   planes (q, q + planes/2) of one word into an mma.sync m16n8k16 A
//   register (16 columns x 16 K rows), the 8 activation rows as B, staged
//   once per block in MMA order, f32 accumulators: bf16 products summed in
//   f32, the variant's own arithmetic.  V6, V7 and V8 multiply f32 weights
//   by f32 activations and stay f32 FMAs on the CUDA cores (activations
//   staged as f32, telescoped for V7 / V8): TF32 rounds a 16-bit field times
//   its scale to 2^-11, which the telescoped sums do not cancel, and a
//   split-precision (3 x TF32) product spends three MMAs and the splitting
//   of both operands per value -- more CUDA-core work than the f32 FMAs it
//   would replace at 8 rows.  V4 sums the words as f32.  The splits (one
//   thread block cluster) are summed in rank order through the cluster's
//   distributed shared memory, as in the decode matvec: no atomics, no
//   workspace, and two calls on the same inputs are bit-identical.  Unlike
//   the decode matvec a cluster takes up to 16 splits (a non-portable size,
//   where the card places it): the dequantization's longer dependent chains
//   want the 16 warps an SM that 16 splits give at 11008 -> 4096 (8 at 8
//   splits).

#include <cooperative_groups.h>

#include "common.cuh"

using namespace qeft;

namespace {

// ------------------------------------------------------------------ P1

__global__ void add_one_kernel(const float* __restrict__ x, float* __restrict__ y, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = x[i] + 1.f;
}

// ------------------------------------------------------- shared: tickets

constexpr int kThreads = 256;  // 8 warps
constexpr int kTileCols = 128;  // columns a block covers: 32 lanes x 4

// After a block has added its partials to the workspace: true in the one
// block of this column tile that arrives last (it then reads the totals).
__device__ __forceinline__ bool last_of_tile(unsigned int* tickets, bool* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *flag = atomicAdd(&tickets[blockIdx.x], 1u) == gridDim.y - 1;
  __syncthreads();
  return *flag;
}

// ------------------------------------------------------------------ P2

__global__ void __launch_bounds__(kThreads)
colsum_kernel(const int4* __restrict__ qw, float* __restrict__ out, uint32_t* __restrict__ ws,
              unsigned int* __restrict__ tickets, int K8, int N, int rows_per_block) {
  __shared__ uint32_t red[8][kTileCols];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = blockIdx.x * kTileCols + lane * 4;
  const int r0 = blockIdx.y * rows_per_block, r1 = min(r0 + rows_per_block, K8);
  const int n4 = N / 4;
  uint32_t su[4] = {0u, 0u, 0u, 0u};
  auto take = [&](int4 v) {
    su[0] += (uint32_t)v.x;
    su[1] += (uint32_t)v.y;
    su[2] += (uint32_t)v.z;
    su[3] += (uint32_t)v.w;
  };
  if (c0 < N) {
    const int4* col = qw + c0 / 4;
    int r = r0 + warp;
    for (; r + 24 < r1; r += 32) {  // four rows' loads in flight
      int4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = __ldg(col + (size_t)(r + 8 * u) * n4);
#pragma unroll
      for (int u = 0; u < 4; ++u) take(v[u]);
    }
    for (; r < r1; r += 8) take(__ldg(col + (size_t)r * n4));
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) red[warp][lane * 4 + j] = su[j];
  __syncthreads();
  const int c = blockIdx.x * kTileCols + threadIdx.x;
  if (threadIdx.x < kTileCols && c < N) {
    uint32_t t = 0u;
    for (int wp = 0; wp < 8; ++wp) t += red[wp][threadIdx.x];
    atomicAdd(ws + c, t);
  }
  if (!last_of_tile(tickets, &last)) return;
  if (threadIdx.x < kTileCols && c < N) {
    const uint32_t t = atomicExch(ws + c, 0u);  // the total, and the workspace zeroed
#pragma unroll
    for (int m = 0; m < 8; ++m) out[(size_t)m * N + c] = (float)(int32_t)t;
  }
  if (threadIdx.x == 0) tickets[blockIdx.x] = 0u;
}

// ------------------------------------------------- P2 and P3: the ring

constexpr int kR_STAGE_BYTES_MAX = (1 << 20) - 1;  // an mbarrier phase's byte count
// consumer warps a block (warp 0 produces): dma_tile's only copy rows 0..7
// out; unpack_only's extract nibbles, two warps a column quad (each taking
// every other row of a stage), so that an SM has enough warps to hide the
// extraction's latencies
constexpr int kT_CONSUMERS = 4, kU_CONSUMERS = 8;
constexpr int kU_QUADS = 16 * kU_CONSUMERS;  // column quads: 128, the widest tile 512 words
// word rows a lane accumulator takes before it is widened: each of its two
// 16-bit lanes gains at most 4 x 15 a word (65535 / 60)
constexpr int kLaneRows = 1092;

// block (blockIdx.x, blockIdx.y): column tile blockIdx.x of bn words, rows
// [r0, r1) of split blockIdx.y; its ring in the dynamic shared memory
__device__ __forceinline__ RowRing block_ring(const int32_t* qw, int K8, int N, int bn,
                                              int rows_per_block, int stage_rows, int stages,
                                              int consumers, unsigned char* smem, int* r0) {
  *r0 = blockIdx.y * rows_per_block;
  RowRing ring;
  ring.src = reinterpret_cast<const unsigned char*>(qw + (size_t)*r0 * N + (size_t)blockIdx.x * bn);
  ring.ld = (size_t)N * 4;
  ring.rows = min(rows_per_block, K8 - *r0);
  ring.row_bytes = bn * 4;
  ring.stage_rows = stage_rows;
  ring.stages = stages;
  ring.consumers = consumers;
  ring.slots = smem;
  return ring;
}

__global__ void __launch_bounds__(32 * (1 + kU_CONSUMERS))
unpack_ring_kernel(const int32_t* __restrict__ qw, float* __restrict__ out,
                   uint32_t* __restrict__ ws, unsigned int* __restrict__ tickets, int K8, int N,
                   int bn, int rows_per_block, int stage_rows, int stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint32_t red[4][kU_QUADS];  // the odd rows' totals
  __shared__ bool last;
  int r0;
  const RowRing ring = block_ring(qw, K8, N, bn, rows_per_block, stage_rows, stages,
                                  kU_CONSUMERS, smem, &r0);
  const int warp = threadIdx.x >> 5, t = threadIdx.x - 32;
  const int quad = t % kU_QUADS, half = t / kU_QUADS;  // columns 4 quad .., rows half, half + 2, ..
  const bool owns = warp > 0 && 4 * quad < bn;
  if (threadIdx.x == 0) ring.init();
  __syncthreads();
  uint32_t total[4] = {0u, 0u, 0u, 0u};
  if (warp == 0) {
    if (threadIdx.x == 0) ring.produce();
    __syncwarp();
  } else {
    uint32_t lanes[4] = {0u, 0u, 0u, 0u};  // nibbles 0-3 low, 4-7 high, of each column
    auto widen = [&]() {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        total[j] += (lanes[j] & 0xFFFFu) + (lanes[j] >> 16);
        lanes[j] = 0u;
      }
    };
    int held = 0;  // word rows of the stages in the lane accumulators
    ring.consume([&](int slot, int, int n) {
      if (held + n > kLaneRows) {
        widen();
        held = 0;
      }
      held += n;
      if (!owns) return;
      const uint32_t row = smem_u32(ring.slot(slot)) + 16 * quad;
#pragma unroll 4
      for (int i = half; i < n; i += 2) {
        const uint4 v = lds128(row + i * ring.row_bytes);
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
          lanes[j] += (nibble_pair(w[j], 0) + nibble_pair(w[j], 1)) +
                      (nibble_pair(w[j], 2) + nibble_pair(w[j], 3));
      }
    });
    widen();
    if (owns && half == 1) {
#pragma unroll
      for (int j = 0; j < 4; ++j) red[j][quad] = total[j];
    }
  }
  __syncthreads();
  if (owns && half == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) atomicAdd(ws + blockIdx.x * bn + 4 * quad + j, total[j] + red[j][quad]);
  }
  if (!last_of_tile(tickets, &last)) return;
  if (owns && half == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = blockIdx.x * bn + 4 * quad + j;
      const float v = (float)atomicExch(ws + c, 0u);  // the total, and the workspace zeroed
#pragma unroll
      for (int m = 0; m < 8; ++m) out[(size_t)m * N + c] = v;
    }
  }
  if (threadIdx.x == 0) tickets[blockIdx.x] = 0u;
}

__global__ void __launch_bounds__(32 * (1 + kT_CONSUMERS))
dma_tile_kernel(const int32_t* __restrict__ qw, const float* __restrict__ s,
                float* __restrict__ out, int K8, int N, int bn, int rows_per_block,
                int stage_rows, int stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  int r0;
  const RowRing ring = block_ring(qw, K8, N, bn, rows_per_block, stage_rows, stages,
                                  kT_CONSUMERS, smem, &r0);
  const int col0 = blockIdx.x * bn;
  if (threadIdx.x == 0) ring.init();
  __syncthreads();
  if (threadIdx.x < 32) {  // the producer warp: one thread issues, the rest have no part
    if (threadIdx.x == 0) ring.produce();
    return;
  }
  const int t = threadIdx.x - 32;
  ring.consume([&](int slot, int r, int n) {
    const int32_t* words = reinterpret_cast<const int32_t*>(ring.slot(slot));
    for (int i = 0; i < n && r0 + r + i < 8; ++i) {  // output rows: s added, written
      const size_t o = (size_t)(r0 + r + i) * N + col0;
      for (int c = t; c < bn; c += 32 * kT_CONSUMERS)
        out[o + c] = (float)words[(size_t)i * bn + c] + s[o + c];
    }
  });
}

constexpr int kMaxDevices = 64;

// the kernel's dynamic shared memory on the current device, raised past its
// default where the ring needs it; refused where it and the kernel's static
// shared memory exceed what a block may opt in to.  opted[device]: the
// largest the kernel was given there
template <class Kernel>
cudaError_t ring_smem(Kernel kernel, int bytes, int (&opted)[kMaxDevices]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (bytes <= opted[dev]) return cudaSuccess;
  cudaFuncAttributes attr;
  int optin = 0;
  if ((e = cudaFuncGetAttributes(&attr, kernel)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
          cudaSuccess)
    return e;
  if (bytes + (long)attr.sharedSizeBytes > optin) return cudaErrorInvalidValue;
  if (bytes > attr.maxDynamicSharedSizeBytes &&
      (e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)) !=
          cudaSuccess)
    return e;
  opted[dev] = bytes;
  return cudaSuccess;
}

// the plan's arguments as the ring takes them (probes/common.py:stream_plan
// makes them): bn | N, 4 | bn, whole stages within an mbarrier's byte count
// and the ring within a block's shared memory
bool ring_plan_ok(int K8, int N, int bn, int rows_per_block, int stage_rows, int stages) {
  return K8 >= 1 && bn >= 4 && bn % 4 == 0 && N % bn == 0 && rows_per_block >= 1 &&
         stage_rows >= 1 && stages >= 1 && (long)stage_rows * bn * 4 <= kR_STAGE_BYTES_MAX &&
         (long)stages * stage_rows * bn * 4 + 16L * stages <= 232448;
}

// ------------------------------------------------------------------ P4

enum Variant { kFull = 0, kNoScale, k4Plane, k2Plane, kDma, kNoShift, kF32Dot, kTele16, kTele8 };

__host__ __device__ constexpr int planes_of(int V) { return V == k4Plane ? 4 : V == k2Plane ? 2 : 8; }
// the variants whose dot runs on the tensor cores (bf16 weights); the f32
// ones run as FMAs on the CUDA cores, v4_dma has no dot
__host__ __device__ constexpr bool on_mma(int V) { return V <= k2Plane || V == kNoShift; }

// the telescoped variants: a plane that starts a field (level 0) takes x_p
// as it is, the others x_p - 16 x_{p-1}
template <int V>
__device__ __forceinline__ bool starts_field(int p) {
  return V == kTele16 ? (p & 3) == 0 : V == kTele8 ? (p & 1) == 0 : true;
}

// A block is 8 warps over kA_BN columns and a split of the units (8 word
// rows each) -- blockIdx.y, one block of a cluster of the splits.  Lane
// (gid, t) of warp w owns columns 4 gid .. 4 gid + 3 of the warp's 32 and
// word rows 8u + t and 8u + 4 + t of every unit u of the split.
constexpr int kA_BN = 256;
constexpr int kA_CHUNK = 16;        // units of activations staged at once
constexpr int kA_ROW_F32 = 64 + 4;  // staged f32 floats of a word row (8 planes x 8 tokens), padded
constexpr int kA_MAX_SPLITS = 16;  // a non-portable cluster size, where the card places one

// the bf16 weight pair i of a word for the MMA variants: planes (i, i +
// planes/2) of one column, each (plane as f32) * scale rounded to bf16 (v1:
// the plane itself; v5: every plane is the low nibble).  2^23 + code is the
// code OR-ed into the mantissa of 2^23, and fma(2^23 + code, s, -2^23 s)
// rounds the exact code * s once: the plain version's f32 product.
template <int V>
__device__ __forceinline__ uint32_t weight_pair(uint32_t w, float s, float zs, int i) {
  auto deq = [&](int p) {
    const float f = __uint_as_float(((V == kNoShift ? w : w >> (4 * p)) & 0xFu) | 0x4B000000u);
    return V == kNoScale ? f - 8388608.f : fmaf(f, s, zs);
  };
  const bf162 r = __floats2bfloat162_rn(deq(i), deq(i + planes_of(V) / 2));
  return *reinterpret_cast<const uint32_t*>(&r);
}

template <int V>
__global__ void __launch_bounds__(kThreads, 2)
gemv_ablation_kernel(const bf16* __restrict__ x, const uint4* __restrict__ qw,
                     const float4* __restrict__ s, bf16* __restrict__ out, int K8, int N, int G,
                     int bn) {
  constexpr int PLANES = planes_of(V), HALF = PLANES / 2;
  constexpr int CP = PLANES >= 4 ? 4 : 2, H = PLANES / CP;  // pairs of a staged vector, vectors
  constexpr bool SCALED = V != kNoScale && V != kDma;
  constexpr int XS_BYTES = on_mma(V)   ? kA_CHUNK * 8 * 4 * PLANES * 4
                           : V == kDma ? 16
                                       : kA_CHUNK * 8 * kA_ROW_F32 * 4;
  // MMA variants: [unit][vector h][token][lane t] of CP bf16 pairs, the
  // lane's pairs in its order (word row 8u + t's pairs 0..HALF-1, then
  // word row 8u + 4 + t's); f32 variants: [unit][word row][plane][token]
  __shared__ __align__(16) unsigned char xs[XS_BYTES];
  __shared__ __align__(16) float red[8 * kA_BN];  // [token][column]
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, t = lane & 3;
  const int K = K8 * 8, U = K8 / 8, n4 = N / 4;
  const int S = gridDim.y, rank = blockIdx.y;
  const int u0 = rank * U / S, u1 = (rank + 1) * U / S;  // this split's units
  const int c4 = (blockIdx.x * kA_BN + warp * 32 + 4 * gid) / 4;  // this lane's column quad
  const bool col_ok = c4 < n4;

  // the words and scales of unit u: word rows 8u + t and 8u + 4 + t
  auto load = [&](int u, uint4 (&q)[2], float4 (&sc)[2]) {
    const bool ok = col_ok && u < u1;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int w = 8 * u + 4 * h + t;
      q[h] = ok ? __ldcs(qw + (size_t)w * n4 + c4) : make_uint4(0u, 0u, 0u, 0u);
      sc[h] = ok && SCALED ? __ldg(s + (size_t)(w % G) * n4 + c4) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };

  // the staged activations of the chunk's units c0 .. c1 - 1
  auto stage = [&](int c0, int c1) {
    if constexpr (on_mma(V)) {
      uint32_t* xp = reinterpret_cast<uint32_t*>(xs);
      for (int idx = tid; idx < (c1 - c0) * 8 * HALF; idx += kThreads) {
        const int u = idx / (8 * HALF), m = (idx / HALF) & 7, q = idx % HALF;
        const bf16* xr = x + (size_t)m * K + 8 * (c0 + u);
        const uint4 lo = __ldg(reinterpret_cast<const uint4*>(xr + (size_t)q * K8));
        const uint4 hi = __ldg(reinterpret_cast<const uint4*>(xr + (size_t)(q + HALF) * K8));
        const uint32_t l[4] = {lo.x, lo.y, lo.z, lo.w}, hv[4] = {hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int r = 0; r < 8; ++r) {  // word row 8u + r: lane r % 4, its pair q or HALF + q
          const int i = r < 4 ? q : HALF + q;
          xp[(((u * H + i / CP) * 8 + m) * 4 + (r & 3)) * CP + i % CP] =
              __byte_perm(l[r >> 1], hv[r >> 1], (r & 1) ? 0x7632 : 0x5410);
        }
      }
    } else if constexpr (V != kDma) {
      float* xf = reinterpret_cast<float*>(xs);
      for (int idx = tid; idx < (c1 - c0) * 512; idx += kThreads) {
        const int r = idx & 7, m = (idx >> 3) & 7, p = (idx >> 6) & 7, u = idx >> 9;
        const size_t o = (size_t)m * K + (size_t)p * K8 + 8 * (c0 + u) + r;
        float v = bf2f(x[o]);
        if (!starts_field<V>(p)) v -= 16.f * bf2f(x[o - K8]);
        xf[(u * 8 + r) * kA_ROW_F32 + p * 8 + m] = v;
      }
    }
  };

  float acc[8][4];  // MMA: [tile j][i] in acc[j] (column 4 gid + 2j + i/2, token 2t + i%2);
                    // f32: [token][column]; v4_dma: acc[0][column]
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;

  // one unit (cu: its index in the staged chunk)
  auto compute = [&](int cu, const uint4 (&q)[2], const float4 (&sc)[2]) {
    if constexpr (on_mma(V)) {
      uint32_t b[PLANES];  // B registers of token gid, lane t, in the lane's pair order
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const int at = ((cu * H + h) * 8 + gid) * 4 + t;
        if constexpr (CP == 4) {
          const uint4 v = reinterpret_cast<const uint4*>(xs)[at];
          b[4 * h] = v.x, b[4 * h + 1] = v.y, b[4 * h + 2] = v.z, b[4 * h + 3] = v.w;
        } else {
          const uint2 v = reinterpret_cast<const uint2*>(xs)[at];
          b[0] = v.x, b[1] = v.y;
        }
      }
      const uint32_t w[2][4] = {{q[0].x, q[0].y, q[0].z, q[0].w}, {q[1].x, q[1].y, q[1].z, q[1].w}};
      const float sv[2][4] = {{sc[0].x, sc[0].y, sc[0].z, sc[0].w},
                              {sc[1].x, sc[1].y, sc[1].z, sc[1].w}};
      // A register of column c, lane pair i: pair i of word row 8u + t, or
      // pair i - HALF of word row 8u + 4 + t
      auto a = [&](int c, int i) {
        const int h = i < HALF ? 0 : 1;
        return weight_pair<V>(w[h][c], sv[h][c], -8388608.f * sv[h][c], i - h * HALF);
      };
#pragma unroll
      for (int st = 0; st < HALF; ++st)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          mma_bf16(acc[j], a(2 * j, 2 * st), a(2 * j + 1, 2 * st),
                   a(2 * j, 2 * st + 1), a(2 * j + 1, 2 * st + 1), b[2 * st], b[2 * st + 1]);
    } else if constexpr (V == kDma) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        acc[0][0] += (float)(int32_t)q[h].x;
        acc[0][1] += (float)(int32_t)q[h].y;
        acc[0][2] += (float)(int32_t)q[h].z;
        acc[0][3] += (float)(int32_t)q[h].w;
      }
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t qv[4] = {q[h].x, q[h].y, q[h].z, q[h].w};
        const float sv[4] = {sc[h].x, sc[h].y, sc[h].z, sc[h].w};
        const float4* xw = reinterpret_cast<const float4*>(
            reinterpret_cast<const float*>(xs) + (cu * 8 + 4 * h + t) * kA_ROW_F32);
        uint32_t cur[4];
#pragma unroll
        for (int p = 0; p < 8; ++p) {
          float wt[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            uint32_t code;
            if constexpr (V == kTele16) {
              if ((p & 3) == 0) cur[j] = p == 0 ? (qv[j] & 0xFFFFu) : (qv[j] >> 16);
              else cur[j] >>= 4;
              code = cur[j];
            } else if constexpr (V == kTele8) {
              if ((p & 1) == 0) cur[j] = p == 6 ? (qv[j] >> 24) : ((qv[j] >> (4 * p)) & 0xFFu);
              else cur[j] >>= 4;
              code = cur[j];
            } else {
              code = (qv[j] >> (4 * p)) & 0xFu;
            }
            wt[j] = (float)code * sv[j];
          }
          const float4 xa = xw[2 * p], xb = xw[2 * p + 1];
          const float xm[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
          for (int m = 0; m < 8; ++m)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[m][j] = fmaf(xm[m], wt[j], acc[m][j]);
        }
      }
    }
  };

  uint4 q[2], q_next[2];
  float4 sc[2], sc_next[2];
  int u = u0;
  load(u, q, sc);
  for (int c0 = u0; c0 < u1; c0 += kA_CHUNK) {
    const int c1 = min(u1, c0 + kA_CHUNK);
    if (c0 > u0) __syncthreads();  // the previous chunk is consumed
    stage(c0, c1);
    __syncthreads();
    for (; u < c1; ++u) {  // the next unit's words and scales in flight
      load(u + 1, q_next, sc_next);
      compute(u - c0, q, sc);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        q[h] = q_next[h];
        sc[h] = sc_next[h];
      }
    }
  }

  // this block's partial tile into red [token][column]: the f32 and v4_dma
  // lanes first sum their quad's word rows (lanes t, fixed order)
  const int cl = warp * 32 + 4 * gid;
  constexpr int ROWS_OUT = V == kDma ? 1 : 8;
  if constexpr (on_mma(V)) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) red[(2 * t + (i & 1)) * kA_BN + cl + 2 * j + (i >> 1)] = acc[j][i];
  } else {
#pragma unroll
    for (int m = 0; m < ROWS_OUT; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float v = acc[m][j];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (ROWS_OUT == 1 ? t == 0 : (m >> 1) == t) red[m * kA_BN + cl + j] = v;
      }
  }
  // the splits' partial tiles, summed in rank order through the cluster's
  // shared memory; each block writes its share of the tile in bf16
  cluster.sync();
  const int per = (ROWS_OUT * kA_BN + S - 1) / S, end = min(ROWS_OUT * kA_BN, (rank + 1) * per);
  for (int idx = rank * per + tid; idx < end; idx += kThreads) {
    const int m = idx / kA_BN, nn = blockIdx.x * kA_BN + idx % kA_BN;
    if (nn >= N) continue;
    float y = 0.f;
    for (int r = 0; r < S; ++r) y += cluster.map_shared_rank(red, r)[idx];
    if constexpr (V == kDma) {
#pragma unroll
      for (int mm = 0; mm < 8; ++mm)
        out[(size_t)mm * N + nn] = f2bf(y + bf2f(x[(size_t)mm * K + nn % bn]));
    } else {
      out[(size_t)m * N + nn] = f2bf(y);
    }
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

template <int V>
cudaError_t launch_ablation(const bf16* x, const uint4* qw, const float4* s, bf16* out, int K8,
                            int N, int G, int bn, cudaStream_t st) {
  // the most splits a cluster may have: 16 where the card places a cluster
  // of 16 such blocks, else the portable 8 (once per variant)
  static int most = 0;
  if (most == 0) {
    cudaError_t e = cudaFuncSetAttribute(gemv_ablation_kernel<V>,
                                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    cudaLaunchAttribute a;
    const cudaLaunchConfig_t probe = split_cluster_config(1, kA_MAX_SPLITS, kThreads, st, &a);
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, gemv_ablation_kernel<V>, &probe);
    if (e != cudaSuccess) return e;
    most = clusters > 0 ? kA_MAX_SPLITS : 8;
  }
  // at most two blocks an SM.  The dequantization's dependent chains want
  // more warps an SM than the decode matvec's: 16 splits at 11008 -> 4096,
  // where 16 column tiles give 8 warps an SM at 8
  const int tiles = (N + kA_BN - 1) / kA_BN;
  const int splits = k_splits(tiles, K8 / 8, most, 2);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = split_cluster_config(tiles, splits, kThreads, st, &attr);
  cudaError_t e = cudaLaunchKernelEx(&cfg, gemv_ablation_kernel<V>, x, qw, s, out, K8, N, G, bn);
  return e != cudaSuccess ? e : cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

extern "C" int add_one(const void* x, void* y, int n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  add_one_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), n);
  return (int)cudaGetLastError();
}

// ws: N zeroed words, tickets: one zeroed counter a column tile; both are
// left zeroed
extern "C" int dma_only(const void* qw, void* out, void* ws, void* tickets, int K8, int N,
                        int rows_per_block, void* stream) {
  if (K8 < 1 || N < 4 || N % 4 || rows_per_block < 1 || !aligned16(qw))
    return (int)cudaErrorInvalidValue;
  dim3 grid((N + kTileCols - 1) / kTileCols, (K8 + rows_per_block - 1) / rows_per_block);
  colsum_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(qw), static_cast<float*>(out), static_cast<uint32_t*>(ws),
      static_cast<unsigned int*>(tickets), K8, N, rows_per_block);
  return (int)cudaGetLastError();
}

extern "C" int unpack_only(const void* qw, void* out, void* ws, void* tickets, int K8, int N,
                           int bn, int rows_per_block, int stage_rows, int stages,
                           void* stream) {
  static int opted[kMaxDevices] = {};
  if (!ring_plan_ok(K8, N, bn, rows_per_block, stage_rows, stages) || bn > 4 * kU_QUADS ||
      stage_rows > kLaneRows || !aligned16(qw))
    return (int)cudaErrorInvalidValue;
  const int smem = RowRing::smem_bytes(bn * 4, stage_rows, stages);
  const cudaError_t e = ring_smem(unpack_ring_kernel, smem, opted);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(N / bn, (K8 + rows_per_block - 1) / rows_per_block);
  unpack_ring_kernel<<<grid, 32 * (1 + kU_CONSUMERS), smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(qw), static_cast<float*>(out), static_cast<uint32_t*>(ws),
      static_cast<unsigned int*>(tickets), K8, N, bn, rows_per_block, stage_rows, stages);
  return (int)cudaGetLastError();
}

extern "C" int dma_tile(const void* qw, const void* s, void* out, int K8, int N, int bn,
                        int rows_per_block, int stage_rows, int stages, void* stream) {
  static int opted[kMaxDevices] = {};
  if (K8 < 8 || !ring_plan_ok(K8, N, bn, rows_per_block, stage_rows, stages) || !aligned16(qw))
    return (int)cudaErrorInvalidValue;
  const int smem = RowRing::smem_bytes(bn * 4, stage_rows, stages);
  const cudaError_t e = ring_smem(dma_tile_kernel, smem, opted);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(N / bn, (K8 + rows_per_block - 1) / rows_per_block);
  dma_tile_kernel<<<grid, 32 * (1 + kT_CONSUMERS), smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(qw), static_cast<const float*>(s), static_cast<float*>(out),
      K8, N, bn, rows_per_block, stage_rows, stages);
  return (int)cudaGetLastError();
}

// G = K / g scale rows; bn: the N tile of the V4 variant.  K/8 must be a
// multiple of 8 (units of 8 word rows, 16-byte activation loads).
extern "C" int gemv_ablation(const void* x, const void* qw, const void* s, void* out, int K8,
                             int N, int G, int bn, int variant, void* stream) {
  if (K8 < 8 || K8 % 8 || N < 4 || N % 4 || G < 1 || K8 % G || bn < 1 || bn > K8 * 8 ||
      !aligned16(x) || !aligned16(qw) || !aligned16(s))
    return (int)cudaErrorInvalidValue;
  const bf16* xx = static_cast<const bf16*>(x);
  const uint4* q = static_cast<const uint4*>(qw);
  const float4* ss = static_cast<const float4*>(s);
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define QEFT_CASE(VV) \
  case VV:            \
    return (int)launch_ablation<VV>(xx, q, ss, o, K8, N, G, bn, st);
  switch (variant) {
    QEFT_CASE(kFull) QEFT_CASE(kNoScale) QEFT_CASE(k4Plane) QEFT_CASE(k2Plane) QEFT_CASE(kDma)
    QEFT_CASE(kNoShift) QEFT_CASE(kF32Dot) QEFT_CASE(kTele16) QEFT_CASE(kTele8)
  }
#undef QEFT_CASE
  return (int)cudaErrorInvalidValue;
}
