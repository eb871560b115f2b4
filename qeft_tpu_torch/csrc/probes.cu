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
//   (w >> 4p) & 0xF of every word, whose total (< 2^24) is exact in f32 in
//   any order.  Bound: the K/2 * N bytes of words over 3.35 TB/s (6.7 us at
//   [1376, 4096]); unpack_only adds 8 extractions and adds a word.
//   Design: a block covers 128 columns (a lane reads 4 with one 16-byte load)
//   and a slice of the rows (blockIdx.y), so about four blocks per SM stream
//   at once; 8 warps split the slice, each keeping four loads in flight.  The
//   warps meet in shared memory, each block adds its partial column sums to
//   a word-per-column workspace with atomics (integer sums, so the order does
//   not matter), and the last block of a column tile -- counted by a ticket
//   per tile -- writes the 8 output rows and zeroes the workspace and its
//   ticket for the next launch.
//
// dma_tile (P3) replaces scripts/dma_probe2.py::make(bn).f (kern): out =
//   float(qw[:8, :]) + s, where the TPU's BlockSpec moves the whole
//   [K/8, bn] block of words into VMEM for every grid step although only 8
//   rows are used.  Here every byte of the tile likewise passes through
//   shared memory: a ring of 4 stages of 4 rows, filled with cp.async (a load
//   the compiler cannot drop, unlike a register load whose value is never
//   used); the blocks holding rows 0..7 add s and write the output from the
//   ring.  Bound: the K/2 * N bytes of words (plus s and out), as P2.  bn
//   stays the column width of a block's tile; the rows of a tile are split
//   over blocks so that the grid fills 132 SMs at every bn.
//
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
//   that at the bf16 tensor rate, but here they run as f32 FMAs on the CUDA
//   cores (about 12 us of issue at this shape), which is what the variants
//   are there to expose.  Design: a block covers 128 columns (4 a lane, one
//   16-byte load of words and one of scales per word row) and a slice of the
//   word rows, whose activations of all 8 planes and 8 rows it stages in
//   shared memory as f32 (for V7 / V8 already telescoped); 8 warps split the
//   slice with the next row's loads issued before the current row's FMAs;
//   8 x 4 f32 accumulators a thread.  Partial sums cross blocks as in P2,
//   through an f32 workspace with atomics and a ticket per column tile; the
//   last block rounds to bf16 and zeroes the workspace.

#include "common.cuh"

using namespace qeft;

namespace {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

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

template <bool UNPACK>
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
  float sf[4] = {0.f, 0.f, 0.f, 0.f};
  auto take = [&](int4 v) {
    const uint32_t w[4] = {(uint32_t)v.x, (uint32_t)v.y, (uint32_t)v.z, (uint32_t)v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if constexpr (UNPACK) {
#pragma unroll
        for (int p = 0; p < 8; ++p) sf[j] += nibble(w[j], p);
      } else {
        su[j] += w[j];
      }
    }
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
  for (int j = 0; j < 4; ++j) red[warp][lane * 4 + j] = UNPACK ? __float_as_uint(sf[j]) : su[j];
  __syncthreads();
  const int c = blockIdx.x * kTileCols + threadIdx.x;
  if (threadIdx.x < kTileCols && c < N) {
    if constexpr (UNPACK) {
      float t = 0.f;
      for (int wp = 0; wp < 8; ++wp) t += __uint_as_float(red[wp][threadIdx.x]);
      atomicAdd(reinterpret_cast<float*>(ws) + c, t);
    } else {
      uint32_t t = 0u;
      for (int wp = 0; wp < 8; ++wp) t += red[wp][threadIdx.x];
      atomicAdd(ws + c, t);
    }
  }
  if (!last_of_tile(tickets, &last)) return;
  if (threadIdx.x < kTileCols && c < N) {
    const uint32_t t = atomicExch(ws + c, 0u);  // the total, and the workspace zeroed
    const float v = UNPACK ? __uint_as_float(t) : (float)(int32_t)t;
#pragma unroll
    for (int m = 0; m < 8; ++m) out[(size_t)m * N + c] = v;
  }
  if (threadIdx.x == 0) tickets[blockIdx.x] = 0u;
}

// ------------------------------------------------------------------ P3

constexpr int kT_STAGES = 4, kT_ROWS = 4;  // ring of 4 stages of 4 word rows

__global__ void __launch_bounds__(kThreads)
dma_tile_kernel(const int32_t* __restrict__ qw, const float* __restrict__ s,
                float* __restrict__ out, int K8, int N, int bn, int rows_per_block) {
  extern __shared__ __align__(16) int32_t ring[];
  const int col0 = blockIdx.x * bn;
  const int r0 = blockIdx.y * rows_per_block, r1 = min(r0 + rows_per_block, K8);
  const int chunks = bn / 4;  // 16-byte chunks of a row
  const int n_stages = (r1 - r0 + kT_ROWS - 1) / kT_ROWS;
  auto issue = [&](int st) {
    if (st < n_stages) {
      int32_t* slot = ring + (size_t)(st % kT_STAGES) * kT_ROWS * bn;
      for (int idx = threadIdx.x; idx < kT_ROWS * chunks; idx += blockDim.x) {
        const int rr = idx / chunks, cc = idx - rr * chunks;
        const int row = r0 + st * kT_ROWS + rr;
        if (row < r1) cp_async16(slot + rr * bn + cc * 4, qw + (size_t)row * N + col0 + cc * 4);
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count uniform
  };
  for (int st = 0; st < kT_STAGES - 1; ++st) issue(st);
  for (int st = 0; st < n_stages; ++st) {
    cp_async_wait<kT_STAGES - 2>();  // stage st has landed
    __syncthreads();                 // ... for every thread; stage st-1 is consumed
    const int row0 = r0 + st * kT_ROWS;
    if (row0 < 8) {
      const int32_t* slot = ring + (size_t)(st % kT_STAGES) * kT_ROWS * bn;
      for (int rr = 0; rr < kT_ROWS; ++rr) {
        const int row = row0 + rr;
        if (row >= 8 || row >= r1) break;
        for (int c = threadIdx.x; c < bn; c += blockDim.x) {
          const size_t o = (size_t)row * N + col0 + c;
          out[o] = (float)slot[rr * bn + c] + s[o];
        }
      }
    }
    issue(st + kT_STAGES - 1);
  }
  cp_async_wait<0>();
}

// ------------------------------------------------------------------ P4

enum Variant { kFull = 0, kNoScale, k4Plane, k2Plane, kDma, kNoShift, kF32Dot, kTele16, kTele8 };

__host__ __device__ constexpr int planes_of(int V) { return V == k4Plane ? 4 : V == k2Plane ? 2 : 8; }

// the telescoped variants: a plane that starts a field (level 0) takes x_p
// as it is, the others x_p - 16 x_{p-1}
template <int V>
__device__ __forceinline__ bool starts_field(int p) {
  return V == kTele16 ? (p & 3) == 0 : V == kTele8 ? (p & 1) == 0 : true;
}

template <int V>
__global__ void __launch_bounds__(kThreads)
gemv_ablation_kernel(const bf16* __restrict__ x, const int4* __restrict__ qw,
                     const float4* __restrict__ s, bf16* __restrict__ out,
                     float* __restrict__ ws, unsigned int* __restrict__ tickets, int K8, int N,
                     int G, int bn, int rows_per_block) {
  constexpr int PLANES = planes_of(V);
  extern __shared__ __align__(16) float smem[];  // xs [rows][8 planes][8 rows], then the reduction
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = blockIdx.x * kTileCols + lane * 4;
  const int r0 = blockIdx.y * rows_per_block, r1 = min(r0 + rows_per_block, K8);
  const int K = K8 * 8, n4 = N / 4;

  if constexpr (V != kDma) {
    for (int idx = threadIdx.x; idx < (r1 - r0) * 64; idx += blockDim.x) {
      const int wl = idx >> 6, p = (idx >> 3) & 7, m = idx & 7;
      const int w = r0 + wl;
      float v = bf2f(x[(size_t)m * K + p * K8 + w]);
      if (!starts_field<V>(p)) v -= 16.f * bf2f(x[(size_t)m * K + (p - 1) * K8 + w]);
      smem[idx] = v;
    }
    __syncthreads();
  }

  float acc[8][4];
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;

  if (c0 < N) {
    int w = r0 + warp;
    int4 qn = make_int4(0, 0, 0, 0);
    float4 sn = make_float4(0.f, 0.f, 0.f, 0.f);
    if (w < r1) {
      qn = __ldg(qw + (size_t)w * n4 + c0 / 4);
      if (V != kDma && V != kNoScale) sn = __ldg(s + (size_t)(w % G) * n4 + c0 / 4);
    }
    for (; w < r1; w += 8) {
      const uint32_t q[4] = {(uint32_t)qn.x, (uint32_t)qn.y, (uint32_t)qn.z, (uint32_t)qn.w};
      const float sc[4] = {sn.x, sn.y, sn.z, sn.w};
      if (w + 8 < r1) {  // the next row's loads in flight during this row's FMAs
        qn = __ldg(qw + (size_t)(w + 8) * n4 + c0 / 4);
        if (V != kDma && V != kNoScale) sn = __ldg(s + (size_t)((w + 8) % G) * n4 + c0 / 4);
      }
      if constexpr (V == kDma) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[0][j] += (float)(int32_t)q[j];
        continue;
      }
      const float4* xw = reinterpret_cast<const float4*>(smem + (w - r0) * 64);
      uint32_t cur[4];
#pragma unroll
      for (int p = 0; p < PLANES; ++p) {
        float wt[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t code;
          if constexpr (V == kTele16) {
            if ((p & 3) == 0) cur[j] = p == 0 ? (q[j] & 0xFFFFu) : (q[j] >> 16);
            else cur[j] >>= 4;
            code = cur[j];
          } else if constexpr (V == kTele8) {
            if ((p & 1) == 0) cur[j] = p == 6 ? (q[j] >> 24) : ((q[j] >> (4 * p)) & 0xFFu);
            else cur[j] >>= 4;
            code = cur[j];
          } else if constexpr (V == kNoShift) {
            code = q[j] & 0xFu;
          } else {
            code = (q[j] >> (4 * p)) & 0xFu;
          }
          const float f = (float)code;
          if constexpr (V == kNoScale) wt[j] = f;  // a nibble is exact in bf16
          else if constexpr (V == kF32Dot || V == kTele16 || V == kTele8) wt[j] = f * sc[j];
          else wt[j] = bf2f(f2bf(f * sc[j]));
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

  constexpr int ROWS_OUT = V == kDma ? 1 : 8;
  __syncthreads();  // xs consumed: the same shared memory takes the reduction
  float* red = smem;  // [8 warps][ROWS_OUT][128]
#pragma unroll
  for (int m = 0; m < ROWS_OUT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) red[(warp * ROWS_OUT + m) * kTileCols + lane * 4 + j] = acc[m][j];
  __syncthreads();
  for (int idx = threadIdx.x; idx < ROWS_OUT * kTileCols; idx += blockDim.x) {
    const int m = idx / kTileCols, col = idx - m * kTileCols;
    const int c = blockIdx.x * kTileCols + col;
    if (c >= N) continue;
    float t = 0.f;
    for (int wp = 0; wp < 8; ++wp) t += red[(wp * ROWS_OUT + m) * kTileCols + col];
    atomicAdd(ws + (size_t)m * N + c, t);
  }
  if (!last_of_tile(tickets, &last)) return;
  for (int idx = threadIdx.x; idx < 8 * kTileCols; idx += blockDim.x) {
    const int m = idx / kTileCols, col = idx - m * kTileCols;
    const int c = blockIdx.x * kTileCols + col;
    if (c >= N) continue;
    float v;
    if constexpr (V == kDma) {
      v = __ldcg(ws + c) + bf2f(x[(size_t)m * K + c % bn]);
    } else {
      v = atomicExch(ws + (size_t)m * N + c, 0.f);
    }
    out[(size_t)m * N + c] = f2bf(v);
  }
  if constexpr (V == kDma) {
    __syncthreads();  // every row has read the column sums
    for (int col = threadIdx.x; col < kTileCols; col += blockDim.x) {
      const int c = blockIdx.x * kTileCols + col;
      if (c < N) ws[c] = 0.f;
    }
  }
  if (threadIdx.x == 0) tickets[blockIdx.x] = 0u;
}

template <int V>
cudaError_t launch_ablation(const bf16* x, const int4* qw, const float4* s, bf16* out, float* ws,
                            unsigned int* tickets, int K8, int N, int G, int bn, int rpb,
                            cudaStream_t st) {
  const size_t xs = V == kDma ? 0 : (size_t)rpb * 64 * sizeof(float);
  const size_t rd = (size_t)8 * (V == kDma ? 1 : 8) * kTileCols * sizeof(float);
  const size_t smem = xs > rd ? xs : rd;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(gemv_ablation_kernel<V>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((N + kTileCols - 1) / kTileCols, (K8 + rpb - 1) / rpb);
  gemv_ablation_kernel<V><<<grid, kThreads, smem, st>>>(x, qw, s, out, ws, tickets, K8, N, G, bn,
                                                         rpb);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

extern "C" int add_one(const void* x, void* y, int n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  add_one_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), n);
  return (int)cudaGetLastError();
}

namespace {

// ws: N zeroed words, tickets: ceil(N / 128) zeroed counters; both are left
// zeroed
int column_sum(const void* qw, void* out, void* ws, void* tickets, int K8, int N,
               int rows_per_block, bool unpack, void* stream) {
  if (K8 < 1 || N < 4 || N % 4 || rows_per_block < 1 || !aligned16(qw))
    return (int)cudaErrorInvalidValue;
  dim3 grid((N + kTileCols - 1) / kTileCols, (K8 + rows_per_block - 1) / rows_per_block);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int4* q = static_cast<const int4*>(qw);
  float* o = static_cast<float*>(out);
  uint32_t* w = static_cast<uint32_t*>(ws);
  unsigned int* t = static_cast<unsigned int*>(tickets);
  if (unpack)
    colsum_kernel<true><<<grid, kThreads, 0, st>>>(q, o, w, t, K8, N, rows_per_block);
  else
    colsum_kernel<false><<<grid, kThreads, 0, st>>>(q, o, w, t, K8, N, rows_per_block);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dma_only(const void* qw, void* out, void* ws, void* tickets, int K8, int N,
                        int rows_per_block, void* stream) {
  return column_sum(qw, out, ws, tickets, K8, N, rows_per_block, false, stream);
}

extern "C" int unpack_only(const void* qw, void* out, void* ws, void* tickets, int K8, int N,
                           int rows_per_block, void* stream) {
  return column_sum(qw, out, ws, tickets, K8, N, rows_per_block, true, stream);
}

extern "C" int dma_tile(const void* qw, const void* s, void* out, int K8, int N, int bn,
                        int rows_per_block, void* stream) {
  if (K8 < 8 || bn < 4 || bn % 4 || N % bn || rows_per_block < 1 || !aligned16(qw))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kT_STAGES * kT_ROWS * bn * sizeof(int32_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(dma_tile_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(N / bn, (K8 + rows_per_block - 1) / rows_per_block);
  dma_tile_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(qw), static_cast<const float*>(s), static_cast<float*>(out),
      K8, N, bn, rows_per_block);
  return (int)cudaGetLastError();
}

// ws: 8 * N zeroed floats, tickets: ceil(N / 128) zeroed counters; both are
// left zeroed.  G = K / g scale rows; bn: the N tile of the V4 variant.
extern "C" int gemv_ablation(const void* x, const void* qw, const void* s, void* out, void* ws,
                             void* tickets, int K8, int N, int G, int bn, int rows_per_block,
                             int variant, void* stream) {
  if (K8 < 1 || N < 4 || N % 4 || G < 1 || K8 % G || bn < 1 || bn > K8 * 8 ||
      rows_per_block < 1 || rows_per_block > 192 || !aligned16(qw) || !aligned16(s))
    return (int)cudaErrorInvalidValue;
  const bf16* xx = static_cast<const bf16*>(x);
  const int4* q = static_cast<const int4*>(qw);
  const float4* ss = static_cast<const float4*>(s);
  bf16* o = static_cast<bf16*>(out);
  float* w = static_cast<float*>(ws);
  unsigned int* t = static_cast<unsigned int*>(tickets);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define QEFT_CASE(VV) \
  case VV:            \
    return (int)launch_ablation<VV>(xx, q, ss, o, w, t, K8, N, G, bn, rows_per_block, st);
  switch (variant) {
    QEFT_CASE(kFull) QEFT_CASE(kNoScale) QEFT_CASE(k4Plane) QEFT_CASE(k2Plane) QEFT_CASE(kDma)
    QEFT_CASE(kNoShift) QEFT_CASE(kF32Dot) QEFT_CASE(kTele16) QEFT_CASE(kTele8)
  }
#undef QEFT_CASE
  return (int)cudaErrorInvalidValue;
}
