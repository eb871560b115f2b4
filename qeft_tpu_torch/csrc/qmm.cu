// Packed INT4 (W4A16) products of the mixed-precision linear, for Hopper.
//
// qgemv_stacked_fused (K1) replaces qeft_tpu/ops/pallas_qmm.py::
//   qgemv_stacked_fused (_qmm_kernel_stacked_fused): one decoder stage for
//   1..8 token rows -- optional RMS norm of the raw residual, the INT4 matvec
//   over ALL K rows, the weak-column slab x[:, K-r:] @ oweight[l], optional
//   residual add -- reading layer `layer` of the stacked [L, ...] buffers in
//   place.
// qgemv_stacked (K6) replaces pallas_qmm.py::qgemv_stacked
//   (_qmm_kernel_stacked): the same matvec and slab with no norm and no
//   residual -- the linear of the ragged window forward that continuous
//   batching and speculative drafting run.
// qgemv (K5) replaces pallas_qmm.py::qgemv (_run_qmm at bm = 8): K6 on one
//   unstacked linear, plus an optional bias [N], summed in f32 and rounded
//   to bf16 once (the TPU path adds slab and bias outside its kernel,
//   rounding after each): every OPT, Phi, Bloom and Falcon linear at decode.
//   All three are one kernel, qgemv_mma_kernel: K1 with its norm prologue and
//   residual epilogue, K5 layer 0 with a bias.  Group sizes 64 and 128, N a
//   multiple of 4; anything else returns cudaErrorInvalidValue.
//   Bound: HBM bytes (K*N/2 bytes of codes, 4*(K/g)*N of scales and zero
//   points, 2*r*N of oweight); 2*M*K*N operations are a few µs of
//   tensor-core time.
//   Design (tensor cores): mma.sync m16n8k16 with the weights as A (16
//   output columns x 16 K rows) and the <= 8 token rows as B's 8 columns, f32
//   accumulators.  A nibble plus 128 is exact in bf16, so one shift and one
//   mask-or turn a word's nibbles (q, q + 4) into an A register as it stands;
//   each group's MMAs start from zero and fold into the f32 result as
//   s_g * part + (z_g - 128 s_g) * sum_g(x), which spends no instruction on
//   turning the codes back to 0..15.  The MMA sums over its 16 K rows in any
//   order, so the order is the words' (mma_k_row): a lane takes one word row
//   of 4 consecutive columns (a 16-byte load) and feeds two k16 steps of two
//   column pairs.  A block of 8 warps covers 256 columns and a split of the
//   groups; all its threads stage the split's activations of the M token
//   rows in MMA order, 16-byte stores (8-byte loads transposed with byte
//   permutes), in chunks of 64 units (2,048 K rows at g = 128) at any K,
//   with one sum per (unit, token) for the zero points.  Each lane loads the next step's 16 words and scales
//   into registers (64 bytes, coalesced as they stand: 128 bytes a word row
//   across a warp) while it computes the current step; 43 KB of static
//   shared memory, two blocks an SM.  (A lane-private cp.async ring three
//   steps deep measured slower on the H100: the kernel is bound by the
//   latency of its dependent instruction chains and its fixed costs, not by
//   bytes in flight.)  N = 4096 has 16 tiles of 256 columns for 132 SMs, so
//   the groups are split over up to 8 blocks (blockIdx.y), one thread block
//   cluster; the splits' partial tiles are summed in rank order through the
//   cluster's distributed shared memory (no atomics, no second pass, no
//   workspace): two calls on the same inputs are bit-identical.  The weak
//   columns are k16 steps of oweight (two rows per A register, byte
//   permutes) against x[:, K-r:], spread over the splits, loaded with the
//   first words.
//   K1's prologue: behind its first word loads every block sums the squares
//   of each whole token row itself (M x K bf16 from L2, f32, one thread
//   mapping and order shared by all blocks), so every split of a cluster
//   holds a bit-identical rstd without a cluster barrier.  The normalised
//   values (rounded to bf16 after the RMS scale, then times the weight, as
//   rms_norm) take the raw ones' place where the activations are staged,
//   in the zero-point sums and in the weak-column steps.  The residual is
//   added in the rank-order sum, before the one rounding, where K5 adds its
//   bias.  (An earlier K1 ran on the CUDA cores, one block per 32 columns,
//   each block re-staging the whole row: bound by dequantization and FMA
//   issue.)
//   The bf16w variant (template flag BF16W; entry points *_bf16w, asked for
//   by QEFT_GEMV_F32W=0) replaces the same kernels under the JAX package's
//   _plane_dot with f32w off: each dequantized weight code * scale is
//   rounded once to bf16 before the product.  Its A registers are
//   fma(128 + code, s, -128 s) on bf16 pairs -- (128 + code) * s is exact,
//   so the fused add leaves code * s rounded once -- and each group folds
//   in as part + z * sum_g(x).  It costs a bf16x2 FMA per A register more.
//
// qgemm (K2) replaces pallas_qmm.py::qgemm (_run_qmm / _qmm_kernel): the
//   W4A16 GEMM for more rows (prefill, PPL windows, the training forward),
//   with the weak-column slab and an optional residual in the epilogue
//   instead of separate GEMMs.  Group sizes 64 and 128.
//   Bound: at M = 64 the weight bytes (as K1), and in practice the
//   dequantization on CUDA cores (each weight is turned into bf16 once per
//   block row); at M = 2048 the bf16 tensor-core rate.
//   Design (Hopper): a block of two warpgroups computes a BM x 128 tile with
//   wgmma (m64n128k16 at BM = 128, m64n64k16 at BM = 64), f32 accumulators
//   in registers.  A step is 64 K rows (half a group at g = 128): one thread
//   has TMA bring the step's activation tile (in the 128-byte swizzle wgmma
//   reads) and, once a group, its packed words, scales and zero points into
//   a ring of 3 (BM = 128) or 4 (BM = 64) shared-memory stages, S - 1 steps
//   ahead, each stage completing on its own mbarrier.  All 256 threads dequantize a
//   stage's words (code*scale, then + zero, in f32, one rounding to bf16 --
//   as the plain version) into a K-major, swizzled B tile, 16 bytes a store,
//   while the tensor cores run the previous step's wgmmas, which read the
//   activations straight from the ring.  So each [g x 128] weight tile is
//   dequantized once per 128 rows at M > 64 (16 times at M = 2048, against
//   32 before).  Two blocks share an SM, so one block's barriers and
//   dequantization overlap the other's tensor-core work.  At 9..64 rows BM
//   = 64 and the groups are split over blockIdx.z (split-K, at least about
//   two blocks per SM, no empty split); each split leaves an f32 partial
//   tile and a second pass sums them in split order (deterministic) with
//   the residual.  The weak columns follow, in the last split, as steps of
//   32 K rows that copy oweight into the B tile.
//
// qgemm_t (K7) replaces pallas_qmm.py::qgemm_t (_qmm_t_kernel): the training
//   backward dx = g @ W_deq^T from the packed codes, over ALL K rows (the
//   last r included: the forward's K2 runs over them too), plus an optional
//   f32 [M, r] addend (the weak-column product g @ oweight^T, computed
//   outside) on the last r columns before the one rounding to bf16.
//   Bound: at M = 2048 the bf16 tensor-core rate (2*M*K*N operations against
//   K*N/2 code bytes and 2*M*(N + K) activation bytes).
//   Design: K2's main loop with the contraction over N.  A block owns BM
//   rows x 128 output columns (one group at g = 128, two at g = 64) and
//   loops over N in steps of 64 through a ring of 3 (BM = 128) or 4 stages;
//   word row jj, nibble p is K column p*(g/8) + jj of its group, and N is
//   the words' contiguous dimension, so W_deq^T is K-major
//   (contraction-contiguous) as wgmma reads it: 8 consecutive words of one
//   word row give one 16-byte chunk per plane.  The block writes its columns
//   in original K order; no inverse permutation is needed.  At M = 2048
//   each weight is dequantized 16 times (once per 128 rows), against 32
//   before.

#include <cooperative_groups.h>
#include <cuda.h>

#include "common.cuh"

using namespace qeft;

namespace {

// ------------------------------------------------------------ K1, K5, K6

// A block is kD_WARPS warps over kD_BN output columns and a split of the
// quantization groups (blockIdx.y, one block of a cluster of the splits).
// Warp w owns 32 columns -- lane (gid, t) = (lane / 4, lane % 4) the four
// columns 4*gid .. 4*gid + 3 of them -- and every group of the split.  A
// unit is 4 word rows (jj0 .. jj0 + 3) of one group: 32 K rows.
// A warp step is kD_STEP_UNITS units (one group at g = 128, two at g = 64):
// each lane loads its words, scales and zero points of the next step into
// registers while it computes the current one.
constexpr int kD_WARPS = 8;
constexpr int kD_THREADS = kD_WARPS * 32;
constexpr int kD_BN = kD_WARPS * 32;
constexpr int kD_CHUNK = 64;        // units of activations staged at once (32 KB)
constexpr int kD_UNIT = 8 * 32;     // staged bf16 of a unit: 8 token rows x 32 K rows
constexpr int kD_STEP_UNITS = 4;
constexpr int kD_MAX_SPLITS = 8;     // the portable cluster size
constexpr int kD_BLOCKS_PER_SM = 2;
constexpr uint32_t kBF16_128 = 0x43004300u;  // the bf16 pair (128, 128)
constexpr uint32_t kBF16_M128 = 0xC300C300u;  // the bf16 pair (-128, -128)

// the low and high bf16 halves of a 32-bit word, as floats
__device__ __forceinline__ float lo_bf16(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_bf16(uint32_t v) { return __uint_as_float(v & 0xFFFF0000u); }
__device__ __forceinline__ float round_bf16(float v) { return bf2f(f2bf(v)); }

// K1's norm prologue on a bf16 pair of x and the pair of norm weights at the
// same K rows: each value rounded to bf16 after the RMS scale, then
// multiplied by its weight (by bf16(1 + w) for gemma) and rounded again, as
// ops/qmm.py:rms_norm does it
__device__ __forceinline__ uint32_t normed_pair(uint32_t x, uint32_t w, float rs,
                                                int one_offset) {
  float w0 = lo_bf16(w), w1 = hi_bf16(w);
  if (one_offset) {
    w0 = round_bf16(1.f + w0);
    w1 = round_bf16(1.f + w1);
  }
  const bf162 r = __floats2bfloat162_rn(round_bf16(lo_bf16(x) * rs) * w0,
                                        round_bf16(hi_bf16(x) * rs) * w1);
  return *reinterpret_cast<const uint32_t*>(&r);
}

// The contraction order of the tensor-core decode matvec.  Element j (0..7)
// of lane t's activation chunk of the unit at word row jj0 is K row
// mma_k_row(hh, jj0, t, j) of its group: word row jj0 + t, nibble j/2 + 4*(j%2).
// The mask-or pair q of that word holds nibbles (q, q + 4), elements
// (2q, 2q + 1), so chunk word q and pair q meet in one MMA register: pair 2s
// is A register a0 / a1 and pair 2s + 1 is a2 / a3 of k16 step s (0, 1),
// chunk words 2s and 2s + 1 are B registers b0 and b1.  Over the units and
// both steps this is a permutation of the group's g K rows
// (qeft_tpu_torch/ops/qmm.py:mma_k_row is its twin, for the CPU tests).
__host__ __device__ constexpr int mma_k_row(int hh, int jj0, int t, int j) {
  return ((j >> 1) + 4 * (j & 1)) * hh + jj0 + t;
}

// mask-or pair q of a word: the bf16 pair (128 + nibble q, 128 + nibble q + 4)
__device__ __forceinline__ uint32_t code_pair(uint32_t w, int q) {
  return nibble_pair(w, q) | kBF16_128;
}

// the bf16w variant's A register: the pair (nibble q * s, nibble q + 4 * s),
// each product rounded once to bf16; s2 = (s, s), n2 = (-128 s, -128 s)
__device__ __forceinline__ uint32_t scaled_pair(uint32_t w, int q, uint32_t s2, uint32_t n2) {
  const uint32_t c = code_pair(w, q);
  const bf162 r = __hfma2(*reinterpret_cast<const bf162*>(&c),
                          *reinterpret_cast<const bf162*>(&s2),
                          *reinterpret_cast<const bf162*>(&n2));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// the bf16 pair (v, v) of the low (hi = false) or high half of a word
__device__ __forceinline__ uint32_t splat(uint32_t v, bool hi) {
  return __byte_perm(v, 0u, hi ? 0x3232 : 0x1010);
}

// the low (hi = false) or high bf16 halves of a and b as one pair (a's first)
__device__ __forceinline__ uint32_t halves(uint32_t a, uint32_t b, bool hi) {
  return __byte_perm(a, b, hi ? 0x7632 : 0x5410);
}

struct GemvArgs {
  const bf16* x;       // [M, K]: K1's raw residual when lnw is given
  const bf16* lnw;     // [K] RMS-norm weight or null (K1)
  const int32_t* qw;   // [K/8, N], word row jj*G + gi
  const bf16* sc;      // [G, N]
  const bf16* sz;      // [G, N]
  const bf16* ow;      // [R, N] or null
  const bf16* bias;    // [N] or null (K5)
  const bf16* res;     // [M, N] residual or null (K1)
  bf16* out;           // [M, N]
  int M, K, N, R;
  float eps;
  int one_offset;      // gemma's norm: scale by 1 + lnw
  int bf16w;           // the bf16w variant
};

// NORM: K1 with its norm prologue (p.lnw given); K6 and K5 compile without it.
// BF16W: the bf16w variant (weights code * scale rounded to bf16)
template <int UPG, bool NORM, bool BF16W>
__global__ void __launch_bounds__(kD_THREADS, kD_BLOCKS_PER_SM)
qgemv_mma_kernel(const GemvArgs p) {
  constexpr int HH = UPG * 4, GROUP = HH * 8, GPB = kD_STEP_UNITS / UPG;
  __shared__ __align__(16) bf16 xs[kD_CHUNK * kD_UNIT];   // [unit][token][32], chunk order
  __shared__ __align__(8) float psum[kD_CHUNK * 8];       // [unit][token]: its 32 values
  __shared__ __align__(16) float red[8 * kD_BN];           // [token][column]
  __shared__ float ssq[kD_WARPS * 8];                      // K1: [warp][token] sums of squares
  __shared__ float rstd[8];                                // K1: [token]
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, t = lane & 3;
  const int M = p.M, K = p.K, N = p.N, G = K / GROUP;
  const int S = gridDim.y, rank = blockIdx.y;
  const int gb0 = rank * G / S, gb1 = (rank + 1) * G / S;  // this split's groups
  const int n4 = blockIdx.x * kD_BN + warp * 32 + 4 * gid;  // this lane's 4 columns
  const bool col_ok = n4 < N;                              // N % 4 == 0

  // the words (4 columns, word row jj0 + t), scales and zero points of
  // groups gi .. gi + GPB - 1; zeros past the split
  auto load = [&](int gi, uint4 (&w)[kD_STEP_UNITS], uint2 (&s)[GPB], uint2 (&z)[GPB]) {
#pragma unroll
    for (int b = 0; b < GPB; ++b) {
      const int gg = gi + b;
      const bool ok = col_ok && gg < gb1;
#pragma unroll
      for (int u = 0; u < UPG; ++u)
        w[b * UPG + u] = ok ? __ldcs(reinterpret_cast<const uint4*>(
                                  p.qw + ((size_t)(4 * u + t) * G + gg) * N + n4))
                            : make_uint4(0u, 0u, 0u, 0u);
      s[b] = ok ? __ldcs(reinterpret_cast<const uint2*>(p.sc + (size_t)gg * N + n4))
                : make_uint2(0u, 0u);
      z[b] = ok ? __ldcs(reinterpret_cast<const uint2*>(p.sz + (size_t)gg * N + n4))
                : make_uint2(0u, 0u);
    }
  };

  uint4 w[kD_STEP_UNITS], w_next[kD_STEP_UNITS];
  uint2 s[GPB], z[GPB], s_next[GPB], z_next[GPB];
  int gi = gb0;
  load(gi, w, s, z);

  float acc[2][4];  // [tile j][i]: column n4 + 2j + i/2, token 2t + i%2
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  // 1. the first of this split's weak-column steps (k16 steps over
  //    x[:, K-R:] in natural order, zero past R, and oweight, spread over
  //    the splits), loaded while the words are in flight and computed once
  //    the activations are staged
  const int R = p.R, weak_steps = p.ow != nullptr ? (R + 15) / 16 : 0;
  const int mp_log = M > 4 ? 3 : M > 2 ? 2 : M - 1, MP = 1 << mp_log;  // M to a power of two
  auto pair = [&](const bf16* v, int i) -> uint32_t {  // v[i], v[i + 1] as a bf16 pair, 0 past R
    const uint32_t lo = i < R ? __bfloat16_as_ushort(v[i]) : 0u;
    const uint32_t hi = i + 1 < R ? __bfloat16_as_ushort(v[i + 1]) : 0u;
    return lo | (hi << 16);
  };
  const bf16* xt = p.x + (size_t)gid * K + (K - R);  // x[gid, K-R:]
  auto xpair = [&](int i) -> uint32_t { return gid < M ? pair(xt, i) : 0u; };
  auto orow = [&](int i) -> uint2 {  // oweight[i, n4 .. n4 + 3]
    return col_ok && i < R ? __ldg(reinterpret_cast<const uint2*>(p.ow + (size_t)i * N + n4))
                           : make_uint2(0u, 0u);
  };
  uint2 wr[4];  // oweight rows i0, i0 + 1, i0 + 8, i0 + 9 of step ws
  uint32_t wb[2], wl[2];  // x and (K1) lnw at K-R + i0 .. +1 and + i0 + 8 .. +9
  auto load_weak = [&](int ws) {
    const int i0 = ws * 16 + 2 * t;
    wr[0] = orow(i0);
    wr[1] = orow(i0 + 1);
    wr[2] = orow(i0 + 8);
    wr[3] = orow(i0 + 9);
    wb[0] = xpair(i0);
    wb[1] = xpair(i0 + 8);
    if constexpr (NORM) {
      wl[0] = pair(p.lnw + (K - R), i0);
      wl[1] = pair(p.lnw + (K - R), i0 + 8);
    }
  };
  int ws = rank;
  if (ws < weak_steps) load_weak(ws);

  // 2. K1's norm prologue, issued behind the first loads: every block sums
  //    the squares of each whole token row itself (f32, from L2) in one
  //    thread mapping and order, so all splits of a cluster scale by
  //    bit-identical rstd with no cluster barrier
  if constexpr (NORM) {
    float ss[8];
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      ss[m] = 0.f;
      if (m >= M) continue;
      const uint4* xr = reinterpret_cast<const uint4*>(p.x + (size_t)m * K);
#pragma unroll 4
      for (int c = tid; c < K / 8; c += kD_THREADS) {
        const uint4 v = __ldg(xr + c);
        const uint32_t e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          ss[m] = fmaf(lo_bf16(e[q]), lo_bf16(e[q]), ss[m]);
          ss[m] = fmaf(hi_bf16(e[q]), hi_bf16(e[q]), ss[m]);
        }
      }
      ss[m] = warp_sum(ss[m]);
    }
    if (lane == 0) {
#pragma unroll
      for (int m = 0; m < 8; ++m) ssq[warp * 8 + m] = ss[m];
    }
    __syncthreads();
    if (tid < 8) {
      float v = 0.f;
#pragma unroll
      for (int wp = 0; wp < kD_WARPS; ++wp) v += ssq[wp * 8 + tid];
      rstd[tid] = rsqrtf(v / (float)K + p.eps);
    }
    __syncthreads();
  }

  for (int c0 = gb0; c0 < gb1; c0 += kD_CHUNK / UPG) {
    const int c1 = min(gb1, c0 + kD_CHUNK / UPG);
    if (c0 > gb0) __syncthreads();  // the previous chunk's MMAs are done

    // 3. the chunk's activations in MMA order (K1: normalised), 16 bytes
    //    per (unit, token < M, lane t), and each (unit, token)'s sum for the
    //    zero points, over (unit, token) pairs of MP tokens a unit, so that
    //    one token row keeps every thread busy.  The slots of tokens past M
    //    are never written: they feed only the MMA columns and the fold of
    //    those tokens, whose results are never read
    for (int idx = tid; idx < (c1 - c0) * UPG * MP; idx += kD_THREADS) {
      const int u = idx >> mp_log, m = idx & (MP - 1), jj0 = 4 * (u % UPG);
      if (m >= M) continue;
      const size_t k0 = (size_t)(c0 + u / UPG) * GROUP;
      uint2 v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[j] = __ldg(reinterpret_cast<const uint2*>(p.x + (size_t)m * K + k0 +
                                                    mma_k_row(HH, jj0, 0, j)));
      if constexpr (NORM) {
        const float rs = rstd[m];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint2 l =
              __ldg(reinterpret_cast<const uint2*>(p.lnw + k0 + mma_k_row(HH, jj0, 0, j)));
          v[j].x = normed_pair(v[j].x, l.x, rs, p.one_offset);
          v[j].y = normed_pair(v[j].y, l.y, rs, p.one_offset);
        }
      }
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        sum += (lo_bf16(v[j].x) + hi_bf16(v[j].x)) + (lo_bf16(v[j].y) + hi_bf16(v[j].y));
      psum[u * 8 + m] = sum;
      uint4* dst = reinterpret_cast<uint4*>(xs + (size_t)(u * 8 + m) * 32);
#pragma unroll
      for (int tt = 0; tt < 4; ++tt) {
        uint32_t c[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          c[q] = halves(tt < 2 ? v[2 * q].x : v[2 * q].y, tt < 2 ? v[2 * q + 1].x : v[2 * q + 1].y,
                        tt & 1);
        dst[tt] = make_uint4(c[0], c[1], c[2], c[3]);
      }
    }
    __syncthreads();
    if (c0 == gb0) {
      // the weak-column steps, their loads issued before the staging
      for (; ws < weak_steps; ws += S) {
        uint32_t b0 = wb[0], b1 = wb[1];
        if constexpr (NORM) {
          const float rs = gid < M ? rstd[gid] : 0.f;
          b0 = normed_pair(b0, wl[0], rs, p.one_offset);
          b1 = normed_pair(b1, wl[1], rs, p.one_offset);
        }
        mma_bf16(acc[0], halves(wr[0].x, wr[1].x, false), halves(wr[0].x, wr[1].x, true),
                 halves(wr[2].x, wr[3].x, false), halves(wr[2].x, wr[3].x, true), b0, b1);
        mma_bf16(acc[1], halves(wr[0].y, wr[1].y, false), halves(wr[0].y, wr[1].y, true),
                 halves(wr[2].y, wr[3].y, false), halves(wr[2].y, wr[3].y, true), b0, b1);
        if (ws + S < weak_steps) load_weak(ws + S);
      }
    }

    // 4. the warp's groups of the chunk, the next step's words in flight
    for (; gi < c1; gi += GPB) {
      load(gi + GPB, w_next, s_next, z_next);
#pragma unroll
      for (int b = 0; b < GPB; ++b) {
        const int gl = gi + b - c0;  // the group within the chunk
        if (gi + b >= c1) break;
        float part[2][4];  // sum over the group of x * (128 + code), from zero
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) part[j][i] = 0.f;
        float sx0 = 0.f, sx1 = 0.f;  // the group's sums of tokens 2t, 2t + 1
        const uint2 sv = s[b], zv = z[b];
        const uint32_t sp[2] = {sv.x, sv.y}, zp[2] = {zv.x, zv.y};
        uint32_t s2[2][2], n2[2][2];  // bf16w: [column pair j][column 2j, 2j + 1] (s, s), -128 s
        if constexpr (BF16W) {
          const uint32_t m128 = kBF16_M128;
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              s2[j][c] = splat(sp[j], c != 0);
              const bf162 n = __hmul2(*reinterpret_cast<const bf162*>(&s2[j][c]),
                                      *reinterpret_cast<const bf162*>(&m128));
              n2[j][c] = *reinterpret_cast<const uint32_t*>(&n);
            }
        }
#pragma unroll
        for (int u = 0; u < UPG; ++u) {
          const int cu = gl * UPG + u;
          const uint4 xb = *reinterpret_cast<const uint4*>(xs + (size_t)(cu * 8 + gid) * 32 + t * 8);
          const float2 ps = *reinterpret_cast<const float2*>(psum + cu * 8 + 2 * t);
          sx0 += ps.x;
          sx1 += ps.y;
          const uint4 wv = w[b * UPG + u];
          const uint32_t cw[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const uint32_t e = cw[2 * j], o = cw[2 * j + 1];  // columns 2j, 2j + 1
            if constexpr (BF16W) {
              const uint32_t se = s2[j][0], so = s2[j][1], ne = n2[j][0], no = n2[j][1];
              mma_bf16(part[j], scaled_pair(e, 0, se, ne), scaled_pair(o, 0, so, no),
                       scaled_pair(e, 1, se, ne), scaled_pair(o, 1, so, no), xb.x, xb.y);
              mma_bf16(part[j], scaled_pair(e, 2, se, ne), scaled_pair(o, 2, so, no),
                       scaled_pair(e, 3, se, ne), scaled_pair(o, 3, so, no), xb.z, xb.w);
            } else {
              mma_bf16(part[j], code_pair(e, 0), code_pair(o, 0), code_pair(e, 1),
                       code_pair(o, 1), xb.x, xb.y);
              mma_bf16(part[j], code_pair(e, 2), code_pair(o, 2), code_pair(e, 3),
                       code_pair(o, 3), xb.z, xb.w);
            }
          }
        }
        // acc += s * part + (z - 128 s) * sum(x): the codes above carry +128
        // (bf16w: part carries the scale and no +128, so acc += part + z * sum(x))
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float s0 = BF16W ? 1.f : lo_bf16(sp[j]), s1 = BF16W ? 1.f : hi_bf16(sp[j]);
          const float z0 = lo_bf16(zp[j]) - (BF16W ? 0.f : 128.f * s0);
          const float z1 = hi_bf16(zp[j]) - (BF16W ? 0.f : 128.f * s1);
          acc[j][0] += s0 * part[j][0] + z0 * sx0;
          acc[j][1] += s0 * part[j][1] + z0 * sx1;
          acc[j][2] += s1 * part[j][2] + z1 * sx0;
          acc[j][3] += s1 * part[j][3] + z1 * sx1;
        }
      }
#pragma unroll
      for (int i = 0; i < kD_STEP_UNITS; ++i) w[i] = w_next[i];
#pragma unroll
      for (int b = 0; b < GPB; ++b) {
        s[b] = s_next[b];
        z[b] = z_next[b];
      }
    }
  }

  // 5. the splits' partial tiles, summed in rank order through the cluster's
  //    shared memory; each block writes its share of the tile (+ K5's bias
  //    or K1's residual) in bf16, rounded once
  const int cl = warp * 32 + 4 * gid;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) red[(2 * t + (i & 1)) * kD_BN + cl + 2 * j + (i >> 1)] = acc[j][i];
  cluster.sync();
  const int per = (8 * kD_BN + S - 1) / S, end = min(8 * kD_BN, (rank + 1) * per);
  for (int idx = rank * per + tid; idx < end; idx += kD_THREADS) {
    const int m = idx / kD_BN, nn = blockIdx.x * kD_BN + idx % kD_BN;
    if (m >= M || nn >= N) continue;
    float y = 0.f;
    for (int r = 0; r < S; ++r) y += cluster.map_shared_rank(red, r)[idx];
    if (p.bias != nullptr) y += bf2f(p.bias[nn]);
    if (p.res != nullptr) y += bf2f(p.res[(size_t)m * N + nn]);
    p.out[(size_t)m * N + nn] = f2bf(y);
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

// the groups split over a cluster of up to 8 blocks, at most two blocks an SM
template <int UPG>
cudaError_t launch_gemv(const GemvArgs& a, cudaStream_t stream) {
  const int tiles = (a.N + kD_BN - 1) / kD_BN;
  const int splits = k_splits(tiles, a.K / (UPG * 32), kD_MAX_SPLITS, kD_BLOCKS_PER_SM);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = split_cluster_config(tiles, splits, kD_THREADS, stream, &attr);
  cudaError_t e;
  if (a.bf16w)
    e = a.lnw != nullptr ? cudaLaunchKernelEx(&cfg, qgemv_mma_kernel<UPG, true, true>, a)
                         : cudaLaunchKernelEx(&cfg, qgemv_mma_kernel<UPG, false, true>, a);
  else
    e = a.lnw != nullptr ? cudaLaunchKernelEx(&cfg, qgemv_mma_kernel<UPG, true, false>, a)
                         : cudaLaunchKernelEx(&cfg, qgemv_mma_kernel<UPG, false, false>, a);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// ----------------------------------------------------------------- K2, K7

// One main loop serves both GEMMs (ROLE T7 = false: K2, true: K7).  A block
// is 256 threads, two warpgroups, over a BM x 128 output tile: at BM = 128
// each warpgroup owns 64 rows and all 128 columns (wgmma m64n128k16), at
// BM = 64 each owns the 64 rows and half the columns (m64n64k16).  A step
// contracts 64 rows of K (K2) or of N (K7).  Both operands sit K-major
// (contraction-contiguous) in shared memory in the 128-byte swizzle wgmma
// reads: rows of 64 bf16, 16-byte chunk c of row r at chunk c ^ (r & 7),
// 8-row atoms of 1 KB.  Two blocks fit on an SM (shared memory under 113 KB,
// at most 128 registers a thread), so one block's barriers and
// dequantization overlap the other's tensor-core work.

constexpr int kM_THREADS = 256;
constexpr int kM_BN = 128;   // output columns of a block (K2: of N; K7: of K)
constexpr int kM_ROW = 128;  // bytes of one swizzled row: 64 bf16
constexpr int kM_SZ = 512;   // a stage's scales and zero points (bf16)
constexpr int kM_WEAK = 32;  // oweight rows of one K2 weak-column step

// bytes of one stage: the activation tile [BM][64], the packed operand (K2:
// a group's words [g/8][128] int32 or 32 oweight rows [32][128] bf16; K7:
// 16 word rows [16][64] int32), scales and zero points; the B tile [128][64]
template <bool T7, int BM>
__host__ __device__ constexpr int stage_bytes() {
  return (BM * kM_ROW + (T7 ? 16 * 64 * 4 : 16 * kM_BN * 4) + kM_SZ + 1023) / 1024 * 1024;
}
constexpr int kM_BTILE = kM_BN * kM_ROW;
template <bool T7, int BM, int S>
__host__ __device__ constexpr int gemm_smem() {
  return 2 * kM_BTILE + S * stage_bytes<T7, BM>() + 1024;  // + the 1 KB alignment slack
}

struct GemmArgs {
  const bf16* res;    // K2: residual [M, N] or null
  const float* tail;  // K7: f32 [M, R] or null
  bf16* out;
  float* ws;  // K2: f32 [splits, M, N] partial tiles, or null
  int M, K, N, g, R;  // K2: R = 0 without oweight
};

// TMA descriptors of the operands: the activations (K2: x [M, K]; K7: g
// [M, N], 128-byte swizzled boxes of [BM][64]), the words seen as [g/8, G,
// N], scales and zero points [G, N], and K2's oweight [R, N]
struct GemmMaps {
  CUtensorMap a, w, s, z, o;
};

// byte offset of 16-byte chunk c (0..7) of row r of a swizzled tile
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)(r * kM_ROW + ((c ^ (r & 7)) << 4));
}

// TMA: a box of tensor map `map` at coordinates (c0, c1[, c2]) into shared
// memory at `dst`, completion counted in bytes on mbarrier `bar`
__device__ __forceinline__ void tma2(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                     uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma3(uint32_t dst, const CUtensorMap* map, int c0, int c1, int c2,
                                     uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// wgmma descriptor of a K-major, 128-byte-swizzled operand at shared address
// `addr`: 8-row atoms 1,024 bytes apart (SBO); LBO unused for this layout
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void gmma_arrive() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void gmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void gmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator accesses across the async MMAs
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x N] += A[64 x 16] * B[16 x N], bf16 in, f32 accumulators
template <int N>
struct Gmma;

template <>
struct Gmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
          "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Gmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};

// code * s, then + z, in f32 (mul then add, as the plain version rounds)
__device__ __forceinline__ float dq(uint32_t w, int p, float s, float z) {
  return __fadd_rn(__fmul_rn(nibble(w, p), s), z);
}

// two floats as a bf16 pair, the first at the lower address
__device__ __forceinline__ uint32_t pack_bf2(float lo, float hi) {
  const bf162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The steps of a K2 split: (groups of the split) x (g/64 steps of 64 K rows
// each), then, in the last split, ceil(R/32) weak-column steps of 32 rows.
struct K2Steps {
  int gb, nq, hpg;
};

// K2 step t, issued by one thread: the x tile [BM][64] (128-byte swizzled)
// and, at a group's first step, the group's words [g/8][128], scales and
// zero points [128] each; or, for a weak step, x[:, K-R+w0 ..] and oweight
// rows [32][128].  TMA zero-fills what lies past M, N, K or R.
template <int BM>
__device__ __forceinline__ void k2_issue(const GemmArgs& p, const GemmMaps& mp, const K2Steps& ks,
                                         int t, int m0, int n0, unsigned char* st, uint32_t bar) {
  const uint32_t A = smem_u32(st), W = A + BM * kM_ROW, SZ = W + 16 * kM_BN * 4;
  if (t < ks.nq) {
    const int gi = ks.gb + t / ks.hpg, h = t % ks.hpg;
    mbar_expect(bar, BM * kM_ROW + (h == 0 ? (p.g / 8) * kM_BN * 4 + 2 * kM_BN * 2 : 0));
    tma2(A, &mp.a, gi * p.g + h * 64, m0, bar);
    if (h == 0) {  // the group's second step reads them from this stage
      tma3(W, &mp.w, n0, gi, 0, bar);
      tma2(SZ, &mp.s, n0, gi, bar);
      tma2(SZ + kM_BN * 2, &mp.z, n0, gi, bar);
    }
  } else {
    const int w0 = (t - ks.nq) * kM_WEAK;
    mbar_expect(bar, BM * kM_ROW + kM_WEAK * kM_BN * 2);
    tma2(A, &mp.a, p.K - p.R + w0, m0, bar);
    tma2(W, &mp.o, n0, w0, bar);
  }
}

// K2's B tile of step t, K-major: row n holds the step's 64 K rows of
// column n.  Word row jj, nibble pl of the group is K row pl*(g/8) + jj, so
// a thread holding word rows jj0..jj0+7 of column n writes 8 consecutive K
// rows of a plane as one 16-byte chunk: at g = 128 a thread takes 8 word
// rows and the step's 4 planes, at g = 64 all 8 word rows and 4 of the 8
// planes.  A weak step copies oweight across (32 rows: chunks 0..3).
// The words of a group's second step (g = 128) are in the previous step's
// stage, `prev`: that stage is refilled only after this dequantization.
template <int BM>
__device__ __forceinline__ void k2_dequant(const GemmArgs& p, const K2Steps& ks, int t,
                                           const unsigned char* st, const unsigned char* prev,
                                           unsigned char* B, int tid) {
  if (t < ks.nq) {
    const unsigned char* W = (t % ks.hpg ? prev : st) + BM * kM_ROW;
    const int32_t* words = reinterpret_cast<const int32_t*>(W);
    const bf16* S = reinterpret_cast<const bf16*>(W + 16 * kM_BN * 4);
    const int hh = p.g / 8, h = t % ks.hpg, n = tid % kM_BN, r = tid / kM_BN;
    const int jj0 = hh == 16 ? r * 8 : 0, pl0 = hh == 16 ? 4 * h : 4 * r;
    uint32_t w[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) w[i] = (uint32_t)words[(jj0 + i) * kM_BN + n];
    const float s = bf2f(S[n]), z = bf2f(S[kM_BN + n]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int pl = pl0 + i, kr = pl * hh + jj0 - 64 * h;
      uint32_t v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = pack_bf2(dq(w[2 * j], pl, s, z), dq(w[2 * j + 1], pl, s, z));
      *reinterpret_cast<uint4*>(B + swz(n, kr >> 3)) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  } else {
    const uint16_t* O = reinterpret_cast<const uint16_t*>(st + BM * kM_ROW);  // [32][128] bf16
    for (int u = tid; u < kM_BN * kM_WEAK / 8; u += kM_THREADS) {
      const int n = u % kM_BN, c = u / kM_BN;
      uint32_t v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = (uint32_t)O[(c * 8 + 2 * j) * kM_BN + n] |
               ((uint32_t)O[(c * 8 + 2 * j + 1) * kM_BN + n] << 16);
      *reinterpret_cast<uint4*>(B + swz(n, c)) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

// K7 step t: contraction columns t*64 .. +64 of N.  The g tile [BM][64]
// (swizzled); the words of the block's 128 output columns k0.. (nb = 128/g
// groups of g/8 word rows) as [g/8][nb][64]; scales and zeros [nb][64].
template <int BM>
__device__ __forceinline__ void k7_issue(const GemmArgs& p, const GemmMaps& mp, int t, int m0,
                                         int k0, unsigned char* st, uint32_t bar) {
  const uint32_t A = smem_u32(st), W = A + BM * kM_ROW, SZ = W + 16 * 64 * 4;
  const int n0 = t * 64, nb = kM_BN / p.g, gi = k0 / p.g;
  mbar_expect(bar, BM * kM_ROW + 16 * 64 * 4 + 2 * nb * 64 * 2);
  tma2(A, &mp.a, n0, m0, bar);
  tma3(W, &mp.w, n0, gi, 0, bar);
  tma2(SZ, &mp.s, n0, gi, bar);
  tma2(SZ + kM_BN * 2, &mp.z, n0, gi, bar);
}

// K7's B tile, K-major in the contraction N: row k (the block's output
// column b*g + pl*(g/8) + jj) holds W_deq[k, n0 .. n0+64].  A thread takes 8
// consecutive words of one word row (8 contraction columns) and writes one
// 16-byte chunk for each of 4 planes.
template <int BM>
__device__ __forceinline__ void k7_dequant(const GemmArgs& p, const unsigned char* st,
                                           unsigned char* B, int tid) {
  const unsigned char* W = st + BM * kM_ROW;
  const bf16* S = reinterpret_cast<const bf16*>(W + 16 * 64 * 4);
  const int hh = p.g / 8, nb = kM_BN / p.g;
  const int n8 = tid & 7, ph = (tid >> 3) & 1, rr = tid >> 4, b = rr / hh, jj = rr - b * hh;
  const uint4* wv = reinterpret_cast<const uint4*>(W + ((jj * nb + b) * 64 + n8 * 8) * 4);
  const uint4 w0 = wv[0], w1 = wv[1];
  const uint32_t w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
  float s[8], z[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    s[i] = bf2f(S[b * 64 + n8 * 8 + i]);
    z[i] = bf2f(S[kM_BN + b * 64 + n8 * 8 + i]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int pl = ph * 4 + i, col = b * p.g + pl * hh + jj;
    uint32_t v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = pack_bf2(dq(w[2 * j], pl, s[2 * j], z[2 * j]),
                      dq(w[2 * j + 1], pl, s[2 * j + 1], z[2 * j + 1]));
    *reinterpret_cast<uint4*>(B + swz(col, n8)) = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// The main loop.  One thread issues step t's TMA loads S - 1 steps ahead
// into a ring of S stages, each with its mbarrier; all 256 threads
// dequantize step t + 1 into the other of two B tiles while the tensor cores
// run step t's wgmmas, which read the activations straight from the ring.
// K2's blockIdx.z is its split of the quantization groups (the weak columns
// go with the last).
template <bool T7, int BM, int S>
__global__ void __launch_bounds__(kM_THREADS, 2)
qmm_gemm_kernel(const GemmArgs p, const __grid_constant__ GemmMaps mp) {
  constexpr int NW = BM;  // columns of a warpgroup: 128 at BM = 128, 64 at BM = 64
  constexpr int NREG = NW / 2;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[S];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

  const int tid = threadIdx.x, wg = tid >> 7;
  const uint32_t a_off = BM == 128 ? wg * 64 * kM_ROW : 0;
  const uint32_t b_off = BM == 128 ? 0 : wg * 64 * kM_ROW;
  const int m0 = blockIdx.y * BM, c0 = blockIdx.x * kM_BN;

  int T;
  K2Steps ks{0, 0, 1};
  if (T7) {
    T = (p.N + 63) / 64;
  } else {
    const int n_groups = p.K / p.g, per = (n_groups + gridDim.z - 1) / gridDim.z;
    ks.gb = blockIdx.z * per;
    ks.hpg = p.g / 64;
    ks.nq = (min(n_groups, ks.gb + per) - ks.gb) * ks.hpg;
    T = ks.nq + (blockIdx.z == gridDim.z - 1 ? (p.R + kM_WEAK - 1) / kM_WEAK : 0);
  }

  auto stage = [&](int t) { return smem + 2 * kM_BTILE + (t % S) * stage_bytes<T7, BM>(); };
  auto btile = [&](int t) { return smem + (t & 1) * kM_BTILE; };
  auto bar = [&](int t) { return smem_u32(&full[t % S]); };
  auto issue = [&](int t) {
    if constexpr (T7) k7_issue<BM>(p, mp, t, m0, c0, stage(t), bar(t));
    else k2_issue<BM>(p, mp, ks, t, m0, c0, stage(t), bar(t));
  };
  auto dequant = [&](int t) {
    mbar_wait(bar(t), (t / S) & 1);
    if constexpr (T7) k7_dequant<BM>(p, stage(t), btile(t), tid);
    else k2_dequant<BM>(p, ks, t, stage(t), stage(t + S - 1), btile(t), tid);
    fence_async_proxy();
  };

  if (tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(smem_u32(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int s = 0; s < S - 1 && s < T; ++s) issue(s);

  float acc[NREG];
#pragma unroll
  for (int i = 0; i < NREG; ++i) acc[i] = 0.f;
  dequant(0);
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const int nkk = (T7 || t < ks.nq) ? 4 : kM_WEAK / 16;  // k16 slices of the step
    const uint32_t A = smem_u32(stage(t)), Bt = smem_u32(btile(t));
    fence_regs(acc);
    gmma_arrive();
    for (int kk = 0; kk < nkk; ++kk)
      Gmma<NW>::mma(acc, gmma_desc(A + a_off + kk * 32), gmma_desc(Bt + b_off + kk * 32));
    gmma_commit();
    fence_regs(acc);
    gmma_wait<1>();  // step t - 1's wgmmas are done: its stage and B tile are free
    fence_regs(acc);
    __syncthreads();
    if (tid == 0 && t + S - 1 < T) issue(t + S - 1);
    if (t + 1 < T) {
      dequant(t + 1);
      __syncthreads();
    }
  }
  gmma_wait<0>();
  fence_regs(acc);

  // accumulator i: row (warp % 4)*16 + lane/4 + 8*((i/2) & 1), column
  // 8*(i/4) + 2*(lane % 4) + (i & 1) of the warpgroup's 64 x NW tile
  const int lane = tid & 31;
  const int row0 = m0 + (BM == 128 ? wg * 64 : 0) + ((tid >> 5) & 3) * 16 + (lane >> 2);
  const int col0 = c0 + (BM == 128 ? 0 : wg * 64) + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int gm = row0 + 8 * r, col = col0 + 8 * j;
      float y0 = acc[4 * j + 2 * r], y1 = acc[4 * j + 2 * r + 1];
      if (T7) {
        if (gm < p.M && col < p.K) {
          const int kt = p.K - p.R;
          if (p.tail != nullptr) {
            if (col >= kt) y0 += p.tail[(size_t)gm * p.R + (col - kt)];
            if (col + 1 >= kt) y1 += p.tail[(size_t)gm * p.R + (col + 1 - kt)];
          }
          *reinterpret_cast<uint32_t*>(p.out + (size_t)gm * p.K + col) = pack_bf2(y0, y1);
        }
      } else if (gm < p.M && col < p.N) {
        const size_t o = (size_t)gm * p.N + col;
        if (p.ws != nullptr) {
          *reinterpret_cast<float2*>(p.ws + (size_t)blockIdx.z * p.M * p.N + o) =
              make_float2(y0, y1);
        } else {
          if (p.res != nullptr) {
            const float2 rv = __bfloat1622float2(*reinterpret_cast<const bf162*>(p.res + o));
            y0 += rv.x;
            y1 += rv.y;
          }
          *reinterpret_cast<uint32_t*>(p.out + o) = pack_bf2(y0, y1);
        }
      }
    }
  }
}

template <bool T7, int BM, int S>
cudaError_t launch_gemm(const GemmArgs& a, const GemmMaps& m, dim3 grid, cudaStream_t stream) {
  constexpr int smem = gemm_smem<T7, BM, S>();
  static bool opted = false;  // more than the default 48 KB of shared memory, once
  if (!opted) {
    cudaError_t e = cudaFuncSetAttribute(qmm_gemm_kernel<T7, BM, S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(qmm_gemm_kernel<T7, BM, S>,
                               cudaFuncAttributePreferredSharedMemoryCarveout, 100);
    if (e != cudaSuccess) return e;
    opted = true;
  }
  qmm_gemm_kernel<T7, BM, S><<<grid, kM_THREADS, smem, stream>>>(a, m);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime
// (no link against libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// a tensor map over `rank` dims (innermost first) with the row strides in
// bytes; `swizzle`: the 128-byte swizzle of the wgmma operands
bool tensor_map(CUtensorMap* m, CUtensorMapDataType type, int rank, const void* base,
                const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
                bool swizzle) {
  const EncodeTiled fn = encode_tiled();
  const cuuint32_t ones[3] = {1, 1, 1};
  return fn != nullptr &&
         fn(m, type, rank, const_cast<void*>(base), dims, strides, box, ones,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the maps of the packed operand shared by K2 and K7: words [g/8, G, N] in
// boxes of [g/8][nb][cols], scales and zero points [G, N] in boxes [nb][cols]
bool packed_maps(GemmMaps& mp, const void* qw, const void* sc, const void* sz, int K, int N,
                 int g, int cols, int nb) {
  const cuuint64_t G = K / g;
  const cuuint64_t wd[3] = {(cuuint64_t)N, G, (cuuint64_t)g / 8};
  const cuuint64_t ws[2] = {(cuuint64_t)N * 4, G * N * 4};
  const cuuint32_t wb[3] = {(cuuint32_t)cols, (cuuint32_t)nb, (cuuint32_t)g / 8};
  const cuuint64_t sd[2] = {(cuuint64_t)N, G};
  const cuuint64_t ss[1] = {(cuuint64_t)N * 2};
  const cuuint32_t sb[2] = {(cuuint32_t)cols, (cuuint32_t)nb};
  return tensor_map(&mp.w, CU_TENSOR_MAP_DATA_TYPE_INT32, 3, qw, wd, ws, wb, false) &&
         tensor_map(&mp.s, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, sc, sd, ss, sb, false) &&
         tensor_map(&mp.z, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, sz, sd, ss, sb, false);
}

// the activations [rows, cols] in swizzled boxes of [bm][64]
bool act_map(CUtensorMap* m, const void* a, int rows, int cols, int bm) {
  const cuuint64_t d[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t s[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t b[2] = {64, (cuuint32_t)bm};
  return tensor_map(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a, d, s, b, true);
}

// sum of the split-K partial tiles in split order, plus the residual
__global__ void qgemm_reduce_kernel(const float* __restrict__ ws, const bf16* __restrict__ res,
                                    bf16* __restrict__ out, size_t MN, int splits) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < MN;
       i += (size_t)gridDim.x * blockDim.x) {
    float y = 0.f;
    for (int s = 0; s < splits; ++s) y += ws[(size_t)s * MN + i];
    if (res != nullptr) y += bf2f(res[i]);
    out[i] = f2bf(y);
  }
}

}  // namespace

namespace {

// K1, K6 and K5: layer `layer` of the stacked buffers (0 for K5); group sizes
// 64 and 128, N a multiple of 4 (16-byte word loads)
int run_gemv(const void* x, const void* lnw, const void* qweight, const void* scales,
             const void* szeros, const void* ow, const void* bias, const void* res, void* out,
             int layer, int M, int K, int N, int g, int R, float eps, int one_offset,
             int bf16w, void* stream) {
  if (M < 1 || M > 8 || K <= 0 || N <= 0 || N % 4 || (g != 64 && g != 128) || K % g || R < 0 ||
      R > K || layer < 0)
    return (int)cudaErrorInvalidValue;
  const size_t n_groups = K / g;
  const GemvArgs a{static_cast<const bf16*>(x),
                   static_cast<const bf16*>(lnw),
                   static_cast<const int32_t*>(qweight) + (size_t)layer * (K / 8) * N,
                   static_cast<const bf16*>(scales) + (size_t)layer * n_groups * N,
                   static_cast<const bf16*>(szeros) + (size_t)layer * n_groups * N,
                   ow ? static_cast<const bf16*>(ow) + (size_t)layer * R * N : nullptr,
                   static_cast<const bf16*>(bias),
                   static_cast<const bf16*>(res),
                   static_cast<bf16*>(out),
                   M, K, N, ow ? R : 0, eps, one_offset, bf16w};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(g == 128 ? launch_gemv<4>(a, st) : launch_gemv<2>(a, st));
}

}  // namespace

// K1: one decoder stage of layer `layer` on the tensor-core template, with
// the RMS norm of x (lnw given) and the residual (res given)
#define QGEMV_STACKED_FUSED(NAME, BF16W)                                                        \
  extern "C" int NAME(const void* x, const void* lnw, const void* qweight, const void* scales,  \
                      const void* szeros, const void* ow, const void* res, void* out, int layer, \
                      int M, int K, int N, int g, int R, float eps, int one_offset,              \
                      void* stream) {                                                            \
    return run_gemv(x, lnw, qweight, scales, szeros, ow, nullptr, res, out, layer, M, K, N, g,  \
                    R, eps, one_offset, BF16W, stream);                                          \
  }
QGEMV_STACKED_FUSED(qgemv_stacked_fused, 0)
QGEMV_STACKED_FUSED(qgemv_stacked_fused_bf16w, 1)

// K6: the tensor-core decode matvec of layer `layer`, weak columns inside
#define QGEMV_STACKED(NAME, BF16W)                                                               \
  extern "C" int NAME(const void* x, const void* qweight, const void* scales, const void* szeros, \
                      const void* ow, void* out, int layer, int M, int K, int N, int g, int R,    \
                      void* stream) {                                                             \
    return run_gemv(x, nullptr, qweight, scales, szeros, ow, nullptr, nullptr, out, layer, M, K, \
                    N, g, R, 0.f, 0, BF16W, stream);                                              \
  }
QGEMV_STACKED(qgemv_stacked, 0)
QGEMV_STACKED(qgemv_stacked_bf16w, 1)

// K5: K6's kernel on one unstacked linear, with an optional bias [N] added
// before the one rounding
#define QGEMV(NAME, BF16W)                                                                       \
  extern "C" int NAME(const void* x, const void* qweight, const void* scales, const void* szeros, \
                      const void* ow, const void* bias, void* out, int M, int K, int N, int g,    \
                      int R, void* stream) {                                                      \
    return run_gemv(x, nullptr, qweight, scales, szeros, ow, bias, nullptr, out, 0, M, K, N, g,  \
                    R, 0.f, 0, BF16W, stream);                                                    \
  }
QGEMV(qgemv, 0)
QGEMV(qgemv_bf16w, 1)

// bm: rows of a block (64 or 128); ws: f32 [splits, M, N] scratch when
// splits > 1 (else unused)
extern "C" int qgemm(const void* x, const void* qweight, const void* scales, const void* szeros,
                     const void* ow, const void* res, void* out, void* ws, int M, int K, int N,
                     int g, int R, int bm, int splits, void* stream) {
  if (M < 1 || K <= 0 || N <= 0 || N % 8 || (g != 64 && g != 128) || K % g || R < 0 || R > K ||
      R % 8 || (bm != 64 && bm != 128) || (M + bm - 1) / bm > 65535 || splits < 1 ||
      splits > K / g || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* w = splits > 1 ? static_cast<float*>(ws) : nullptr;
  const int r = ow ? R : 0;
  GemmMaps mp;
  if (!act_map(&mp.a, x, M, K, bm) ||
      !packed_maps(mp, qweight, scales, szeros, K, N, g, kM_BN, 1))
    return (int)cudaErrorInvalidValue;
  mp.o = mp.s;  // read only by weak steps, which need r > 0
  if (r > 0) {
    const cuuint64_t d[2] = {(cuuint64_t)N, (cuuint64_t)r};
    const cuuint64_t s[1] = {(cuuint64_t)N * 2};
    const cuuint32_t b[2] = {kM_BN, kM_WEAK};
    if (!tensor_map(&mp.o, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ow, d, s, b, false))
      return (int)cudaErrorInvalidValue;
  }
  const GemmArgs a{static_cast<const bf16*>(res), nullptr, static_cast<bf16*>(out), w,
                   M, K, N, g, r};
  dim3 grid((N + kM_BN - 1) / kM_BN, (M + bm - 1) / bm, splits);
  cudaError_t e = bm == 128 ? launch_gemm<false, 128, 3>(a, mp, grid, st)
                            : launch_gemm<false, 64, 4>(a, mp, grid, st);
  if (e != cudaSuccess || w == nullptr) return (int)e;
  const size_t mn = (size_t)M * N;
  const int blocks = (int)((mn + 255) / 256 < 4096 ? (mn + 255) / 256 : 4096);
  qgemm_reduce_kernel<<<blocks, 256, 0, st>>>(w, static_cast<const bf16*>(res),
                                             static_cast<bf16*>(out), mn, splits);
  return (int)cudaGetLastError();
}

// tail: f32 [M, R] added to the last R columns of dx before rounding, or
// NULL; bm: rows of a block (64 or 128)
extern "C" int qgemm_t(const void* g, const void* qweight, const void* scales, const void* szeros,
                       const void* tail, void* out, int M, int K, int N, int group, int R, int bm,
                       void* stream) {
  if (M < 1 || (bm != 64 && bm != 128) || (M + bm - 1) / bm > 65535 || K <= 0 || N <= 0 ||
      N % 8 || (group != 64 && group != 128) || K % group || R < 0 || R > K ||
      (tail != nullptr && R == 0))
    return (int)cudaErrorInvalidValue;
  GemmMaps mp;
  if (!act_map(&mp.a, g, M, N, bm) ||
      !packed_maps(mp, qweight, scales, szeros, K, N, group, 64, kM_BN / group))
    return (int)cudaErrorInvalidValue;
  mp.o = mp.s;  // K7 has no oweight operand
  const GemmArgs a{nullptr, static_cast<const float*>(tail), static_cast<bf16*>(out), nullptr,
                   M, K, N, group, tail ? R : 0};
  dim3 grid((K + kM_BN - 1) / kM_BN, (M + bm - 1) / bm);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(bm == 128 ? launch_gemm<true, 128, 3>(a, mp, grid, st)
                         : launch_gemm<true, 64, 4>(a, mp, grid, st));
}
