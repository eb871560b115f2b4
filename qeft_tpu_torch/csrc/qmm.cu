// Packed INT4 (W4A16) products of the mixed-precision linear, for Hopper.
//
// qgemv_stacked_fused (K1) replaces qeft_tpu/ops/pallas_qmm.py::
//   qgemv_stacked_fused (_qmm_kernel_stacked_fused): one decoder stage for
//   1..8 token rows -- optional RMS norm of the raw residual, the INT4 matvec
//   over ALL K rows, the weak-column slab x[:, K-r:] @ oweight[l], optional
//   residual add -- reading layer `layer` of the stacked [L, ...] buffers in
//   place.
//   Bound: HBM bytes.  Per launch it must stream K*N/2 bytes of codes,
//   4*(K/g)*N bytes of scales and zero points and 2*r*N bytes of oweight;
//   its FLOPs are ~2*M*K*N, far below the bf16 tensor rate.
//   Design: one block per 32 output columns (one per lane), 16 warps that
//   split the word rows in units of up to 16 (one group at g = 128) and meet
//   in a shared-memory reduction -- a loop inside the block takes the place
//   of the TPU's sequential grid axis.  A warp issues all loads of a unit
//   (16 words a lane, plus the group's scale and zero point) before it uses
//   any of them.  Every block recomputes the row's RMS statistics itself
//   (blocks run in no order), writes the normalised row to shared memory in
//   packed-word order (word row r, nibble p at r*8 + p) so one 16-byte
//   broadcast load feeds the 8 nibbles of a word, and keeps per-group
//   activation sums so the zero points cost one FMA per group:
//   y = sum_g s_g*sum(h*code) + z_g*sum(h).  Warps read the
//   group-interleaved words directly (word row jj*G + gi), coalesced along N.
//   At one token row the kernel is bound by instruction issue as much as by
//   bytes, so the unpack is lean: one shift and one mask-or turn nibbles
//   (q, q+4) into the bf16 pair (128 + code), whose halves are exact floats
//   after one more logic op each, and the 128 folds into the zero-point term
//   (z_g - 128*s_g).
//   Wide rows: 8 rows of K bf16 values take 16*K bytes, more than the 227 KB
//   of shared memory a block may have once K passes about 13,000.  The row
//   is then staged in bands of whole quantization groups (each band a
//   contiguous K range of x, balanced over the fewest bands that fit); the
//   accumulators stay in registers from band to band, and the weights are
//   still read once.  K1's RMS statistics take one pass over the whole row
//   first, and the norm is applied as each band is staged.  Where the row
//   fits (Llama-2-7B's widths at every M) there is one band, as before.
//
// qgemv_stacked (K6) replaces pallas_qmm.py::qgemv_stacked
//   (_qmm_kernel_stacked): the INT4 matvec of layer `layer` of a stacked
//   linear plus its weak-column slab, with no norm and no residual -- the
//   linear of the ragged window forward that continuous batching and
//   speculative drafting run.  It is K1's kernel with the norm prologue and
//   the residual epilogue compiled out (template flag FUSED = false); same
//   bound, same design, same dequantization.
//
// qgemv (K5) replaces pallas_qmm.py::qgemv (_run_qmm at bm = 8): the INT4
//   matvec of one unstacked linear for 1..8 rows, the weak-column slab and an
//   optional bias [N], summed in f32 and rounded to bf16 once (the TPU path
//   adds slab and bias outside its kernel, rounding after each).  It is K6's
//   kernel at layer 0 with the bias added in the epilogue: the linear of
//   every OPT, Phi, Bloom and Falcon layer at decode.
//
// qgemm (K2) replaces pallas_qmm.py::qgemm (_run_qmm / _qmm_kernel): the
//   W4A16 GEMM for more rows (prefill, PPL windows), with the weak-column
//   slab and an optional residual in the epilogue instead of separate GEMMs.
//   Bound: at M = 64 still the weight bytes (as K1); at M in the thousands
//   the bf16 tensor-core rate.
//   Design: 64x64 output tile per block, 4 warps of 32x32 on bf16 WMMA
//   (mma.sync) with f32 accumulators; the K loop walks one quantization
//   group (g <= 128) per step: the group's g/8 word rows are dequantized
//   (code*scale + zero, rounded to bf16 exactly as the plain version does)
//   into a [g x 64] shared tile next to the [64 x g] activation slab.  The
//   next group's words and activations are loaded into registers while the
//   tensor cores work on the current one.  At prefill sizes the output tiles
//   alone are too few to fill 132 SMs, so the groups are split over
//   blockIdx.z (split-K); each split leaves an f32 partial tile and a second
//   pass sums them in split order (deterministic) with the residual.  The
//   weak columns follow, in the last split, as extra K steps that read
//   oweight directly.  No TMA/wgmma yet.
//
// qgemm_t (K7) replaces pallas_qmm.py::qgemm_t (_qmm_t_kernel): the training
//   backward dx = g @ W_deq^T from the packed codes, over ALL K rows (the
//   last r included: the forward's K2 runs over them too), plus an optional
//   f32 [M, r] addend (the weak-column product g @ oweight^T, computed
//   outside) on the last r columns before the one rounding to bf16.
//   Bound: at M = 2048 the bf16 tensor-core rate (2*M*K*N operations against
//   K*N/2 code bytes and 2*M*(N + K) activation bytes).
//   Design: one block per (64-row M tile, one quantization group of K
//   columns); a loop over N in chunks of 64 takes the place of the TPU's
//   sequential reduction axis, so nothing is carried between blocks.  Each
//   chunk dequantizes the group's g/8 word rows x 8 planes (mul then add, as
//   K2 and the plain version round) into a [g][64] shared tile -- word row
//   jj, nibble p is K column p*(g/8) + jj of the group, so the block writes
//   its g output columns in original K order and no inverse permutation is
//   needed -- and 4 warps of 16 rows run bf16 WMMA against the [64 x 64] g
//   tile, the W tile read column-major.  The next chunk's words and g tile
//   are loaded into registers during the current chunk's MMAs, as in K2.  At
//   M = 2048 this is 1,024 to 2,752 blocks; at small M the same grid runs
//   K/g blocks with the rows past M masked (few blocks: slow, not wrong).
//   No TMA/wgmma yet.

#include <mma.h>

#include "common.cuh"

using namespace qeft;

namespace {

// ----------------------------------------------------------------- K1

constexpr int kV_WARPS = 16;  // warps per block, splitting the word rows
constexpr int kV_THREADS = kV_WARPS * 32;
constexpr int kV_COLS = 32;   // output columns per block (one per lane)
constexpr int kV_CHUNK = 16;  // word rows per unit of work
constexpr uint32_t kBF16_128 = 0x43004300u;  // the bf16 pair (128, 128)

// index of K-row k in packed-word order (word row r, nibble p -> r*8 + p)
__device__ __forceinline__ int word_order(int k, int g, int hh, int n_groups) {
  const int gi = k / g;
  const int rem = k - gi * g;
  const int p = rem / hh;
  const int jj = rem - p * hh;
  return (jj * n_groups + gi) * 8 + p;
}

// the low and high bf16 halves of a 32-bit word, as floats
__device__ __forceinline__ float lo_bf16(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_bf16(uint32_t v) { return __uint_as_float(v & 0xFFFF0000u); }

// a unit of work: up to kV_CHUNK word rows of group gi of the staged band
// from row j0 (j0 = hh marks an empty unit), with the group's scale and zero
// point
struct Unit {
  uint32_t w[kV_CHUNK];
  float s, z;
  int gi, j0;
};

__device__ __forceinline__ void load_unit(Unit& u, int idx, int n_units, int cpg, int hh,
                                          int n_groups, int g0, int N, int n, bool col_ok,
                                          const int32_t* __restrict__ qw,
                                          const bf16* __restrict__ sc,
                                          const bf16* __restrict__ sz) {
  const bool ok = col_ok && idx < n_units;
  u.gi = ok ? idx / cpg : 0;
  u.j0 = ok ? (idx - u.gi * cpg) * kV_CHUNK : hh;
  const int gi = g0 + u.gi;  // the group's index in the whole row
  u.s = ok ? bf2f(sc[(size_t)gi * N + n]) : 0.f;
  u.z = ok ? bf2f(sz[(size_t)gi * N + n]) : 0.f;
#pragma unroll
  for (int t = 0; t < kV_CHUNK; ++t)
    u.w[t] = (u.j0 + t < hh)
                 ? (uint32_t)__ldg(qw + (size_t)((u.j0 + t) * n_groups + gi) * N + n)
                 : 0u;
}

// acc[m] += s * sum_k h[m,k] * code_k + z * sum_k h[m,k] over the unit's rows;
// hs holds rows of kb values in the staged band's word order, whose n_groups
// is the band's group count GB
template <int MT>
__device__ __forceinline__ void compute_unit(const Unit& u, float (&acc)[MT], const bf16* hs,
                                             const float* sumx, int kb, int n_groups, int hh) {
  if (u.j0 >= hh) return;
  float t0[MT], t1[MT];  // nibbles 0..3 and 4..7: two independent FMA chains
#pragma unroll
  for (int m = 0; m < MT; ++m) t0[m] = t1[m] = 0.f;
#pragma unroll
  for (int tt = 0; tt < kV_CHUNK; ++tt) {
    if (u.j0 + tt >= hh) break;
    const int base = ((u.j0 + tt) * n_groups + u.gi) * 8;
    uint32_t pr[4];  // bf16 pairs (128 + code_q, 128 + code_{q+4})
#pragma unroll
    for (int q = 0; q < 4; ++q) pr[q] = ((u.w[tt] >> (4 * q)) & 0x000F000Fu) | kBF16_128;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      // activations base..base+7 as four bf16 pairs: nibble q in pair q/2
      const uint4 hv = *reinterpret_cast<const uint4*>(hs + m * kb + base);
      const uint32_t hw[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t a = hw[q >> 1], b = hw[2 + (q >> 1)];
        const float ha = (q & 1) ? hi_bf16(a) : lo_bf16(a);
        const float hb = (q & 1) ? hi_bf16(b) : lo_bf16(b);
        t0[m] = fmaf(ha, lo_bf16(pr[q]), t0[m]);
        t1[m] = fmaf(hb, hi_bf16(pr[q]), t1[m]);
      }
    }
  }
  const float z = u.z - 128.f * u.s;  // the codes above carry +128
  const bool first = u.j0 == 0;      // the group's zero-point term, once
#pragma unroll
  for (int m = 0; m < MT; ++m)
    acc[m] += u.s * (t0[m] + t1[m]) + (first ? z * sumx[m * n_groups + u.gi] : 0.f);
}

// the K1 prologue's value of one activation: rounded to bf16 after the RMS
// scale, then multiplied by the norm weight (by 1 + w for gemma), as rms_norm
__device__ __forceinline__ bf16 normed(bf16 v, bf16 w, float rs, int one_offset) {
  const float nrm = bf2f(f2bf(bf2f(v) * rs));
  float wl = bf2f(w);
  if (one_offset) wl = bf2f(f2bf(1.f + wl));
  return f2bf(nrm * wl);
}

// FUSED = false compiles the norm prologue and the residual epilogue out (K6,
// K5).  The row is staged in bands of GB quantization groups (K columns
// g0*g .. (g0+GB)*g, contiguous in x): each band is written to shared memory
// in band-local packed-word order, its units are consumed, and the
// accumulators stay in registers across bands.  When the whole row fits,
// GB = K/g and there is one band.  The weak-column tail x[:, K-R:] is staged
// once, in its own buffer, before the bands.
template <int MT, bool FUSED>
__global__ void __launch_bounds__(kV_THREADS)
qgemv_fused_kernel(const bf16* __restrict__ x, const bf16* __restrict__ lnw,
                   const int32_t* __restrict__ qw, const bf16* __restrict__ sc,
                   const bf16* __restrict__ sz, const bf16* __restrict__ ow,
                   const bf16* __restrict__ res, const bf16* __restrict__ bias,
                   bf16* __restrict__ out, int K, int N, int g, int R, int GB, float eps,
                   int one_offset) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_groups = K / g;
  const int hh = g / 8;
  const int k8 = K / 8;
  const int kb = GB * g;                                        // K rows of one band
  bf16* hs = reinterpret_cast<bf16*>(smem);                     // [MT][kb]
  float* sumx = reinterpret_cast<float*>(hs + MT * kb);         // [MT][GB]
  float* part = sumx + MT * GB;                                 // [WARPS][MT][COLS]
  bf16* ts = reinterpret_cast<bf16*>(part + kV_WARPS * MT * kV_COLS);  // [MT][R]
  __shared__ float red[32];
  __shared__ float rstd[MT];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool norm = FUSED && lnw != nullptr;

  // 1. RMS statistics of each whole row (f32), as rms_norm computes them
  if (norm) {
    for (int m = 0; m < MT; ++m) {
      const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)m * K);
      float ss = 0.f;
      for (int c = tid; c < k8; c += kV_THREADS) {
        const uint4 v = __ldg(xr + c);
        const bf162* h2 = reinterpret_cast<const bf162*>(&v);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 f = __bfloat1622float2(h2[q]);
          ss = fmaf(f.x, f.x, ss);
          ss = fmaf(f.y, f.y, ss);
        }
      }
      ss = block_sum(ss, red);
      if (tid == 0) rstd[m] = rsqrtf(ss / (float)K + eps);
    }
    __syncthreads();
  }

  // 2. the (normalised) weak-column tail, in original order
  for (int idx = tid; idx < MT * R; idx += kV_THREADS) {
    const int m = idx / R, k = K - R + (idx - m * R);
    bf16 v = x[(size_t)m * K + k];
    if (norm) v = normed(v, lnw[k], rstd[m], one_offset);
    ts[idx] = v;
  }

  const int n = blockIdx.x * kV_COLS + lane;
  const bool col_ok = n < N;
  const int cpg = (hh + kV_CHUNK - 1) / kV_CHUNK;  // units per group
  float acc[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m] = 0.f;

  for (int g0 = 0; g0 < n_groups; g0 += GB) {
    const int gb = min(GB, n_groups - g0);  // groups of this band
    const int c8 = gb * hh;                 // 8-column chunks of a row in this band
    if (g0 > 0) __syncthreads();            // the previous band's units are done

    // 3. the band's (normalised) rows into shared memory, in band-local
    //    packed-word order; the value is rounded to bf16 before the weight
    //    multiply, like rms_norm
    for (int idx = tid; idx < MT * c8; idx += kV_THREADS) {
      const int m = idx / c8, c = idx - m * c8;
      const int kc = g0 * hh + c;  // the chunk's index in the whole row
      const uint4 xv = __ldg(reinterpret_cast<const uint4*>(x + (size_t)m * K) + kc);
      uint4 lv = make_uint4(0u, 0u, 0u, 0u);
      if (norm) lv = __ldg(reinterpret_cast<const uint4*>(lnw) + kc);
      const bf16* xe = reinterpret_cast<const bf16*>(&xv);
      const bf16* le = reinterpret_cast<const bf16*>(&lv);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        bf16 v = xe[e];
        if (norm) v = normed(v, le[e], rstd[m], one_offset);
        hs[m * kb + word_order(c * 8 + e, g, hh, GB)] = v;
      }
    }
    __syncthreads();

    // 4. per-group activation sums for the zero points
    for (int pr = warp; pr < MT * gb; pr += kV_WARPS) {
      const int m = pr / gb, gl = pr - m * gb;
      float s = 0.f;
      for (int t = lane; t < g; t += 32)
        s += bf2f(hs[m * kb + word_order(gl * g + t, g, hh, GB)]);
      s = warp_sum(s);
      if (lane == 0) sumx[m * GB + gl] = s;
    }
    __syncthreads();

    // 5. the band's matvec: warp `warp` takes units warp, warp + 16, ...
    const int n_units = gb * cpg;
    for (int idx = warp; idx < n_units; idx += kV_WARPS) {
      Unit u;
      load_unit(u, idx, n_units, cpg, hh, n_groups, g0, N, n, col_ok, qw, sc, sz);
      compute_unit<MT>(u, acc, hs, sumx, kb, GB, hh);
    }
  }

  // 6. weak columns: the staged tail; eight rows a warp in flight at once
  if (ow != nullptr && col_ok) {
    for (int i0 = warp; i0 < R; i0 += 8 * kV_WARPS) {
      float o[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int i = i0 + e * kV_WARPS;
        o[e] = i < R ? bf2f(ow[(size_t)i * N + n]) : 0.f;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int i = i0 + e * kV_WARPS;
        if (i >= R) break;
#pragma unroll
        for (int m = 0; m < MT; ++m) acc[m] += bf2f(ts[m * R + i]) * o[e];
      }
    }
  }

  // 7. reduce the warps' partial sums, add the residual or the bias, store bf16
#pragma unroll
  for (int m = 0; m < MT; ++m) part[(warp * MT + m) * kV_COLS + lane] = acc[m];
  __syncthreads();
  for (int idx = tid; idx < MT * kV_COLS; idx += kV_THREADS) {
    const int m = idx / kV_COLS, col = idx - m * kV_COLS;
    const int nn = blockIdx.x * kV_COLS + col;
    if (nn < N) {
      float y = 0.f;
      for (int wp = 0; wp < kV_WARPS; ++wp) y += part[(wp * MT + m) * kV_COLS + col];
      if (FUSED && res != nullptr) y += bf2f(res[(size_t)m * N + nn]);
      if (bias != nullptr) y += bf2f(bias[nn]);
      out[(size_t)m * N + nn] = f2bf(y);
    }
  }
}

// the most dynamic shared memory a block may ask for (227 KB on Hopper), or
// 0 if the device cannot be queried
inline int smem_optin() {
  static int bytes = 0;
  if (bytes == 0) {
    int dev = 0, v = 0;
    if (cudaGetDevice(&dev) == cudaSuccess &&
        cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) == cudaSuccess)
      bytes = v;
  }
  return bytes;
}

// groups per band: as many as fit under the limit (less 1 KB for the static
// shared memory), balanced over the fewest bands; 0 if not one group fits
template <int MT>
int band_groups(int n_groups, int g, int R, size_t& smem) {
  const size_t fixed = (size_t)kV_WARPS * MT * kV_COLS * sizeof(float) + (size_t)MT * R * sizeof(bf16);
  const size_t per_group = (size_t)MT * (g * sizeof(bf16) + sizeof(float));
  const size_t limit = (size_t)smem_optin();
  if (limit < 1024 + fixed + per_group) return 0;
  const int fit = (int)((limit - 1024 - fixed) / per_group);
  const int bands = (n_groups + fit - 1) / fit;
  const int gb = (n_groups + bands - 1) / bands;
  smem = fixed + per_group * gb;
  return gb;
}

template <int MT, bool FUSED>
cudaError_t launch_qgemv(const bf16* x, const bf16* lnw, const int32_t* qw, const bf16* sc,
                         const bf16* sz, const bf16* ow, const bf16* res, const bf16* bias,
                         bf16* out, int K, int N, int g, int R, float eps, int one_offset,
                         cudaStream_t stream) {
  size_t smem = 0;
  const int gb = band_groups<MT>(K / g, g, R, smem);
  if (gb == 0) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {  // opt in to more than the default 48 KB
    cudaError_t e = cudaFuncSetAttribute(qgemv_fused_kernel<MT, FUSED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((N + kV_COLS - 1) / kV_COLS);
  qgemv_fused_kernel<MT, FUSED><<<grid, kV_THREADS, smem, stream>>>(
      x, lnw, qw, sc, sz, ow, res, bias, out, K, N, g, R, gb, eps, one_offset);
  return cudaGetLastError();
}

// ----------------------------------------------------------------- K2

namespace wmma = nvcuda::wmma;

constexpr int kG_BM = 64, kG_BN = 64, kG_THREADS = 128;
constexpr int kG_MAXG = 128;                                   // largest group a step holds
constexpr int kG_A_PER = kG_BM * (kG_MAXG / 8) / kG_THREADS;   // 16-byte x chunks a thread
constexpr int kG_B_PER = (kG_MAXG / 8) * kG_BN / kG_THREADS;   // words a thread
constexpr int kG_LDB = kG_BN + 8;  // bf16 elements per shared B row
constexpr int kG_LDC = kG_BN + 4;  // floats per shared C row

__host__ __device__ inline size_t qgemm_smem(int g) {
  const size_t ab = (size_t)kG_BM * (g + 8) * 2 + (size_t)g * kG_LDB * 2;
  const size_t c = (size_t)kG_BM * kG_LDC * 4;
  return ab > c ? ab : c;
}

// one group's operands, held in registers between its load and its store
struct GroupRegs {
  uint4 a[kG_A_PER];
  uint32_t b[kG_B_PER];
  float s, z;
};

// x[m0:m0+64, kx0:kx0+g] as 16-byte chunks, zero past M and past `rows`
__device__ __forceinline__ void load_x(uint4 (&a)[kG_A_PER], const bf16* __restrict__ x, int m0,
                                       int M, int K, int kx0, int g, int rows, int tid) {
  const int chunks = g / 8;
#pragma unroll
  for (int i = 0; i < kG_A_PER; ++i) {
    const int idx = tid + i * kG_THREADS;
    const int m = idx / chunks, ch = idx - m * chunks;
    a[i] = make_uint4(0u, 0u, 0u, 0u);
    if (m < kG_BM && m0 + m < M && ch * 8 < rows)
      a[i] = __ldg(reinterpret_cast<const uint4*>(x + (size_t)(m0 + m) * K + kx0) + ch);
  }
}

__device__ __forceinline__ void store_x(const uint4 (&a)[kG_A_PER], bf16* As, int g, int tid) {
  const int chunks = g / 8, lda = g + 8;
#pragma unroll
  for (int i = 0; i < kG_A_PER; ++i) {
    const int idx = tid + i * kG_THREADS;
    const int m = idx / chunks, ch = idx - m * chunks;
    if (m < kG_BM) *reinterpret_cast<uint4*>(As + m * lda + ch * 8) = a[i];
  }
}

__device__ __forceinline__ void load_group(GroupRegs& r, const bf16* __restrict__ x,
                                           const int32_t* __restrict__ qw,
                                           const bf16* __restrict__ sc,
                                           const bf16* __restrict__ sz, int tile, int m0, int M,
                                           int K, int N, int g, int n, bool col_ok, int tid) {
  const int n_groups = K / g, hh = g / 8;
  load_x(r.a, x, m0, M, K, tile * g, g, g, tid);
#pragma unroll
  for (int i = 0; i < kG_B_PER; ++i) {
    const int jj = tid / kG_BN + i * (kG_THREADS / kG_BN);
    r.b[i] = (col_ok && jj < hh) ? (uint32_t)__ldg(qw + (size_t)(jj * n_groups + tile) * N + n)
                                 : 0u;
  }
  r.s = col_ok ? bf2f(sc[(size_t)tile * N + n]) : 0.f;
  r.z = col_ok ? bf2f(sz[(size_t)tile * N + n]) : 0.f;
}

// A as it is; B dequantized: word row jj, nibble p is K-row p*hh + jj of the group
__device__ __forceinline__ void store_group(const GroupRegs& r, bf16* As, bf16* Bs, int g, int c,
                                            int tid) {
  const int hh = g / 8;
  store_x(r.a, As, g, tid);
#pragma unroll
  for (int i = 0; i < kG_B_PER; ++i) {
    const int jj = tid / kG_BN + i * (kG_THREADS / kG_BN);
    if (jj >= hh) break;
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      // mul then add, not an FMA: the same rounding as the plain version
      const float wv = __fadd_rn(__fmul_rn(nibble(r.b[i], p), r.s), r.z);
      Bs[(p * hh + jj) * kG_LDB + c] = f2bf(wv);
    }
  }
}

using AccFrag = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ void mma_step(AccFrag (&acc)[2][2], const bf16* As, const bf16* Bs,
                                         int g, int wm, int wn) {
  const int lda = g + 8;
  for (int kk = 0; kk < g; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * lda + kk, lda);
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::load_matrix_sync(b[j], Bs + kk * kG_LDB + wn * 32 + j * 16, kG_LDB);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
  }
}

__global__ void __launch_bounds__(kG_THREADS)
qgemm_kernel(const bf16* __restrict__ x, const int32_t* __restrict__ qw,
             const bf16* __restrict__ sc, const bf16* __restrict__ sz,
             const bf16* __restrict__ ow, const bf16* __restrict__ res,
             bf16* __restrict__ out, float* __restrict__ ws, int M, int K, int N, int g, int R) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);    // [BM][g + 8]
  bf16* Bs = As + kG_BM * (g + 8);             // [g][BN + 8]
  float* Cs = reinterpret_cast<float*>(smem);  // [BM][BN + 4], after the K loop

  const int n_groups = K / g;
  const int m0 = blockIdx.y * kG_BM, n0 = blockIdx.x * kG_BN;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int c = tid % kG_BN;
  const int n = n0 + c;
  const bool col_ok = n < N;

  AccFrag acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  // this split's groups, the next one's loads in flight during each step
  const int per = (n_groups + gridDim.z - 1) / gridDim.z;
  const int t_begin = blockIdx.z * per;
  const int t_end = min(n_groups, t_begin + per);
  GroupRegs r;
  if (t_begin < t_end) load_group(r, x, qw, sc, sz, t_begin, m0, M, K, N, g, n, col_ok, tid);
  for (int tile = t_begin; tile < t_end; ++tile) {
    __syncthreads();  // the previous step's fragments are loaded
    store_group(r, As, Bs, g, c, tid);
    __syncthreads();
    if (tile + 1 < t_end) load_group(r, x, qw, sc, sz, tile + 1, m0, M, K, N, g, n, col_ok, tid);
    mma_step(acc, As, Bs, g, wm, wn);
  }

  // weak columns, in the last split: x[:, K-R:] against oweight, g rows a step
  if (ow != nullptr && blockIdx.z == gridDim.z - 1) {
    for (int t0 = 0; t0 < R; t0 += g) {
      const int rows = min(g, R - t0);
      uint4 a[kG_A_PER], b[kG_A_PER];
      load_x(a, x, m0, M, K, K - R + t0, g, rows, tid);
#pragma unroll
      for (int i = 0; i < kG_A_PER; ++i) {  // oweight rows as 8 chunks of 8 columns
        const int idx = tid + i * kG_THREADS;
        const int row = idx >> 3, ch = idx & 7;
        b[i] = make_uint4(0u, 0u, 0u, 0u);
        if (row < rows && n0 + ch * 8 < N)
          b[i] = __ldg(reinterpret_cast<const uint4*>(ow + (size_t)(t0 + row) * N + n0) + ch);
      }
      __syncthreads();
      store_x(a, As, g, tid);
#pragma unroll
      for (int i = 0; i < kG_A_PER; ++i) {
        const int idx = tid + i * kG_THREADS;
        const int row = idx >> 3, ch = idx & 7;
        if (row < g) *reinterpret_cast<uint4*>(Bs + row * kG_LDB + ch * 8) = b[i];
      }
      __syncthreads();
      mma_step(acc, As, Bs, g, wm, wn);
    }
  }

  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * kG_LDC + wn * 32 + j * 16, acc[i][j],
                              kG_LDC, wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < kG_BM * kG_BN; i += kG_THREADS) {
    const int m = i / kG_BN, cc = i - m * kG_BN;
    const int gm = m0 + m, gn = n0 + cc;
    if (gm < M && gn < N) {
      float y = Cs[m * kG_LDC + cc];
      if (ws != nullptr) {
        ws[((size_t)blockIdx.z * M + gm) * N + gn] = y;
      } else {
        if (res != nullptr) y += bf2f(res[(size_t)gm * N + gn]);
        out[(size_t)gm * N + gn] = f2bf(y);
      }
    }
  }
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

// ----------------------------------------------------------------- K7

constexpr int kT_BM = 64, kT_BN = 64, kT_THREADS = 128;  // M tile, N chunk, 4 warps
constexpr int kT_LD = kT_BN + 8;                          // bf16 per shared g / W row
constexpr int kT_A_PER = kT_BM * kT_BN / 8 / kT_THREADS;  // 16-byte g chunks a thread
constexpr int kT_B_PER = (kG_MAXG / 8) * kT_BN / kT_THREADS;  // words a thread

__host__ __device__ inline size_t qgemm_t_smem(int g) {
  const size_t ab = (size_t)(kT_BM + g) * kT_LD * 2;
  const size_t c = (size_t)kT_BM * (g + 4) * 4;
  return ab > c ? ab : c;
}

// one N chunk's operands, held in registers between its load and its store
struct ChunkRegs {
  uint4 a[kT_A_PER];
  uint32_t b[kT_B_PER];
  float s, z;
};

__device__ __forceinline__ void load_chunk(ChunkRegs& r, const bf16* __restrict__ gy,
                                           const int32_t* __restrict__ qw,
                                           const bf16* __restrict__ sc,
                                           const bf16* __restrict__ sz, int gi, int n0, int m0,
                                           int M, int N, int n_groups, int hh, int tid) {
#pragma unroll
  for (int i = 0; i < kT_A_PER; ++i) {  // g[m0:m0+64, n0:n0+64], zero past M and N
    const int idx = tid + i * kT_THREADS;
    const int m = idx >> 3, ch = idx & 7;
    r.a[i] = make_uint4(0u, 0u, 0u, 0u);
    if (m0 + m < M && n0 + ch * 8 < N)
      r.a[i] = __ldg(reinterpret_cast<const uint4*>(gy + (size_t)(m0 + m) * N + n0) + ch);
  }
  const int n = n0 + (tid & (kT_BN - 1));
  const bool col_ok = n < N;
#pragma unroll
  for (int i = 0; i < kT_B_PER; ++i) {
    const int jj = tid / kT_BN + i * (kT_THREADS / kT_BN);
    r.b[i] = (col_ok && jj < hh) ? (uint32_t)__ldg(qw + (size_t)(jj * n_groups + gi) * N + n)
                                 : 0u;
  }
  r.s = col_ok ? bf2f(sc[(size_t)gi * N + n]) : 0.f;
  r.z = col_ok ? bf2f(sz[(size_t)gi * N + n]) : 0.f;
}

// g as it is; W dequantized as [k][n]: word row jj, nibble p is K column p*hh + jj
__device__ __forceinline__ void store_chunk(const ChunkRegs& r, bf16* As, bf16* Bs, int hh,
                                            int tid) {
#pragma unroll
  for (int i = 0; i < kT_A_PER; ++i) {
    const int idx = tid + i * kT_THREADS;
    *reinterpret_cast<uint4*>(As + (idx >> 3) * kT_LD + (idx & 7) * 8) = r.a[i];
  }
  const int c = tid & (kT_BN - 1);
#pragma unroll
  for (int i = 0; i < kT_B_PER; ++i) {
    const int jj = tid / kT_BN + i * (kT_THREADS / kT_BN);
    if (jj >= hh) break;
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      // mul then add, not an FMA: the same rounding as K2 and the plain version
      const float wv = __fadd_rn(__fmul_rn(nibble(r.b[i], p), r.s), r.z);
      Bs[(p * hh + jj) * kT_LD + c] = f2bf(wv);
    }
  }
}

// FK = g / 16 accumulator fragments a warp: its 16 rows by the group's g columns
template <int FK>
__global__ void __launch_bounds__(kT_THREADS)
qgemm_t_kernel(const bf16* __restrict__ gy, const int32_t* __restrict__ qw,
               const bf16* __restrict__ sc, const bf16* __restrict__ sz,
               const float* __restrict__ tail, bf16* __restrict__ out, int M, int K, int N,
               int R) {
  constexpr int g = FK * 16, hh = g / 8, ldc = g + 4;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);    // [BM][BN + 8], the g tile
  bf16* Bs = As + kT_BM * kT_LD;               // [g][BN + 8], W^T column-major
  float* Cs = reinterpret_cast<float*>(smem);  // [BM][g + 4], after the N loop

  const int n_groups = K / g;
  const int gi = blockIdx.x, m0 = blockIdx.y * kT_BM;
  const int tid = threadIdx.x, warp = tid >> 5;

  AccFrag acc[FK];
#pragma unroll
  for (int j = 0; j < FK; ++j) wmma::fill_fragment(acc[j], 0.f);

  const int n_chunks = (N + kT_BN - 1) / kT_BN;
  ChunkRegs r;
  load_chunk(r, gy, qw, sc, sz, gi, 0, m0, M, N, n_groups, hh, tid);
  for (int ci = 0; ci < n_chunks; ++ci) {
    __syncthreads();  // the previous chunk's fragments are loaded
    store_chunk(r, As, Bs, hh, tid);
    __syncthreads();
    if (ci + 1 < n_chunks)
      load_chunk(r, gy, qw, sc, sz, gi, (ci + 1) * kT_BN, m0, M, N, n_groups, hh, tid);
#pragma unroll
    for (int kk = 0; kk < kT_BN; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, As + warp * 16 * kT_LD + kk, kT_LD);
#pragma unroll
      for (int j = 0; j < FK; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(b, Bs + j * 16 * kT_LD + kk, kT_LD);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
  }

  __syncthreads();
#pragma unroll
  for (int j = 0; j < FK; ++j)
    wmma::store_matrix_sync(Cs + warp * 16 * ldc + j * 16, acc[j], ldc, wmma::mem_row_major);
  __syncthreads();
  const int k_tail = K - R;
  for (int i = tid; i < kT_BM * g; i += kT_THREADS) {
    const int m = i / g, kc = i - m * g;
    const int gm = m0 + m, k = gi * g + kc;
    if (gm < M) {
      float y = Cs[m * ldc + kc];
      if (tail != nullptr && k >= k_tail) y += tail[(size_t)gm * R + (k - k_tail)];
      out[(size_t)gm * K + k] = f2bf(y);
    }
  }
}

template <int FK>
cudaError_t launch_qgemm_t(const bf16* gy, const int32_t* qw, const bf16* sc, const bf16* sz,
                           const float* tail, bf16* out, int M, int K, int N, int R,
                           cudaStream_t stream) {
  const size_t smem = qgemm_t_smem(FK * 16);
  if (smem > 48 * 1024) {  // opt in to more than the default 48 KB
    cudaError_t e = cudaFuncSetAttribute(qgemm_t_kernel<FK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(K / (FK * 16), (M + kT_BM - 1) / kT_BM);
  qgemm_t_kernel<FK><<<grid, kT_THREADS, smem, stream>>>(gy, qw, sc, sz, tail, out, M, K, N, R);
  return cudaGetLastError();
}

}  // namespace

namespace {

// layer `layer` of the stacked buffers (K1, K6; 0 for K5), then the MT instance
template <bool FUSED>
int run_qgemv(const void* x, const void* lnw, const void* qweight, const void* scales,
              const void* szeros, const void* ow, const void* res, const void* bias, void* out,
              int layer, int M, int K, int N, int g, int R, float eps, int one_offset,
              void* stream) {
  if (M < 1 || M > 8 || K <= 0 || N <= 0 || g <= 0 || g % 8 || K % g || R < 0 || R > K ||
      layer < 0)
    return (int)cudaErrorInvalidValue;
  const size_t n_groups = K / g;
  const int32_t* qw = static_cast<const int32_t*>(qweight) + (size_t)layer * (K / 8) * N;
  const bf16* sc = static_cast<const bf16*>(scales) + (size_t)layer * n_groups * N;
  const bf16* sz = static_cast<const bf16*>(szeros) + (size_t)layer * n_groups * N;
  const bf16* o = ow ? static_cast<const bf16*>(ow) + (size_t)layer * R * N : nullptr;
  const bf16* xx = static_cast<const bf16*>(x);
  const bf16* ln = static_cast<const bf16*>(lnw);
  const bf16* rs = static_cast<const bf16*>(res);
  const bf16* bs = static_cast<const bf16*>(bias);
  bf16* y = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (M) {
#define QEFT_CASE(MT)                                                                    \
  case MT:                                                                               \
    return (int)launch_qgemv<MT, FUSED>(xx, ln, qw, sc, sz, o, rs, bs, y, K, N, g, o ? R : 0, \
                                        eps, one_offset, st);
    QEFT_CASE(1) QEFT_CASE(2) QEFT_CASE(3) QEFT_CASE(4)
    QEFT_CASE(5) QEFT_CASE(6) QEFT_CASE(7) QEFT_CASE(8)
#undef QEFT_CASE
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int qgemv_stacked_fused(const void* x, const void* lnw, const void* qweight,
                                   const void* scales, const void* szeros, const void* ow,
                                   const void* res, void* out, int layer, int M, int K, int N,
                                   int g, int R, float eps, int one_offset, void* stream) {
  return run_qgemv<true>(x, lnw, qweight, scales, szeros, ow, res, nullptr, out, layer, M, K, N,
                         g, R, eps, one_offset, stream);
}

// K6: K1 without the norm and the residual; the weak columns stay inside
extern "C" int qgemv_stacked(const void* x, const void* qweight, const void* scales,
                             const void* szeros, const void* ow, void* out, int layer, int M,
                             int K, int N, int g, int R, void* stream) {
  return run_qgemv<false>(x, nullptr, qweight, scales, szeros, ow, nullptr, nullptr, out, layer,
                          M, K, N, g, R, 0.f, 0, stream);
}

// K5: K6's kernel on one unstacked linear, with an optional bias [N] added
// before the one rounding
extern "C" int qgemv(const void* x, const void* qweight, const void* scales, const void* szeros,
                     const void* ow, const void* bias, void* out, int M, int K, int N, int g,
                     int R, void* stream) {
  return run_qgemv<false>(x, nullptr, qweight, scales, szeros, ow, nullptr, bias, out, 0, M, K,
                          N, g, R, 0.f, 0, stream);
}

// ws: f32 [splits, M, N] scratch when splits > 1 (else unused)
extern "C" int qgemm(const void* x, const void* qweight, const void* scales, const void* szeros,
                     const void* ow, const void* res, void* out, void* ws, int M, int K, int N,
                     int g, int R, int splits, void* stream) {
  if (M < 1 || K <= 0 || N <= 0 || N % 8 || g <= 0 || g > kG_MAXG || g % 16 || K % g ||
      R < 0 || R > K || R % 8 || splits < 1 || splits > K / g || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = qgemm_smem(g);
  if (smem > 48 * 1024) {  // opt in to more than the default 48 KB
    cudaError_t e = cudaFuncSetAttribute(qgemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* w = splits > 1 ? static_cast<float*>(ws) : nullptr;
  dim3 grid((N + kG_BN - 1) / kG_BN, (M + kG_BM - 1) / kG_BM, splits);
  qgemm_kernel<<<grid, kG_THREADS, smem, st>>>(
      static_cast<const bf16*>(x), static_cast<const int32_t*>(qweight),
      static_cast<const bf16*>(scales), static_cast<const bf16*>(szeros),
      static_cast<const bf16*>(ow), static_cast<const bf16*>(res), static_cast<bf16*>(out), w, M,
      K, N, g, ow ? R : 0);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || w == nullptr) return (int)e;
  const size_t mn = (size_t)M * N;
  const int blocks = (int)((mn + 255) / 256 < 4096 ? (mn + 255) / 256 : 4096);
  qgemm_reduce_kernel<<<blocks, 256, 0, st>>>(w, static_cast<const bf16*>(res),
                                             static_cast<bf16*>(out), mn, splits);
  return (int)cudaGetLastError();
}

// tail: f32 [M, R] added to the last R columns of dx before rounding, or NULL
extern "C" int qgemm_t(const void* g, const void* qweight, const void* scales, const void* szeros,
                       const void* tail, void* out, int M, int K, int N, int group, int R,
                       void* stream) {
  if (M < 1 || (M + kT_BM - 1) / kT_BM > 65535 || K <= 0 || N <= 0 || N % 8 || group <= 0 ||
      group > kG_MAXG || group % 16 || K % group || R < 0 || R > K ||
      (tail != nullptr && R == 0))
    return (int)cudaErrorInvalidValue;
  const bf16* gy = static_cast<const bf16*>(g);
  const int32_t* qw = static_cast<const int32_t*>(qweight);
  const bf16* sc = static_cast<const bf16*>(scales);
  const bf16* sz = static_cast<const bf16*>(szeros);
  const float* tl = static_cast<const float*>(tail);
  bf16* y = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (group / 16) {
#define QEFT_CASE(FK) \
  case FK:            \
    return (int)launch_qgemm_t<FK>(gy, qw, sc, sz, tl, y, M, K, N, tl ? R : 0, st);
    QEFT_CASE(1) QEFT_CASE(2) QEFT_CASE(3) QEFT_CASE(4)
    QEFT_CASE(5) QEFT_CASE(6) QEFT_CASE(7) QEFT_CASE(8)
#undef QEFT_CASE
  }
  return (int)cudaErrorInvalidValue;
}
