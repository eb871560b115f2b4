// Causal window attention for prefill and full-sequence forwards, for Hopper.
//
// flash_window_attention (K3) replaces qeft_tpu/ops/pallas_flash.py::
//   flash_window_attention: q [B, S, H, D] (RoPE applied) against a
//   head-major K/V slab [B, Hkv, Sk, D]; query i sits at position pos + i
//   (pos a scalar or one per sequence) and attends keys <= pos + i; query
//   head h reads kv head h / (H / Hkv).  Output [B, S, H*D] bf16.
//   Bound: bytes (q, the valid K/V prefix and the output) at the prefill
//   and decode-window shapes; at long full windows the 4*S*Sk*D/2 causal
//   FLOPs, on the tensor cores.
//   Design: FlashAttention-2 on mma.sync.m16n8k16 (bf16 operands, f32
//   accumulators), each warp over 16 query rows of one (sequence, head) --
//   a tile that suits the widths the paths give (W = 1 engine rows, W = 5
//   verify windows, S = 64 prefill) where wgmma's 64-row tile would leave a
//   quarter of the blocks.  A block is one warp up to 128 rows a window
//   (S = 64: 128 blocks), four warps beyond, which share each chunk's copy.
//   The block walks key chunks of 64 in increasing order from key 0 up to
//   the last key its rows may see; chunk c + 2 is loaded with cp.async into
//   a two-stage ring (padded rows, conflict-free ldmatrix) while chunk c
//   computes, and keys past that last key are zero-filled, never read.  Per
//   chunk: S = Q.K^T (Q and K through ldmatrix), the causal mask, an online
//   softmax in registers (row max and sum across the quad that holds a row,
//   exp2 of scores prescaled by D^-0.5 * log2 e), P rounded to bf16 and
//   reused from the S registers as the A operand of P.V (V through
//   ldmatrix.trans), the accumulator rescaled once; one division by the row
//   sum at the end.  A warp computes every chunk its block walks, also one
//   wholly past its rows (a no-op, below): a branch around the chunk's MMAs
//   measured slower than the work it saves.
//   A row's result depends on its own q row and keys only: chunk
//   boundaries are fixed, a masked key has p = 0, and a chunk wholly past a
//   row's frontier leaves its (max, sum, accumulator) bit-unchanged (alpha =
//   exp2(0) = 1, or 0 while the max is still -inf) -- so a row's output
//   does not depend on S, on the other rows of its tile or on the grid (the
//   property speculative verification relies on).  A row that sees no key
//   (sum 0) writes zeros.

#include "common.cuh"

using namespace qeft;

namespace {

constexpr int kF_ROWS = 16;  // query rows a warp: one m16 tile
constexpr int kF_KEYS = 64;  // keys a chunk

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  // src-size 0 zero-fills the 16 bytes and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// a barrier of the block's NW warps
template <int NW>
__device__ __forceinline__ void block_sync() {
  if constexpr (NW == 1) __syncwarp();
  else __syncthreads();
}

template <int D, int NW>
constexpr int flash_smem() {
  return (NW * kF_ROWS + 4 * kF_KEYS) * (D + 8) * 2;  // Q, then K and V of two stages
}

// grid (ceil(S / (16 NW)), H, B), NW warps of 16 rows; pos_arr: [B] int64
// or NULL (pos0)
template <int D, int NW>
__global__ void __launch_bounds__(32 * NW)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const long long* __restrict__ pos_arr,
                 bf16* __restrict__ out, int S, int H, int Hkv, int Sk, int pos0) {
  constexpr int LD = D + 8;        // padded shared row (elements): ldmatrix rows in 8 banks
  constexpr int NT = kF_KEYS / 8;  // n8 key tiles of S
  constexpr int DT = D / 8;        // n8 dim tiles of the accumulator
  constexpr int CH = D / 8;        // 16-byte chunks a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + NW * kF_ROWS * LD;  // [2][64][LD]
  bf16* Vs = Ks + 2 * kF_KEYS * LD;  // [2][64][LD]

  const int b = blockIdx.z, h = blockIdx.y, ib = blockIdx.x * NW * kF_ROWS;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, gid = lane >> 2, t = lane & 3;
  const int i0 = ib + warp * kF_ROWS;  // this warp's first row
  const int pos = pos_arr != nullptr ? (int)pos_arr[b] : pos0;
  const int last_row = min(ib + NW * kF_ROWS, S) - 1;
  const int kend = min(pos + last_row, Sk - 1);  // the last key any row may see
  const int n_chunks = kend / kF_KEYS + 1;
  const bf16* kb = k + ((size_t)b * Hkv + hk) * Sk * D;
  const bf16* vb = v + ((size_t)b * Hkv + hk) * Sk * D;

  for (int idx = tid; idx < NW * kF_ROWS * CH; idx += 32 * NW) {
    const int r = idx / CH, c = idx - r * CH;
    const bool ok = ib + r < S;
    cp_async16(smem_u32(Qs + r * LD + c * 8),
               ok ? q + (((size_t)b * S + ib + r) * H + h) * D + c * 8 : q, ok);
  }
  auto load_chunk = [&](int ch, int st) {
    bf16* kd = Ks + st * kF_KEYS * LD;
    bf16* vd = Vs + st * kF_KEYS * LD;
    for (int idx = tid; idx < kF_KEYS * CH; idx += 32 * NW) {
      const int r = idx / CH, c = idx - r * CH, j = ch * kF_KEYS + r;
      const bool ok = j <= kend;
      const size_t off = ok ? (size_t)j * D + c * 8 : 0;
      cp_async16(smem_u32(kd + r * LD + c * 8), kb + off, ok);
      cp_async16(smem_u32(vd + r * LD + c * 8), vb + off, ok);
    }
  };
  load_chunk(0, 0);
  cp_async_commit();  // Q and chunk 0
  if (n_chunks > 1) load_chunk(1, 1);
  cp_async_commit();  // an empty group past the end keeps the count uniform

  const int r0 = i0 + gid, r1 = r0 + 8;  // this thread's rows
  const int lim0 = r0 < S ? min(pos + r0, Sk - 1) : -1;  // last key each may see
  const int lim1 = r1 < S ? min(pos + r1, Sk - 1) : -1;
  const float sl2 = rsqrtf((float)D) * 1.4426950408889634f;  // D^-0.5 * log2 e
  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;  // l: this thread's columns

  const uint32_t q_base = smem_u32(Qs + (warp * kF_ROWS + (lane & 15)) * LD + (lane >> 4) * 8);
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int st = ch & 1;
    cp_async_wait<1>();
    block_sync<NW>();
    const uint32_t k_base =
        smem_u32(Ks + (st * kF_KEYS + (lane >> 4) * 8 + (lane & 7)) * LD + ((lane >> 3) & 1) * 8);
    const uint32_t v_base =
        smem_u32(Vs + (st * kF_KEYS + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8);

    // S = Q K^T over the chunk: 16 rows x 64 keys
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, q_base + kk * 32);
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        uint32_t bk[4];
        ldmatrix_x4(bk, k_base + (nt * 8 * LD + kk * 16) * 2);
        mma_bf16(s[nt], a[0], a[1], a[2], a[3], bk[0], bk[1]);
        mma_bf16(s[nt + 1], a[0], a[1], a[2], a[3], bk[2], bk[3]);
      }
    }

    // the mask, and the online softmax of rows r0 (elements 0, 1) and r1 (2, 3)
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = ch * kF_KEYS + nt * 8 + 2 * t + e;
        s[nt][e] = j <= lim0 ? s[nt][e] * sl2 : -CUDART_INF_F;
        s[nt][e + 2] = j <= lim1 ? s[nt][e + 2] * sl2 : -CUDART_INF_F;
        mx0 = fmaxf(mx0, s[nt][e]);
        mx1 = fmaxf(mx1, s[nt][e + 2]);
      }
#pragma unroll
    for (int x = 1; x < 4; x <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float mu0 = mn0 == -CUDART_INF_F ? 0.f : mn0;  // no key yet: every p is 0
    const float mu1 = mn1 == -CUDART_INF_F ? 0.f : mn1;
    const float al0 = m0 == mn0 ? 1.f : exp2f(m0 - mu0);  // exactly 1 while the max holds
    const float al1 = m1 == mn1 ? 1.f : exp2f(m1 - mu1);
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[nt][e] = exp2f(s[nt][e] - mu0);
        s[nt][e + 2] = exp2f(s[nt][e + 2] - mu1);
        ps0 += s[nt][e];
        ps1 += s[nt][e + 2];
      }
    l0 = l0 * al0 + ps0;
    l1 = l1 * al1 + ps1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      o[dt][0] *= al0;
      o[dt][1] *= al0;
      o[dt][2] *= al1;
      o[dt][3] *= al1;
    }

    // O += P V: P in bf16 from the S registers, V through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < kF_KEYS / 16; ++kk) {
      const uint32_t a0 = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      const uint32_t a1 = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      const uint32_t a2 = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      const uint32_t a3 = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dt = 0; dt < DT; dt += 2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, v_base + (kk * 16 * LD + dt * 8) * 2);
        mma_bf16(o[dt], a0, a1, a2, a3, bv[0], bv[1]);
        mma_bf16(o[dt + 1], a0, a1, a2, a3, bv[2], bv[3]);
      }
    }
    block_sync<NW>();  // the stage is consumed
    if (ch + 2 < n_chunks) load_chunk(ch + 2, st);
    cp_async_commit();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int x = 1; x < 4; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f, inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int d = dt * 8 + 2 * t;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(out + (((size_t)b * S + r0) * H + h) * D + d) =
          pack_bf16(o[dt][0] * inv0, o[dt][1] * inv0);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(out + (((size_t)b * S + r1) * H + h) * D + d) =
          pack_bf16(o[dt][2] * inv1, o[dt][3] * inv1);
  }
}

template <int D, int NW>
cudaError_t launch_flash(const bf16* q, const bf16* k, const bf16* v, const long long* pos_arr,
                         bf16* out, int B, int S, int H, int Hkv, int Sk, int pos0,
                         cudaStream_t stream) {
  constexpr int smem = flash_smem<D, NW>();
  static bool attr = false;
  if (!attr) {
    cudaError_t e = cudaFuncSetAttribute(flash_mma_kernel<D, NW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  dim3 grid((S + NW * kF_ROWS - 1) / (NW * kF_ROWS), H, B);
  flash_mma_kernel<D, NW><<<grid, 32 * NW, smem, stream>>>(q, k, v, pos_arr, out, S, H, Hkv, Sk,
                                                           pos0);
  return cudaGetLastError();
}

// blocks of one warp up to 128 rows (the decode and verify windows, the
// prefill: enough blocks for the SMs), of 4 warps above, where 64 rows
// share each chunk's copy; a row's arithmetic is the same in both
template <int D>
cudaError_t launch_rows(const bf16* q, const bf16* k, const bf16* v, const long long* pos_arr,
                        bf16* out, int B, int S, int H, int Hkv, int Sk, int pos0,
                        cudaStream_t st) {
  return S <= 128 ? launch_flash<D, 1>(q, k, v, pos_arr, out, B, S, H, Hkv, Sk, pos0, st)
                  : launch_flash<D, 4>(q, k, v, pos_arr, out, B, S, H, Hkv, Sk, pos0, st);
}

}  // namespace

// pos_arr: NULL (every sequence at pos0) or B int64 positions on the device
extern "C" int flash_window_attention(const void* q, const void* k, const void* v,
                                      const void* pos_arr, void* out, int B, int S, int H,
                                      int Hkv, int Sk, int D, int pos0, void* stream) {
  if (B < 1 || S < 1 || H < 1 || Hkv < 1 || H % Hkv || Sk < 1 || pos0 < 0)
    return (int)cudaErrorInvalidValue;
  const bf16* qq = static_cast<const bf16*>(q);
  const bf16* kk = static_cast<const bf16*>(k);
  const bf16* vv = static_cast<const bf16*>(v);
  const long long* pa = static_cast<const long long*>(pos_arr);
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return (int)launch_rows<64>(qq, kk, vv, pa, o, B, S, H, Hkv, Sk, pos0, st);
    case 128: return (int)launch_rows<128>(qq, kk, vv, pa, o, B, S, H, Hkv, Sk, pos0, st);
    case 256: return (int)launch_rows<256>(qq, kk, vv, pa, o, B, S, H, Hkv, Sk, pos0, st);
  }
  return (int)cudaErrorInvalidValue;
}
