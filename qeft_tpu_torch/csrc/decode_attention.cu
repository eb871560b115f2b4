// Single-query decode attention over the static KV cache, for Hopper.
//
// decode_attention (K4) replaces the bf16 branch of qeft_tpu/ops/
//   pallas_attention.py::decode_attention: one query per (sequence, head)
//   attends cache slots 0..pos of a head-major cache [B, Hkv, S, D] that
//   already holds the current token; query head h reads kv head
//   h / (H / Hkv).  Output [B, H, D] bf16.
//   Bound: HBM bytes, 2*Hkv*(pos+1)*D*2 per sequence and layer -- only the
//   valid prefix, never the whole cache.
// decode_attention_int8 (K4q) replaces the int8 branch of the same
//   function: the cache holds int8 codes with one f32 scale per (slot, kv
//   head) vector, [B, Hkv, S].  The K scale multiplies each score after the
//   D^-0.5 scale; the running sum takes the unscaled probabilities and the V
//   scale multiplies them only for the P.V product, so no dequantized K/V
//   tile exists.  Bound: HBM bytes, 2*Hkv*(pos+1)*(D + 4) -- half of K4's.
// decode_attention_stacked (K8) replaces pallas_attention.py::
//   decode_attention_stacked: layer `layer` of the whole stacked cache
//   [L, B, Hkv, S, D] (bf16, or int8 codes with [L, B, Hkv, S] scales),
//   reached by pointer arithmetic -- no slice is copied.  Slot pos is stale,
//   so only slots < pos are read; the current token's unquantized k_new /
//   v_new [B, Hkv, D] enter as one extra softmax term that seeds the
//   combination (when pos == 0 it is the only term).  Bound: as K4 or K4q
//   over pos slots, plus the new vectors.
//
// Design, one template for the three: split-K ("flash decoding") in one
// launch.  The kC blocks that split one (sequence, kv head)'s valid keys form
// a thread block cluster; each takes a chunk of ceil(len / kC) keys rounded
// up to a multiple of 16, from key 0 -- the chunks depend on the valid length
// only, so a device position and a host int cut the same chunks.  A block
// serves the query heads of its kv head, up to 4 a pass (a GQA cache is read
// once at up to 4 query heads a kv head), and streams its chunk's K and V rows
// (and, int8, their scale ranges) into shared memory with one bulk
// asynchronous copy each per tile (a chunk of a head-major [S, D] slab is one
// contiguous range): tiles of 16 KB of K rows, one tile, or a two-stage ring
// where a chunk of the cache's capacity needs more, each stage completing on
// its mbarrier; thread 0 issues them first thing.  The arithmetic is f32 on
// CUDA cores from shared memory, as the JAX kernel computes in f32 (one query
// a head gives the tensor cores nothing): the score pass gives each key D/16
// lanes of 16 elements (neighbouring lanes on neighbouring 16-byte chunks,
// conflict-free; each lane's q elements in registers; int8 codes turned
// into floats by a byte permute and one add), an online softmax carries
// (max, sum) per head from tile to tile, and P.V gives each thread 8 dims of
// every NG-th key.  Each block pushes its (max, sum, unnormalised
// accumulator) into its slot of rank 0's shared memory (distributed shared
// memory stores), and rank 0 combines the slots in rank order, seeded with
// K8's new-token term, and writes the output: two cluster barriers, split
// into arrive and wait, no remote load.  A block whose chunk is empty (len <
// kC * 16; K8 at pos 0) takes part in every barrier, with max -inf and sum
// 0.  No scratch, no second kernel, and every call sums in the same order
// (bit-identical calls).
//
// The grouped-head path (decode_group_kernel): K4 where a kv head serves
// rep = H / Hkv >= kGroupMin query heads (Falcon-7b's 71 over 1, Falcon-40b's
// 128 over 8).  Passes of at most 4 heads would stream each chunk rep / HB
// times (71 times: 71 is prime) with the tensor cores idle; the group's q
// rows are instead the M dimension of mma.sync.m16n8k16 (71 rows: five m16
// tiles, a warp each, padded with zero rows), and K and V stream once.  One
// block a (sequence, kv head, split) -- blocks along z where rep exceeds a
// block's 128 rows (64 at D = 256) -- the splits of one (sequence, kv head)
// a cluster, as many as cover the card's SMs once, up to kGroupSplits (B = 8
// groups of Falcon-7b: 16 splits, 128 blocks); the chunks are split_chunk's
// over that number, so again a function of the valid length alone.  Warp 0
// feeds a two-stage ring on mbarriers with one bulk copy a K or V row, into
// rows padded by 16 bytes so that ldmatrix reads them without bank
// conflicts.  Each warp runs FlashAttention-2 over its 16 rows as K3 does:
// S = Q.K^T on the tensor cores (q as A fragments in registers, K through
// ldmatrix; exact bf16 products, f32 sums), the online softmax in registers
// (exp2 of scores prescaled by D^-0.5 log2 e, row max and sum across a
// quad), P rounded to bf16 straight from the S registers as the A operand
// of P.V (V through ldmatrix.trans, keys past the chunk's end read as 0).
// The block's (max, sum, accumulator) go into its own shared memory, over
// the consumed ring; after a cluster barrier each rank reads every split's
// rows through distributed shared memory for its share of the output and
// combines them in rank order; a second barrier keeps every block's shared
// memory alive until then.  No scratch, no second kernel, bit-identical
// calls.  Bound: HBM bytes, as K4 -- the tensor cores do 4 * 80 * D flops a
// key and group (Falcon-7b), far under the card's ridge.
//
// The latent path (decode_latent_attention, decode_latent_kernel) has no
// counterpart in the JAX package: DeepSeek-V2's multi-head latent attention
// at decode.  16 query heads ([q_lat, q_pe], 576 wide) attend one cached
// 576-wide row a token (the normalised latent and the roped shared key);
// the values are the rows' first 512 dims.  Split-K over the valid slots
// as K4, a cluster of up to 8 splits a sequence (enough to cover the SMs
// about twice); warp 0 streams each split's rows once through a two-stage
// ring of padded rows, one bulk copy a row.  The 16 heads are one m16
// tile: each of 4 warps computes S = Q.K^T for 8 keys of a 32-key tile
// over all 576 dims (q and K through ldmatrix, f32 sums), the online
// softmax runs a warp per 4 heads (P rounded to bf16, the sum of the f32
// values), and each warp accumulates O += P.V for its 128 of the 512
// value dims (V through ldmatrix.trans of the same rows).  Splits combine
// in rank order over distributed shared memory as the group path does.
// Bound: HBM bytes, B * (pos + 1) * 1152 a layer.
//
// Position on the device (pos_dev, an int64 scalar; NULL: the host int
// pos).  A decode step captured once as a CUDA graph and replayed at every
// position reads its position from the device; the grid is the same at
// every position, and each block derives the chunk from the valid length it
// reads -- so the output is bit-identical to the host-int launch at the same
// position.  The range check of such a position is the caller's (once per
// loop); the kernel clamps it into the cache, so a bad one reads no memory
// outside.

#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

using namespace qeft;

namespace {

namespace cg = cooperative_groups;

constexpr int kC = 8;          // blocks of a cluster: the splits of one (sequence, kv head)
constexpr int kAlign = 16;     // chunks start at multiples of 16 keys
constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxStages = 2;  // tiles of the ring

// element type of the cache: bf16, or int8 codes when Q8
template <bool Q8>
using kv_t = typename std::conditional<Q8, int8_t, bf16>::type;

// keys a split of `splits`: ceil(len / splits), rounded up to a multiple of
// kAlign (qeft_tpu_torch/ops/attention.py:split_chunk is its twin)
__host__ __device__ constexpr int split_chunk(int len, int splits = kC) {
  return ((len + splits - 1) / splits + kAlign - 1) / kAlign * kAlign;
}

struct Args {
  const bf16* q;            // [B, H, D]
  const void* k;            // [B, Hkv, S, D] of the layer
  const void* v;
  const float* ks;          // [B, Hkv, S], int8 only
  const float* vs;
  const bf16* k_new;        // [B, Hkv, D], K8 only
  const bf16* v_new;
  bf16* out;                // [B, H, D]
  const long long* pos_dev;  // NULL: `len` holds
  int len_off;              // valid keys = *pos_dev + len_off
  int H, Hkv, S, len;
  int stages;               // tiles of the ring: 1, or kMaxStages
};

// shared memory of one block, in bytes from a 16-byte aligned base: the
// fixed part, then the ring of `stages` tiles
template <int D, bool Q8, int HB>
struct Smem {
  static constexpr int KT = 16384 / (D * (int)sizeof(kv_t<Q8>));  // keys a tile: 16 KB of K rows
  static constexpr int ROWS = KT * D * (int)sizeof(kv_t<Q8>);
  static constexpr int SCALES = Q8 ? KT * 4 : 0;
  static constexpr int STAGE = 2 * ROWS + 2 * SCALES;         // K, V, K scales, V scales
  static constexpr int RED = 0;                               // [kWarps][HB][D] f32
  static constexpr int ACC = RED + kWarps * HB * D * 4;       // [kC][HB][D] f32: the splits'
  static constexpr int P = ACC + kC * HB * D * 4;             // [HB][KT] f32 scores, probs
  static constexpr int Q = P + HB * KT * 4;                   // [HB][D] f32
  static constexpr int ML = Q + HB * D * 4;                   // m, l, alpha, s_new: [4][HB]
  static constexpr int CML = ML + 4 * HB * 4;                 // the splits' m, l: [2][kC][HB]
  static constexpr int BAR = (CML + 2 * kC * HB * 4 + 7) / 8 * 8;  // kMaxStages mbarriers
  static constexpr int RING = (BAR + 8 * kMaxStages + 15) / 16 * 16;
  static int bytes(int stages) { return RING + stages * STAGE; }
  // one tile where every chunk of an S-slot cache fits one, else a ring
  static int stages_for(int S) { return split_chunk(S) > KT ? kMaxStages : 1; }
};

// the 4 int8 of a word as exact floats: each biased byte (c + 128) is
// permuted into the mantissa of 2^23, and 2^23 + 128 subtracted (no
// integer-to-float conversion, which issues at a fraction of an FADD's rate)
__device__ __forceinline__ void i8x4(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + i)) - 8388736.f;
}

// 8 bf16 of a 16-byte word as floats
__device__ __forceinline__ void bf16x8(const uint4& raw, float* f) {
  const bf162* p = reinterpret_cast<const bf162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 x = __bfloat1622float2(p[e]);
    f[2 * e] = x.x;
    f[2 * e + 1] = x.y;
  }
}

// a lane's 16 elements of a row in shared memory as floats: bf16 16-byte
// chunks c0 and c1, or the int8 chunk c0
template <bool Q8>
__device__ __forceinline__ void row16(const kv_t<Q8>* row, int c0, int c1, float (&f)[16]) {
  if constexpr (Q8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(row + 16 * c0);
    i8x4(raw.x, f);
    i8x4(raw.y, f + 4);
    i8x4(raw.z, f + 8);
    i8x4(raw.w, f + 12);
  } else {
    bf16x8(*reinterpret_cast<const uint4*>(row + 8 * c0), f);
    bf16x8(*reinterpret_cast<const uint4*>(row + 8 * c1), f + 8);
  }
}

// dims d0..d0+7 of a V row from shared memory as floats
template <bool Q8>
__device__ __forceinline__ void row8(const kv_t<Q8>* row, int d0, float (&f)[8]) {
  if constexpr (Q8) {
    const uint2 raw = *reinterpret_cast<const uint2*>(row + d0);
    i8x4(raw.x, f);
    i8x4(raw.y, f + 4);
  } else {
    bf16x8(*reinterpret_cast<const uint4*>(row + d0), f);
  }
}

// barrier.cluster in two halves: the arrival (releasing this thread's
// writes, or relaxed) and the wait for every thread of the cluster
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// q . k over a lane's 16 elements, four partial sums
__device__ __forceinline__ float dot16(const float (&q)[16], const float (&k)[16]) {
  float s[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) s[i] = q[i] * k[i];
#pragma unroll
  for (int e = 4; e < 16; ++e) s[e & 3] = fmaf(q[e], k[e], s[e & 3]);
  return (s[0] + s[1]) + (s[2] + s[3]);
}

// grid (kC, B * Hkv), clusters of kC along x; HB query heads a pass (a
// divisor of H / Hkv, at most 4: their q slices stay in registers)
template <int D, bool Q8, int HB>
__global__ void __launch_bounds__(kThreads) decode_cluster_kernel(const Args a) {
  using T = kv_t<Q8>;
  using L = Smem<D, Q8, HB>;
  constexpr int KT = L::KT;
  constexpr int LPK = D / 16;          // lanes a key in the score pass
  constexpr int KPP = kThreads / LPK;  // keys a score pass
  constexpr int TPR = D / 8;           // threads a row in P.V
  constexpr int NG = kThreads / TPR;   // key strides of P.V
  constexpr int KPL = KT / 32;         // keys a lane in the softmax

  extern __shared__ __align__(16) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem + L::RED);
  float* cacc = reinterpret_cast<float*>(smem + L::ACC);
  float* sp = reinterpret_cast<float*>(smem + L::P);
  float* qs = reinterpret_cast<float*>(smem + L::Q);
  float* m_run = reinterpret_cast<float*>(smem + L::ML);
  float* l_run = m_run + HB;
  float* alpha = l_run + HB;
  float* s_new = alpha + HB;
  float* cm = reinterpret_cast<float*>(smem + L::CML);
  float* cl = cm + kC * HB;
  const uint32_t bar0 = smem_u32(smem + L::BAR);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int head = blockIdx.y;  // b * Hkv + kv head
  const int b = head / a.Hkv, hk = head - b * a.Hkv;
  const int rep = a.H / a.Hkv, stages = a.stages;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float scale = rsqrtf((float)D);

  const int len = a.pos_dev != nullptr
                      ? (int)min(max(*a.pos_dev + a.len_off, 0LL), (long long)a.S)
                      : a.len;
  const int chunk = split_chunk(len);
  const int k0 = min(rank * chunk, len), k1 = min(k0 + chunk, len);
  const int n_tiles = (k1 - k0 + KT - 1) / KT;
  const int steps = (rep / HB) * n_tiles;  // a pass over the chunk for each HB heads

  const T* kg = static_cast<const T*>(a.k) + (size_t)head * a.S * D;
  const T* vg = static_cast<const T*>(a.v) + (size_t)head * a.S * D;
  const float* ksg = Q8 ? a.ks + (size_t)head * a.S : nullptr;
  const float* vsg = Q8 ? a.vs + (size_t)head * a.S : nullptr;

  auto stage = [&](int st) { return smem + L::RING + st * L::STAGE; };
  // scales of keys past the bulk-copied multiple of 4 (or of a range that
  // is not 16-byte aligned) come from global memory
  auto bulk_scales = [&](int j0, int n) {
    if constexpr (!Q8) return 0;
    const uintptr_t at = reinterpret_cast<uintptr_t>(ksg + j0) | reinterpret_cast<uintptr_t>(vsg + j0);
    return (at & 15) ? 0 : (n & ~3);
  };
  auto issue = [&](int step) {
    const int st = step % stages, j0 = k0 + (step % n_tiles) * KT, n = min(KT, k1 - j0);
    const int n4 = bulk_scales(j0, n);
    const uint32_t row_bytes = (uint32_t)n * D * sizeof(T), bar = bar0 + 8 * st;
    unsigned char* s = stage(st);
    mbar_expect(bar, (int)(2 * row_bytes + 8u * n4));
    bulk_load(smem_u32(s), kg + (size_t)j0 * D, row_bytes, bar);
    bulk_load(smem_u32(s + L::ROWS), vg + (size_t)j0 * D, row_bytes, bar);
    if (n4 > 0) {
      bulk_load(smem_u32(s + 2 * L::ROWS), ksg + j0, 4u * n4, bar);
      bulk_load(smem_u32(s + 2 * L::ROWS + L::SCALES), vsg + j0, 4u * n4, bar);
    }
  };

  // the ring's copies leave first; the barrier below publishes the
  // mbarriers.  The cluster's first phase completes once every block runs:
  // then rank 0's shared memory may be written.
  cluster_arrive_relaxed();
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(bar0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < stages && s < steps; ++s) issue(s);
  }

  const int grp = tid / LPK, li = tid - grp * LPK;    // score pass: key, lane of the key
  const int g = tid / TPR, d0 = (tid - g * TPR) * 8;  // P.V: key stride, dims
  // the score pass's elements of a row: bf16 chunks c0, c1 (D = 64: odd
  // keys -- odd lane groups, KPP being even -- read their upper half
  // first, so that a quarter warp covers 128 contiguous bytes), int8 chunk c0
  const int swap = (!Q8 && D == 64) ? (grp & 1) * LPK : 0;
  const int c0 = Q8 ? li : (li + swap) % (2 * LPK), c1 = (li + LPK + swap) % (2 * LPK);
  const int e0 = Q8 ? 16 * c0 : 8 * c0, e1 = Q8 ? 16 * c0 + 8 : 8 * c1;

  for (int hc = 0; hc < rep / HB; ++hc) {
    const int h0 = hk * rep + hc * HB;  // the first query head of the pass
    for (int i = tid; i < HB * D; i += kThreads) qs[i] = bf2f(a.q[((size_t)b * a.H + h0) * D + i]);
    if (tid < HB) {
      m_run[tid] = -CUDART_INF_F;
      l_run[tid] = 0.f;
    }
    float acc[HB][8];
#pragma unroll
    for (int hh = 0; hh < HB; ++hh)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[hh][e] = 0.f;
    __syncthreads();
    float qv[HB][16];  // this lane's q elements of each head
#pragma unroll
    for (int hh = 0; hh < HB; ++hh)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        qv[hh][e] = qs[hh * D + e0 + e];
        qv[hh][8 + e] = qs[hh * D + e1 + e];
      }

    for (int t = 0; t < n_tiles; ++t) {
      const int step = hc * n_tiles + t, st = step % stages;
      const int j0 = k0 + t * KT, n = min(KT, k1 - j0);
      const int n4 = bulk_scales(j0, n);
      const T* Kt = reinterpret_cast<const T*>(stage(st));
      const T* Vt = reinterpret_cast<const T*>(stage(st) + L::ROWS);
      const float* kst = reinterpret_cast<const float*>(stage(st) + 2 * L::ROWS);
      const float* vst = kst + KT;
      mbar_wait(bar0 + 8 * st, (step / stages) & 1);

      // scores: D/16 lanes a key, 16 elements each, f32; the passes up to
      // the tile's last key
#pragma unroll
      for (int p = 0; p < KT / KPP; ++p) {
        if (p * KPP >= n) break;
        const int j = p * KPP + grp;
        float kf[16];
        row16<Q8>(Kt + (size_t)j * D, c0, c1, kf);
        float ksc = 1.f;
        if constexpr (Q8) {
          if (li == 0 && j < n) ksc = j < n4 ? kst[j] : __ldg(ksg + j0 + j);
        }
#pragma unroll
        for (int hh = 0; hh < HB; ++hh) {
          float dot = dot16(qv[hh], kf);
#pragma unroll
          for (int o = LPK / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
          if (li == 0) sp[hh * KT + j] = j < n ? dot * scale * ksc : -CUDART_INF_F;
        }
      }
      __syncthreads();

      // online softmax over the tile: one warp a head
      for (int hh = warp; hh < HB; hh += kWarps) {
        float s[KPL], mt = -CUDART_INF_F;
#pragma unroll
        for (int e = 0; e < KPL; ++e) {
          s[e] = e * 32 + lane < n ? sp[hh * KT + e * 32 + lane] : -CUDART_INF_F;
          mt = fmaxf(mt, s[e]);
        }
        mt = warp_max(mt);
        const float mo = m_run[hh], mn = fmaxf(mo, mt);  // finite: key j0 is valid
        const float al = mo == -CUDART_INF_F ? 0.f : expf(mo - mn);
        float ps = 0.f;
#pragma unroll
        for (int e = 0; e < KPL; ++e) {
          const int j = e * 32 + lane;
          const float p = j < n ? expf(s[e] - mn) : 0.f;
          ps += p;
          float pv = p;  // the probability as the P.V product takes it
          if constexpr (Q8) {
            if (j < n) pv *= j < n4 ? vst[j] : __ldg(vsg + j0 + j);
          }
          sp[hh * KT + j] = pv;
        }
        ps = warp_sum(ps);  // unscaled
        if (lane == 0) {
          m_run[hh] = mn;
          l_run[hh] = l_run[hh] * al + ps;
          alpha[hh] = al;
        }
      }
      __syncthreads();

      // P.V: 8 dims of every NG-th key, four keys' loads in flight
#pragma unroll
      for (int hh = 0; hh < HB; ++hh) {
        const float al = alpha[hh];
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[hh][e] *= al;
      }
      for (int j = g; j < n; j += 4 * NG) {
        float vf[4][8];
#pragma unroll
        for (int u = 0; u < 4; ++u) row8<Q8>(Vt + (size_t)min(j + u * NG, KT - 1) * D, d0, vf[u]);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (j + u * NG >= n) break;
#pragma unroll
          for (int hh = 0; hh < HB; ++hh) {
            const float p = sp[hh * KT + j + u * NG];
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[hh][e] = fmaf(p, vf[u][e], acc[hh][e]);
          }
        }
      }
      __syncthreads();  // the stage, the probabilities and alpha are consumed
      if (tid == 0 && step + stages < steps) {
        fence_async_proxy();
        issue(step + stages);
      }
    }

    // the block's accumulator: the key strides summed in order, within a
    // warp by shuffles, then across the warps
#pragma unroll
    for (int hh = 0; hh < HB; ++hh)
#pragma unroll
      for (int e = 0; e < 8; ++e)
#pragma unroll
        for (int o = TPR; o < 32; o <<= 1) acc[hh][e] += __shfl_xor_sync(0xffffffffu, acc[hh][e], o);
    if (lane < TPR) {
#pragma unroll
      for (int hh = 0; hh < HB; ++hh) {
        float4* r = reinterpret_cast<float4*>(red + ((size_t)warp * HB + hh) * D + d0);
        r[0] = make_float4(acc[hh][0], acc[hh][1], acc[hh][2], acc[hh][3]);
        r[1] = make_float4(acc[hh][4], acc[hh][5], acc[hh][6], acc[hh][7]);
      }
    }
    if (a.k_new != nullptr && rank == 0) {  // K8: the new token's score, one warp a head
      const bf16* kn = a.k_new + ((size_t)b * a.Hkv + hk) * D;
      for (int hh = warp; hh < HB; hh += kWarps) {
        float dot = 0.f;
        for (int d = lane; d < D; d += 32) dot = fmaf(qs[hh * D + d], bf2f(kn[d]), dot);
        dot = warp_sum(dot);
        if (lane == 0) s_new[hh] = dot * scale;
      }
    }
    __syncthreads();

    // the split's (max, sum, accumulator) pushed into rank 0's slot r, then
    // combined there in rank order (an empty chunk: max -inf, sum 0, acc 0)
    cluster_wait();  // rank 0 runs, and has combined the previous pass
    float* acc0 = cluster.map_shared_rank(cacc, 0) + rank * HB * D;
    for (int i = tid; i < HB * D; i += kThreads) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red[w * HB * D + i];
      acc0[i] = s;
    }
    if (tid < HB) {
      cluster.map_shared_rank(cm, 0)[rank * HB + tid] = m_run[tid];
      cluster.map_shared_rank(cl, 0)[rank * HB + tid] = l_run[tid];
    }
    cluster_arrive();
    cluster_wait();  // every split's slot is written
    if (rank == 0) {
      const bf16* vn = a.v_new != nullptr ? a.v_new + ((size_t)b * a.Hkv + hk) * D : nullptr;
      for (int i = tid; i < HB * D; i += kThreads) {
        const int hh = i / D, d = i - hh * D;
        float mx = vn != nullptr ? s_new[hh] : -CUDART_INF_F;
#pragma unroll
        for (int r = 0; r < kC; ++r) mx = fmaxf(mx, cm[r * HB + hh]);
        float l = 0.f, o = 0.f;
        if (vn != nullptr) {
          const float w = expf(s_new[hh] - mx);
          l = w;
          o = w * bf2f(vn[d]);
        }
#pragma unroll
        for (int r = 0; r < kC; ++r) {
          const float mr = cm[r * HB + hh];
          const float w = mr == -CUDART_INF_F ? 0.f : expf(mr - mx);
          l += cl[r * HB + hh] * w;
          o += cacc[r * HB * D + i] * w;
        }
        a.out[((size_t)b * a.H + h0 + hh) * D + d] = f2bf(l > 0.f ? o / l : 0.f);
      }
    }
    cluster_arrive();  // rank 0: the slots are free again
  }
}

template <int D, bool Q8, int HB>
cudaError_t launch(Args a, int B, cudaStream_t st) {
  using L = Smem<D, Q8, HB>;
  a.stages = L::stages_for(a.S);  // the cache's capacity: the same at every position
  const int smem = L::bytes(a.stages);
  static int attr = 0;  // the dynamic shared memory allowed so far
  if (smem > attr) {
    cudaError_t e = cudaFuncSetAttribute(decode_cluster_kernel<D, Q8, HB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         L::bytes(kMaxStages));
    if (e != cudaSuccess) return e;
    attr = L::bytes(kMaxStages);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kC, B * a.Hkv);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = kC;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, decode_cluster_kernel<D, Q8, HB>, a);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// ---- the grouped-head path: K4 where H / Hkv >= kGroupMin

constexpr int kGroupMin = 16;     // query heads a kv head from which K4 takes it
constexpr int kGroupSplits = 16;  // most splits of a cluster (above 8: a non-portable size)

// shared memory of a group block, in bytes from a 16-byte aligned base: a
// two-stage ring of K and V tiles whose rows are padded by 16 bytes (the 8
// row addresses of an ldmatrix fall in 8 distinct 16-byte bank groups);
// over the ring, once its last tile is consumed, the block's [rows][D + 8]
// f32 accumulator; the rows' max and sum; the mbarriers
template <int D>
struct GroupSmem {
  static constexpr int WARPS = D == 256 ? 4 : 8;  // most m16 row tiles a block
  static constexpr int ROWS = 16 * WARPS;
  static constexpr int KT = D == 256 ? 32 : 64;                   // keys a tile
  static constexpr int KB = D == 64 ? 64 : (D == 128 ? 32 : 16);  // keys a softmax step
  static constexpr int PITCH = 2 * D + 16;                        // bytes a K or V row
  static constexpr int STAGE = 2 * KT * PITCH;                    // K rows, then V rows
  static constexpr int OP = D + 8;                                // floats an accumulator row
  static constexpr int RING = kMaxStages * STAGE;
  static constexpr int OACC = ROWS * OP * 4;
  static constexpr int ML = RING > OACC ? RING : OACC;  // [2][ROWS] f32: max, then sum
  static constexpr int BAR = ML + 2 * ROWS * 4;
  static constexpr int BYTES = BAR + 8 * kMaxStages;
};

// a bf16 pair of V holding keys j (low half) and j + 1 (high half), a key
// at or past n read as 0: the ring's rows past a chunk's end are stale, and
// p = 0 times a stale NaN would not be 0
__device__ __forceinline__ uint32_t keys_below(uint32_t w, int j, int n) {
  return (j < n ? w & 0xffffu : 0u) | (j + 1 < n ? w & 0xffff0000u : 0u);
}

// grid (splits, B * Hkv, ceil(rep / rows)), clusters of `splits` along x;
// a block serves rows = blockDim.x / 2 query heads of its kv head, 16 a warp
template <int D>
__global__ void __launch_bounds__(32 * GroupSmem<D>::WARPS)
    decode_group_kernel(const Args a, const int splits) {
  using L = GroupSmem<D>;
  constexpr int KT = L::KT, KB = L::KB, PITCH = L::PITCH, OP = L::OP;
  constexpr int NT = KB / 8;  // n8 tiles of a step's scores
  constexpr int DT = D / 8;   // n8 tiles of the accumulator

  extern __shared__ __align__(16) unsigned char smem[];
  float* oacc = reinterpret_cast<float*>(smem);
  float* ml = reinterpret_cast<float*>(smem + L::ML);
  const uint32_t ring = smem_u32(smem), bar0 = smem_u32(smem + L::BAR);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int head = blockIdx.y;  // b * Hkv + kv head
  const int b = head / a.Hkv, hk = head - b * a.Hkv;
  const int rep = a.H / a.Hkv;
  const int rows = blockDim.x / 2, r0 = blockIdx.z * rows;  // the block's first row of the group
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, t = lane & 3;

  const int len = a.pos_dev != nullptr
                      ? (int)min(max(*a.pos_dev + a.len_off, 0LL), (long long)a.S)
                      : a.len;
  const int chunk = split_chunk(len, splits);
  const int k0 = min(rank * chunk, len), k1 = min(k0 + chunk, len);
  const int n_tiles = (k1 - k0 + KT - 1) / KT;
  const bf16* kg = static_cast<const bf16*>(a.k) + (size_t)head * a.S * D;
  const bf16* vg = static_cast<const bf16*>(a.v) + (size_t)head * a.S * D;

  // warp 0: tile `step`'s K and V rows, one bulk copy a row (the padded
  // rows are not one contiguous range in shared memory)
  auto issue = [&](int step) {
    const int st = step % kMaxStages, j0 = k0 + step * KT, n = min(KT, k1 - j0);
    const uint32_t bar = bar0 + 8 * st, dst = ring + st * L::STAGE;
    if (lane == 0) mbar_expect(bar, 2 * n * D * (int)sizeof(bf16));
    __syncwarp();
    for (int i = lane; i < n; i += 32) {
      bulk_load(dst + i * PITCH, kg + (size_t)(j0 + i) * D, D * sizeof(bf16), bar);
      bulk_load(dst + (KT + i) * PITCH, vg + (size_t)(j0 + i) * D, D * sizeof(bf16), bar);
    }
  };
  if (tid == 0) {
    for (int s = 0; s < kMaxStages; ++s) mbar_init(bar0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == 0)
    for (int s = 0; s < kMaxStages && s < n_tiles; ++s) issue(s);

  // this thread's q rows (gid, gid + 8 of its warp's tile) as A fragments;
  // rows past the group are zero
  const int qr0 = r0 + warp * 16 + gid, qr1 = qr0 + 8;
  const bf16* qg = a.q + ((size_t)b * a.H + (size_t)hk * rep) * D;
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = 16 * kk + 2 * t;
    auto word = [&](int r, int col) {
      return r < rep ? __ldg(reinterpret_cast<const unsigned int*>(qg + (size_t)r * D + col)) : 0u;
    };
    qa[kk][0] = word(qr0, c);
    qa[kk][1] = word(qr1, c);
    qa[kk][2] = word(qr0, c + 8);
    qa[kk][3] = word(qr1, c + 8);
  }

  const float sl2 = rsqrtf((float)D) * 1.4426950408889634f;  // D^-0.5 * log2 e
  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;  // l: this thread's columns
  // ldmatrix row addresses, as K3 takes them: K two n8 tiles of one k step,
  // V (transposed) two n8 tiles of dims over 16 keys
  const uint32_t k_lane = ((lane >> 4) * 8 + (lane & 7)) * PITCH + ((lane >> 3) & 1) * 16;
  const uint32_t v_lane = ((lane & 7) + ((lane >> 3) & 1) * 8) * PITCH + (lane >> 4) * 16;

  for (int step = 0; step < n_tiles; ++step) {
    const int st = step % kMaxStages, n = min(KT, k1 - k0 - step * KT);
    const uint32_t kt = ring + st * L::STAGE, vt = kt + KT * PITCH;
    mbar_wait(bar0 + 8 * st, (step / kMaxStages) & 1);
    for (int c = 0; c < n; c += KB) {
      // S = Q K^T over keys c .. c + KB of the tile
      float s[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
        for (int nt = 0; nt < NT; nt += 2) {
          uint32_t bk[4];
          ldmatrix_x4(bk, kt + (c + nt * 8) * PITCH + k_lane + kk * 32);
          mma_bf16(s[nt], qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3], bk[0], bk[1]);
          mma_bf16(s[nt + 1], qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3], bk[2], bk[3]);
        }

      // keys past the chunk's end masked; the online softmax of rows gid
      // (elements 0, 1) and gid + 8 (2, 3), max across the quad
      float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = c + nt * 8 + 2 * t + e < n;
          s[nt][e] = ok ? s[nt][e] * sl2 : -CUDART_INF_F;
          s[nt][e + 2] = ok ? s[nt][e + 2] * sl2 : -CUDART_INF_F;
          mx0 = fmaxf(mx0, s[nt][e]);
          mx1 = fmaxf(mx1, s[nt][e + 2]);
        }
#pragma unroll
      for (int x = 1; x < 4; x <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);  // finite: key c is valid
      const float al0 = m0 == mn0 ? 1.f : exp2f(m0 - mn0);     // 0 at the first step
      const float al1 = m1 == mn1 ? 1.f : exp2f(m1 - mn1);
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[nt][e] = exp2f(s[nt][e] - mn0);
          s[nt][e + 2] = exp2f(s[nt][e + 2] - mn1);
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

      // O += P V: P rounded to bf16 from the S registers, V through
      // ldmatrix.trans, its keys past the chunk's end read as 0
#pragma unroll
      for (int kk = 0; kk < KB / 16; ++kk) {
        const uint32_t a0 = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        const uint32_t a1 = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        const uint32_t a2 = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        const uint32_t a3 = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        const int j = c + 16 * kk + 2 * t;  // this thread's keys j, j + 1, j + 8, j + 9
        const bool ragged = c + 16 * kk + 16 > n;
#pragma unroll
        for (int dt = 0; dt < DT; dt += 2) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, vt + (c + 16 * kk) * PITCH + v_lane + dt * 16);
          if (ragged) {
            bv[0] = keys_below(bv[0], j, n);
            bv[1] = keys_below(bv[1], j + 8, n);
            bv[2] = keys_below(bv[2], j, n);
            bv[3] = keys_below(bv[3], j + 8, n);
          }
          mma_bf16(o[dt], a0, a1, a2, a3, bv[0], bv[1]);
          mma_bf16(o[dt + 1], a0, a1, a2, a3, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // every warp has consumed the stage
    if (warp == 0 && step + kMaxStages < n_tiles) {
      fence_async_proxy();
      issue(step + kMaxStages);
    }
  }

  // the split's rows: (max, sum, unnormalised accumulator) into this
  // block's shared memory, over the consumed ring (an empty chunk: max
  // -inf, sum 0, accumulator 0)
#pragma unroll
  for (int x = 1; x < 4; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  const int lr0 = warp * 16 + gid, lr1 = lr0 + 8;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    *reinterpret_cast<float2*>(oacc + lr0 * OP + dt * 8 + 2 * t) = make_float2(o[dt][0], o[dt][1]);
    *reinterpret_cast<float2*>(oacc + lr1 * OP + dt * 8 + 2 * t) = make_float2(o[dt][2], o[dt][3]);
  }
  if (t == 0) {
    ml[lr0] = m0;
    ml[lr1] = m1;
    ml[L::ROWS + lr0] = l0;
    ml[L::ROWS + lr1] = l1;
  }
  cluster_arrive();
  cluster_wait();  // every split's rows are written

  // the output, 4 dims a thread and the rows shared out over the ranks:
  // each reads every split's (max, sum, accumulator) through distributed
  // shared memory and combines them in rank order
  const int nrows = min(rows, rep - r0), vecs = D / 4;
  for (int i = rank * blockDim.x + tid; i < nrows * vecs; i += splits * blockDim.x) {
    const int row = i / vecs, d = (i - row * vecs) * 4;
    float mr[kGroupSplits], mx = -CUDART_INF_F;
#pragma unroll
    for (int r = 0; r < kGroupSplits; ++r) {
      mr[r] = r < splits ? *cluster.map_shared_rank(ml + row, r) : -CUDART_INF_F;
      mx = fmaxf(mx, mr[r]);
    }
    float l = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int r = 0; r < kGroupSplits; ++r) {
      if (r >= splits) break;
      const float w = mr[r] == -CUDART_INF_F ? 0.f : exp2f(mr[r] - mx);
      l += *cluster.map_shared_rank(ml + L::ROWS + row, r) * w;
      const float4 x = *reinterpret_cast<const float4*>(cluster.map_shared_rank(oacc + row * OP + d, r));
      acc.x += x.x * w;
      acc.y += x.y * w;
      acc.z += x.z * w;
      acc.w += x.w * w;
    }
    const bf162 lo = __floats2bfloat162_rn(l > 0.f ? acc.x / l : 0.f, l > 0.f ? acc.y / l : 0.f);
    const bf162 hi = __floats2bfloat162_rn(l > 0.f ? acc.z / l : 0.f, l > 0.f ? acc.w / l : 0.f);
    bf162* dst = reinterpret_cast<bf162*>(a.out + ((size_t)b * a.H + (size_t)hk * rep + r0 + row) * D + d);
    dst[0] = lo;
    dst[1] = hi;
  }
  cluster_arrive();
  cluster_wait();  // no block leaves while its rows may still be read
}

// the group path's launch: as many m16 row tiles a block as the group
// needs, up to GroupSmem's WARPS (more rows: blocks along z), and splits
// enough that the grid covers the card's SMs once, at most kGroupSplits
// (or 8 where the card cannot schedule a cluster of kGroupSplits)
template <int D>
cudaError_t launch_group(const Args& a, int B, cudaStream_t st) {
  using L = GroupSmem<D>;
  const int rep = a.H / a.Hkv;
  const int warps = min((rep + 15) / 16, L::WARPS);
  const int zb = (rep + 16 * warps - 1) / (16 * warps);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  cfg.dynamicSmemBytes = L::BYTES;
  cfg.stream = st;
  static int most = 0;  // the largest cluster, found at the first launch
  if (most == 0) {
    cudaError_t e = cudaFuncSetAttribute(decode_group_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (e != cudaSuccess) return e;
    most = kC;
    if (cudaFuncSetAttribute(decode_group_kernel<D>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1) == cudaSuccess) {
      int clusters = 0;
      cfg.gridDim = dim3(kGroupSplits, 1, 1);
      cfg.blockDim = dim3(32 * L::WARPS);
      attrs[0].val.clusterDim.x = kGroupSplits;
      if (cudaOccupancyMaxActiveClusters(&clusters, decode_group_kernel<D>, &cfg) == cudaSuccess &&
          clusters > 0)
        most = kGroupSplits;
    }
    cudaGetLastError();  // a refused query leaves no error behind
  }
  const int splits = max(1, min(most, sm_count() / (B * a.Hkv * zb)));
  cfg.gridDim = dim3(splits, B * a.Hkv, zb);
  cfg.blockDim = dim3(32 * warps);
  attrs[0].val.clusterDim.x = splits;
  cudaError_t e = cudaLaunchKernelEx(&cfg, decode_group_kernel<D>, a, splits);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// ---- the latent path: multi-head latent attention (DeepSeek-V2) at decode

constexpr int kLatK = 576;      // a cached row: the normalised latent (512) and the roped key (64)
constexpr int kLatV = 512;      // the values: each row's first 512
constexpr int kLatHeads = 16;   // query heads: one m16 tile
constexpr int kLatWarps = 4;
constexpr int kLatKT = 32;      // keys a tile: an n8 tile of scores a warp
constexpr int kLatSplits = 8;   // most splits of a cluster
constexpr int kLatDW = kLatV / kLatWarps;  // accumulator dims a warp

// shared memory of a latent block, in bytes from a 16-byte aligned base: a
// two-stage ring of cached rows padded by 16 bytes (ldmatrix without bank
// conflicts), the queries in the same pitch, the tile's probabilities
// (bf16) and scores (f32), the heads' max, sum and rescale, the mbarriers;
// over the ring, once its last tile is consumed, the [16][512 + 8] f32
// accumulator
struct LatentSmem {
  static constexpr int PITCH = 2 * kLatK + 16;
  static constexpr int PPITCH = 2 * kLatKT + 16;
  static constexpr int STAGE = kLatKT * PITCH;
  static constexpr int OP = kLatV + 8;
  static constexpr int Q = kMaxStages * STAGE;
  static constexpr int P = Q + kLatHeads * PITCH;
  static constexpr int S = P + kLatHeads * PPITCH;
  static constexpr int ML = S + kLatHeads * kLatKT * 4;  // [3][16] f32: max, sum, rescale
  static constexpr int BAR = (ML + 3 * kLatHeads * 4 + 7) / 8 * 8;
  static constexpr int BYTES = BAR + 8 * kMaxStages;
  static_assert(kLatHeads * OP * 4 <= Q, "the accumulator fits over the ring");
};

struct LatentArgs {
  const bf16* q;             // [B, 16, 576]: the absorbed query and the roped q_pe
  const bf16* c;             // [B, S, 576] of the layer
  bf16* out;                 // [B, 16, 512]
  const long long* pos_dev;  // NULL: `len` holds
  int S, len;
  float scale;               // the softmax scale
};

// grid (splits, B), clusters of `splits` along x: all 16 query heads of a
// sequence read each cached row of the split's chunk once
__global__ void __launch_bounds__(32 * kLatWarps)
    decode_latent_kernel(const LatentArgs a, const int splits) {
  using L = LatentSmem;
  constexpr int KT = kLatKT, PITCH = L::PITCH, PPITCH = L::PPITCH, NT = kLatDW / 8;

  extern __shared__ __align__(16) unsigned char smem[];
  float* oacc = reinterpret_cast<float*>(smem);
  float* sc = reinterpret_cast<float*>(smem + L::S);
  float* ml = reinterpret_cast<float*>(smem + L::ML);
  const uint32_t ring = smem_u32(smem), qs = ring + L::Q, ps = ring + L::P;
  const uint32_t bar0 = smem_u32(smem + L::BAR);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, t = lane & 3;

  const int len = a.pos_dev != nullptr
                      ? (int)min(max(*a.pos_dev + 1, 0LL), (long long)a.S)
                      : a.len;
  const int chunk = split_chunk(len, splits);
  const int k0 = min(rank * chunk, len), k1 = min(k0 + chunk, len);
  const int n_tiles = (k1 - k0 + KT - 1) / KT;
  const bf16* cb = a.c + (size_t)b * a.S * kLatK;

  // warp 0: tile `step`'s rows, one bulk copy a row
  auto issue = [&](int step) {
    const int st = step % kMaxStages, j0 = k0 + step * KT, n = min(KT, k1 - j0);
    const uint32_t bar = bar0 + 8 * st, dst = ring + st * L::STAGE;
    if (lane == 0) mbar_expect(bar, n * kLatK * (int)sizeof(bf16));
    __syncwarp();
    for (int i = lane; i < n; i += 32)
      bulk_load(dst + i * PITCH, cb + (size_t)(j0 + i) * kLatK, kLatK * sizeof(bf16), bar);
  };
  if (tid == 0) {
    for (int s = 0; s < kMaxStages; ++s) mbar_init(bar0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == 0)
    for (int s = 0; s < kMaxStages && s < n_tiles; ++s) issue(s);

  // the queries into shared memory; each head's running max and sum
  const bf16* qb = a.q + (size_t)b * kLatHeads * kLatK;
  for (int i = tid; i < kLatHeads * kLatK / 8; i += blockDim.x) {
    const int r = i / (kLatK / 8), c = i - r * (kLatK / 8);
    *reinterpret_cast<uint4*>(smem + L::Q + r * PITCH + c * 16) =
        __ldg(reinterpret_cast<const uint4*>(qb + (size_t)r * kLatK) + c);
  }
  if (tid < kLatHeads) {
    ml[tid] = -CUDART_INF_F;
    ml[kLatHeads + tid] = 0.f;
  }
  __syncthreads();

  const float sl2 = a.scale * 1.4426950408889634f;  // the scale times log2 e
  float o[NT][4];  // rows gid, gid + 8; dims warp * kLatDW + 8 dt + 2t, + 1
#pragma unroll
  for (int dt = 0; dt < NT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  // ldmatrix row addresses: q and P as A fragments (rows lane & 15, the
  // second k8 half for lanes 16..31), K as two k16 steps of the warp's 8
  // keys, V (transposed) as two n8 tiles of dims over 16 keys
  const uint32_t a_lane = (lane & 15) * PITCH + (lane >> 4) * 16;
  const uint32_t p_lane = (lane & 15) * PPITCH + (lane >> 4) * 16;
  const uint32_t k_lane = (warp * 8 + (lane & 7)) * PITCH + (lane >> 3) * 16;
  const uint32_t v_lane = ((lane & 7) + ((lane >> 3) & 1) * 8) * PITCH + (lane >> 4) * 16 +
                          warp * kLatDW * 2;

  for (int step = 0; step < n_tiles; ++step) {
    const int st = step % kMaxStages, n = min(KT, k1 - k0 - step * KT);
    const uint32_t kt = ring + st * L::STAGE;
    mbar_wait(bar0 + 8 * st, (step / kMaxStages) & 1);

    // S = Q K^T of the warp's 8 keys over all 576 dims, f32 sums
    float s4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 6
    for (int kk = 0; kk < kLatK / 16; kk += 2) {
      uint32_t qa[4], qc[4], bk[4];
      ldmatrix_x4(qa, qs + a_lane + kk * 32);
      ldmatrix_x4(qc, qs + a_lane + (kk + 1) * 32);
      ldmatrix_x4(bk, kt + k_lane + kk * 32);
      mma_bf16(s4, qa[0], qa[1], qa[2], qa[3], bk[0], bk[1]);
      mma_bf16(s4, qc[0], qc[1], qc[2], qc[3], bk[2], bk[3]);
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key = warp * 8 + 2 * t + e;
      const bool ok = key < n;
      sc[gid * KT + key] = ok ? s4[e] * sl2 : -CUDART_INF_F;
      sc[(gid + 8) * KT + key] = ok ? s4[e + 2] * sl2 : -CUDART_INF_F;
    }
    __syncthreads();

    // the online softmax: warp w takes heads 4w .. 4w + 3, a lane a key;
    // P rounded to bf16, the sum taken of the f32 values
#pragma unroll
    for (int hh = 0; hh < kLatHeads / kLatWarps; ++hh) {
      const int h = warp * (kLatHeads / kLatWarps) + hh;
      const float v = sc[h * KT + lane], m_old = ml[h], l_old = ml[kLatHeads + h];
      const float m_new = fmaxf(m_old, warp_max(v));  // finite: key 0 is valid
      const float p = exp2f(v - m_new);
      const float sum = warp_sum(p);
      *reinterpret_cast<bf16*>(smem + L::P + h * PPITCH + lane * 2) = f2bf(p);
      __syncwarp();  // every lane has read the head's max and sum
      if (lane == 0) {
        const float alpha = m_old == m_new ? 1.f : exp2f(m_old - m_new);
        ml[h] = m_new;
        ml[kLatHeads + h] = l_old * alpha + sum;
        ml[2 * kLatHeads + h] = alpha;
      }
    }
    __syncthreads();

    // O = alpha O + P V: V is the rows' first 512 dims, through
    // ldmatrix.trans; keys past the chunk's end read as 0
    const float al0 = ml[2 * kLatHeads + gid], al1 = ml[2 * kLatHeads + gid + 8];
#pragma unroll
    for (int dt = 0; dt < NT; ++dt) {
      o[dt][0] *= al0;
      o[dt][1] *= al0;
      o[dt][2] *= al1;
      o[dt][3] *= al1;
    }
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      uint32_t pa[4];
      ldmatrix_x4(pa, ps + p_lane + kk * 32);
      const int j = 16 * kk + 2 * t;  // this thread's keys j, j + 1, j + 8, j + 9
      const bool ragged = 16 * kk + 16 > n;
#pragma unroll
      for (int dt = 0; dt < NT; dt += 2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, kt + 16 * kk * PITCH + v_lane + dt * 16);
        if (ragged) {
          bv[0] = keys_below(bv[0], j, n);
          bv[1] = keys_below(bv[1], j + 8, n);
          bv[2] = keys_below(bv[2], j, n);
          bv[3] = keys_below(bv[3], j + 8, n);
        }
        mma_bf16(o[dt], pa[0], pa[1], pa[2], pa[3], bv[0], bv[1]);
        mma_bf16(o[dt + 1], pa[0], pa[1], pa[2], pa[3], bv[2], bv[3]);
      }
    }
    __syncthreads();  // every warp has consumed the stage, the scores and P
    if (warp == 0 && step + kMaxStages < n_tiles) {
      fence_async_proxy();
      issue(step + kMaxStages);
    }
  }

  // the split's accumulator into this block's shared memory, over the
  // consumed ring (an empty chunk: max -inf, sum 0, accumulator 0)
#pragma unroll
  for (int dt = 0; dt < NT; ++dt) {
    const int d = warp * kLatDW + dt * 8 + 2 * t;
    *reinterpret_cast<float2*>(oacc + gid * L::OP + d) = make_float2(o[dt][0], o[dt][1]);
    *reinterpret_cast<float2*>(oacc + (gid + 8) * L::OP + d) = make_float2(o[dt][2], o[dt][3]);
  }
  cluster_arrive();
  cluster_wait();  // every split's rows are written

  // the output, 4 dims a thread, shared out over the ranks; each combines
  // every split's (max, sum, accumulator) in rank order
  constexpr int vecs = kLatV / 4;
  for (int i = rank * blockDim.x + tid; i < kLatHeads * vecs; i += splits * blockDim.x) {
    const int row = i / vecs, d = (i - row * vecs) * 4;
    float mr[kLatSplits], mx = -CUDART_INF_F;
#pragma unroll
    for (int r = 0; r < kLatSplits; ++r) {
      mr[r] = r < splits ? *cluster.map_shared_rank(ml + row, r) : -CUDART_INF_F;
      mx = fmaxf(mx, mr[r]);
    }
    float l = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int r = 0; r < kLatSplits; ++r) {
      if (r >= splits) break;
      const float w = mr[r] == -CUDART_INF_F ? 0.f : exp2f(mr[r] - mx);
      l += *cluster.map_shared_rank(ml + kLatHeads + row, r) * w;
      const float4 x =
          *reinterpret_cast<const float4*>(cluster.map_shared_rank(oacc + row * L::OP + d, r));
      acc.x += x.x * w;
      acc.y += x.y * w;
      acc.z += x.z * w;
      acc.w += x.w * w;
    }
    const bf162 lo = __floats2bfloat162_rn(l > 0.f ? acc.x / l : 0.f, l > 0.f ? acc.y / l : 0.f);
    const bf162 hi = __floats2bfloat162_rn(l > 0.f ? acc.z / l : 0.f, l > 0.f ? acc.w / l : 0.f);
    bf162* dst = reinterpret_cast<bf162*>(a.out + ((size_t)b * kLatHeads + row) * kLatV + d);
    dst[0] = lo;
    dst[1] = hi;
  }
  cluster_arrive();
  cluster_wait();  // no block leaves while its rows may still be read
}

// splits enough that the grid covers the card's SMs about twice
cudaError_t launch_latent(const LatentArgs& a, int B, cudaStream_t st) {
  static bool opted = false;
  if (!opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_latent_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, LatentSmem::BYTES);
    if (e != cudaSuccess) return e;
    opted = true;
  }
  const int splits = max(1, min(kLatSplits, (2 * sm_count() + B - 1) / B));
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = splits;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  cfg.gridDim = dim3(splits, B, 1);
  cfg.blockDim = dim3(32 * kLatWarps);
  cfg.dynamicSmemBytes = LatentSmem::BYTES;
  cfg.stream = st;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, decode_latent_kernel, a, splits);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <int D, bool Q8>
cudaError_t launch_heads(const Args& a, int B, cudaStream_t st) {
  const int rep = a.H / a.Hkv;
  if (!Q8 && a.k_new == nullptr && rep >= kGroupMin) return launch_group<D>(a, B, st);  // K4 only
  // query heads a pass: the largest of 4, 2, 1 dividing rep
  if (rep % 4 == 0) return launch<D, Q8, 4>(a, B, st);
  if (rep % 2 == 0) return launch<D, Q8, 2>(a, B, st);
  return launch<D, Q8, 1>(a, B, st);
}

// every entry point: checks, then the (D, int8) instance over `len` slots,
// or over pos_dev[0] + len_off slots
int run(Args a, int B, int D, void* stream) {
  if (B < 1 || a.H < 1 || a.Hkv < 1 || a.H % a.Hkv || a.len < 0 || a.len > a.S ||
      (a.ks == nullptr) != (a.vs == nullptr) || (a.k_new == nullptr) != (a.v_new == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool q8 = a.ks != nullptr;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return (int)(q8 ? launch_heads<64, true>(a, B, st) : launch_heads<64, false>(a, B, st));
    case 128: return (int)(q8 ? launch_heads<128, true>(a, B, st) : launch_heads<128, false>(a, B, st));
    case 256: return (int)(q8 ? launch_heads<256, true>(a, B, st) : launch_heads<256, false>(a, B, st));
  }
  return (int)cudaErrorInvalidValue;
}

Args make_args(const void* q, const void* k, const void* v, const void* ks, const void* vs,
               const void* k_new, const void* v_new, const void* pos_dev, void* out,
               int len_off, int H, int Hkv, int S, int len) {
  return Args{static_cast<const bf16*>(q), k, v, static_cast<const float*>(ks),
              static_cast<const float*>(vs), static_cast<const bf16*>(k_new),
              static_cast<const bf16*>(v_new), static_cast<bf16*>(out),
              static_cast<const long long*>(pos_dev), len_off, H, Hkv, S, len, 1};
}

}  // namespace

// pos_dev: NULL, or the int64 position on the device -- pos is then not
// read; likewise below
extern "C" int decode_attention(const void* q, const void* k, const void* v, const void* pos_dev,
                                void* out, int B, int H, int Hkv, int S, int D, int pos,
                                void* stream) {
  if (pos_dev != nullptr) pos = S - 1;
  if (pos < 0 || pos >= S) return (int)cudaErrorInvalidValue;
  return run(make_args(q, k, v, nullptr, nullptr, nullptr, nullptr, pos_dev, out, 1, H, Hkv, S,
                       pos + 1),
             B, D, stream);
}

// ks, vs: f32 [B, Hkv, S] per-vector scales of the int8 codes k, v
extern "C" int decode_attention_int8(const void* q, const void* k, const void* v, const void* ks,
                                     const void* vs, const void* pos_dev, void* out, int B, int H,
                                     int Hkv, int S, int D, int pos, void* stream) {
  if (pos_dev != nullptr) pos = S - 1;
  if (pos < 0 || pos >= S || ks == nullptr || vs == nullptr) return (int)cudaErrorInvalidValue;
  return run(make_args(q, k, v, ks, vs, nullptr, nullptr, pos_dev, out, 1, H, Hkv, S, pos + 1), B,
             D, stream);
}

// k, v: the stacked [L, B, Hkv, S, D] cache (bf16 when ks is NULL, else int8
// with f32 [L, B, Hkv, S] scales ks, vs); k_new, v_new: bf16 [B, Hkv, D]
extern "C" int decode_attention_stacked(const void* q, const void* k, const void* v,
                                        const void* ks, const void* vs, const void* k_new,
                                        const void* v_new, const void* pos_dev, void* out, int L,
                                        int B, int H, int Hkv, int S, int D, int layer, int pos,
                                        void* stream) {
  if (pos_dev != nullptr) pos = S - 1;
  if (layer < 0 || layer >= L || pos < 0 || pos >= S || k_new == nullptr || v_new == nullptr)
    return (int)cudaErrorInvalidValue;
  const size_t vecs = (size_t)layer * B * Hkv * S;  // vectors before this layer
  const size_t elt = ks != nullptr ? 1 : sizeof(bf16);
  const char* kl = static_cast<const char*>(k) + vecs * D * elt;
  const char* vl = static_cast<const char*>(v) + vecs * D * elt;
  const float* ksl = ks != nullptr ? static_cast<const float*>(ks) + vecs : nullptr;
  const float* vsl = vs != nullptr ? static_cast<const float*>(vs) + vecs : nullptr;
  return run(make_args(q, kl, vl, ksl, vsl, k_new, v_new, pos_dev, out, 0, H, Hkv, S, pos), B, D,
             stream);
}

// the latent path: q [B, H, D] (D = 576: the absorbed query and the roped
// q_pe), c [B, S, D] the layer's latent cache holding the current token,
// out [B, H, DV] (DV = 512, the values: each row's first DV); H = 16
extern "C" int decode_latent_attention(const void* q, const void* c, const void* pos_dev,
                                       void* out, int B, int H, int S, int D, int DV, int pos,
                                       float scale, void* stream) {
  if (pos_dev != nullptr) pos = S - 1;
  if (B < 1 || H != kLatHeads || D != kLatK || DV != kLatV || pos < 0 || pos >= S ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  const LatentArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(c),
                     static_cast<bf16*>(out), static_cast<const long long*>(pos_dev), S, pos + 1,
                     scale};
  return (int)launch_latent(a, B, static_cast<cudaStream_t>(stream));
}
