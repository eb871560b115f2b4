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

// keys a split: ceil(len / kC), rounded up to a multiple of kAlign
// (qeft_tpu_torch/ops/attention.py:split_chunk is its twin)
__host__ __device__ constexpr int split_chunk(int len) {
  return ((len + kC - 1) / kC + kAlign - 1) / kAlign * kAlign;
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

// one bulk asynchronous copy of `bytes` (a multiple of 16) from global
// `src` to shared `dst`, both 16-byte aligned, completing on mbarrier `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

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

template <int D, bool Q8>
cudaError_t launch_heads(const Args& a, int B, cudaStream_t st) {
  const int rep = a.H / a.Hkv;  // query heads a pass: the largest of 4, 2, 1 dividing it
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
