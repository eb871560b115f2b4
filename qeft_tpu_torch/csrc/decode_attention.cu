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
//   v_new [B, Hkv, D] enter as one extra softmax term in the combine pass
//   (when pos == 0 it is the only term).  Bound: as K4 or K4q over pos
//   slots, plus the new vectors.
//
// Design, shared by the three: split-K ("flash decoding").  The valid
// prefix is cut into n_split chunks of at most 256 keys so that enough
// blocks stream the cache at once; block (chunk, sequence*head) has one
// thread per key for the scores (a D-element row each, 16-byte loads all
// issued together), an f32 block softmax over its chunk, then threads split
// (key stride, dim pair) for P.V with coalesced loads, eight keys' loads in
// flight per thread.  Each block leaves its (max, sum, unnormalised
// accumulator) in f32 scratch; a second small pass rescales and combines the
// chunks (and K8's new-token term).  Slots past the valid prefix are never
// read.

#include <type_traits>

#include "common.cuh"

using namespace qeft;

namespace {

constexpr int kD_THREADS = 256;  // = keys per chunk at most

// element type of the cache: bf16, or int8 codes when Q8
template <bool Q8>
using kv_t = typename std::conditional<Q8, int8_t, bf16>::type;

// q . row over D elements, q in shared memory as f32
template <int D, bool Q8>
__device__ __forceinline__ float dot_row(const float* qs, const kv_t<Q8>* row) {
  float dot = 0.f;
  constexpr int VEC = 16 / sizeof(kv_t<Q8>);  // elements a 16-byte load
#pragma unroll
  for (int d0 = 0; d0 < D; d0 += VEC) {
    const uint4 raw = *reinterpret_cast<const uint4*>(row + d0);
    if constexpr (Q8) {
      const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
      for (int t = 0; t < VEC; ++t) dot = fmaf(qs[d0 + t], (float)c[t], dot);
    } else {
      const bf162* k2 = reinterpret_cast<const bf162*>(&raw);
#pragma unroll
      for (int t = 0; t < VEC / 2; ++t) {
        const float2 f = __bfloat1622float2(k2[t]);
        dot = fmaf(qs[d0 + 2 * t], f.x, dot);
        dot = fmaf(qs[d0 + 2 * t + 1], f.y, dot);
      }
    }
  }
  return dot;
}

// elements (2*dp, 2*dp + 1) of a row as floats
template <bool Q8>
__device__ __forceinline__ float2 load_pair(const kv_t<Q8>* row, int dp) {
  if constexpr (Q8) {
    const char2 c = *reinterpret_cast<const char2*>(row + 2 * dp);
    return make_float2((float)c.x, (float)c.y);
  } else {
    return __bfloat1622float2(*reinterpret_cast<const bf162*>(row + 2 * dp));
  }
}

// k, v (and ks, vs when Q8) point at the [B, Hkv, S, ...] cache of one
// layer; `len` slots from slot 0 are valid
template <int D, bool Q8>
__global__ void __launch_bounds__(kD_THREADS)
decode_split_kernel(const bf16* __restrict__ q, const kv_t<Q8>* __restrict__ k,
                    const kv_t<Q8>* __restrict__ v, const float* __restrict__ ks,
                    const float* __restrict__ vs, float* __restrict__ part_acc,
                    float* __restrict__ part_m, float* __restrict__ part_l,
                    int BH, int H, int Hkv, int S, int len, int n_split) {
  constexpr int HALF = D / 2;                 // dim pairs
  constexpr int GROUPS = kD_THREADS / HALF;   // key strides of the P.V pass
  __shared__ __align__(16) float qs[D];
  __shared__ float ps[kD_THREADS];
  __shared__ float accs[GROUPS * D];
  __shared__ float red[32];

  const int split = blockIdx.x, bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int chunk = (len + n_split - 1) / n_split;
  const int k0 = split * chunk;
  const int k1 = min(k0 + chunk, len);
  const float scale = rsqrtf((float)D);

  for (int d = tid; d < D; d += blockDim.x) qs[d] = bf2f(q[(size_t)bh * D + d]);
  __syncthreads();

  const size_t head = (size_t)b * Hkv + hk;
  const kv_t<Q8>* kb = k + head * S * D;
  const kv_t<Q8>* vb = v + head * S * D;
  const int j = k0 + tid;
  float s = -CUDART_INF_F;
  if (j < k1) {
    s = dot_row<D, Q8>(qs, kb + (size_t)j * D) * scale;
    if constexpr (Q8) s *= ks[head * S + j];
  }
  const float m = block_max(s, red);
  const float p = (j < k1) ? expf(s - m) : 0.f;
  float pv = p;  // the probability as the P.V product takes it
  if constexpr (Q8) {
    if (j < k1) pv *= vs[head * S + j];
  }
  ps[tid] = pv;
  const float l = block_sum(p, red);  // unscaled; its barriers also publish ps

  // P.V: thread -> (key stride group, dim pair), eight keys a batch
  {
    const int gq = tid / HALF, dp = tid - gq * HALF;
    const int n_keys = k1 - k0;
    float a0 = 0.f, a1 = 0.f;
    for (int j0 = gq; j0 < n_keys; j0 += 8 * GROUPS) {
      float pj[8];
      float2 f[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int jj = j0 + e * GROUPS;
        pj[e] = 0.f;
        f[e] = make_float2(0.f, 0.f);
        if (jj < n_keys) {
          pj[e] = ps[jj];
          f[e] = load_pair<Q8>(vb + (size_t)(k0 + jj) * D, dp);
        }
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        a0 = fmaf(pj[e], f[e].x, a0);
        a1 = fmaf(pj[e], f[e].y, a1);
      }
    }
    accs[gq * D + 2 * dp] = a0;
    accs[gq * D + 2 * dp + 1] = a1;
  }
  __syncthreads();
  for (int d = tid; d < D; d += blockDim.x) {
    float a = 0.f;
    for (int gq = 0; gq < GROUPS; ++gq) a += accs[gq * D + d];
    part_acc[((size_t)split * BH + bh) * D + d] = a;
  }
  if (tid == 0) {
    part_m[split * BH + bh] = m;
    part_l[split * BH + bh] = l;
  }
}

// one block of D threads per (sequence, head); with k_new the current
// token's term (m = s_new, l = 1, acc = v_new) seeds the combination
__global__ void decode_combine_kernel(const float* __restrict__ part_acc,
                                      const float* __restrict__ part_m,
                                      const float* __restrict__ part_l,
                                      const bf16* __restrict__ q,
                                      const bf16* __restrict__ k_new,
                                      const bf16* __restrict__ v_new, bf16* __restrict__ out,
                                      int BH, int H, int Hkv, int D, int n_split) {
  __shared__ float red[32];
  const int bh = blockIdx.x, d = threadIdx.x;
  float mx = -CUDART_INF_F, s_new = 0.f, vn = 0.f;
  if (k_new != nullptr) {
    const int b = bh / H, h = bh - b * H;
    const size_t nv = ((size_t)b * Hkv + h / (H / Hkv)) * D + d;
    s_new = block_sum(bf2f(q[(size_t)bh * D + d]) * bf2f(k_new[nv]), red) * rsqrtf((float)D);
    vn = bf2f(v_new[nv]);
    mx = s_new;
  }
  for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, part_m[s * BH + bh]);
  float l = 0.f, a = 0.f;
  if (k_new != nullptr) {
    const float w = expf(s_new - mx);
    l = w;
    a = w * vn;
  }
  for (int s = 0; s < n_split; ++s) {
    const float ms = part_m[s * BH + bh];
    if (ms == -CUDART_INF_F) continue;  // an empty chunk
    const float w = expf(ms - mx);
    l += part_l[s * BH + bh] * w;
    a += part_acc[((size_t)s * BH + bh) * D + d] * w;
  }
  out[(size_t)bh * D + d] = f2bf(l > 0.f ? a / l : 0.f);
}

template <int D, bool Q8>
cudaError_t launch_decode(const bf16* q, const void* k, const void* v, const float* ks,
                          const float* vs, const bf16* k_new, const bf16* v_new, bf16* out,
                          float* part_acc, float* part_m, float* part_l, int B, int H, int Hkv,
                          int S, int len, int n_split, cudaStream_t st) {
  const int BH = B * H;
  dim3 grid(n_split, BH);
  decode_split_kernel<D, Q8><<<grid, kD_THREADS, 0, st>>>(
      q, static_cast<const kv_t<Q8>*>(k), static_cast<const kv_t<Q8>*>(v), ks, vs, part_acc,
      part_m, part_l, BH, H, Hkv, S, len, n_split);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  decode_combine_kernel<<<BH, D, 0, st>>>(part_acc, part_m, part_l, q, k_new, v_new, out, BH, H,
                                          Hkv, D, n_split);
  return cudaGetLastError();
}

// every entry point: checks, then the (D, int8) instance over `len` slots
int run(const void* q, const void* k, const void* v, const void* ks, const void* vs,
        const void* k_new, const void* v_new, void* out, void* part_acc, void* part_m,
        void* part_l, int B, int H, int Hkv, int S, int D, int len, int n_split, void* stream) {
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv || len < 0 || len > S || n_split < 1 ||
      (ks == nullptr) != (vs == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((len + n_split - 1) / n_split > kD_THREADS) return (int)cudaErrorInvalidValue;
  const bool q8 = ks != nullptr;
  const bf16* qq = static_cast<const bf16*>(q);
  const float* kss = static_cast<const float*>(ks);
  const float* vss = static_cast<const float*>(vs);
  const bf16* kn = static_cast<const bf16*>(k_new);
  const bf16* vn = static_cast<const bf16*>(v_new);
  bf16* o = static_cast<bf16*>(out);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define QEFT_CASE(DD)                                                                          \
  case DD:                                                                                     \
    return q8 ? (int)launch_decode<DD, true>(qq, k, v, kss, vss, kn, vn, o, pa, pm, pl, B, H,  \
                                             Hkv, S, len, n_split, st)                         \
              : (int)launch_decode<DD, false>(qq, k, v, kss, vss, kn, vn, o, pa, pm, pl, B, H, \
                                              Hkv, S, len, n_split, st);
  switch (D) {
    QEFT_CASE(64) QEFT_CASE(128) QEFT_CASE(256)
  }
#undef QEFT_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int decode_attention(const void* q, const void* k, const void* v, void* out,
                                void* part_acc, void* part_m, void* part_l, int B, int H,
                                int Hkv, int S, int D, int pos, int n_split, void* stream) {
  if (pos < 0 || pos >= S) return (int)cudaErrorInvalidValue;
  return run(q, k, v, nullptr, nullptr, nullptr, nullptr, out, part_acc, part_m, part_l, B, H,
             Hkv, S, D, pos + 1, n_split, stream);
}

// ks, vs: f32 [B, Hkv, S] per-vector scales of the int8 codes k, v
extern "C" int decode_attention_int8(const void* q, const void* k, const void* v, const void* ks,
                                     const void* vs, void* out, void* part_acc, void* part_m,
                                     void* part_l, int B, int H, int Hkv, int S, int D, int pos,
                                     int n_split, void* stream) {
  if (pos < 0 || pos >= S || ks == nullptr || vs == nullptr) return (int)cudaErrorInvalidValue;
  return run(q, k, v, ks, vs, nullptr, nullptr, out, part_acc, part_m, part_l, B, H, Hkv, S, D,
             pos + 1, n_split, stream);
}

// k, v: the stacked [L, B, Hkv, S, D] cache (bf16 when ks is NULL, else int8
// with f32 [L, B, Hkv, S] scales ks, vs); k_new, v_new: bf16 [B, Hkv, D]
extern "C" int decode_attention_stacked(const void* q, const void* k, const void* v,
                                        const void* ks, const void* vs, const void* k_new,
                                        const void* v_new, void* out, void* part_acc,
                                        void* part_m, void* part_l, int L, int B, int H, int Hkv,
                                        int S, int D, int layer, int pos, int n_split,
                                        void* stream) {
  if (layer < 0 || layer >= L || pos < 0 || pos >= S || k_new == nullptr || v_new == nullptr)
    return (int)cudaErrorInvalidValue;
  const size_t vecs = (size_t)layer * B * Hkv * S;  // vectors before this layer
  const size_t elt = ks != nullptr ? 1 : sizeof(bf16);
  const char* kl = static_cast<const char*>(k) + vecs * D * elt;
  const char* vl = static_cast<const char*>(v) + vecs * D * elt;
  const float* ksl = ks != nullptr ? static_cast<const float*>(ks) + vecs : nullptr;
  const float* vsl = vs != nullptr ? static_cast<const float*>(vs) + vecs : nullptr;
  return run(q, kl, vl, ksl, vsl, k_new, v_new, out, part_acc, part_m, part_l, B, H, Hkv, S, D,
             pos, n_split, stream);
}
