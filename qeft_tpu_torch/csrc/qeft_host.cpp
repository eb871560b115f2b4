// Host-side INT4 plane packing / unpacking and the quantize-to-codes step,
// the port's copy of native/qeft_host.cpp (the JAX package's host library),
// built at first use by qeft_tpu_torch/ops/native.py with native/Makefile's
// flags and loaded through ctypes.  No framework is linked.
//
// The reference (xvyaward/qeft, qlinear.py) packs on the torch host path, a
// CPU hot spot at 70B scale; here each transform is one multi-threaded pass.
//
// Layout contract (qeft_tpu_torch/ops/packing.py, bit for bit):
//   codes [K, N] int32 (values 0..15), group size g (g % 8 == 0), h = g/8,
//   G = K/g; word rows are GROUP-INTERLEAVED (row -> group row % G):
//   packed[jj*G + gi, n] = sum_p codes[gi*g + p*h + jj, n] << 4p
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

void pack_rows(const int32_t* codes, int32_t* out, long k, long n, long g,
               long row_begin, long row_end) {
  const long h = g / 8;
  const long n_groups = k / g;
  for (long j = row_begin; j < row_end; ++j) {
    const long gi = j % n_groups;
    const long jj = j / n_groups;
    int32_t* dst = out + j * n;
    std::memset(dst, 0, sizeof(int32_t) * n);
    for (long p = 0; p < 8; ++p) {
      const int32_t* src = codes + (gi * g + p * h + jj) * n;
      const int shift = 4 * (int)p;
      for (long c = 0; c < n; ++c) {
        dst[c] |= (src[c] & 0xF) << shift;
      }
    }
  }
}

void unpack_rows(const int32_t* packed, int32_t* out, long k, long n, long g,
                 long row_begin, long row_end) {
  const long h = g / 8;
  const long n_groups = k / g;
  for (long j = row_begin; j < row_end; ++j) {
    const long gi = j % n_groups;
    const long jj = j / n_groups;
    const int32_t* src = packed + j * n;
    for (long p = 0; p < 8; ++p) {
      int32_t* dst = out + (gi * g + p * h + jj) * n;
      const int shift = 4 * (int)p;
      for (long c = 0; c < n; ++c) {
        dst[c] = (src[c] >> shift) & 0xF;
      }
    }
  }
}

template <typename F>
void parallel_rows(long rows, F&& fn) {
  unsigned hw = std::thread::hardware_concurrency();
  long nthreads = hw ? (long)hw : 4;
  if (rows < nthreads * 4) {
    fn(0, rows);
    return;
  }
  std::vector<std::thread> threads;
  const long chunk = (rows + nthreads - 1) / nthreads;
  for (long t = 0; t < nthreads; ++t) {
    const long b = t * chunk;
    const long e = b + chunk < rows ? b + chunk : rows;
    if (b >= e) break;
    threads.emplace_back([=, &fn] { fn(b, e); });
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// codes [K, N] -> packed [K/8, N]
void qeft_pack_codes(const int32_t* codes, int32_t* out, long k, long n, long g) {
  if (g <= 0) g = k;
  parallel_rows(k / 8, [&](long b, long e) { pack_rows(codes, out, k, n, g, b, e); });
}

// packed [K/8, N] -> codes [K, N]
void qeft_unpack_codes(const int32_t* packed, int32_t* out, long k, long n, long g) {
  if (g <= 0) g = k;
  parallel_rows(k / 8, [&](long b, long e) { unpack_rows(packed, out, k, n, g, b, e); });
}

// round(w/s + z) (halves away from zero) with clip to [0, 15]: the
// quantize-to-codes step of the reference's QuantLinear.pack, fused with the
// outlier zero-point overwrite.  w [K, N] fp32, scales/zeros [G, N] fp32.
void qeft_quantize_codes(const float* w, const float* scales, const float* zeros,
                         int32_t* out, long k, long n, long g, long n_outlier) {
  if (g <= 0) g = k;
  parallel_rows(k, [&](long b, long e) {
    for (long row = b; row < e; ++row) {
      const long gi = row / g;
      const float* srow = scales + gi * n;
      const float* zrow = zeros + gi * n;
      const float* wrow = w + row * n;
      int32_t* orow = out + row * n;
      const bool is_outlier = row >= k - n_outlier;
      for (long c = 0; c < n; ++c) {
        if (is_outlier) {
          int32_t z = (int32_t)(zrow[c] + 0.5f);
          orow[c] = z < 0 ? 0 : (z > 15 ? 15 : z);
        } else {
          float q = wrow[c] / srow[c] + zrow[c];
          long qi = (long)(q + (q >= 0 ? 0.5f : -0.5f));
          orow[c] = qi < 0 ? 0 : (qi > 15 ? 15 : (int32_t)qi);
        }
      }
    }
  });
}

int qeft_host_version() { return 1; }
}
