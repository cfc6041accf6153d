// Native CPU oracle library.
//
// Re-implements the reference's device algorithms in portable C++ so the
// test/bench harness can verify device results bit-exactly at native speed:
//
//   * the six RNG generator recurrences (src/cl_ops/rng/clo_rng_lcg.cl:43-59,
//     clo_rng_xorshift64.cl:43-63, clo_rng_xorshift128.cl:42-59,
//     clo_rng_mwc64x.cl:42-62, clo_rng_parkmiller.cl:43-59,
//     clo_rng_tauslcg.cl:51-100) including the exact seed conversions
//     (clo_ulong2statetype) — streams must match the framework's vectorized
//     generators bit for bit;
//   * serial exclusive scan with a wider sum type
//     (src/benchmarks/clo_scan_bench.c:246-260 check loop);
//   * sortedness check + std::sort oracle
//     (src/benchmarks/clo_sort_bench.c:216-227);
//   * typed uniform random fill (src/benchmarks/clo_bench.c:67-142).
//
// Exposed as a C ABI for ctypes (no pybind11 in this image).

#include <algorithm>
#include <cstdint>
#include <cstring>

extern "C" {

// ---------- RNG oracles ----------
// Each fills out[d * n_streams + s] with draw d of stream s, seeding stream
// s from seeds[s] exactly like the reference's clo_ulong2statetype.

void clo_oracle_rng_lcg(const uint64_t* seeds, int64_t n_streams,
                        int64_t draws, uint32_t* out) {
  for (int64_t s = 0; s < n_streams; ++s) {
    uint64_t st = seeds[s];
    for (int64_t d = 0; d < draws; ++d) {
      st = (st * 0x5DEECE66DULL + 0xBULL) & ((1ULL << 48) - 1);
      out[d * n_streams + s] = (uint32_t)(st >> 16);
    }
  }
}

void clo_oracle_rng_xorshift64(const uint64_t* seeds, int64_t n_streams,
                               int64_t draws, uint32_t* out) {
  for (int64_t s = 0; s < n_streams; ++s) {
    uint64_t st = seeds[s];
    for (int64_t d = 0; d < draws; ++d) {
      st ^= st << 21;
      st ^= st >> 35;
      st ^= st << 4;
      out[d * n_streams + s] = (uint32_t)st;
    }
  }
}

void clo_oracle_rng_xorshift128(const uint64_t* seeds, int64_t n_streams,
                                int64_t draws, uint32_t* out) {
  for (int64_t s = 0; s < n_streams; ++s) {
    uint64_t sd = seeds[s];
    // (s, s>>16, s>>32, s>>46) each truncated to 32 bits
    uint32_t x = (uint32_t)sd, y = (uint32_t)(sd >> 16),
             z = (uint32_t)(sd >> 32), w = (uint32_t)(sd >> 46);
    for (int64_t d = 0; d < draws; ++d) {
      uint32_t t = x ^ (x << 11);
      uint32_t wn = w ^ (w >> 19) ^ (t ^ (t >> 8));
      x = y; y = z; z = w; w = wn;
      out[d * n_streams + s] = wn;
    }
  }
}

void clo_oracle_rng_mwc64x(const uint64_t* seeds, int64_t n_streams,
                           int64_t draws, uint32_t* out) {
  const uint32_t A = 4294883355u;
  for (int64_t s = 0; s < n_streams; ++s) {
    uint32_t x = (uint32_t)seeds[s];
    uint32_t c = (uint32_t)(seeds[s] >> 32);
    for (int64_t d = 0; d < draws; ++d) {
      uint32_t res = x ^ c;
      uint32_t hi = (uint32_t)(((uint64_t)x * A) >> 32);
      uint32_t xn = x * A + c;
      c = hi + (xn < c ? 1u : 0u);
      x = xn;
      out[d * n_streams + s] = res;
    }
  }
}

void clo_oracle_rng_parkmiller(const uint64_t* seeds, int64_t n_streams,
                               int64_t draws, uint32_t* out) {
  for (int64_t s = 0; s < n_streams; ++s) {
    int32_t st = (int32_t)(uint32_t)seeds[s];
    for (int64_t d = 0; d < draws; ++d) {
      int64_t v = (int64_t)st * 16807;
      st = (int32_t)(v % 2147483647LL);
      out[d * n_streams + s] = ((uint32_t)st) << 1;
    }
  }
}

static inline uint32_t taus_step(uint32_t z, int s1, int s2, int s3,
                                 uint32_t m) {
  uint32_t b = ((z << s1) ^ z) >> s2;
  return ((z & m) << s3) ^ b;
}

void clo_oracle_rng_tauslcg(const uint64_t* seeds, int64_t n_streams,
                            int64_t draws, uint32_t* out) {
  for (int64_t s = 0; s < n_streams; ++s) {
    uint32_t lo = (uint32_t)seeds[s], hi = (uint32_t)(seeds[s] >> 32);
    uint32_t x = lo, y = hi, z = lo, w = hi;  // as_uint4((ulong2)(seed,seed))
    for (int64_t d = 0; d < draws; ++d) {
      uint32_t nx = taus_step(y, 13, 19, 12, 4294967294u);
      uint32_t ny = taus_step(z, 2, 25, 4, 4294967288u);
      uint32_t nz = taus_step(w, 3, 11, 17, 4294967294u);
      uint32_t nw = 1664525u * x + 1013904223u;
      x = nx; y = ny; z = nz; w = nw;
      out[d * n_streams + s] = nx;
    }
  }
}

// ---------- scan oracle ----------

void clo_oracle_scan_u32_u64(const uint32_t* in, int64_t n, uint64_t* out) {
  uint64_t acc = 0;
  for (int64_t i = 0; i < n; ++i) {
    out[i] = acc;
    acc += in[i];
  }
}

void clo_oracle_scan_u64_u64(const uint64_t* in, int64_t n, uint64_t* out) {
  uint64_t acc = 0;
  for (int64_t i = 0; i < n; ++i) {
    out[i] = acc;
    acc += in[i];
  }
}

// ---------- sort oracles ----------

int32_t clo_oracle_check_sorted_u32(const uint32_t* in, int64_t n) {
  for (int64_t i = 1; i < n; ++i)
    if (in[i - 1] > in[i]) return 0;
  return 1;
}

int32_t clo_oracle_check_sorted_u64(const uint64_t* in, int64_t n) {
  for (int64_t i = 1; i < n; ++i)
    if (in[i - 1] > in[i]) return 0;
  return 1;
}

void clo_oracle_sort_u32(uint32_t* data, int64_t n) {
  std::sort(data, data + n);
}

void clo_oracle_sort_u64(uint64_t* data, int64_t n) {
  std::sort(data, data + n);
}

// ---------- typed random fill (clo_bench_rand parity) ----------
// Simple xorshift64* host PRNG; ranges per type like clo_bench.c:67-142.

void clo_oracle_rand_u32(uint64_t seed, int64_t n, uint32_t* out) {
  uint64_t st = seed ? seed : 0x9E3779B97F4A7C15ULL;
  for (int64_t i = 0; i < n; ++i) {
    st ^= st >> 12; st ^= st << 25; st ^= st >> 27;
    out[i] = (uint32_t)((st * 0x2545F4914F6CDD1DULL) >> 32);
  }
}

void clo_oracle_rand_u64(uint64_t seed, int64_t n, uint64_t* out) {
  uint64_t st = seed ? seed : 0x9E3779B97F4A7C15ULL;
  for (int64_t i = 0; i < n; ++i) {
    st ^= st >> 12; st ^= st << 25; st ^= st >> 27;
    out[i] = st * 0x2545F4914F6CDD1DULL;
  }
}

}  // extern "C"
