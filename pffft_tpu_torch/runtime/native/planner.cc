// Plan arithmetic of the host runtime: factorization, size validity,
// nearest valid size and twiddle tables.
//
// The port's own copy of the JAX package's native planner, with the
// symbols prefixed pftt_ so that both libraries can live in one process.
// The tables take cos/sin in long double on an exponent reduced exactly in
// integers, then round to double: plan.py computes the same tables with
// numpy's long double, operation for operation, and the two agree bit for
// bit (tests/test_torch_runtime.py).
//
// C ABI only; no exceptions across the boundary.

#include <cmath>
#include <cstdint>
#include <initializer_list>

extern "C" {

// Prime factors of n from {2, 3, 5}, ascending, into factors_out (room for
// 64).  Returns their count, or -1 if n < 1 or n has another prime factor.
int pftt_decompose(uint64_t n, int32_t* factors_out) {
  if (n < 1) return -1;
  int cnt = 0;
  static const uint64_t primes[3] = {2, 3, 5};
  for (int pi = 0; pi < 3; ++pi) {
    while (n % primes[pi] == 0) {
      if (cnt >= 64) return -1;
      factors_out[cnt++] = (int32_t)primes[pi];
      n /= primes[pi];
    }
  }
  return n == 1 ? cnt : -1;
}

// kind: 0 = real, 1 = complex (the pffft.h enum order).
static uint64_t min_fft_size(int kind) { return kind == 0 ? 32 : 16; }

int pftt_is_valid_size(uint64_t n, int kind) {
  const uint64_t m = min_fft_size(kind);
  if (n == 0 || n % m != 0 || n > (1ull << 26)) return 0;
  uint64_t q = n / m;
  for (uint64_t p : {2ull, 3ull, 5ull})
    while (q % p == 0) q /= p;
  return q == 1;
}

uint64_t pftt_nearest_transform_size(uint64_t n, int kind, int higher) {
  const uint64_t m = min_fft_size(kind);
  if (n < m) return m;
  uint64_t c = higher ? ((n + m - 1) / m) * m : (n / m) * m;
  while (!pftt_is_valid_size(c, kind)) {
    if (higher) {
      c += m;
    } else {
      if (c <= m) return m;
      c -= m;
    }
  }
  return c;
}

// T[k, i] = exp(-2 pi j (k*i mod period) / period), k in [l], i in [r],
// row-major [l, r].
void pftt_fill_stage_twiddle(double* out_re, double* out_im, uint64_t l,
                             uint64_t r, uint64_t period) {
  const long double step = -2.0L * 3.14159265358979323846264338327950288L /
                           (long double)period;
  for (uint64_t k = 0; k < l; ++k) {
    for (uint64_t i = 0; i < r; ++i) {
      const uint64_t e = (k * i) % period;
      const long double ang = step * (long double)e;
      out_re[k * r + i] = (double)cosl(ang);
      out_im[k * r + i] = (double)sinl(ang);
    }
  }
}

// Dense DFT matrix W[i, t] = exp(-2 pi j (i*t mod r) / r), row-major [r, r].
void pftt_fill_dft_matrix(double* out_re, double* out_im, uint64_t r) {
  pftt_fill_stage_twiddle(out_re, out_im, r, r, r);
}

// Real-split twiddles B[k] = exp(-2 pi j k / n), k in [n/2].
void pftt_fill_real_split_twiddle(double* out_re, double* out_im, uint64_t n) {
  const uint64_t h = n / 2;
  const long double step = -2.0L * 3.14159265358979323846264338327950288L /
                           (long double)n;
  for (uint64_t k = 0; k < h; ++k) {
    const long double ang = step * (long double)k;
    out_re[k] = (double)cosl(ang);
    out_im[k] = (double)sinl(ang);
  }
}

}  // extern "C"
