// Fused two-stage FFT of batch-major planes [B, N], one pass (kernel B9).
//
// Replaces pffft_tpu/ops/fused_stage.py `_build` / `_make_kernel` (entered
// through `cfft_fused2`): a batched complex FFT of planar f32 rows, N = n1*n2,
// unscaled both directions, written in canonical order (out[b, k]) or in the
// internal k1-major order of the two factors (out[b, k1*n2 + k2] holds bin
// k = k1 + n1*k2).
//
// Design.  The TPU kernel runs two dense r x r DFT matmuls on the MXU; in
// true fp32 a dense 64-term stage loses the 140 dB carrier bound, so the
// arithmetic here is the thin radix-16/8/4/2/5/3 Stockham chain (the ordered
// spectrum does not depend on the factorization), and (n1, n2) only define
// the internal order, applied as an index map at the store.  The chain runs
// on the register-resident core of regfft.cuh: a block owns `rows` whole
// rows (one for N >= 2048, more for small N, planned by
// ops/fused_stage.fused2_tile), its threads read their first stage's inputs
// straight from the rows into registers (neighbouring threads on
// neighbouring elements of a row: coalesced, any alignment, any N), exchange
// between stages through one padded row buffer in shared memory, and write
// the last stage's outputs straight to the output rows, again coalesced.
// The internal order goes through shared memory once more: the last stage
// writes there, and the store reads each output position's bin.  Rows past
// B are masked.
//
// Bound on this card: 16*N*B bytes per call (both planes read once and
// written once) at 3.35 TB/s; the chain's ~5 N log2 N B flops are far below
// the f32 peak.  What the design does about it: the row buffer is N*8*17/16
// bytes, so for N <= 8192 two or more blocks share an SM and one block's
// loads and stores overlap another's stages; there is no transposed tile and
// no separate load or store pass through shared memory.

#include "regfft.cuh"

namespace {

using pf::rf::kMaxThreads;

// Rows r0 .. r0 + valid - 1 of [b, n] planes in device memory.
struct RowsIn {
  const float* re;
  const float* im;
  int n, valid;
  __device__ __forceinline__ float2 load(int f, int p) const {
    if (f >= valid) return make_float2(0.0f, 0.0f);
    const size_t g = static_cast<size_t>(f) * n + p;
    return make_float2(__ldg(re + g), __ldg(im + g));
  }
};

struct RowsOut {
  float* re;
  float* im;
  int n, valid;
  __device__ __forceinline__ void store(int f, int p, float2 v) const {
    if (f >= valid) return;
    const size_t g = static_cast<size_t>(f) * n + p;
    re[g] = v.x;
    im[g] = v.y;
  }
};

// The block's rows in shared memory, `pitch` float2 apart.
struct RowsSmem {
  float2* tile;
  int pitch, shift;
  __device__ __forceinline__ float2 load(int f, int p) const {
    return tile[f * pitch + pf::rf::pad(p, shift)];
  }
  __device__ __forceinline__ void store(int f, int p, float2 v) const {
    tile[f * pitch + pf::rf::pad(p, shift)] = v;
  }
};

// Output position p of a row reads canonical bin k = k2*n1 + k1, where
// p = k1*n2 + k2.
__device__ __forceinline__ int source_bin(int p, int n1, int n2) {
  const int k1 = p / n2;
  return (p - k1 * n2) * n1 + k1;
}

template <int E, bool BWD>
__global__ void __launch_bounds__(kMaxThreads, 1)
fused2_kernel(const float* __restrict__ re, const float* __restrict__ im,
              float* __restrict__ ore, float* __restrict__ oim,
              const float2* __restrict__ tw, const pf::rf::Plan plan, int n, int b, int rows,
              int pitch, int shift, bool ordered, int n1, int n2) {
  extern __shared__ __align__(16) float2 tile[];  // [rows, pitch]
  const int r0 = blockIdx.x * rows;
  const int valid = min(rows, b - r0);
  const size_t at = static_cast<size_t>(r0) * n;
  const RowsIn src{re + at, im + at, n, valid};
  const RowsSmem sm{tile, pitch, shift};
  const RowsOut dst{ore + at, oim + at, n, valid};
  pf::rf::run<E, BWD>(plan, tw, pf::rf::RowLanes{}, rows, src, sm, dst, ordered);
  if (!ordered) {  // the canonical spectrum is in the tile
    for (int e = threadIdx.x; e < valid * n; e += blockDim.x) {
      const int f = e / n, p = e - f * n;
      dst.store(f, p, sm.load(f, source_bin(p, n1, n2)));
    }
  }
}

template <int E>
cudaError_t launch(const float* re, const float* im, float* ore, float* oim, const float2* tw,
                   const pf::rf::Plan& plan, int n, int b, int rows, int threads, int pitch,
                   int shift, bool ordered, int n1, int n2, bool backward,
                   cudaStream_t stream) {
  auto kernel = backward ? fused2_kernel<E, true> : fused2_kernel<E, false>;
  const size_t smem = static_cast<size_t>(rows) * pitch * sizeof(float2);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int blocks = (b + rows - 1) / rows;
  kernel<<<blocks, threads, smem, stream>>>(re, im, ore, oim, tw, plan, n, b, rows, pitch,
                                            shift, ordered, n1, n2);
  return cudaGetLastError();
}

// The launch shape's checks.
cudaError_t check_shape(int n, int rows, int threads, int elems, int pitch, int shift) {
  if (n < 1 || rows < 1 || threads < 32 || threads % 32 || shift < 1 ||
      (elems != 16 && elems != 32) || pitch < pf::rf::pad(n - 1, shift) + 1) {
    return cudaErrorInvalidValue;
  }
  // the core's coverage: every stage's butterflies in one pass of the block
  if (static_cast<long long>(threads) * elems < static_cast<long long>(rows) * n ||
      threads > kMaxThreads) {
    return cudaErrorInvalidConfiguration;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Forward or backward transform of the [b, n] planes re/im into ore/oim, in
// canonical order (ordered = 1) or the internal order of n = n1 * n2.  desc
// (n_stages rows of r, l, m, offset) and tw (each stage's transposed [r, l]
// twiddle table as (re, im) pairs) describe the thin chain.  The launch
// shape is the planner's (ops/fused_stage.fused2_tile): `rows` rows per
// block of `threads` threads, `elems` (16 or 32) values per thread per
// stage, row buffers `pitch` float2 apart, padded every 2^shift.  Returns a
// cudaError_t: invalid arguments give cudaErrorInvalidValue, a shape the
// core cannot cover cudaErrorInvalidConfiguration, a buffer too large for
// the card the error of cudaFuncSetAttribute.
int pf_fused2(const float* re, const float* im, float* ore, float* oim, const float* tw,
              const int* desc, int n_stages, int n, int b, int rows, int threads, int elems,
              int pitch, int shift, int n1, int n2, int ordered, int backward, int device,
              void* stream) {
  if (b < 1 || n1 < 1 || n2 < 1 || n1 * n2 != n) return cudaErrorInvalidValue;
  cudaError_t err = check_shape(n, rows, threads, elems, pitch, shift);
  if (err != cudaSuccess) return err;
  pf::rf::Plan plan;
  err = pf::rf::plan_from(desc, n_stages, &plan);
  if (err != cudaSuccess) return err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto go = elems == 16 ? launch<16> : launch<32>;
  return go(re, im, ore, oim, reinterpret_cast<const float2*>(tw), plan, n, b, rows, threads,
            pitch, shift, ordered != 0, n1, n2, backward != 0,
            static_cast<cudaStream_t>(stream));
}

}  // extern "C"
