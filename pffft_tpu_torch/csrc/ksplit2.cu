// B10, the in-kernel ksplit: a one-pass N = m*r FFT of time-major planes.
//
// Replaces pffft_tpu/ops/dispatch.py `_build_ksplit2` / `_make_ksplit2_kernel`
// (entered through `cfft_ksplit2_tmajor`).  Planes [N, B] viewed as [m, r, B]
// (free, row-major) hold in slab c the decimated sequence x[c::r].  One pass
// computes the length-m transform Z_c of every slab, then
//
//   X[s*m + k] = sum_c W_N^{c*k} W_r^{c*s} Z_c[k],   r in {2,3,4,5,8,16,32},
//
// and stores the canonical ordered spectrum [N, B], unscaled, both
// directions.  It is the function of kern2 (stockham_chain.cu on [m, r*B],
// then combine.cu) in one round trip through device memory.
//
// Design (chain.cuh).  A block loads the [N, tb] block of its tb batch
// columns into one float2 tile in shared memory.  Row-major that tile is
// [m, r*tb]: the r slabs side by side, slab c at columns [c*tb, (c+1)*tb).
// The block runs the m-plan's stages on it with r*tb columns (run_stages),
// then one more twiddled radix-r stage with l = m, m' = 1 and tb columns,
// reading the last stage's [m, r] table W_N^{c*k}: combine.cu's arithmetic,
// done in shared memory.  Then it stores the [N, tb] tile once.
//
// Bound on this card: 16*N*B bytes in one pass (each plane read once and
// written once), 0.0801 ms for a 64 MB plane pair at 3.35 TB/s; the
// butterflies' ~5 N log2 N B flops are far below the f32 peak.  The tile
// holds all N rows, so N*tb <= 16384 (the chain's register ping-pong):
// tb = 4 / 2 / 1 at N = 4096 / 8192 / 16384, 16-, 8- and 4-byte row
// segments, and a narrow segment uses a fraction of each 32-byte sector it
// loads.  That is this simple form's known cost; a cluster of r blocks, one
// slab each, is the form that widens it (ROADMAP D2).  The ragged last tile
// is masked (b < B).
//
// Build.  This file is compiled once per combine radix, with
// -DPF_KSPLIT2_RADIX=r, into a library of its own (ops/_build.py): each
// holds four kernels (direction x load form), the seven builds run in
// parallel, and a call loads only the radix it needs.

#include "chain.cuh"

#ifndef PF_KSPLIT2_RADIX
#error "build with -DPF_KSPLIT2_RADIX=r, r in {2,3,4,5,8,16,32}"
#endif

namespace {

using pf::kMaxThreads;

constexpr int kRadix = PF_KSPLIT2_RADIX;
static_assert(kRadix == 2 || kRadix == 3 || kRadix == 4 || kRadix == 5 || kRadix == 8 ||
                  kRadix == 16 || kRadix == 32,
              "PF_KSPLIT2_RADIX is not a combine radix");

// R, the combine's radix, is a template argument: one kernel per radix
// keeps the register pressure of the other radices' butterflies out of it.
template <int R, bool BWD, bool VEC>
__global__ void __launch_bounds__(kMaxThreads, 1)
ksplit2_kernel(const float* __restrict__ re, const float* __restrict__ im,
               float* __restrict__ ore, float* __restrict__ oim,
               const float2* __restrict__ tw, const pf::Stages st, int last_off, int n,
               int b, int tb) {
  extern __shared__ __align__(16) float2 tile[];  // [n, tb] = [m, R*tb]
  const int b0 = blockIdx.x * tb;
  const int cols = min(tb, b - b0);
  pf::load_tile<VEC>(tile, pf::Rows{re, im, b}, n, tb, b0, cols);
  __syncthreads();
  pf::run_stages<BWD>(tile, tw, st, R * tb);
  // the twiddled radix-R combine on the [m, R, tb] tile (l = m, m' = 1)
  pf::stage<R, BWD>(tile, tw + last_off, n / R, 1, tb);
  pf::store_tile<VEC>(tile, ore, oim, n, b, tb, b0, cols);
}

template <int R>
cudaError_t launch(const float* re, const float* im, float* ore, float* oim, const float2* tw,
                   const pf::Stages& st, int last_off, int n, int b, int tb, bool backward,
                   bool vec, int threads, size_t smem, cudaStream_t stream) {
  auto kernel = backward
                    ? (vec ? ksplit2_kernel<R, true, true> : ksplit2_kernel<R, true, false>)
                    : (vec ? ksplit2_kernel<R, false, true> : ksplit2_kernel<R, false, false>);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int blocks = (b + tb - 1) / tb;
  kernel<<<blocks, threads, smem, stream>>>(re, im, ore, oim, tw, st, last_off, n, b, tb);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Forward or backward transform of [n, b] planes re/im into ore/oim.
// desc holds n_stages rows of (r, l, m, offset into tw in complex values):
// the m-plan's stages, then the combine stage (r, m, 1, offset) with
// m*r == n; tw is the concatenation of their [l, r] tables as (re, im)
// pairs.  The combine radix r must be this library's PF_KSPLIT2_RADIX.
// Returns a cudaError_t: invalid arguments give cudaErrorInvalidValue, a
// tile too large for the block cudaErrorInvalidConfiguration.
int pf_ksplit2_tmajor(const float* re, const float* im, float* ore, float* oim,
                      const float* tw, const int* desc, int n_stages, int n, int b, int tb,
                      int backward, int device, void* stream) {
  if (b < 1 || n_stages < 2) return cudaErrorInvalidValue;
  const int* last = desc + 4 * (n_stages - 1);
  const int r = last[0], m = last[1];
  if (r != kRadix) return cudaErrorInvalidValue;
  if (last[2] != 1 || static_cast<long long>(m) * r != n) return cudaErrorInvalidValue;
  pf::Stages st;
  int threads;
  size_t smem;
  cudaError_t err = pf::chain_config(desc, n_stages - 1, n, tb, &st, &threads, &smem);
  if (err != cudaSuccess) return err;
  // the combine stage's butterflies per thread, as chain_config counts a stage's
  const long long per_thread = r * (pf::kElems / r);
  const long long need = (static_cast<long long>(n) * tb + per_thread - 1) / per_thread;
  if (need > kMaxThreads) return cudaErrorInvalidConfiguration;
  if (need > threads) threads = static_cast<int>((need + 31) / 32 * 32);
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const bool vec = tb % 4 == 0 && b % 4 == 0 && pf::aligned16(re) && pf::aligned16(im) &&
                   pf::aligned16(ore) && pf::aligned16(oim);
  return launch<kRadix>(re, im, ore, oim, reinterpret_cast<const float2*>(tw), st, last[3],
                        n, b, tb, backward != 0, vec, threads, smem,
                        static_cast<cudaStream_t>(stream));
}

}  // extern "C"
