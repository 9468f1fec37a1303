// Fused overlap-save block convolution: forward FFT, multiply by the filter
// spectrum, backward FFT, in one pass over device memory.
//
// Replaces pffft_tpu/ops/conv_kernel.py `_build` / `_make_conv_kernel` /
// `_make_conv_kernel_scratch` (entered through `zconv_pallas_tmajor`, called
// from FastConv's "fused" route): for time-major f32 planes [N, B], column
// by column,
//
//   y = IFFT(FFT(x) * Hf),   Hf = FFT(g) / N  (filter_spectrum: the 1/N of
//                                              the inverse is folded in).
//
// Design (chain.cuh).  One block owns a tile of TB columns x all N rows in
// shared memory: it loads the tile once, runs every forward stage, multiplies
// row k by Hf[k] (read through the read-only cache, broadcast over the
// columns), runs every backward stage (the forward twiddle tables used
// conjugated, as the planar chain's backward does) and stores the tile once.
// Neither chain scales: the 1/N is in Hf.  The ragged last tile is masked.
// The tile budget is the chain's (N*TB <= 16384 values, 512 threads), so
// the fused route serves nfft <= 2048; longer blocks take the composed route.
//
// A real filter's Hf is Hermitian, so a column holding two real frames
// (re = a, im = b) comes back as (h*a) + i(h*b): FastConv packs two real
// frames per column.  A complex filter's column holds one complex frame.
//
// Bound on this card: 16*N*B bytes per call (both planes read once and
// written once) at 3.35 TB/s, the planar chain's bound; the two chains'
// ~10 N log2 N B flops stay far below the f32 peak.  The TPU's scratch and
// unrolled forms exist for its compiler and have no counterpart.

#include "chain.cuh"

namespace {

using pf::kMaxThreads;

template <bool VEC>
__global__ void __launch_bounds__(kMaxThreads, 1)
conv_kernel(const float* __restrict__ re, const float* __restrict__ im,
            float* __restrict__ ore, float* __restrict__ oim,
            const float* __restrict__ hfr, const float* __restrict__ hfi,
            const float2* __restrict__ tw, const pf::Stages st, int n, int b, int tb) {
  extern __shared__ __align__(16) float2 tile[];  // [n, tb]
  const int b0 = blockIdx.x * tb;
  const int cols = min(tb, b - b0);
  pf::load_tile<VEC>(tile, pf::Rows{re, im, b}, n, tb, b0, cols);
  __syncthreads();
  pf::run_stages<false>(tile, tw, st, tb);  // ends after a barrier
  const int total = n * tb;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int row = e / tb;
    tile[e] = pf::cmul(tile[e], __ldg(hfr + row), __ldg(hfi + row));
  }
  __syncthreads();
  pf::run_stages<true>(tile, tw, st, tb);
  pf::store_tile<VEC>(tile, ore, oim, n, b, tb, b0, cols);
}

}  // namespace

extern "C" {

// Block convolution of [n, b] planes re/im into ore/oim with the filter
// spectrum hfr/hfi ([n], canonical order, pre-scaled by 1/n).  desc and tw
// as for pf_chain_tmajor (the forward tables; the backward chain conjugates
// them).  Returns a cudaError_t: invalid arguments give
// cudaErrorInvalidValue, a tile too large for the block
// cudaErrorInvalidConfiguration.
int pf_conv_fused_tmajor(const float* re, const float* im, float* ore, float* oim,
                         const float* hfr, const float* hfi, const float* tw,
                         const int* desc, int n_stages, int n, int b, int tb, int device,
                         void* stream) {
  if (b < 1) return cudaErrorInvalidValue;
  pf::Stages st;
  int threads;
  size_t smem;
  cudaError_t err = pf::chain_config(desc, n_stages, n, tb, &st, &threads, &smem);
  if (err != cudaSuccess) return err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const bool vec = tb % 4 == 0 && b % 4 == 0 && pf::aligned16(re) && pf::aligned16(im) &&
                   pf::aligned16(ore) && pf::aligned16(oim);
  auto kernel = vec ? conv_kernel<true> : conv_kernel<false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int blocks = (b + tb - 1) / tb;
  kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      re, im, ore, oim, hfr, hfi, reinterpret_cast<const float2*>(tw), st, n, b, tb);
  return cudaGetLastError();
}

}  // extern "C"
