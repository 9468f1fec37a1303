// Single-pass Stockham FFT over all stages of a plan, time-major planes.
//
// Replaces pffft_tpu/ops/pallas_fft.py `_build` / `_make_kernel` /
// `_make_kernel_scratch` (entered through `cfft_pallas_tmajor`): a batched
// complex FFT of planar f32 [N, B] -> [N, B], unscaled, canonical order.
//
// Design (chain.cuh).  One block owns a tile of TB batch columns x all N
// rows.  It loads the [N, TB] re/im tile from global memory (coalesced along
// the batch, which is contiguous in time-major order) into one shared-memory
// buffer, runs every stage there with the registers as the Stockham
// ping-pong's second buffer, and writes the canonical-order result once.
//
// Bound on this card: 16*N*B bytes per pass (each plane read once and
// written once) at 3.35 TB/s; the butterflies' ~5 N log2 N B flops are far
// below the f32 peak.  The design reads and writes device memory once per
// transform, in 16-byte vectors where the tile and batch allow it, with
// several loads in flight per thread; the ragged batch edge is masked
// (b < B).  What it does not do yet: overlap one tile's loads with another's
// stages, which needs two tiles (or a cluster) per SM.

#include "chain.cuh"

namespace {

using pf::kMaxThreads;

template <bool BWD, bool VEC>
__global__ void __launch_bounds__(kMaxThreads, 1)
chain_kernel(const float* __restrict__ re, const float* __restrict__ im,
             float* __restrict__ ore, float* __restrict__ oim,
             const float2* __restrict__ tw, const pf::Stages st, int n, int b, int tb) {
  extern __shared__ __align__(16) float2 tile[];  // [n, tb]
  const int b0 = blockIdx.x * tb;
  const int cols = min(tb, b - b0);
  pf::load_tile<VEC>(tile, pf::Rows{re, im, b}, n, tb, b0, cols);
  __syncthreads();
  pf::run_stages<BWD>(tile, tw, st, tb);
  pf::store_tile<VEC>(tile, ore, oim, n, b, tb, b0, cols);
}

}  // namespace

extern "C" {

// Forward or backward transform of [n, b] planes re/im into ore/oim.
// desc holds n_stages rows of (r, l, m, offset into tw in complex values);
// tw is the concatenation of the stages' [l, r] tables as (re, im) pairs.
// Returns a cudaError_t: invalid arguments give cudaErrorInvalidValue, a
// tile too large for the block gives cudaErrorInvalidConfiguration.
int pf_chain_tmajor(const float* re, const float* im, float* ore, float* oim,
                    const float* tw, const int* desc, int n_stages, int n, int b,
                    int tb, int backward, int device, void* stream) {
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
  auto kernel = backward ? (vec ? chain_kernel<true, true> : chain_kernel<true, false>)
                         : (vec ? chain_kernel<false, true> : chain_kernel<false, false>);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int blocks = (b + tb - 1) / tb;
  kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      re, im, ore, oim, reinterpret_cast<const float2*>(tw), st, n, b, tb);
  return cudaGetLastError();
}

}  // extern "C"
