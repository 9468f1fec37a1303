// Single-pass Stockham FFT over all stages of a plan, time-major planes (B1).
//
// Replaces pffft_tpu/ops/pallas_fft.py `_build` / `_make_kernel` /
// `_make_kernel_scratch` (entered through `cfft_pallas_tmajor`): a batched
// complex FFT of planar f32 [N, B] -> [N, B], unscaled, canonical order.
// kern2's pass A is the same call on the free view [m, r*B].
//
// Design.  One block owns tb batch columns x all N rows and runs the thin
// chain on the register-resident core of regfft.cuh, one lane per column
// (ColLanes: tb neighbouring threads on the tb columns of a row).  Its
// threads read their first stage's inputs straight from the planes into
// registers, exchange between stages through one padded [pad(N), tb] tile
// in shared memory, and write the last stage's outputs straight to the
// output planes: an S-stage plan makes S - 1 exchanges and no separate load
// or store pass through shared memory.  Any B and any alignment take the
// one code path: lanes past B load zeros and store nothing.  The launch
// shape (tb, threads, values a thread, tile padding) is the planner's,
// ops/pallas_fft.chain_core_tile.
//
// Bound on this card: 16*N*B bytes per pass (each plane read once and
// written once) at 3.35 TB/s; the butterflies' ~5 N log2 N B flops are far
// below the f32 peak.  What the design does about it: no shared-memory pass
// of its own for the load or the store, so a thread keeps its first stage's
// loads in flight together.  What limits it: the row segment a block reads
// is tb*4 bytes per plane, and a block holds at most 16384 values, so N =
// 2048 gets 32-byte segments; narrower tiles with two or four blocks per SM
// overlap loads with stages but read shorter segments and run slower (the
// planner's default is the widest tile; chip_smoke.py's chain_sweep line).

#include "regfft.cuh"

namespace {

using pf::rf::kMaxThreads;

template <int E, bool BWD>
__global__ void __launch_bounds__(kMaxThreads, 1)
chain_kernel(const float* __restrict__ re, const float* __restrict__ im,
             float* __restrict__ ore, float* __restrict__ oim,
             const float2* __restrict__ tw, const pf::rf::Plan plan, int b, int tb,
             int shift) {
  extern __shared__ __align__(16) float2 tile[];  // [pad(n), tb]
  const int b0 = blockIdx.x * tb;
  const int cols = min(tb, b - b0);
  const pf::rf::ColsIn src{re + b0, im + b0, b, cols};
  const pf::rf::ColsSmem sm{tile, tb, shift};
  const pf::rf::ColsOut dst{ore + b0, oim + b0, b, cols};
  pf::rf::run<E, BWD>(plan, tw, pf::rf::ColLanes{tb}, tb, src, sm, dst, true);
}

using Kernel = decltype(&chain_kernel<32, false>);

Kernel pick(int elems, bool backward) {
  if (elems == 16) return backward ? chain_kernel<16, true> : chain_kernel<16, false>;
  return backward ? chain_kernel<32, true> : chain_kernel<32, false>;
}

}  // namespace

extern "C" {

// Forward or backward transform of [n, b] planes re/im into ore/oim.
// desc holds n_stages rows of (r, l, m, offset into tw in complex values);
// tw is the concatenation of the stages' transposed [r, l] tables as (re,
// im) pairs.  The launch shape is the planner's: tb columns per block of
// `threads` threads, `elems` (16 or 32) values a thread per stage, the tile
// padded every 2^shift rows.  Returns a cudaError_t: invalid arguments give
// cudaErrorInvalidValue, a shape the core cannot cover
// cudaErrorInvalidConfiguration, a tile too large for the card the error of
// cudaFuncSetAttribute.
int pf_chain_tmajor(const float* re, const float* im, float* ore, float* oim,
                    const float* tw, const int* desc, int n_stages, int n, int b, int tb,
                    int threads, int elems, int shift, int backward, int device,
                    void* stream) {
  if (b < 1) return cudaErrorInvalidValue;
  size_t smem;
  cudaError_t err = pf::rf::cols_shape(n, tb, threads, elems, shift, &smem);
  if (err != cudaSuccess) return err;
  pf::rf::Plan plan;
  err = pf::rf::plan_from(desc, n_stages, &plan);
  if (err != cudaSuccess) return err;
  if (!pf::rf::plan_spans(plan, n)) return cudaErrorInvalidValue;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Kernel kernel = pick(elems, backward != 0);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int blocks = (b + tb - 1) / tb;
  kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      re, im, ore, oim, reinterpret_cast<const float2*>(tw), plan, b, tb, shift);
  return cudaGetLastError();
}

// Blocks of the forward kernel one SM holds at this launch shape
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor, with the registers ptxas
// gave), into *out.  Returns a cudaError_t.
int pf_chain_occupancy(int n, int tb, int threads, int elems, int shift, int device,
                       int* out) {
  size_t smem;
  cudaError_t err = pf::rf::cols_shape(n, tb, threads, elems, shift, &smem);
  if (err != cudaSuccess) return err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Kernel kernel = pick(elems, false);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, threads, smem);
}

}  // extern "C"
