// The time-major Stockham chain reading its input from ONE packed buffer (B4).
//
// Replaces pffft_tpu/ops/pallas_fft.py `_build_packed` (entered through
// `cfft_pallas_tmajor_packed`; used by `dispatch.cfft_kern2_tmajor_packed`
// and `dispatch.packed_fwd_route`): a forward complex FFT whose input never
// exists as planar planes.
//
//   slabs = 1: y [n, 2B], re at columns [0, B), im at [B, 2B) -- the free
//              x.reshape(H, 2B) of a real [N, B] signal, z[h] = x[2h] + i x[2h+1].
//   slabs = r: y [m, r*2B], the free wide view of the same buffer for kern2's
//              pass A: slab s of row k holds z[k*r + s] (re at s*2B, im at
//              s*2B + B), and output column s*B + j reads slab s, lane j.
//
// Output is the planar [n, slabs*B] pair, as B1 (stockham_chain.cu) gives on
// the unpacked planes: the same stages on the same values.
//
// Design.  B1 on the register-resident core of regfft.cuh with one more
// load map, PackedColsIn: lane f of a block is column c0 + f, which reads
// slab c / B, lane c mod B, so both slab counts (and a block whose tb
// columns straddle a slab boundary, B % tb != 0) take one code path.  The
// first stage loads straight from the packed buffer into registers, stages
// exchange through one padded [pad(n), tb] tile in shared memory, and the
// last stage stores straight to the planes (ColsOut).  The launch shape is
// B1's planner's (ops/pallas_fft.chain_core_tile).  Forward only, as the
// entry point is.
//
// Bound on this card: 16*n*slabs*B bytes (every input read once, both
// output planes written once) at 3.35 TB/s, the same as B1: the pack costs
// no pass of its own.  What limits it is B1's: the row segment a block reads
// (tb*4 bytes per half-slab; 32 bytes at m = 2048), and the stages of a
// block do not overlap its loads at one block per SM.

#include "regfft.cuh"

namespace {

using pf::rf::kMaxThreads;

template <int E>
__global__ void __launch_bounds__(kMaxThreads, 1)
chain_packed_kernel(const float* __restrict__ y, float* __restrict__ ore,
                    float* __restrict__ oim, const float2* __restrict__ tw,
                    const pf::rf::Plan plan, int b, int seg, int ld, int tb, int shift) {
  extern __shared__ __align__(16) float2 tile[];  // [pad(n), tb]
  const int b0 = blockIdx.x * tb;
  const int cols = min(tb, b - b0);
  const pf::rf::PackedColsIn src{y, ld, seg, b0, cols};
  const pf::rf::ColsSmem sm{tile, tb, shift};
  const pf::rf::ColsOut dst{ore + b0, oim + b0, b, cols};
  pf::rf::run<E, false>(plan, tw, pf::rf::ColLanes{tb}, tb, src, sm, dst, true);
}

using Kernel = decltype(&chain_packed_kernel<32>);

Kernel pick(int elems) { return elems == 16 ? chain_packed_kernel<16> : chain_packed_kernel<32>; }

}  // namespace

extern "C" {

// Forward transform of the packed buffer y ([n, slabs*2*seg]) into planar
// ore/oim ([n, slabs*seg]).  desc and tw as for pf_chain_tmajor, and the
// launch shape (tb, threads, elems, shift) too.  Returns a cudaError_t:
// invalid arguments give cudaErrorInvalidValue, a shape the core cannot
// cover cudaErrorInvalidConfiguration.
int pf_chain_tmajor_packed(const float* y, float* ore, float* oim, const float* tw,
                           const int* desc, int n_stages, int n, int seg, int slabs,
                           int tb, int threads, int elems, int shift, int device,
                           void* stream) {
  if (seg < 1 || slabs < 1 || static_cast<long long>(slabs) * 2 * seg > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  size_t smem;
  cudaError_t err = pf::rf::cols_shape(n, tb, threads, elems, shift, &smem);
  if (err != cudaSuccess) return err;
  pf::rf::Plan plan;
  err = pf::rf::plan_from(desc, n_stages, &plan);
  if (err != cudaSuccess) return err;
  if (!pf::rf::plan_spans(plan, n)) return cudaErrorInvalidValue;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Kernel kernel = pick(elems);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int b = slabs * seg;
  const int blocks = (b + tb - 1) / tb;
  kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      y, ore, oim, reinterpret_cast<const float2*>(tw), plan, b, seg, 2 * slabs * seg, tb,
      shift);
  return cudaGetLastError();
}

}  // extern "C"
