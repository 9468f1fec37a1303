// The Stockham chain reading its re/im tiles from ONE packed buffer.
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
// Output is the planar [n, slabs*B] pair, as the planar chain would give on
// the unpacked planes (bit for bit: the same stages on the same values).
//
// Design.  The planar chain (chain.cuh) with a load-side index map (Rows for
// one slab, Slabs for r); the stages and the store are unchanged.  With
// B % 4 == 0 a group of 4 columns is one 16-byte vector that never crosses a
// slab; otherwise the loads are scalar.  Bound: 16*n*slabs*B bytes (every
// input read once, both output planes written once) at 3.35 TB/s, the same
// as the planar chain: the pack costs no pass of its own.

#include "chain.cuh"

namespace {

using pf::kMaxThreads;

template <bool VEC, class Src>
__global__ void __launch_bounds__(kMaxThreads, 1)
chain_packed_kernel(const Src src, float* __restrict__ ore, float* __restrict__ oim,
                    const float2* __restrict__ tw, const pf::Stages st, int n, int b,
                    int tb) {
  extern __shared__ __align__(16) float2 tile[];  // [n, tb]
  const int b0 = blockIdx.x * tb;
  const int cols = min(tb, b - b0);
  pf::load_tile<VEC>(tile, src, n, tb, b0, cols);
  __syncthreads();
  pf::run_stages<false>(tile, tw, st, tb);
  pf::store_tile<VEC>(tile, ore, oim, n, b, tb, b0, cols);
}

template <bool VEC, class Src>
cudaError_t launch(const Src src, float* ore, float* oim, const float* tw,
                   const pf::Stages& st, int n, int b, int tb, int threads, size_t smem,
                   cudaStream_t stream) {
  auto kernel = chain_packed_kernel<VEC, Src>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int blocks = (b + tb - 1) / tb;
  kernel<<<blocks, threads, smem, stream>>>(src, ore, oim,
                                            reinterpret_cast<const float2*>(tw), st, n,
                                            b, tb);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Forward transform of the packed buffer y ([n, slabs*2*seg]) into planar
// ore/oim ([n, slabs*seg]).  desc and tw as for pf_chain_tmajor.  Returns a
// cudaError_t.
int pf_chain_tmajor_packed(const float* y, float* ore, float* oim, const float* tw,
                           const int* desc, int n_stages, int n, int seg, int slabs,
                           int tb, int device, void* stream) {
  if (seg < 1 || slabs < 1) return cudaErrorInvalidValue;
  pf::Stages st;
  int threads;
  size_t smem;
  cudaError_t err = pf::chain_config(desc, n_stages, n, tb, &st, &threads, &smem);
  if (err != cudaSuccess) return err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int b = slabs * seg;
  const bool vec = tb % 4 == 0 && seg % 4 == 0 && pf::aligned16(y) &&
                   pf::aligned16(ore) && pf::aligned16(oim);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (slabs == 1) {
    const pf::Rows src{y, y + seg, 2 * seg};
    return vec ? launch<true>(src, ore, oim, tw, st, n, b, tb, threads, smem, s)
               : launch<false>(src, ore, oim, tw, st, n, b, tb, threads, smem, s);
  }
  const pf::Slabs src{y, y + seg, slabs * 2 * seg, seg};
  return vec ? launch<true>(src, ore, oim, tw, st, n, b, tb, threads, smem, s)
             : launch<false>(src, ore, oim, tw, st, n, b, tb, threads, smem, s);
}

}  // extern "C"
