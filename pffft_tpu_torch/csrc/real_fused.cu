// One-pass real transform: the length-H chain and the real split step in
// one kernel, time-major.
//
// Replaces pffft_tpu/ops/pallas_fft.py `_build_real_fused` /
// `_make_kernel_real_fused` (entered through `rfft_pallas_tmajor_fused` and
// `rfft_bwd_pallas_tmajor_fused`).  H = N/2:
//
//   forward:  packed real input y [H, 2B] (the free x.reshape(H, 2B) of a
//             real [N, B] signal) -> the chain -> REAL_FINALIZE -> packed
//             spectrum planes [H, B] x2, bin0 = DC + i*Nyquist.
//   backward: spectrum planes [H, B] x2 -> REAL_PREPROCESS (2*Z) -> the
//             backward chain -> the planar pre-interleave pair [H, B] x2.
//
// Design.  The chain of chain.cuh on an [H, TB] tile in shared memory; the
// split step needs row (H - k) % H beside row k, which is already in the
// tile, so the Hermitian mirror is a shared-memory read (the TPU kernel's
// roll network, and its power-of-two limit on H, are not needed).  Forward:
// the packed load, the stages, then REAL_FINALIZE fused into the store (it
// only reads the tile).  Backward: the load, a barrier, REAL_PREPROCESS in
// place, a barrier, the backward stages, the planar store.  In place, output
// rows k and H - k both need input rows k and H - k, so one thread owns the
// pair and writes both; rows 0 and H/2 are their own mirrors.  The split
// twiddles (8*H bytes) are read through the read-only cache, not staged in
// shared memory, so the tile plan of the chain holds unchanged.
//
// Bound on this card: 16*H*B bytes per call (the [N, B] input read once,
// both [H, B] output planes written once), 0.0401 ms at 64 MB per plane at
// 3.35 TB/s; the flops are those of the chain plus ~16 per output, far below
// the f32 peak.

#include "chain.cuh"
#include "real.cuh"

namespace {

using pf::kMaxThreads;

// REAL_FINALIZE from the tile into planar [n, b] planes ore/oim.
template <bool VEC>
__device__ __forceinline__ void store_finalize(const float2* tile, const float* __restrict__ wr,
                                               const float* __restrict__ wi,
                                               float* __restrict__ ore,
                                               float* __restrict__ oim, int n, int b,
                                               int tb, int b0, int cols) {
  if constexpr (VEC) {
    const int q4 = tb / 4;
    const int quads = n * q4;
    for (int q = threadIdx.x; q < quads; q += blockDim.x) {
      const int row = q / q4, c = (q - row * q4) * 4;
      if (c >= cols) continue;
      const int mrow = row == 0 ? 0 : n - row;
      const float w_r = __ldg(wr + row), w_i = __ldg(wi + row);
      const float4* zt = reinterpret_cast<const float4*>(tile + row * tb + c);
      const float4* ft = reinterpret_cast<const float4*>(tile + mrow * tb + c);
      const float4 z0 = zt[0], z1 = zt[1], f0 = ft[0], f1 = ft[1];
      const bool r0 = row == 0;
      const float2 x0 = pf::real_finalize(make_float2(z0.x, z0.y), make_float2(f0.x, f0.y),
                                          w_r, w_i, r0);
      const float2 x1 = pf::real_finalize(make_float2(z0.z, z0.w), make_float2(f0.z, f0.w),
                                          w_r, w_i, r0);
      const float2 x2 = pf::real_finalize(make_float2(z1.x, z1.y), make_float2(f1.x, f1.y),
                                          w_r, w_i, r0);
      const float2 x3 = pf::real_finalize(make_float2(z1.z, z1.w), make_float2(f1.z, f1.w),
                                          w_r, w_i, r0);
      const size_t g = static_cast<size_t>(row) * b + b0 + c;
      *reinterpret_cast<float4*>(ore + g) = make_float4(x0.x, x1.x, x2.x, x3.x);
      *reinterpret_cast<float4*>(oim + g) = make_float4(x0.y, x1.y, x2.y, x3.y);
    }
  } else {
    const int total = n * tb;
    for (int e = threadIdx.x; e < total; e += blockDim.x) {
      const int row = e / tb, col = e - row * tb;
      if (col >= cols) continue;
      const int mrow = row == 0 ? 0 : n - row;
      const float2 x = pf::real_finalize(tile[e], tile[mrow * tb + col], __ldg(wr + row),
                                         __ldg(wi + row), row == 0);
      const size_t g = static_cast<size_t>(row) * b + b0 + col;
      ore[g] = x.x;
      oim[g] = x.y;
    }
  }
}

// REAL_PREPROCESS in place on the tile: one thread per (row pair, column).
__device__ __forceinline__ void prep_in_place(float2* tile, const float* __restrict__ wr,
                                              const float* __restrict__ wi, int n, int tb) {
  const int items = (n / 2 + 1) * tb;  // rows k = 0 .. n/2 pair with n - k
  for (int u = threadIdx.x; u < items; u += blockDim.x) {
    const int k = u / tb, col = u - k * tb;
    const int m = k == 0 ? 0 : n - k;
    float2* sk = tile + k * tb + col;
    float2* sm = tile + m * tb + col;
    const float2 s = *sk, f = *sm;
    const float2 zk = pf::real_prep(s, f, __ldg(wr + k), __ldg(wi + k), k == 0);
    if (m != k) *sm = pf::real_prep(f, s, __ldg(wr + m), __ldg(wi + m), false);
    *sk = zk;
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kMaxThreads, 1)
rfft_fused_fwd(const float* __restrict__ y, float* __restrict__ ore, float* __restrict__ oim,
               const float2* __restrict__ tw, const float* __restrict__ wr,
               const float* __restrict__ wi, const pf::Stages st, int n, int b, int tb) {
  extern __shared__ __align__(16) float2 tile[];  // [n, tb]
  const int b0 = blockIdx.x * tb;
  const int cols = min(tb, b - b0);
  pf::load_tile<VEC>(tile, pf::Rows{y, y + b, 2 * b}, n, tb, b0, cols);
  __syncthreads();
  pf::run_stages<false>(tile, tw, st, tb);
  store_finalize<VEC>(tile, wr, wi, ore, oim, n, b, tb, b0, cols);
}

template <bool VEC>
__global__ void __launch_bounds__(kMaxThreads, 1)
rfft_fused_bwd(const float* __restrict__ sr, const float* __restrict__ si,
               float* __restrict__ ore, float* __restrict__ oim,
               const float2* __restrict__ tw, const float* __restrict__ wr,
               const float* __restrict__ wi, const pf::Stages st, int n, int b, int tb) {
  extern __shared__ __align__(16) float2 tile[];  // [n, tb]
  const int b0 = blockIdx.x * tb;
  const int cols = min(tb, b - b0);
  pf::load_tile<VEC>(tile, pf::Rows{sr, si, b}, n, tb, b0, cols);
  __syncthreads();
  prep_in_place(tile, wr, wi, n, tb);
  __syncthreads();
  pf::run_stages<true>(tile, tw, st, tb);
  pf::store_tile<VEC>(tile, ore, oim, n, b, tb, b0, cols);
}

// Checks the arguments, plans the tile and sets the shared-memory limit of
// `kernel`; returns the launch shape.
template <class K>
cudaError_t prepare(K kernel, const int* desc, int n_stages, int n, int b, int tb,
                    int device, pf::Stages* st, int* threads, size_t* smem) {
  if (b < 1) return cudaErrorInvalidValue;
  cudaError_t err = pf::chain_config(desc, n_stages, n, tb, st, threads, smem);
  if (err != cudaSuccess) return err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

}  // namespace

extern "C" {

// Forward: packed y ([n, 2b]) into the packed spectrum planes ore/oim
// ([n, b]).  desc and tw as for pf_chain_tmajor (the length-n chain); wr/wi
// are the [n] split twiddles.  Returns a cudaError_t.
int pf_rfft_tmajor_fused_fwd(const float* y, float* ore, float* oim, const float* tw,
                             const float* wr, const float* wi, const int* desc,
                             int n_stages, int n, int b, int tb, int device, void* stream) {
  const bool vec = tb % 4 == 0 && b % 4 == 0 && pf::aligned16(y) && pf::aligned16(ore) &&
                   pf::aligned16(oim);
  auto kernel = vec ? rfft_fused_fwd<true> : rfft_fused_fwd<false>;
  pf::Stages st;
  int threads;
  size_t smem;
  cudaError_t err = prepare(kernel, desc, n_stages, n, b, tb, device, &st, &threads, &smem);
  if (err != cudaSuccess) return err;
  kernel<<<(b + tb - 1) / tb, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      y, ore, oim, reinterpret_cast<const float2*>(tw), wr, wi, st, n, b, tb);
  return cudaGetLastError();
}

// Backward: spectrum planes sr/si ([n, b]) into the planar pre-interleave
// pair ore/oim ([n, b]).  Returns a cudaError_t.
int pf_rfft_tmajor_fused_bwd(const float* sr, const float* si, float* ore, float* oim,
                             const float* tw, const float* wr, const float* wi,
                             const int* desc, int n_stages, int n, int b, int tb, int device,
                             void* stream) {
  const bool vec = tb % 4 == 0 && b % 4 == 0 && pf::aligned16(sr) && pf::aligned16(si) &&
                   pf::aligned16(ore) && pf::aligned16(oim);
  auto kernel = vec ? rfft_fused_bwd<true> : rfft_fused_bwd<false>;
  pf::Stages st;
  int threads;
  size_t smem;
  cudaError_t err = prepare(kernel, desc, n_stages, n, b, tb, device, &st, &threads, &smem);
  if (err != cudaSuccess) return err;
  kernel<<<(b + tb - 1) / tb, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      sr, si, ore, oim, reinterpret_cast<const float2*>(tw), wr, wi, st, n, b, tb);
  return cudaGetLastError();
}

}  // extern "C"
