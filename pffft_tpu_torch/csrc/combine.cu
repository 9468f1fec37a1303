// kern2 pass B: the twiddled radix-r combine of the two-pass engine.
//
// Replaces pffft_tpu/ops/pallas_fft.py `_build_combine_v2` /
// `_make_combine_kernel_v2` (entered through `cfft_combine_tmajor`), and the
// single-block form `_build_combine` / `_make_combine_kernel` (variant=1),
// which computes the same function:
//
//   X[t*m + k] = sum_c W_N^{c*k} W_r^{c*t} Z_c[k],   r in {2,3,4,5,8,16,32}.
//
// Input is pass A's [m, r*B] state (the length-m transforms of the r
// decimated sequences; slab c sits at lanes [c*B, (c+1)*B) of row k).
// Output is [r, m, B], which as a flat view is the canonical [N, B]
// spectrum.  The twiddle is the last stage's [m, r] table,
// T[k, c] = W_N^{c*k}, stored forward-sign and conjugated for backward.
//
// Design.  One thread per (k, b): it loads Z_c[k] for the r slabs
// (coalesced along b), twiddles, runs the radix-r butterfly in registers
// and stores the r outputs (coalesced along b).  Blocks are (k, 128-column
// chunk), so a warp shares one row of the twiddle table.
//
// Bound on this card: 16*N*B bytes per pass at 3.35 TB/s; the per-point
// work (one complex multiply and a radix-r butterfly) is far below the f32
// peak.  Every value is read once and written once; nothing is staged in
// shared memory because no value is reused.

#include "butterflies.cuh"

namespace {

constexpr int kThreads = 128;

template <int R, bool BWD>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const float* __restrict__ re, const float* __restrict__ im,
               float* __restrict__ ore, float* __restrict__ oim,
               const float2* __restrict__ tw, int m, int b) {
  const int k = blockIdx.x;
  const int col = blockIdx.y * kThreads + threadIdx.x;
  if (col >= b) return;
  const size_t row = static_cast<size_t>(k) * R * b + col;
  float2 v[R];
#pragma unroll
  for (int c = 0; c < R; ++c) {
    float2 x = make_float2(re[row + static_cast<size_t>(c) * b],
                           im[row + static_cast<size_t>(c) * b]);
    if (c > 0) {  // T[k, 0] == 1
      const float2 w = tw[k * R + c];
      x = pf::cmul(x, w.x, BWD ? -w.y : w.y);
    }
    v[c] = x;
  }
  pf::butterfly<R, BWD>(v);
#pragma unroll
  for (int t = 0; t < R; ++t) {
    const size_t o = (static_cast<size_t>(t) * m + k) * b + col;
    ore[o] = v[t].x;
    oim[o] = v[t].y;
  }
}

template <int R>
cudaError_t launch(const float* re, const float* im, float* ore, float* oim,
                   const float* tw, int m, int b, bool backward, cudaStream_t stream) {
  const dim3 grid(m, (b + kThreads - 1) / kThreads);
  const float2* t = reinterpret_cast<const float2*>(tw);
  if (backward)
    combine_kernel<R, true><<<grid, kThreads, 0, stream>>>(re, im, ore, oim, t, m, b);
  else
    combine_kernel<R, false><<<grid, kThreads, 0, stream>>>(re, im, ore, oim, t, m, b);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Combine pass-A planes re/im ([m, r*b]) into ore/oim ([r, m, b]).
// tw is the [m, r] twiddle table as (re, im) pairs.  Returns a cudaError_t.
int pf_combine_tmajor(const float* re, const float* im, float* ore, float* oim,
                      const float* tw, int m, int r, int b, int backward,
                      int device, void* stream) {
  if (m < 1 || b < 1 || (b + kThreads - 1) / kThreads > 65535)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bwd = backward != 0;
  switch (r) {
    case 2: return launch<2>(re, im, ore, oim, tw, m, b, bwd, s);
    case 3: return launch<3>(re, im, ore, oim, tw, m, b, bwd, s);
    case 4: return launch<4>(re, im, ore, oim, tw, m, b, bwd, s);
    case 5: return launch<5>(re, im, ore, oim, tw, m, b, bwd, s);
    case 8: return launch<8>(re, im, ore, oim, tw, m, b, bwd, s);
    case 16: return launch<16>(re, im, ore, oim, tw, m, b, bwd, s);
    case 32: return launch<32>(re, im, ore, oim, tw, m, b, bwd, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
