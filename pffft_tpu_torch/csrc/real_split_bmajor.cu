// The real transform's split step on batch-major planes [B, H] (kernel B6).
//
// Replaces pffft_tpu/ops/real_kernel.py `_build` / `_make_kernel` (entered
// through `real_split_pallas`):
//
//   forward:  REAL_FINALIZE, the length-H transform Z -> the packed real
//             spectrum (bin0 = DC + i*Nyquist);
//   backward: REAL_PREPROCESS, the packed spectrum -> 2*Z, the input of the
//             backward length-H transform (Im xa[0] := 0, the mirror's
//             xb[0] = (Nyquist, 0)).
//
// The TPU kernel reads three blocks of each plane per step and rebuilds the
// Hermitian mirror with a lane reverse (an XOR roll network, since Mosaic
// has no `rev`); it needs H >= 2^14.  Here the mirror is plain indexing, at
// any H and B.
//
// Design.  Elementwise, one thread per Hermitian pair (k, H - k) of one row:
// outputs k and H - k both read inputs k and H - k, so the thread loads both
// (neighbouring threads take neighbouring k, so the front reads ascend and
// the mirror reads descend, both coalesced), computes both with the split
// step of real.cuh, and writes both; k = 0 and k = H/2 are their own
// mirrors.  Every value is read once and written once.  Bound on this card:
// 16*H*B bytes per call (two planes read, two written) at 3.35 TB/s; ~16
// flops per output are far below the f32 peak.

#include "butterflies.cuh"  // pf_error_string
#include "real.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 20;

template <bool BWD>
__device__ __forceinline__ float2 split_row(float2 v, float2 f, float wr, float wi,
                                            bool row0) {
  return BWD ? pf::real_prep(v, f, wr, wi, row0) : pf::real_finalize(v, f, wr, wi, row0);
}

// pairs = H/2 + 1 pair slots per row; items = B * pairs.
template <bool BWD>
__global__ void __launch_bounds__(kThreads)
real_split_bmajor_kernel(const float* __restrict__ zr, const float* __restrict__ zi,
                         float* __restrict__ ore, float* __restrict__ oim,
                         const float* __restrict__ wr, const float* __restrict__ wi, int h,
                         int pairs, long long items) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; t < items;
       t += stride) {
    const long long row = t / pairs;
    const int k = static_cast<int>(t - row * pairs);
    const int m = k == 0 ? 0 : h - k;
    const size_t base = static_cast<size_t>(row) * h;
    const float2 vk = make_float2(zr[base + k], zi[base + k]);
    const float2 vm = make_float2(zr[base + m], zi[base + m]);
    const float2 xk = split_row<BWD>(vk, vm, __ldg(wr + k), __ldg(wi + k), k == 0);
    ore[base + k] = xk.x;
    oim[base + k] = xk.y;
    if (m != k) {
      const float2 xm = split_row<BWD>(vm, vk, __ldg(wr + m), __ldg(wi + m), false);
      ore[base + m] = xm.x;
      oim[base + m] = xm.y;
    }
  }
}

}  // namespace

extern "C" {

// Split step of the [b, h] planes zr/zi into ore/oim; wr/wi are the [h]
// split twiddles.  backward = 0: REAL_FINALIZE; 1: REAL_PREPROCESS.
// Returns a cudaError_t.
int pf_real_split_bmajor(const float* zr, const float* zi, float* ore, float* oim,
                         const float* wr, const float* wi, int h, int b, int backward,
                         int device, void* stream) {
  if (h < 1 || b < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int pairs = h / 2 + 1;
  const long long items = static_cast<long long>(b) * pairs;
  long long blocks = (items + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (backward)
    real_split_bmajor_kernel<true><<<static_cast<int>(blocks), kThreads, 0, s>>>(
        zr, zi, ore, oim, wr, wi, h, pairs, items);
  else
    real_split_bmajor_kernel<false><<<static_cast<int>(blocks), kThreads, 0, s>>>(
        zr, zi, ore, oim, wr, wi, h, pairs, items);
  return cudaGetLastError();
}

}  // extern "C"
