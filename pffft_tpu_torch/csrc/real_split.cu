// The real transform's standalone split step on time-major planes [H, B].
//
// Replaces pffft_tpu/ops/pallas_fft.py `_build_real_split` and
// `_build_real_split_blocked` (entered through `real_split_tmajor_pallas`):
//
//   forward:  REAL_FINALIZE, the length-H transform Z -> the packed real
//             spectrum (bin0 = DC + i*Nyquist);
//   backward: REAL_PREPROCESS, the packed spectrum -> 2*Z, the input of the
//             backward length-H transform.
//
// Both Pallas builds compute this one function; the blocked 3-view form
// exists only for the TPU compiler's tile limits and has no counterpart
// here.  Serves the real sizes whose length-H transform runs on kern2 or the
// stage engine (any H).
//
// Design.  Elementwise: one thread per (row pair, group of columns).  Output
// rows k and H - k both read input rows k and H - k, so a thread loads both
// rows (coalesced along the batch, 16-byte vectors when B % 4 == 0 and the
// planes are aligned), and writes both outputs; rows 0 and H/2 are their
// own mirrors.  Every value is read once and written once.  Bound on this
// card: 16*H*B bytes per call at 3.35 TB/s (two planes read, two written);
// ~16 flops per output are far below the f32 peak.

#include <cstdint>
#include <type_traits>

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

// V columns per thread (4: float4 loads and stores, 1: scalar); groups is
// the number of V-column groups per row.
template <int V, bool BWD>
__global__ void __launch_bounds__(kThreads)
real_split_kernel(const float* __restrict__ zr, const float* __restrict__ zi,
                  float* __restrict__ ore, float* __restrict__ oim,
                  const float* __restrict__ wr, const float* __restrict__ wi, int h, int b,
                  int groups, long long items) {
  using Vec = typename std::conditional<V == 4, float4, float>::type;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; t < items;
       t += stride) {
    const int k = static_cast<int>(t / groups);
    const int c = static_cast<int>(t - static_cast<long long>(k) * groups) * V;
    const int m = k == 0 ? 0 : h - k;
    const size_t gk = static_cast<size_t>(k) * b + c;
    const size_t gm = static_cast<size_t>(m) * b + c;
    const Vec akr = *reinterpret_cast<const Vec*>(zr + gk);
    const Vec aki = *reinterpret_cast<const Vec*>(zi + gk);
    const Vec amr = *reinterpret_cast<const Vec*>(zr + gm);
    const Vec ami = *reinterpret_cast<const Vec*>(zi + gm);
    const float* pkr = reinterpret_cast<const float*>(&akr);
    const float* pki = reinterpret_cast<const float*>(&aki);
    const float* pmr = reinterpret_cast<const float*>(&amr);
    const float* pmi = reinterpret_cast<const float*>(&ami);
    const float wkr = __ldg(wr + k), wki = __ldg(wi + k);
    const float wmr = __ldg(wr + m), wmi = __ldg(wi + m);
    Vec okr, oki, omr, omi;
    float* qkr = reinterpret_cast<float*>(&okr);
    float* qki = reinterpret_cast<float*>(&oki);
    float* qmr = reinterpret_cast<float*>(&omr);
    float* qmi = reinterpret_cast<float*>(&omi);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float2 vk = make_float2(pkr[j], pki[j]);
      const float2 vm = make_float2(pmr[j], pmi[j]);
      const float2 xk = split_row<BWD>(vk, vm, wkr, wki, k == 0);
      const float2 xm = split_row<BWD>(vm, vk, wmr, wmi, false);
      qkr[j] = xk.x;
      qki[j] = xk.y;
      qmr[j] = xm.x;
      qmi[j] = xm.y;
    }
    *reinterpret_cast<Vec*>(ore + gk) = okr;
    *reinterpret_cast<Vec*>(oim + gk) = oki;
    if (m != k) {
      *reinterpret_cast<Vec*>(ore + gm) = omr;
      *reinterpret_cast<Vec*>(oim + gm) = omi;
    }
  }
}

template <int V>
cudaError_t launch(const float* zr, const float* zi, float* ore, float* oim,
                   const float* wr, const float* wi, int h, int b, bool backward,
                   cudaStream_t stream) {
  const int groups = b / V;
  const long long items = static_cast<long long>(h / 2 + 1) * groups;
  long long blocks = (items + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const int grid = static_cast<int>(blocks);
  if (backward)
    real_split_kernel<V, true><<<grid, kThreads, 0, stream>>>(zr, zi, ore, oim, wr, wi, h,
                                                              b, groups, items);
  else
    real_split_kernel<V, false><<<grid, kThreads, 0, stream>>>(zr, zi, ore, oim, wr, wi,
                                                               h, b, groups, items);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// Split step of planes zr/zi ([h, b]) into ore/oim ([h, b]); wr/wi are the
// [h] split twiddles.  backward = 0: REAL_FINALIZE; 1: REAL_PREPROCESS.
// Returns a cudaError_t.
int pf_real_split_tmajor(const float* zr, const float* zi, float* ore, float* oim,
                         const float* wr, const float* wi, int h, int b, int backward,
                         int device, void* stream) {
  if (h < 1 || b < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = b % 4 == 0 && aligned16(zr) && aligned16(zi) && aligned16(ore) &&
                   aligned16(oim);
  return vec ? launch<4>(zr, zi, ore, oim, wr, wi, h, b, backward != 0, s)
             : launch<1>(zr, zi, ore, oim, wr, wi, h, b, backward != 0, s);
}

}  // extern "C"
