// Pure copy of two f32 planes: the per-pass bandwidth probe.
//
// Replaces pffft_tpu/ops/pallas_fft.py `stream_copy_pallas`.  It measures
// the copy ceiling of this card (8 bytes read and written per element pair
// of each plane, 16*N*B bytes for [N, B] planes) that the FFT kernels'
// passes are held against, beside the 3.35 TB/s spec.
//
// Design.  16-byte vector loads and stores (float4) over both planes in one
// grid-stride loop when every pointer is 16-byte aligned; a scalar loop
// covers the tail and unaligned views.  Bound: bytes, 16*N*B at 3.35 TB/s.

#include <cstdint>

#include "butterflies.cuh"  // pf_error_string

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

__global__ void __launch_bounds__(kThreads)
copy_vec(const float4* __restrict__ a, const float4* __restrict__ b,
         float4* __restrict__ oa, float4* __restrict__ ob, size_t n4) {
  const size_t stride = static_cast<size_t>(gridDim.x) * kThreads;
  for (size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x; i < n4;
       i += stride) {
    oa[i] = a[i];
    ob[i] = b[i];
  }
}

__global__ void __launch_bounds__(kThreads)
copy_scalar(const float* __restrict__ a, const float* __restrict__ b,
            float* __restrict__ oa, float* __restrict__ ob, size_t n) {
  const size_t stride = static_cast<size_t>(gridDim.x) * kThreads;
  for (size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += stride) {
    oa[i] = a[i];
    ob[i] = b[i];
  }
}

int blocks_for(size_t work) {
  const size_t blocks = (work + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// Copy n floats of re/im into ore/oim.  Returns a cudaError_t.
int pf_stream_copy(const float* re, const float* im, float* ore, float* oim,
                   long long n, int device, void* stream) {
  if (n < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t total = static_cast<size_t>(n);
  size_t done = 0;
  if (aligned16(re) && aligned16(im) && aligned16(ore) && aligned16(oim)) {
    const size_t n4 = total / 4;
    if (n4) {
      copy_vec<<<blocks_for(n4), kThreads, 0, s>>>(
          reinterpret_cast<const float4*>(re), reinterpret_cast<const float4*>(im),
          reinterpret_cast<float4*>(ore), reinterpret_cast<float4*>(oim), n4);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
    done = n4 * 4;
  }
  if (done < total) {
    copy_scalar<<<blocks_for(total - done), kThreads, 0, s>>>(
        re + done, im + done, ore + done, oim + done, total - done);
  }
  return cudaGetLastError();
}

}  // extern "C"
