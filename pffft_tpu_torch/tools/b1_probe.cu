// Two probes of B1's design space, built and timed by tools/b1_probe.py;
// neither is on a path of the port.
//
// pattern: each element of a [n, tb] column tile loaded and stored through
//   B1's column maps (regfft.cuh ColsIn / ColsOut), with no transform: the
//   time B1's access pattern costs alone, per batch columns tb.
// persist: B1 as a persistent kernel.  A block walks tiles of tb columns
//   (grid-stride); the next tile's planes are copied with cp.async (16 bytes
//   a copy) into one of two dense [n, tb] prefetch buffers in shared memory
//   while the current tile runs on the core from the other, so one tile's
//   loads overlap the previous tile's stages.  Two buffers and the exchange
//   tile fit at tb = 4 for n = 2048 and tb = 8 for n = 1024 (32 values a
//   thread); B1's default tile (tb = 8 at n = 2048) leaves no room for them.

#include "regfft.cuh"

namespace {

using pf::rf::kMaxThreads;

__global__ void __launch_bounds__(kMaxThreads, 1)
pattern_kernel(const float* __restrict__ re, const float* __restrict__ im,
               float* __restrict__ ore, float* __restrict__ oim, int n, int b, int tb) {
  const int b0 = blockIdx.x * tb;
  const int cols = min(tb, b - b0);
  const pf::rf::ColsIn src{re + b0, im + b0, b, cols};
  const pf::rf::ColsOut dst{ore + b0, oim + b0, b, cols};
  constexpr int U = 32;  // values in flight a thread, as the core's first stage
  for (int e0 = threadIdx.x; e0 < n * tb; e0 += U * blockDim.x) {
    float2 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * blockDim.x;
      if (e < n * tb) v[u] = src.load(e % tb, e / tb);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * blockDim.x;
      if (e < n * tb) dst.store(e % tb, e / tb, v[u]);
    }
  }
}

// A dense [n, tb] prefetch buffer pair (re, im) as the core's source.
struct PrefIn {
  const float* re;
  const float* im;
  int tb;
  __device__ __forceinline__ float2 load(int f, int p) const {
    return make_float2(re[p * tb + f], im[p * tb + f]);
  }
};

__device__ __forceinline__ void prefetch(float* sre, float* sim, const float* re,
                                         const float* im, int n, int b, int tb, int b0) {
  const int q4 = tb / 4;  // 16-byte chunks a row
  for (int e = threadIdx.x; e < n * q4; e += blockDim.x) {
    const int row = e / q4, c = (e - row * q4) * 4;
    const size_t g = static_cast<size_t>(row) * b + b0 + c;
    const unsigned dr = static_cast<unsigned>(__cvta_generic_to_shared(sre + row * tb + c));
    const unsigned di = static_cast<unsigned>(__cvta_generic_to_shared(sim + row * tb + c));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dr), "l"(re + g));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(di), "l"(im + g));
  }
  asm volatile("cp.async.commit_group;");
}

__global__ void __launch_bounds__(kMaxThreads, 1)
persist_kernel(const float* __restrict__ re, const float* __restrict__ im,
               float* __restrict__ ore, float* __restrict__ oim,
               const float2* __restrict__ tw, const pf::rf::Plan plan, int n, int b, int tb,
               int shift, int tiles, int pitch) {
  extern __shared__ __align__(16) float2 tile[];  // exchange tile, then 2 x (re, im)
  float* pre = reinterpret_cast<float*>(tile + pitch);
  const int buf = n * tb;
  int t = blockIdx.x;
  if (t < tiles) prefetch(pre, pre + buf, re, im, n, b, tb, t * tb);
  for (int i = 0; t < tiles; t += gridDim.x, ++i) {
    const int nt = t + gridDim.x;
    float* cur = pre + (i & 1) * 2 * buf;
    float* nxt = pre + ((i + 1) & 1) * 2 * buf;
    if (nt < tiles) {
      prefetch(nxt, nxt + buf, re, im, n, b, tb, nt * tb);
      asm volatile("cp.async.wait_group 1;");
    } else {
      asm volatile("cp.async.wait_group 0;");
    }
    __syncthreads();
    const int b0 = t * tb;
    pf::rf::run<32, false>(plan, tw, pf::rf::ColLanes{tb}, tb, PrefIn{cur, cur + buf, tb},
                           pf::rf::ColsSmem{tile, tb, shift},
                           pf::rf::ColsOut{ore + b0, oim + b0, b, tb}, true);
    __syncthreads();
  }
}

}  // namespace

extern "C" {

int pf_probe_pattern(const float* re, const float* im, float* ore, float* oim, int n, int b,
                     int tb, int threads, void* stream) {
  if (n < 1 || b < 1 || tb < 1 || threads < 32 || threads > kMaxThreads) {
    return cudaErrorInvalidValue;
  }
  pattern_kernel<<<(b + tb - 1) / tb, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      re, im, ore, oim, n, b, tb);
  return cudaGetLastError();
}

// Forward transform of [n, b] planes (b a multiple of tb, tb a multiple of
// 4, 16-byte aligned planes) on `grid` persistent blocks; desc and tw as
// for pf_chain_tmajor.
int pf_probe_persist(const float* re, const float* im, float* ore, float* oim, const float* tw,
                     const int* desc, int n_stages, int n, int b, int tb, int threads,
                     int shift, int grid, void* stream) {
  if (b < 1 || tb % 4 || b % tb || grid < 1) return cudaErrorInvalidValue;
  size_t smem;
  cudaError_t err = pf::rf::cols_shape(n, tb, threads, 32, shift, &smem);
  if (err != cudaSuccess) return err;
  pf::rf::Plan plan;
  err = pf::rf::plan_from(desc, n_stages, &plan);
  if (err != cudaSuccess) return err;
  if (!pf::rf::plan_spans(plan, n)) return cudaErrorInvalidValue;
  const int pitch = static_cast<int>((smem / sizeof(float2) + 1) / 2 * 2);  // 16-byte aligned
  smem = static_cast<size_t>(pitch) * sizeof(float2) + 4 * sizeof(float) * n * tb;
  err = cudaFuncSetAttribute(persist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  persist_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      re, im, ore, oim, reinterpret_cast<const float2*>(tw), plan, n, b, tb, shift, b / tb,
      pitch);
  return cudaGetLastError();
}

}  // extern "C"
