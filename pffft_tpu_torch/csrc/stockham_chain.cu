// Single-pass Stockham FFT over all stages of a plan, time-major planes.
//
// Replaces pffft_tpu/ops/pallas_fft.py `_build` / `_make_kernel` /
// `_make_kernel_scratch` (entered through `cfft_pallas_tmajor`): a batched
// complex FFT of planar f32 [N, B] -> [N, B], unscaled, canonical order.
//
// Design.  One block owns a tile of TB batch columns x all N rows.  It loads
// the [N, TB] re/im tile from global memory (coalesced along the batch,
// which is contiguous in time-major order) into ONE dynamic shared-memory
// buffer of float2, runs every stage there, and writes the canonical-order
// result once.  A stage reads the r inputs of each butterfly, multiplies by
// the stage twiddle T[k, i] (conjugated for backward), runs the radix-r
// butterfly and keeps the r outputs in registers; after a barrier it writes
// them back into the same buffer.  The register file is the second buffer
// of the Stockham ping-pong, which doubles the tile shared memory could
// hold as two buffers: each thread holds at most kElems complex values
// across the barrier, so a tile holds N*TB <= kMaxThreads * kElems values
// (16384 for radix 2/4/8/16 chains, 15360 with radix 3 or 5).
//
// Stockham indexing (`_stage_values`): element (k, i, j, b) of the
// [l, r, m, TB] view goes in, output (t, k, j, b) of [r, l, m, TB] comes out:
//   in  = ((k*r + i)*m + j)*TB + b,   out = ((t*l + k)*m + j)*TB + b.
//
// Bound on this card: 16*N*B bytes per pass (each plane read once and
// written once) at 3.35 TB/s; the butterflies' ~5 N log2 N B flops are far
// below the f32 peak.  The design reads and writes device memory once per
// transform, in 16-byte vectors where the tile and batch allow it, with
// several loads in flight per thread; the ragged batch edge is masked
// (b < B).  What it does not do yet: overlap one tile's loads with another's
// stages, which needs two tiles (or a cluster) per SM.

#include <cstdint>

#include "butterflies.cuh"

namespace {

constexpr int kMaxStages = 16;
constexpr int kElems = 32;       // complex values a thread holds across a stage
constexpr int kMaxThreads = 512;  // 65536 registers / 128 per thread

struct Stages {
  int count;
  int r[kMaxStages];
  int l[kMaxStages];
  int m[kMaxStages];
  int off[kMaxStages];  // offset of the stage's [l, r] table in tw
};

template <int R, bool BWD>
__device__ __forceinline__ void stage(float2* tile, const float2* __restrict__ tw,
                                      int l, int m, int tb) {
  constexpr int Q = kElems / R;  // butterflies per thread
  const int mtb = m * tb;
  const int nb = l * mtb;  // butterflies in this stage
  float2 v[Q][R];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int u = threadIdx.x + q * blockDim.x;
    if (u < nb) {
      const int k = u / mtb;
      const int jb = u - k * mtb;
      const float2* src = tile + k * R * mtb + jb;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        float2 x = src[i * mtb];
        if (i > 0 && l > 1) {  // T[k, 0] == 1
          const float2 w = tw[k * R + i];
          x = pf::cmul(x, w.x, BWD ? -w.y : w.y);
        }
        v[q][i] = x;
      }
      pf::butterfly<R, BWD>(v[q]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int u = threadIdx.x + q * blockDim.x;
    if (u < nb) {
      const int k = u / mtb;
      const int jb = u - k * mtb;
      float2* dst = tile + k * mtb + jb;
#pragma unroll
      for (int t = 0; t < R; ++t) dst[t * l * mtb] = v[q][t];
    }
  }
  __syncthreads();
}

// Global <-> shared moves of the [n, tb] tile.  A block runs alone on its SM
// (the tile fills most of shared memory), so these phases are bound by the
// loads each thread keeps in flight: every thread issues kUnroll vector
// loads (or 4*kUnroll scalar ones) per plane before it stores any.
constexpr int kUnroll = 4;

// VEC: tb, b and cols are multiples of 4 and the planes 16-byte aligned,
// so a row segment of 4 columns is one float4 per plane.
template <bool VEC>
__device__ __forceinline__ void load_tile(float2* tile, const float* __restrict__ re,
                                          const float* __restrict__ im, int n, int b,
                                          int tb, int b0, int cols) {
  if constexpr (VEC) {
    const int q4 = tb / 4;
    const int quads = n * q4;
    for (int base = threadIdx.x; base < quads; base += kUnroll * blockDim.x) {
      float4 r[kUnroll], i[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int q = base + u * blockDim.x;
        r[u] = i[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        const int row = q / q4, c = (q - row * q4) * 4;
        if (q < quads && c < cols) {
          const size_t g = static_cast<size_t>(row) * b + b0 + c;
          r[u] = *reinterpret_cast<const float4*>(re + g);
          i[u] = *reinterpret_cast<const float4*>(im + g);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int q = base + u * blockDim.x;
        if (q < quads) {  // tile + 4q is (row, c)
          float4* t = reinterpret_cast<float4*>(tile + 4 * q);
          t[0] = make_float4(r[u].x, i[u].x, r[u].y, i[u].y);
          t[1] = make_float4(r[u].z, i[u].z, r[u].w, i[u].w);
        }
      }
    }
  } else {
    constexpr int kU = 4 * kUnroll;
    const int total = n * tb;
    for (int base = threadIdx.x; base < total; base += kU * blockDim.x) {
      float2 x[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int e = base + u * blockDim.x;
        const int row = e / tb, col = e - row * tb;
        x[u] = make_float2(0.0f, 0.0f);
        if (e < total && col < cols) {
          const size_t g = static_cast<size_t>(row) * b + b0 + col;
          x[u] = make_float2(re[g], im[g]);
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int e = base + u * blockDim.x;
        if (e < total) tile[e] = x[u];
      }
    }
  }
}

template <bool VEC>
__device__ __forceinline__ void store_tile(const float2* tile, float* __restrict__ ore,
                                           float* __restrict__ oim, int n, int b, int tb,
                                           int b0, int cols) {
  if constexpr (VEC) {
    const int q4 = tb / 4;
    const int quads = n * q4;
    for (int base = threadIdx.x; base < quads; base += kUnroll * blockDim.x) {
      float4 v[kUnroll][2];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int q = base + u * blockDim.x;
        if (q < quads) {
          const float4* t = reinterpret_cast<const float4*>(tile + 4 * q);
          v[u][0] = t[0];
          v[u][1] = t[1];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int q = base + u * blockDim.x;
        const int row = q / q4, c = (q - row * q4) * 4;
        if (q < quads && c < cols) {
          const size_t g = static_cast<size_t>(row) * b + b0 + c;
          *reinterpret_cast<float4*>(ore + g) =
              make_float4(v[u][0].x, v[u][0].z, v[u][1].x, v[u][1].z);
          *reinterpret_cast<float4*>(oim + g) =
              make_float4(v[u][0].y, v[u][0].w, v[u][1].y, v[u][1].w);
        }
      }
    }
  } else {
    constexpr int kU = 4 * kUnroll;
    const int total = n * tb;
    for (int base = threadIdx.x; base < total; base += kU * blockDim.x) {
      float2 x[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int e = base + u * blockDim.x;
        if (e < total) x[u] = tile[e];
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int e = base + u * blockDim.x;
        const int row = e / tb, col = e - row * tb;
        if (e < total && col < cols) {
          const size_t g = static_cast<size_t>(row) * b + b0 + col;
          ore[g] = x[u].x;
          oim[g] = x[u].y;
        }
      }
    }
  }
}

template <bool BWD, bool VEC>
__global__ void __launch_bounds__(kMaxThreads, 1)
chain_kernel(const float* __restrict__ re, const float* __restrict__ im,
             float* __restrict__ ore, float* __restrict__ oim,
             const float2* __restrict__ tw, const Stages st, int n, int b, int tb) {
  extern __shared__ __align__(16) float2 tile[];  // [n, tb]
  const int b0 = blockIdx.x * tb;
  const int cols = min(tb, b - b0);
  load_tile<VEC>(tile, re, im, n, b, tb, b0, cols);
  __syncthreads();
  for (int s = 0; s < st.count; ++s) {
    const float2* t = tw + st.off[s];
    switch (st.r[s]) {
      case 2: stage<2, BWD>(tile, t, st.l[s], st.m[s], tb); break;
      case 3: stage<3, BWD>(tile, t, st.l[s], st.m[s], tb); break;
      case 4: stage<4, BWD>(tile, t, st.l[s], st.m[s], tb); break;
      case 5: stage<5, BWD>(tile, t, st.l[s], st.m[s], tb); break;
      case 8: stage<8, BWD>(tile, t, st.l[s], st.m[s], tb); break;
      case 16: stage<16, BWD>(tile, t, st.l[s], st.m[s], tb); break;
    }
  }
  store_tile<VEC>(tile, ore, oim, n, b, tb, b0, cols);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// The tile limits the Python side plans with.
int pf_chain_elems_per_thread() { return kElems; }
int pf_chain_max_threads() { return kMaxThreads; }

// Forward or backward transform of [n, b] planes re/im into ore/oim.
// desc holds n_stages rows of (r, l, m, offset into tw in complex values);
// tw is the concatenation of the stages' [l, r] tables as (re, im) pairs.
// Returns a cudaError_t: invalid arguments give cudaErrorInvalidValue, a
// tile too large for the block gives cudaErrorInvalidConfiguration.
int pf_chain_tmajor(const float* re, const float* im, float* ore, float* oim,
                    const float* tw, const int* desc, int n_stages, int n, int b,
                    int tb, int backward, int device, void* stream) {
  if (n_stages < 1 || n_stages > kMaxStages || n < 1 || b < 1 || tb < 1)
    return cudaErrorInvalidValue;
  Stages st{};
  st.count = n_stages;
  int threads = 32;
  const long long tile = static_cast<long long>(n) * tb;
  for (int s = 0; s < n_stages; ++s) {
    const int r = desc[4 * s];
    if (r != 2 && r != 3 && r != 4 && r != 5 && r != 8 && r != 16)
      return cudaErrorInvalidValue;
    st.r[s] = r;
    st.l[s] = desc[4 * s + 1];
    st.m[s] = desc[4 * s + 2];
    st.off[s] = desc[4 * s + 3];
    const long long per_thread = r * (kElems / r);
    const long long need = (tile + per_thread - 1) / per_thread;
    if (need > threads) threads = static_cast<int>(need);
  }
  threads = (threads + 31) / 32 * 32;
  if (threads > kMaxThreads) return cudaErrorInvalidConfiguration;
  const size_t smem = static_cast<size_t>(tile) * sizeof(float2);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const bool vec = tb % 4 == 0 && b % 4 == 0 && aligned16(re) && aligned16(im) &&
                   aligned16(ore) && aligned16(oim);
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
