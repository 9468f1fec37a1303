// Fused two-stage FFT of batch-major planes [B, N], one pass (kernel B9).
//
// Replaces pffft_tpu/ops/fused_stage.py `_build` / `_make_kernel` (entered
// through `cfft_fused2`): a batched complex FFT of planar f32 rows, N = n1*n2,
// unscaled both directions, written in canonical order (out[b, k]) or in the
// internal k1-major order of the two factors (out[b, k1*n2 + k2] holds bin
// k = k1 + n1*k2).
//
// Design.  The TPU kernel runs two dense r x r DFT matmuls on the MXU; in
// true fp32 a dense 64-term stage loses the 140 dB carrier bound, so the
// arithmetic here is the thin radix-16/8/4/2/5/3 Stockham chain of chain.cuh
// (the ordered spectrum does not depend on the factorization), and (n1, n2)
// only define the internal order, applied as an index map at the store.  One
// block owns TB whole rows: it loads the contiguous [TB, N] rows (16-byte
// loads where N % 4 == 0 and the planes are aligned) into the chain's [N, TB]
// float2 tile in shared memory, runs every stage there, and stores each row
// through the output map.  Rows are contiguous, so TB may fall to 1: one
// pass covers N * TB <= 16384 (15360 with radix 3 or 5), N up to 16384.  The
// ragged last tile is masked (rows past B load as zero and are not stored).
// Narrow tiles (TB < 16) rotate the four values a thread moves between a
// row segment and the tile, so a half-warp's shared accesses spread over the
// banks.
//
// Bound on this card: 16*N*B bytes per call (both planes read once and
// written once) at 3.35 TB/s; the chain's ~5 N log2 N B flops are far below
// the f32 peak.  What it does not do yet: overlap one tile's loads with
// another's stages (one 128 KB tile per SM at the larger N).

#include "chain.cuh"

namespace {

using pf::kMaxThreads;
using pf::kUnroll;

__device__ __forceinline__ float lane(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ void set_lane(float4& v, int i, float x) {
  if (i == 0) v.x = x;
  else if (i == 1) v.y = x;
  else if (i == 2) v.z = x;
  else v.w = x;
}

// Rotation of the four values of row segment jq: (jq >> shift) & 3 puts the
// half-warp's 16 accesses on 16 bank pairs for TB = 1, 2, 4 and 8.
__device__ __forceinline__ int rot_shift(int tb) { return tb == 1 ? 2 : tb == 2 ? 1 : 0; }

// Rows b0 .. b0 + rows - 1 of re/im [b, n] into the tile [n, tb]:
// tile[j * tb + r] = (re, im)[b0 + r, j]; tile rows past `rows` are zero.
template <bool VEC>
__device__ __forceinline__ void load_rows(float2* tile, const float* __restrict__ re,
                                          const float* __restrict__ im, int n, int tb,
                                          int b0, int rows) {
  if constexpr (VEC) {
    const int quads = tb * (n / 4);
    const int sh = rot_shift(tb);
    for (int base = threadIdx.x; base < quads; base += kUnroll * blockDim.x) {
      float4 r[kUnroll], i[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int q = base + u * blockDim.x;
        const int row = q % tb, jq = q / tb;
        r[u] = i[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (q < quads && row < rows) {
          const size_t g = static_cast<size_t>(b0 + row) * n + 4 * jq;
          r[u] = *reinterpret_cast<const float4*>(re + g);
          i[u] = *reinterpret_cast<const float4*>(im + g);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int q = base + u * blockDim.x;
        if (q < quads) {
          const int row = q % tb, jq = q / tb;
          const int rot = jq >> sh;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = (e + rot) & 3;
            tile[(4 * jq + c) * tb + row] = make_float2(lane(r[u], c), lane(i[u], c));
          }
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
        const int e = base + u * blockDim.x;  // tile index j * tb + row
        const int row = e % tb, j = e / tb;
        x[u] = make_float2(0.0f, 0.0f);
        if (e < total && row < rows) {
          const size_t g = static_cast<size_t>(b0 + row) * n + j;
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

// Output position p of a row reads canonical bin k: p itself when ordered,
// else p = k1 * n2 + k2 holds k = k2 * n1 + k1.
__device__ __forceinline__ int source_bin(int p, bool ordered, int n1, int n2) {
  if (ordered) return p;
  const int k1 = p / n2;
  return (p - k1 * n2) * n1 + k1;
}

// The tile's rows into ore/oim [b, n] through the output map.
template <bool VEC>
__device__ __forceinline__ void store_rows(const float2* tile, float* __restrict__ ore,
                                           float* __restrict__ oim, int n, int tb, int b0,
                                           int rows, bool ordered, int n1, int n2) {
  if constexpr (VEC) {
    const int quads = tb * (n / 4);
    const int sh = rot_shift(tb);
    for (int q = threadIdx.x; q < quads; q += blockDim.x) {
      const int row = q % tb, pq = q / tb;
      const int rot = pq >> sh;
      float4 vr, vi;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = (e + rot) & 3;
        const float2 v = tile[source_bin(4 * pq + c, ordered, n1, n2) * tb + row];
        set_lane(vr, c, v.x);
        set_lane(vi, c, v.y);
      }
      if (row < rows) {
        const size_t g = static_cast<size_t>(b0 + row) * n + 4 * pq;
        *reinterpret_cast<float4*>(ore + g) = vr;
        *reinterpret_cast<float4*>(oim + g) = vi;
      }
    }
  } else {
    const int total = n * tb;
    for (int e = threadIdx.x; e < total; e += blockDim.x) {
      const int row = e % tb, p = e / tb;
      if (row < rows) {
        const float2 v = tile[source_bin(p, ordered, n1, n2) * tb + row];
        const size_t g = static_cast<size_t>(b0 + row) * n + p;
        ore[g] = v.x;
        oim[g] = v.y;
      }
    }
  }
}

template <bool BWD, bool VEC>
__global__ void __launch_bounds__(kMaxThreads, 1)
fused2_kernel(const float* __restrict__ re, const float* __restrict__ im,
              float* __restrict__ ore, float* __restrict__ oim,
              const float2* __restrict__ tw, const pf::Stages st, int n, int b, int tb,
              bool ordered, int n1, int n2) {
  extern __shared__ __align__(16) float2 tile[];  // [n, tb]
  const int b0 = blockIdx.x * tb;
  const int rows = min(tb, b - b0);
  load_rows<VEC>(tile, re, im, n, tb, b0, rows);
  __syncthreads();
  pf::run_stages<BWD>(tile, tw, st, tb);
  store_rows<VEC>(tile, ore, oim, n, tb, b0, rows, ordered, n1, n2);
}

}  // namespace

extern "C" {

// Forward or backward transform of the [b, n] planes re/im into ore/oim, in
// canonical order (ordered = 1) or the internal order of n = n1 * n2.  desc
// and tw are the thin chain's stage descriptor and twiddles, as for
// pf_chain_tmajor; tb rows per block.  Returns a cudaError_t: invalid
// arguments give cudaErrorInvalidValue, a tile too large for the block
// cudaErrorInvalidConfiguration.
int pf_fused2(const float* re, const float* im, float* ore, float* oim, const float* tw,
              const int* desc, int n_stages, int n, int b, int tb, int n1, int n2,
              int ordered, int backward, int device, void* stream) {
  if (b < 1 || n1 < 1 || n2 < 1 || n1 * n2 != n) return cudaErrorInvalidValue;
  pf::Stages st;
  int threads;
  size_t smem;
  cudaError_t err = pf::chain_config(desc, n_stages, n, tb, &st, &threads, &smem);
  if (err != cudaSuccess) return err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const bool vec = n % 4 == 0 && pf::aligned16(re) && pf::aligned16(im) &&
                   pf::aligned16(ore) && pf::aligned16(oim);
  auto kernel = backward ? (vec ? fused2_kernel<true, true> : fused2_kernel<true, false>)
                         : (vec ? fused2_kernel<false, true> : fused2_kernel<false, false>);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int blocks = (b + tb - 1) / tb;
  kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      re, im, ore, oim, reinterpret_cast<const float2*>(tw), st, n, b, tb, ordered != 0, n1,
      n2);
  return cudaGetLastError();
}

}  // extern "C"
