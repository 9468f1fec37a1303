// Device code of the single-pass Stockham chain of the fused real transform
// (real_fused.cu, B3).  The planar chain (B1) and the chain on a packed input
// (B4) run on the register-resident core of regfft.cuh instead.
//
// A block owns a tile of TB batch columns x all N rows in ONE dynamic
// shared-memory buffer of float2.  A stage reads the r inputs of each
// butterfly, multiplies by the stage twiddle T[k, i] (conjugated for
// backward), runs the radix-r butterfly and keeps the r outputs in
// registers; after a barrier it writes them back into the same buffer.  The
// register file is the second buffer of the Stockham ping-pong: each thread
// holds at most kElems complex values across the barrier, so a tile holds
// N*TB <= kMaxThreads * kElems values (16384 for radix 2/4/8/16 chains,
// 15360 with radix 3 or 5).
//
// Stockham indexing (`_stage_values`): element (k, i, j, b) of the
// [l, r, m, TB] view goes in, output (t, k, j, b) of [r, l, m, TB] comes out:
//   in  = ((k*r + i)*m + j)*TB + b,   out = ((t*l + k)*m + j)*TB + b.
//
// Each library that includes this header gets its own copy of the extern "C"
// helpers below (one library per source file).

#pragma once

#include <cstdint>

#include "butterflies.cuh"

namespace pf {

constexpr int kMaxStages = 16;
constexpr int kElems = 32;        // complex values a thread holds across a stage
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
          x = cmul(x, w.x, BWD ? -w.y : w.y);
        }
        v[q][i] = x;
      }
      butterfly<R, BWD>(v[q]);
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

// Every stage of the chain on the tile; ends after a barrier.
template <bool BWD>
__device__ __forceinline__ void run_stages(float2* tile, const float2* __restrict__ tw,
                                           const Stages& st, int tb) {
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
}

// Where the tile's input column c of row `row` lies.
//
// Rows: re/im planes with row stride ld (planar [N, B]: ld = B; the real
// forward's packed [H, 2B] buffer: re = y, im = y + B, ld = 2B).
struct Rows {
  const float* re;
  const float* im;
  int ld;
  __device__ __forceinline__ size_t at(int row, int c) const {
    return static_cast<size_t>(row) * ld + c;
  }
};

// Global <-> shared moves of the [n, tb] tile.  A block runs alone on its SM
// (the tile fills most of shared memory), so these phases are bound by the
// loads each thread keeps in flight: every thread issues kUnroll vector
// loads (or 4*kUnroll scalar ones) per plane before it stores any.
constexpr int kUnroll = 4;

// VEC: tb, cols and the source's column groups of 4 are 16-byte aligned
// float4s in both planes.
template <bool VEC, class Src>
__device__ __forceinline__ void load_tile(float2* tile, const Src src, int n, int tb,
                                          int b0, int cols) {
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
          const size_t g = src.at(row, b0 + c);
          r[u] = *reinterpret_cast<const float4*>(src.re + g);
          i[u] = *reinterpret_cast<const float4*>(src.im + g);
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
          const size_t g = src.at(row, b0 + col);
          x[u] = make_float2(src.re[g], src.im[g]);
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

// The tile into planar [n, b] planes ore/oim.
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

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Host side: the stage descriptor (n_stages rows of r, l, m, offset into tw
// in complex values) and the launch shape of an [n, tb] tile.  Invalid
// arguments give cudaErrorInvalidValue, a tile too large for one block
// cudaErrorInvalidConfiguration.
inline cudaError_t chain_config(const int* desc, int n_stages, int n, int tb, Stages* st,
                                int* threads, size_t* smem) {
  if (n_stages < 1 || n_stages > kMaxStages || n < 1 || tb < 1) return cudaErrorInvalidValue;
  *st = Stages{};
  st->count = n_stages;
  int t = 32;
  const long long tile = static_cast<long long>(n) * tb;
  for (int s = 0; s < n_stages; ++s) {
    const int r = desc[4 * s];
    if (r != 2 && r != 3 && r != 4 && r != 5 && r != 8 && r != 16) return cudaErrorInvalidValue;
    st->r[s] = r;
    st->l[s] = desc[4 * s + 1];
    st->m[s] = desc[4 * s + 2];
    st->off[s] = desc[4 * s + 3];
    const long long per_thread = r * (kElems / r);
    const long long need = (tile + per_thread - 1) / per_thread;
    if (need > t) t = static_cast<int>(need);
  }
  t = (t + 31) / 32 * 32;
  if (t > kMaxThreads) return cudaErrorInvalidConfiguration;
  *threads = t;
  *smem = static_cast<size_t>(tile) * sizeof(float2);
  return cudaSuccess;
}

}  // namespace pf

extern "C" {

// The tile limits the Python side plans with.
int pf_chain_elems_per_thread() { return pf::kElems; }
int pf_chain_max_threads() { return pf::kMaxThreads; }

}  // extern "C"
