// Sliding-window polyphase FIR, the channelizer's hot loop.
//
// Replaces pffft_tpu/ops/pfb_kernel.py `_build` / `_make_kernel` (entered
// through `pfb_fir`, called from `Channelizer._polyphase`):
//
//   out[r, k, phi] = sum_{s<P} w[s, phi] * rows[r, k + s, phi],   k < K.
//
// Design.  One thread per (row set r, column phi, chunk of kChunk outputs).
// It walks k and keeps the last P inputs in registers (a window of PM >= P
// slots, shifted by one each step), so each input of its chunk is read once;
// neighbouring chunks re-read a halo of P - 1 rows, which the L2 serves.
// Neighbouring threads take neighbouring columns, so loads are coalesced.
// That is the sliding-window reuse the TPU kernel gets from its VMEM strip.
// P > 32 takes a plain loop that reads its P inputs per output.
//
// The kernel is templated on a load map and a store map (as chain.cuh's
// Rows / Slabs):
//   * Rows / Frames, the identity pair: rows [R, Q, M] (Q >= K + P - 1) in,
//     out [R, K, M] out, pfb_fir's contract;
//   * Stream / TimeMajor, the channelizer's pair: the history-prefixed
//     stream ext [R, L] (L >= (P + K - 1) * M + 1) read directly,
//     rows'[q, phi] = ext[(q + 1) * M - phi] with the weights taken in
//     reverse, so that v[k, phi] = sum_s w[s, phi] * ext[(P + k - s) * M - phi]
//     (phi = 0 reads frame q + 1's first sample: the reference's row-0
//     realignment), written time-major v [M, R * K] for the FFT over the
//     phases.  No flip, frame copy or transpose exists in device memory.
//
// Bound on this card: 4 * (R * Q * M + R * K * M) bytes (each input and
// output once) at 3.35 TB/s; 2 * P flops per output are far below the f32
// peak.  The time-major store is not coalesced (a warp writes 32 rows); the
// L2 merges each thread's consecutive k into full sectors.

#include <cstdint>

#include "butterflies.cuh"  // pf_error_string

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 32;

// Identity load map: rows [R, Q, M].
struct Rows {
  const float* x;
  long long ld;  // Q * M
  int m;
  static constexpr bool kFlip = false;
  __device__ __forceinline__ float at(int r, int q, int phi) const {
    return __ldg(x + r * ld + static_cast<long long>(q) * m + phi);
  }
};

// Channelizer load map: the stream ext [R, ld], rows'[q, phi] = ext[(q+1)M - phi],
// with the weights reversed.
struct Stream {
  const float* x;
  long long ld;  // the stream's row length
  int m;
  static constexpr bool kFlip = true;
  __device__ __forceinline__ float at(int r, int q, int phi) const {
    return __ldg(x + r * ld + static_cast<long long>(q + 1) * m - phi);
  }
};

// Identity store map: out [R, K, M].
struct Frames {
  float* y;
  int k;
  int m;
  __device__ __forceinline__ void put(int r, int kk, int phi, float v) const {
    y[(static_cast<long long>(r) * k + kk) * m + phi] = v;
  }
};

// Time-major store map: v [M, R * K].
struct TimeMajor {
  float* y;
  int k;
  int rows;
  __device__ __forceinline__ void put(int r, int kk, int phi, float v) const {
    y[static_cast<long long>(phi) * rows * k + static_cast<long long>(r) * k + kk] = v;
  }
};

// PM window slots (PM >= p); PM == 0: the plain loop for any p.
template <int PM, class Load, class Store>
__global__ void __launch_bounds__(kThreads)
pfb_kernel(const Load ld, const Store out, const float* __restrict__ w, int p, int kout,
           int m, int chunks) {
  const int phi = blockIdx.y * kThreads + threadIdx.x;
  if (phi >= m) return;
  const int r = blockIdx.x / chunks;
  const int k0 = (blockIdx.x - r * chunks) * kChunk;
  const int k1 = min(kout, k0 + kChunk);
  // the tap of input row k + s is w[s] (identity) or w[p - 1 - s] (stream)
  auto tap = [&](int s) { return __ldg(w + (Load::kFlip ? p - 1 - s : s) * m + phi); };
  if constexpr (PM == 0) {
    for (int k = k0; k < k1; ++k) {
      float acc = 0.0f;
      for (int t = 0; t < p; ++t) {  // in the order of the weights' rows
        const int s = Load::kFlip ? p - 1 - t : t;
        acc = fmaf(tap(s), ld.at(r, k + s, phi), acc);
      }
      out.put(r, k, phi, acc);
    }
  } else {
    // slot j < PM holds input row k + j - (PM - p); slots below PM - p are unused
    float win[PM], wt[PM];
#pragma unroll
    for (int j = 0; j < PM; ++j) {
      win[j] = 0.0f;
      wt[j] = j >= PM - p ? tap(j - (PM - p)) : 0.0f;
    }
    for (int q = k0; q < k0 + p - 1; ++q) {
#pragma unroll
      for (int j = 0; j < PM - 1; ++j) win[j] = win[j + 1];
      win[PM - 1] = ld.at(r, q, phi);
    }
    for (int k = k0; k < k1; ++k) {
#pragma unroll
      for (int j = 0; j < PM - 1; ++j) win[j] = win[j + 1];
      win[PM - 1] = ld.at(r, k + p - 1, phi);
      float acc = 0.0f;
#pragma unroll
      for (int t = 0; t < PM; ++t) {  // in the order of the weights' rows
        const int j = Load::kFlip ? PM - 1 - t : t;
        if (j >= PM - p) acc = fmaf(wt[j], win[j], acc);
      }
      out.put(r, k, phi, acc);
    }
  }
}

template <class Load, class Store>
cudaError_t launch(const Load ld, const Store out, const float* w, int p, int k, int m,
                   int rows, cudaStream_t stream) {
  const int chunks = (k + kChunk - 1) / kChunk;
  const long long gx = static_cast<long long>(rows) * chunks;
  if (gx > 0x7fffffffLL || (m + kThreads - 1) / kThreads > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(gx), (m + kThreads - 1) / kThreads);
  auto kernel = p <= 4    ? pfb_kernel<4, Load, Store>
                : p <= 8  ? pfb_kernel<8, Load, Store>
                : p <= 16 ? pfb_kernel<16, Load, Store>
                : p <= 32 ? pfb_kernel<32, Load, Store>
                          : pfb_kernel<0, Load, Store>;
  kernel<<<grid, kThreads, 0, stream>>>(ld, out, w, p, k, m, chunks);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// map 0: x = rows [rows, q, m] (q >= k + p - 1), y = out [rows, k, m].
// map 1: x = the stream ext [rows, q] (q >= (p + k - 1) * m + 1), y = v [m, rows * k].
// w = weights [p, m].  Returns a cudaError_t (cudaErrorInvalidValue for bad
// arguments).
int pf_pfb_fir(const float* x, const float* w, float* y, int p, int k, int m, int rows,
               long long q, int map, int device, void* stream) {
  if (p < 1 || k < 1 || m < 1 || rows < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (map == 0) {
    if (q < static_cast<long long>(k) + p - 1) return cudaErrorInvalidValue;
    return launch(Rows{x, q * m, m}, Frames{y, k, m}, w, p, k, m, rows, s);
  }
  if (map == 1) {
    if (q < (static_cast<long long>(p) + k - 1) * m + 1) return cudaErrorInvalidValue;
    return launch(Stream{x, q, m}, TimeMajor{y, k, rows}, w, p, k, m, rows, s);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
