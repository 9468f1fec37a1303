// Sliding-window polyphase FIR, the channelizer's hot loop (B8).
//
// Replaces pffft_tpu/ops/pfb_kernel.py `_build` / `_make_kernel` (entered
// through `pfb_fir`, called from `Channelizer._polyphase`), and serves the
// time-major path that pffft_tpu/channelizer.py `_polyphase_tmajor` builds
// with XLA.  Two entry points:
//
//   * pf_pfb_fir, the identity maps: rows [R, Q, M] (Q >= K + P - 1) in,
//     out[r, k, phi] = sum_{s<P} w[s, phi] * rows[r, k + s, phi], [R, K, M].
//     One thread per (row set, phase, chunk of kChunk outputs) walks k and
//     keeps the last P inputs in registers, so each input of its chunk is
//     read once (neighbouring chunks re-read a halo of P - 1 rows from L2);
//     neighbouring threads take neighbouring phases, so loads and stores are
//     coalesced.  P > 32 takes a plain loop that reads its P inputs per output.
//
//   * pf_pfb_stream, the channelizer's stream map, both planes in one launch:
//     v[phi, r*K + k] = sum_{s<P} w[s, phi] * ext[r, (P + k - s)*M - phi + o],
//     phi < M, k < K, written time-major v [M, R*K] for the FFT over the
//     phases.  ext is the virtual history-prefixed stream [hist, chunk] of a
//     plane, read in place: sample i comes from hist when i < hlen and from
//     the chunk at i - hlen otherwise (two pointers, two row strides), and is
//     zero past the chunk's end; o is a start offset (the oversampled
//     channelizer's residue r*H).  No ext, flip, frame copy or transpose
//     exists in device memory.
//
// Design of the stream map.  A block of 32 x W threads owns a tile of 32
// phases x TK = W*kKc outputs k of one row r of one plane (grid: k tiles x
// rows, phase tiles, planes).  Lane l of warp g computes outputs k0 + g*kKc
// .. + kKc - 1 of one phase, keeping the kKc + P - 1 inputs it needs in
// registers (every one loaded before the first multiply, so they are in
// flight together); a warp's 32 lanes read 32 neighbouring samples of one
// frame, a coalesced 128-byte load.  The lanes take u = M - phi, the sample
// within the frame (phi = 0 is u = M, the next frame's first sample: the
// reference's row-0 realignment), 32 neighbouring u a tile.  The outputs go
// into a padded [32][TK + 1] shared tile; after a barrier the block stores it
// with threads along k, so each warp writes row segments of v, TK*4 bytes
// long, instead of 32 rows R*K*4 bytes apart.  The weights are one [P, M]
// table for both planes.  P > 32 takes a plain loop.
//
// Bound on this card: 4 * (inputs + outputs) bytes at 3.35 TB/s (each
// stream sample read once, each output written once); 2 * P flops per output
// are far below the f32 peak.  What limits it: each thread re-reads a halo of
// P - 1 frames from L1/L2 (39 loads for 32 outputs at P = 8: kKc = 32, the
// fastest of 8, 16 and 32 on the H100), and the transpose adds a pass
// through shared memory.  W is a launch argument (ops/pfb_kernel.STREAM_WARPS
// by default).

#include "butterflies.cuh"  // pf_error_string

namespace {

// ---------------------------------------------------------------------------
// The identity maps
// ---------------------------------------------------------------------------

constexpr int kThreads = 128;
constexpr int kChunk = 32;

// rows [R, Q, M] in.
struct Rows {
  const float* x;
  long long ld;  // Q * M
  int m;
  __device__ __forceinline__ float at(int r, int q, int phi) const {
    return __ldg(x + r * ld + static_cast<long long>(q) * m + phi);
  }
};

// out [R, K, M].
struct Frames {
  float* y;
  int k;
  int m;
  __device__ __forceinline__ void put(int r, int kk, int phi, float v) const {
    y[(static_cast<long long>(r) * k + kk) * m + phi] = v;
  }
};

// PM window slots (PM >= p); PM == 0: the plain loop for any p.
template <int PM>
__global__ void __launch_bounds__(kThreads)
pfb_kernel(const Rows ld, const Frames out, const float* __restrict__ w, int p, int kout,
           int m, int chunks) {
  const int phi = blockIdx.y * kThreads + threadIdx.x;
  if (phi >= m) return;
  const int r = blockIdx.x / chunks;
  const int k0 = (blockIdx.x - r * chunks) * kChunk;
  const int k1 = min(kout, k0 + kChunk);
  auto tap = [&](int s) { return __ldg(w + s * m + phi); };
  if constexpr (PM == 0) {
    for (int k = k0; k < k1; ++k) {
      float acc = 0.0f;
      for (int s = 0; s < p; ++s) acc = fmaf(tap(s), ld.at(r, k + s, phi), acc);
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
      for (int j = 0; j < PM; ++j) {  // in the order of the weights' rows
        if (j >= PM - p) acc = fmaf(wt[j], win[j], acc);
      }
      out.put(r, k, phi, acc);
    }
  }
}

// ---------------------------------------------------------------------------
// The stream map
// ---------------------------------------------------------------------------

constexpr int kTile = 32;           // phases per tile: one warp's lanes
constexpr int kKc = 32;             // outputs (frames) a thread computes
constexpr int kMaxStreamThreads = 256;

// One plane: its history [R, hlen] (row stride hld), its chunk [R, xlen] (row
// stride xld), its output v [M, R*K].
struct Plane {
  const float* hist;
  const float* x;
  float* v;
};

struct StreamShape {
  long long hld, xld, xlen;
  int hlen, m, p, k, rows, off, tk;
};

// Sample i >= 0 of row r of the virtual stream [hist, chunk], zero past its end.
__device__ __forceinline__ float sample(const Plane& pl, const StreamShape& sh, int r,
                                        long long i) {
  if (i < sh.hlen) return __ldg(pl.hist + r * sh.hld + i);
  i -= sh.hlen;
  return i < sh.xlen ? __ldg(pl.x + r * sh.xld + i) : 0.0f;
}

// PM: the window for p <= PM taps (PM == 0: the plain loop, any p).
// blockDim.x = 32 * W, sh.tk = W * kKc.
template <int PM>
__global__ void __launch_bounds__(kMaxStreamThreads)
pfb_stream_kernel(const Plane p0, const Plane p1, const float* __restrict__ w,
                  const StreamShape sh, int ktiles) {
  extern __shared__ float tile[];  // [kTile][tk + 1]
  const Plane pl = blockIdx.z ? p1 : p0;
  const int r = blockIdx.x / ktiles;
  const int kt0 = (blockIdx.x - r * ktiles) * sh.tk;
  const int lane = threadIdx.x & (kTile - 1);
  const int g = threadIdx.x / kTile;
  const int pitch = sh.tk + 1;
  const int m = sh.m, p = sh.p;
  // lane -> sample u of a frame, 1 <= u <= M; phase phi = M - u (u = M: 0)
  const int u = 1 + blockIdx.y * kTile + lane;
  const int k0 = kt0 + g * kKc;
  if (u <= m && k0 < sh.k) {
    const int phi = u == m ? 0 : m - u;
    // rows'[q] = ext[(q + 1)*M - phi + o] = ext[q*M + u + o] (u = M: frame q + 1)
    const long long base = static_cast<long long>(u) + sh.off;
    auto row = [&](int q) { return sample(pl, sh, r, static_cast<long long>(q) * m + base); };
    float* out = tile + lane * pitch + g * kKc;
    if constexpr (PM == 0) {
      for (int i = 0; i < kKc; ++i) {
        float acc = 0.0f;
        for (int s = 0; s < p; ++s) {  // v[k] = sum_s w[s] rows'[k + P - 1 - s]
          acc = fmaf(__ldg(w + s * m + phi), row(k0 + i + p - 1 - s), acc);
        }
        out[i] = acc;
      }
    } else {
      // a[j] = rows'[k0 + j - (PM - p)]; slots below PM - p are not used
      float a[kKc + PM - 1], wt[PM];
#pragma unroll
      for (int s = 0; s < PM; ++s) wt[s] = s < p ? __ldg(w + s * m + phi) : 0.0f;
#pragma unroll
      for (int j = 0; j < kKc + PM - 1; ++j) {
        a[j] = j >= PM - p ? row(k0 + j - (PM - p)) : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < kKc; ++i) {
        float acc = 0.0f;
#pragma unroll
        for (int s = 0; s < PM; ++s) {  // in the order of the weights' rows
          if (s < p) acc = fmaf(wt[s], a[i + PM - 1 - s], acc);
        }
        out[i] = acc;
      }
    }
  }
  __syncthreads();
  // the tile's rows are phases: threads along k, a row segment per warp step
  const long long ldv = static_cast<long long>(sh.rows) * sh.k;
  const int span = min(sh.tk, sh.k - kt0);
  for (int e = threadIdx.x; e < kTile * sh.tk; e += blockDim.x) {
    const int row_of = e / sh.tk;
    const int kk = e - row_of * sh.tk;
    const int ur = 1 + blockIdx.y * kTile + row_of;
    if (kk < span && ur <= m) {
      const int phi = ur == m ? 0 : m - ur;
      pl.v[phi * ldv + static_cast<long long>(r) * sh.k + kt0 + kk] = tile[row_of * pitch + kk];
    }
  }
}

cudaError_t launch_stream(const Plane& p0, const Plane& p1, const float* w,
                          const StreamShape& sh, int warps, cudaStream_t stream) {
  const int ktiles = (sh.k + sh.tk - 1) / sh.tk;
  const long long gx = static_cast<long long>(ktiles) * sh.rows;
  const int gy = (sh.m + kTile - 1) / kTile;
  if (gx > 0x7fffffffLL || gy > 65535) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(kTile) * (sh.tk + 1) * sizeof(float);
  auto kernel = sh.p <= 4    ? pfb_stream_kernel<4>
                : sh.p <= 8  ? pfb_stream_kernel<8>
                : sh.p <= 16 ? pfb_stream_kernel<16>
                : sh.p <= 32 ? pfb_stream_kernel<32>
                             : pfb_stream_kernel<0>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(gx), gy, 2);  // z: the plane
  kernel<<<grid, kTile * warps, smem, stream>>>(p0, p1, w, sh, ktiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The identity maps: x = rows [rows, q, m] (q >= k + p - 1), y = out [rows,
// k, m], w = weights [p, m].  Returns a cudaError_t (cudaErrorInvalidValue
// for bad arguments).
int pf_pfb_fir(const float* x, const float* w, float* y, int p, int k, int m, int rows,
               long long q, int device, void* stream) {
  if (p < 1 || k < 1 || m < 1 || rows < 1 || q < static_cast<long long>(k) + p - 1) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int chunks = (k + kChunk - 1) / kChunk;
  const long long gx = static_cast<long long>(rows) * chunks;
  if (gx > 0x7fffffffLL || (m + kThreads - 1) / kThreads > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(gx), (m + kThreads - 1) / kThreads);
  auto kernel = p <= 4    ? pfb_kernel<4>
                : p <= 8  ? pfb_kernel<8>
                : p <= 16 ? pfb_kernel<16>
                : p <= 32 ? pfb_kernel<32>
                          : pfb_kernel<0>;
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      Rows{x, q * m, m}, Frames{y, k, m}, w, p, k, m, chunks);
  return cudaGetLastError();
}

// The stream map on both planes: plane j has its history hj [rows, hlen]
// (row stride hld), its chunk xj [rows, xlen] (row stride xld) and its
// output vj [m, rows*k]; w = weights [p, m]; off = the start offset
// o >= 0.  Launch shape: warps (1..8) warps a block.  Returns a cudaError_t (cudaErrorInvalidValue for bad
// arguments).
int pf_pfb_stream(const float* h0, const float* x0, float* v0, const float* h1,
                  const float* x1, float* v1, const float* w, int p, int k,
                  int m, int rows, int hlen, long long hld, long long xlen, long long xld,
                  int off, int warps, int device, void* stream) {
  if (p < 1 || k < 1 || m < 1 || rows < 1 || hlen < 0 || xlen < 0 || off < 0 ||
      warps < 1 || warps > kMaxStreamThreads / kTile || hld < hlen || xld < xlen ||
      (static_cast<long long>(p) + k) * m + off > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const StreamShape sh{hld, xld, xlen, hlen, m, p, k, rows, off, warps * kKc};
  const Plane a0{h0, x0, v0}, a1{h1, x1, v1};
  return launch_stream(a0, a1, w, sh, warps, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
