// A register-resident Stockham FFT core for Hopper, shared by the batch-major
// row FFT (fused2.cu, B9), the clustered one-pass ksplit (ksplit2.cu, B10),
// the time-major chain (stockham_chain.cu, B1), the chain on a packed input
// (chain_packed.cu, B4), the fused real transform (real_fused.cu, B3) and the
// fused block convolution (conv_fused.cu, B7).
//
// A block runs F independent length-n transforms ("lanes") with the stages
// of one thin plan (radix 16/8/4/2, then 5 and 3; an instance that asks for
// it may open with radix-32 stages, see run()).  Within a stage every
// value lives in registers: a thread reads the R inputs of each of its
// butterflies, applies the stage twiddle T[k, i] (conjugated for backward),
// runs the radix-R butterfly (butterflies.cuh) and writes the R outputs.
// Only the exchange between two stages goes through shared memory, so an
// S-stage plan reads its input once (from device memory, straight into the
// first stage's registers), makes S - 1 exchanges, each a write, a barrier,
// a read and (before the next write into the same buffer) a second barrier,
// and writes its last stage's outputs once (to device memory, or to shared
// memory where the caller needs them there).
//
// Stockham indexing, as the plain version `_stage_values`:
// butterfly b = k*m + j of stage (l, R, m) reads element (k*R + i)*m + j and
// writes element (t*l + k)*m + j = t*(l*m) + b, t in [0, R).
//
// A thread holds E values per stage: Q = ceil(E / R) butterflies, with
// butterfly w = threadIdx.x + q*blockDim.x of the F*(n/R) in the block, so
// blockDim.x >= F*n / E covers every stage.  Twiddles are read from a
// transposed table, tw[off + i*l + k] = T[k, i], so that neighbouring
// butterflies read neighbouring entries.
//
// Shared memory holds one float2 per element, with one float2 of padding
// every 2^shift elements of a lane (pad()): the exchange's strided reads
// then fall on distinct banks.

#pragma once

#include <cstdint>

#include "butterflies.cuh"

namespace pf {
namespace rf {

constexpr int kMaxStages = 16;
constexpr int kMaxThreads = 512;  // every core kernel's launch bound: <= 128 registers

struct Plan {
  int count;
  int r[kMaxStages];
  int l[kMaxStages];
  int m[kMaxStages];
  int off[kMaxStages];  // offset of the stage's transposed [r, l] table in tw
};

__host__ __device__ __forceinline__ int pad(int p, int shift) { return p + (p >> shift); }

// Lanes of a block: which lane and which butterfly the block's butterfly w is.
// Rows (B9): lane-major, so neighbouring threads take neighbouring elements
// of one contiguous row.
struct RowLanes {
  __device__ __forceinline__ void split(int w, int nb, int& f, int& b) const {
    f = w / nb;
    b = w - f * nb;
  }
};

// Columns (B10): lane-minor, so neighbouring threads take neighbouring
// batch columns of one row.
struct ColLanes {
  int lanes;
  __device__ __forceinline__ void split(int w, int, int& f, int& b) const {
    b = w / lanes;
    f = w - b * lanes;
  }
};

// Time-major planes [n, ld] (B1, B7's column map): lane f of the block is
// column c0 + f, element p is row p; the planes start at column c0, and
// lanes f >= cols (past the last column) load zeros and store nothing.
struct ColsIn {
  const float* re;
  const float* im;
  int ld, cols;
  __device__ __forceinline__ float2 load(int f, int p) const {
    if (f >= cols) return make_float2(0.0f, 0.0f);
    const size_t g = static_cast<size_t>(p) * ld + f;
    return make_float2(__ldg(re + g), __ldg(im + g));
  }
};

// A packed time-major buffer y [n, ld] (B4): slabs of 2*seg columns, re at
// columns s*2*seg + j and im at s*2*seg + seg + j of slab s.  Lane f of the
// block is global column c = c0 + f, which reads slab s = c / seg, lane j =
// c mod seg, so a block's lanes may straddle two slabs; lanes f >= cols load
// zeros.  With one slab (ld = 2*seg) it is the free [n, 2B] view of a real
// signal, re and im side by side.
struct PackedColsIn {
  const float* y;
  int ld, seg, c0, cols;
  __device__ __forceinline__ float2 load(int f, int p) const {
    if (f >= cols) return make_float2(0.0f, 0.0f);
    const int c = c0 + f;
    const int s = c / seg;
    const size_t g = static_cast<size_t>(p) * ld + static_cast<size_t>(s) * seg + c;
    return make_float2(__ldg(y + g), __ldg(y + g + seg));
  }
};

struct ColsOut {
  float* re;
  float* im;
  int ld, cols;
  __device__ __forceinline__ void store(int f, int p, float2 v) const {
    if (f >= cols) return;
    const size_t g = static_cast<size_t>(p) * ld + f;
    re[g] = v.x;
    im[g] = v.y;
  }
};

// The block's [pad(n), tb] tile of columns in shared memory: element p of
// lane f at pad(p)*tb + f.
struct ColsSmem {
  float2* tile;
  int tb, shift;
  __device__ __forceinline__ float2 load(int f, int p) const {
    return tile[pad(p, shift) * tb + f];
  }
  __device__ __forceinline__ void store(int f, int p, float2 v) const {
    tile[pad(p, shift) * tb + f] = v;
  }
};

// One radix-R stage (l, R, m) over all lanes: `total` = lanes * l*m
// butterflies.  BARRIER: in and out are the same shared buffer, so every
// read of the stage completes before the first write.
template <int R, int E, bool BWD, bool BARRIER, class Lanes, class In, class Out>
__device__ __forceinline__ void stage(const Lanes& ln, int total, int l, int m,
                                      const float2* __restrict__ tw, const In& in,
                                      const Out& out) {
  constexpr int Q = (E + R - 1) / R;
  const int nb = l * m;
  float2 v[Q][R];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int w = threadIdx.x + q * blockDim.x;
    if (w < total) {
      int f, b;
      ln.split(w, nb, f, b);
      const int k = b / m;
      const int base = b + k * (R - 1) * m;  // (k*R)*m + j
#pragma unroll
      for (int i = 0; i < R; ++i) {
        float2 x = in.load(f, base + i * m);
        if (i > 0 && l > 1) {  // T[k, 0] == 1
          const float2 t = __ldg(tw + i * l + k);
          x = cmul(x, t.x, BWD ? -t.y : t.y);
        }
        v[q][i] = x;
      }
      butterfly<R, BWD>(v[q]);
    }
  }
  if (BARRIER) __syncthreads();
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int w = threadIdx.x + q * blockDim.x;
    if (w < total) {
      int f, b;
      ln.split(w, nb, f, b);
#pragma unroll
      for (int t = 0; t < R; ++t) out.store(f, t * nb + b, v[q][t]);
    }
  }
}

// Stage s of the plan, from `src` (device memory) when it is the first and
// to `dst` (device memory) when it is the last; `sm` (shared memory)
// otherwise.  A stage that writes shared memory ends with a barrier.
// SRC_SHARED: `src` reads the shared buffer itself (a map over `sm`), so
// the first stage completes its reads before its first write.
template <int R, int E, bool BWD, bool SRC_SHARED, class Lanes, class Src, class Sm,
          class Dst>
__device__ __forceinline__ void stage_at(bool first, bool last, const Lanes& ln, int lanes,
                                         int l, int m, const float2* __restrict__ tw,
                                         const Src& src, const Sm& sm, const Dst& dst) {
  const int total = lanes * l * m;
  if (first && last) {
    stage<R, E, BWD, false>(ln, total, l, m, tw, src, dst);
  } else if (first) {
    stage<R, E, BWD, SRC_SHARED>(ln, total, l, m, tw, src, sm);
    __syncthreads();
  } else if (last) {
    stage<R, E, BWD, false>(ln, total, l, m, tw, sm, dst);
  } else {
    stage<R, E, BWD, true>(ln, total, l, m, tw, sm, sm);
    __syncthreads();
  }
}

// Every stage of the plan on `lanes` lanes.  last_to_dst = false keeps the
// last stage's outputs in shared memory (for a combine or a mapped store
// that follows); the call then ends after a barrier.  SRC_SHARED: `src`
// reads `sm` (a second pass over what an earlier call left there).
//
// A thin plan's radices come in the order 16..., then at most one of 8, 4,
// 2, then 5..., then 3..., so each radix gets a loop (or a test) of its own.
// One loop over all stages with a switch on the radix made ptxas spill at
// 128 registers, while each radix alone spills nothing.  R32: the plan may
// open with radix-32 stages (B7's stream map at 8192 = 32*16*16: one stage,
// so one exchange a chain, fewer than the thin plan); only a kernel
// instance that asks for it compiles that loop.
template <int E, bool BWD, bool SRC_SHARED = false, bool R32 = false, class Lanes, class Src,
          class Sm, class Dst>
__device__ __forceinline__ void run(const Plan& p, const float2* __restrict__ tw,
                                    const Lanes& ln, int lanes, const Src& src, const Sm& sm,
                                    const Dst& dst, bool last_to_dst) {
  int s = 0;
#define PF_RF_STAGE(R)                                                                   \
  stage_at<R, E, BWD, SRC_SHARED>(s == 0, last_to_dst && s == p.count - 1, ln, lanes, p.l[s], \
                                  p.m[s], tw + p.off[s], src, sm, dst)
  if constexpr (R32) {
    for (; s < p.count && p.r[s] == 32; ++s) PF_RF_STAGE(32);
  }
  for (; s < p.count && p.r[s] == 16; ++s) PF_RF_STAGE(16);
  if (s < p.count && p.r[s] == 8) PF_RF_STAGE(8), ++s;
  if (s < p.count && p.r[s] == 4) PF_RF_STAGE(4), ++s;
  if (s < p.count && p.r[s] == 2) PF_RF_STAGE(2), ++s;
  for (; s < p.count && p.r[s] == 5; ++s) PF_RF_STAGE(5);
  for (; s < p.count && p.r[s] == 3; ++s) PF_RF_STAGE(3);
#undef PF_RF_STAGE
}

// Host side: the stage descriptor, n_stages rows of (r, l, m, offset into
// tw in complex values), in the thin order run() walks (R32: radix-32
// stages may come first, for a run<..., R32 = true>).  Invalid rows give
// cudaErrorInvalidValue.
template <bool R32 = false>
inline cudaError_t plan_from(const int* desc, int n_stages, Plan* p) {
  if (n_stages < 1 || n_stages > kMaxStages) return cudaErrorInvalidValue;
  *p = Plan{};
  p->count = n_stages;
  int rank = 0;  // position of the radix in the order 32, 16, 8, 4, 2, 5, 3
  for (int s = 0; s < n_stages; ++s) {
    const int r = desc[4 * s];
    const int at = R32 && r == 32 ? 0 : r == 16 ? 1 : r == 8 ? 2 : r == 4 ? 3 : r == 2 ? 4
                 : r == 5 ? 5 : r == 3 ? 6 : -1;
    // out of order, unknown, or a second 8, 4 or 2
    if (at < rank || (at == rank && at >= 2 && at <= 4)) return cudaErrorInvalidValue;
    rank = at;
    p->r[s] = r;
    p->l[s] = desc[4 * s + 1];
    p->m[s] = desc[4 * s + 2];
    p->off[s] = desc[4 * s + 3];
  }
  return cudaSuccess;
}

// Host side: whether every stage (l, r, m) of p spans length n.
inline bool plan_spans(const Plan& p, int n) {
  for (int s = 0; s < p.count; ++s) {
    if (static_cast<long long>(p.l[s]) * p.r[s] * p.m[s] != n) return false;
  }
  return true;
}

// Host side: the checks of a column launch (B1, B7's column map) of tb
// lanes of length n on `threads` threads holding `elems` values a stage;
// *smem gets the bytes of its padded [pad(n), tb] tile.  Invalid arguments
// give cudaErrorInvalidValue, a block the core cannot cover
// cudaErrorInvalidConfiguration.
inline cudaError_t cols_shape(int n, int tb, int threads, int elems, int shift,
                              size_t* smem) {
  if (n < 1 || tb < 1 || threads < 32 || threads % 32 || shift < 1 ||
      (elems != 16 && elems != 32)) {
    return cudaErrorInvalidValue;
  }
  if (static_cast<long long>(threads) * elems < static_cast<long long>(n) * tb ||
      threads > kMaxThreads) {
    return cudaErrorInvalidConfiguration;
  }
  *smem = static_cast<size_t>(pad(n - 1, shift) + 1) * tb * sizeof(float2);
  return cudaSuccess;
}

}  // namespace rf
}  // namespace pf
