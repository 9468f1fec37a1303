// One-pass real transform: the length-H chain and the real split step in
// one kernel, time-major (B3).
//
// Replaces pffft_tpu/ops/pallas_fft.py `_build_real_fused` /
// `_make_kernel_real_fused` (entered through `rfft_pallas_tmajor_fused` and
// `rfft_bwd_pallas_tmajor_fused`).  H = N/2:
//
//   forward:  packed real input y [H, 2B] (the free x.reshape(H, 2B) of a
//             real [N, B] signal) -> the chain -> REAL_FINALIZE -> packed
//             spectrum planes [H, B] x2, bin0 = DC + i*Nyquist.
//   backward: spectrum planes [H, B] x2 -> REAL_PREPROCESS (2*Z) -> the
//             backward chain -> the pre-interleave pair [H, B] x2, written
//             as the two halves of one [H, 2B] buffer, which is the real
//             [N, B] signal itself (re at columns [0, B), im at [B, 2B)),
//             so no interleave copy follows.
//
// Design.  B1 on the register-resident core of regfft.cuh (one lane per
// batch column, the thin chain, stages exchanging through one padded
// [pad(H), tb] tile), at B1's launch shape (ops/pallas_fft.chain_core_tile).
// The split step needs row (H - k) % H beside row k, and a row of a lane
// belongs to the block that owns the lane, so the Hermitian mirror needs no
// second kernel (nor the TPU kernel's roll network and its power-of-two H):
//   Forward: the first stage loads straight from the packed buffer
//   (PackedColsIn), and the stages but the last run as B1's.  The last
//   stage (m = 1) puts row t*l + k in output t of butterfly k, whose mirror
//   is output R - 1 - t of butterfly l - k, so a thread runs the two
//   butterflies of a pair and stores REAL_FINALIZE of both straight to the
//   planes (last_finalize): no pass of its own over the tile.  (A separate
//   pass after the last stage, rows k and H - k a thread, ran 2-15% slower
//   on the H100; one thread per element slower still.)
//   Backward: one pass, a thread per (row pair, lane), reads S[k] and
//   S[H - k] once from the planes and writes REAL_PREPROCESS of both into
//   the tile; after a barrier the stages run from the tile and the last one
//   stores straight to the output.  (REAL_PREPROCESS inside the first
//   stage's loads, each value reading its mirror again, took 128 registers
//   and ran 20-40% slower.)  Rows 0 and H/2, each its own mirror, share one
//   item in both directions, so the items divide evenly among the threads.
// The split twiddles (8*H bytes) are read through the read-only cache.  The
// timings above are chip_smoke.py's real_fused_sweep lines.
//
// Bound on this card: 16*H*B bytes per call (the [N, B] input read once,
// both [H, B] output planes written once, or the reverse), 0.0401 ms at 64
// MB per plane at 3.35 TB/s; the flops are those of the chain plus ~16 per
// output, far below the f32 peak.  What limits it is B1's: the row segment
// a block reads, tb*4 bytes (32 at H = 2048), and one block per SM (its
// tile), so a block's loads, stages and stores do not overlap.

#include "real.cuh"
#include "regfft.cuh"

namespace {

using pf::rf::ColLanes;
using pf::rf::ColsOut;
using pf::rf::ColsSmem;
using pf::rf::kMaxThreads;

// The spectrum planes [n, ld] (from the block's first column; lanes f >=
// cols are past the last column) and the split twiddles, for prep_tile.
struct PlanesIn {
  const float* sr;
  const float* si;
  const float* wr;
  const float* wi;
  int ld, cols, n;
};

// REAL_PREPROCESS from the planes into the tile, one thread per (row
// group, lane): rows k and n - k, read once and both written, or for k = 0
// rows 0 and n/2, each its own mirror (so every thread of a block of n*tb/2
// items gets the same count).  U items a thread at a time, their loads
// issued first.
template <int U>
__device__ __forceinline__ void prep_tile(const PlanesIn& in, const ColsSmem& sm, int tb) {
  const int n = in.n;
  const int items = (n + 1) / 2 * tb;
  for (int u0 = threadIdx.x; u0 < items; u0 += U * blockDim.x) {
    float2 s[U], t[U];
    float w[U][4];
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int u = min(u0 + i * blockDim.x, items - 1);
      const int k = u / tb, f = min(u - k * tb, in.cols - 1);
      const int m = k == 0 ? n / 2 * (1 - n % 2) : n - k;
      const size_t g = static_cast<size_t>(k) * in.ld + f;
      const size_t h = static_cast<size_t>(m) * in.ld + f;
      s[i] = make_float2(__ldg(in.sr + g), __ldg(in.si + g));
      t[i] = make_float2(__ldg(in.sr + h), __ldg(in.si + h));
      w[i][0] = __ldg(in.wr + k), w[i][1] = __ldg(in.wi + k);
      w[i][2] = __ldg(in.wr + m), w[i][3] = __ldg(in.wi + m);
    }
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int u = u0 + i * blockDim.x;
      if (u >= items) break;
      const int k = u / tb, f = u - k * tb;
      const int m = k == 0 ? n / 2 * (1 - n % 2) : n - k;
      const bool live = f < in.cols;  // lanes past the last column hold zeros
      const float2 zero = make_float2(0.0f, 0.0f);
      const float2 mk = k == 0 ? s[i] : t[i];  // the mirrors of rows k and m
      const float2 mm = k == 0 ? t[i] : s[i];
      sm.store(f, k, live ? pf::real_prep(s[i], mk, w[i][0], w[i][1], k == 0) : zero);
      if (m != k) sm.store(f, m, live ? pf::real_prep(t[i], mm, w[i][2], w[i][3], false) : zero);
    }
  }
}

// Items a thread reads before it writes in the backward's split pass: four
// keep 16 loads a thread in flight, where one at a time left the pass
// latency-bound; eight made the kernel spill.
constexpr int kSplitItems = 4;

// One butterfly k of lane f of the last stage (l, R, m = 1) from the tile:
// inputs k*R + i, twiddles T[k, i], forward.
template <int R>
__device__ __forceinline__ void last_butterfly(const ColsSmem& sm, int f, int k, int l,
                                               const float2* __restrict__ tw, float2 (&v)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    float2 x = sm.load(f, k * R + i);
    if (i > 0 && l > 1) {  // T[k, 0] == 1
      const float2 t = __ldg(tw + i * l + k);
      x = pf::cmul(x, t.x, t.y);
    }
    v[i] = x;
  }
  pf::butterfly<R, false>(v);
}

// The forward's last stage (l, R, m = 1) with REAL_FINALIZE fused: output t
// of butterfly k is row p = t*l + k, and its mirror (n - p) % n is output
// R - 1 - t of butterfly l - k (output (R - t) % R of butterfly 0, output
// R - 1 - t of butterfly l/2 itself).  One thread runs butterflies k and l -
// k of a lane, or 0 and l/2 (so every thread of a block of l*tb/2 items gets
// the same count), from the tile and stores REAL_FINALIZE of their 2R rows
// straight to dst, with no second pass over the tile.
template <int R>
__device__ __forceinline__ void last_finalize(const ColsSmem& sm, int tb, int l,
                                              const float2* __restrict__ tw,
                                              const float* __restrict__ wr,
                                              const float* __restrict__ wi,
                                              const ColsOut& dst) {
  const int items = (l + 1) / 2 * tb;
  for (int u = threadIdx.x; u < items; u += blockDim.x) {
    const int k = u / tb, f = u - k * tb;
    const int kk = k == 0 ? l / 2 * (1 - l % 2) : l - k;
    float2 a[R], c[R];
    last_butterfly<R>(sm, f, k, l, tw, a);
    last_butterfly<R>(sm, f, kk, l, tw, c);
#pragma unroll
    for (int t = 0; t < R; ++t) {
      const int p = t * l + k;
      const float2 ma = k == 0 ? a[(R - t) % R] : c[R - 1 - t];  // mirrors of rows p and q
      const float2 mc = k == 0 ? c[R - 1 - t] : a[R - 1 - t];
      dst.store(f, p, pf::real_finalize(a[t], ma, __ldg(wr + p), __ldg(wi + p), p == 0));
      if (kk != k) {
        const int q = t * l + kk;
        dst.store(f, q, pf::real_finalize(c[t], mc, __ldg(wr + q), __ldg(wi + q), false));
      }
    }
  }
}

// The forward: `head` holds the plan's stages but the last (none for a
// one-stage plan, whose input is first copied into the tile), and (last_r,
// last_l, last_off) is the last, run by last_finalize.
template <int E>
__global__ void __launch_bounds__(kMaxThreads, 1)
rfft_fused_fwd(const float* __restrict__ y, float* __restrict__ ore, float* __restrict__ oim,
               const float2* __restrict__ tw, const float* __restrict__ wr,
               const float* __restrict__ wi, const pf::rf::Plan head, int last_r, int last_l,
               int last_off, int n, int b, int tb, int shift) {
  extern __shared__ __align__(16) float2 tile[];  // [pad(n), tb]
  const int b0 = blockIdx.x * tb;
  const int cols = min(tb, b - b0);
  const pf::rf::PackedColsIn src{y, 2 * b, b, b0, cols};
  const ColsSmem sm{tile, tb, shift};
  if (head.count > 0) {
    pf::rf::run<E, false>(head, tw, ColLanes{tb}, tb, src, sm, sm, false);
  } else {
    for (int e = threadIdx.x; e < n * tb; e += blockDim.x) {
      const int p = e / tb;
      sm.store(e - p * tb, p, src.load(e - p * tb, p));
    }
    __syncthreads();
  }
  const ColsOut dst{ore + b0, oim + b0, b, cols};
  const float2* lt = tw + last_off;
  switch (last_r) {
    case 16: last_finalize<16>(sm, tb, last_l, lt, wr, wi, dst); break;
    case 8: last_finalize<8>(sm, tb, last_l, lt, wr, wi, dst); break;
    case 4: last_finalize<4>(sm, tb, last_l, lt, wr, wi, dst); break;
    case 2: last_finalize<2>(sm, tb, last_l, lt, wr, wi, dst); break;
    case 5: last_finalize<5>(sm, tb, last_l, lt, wr, wi, dst); break;
    default: last_finalize<3>(sm, tb, last_l, lt, wr, wi, dst); break;
  }
}

template <int E>
__global__ void __launch_bounds__(kMaxThreads, 1)
rfft_fused_bwd(const float* __restrict__ sr, const float* __restrict__ si,
               float* __restrict__ x, const float2* __restrict__ tw, const float* __restrict__ wr,
               const float* __restrict__ wi, const pf::rf::Plan plan, int n, int b, int tb,
               int shift) {
  extern __shared__ __align__(16) float2 tile[];  // [pad(n), tb]
  const int b0 = blockIdx.x * tb;
  const int cols = min(tb, b - b0);
  const ColsSmem sm{tile, tb, shift};
  prep_tile<kSplitItems>(PlanesIn{sr + b0, si + b0, wr, wi, b, cols, n}, sm, tb);
  __syncthreads();
  pf::rf::run<E, true, true>(plan, tw, ColLanes{tb}, tb, sm, sm,
                             ColsOut{x + b0, x + b + b0, 2 * b, cols}, true);
}

using FwdKernel = decltype(&rfft_fused_fwd<32>);
using BwdKernel = decltype(&rfft_fused_bwd<32>);

FwdKernel pick_fwd(int elems) { return elems == 16 ? rfft_fused_fwd<16> : rfft_fused_fwd<32>; }


BwdKernel pick_bwd(int elems) { return elems == 16 ? rfft_fused_bwd<16> : rfft_fused_bwd<32>; }

// Checks the arguments and the launch shape, builds the plan and sets the
// kernel's shared-memory limit; *smem gets the tile's bytes.
template <class K>
cudaError_t prepare(K kernel, const int* desc, int n_stages, int n, int b, int tb,
                    int threads, int elems, int shift, int device, pf::rf::Plan* plan,
                    size_t* smem) {
  if (b < 1 || b > 0x3fffffff) return cudaErrorInvalidValue;
  cudaError_t err = pf::rf::cols_shape(n, tb, threads, elems, shift, smem);
  if (err != cudaSuccess) return err;
  err = pf::rf::plan_from(desc, n_stages, plan);
  if (err != cudaSuccess) return err;
  if (!pf::rf::plan_spans(*plan, n)) return cudaErrorInvalidValue;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

}  // namespace

extern "C" {

// Forward: packed y ([n, 2b]) into the packed spectrum planes ore/oim
// ([n, b]).  desc and tw as for pf_chain_tmajor (the thin length-n chain,
// transposed tables), and its launch shape (tb, threads, elems, shift);
// wr/wi are the [n] split twiddles.  Returns a cudaError_t: invalid
// arguments give cudaErrorInvalidValue, a shape the core cannot cover
// cudaErrorInvalidConfiguration.
int pf_rfft_tmajor_fused_fwd(const float* y, float* ore, float* oim, const float* tw,
                             const float* wr, const float* wi, const int* desc,
                             int n_stages, int n, int b, int tb, int threads, int elems,
                             int shift, int device, void* stream) {
  const FwdKernel kernel = pick_fwd(elems);
  pf::rf::Plan plan;
  size_t smem;
  cudaError_t err = prepare(kernel, desc, n_stages, n, b, tb, threads, elems, shift, device,
                            &plan, &smem);
  if (err != cudaSuccess) return err;
  const int s = plan.count - 1;
  if (plan.m[s] != 1) return cudaErrorInvalidValue;
  pf::rf::Plan head = plan;
  head.count = s;
  kernel<<<(b + tb - 1) / tb, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      y, ore, oim, reinterpret_cast<const float2*>(tw), wr, wi, head, plan.r[s], plan.l[s],
      plan.off[s], n, b, tb, shift);
  return cudaGetLastError();
}

// Backward: spectrum planes sr/si ([n, b]) into the real [2n, b] signal x,
// viewed as [n, 2b]: row p of the pre-interleave pair's lane j at x[p*2b +
// j] (re) and x[p*2b + b + j] (im).  Otherwise as the forward.
int pf_rfft_tmajor_fused_bwd(const float* sr, const float* si, float* x, const float* tw,
                             const float* wr, const float* wi, const int* desc, int n_stages,
                             int n, int b, int tb, int threads, int elems, int shift,
                             int device, void* stream) {
  const BwdKernel kernel = pick_bwd(elems);
  pf::rf::Plan plan;
  size_t smem;
  cudaError_t err = prepare(kernel, desc, n_stages, n, b, tb, threads, elems, shift, device,
                            &plan, &smem);
  if (err != cudaSuccess) return err;
  kernel<<<(b + tb - 1) / tb, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      sr, si, x, reinterpret_cast<const float2*>(tw), wr, wi, plan, n, b, tb,
      shift);
  return cudaGetLastError();
}

// Blocks of the forward (backward != 0: the backward) kernel one SM holds at
// this launch shape (cudaOccupancyMaxActiveBlocksPerMultiprocessor, with the
// registers ptxas gave), into *out.  Returns a cudaError_t.
int pf_rfft_fused_occupancy(int n, int tb, int threads, int elems, int shift, int backward,
                            int device, int* out) {
  size_t smem;
  cudaError_t err = pf::rf::cols_shape(n, tb, threads, elems, shift, &smem);
  if (err != cudaSuccess) return err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const void* kernel = backward ? reinterpret_cast<const void*>(pick_bwd(elems))
                                : reinterpret_cast<const void*>(pick_fwd(elems));
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, threads, smem);
}

}  // extern "C"
