// Fused overlap-save block convolution: forward FFT, multiply by the filter
// spectrum, backward FFT, in one pass over device memory (B7).
//
// Replaces pffft_tpu/ops/conv_kernel.py `_build` / `_make_conv_kernel` /
// `_make_conv_kernel_scratch` (entered through `zconv_pallas_tmajor`, called
// from FastConv's "fused" route): for each lane (one overlap-save block),
//
//   y = IFFT(FFT(x) * Hf),   Hf = FFT(g) / N  (filter_spectrum: the 1/N of
//                                              the inverse is folded in).
//
// Design.  Both transforms run on the register-resident core of regfft.cuh.
// The forward run reads each lane's first stage straight from device memory
// and leaves the canonical-order spectrum in the block's shared tile; the
// backward run reads it back through TimesHf, which multiplies element k by
// Hf[k] (read through the read-only cache) as it loads, so the multiply
// costs no pass of its own, and its last stage stores straight to device
// memory through the map.  Neither chain scales: the 1/N is in Hf.  The
// backward chain uses the forward tables conjugated.  Two maps:
//
//   columns  time-major planes [N, B], one block per tb columns
//            (ColLanes, as B1): zconv_tmajor, the reference's layout;
//   stream   the frames of FastConv's streams [R, L] read in place, rows
//            ld >= L samples apart (a slice of wider rows, such as a ring
//            buffer's, is read where it lies; RowLanes, as B9: neighbouring
//            threads on neighbouring samples): lane j of row r is frame j
//            at stride u, x[r, j*u + t],
//            or, with a real filter on a real stream (PAIRS), frames 2j and
//            2j + 1 as the lane's re and im.  Samples past L read as zero
//            (the reference's tail memset); the store keeps t < u of each
//            frame and positions < total, straight into the output rows.
//            A complex stream is read and written interleaved (re, im).
//
// A real filter's Hf is Hermitian, so a lane holding two real frames
// (re = a, im = b) comes back as (h*a) + i(h*b).
//
// Bound on this card: the columns map moves 16*N*B bytes per call (both
// planes read once and written once) at 3.35 TB/s; the stream map reads
// each stream sample and writes each output sample once, 4*(R*L + R*total)
// bytes for a real stream.  The two chains' ~10 N log2 N flops per lane stay
// far below the f32 peak.  The stream map also takes the framing and
// unpacking copies that used to run around the kernel off the path.  Both
// maps launch at 16 values a thread (ops/conv_kernel): the column map at
// N = 2048 ran slower at B1's 32 values and tb = 8 than at 16 values and
// tb = 4 (chip_smoke.py's conv_sweep line times both).

#include "regfft.cuh"

namespace {

using pf::rf::kMaxThreads;

// Values a thread holds per stage in the stream map's radix-32 instance
// (the launch shape ops/conv_kernel.stream_tile gives its lengths).
constexpr int kR32Elems = 16;

// The shared tile times the filter spectrum: element p of every lane is
// multiplied by Hf[p].
template <class Sm>
struct TimesHf {
  Sm sm;
  const float* hfr;
  const float* hfi;
  __device__ __forceinline__ float2 load(int f, int p) const {
    return pf::cmul(sm.load(f, p), __ldg(hfr + p), __ldg(hfi + p));
  }
};

// Each chain in a function of its own: inlined into one kernel, the two
// chains made ptxas spill 2.3-7 KB a thread at 128 registers; called, each
// gets the registers alone and neither spills.  The plan stays in the
// kernel's parameter space (__grid_constant__), read through a pointer.
// R32: the plan may open with radix-32 stages (regfft.cuh's run).
template <int E, bool R32, class Lanes, class Src, class Sm>
__device__ __noinline__ void forward_chain(const pf::rf::Plan* plan, const float2* tw, Lanes ln,
                                           int lanes, Src src, Sm sm) {
  // ends after a barrier
  pf::rf::run<E, false, false, R32>(*plan, tw, ln, lanes, src, sm, sm, false);
}

template <int E, bool R32, class Lanes, class Sm, class Dst>
__device__ __noinline__ void backward_chain(const pf::rf::Plan* plan, const float2* tw,
                                            Lanes ln, int lanes, Sm sm, Dst dst,
                                            const float* hfr, const float* hfi) {
  pf::rf::run<E, true, true, R32>(*plan, tw, ln, lanes, TimesHf<Sm>{sm, hfr, hfi}, sm, dst,
                                  true);
}

template <int E, bool R32 = false, class Lanes, class Src, class Sm, class Dst>
__device__ __forceinline__ void convolve(const pf::rf::Plan& plan, const float2* tw,
                                         const Lanes& ln, int lanes, const Src& src,
                                         const Sm& sm, const Dst& dst, const float* hfr,
                                         const float* hfi) {
  forward_chain<E, R32>(&plan, tw, ln, lanes, src, sm);
  backward_chain<E, R32>(&plan, tw, ln, lanes, sm, dst, hfr, hfi);
}

template <int E>
__global__ void __launch_bounds__(kMaxThreads, 1)
conv_cols_kernel(const float* __restrict__ re, const float* __restrict__ im,
                 float* __restrict__ ore, float* __restrict__ oim,
                 const float* __restrict__ hfr, const float* __restrict__ hfi,
                 const float2* __restrict__ tw, const __grid_constant__ pf::rf::Plan plan,
                 int b, int tb, int shift) {
  extern __shared__ __align__(16) float2 tile[];  // [pad(n), tb]
  const int b0 = blockIdx.x * tb;
  const int cols = min(tb, b - b0);
  convolve<E>(plan, tw, pf::rf::ColLanes{tb}, tb, pf::rf::ColsIn{re + b0, im + b0, b, cols},
              pf::rf::ColsSmem{tile, tb, shift}, pf::rf::ColsOut{ore + b0, oim + b0, b, cols},
              hfr, hfi);
}

// The stream map.  x is row r of the input (len samples, of which none past
// len is read; PAIRS: real, else interleaved complex), lane f of the block is
// lane lane0 + f of the row.
template <bool PAIRS>
struct StreamIn {
  const float* x;
  int len, u, lane0, lanes;
  __device__ __forceinline__ float sample(int pos, int part) const {
    return pos < len ? __ldg(x + (PAIRS ? pos : 2 * pos + part)) : 0.0f;
  }
  __device__ __forceinline__ float2 load(int f, int p) const {
    const int j = lane0 + f;
    if (j >= lanes) return make_float2(0.0f, 0.0f);
    if (PAIRS) {
      const int pos = 2 * j * u + p;
      return make_float2(sample(pos, 0), sample(pos + u, 0));
    }
    const int pos = j * u + p;
    return make_float2(sample(pos, 0), sample(pos, 1));
  }
};

template <bool PAIRS>
struct StreamOut {
  float* y;
  int total, u, lane0, lanes;
  __device__ __forceinline__ void store(int f, int p, float2 v) const {
    const int j = lane0 + f;
    if (p >= u || j >= lanes) return;
    if (PAIRS) {
      const int pos = 2 * j * u + p;
      if (pos < total) y[pos] = v.x;
      if (pos + u < total) y[pos + u] = v.y;
    } else {
      const int pos = j * u + p;
      if (pos < total) {
        y[2 * pos] = v.x;
        y[2 * pos + 1] = v.y;
      }
    }
  }
};

// The block's lanes in shared memory, `pitch` float2 apart (as B9's rows).
struct LanesSmem {
  float2* tile;
  int pitch, shift;
  __device__ __forceinline__ float2 load(int f, int p) const {
    return tile[f * pitch + pf::rf::pad(p, shift)];
  }
  __device__ __forceinline__ void store(int f, int p, float2 v) const {
    tile[f * pitch + pf::rf::pad(p, shift)] = v;
  }
};

// Block i serves stream row i / bpr, lanes (i % bpr) * rows .. + rows - 1.
// R32: the instance whose plan opens with radix-32 stages (kR32Elems values
// a thread); every other length runs the thin plan's instances.
template <int E, bool PAIRS, bool R32 = false>
__global__ void __launch_bounds__(kMaxThreads, 1)
conv_stream_kernel(const float* __restrict__ x, float* __restrict__ y,
                   const float* __restrict__ hfr, const float* __restrict__ hfi,
                   const float2* __restrict__ tw, const __grid_constant__ pf::rf::Plan plan,
                   int len, int ld, int total, int u, int lanes, int bpr, int rows,
                   int pitch, int shift) {
  extern __shared__ __align__(16) float2 tile[];  // [rows, pitch]
  const int r = blockIdx.x / bpr;
  const int lane0 = (blockIdx.x - r * bpr) * rows;
  constexpr int kParts = PAIRS ? 1 : 2;  // floats a sample
  const StreamIn<PAIRS> src{x + static_cast<size_t>(r) * ld * kParts, len, u, lane0, lanes};
  const StreamOut<PAIRS> dst{y + static_cast<size_t>(r) * total * kParts, total, u, lane0,
                             lanes};
  convolve<E, R32>(plan, tw, pf::rf::RowLanes{}, rows, src, LanesSmem{tile, pitch, shift}, dst,
                   hfr, hfi);
}

// The plan's checks, shared by both maps (R32: the stream map's radix-32
// plans).
template <bool R32 = false>
cudaError_t load_plan(const int* desc, int n_stages, int n, pf::rf::Plan* plan) {
  cudaError_t err = pf::rf::plan_from<R32>(desc, n_stages, plan);
  if (err != cudaSuccess) return err;
  return pf::rf::plan_spans(*plan, n) ? cudaSuccess : cudaErrorInvalidValue;
}

template <class K>
cudaError_t allow_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

extern "C" {

// Block convolution of [n, b] planes re/im into ore/oim with the filter
// spectrum hfr/hfi ([n], canonical order, pre-scaled by 1/n), one lane per
// column.  desc and tw as for pf_chain_tmajor (the forward stages'
// transposed tables; the backward chain conjugates them); the launch shape
// (tb, threads, elems, shift) is the column planner's
// (ops/pallas_fft.chain_core_tile).  Returns a cudaError_t: invalid
// arguments give cudaErrorInvalidValue, a shape the core cannot cover
// cudaErrorInvalidConfiguration.
int pf_conv_fused_tmajor(const float* re, const float* im, float* ore, float* oim,
                         const float* hfr, const float* hfi, const float* tw,
                         const int* desc, int n_stages, int n, int b, int tb, int threads,
                         int elems, int shift, int device, void* stream) {
  if (b < 1) return cudaErrorInvalidValue;
  size_t smem;
  cudaError_t err = pf::rf::cols_shape(n, tb, threads, elems, shift, &smem);
  if (err != cudaSuccess) return err;
  pf::rf::Plan plan;
  err = load_plan(desc, n_stages, n, &plan);
  if (err != cudaSuccess) return err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto kernel = elems == 16 ? conv_cols_kernel<16> : conv_cols_kernel<32>;
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (b + tb - 1) / tb;
  kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      re, im, ore, oim, hfr, hfi, reinterpret_cast<const float2*>(tw), plan, b, tb, shift);
  return cudaGetLastError();
}

// Block convolution of the frames of `nrows` streams x [nrows, len], rows
// ld >= len samples apart, at stride u into y [nrows, total]: frame j of a
// row is x[j*u : j*u + n] (zero past len: nothing between a row's end and
// the next row is read), and its first u outputs land at y[j*u : j*u + u]
// (only positions < total are written).  pairs = 1: real streams, two frames a
// lane (real filter); pairs = 0: interleaved complex streams, one frame a
// lane.  lanes is the lanes of a row (pairs: ceil(frames / 2)).  The
// launch shape (rows lanes per block, threads, elems, pitch, shift) is the
// row planner's (ops/conv_kernel.stream_tile).  A desc whose first stage is
// radix 32 (ops/conv_kernel.stream_plan) runs the R32 instance, at
// kR32Elems values a thread.  Returns a cudaError_t: invalid arguments give
// cudaErrorInvalidValue, a shape the core cannot cover
// cudaErrorInvalidConfiguration.
int pf_conv_stream(const float* x, float* y, const float* hfr, const float* hfi,
                   const float* tw, const int* desc, int n_stages, int n, int nrows, int len,
                   int ld, int total, int u, int lanes, int pairs, int rows, int threads,
                   int elems, int pitch, int shift, int device, void* stream) {
  if (n < 1 || nrows < 1 || len < 0 || ld < len || total < 1 || u < 1 || u > n || lanes < 1 ||
      rows < 1 || threads < 32 || threads % 32 || shift < 1 ||
      (elems != 16 && elems != 32) || pitch < pf::rf::pad(n - 1, shift) + 1 ||
      static_cast<long long>(lanes) * u * (pairs ? 2 : 1) < total ||
      // every position (and, interleaved, 2 * position + 1) in an int
      2LL * (static_cast<long long>(lanes) * u * 2 + n) > 0x7fffffffLL ||
      2LL * len > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  if (static_cast<long long>(threads) * elems < static_cast<long long>(rows) * n ||
      threads > kMaxThreads) {
    return cudaErrorInvalidConfiguration;
  }
  const long long bpr = (lanes + rows - 1) / rows;
  if (bpr * nrows > 0x7fffffffLL) return cudaErrorInvalidValue;
  const bool r32 = n_stages >= 1 && desc[0] == 32;
  if (r32 && elems != kR32Elems) return cudaErrorInvalidConfiguration;
  pf::rf::Plan plan;
  cudaError_t err = r32 ? load_plan<true>(desc, n_stages, n, &plan)
                        : load_plan(desc, n_stages, n, &plan);
  if (err != cudaSuccess) return err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto kernel = r32 ? (pairs ? conv_stream_kernel<kR32Elems, true, true>
                             : conv_stream_kernel<kR32Elems, false, true>)
                : pairs ? (elems == 16 ? conv_stream_kernel<16, true>
                                       : conv_stream_kernel<32, true>)
                        : (elems == 16 ? conv_stream_kernel<16, false>
                                       : conv_stream_kernel<32, false>);
  const size_t smem = static_cast<size_t>(rows) * pitch * sizeof(float2);
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(bpr * nrows), threads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      x, y, hfr, hfi, reinterpret_cast<const float2*>(tw), plan, len, ld, total, u, lanes,
      static_cast<int>(bpr), rows, pitch, shift);
  return cudaGetLastError();
}

}  // extern "C"
