// B10, the in-kernel ksplit: a one-pass N = m*r FFT of time-major planes,
// run by a thread-block cluster.
//
// Replaces pffft_tpu/ops/dispatch.py `_build_ksplit2` / `_make_ksplit2_kernel`
// (entered through `cfft_ksplit2_tmajor`).  Planes [N, B] viewed as [m, r, B]
// (free, row-major) hold in slab c the decimated sequence x[c::r].  One pass
// computes the length-m transform Z_c of every slab, then
//
//   X[s*m + k] = sum_c W_N^{c*k} W_r^{c*s} Z_c[k],   r in {2,3,4,5,8,16,32},
//
// and stores the canonical ordered spectrum [N, B], unscaled, both
// directions.  It is the function of kern2 (stockham_chain.cu on [m, r*B],
// then combine.cu) in one round trip through device memory.
//
// Design.  One cluster of cs blocks (cs divides r, cs <= 16) owns tb batch
// columns of all N rows.  Block q of the cluster holds the slabs
// q*spb .. (q+1)*spb - 1 (spb = r / cs), each as an [m, tb] tile in its
// shared memory: it runs their length-m transforms on the register-resident
// core (regfft.cuh), reading each slab's rows c, c + r, c + 2r, ... straight
// from device memory into the first stage's registers (tb neighbouring
// threads on the tb columns of a row: tb*4-byte row segments) and leaving
// Z_c in shared memory.  After cluster.sync() it computes the twiddled
// radix-r combine for its 1/cs share of k, reading Z_c[k] of the other
// blocks' slabs through distributed shared memory, and stores rows s*m + k.
// A final cluster.sync() keeps every block's tile alive until the others
// have read it.  The planner (ops/dispatch.ksplit2_tile) picks tb, cs and
// the shared memory; a launch the card cannot hold (cudaOccupancy-
// MaxActiveClusters == 0) is refused before it starts.
//
// Bound on this card: 16*N*B bytes in one pass (each plane read once and
// written once), 0.0801 ms for a 64 MB plane pair at 3.35 TB/s; the
// butterflies' ~5 N log2 N B flops are far below the f32 peak.  With m =
// 2048 a block's tile of 8 columns is 2048*8*8 bytes plus padding (147 KB),
// so one block fits an SM; warps overlap their loads with other warps'
// stages, blocks do not.  The ragged last column group is masked.
//
// Build.  This file is compiled once per combine radix, with
// -DPF_KSPLIT2_RADIX=r, into a library of its own (ops/_build.py): each
// holds two kernels (one per direction), the seven builds run in parallel,
// and a call loads only the radix it needs.

#include <cooperative_groups.h>

#include "regfft.cuh"

#ifndef PF_KSPLIT2_RADIX
#error "build with -DPF_KSPLIT2_RADIX=r, r in {2,3,4,5,8,16,32}"
#endif

namespace cg = cooperative_groups;

namespace {

using pf::rf::kMaxThreads;

constexpr int kRadix = PF_KSPLIT2_RADIX;
static_assert(kRadix == 2 || kRadix == 3 || kRadix == 4 || kRadix == 5 || kRadix == 8 ||
                  kRadix == 16 || kRadix == 32,
              "PF_KSPLIT2_RADIX is not a combine radix");
constexpr int kElems = 32;        // values per thread per stage
constexpr int kMaxCluster = 16;   // the largest (non-portable) cluster on sm_90

// The block's slabs in device memory: lane f = slab*tb + col reads slab
// c0 + slab, column b0 + col; element p of the slab is row p*r + c0 + slab.
struct SlabsIn {
  const float* re;
  const float* im;
  int r, ld, tb, cols;
  __device__ __forceinline__ float2 load(int f, int p) const {
    const int s = f / tb, col = f - s * tb;
    if (col >= cols) return make_float2(0.0f, 0.0f);
    const size_t g = (static_cast<size_t>(p) * r + s) * ld + col;
    return make_float2(__ldg(re + g), __ldg(im + g));
  }
};

// The slabs' tiles in shared memory: slab s at s*slab_pitch, element p of
// column col at pad(p)*tb + col.
struct SlabsSmem {
  float2* tile;
  int tb, slab_pitch, shift;
  __device__ __forceinline__ int at(int f, int p) const {
    const int s = f / tb, col = f - s * tb;
    return s * slab_pitch + pf::rf::pad(p, shift) * tb + col;
  }
  __device__ __forceinline__ float2 load(int f, int p) const { return tile[at(f, p)]; }
  __device__ __forceinline__ void store(int f, int p, float2 v) const { tile[at(f, p)] = v; }
};

template <int R, bool BWD>
__global__ void __launch_bounds__(kMaxThreads, 1)
ksplit2_kernel(const float* __restrict__ re, const float* __restrict__ im,
               float* __restrict__ ore, float* __restrict__ oim,
               const float2* __restrict__ tw, const pf::rf::Plan plan,
               const float2* __restrict__ twc, int m, int b, int tb, int spb, int shift) {
  extern __shared__ __align__(16) float2 tile[];  // [spb][pad(m)][tb]
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int q = static_cast<int>(cluster.block_rank());
  const int b0 = (blockIdx.x / cs) * tb;
  const int cols = min(tb, b - b0);
  const int slab_pitch = pf::rf::pad(m - 1, shift) * tb + tb;
  const int lanes = spb * tb;
  const SlabsSmem sm{tile, tb, slab_pitch, shift};
  const SlabsIn src{re + static_cast<size_t>(q) * spb * b + b0,
                    im + static_cast<size_t>(q) * spb * b + b0, R, b, tb, cols};
  // the m-point transforms of the block's slabs, left in the tile
  pf::rf::run<kElems, BWD>(plan, tw, pf::rf::ColLanes{lanes}, lanes, src, sm, sm, false);
  cluster.sync();
  // the combine over k in [k0, k0 + kn), tb columns each
  const int kper = (m + cs - 1) / cs;
  const int k0 = q * kper;
  const int kn = max(0, min(m, k0 + kper) - k0);
  const int total = kn * tb;
  constexpr int QC = R >= kElems ? 1 : kElems / R;
  for (int w0 = threadIdx.x; w0 < total; w0 += QC * blockDim.x) {
    float2 v[QC][R];
#pragma unroll
    for (int u = 0; u < QC; ++u) {
      const int w = w0 + u * blockDim.x;
      if (w < total) {
        const int kk = w / tb, col = w - kk * tb, k = k0 + kk;
        const int e = pf::rf::pad(k, shift) * tb + col;
#pragma unroll
        for (int c = 0; c < R; ++c) {
          const int owner = c / spb;
          const float2* z = cluster.map_shared_rank(tile, owner);
          float2 x = z[(c - owner * spb) * slab_pitch + e];
          if (c > 0) {  // T[k, 0] == 1
            const float2 t = __ldg(twc + c * m + k);
            x = pf::cmul(x, t.x, BWD ? -t.y : t.y);
          }
          v[u][c] = x;
        }
        pf::butterfly<R, BWD>(v[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < QC; ++u) {
      const int w = w0 + u * blockDim.x;
      if (w < total) {
        const int kk = w / tb, col = w - kk * tb, k = k0 + kk;
        if (col < cols) {
#pragma unroll
          for (int s = 0; s < R; ++s) {
            const size_t g = static_cast<size_t>(s * m + k) * b + b0 + col;
            ore[g] = v[u][s].x;
            oim[g] = v[u][s].y;
          }
        }
      }
    }
  }
  cluster.sync();  // the other blocks may still read this tile
}

// The kernel and its launch configuration for a cluster of cs blocks, tb
// columns and spb slabs per block; invalid shapes give
// cudaErrorInvalidValue, a block the core cannot cover
// cudaErrorInvalidConfiguration.
struct Launch {
  decltype(&ksplit2_kernel<kRadix, false>) kernel;
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr[1];
};

cudaError_t configure(Launch* ln, int m, int b, int tb, int cs, int threads, int shift,
                      bool backward, cudaStream_t stream) {
  if (m < 1 || b < 1 || tb < 1 || cs < 1 || cs > kMaxCluster || kRadix % cs || shift < 1 ||
      threads < 32 || threads % 32) {
    return cudaErrorInvalidValue;
  }
  const int spb = kRadix / cs;
  if (static_cast<long long>(threads) * kElems < static_cast<long long>(spb) * tb * m ||
      threads > kMaxThreads) {
    return cudaErrorInvalidConfiguration;
  }
  ln->kernel = backward ? ksplit2_kernel<kRadix, true> : ksplit2_kernel<kRadix, false>;
  const size_t slab_pitch = static_cast<size_t>(pf::rf::pad(m - 1, shift)) * tb + tb;
  const size_t smem = spb * slab_pitch * sizeof(float2);
  cudaError_t err = cudaFuncSetAttribute(ln->kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (cs > 8) {
    err = cudaFuncSetAttribute(ln->kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  ln->config = cudaLaunchConfig_t{};
  ln->config.gridDim = dim3(static_cast<unsigned>(cs * ((b + tb - 1) / tb)));
  ln->config.blockDim = dim3(static_cast<unsigned>(threads));
  ln->config.dynamicSmemBytes = smem;
  ln->config.stream = stream;
  ln->attr[0].id = cudaLaunchAttributeClusterDimension;
  ln->attr[0].val.clusterDim.x = cs;
  ln->attr[0].val.clusterDim.y = 1;
  ln->attr[0].val.clusterDim.z = 1;
  ln->config.attrs = ln->attr;
  ln->config.numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Forward or backward transform of [n, b] planes re/im into ore/oim, n =
// m*r.  desc holds n_stages rows of (r, l, m, offset into tw in complex
// values): the m-plan's stages; tw is the concatenation of their transposed
// [r, l] tables and twc the combine's transposed [r, m] table W_N^{c*k}, as
// (re, im) pairs.  The combine radix r must be this library's
// PF_KSPLIT2_RADIX.  The launch shape is the planner's
// (ops/dispatch.ksplit2_tile): tb columns per cluster of cs blocks of
// `threads` threads, tiles padded every 2^shift rows.  Returns a
// cudaError_t: invalid arguments give cudaErrorInvalidValue, a block the
// core cannot cover cudaErrorInvalidConfiguration, a cluster the card
// cannot hold cudaErrorLaunchOutOfResources (nothing is launched then).
int pf_ksplit2_tmajor(const float* re, const float* im, float* ore, float* oim,
                      const float* tw, const int* desc, int n_stages, const float* twc, int n,
                      int r, int b, int tb, int cs, int threads, int shift, int backward,
                      int device, void* stream) {
  if (r != kRadix || n % r) return cudaErrorInvalidValue;
  const int m = n / r;
  pf::rf::Plan plan;
  cudaError_t err = pf::rf::plan_from(desc, n_stages, &plan);
  if (err != cudaSuccess) return err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Launch ln;
  err = configure(&ln, m, b, tb, cs, threads, shift, backward != 0,
                  static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, ln.kernel, &ln.config);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorLaunchOutOfResources;
  err = cudaLaunchKernelEx(&ln.config, ln.kernel, re, im, ore, oim,
                           reinterpret_cast<const float2*>(tw), plan,
                           reinterpret_cast<const float2*>(twc), m, b, tb, kRadix / cs, shift);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Clusters of the forward kernel the card holds at once at this launch
// shape (cudaOccupancyMaxActiveClusters) and blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into out[0] and out[1].
// Returns a cudaError_t.
int pf_ksplit2_occupancy(int m, int tb, int cs, int threads, int shift, int device, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Launch ln;
  err = configure(&ln, m, tb, tb, cs, threads, shift, false, nullptr);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveClusters(&out[0], ln.kernel, &ln.config);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], ln.kernel, threads,
                                                       ln.config.dynamicSmemBytes);
}

}  // extern "C"
