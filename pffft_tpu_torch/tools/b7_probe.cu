// B7's stream map (csrc/conv_fused.cu) at every launch shape the core takes,
// for real streams, with the thin plan or a plan that opens with radix-32
// stages; built and timed by tools/b7_probe.py.  No path of the port calls
// it: the port launches the stream map through pf_conv_stream, which runs
// the radix-32 plans at one shape only (kR32Elems values a thread).

#include "conv_fused.cu"

extern "C" {

// As pf_conv_stream with pairs = 1, but any of the four real-stream
// instances: elems 16 or 32, the thin plan or a radix-32 one (desc[0] ==
// 32).  Shapes are checked as pf_conv_stream checks them.
int pf_probe_stream(const float* x, float* y, const float* hfr, const float* hfi,
                    const float* tw, const int* desc, int n_stages, int n, int nrows, int len,
                    int ld, int total, int u, int lanes, int rows, int threads, int elems,
                    int pitch, int shift, void* stream) {
  if (n < 1 || nrows < 1 || len < 0 || ld < len || total < 1 || u < 1 || u > n || lanes < 1 ||
      rows < 1 || threads < 32 || threads % 32 || shift < 1 || (elems != 16 && elems != 32) ||
      pitch < pf::rf::pad(n - 1, shift) + 1 ||
      static_cast<long long>(lanes) * u * 2 < total) {
    return cudaErrorInvalidValue;
  }
  if (static_cast<long long>(threads) * elems < static_cast<long long>(rows) * n ||
      threads > kMaxThreads) {
    return cudaErrorInvalidConfiguration;
  }
  const int bpr = (lanes + rows - 1) / rows;
  const bool r32 = n_stages >= 1 && desc[0] == 32;
  pf::rf::Plan plan;
  cudaError_t err = r32 ? load_plan<true>(desc, n_stages, n, &plan)
                        : load_plan(desc, n_stages, n, &plan);
  if (err != cudaSuccess) return err;
  auto kernel = r32 ? (elems == 16 ? conv_stream_kernel<16, true, true>
                                   : conv_stream_kernel<32, true, true>)
                    : (elems == 16 ? conv_stream_kernel<16, true>
                                   : conv_stream_kernel<32, true>);
  const size_t smem = static_cast<size_t>(rows) * pitch * sizeof(float2);
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<bpr * nrows, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, y, hfr, hfi, reinterpret_cast<const float2*>(tw), plan, len, ld, total, u, lanes, bpr,
      rows, pitch, shift);
  return cudaGetLastError();
}

// Blocks of the instance an SM holds at once, by the card's occupancy
// calculator (the registers ptxas gave).
int pf_probe_occupancy(int r32, int elems, int threads, int smem, int* blocks) {
  auto kernel = r32 ? (elems == 16 ? conv_stream_kernel<16, true, true>
                                   : conv_stream_kernel<32, true, true>)
                    : (elems == 16 ? conv_stream_kernel<16, true>
                                   : conv_stream_kernel<32, true>);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, threads, smem);
}

}  // extern "C"
