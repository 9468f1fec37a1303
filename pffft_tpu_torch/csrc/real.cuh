// The real transform's split step for one row: REAL_FINALIZE (forward) and
// REAL_PREPROCESS (backward), shared by the fused real kernel
// (real_fused.cu) and the standalone split kernel (real_split.cu).
//
// Device counterpart of pffft_tpu/ops/pallas_fft.py `_fwd_split_block` /
// `_bwd_prep_block` (the flat forms of ops/split.py), row by row, with the
// same operation order as the plain versions in pffft_tpu_torch/ops/split.py.
// H = N/2 is the complex engine length; w = (wr, wi) is the split twiddle of
// row k, exp(-2i pi k / N), stored forward-sign and used as stored in both
// directions.

#pragma once

#include <cuda_runtime.h>

namespace pf {

// Packed real spectrum row k from the length-H transform Z: z = Z[k],
// f = Z[(H - k) % H].  Row 0 packs DC + i*Nyquist.
__device__ __forceinline__ float2 real_finalize(float2 z, float2 f, float wr, float wi,
                                                bool row0) {
  if (row0) return make_float2(z.x + z.y, z.x - z.y);
  const float a = 0.5f * (1.0f + wi);
  const float b = 0.5f * wr;
  const float c = 0.5f * (1.0f - wi);
  return make_float2(a * z.x + b * z.y + c * f.x + b * f.y,
                     -b * z.x + a * z.y + b * f.x - c * f.y);
}

// 2*Z[k] for the backward length-H transform from the packed spectrum S:
// s = S[k], f = S[(H - k) % H].  Row 0 reads DC = s.x and Nyquist = s.y.
__device__ __forceinline__ float2 real_prep(float2 s, float2 f, float wr, float wi,
                                            bool row0) {
  const float xar = s.x;
  const float xai = row0 ? 0.0f : s.y;
  const float xbr = row0 ? s.y : f.x;
  const float xbi = row0 ? 0.0f : f.y;
  const float p = 1.0f + wi;
  const float q = 1.0f - wi;
  return make_float2(p * xar - wr * xai + q * xbr - wr * xbi,
                     wr * xar + p * xai - wr * xbr - q * xbi);
}

}  // namespace pf
