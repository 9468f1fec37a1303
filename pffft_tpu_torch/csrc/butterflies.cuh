// Radix-2/3/4/5/8/16/32 butterflies on float2 values held in registers.
//
// Device counterpart of `_butterfly` in pffft_tpu/ops/pallas_fft.py (and of
// its plain PyTorch copy in pffft_tpu_torch/ops/pallas_fft.py): the same
// algebra, the same operation order and the same f32 constants, so a kernel
// and its plain version differ only where nvcc contracts a*b+c into an FMA.
//
//   y[t] = sum_i W_r^{sign*i*t} x[i],  sign = -1 forward, +1 backward.
//
// Each header user is compiled into its own shared library, so the
// extern "C" helper below is defined once per library.

#pragma once

#include <cuda_runtime.h>

extern "C" const char* pf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace pf {

// f32 roundings of the reference's float64 constants: sqrt(3)/2 and
// cos/sin of 2pi/5 and 4pi/5.
constexpr float kSqrt3_2 = 0x1.bb67aep-1f;
constexpr float kC51 = 0x1.3c6ef4p-2f;
constexpr float kS51 = 0x1.e6f0e2p-1f;
constexpr float kC52 = -0x1.9e377ap-1f;
constexpr float kS52 = 0x1.2cf23p-1f;

// cos/sin(2 pi k / 32), rounded to f32 from float64.  W8^c = W32^{4c} and
// W16^{bc} = W32^{2bc} round to the same f32 values as the reference's own
// expressions (checked for every (radix, b, c) the butterflies use).
static __constant__ float kW32Cos[32] = {
    0x1p+0f,         0x1.f6297cp-1f,  0x1.d906bcp-1f,  0x1.a9b662p-1f,
    0x1.6a09e6p-1f,  0x1.1c73b4p-1f,  0x1.87de2ap-2f,  0x1.8f8b84p-3f,
    0x1.1a6264p-54f, -0x1.8f8b84p-3f, -0x1.87de2ap-2f, -0x1.1c73b4p-1f,
    -0x1.6a09e6p-1f, -0x1.a9b662p-1f, -0x1.d906bcp-1f, -0x1.f6297cp-1f,
    -0x1p+0f,        -0x1.f6297cp-1f, -0x1.d906bcp-1f, -0x1.a9b662p-1f,
    -0x1.6a09e6p-1f, -0x1.1c73b4p-1f, -0x1.87de2ap-2f, -0x1.8f8b84p-3f,
    -0x1.a79394p-53f, 0x1.8f8b84p-3f, 0x1.87de2ap-2f,  0x1.1c73b4p-1f,
    0x1.6a09e6p-1f,  0x1.a9b662p-1f,  0x1.d906bcp-1f,  0x1.f6297cp-1f};
static __constant__ float kW32Sin[32] = {
    0.0f,            0x1.8f8b84p-3f,  0x1.87de2ap-2f,  0x1.1c73b4p-1f,
    0x1.6a09e6p-1f,  0x1.a9b662p-1f,  0x1.d906bcp-1f,  0x1.f6297cp-1f,
    0x1p+0f,         0x1.f6297cp-1f,  0x1.d906bcp-1f,  0x1.a9b662p-1f,
    0x1.6a09e6p-1f,  0x1.1c73b4p-1f,  0x1.87de2ap-2f,  0x1.8f8b84p-3f,
    0x1.1a6264p-53f, -0x1.8f8b84p-3f, -0x1.87de2ap-2f, -0x1.1c73b4p-1f,
    -0x1.6a09e6p-1f, -0x1.a9b662p-1f, -0x1.d906bcp-1f, -0x1.f6297cp-1f,
    -0x1p+0f,        -0x1.f6297cp-1f, -0x1.d906bcp-1f, -0x1.a9b662p-1f,
    -0x1.6a09e6p-1f, -0x1.1c73b4p-1f, -0x1.87de2ap-2f, -0x1.8f8b84p-3f};

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

// (xr*wr - xi*wi, xr*wi + xi*wr), the reference's planar product
__device__ __forceinline__ float2 cmul(float2 a, float wr, float wi) {
  return make_float2(a.x * wr - a.y * wi, a.x * wi + a.y * wr);
}

// a * W32^{sign*k}
template <bool BWD>
__device__ __forceinline__ float2 cmul_w32(float2 a, int k) {
  const float s = BWD ? 1.0f : -1.0f;
  return cmul(a, kW32Cos[k], s * kW32Sin[k]);
}

template <bool BWD>
__device__ __forceinline__ void bf4(float2& x0, float2& x1, float2& x2, float2& x3) {
  const float2 t0 = cadd(x0, x2), t1 = csub(x0, x2);
  const float2 t2 = cadd(x1, x3), t3 = csub(x1, x3);
  float2 y1, y3;
  if (!BWD) {  // y1 = t1 - i t3, y3 = t1 + i t3
    y1 = make_float2(t1.x + t3.y, t1.y - t3.x);
    y3 = make_float2(t1.x - t3.y, t1.y + t3.x);
  } else {
    y1 = make_float2(t1.x - t3.y, t1.y + t3.x);
    y3 = make_float2(t1.x + t3.y, t1.y - t3.x);
  }
  x0 = cadd(t0, t2);
  x1 = y1;
  x2 = csub(t0, t2);
  x3 = y3;
}

template <bool BWD>
__device__ __forceinline__ void bf3(float2* v) {
  const float s3 = (BWD ? 1.0f : -1.0f) * kSqrt3_2;
  const float2 x0 = v[0];
  const float2 s = cadd(v[1], v[2]), d = csub(v[1], v[2]);
  const float mr = x0.x - 0.5f * s.x, mi = x0.y - 0.5f * s.y;
  v[0] = cadd(x0, s);
  v[1] = make_float2(mr - s3 * d.y, mi + s3 * d.x);
  v[2] = make_float2(mr + s3 * d.y, mi - s3 * d.x);
}

template <bool BWD>
__device__ __forceinline__ void bf5(float2* v) {
  const float sign = BWD ? 1.0f : -1.0f;
  const float2 x0 = v[0];
  const float2 s1 = cadd(v[1], v[4]), d1 = csub(v[1], v[4]);
  const float2 s2 = cadd(v[2], v[3]), d2 = csub(v[2], v[3]);
  v[0] = cadd(cadd(x0, s1), s2);
#pragma unroll
  for (int t = 1; t <= 2; ++t) {
    const float ca = t == 1 ? kC51 : kC52, cb = t == 1 ? kC52 : kC51;
    const float sa = t == 1 ? kS51 : kS52, sb = t == 1 ? kS52 : -kS51;
    const float er = (x0.x + ca * s1.x) + cb * s2.x;
    const float ei = (x0.y + ca * s1.y) + cb * s2.y;
    const float fr = sign * (sa * d1.x + sb * d2.x);
    const float fi = sign * (sa * d1.y + sb * d2.y);
    v[t] = make_float2(er - fi, ei + fr);      // y_t = e + i f
    v[5 - t] = make_float2(er + fi, ei - fr);  // y_{5-t} = e - i f
  }
}

// i = 2a + b: radix-4 over a per parity b, then a twiddled radix-2 over b:
// y[c + 4d] = A0[c] + W8^{sign*c} (-1)^d A1[c].  in and out are distinct.
template <bool BWD>
__device__ __forceinline__ void bf8(const float2* in, float2* out) {
  float2 e0 = in[0], e1 = in[2], e2 = in[4], e3 = in[6];
  float2 o0 = in[1], o1 = in[3], o2 = in[5], o3 = in[7];
  bf4<BWD>(e0, e1, e2, e3);
  bf4<BWD>(o0, o1, o2, o3);
  const float2 ev[4] = {e0, e1, e2, e3};
  const float2 od[4] = {o0, o1, o2, o3};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float2 x = c ? cmul_w32<BWD>(od[c], 4 * c) : od[c];
    out[c] = cadd(ev[c], x);
    out[c + 4] = csub(ev[c], x);
  }
}

// i = 4a + b: radix-4 over a per residue b, twiddles W16^{sign*b*c}, then a
// radix-4 over b: y[c + 4d] = R4_d(W^{bc} A_b[c]).
template <bool BWD>
__device__ __forceinline__ void bf16(const float2* in, float2* out) {
  float2 col[4][4];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    float2 a0 = in[b], a1 = in[b + 4], a2 = in[b + 8], a3 = in[b + 12];
    bf4<BWD>(a0, a1, a2, a3);
    col[b][0] = a0; col[b][1] = a1; col[b][2] = a2; col[b][3] = a3;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    float2 y[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      y[b] = (b && c) ? cmul_w32<BWD>(col[b][c], 2 * b * c) : col[b][c];
    }
    bf4<BWD>(y[0], y[1], y[2], y[3]);
#pragma unroll
    for (int d = 0; d < 4; ++d) out[c + 4 * d] = y[d];
  }
}

// i = 4a + b: radix-8 over a per residue b, twiddles W32^{sign*b*c}, then a
// radix-4 over b: y[c + 8d] = R4_d(W32^{bc} A_b[c]).
template <bool BWD>
__device__ __forceinline__ void bf32(const float2* in, float2* out) {
  float2 col[4][8];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    float2 a[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) a[j] = in[b + 4 * j];
    bf8<BWD>(a, col[b]);
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    float2 y[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      y[b] = (b && c) ? cmul_w32<BWD>(col[b][c], b * c) : col[b][c];
    }
    bf4<BWD>(y[0], y[1], y[2], y[3]);
#pragma unroll
    for (int d = 0; d < 4; ++d) out[c + 8 * d] = y[d];
  }
}

// In-place radix-R butterfly on v[0..R).  Every index is a compile-time
// constant after unrolling, so v stays in registers.
template <int R, bool BWD>
__device__ __forceinline__ void butterfly(float2* v) {
  if constexpr (R == 2) {
    const float2 x0 = v[0], x1 = v[1];
    v[0] = cadd(x0, x1);
    v[1] = csub(x0, x1);
  } else if constexpr (R == 3) {
    bf3<BWD>(v);
  } else if constexpr (R == 4) {
    bf4<BWD>(v[0], v[1], v[2], v[3]);
  } else if constexpr (R == 5) {
    bf5<BWD>(v);
  } else {
    float2 in[R];
#pragma unroll
    for (int i = 0; i < R; ++i) in[i] = v[i];
    if constexpr (R == 8) bf8<BWD>(in, v);
    else if constexpr (R == 16) bf16<BWD>(in, v);
    else {
      static_assert(R == 32, "unsupported radix");
      bf32<BWD>(in, v);
    }
  }
}

}  // namespace pf
