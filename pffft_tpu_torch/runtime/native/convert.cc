// Sample-format converters: the host pass between an SDR's byte stream and
// the planar float32 the device consumes (widen, scale, deinterleave in one
// loop, where numpy takes a chain of temporaries).
//
// The port's own copy of the JAX package's converters, with the symbols
// prefixed pftt_.  The scales are the original library's (its CIC takes
// s16 by 1/32768 and offset-binary u8 as (x - 127.4) / 128).  Built without
// -ffast-math: each result rounds exactly as the numpy arms of
// runtime/__init__.py do.

#include <cstdint>

extern "C" {

// s16 real -> f32, scaled by 1/32768.
void pftt_convert_s16_f32(const int16_t* in, float* out, uint64_t n) {
  const float k = 1.0f / 32768.0f;
  for (uint64_t i = 0; i < n; ++i) out[i] = (float)in[i] * k;
}

// s16 interleaved IQ -> planar (re, im) f32, scaled by 1/32768.
void pftt_convert_cs16_planar_f32(const int16_t* in, float* re, float* im,
                                  uint64_t n_cplx) {
  const float k = 1.0f / 32768.0f;
  for (uint64_t i = 0; i < n_cplx; ++i) {
    re[i] = (float)in[2 * i] * k;
    im[i] = (float)in[2 * i + 1] * k;
  }
}

// u8 offset-binary interleaved IQ -> planar f32, (x - 127.4) / 128.
void pftt_convert_cu8_planar_f32(const uint8_t* in, float* re, float* im,
                                 uint64_t n_cplx) {
  const float mid = 127.4f;
  const float k = 1.0f / 128.0f;
  for (uint64_t i = 0; i < n_cplx; ++i) {
    re[i] = ((float)in[2 * i] - mid) * k;
    im[i] = ((float)in[2 * i + 1] - mid) * k;
  }
}

// planar f32 -> s16 interleaved IQ, scaled by 32767, saturating.
void pftt_convert_planar_f32_cs16(const float* re, const float* im,
                                  int16_t* out, uint64_t n_cplx) {
  for (uint64_t i = 0; i < n_cplx; ++i) {
    float a = re[i] * 32767.0f;
    float b = im[i] * 32767.0f;
    if (a > 32767.0f) a = 32767.0f;
    if (a < -32768.0f) a = -32768.0f;
    if (b > 32767.0f) b = 32767.0f;
    if (b < -32768.0f) b = -32768.0f;
    out[2 * i] = (int16_t)a;
    out[2 * i + 1] = (int16_t)b;
  }
}

}  // extern "C"
