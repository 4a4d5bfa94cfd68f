// Polynomial trig and color math of the develop kernel, as __device__
// functions: constant for constant and operation for operation the
// functions of kernels/ktrig.py and core/color.py (which mirror the JAX
// package's kernels/ktrig.py and core/color.py). Constants are written as
// double literals cast to float (RPF_F), so they round exactly as a Python
// float does when it meets a float32 tensor.
#pragma once

#define RPF_F(x) ((float)(x))

namespace rpf {

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// atan(t) for t in [0, 1], Cephes atanf reduction + odd polynomial.
__device__ __forceinline__ float atan_unit(float t) {
  const bool hi = t > RPF_F(0.41421356237309503);
  const float tr = hi ? (t - 1.0f) / (t + 1.0f) : t;
  const float s = tr * tr;
  const float p = ((RPF_F(8.05374449538e-2) * s - RPF_F(1.38776856032e-1)) * s
                   + RPF_F(1.99777106478e-1)) * s - RPF_F(3.33329491539e-1);
  const float r = tr + tr * s * p;
  return hi ? r + RPF_F(0.7853981633974483) : r;
}

// atan2(y, x) / 2pi wrapped into [0, 1).
__device__ __forceinline__ float atan2_turns(float y, float x) {
  const float ax = fabsf(x);
  const float ay = fabsf(y);
  const float hi = fmaxf(ax, ay);
  const float lo = fminf(ax, ay);
  const float t = lo / fmaxf(hi, RPF_F(1e-30));
  float r = atan_unit(t);
  r = ay > ax ? RPF_F(1.5707963267948966) - r : r;
  r = x < 0.0f ? RPF_F(3.14159265359) - r : r;
  r = y < 0.0f ? -r : r;
  const float h = r * RPF_F(1.0 / 6.28318530718);
  return h < 0.0f ? h + 1.0f : h;
}

// (sin, cos) of 2*pi*h for h in [0, 1): k = floor(2h + 1/2), u = h - k/2
// in [-1/4, 1/4], odd/even polynomials, sign (-1)^k.
__device__ __forceinline__ void sincos_turns(float h, float& s_out,
                                             float& c_out) {
  const float k = floorf(2.0f * h + 0.5f);
  const float u = h - 0.5f * k;
  const float sign = 1.0f - 2.0f * (k - 2.0f * floorf(0.5f * k));
  const float z = u * RPF_F(6.28318530718);
  const float z2 = z * z;
  const float sin_p = z * (1.0f + z2 * (RPF_F(-1.6666667163e-1) + z2 * (
      RPF_F(8.3333337680e-3) + z2 * (RPF_F(-1.9841270114e-4) + z2 * (
      RPF_F(2.7557314297e-6) + z2 * RPF_F(-2.5050759689e-8))))));
  const float cos_p = 1.0f + z2 * (-0.5f + z2 * (RPF_F(4.1666667908e-2)
      + z2 * (RPF_F(-1.3888889225e-3) + z2 * (RPF_F(2.4801587642e-5)
      + z2 * (RPF_F(-2.7557314297e-7) + z2 * RPF_F(2.0875723372e-9))))));
  s_out = sign * sin_p;
  c_out = sign * cos_p;
}

// sRGB OETF (wgpu_shader.wgsl:95-103), unclamped, with x^(1/2.4) taken as
// exp2(log2(x) / 2.4) (ktrig.py srgb_oetf): on the H100 the two accurate
// library calls take less time than one exact powf, and torch's exp2 and
// log2 on the card are the same functions, so the twin rounds alike.
__device__ __forceinline__ float srgb_oetf(float c) {
  return c <= RPF_F(0.0031308)
             ? c * RPF_F(12.92)
             : RPF_F(1.055) * exp2f(log2f(fmaxf(c, 0.0f)) * RPF_F(1.0 / 2.4))
                   - RPF_F(0.055);
}

// The OKLab cube root: the exact-LUT anchor's torch.pow, so that an exactly
// gray pixel - whose OKLab a and b are the last-ulp differences of its three
// cube roots, and whose hue the hue-indexed curves read - takes the
// anchor's hue.
__device__ __forceinline__ float cbrt_pow(float x) {
  return powf(fmaxf(x, 0.0f), RPF_F(1.0 / 3.0));
}

// Row-major 3x3 times a planar vector, summed left to right.
#define RPF_MAT3(m00, m01, m02, m10, m11, m12, m20, m21, m22, a, b, c, x, y, z) \
  do {                                                                          \
    x = RPF_F(m00) * (a) + RPF_F(m01) * (b) + RPF_F(m02) * (c);                 \
    y = RPF_F(m10) * (a) + RPF_F(m11) * (b) + RPF_F(m12) * (c);                 \
    z = RPF_F(m20) * (a) + RPF_F(m21) * (b) + RPF_F(m22) * (c);                 \
  } while (0)

// Linear sRGB -> (L, C, h in turns) (wgpu_shader.wgsl:64-75).
__device__ __forceinline__ void linear_srgb_to_oklch(float r, float g, float b,
                                                     float& L, float& C,
                                                     float& H) {
  float l_, m_, s_;
  RPF_MAT3(0.4122214708, 0.5363325363, 0.0514459929,
           0.2119034982, 0.6806995451, 0.1073969566,
           0.0883024619, 0.2817188376, 0.6299787005, r, g, b, l_, m_, s_);
  l_ = cbrt_pow(l_);
  m_ = cbrt_pow(m_);
  s_ = cbrt_pow(s_);
  float A, B;
  RPF_MAT3(0.2104542553, 0.7936177850, -0.0040720468,
           1.9779984951, -2.4285922050, 0.4505937099,
           0.0259040371, 0.7827717662, -0.8086757660, l_, m_, s_, L, A, B);
  C = sqrtf(A * A + B * B);
  H = atan2_turns(B, A);
}

// (L, C, h in turns) -> linear sRGB (wgpu_shader.wgsl:77-84).
__device__ __forceinline__ void oklch_to_linear_srgb(float L, float C, float H,
                                                     float& r, float& g,
                                                     float& b) {
  float sin_h, cos_h;
  sincos_turns(H, sin_h, cos_h);
  const float A = C * cos_h;
  const float B = C * sin_h;
  float l_, m_, s_;
  RPF_MAT3(1.0, 0.3963377774, 0.2158037573,
           1.0, -0.1055613458, -0.0638541728,
           1.0, -0.0894841775, -1.2914855480, L, A, B, l_, m_, s_);
  l_ = l_ * l_ * l_;
  m_ = m_ * m_ * m_;
  s_ = s_ * s_ * s_;
  RPF_MAT3(4.0767416621, -3.3077115913, 0.2309699292,
           -1.2684380046, 2.6097574011, -0.3413193965,
           -0.0041960863, -0.7034186147, 1.7076147010, l_, m_, s_, r, g, b);
}

}  // namespace rpf
