// The per-pixel edit stack of the develop kernel, as __device__ functions:
// vignette, then per mask (WB -> tone -> brightness curve), then per mask in
// OKLCH (hue remap, sat/light gains read from the hue), then the sRGB
// encode (wgpu_shader.wgsl:166-336). The same math as the plain twin
// (kernels/fused.py edit_stack) and the JAX package's Pallas edit_stack;
// one home for the develop kernel here and the one-pass RAW kernel of a
// later slice, which differ only in how a mask row is read (the Sel
// functor).
#pragma once

#include "ktrig.cuh"

namespace rpf {

constexpr float kLutMax = 65535.0f;

// Per-mask default-slot bits (the shortcut table).
constexpr int kSlotBright = 1, kSlotHue = 2, kSlotSat = 4, kSlotLight = 8;

// Views into the kernel's table (see develop.cu for the layout).
struct EditTables {
  const float* slots;   // [M]       default-slot bits, as floats
  const float* gains;   // [M*3]     WB gains
  const float* tone;    // [M*6]     exposure EV, contrast, shadow, highlight, black, white
  const float* chan;    // [M]       brightness-curve channel 0/1/2, 3 = all
  const float* knots;   // [M*4*S]   sorted knots, padded with 2*65536
  const float* coeffs;  // [M*4*S*4] per-segment monomial coefficients
  int M, S;
};

__device__ __forceinline__ EditTables edit_tables(const float* base, int M,
                                                  int S) {
  EditTables t;
  t.slots = base;
  t.gains = t.slots + M;
  t.tone = t.gains + 3 * M;
  t.chan = t.tone + 6 * M;
  t.knots = t.chan + M;
  t.coeffs = t.knots + 4 * M * S;
  t.M = M;
  t.S = S;
  return t;
}

__host__ __device__ __forceinline__ int table_floats(int M, int S) {
  return 11 * M + 20 * M * S;
}

// Selected packed-PCHIP evaluation: the active segment's own coefficients
// (no telescoped deltas), then Horner.
__device__ __forceinline__ float eval_curve(float u, const float* kn,
                                            const float* co, int S) {
  u = fmaxf(u, kn[0]);
  float a = co[0], b = co[1], c = co[2], d = co[3], x0 = kn[0];
  for (int j = 1; j < S; ++j) {
    if (u >= kn[j]) {
      a = co[4 * j + 0];
      b = co[4 * j + 1];
      c = co[4 * j + 2];
      d = co[4 * j + 3];
      x0 = kn[j];
    }
  }
  const float dt = u - x0;
  return a + dt * (b + dt * (c + dt * d));
}

// LUT semantics: index floor(v*65535) clamped to [0, 65535] BEFORE the
// evaluation, result truncated and clamped like the i32 table, rescaled.
__device__ __forceinline__ float quantized_curve(float v, const float* kn,
                                                 const float* co, int S,
                                                 float denom) {
  const float u = clampf(floorf(v * kLutMax), 0.0f, kLutMax);
  const float y = clampf(floorf(eval_curve(u, kn, co, S)), 0.0f, 65535.0f);
  return y / denom;
}

// What a default brightness/hue curve evaluates to: the floor staircase.
__device__ __forceinline__ float staircase(float v) {
  return clampf(floorf(v * kLutMax), 0.0f, kLutMax) / kLutMax;
}

// Vignette on global pixel coordinates (wgpu_shader.wgsl:166-178).
__device__ __forceinline__ void vignette(float& r, float& g, float& b,
                                         float value, float hf, float wf,
                                         float ys, float xs) {
  const float strength = (-value / 100.0f) * 2.0f;
  if (strength == 0.0f) return;
  const float cy = (ys / hf - 0.5f) * 1.5f;
  const float cx = (xs / wf - 0.5f) * 1.5f;
  const float dist = sqrtf(cx * cx + cy * cy);
  const float t = clampf((dist - 0.25f) / 0.75f, 0.0f, 1.0f);
  const float falloff = t * sqrtf(t);
  const float gain = clampf(1.0f - strength * falloff, 0.0f, 4.0f);
  r *= gain;
  g *= gain;
  b *= gain;
}

// Exposure / shadow / highlight / black / white / contrast + clamp
// (wgpu_shader.wgsl:200-259).
__device__ __forceinline__ void tone(float& r, float& g, float& b,
                                     const float* tv) {
  const float mul = exp2f(tv[0]);
  r *= mul;
  g *= mul;
  b *= mul;
  const float y = RPF_F(0.2126) * r + RPF_F(0.7152) * g + RPF_F(0.0722) * b;
  const float shadow_gain = 1.0f + tv[2] * clampf(1.0f - y, 0.0f, 1.0f);
  r *= shadow_gain;
  g *= shadow_gain;
  b *= shadow_gain;
  const float highlight_gain = 1.0f + tv[3] * clampf(y, 0.0f, 1.0f);
  r *= highlight_gain;
  g *= highlight_gain;
  b *= highlight_gain;
  const float t = clampf(y, 0.0f, 1.0f);
  if (tv[4] != 0.0f) {
    const float lift = tv[4] * ((1.0f - t) * (1.0f - t));
    r += lift;
    g += lift;
    b += lift;
  }
  if (tv[5] != 0.0f) {
    const float lift = tv[5] * (t * t);
    r += lift;
    g += lift;
    b += lift;
  }
  if (tv[1] != 0.0f) {
    const float c = 1.0f + tv[1];
    r = (r - 0.5f) * c + 0.5f;
    g = (g - 0.5f) * c + 0.5f;
    b = (b - 0.5f) * c + 0.5f;
  }
  r = clampf(r, 0.0f, 1.0f);
  g = clampf(g, 0.0f, 1.0f);
  b = clampf(b, 0.0f, 1.0f);
}

// Mask k's WB -> tone -> brightness curve, with the channel selector.
__device__ __forceinline__ void bright_chain(float& r, float& g, float& b,
                                             const EditTables& t, int k) {
  r *= t.gains[3 * k + 0];
  g *= t.gains[3 * k + 1];
  b *= t.gains[3 * k + 2];
  tone(r, g, b, t.tone + 6 * k);
  const float ch = t.chan[k];
  const bool def = (static_cast<int>(t.slots[k]) & kSlotBright) != 0;
  const float* kn = t.knots + (4 * k) * t.S;
  const float* co = t.coeffs + (4 * k) * t.S * 4;
  if (ch == 0.0f || ch == 3.0f)
    r = def ? staircase(r) : quantized_curve(r, kn, co, t.S, kLutMax);
  if (ch == 1.0f || ch == 3.0f)
    g = def ? staircase(g) : quantized_curve(g, kn, co, t.S, kLutMax);
  if (ch == 2.0f || ch == 3.0f)
    b = def ? staircase(b) : quantized_curve(b, kn, co, t.S, kLutMax);
}

// The edit stack after the vignette. sel(k) is true where mask k applies.
// IDENTITY skips the OKLCH round trip (valid only with default hue/sat/
// light curves on every mask; <= 3e-3 from the full path).
template <bool IDENTITY, typename Sel>
__device__ __forceinline__ void edit_stack(float& r, float& g, float& b,
                                           const EditTables& t, Sel sel) {
  for (int k = 0; k < t.M; ++k) {
    if (sel(k)) bright_chain(r, g, b, t, k);
  }
  if (!IDENTITY) {
    float L, C, H;
    linear_srgb_to_oklch(r, g, b, L, C, H);
    // Exactly what a default sat/light curve evaluates to.
    const float default_gain = 32767.0f / 32767.5f;
    for (int k = 0; k < t.M; ++k) {
      if (!sel(k)) continue;
      const int bits = static_cast<int>(t.slots[k]);
      const float* kn = t.knots + (4 * k) * t.S;
      const float* co = t.coeffs + (4 * k) * t.S * 4;
      const int seg = t.S;
      const float new_h = (bits & kSlotHue)
          ? staircase(H) : quantized_curve(H, kn + seg, co + 4 * seg, seg, kLutMax);
      const float sat_g = (bits & kSlotSat)
          ? default_gain
          : quantized_curve(H, kn + 2 * seg, co + 8 * seg, seg, 32767.5f);
      const float light_g = (bits & kSlotLight)
          ? default_gain
          : quantized_curve(H, kn + 3 * seg, co + 12 * seg, seg, 32767.5f);
      H = new_h;
      C = C * sat_g;
      L = L * light_g;
    }
    oklch_to_linear_srgb(L, C, H, r, g, b);
  }
  r = clampf(linear_to_srgb(r), 0.0f, 1.0f);
  g = clampf(linear_to_srgb(g), 0.0f, 1.0f);
  b = clampf(linear_to_srgb(b), 0.0f, 1.0f);
}

}  // namespace rpf
