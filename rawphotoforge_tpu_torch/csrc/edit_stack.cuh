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

// Views into the kernel's table as staged in shared memory (see develop.cu
// for the layout; stage_table moves the coefficients to a 16-byte boundary).
struct EditTables {
  const float* slots;   // [M]       default-slot bits, as floats
  const float* gains;   // [M*3]     WB gains
  const float* tone;    // [M*6]     exposure EV, contrast, shadow, highlight, black, white
  const float* chan;    // [M]       brightness-curve channel 0/1/2, 3 = all
  const float* knots;   // [M*4*S]   sorted knots, padded with 2*65536
  const float4* coeffs; // [M*4*S]   per-segment monomial coefficients (a, b, c, d)
  int M, S;
};

__host__ __device__ __forceinline__ int table_floats(int M, int S) {
  return 11 * M + 20 * M * S;
}

// Shared-memory floats of a kernel table of `head` floats before the edit
// tables, as stage_table lays it out, and where its coefficients start.
__host__ __device__ __forceinline__ int staged_coeffs(int head, int M, int S) {
  return (head + 11 * M + 4 * M * S + 3) & ~3;
}

__host__ __device__ __forceinline__ int staged_floats(int head, int M, int S) {
  return staged_coeffs(head, M, S) + 16 * M * S;
}

// Copies the kernel table (head floats, then the edit tables) into shared
// memory `sh` (16-byte aligned), the coefficient block moved up to a 16-byte
// boundary so that a segment's four coefficients are one vector read. The
// caller synchronizes before reading it.
__device__ __forceinline__ EditTables stage_table(float* sh,
                                                  const float* __restrict__ table,
                                                  int head, int M, int S,
                                                  int tid, int nthreads) {
  const int tail = head + 11 * M + 4 * M * S;
  const int pad = staged_coeffs(head, M, S) - tail;
  const int n = tail + 16 * M * S;
  for (int i = tid; i < n; i += nthreads) sh[i < tail ? i : i + pad] = table[i];
  EditTables t;
  t.slots = sh + head;
  t.gains = t.slots + M;
  t.tone = t.gains + 3 * M;
  t.chan = t.tone + 6 * M;
  t.knots = t.chan + M;
  t.coeffs = reinterpret_cast<const float4*>(sh + staged_coeffs(head, M, S));
  t.M = M;
  t.S = S;
  return t;
}

// Selected packed-PCHIP evaluation: the active segment's own coefficients
// (no telescoped deltas), then Horner. The active segment is the last j with
// u >= kn[j]; the knots are sorted and padded with 2*65536, and S is a power
// of two, so a branch-free binary search over the row (log2 S compares)
// finds the segment the twin's select chain picks, and the result is the
// same bit for bit. The search keeps the chosen knot, so only the
// coefficients are read after it.
__device__ __forceinline__ float eval_curve(float u, const float* kn,
                                            const float4* co, int S) {
  float x0 = kn[0];
  u = fmaxf(u, x0);
  int j = 0;
  for (int step = S >> 1; step > 0; step >>= 1) {
    const float k = kn[j + step];
    const bool take = u >= k;
    j = take ? j + step : j;
    x0 = take ? k : x0;
  }
  const float4 c = co[j];
  const float dt = u - x0;
  return c.x + dt * (c.y + dt * (c.z + dt * c.w));
}

// y / d as the product with the rounded reciprocal and one residual
// correction: three operations in place of a correctly rounded division.
// Not equal to the IEEE quotient for every y and d (for the vignette's
// d = 0.75 it is not), but equal for d = 65535 and 32767.5 on every whole
// y in [0, 65535], the curves' outputs (held exhaustively against the
// twin's division by chip_smoke.py phase 2a).
__device__ __forceinline__ float div_const(float y, float d, float rcp) {
  const float q = y * rcp;
  const float r = __fmaf_rn(-q, d, y);
  return __fmaf_rn(r, rcp, q);
}

__device__ __forceinline__ float div_65535(float y) {
  return div_const(y, kLutMax, RPF_F(1.0f / 65535.0f));
}

__device__ __forceinline__ float div_32767_5(float y) {
  return div_const(y, 32767.5f, RPF_F(1.0f / 32767.5f));
}

// LUT semantics: index floor(v*65535) clamped to [0, 65535] BEFORE the
// evaluation, result truncated and clamped like the i32 table, rescaled.
template <bool GAIN>
__device__ __forceinline__ float quantized_curve(float v, const float* kn,
                                                 const float4* co, int S) {
  const float u = clampf(floorf(v * kLutMax), 0.0f, kLutMax);
  const float y = clampf(floorf(eval_curve(u, kn, co, S)), 0.0f, 65535.0f);
  return GAIN ? div_32767_5(y) : div_65535(y);
}

// What a default brightness/hue curve evaluates to: the floor staircase.
__device__ __forceinline__ float staircase(float v) {
  return div_65535(clampf(floorf(v * kLutMax), 0.0f, kLutMax));
}

// Vignette on global pixel coordinates (wgpu_shader.wgsl:166-178), split so
// that each row and each column computes its part once: vignette_axis is
// ((c / extent - 0.5) * 1.5)^2 for a row (ys, true height) or a column (xs,
// true width), with the arithmetic of the twin's broadcast [H,1] and [1,W].
__device__ __forceinline__ float vignette_strength(float value) {
  return (-value / 100.0f) * 2.0f;
}

__device__ __forceinline__ float vignette_axis(float c, float extent) {
  const float v = (c / extent - 0.5f) * 1.5f;
  return v * v;
}

__device__ __forceinline__ void vignette(float& r, float& g, float& b,
                                         float strength, float ax_y,
                                         float ax_x) {
  if (strength == 0.0f) return;
  const float dist = sqrtf(ax_x + ax_y);
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
  const float4* co = t.coeffs + (4 * k) * t.S;
  if (ch == 0.0f || ch == 3.0f)
    r = def ? staircase(r) : quantized_curve<false>(r, kn, co, t.S);
  if (ch == 1.0f || ch == 3.0f)
    g = def ? staircase(g) : quantized_curve<false>(g, kn, co, t.S);
  if (ch == 2.0f || ch == 3.0f)
    b = def ? staircase(b) : quantized_curve<false>(b, kn, co, t.S);
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
      const float4* co = t.coeffs + (4 * k) * t.S;
      const int seg = t.S;
      const float new_h = (bits & kSlotHue)
          ? staircase(H) : quantized_curve<false>(H, kn + seg, co + seg, seg);
      const float sat_g = (bits & kSlotSat)
          ? default_gain
          : quantized_curve<true>(H, kn + 2 * seg, co + 2 * seg, seg);
      const float light_g = (bits & kSlotLight)
          ? default_gain
          : quantized_curve<true>(H, kn + 3 * seg, co + 3 * seg, seg);
      H = new_h;
      C = C * sat_g;
      L = L * light_g;
    }
    oklch_to_linear_srgb(L, C, H, r, g, b);
  }
  r = clampf(srgb_oetf(r), 0.0f, 1.0f);
  g = clampf(srgb_oetf(g), 0.0f, 1.0f);
  b = clampf(srgb_oetf(b), 0.0f, 1.0f);
}

}  // namespace rpf
