// The one-pass RAW develop kernel for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel kernels/raw_pipeline.py:_raw_kernel
// (pallas_call at raw_pipeline.py:485): in one pass, a normalized CFA mosaic
// -> per-site white balance -> demosaic (Malvar-He-Cutler for Bayer, the
// directional-green residual normalized convolution for X-Trans) -> 3x3
// camera matrix clipped to [0, 1] -> radius-2 unsharp mask -> vignette -> the
// per-mask edit stack (edit_stack.cuh) -> sRGB, f32 [3, H, W].
//
// Bound: bytes on paper (4 B/px of mosaic in, 12 B/px out: 16 B/px, ~0.115 ms
// for 24 MP at 3.35 TB/s), but the exact arithmetic of the demosaic, the
// unsharp and the edit stack sets the time, as in develop.cu: the design
// spends as few operations and shared-memory accesses per output as the
// exact result allows.
//
// Borders follow the Pallas wrapper: Bayer reads mirror indices (numpy
// "reflect", -1 -> 1; WB is applied before the pad, so a mirrored site
// carries its source site's gain); X-Trans reads the phase-preserving
// periodic border (rows -12..-1 are rows 0..11, rows H..H+11 are rows
// H-12..H-1). CFA phases are global (y mod 2 or 6), so no tile size shows in
// the output. Every sum runs in the Pallas kernel's order (Malvar's
// neighbour sums as the twin's, the unsharp's vertical taps before its
// horizontal ones, conv7y before conv7x, taps left to right from 0) and the
// build uses exact division and no multiply-add contraction, so the kernel
// equals its plain torch twin (kernels/raw_pipeline.py raw_develop_fused_ref)
// bit for bit.
//
// Both CFAs walk strips: a block walks down a column strip in steps,
// keeping the rows of the window and of the demosaiced planes that the next
// step shares, so the vertical halo is paid once per band of steps rather
// than once per tile. The grid is one wave of resident blocks, so the table
// is staged once per resident block.
//
// Bayer: strips of 124 output columns, steps of 16 rows; the steps of all
// strips, in strip-major order, are split evenly over the wave (a block's
// share may cross into the next strip, where a new band starts), so every
// block does the same work. The strip's planes are 128 columns wide (the
// outputs and the 2-px sharpen margin): a warp covers one plane row, 4
// columns a lane, and a site's CFA phase is the row's parity and the lane's
// element index, so each warp takes one branch of Malvar per element. The
// window (24 rows x 132 columns) and the three clipped planes (20 rows) are
// rings in shared memory: a step loads 16 new window rows and computes 16
// new plane rows. The window loads in groups of 4 columns: one 16-byte load
// for a group inside the image (W % 4 == 0, the mosaic aligned), 4 loads at
// mirror indices for a group over its border. The unsharp is separable as
// the twin's _blur5: each lane sums the 5 rows of its 4 columns once
// (16-byte reads), takes the next lane's 4 sums by a warp shuffle, and sums
// the 5 columns of each of its 4 outputs. A lane then runs the vignette and
// the edit stack on its 4 outputs and stores them as float4 (a scalar
// ragged edge); lane 31's outputs belong to the next strip. What bounds it
// on the card: the exact per-pixel arithmetic (the edit stack, then the
// unsharp, Malvar and the vignette) more than the 16 bytes a pixel moves.
//
// X-Trans: a block owns a strip 48 columns wide (a multiple of 6, as are
// its rows, so a window site's CFA phase is its window coordinates mod 6,
// the same in every block; a u8 plane holds each site's phase and channel,
// computed once) and walks down a band of it in steps of 24 rows. A step
// keeps the rows of the window (24), the green estimate (10) and the
// demosaiced planes (4) that the next step shares. The vignette's row and
// column terms are computed once per row and per column into shared memory.
//
// Table layout (floats): [vignette, true_h, true_w, sharpen] [cam2srgb 9]
// [wb gains 3] [gauss taps 5] [slot bits M] [gains 3M] [tone 6M] [channel M]
// [knots 4MS] [coeffs 16MS].

#include <cstdint>
#include <cuda_runtime.h>

#include "edit_stack.cuh"
#include "vec4.cuh"
#include "wave.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHead = 21;

// Bayer: strips of BSW output columns (plane columns BSW + 4 = one warp x 4),
// steps of BSH rows (16 ties with 8, beats 32: chip_smoke.py --bayer-ab); 4-px halo
// (2 demosaic + 2 sharpen). The window ring holds the BSH + 8 rows a band's
// first step needs, the plane rings the BSH + 4 rows a step's unsharp reads.
constexpr int BSW = 124, BSH = 16, BHALO = 4;
constexpr int BP_W = BSW + 4;
constexpr int BWIN_W = BSW + 2 * BHALO;
constexpr int BWIN_R = BSH + 2 * BHALO;
constexpr int BP_R = BSH + 4;
constexpr int BSMEM_FLOATS = BWIN_R * BWIN_W + 3 * BP_R * BP_W;
static_assert(BP_W == 32 * 4, "a warp covers one plane row, 4 columns a lane");
static_assert(BSW % 4 == 0, "strips start on 16-byte and even columns");

// X-Trans: strips XW columns wide, steps of XH rows (a multiple of 6 and
// >= the 24 window rows a step keeps); 12-px halo. Window
// coordinates as in the Pallas kernel: the conv/mask extent at offset 4,
// the green estimate E1 at offset 7, the demosaic output E0 at offset 10.
constexpr int XW = 48, XH = 24, XHALO = 12;
constexpr int XWIN_W = XW + 2 * XHALO;
constexpr int XS_W = XW + 16;   // mask / gradient extent
constexpr int XE1_W = XW + 10;  // g_est extent
constexpr int XE0_W = XW + 4;   // demosaic output extent

// The X-Trans 6x6 pattern (rawphotoforge_tpu_torch/ops/demosaic.XTRANS).
__constant__ unsigned char kXTrans[6][6] = {
    {1, 1, 0, 1, 1, 2}, {1, 1, 2, 1, 1, 0}, {2, 0, 1, 0, 2, 1},
    {1, 1, 2, 1, 1, 0}, {1, 1, 0, 1, 1, 2}, {0, 2, 1, 2, 0, 1}};

// Triangle taps of the normalized convolutions (raw_pipeline._NC_TAPS).
__constant__ float kNC[7] = {1.0f, 2.0f, 3.0f, 4.0f, 3.0f, 2.0f, 1.0f};

// numpy "reflect" index of i on an axis of length n (period 2(n-1)).
__device__ __forceinline__ int reflect_idx(int i, int n) {
  if (n == 1) return 0;
  const int p = 2 * (n - 1);
  i %= p;
  if (i < 0) i += p;
  return i < n ? i : p - i;
}

// The X-Trans border: continue each edge with its own 12 rows (phase kept).
// Sites past the pad only feed outputs past the image; they read in bounds.
__device__ __forceinline__ int periodic_idx(int i, int n) {
  if (i < 0) i += XHALO;
  else if (i >= n) i -= XHALO;
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// Bayer channel of global site (y, x); pattern = 4 channel ids, row-major.
__device__ __forceinline__ int bayer_chan(int pattern, int y, int x) {
  const int k = ((y & 1) << 1) | (x & 1);
  return (pattern >> (2 * k)) & 3;
}

// Camera matrix then clip to [0, 1] (jnp.clip: min(max(x, 0), 1)).
__device__ __forceinline__ void cam_clip(const float* cam, float r, float g,
                                         float b, float& cr, float& cg,
                                         float& cb) {
  cr = rpf::clampf(cam[0] * r + cam[1] * g + cam[2] * b, 0.0f, 1.0f);
  cg = rpf::clampf(cam[3] * r + cam[4] * g + cam[5] * b, 0.0f, 1.0f);
  cb = rpf::clampf(cam[6] * r + cam[7] * g + cam[8] * b, 0.0f, 1.0f);
}

// Separable radius-2 Gaussian at (a, b) of the output tile over an E0 plane
// of row stride ew (the output sits at E0 (a+2, b+2)): rows first, then
// columns, each sum left to right.
__device__ __forceinline__ float blur5(const float* x, int ew, int a, int b,
                                       const float* t) {
  float acc = 0.0f;
  for (int j = 0; j < 5; ++j) {
    float row = t[0] * x[a * ew + b + j];
    for (int k = 1; k < 5; ++k) row = row + t[k] * x[(a + k) * ew + b + j];
    acc = j == 0 ? t[0] * row : acc + t[j] * row;
  }
  return acc;
}

// The vignette's row terms of rows y0 .. y0+n-1 and column terms of columns
// x0 .. x0+n-1 (threads tid < n each compute one).
__device__ __forceinline__ void vignette_axes(const float* tab, float* vy,
                                              int y0, int ny, float* vx,
                                              int x0, int nx, int H, int W) {
  const float hf = tab[1] > 0.0f ? tab[1] : static_cast<float>(H);
  const float wf = tab[2] > 0.0f ? tab[2] : static_cast<float>(W);
  const int tid = threadIdx.x;
  if (vy != nullptr && tid < ny)
    vy[tid] = rpf::vignette_axis(static_cast<float>(y0 + tid), hf);
  if (vx != nullptr && tid < nx)
    vx[tid] = rpf::vignette_axis(static_cast<float>(x0 + tid), wf);
}

// The X-Trans kernel's per-pixel tail: unsharp on the clipped planes,
// vignette, the edit stack, the store.
template <bool IDENTITY>
__device__ __forceinline__ void tail(const float* tab, const rpf::EditTables& t,
                                     const float* pr, const float* pg,
                                     const float* pb, int ew, int a, int b,
                                     int y, int x, int H, int W, float ay,
                                     float ax, const uint8_t* __restrict__ masks,
                                     float* __restrict__ out) {
  const float amt = tab[3];
  const float* taps = tab + 16;
  const int e = (a + 2) * ew + (b + 2);
  float r = pr[e], g = pg[e], bl = pb[e];
  if (amt != 0.0f) {
    r = fmaxf(r + amt * (r - blur5(pr, ew, a, b, taps)), 0.0f);
    g = fmaxf(g + amt * (g - blur5(pg, ew, a, b, taps)), 0.0f);
    bl = fmaxf(bl + amt * (bl - blur5(pb, ew, a, b, taps)), 0.0f);
  }
  rpf::vignette(r, g, bl, rpf::vignette_strength(tab[0]), ay, ax);
  const int64_t hw = static_cast<int64_t>(H) * W;
  const int64_t i = static_cast<int64_t>(y) * W + x;
  // Row 0 is the all-ones main mask (never read); masks holds rows 1..M-1.
  auto sel = [&](int k) -> bool {
    return k == 0 || masks[(k - 1) * hw + i] != 0;
  };
  rpf::edit_stack<IDENTITY>(r, g, bl, t, sel);
  out[i] = r;
  out[hw + i] = g;
  out[2 * hw + i] = bl;
}

__device__ __forceinline__ float4 operator*(float s, const float4& v) {
  return make_float4(s * v.x, s * v.y, s * v.z, s * v.w);
}

__device__ __forceinline__ float4 operator+(const float4& a, const float4& b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 shfl_down1(const float4& v) {
  return make_float4(__shfl_down_sync(0xffffffffu, v.x, 1),
                     __shfl_down_sync(0xffffffffu, v.y, 1),
                     __shfl_down_sync(0xffffffffu, v.z, 1),
                     __shfl_down_sync(0xffffffffu, v.w, 1));
}

// One clipped plane at a lane's 4 outputs of an output row whose plane rows
// y-2 .. y+2 start at rows[0..4] (each at the lane's column 4*lane): the
// centre values and, where amt != 0, the unsharp result. The vertical sums
// of the lane's 4 plane columns, then the next lane's 4 by a shuffle, then
// the horizontal 5-tap of each output: _blur5's order.
__device__ __forceinline__ float4 unsharp4(const float* const* rows,
                                           const float* t, float amt) {
  const float4 mid = *reinterpret_cast<const float4*>(rows[2]);
  const float4 nmid = shfl_down1(mid);
  float4 c = make_float4(mid.z, mid.w, nmid.x, nmid.y);
  if (amt == 0.0f) return c;
  float4 v = t[0] * *reinterpret_cast<const float4*>(rows[0]);
#pragma unroll
  for (int k = 1; k < 5; ++k)
    v = v + t[k] * (k == 2 ? mid : *reinterpret_cast<const float4*>(rows[k]));
  const float4 vn = shfl_down1(v);
  const float s[8] = {v.x, v.y, v.z, v.w, vn.x, vn.y, vn.z, vn.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float acc = t[0] * s[j];
#pragma unroll
    for (int i = 1; i < 5; ++i) acc = acc + t[i] * s[j + i];
    const float x = rpf::pick(c, j);
    rpf::put(c, j, fmaxf(x + amt * (x - acc), 0.0f));
  }
  return c;
}

template <bool IDENTITY>
__global__ void __launch_bounds__(kThreads)
bayer_kernel(const float* __restrict__ mosaic, const uint8_t* __restrict__ masks,
             const float* __restrict__ table, int tab_stride,
             float* __restrict__ out, int M, int S, int H, int W, int pattern,
             int r_in_row0, int vec) {
  extern __shared__ __align__(16) float sh[];
  float* tab = sh;
  float* win = sh + tab_stride;           // [BWIN_R][BWIN_W] ring
  float* pl = win + BWIN_R * BWIN_W;      // [3][BP_R][BP_W] rings
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const rpf::EditTables t =
      rpf::stage_table(tab, table, kHead, M, S, tid, kThreads);
  __syncthreads();
  const float* cam = tab + 4;
  const float* wb = tab + 13;
  const float* taps = tab + 16;
  const float amt = tab[3];
  const float strength = rpf::vignette_strength(tab[0]);
  const float hf = tab[1] > 0.0f ? tab[1] : static_cast<float>(H);
  const float wf = tab[2] > 0.0f ? tab[2] : static_cast<float>(W);
  const int64_t hw = static_cast<int64_t>(H) * W;
  const int c4 = 4 * lane;
  // The steps of all strips in strip-major order, split evenly over the
  // grid: a block walks its share, which may cross into the next strip.
  const int rows = (H + BSH - 1) / BSH;
  const int total = (W + BSW - 1) / BSW * rows;
  const int first = static_cast<int>(int64_t{blockIdx.x} * total / gridDim.x);
  const int last = static_cast<int>(int64_t{blockIdx.x + 1} * total / gridDim.x);
  int x0 = 0, band0 = 0, n = 0;
  bool full = false;
  constexpr int G = BWIN_W / 4;  // 16-byte groups of a window row
  float4 ax;
  // Ring rows of global row y: the window's from band0 - 4, the planes'
  // from band0 - 2.
  auto wrow = [&](int y) { return win + ((y - band0 + BHALO) % BWIN_R) * BWIN_W; };
  auto prow = [&](int y) { return pl + ((y - band0 + 2) % BP_R) * BP_W; };

  for (int it = first; it < last; ++it) {
    const int y0 = it % rows * BSH;
    // A band starts at the block's first step and at each strip's top.
    const bool start = it == first || y0 == 0;
    if (start) {
      x0 = it / rows * BSW;
      band0 = y0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        rpf::put(ax, j, rpf::vignette_axis(static_cast<float>(x0 + c4 + j), wf));
      // Lane 31's columns are the next strip's first.
      n = lane < 31 ? min(4, W - (x0 + c4)) : 0;
      full = vec && n == 4;
    }
    // New window rows (all BSH + 8 at a band's start), WB at the load, in
    // groups of 4 columns: a group inside the image is one 16-byte load
    // where vec allows, a group over its border 4 loads at mirror indices.
    // Columns past W + 3 and rows past H + 3 feed no output: not loaded.
    // Their ring rows were last read by the previous step's Malvar, so
    // this runs while other warps finish the previous tail.
    const int wy0 = start ? y0 - BHALO : y0 + BHALO;
    const int wn = start ? BWIN_R : BSH;
    for (int i = tid; i < wn * G; i += kThreads) {
      const int y = wy0 + i / G, x = x0 - BHALO + 4 * (i % G);
      if (y >= H + BHALO || x >= W + BHALO) continue;
      const int sy = y >= 0 && y < H ? y : reflect_idx(y, H);
      const float* src = mosaic + static_cast<int64_t>(sy) * W;
      float4 v;
      if (vec && x >= 0 && x + 4 <= W) {
        v = *reinterpret_cast<const float4*>(src + x);
        const float g0 = wb[bayer_chan(pattern, sy, 0)];  // x is even
        const float g1 = wb[bayer_chan(pattern, sy, 1)];
        v = make_float4(v.x * g0, v.y * g1, v.z * g0, v.w * g1);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int sx = x + e >= 0 && x + e < W ? x + e : reflect_idx(x + e, W);
          rpf::put(v, e, src[sx] * wb[bayer_chan(pattern, sy, sx)]);
        }
      }
      *reinterpret_cast<float4*>(wrow(y) + (x - x0 + BHALO)) = v;
    }
    __syncthreads();

    // Malvar-He-Cutler and the clipped camera matrix over the new plane
    // rows (all BSH + 4 at a band's start), a warp to a row. Site
    // (y, x0 - 2 + c4 + j) has the parity of (y, j), the same in every
    // lane, so each warp takes one branch per element.
    const int py0 = start ? y0 - 2 : y0 + 2;
    const int pn = start ? BP_R : BSH;
    for (int r = warp; r < pn; r += kWarps) {
      const int y = py0 + r;
      float m[5][8];
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        const float* p = wrow(y - 2 + k) + c4;
        const float4 lo = *reinterpret_cast<const float4*>(p);
        const float4 hi = *reinterpret_cast<const float4*>(p + 4);
        m[k][0] = lo.x; m[k][1] = lo.y; m[k][2] = lo.z; m[k][3] = lo.w;
        m[k][4] = hi.x; m[k][5] = hi.y; m[k][6] = hi.z; m[k][7] = hi.w;
      }
      const bool row_has_r = r_in_row0 ? (y & 1) == 0 : (y & 1) != 0;
      float4 pr4, pg4, pb4;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // W_(dy, dx) = m[2 + dy][j + 2 + dx]
        const float c = m[2][j + 2];
        const int ch = bayer_chan(pattern, y, j);
        const float diag1 = m[1][j + 1] + m[1][j + 3] + m[3][j + 1] + m[3][j + 3];
        const float ud2 = m[0][j + 2] + m[4][j + 2];
        const float lr2 = m[2][j] + m[2][j + 4];
        float r, g, bb;
        if (ch == 1) {
          const float ud1 = m[1][j + 2] + m[3][j + 2];
          const float lr1 = m[2][j + 1] + m[2][j + 3];
          const float same_row =
              (5.0f * c + 4.0f * lr1 - diag1 - lr2 + 0.5f * ud2) * 0.125f;
          const float same_col =
              (5.0f * c + 4.0f * ud1 - diag1 - ud2 + 0.5f * lr2) * 0.125f;
          g = c;
          r = row_has_r ? same_row : same_col;
          bb = row_has_r ? same_col : same_row;
        } else {
          const float cross1 = m[1][j + 2] + m[3][j + 2] + m[2][j + 1] + m[2][j + 3];
          const float axial2 = ud2 + lr2;
          g = (4.0f * c + 2.0f * cross1 - axial2) * 0.125f;
          const float opp = (6.0f * c + 2.0f * diag1 - 1.5f * axial2) * 0.125f;
          r = ch == 0 ? c : opp;
          bb = ch == 2 ? c : opp;
        }
        float cr, cg, cb;
        cam_clip(cam, r, g, bb, cr, cg, cb);
        rpf::put(pr4, j, cr);
        rpf::put(pg4, j, cg);
        rpf::put(pb4, j, cb);
      }
      float* p = prow(y) + c4;
      *reinterpret_cast<float4*>(p) = pr4;
      *reinterpret_cast<float4*>(p + BP_R * BP_W) = pg4;
      *reinterpret_cast<float4*>(p + 2 * BP_R * BP_W) = pb4;
    }
    __syncthreads();

    // The tail, a warp to an output row, 4 outputs a lane: unsharp,
    // vignette, the edit stack, the store. The next step's first writes to
    // the plane rings come after its window load's barrier.
    for (int a = warp; a < BSH; a += kWarps) {
      const int y = y0 + a;
      if (y >= H) break;
      const float* rows[5];
#pragma unroll
      for (int k = 0; k < 5; ++k) rows[k] = prow(y - 2 + k) + c4;
      float4 vr = unsharp4(rows, taps, amt);
#pragma unroll
      for (int k = 0; k < 5; ++k) rows[k] += BP_R * BP_W;
      float4 vg = unsharp4(rows, taps, amt);
#pragma unroll
      for (int k = 0; k < 5; ++k) rows[k] += BP_R * BP_W;
      float4 vb = unsharp4(rows, taps, amt);
      const float ay = rpf::vignette_axis(static_cast<float>(y), hf);
      const int64_t i0 = static_cast<int64_t>(y) * W + x0 + c4;
      auto pixel = [&](int j) {
        float r = rpf::pick(vr, j), g = rpf::pick(vg, j), b = rpf::pick(vb, j);
        rpf::vignette(r, g, b, strength, ay, rpf::pick(ax, j));
        // Row 0 is the all-ones main mask (never read); masks holds rows
        // 1..M-1.
        auto sel = [&](int k) -> bool {
          return k == 0 || masks[(k - 1) * hw + i0 + j] != 0;
        };
        rpf::edit_stack<IDENTITY>(r, g, b, t, sel);
        rpf::put(vr, j, r);
        rpf::put(vg, j, g);
        rpf::put(vb, j, b);
      };
      // As in develop.cu: the identity stack unrolled over the 4 pixels,
      // the full stack (which would spill unrolled) one at a time.
      if constexpr (IDENTITY) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (j < n) pixel(j);
      } else {
#pragma unroll 1
        for (int j = 0; j < n; ++j) pixel(j);
      }
      if (n > 0) {
        rpf::store4(out + i0, vr, full, n);
        rpf::store4(out + hw + i0, vg, full, n);
        rpf::store4(out + 2 * hw + i0, vb, full, n);
      }
    }
  }
}

// Rows of an X-Trans block's window, green estimate and demosaiced planes,
// and its shared-memory floats beside the table (conv7y scratch of two
// planes; the u8 site plane included, rounded up to whole floats).
constexpr int XWIN_H = XH + 2 * XHALO, XE1_H = XH + 10, XE0_H = XH + 4;
constexpr int XSCRATCH = XE1_H * XS_W > XE0_H * XE1_W ? XE1_H * XS_W
                                                      : XE0_H * XE1_W;
constexpr int XSMEM_FLOATS = 4 * 36 + XH + XW + XWIN_H * XWIN_W +
                             2 * XSCRATCH + XE1_H * XE1_W +
                             3 * XE0_H * XE0_W + (XWIN_H * XWIN_W + 3) / 4;
static_assert(XH % 6 == 0 && XH >= 2 * XHALO, "XH: a multiple of 6, >= 24");

template <bool IDENTITY>
__global__ void __launch_bounds__(kThreads)
xtrans_kernel(const float* __restrict__ mosaic, const uint8_t* __restrict__ masks,
              const float* __restrict__ table, int tab_stride,
              float* __restrict__ out, int M, int S, int H, int W, int steps) {
  constexpr int WIN_H = XWIN_H, E1H = XE1_H, E0H = XE0_H;
  extern __shared__ __align__(16) float sh[];
  float* tab = sh;
  float* den = sh + tab_stride;              // [4][36] by CFA phase
  float* vy = den + 4 * 36;                  // [XH] vignette row terms
  float* vx = vy + XH;                       // [XW] vignette column terms
  float* win = vx + XW;                      // [WIN_H][XWIN_W]
  float* scr = win + WIN_H * XWIN_W;         // conv7y scratch, 2 planes
  float* gest = scr + 2 * XSCRATCH;       // [E1H][XE1_W]
  float* pr = gest + E1H * XE1_W;            // [E0H][XE0_W] x 3
  float* pg = pr + E0H * XE0_W;
  float* pb = pg + E0H * XE0_W;
  // Window site: its CFA phase (py*6 + px) in bits 0..5, channel in 6..7.
  uint8_t* site = reinterpret_cast<uint8_t*>(pb + E0H * XE0_W);
  const int tid = threadIdx.x;
  const rpf::EditTables t =
      rpf::stage_table(tab, table, kHead, M, S, tid, kThreads);
  const float* cam = tab + 4;
  const float* wb = tab + 13;
  const int x0 = blockIdx.x * XW;
  const int band0 = blockIdx.y * steps * XH;

  // Normalizers by the CFA phase (py, px) of the site they serve: 1-D
  // green along x and y, and the 7x7 red and blue sample mass. Exact small
  // integers, so their order of summation does not matter.
  for (int i = tid; i < 4 * 36; i += kThreads) {
    const int kind = i / 36, py = (i % 36) / 6, px = i % 6;
    float s = 0.0f;
    if (kind < 2) {
      for (int k = 0; k < 7; ++k) {
        const int c = kind == 0 ? kXTrans[py][(px + 3 + k) % 6]
                                : kXTrans[(py + 3 + k) % 6][px];
        s += c == 1 ? kNC[k] : 0.0f;
      }
    } else {
      const int want = kind == 2 ? 0 : 2;
      for (int ky = 0; ky < 7; ++ky)
        for (int kx = 0; kx < 7; ++kx)
          s += kXTrans[(py + 3 + ky) % 6][(px + 3 + kx) % 6] == want
                   ? kNC[ky] * kNC[kx] : 0.0f;
    }
    den[i] = s;
  }
  // Window coordinates are global ones shifted by a multiple of 6.
  for (int i = tid; i < WIN_H * XWIN_W; i += kThreads) {
    const int py = (i / XWIN_W) % 6, px = (i % XWIN_W) % 6;
    site[i] = static_cast<uint8_t>(py * 6 + px + (kXTrans[py][px] << 6));
  }
  __syncthreads();

  for (int step = 0; step < steps; ++step) {
    const int y0 = band0 + step * XH;
    if (y0 >= H) break;
    // Rows of each array this step computes: all of them on the band's
    // first step; afterwards the last XH, the rest moved up from the step
    // before.
    const int lw = step ? WIN_H - XH : 0;
    const int l1 = step ? E1H - XH : 0;
    const int l0 = step ? E0H - XH : 0;
    if (step) {
      for (int i = tid; i < lw * XWIN_W; i += kThreads)
        win[i] = win[XH * XWIN_W + i];
      for (int i = tid; i < l1 * XE1_W; i += kThreads)
        gest[i] = gest[XH * XE1_W + i];
      for (int i = tid; i < l0 * XE0_W; i += kThreads) {
        pr[i] = pr[XH * XE0_W + i];
        pg[i] = pg[XH * XE0_W + i];
        pb[i] = pb[XH * XE0_W + i];
      }
      __syncthreads();
    }
    vignette_axes(tab, vy, y0, XH, vx, x0, step ? 0 : XW, H, W);
    for (int i = tid; i < (WIN_H - lw) * XWIN_W; i += kThreads) {
      const int wy = lw + i / XWIN_W, wx = i % XWIN_W;
      const int sy = periodic_idx(y0 - XHALO + wy, H);
      const int sx = periodic_idx(x0 - XHALO + wx, W);
      win[wy * XWIN_W + wx] = mosaic[static_cast<int64_t>(sy) * W + sx] *
                              wb[site[wy * XWIN_W + wx] >> 6];
    }
    __syncthreads();

    // conv7y of the gradient energies over the E1 rows and the full mask
    // extent's columns (gx/gy are read at the mask extent, offset 4).
    for (int i = tid; i < (E1H - l1) * XS_W; i += kThreads) {
      const int a = l1 + i / XS_W, b = i % XS_W;
      float sx = 0.0f, sy = 0.0f;
      for (int k = 0; k < 7; ++k) {
        const float* p = win + (4 + a + k) * XWIN_W + (4 + b);
        const float gx = fabsf(p[1] - p[-1]);
        const float gy = fabsf(p[XWIN_W] - p[-XWIN_W]);
        sx = k == 0 ? kNC[0] * gx : sx + kNC[k] * gx;
        sy = k == 0 ? kNC[0] * gy : sy + kNC[k] * gy;
      }
      scr[a * XS_W + b] = sx;
      scr[XSCRATCH + a * XS_W + b] = sy;
    }
    __syncthreads();

    // Green estimate at E1: the 1-D normalized convolution along the axis
    // of lower gradient energy.
    for (int i = tid; i < (E1H - l1) * XE1_W; i += kThreads) {
      const int a = l1 + i / XE1_W, b = i % XE1_W;
      float sgx = 0.0f, sgy = 0.0f, nh = 0.0f, nv = 0.0f;
      for (int k = 0; k < 7; ++k) {
        const float cx = scr[a * XS_W + b + k];
        const float cyy = scr[XSCRATCH + a * XS_W + b + k];
        // mosaic * green mask at mask-extent (3 + a, b + k) / (a + k, 3 + b)
        const int h = (7 + a) * XWIN_W + 4 + b + k;
        const int v = (4 + a + k) * XWIN_W + 7 + b;
        const float ph = win[h] * ((site[h] >> 6) == 1 ? 1.0f : 0.0f);
        const float pv = win[v] * ((site[v] >> 6) == 1 ? 1.0f : 0.0f);
        sgx = k == 0 ? kNC[0] * cx : sgx + kNC[k] * cx;
        sgy = k == 0 ? kNC[0] * cyy : sgy + kNC[k] * cyy;
        nh = k == 0 ? kNC[0] * ph : nh + kNC[k] * ph;
        nv = k == 0 ? kNC[0] * pv : nv + kNC[k] * pv;
      }
      const int phase = site[(7 + a) * XWIN_W + 7 + b] & 63;
      const float g_h = nh / fmaxf(den[phase], 1e-8f);
      const float g_v = nv / fmaxf(den[36 + phase], 1e-8f);
      gest[a * XE1_W + b] = sgx > sgy ? g_v : g_h;
    }
    __syncthreads();

    // conv7y of the chroma residuals (mosaic - g_est) at the red and blue
    // sample sites, over the E0 rows and the E1 columns.
    for (int i = tid; i < (E0H - l0) * XE1_W; i += kThreads) {
      const int a = l0 + i / XE1_W, b = i % XE1_W;
      float sr = 0.0f, sb = 0.0f;
      for (int k = 0; k < 7; ++k) {
        const int w = (7 + a + k) * XWIN_W + 7 + b;
        const float d = win[w] - gest[(a + k) * XE1_W + b];
        const int c = site[w] >> 6;
        const float dr = d * (c == 0 ? 1.0f : 0.0f);
        const float db = d * (c == 2 ? 1.0f : 0.0f);
        sr = k == 0 ? kNC[0] * dr : sr + kNC[k] * dr;
        sb = k == 0 ? kNC[0] * db : sb + kNC[k] * db;
      }
      scr[a * XE1_W + b] = sr;
      scr[XSCRATCH + a * XE1_W + b] = sb;
    }
    __syncthreads();

    // Demosaiced, matrix-clipped planes at E0.
    for (int i = tid; i < (E0H - l0) * XE0_W; i += kThreads) {
      const int a = l0 + i / XE0_W, b = i % XE0_W;
      const int w = (10 + a) * XWIN_W + 10 + b;
      const float m0 = win[w];
      const int c = site[w] >> 6;
      const float g = c == 1 ? m0 : gest[(3 + a) * XE1_W + (3 + b)];
      const float* cr = scr + a * XE1_W + b;
      const float* cb = cr + XSCRATCH;
      float nr = kNC[0] * cr[0], nb = kNC[0] * cb[0];
      for (int k = 1; k < 7; ++k) {
        nr = nr + kNC[k] * cr[k];
        nb = nb + kNC[k] * cb[k];
      }
      const int phase = site[w] & 63;
      const float r = c == 0 ? m0 : g + nr / fmaxf(den[72 + phase], 1e-8f);
      const float bb = c == 2 ? m0 : g + nb / fmaxf(den[108 + phase], 1e-8f);
      const int e = a * XE0_W + b;
      cam_clip(cam, r, g, bb, pr[e], pg[e], pb[e]);
    }
    __syncthreads();

    for (int i = tid; i < XH * XW; i += kThreads) {
      const int a = i / XW, b = i % XW;
      const int y = y0 + a, x = x0 + b;
      if (y >= H || x >= W) continue;
      tail<IDENTITY>(tab, t, pr, pg, pb, XE0_W, a, b, y, x, H, W, vy[a],
                     vx[b], masks, out);
    }
    __syncthreads();  // the next step moves rows the tail has read
  }
}

// One wave of resident blocks of `kernel` at `smem` bytes of dynamic shared
// memory, after raising its limit where it needs to.
template <typename Kernel>
cudaError_t one_wave(Kernel kernel, size_t smem, int* wave) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  return rpf::wave_blocks(kernel, kThreads, smem, wave);
}

// X-Trans: strips of XW columns, each cut into as many bands of XH-row
// steps as fill the resident blocks once.
template <bool IDENTITY>
cudaError_t launch_xtrans(const float* mosaic, const uint8_t* masks,
                          const float* table, int tab_stride, float* out,
                          int M, int S, int H, int W, cudaStream_t stream) {
  auto kernel = xtrans_kernel<IDENTITY>;
  const size_t smem = sizeof(float) * (tab_stride + XSMEM_FLOATS);
  int wave = 0;
  cudaError_t e = one_wave(kernel, smem, &wave);
  if (e != cudaSuccess) return e;
  const int gx = (W + XW - 1) / XW;
  const int rows = (H + XH - 1) / XH;
  int bands = wave / gx;
  if (bands < 1) bands = 1;
  const int steps = (rows + bands - 1) / bands;
  const int gy = (rows + steps - 1) / steps;
  kernel<<<dim3(gx, gy), kThreads, smem, stream>>>(
      mosaic, masks, table, tab_stride, out, M, S, H, W, steps);
  return cudaGetLastError();
}

template <bool IDENTITY>
cudaError_t launch(const float* mosaic, const uint8_t* masks,
                   const float* table, float* out, int M, int S,
                   int H, int W, int pattern, int r_in_row0, int vec,
                   cudaStream_t stream) {
  const int tab_stride = rpf::staged_floats(kHead, M, S);  // a multiple of 4
  if (pattern < 0)
    return launch_xtrans<IDENTITY>(mosaic, masks, table, tab_stride, out, M,
                                   S, H, W, stream);
  // Bayer: one wave of blocks (fewer when there are fewer steps), each
  // walking an equal share of the strips' steps.
  auto kernel = bayer_kernel<IDENTITY>;
  const size_t smem = sizeof(float) * (tab_stride + BSMEM_FLOATS);
  int wave = 0;
  cudaError_t e = one_wave(kernel, smem, &wave);
  if (e != cudaSuccess) return e;
  const int64_t total =
      int64_t{(W + BSW - 1) / BSW} * ((H + BSH - 1) / BSH);
  if (total > INT32_MAX) return cudaErrorInvalidValue;
  const int blocks = total < wave ? static_cast<int>(total) : wave;
  kernel<<<blocks, kThreads, smem, stream>>>(mosaic, masks, table, tab_stride,
                                             out, M, S, H, W, pattern,
                                             r_in_row0, vec);
  return cudaGetLastError();
}

}  // namespace

// pattern: the 2x2 Bayer tile as four 2-bit channel ids (site (y&1, x&1)
// at bits 2*(2*(y&1) + (x&1))), or -1 for X-Trans. masks: u8 [M-1, H, W]
// regional rows (null when M == 1). The Bayer kernel moves 16-byte vectors
// where W % 4 == 0 and the mosaic and out are so aligned. Launches on
// `stream` without synchronizing; returns the launch's cudaGetLastError()
// (0 on success).
extern "C" int rpf_raw_develop_launch(const void* mosaic, const void* masks,
                                      const void* table, int table_len,
                                      void* out, int M, int S, int H, int W,
                                      int pattern, int r_in_row0,
                                      int identity, void* stream) {
  if (table_len != kHead + rpf::table_floats(M, S) || S < 1 || (S & (S - 1)))
    return cudaErrorInvalidValue;
  if (M > 1 && masks == nullptr) return cudaErrorInvalidValue;
  if (H < 1 || W < 1 || (pattern < 0 && (H < XHALO || W < XHALO)))
    return cudaErrorInvalidValue;
  const float* m = static_cast<const float*>(mosaic);
  const uint8_t* mk = static_cast<const uint8_t*>(masks);
  const float* tab = static_cast<const float*>(table);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = W % 4 == 0 && rpf::aligned(mosaic, 16) && rpf::aligned(out, 16);
  return static_cast<int>(
      identity ? launch<true>(m, mk, tab, o, M, S, H, W, pattern, r_in_row0,
                              vec, s)
               : launch<false>(m, mk, tab, o, M, S, H, W, pattern, r_in_row0,
                               vec, s));
}
