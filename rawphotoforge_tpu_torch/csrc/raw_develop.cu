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
// for 24 MP at 3.35 TB/s), but the exact arithmetic of the demosaic and the
// edit stack sets the time, as in develop.cu.
//
// Design: a block stages its haloed mosaic window in shared memory (the WB
// gain applied as it loads), computes the demosaiced, matrix-clipped planes
// over its outputs plus the 2-px sharpen margin into shared memory, then
// runs the per-pixel tail. Borders follow the Pallas wrapper: Bayer reads
// mirror indices (numpy "reflect", -1 -> 1; WB is applied before the pad, so
// a mirrored site carries its source site's gain); X-Trans reads the
// phase-preserving periodic border (rows -12..-1 are rows 0..11, rows
// H..H+11 are rows H-12..H-1). CFA phases are global (y mod 2 or 6), so no
// tile size shows in the output. Every sum runs in the Pallas kernel's order
// (conv7y before conv7x, taps left to right from 0) and the build uses exact
// division and no multiply-add contraction, so the kernel equals its plain
// torch twin (kernels/raw_pipeline.py raw_develop_fused_ref) bit for bit.
//
// Bayer: one 16 x 64 output tile per block. X-Trans: a block owns a strip
// 48 columns wide (a multiple of 6, as are its rows, so a window site's CFA
// phase is its window coordinates mod 6, the same in every block; a u8
// plane holds each site's phase and channel, computed once) and walks down
// a band of it in steps of 24 rows. A step keeps the rows of the window
// (24), the green estimate (10) and the demosaiced planes (4) that the next
// step shares with it, so the vertical halo is paid once per band rather
// than once per tile; there are as many bands as fill the card's resident
// blocks once. The vignette's row and column terms are computed once per
// row and per column into shared memory.
//
// Table layout (floats): [vignette, true_h, true_w, sharpen] [cam2srgb 9]
// [wb gains 3] [gauss taps 5] [slot bits M] [gains 3M] [tone 6M] [channel M]
// [knots 4MS] [coeffs 16MS].

#include <cstdint>
#include <cuda_runtime.h>

#include "edit_stack.cuh"
#include "wave.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kHead = 21;

// Bayer: 16 x 64 outputs per block; 4-px halo (2 demosaic + 2 sharpen).
constexpr int BH = 16, BW = 64, BHALO = 4;
constexpr int BWIN_H = BH + 2 * BHALO, BWIN_W = BW + 2 * BHALO;
constexpr int BE0_H = BH + 4, BE0_W = BW + 4;

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

// The per-pixel tail shared by both CFAs: unsharp on the clipped planes,
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

template <bool IDENTITY>
__global__ void __launch_bounds__(kThreads)
bayer_kernel(const float* __restrict__ mosaic, const uint8_t* __restrict__ masks,
             const float* __restrict__ table, int tab_stride,
             float* __restrict__ out, int M, int S, int H, int W, int pattern,
             int r_in_row0) {
  extern __shared__ __align__(16) float sh[];
  float* tab = sh;
  float* vy = sh + tab_stride;                // [BH] vignette row terms
  float* vx = vy + BH;                        // [BW] vignette column terms
  float* win = vx + BW;                       // [BWIN_H][BWIN_W]
  float* pr = win + BWIN_H * BWIN_W;          // [BE0_H][BE0_W] x 3
  float* pg = pr + BE0_H * BE0_W;
  float* pb = pg + BE0_H * BE0_W;
  const rpf::EditTables t =
      rpf::stage_table(tab, table, kHead, M, S, threadIdx.x, kThreads);
  __syncthreads();
  const float* cam = tab + 4;
  const float* wb = tab + 13;
  const int y0 = blockIdx.y * BH, x0 = blockIdx.x * BW;
  vignette_axes(tab, vy, y0, BH, vx, x0, BW, H, W);

  for (int i = threadIdx.x; i < BWIN_H * BWIN_W; i += blockDim.x) {
    const int sy = reflect_idx(y0 - BHALO + i / BWIN_W, H);
    const int sx = reflect_idx(x0 - BHALO + i % BWIN_W, W);
    win[i] = mosaic[static_cast<int64_t>(sy) * W + sx] *
             wb[bayer_chan(pattern, sy, sx)];
  }
  __syncthreads();

  // Malvar-He-Cutler over the tile plus the 2-px sharpen margin.
  for (int i = threadIdx.x; i < BE0_H * BE0_W; i += blockDim.x) {
    const int a = i / BE0_W, b = i % BE0_W;
    const int gy = y0 - 2 + a, gx = x0 - 2 + b;
    const float* p = win + (a + 2) * BWIN_W + (b + 2);
    auto W_ = [&](int dy, int dx) { return p[dy * BWIN_W + dx]; };
    const float c = W_(0, 0);
    const float cross1 = W_(-1, 0) + W_(1, 0) + W_(0, -1) + W_(0, 1);
    const float diag1 = W_(-1, -1) + W_(-1, 1) + W_(1, -1) + W_(1, 1);
    const float ud2 = W_(-2, 0) + W_(2, 0);
    const float lr2 = W_(0, -2) + W_(0, 2);
    const float axial2 = ud2 + lr2;
    const float ud1 = W_(-1, 0) + W_(1, 0);
    const float lr1 = W_(0, -1) + W_(0, 1);
    const float g_at_cb = (4.0f * c + 2.0f * cross1 - axial2) * 0.125f;
    const float same_row =
        (5.0f * c + 4.0f * lr1 - diag1 - lr2 + 0.5f * ud2) * 0.125f;
    const float same_col =
        (5.0f * c + 4.0f * ud1 - diag1 - ud2 + 0.5f * lr2) * 0.125f;
    const float opp = (6.0f * c + 2.0f * diag1 - 1.5f * axial2) * 0.125f;
    const int ch = bayer_chan(pattern, gy, gx);
    const bool row_has_r = r_in_row0 ? (gy & 1) == 0 : (gy & 1) != 0;
    float r, g, bb;
    g = ch == 1 ? c : g_at_cb;
    r = ch == 0 ? c : (ch == 1 ? (row_has_r ? same_row : same_col) : opp);
    bb = ch == 2 ? c : (ch == 1 ? (row_has_r ? same_col : same_row) : opp);
    cam_clip(cam, r, g, bb, pr[i], pg[i], pb[i]);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < BH * BW; i += blockDim.x) {
    const int a = i / BW, b = i % BW;
    const int y = y0 + a, x = x0 + b;
    if (y >= H || x >= W) continue;
    tail<IDENTITY>(tab, t, pr, pg, pb, BE0_W, a, b, y, x, H, W, vy[a], vx[b],
                   masks, out);
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

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// X-Trans: strips of XW columns, each cut into as many bands of XH-row
// steps as fill the resident blocks once.
template <bool IDENTITY>
cudaError_t launch_xtrans(const float* mosaic, const uint8_t* masks,
                          const float* table, int tab_stride, float* out,
                          int M, int S, int H, int W, cudaStream_t stream) {
  auto kernel = xtrans_kernel<IDENTITY>;
  const size_t smem = sizeof(float) * (tab_stride + XSMEM_FLOATS);
  cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  int wave = 0;
  e = rpf::wave_blocks(kernel, kThreads, smem, &wave);
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
                   int H, int W, int pattern, int r_in_row0,
                   cudaStream_t stream) {
  const int tab_stride = rpf::staged_floats(kHead, M, S);  // a multiple of 4
  if (pattern < 0)
    return launch_xtrans<IDENTITY>(mosaic, masks, table, tab_stride, out, M,
                                   S, H, W, stream);
  auto kernel = bayer_kernel<IDENTITY>;
  const size_t smem = sizeof(float) *
      (tab_stride + BH + BW + BWIN_H * BWIN_W + 3 * BE0_H * BE0_W);
  cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((W + BW - 1) / BW, (H + BH - 1) / BH);
  kernel<<<grid, kThreads, smem, stream>>>(mosaic, masks, table, tab_stride,
                                           out, M, S, H, W, pattern,
                                           r_in_row0);
  return cudaGetLastError();
}

}  // namespace

// pattern: the 2x2 Bayer tile as four 2-bit channel ids (site (y&1, x&1)
// at bits 2*(2*(y&1) + (x&1))), or -1 for X-Trans. masks: u8 [M-1, H, W]
// regional rows (null when M == 1). Launches on `stream` without
// synchronizing; returns the launch's cudaGetLastError() (0 on success).
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
  return static_cast<int>(
      identity ? launch<true>(m, mk, tab, o, M, S, H, W, pattern, r_in_row0, s)
               : launch<false>(m, mk, tab, o, M, S, H, W, pattern, r_in_row0,
                               s));
}
