// The geometry-and-sharpen stage for Hopper (sm_90a): the lens-distortion
// warp, the edge replication into the bucket pad and the radius-2 unsharp
// mask of f32 planes [3, H, W], in one launch.
//
// It replaces the JAX package's ops/geometry.py warp (lens_distortion,
// warp_coords, the bilinear gather) and ops/sharpen.py unsharp mask (two
// 5-tap passes with reflect padding), both jnp with no Pallas kernel, and
// the edge replication between them (ops/develop.replicate_true_edges). The
// port's plain twin is that chain of torch ops (kernels/geometry.py), and
// the kernel equals it bit for bit: each operation below is the twin's, in
// the twin's order, and the build has exact division and square root and no
// multiply-add contraction (kernels/cuda_build.py); the sums use __fadd_rn
// and __fmul_rn where the order is the contract.
//
// What one output pixel (y, x) of the grid is:
// - S(r, c), the warped and edge-replicated value at (r, c): with the warp
//   on, the bilinear sample of the source at the warp's coordinates of
//   (r, c) (0 where they fall outside the true extent); with it off, the
//   source at (r, c). The indices r, c are first clamped to the true extent
//   (th - 1, tw - 1) where the pad is edge-replicated after a warp, else to
//   the grid (H - 1, W - 1).
// - Without the unsharp, S(y, x). With it, the 5-tap Gaussian of S over
//   rows and then columns, each neighbour index reflected into the grid as
//   numpy's 'reflect' pad does (clipping where the axis is 2 or fewer
//   pixels), then max(x + amount (x - blur), 0) with x = S(y, x).
//
// What bounds it: bytes. At 45 MP (8192 x 5504) the stage must read the
// three f32 planes once and write them once: 1.082 GB, 0.323 ms at the H100
// SXM's 3.35 TB/s. The torch chain moved each plane a dozen times through
// full-frame temporaries (int64 index planes, each lerp term, the padded
// copies of each blur pass) and read device scalars back to the host.
//
// Design:
// - Tiles. A block owns a 64 x 32 output tile. It samples S over the tile
//   and a 2-pixel halo (68 x 36 x 3 planes, 29 KB of shared memory), then
//   each thread blurs 4 adjacent outputs of a row from shared memory (the
//   vertical sums of the 8 columns they need, then the horizontal taps) and
//   stores them, as one float4 where W % 4 == 0. The halo is recomputed by
//   the neighbouring tiles: 68 x 36 / (64 x 32) = 1.20 samples an output.
//   Without the unsharp the tile has no halo and each sample is stored as
//   it is taken.
// - Coordinates. The warp's u and v depend on the column and the row alone,
//   so a tile computes its 68 columns' cu and 36 rows' cv once (with their
//   reflected and clamped indices); a sample then takes r2, the
//   denominator, three divisions, the snap and the floor.
// - Corner reads go through the read-only path (__ldg). A tile's source
//   footprint is a small, nearly affine patch, so L1 and L2 absorb the four
//   corners' reuse and DRAM sees about one read of the source.
// - Int32 offsets: the wrapper refuses 3 H W >= 2^31.
// - No readbacks: the wrapper computes the warp's strength and the unsharp's
//   amount and taps on the host in f32, and the launcher below the extents
//   and the aspect, by the same IEEE operations the twin runs on the device;
//   the launch is asynchronous.
//
// The exact-LUT anchor (ops/develop.develop), the row-sharded warp
// (parallel/spatial, whose slabs sample with a row base and a halo of their
// own), the CLI's batch unsharp and the host develop (engine/hostdev) keep
// the plain ops: the anchor is the oracle, and the others are separate
// contracts.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 64, kTileH = 32, kRadius = 2, kTaps = 2 * kRadius + 1;
constexpr int kThreads = 256;
constexpr int kStageW = kTileW + 2 * kRadius;  // 68: a row is 272 B, 16-byte aligned
constexpr int kStageH = kTileH + 2 * kRadius;  // 36

struct Params {
  int H, W;          // the grid
  int ch, cw;        // the largest row and column S reads: th - 1 or H - 1, ...
  float strength;    // -0.5 * (d / 100)
  float hf, wf;      // the true extent th x tw, as f32
  float aspect;      // wf / hf
  float hfm1, wfm1;  // hf - 1, wf - 1
  int hi, wi;        // th - 1, tw - 1
  float amount;      // the unsharp's amount, f32
  float taps[kTaps]; // _gauss_taps(1.0, 2)
  int vec;           // W % 4 == 0: float4 stores
};

// numpy 'reflect' padding's source index for j in [-2, n + 1] (clipping when
// the axis is not longer than the radius), as ops/sharpen._pad_index.
__device__ __forceinline__ int reflect(int j, int n) {
  if (n > kRadius) {
    j = j < 0 ? -j : j;
    if (j > n - 1) j = 2 * (n - 1) - j;
  }
  return j < 0 ? 0 : (j > n - 1 ? n - 1 : j);
}

// ops/geometry.snap_near_integer: round to the nearest integer (ties to
// even, torch.round) where within max(|s| * 6e-7, 1e-4) of it.
__device__ __forceinline__ float snap(float s) {
  const float r = rintf(s);
  float thr = __fmul_rn(fabsf(s), 6e-7f);
  thr = thr < 1e-4f ? 1e-4f : thr;
  return fabsf(__fsub_rn(s, r)) < thr ? r : s;
}

// ops/geometry._bilinear_gather's lerp: along x, then along y.
__device__ __forceinline__ float lerp2(float c00, float c10, float c01, float c11,
                                       float tx, float ty) {
  const float sx = __fsub_rn(1.0f, tx), sy = __fsub_rn(1.0f, ty);
  const float cx0 = __fadd_rn(__fmul_rn(c00, sx), __fmul_rn(c10, tx));
  const float cx1 = __fadd_rn(__fmul_rn(c01, sx), __fmul_rn(c11, tx));
  return __fadd_rn(__fmul_rn(cx0, sy), __fmul_rn(cx1, ty));
}

// S at source row `row`, column `col` (already reflected and clamped) into
// v[3]; cu, cv are the warp's centred coordinates of that column and row
// (ops/geometry.warp_coords and warp_sample, row_base 0).
template <bool WARP>
__device__ __forceinline__ void sample(const float* __restrict__ src, const Params& p,
                                       int row, int col, float cu, float cv,
                                       float v[3]) {
  const int hw = p.H * p.W;
  if (!WARP) {
    const int i = row * p.W + col;
    v[0] = __ldg(src + i);
    v[1] = __ldg(src + hw + i);
    v[2] = __ldg(src + 2 * hw + i);
    return;
  }
  const float r2 = __fadd_rn(__fmul_rn(cu, cu), __fmul_rn(cv, cv));
  const float denom = __fadd_rn(1.0f, __fmul_rn(p.strength, r2));
  const float du = __fdiv_rn(cu, denom);
  const float dv = __fdiv_rn(cv, denom);
  const float fu = __fadd_rn(__fdiv_rn(du, p.aspect), 0.5f);
  const float fv = __fadd_rn(dv, 0.5f);
  if (fu < 0.0f || fu > 1.0f || fv < 0.0f || fv > 1.0f) {
    v[0] = v[1] = v[2] = 0.0f;
    return;
  }
  const float px = snap(__fmul_rn(fu, p.wfm1));
  const float py = snap(__fmul_rn(fv, p.hfm1));
  const float x0f = floorf(px), y0f = floorf(py);
  // clamp(int(floor), 0, wi), taken on the float (a NaN lands on 0).
  const int x0 = static_cast<int>(fminf(fmaxf(x0f, 0.0f), static_cast<float>(p.wi)));
  const int y0 = static_cast<int>(fminf(fmaxf(y0f, 0.0f), static_cast<float>(p.hi)));
  const int x1 = x0 + 1 > p.wi ? p.wi : x0 + 1;
  const int y1 = y0 + 1 > p.hi ? p.hi : y0 + 1;
  const float tx = __fsub_rn(px, x0f), ty = __fsub_rn(py, y0f);
  const int i00 = y0 * p.W + x0, i10 = y0 * p.W + x1;
  const int i01 = y1 * p.W + x0, i11 = y1 * p.W + x1;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float* s = src + k * hw;
    v[k] = lerp2(__ldg(s + i00), __ldg(s + i10), __ldg(s + i01), __ldg(s + i11), tx, ty);
  }
}

// ((((0 + t0 a0) + t1 a1) + t2 a2) + t3 a3) + t4 a4: ops/sharpen._blur_axis.
__device__ __forceinline__ float taps5(const float* t, float a0, float a1, float a2,
                                       float a3, float a4) {
  float acc = __fadd_rn(0.0f, __fmul_rn(t[0], a0));
  acc = __fadd_rn(acc, __fmul_rn(t[1], a1));
  acc = __fadd_rn(acc, __fmul_rn(t[2], a2));
  acc = __fadd_rn(acc, __fmul_rn(t[3], a3));
  return __fadd_rn(acc, __fmul_rn(t[4], a4));
}

__device__ __forceinline__ float sharpen(float x, float blur, float amount) {
  const float y = __fadd_rn(x, __fmul_rn(amount, __fsub_rn(x, blur)));
  return y < 0.0f ? 0.0f : y;  // torch.clamp(min=0): a NaN stays NaN
}

template <bool WARP, bool SHARPEN>
__global__ void __launch_bounds__(kThreads)
geometry_sharpen_kernel(const float* __restrict__ src, float* __restrict__ dst,
                        const Params p) {
  constexpr int halo = SHARPEN ? kRadius : 0;
  constexpr int sw = kTileW + 2 * halo, sh = kTileH + 2 * halo;
  __shared__ __align__(16) float stage[SHARPEN ? 3 * kStageH * kStageW : 1];
  __shared__ float col_u[kStageW], row_v[kStageH];
  __shared__ int col_i[kStageW], row_i[kStageH];
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * kTileW - halo, y0 = blockIdx.y * kTileH - halo;

  // The tile's columns and rows: reflected into the grid, clamped to the
  // extent S reads, and (with the warp) their centred coordinates
  // cu = (c / wf - 0.5) * aspect and cv = r / hf - 0.5.
  for (int j = tid; j < sw + sh; j += kThreads) {
    if (j < sw) {
      const int c = min(reflect(x0 + j, p.W), p.cw);
      col_i[j] = c;
      if (WARP)
        col_u[j] = __fmul_rn(__fsub_rn(__fdiv_rn(static_cast<float>(c), p.wf), 0.5f),
                             p.aspect);
    } else {
      const int r = min(reflect(y0 + j - sw, p.H), p.ch);
      row_i[j - sw] = r;
      if (WARP) row_v[j - sw] = __fsub_rn(__fdiv_rn(static_cast<float>(r), p.hf), 0.5f);
    }
  }
  __syncthreads();

  const int hw = p.H * p.W;
  for (int i = tid; i < sh * sw; i += kThreads) {
    const int a = i / sw, b = i - a * sw;
    if (!SHARPEN && (y0 + a >= p.H || x0 + b >= p.W)) continue;
    float v[3];
    sample<WARP>(src, p, row_i[a], col_i[b], WARP ? col_u[b] : 0.0f,
                 WARP ? row_v[a] : 0.0f, v);
    if (SHARPEN) {
#pragma unroll
      for (int k = 0; k < 3; ++k) stage[(k * kStageH + a) * kStageW + b] = v[k];
    } else {
      const int o = (y0 + a) * p.W + x0 + b;
      dst[o] = v[0];
      dst[hw + o] = v[1];
      dst[2 * hw + o] = v[2];
    }
  }
  if (!SHARPEN) return;
  __syncthreads();

  // Four adjacent outputs a thread: output column 4q + j of the tile reads
  // stage columns 4q + j .. 4q + j + 4, so the 8 vertical sums of stage
  // columns 4q .. 4q + 7 serve all four.
  constexpr int quads = kTileW / 4;
  const float* t = p.taps;
  for (int i = tid; i < 3 * kTileH * quads; i += kThreads) {
    const int k = i / (kTileH * quads);
    const int a = (i / quads) % kTileH, q = i % quads;
    const int y = y0 + halo + a, x = x0 + halo + 4 * q;
    if (y >= p.H || x >= p.W) continue;
    const float* base = stage + (k * kStageH + a) * kStageW + 4 * q;
    float4 lo[kTaps], hi[kTaps];
#pragma unroll
    for (int r = 0; r < kTaps; ++r) {
      lo[r] = *reinterpret_cast<const float4*>(base + r * kStageW);
      hi[r] = *reinterpret_cast<const float4*>(base + r * kStageW + 4);
    }
    float col[8];
    col[0] = taps5(t, lo[0].x, lo[1].x, lo[2].x, lo[3].x, lo[4].x);
    col[1] = taps5(t, lo[0].y, lo[1].y, lo[2].y, lo[3].y, lo[4].y);
    col[2] = taps5(t, lo[0].z, lo[1].z, lo[2].z, lo[3].z, lo[4].z);
    col[3] = taps5(t, lo[0].w, lo[1].w, lo[2].w, lo[3].w, lo[4].w);
    col[4] = taps5(t, hi[0].x, hi[1].x, hi[2].x, hi[3].x, hi[4].x);
    col[5] = taps5(t, hi[0].y, hi[1].y, hi[2].y, hi[3].y, hi[4].y);
    col[6] = taps5(t, hi[0].z, hi[1].z, hi[2].z, hi[3].z, hi[4].z);
    col[7] = taps5(t, hi[0].w, hi[1].w, hi[2].w, hi[3].w, hi[4].w);
    const float mid[8] = {lo[2].x, lo[2].y, lo[2].z, lo[2].w,
                          hi[2].x, hi[2].y, hi[2].z, hi[2].w};
    float out[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[j] = sharpen(mid[j + 2],
                       taps5(t, col[j], col[j + 1], col[j + 2], col[j + 3], col[j + 4]),
                       p.amount);
    float* o = dst + k * hw + y * p.W + x;
    if (p.vec) {
      *reinterpret_cast<float4*>(o) = make_float4(out[0], out[1], out[2], out[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (x + j < p.W) o[j] = out[j];
    }
  }
}

template <bool WARP, bool SHARPEN>
cudaError_t launch(const float* src, float* dst, const Params& p, cudaStream_t stream) {
  const dim3 grid((p.W + kTileW - 1) / kTileW, (p.H + kTileH - 1) / kTileH);
  geometry_sharpen_kernel<WARP, SHARPEN><<<grid, kThreads, 0, stream>>>(src, dst, p);
  return cudaGetLastError();
}

}  // namespace

// One launch over src and dst, f32 [3, H, W] contiguous and distinct, whose
// true extent is th x tw. warp: sample through the lens warp of `strength`
// (else read the source); replicate: S clamps its indices to the true
// extent (else to the grid); the unsharp mask runs where amount != 0, with
// `taps`, 5 floats on the host. Returns a cudaError_t value.
extern "C" int rpf_geometry_sharpen_launch(const void* src, void* dst, int H, int W,
                                           int th, int tw, int warp, int replicate,
                                           float strength, float amount,
                                           const float* taps, void* stream) {
  if (H <= 0 || W <= 0 || th <= 0 || th > H || tw <= 0 || tw > W ||
      3 * static_cast<int64_t>(H) * W >= (int64_t{1} << 31) || src == dst ||
      taps == nullptr)
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(dst) % 16 || reinterpret_cast<uintptr_t>(src) % 4)
    return cudaErrorMisalignedAddress;
  Params p;
  p.H = H;
  p.W = W;
  p.ch = replicate ? th - 1 : H - 1;
  p.cw = replicate ? tw - 1 : W - 1;
  p.strength = strength;
  p.hf = static_cast<float>(th);
  p.wf = static_cast<float>(tw);
  p.aspect = p.wf / p.hf;
  p.hfm1 = p.hf - 1.0f;
  p.wfm1 = p.wf - 1.0f;
  p.hi = th - 1;
  p.wi = tw - 1;
  p.amount = amount;
  for (int k = 0; k < kTaps; ++k) p.taps[k] = taps[k];
  p.vec = W % 4 == 0;
  const auto* in = static_cast<const float*>(src);
  auto* out = static_cast<float*>(dst);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (warp)
    return static_cast<int>(amount != 0.0f ? launch<true, true>(in, out, p, s)
                                           : launch<true, false>(in, out, p, s));
  return static_cast<int>(amount != 0.0f ? launch<false, true>(in, out, p, s)
                                         : launch<false, false>(in, out, p, s));
}
