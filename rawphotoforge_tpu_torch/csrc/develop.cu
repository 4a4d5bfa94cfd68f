// The fused develop kernel for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel kernels/fused.py:_develop_kernel
// (pallas_call at fused.py:488): vignette -> per-mask (WB -> tone ->
// brightness curve) -> per-mask OKLCH hue/sat/light -> sRGB encode, over
// post-geometry planes f32 [3, H, W].
//
// Bound: bytes on paper. Each pixel reads 12 B of f32 planes (+1 B per u8
// mask row, +4 B per f32 row) and writes 12 B; a 24.64 Mpx bucket-padded
// 24 MP frame moves 591 MB (0.18 ms at 3.35 TB/s), 690 MB with four u8 mask
// rows. What sets the time is the per-pixel arithmetic of the edit stack
// under exact IEEE rounding (-fmad=false, -prec-div/-prec-sqrt=true), so the
// design spends as few operations per pixel as the exact result allows.
//
// Design: a 2-D grid. A block is 32 x 8 threads; each thread owns 4
// consecutive pixels of a row (16-byte float4 plane loads and stores, one
// 4-byte load per u8 mask row) and walks down the rows with a stride of the
// grid's height, so the column half of the vignette is computed once per
// thread and the row half once per row. Mask rows 0..31 become one bit
// mask per pixel, read once per row. The small tables arrive packed in one
// f32 buffer and are staged in shared memory once per block. A row whose
// width is not a multiple of 4, or a misaligned buffer, takes scalar loads
// for the ragged last 1-3 pixels (or for the whole row). M, S, H, W and the
// per-mask default-slot bits are runtime values; templates cover only
// IDENTITY (identity_oklch) and the mask element type.
//
// Table layout (floats): [vignette, true_h, true_w, row_offset]
// [slot bits M] [gains 3M] [tone 6M] [channel M] [knots 4MS] [coeffs 16MS];
// S, the segments of a curve row, is a power of two.

#include <cstdint>
#include <cuda_runtime.h>

#include "edit_stack.cuh"
#include "vec4.cuh"
#include "wave.cuh"

namespace {

using rpf::load4;
using rpf::pick;
using rpf::put;
using rpf::store4;

constexpr int kCols = 32, kRows = 8, kPix = 4;
constexpr int kThreads = kCols * kRows;
constexpr int kBitRows = 32;  // mask rows held as bits; the rest are read

__device__ __forceinline__ uint32_t pick(const uint4& v, int j) {
  return j == 0 ? v.x : (j == 1 ? v.y : (j == 2 ? v.z : v.w));
}

// Which of 4 consecutive mask values are non-zero, as bits 0..3.
__device__ __forceinline__ uint32_t nonzero4(const uint8_t* __restrict__ p,
                                             bool full, int n) {
  uint32_t out = 0;
  if (full) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int j = 0; j < 4; ++j) out |= ((w >> (8 * j)) & 0xffu) != 0 ? 1u << j : 0u;
    return out;
  }
  for (int j = 0; j < n; ++j) out |= p[j] != 0 ? 1u << j : 0u;
  return out;
}

__device__ __forceinline__ uint32_t nonzero4(const float* __restrict__ p,
                                             bool full, int n) {
  const float4 v = load4(p, full, n);
  uint32_t out = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) out |= pick(v, j) != 0.0f ? 1u << j : 0u;
  return out;
}

template <bool IDENTITY, typename MaskT>
__global__ void __launch_bounds__(kThreads)
develop_kernel(const float* __restrict__ planes,
               const MaskT* __restrict__ masks, const float* __restrict__ table,
               float* __restrict__ out, int M, int S, int H, int W,
               int main_only, int vec) {
  extern __shared__ __align__(16) float sh[];
  const int tid = threadIdx.y * kCols + threadIdx.x;
  const rpf::EditTables t = rpf::stage_table(sh, table, 4, M, S, tid, kThreads);
  __syncthreads();

  const int x0 = (blockIdx.x * kCols + threadIdx.x) * kPix;
  if (x0 >= W) return;
  const int n = min(kPix, W - x0);
  const bool full = vec && n == kPix;
  const float strength = rpf::vignette_strength(sh[0]);
  const float hf = sh[1] > 0.0f ? sh[1] : static_cast<float>(H);
  const float wf = sh[2] > 0.0f ? sh[2] : static_cast<float>(W);
  const float row_offset = sh[3];
  float4 ax = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int j = 0; j < kPix; ++j)
    put(ax, j, rpf::vignette_axis(static_cast<float>(x0 + j), wf));
  const int bit_rows = main_only ? 0 : min(M, kBitRows);

  const int64_t hw = static_cast<int64_t>(H) * W;
  for (int y = blockIdx.y * kRows + threadIdx.y; y < H;
       y += gridDim.y * kRows) {
    const int64_t i0 = static_cast<int64_t>(y) * W + x0;
    float4 vr = load4(planes + i0, full, n);
    float4 vg = load4(planes + hw + i0, full, n);
    float4 vb = load4(planes + 2 * hw + i0, full, n);
    // Mask 0 of a main-only call is all ones by the caller's assertion and
    // is never read (masks may be null then).
    uint4 bits = main_only ? make_uint4(1u, 1u, 1u, 1u) : make_uint4(0u, 0u, 0u, 0u);
    for (int k = 0; k < bit_rows; ++k) {
      const uint32_t nz = nonzero4(masks + k * hw + i0, full, n);
      bits.x |= (nz & 1u) << k;
      bits.y |= ((nz >> 1) & 1u) << k;
      bits.z |= ((nz >> 2) & 1u) << k;
      bits.w |= ((nz >> 3) & 1u) << k;
    }
    const float ay = rpf::vignette_axis(static_cast<float>(y) + row_offset, hf);
    auto pixel = [&](int j) {
      float r = pick(vr, j), g = pick(vg, j), b = pick(vb, j);
      rpf::vignette(r, g, b, strength, ay, pick(ax, j));
      const uint32_t pb = pick(bits, j);
      auto sel = [&](int k) -> bool {
        return k < kBitRows ? ((pb >> k) & 1u) != 0
                            : masks[k * hw + i0 + j] != MaskT(0);
      };
      rpf::edit_stack<IDENTITY>(r, g, b, t, sel);
      put(vr, j, r);
      put(vg, j, g);
      put(vb, j, b);
    };
    // Without the OKLCH round trip the stack is short enough to unroll over
    // the 4 pixels (4 independent chains for the scheduler); the full stack
    // unrolled spills registers, so it takes one pixel at a time.
    if constexpr (IDENTITY) {
#pragma unroll
      for (int j = 0; j < kPix; ++j)
        if (j < n) pixel(j);
    } else {
#pragma unroll 1
      for (int j = 0; j < n; ++j) pixel(j);
    }
    store4(out + i0, vr, full, n);
    store4(out + hw + i0, vg, full, n);
    store4(out + 2 * hw + i0, vb, full, n);
  }
}

template <bool IDENTITY, typename MaskT>
cudaError_t launch(const void* planes, const void* masks, const float* table,
                   float* out, int M, int S, int H, int W,
                   int main_only, int vec, int max_blocks,
                   cudaStream_t stream) {
  auto kernel = develop_kernel<IDENTITY, MaskT>;
  const size_t smem = sizeof(float) * rpf::staged_floats(4, M, S);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  // One wave of resident blocks (or max_blocks, where given): the rows
  // beyond it are walked by the threads' row loop.
  if (max_blocks <= 0) {
    cudaError_t e = rpf::wave_blocks(kernel, kThreads, smem, &max_blocks);
    if (e != cudaSuccess) return e;
  }
  const int gx = (W + kCols * kPix - 1) / (kCols * kPix);
  int gy = (H + kRows - 1) / kRows;
  const int cap = max_blocks / gx;
  if (gy > cap) gy = cap > 1 ? cap : 1;
  kernel<<<dim3(gx, gy), dim3(kCols, kRows), smem, stream>>>(
      static_cast<const float*>(planes), static_cast<const MaskT*>(masks),
      table, out, M, S, H, W, main_only, vec);
  return cudaGetLastError();
}

// The edit stack's device functions whose form differs from the Pallas
// kernel's (the OETF) or that replace a division, and the cube root, one
// per element, for the exhaustive checks against their torch twins.
__global__ void device_fn_kernel(int fn, const float* __restrict__ in,
                                 float* __restrict__ out, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const float x = in[i];
    float y;
    switch (fn) {
      case 0: y = rpf::cbrt_pow(x); break;
      case 1: y = rpf::srgb_oetf(x); break;
      case 2: y = rpf::div_65535(x); break;
      default: y = rpf::div_32767_5(x); break;
    }
    out[i] = y;
  }
}

}  // namespace

// mask_kind: 0 = no mask array (main-only), 1 = u8 rows, 2 = f32 rows. A
// thread's 4 pixels move as one 16-byte vector where W % 4 == 0 and the
// buffers are so aligned. max_blocks caps the grid (0: one wave of
// resident blocks). Launches on `stream` without synchronizing; returns the
// launch's cudaGetLastError() (0 on success).
extern "C" int rpf_develop_launch(const void* planes, const void* masks,
                                  int mask_kind, const void* table,
                                  int table_len, void* out, int M, int S,
                                  int H, int W, int main_only, int identity,
                                  int max_blocks, void* stream) {
  if (table_len != 4 + rpf::table_floats(M, S) || S < 1 || (S & (S - 1)))
    return cudaErrorInvalidValue;
  if (mask_kind == 0 && !main_only) return cudaErrorInvalidValue;
  if (H < 1 || W < 1) return cudaErrorInvalidValue;
  const float* tab = static_cast<const float*>(table);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool f32 = mask_kind == 2;
  const int vec = W % 4 == 0 && rpf::aligned(planes, 16) &&
                  rpf::aligned(out, 16) &&
                  (masks == nullptr || rpf::aligned(masks, f32 ? 16 : 4));
  if (identity) {
    return static_cast<int>(
        f32 ? launch<true, float>(planes, masks, tab, o, M, S, H, W,
                                  main_only, vec, max_blocks, s)
            : launch<true, uint8_t>(planes, masks, tab, o, M, S, H, W,
                                    main_only, vec, max_blocks, s));
  }
  return static_cast<int>(
      f32 ? launch<false, float>(planes, masks, tab, o, M, S, H, W,
                                 main_only, vec, max_blocks, s)
          : launch<false, uint8_t>(planes, masks, tab, o, M, S, H, W,
                                   main_only, vec, max_blocks, s));
}

// fn: 0 the OKLab cube root, 1 the sRGB OETF, 2 y / 65535, 3 y / 32767.5
// (the last two for whole y in [0, 65535]).
extern "C" int rpf_develop_device_fn(int fn, const void* in, void* out,
                                     long long n, void* stream) {
  if (fn < 0 || fn > 3 || n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  long long blocks = (n + 255) / 256;
  if (blocks > 65536) blocks = 65536;
  device_fn_kernel<<<static_cast<unsigned>(blocks), 256, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      fn, static_cast<const float*>(in), static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
