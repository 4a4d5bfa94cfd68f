// The fused develop kernel for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel kernels/fused.py:_develop_kernel
// (pallas_call at fused.py:488): vignette -> per-mask (WB -> tone ->
// brightness curve) -> per-mask OKLCH hue/sat/light -> sRGB encode, over
// post-geometry planes f32 [3, H, W].
//
// Bound: bytes. Each pixel reads 12 B of f32 planes (+1 B per u8 mask row,
// +4 B per f32 row) and writes 12 B; a 24.64 Mpx bucket-padded 24 MP frame
// moves 591 MB (0.18 ms at 3.35 TB/s), 690 MB with four u8 mask rows.
//
// Design: one thread per pixel in a grid-stride loop over the row-major
// image, so the plane, mask and output accesses of a warp are contiguous.
// The small tables arrive packed in one f32 buffer and are staged in shared
// memory once per block; every curve-segment read is then a uniform
// (broadcast) shared-memory read. M, S, H, W and the per-mask default-slot
// bits are runtime values; templates cover only IDENTITY (identity_oklch)
// and the mask element type.
//
// Table layout (floats): [vignette, true_h, true_w, row_offset]
// [slot bits M] [gains 3M] [tone 6M] [channel M] [knots 4MS] [coeffs 16MS].

#include <cstdint>
#include <cuda_runtime.h>

#include "edit_stack.cuh"

namespace {

template <bool IDENTITY, typename MaskT>
__global__ void __launch_bounds__(256)
develop_kernel(const float* __restrict__ planes,
               const MaskT* __restrict__ masks, const float* __restrict__ table,
               int table_len, float* __restrict__ out, int M, int S, int H,
               int W, int main_only) {
  extern __shared__ float sh[];
  for (int i = threadIdx.x; i < table_len; i += blockDim.x) sh[i] = table[i];
  __syncthreads();

  const float vig = sh[0];
  const float hf = sh[1] > 0.0f ? sh[1] : static_cast<float>(H);
  const float wf = sh[2] > 0.0f ? sh[2] : static_cast<float>(W);
  const float row_offset = sh[3];
  const rpf::EditTables t = rpf::edit_tables(sh + 4, M, S);

  const int64_t hw = static_cast<int64_t>(H) * W;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < hw; i += stride) {
    const int y = static_cast<int>(i / W);
    const int x = static_cast<int>(i - static_cast<int64_t>(y) * W);
    float r = planes[i];
    float g = planes[hw + i];
    float b = planes[2 * hw + i];
    rpf::vignette(r, g, b, vig, hf, wf, static_cast<float>(y) + row_offset,
                  static_cast<float>(x));
    // Mask 0 of a main-only call is all ones by the caller's assertion and
    // is never read (masks may be null then).
    auto sel = [&](int k) -> bool {
      return (main_only && k == 0) || masks[k * hw + i] != MaskT(0);
    };
    rpf::edit_stack<IDENTITY>(r, g, b, t, sel);
    out[i] = r;
    out[hw + i] = g;
    out[2 * hw + i] = b;
  }
}

template <bool IDENTITY, typename MaskT>
cudaError_t launch(const void* planes, const void* masks, const float* table,
                   int table_len, float* out, int M, int S, int H, int W,
                   int main_only, int max_blocks, cudaStream_t stream) {
  auto kernel = develop_kernel<IDENTITY, MaskT>;
  const size_t smem = static_cast<size_t>(table_len) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int threads = 256;
  const int64_t hw = static_cast<int64_t>(H) * W;
  int64_t blocks = (hw + threads - 1) / threads;
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks < 1) blocks = 1;
  kernel<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
      static_cast<const float*>(planes), static_cast<const MaskT*>(masks),
      table, table_len, out, M, S, H, W, main_only);
  return cudaGetLastError();
}

}  // namespace

// mask_kind: 0 = no mask array (main-only), 1 = u8 rows, 2 = f32 rows.
// Launches on `stream` without synchronizing; returns the launch's
// cudaGetLastError() (0 on success).
extern "C" int rpf_develop_launch(const void* planes, const void* masks,
                                  int mask_kind, const void* table,
                                  int table_len, void* out, int M, int S,
                                  int H, int W, int main_only, int identity,
                                  int max_blocks, void* stream) {
  if (table_len != 4 + rpf::table_floats(M, S)) return cudaErrorInvalidValue;
  if (mask_kind == 0 && !main_only) return cudaErrorInvalidValue;
  const float* tab = static_cast<const float*>(table);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool f32 = mask_kind == 2;
  if (identity) {
    return static_cast<int>(
        f32 ? launch<true, float>(planes, masks, tab, table_len, o, M, S, H, W,
                                  main_only, max_blocks, s)
            : launch<true, uint8_t>(planes, masks, tab, table_len, o, M, S, H,
                                    W, main_only, max_blocks, s));
  }
  return static_cast<int>(
      f32 ? launch<false, float>(planes, masks, tab, table_len, o, M, S, H, W,
                                 main_only, max_blocks, s)
          : launch<false, uint8_t>(planes, masks, tab, table_len, o, M, S, H,
                                   W, main_only, max_blocks, s));
}
