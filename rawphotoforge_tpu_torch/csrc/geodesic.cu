// The geodesic flood's directional sweep for Hopper (sm_90a): one raster
// relaxation of the distance map d f32 [H, W], in place.
//
// It replaces the lax.scan row sweeps of the JAX package's
// ops/masking.py:123-199 (geodesic_distance: _sweep_down over d, its flips
// and its transposes, four directions a round; jnp, no Pallas kernel). A
// down sweep is
//
//     d[y, x] = min(d[y, x], d[y - 1, x] + c[y, x])    for y = 1 .. H - 1,
//
// and up, right and left likewise. The step costs come unpadded: gv f32
// [H - 1, W] between vertical neighbours (down enters row y with gv[y - 1],
// up enters row y from y + 1 with gv[y]) and gh f32 [H, W - 1] between
// horizontal ones (right enters column x with gh[:, x - 1], left with
// gh[:, x]). The JAX package builds padded, flipped and transposed copies
// of them; here the index arithmetic does that.
//
// Design (a simple kernel that is right): each chain of the recurrence is
// serial, so one thread walks one chain. Down and up give one thread per
// column: a warp's loads and stores are coalesced, and the chain runs in a
// register. Right and left give one thread per row, strided across the
// warp. A thread loads kChunk steps of d and of the costs before it walks
// them (the loads do not wait on the chain), then stores them. Blocks are
// one warp, so the at most max(H, W) chains spread over as many SMs as they
// fill (1280 columns at MID: 40 warps on 132 SMs).
//
// What bounds it on the card: bytes — d and the costs read once and d
// written once, 12 B/px a sweep (1280x853 x 12 B ~ 0.0039 ms at the H100
// SXM's data-sheet 3.35 TB/s, a 700 W card).
// With so few chains and a dependent walk it runs far from that; an
// associative min-plus scan over the chain would be the redesign.
//
// Exactness: each step is one f32 add, then one min, in JAX's order
// (prev + c, then min(d, that)). The min treats NaN as torch.minimum and
// jnp.minimum do: a NaN operand propagates (fminf would drop it). With
// -fmad=false the kernel equals its torch twin (kernels/geodesic.py
// sweep_ref) bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 16;
constexpr int kThreads = 32;

// torch.minimum's rule on the card: the first NaN operand, else fminf.
__device__ __forceinline__ float min_nan(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fminf(a, b);
}

// One chain of `n` cells: cell k at d[base + k * stride], entered from cell
// k - 1 (walking forward) or k + 1 (backward) across the cost at
// cost[cbase + j * cstride], j the lower cell index of the pair.
__device__ __forceinline__ void walk(float* __restrict__ d,
                                     const float* __restrict__ cost,
                                     int64_t base, int64_t stride,
                                     int64_t cbase, int64_t cstride, int n,
                                     bool backward) {
  int k = backward ? n - 1 : 0;
  const int step = backward ? -1 : 1;
  float prev = d[base + k * stride];
  int remaining = n - 1;
  while (remaining > 0) {
    const int m = remaining < kChunk ? remaining : kChunk;
    float dv[kChunk], cv[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      if (i < m) {
        const int kk = k + step * (i + 1);
        dv[i] = d[base + kk * stride];
        cv[i] = cost[cbase + (backward ? kk : kk - 1) * cstride];
      }
    }
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      if (i < m) {
        prev = min_nan(dv[i], prev + cv[i]);
        dv[i] = prev;
      }
    }
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      if (i < m) d[base + (k + step * (i + 1)) * stride] = dv[i];
    }
    k += step * m;
    remaining -= m;
  }
}

// Down (up = false) or up: one thread per column.
__global__ void geodesic_sweep_cols(float* __restrict__ d,
                                    const float* __restrict__ gv, int H,
                                    int W, bool up) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= W) return;
  walk(d, gv, x, W, x, W, H, up);
}

// Right (left = false) or left: one thread per row.
__global__ void geodesic_sweep_rows(float* __restrict__ d,
                                    const float* __restrict__ gh, int H,
                                    int W, bool left) {
  const int y = blockIdx.x * blockDim.x + threadIdx.x;
  if (y >= H) return;
  walk(d, gh, static_cast<int64_t>(y) * W, 1,
       static_cast<int64_t>(y) * (W - 1), 1, W, left);
}

}  // namespace

// d: f32 [H, W], relaxed in place; cost: gv f32 [H - 1, W] for directions
// 0 (down) and 1 (up), gh f32 [H, W - 1] for 2 (right) and 3 (left). Queued
// on `stream` without synchronizing; returns cudaGetLastError() (0 on
// success).
extern "C" int rpf_geodesic_sweep_launch(void* d, const void* cost, int H,
                                         int W, int direction, void* stream) {
  if (H <= 0 || W <= 0 || direction < 0 || direction > 3)
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  float* dd = static_cast<float*>(d);
  const float* c = static_cast<const float*>(cost);
  if (direction < 2) {
    geodesic_sweep_cols<<<(W + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        dd, c, H, W, direction == 1);
  } else {
    geodesic_sweep_rows<<<(H + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        dd, c, H, W, direction == 3);
  }
  return static_cast<int>(cudaGetLastError());
}
