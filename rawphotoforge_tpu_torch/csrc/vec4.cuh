// Four consecutive pixels of a row held in one float4: element access by a
// runtime index without local memory (selects), and 16-byte loads and
// stores with a scalar ragged edge. Shared by the develop and RAW kernels.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace rpf {

inline bool aligned(const void* p, uintptr_t n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

__device__ __forceinline__ float pick(const float4& v, int j) {
  return j == 0 ? v.x : (j == 1 ? v.y : (j == 2 ? v.z : v.w));
}

__device__ __forceinline__ void put(float4& v, int j, float x) {
  v.x = j == 0 ? x : v.x;
  v.y = j == 1 ? x : v.y;
  v.z = j == 2 ? x : v.z;
  v.w = j == 3 ? x : v.w;
}

// Up to 4 consecutive floats from p (n of them; the rest are 0).
__device__ __forceinline__ float4 load4(const float* __restrict__ p, bool full,
                                        int n) {
  if (full) return *reinterpret_cast<const float4*>(p);
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int j = 0; j < n; ++j) put(v, j, p[j]);
  return v;
}

__device__ __forceinline__ void store4(float* __restrict__ p, const float4& v,
                                       bool full, int n) {
  if (full) {
    *reinterpret_cast<float4*>(p) = v;
    return;
  }
  for (int j = 0; j < n; ++j) p[j] = pick(v, j);
}

}  // namespace rpf
