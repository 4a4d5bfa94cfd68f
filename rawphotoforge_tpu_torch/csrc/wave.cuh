// One wave of resident blocks: how many blocks of a kernel the card holds at
// once, which the launchers size their grids by. The runtime is asked once
// per device, kernel, block size and shared-memory size; later launches
// read the answer from a small table.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <mutex>
#include <vector>

namespace rpf {

// Blocks of `kernel` at `threads` threads and `smem` bytes of dynamic shared
// memory that fit on the current device at once, into *blocks. Where `smem`
// is over the default 48 KiB, the kernel's limit is raised to it first, so
// once per device like the query.
template <typename Kernel>
cudaError_t wave_blocks(Kernel kernel, int threads, size_t smem, int* blocks) {
  struct Known {
    int dev;
    const void* fn;
    int threads;
    size_t smem;
    int blocks;
  };
  static std::mutex mu;
  static std::vector<Known> known;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const void* fn = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> lock(mu);
  for (const Known& k : known) {
    if (k.dev == dev && k.fn == fn && k.threads == threads && k.smem == smem) {
      *blocks = k.blocks;
      return cudaSuccess;
    }
  }
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                      smem);
  if (e != cudaSuccess) return e;
  known.push_back({dev, fn, threads, smem, per_sm * sms});
  *blocks = per_sm * sms;
  return cudaSuccess;
}

}  // namespace rpf
