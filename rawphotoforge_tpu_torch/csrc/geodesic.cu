// The geodesic flood for Hopper (sm_90a): whole floods of the distance map
// d f32 [H, W], relaxed in place, in one launch.
//
// It replaces the lax.scan row sweeps of the JAX package's
// ops/masking.py:123-199 (geodesic_distance: _sweep_down over d, its flips
// and its transposes, four directions a round; jnp, no Pallas kernel). A
// down sweep is
//
//     d[y, x] = min(d[y, x], d[y - 1, x] + c[y, x])    for y = 1 .. H - 1,
//
// and up, right and left likewise; a round is down, up, right, left. The
// step costs: gv [H - 1, W] between vertical neighbours (down enters row y
// with gv[y - 1], up enters row y from y + 1 with gv[y]) and gh [H, W - 1]
// between horizontal ones. All three arrays come with rows P floats apart,
// P = W rounded up to a multiple of 4, 16-byte aligned (kernels/geodesic.py
// pads a copy where they are not).
//
// Design:
// - Chains. Each column (down, up) and each row (right, left) is a serial
//   chain. Down and then up on a column touch only that column, so one
//   thread walks its column down and straight back up, and a row right and
//   straight back left: the same adds and mins on each chain, in the
//   twin's order. A round is two phases, columns then rows.
// - One launch a flood. A grid of at most one resident wave runs every
//   phase, with a grid-wide barrier between phases: a hand-written
//   arrive/wait on a global counter (release and acquire at gpu scope), so
//   the build needs no relocatable device code (cooperative groups' grid
//   sync may). The grid is launched cooperatively all the same: the runtime
//   then refuses a grid whose blocks cannot all be resident at once, so the
//   barrier cannot wait forever on a block that never started. A wait that
//   outlasts any real flood traps, so a fault surfaces as an error.
// - Tiles in shared memory. A block owns a tile of 32 adjacent chains (32
//   columns or 32 rows); lane l of its warps takes chain l. The chains'
//   cells stream through shared memory in chunks of 32 cells, a ring of 5
//   chunks, by 16-byte cp.async copies and 16-byte stores (hence the pitch
//   P): an instruction of a warp moves 4 row segments of a column tile (32
//   columns each) or 4 rows' 32-cell segments of a row tile, so the row
//   phase reads and writes as coalesced as the column phase. A chunk is
//   [cell][chain] (pitch 32) for columns and [chain][cell] (pitch 36) for
//   rows: lane l reads its row's cells 4 at a time at l * 36 + 4q, in
//   distinct banks for the 8 lanes of a 16-byte access phase.
// - Three warps a block. Few tiles run at once (40 at MID), so nothing
//   hides a warp's latency, and the SM's memory instructions, not the
//   chain, set the pace (chip_smoke.py --geodesic-ab cuts each stage out),
//   so they are 16-byte where the layout allows and split over three
//   warps: the walker walks (a chunk's cells and costs into registers, the
//   32 dependent steps, the results back into the chunk), the copier
//   stages the chunk 3 visits ahead, the storer writes back the chunk
//   walked last; two block barriers a visit.
// - The turn. The forward walk's last 5 chunks stay in the ring with their
//   results and the backward walk starts on them; earlier chunks are read
//   back (from L2, where a MID flood's 17.5 MB lives).
// - Int32 indices: the wrapper refuses H * P >= 2^31.
//
// What bounds it on the card: not bytes (d, gv and gh read once and d
// written once are 16 B/px a flood: 17.5 MB, 0.0052 ms at MID at the H100
// SXM's 3.35 TB/s) but the dependent chain. A round walks each column 2 (H
// - 1) steps and each row 2 (W - 1), one dependent f32 add and one min a
// step, and the rows wait for every column: 4 rounds at MID 853x1280 are
// 17,048 dependent steps. ROADMAP.md B.1 rules out shortening it with an
// associative min-plus scan: it reassociates the adds, and the flood must
// equal the sequential twin bit for bit.
//
// Exactness: each step is one f32 add, then one min, in JAX's order
// (prev + c, then min(d, that)). The min is min.NaN: NaN when either
// operand is NaN, as torch.minimum and jnp.minimum give (fminf would drop
// it; the NaN's payload may differ, which the tests allow), else the
// smaller. With -fmad=false the kernel equals its torch twin
// (kernels/geodesic.py sweep_ref) bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

#include "wave.cuh"

namespace {

constexpr int kLanes = 32;                 // chains a tile: a warp's lanes
constexpr int kWalker = 0, kCopier = 1, kStorer = 2;  // the block's warps
constexpr int kThreads = 3 * 32;
constexpr int kChunk = 32;                 // cells a chunk
constexpr int kVecs = kChunk / 4;          // 16-byte moves a lane a chunk
constexpr int kColPitch = 32;              // floats between a column chunk's cells
constexpr int kRowPitch = 36;              // floats between a row chunk's chains
constexpr int kSlot = kLanes * kRowPitch;  // floats a chunk (either layout)
constexpr int kAhead = 3;                  // visits whose copies fly ahead
constexpr int kRing = kAhead + 2;          // + the chunk walked, + the one leaving
constexpr unsigned kMaxSpins = 1u << 26;   // x >= 32 ns: > 2 s at a barrier
// Dynamic shared memory: the ring, for d and for c.
constexpr size_t kSmem = 2 * kRing * kSlot * sizeof(float);

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

// min(a, b), NaN if either is NaN.
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// 16 bytes into shared dst: the first `bytes` (0..16) from src, zeros
// after (src is not read where bytes is 0).
__device__ __forceinline__ void copy16(float* dst, const float* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Every block arrives, then waits until `target` arrivals in all; the
// block's writes before it are visible to every block's reads after it.
__device__ void grid_barrier(unsigned* count, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
    atomicAdd(count, 1u);
    unsigned seen = 0, spins = 0;
    for (;;) {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(seen)
                   : "l"(count)
                   : "memory");
      if (seen >= target) break;
      if (++spins > kMaxSpins) __trap();
      __nanosleep(32);
    }
  }
  __syncthreads();
}

// A tile of chains, rows P floats apart in d and c. Column tile: cell i of
// chain k at d[i * P + k], its cost to cell i + 1 (i < n - 1) at c[i * P +
// k]; `room` = P - the tile's first column: its vectors stay in a row. Row
// tile: cell i of chain k at d[k * P + i], c[k * P + i].
struct Tile {
  float* d;
  const float* c;
  int P;
  int chains;  // valid chains, <= kLanes
  int n;       // cells a chain
  int room;
};

// A lane's 16-byte moves of chunk k: lane = 8a + q. Move it (0 .. 7) is,
// in a column tile, cell 32 k + 4 it + a, chains 4q .. 4q + 3, at (4 it + a)
// * 32 + 4q of the slot; in a row tile, chain 4 it + a, cells 32 k + 4q ..
// 32 k + 4q + 3, at (4 it + a) * 36 + 4q. Either way move it + 1 lies 4 P
// floats after move it in d and c.
template <bool kRows>
__device__ __forceinline__ int slot_offset(int lane) {
  return (lane >> 3) * (kRows ? kRowPitch : kColPitch) + 4 * (lane & 7);
}

template <bool kRows>
__device__ __forceinline__ int global_offset(const Tile& t, int k, int lane) {
  const int a = lane >> 3, q = lane & 7;
  return kRows ? a * t.P + k * kChunk + 4 * q : (k * kChunk + a) * t.P + 4 * q;
}

// Bytes of move it of chunk k to take from d (cost = false) or c (cost =
// true), zeros after: in a column tile whole vectors of cells < n (< n - 1
// for costs) inside the row; in a row tile chains < chains, cells < P (< n
// - 1 for costs, to the float).
template <bool kRows>
__device__ __forceinline__ int move_bytes(const Tile& t, int k, int it, int lane,
                                          bool cost) {
  const int a = lane >> 3, q = lane & 7;
  if (kRows) {
    if (4 * it + a >= t.chains) return 0;
    const int left = (cost ? t.n - 1 : t.P) - (k * kChunk + 4 * q);
    return left <= 0 ? 0 : (left >= 4 ? 16 : 4 * left);
  }
  const int cell = k * kChunk + 4 * it + a;
  return cell < (cost ? t.n - 1 : t.n) && 4 * q < t.room ? 16 : 0;
}

// The copier: chunk k of the tile into its ring slot (sd, sc).
template <bool kRows>
__device__ __forceinline__ void copy_chunk(const Tile& t, int k, float* sd, float* sc,
                                           int lane) {
  constexpr int kStep = 4 * (kRows ? kRowPitch : kColPitch);
  const int so = slot_offset<kRows>(lane);
  const int go = global_offset<kRows>(t, k, lane);
#pragma unroll
  for (int it = 0; it < kVecs; ++it) {
    const int bd = move_bytes<kRows>(t, k, it, lane, false);
    const int bc = move_bytes<kRows>(t, k, it, lane, true);
    const int g = go + it * 4 * t.P;
    copy16(sd + so + it * kStep, bd ? t.d + g : t.d, bd);
    copy16(sc + so + it * kStep, bc ? t.c + g : t.d, bc);
  }
}

// The storer: chunk k's results from its slot, then back to d.
template <bool kRows>
__device__ __forceinline__ void load_results(const float* sd, int lane,
                                             float4 (&v)[kVecs]) {
  constexpr int kStep = 4 * (kRows ? kRowPitch : kColPitch);
  const int so = slot_offset<kRows>(lane);
#pragma unroll
  for (int it = 0; it < kVecs; ++it)
    v[it] = *reinterpret_cast<const float4*>(sd + so + it * kStep);
}

template <bool kRows>
__device__ __forceinline__ void store_results(const Tile& t, int k, int lane,
                                              const float4 (&v)[kVecs]) {
  const int go = global_offset<kRows>(t, k, lane);
#pragma unroll
  for (int it = 0; it < kVecs; ++it) {
    if (move_bytes<kRows>(t, k, it, lane, false))
      *reinterpret_cast<float4*>(t.d + go + it * 4 * t.P) = v[it];
  }
}

// The walker: the lane walks its chain through a chunk (slot sd, sc) in
// registers, forward (each step the min, then the add of the cell's cost:
// the carry is the cell's value plus its cost) or backward (the add, then
// the min: the carry is the cell's value), all 32 cells, into dv. A
// backward walk of the chain's last chunk starts on cells past its end:
// they hold +inf, so they change nothing (forward, they come after the
// chain's cells).
template <bool kRows, bool kFwd>
__device__ __forceinline__ float walk(const float* sd, const float* sc, int lane,
                                      int len, float carry, float (&dv)[kChunk]) {
  float cv[kChunk];
  if (kRows) {
#pragma unroll
    for (int q = 0; q < kVecs; ++q) {
      const float4 a = *reinterpret_cast<const float4*>(sd + lane * kRowPitch + 4 * q);
      const float4 b = *reinterpret_cast<const float4*>(sc + lane * kRowPitch + 4 * q);
      dv[4 * q] = a.x, dv[4 * q + 1] = a.y, dv[4 * q + 2] = a.z, dv[4 * q + 3] = a.w;
      cv[4 * q] = b.x, cv[4 * q + 1] = b.y, cv[4 * q + 2] = b.z, cv[4 * q + 3] = b.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      dv[i] = sd[i * kColPitch + lane];
      cv[i] = sc[i * kColPitch + lane];
    }
  }
  if (!kFwd && len < kChunk) {
#pragma unroll
    for (int i = 0; i < kChunk; ++i)
      if (i >= len) dv[i] = inf();
  }
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    const int i = kFwd ? j : kChunk - 1 - j;
    if (kFwd) {
      dv[i] = min_nan(dv[i], carry);
      carry = dv[i] + cv[i];
    } else {
      dv[i] = min_nan(dv[i], carry + cv[i]);
      carry = dv[i];
    }
  }
  return carry;
}

template <bool kRows>
__device__ __forceinline__ void put_back(float* sd, int lane, const float (&dv)[kChunk]) {
  if (kRows) {
#pragma unroll
    for (int q = 0; q < kVecs; ++q)
      *reinterpret_cast<float4*>(sd + lane * kRowPitch + 4 * q) =
          make_float4(dv[4 * q], dv[4 * q + 1], dv[4 * q + 2], dv[4 * q + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < kChunk; ++i) sd[i * kColPitch + lane] = dv[i];
  }
}

// A tile's chains forward (cell 0 to n - 1), backward, or forward and
// straight back, by the block's three warps. Visits: the forward walk's
// chunks 0 .. m, then the backward walk's m .. 0, each in ring slot chunk %
// kRing; the backward walk's first kRing chunks are still resident from the
// forward walk. Two block barriers a visit: after the first, the visit's
// chunk is staged and the last one's results are in their slot; between
// the two, the walker walks in registers, the copier issues the copies of
// the chunk kAhead visits ahead and the storer loads the last chunk's
// results; after the second, the walker puts its results into the slot
// (which the storer may have been reading: at the turn the backward walk
// starts on the chunk the forward walk ended on) and the storer stores. A
// walk starts with an infinite carry (its first cell keeps its value; the
// cost staged past a chain's last cell is 0).
template <bool kRows>
__device__ void run_tile(const Tile& t, bool fwd, bool bwd, float* ring_d,
                         float* ring_c, int lane, int role) {
  const int nchunk = (t.n + kChunk - 1) / kChunk;
  const int nv = (static_cast<int>(fwd) + static_cast<int>(bwd)) * nchunk;
  auto forward = [&](int v) { return fwd && v < nchunk; };
  auto chunk = [&](int v) {
    return forward(v) ? v : (fwd ? 2 * nchunk - 1 - v : nchunk - 1 - v);
  };
  auto needs_copy = [&](int v) {
    return v < nv && (forward(v) || !fwd || chunk(v) < nchunk - kRing);
  };
  auto slot_d = [&](int k) { return ring_d + (k % kRing) * kSlot; };
  auto slot_c = [&](int k) { return ring_c + (k % kRing) * kSlot; };
  if (role == kCopier) {
    for (int v = 0; v < kAhead; ++v) {
      if (needs_copy(v)) copy_chunk<kRows>(t, chunk(v), slot_d(chunk(v)), slot_c(chunk(v)), lane);
      commit();
    }
  }
  float carry = inf();
  float dv[kChunk];
  float4 res[kVecs];
  for (int v = 0; v < nv; ++v) {
    const int k = chunk(v);
    if (role == kCopier) wait_pending<kAhead - 1>();
    __syncthreads();
    if (role == kWalker) {
      const int len = min(kChunk, t.n - k * kChunk);
      if (forward(v)) {
        carry = walk<kRows, true>(slot_d(k), slot_c(k), lane, len, carry, dv);
      } else {
        if (v == 0 || forward(v - 1)) carry = inf();
        carry = walk<kRows, false>(slot_d(k), slot_c(k), lane, len, carry, dv);
      }
    } else if (role == kCopier) {
      if (needs_copy(v + kAhead)) {
        const int next = chunk(v + kAhead);
        copy_chunk<kRows>(t, next, slot_d(next), slot_c(next), lane);
      }
      commit();
    } else if (v > 0) {
      load_results<kRows>(slot_d(chunk(v - 1)), lane, res);
    }
    __syncthreads();
    if (role == kWalker) {
      put_back<kRows>(slot_d(k), lane, dv);
    } else if (role == kStorer && v > 0) {
      store_results<kRows>(t, chunk(v - 1), lane, res);
    }
  }
  __syncthreads();
  if (role == kStorer && nv > 0) {
    load_results<kRows>(slot_d(chunk(nv - 1)), lane, res);
    store_results<kRows>(t, chunk(nv - 1), lane, res);
  }
  if (role == kCopier) wait_pending<0>();
  __syncthreads();
}

// `rounds` rounds of (columns down and up, rows right and left) when
// only < 0; else one direction (0 down, 1 up, 2 right, 3 left) once.
// `barrier`: one zeroed counter (unused for one direction).
__global__ void __launch_bounds__(kThreads)
geodesic_sweep_kernel(float* __restrict__ d, const float* __restrict__ gv,
                      const float* __restrict__ gh, int H, int W, int P, int rounds,
                      int only, unsigned* barrier) {
  extern __shared__ __align__(16) float smem[];
  float* ring_d = smem;
  float* ring_c = smem + kRing * kSlot;
  const int lane = threadIdx.x % 32, role = threadIdx.x / 32;
  const int phases = only < 0 ? 2 * rounds : 1;
  const bool fwd = only < 0 || only == 0 || only == 2;
  const bool bwd = only < 0 || only == 1 || only == 3;
  for (int p = 0; p < phases; ++p) {
    if (p > 0) grid_barrier(barrier, static_cast<unsigned>(p) * gridDim.x);
    const bool rows = only < 0 ? (p & 1) != 0 : only >= 2;
    if (!rows) {
      for (int x0 = blockIdx.x * kLanes; x0 < W; x0 += gridDim.x * kLanes) {
        const Tile t{d + x0, gv + x0, P, min(kLanes, W - x0), H, P - x0};
        run_tile<false>(t, fwd, bwd, ring_d, ring_c, lane, role);
      }
    } else {
      for (int y0 = blockIdx.x * kLanes; y0 < H; y0 += gridDim.x * kLanes) {
        const Tile t{d + y0 * P, gh + y0 * P, P, min(kLanes, H - y0), W, P};
        run_tile<true>(t, fwd, bwd, ring_d, ring_c, lane, role);
      }
    }
  }
}

}  // namespace

// d: f32 [H, W] relaxed in place, gv [H - 1, W], gh [H, W - 1], each with
// rows P floats apart (P >= W, a multiple of 4) and 16-byte aligned.
// only = -1: `rounds` rounds of down, up, right, left, one launch, with
// `barrier` one zeroed u32 (the grid barrier's counter); only = 0..3: that
// one direction (down, up, right, left) once. H * P < 2^31. Queued on
// `stream` without synchronizing; returns the launch's error (0 on
// success).
extern "C" int rpf_geodesic_flood_launch(void* d, const void* gv, const void* gh,
                                         int H, int W, int P, int rounds, int only,
                                         void* barrier, void* stream) {
  if (H <= 0 || W <= 0 || P < W || P % 4 || rounds <= 0 || only < -1 || only > 3 ||
      (only < 0 && barrier == nullptr) ||
      static_cast<int64_t>(H) * P >= (int64_t{1} << 31))
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(d) % 16 || reinterpret_cast<uintptr_t>(gv) % 16 ||
      reinterpret_cast<uintptr_t>(gh) % 16)
    return cudaErrorMisalignedAddress;
  int wave = 0;
  cudaError_t e = rpf::wave_blocks(geodesic_sweep_kernel, kThreads, kSmem, &wave);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int col_tiles = (W + kLanes - 1) / kLanes;
  const int row_tiles = (H + kLanes - 1) / kLanes;
  const int tiles = only < 0 ? (col_tiles > row_tiles ? col_tiles : row_tiles)
                             : (only < 2 ? col_tiles : row_tiles);
  const int grid = tiles < wave ? tiles : wave;
  float* dd = static_cast<float*>(d);
  const float* v = static_cast<const float*>(gv);
  const float* h = static_cast<const float*>(gh);
  unsigned* bar = static_cast<unsigned*>(barrier);
  void* args[] = {&dd, &v, &h, &H, &W, &P, &rounds, &only, &bar};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(geodesic_sweep_kernel),
                                  dim3(grid), dim3(kThreads), args, kSmem,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it: the caller raises on the value returned
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}
