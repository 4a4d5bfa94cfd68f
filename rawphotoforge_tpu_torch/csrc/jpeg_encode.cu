// The JPEG device wires for Hopper (sm_90a): three kernels that turn an sRGB
// render into the entropy-coded scan of a baseline JFIF 4:2:0 file.
//
// They replace the JAX package's io/jpegbits.py and the block stages of
// io/jpegenc.py (_block_stages, _prepacked_jit: jnp code, no Pallas kernel).
// The JAX wires are shaped by the TPU: Huffman lookups as select-sums, code
// strings as u32 (hi, lo) pairs, a 65-step pass over a [blocks, 53] word grid
// and stable 1-bit sorts to compact. Here the entropy coding is a warp per
// block, the block stage a persistent grid over MCU strips, and the offsets
// a prefix sum (torch.cumsum, outside the kernels):
//
//  jpeg_blocks_kernel: JFIF YCbCr from f32 sRGB planes [3, H, W] -> quantized
//    zigzag blocks int16 [N, 64] in MCU order (Y tl, tr, bl, br, Cb, Cr).
//    Each sample at or beyond the true extent (th, tw) is an edge replica
//    (luma before the 4:2:0 subsample, chroma after it); the 2x2 chroma sum
//    times 0.25; rounding to the u8 grid half to even; the level shift; the
//    fDCT as rows then columns of sequential 8-term sums; the division by q,
//    rounded half away from zero.
//    Design: one wave of 384-thread blocks walks chunks of 16 rows x 128
//    columns (8 MCUs of one strip). A block stages its constants (the fDCT
//    matrix, both q tables, the JFIF matrix, the zigzag order) in shared
//    memory once. A chunk's R, G, B rows are staged by cp.async,
//    double-buffered: the next chunk's copies fly while this one computes.
//    The copies are 16-byte where the row pitch allows it (W % 4 == 0) and
//    the chunk lies inside the true width, else 4-byte (a pitch of W * 4
//    bytes is off the 16-byte grid when W % 4 != 0): each path has test
//    frames of its own. The staged rows and columns are the clamped ones,
//    so the edge replicas cost nothing; a chunk wholly beyond the true
//    extent stages the last true pair of rows (columns), which serves both
//    its luma and its chroma replicas. Each pixel is converted to Y, Cb, Cr
//    once, in place; then a thread a sample builds the level-shifted blocks
//    (the chroma means from shared memory), a thread a block row computes
//    its 8 row sums, a thread a block column its 8 column sums and their
//    quantization into a zigzag-ordered shared copy, and the chunk's MCUs,
//    768 contiguous bytes each, leave in 16-byte stores. No tensor cores:
//    the twin's fixed summation order is the contract, and a TF32 or wgmma
//    fDCT would round otherwise, so every product and sum is an f32
//    operation of its own.
//  jpeg_huffman_kernel: a warp per block, in the twin's lane formulation
//    (io/jpegbits._lanes, _assemble); one wave of 6-warp blocks, each
//    coding one MCU at a time (warp k its block k, so a warp's component
//    and tables are fixed, and the MCU's grid row and column advance
//    without a division). The warp loads the block's 64 int16 in one
//    coalesced 128-byte load; lane l codes zigzag positions l and 32 + l.
//    A ballot over "nonzero" gives the block's 64-bit occupancy (the DC
//    always coded); a lane's zero run is the distance to the previous set
//    bit, its ZRLs (run / 16 of them) ride in front of its symbol, and the
//    EOB rides behind the last coded lane (the DC lane for an all-zero AC). The DC delta is taken against the previous TRUE block
//    of the same component (padding blocks of a padded grid are skipped,
//    found by index arithmetic). Each lane looks its codes up in a
//    shared-memory copy of the Annex K.3 tables; one shuffle scan of both
//    positions' lengths (packed in one int) gives each string's bit offset
//    and the block's bit length; the lanes OR their strings (the ZRLs, then
//    a body of <= 30 bits: all 32-bit arithmetic, each piece one or two
//    words) into the block's 52 words staged in shared memory, and
//    13 lanes store them, zero tail included, as 16-byte vectors into the
//    block's 208-byte slot (io/jpegbits.BLOCK_WORDS). Coefficients outside
//    the baseline domain (AC size > 10, DC delta size > 11) are counted in
//    `bad`, as the JAX wire counts them, one atomicAdd per warp.
//  jpeg_pack_kernel: 8 lanes a block (4 blocks a warp; a block of the scan
//    holds ~5 coded words at 24 MP q95, at most 52). Packed: the block's
//    words shifted onto its exclusive global bit offset in the zeroed scan,
//    the group reading them in one coalesced pass and forming each output
//    word with a funnel shift of its word and its left neighbour's (taken
//    by a shuffle); atomicOr on its first and last scan words (which
//    neighbours share; OR commutes, so the scan is deterministic), plain
//    stores between; longer blocks loop over the group. Prepacked: the
//    block's words copied to its exclusive word offset by the same groups.
//
// What bounds them on the card: bytes. The blocks kernel reads 12 B/px of
// planes and writes 2 B a coefficient (~0.11 ms for 24 MP at 3.35 TB/s);
// the Huffman kernel reads the blocks and writes the 208-byte slots, the
// pack kernel reads the slots' coded words and writes the scan (its call
// also zero-fills the N * 52 + 1 words the scan's contract holds).
//
// The build uses exact division and no multiply-add contraction, so
// jpeg_blocks_kernel equals its torch twin (io/jpegenc.py blockify) bit for
// bit; the other two compute integers.

#include <cstdint>
#include <cuda_runtime.h>

#include "wave.cuh"

namespace {

constexpr int kBlockWords = 52;
// consts: D[u][x] (64), qlum and qchr in natural order (64 + 64), the JFIF
// matrix (9), all f32 from the host so the kernel's constants are the
// twin's.
constexpr int kConsts = 64 + 128 + 9;
// table: (code << 5) | len of DC lum (12), DC chr (12), AC lum (256),
// AC chr (256).
constexpr int kTable = 12 + 12 + 256 + 256;
constexpr unsigned kFull = 0xFFFFFFFFu;

__constant__ uint8_t kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// -- jpeg_blocks_kernel ----------------------------------------------------------

constexpr int kBThreads = 384;                 // 3 threads a staged column
constexpr int kChunkMcus = 8;
constexpr int kChunkCols = 16 * kChunkMcus;   // 128
constexpr int kPlaneFloats = 16 * kChunkCols;  // one staged plane of a chunk
constexpr int kStageFloats = 3 * kPlaneFloats;
constexpr int kCoefs = 6 * 64 * kChunkMcus;   // a chunk's coefficients
constexpr int kTmpStride = 72;                // row-pass block stride (floats)
// Dynamic shared memory: two staging buffers and the level-shifted blocks.
// The row pass writes into the chunk's own staging buffer, whose converted
// samples are dead by then (at a block stride of 72 floats, so that the
// column reads of 4 blocks a warp fall in distinct banks); the quantized
// int16 blocks go into the level-shifted blocks' space for the copy-out.
constexpr size_t kBlocksSmem = sizeof(float) * (2 * kStageFloats + kCoefs);
static_assert(6 * kChunkMcus * kTmpStride <= kStageFloats, "tmp fits");
static_assert(kBThreads == 3 * kChunkCols && kBThreads == 6 * 64,
              "a thread's staged column and its block component are fixed");

__device__ __forceinline__ float clamp01_255(float v) {
  return fminf(fmaxf(v, 0.0f), 1.0f) * 255.0f;
}

__device__ __forceinline__ float u8_grid(float v) {
  return fminf(fmaxf(rintf(v), 0.0f), 255.0f);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// One chunk: MCU strip `my`, MCU columns [mx0, mx0 + nm). `pad_rows`: the
// strip lies wholly at or beyond the true height; `pad_cols`: the chunk at
// or beyond the true width.
struct Chunk {
  int my, mx0, nm, x0;
  bool pad_rows, pad_cols;
  __device__ Chunk(int chunk, int per_strip, int mw, int th, int tw) {
    my = chunk / per_strip;
    mx0 = (chunk - my * per_strip) * kChunkMcus;
    nm = min(kChunkMcus, mw - mx0);
    x0 = mx0 * 16;
    pad_rows = my * 16 >= th;
    pad_cols = x0 >= tw;
  }
};

// The source index staged at position j of a chunk along one axis: the
// clamped one, or, for a chunk wholly beyond the true extent n, the last
// true pair (2c - 2, min(2c - 1, n - 1)) with c = ceil(n / 2): position 1
// is n - 1 (the luma replica), positions 0 and 1 the sources of the last
// true chroma sample (the chroma replica).
__device__ __forceinline__ int staged_src(int j, int base, bool pad, int n) {
  if (!pad) return min(base + j, n - 1);
  const int c = (n + 1) >> 1;
  return (j & 1) ? min(2 * c - 1, n - 1) : 2 * c - 2;
}

// Stages a chunk's 48 plane rows (3 planes x 16 rows, clamped). `vec`:
// the planes and their row pitch are 16-byte aligned (W % 4 == 0); a chunk
// inside the true width then moves in 16-byte copies, 4 a thread. Else
// thread t copies column t % 128 of the rows t / 128 + 3i, 4 bytes each.
__device__ void stage_chunk(const float* __restrict__ planes, int64_t plane,
                            int W, int th, int tw, bool vec, const Chunk& k,
                            float* buf) {
  const int ncols = k.nm * 16;
  if (vec && !k.pad_cols && k.x0 + ncols <= tw) {
    for (int e = threadIdx.x; e < 48 * kChunkCols / 4; e += kBThreads) {
      const int q = e & (kChunkCols / 4 - 1), r = e / (kChunkCols / 4);
      if (4 * q >= ncols) continue;
      const int y = staged_src(r & 15, k.my * 16, k.pad_rows, th);
      cp_async16(buf + r * kChunkCols + 4 * q,
                 planes + (r >> 4) * plane + static_cast<int64_t>(y) * W + k.x0 + 4 * q);
    }
    return;
  }
  const int col = threadIdx.x & (kChunkCols - 1);
  if (col >= ncols) return;
  const float* src = planes + staged_src(col, k.x0, k.pad_cols, tw);
  for (int r = threadIdx.x >> 7; r < 48; r += 3) {
    const int y = staged_src(r & 15, k.my * 16, k.pad_rows, th);
    cp_async4(buf + r * kChunkCols + col,
              src + (r >> 4) * plane + static_cast<int64_t>(y) * W);
  }
}

__global__ void __launch_bounds__(kBThreads, 3)
jpeg_blocks_kernel(const float* __restrict__ planes, int H, int W, int th,
                   int tw, int mw, int nchunks, int vec,
                   const float* __restrict__ consts, int16_t* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(16) float c[kConsts];
  __shared__ uint8_t zpos[64];  // natural index -> zigzag position
  const int t = threadIdx.x;
  for (int i = t; i < kConsts; i += kBThreads) c[i] = consts[i];
  if (t < 64) zpos[kZigzag[t]] = static_cast<uint8_t>(t);
  const float4* D4 = reinterpret_cast<const float4*>(c);  // D[u][0..7]
  const float* m = c + 192;
  const int64_t plane = static_cast<int64_t>(H) * W;
  const int per_strip = (mw + kChunkMcus - 1) / kChunkMcus;
  const int ch = (th + 1) >> 1, cw = (tw + 1) >> 1;
  float* px = smem + 2 * kStageFloats;
  int16_t* quant = reinterpret_cast<int16_t*>(px);
  // This thread's staged column, and its sample of each MCU's blocks:
  // component comp (Y tl, tr, bl, br, Cb, Cr) at natural index p.
  const int col = t & (kChunkCols - 1);
  const int comp = t >> 6, p = t & 63, py = p >> 3, pxx = p & 7;

  int chunk = blockIdx.x;
  if (chunk < nchunks)
    stage_chunk(planes, plane, W, th, tw, vec, Chunk(chunk, per_strip, mw, th, tw),
                smem);
  cp_async_commit();
  for (int it = 0; chunk < nchunks; ++it, chunk += gridDim.x) {
    float* cur = smem + (it & 1) * kStageFloats;
    float* nxt = smem + ((it + 1) & 1) * kStageFloats;
    const Chunk k(chunk, per_strip, mw, th, tw);
    const int nblk = 6 * k.nm;
    cp_async_wait_all();
    __syncthreads();  // this chunk staged; the last chunk's reads done
    const int next = chunk + gridDim.x;
    if (next < nchunks)
      stage_chunk(planes, plane, W, th, tw, vec, Chunk(next, per_strip, mw, th, tw),
                  nxt);
    cp_async_commit();

    // Y, Cb, Cr of each staged pixel, in place, in the twin's order.
    if (col < 16 * k.nm) {
      for (int j = t >> 7; j < 16; j += 3) {
        float* q = cur + j * kChunkCols + col;
        const float r = clamp01_255(q[0]);
        const float g = clamp01_255(q[kPlaneFloats]);
        const float b = clamp01_255(q[2 * kPlaneFloats]);
        q[0] = m[0] * r + m[1] * g + m[2] * b;
        q[kPlaneFloats] = 128.0f + m[3] * r + m[4] * g + m[5] * b;
        q[2 * kPlaneFloats] = 128.0f + m[6] * r + m[7] * g + m[8] * b;
      }
    }
    __syncthreads();

    // The level-shifted samples of the chunk's blocks, natural order. The
    // chroma mean reads the last true chroma row and column at most.
    if (comp < 4) {
      const int j = k.pad_rows ? 1 : (comp >> 1) * 8 + py;
      const float* row = cur + j * kChunkCols;
      for (int mcu = 0; mcu < k.nm; ++mcu) {
        const int i = k.pad_cols ? 1 : mcu * 16 + (comp & 1) * 8 + pxx;
        px[mcu * 384 + t] = u8_grid(row[i]) - 128.0f;
      }
    } else {
      const int cy = k.pad_rows ? 0 : min(py, ch - 1 - k.my * 8);
      const int ccol = k.pad_cols ? 0 : cw - 1 - k.x0 / 2;
      const float* rows = cur + (comp - 3) * kPlaneFloats + 2 * cy * kChunkCols;
      for (int mcu = 0; mcu < k.nm; ++mcu) {
        const float* s = rows + 2 * (k.pad_cols ? 0 : min(mcu * 8 + pxx, ccol));
        px[mcu * 384 + t] =
            u8_grid((((s[0] + s[1]) + s[kChunkCols]) + s[kChunkCols + 1]) * 0.25f) -
            128.0f;
      }
    }
    __syncthreads();

    // Rows: thread (block t / 8, row t % 8) computes tmp[y][u] = sum_x
    // D[u][x] px[y][x] for u = 0..7, each a sequential 8-term sum.
    float* tmp = cur;
    const int blk = t >> 3, lane8 = t & 7;
    if (blk < nblk) {
      const float4* r4 = reinterpret_cast<const float4*>(px + blk * 64 + lane8 * 8);
      const float4 a = r4[0], b = r4[1];
      float o[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float4 d0 = D4[2 * u], d1 = D4[2 * u + 1];
        float s = d0.x * a.x;
        s = s + d0.y * a.y;
        s = s + d0.z * a.z;
        s = s + d0.w * a.w;
        s = s + d1.x * b.x;
        s = s + d1.y * b.y;
        s = s + d1.z * b.z;
        s = s + d1.w * b.w;
        o[u] = s;
      }
      float4* w4 = reinterpret_cast<float4*>(tmp + blk * kTmpStride + lane8 * 8);
      w4[0] = make_float4(o[0], o[1], o[2], o[3]);
      w4[1] = make_float4(o[4], o[5], o[6], o[7]);
    }
    __syncthreads();

    // Columns: thread (block t / 8, column u = t % 8) computes o[v][u] =
    // sum_y D[v][y] tmp[y][u] for v = 0..7, then the exact division by q
    // and the rounding half away from zero, into its zigzag slot.
    if (blk < nblk) {
      const float* colp = tmp + blk * kTmpStride + lane8;
      float x[8];
#pragma unroll
      for (int y = 0; y < 8; ++y) x[y] = colp[y * 8];
      const float* q = c + (blk % 6 < 4 ? 64 : 128);
      int16_t* dq = quant + blk * 64;
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        const float4 d0 = D4[2 * v], d1 = D4[2 * v + 1];
        float s = d0.x * x[0];
        s = s + d0.y * x[1];
        s = s + d0.z * x[2];
        s = s + d0.w * x[3];
        s = s + d1.x * x[4];
        s = s + d1.y * x[5];
        s = s + d1.z * x[6];
        s = s + d1.w * x[7];
        const int nat = v * 8 + lane8;
        const float rq = s / q[nat];
        dq[zpos[nat]] = static_cast<int16_t>(copysignf(floorf(fabsf(rq) + 0.5f), rq));
      }
    }
    __syncthreads();

    // The chunk's nm MCUs of int16 zigzag blocks, 768 bytes each, are
    // contiguous in the output: one 16-byte store a thread.
    if (t < 48 * k.nm)
      reinterpret_cast<uint4*>(out + static_cast<int64_t>(k.my * mw + k.mx0) * 384)[t] =
          reinterpret_cast<const uint4*>(quant)[t];
  }
  cp_async_wait_all();
}

// -- jpeg_huffman_kernel ---------------------------------------------------------

// A block of 6 warps codes one MCU at a time, warp k its block k (Y tl, tr,
// bl, br, Cb, Cr), so a warp's component and tables are fixed.
constexpr int kHWarps = 6;

// Size category: the bit length of |v|.
__device__ __forceinline__ int bit_size(int v) {
  const unsigned a = static_cast<unsigned>(v < 0 ? -v : v);
  return a ? 32 - __clz(a) : 0;
}

// The s magnitude bits of v (one's complement of |v| for negative v).
__device__ __forceinline__ uint32_t magnitude(int v, int s) {
  return static_cast<uint32_t>(v < 0 ? v - 1 : v) & ((1u << s) - 1u);
}

// A warp's component: its DC and AC tables ((code << 5) | len).
struct Coder {
  const uint32_t* dc;
  const uint32_t* ac;
};

// The body of zigzag position pos's string (pos 0 the DC, coded always;
// else a nonzero AC whose zero run follows the coded position prev): its
// (run, size) or DC size code, then the magnitude bits of v, <= 26 bits
// (the ZRLs of the run, run / 16 of them, go in front of it). Returns the
// body's length. An out-of-domain size (AC > 10, DC > 11) carries its
// magnitude bits only (<= 16), and counts in `bad`.
__device__ __forceinline__ int lane_body(int pos, int prev, int v,
                                         const Coder& cd, uint32_t& body,
                                         int& bad) {
  const int run = pos - prev - 1;
  const int sz = bit_size(v);
  uint32_t e = 0u;
  if (sz <= (pos ? 10 : 11))
    e = pos ? cd.ac[((run & 15) << 4) | sz] : cd.dc[sz];
  else
    ++bad;
  body = ((e >> 5) << sz) | magnitude(v, sz);
  return static_cast<int>(e & 31u) + sz;
}

// ORs the len (1..32) low bits of v at bit offset off (MSB-first) into the
// block's staged words: one or two words, a word only where its piece is
// not zero.
__device__ __forceinline__ void or_bits(uint32_t* w, uint32_t v, int len,
                                        int off) {
  const uint32_t u = v << (32 - len);  // left-aligned
  const int r = off & 31;
  uint32_t* p = w + (off >> 5);
  if (u >> r) atomicOr(p, u >> r);
  if (r + len > 32 && (u << (32 - r))) atomicOr(p + 1, u << (32 - r));
}

// A lane's string at bit offset off: z ZRLs, then its body.
__device__ __forceinline__ void or_string(uint32_t* w, int z, uint32_t zrl,
                                          int zrl_len, uint32_t body,
                                          int body_len, int off) {
  for (int i = 0; i < z; ++i, off += zrl_len) or_bits(w, zrl, zrl_len, off);
  or_bits(w, body, body_len, off);
}

__global__ void __launch_bounds__(32 * kHWarps)
jpeg_huffman_kernel(const int16_t* __restrict__ blocks, int nmcu, int grid_c,
                    int mcu_r, int mcu_c, const uint32_t* __restrict__ table,
                    uint32_t* __restrict__ words, int32_t* __restrict__ bits,
                    int32_t* __restrict__ bad_total) {
  __shared__ uint32_t tab[kTable];
  __shared__ __align__(16) uint32_t staged[kHWarps][kBlockWords];
  for (int i = threadIdx.x; i < kTable; i += blockDim.x) tab[i] = table[i];
  const int lane = threadIdx.x & 31, k = threadIdx.x >> 5;
  uint32_t* sw = staged[k];
  uint4* sw4 = reinterpret_cast<uint4*>(sw);
  for (int j = lane; j < kBlockWords; j += 32) sw[j] = 0u;
  __syncthreads();
  const bool chroma = k >= 4;
  const Coder cd{tab + (chroma ? 12 : 0), tab + (chroma ? 280 : 24)};
  const uint32_t zrl = cd.ac[0xF0] >> 5, eob = cd.ac[0] >> 5;
  const int zrl_len = static_cast<int>(cd.ac[0xF0] & 31u);
  const int eob_len = static_cast<int>(cd.ac[0] & 31u);
  const uint32_t below = (1u << lane) - 1u;  // the lanes before this one
  const uint32_t* pairs = reinterpret_cast<const uint32_t*>(blocks);
  int bad = 0;
  // The MCU's grid row and column, advanced by the grid's stride.
  int mcu = blockIdx.x;
  int row = mcu / grid_c, col = mcu - row * grid_c;
  const int drow = gridDim.x / grid_c, dcol = gridDim.x - drow * grid_c;
  for (; mcu < nmcu; mcu += gridDim.x) {
    const int b = mcu * 6 + k;
    uint4* dst = reinterpret_cast<uint4*>(words + static_cast<int64_t>(b) * kBlockWords);
    if (row >= mcu_r || col >= mcu_c) {  // a padding block: no bits
      if (lane < kBlockWords / 4) dst[lane] = make_uint4(0u, 0u, 0u, 0u);
      if (lane == 0) bits[b] = 0;
    } else {
      // The previous true block of the same component: the luma chain runs
      // tl, tr, bl, br within an MCU; across MCUs (and for chroma) the
      // chain steps to the previous true MCU of the row, or the last true
      // MCU of the row above.
      int prev = -1;
      if (k >= 1 && k <= 3) {
        prev = b - 1;
      } else {
        const int pm = col > 0 ? mcu - 1 : row > 0 ? (row - 1) * grid_c + mcu_c - 1 : -1;
        if (pm >= 0) prev = pm * 6 + (k == 0 ? 3 : k);
      }
      const int prev_dc =
          lane == 0 && prev >= 0 ? blocks[static_cast<int64_t>(prev) * 64] : 0;
      // Lane l holds zigzag positions 2l, 2l + 1 and codes l and 32 + l.
      const uint32_t pair = pairs[static_cast<int64_t>(b) * 32 + lane];
      const int half = (lane & 1) * 16;
      int va = static_cast<int16_t>(static_cast<uint16_t>(
          __shfl_sync(kFull, pair, lane >> 1) >> half));
      const int vb = static_cast<int16_t>(static_cast<uint16_t>(
          __shfl_sync(kFull, pair, 16 + (lane >> 1)) >> half));
      // Occupancy of positions 0..31 and 32..63; the DC is always coded.
      const uint32_t lo = __ballot_sync(kFull, va != 0) | 1u;
      const uint32_t hi = __ballot_sync(kFull, vb != 0);
      const int last = hi ? 63 - __clz(hi) : 31 - __clz(lo);
      if (lane == 0) va -= prev_dc;  // the DC delta

      // Each coded position's string: z ZRLs and a body (+ the EOB behind
      // the last coded position).
      uint32_t body_a = 0u, body_b = 0u;
      int z_a = 0, z_b = 0, blen_a = 0, blen_b = 0;
      if (lane == 0 || va != 0) {
        const int prev_a = 31 - __clz(lo & below);  // -1 for the DC
        z_a = (lane - prev_a - 1) >> 4;
        blen_a = lane_body(lane, prev_a, va, cd, body_a, bad);
      }
      if (vb != 0) {
        const uint32_t hb = hi & below;
        const int prev_b = hb ? 63 - __clz(hb) : 31 - __clz(lo);
        z_b = (32 + lane - prev_b - 1) >> 4;
        blen_b = lane_body(32 + lane, prev_b, vb, cd, body_b, bad);
      }
      if (last < 63) {
        if (last == lane) {
          body_a = (body_a << eob_len) | eob;
          blen_a += eob_len;
        } else if (last == 32 + lane) {
          body_b = (body_b << eob_len) | eob;
          blen_b += eob_len;
        }
      }
      const int len_a = z_a * zrl_len + blen_a, len_b = z_b * zrl_len + blen_b;

      // Bit offsets: one inclusive scan of both lengths (len_b << 16 |
      // len_a; a block's lengths sum to <= 1664 bits, so the halves never
      // carry).
      const int packed = (len_b << 16) | len_a;
      int inc = packed;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int up = __shfl_up_sync(kFull, inc, o);
        if (lane >= o) inc += up;
      }
      const int total = __shfl_sync(kFull, inc, 31);
      const int before = inc - packed;
      const int total_a = total & 0xFFFF;
      if (len_a) or_string(sw, z_a, zrl, zrl_len, body_a, blen_a, before & 0xFFFF);
      if (len_b)
        or_string(sw, z_b, zrl, zrl_len, body_b, blen_b, total_a + (before >> 16));
      __syncwarp();
      if (lane < kBlockWords / 4) {  // 13 lanes store the 208-byte slot
        dst[lane] = sw4[lane];
        sw4[lane] = make_uint4(0u, 0u, 0u, 0u);
      }
      if (lane == 0) bits[b] = total_a + (total >> 16);
      __syncwarp();
    }
    row += drow;
    col += dcol;
    if (col >= grid_c) {
      col -= grid_c;
      ++row;
    }
  }
  bad = __reduce_add_sync(kFull, bad);
  if (lane == 0 && bad) atomicAdd(bad_total, bad);
}

// -- jpeg_pack_kernel ------------------------------------------------------------

// A group of kPackLanes lanes a block, kPackGroups blocks a 256-thread CUDA
// block. Lane g of the group takes the block's output words g, g + 8, ...
// (packed: word j of the block's bits shifted onto its offset, j = 0 ..
// last, formed from its words j and j - 1: lane g's own and its left
// neighbour's, by a shuffle).
constexpr int kPackLanes = 8;
constexpr int kPackGroups = 256 / kPackLanes;

__global__ void __launch_bounds__(256)
jpeg_pack_kernel(const uint32_t* __restrict__ words,
                 const int32_t* __restrict__ bits,
                 const int64_t* __restrict__ offsets, int nblocks,
                 int packed, uint32_t* __restrict__ out) {
  const int b = blockIdx.x * kPackGroups + threadIdx.x / kPackLanes;
  const int g = threadIdx.x % kPackLanes;
  if (b >= nblocks) return;
  const int nb = bits[b];
  if (nb == 0) return;
  const int nw = (nb + 31) >> 5;
  const uint32_t* w = words + static_cast<int64_t>(b) * kBlockWords;
  const int64_t off = offsets[b];
  if (!packed) {
    uint32_t* o = out + off;
    for (int j = g; j < nw; j += kPackLanes) o[j] = w[j];
    return;
  }
  // The group's lanes (it returns or loops as one, so they are all here).
  const unsigned mask = 0xFFu << (threadIdx.x & 31 & ~(kPackLanes - 1));
  uint32_t* o = out + (off >> 5);
  const int r = static_cast<int>(off & 31);
  const int last = static_cast<int>((r + nb - 1) >> 5);
  uint32_t carry = 0u;  // word j - 1 for lane 0: the previous pass's lane 7
  for (int j0 = 0; j0 <= last; j0 += kPackLanes) {
    const int j = j0 + g;
    const uint32_t cur = j < nw ? w[j] : 0u;
    uint32_t left = __shfl_up_sync(mask, cur, 1, kPackLanes);
    if (g == 0) left = carry;
    carry = __shfl_sync(mask, cur, kPackLanes - 1, kPackLanes);
    // (left:cur) >> r: the bits of word j - 1 that spill into word j.
    const uint32_t v = __funnelshift_r(cur, left, r);
    if (j <= last) {
      if (j == 0 || j == last) atomicOr(o + j, v);
      else o[j] = v;
    }
  }
}

}  // namespace

// planes: f32 [3, H, W]; (th, tw) the true extent (<= H, W); consts: the
// kConsts floats; out: int16 [6 * ceil(H/16) * ceil(W/16), 64], 16-byte
// aligned. Each launch
// is queued on `stream` without synchronizing and returns its
// cudaGetLastError() (0 on success).
extern "C" int rpf_jpeg_blocks_launch(const void* planes, int H, int W, int th,
                                      int tw, const void* consts, void* out,
                                      void* stream) {
  if (H <= 0 || W <= 0 || th <= 0 || tw <= 0 || th > H || tw > W)
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(planes) % 4 || reinterpret_cast<uintptr_t>(out) % 16)
    return cudaErrorMisalignedAddress;
  const int mh = (H + 15) / 16, mw = (W + 15) / 16;
  const int64_t nchunks =
      static_cast<int64_t>(mh) * ((mw + kChunkMcus - 1) / kChunkMcus);
  if (nchunks > (int64_t{1} << 30)) return cudaErrorInvalidValue;
  int wave = 0;
  const cudaError_t e =
      rpf::wave_blocks(jpeg_blocks_kernel, kBThreads, kBlocksSmem, &wave);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int grid = static_cast<int>(nchunks < wave ? nchunks : wave);
  jpeg_blocks_kernel<<<grid, kBThreads, kBlocksSmem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(planes), H, W, th, tw, mw,
      static_cast<int>(nchunks),
      W % 4 == 0 && reinterpret_cast<uintptr_t>(planes) % 16 == 0,
      static_cast<const float*>(consts), static_cast<int16_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// blocks: int16 [nblocks, 64] (absolute DCs, 4-byte aligned) over a grid of
// grid_c MCU columns, of which the first mcu_r rows and mcu_c columns are
// true; table: the kTable entries; words: u32 [nblocks, 52], 16-byte aligned;
// bits: int32 [nblocks]; bad_total: one int32, zeroed by the caller.
extern "C" int rpf_jpeg_huffman_launch(const void* blocks, int64_t nblocks,
                                       int grid_c, int mcu_r, int mcu_c,
                                       const void* table, void* words,
                                       void* bits, void* bad_total,
                                       void* stream) {
  if (nblocks <= 0 || nblocks % 6 || nblocks > (int64_t{1} << 30) ||
      grid_c <= 0 || mcu_c > grid_c || mcu_r <= 0 || mcu_c <= 0)
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(blocks) % 4 ||
      reinterpret_cast<uintptr_t>(words) % 16)
    return cudaErrorMisalignedAddress;
  int wave = 0;
  const cudaError_t e =
      rpf::wave_blocks(jpeg_huffman_kernel, 32 * kHWarps, 0, &wave);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nmcu = static_cast<int>(nblocks / 6);
  jpeg_huffman_kernel<<<nmcu < wave ? nmcu : wave, 32 * kHWarps, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(blocks), nmcu, grid_c, mcu_r, mcu_c,
      static_cast<const uint32_t*>(table), static_cast<uint32_t*>(words),
      static_cast<int32_t*>(bits), static_cast<int32_t*>(bad_total));
  return static_cast<int>(cudaGetLastError());
}

// words/bits: the Huffman kernel's outputs; offsets: int64 [nblocks], the
// exclusive prefix sum of bits (packed) or of the word counts (prepacked);
// out: u32, zeroed by the caller when packed.
extern "C" int rpf_jpeg_pack_launch(const void* words, const void* bits,
                                    const void* offsets, int64_t nblocks,
                                    int packed, void* out, void* stream) {
  if (nblocks <= 0 || nblocks > (int64_t{1} << 30)) return cudaErrorInvalidValue;
  const int n = static_cast<int>(nblocks);
  jpeg_pack_kernel<<<(n + kPackGroups - 1) / kPackGroups, 256, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const int32_t*>(bits),
      static_cast<const int64_t*>(offsets), n, packed,
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
