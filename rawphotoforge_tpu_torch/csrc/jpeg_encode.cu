// The JPEG device wires for Hopper (sm_90a): three kernels that turn an sRGB
// render into the entropy-coded scan of a baseline JFIF 4:2:0 file.
//
// They replace the JAX package's io/jpegbits.py and the block stages of
// io/jpegenc.py (_block_stages, _prepacked_jit: jnp code, no Pallas kernel).
// The JAX wires are shaped by the TPU: Huffman lookups as select-sums, code
// strings as u32 (hi, lo) pairs, a 65-step pass over a [blocks, 53] word grid
// and stable 1-bit sorts to compact. On the card a thread can walk one block
// serially, so the design is one thread per 8x8 block for the entropy coding
// and a prefix sum (torch.cumsum, outside the kernels) for the offsets:
//
//  jpeg_blocks_kernel: one 384-thread block per 16x16 MCU, a thread per
//    coefficient of its six 8x8 blocks (Y tl, tr, bl, br, Cb, Cr). JFIF
//    YCbCr from f32 sRGB planes [3, H, W]; each sample at or beyond the true
//    extent (th, tw) is an edge replica (luma before the 4:2:0 subsample,
//    chroma after it); the 2x2 chroma sum times 0.25; rounding to the u8 grid
//    half to even; the level shift; the fDCT as rows then columns of
//    sequential 8-term sums in shared memory; the division by q, rounded
//    half away from zero; written in zigzag order as int16 [N, 64].
//  jpeg_huffman_kernel: one thread per block. The DC delta against the
//    previous TRUE block of the same component (padding blocks of a padded
//    grid are skipped, found by index arithmetic), then the block's baseline
//    bit string (DC category + magnitude, run/size AC symbols, ZRLs, EOB;
//    Annex K.3 tables) MSB-first into its own 52 u32 words (the worst case,
//    io/jpegbits.BLOCK_WORDS), zero-padded, and its bit length. Coefficients
//    outside the baseline domain (AC size > 10, DC delta size > 11) are
//    counted in `bad`, as the JAX wire counts them.
//  jpeg_pack_kernel: one thread per block. Packed: the block's words shifted
//    onto its exclusive global bit offset in the zeroed scan, atomicOr on its
//    first and last scan words (which neighbours share; OR commutes, so the
//    scan is deterministic), plain stores between. Prepacked: the block's
//    words copied to its exclusive word offset.
//
// What bounds them on the card: bytes. The blocks kernel reads 12 B/px of
// planes and writes 2 B a coefficient (~0.11 ms for 24 MP at 3.35 TB/s);
// the other two move the blocks, the bit strings and the scan. Simple first:
// the per-block scratch is written and read at a 208-byte stride, one
// thread per block, and chroma threads read their four RGB sources again.
//
// The build uses exact division and no multiply-add contraction, so
// jpeg_blocks_kernel equals its torch twin (io/jpegenc.py blockify) bit for
// bit; the other two compute integers.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockWords = 52;
// consts: D[u][x] (64), qlum and qchr in natural order (64 + 64), the JFIF
// matrix (9), all f32 from the host so the kernel's constants are the
// twin's.
constexpr int kConsts = 64 + 128 + 9;
// table: (code << 5) | len of DC lum (12), DC chr (12), AC lum (256),
// AC chr (256).
constexpr int kTable = 12 + 12 + 256 + 256;

__constant__ uint8_t kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

__device__ __forceinline__ float clamp01_255(float v) {
  return fminf(fmaxf(v, 0.0f), 1.0f) * 255.0f;
}

__device__ __forceinline__ float u8_grid(float v) {
  return fminf(fmaxf(rintf(v), 0.0f), 255.0f);
}

// One JFIF component (0 = Y, 1 = Cb, 2 = Cr) at pixel i, in the twin's
// operation order.
__device__ __forceinline__ float ycc(const float* __restrict__ planes,
                                     int64_t plane, int64_t i, int comp,
                                     const float* m) {
  const float r = clamp01_255(planes[i]);
  const float g = clamp01_255(planes[plane + i]);
  const float b = clamp01_255(planes[2 * plane + i]);
  const float* row = m + 3 * comp;
  if (comp == 0) return row[0] * r + row[1] * g + row[2] * b;
  return 128.0f + row[0] * r + row[1] * g + row[2] * b;
}

__global__ void __launch_bounds__(384)
jpeg_blocks_kernel(const float* __restrict__ planes, int H, int W, int th,
                   int tw, int mw, const float* __restrict__ consts,
                   int16_t* __restrict__ out) {
  __shared__ float c[kConsts];
  __shared__ float px[6][64];
  __shared__ float tmp[6][64];
  const int t = threadIdx.x;
  if (t < kConsts) c[t] = consts[t];
  __syncthreads();
  const float* D = c;
  const float* m = c + 192;
  const int64_t mcu = blockIdx.x;
  const int my = static_cast<int>(mcu / mw), mx = static_cast<int>(mcu % mw);
  const int k = t >> 6, p = t & 63, py = p >> 3, pxx = p & 7;
  const int64_t plane = static_cast<int64_t>(H) * W;
  float v;
  if (k < 4) {
    const int y = min(my * 16 + (k >> 1) * 8 + py, th - 1);
    const int x = min(mx * 16 + (k & 1) * 8 + pxx, tw - 1);
    v = u8_grid(ycc(planes, plane, static_cast<int64_t>(y) * W + x, 0, m));
  } else {
    const int cy = min(my * 8 + py, (th + 1) / 2 - 1);
    const int cx = min(mx * 8 + pxx, (tw + 1) / 2 - 1);
    const int y0 = min(2 * cy, th - 1), y1 = min(2 * cy + 1, th - 1);
    const int x0 = min(2 * cx, tw - 1), x1 = min(2 * cx + 1, tw - 1);
    const int comp = k - 3;
    const float s00 = ycc(planes, plane, static_cast<int64_t>(y0) * W + x0, comp, m);
    const float s01 = ycc(planes, plane, static_cast<int64_t>(y0) * W + x1, comp, m);
    const float s10 = ycc(planes, plane, static_cast<int64_t>(y1) * W + x0, comp, m);
    const float s11 = ycc(planes, plane, static_cast<int64_t>(y1) * W + x1, comp, m);
    v = u8_grid((((s00 + s01) + s10) + s11) * 0.25f);
  }
  px[k][p] = v - 128.0f;
  __syncthreads();
  {  // rows: tmp[y][u] = sum_x D[u][x] px[y][x]
    const int y = p >> 3, u = p & 7;
    float s = D[u * 8] * px[k][y * 8];
    for (int x = 1; x < 8; ++x) s = s + D[u * 8 + x] * px[k][y * 8 + x];
    tmp[k][p] = s;
  }
  __syncthreads();
  // columns: o[v][u] = sum_y D[v][y] tmp[y][u], for zigzag position p.
  const int nat = kZigzag[p];
  const int vv = nat >> 3, u = nat & 7;
  float o = D[vv * 8] * tmp[k][u];
  for (int y = 1; y < 8; ++y) o = o + D[vv * 8 + y] * tmp[k][y * 8 + u];
  const float rq = o / c[64 + (k < 4 ? 0 : 64) + nat];
  out[(mcu * 6 + k) * 64 + p] =
      static_cast<int16_t>(copysignf(floorf(fabsf(rq) + 0.5f), rq));
}

// Size category: the bit length of |v|.
__device__ __forceinline__ int bit_size(int v) {
  const unsigned a = static_cast<unsigned>(v < 0 ? -v : v);
  return a ? 32 - __clz(a) : 0;
}

// The s magnitude bits of v (one's complement of |v| for negative v).
__device__ __forceinline__ uint32_t magnitude(int v, int s) {
  return static_cast<uint32_t>(v < 0 ? v - 1 : v) & ((1u << s) - 1u);
}

// MSB-first bit emission into one block's words.
struct BitSink {
  uint32_t* w;
  uint64_t acc;
  int nacc, nw, bits;
  __device__ void put(uint32_t value, int n) {  // n <= 26
    acc = (acc << n) | value;
    nacc += n;
    bits += n;
    if (nacc >= 32) {
      nacc -= 32;
      w[nw++] = static_cast<uint32_t>(acc >> nacc);
      acc &= (1ull << nacc) - 1ull;
    }
  }
};

__global__ void __launch_bounds__(256)
jpeg_huffman_kernel(const int16_t* __restrict__ blocks, int64_t nblocks,
                    int grid_c, int mcu_r, int mcu_c,
                    const uint32_t* __restrict__ table,
                    uint32_t* __restrict__ words, int32_t* __restrict__ bits,
                    int32_t* __restrict__ bad_total) {
  __shared__ uint32_t tab[kTable];
  for (int i = threadIdx.x; i < kTable; i += blockDim.x) tab[i] = table[i];
  __syncthreads();
  const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= nblocks) return;
  uint32_t* w = words + b * kBlockWords;
  const int64_t mcu = b / 6;
  const int k = static_cast<int>(b % 6);
  const int64_t row = mcu / grid_c, col = mcu % grid_c;
  if (row >= mcu_r || col >= mcu_c) {  // a padding block: no bits
    bits[b] = 0;
    for (int j = 0; j < kBlockWords; ++j) w[j] = 0u;
    return;
  }
  // The previous true block of the same component: the luma chain runs
  // tl, tr, bl, br within an MCU; across MCUs (and for chroma) the chain
  // steps to the previous true MCU of the row, or the last true MCU of the
  // row above.
  int64_t prev = -1;
  if (k >= 1 && k <= 3) {
    prev = b - 1;
  } else {
    int64_t pm = -1;
    if (col > 0) pm = mcu - 1;
    else if (row > 0) pm = (row - 1) * grid_c + (mcu_c - 1);
    if (pm >= 0) prev = pm * 6 + (k == 0 ? 3 : k);
  }
  const int16_t* blk = blocks + b * 64;
  const int d = static_cast<int>(blk[0]) - (prev >= 0 ? static_cast<int>(blocks[prev * 64]) : 0);
  const bool chroma = k >= 4;
  BitSink sink{w, 0ull, 0, 0, 0};
  int bad = 0;
  const int s = bit_size(d);
  uint32_t e = 0u;
  if (s <= 11) e = tab[(chroma ? 12 : 0) + s]; else ++bad;
  sink.put(((e >> 5) << s) | magnitude(d, s), static_cast<int>(e & 31u) + s);
  const uint32_t* ac = tab + (chroma ? 280 : 24);
  const uint32_t zrl = ac[0xF0];
  int run = 0;
  for (int i = 1; i < 64; ++i) {
    const int v = blk[i];
    if (v == 0) { ++run; continue; }
    while (run > 15) {
      sink.put(zrl >> 5, static_cast<int>(zrl & 31u));
      run -= 16;
    }
    const int sz = bit_size(v);
    uint32_t a = 0u;
    if (sz <= 10) a = ac[(run << 4) | sz]; else ++bad;
    sink.put(((a >> 5) << sz) | magnitude(v, sz), static_cast<int>(a & 31u) + sz);
    run = 0;
  }
  if (run > 0) sink.put(ac[0] >> 5, static_cast<int>(ac[0] & 31u));  // EOB
  if (sink.nacc > 0)
    w[sink.nw++] = static_cast<uint32_t>(sink.acc << (32 - sink.nacc));
  for (int j = sink.nw; j < kBlockWords; ++j) w[j] = 0u;
  bits[b] = sink.bits;
  if (bad) atomicAdd(bad_total, bad);
}

__global__ void __launch_bounds__(256)
jpeg_pack_kernel(const uint32_t* __restrict__ words,
                 const int32_t* __restrict__ bits,
                 const int64_t* __restrict__ offsets, int64_t nblocks,
                 int packed, uint32_t* __restrict__ out) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= nblocks) return;
  const int nb = bits[b];
  if (nb == 0) return;
  const int nw = (nb + 31) >> 5;
  const uint32_t* w = words + b * kBlockWords;
  const int64_t off = offsets[b];
  if (!packed) {
    for (int j = 0; j < nw; ++j) out[off + j] = w[j];
    return;
  }
  const int64_t q = off >> 5;
  const int r = static_cast<int>(off & 31);
  const int last = static_cast<int>(((off + nb - 1) >> 5) - q);
  for (int j = 0; j <= last; ++j) {
    uint32_t v = j < nw ? w[j] >> r : 0u;
    if (r && j > 0) v |= w[j - 1] << (32 - r);
    if (j == 0 || j == last) atomicOr(out + q + j, v);
    else out[q + j] = v;
  }
}

int blocks_of(int64_t n) { return static_cast<int>((n + 255) / 256); }

}  // namespace

// planes: f32 [3, H, W]; (th, tw) the true extent (<= H, W); consts: the
// kConsts floats; out: int16 [6 * ceil(H/16) * ceil(W/16), 64]. Each launch
// is queued on `stream` without synchronizing and returns its
// cudaGetLastError() (0 on success).
extern "C" int rpf_jpeg_blocks_launch(const void* planes, int H, int W, int th,
                                      int tw, const void* consts, void* out,
                                      void* stream) {
  if (H <= 0 || W <= 0 || th <= 0 || tw <= 0 || th > H || tw > W)
    return cudaErrorInvalidValue;
  const int mh = (H + 15) / 16, mw = (W + 15) / 16;
  jpeg_blocks_kernel<<<static_cast<unsigned>(static_cast<int64_t>(mh) * mw),
                       384, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(planes), H, W, th, tw, mw,
      static_cast<const float*>(consts), static_cast<int16_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// blocks: int16 [nblocks, 64] (absolute DCs) over a grid of grid_c MCU
// columns, of which the first mcu_r rows and mcu_c columns are true; table:
// the kTable entries; words: u32 [nblocks, 52]; bits: int32 [nblocks];
// bad_total: one int32, zeroed by the caller.
extern "C" int rpf_jpeg_huffman_launch(const void* blocks, int64_t nblocks,
                                       int grid_c, int mcu_r, int mcu_c,
                                       const void* table, void* words,
                                       void* bits, void* bad_total,
                                       void* stream) {
  if (nblocks <= 0 || nblocks % 6 || grid_c <= 0 || mcu_c > grid_c ||
      mcu_r <= 0 || mcu_c <= 0)
    return cudaErrorInvalidValue;
  jpeg_huffman_kernel<<<blocks_of(nblocks), 256, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(blocks), nblocks, grid_c, mcu_r, mcu_c,
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
  if (nblocks <= 0) return cudaErrorInvalidValue;
  jpeg_pack_kernel<<<blocks_of(nblocks), 256, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const int32_t*>(bits),
      static_cast<const int64_t*>(offsets), nblocks, packed,
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
