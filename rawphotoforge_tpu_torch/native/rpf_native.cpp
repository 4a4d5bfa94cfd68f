// rpf_native: the port's native host codecs, copied from the JAX
// package's native/rpf_native.cpp (the same source for these functions, so
// they give the same bytes): the lossless-JPEG scan decoder and bit packer
// behind io/ljpeg.py, the baseline JPEG 4:2:0 encoder behind
// io/jpegenc.py's dense wire and the stream assemblers of its device wires
// (sparse nibbles, prepacked and packed bits; io/jpegbits.py), the Sony
// ARW2 and Panasonic RAW4 decoders
// behind io/vendor_packed.py, the per-CFA-tile block means of
// engine/instant.py, and the host develop of engine/hostdev.py (the fused
// one-pass develop, the lens-distortion warp, the unsharp and the era
// mask selections), the 16-bit PNG row unfilter of io/image_io.py, and
// the JAX package's other host helpers (PCHIP LUT, resize, sRGB
// conversions, histogram, mask binarization).
// rawphotoforge_tpu_torch/native/__init__.py builds this file with g++ at
// first use and binds it with ctypes. The `#pragma omp` lines come with
// the copied code; the build has no -fopenmp, so they are ignored and
// those loops run on one thread.
//
// ABI: plain C, ctypes-friendly. All functions return 0 on success.

#include <cmath>
#include <cstdint>
#include <new>
#include <cstring>
#include <algorithm>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

extern "C" {

// Error codes.
enum {
  RPF_OK = 0,
  RPF_ERR_ARGS = 1,
  RPF_ERR_NOT_INCREASING = 2,
};

// ---------------------------------------------------------------------------
// Lossless-JPEG (ITU-T.81 process 14) scan decoding — the per-sample
// Huffman hot loop behind io/ljpeg.py. One call decodes one restart
// segment (already 0xFF00-unstuffed by the Python layer) into the shared
// output plane; prediction state resets at segment entry per T.81 F.2.1.3.
// Semantics oracle: the JAX package's io/ljpeg._decode_scan_py.
// ---------------------------------------------------------------------------

enum {
  RPF_ERR_BAD_HUFF = 3,
  RPF_ERR_TRUNCATED = 4,
};

namespace {

struct LjBitReader {
  const uint8_t* p;
  int64_t n;        // total bytes
  int64_t byte;     // next byte to load
  uint64_t cache;   // MSB-aligned bit cache
  int ncached;

  void fill() {
    if (byte + 8 <= n) {
      // Bulk refill: top up to a whole number of bytes from one load.
      uint64_t v;
      std::memcpy(&v, p + byte, 8);
#if defined(__GNUC__) || defined(__clang__)
      v = __builtin_bswap64(v);
#else
      v = ((v & 0xFFULL) << 56) | ((v & 0xFF00ULL) << 40) |
          ((v & 0xFF0000ULL) << 24) | ((v & 0xFF000000ULL) << 8) |
          ((v >> 8) & 0xFF000000ULL) | ((v >> 24) & 0xFF0000ULL) |
          ((v >> 40) & 0xFF00ULL) | (v >> 56);
#endif
      int k = (64 - ncached) >> 3;
      if (k) {
        uint64_t masked = (k >= 8) ? v : (v & (~0ULL << (64 - 8 * k)));
        cache |= masked >> ncached;
        byte += k;
        ncached += 8 * k;
      }
      return;
    }
    while (ncached <= 48) {
      uint64_t b = (byte < n) ? p[byte] : 0;  // zero-pad past end
      ++byte;
      cache |= b << (56 - ncached);
      ncached += 8;
    }
  }
  inline uint32_t peek16() {
    if (ncached < 16) fill();
    return static_cast<uint32_t>(cache >> 48);
  }
  inline void skip(int k) {
    cache <<= k;
    ncached -= k;
  }
  inline uint32_t get(int k) {
    if (k == 0) return 0;
    if (ncached < k) fill();
    uint32_t v = static_cast<uint32_t>(cache >> (64 - k));
    cache <<= k;
    ncached -= k;
    return v;
  }
};

}  // namespace

int rpf_ljpeg_decode_scan(
    const uint8_t* seg, int64_t seg_bytes,
    uint16_t* out,                 // [rows, mcus_per_row * ncomp]
    int rows, int mcus_per_row, int ncomp,
    const uint8_t* lut_sym,        // [ntab << 16] peek-16 symbol LUT
    const uint8_t* lut_len,        // [ntab << 16] peek-16 code lengths
    const uint8_t* comp_tab,       // [ncomp]
    int ntab,
    int predictor, int precision, int pt,
    int64_t mcu_start, int64_t mcu_count) {
  // The Huffman LUTs are built once per frame by the Python layer
  // (io/ljpeg._build_huffman_lut) and shared across restart segments.
  if (!seg || !out || !lut_sym || !lut_len || !comp_tab || rows <= 0 ||
      mcus_per_row <= 0 || ncomp <= 0 || ncomp > 4 || ntab <= 0 ||
      predictor < 1 || predictor > 7 || precision < 2 || precision > 16 ||
      pt < 0 || pt >= precision)
    return RPF_ERR_ARGS;
  // The ONLY write-bounds parameters: an out-of-range MCU window would be
  // a heap overflow, so it is validated here, not just in the Python
  // framing layer.
  const int64_t total_mcus =
      static_cast<int64_t>(rows) * mcus_per_row;
  if (mcu_start < 0 || mcu_count < 0 || mcu_start + mcu_count > total_mcus)
    return RPF_ERR_ARGS;

  LjBitReader br{seg, seg_bytes, 0, 0, 0};
  const int stride = mcus_per_row * ncomp;
  const int32_t dflt = 1 << (precision - pt - 1);
  bool seg_first[4] = {true, true, true, true};
  // T.81 H.1.2.1: the interval's first line predicts with 1-D Ra.
  const int first_row = static_cast<int>(mcu_start / mcus_per_row);
  int rc = RPF_OK;

  for (int64_t idx = mcu_start; idx < mcu_start + mcu_count; ++idx) {
    int row = static_cast<int>(idx / mcus_per_row);
    int col = static_cast<int>(idx % mcus_per_row);
    uint16_t* orow = out + static_cast<size_t>(row) * stride;
    for (int c = 0; c < ncomp; ++c) {
      const size_t toff = static_cast<size_t>(comp_tab[c]) << 16;
      uint32_t peek = br.peek16();
      int ssss = lut_sym[toff + peek];
      int ln = lut_len[toff + peek];
      if (ln == 0) return RPF_ERR_BAD_HUFF;
      br.skip(ln);
      int32_t diff;
      if (ssss == 16) {
        diff = 32768;
      } else if (ssss == 0) {
        diff = 0;
      } else {
        uint32_t v = br.get(ssss);
        diff = (v >= (1u << (ssss - 1)))
                   ? static_cast<int32_t>(v)
                   : static_cast<int32_t>(v) - (1 << ssss) + 1;
      }
      int x = col * ncomp + c;
      int32_t pred;
      if (seg_first[c]) {
        pred = dflt;
        seg_first[c] = false;
      } else if (row == first_row) {
        pred = orow[x - ncomp];  // 1-D Ra on the interval's first line
      } else if (col == 0) {
        pred = *(orow - stride + x);
      } else {
        int32_t ra = orow[x - ncomp];
        int32_t rb = *(orow - stride + x);
        int32_t rcn = *(orow - stride + x - ncomp);
        switch (predictor) {
          case 1: pred = ra; break;
          case 2: pred = rb; break;
          case 3: pred = rcn; break;
          case 4: pred = ra + rb - rcn; break;
          case 5: pred = ra + ((rb - rcn) >> 1); break;
          case 6: pred = rb + ((ra - rcn) >> 1); break;
          default: pred = (ra + rb) >> 1; break;
        }
      }
      orow[x] = static_cast<uint16_t>((pred + diff) & 0xFFFF);
    }
  }
  // Consumed more bits than the segment holds -> truncated stream.
  if (8 * br.byte - br.ncached > 8 * seg_bytes) rc = RPF_ERR_TRUNCATED;
  return rc;
}

// Lossless-JPEG bit packing (encoder hot loop): MSB-first concatenation
// of (value, nbits<=32) entries, final partial byte padded with 1s (the
// JPEG byte-align rule). Returns bytes written. Semantics oracle: the
// JAX package's io/ljpeg._pack_bits (numpy).
int64_t rpf_ljpeg_pack_bits(const int64_t* vals, const uint8_t* lens,
                            int64_t n, uint8_t* out) {
  if ((!vals || !lens || !out) && n > 0) return -1;
  uint64_t acc = 0;
  int nacc = 0;
  int64_t o = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int l = lens[i];
    if (l > 32) return -1;  // > code+extra width: acc << l would drop bits
    const uint64_t mask = (1ULL << l) - 1;
    acc = (acc << l) | (static_cast<uint64_t>(vals[i]) & mask);
    nacc += l;
    while (nacc >= 8) {
      out[o++] = static_cast<uint8_t>(acc >> (nacc - 8));
      nacc -= 8;
    }
  }
  if (nacc > 0) {
    const int pad = 8 - nacc;
    out[o++] = static_cast<uint8_t>(((acc << pad) | ((1u << pad) - 1)) & 0xFF);
  }
  return o;
}

// ---------------------------------------------------------------------------
// Baseline JPEG encoder (ITU T.81 SOF0, 4:2:0, JFIF) from planar YCbCr.
//
// Export hot path: the device converts sRGB -> YCbCr and 2x2-subsamples
// chroma (io/jpegenc.py), so the fetch moves 1.5 bytes/pixel; this
// encoder turns the fetched planes into a JFIF stream (fDCT, Annex K
// quantization tables scaled by quality, Annex K.3 Huffman tables —
// emitted in the DHT, so bitstream validity never depends on table
// choice). Replaces PIL in the batch-export path (the reference encodes
// via the `image` crate, image.rs:482-511).
// ---------------------------------------------------------------------------

namespace jpg {

// Natural order of each zigzag position (T.81 Figure 5 sequence).
static const uint8_t kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// Annex K.1 / K.2 base quantization tables (natural order).
static const int kQLum[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
static const int kQChr[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// Annex K.3 typical Huffman tables: BITS[16] then HUFFVAL.
static const uint8_t kDcLumBits[16] = {0, 1, 5, 1, 1, 1, 1, 1,
                                       1, 0, 0, 0, 0, 0, 0, 0};
static const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
static const uint8_t kDcChrBits[16] = {0, 3, 1, 1, 1, 1, 1, 1,
                                       1, 1, 1, 0, 0, 0, 0, 0};
static const uint8_t kAcLumBits[16] = {0, 2, 1, 3, 3, 2, 4, 3,
                                       5, 5, 4, 4, 0, 0, 1, 0x7d};
static const uint8_t kAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
static const uint8_t kAcChrBits[16] = {0, 2, 1, 2, 4, 4, 3, 4,
                                       7, 5, 4, 4, 0, 1, 2, 0x77};
static const uint8_t kAcChrVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct HuffTable {
  uint16_t code[256];
  uint8_t len[256];
};

// Canonical code assignment (T.81 Annex C).
static void build_huff(const uint8_t bits[16], const uint8_t* vals,
                       int nvals, HuffTable* t) {
  std::memset(t->len, 0, sizeof(t->len));
  uint16_t code = 0;
  int k = 0;
  for (int l = 1; l <= 16; ++l) {
    for (int i = 0; i < bits[l - 1]; ++i) {
      const uint8_t v = vals[k++];
      t->code[v] = code++;
      t->len[v] = static_cast<uint8_t>(l);
    }
    code <<= 1;
  }
  (void)nvals;
}

struct BitWriter {
  uint8_t* out;
  int64_t cap, pos;
  uint64_t acc;  // holds < 32 pending bits between put() calls
  int nacc;
  bool overflow;

  void put_byte(uint8_t b) {
    if (pos >= cap) { overflow = true; return; }
    out[pos++] = b;
  }
  // Entropy-coding hot path: callers combine a Huffman code and its
  // magnitude bits into ONE put of <= 27 bits (16 + 11). With the
  // nacc < 32 entry invariant the 64-bit accumulator never overflows,
  // and whole 32-bit gulps drain at once — a SWAR test finds the rare
  // 0xFF needing stuffing, so the common case is one bounds check and
  // a byteswapped 4-byte store per ~1.5 coefficients instead of
  // per-byte shift/compare/bounds work.
  inline void put(uint32_t value, int nbits) {
    acc = (acc << nbits) | (value & ((1u << nbits) - 1));
    nacc += nbits;
    if (nacc >= 32) {
      const uint32_t w = static_cast<uint32_t>(acc >> (nacc - 32));
      nacc -= 32;
      const uint32_t t = ~w;  // a 0xFF byte in w is a 0x00 byte in t
      if (((t - 0x01010101u) & ~t & 0x80808080u) == 0 && pos + 4 <= cap) {
        const uint32_t be = __builtin_bswap32(w);
        std::memcpy(out + pos, &be, 4);
        pos += 4;
      } else {
        for (int s = 24; s >= 0; s -= 8) {
          const uint8_t b = static_cast<uint8_t>(w >> s);
          put_byte(b);
          if (b == 0xFF) put_byte(0x00);  // byte stuffing
        }
      }
    }
  }
  void flush() {  // pad with 1s to a byte boundary, drain whole bytes
    if (nacc & 7) put((1u << (8 - (nacc & 7))) - 1, 8 - (nacc & 7));
    while (nacc >= 8) {
      const uint8_t b = static_cast<uint8_t>(acc >> (nacc - 8));
      put_byte(b);
      if (b == 0xFF) put_byte(0x00);
      nacc -= 8;
    }
  }
};

// Size category (number of magnitude bits) of a coefficient.
static inline int bit_size(int v) {
  const unsigned a = static_cast<unsigned>(v < 0 ? -v : v);
  return a ? 32 - __builtin_clz(a) : 0;
}

// Separable float fDCT with orthonormal scaling folded into quantization
// is overkill here; use the direct T.81 definition via a precomputed
// cos matrix: F[u] = C(u)/2 * sum_x f[x] cos((2x+1)u*pi/16).
struct DctConsts {
  float c[8][8];  // c[u][x] = C(u)/2 * cos((2x+1) u pi / 16)
  DctConsts() {
    for (int u = 0; u < 8; ++u) {
      const double kPi = 3.14159265358979323846;  // M_PI is POSIX-only
      const double cu = (u == 0) ? (1.0 / std::sqrt(2.0)) : 1.0;
      for (int x = 0; x < 8; ++x)
        c[u][x] = static_cast<float>(
            0.5 * cu * std::cos((2 * x + 1) * u * kPi / 16.0));
    }
  }
};
static const DctConsts kDct;

static void fdct8x8(const float in[64], float out[64]) {
  float tmp[64];
  for (int y = 0; y < 8; ++y)         // rows
    for (int u = 0; u < 8; ++u) {
      float s = 0;
      for (int x = 0; x < 8; ++x) s += kDct.c[u][x] * in[y * 8 + x];
      tmp[y * 8 + u] = s;
    }
  for (int u = 0; u < 8; ++u)         // columns
    for (int v = 0; v < 8; ++v) {
      float s = 0;
      for (int y = 0; y < 8; ++y) s += kDct.c[v][y] * tmp[y * 8 + u];
      out[v * 8 + u] = s;
    }
}

// Load an 8x8 block with edge clamping, level-shifted by -128.
static void load_block(const uint8_t* plane, int h, int w, int y0, int x0,
                       float out[64]) {
  for (int y = 0; y < 8; ++y) {
    const int sy = std::min(y0 + y, h - 1);
    const uint8_t* row = plane + static_cast<int64_t>(sy) * w;
    for (int x = 0; x < 8; ++x)
      out[y * 8 + x] = static_cast<float>(row[std::min(x0 + x, w - 1)]) - 128.0f;
  }
}

// fDCT + quantize + zigzag one block.
static void block_coeffs(const uint8_t* plane, int h, int w, int y0, int x0,
                         const uint16_t qtbl[64], int16_t zz[64]) {
  float px[64], fq[64];
  load_block(plane, h, w, y0, x0, px);
  fdct8x8(px, fq);
  for (int i = 0; i < 64; ++i) {
    const int nat = kZigzag[i];
    const float v = fq[nat] / static_cast<float>(qtbl[nat]);
    zz[i] = static_cast<int16_t>(std::lround(v));
  }
}

static void encode_block(BitWriter* bw, const int16_t zz[64], int* dc_pred,
                         const HuffTable& dc, const HuffTable& ac) {
  const int diff = zz[0] - *dc_pred;
  *dc_pred = zz[0];
  const int s = bit_size(diff);
  // Code + magnitude as ONE put (<= 16 + 11 bits): halves the put()
  // calls on the entropy-coding hot path.
  const uint32_t dmag =
      static_cast<uint32_t>(diff < 0 ? diff + (1 << s) - 1 : diff)
      & ((1u << s) - 1);
  bw->put((static_cast<uint32_t>(dc.code[s]) << s) | dmag, dc.len[s] + s);
  int run = 0;
  for (int i = 1; i < 64; ++i) {
    if (zz[i] == 0) { ++run; continue; }
    while (run > 15) {
      bw->put(ac.code[0xF0], ac.len[0xF0]);  // ZRL
      run -= 16;
    }
    const int sz = bit_size(zz[i]);
    const int sym = (run << 4) | sz;
    const uint32_t mag =
        static_cast<uint32_t>(zz[i] < 0 ? zz[i] + (1 << sz) - 1 : zz[i])
        & ((1u << sz) - 1);
    bw->put((static_cast<uint32_t>(ac.code[sym]) << sz) | mag,
            ac.len[sym] + sz);
    run = 0;
  }
  if (run > 0) bw->put(ac.code[0x00], ac.len[0x00]);  // EOB
}

static void scale_qtbl(const int base[64], int quality, uint16_t out[64]) {
  quality = std::max(1, std::min(100, quality));
  const int scale = quality < 50 ? 5000 / quality : 200 - 2 * quality;
  for (int i = 0; i < 64; ++i) {
    const int q = (base[i] * scale + 50) / 100;
    out[i] = static_cast<uint16_t>(std::max(1, std::min(255, q)));
  }
}

static void put_marker(BitWriter* bw, uint8_t m) {
  bw->put_byte(0xFF);
  bw->put_byte(m);
}

static void put_u16(BitWriter* bw, int v) {
  bw->put_byte(static_cast<uint8_t>(v >> 8));
  bw->put_byte(static_cast<uint8_t>(v & 0xFF));
}

// SOI through SOS for the one stream layout both encoders emit: JFIF,
// two DQTs, SOF0 4:2:0, the four Annex K.3 DHTs, 3-component scan.
static void write_headers(BitWriter* bw, int h, int w,
                          const uint16_t qlum[64], const uint16_t qchr[64]) {
  put_marker(bw, 0xD8);  // SOI
  put_marker(bw, 0xE0);  // APP0 / JFIF
  put_u16(bw, 16);
  const uint8_t jfif[14] = {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
  for (uint8_t b : jfif) bw->put_byte(b);
  for (int t = 0; t < 2; ++t) {  // DQT x2
    put_marker(bw, 0xDB);
    put_u16(bw, 67);
    bw->put_byte(static_cast<uint8_t>(t));
    const uint16_t* q = t == 0 ? qlum : qchr;
    for (int i = 0; i < 64; ++i)
      bw->put_byte(static_cast<uint8_t>(q[kZigzag[i]]));
  }
  put_marker(bw, 0xC0);  // SOF0
  put_u16(bw, 17);
  bw->put_byte(8);
  put_u16(bw, h);
  put_u16(bw, w);
  bw->put_byte(3);
  const uint8_t sof[9] = {1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1};
  for (uint8_t b : sof) bw->put_byte(b);
  struct {
    uint8_t cls_id;
    const uint8_t* bits;
    const uint8_t* vals;
    int n;
  } dht[4] = {
      {0x00, kDcLumBits, kDcVals, 12},
      {0x10, kAcLumBits, kAcLumVals, 162},
      {0x01, kDcChrBits, kDcVals, 12},
      {0x11, kAcChrBits, kAcChrVals, 162},
  };
  for (const auto& d : dht) {
    put_marker(bw, 0xC4);
    put_u16(bw, 2 + 1 + 16 + d.n);
    bw->put_byte(d.cls_id);
    for (int i = 0; i < 16; ++i) bw->put_byte(d.bits[i]);
    for (int i = 0; i < d.n; ++i) bw->put_byte(d.vals[i]);
  }
  put_marker(bw, 0xDA);  // SOS
  put_u16(bw, 12);
  bw->put_byte(3);
  const uint8_t sos[6] = {1, 0x00, 2, 0x11, 3, 0x11};
  for (uint8_t b : sos) bw->put_byte(b);
  bw->put_byte(0);
  bw->put_byte(63);
  bw->put_byte(0);
}

}  // namespace jpg

// y: [h, w] u8; cb, cr: [ceil(h/2), ceil(w/2)] u8 (JFIF 4:2:0 planes).
// Writes a complete JFIF stream into out (capacity out_cap); *out_len
// receives the byte count. Returns RPF_OK, RPF_ERR_ARGS, or 3 (overflow).
int rpf_jpeg_encode_ycc420(const uint8_t* y, const uint8_t* cb,
                           const uint8_t* cr, int h, int w, int quality,
                           uint8_t* out, int64_t out_cap, int64_t* out_len) {
  using namespace jpg;
  if (!y || !cb || !cr || !out || !out_len || h <= 0 || w <= 0 ||
      h > 65535 || w > 65535)  // SOF0 dimension fields are 16-bit
    return RPF_ERR_ARGS;
  const int ch = (h + 1) / 2, cw = (w + 1) / 2;

  uint16_t qlum[64], qchr[64];
  scale_qtbl(kQLum, quality, qlum);
  scale_qtbl(kQChr, quality, qchr);
  HuffTable dcl, dcc, acl, acc_;
  build_huff(kDcLumBits, kDcVals, 12, &dcl);
  build_huff(kDcChrBits, kDcVals, 12, &dcc);
  build_huff(kAcLumBits, kAcLumVals, 162, &acl);
  build_huff(kAcChrBits, kAcChrVals, 162, &acc_);

  BitWriter bw{out, out_cap, 0, 0, 0, false};
  write_headers(&bw, h, w, qlum, qchr);

  const int mcu_rows = (h + 15) / 16, mcu_cols = (w + 15) / 16;
  int pred_y = 0, pred_cb = 0, pred_cr = 0;
  int16_t zz[64];
  for (int my = 0; my < mcu_rows && !bw.overflow; ++my) {
    for (int mx = 0; mx < mcu_cols; ++mx) {
      for (int dy = 0; dy < 2; ++dy)
        for (int dx = 0; dx < 2; ++dx) {
          block_coeffs(y, h, w, my * 16 + dy * 8, mx * 16 + dx * 8, qlum, zz);
          encode_block(&bw, zz, &pred_y, dcl, acl);
        }
      block_coeffs(cb, ch, cw, my * 8, mx * 8, qchr, zz);
      encode_block(&bw, zz, &pred_cb, dcc, acc_);
      block_coeffs(cr, ch, cw, my * 8, mx * 8, qchr, zz);
      encode_block(&bw, zz, &pred_cr, dcc, acc_);
    }
  }
  bw.flush();
  put_marker(&bw, 0xD9);  // EOI
  if (bw.overflow) return 3;
  *out_len = bw.pos;
  return RPF_OK;
}

// Entropy-code a JFIF stream from the nibble wire's sparse quantized DCT
// coefficients (io/jpegenc.py `_sparsify`): per block a 64-bit nonzero
// presence bitmap over zigzag positions plus its nonzero values in
// ascending zigzag order, the DC slot holding the delta against the
// previous same-component block in MCU scan order (over the whole grid).
// The value stream arrives as packed 4-bit two's-complement nibbles (low
// nibble first; `nvalues` is the BYTE length of the packed stream) with
// 0x8 (-8) as the escape marker: escaped values are taken, in stream
// order, from the int16 `escapes` side channel.
//
// Padded grids: the coefficient arrays may cover a LARGER MCU grid
// (grid_mcu_rows x grid_mcu_cols) than the true image (h x w). The walk
// visits every grid block of the first ceil(h/16) MCU rows in device
// order — consuming its values and replaying its DC delta to keep the
// prediction chain aligned — but emits only blocks whose MCU column is
// inside the true image. Blocks are 6 per MCU (Y tl, tr, bl, br, Cb, Cr —
// the same walk rpf_jpeg_encode_ycc420 takes). counts[b] must equal
// popcount(bitmap[b]) and every coefficient must fit its baseline Huffman
// size category (<=11 bits DC, <=10 AC) — violations return RPF_ERR_ARGS
// rather than emitting undefined symbols.
int rpf_jpeg_encode_sparse(const uint8_t* counts, const uint32_t* bitmaps,
                           const uint8_t* values, int64_t nvalues,
                           const int16_t* escapes, int64_t nescapes, int h,
                           int w, int grid_mcu_rows, int grid_mcu_cols,
                           int quality, uint8_t* out, int64_t out_cap,
                           int64_t* out_len) {
  using namespace jpg;
  const int mcu_rows = (h + 15) / 16, mcu_cols = (w + 15) / 16;
  if (!counts || !bitmaps || !values || (!escapes && nescapes > 0) ||
      !out || !out_len || h <= 0 || w <= 0 || h > 65535 || w > 65535 ||
      grid_mcu_rows < mcu_rows || grid_mcu_cols < mcu_cols)
    return RPF_ERR_ARGS;

  uint16_t qlum[64], qchr[64];
  scale_qtbl(kQLum, quality, qlum);
  scale_qtbl(kQChr, quality, qchr);
  HuffTable dcl, dcc, acl, acc_;
  build_huff(kDcLumBits, kDcVals, 12, &dcl);
  build_huff(kDcChrBits, kDcVals, 12, &dcc);
  build_huff(kAcLumBits, kAcLumVals, 162, &acl);
  build_huff(kAcChrBits, kAcChrVals, 162, &acc_);

  BitWriter bw{out, out_cap, 0, 0, 0, false};
  write_headers(&bw, h, w, qlum, qchr);

  // chain[] accumulates absolute DCs over EVERY walked grid block (the
  // device's delta chain runs over the whole grid); pred[] tracks only
  // EMITTED blocks — encode_block recomputes the true image's own DC
  // differences from the reconstructed absolutes.
  int pred[3] = {0, 0, 0}, chain[3] = {0, 0, 0};
  int64_t cur = 0, ecur = 0;
  int16_t zz[64];
  // The walk ends right AFTER the last true-image block: the value stream
  // is fetched only up to that prefix (io/jpegenc), so the final row's
  // trailing padding columns — and all padding rows — must not be consumed.
  const int64_t nwalk =
      ((static_cast<int64_t>(mcu_rows - 1) * grid_mcu_cols) + mcu_cols) * 6;
  for (int64_t b = 0; b < nwalk && !bw.overflow; ++b) {
    const uint64_t bm = static_cast<uint64_t>(bitmaps[2 * b]) |
                        (static_cast<uint64_t>(bitmaps[2 * b + 1]) << 32);
    const int n = counts[b];
    if (n != __builtin_popcountll(bm) || cur + n > 2 * nvalues)
      return RPF_ERR_ARGS;
    std::memset(zz, 0, sizeof(zz));
    for (uint64_t m = bm; m; m &= m - 1) {
      const int64_t vi = cur++;
      // Packed low-nibble-first: sign-extend 4-bit two's complement.
      const int nib = (values[vi >> 1] >> ((vi & 1) * 4)) & 0xF;
      int16_t v;
      if (nib == 8) {  // escape: the true value rides the i16 stream
        if (ecur >= nescapes) return RPF_ERR_ARGS;
        v = escapes[ecur++];
      } else {
        v = static_cast<int16_t>(nib > 8 ? nib - 16 : nib);
      }
      const int i = __builtin_ctzll(m);
      // Baseline size categories: AC <= 10 bits; the DC slot holds a
      // delta, bounded below after accumulation.
      if (i != 0 && bit_size(v) > 10) return RPF_ERR_ARGS;
      zz[i] = v;
    }
    const int c6 = static_cast<int>(b % 6);
    const int comp = c6 <= 3 ? 0 : c6 - 3;
    // zz[0] is the device-computed delta; rebuild the absolute DC so
    // encode_block's own prediction recomputes the emitted delta. The
    // delta, the accumulated absolute, AND the emitted difference must all
    // fit the 11-bit DC category — validating only the delta would let
    // hostile wire data walk the accumulator past int16 and emit a
    // corrupt stream as RPF_OK.
    if (bit_size(zz[0]) > 11) return RPF_ERR_ARGS;
    chain[comp] += zz[0];
    if (bit_size(chain[comp]) > 11) return RPF_ERR_ARGS;
    const int64_t mcu = b / 6;
    if (mcu % grid_mcu_cols >= mcu_cols) continue;  // padding column
    if (bit_size(chain[comp] - pred[comp]) > 11) return RPF_ERR_ARGS;
    zz[0] = static_cast<int16_t>(chain[comp]);
    encode_block(&bw, zz, &pred[comp], comp ? dcc : dcl, comp ? acc_ : acl);
  }
  // The walk must consume the value stream exactly (callers pass the
  // trimmed (n+1)/2-byte prefix): a corrupted bitmap shifts the total
  // coefficient count and lands here instead of emitting a structurally
  // valid but wrong stream. (Skipped when the walk stopped early on output
  // overflow — that path must keep returning 3 so the caller can grow
  // the buffer and retry.)
  if (!bw.overflow && cur != 2 * nvalues && cur + 1 != 2 * nvalues)
    return RPF_ERR_ARGS;
  bw.flush();
  put_marker(&bw, 0xD9);  // EOI
  if (bw.overflow) return 3;
  *out_len = bw.pos;
  return RPF_OK;
}

// Assemble a JFIF stream from PREPACKED entropy bits (io/jpegbits.py
// `wire`): the device already Huffman-coded every block — DC size
// category + magnitude, run/size AC symbols, ZRLs, EOB, against the same
// Annex K.3 tables write_headers declares — into per-block MSB-first bit
// strings, each zero-padded to a whole number of u32 words and
// concatenated in MCU scan order (padding blocks carry lens[b] == 0 and
// occupy no words). The host's only job is shifting each block's bits
// onto the running (non-32-aligned) bit position and stuffing 0x00 after
// 0xFF scan bytes. lens[b] <= 1664 (the 52-word worst case
// io/jpegbits.BLOCK_WORDS bounds); the word stream must be consumed
// exactly — a mismatch means a corrupted fetch, returned as RPF_ERR_ARGS
// rather than an undecodable stream.
int rpf_jpeg_encode_prepacked(const uint16_t* lens, int64_t nblocks,
                              const uint32_t* words, int64_t nwords,
                              int h, int w, int quality, uint8_t* out,
                              int64_t out_cap, int64_t* out_len) {
  using namespace jpg;
  if (!lens || (!words && nwords > 0) || !out || !out_len || h <= 0 ||
      w <= 0 || h > 65535 || w > 65535 ||
      nblocks < static_cast<int64_t>((h + 15) / 16) * ((w + 15) / 16) * 6)
    return RPF_ERR_ARGS;

  uint16_t qlum[64], qchr[64];
  scale_qtbl(kQLum, quality, qlum);
  scale_qtbl(kQChr, quality, qchr);
  BitWriter bw{out, out_cap, 0, 0, 0, false};
  write_headers(&bw, h, w, qlum, qchr);

  int64_t cur = 0;
  for (int64_t b = 0; b < nblocks && !bw.overflow; ++b) {
    const int nb = lens[b];
    if (nb == 0) continue;  // padding block: not emitted
    if (nb > 1664) return RPF_ERR_ARGS;
    const int k = (nb + 31) / 32;
    if (cur + k > nwords) return RPF_ERR_ARGS;
    for (int j = 0; j < k - 1; ++j) {
      // BitWriter::put masks with (1u << nbits) - 1, UB at 32 — feed
      // whole words as two 16-bit halves.
      const uint32_t v = words[cur + j];
      bw.put(v >> 16, 16);
      bw.put(v & 0xFFFFu, 16);
    }
    const int rem = nb - 32 * (k - 1);
    const uint32_t last = words[cur + k - 1] >> (32 - rem);
    if (rem > 16) {
      bw.put(last >> 16, rem - 16);
      bw.put(last & 0xFFFFu, 16);
    } else {
      bw.put(last, rem);
    }
    cur += k;
  }
  if (!bw.overflow && cur != nwords) return RPF_ERR_ARGS;
  bw.flush();
  put_marker(&bw, 0xD9);  // EOI
  if (bw.overflow) return 3;
  *out_len = bw.pos;
  return RPF_OK;
}

// Assemble a JFIF stream from the PACKED scan (io/jpegbits.py
// `wire_packed`): the device already concatenated every block's Huffman
// bit string into ONE contiguous MSB-first stream, so the words ARE the
// finished scan. The host's whole job is headers, draining the words
// through the stuffing BitWriter (0x00 after 0xFF), padding the final
// partial byte with 1 bits, and EOI — byte-identical to the prepacked and
// sparse coders for the same coefficients by construction.
int rpf_jpeg_encode_packed(const uint32_t* words, int64_t nwords,
                           int64_t total_bits, int h, int w, int quality,
                           uint8_t* out, int64_t out_cap,
                           int64_t* out_len) {
  using namespace jpg;
  if ((!words && nwords > 0) || !out || !out_len || h <= 0 || w <= 0 ||
      h > 65535 || w > 65535 || total_bits < 0 ||
      nwords != (total_bits + 31) / 32)
    return RPF_ERR_ARGS;

  uint16_t qlum[64], qchr[64];
  scale_qtbl(kQLum, quality, qlum);
  scale_qtbl(kQChr, quality, qchr);
  BitWriter bw{out, out_cap, 0, 0, 0, false};
  write_headers(&bw, h, w, qlum, qchr);

  const int64_t full = total_bits / 32;
  for (int64_t j = 0; j < full && !bw.overflow; ++j) {
    // BitWriter::put masks with (1u << nbits) - 1, UB at 32 — feed whole
    // words as two 16-bit halves.
    const uint32_t v = words[j];
    bw.put(v >> 16, 16);
    bw.put(v & 0xFFFFu, 16);
  }
  const int rem = static_cast<int>(total_bits - 32 * full);
  if (rem > 0) {
    const uint32_t last = words[full] >> (32 - rem);
    if (rem > 16) {
      bw.put(last >> 16, rem - 16);
      bw.put(last & 0xFFFFu, 16);
    } else {
      bw.put(last, rem);
    }
  }
  bw.flush();
  put_marker(&bw, 0xD9);  // EOI
  if (bw.overflow) return 3;
  *out_len = bw.pos;
  return RPF_OK;
}


// ---------------------------------------------------------------------------
// Sony ARW2 block decode — the hot loop of io/vendor_packed.decode_arw2
// (the vectorized numpy decoder is the tested oracle; this mirrors it
// bit-for-bit at C speed; single-threaded in the port's build).
//   payload: >= width*height bytes (width % 32 == 0)
//   curve:   u16[4096] companding curve (sony_arw2_curve)
//   out:     u16 [height, width]
// ---------------------------------------------------------------------------

int rpf_arw2_decode(const uint8_t* payload, int64_t nbytes, int width,
                    int height, const uint16_t* curve, uint16_t* out) {
  if (!payload || !curve || !out || width <= 0 || height <= 0 ||
      width % 32 != 0 || nbytes < static_cast<int64_t>(width) * height)
    return RPF_ERR_ARGS;
  for (int row = 0; row < height; ++row) {
    // Row copy with 2 zero slack bytes: delta slot 14 (the degenerate
    // imax == imin case) reads past the last block; the oracle pads
    // each ROW with zeros, so the mirror must too (not read the next
    // row's bytes).
    std::vector<uint8_t> rb(static_cast<size_t>(width) + 2, 0);
    const uint8_t* src = payload + static_cast<int64_t>(row) * width;
    std::copy(src, src + width, rb.begin());
    uint16_t* orow = out + static_cast<int64_t>(row) * width;
    int col = 0;
    int dp = 0;
    while (col < width - 30) {
      uint32_t word = static_cast<uint32_t>(rb[dp]) |
                      (static_cast<uint32_t>(rb[dp + 1]) << 8) |
                      (static_cast<uint32_t>(rb[dp + 2]) << 16) |
                      (static_cast<uint32_t>(rb[dp + 3]) << 24);
      int vmax = word & 0x7ff;
      int vmin = (word >> 11) & 0x7ff;
      int imax = (word >> 22) & 0xf;
      int imin = (word >> 26) & 0xf;
      int sh = 0;
      while (sh < 4 && (0x80 << sh) <= vmax - vmin) ++sh;
      int bit = 30;
      for (int i = 0; i < 16; ++i, col += 2) {
        int pix;
        if (i == imax) {
          pix = vmax;
        } else if (i == imin) {
          pix = vmin;
        } else {
          int byte = dp + (bit >> 3);
          int w16 = rb[byte] | (rb[byte + 1] << 8);
          pix = (((w16 >> (bit & 7)) & 0x7f) << sh) + vmin;
          if (pix > 0x7ff) pix = 0x7ff;
          bit += 7;
        }
        orow[col] = curve[pix << 1];
      }
      col -= (col & 1) ? 1 : 31;
      dp += 16;
    }
  }
  return RPF_OK;
}

// ---------------------------------------------------------------------------
// Panasonic RAW4 bitstream decode — the sequential hot loop of
// io/vendor_packed.decode_pana_raw4 (dcraw pana_bits semantics; the
// Python decode_pana_raw4_py is the tested oracle, this is its
// bit-for-bit mirror at C speed for full-sensor files).
//   data: the raw payload (0x4000-byte blocks, rotated by 0x2008)
//   out:  u16 [height, width]
// Returns RPF_ERR_TRUNCATED when the stream ends before the last pixel.
// ---------------------------------------------------------------------------

int rpf_pana_decode_raw4(const uint8_t* data, int64_t nbytes, int width,
                         int height, uint16_t* out) {
  if (!data || !out || width <= 0 || height <= 0 || nbytes < 0)
    return RPF_ERR_ARGS;
  uint8_t buf[0x4001];
  std::memset(buf, 0, sizeof buf);
  int64_t pos = 0;
  int vbits = 0;
  bool truncated = false;
  auto get = [&](int nbits) -> int {
    if (vbits == 0) {
      if (pos >= nbytes) {
        truncated = true;
        return 0;
      }
      int64_t n = nbytes - pos;
      if (n > 0x4000) n = 0x4000;
      const int lf = 0x2008;  // PANA_LOAD_FLAGS block rotation
      std::memset(buf, 0, 0x4000);
      for (int64_t k = 0; k < n; ++k) {
        int64_t at = (k < 0x4000 - lf) ? lf + k : k - (0x4000 - lf);
        buf[at] = data[pos + k];
      }
      pos += 0x4000;
    }
    vbits = (vbits - nbits) & 0x1ffff;
    int byte = (vbits >> 3) & 0x3fff;
    int window = buf[byte] | (buf[byte + 1] << 8);
    return (window >> (vbits & 7)) & ((1 << nbits) - 1);
  };
  for (int row = 0; row < height; ++row) {
    int pred[2] = {0, 0}, nonz[2] = {0, 0}, sh = 0;
    uint16_t* orow = out + static_cast<int64_t>(row) * width;
    for (int col = 0; col < width; ++col) {
      int i = col % 14;
      if (i == 0) pred[0] = pred[1] = nonz[0] = nonz[1] = 0;
      if (i % 3 == 2) sh = 4 >> (3 - get(2));
      int p = i & 1;
      if (nonz[p]) {
        int j = get(8);
        if (j) {
          pred[p] -= 0x80 << sh;
          if (pred[p] < 0 || sh == 4) pred[p] &= ~(-1 << sh);
          pred[p] += j << sh;
        }
      } else {
        nonz[p] = get(8);
        if (nonz[p] || i > 11) pred[p] = (nonz[p] << 4) | get(4);
      }
      orow[col] = static_cast<uint16_t>(pred[p] & 0xffff);
    }
  }
  return truncated ? static_cast<int>(RPF_ERR_TRUNCATED)
                   : static_cast<int>(RPF_OK);
}

// ---------------------------------------------------------------------------
// Per-CFA-tile channel means of a u16 mosaic block, one row-major pass —
// the hot loop of the instant RAW preview (engine/instant.py
// quick_linear_from_raw). The numpy formulation needs ph*pw strided
// passes (36 for X-Trans: ~0.85 s at 24MP); this visits each input
// sample exactly once. out is filled with clip((mean - black)/span, 0, 1)
// per channel — matching the numpy path bit-for-bit up to f32 summation
// order (gated in tests).
//   t:    u16 [eh*ph, ew*pw] C-contiguous (a decimated or sliced mosaic)
//   tile: i32 [ph*pw] CFA channel (0/1/2) per site, row-major
//   out:  f32 [3, eh, ew]
// ---------------------------------------------------------------------------

int rpf_cfa_block_means(const uint16_t* t, int eh, int ew, int ph, int pw,
                        const int32_t* tile, float black, float span,
                        float* out) {
  if (!t || !tile || !out || eh <= 0 || ew <= 0 || ph <= 0 || pw <= 0 ||
      span <= 0.f)
    return RPF_ERR_ARGS;
  float counts[3] = {0.f, 0.f, 0.f};
  for (int i = 0; i < ph * pw; ++i) {
    if (tile[i] < 0 || tile[i] > 2) return RPF_ERR_ARGS;
    counts[tile[i]] += 1.f;
  }
  for (int c = 0; c < 3; ++c)
    if (counts[c] == 0.f) return RPF_ERR_ARGS;

  const int64_t plane = static_cast<int64_t>(eh) * ew;
  std::memset(out, 0, sizeof(float) * 3 * plane);
  const int64_t row_w = static_cast<int64_t>(ew) * pw;

  for (int by = 0; by < eh; ++by) {
    float* o0 = out + static_cast<int64_t>(by) * ew;
    float* o1 = o0 + plane;
    float* o2 = o1 + plane;
    float* planes_row[3] = {o0, o1, o2};
    for (int dy = 0; dy < ph; ++dy) {
      const uint16_t* row = t + (static_cast<int64_t>(by) * ph + dy) * row_w;
      const int32_t* trow = tile + dy * pw;
      for (int bx = 0; bx < ew; ++bx) {
        const uint16_t* cell = row + static_cast<int64_t>(bx) * pw;
        for (int dx = 0; dx < pw; ++dx) {
          planes_row[trow[dx]][bx] += static_cast<float>(cell[dx]);
        }
      }
    }
  }
  const float inv_span = 1.f / span;
  for (int c = 0; c < 3; ++c) {
    const float inv = 1.f / counts[c];
    float* p = out + static_cast<int64_t>(c) * plane;
    for (int64_t i = 0; i < plane; ++i) {
      float v = (p[i] * inv - black) * inv_span;
      p[i] = v < 0.f ? 0.f : (v > 1.f ? 1.f : v);
    }
  }
  return 0;
}


// ---------------------------------------------------------------------------
// Fused host-side develop: the whole post-geometry pixel chain (vignette ->
// per-mask WB/tone/brightness-LUT -> per-mask OKLCH hue/sat/light LUTs ->
// sRGB -> truncating u8) in ONE pass over the image. This is the *instant
// era* frame renderer (engine/hostdev.develop_np run ~5x faster): the numpy
// mirror walks ~50 full-image temporaries through memory; this touches each
// pixel once. Semantics mirror ops/develop.develop_post_geo
// (wgpu_shader.wgsl:265-337) exactly — same formula order, the same exact
// 65536-entry i32 LUT gathers, the same truncating u8 store
// (image.rs:375-383). Transcendentals are the kernels/ktrig.py polynomial
// family (Cephes atan2, Taylor sincos, bit-hack+Halley cbrt, and the
// x^(1/2.4) = cbrt(sqrt(sqrt(x^5))) sRGB pow), all within ~1e-7 of libm —
// far below one LUT step; the u8 output differs from the numpy mirror only
// by boundary-straddle flips of 1 (gated in tests/test_hostdev.py).
// ---------------------------------------------------------------------------

namespace {

__attribute__((always_inline)) inline float rpf_clampf(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// max(x, 0)^(1/3): exponent bit-hack seed + two Halley iterations
// (kernels/ktrig.cbrt_fast; ~1 ulp over the OKLab LMS domain).
__attribute__((always_inline)) inline float rpf_cbrt_fast(float x) {
  x = std::fabs(x > 0.0f ? x : 0.0f);
  int32_t i;
  std::memcpy(&i, &x, 4);
  i = i / 3 + 709921077;
  float y;
  std::memcpy(&y, &i, 4);
  // Two Halley iterations, hand-unrolled: a `for` here is control flow
  // the autovectorizer refuses to carry into the SIMD chunk loops.
  float y3 = y * y * y;
  y = y * (y3 + 2.0f * x) / (2.0f * y3 + x + 1e-30f);
  y3 = y * y * y;
  y = y * (y3 + 2.0f * x) / (2.0f * y3 + x + 1e-30f);
  return y;
}

constexpr float RPF_TWO_PI = 6.28318530718f;
constexpr float RPF_PI = 3.14159265359f;
constexpr float RPF_HALF_PI = 1.5707963267948966f;
constexpr float RPF_QUARTER_PI = 0.7853981633974483f;
constexpr float RPF_TAN_PI_8 = 0.41421356237309503f;

// atan2(y, x) / 2pi wrapped into [0, 1) (kernels/ktrig.atan2_turns:
// Cephes atanf reduction + odd polynomial, error ~1e-7 rad — one hue-LUT
// step is 9.6e-5 rad wide). Branch-free (ternaries become vector blends).
__attribute__((always_inline)) inline float rpf_atan2_turns(float yv, float xv) {
  float ax = std::fabs(xv), ay = std::fabs(yv);
  float hi = ax > ay ? ax : ay;
  float lo = ax > ay ? ay : ax;
  float t = lo / (hi > 1e-30f ? hi : 1e-30f);
  float tr = t > RPF_TAN_PI_8 ? (t - 1.0f) / (t + 1.0f) : t;
  float s = tr * tr;
  float p = ((8.05374449538e-2f * s - 1.38776856032e-1f) * s +
             1.99777106478e-1f) * s - 3.33329491539e-1f;
  float r = tr + tr * s * p;
  r = t > RPF_TAN_PI_8 ? r + RPF_QUARTER_PI : r;
  r = ay > ax ? RPF_HALF_PI - r : r;
  r = xv < 0.0f ? RPF_PI - r : r;
  r = yv < 0.0f ? -r : r;
  float h = r * (1.0f / RPF_TWO_PI);
  return h < 0.0f ? h + 1.0f : h;
}

// sin / cos of 2*pi*h for h in [0, 1] (kernels/ktrig.sincos_turns). Two
// pure functions instead of one with out-pointers: address-taken locals
// give the vectorizer "no vectype" and kill the whole SIMD loop; after
// inlining, CSE merges the shared reduction anyway.
__attribute__((always_inline)) inline float rpf_sin_turns(float h) {
  float k = std::floor(2.0f * h + 0.5f);
  float u = h - 0.5f * k;
  float sign = 1.0f - 2.0f * (k - 2.0f * std::floor(0.5f * k));
  float z = u * RPF_TWO_PI;
  float z2 = z * z;
  float sin_p = z * (1.0f + z2 * (-1.6666667163e-1f + z2 * (8.3333337680e-3f
      + z2 * (-1.9841270114e-4f + z2 * (2.7557314297e-6f
      + z2 * -2.5050759689e-8f)))));
  return sign * sin_p;
}

__attribute__((always_inline)) inline float rpf_cos_turns(float h) {
  float k = std::floor(2.0f * h + 0.5f);
  float u = h - 0.5f * k;
  float sign = 1.0f - 2.0f * (k - 2.0f * std::floor(0.5f * k));
  float z = u * RPF_TWO_PI;
  float z2 = z * z;
  float cos_p = 1.0f + z2 * (-0.5f + z2 * (4.1666667908e-2f
      + z2 * (-1.3888889225e-3f + z2 * (2.4801587642e-5f
      + z2 * (-2.7557314297e-7f + z2 * 2.0875723372e-9f)))));
  return sign * cos_p;
}

// sRGB OETF with x^(1/2.4) = x^(5/12) = cbrt(sqrt(sqrt(x^5)))
// (kernels/ktrig.linear_to_srgb_fast — exact exponent algebra).
__attribute__((always_inline)) inline float rpf_srgb_fast(float c) {
  float x = c > 0.0f ? c : 0.0f;
  float x5 = x * x;
  x5 = x5 * x5 * x;
  float hi = 1.055f * rpf_cbrt_fast(std::sqrt(std::sqrt(x5))) - 0.055f;
  return c <= 0.0031308f ? c * 12.92f : hi;  // branch-free: blends
}

// Exact i32 LUT gather: truncating index like numpy's astype(int32),
// table clamp to [0, 65535], then the slot's output scale.
__attribute__((always_inline)) inline float rpf_lut01(const int32_t* lut, float v, float inv_scale) {
  int idx = static_cast<int>(v * 65535.0f);
  idx = idx < 0 ? 0 : (idx > 65535 ? 65535 : idx);  // NaN cast lands at 0
  int32_t q = lut[idx];
  q = q < 0 ? 0 : (q > 65535 ? 65535 : q);
  return static_cast<float>(q) * inv_scale;
}

}  // namespace

// ---------------------------------------------------------------------------
// Era mask selections, native: OKLab similarity logits and the geodesic
// (Toivanen raster-sweep) smart-select distance — the per-click selection
// mirrors of engine/hostdev.similarity_logits_np / smart_logits_np (which
// mirror ops/masking). Same formula order; the only divergences from the
// numpy mirrors are cbrt (~1 ulp) and, for similarity, a separable
// exp(a)*exp(b) in place of exp(a+b) — both tolerance-gated in
// tests/test_hostdev.py.
// ---------------------------------------------------------------------------

namespace {

// Linear RGB [3, hw] -> OKLab planes (L, A, B), using the mats block's
// first 18 floats (M1 then M2, row-major — the core/color constants).
void rpf_oklab_planes(const float* planes, int64_t hw, const float* m1,
                      const float* m2, float* L, float* A, float* B) {
  const float* P0 = planes;
  const float* P1 = planes + hw;
  const float* P2 = planes + 2 * hw;
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < hw; ++i) {
    float r = P0[i], g = P1[i], b = P2[i];
    float l_ = rpf_cbrt_fast(m1[0] * r + m1[1] * g + m1[2] * b);
    float mm = rpf_cbrt_fast(m1[3] * r + m1[4] * g + m1[5] * b);
    float s_ = rpf_cbrt_fast(m1[6] * r + m1[7] * g + m1[8] * b);
    L[i] = m2[0] * l_ + m2[1] * mm + m2[2] * s_;
    A[i] = m2[3] * l_ + m2[4] * mm + m2[5] * s_;
    B[i] = m2[6] * l_ + m2[7] * mm + m2[8] * s_;
  }
}

}  // namespace

// OKLab-distance logits around the prompted pixel, optional Gaussian
// spatial falloff (hostdev.similarity_logits_np; ops/masking contract).
// mats18 = M1, M2 row-major.
int rpf_similarity_logits(const float* planes, int h, int w, int py, int px,
                          float tol, float sigma, const float* mats18,
                          float* out) {
  if (!planes || !out || !mats18 || h <= 0 || w <= 0 || py < 0 || py >= h ||
      px < 0 || px >= w)
    return RPF_ERR_ARGS;
  const int64_t hw = static_cast<int64_t>(h) * w;
  float* L = new (std::nothrow) float[hw * 3];
  if (!L) return RPF_ERR_ARGS;
  float* A = L + hw;
  float* B = L + 2 * hw;
  rpf_oklab_planes(planes, hw, mats18, mats18 + 9, L, A, B);
  const int64_t seed = static_cast<int64_t>(py) * w + px;
  const float L0 = L[seed], A0 = A[seed], B0 = B[seed];
  const float tolc = tol > 1e-6f ? tol : 1e-6f;

  // Separable spatial factors (exp(a + b) == exp(a) * exp(b) up to one
  // ulp; the numpy mirror evaluates the sum — tolerance-gated).
  float* ey = nullptr;
  float* ex = nullptr;
  if (sigma > 0.0f) {
    ey = new (std::nothrow) float[h + w];
    if (!ey) {
      delete[] L;
      return RPF_ERR_ARGS;
    }
    ex = ey + h;
    float s = sigma > 1.0f ? sigma : 1.0f;
    float inv2s2 = -0.5f / (s * s);
    for (int y = 0; y < h; ++y) {
      float d = static_cast<float>(y) - static_cast<float>(py);
      ey[y] = std::exp(d * d * inv2s2);
    }
    for (int x = 0; x < w; ++x) {
      float d = static_cast<float>(x) - static_cast<float>(px);
      ex[x] = std::exp(d * d * inv2s2);
    }
  }

#pragma omp parallel for schedule(static)
  for (int y = 0; y < h; ++y) {
    const float eyv = ey ? ey[y] : 0.0f;
    const int64_t row = static_cast<int64_t>(y) * w;
#pragma omp simd
    for (int x = 0; x < w; ++x) {
      int64_t i = row + x;
      float dl = L[i] - L0, da = A[i] - A0, db = B[i] - B0;
      float dist = std::sqrt(dl * dl + da * da + db * db);
      float lg = 1.0f - dist / tolc;
      if (ey) {
        float sp = eyv * ex[x];
        lg = lg * sp - (1.0f - sp);
      }
      out[i] = rpf_clampf(lg, -1.0f, 1.0f);
    }
  }
  delete[] ey;
  delete[] L;
  return RPF_OK;
}

// Edge-aware geodesic smart-select logits: Toivanen-style alternating
// raster sweeps of the OKLab-gradient distance transform, then
// clip(1 - d/tol, -1, 1) (hostdev.smart_logits_np / geodesic_distance_np:
// per sweep, down -> up -> right -> left, each relaxation reading the
// just-relaxed neighbor like the numpy in-place rows).
int rpf_geodesic_logits(const float* planes, int h, int w, int py, int px,
                        float edge_weight, float spatial_cost, int sweeps,
                        float tol, const float* mats18, float* out) {
  if (!planes || !out || !mats18 || h <= 0 || w <= 0 || py < 0 || py >= h ||
      px < 0 || px >= w || sweeps < 0 || sweeps > 64)
    return RPF_ERR_ARGS;
  const int64_t hw = static_cast<int64_t>(h) * w;
  // Layout: L/A/B planes, then the vertical [h-1, w] and horizontal
  // [h, w-1] step costs, then the distance field.
  float* L = new (std::nothrow) float[hw * 3];
  float* gv = new (std::nothrow) float[(h > 1 ? (h - 1) : 0) *
                                       static_cast<int64_t>(w) + 1];
  float* gh = new (std::nothrow) float[static_cast<int64_t>(h) *
                                       (w > 1 ? (w - 1) : 0) + 1];
  float* d = new (std::nothrow) float[hw];
  if (!L || !gv || !gh || !d) {
    delete[] L; delete[] gv; delete[] gh; delete[] d;
    return RPF_ERR_ARGS;
  }
  float* A = L + hw;
  float* B = L + 2 * hw;
  rpf_oklab_planes(planes, hw, mats18, mats18 + 9, L, A, B);

  // Step costs: |grad Lab| * edge_weight + spatial_cost along each axis.
  const int gw = w - 1;
#pragma omp parallel for schedule(static)
  for (int y = 0; y < h; ++y) {
    const int64_t row = static_cast<int64_t>(y) * w;
    if (y < h - 1) {
      float* gvr = gv + static_cast<int64_t>(y) * w;
#pragma omp simd
      for (int x = 0; x < w; ++x) {
        int64_t i = row + x;
        float dl = L[i + w] - L[i];
        float da = A[i + w] - A[i];
        float db = B[i + w] - B[i];
        gvr[x] = std::sqrt(dl * dl + da * da + db * db) * edge_weight +
                 spatial_cost;
      }
    }
    if (gw > 0) {
      float* ghr = gh + static_cast<int64_t>(y) * gw;
#pragma omp simd
      for (int x = 0; x < gw; ++x) {
        int64_t i = row + x;
        float dl = L[i + 1] - L[i];
        float da = A[i + 1] - A[i];
        float db = B[i + 1] - B[i];
        ghr[x] = std::sqrt(dl * dl + da * da + db * db) * edge_weight +
                 spatial_cost;
      }
    }
  }

  for (int64_t i = 0; i < hw; ++i) d[i] = 1e9f;
  d[static_cast<int64_t>(py) * w + px] = 0.0f;

  for (int s = 0; s < sweeps; ++s) {
    // Down: d[y] = min(d[y], d[y-1] + gv[y-1]) — rows in order, each
    // reading the just-relaxed previous row (the scan carry).
    for (int y = 1; y < h; ++y) {
      float* dr = d + static_cast<int64_t>(y) * w;
      const float* dp = dr - w;
      const float* c = gv + static_cast<int64_t>(y - 1) * w;
#pragma omp simd
      for (int x = 0; x < w; ++x) {
        float v = dp[x] + c[x];
        dr[x] = dr[x] < v ? dr[x] : v;
      }
    }
    // Up: d[y] = min(d[y], d[y+1] + gv[y]).
    for (int y = h - 2; y >= 0; --y) {
      float* dr = d + static_cast<int64_t>(y) * w;
      const float* dn = dr + w;
      const float* c = gv + static_cast<int64_t>(y) * w;
#pragma omp simd
      for (int x = 0; x < w; ++x) {
        float v = dn[x] + c[x];
        dr[x] = dr[x] < v ? dr[x] : v;
      }
    }
    // Right then left: sequential chains along x, rows independent.
    if (gw > 0) {
#pragma omp parallel for schedule(static)
      for (int y = 0; y < h; ++y) {
        float* dr = d + static_cast<int64_t>(y) * w;
        const float* c = gh + static_cast<int64_t>(y) * gw;
        for (int x = 1; x < w; ++x) {
          float v = dr[x - 1] + c[x - 1];
          if (v < dr[x]) dr[x] = v;
        }
        for (int x = w - 2; x >= 0; --x) {
          float v = dr[x + 1] + c[x];
          if (v < dr[x]) dr[x] = v;
        }
      }
    }
  }

  const float tolc = tol > 1e-6f ? tol : 1e-6f;
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < hw; ++i)
    out[i] = rpf_clampf(1.0f - d[i] / tolc, -1.0f, 1.0f);
  delete[] L; delete[] gv; delete[] gh; delete[] d;
  return RPF_OK;
}

// ---------------------------------------------------------------------------
// Era geometry stage, native: radial lens-distortion warp and unsharp mask
// over [3, H, W] f32. BIT-IDENTICAL mirrors of engine/hostdev.warp_np /
// unsharp_np (which mirror ops/geometry + ops/sharpen,
// wgpu_shader.wgsl:109-164): every operation is plain IEEE f32 arithmetic
// in the same order — no transcendentals — so outputs equal the numpy
// mirror exactly and the fused develop's input is unchanged by taking the
// native path.
// ---------------------------------------------------------------------------

// Radial warp; OOB pixels go black. strength = f32(-0.5 * distortion/100).
int rpf_warp_f32(const float* planes, int h, int w, float strength,
                 float* out) {
  if (!planes || !out || h <= 0 || w <= 0) return RPF_ERR_ARGS;
  const int64_t hw = static_cast<int64_t>(h) * w;
  const float hf = static_cast<float>(h), wf = static_cast<float>(w);
  const float aspect = wf / hf;

#pragma omp parallel for schedule(static)
  for (int y = 0; y < h; ++y) {
    const float v = static_cast<float>(y) / hf;
    const float cv = v - 0.5f;
    // Per-row staging so the coordinate math vectorizes; the bilinear
    // gather stays a scalar loop over the row.
    enum { WCHUNK = 256 };
    for (int x0c = 0; x0c < w; x0c += WCHUNK) {
      const int n = (w - x0c) < WCHUNK ? (w - x0c) : WCHUNK;
      int xi0[WCHUNK], yi0[WCHUNK], xi1[WCHUNK], yi1[WCHUNK];
      float txa[WCHUNK], tya[WCHUNK];
      uint8_t oob[WCHUNK];
#pragma omp simd
      for (int j = 0; j < n; ++j) {
        float u = static_cast<float>(x0c + j) / wf;
        float cu = (u - 0.5f) * aspect;
        float r2 = cu * cu + cv * cv;
        float denom = 1.0f + strength * r2;
        float fu = (cu / denom) / aspect + 0.5f;
        float fv = cv / denom + 0.5f;
        oob[j] = (fu < 0.0f) | (fu > 1.0f) | (fv < 0.0f) | (fv > 1.0f);
        float px = fu * (wf - 1.0f);
        float py = fv * (hf - 1.0f);
        float x0f = std::floor(px);
        float y0f = std::floor(py);
        // Match warp_np exactly: clip the i32 cast of the floor (the
        // cast of a huge/NaN float is UB in C, so clamp in float first
        // — OOB lanes are overwritten with 0 anyway).
        float x0cl = x0f < 0.0f ? 0.0f : x0f;
        x0cl = x0cl > wf - 1.0f ? wf - 1.0f : x0cl;
        float y0cl = y0f < 0.0f ? 0.0f : y0f;
        y0cl = y0cl > hf - 1.0f ? hf - 1.0f : y0cl;
        int xi = static_cast<int>(x0cl);
        int yi = static_cast<int>(y0cl);
        xi0[j] = xi;
        yi0[j] = yi;
        xi1[j] = xi + 1 < w - 1 ? xi + 1 : w - 1;
        yi1[j] = yi + 1 < h - 1 ? yi + 1 : h - 1;
        txa[j] = px - x0f;
        tya[j] = py - y0f;
      }
      for (int c = 0; c < 3; ++c) {
        const float* p = planes + c * hw;
        float* o = out + c * hw + static_cast<int64_t>(y) * w + x0c;
        for (int j = 0; j < n; ++j) {
          float tx = txa[j], ty = tya[j];
          float top = p[static_cast<int64_t>(yi0[j]) * w + xi0[j]]
                          * (1.0f - tx)
                      + p[static_cast<int64_t>(yi0[j]) * w + xi1[j]] * tx;
          float bot = p[static_cast<int64_t>(yi1[j]) * w + xi0[j]]
                          * (1.0f - tx)
                      + p[static_cast<int64_t>(yi1[j]) * w + xi1[j]] * tx;
          o[j] = oob[j] ? 0.0f : top * (1.0f - ty) + bot * ty;
        }
      }
    }
  }
  return RPF_OK;
}

// Separable-Gaussian unsharp mask: out = max(x + amount*(x - blur(x)), 0)
// over [3, H, W]; taps has 2*radius+1 entries. Padding mirrors numpy:
// reflect when the axis is longer than radius, edge-clamp otherwise.
static inline int rpf_reflect_idx(int i, int n, bool edge) {
  if (edge) return i < 0 ? 0 : (i >= n ? n - 1 : i);
  if (i < 0) return -i;
  if (i >= n) return 2 * n - 2 - i;
  return i;
}

int rpf_unsharp_f32(const float* planes, int h, int w, const float* taps,
                    int radius, float amount, float* out) {
  if (!planes || !out || !taps || h <= 0 || w <= 0 || radius < 0 ||
      radius > 64)
    return RPF_ERR_ARGS;
  const int64_t hw = static_cast<int64_t>(h) * w;
  const int nt = 2 * radius + 1;
  const bool edge_y = h <= radius, edge_x = w <= radius;
  float* tmp = new (std::nothrow) float[hw];
  if (!tmp) return RPF_ERR_ARGS;

  for (int c = 0; c < 3; ++c) {
    const float* src = planes + c * hw;
    float* dst = out + c * hw;
    // Vertical pass into tmp: accumulate taps in index order, exactly
    // like _blur_axis_np's `out += wgt * xp[slice]` chain.
#pragma omp parallel for schedule(static)
    for (int y = 0; y < h; ++y) {
      int idx[129] = {0};  // nt >= 1 always fills idx[0]; zero-init
                           // quiets gcc's maybe-uninitialized.
      for (int i = 0; i < nt; ++i)
        idx[i] = rpf_reflect_idx(y + i - radius, h, edge_y);
      float* trow = tmp + static_cast<int64_t>(y) * w;
      const float* r0 = src + static_cast<int64_t>(idx[0]) * w;
#pragma omp simd
      for (int x = 0; x < w; ++x) trow[x] = taps[0] * r0[x];
      for (int i = 1; i < nt; ++i) {
        const float* ri = src + static_cast<int64_t>(idx[i]) * w;
        const float wgt = taps[i];
#pragma omp simd
        for (int x = 0; x < w; ++x) trow[x] += wgt * ri[x];
      }
    }
    // Horizontal pass + combine.
#pragma omp parallel for schedule(static)
    for (int y = 0; y < h; ++y) {
      const float* trow = tmp + static_cast<int64_t>(y) * w;
      const float* srow = src + static_cast<int64_t>(y) * w;
      float* drow = dst + static_cast<int64_t>(y) * w;
      const int lo = radius, hi = w - radius;
      // Borders: reflected/clamped indices, scalar.
      for (int x = 0; x < w; ++x) {
        if (x >= lo && x < hi && !edge_x) continue;
        float acc = 0.0f;
        for (int i = 0; i < nt; ++i)
          acc += taps[i] * trow[rpf_reflect_idx(x + i - radius, w, edge_x)];
        float v = srow[x] + amount * (srow[x] - acc);
        drow[x] = v > 0.0f ? v : 0.0f;
      }
      if (edge_x) continue;
      // Interior: direct windows, vectorizes.
#pragma omp simd
      for (int x = lo; x < hi; ++x) {
        float acc = taps[0] * trow[x - radius];
        for (int i = 1; i < nt; ++i) acc += taps[i] * trow[x - radius + i];
        float v = srow[x] + amount * (srow[x] - acc);
        drow[x] = v > 0.0f ? v : 0.0f;
      }
    }
  }
  delete[] tmp;
  return RPF_OK;
}

// planes: [3, h, w] f32 post-warp/unsharp linear RGB. masks: [n_masks, h, w]
// f32 0/1 (row 0 never read; pass a dummy when n_masks == 1). mrow: per-mask
// f32[16]: 0-2 WB gains, 3 exp2(exposure), 4 contrast/100 (gate), 5
// shadow/100, 6 highlight/100, 7 black/100, 8 white/100, 9 brightness
// channel (-1 = LUT inactive, else 0/1/2/3), 10 reserved, 11 precomputed
// f32(1 + contrast/100), 12-15 reserved. lut_idx: i32[n_masks*4] rows into
// ``luts`` for (brightness, hue, sat, light), -1 = absent; a mask's three
// OKLCH rows are all present or all absent. mats: f32[39] = M1, M2, M2_INV,
// M1_INV row-major + (LUMA_R, LUMA_G, LUMA_B). vig_strength: the
// already-scaled f32((-vignette/100)*2), 0 = skip. out: u8 [h, w, 3].
int rpf_hostdev_develop(const float* planes, int h, int w, int n_masks,
                        const float* masks, const float* mrow,
                        const int32_t* lut_idx, const int32_t* luts,
                        int n_lut_rows, const float* mats,
                        float vig_strength, uint8_t* out) {
  if (!planes || !mrow || !lut_idx || !mats || !out || h <= 0 || w <= 0 ||
      n_masks < 1 || (n_masks > 1 && !masks) || (n_lut_rows > 0 && !luts))
    return RPF_ERR_ARGS;
  for (int k = 0; k < n_masks * 4; ++k)
    if (lut_idx[k] >= n_lut_rows || lut_idx[k] < -1) return RPF_ERR_ARGS;

  const int64_t hw = static_cast<int64_t>(h) * w;
  const float* P0 = planes;
  const float* P1 = planes + hw;
  const float* P2 = planes + 2 * hw;
  const float* m1 = mats;        // linear sRGB -> LMS
  const float* m2 = mats + 9;    // cbrt(LMS) -> OKLab
  const float* m2i = mats + 18;  // OKLab -> cbrt(LMS)
  const float* m1i = mats + 27;  // LMS -> linear sRGB
  const float lum_r = mats[36], lum_g = mats[37], lum_b = mats[38];

  bool any_oklch = false;
  for (int k = 0; k < n_masks; ++k) any_oklch |= (lut_idx[k * 4 + 1] >= 0);

  const float hf = static_cast<float>(h), wf = static_cast<float>(w);

  // Chunked structure: each stage is a short, branch-free loop over a
  // stack-resident chunk so the autovectorizer turns it into SIMD; LUT
  // gathers stay scalar loops over the same chunk. Per-mask uniform
  // conditions (contrast on? which channels take the brightness curve?)
  // hoist out of the lane loops as scalars feeding blends.
  enum { CHUNK = 256 };

#pragma omp parallel for schedule(static)
  for (int y = 0; y < h; ++y) {
    const float cy = (static_cast<float>(y) / hf - 0.5f) * 1.5f;
    for (int x0 = 0; x0 < w; x0 += CHUNK) {
      const int n = (w - x0) < CHUNK ? (w - x0) : CHUNK;
      const int64_t base = static_cast<int64_t>(y) * w + x0;
      float R[CHUNK], G[CHUNK], B[CHUNK];

      if (vig_strength != 0.0f) {  // ops/pointwise.vignette (wgsl:166-178)
        const float cy2 = cy * cy;
#pragma omp simd
        for (int j = 0; j < n; ++j) {
          float cx = (static_cast<float>(x0 + j) / wf - 0.5f) * 1.5f;
          float dist = std::sqrt(cx * cx + cy2);
          float t = rpf_clampf((dist - 0.25f) / 0.75f, 0.0f, 1.0f);
          float gain = rpf_clampf(1.0f - vig_strength * (t * std::sqrt(t)),
                                  0.0f, 4.0f);
          R[j] = P0[base + j] * gain;
          G[j] = P1[base + j] * gain;
          B[j] = P2[base + j] * gain;
        }
      } else {
#pragma omp simd
        for (int j = 0; j < n; ++j) {
          R[j] = P0[base + j];
          G[j] = P1[base + j];
          B[j] = P2[base + j];
        }
      }

      // Per-mask linear pass over the RUNNING values: WB -> tone ->
      // brightness LUT (develop_post_geo's first loop; unselected lanes
      // keep the running value, selected ones take the mask's output).
      for (int k = 0; k < n_masks; ++k) {
        const float* m = mrow + k * 16;
        const float* mk = k > 0 ? masks + k * hw + base : nullptr;
        const float has_contrast = m[4] != 0.0f ? 1.0f : 0.0f;
        const float cmul = m[11];
        float RK[CHUNK], GK[CHUNK], BK[CHUNK];
#pragma omp simd
        for (int j = 0; j < n; ++j) {
          float rk = R[j] * m[0], gk = G[j] * m[1], bk = B[j] * m[2];
          rk *= m[3];
          gk *= m[3];
          bk *= m[3];
          float yy = lum_r * rk + lum_g * gk + lum_b * bk;
          float sg = 1.0f + m[5] * rpf_clampf(1.0f - yy, 0.0f, 1.0f);
          float hg = 1.0f + m[6] * rpf_clampf(yy, 0.0f, 1.0f);
          rk *= sg * hg;
          gk *= sg * hg;
          bk *= sg * hg;
          float t = rpf_clampf(yy, 0.0f, 1.0f);
          // black/white lifts apply unconditionally: when the slider is 0
          // the lift is exactly +0.0f (identity up to -0.0, which the
          // clamp below erases) — matching develop_np's skipped branch.
          float lift = m[7] * ((1.0f - t) * (1.0f - t)) + m[8] * (t * t);
          rk += lift;
          gk += lift;
          bk += lift;
          // Contrast must stay gated: (r - .5)*1 + .5 is NOT the identity
          // in f32 (absorbs tiny values), so blend on the hoisted flag.
          float rc = (rk - 0.5f) * cmul + 0.5f;
          float gc = (gk - 0.5f) * cmul + 0.5f;
          float bc = (bk - 0.5f) * cmul + 0.5f;
          rk = has_contrast != 0.0f ? rc : rk;
          gk = has_contrast != 0.0f ? gc : gk;
          bk = has_contrast != 0.0f ? bc : bk;
          RK[j] = rpf_clampf(rk, 0.0f, 1.0f);
          GK[j] = rpf_clampf(gk, 0.0f, 1.0f);
          BK[j] = rpf_clampf(bk, 0.0f, 1.0f);
        }
        const int bi = lut_idx[k * 4 + 0];
        if (bi >= 0) {
          const int32_t* bl = luts + static_cast<int64_t>(bi) * 65536;
          const int ch = static_cast<int>(m[9]);
          const bool cr = ch == 0 || ch == 3;
          const bool cg = ch == 1 || ch == 3;
          const bool cb = ch == 2 || ch == 3;
          for (int j = 0; j < n; ++j) {
            if (cr) RK[j] = rpf_lut01(bl, RK[j], 1.0f / 65535.0f);
            if (cg) GK[j] = rpf_lut01(bl, GK[j], 1.0f / 65535.0f);
            if (cb) BK[j] = rpf_lut01(bl, BK[j], 1.0f / 65535.0f);
          }
        }
        if (mk == nullptr) {
#pragma omp simd
          for (int j = 0; j < n; ++j) {
            R[j] = RK[j];
            G[j] = GK[j];
            B[j] = BK[j];
          }
        } else {
#pragma omp simd
          for (int j = 0; j < n; ++j) {
            R[j] = mk[j] == 1.0f ? RK[j] : R[j];
            G[j] = mk[j] == 1.0f ? GK[j] : G[j];
            B[j] = mk[j] == 1.0f ? BK[j] : B[j];
          }
        }
      }

      // Per-mask OKLCH pass (develop_post_geo's second loop); masks whose
      // hue/sat/light curves are all default are skipped entirely — the
      // identity_oklch staircase shortcut develop_np also takes.
      if (any_oklch) {
        float Lc[CHUNK], Cc[CHUNK], Hc[CHUNK];
#pragma omp simd
        for (int j = 0; j < n; ++j) {
          float l_ = m1[0] * R[j] + m1[1] * G[j] + m1[2] * B[j];
          float mm = m1[3] * R[j] + m1[4] * G[j] + m1[5] * B[j];
          float s_ = m1[6] * R[j] + m1[7] * G[j] + m1[8] * B[j];
          l_ = rpf_cbrt_fast(l_);
          mm = rpf_cbrt_fast(mm);
          s_ = rpf_cbrt_fast(s_);
          float L = m2[0] * l_ + m2[1] * mm + m2[2] * s_;
          float A = m2[3] * l_ + m2[4] * mm + m2[5] * s_;
          float Bo = m2[6] * l_ + m2[7] * mm + m2[8] * s_;
          Lc[j] = L;
          Cc[j] = std::sqrt(A * A + Bo * Bo);
          Hc[j] = rpf_atan2_turns(Bo, A);
        }
        for (int k = 0; k < n_masks; ++k) {
          const int hi_ = lut_idx[k * 4 + 1];
          if (hi_ < 0) continue;
          const float* mk = k > 0 ? masks + k * hw + base : nullptr;
          const int32_t* hl = luts + static_cast<int64_t>(hi_) * 65536;
          const int32_t* sl =
              luts + static_cast<int64_t>(lut_idx[k * 4 + 2]) * 65536;
          const int32_t* ll =
              luts + static_cast<int64_t>(lut_idx[k * 4 + 3]) * 65536;
          for (int j = 0; j < n; ++j) {
            if (mk != nullptr && mk[j] != 1.0f) continue;
            int idx = static_cast<int>(Hc[j] * 65535.0f);
            idx = idx < 0 ? 0 : (idx > 65535 ? 65535 : idx);
            int32_t q = hl[idx];
            q = q < 0 ? 0 : (q > 65535 ? 65535 : q);
            Hc[j] = static_cast<float>(q) / 65535.0f;
            q = sl[idx];
            q = q < 0 ? 0 : (q > 65535 ? 65535 : q);
            Cc[j] *= static_cast<float>(q) / 32767.5f;
            q = ll[idx];
            q = q < 0 ? 0 : (q > 65535 ? 65535 : q);
            Lc[j] *= static_cast<float>(q) / 32767.5f;
          }
        }
#pragma omp simd
        for (int j = 0; j < n; ++j) {
          float A = Cc[j] * rpf_cos_turns(Hc[j]);
          float Bo = Cc[j] * rpf_sin_turns(Hc[j]);
          float l_ = m2i[0] * Lc[j] + m2i[1] * A + m2i[2] * Bo;
          float mm = m2i[3] * Lc[j] + m2i[4] * A + m2i[5] * Bo;
          float s_ = m2i[6] * Lc[j] + m2i[7] * A + m2i[8] * Bo;
          l_ = l_ * l_ * l_;
          mm = mm * mm * mm;
          s_ = s_ * s_ * s_;
          R[j] = m1i[0] * l_ + m1i[1] * mm + m1i[2] * s_;
          G[j] = m1i[3] * l_ + m1i[4] * mm + m1i[5] * s_;
          B[j] = m1i[6] * l_ + m1i[7] * mm + m1i[8] * s_;
        }
      }

      // sRGB encode + clip (NaN-safe clamp first) into planar chunks —
      // this loop holds the expensive pow chain and MUST vectorize, so
      // it stays free of the interleaved u8 store (whose stride-3 layout
      // the vectorizer prices as unprofitable and would scalarize the
      // whole loop, pow included).
#pragma omp simd
      for (int j = 0; j < n; ++j) {
        float sr = rpf_srgb_fast(R[j]);
        float sg = rpf_srgb_fast(G[j]);
        float sb = rpf_srgb_fast(B[j]);
        R[j] = (sr >= 0.0f) ? (sr < 1.0f ? sr : 1.0f) : 0.0f;
        G[j] = (sg >= 0.0f) ? (sg < 1.0f ? sg : 1.0f) : 0.0f;
        B[j] = (sb >= 0.0f) ? (sb < 1.0f ? sb : 1.0f) : 0.0f;
      }
      // Truncating u8 interleave (image.rs:375-383's `as u8` store).
      uint8_t* px = out + base * 3;
      for (int j = 0; j < n; ++j) {
        px[j * 3 + 0] = static_cast<uint8_t>(R[j] * 255.0f);
        px[j * 3 + 1] = static_cast<uint8_t>(G[j] * 255.0f);
        px[j * 3 + 2] = static_cast<uint8_t>(B[j] * 255.0f);
      }
    }
  }
  return RPF_OK;
}

// ---------------------------------------------------------------------------
// The JAX package's host helpers, unchanged in arithmetic: the PCHIP LUT
// expansion, the bilinear resize, the sRGB u8 <-> linear f32 conversions,
// the RGB + gray histogram, the mask binarization (native/__init__.py's
// API-parity wrappers) and the PNG row unfilter behind io/image_io.py's
// 16-bit PNG decode. Without -fopenmp their `#pragma omp` lines are
// ignored and the histogram takes its single-thread branch: the outputs
// are those of the JAX package's OpenMP build.
// ---------------------------------------------------------------------------

// ---------------------------------------------------------------------------
// PCHIP -> LUT expansion (f32 internals; harmonic-mean slopes; clamped
// extrapolation; truncate-toward-zero i32 cast — the exact semantics of the
// reference's curve setters).
// ---------------------------------------------------------------------------

int rpf_pchip_build_lut(const int32_t* xs, const int32_t* ys, int n,
                        int32_t lo, int32_t hi, int lut_size, int32_t* out) {
  if (n < 2 || lut_size <= 0 || !xs || !ys || !out) return RPF_ERR_ARGS;

  // f32 working copies (match the reference's f32 internals). nothrow:
  // an exception must not unwind through the C ABI into ctypes.
  float* x = new (std::nothrow) float[n];
  float* y = new (std::nothrow) float[n];
  float* h = new (std::nothrow) float[n - 1];
  float* del = new (std::nothrow) float[n - 1];
  float* slope = new (std::nothrow) float[n];
  if (!x || !y || !h || !del || !slope) {
    delete[] x; delete[] y; delete[] h; delete[] del; delete[] slope;
    return RPF_ERR_ARGS;
  }
  for (int i = 0; i < n; ++i) {
    x[i] = static_cast<float>(xs[i]);
    y[i] = static_cast<float>(ys[i]);
  }
  for (int i = 0; i < n - 1; ++i) {
    h[i] = x[i + 1] - x[i];
    if (h[i] <= 0.0f) {
      delete[] x; delete[] y; delete[] h; delete[] del; delete[] slope;
      return RPF_ERR_NOT_INCREASING;
    }
    del[i] = (y[i + 1] - y[i]) / h[i];
  }
  slope[0] = del[0];
  slope[n - 1] = del[n - 2];
  for (int i = 1; i < n - 1; ++i) {
    if (del[i - 1] * del[i] <= 0.0f) {
      slope[i] = 0.0f;
    } else {
      float w1 = 2.0f * h[i] + h[i - 1];
      float w2 = h[i] + 2.0f * h[i - 1];
      slope[i] = (w1 + w2) / (w1 / del[i - 1] + w2 / del[i]);
    }
  }

#pragma omp parallel for schedule(static)
  for (int k = 0; k < lut_size; ++k) {
    float xv = static_cast<float>(k);
    float val;
    if (xv <= x[0]) {
      val = y[0];
    } else if (xv >= x[n - 1]) {
      val = y[n - 1];
    } else {
      // Binary search: largest i with x[i] <= xv.
      int loi = 0, hii = n - 1;
      while (hii - loi > 1) {
        int mid = (loi + hii) >> 1;
        if (x[mid] <= xv) loi = mid; else hii = mid;
      }
      int i = std::min(loi, n - 2);
      float hv = h[i];
      float t = (xv - x[i]) / hv;
      float t2 = t * t;
      float t3 = t2 * t;
      float h00 = 2.0f * t3 - 3.0f * t2 + 1.0f;
      float h10 = t3 - 2.0f * t2 + t;
      float h01 = -2.0f * t3 + 3.0f * t2;
      float h11 = t3 - t2;
      val = h00 * y[i] + h10 * hv * slope[i] + h01 * y[i + 1] +
            h11 * hv * slope[i + 1];
    }
    // Clamp in float FIRST (casting values at/above 2^31 is UB and lands
    // on the wrong side), then truncate toward zero (Rust `as i32`).
    float lof = static_cast<float>(lo);
    float hif = static_cast<float>(hi);
    val = (val >= lof) ? std::min(val, hif) : lof;  // NaN -> lo
    int32_t iv = static_cast<int32_t>(val);
    out[k] = std::min(std::max(iv, lo), hi);
  }

  delete[] x; delete[] y; delete[] h; delete[] del; delete[] slope;
  return RPF_OK;
}

// ---------------------------------------------------------------------------
// Bilinear resize, HWC float32, half-texel-centered — the preview-pyramid
// resampler contract (web/main.ts:984-1019): indices clamp at the edges
// but the first-row/column weights can go slightly negative on upscale
// (mild extrapolation), exactly like the reference and ops/geometry.
// ---------------------------------------------------------------------------

int rpf_resize_bilinear_f32(const float* src, int sh, int sw, int ch,
                            float* dst, int dh, int dw) {
  if (!src || !dst || sh <= 0 || sw <= 0 || dh <= 0 || dw <= 0 || ch <= 0)
    return RPF_ERR_ARGS;
  const float scale_y = static_cast<float>(sh) / dh;
  const float scale_x = static_cast<float>(sw) / dw;

#pragma omp parallel for schedule(static)
  for (int y = 0; y < dh; ++y) {
    float sy = (y + 0.5f) * scale_y - 0.5f;
    int y0 = std::max(static_cast<int>(std::floor(sy)), 0);
    int y1 = std::min(y0 + 1, sh - 1);
    float ty = sy - y0;
    for (int x = 0; x < dw; ++x) {
      float sx = (x + 0.5f) * scale_x - 0.5f;
      int x0 = std::max(static_cast<int>(std::floor(sx)), 0);
      int x1 = std::min(x0 + 1, sw - 1);
      float tx = sx - x0;
      const float* r0a = src + (static_cast<size_t>(y0) * sw + x0) * ch;
      const float* r0b = src + (static_cast<size_t>(y0) * sw + x1) * ch;
      const float* r1a = src + (static_cast<size_t>(y1) * sw + x0) * ch;
      const float* r1b = src + (static_cast<size_t>(y1) * sw + x1) * ch;
      float* d = dst + (static_cast<size_t>(y) * dw + x) * ch;
      for (int c = 0; c < ch; ++c) {
        float top = r0a[c] * (1.0f - tx) + r0b[c] * tx;
        float bot = r1a[c] * (1.0f - tx) + r1b[c] * tx;
        d[c] = top * (1.0f - ty) + bot * ty;
      }
    }
  }
  return RPF_OK;
}

// ---------------------------------------------------------------------------
// sRGB u8 <-> linear f32 (EOTF per wgpu_shader.wgsl:85-103; decode via a
// 256-entry table, encode truncating like image.rs:375-383).
// ---------------------------------------------------------------------------

// Thread-safe lazy table (C++11 magic static): ctypes releases the GIL,
// so concurrent first calls from Python threads are real; a plain
// check-then-init bool is a data race.
struct SrgbDecodeTable {
  float v[256];
  SrgbDecodeTable() {
    for (int i = 0; i < 256; ++i) {
      float c = i / 255.0f;
      v[i] = (c <= 0.04045f) ? c / 12.92f
                             : std::pow((c + 0.055f) / 1.055f, 2.4f);
    }
  }
};

int rpf_srgb_u8_to_linear_f32(const uint8_t* src, float* dst, int64_t n) {
  if (!src || !dst || n < 0) return RPF_ERR_ARGS;
  static const SrgbDecodeTable table;
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) dst[i] = table.v[src[i]];
  return RPF_OK;
}

int rpf_linear_f32_to_srgb_u8(const float* src, uint8_t* dst, int64_t n) {
  if (!src || !dst || n < 0) return RPF_ERR_ARGS;
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    float c = src[i];
    float s = (c <= 0.0031308f)
                  ? c * 12.92f
                  : 1.055f * std::pow(std::max(c, 0.0f), 1.0f / 2.4f) - 0.055f;
    // NaN-safe clamp BEFORE the cast (float->int of NaN/huge is UB).
    s = (s >= 0.0f) ? std::min(s, 1.0f) : 0.0f;
    dst[i] = static_cast<uint8_t>(s * 255.0f);  // truncating, as reference
  }
  return RPF_OK;
}

// ---------------------------------------------------------------------------
// 256-bin RGB + gray histogram of an sRGB-encoded f32 HWC image
// (BT.601 gray weights — the reference feeds cv2 RGB2GRAY on the preview).
// ---------------------------------------------------------------------------

int rpf_histogram_rgbl_f32(const float* hwc, int h, int w, int32_t* out4x256) {
  if (!hwc || !out4x256 || h <= 0 || w <= 0) return RPF_ERR_ARGS;
  std::memset(out4x256, 0, sizeof(int32_t) * 4 * 256);
  const int64_t n = static_cast<int64_t>(h) * w;

#if defined(_OPENMP)
  int nthreads = omp_get_max_threads();
#else
  int nthreads = 1;
#endif
  // Per-thread local bins, merged at the end (avoids atomics).
  int32_t* locals =
      new (std::nothrow) int32_t[static_cast<size_t>(nthreads) * 4 * 256]();
  if (!locals) return RPF_ERR_ARGS;

#pragma omp parallel
  {
#if defined(_OPENMP)
    int tid = omp_get_thread_num();
#else
    int tid = 0;
#endif
    int32_t* bins = locals + static_cast<size_t>(tid) * 4 * 256;
#pragma omp for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
      const float* px = hwc + i * 3;
      float r = px[0], g = px[1], b = px[2];
      float gray = 0.299f * r + 0.587f * g + 0.114f * b;
      // Clamp in float BEFORE the int cast: casting NaN or out-of-range
      // floats is UB. NaN deterministically lands in bin 0.
      auto bin = [](float v) {
        v = v * 255.0f;
        v = (v >= 0.0f) ? std::min(v, 255.0f) : 0.0f;
        return static_cast<int>(v);
      };
      int ri = bin(r);
      int gi = bin(g);
      int bi = bin(b);
      int yi = bin(gray);
      bins[0 * 256 + ri]++;
      bins[1 * 256 + gi]++;
      bins[2 * 256 + bi]++;
      bins[3 * 256 + yi]++;
    }
  }
  for (int t = 0; t < nthreads; ++t)
    for (int k = 0; k < 4 * 256; ++k)
      out4x256[k] += locals[static_cast<size_t>(t) * 4 * 256 + k];
  delete[] locals;
  return RPF_OK;
}

int rpf_binarize_mask_f32(const float* src, float* dst, int64_t n,
                          float threshold) {
  if (!src || !dst || n < 0) return RPF_ERR_ARGS;
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) dst[i] = src[i] >= threshold ? 1.0f : 0.0f;
  return RPF_OK;
}

// PNG row reconstruction (PNG spec 4.5.4 / RFC 2083 §6.6): undo the
// per-row byte filters in place. `data` holds h rows of `stride`
// filtered bytes (filter-type bytes already stripped into `filters`),
// `bpp` is bytes per pixel. Rows are inherently sequential (Up/Average/
// Paeth read the reconstructed previous row, Sub/Average/Paeth the
// reconstructed left pixel) — this loop is why the decode needs a
// native hot path; the numpy mirror in io/image_io.py is the tested
// oracle. Returns RPF_OK or RPF_ERR on an unknown filter type.
int rpf_png_unfilter(uint8_t* data, const uint8_t* filters, int64_t h,
                     int64_t stride, int32_t bpp) {
  if (h <= 0 || stride <= 0 || bpp <= 0 || bpp > stride) return RPF_ERR_ARGS;
  for (int64_t y = 0; y < h; ++y) {
    uint8_t* row = data + y * stride;
    const uint8_t* up = y > 0 ? data + (y - 1) * stride : nullptr;
    switch (filters[y]) {
      case 0:
        break;
      case 1:  // Sub
        for (int64_t x = bpp; x < stride; ++x) row[x] += row[x - bpp];
        break;
      case 2:  // Up
        if (up)
          for (int64_t x = 0; x < stride; ++x) row[x] += up[x];
        break;
      case 3:  // Average
        for (int64_t x = 0; x < stride; ++x) {
          unsigned a = x >= bpp ? row[x - bpp] : 0u;
          unsigned b = up ? up[x] : 0u;
          row[x] = static_cast<uint8_t>(row[x] + ((a + b) >> 1));
        }
        break;
      case 4:  // Paeth
        for (int64_t x = 0; x < stride; ++x) {
          int a = x >= bpp ? row[x - bpp] : 0;
          int b = up ? up[x] : 0;
          int c = (up && x >= bpp) ? up[x - bpp] : 0;
          int p = a + b - c;
          int pa = p > a ? p - a : a - p;
          int pb = p > b ? p - b : b - p;
          int pc = p > c ? p - c : c - p;
          int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          row[x] = static_cast<uint8_t>(row[x] + pred);
        }
        break;
      default:
        return RPF_ERR_ARGS;
    }
  }
  return RPF_OK;
}

}  // extern "C"
