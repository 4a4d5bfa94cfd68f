"""Lossless JPEG (ITU-T.81 process 14, SOF3) codec — the JAX package's
``io/ljpeg.py`` on the port's own native library.

Most real-world RAW files carry their CFA data as lossless-JPEG streams:
DNG Compression=7 tiles/strips, Canon CR2, and (as one variant) Nikon NEF.
The reference decodes these via rawler
(rust-godot-legacy/photo-editor/src/image.rs:509-557, rawler 0.7's ljpeg92
module); this is the framework's own implementation, re-derived from the
ITU-T.81 spec (Annex H: lossless mode):

* header/marker parsing and stream assembly in Python (`parse`, `decode`);
* the per-sample Huffman-decode hot loop in native C++
  (rpf_ljpeg_decode_scan in native/rpf_native.cpp, the port's copy of the
  JAX package's source; no Python fallback);
* a vectorized encoder (`encode`) used for the compressed-DNG writer and
  for round-trip fixtures (predictors 1-7, 2-16 bit, multi-component,
  restart intervals).

Supported: SOF3 frames with 1x1 sampling (the only layout RAW containers
use), 1-4 components, predictors 1-7, point transform, restart intervals.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from .._errbase import PhotoEditorError


class LJpegError(PhotoEditorError, ValueError):
    """Malformed or unsupported lossless-JPEG stream."""


# Markers.
M_SOI = 0xD8
M_EOI = 0xD9
M_SOS = 0xDA
M_DHT = 0xC4
M_SOF3 = 0xC3
M_DRI = 0xDD
M_DNL = 0xDC
M_RST0 = 0xD0  # .. 0xD7

_SOF_UNSUPPORTED = {
    0xC0, 0xC1, 0xC2, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF
}


@dataclasses.dataclass
class LJpegFrame:
    """Parsed SOF3 + SOS header state."""

    precision: int                  # sample bits P (2..16)
    rows: int                       # Y: lines
    mcus_per_row: int               # X: samples per line (per component)
    ncomp: int
    predictor: int                  # SOS Ss, 1..7
    point_transform: int            # SOS Al
    restart_interval: int           # DRI value in MCUs, 0 = none
    comp_table: np.ndarray          # [ncomp] u8: DC table id per component
    counts: np.ndarray              # [ntab, 16] u8 BITS
    values: np.ndarray              # [ntab, 17] u8 HUFFVAL (padded)
    nvalues: np.ndarray             # [ntab] actual value counts
    scan: bytes                     # entropy-coded bytes (incl. RST markers)

    @property
    def width(self) -> int:
        """Total output columns = MCUs per row x components (the
        column-interleaved layout RAW containers use)."""
        return self.mcus_per_row * self.ncomp


def parse(data: bytes) -> LJpegFrame:
    """Parse markers up to (and including) SOS; returns the frame +
    entropy-coded scan bytes. Malformed/truncated headers raise
    LJpegError (never struct/numpy errors)."""
    try:
        return _parse(data)
    except LJpegError:
        raise
    except (struct.error, ValueError, IndexError) as e:
        raise LJpegError(f"malformed lossless-JPEG header: {e}") from e


def _parse(data: bytes) -> LJpegFrame:
    if len(data) < 4 or data[0] != 0xFF or data[1] != M_SOI:
        raise LJpegError("missing SOI marker")
    pos = 2
    precision = rows = mcus = ncomp = None
    comp_index: dict = {}
    restart = 0
    tables: dict[int, tuple[np.ndarray, np.ndarray]] = {}

    while True:
        # Find the next marker (skip fill bytes 0xFF).
        if pos + 1 >= len(data):
            raise LJpegError("truncated stream: no SOS found")
        if data[pos] != 0xFF:
            raise LJpegError(f"expected marker at byte {pos}")
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1
        if pos >= len(data):
            raise LJpegError("truncated stream")
        marker = data[pos]
        pos += 1

        if marker == M_SOF3:
            (seglen, precision, rows, mcus, ncomp) = struct.unpack_from(
                ">HBHHB", data, pos
            )
            if not (2 <= precision <= 16):
                raise LJpegError(f"bad precision {precision}")
            if ncomp < 1 or ncomp > 4:
                raise LJpegError(f"unsupported component count {ncomp}")
            comp_index = {}  # component id -> frame position
            for i in range(ncomp):
                cid, hv, _tq = struct.unpack_from(">BBB", data, pos + 8 + 3 * i)
                if hv != 0x11:
                    raise LJpegError(
                        f"unsupported sampling factors 0x{hv:02x} "
                        f"(RAW lossless JPEG is always 1x1)"
                    )
                comp_index[cid] = i
            pos += seglen
        elif marker in _SOF_UNSUPPORTED:
            raise LJpegError(
                f"not a lossless (SOF3) stream: found SOF marker 0xFF{marker:02X}"
            )
        elif marker == M_DHT:
            (seglen,) = struct.unpack_from(">H", data, pos)
            end = pos + seglen
            p = pos + 2
            while p < end:
                tcth = data[p]
                tc, th = tcth >> 4, tcth & 0x0F
                if tc != 0:
                    raise LJpegError("lossless JPEG uses DC-class tables only")
                counts = np.frombuffer(data, np.uint8, 16, p + 1).copy()
                nval = int(counts.sum())
                if nval > 17:
                    raise LJpegError(f"too many Huffman values ({nval})")
                vals = np.frombuffer(data, np.uint8, nval, p + 17).copy()
                # Kraft validity: an oversubscribed table would overflow
                # the 16-bit code space and alias symbols in the peek-16
                # LUT -> silently wrong pixels.
                kraft = sum(int(counts[l]) << (16 - (l + 1))
                            for l in range(16))
                if kraft > (1 << 16):
                    raise LJpegError(
                        f"invalid Huffman table: code space oversubscribed "
                        f"(Kraft sum {kraft / float(1 << 16):.3f} > 1)"
                    )
                if vals.size and int(vals.max()) > 16:
                    # Lossless SSSS categories are 0..16; a larger value
                    # would drive the native decoder into shift counts
                    # >= 64 (undefined behavior).
                    raise LJpegError(
                        f"Huffman value {int(vals.max())} out of range "
                        f"(SSSS must be 0..16)"
                    )
                tables[th] = (counts, vals)
                p += 17 + nval
            pos = end
        elif marker == M_DRI:
            (seglen, restart) = struct.unpack_from(">HH", data, pos)
            pos += seglen
        elif marker == M_SOS:
            (seglen, ns) = struct.unpack_from(">HB", data, pos)
            if precision is None:
                raise LJpegError("SOS before SOF3")
            if ns != ncomp:
                raise LJpegError(f"scan components {ns} != frame components {ncomp}")
            comp_table = np.zeros(ncomp, dtype=np.uint8)
            for i in range(ns):
                cs, tdta = struct.unpack_from(">BB", data, pos + 3 + 2 * i)
                if cs not in comp_index:
                    raise LJpegError(f"scan references unknown component {cs}")
                comp_table[comp_index[cs]] = tdta >> 4
            ss, _se, ahal = struct.unpack_from(
                ">BBB", data, pos + 3 + 2 * ns
            )
            if not (1 <= ss <= 7):
                raise LJpegError(f"bad predictor {ss}")
            if (ahal & 0x0F) >= precision:
                # 1 << (precision - pt - 1) would be a negative shift:
                # C++ UB / silently wrong pixels on the native path.
                raise LJpegError(
                    f"point transform {ahal & 0x0F} >= precision {precision}"
                )
            scan_start = pos + seglen
            frame_done = (scan_start, ss, ahal & 0x0F, comp_table)
            break
        elif marker == M_EOI:
            raise LJpegError("EOI before SOS")
        elif M_RST0 <= marker <= M_RST0 + 7 or marker in (0x01,) or marker == 0:
            continue  # standalone markers, no length
        else:
            (seglen,) = struct.unpack_from(">H", data, pos)
            pos += seglen

    scan_start, predictor, pt, comp_table = frame_done
    if rows == 0:
        raise LJpegError("DNL-deferred line count is not supported")
    # Allocation-bomb guard: corrupted SOF3 dimensions must not turn into
    # multi-GB buffers (largest real sensors are ~150 MP).
    if rows * mcus * ncomp > 500_000_000:
        raise LJpegError(
            f"implausible SOF3 dimensions: {rows} lines x {mcus} MCUs x "
            f"{ncomp} components"
        )

    # Scan runs until EOI (last 0xFFD9) or end of data.
    end = data.rfind(b"\xff\xd9")
    scan = data[scan_start : end if end > scan_start else len(data)]

    ntab = (int(max(tables)) + 1) if tables else 0
    for t in comp_table:
        if int(t) not in tables:
            raise LJpegError(f"scan uses undefined Huffman table {int(t)}")
    counts = np.zeros((ntab, 16), dtype=np.uint8)
    values = np.zeros((ntab, 17), dtype=np.uint8)
    nvalues = np.zeros(ntab, dtype=np.int32)
    for th, (c, v) in tables.items():
        counts[th] = c
        values[th, : len(v)] = v
        nvalues[th] = len(v)

    return LJpegFrame(
        precision=precision,
        rows=rows,
        mcus_per_row=mcus,
        ncomp=ncomp,
        predictor=predictor,
        point_transform=pt,
        restart_interval=restart,
        comp_table=comp_table,
        counts=counts,
        values=values,
        nvalues=nvalues,
        scan=scan,
    )


def _split_segments(scan: bytes, restart_interval: int, total_mcus: int):
    """Split the scan at restart markers and unstuff 0xFF00 -> 0xFF.

    Returns a list of (segment_bytes, mcu_start, mcu_count)."""
    arr = np.frombuffer(scan, dtype=np.uint8)
    # Positions of 0xFF followed by RSTn.
    ff = np.flatnonzero(arr[:-1] == 0xFF)
    nxt = arr[ff + 1]
    rst_pos = ff[(nxt >= M_RST0) & (nxt <= M_RST0 + 7)]
    bounds = [0, *(int(p) for p in rst_pos), len(arr)]

    segs = []
    mcu_start = 0
    per = restart_interval if restart_interval > 0 else total_mcus
    for i in range(len(bounds) - 1):
        s = bounds[i] + (2 if i > 0 else 0)  # skip the RST marker itself
        chunk = arr[s : bounds[i + 1]]
        # Unstuff: drop every 0x00 that follows 0xFF.
        if len(chunk):
            stuffed = np.flatnonzero(chunk[:-1] == 0xFF) + 1
            stuffed = stuffed[chunk[stuffed] == 0x00]
            if len(stuffed):
                chunk = np.delete(chunk, stuffed)
        count = min(per, total_mcus - mcu_start)
        if count <= 0:
            break
        segs.append((chunk.tobytes(), mcu_start, count))
        mcu_start += count
    if mcu_start < total_mcus:
        raise LJpegError(
            f"scan ends after {mcu_start} of {total_mcus} MCUs"
        )
    return segs


def _build_huffman_lut(counts: np.ndarray, values: np.ndarray, nval: int):
    """Canonical Huffman -> (symbol, length) arrays indexed by a 16-bit peek."""
    sym = np.full(1 << 16, 0xFF, dtype=np.uint8)
    length = np.zeros(1 << 16, dtype=np.uint8)
    code = 0
    k = 0
    for ln in range(1, 17):
        for _ in range(int(counts[ln - 1])):
            if k >= nval:
                raise LJpegError("malformed Huffman table")
            lo = code << (16 - ln)
            hi = lo + (1 << (16 - ln))
            sym[lo:hi] = values[k]
            length[lo:hi] = ln
            code += 1
            k += 1
        code <<= 1
    return sym, length


def decode(data: bytes) -> tuple[np.ndarray, LJpegFrame]:
    """Decode a lossless-JPEG stream.

    Returns (samples, frame) where samples is u16 [rows, mcus_per_row*ncomp]
    with components column-interleaved (the layout DNG/CR2 CFA tiles use),
    already shifted left by the point transform per T.81 F.2.1.3.1.
    """
    frame = parse(data)
    total = frame.rows * frame.mcus_per_row
    segs = _split_segments(frame.scan, frame.restart_interval, total)

    # Peek-16 Huffman LUTs, built ONCE per frame (not per restart segment —
    # a per-row DRI would otherwise rebuild ntab x 128 KB per segment).
    luts = [
        _build_huffman_lut(frame.counts[t], frame.values[t], int(frame.nvalues[t]))
        for t in range(frame.counts.shape[0])
    ]

    from ..native import ljpeg_decode_scan

    out16 = np.zeros((frame.rows, frame.width), dtype=np.uint16)
    lut_sym = np.concatenate([s for s, _ in luts])
    lut_len = np.concatenate([l for _, l in luts])
    for seg, start, count in segs:
        ljpeg_decode_scan(seg, out16, frame, start, count, lut_sym, lut_len)
    if frame.point_transform:
        out16 <<= frame.point_transform
    return out16, frame


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def _diffs(samples: np.ndarray, predictor: int, precision: int, pt: int,
           restart_interval: int) -> np.ndarray:
    """Per-sample prediction differences, [H, W, C] int32."""
    s = samples.astype(np.int32) >> pt
    h, w, nc = s.shape
    ra = np.zeros_like(s)
    rb = np.zeros_like(s)
    rc = np.zeros_like(s)
    ra[:, 1:] = s[:, :-1]
    rb[1:, :] = s[:-1, :]
    rc[1:, 1:] = s[:-1, :-1]

    if predictor == 1:
        pred = ra
    elif predictor == 2:
        pred = rb
    elif predictor == 3:
        pred = rc
    elif predictor == 4:
        pred = ra + rb - rc
    elif predictor == 5:
        pred = ra + ((rb - rc) >> 1)
    elif predictor == 6:
        pred = rb + ((ra - rc) >> 1)
    elif predictor == 7:
        pred = (ra + rb) >> 1
    else:
        raise LJpegError(f"bad predictor {predictor}")
    # Boundary rules (T.81 H.1.2.1): the first line of the scan — and of
    # every restart interval — uses the 1-D Ra predictor; the very first
    # sample of each uses the default prediction.
    pred[0, 1:] = ra[0, 1:]
    pred[1:, 0] = rb[1:, 0]
    default = 1 << (precision - pt - 1)
    pred[0, 0] = default
    if restart_interval > 0:
        idx = np.arange(h * w)
        start = (idx // restart_interval) * restart_interval
        same_line = (idx // w) == (start // w)
        # Ra on each interval's first line (col 0 can only be the interval
        # start itself, handled below).
        line_mask = (same_line & (idx != start)).reshape(h, w)
        pred[line_mask] = ra[line_mask]
        flat_pred = pred.reshape(-1, nc)
        flat_pred[np.arange(0, h * w, restart_interval)] = default
        pred = flat_pred.reshape(h, w, nc)
    return s - pred


# Category (bit length) of |diff| for 0..32768 — exact integer lookup,
# far cheaper than float frexp over megapixel arrays.
_SSSS_TABLE = None


def _ssss_table() -> np.ndarray:
    global _SSSS_TABLE
    if _SSSS_TABLE is None:
        t = np.zeros(32769, dtype=np.uint8)
        for k in range(1, 17):
            t[1 << (k - 1): (1 << k)] = k
        t[32768] = 16
        _SSSS_TABLE = t
    return _SSSS_TABLE


def _pack_bits(vals: np.ndarray, lens: np.ndarray) -> bytes:
    """MSB-first bit packing of (value, nbits) pairs; pads with 1s (the
    native packer)."""
    from ..native import ljpeg_pack_bits

    return ljpeg_pack_bits(vals, lens)


def _stuff(packed: bytes) -> np.ndarray:
    arr = np.frombuffer(packed, dtype=np.uint8)
    idx = np.flatnonzero(arr == 0xFF)
    return np.insert(arr, idx + 1, 0)


# One shared table: categories 0..16, all 5 bits (17 <= 2^5; max code
# 10000b so the all-ones prefix rule holds). Simple and always valid.
_ENC_COUNTS = np.array([0, 0, 0, 0, 17] + [0] * 11, dtype=np.uint8)
_ENC_VALUES = np.arange(17, dtype=np.uint8)


def optimal_table(categories: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Build the optimal canonical Huffman table for a category stream.

    Standard Huffman over the category histogram, with the JPEG 16-bit
    length cap enforced by the Annex-K BITS-adjustment procedure (move a
    pair of overlong codes up under a shorter sibling). Typically saves
    2-3 bits/sample over the fixed 5-bit table on real image statistics.
    """
    import heapq

    freq = np.bincount(np.asarray(categories, dtype=np.int64).reshape(-1),
                       minlength=17)
    present = np.flatnonzero(freq)
    if len(present) == 0:
        return _ENC_COUNTS, _ENC_VALUES

    # Huffman over the real symbols PLUS the T.81 K.2 dummy (frequency 1,
    # pseudo-value 255): the dummy takes the deepest/last canonical code —
    # the all-1-bits codeword the spec reserves — and is dropped from the
    # table afterwards, so no real symbol ever gets it.
    DUMMY = 255
    heap = [(int(freq[s]), int(s), [int(s)]) for s in present]
    heap.append((1, DUMMY, [DUMMY]))
    heapq.heapify(heap)
    depth = {int(s): 0 for s in present}
    depth[DUMMY] = 0
    uid = 1000
    while len(heap) > 1:
        fa, _, sa = heapq.heappop(heap)
        fb, _, sb = heapq.heappop(heap)
        for s in sa + sb:
            depth[s] += 1
        heapq.heappush(heap, (fa + fb, uid, sa + sb))
        uid += 1

    counts = np.zeros(32, dtype=np.int64)
    for s in list(present) + [DUMMY]:
        counts[depth[s] - 1] += 1
    # Length cap (T.81 K.3 Adjust_BITS): repeatedly take one code from the
    # longest length, pair it under a code at the nearest shorter length.
    i = 31
    while i > 15:
        if counts[i] > 0:
            j = i - 2
            while counts[j] == 0:
                j -= 1
            counts[i] -= 2
            counts[i - 1] += 1
            counts[j + 1] += 2
            counts[j] -= 1
        else:
            i -= 1
    # Drop the dummy: it occupies the last code of the longest length
    # (deepest depth; canonical ties order it last via its 255 value).
    i = 15
    while counts[i] == 0:
        i -= 1
    counts[i] -= 1
    # Canonical value order: by code length, ties by symbol value; the
    # dummy sorts strictly last and is excluded.
    order = sorted(present, key=lambda s: (depth[int(s)], s))
    values = np.asarray(order, dtype=np.uint8)
    return counts[:16].astype(np.uint8), values


def _canonical_codes(counts: np.ndarray, values: np.ndarray):
    """Canonical code/length per symbol value (inverse of the decode LUT)."""
    code_of = {}
    code = 0
    k = 0
    for ln in range(1, 17):
        for _ in range(int(counts[ln - 1])):
            code_of[int(values[k])] = (code, ln)
            code += 1
            k += 1
        code <<= 1
    return code_of


def encode(
    samples: np.ndarray,
    precision: int | None = None,
    predictor: int = 1,
    point_transform: int = 0,
    restart_interval: int = 0,
    huffman=None,
) -> bytes:
    """Encode u16 samples ([H, W] or [H, W, C], C<=4) as lossless JPEG.

    Every decoder-supported shape is encodable, which gives the round-trip
    property the tests rely on; also used by write_dng(compression=7).
    ``huffman``: None for the simple 17-categories-at-5-bits table,
    ``"optimal"`` to build the entropy-optimal canonical table from the
    data, or an explicit (counts[16], values) pair.
    """
    s = np.asarray(samples)
    if s.ndim == 2:
        s = s[:, :, None]
    if s.ndim != 3 or s.shape[2] > 4:
        raise LJpegError(f"bad sample shape {samples.shape}")
    if s.size == 0:
        raise LJpegError("cannot encode an empty sample array")
    h, w, nc = s.shape
    if precision is None:
        precision = max(2, int(s.max()).bit_length())
    if not (2 <= precision <= 16):
        raise LJpegError(f"bad precision {precision}")
    if not (0 <= point_transform < precision):
        raise LJpegError(
            f"point transform {point_transform} out of range for "
            f"precision {precision}")
    if int(s.max()) >= (1 << precision):
        raise LJpegError("samples exceed precision")

    d = _diffs(s, predictor, precision, point_transform, restart_interval)
    # Map to mod-2^16 signed representatives in [-32767, 32768]; all
    # integer int32 math (the float path costs seconds at 50MP).
    d16 = d & np.int32(0xFFFF)
    d16 -= (d16 >= 32768) * np.int32(65536)

    mag = np.abs(d16)
    ssss = _ssss_table()[mag]  # exact bit length; mag == 32768 -> 16
    is16 = d16 == np.int32(-32768)  # category 16: no appended bits

    extra = np.where(d16 < 0,
                     d16 + (np.int32(1) << ssss.astype(np.int32)) - 1, d16)
    extra_len = np.where(is16, np.uint8(0), ssss)

    flat_ssss = ssss.reshape(-1)
    flat_extra = extra.reshape(-1)
    flat_elen = extra_len.reshape(-1)

    if huffman is None:
        enc_counts, enc_values = _ENC_COUNTS, _ENC_VALUES
    elif isinstance(huffman, str) and huffman == "optimal":
        enc_counts, enc_values = optimal_table(flat_ssss)
    else:
        enc_counts = np.asarray(huffman[0], dtype=np.uint8)
        enc_values = np.asarray(huffman[1], dtype=np.uint8)
    code_of = _canonical_codes(enc_counts, enc_values)
    missing = set(np.unique(flat_ssss)) - set(code_of)
    if missing:
        raise LJpegError(f"Huffman table lacks categories {sorted(missing)}")
    cat_code = np.zeros(17, dtype=np.uint32)
    cat_len = np.zeros(17, dtype=np.uint8)
    for v, (c, ln) in code_of.items():
        if v <= 16:
            cat_code[v] = c
            cat_len[v] = ln

    # One packed entry per sample: (huffman code << extra_len) | extra —
    # max 16+16 = 32 bits, halving the bit-packing work vs two entries.
    code_l = cat_len[flat_ssss]
    # Zero the appended-bits field where none are emitted (categories 0 and
    # 16), so it cannot pollute the OR below.
    extra_bits = np.where(flat_elen > 0, flat_extra, 0).astype(np.int64)
    vals = (cat_code[flat_ssss].astype(np.int64) << flat_elen) | extra_bits
    lens = (code_l + flat_elen).astype(np.uint8)

    out = bytearray()
    out += b"\xff\xd8"  # SOI
    # SOF3
    out += struct.pack(">BBHBHHB", 0xFF, M_SOF3, 8 + 3 * nc, precision, h, w, nc)
    for c in range(nc):
        out += struct.pack(">BBB", c + 1, 0x11, 0)
    # DHT (table 0, used by all components)
    nval = int(enc_counts.sum())
    out += struct.pack(">BBH", 0xFF, M_DHT, 2 + 1 + 16 + nval) + b"\x00"
    out += enc_counts.tobytes() + enc_values[:nval].tobytes()
    if restart_interval:
        out += struct.pack(">BBHH", 0xFF, M_DRI, 4, restart_interval)
    # SOS
    out += struct.pack(">BBHB", 0xFF, M_SOS, 6 + 2 * nc, nc)
    for c in range(nc):
        out += struct.pack(">BB", c + 1, 0x00)
    out += struct.pack(">BBB", predictor, 0, point_transform)

    if restart_interval > 0:
        per = restart_interval * nc  # samples (= entries) per interval
        n = vals.size
        n_iv = (h * w + restart_interval - 1) // restart_interval
        for i in range(n_iv):
            sl = slice(i * per, min((i + 1) * per, n))
            out += _stuff(_pack_bits(vals[sl], lens[sl])).tobytes()
            if i != n_iv - 1:
                out += bytes([0xFF, M_RST0 + (i % 8)])
    else:
        out += _stuff(_pack_bits(vals, lens)).tobytes()
    out += b"\xff\xd9"  # EOI
    return bytes(out)
