"""ctypes loader for the port's native host library (``rpf_native.cpp``).

The source is the port's own copy of the parts of the JAX package's
native runtime the RAW batch path calls: the lossless-JPEG scan decoder
and bit packer (``io/ljpeg``), the baseline JPEG 4:2:0 encoder
(``io/jpegenc``) and the stream assemblers of the JPEG device wires
(sparse, prepacked, packed; ``io/jpegenc``, ``io/jpegbits``), the Sony ARW2
and Panasonic RAW4 decoders
(``io/vendor_packed``), the per-CFA-tile block means of the decode gate
(``engine/instant``) and the host develop of the server's instant era and
drag previews (``engine/hostdev``: the fused one-pass develop, the
lens-distortion warp, the unsharp, the similarity and geodesic mask
logits), the 16-bit PNG row unfilter of ``io/image_io``'s PNG decode, and
the JAX package's other host helpers, for API parity (PCHIP LUT, resize,
sRGB conversions, histogram, mask binarization). The library is built at
first use (never at import) with
``g++`` and the JAX package's Makefile flags (less ``-fopenmp``) into
``<package>/build/``
(listed in .gitignore), keyed by a hash of the source, the flags and the
host CPU (``-march=native``); an existing library of the same key is
reused. A failed build raises with the compiler's log: there is no
pure-Python fallback, since a 24 MP lossless-JPEG, ARW2 or RAW4 decode in
Python would take minutes (``io/vendor_packed``'s Python decoders are kept
as test oracles only).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

from .._errbase import JpegWireDataError, PhotoEditorError

SOURCE = Path(__file__).resolve().parent / "rpf_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"

# The JAX package's native/Makefile flags (Linux) without -fopenmp, which
# none of these functions uses (and the card's machine has no libgomp): no
# FMA contraction, so the codecs round exactly as the JAX package's build.
CXX_FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-fno-math-errno",
             "-fno-trapping-math", "-fPIC", "-shared", "-Wall")

# Build record of the loaded library ({seconds, log, path}), or None.
BUILD = None
_LIB = None
# One build at a time (a server's warm-up thread and a request may race).
_LOCK = threading.Lock()


class NativeBuildError(PhotoEditorError):
    """The native host library could not be built or loaded."""


def _cpu_key() -> bytes:
    """The host CPU's feature flags: a ``-march=native`` build must not be
    loaded on another kind of CPU."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith(b"flags"):
                    return line
    except OSError:
        pass
    return os.uname().machine.encode()


def library() -> ctypes.CDLL:
    """The built and loaded native library (built at the first call)."""
    if _LIB is not None:
        return _LIB
    with _LOCK:
        return _load()


def _load() -> ctypes.CDLL:
    global _LIB, BUILD
    if _LIB is not None:
        return _LIB
    cxx = shutil.which("g++")
    if cxx is None:
        raise NativeBuildError("no C++ compiler (g++) to build the native "
                               "host library rpf_native.cpp")
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    digest.update(_cpu_key())
    out = BUILD_DIR / f"librpf_native-{digest.hexdigest()[:16]}.so"
    record = {"seconds": 0.0, "log": "", "path": str(out)}
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True)
        record["seconds"] = time.perf_counter() - t0
        record["log"] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise NativeBuildError(
                f"building rpf_native.cpp failed:\n{record['log']}")
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
    lib = ctypes.CDLL(str(out))
    _bind(lib)
    _LIB, BUILD = lib, record
    return lib


def _bind(lib) -> None:
    c = ctypes.c_int32
    c64 = ctypes.c_int64
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.rpf_ljpeg_decode_scan.argtypes = [
        ctypes.c_char_p, c64, u16p, c, c, c,
        u8p, u8p, u8p, c, c, c, c, c64, c64,
    ]
    lib.rpf_ljpeg_decode_scan.restype = c
    lib.rpf_ljpeg_pack_bits.argtypes = [i64p, u8p, c64, u8p]
    lib.rpf_ljpeg_pack_bits.restype = c64
    lib.rpf_jpeg_encode_ycc420.argtypes = [
        u8p, u8p, u8p, c, c, c, u8p, c64, ctypes.POINTER(ctypes.c_int64),
    ]
    lib.rpf_jpeg_encode_ycc420.restype = c
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    i16p = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
    lib.rpf_jpeg_encode_sparse.argtypes = [
        u8p, u32p, u8p, c64, i16p, c64, c, c, c, c, c, u8p, c64,
        ctypes.POINTER(ctypes.c_int64)]
    lib.rpf_jpeg_encode_sparse.restype = c
    lib.rpf_jpeg_encode_prepacked.argtypes = [
        u16p, c64, u32p, c64, c, c, c, u8p, c64,
        ctypes.POINTER(ctypes.c_int64)]
    lib.rpf_jpeg_encode_prepacked.restype = c
    lib.rpf_jpeg_encode_packed.argtypes = [
        u32p, c64, c64, c, c, c, u8p, c64,
        ctypes.POINTER(ctypes.c_int64)]
    lib.rpf_jpeg_encode_packed.restype = c
    lib.rpf_arw2_decode.argtypes = [ctypes.c_char_p, c64, c, c, u16p, u16p]
    lib.rpf_arw2_decode.restype = c
    lib.rpf_pana_decode_raw4.argtypes = [ctypes.c_char_p, c64, c, c, u16p]
    lib.rpf_pana_decode_raw4.restype = c
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.rpf_cfa_block_means.argtypes = [
        u16p, c, c, c, c, i32p, ctypes.c_float, ctypes.c_float, f32p,
    ]
    lib.rpf_cfa_block_means.restype = c
    cf = ctypes.c_float
    lib.rpf_hostdev_develop.argtypes = [
        f32p, c, c, c, f32p, f32p, i32p, i32p, c, f32p, cf, u8p]
    lib.rpf_hostdev_develop.restype = c
    lib.rpf_warp_f32.argtypes = [f32p, c, c, cf, f32p]
    lib.rpf_warp_f32.restype = c
    lib.rpf_similarity_logits.argtypes = [f32p, c, c, c, c, cf, cf, f32p, f32p]
    lib.rpf_similarity_logits.restype = c
    lib.rpf_geodesic_logits.argtypes = [
        f32p, c, c, c, c, cf, cf, c, cf, f32p, f32p]
    lib.rpf_geodesic_logits.restype = c
    lib.rpf_unsharp_f32.argtypes = [f32p, c, c, f32p, c, cf, f32p]
    lib.rpf_unsharp_f32.restype = c
    lib.rpf_pchip_build_lut.argtypes = [i32p, i32p, c, c, c, c, i32p]
    lib.rpf_pchip_build_lut.restype = c
    lib.rpf_resize_bilinear_f32.argtypes = [f32p, c, c, c, f32p, c, c]
    lib.rpf_resize_bilinear_f32.restype = c
    lib.rpf_srgb_u8_to_linear_f32.argtypes = [u8p, f32p, c64]
    lib.rpf_srgb_u8_to_linear_f32.restype = c
    lib.rpf_linear_f32_to_srgb_u8.argtypes = [f32p, u8p, c64]
    lib.rpf_linear_f32_to_srgb_u8.restype = c
    lib.rpf_histogram_rgbl_f32.argtypes = [f32p, c, c, i32p]
    lib.rpf_histogram_rgbl_f32.restype = c
    lib.rpf_binarize_mask_f32.argtypes = [f32p, f32p, c64, cf]
    lib.rpf_binarize_mask_f32.restype = c
    # The unfilter writes into its rows: ctypes refuses a read-only array.
    u8w = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS,WRITEABLE")
    lib.rpf_png_unfilter.argtypes = [u8w, u8p, c64, c64, c]
    lib.rpf_png_unfilter.restype = c


def ljpeg_decode_scan(seg: bytes, out, frame, mcu_start: int, mcu_count: int,
                      lut_sym, lut_len) -> None:
    """Decode one lossless-JPEG restart segment into ``out`` (u16
    [rows, mcus_per_row*ncomp]); see io/ljpeg.py for the framing layer.
    ``lut_sym``/``lut_len``: concatenated peek-16 Huffman LUTs
    ([ntab << 16] u8 each), built once per frame by the caller."""
    lut_sym = np.ascontiguousarray(lut_sym, dtype=np.uint8)
    lut_len = np.ascontiguousarray(lut_len, dtype=np.uint8)
    comp_tab = np.ascontiguousarray(frame.comp_table, dtype=np.uint8)
    rc = library().rpf_ljpeg_decode_scan(
        seg, len(seg), out, frame.rows, frame.mcus_per_row, frame.ncomp,
        lut_sym, lut_len, comp_tab, lut_sym.size >> 16,
        frame.predictor, frame.precision, frame.point_transform,
        mcu_start, mcu_count,
    )
    if rc != 0:
        from ..io.ljpeg import LJpegError

        raise LJpegError(f"native lossless-JPEG decode failed (rc={rc})")


def ljpeg_pack_bits(vals, lens) -> bytes:
    """MSB-first bit packing of (value, nbits) entries, 1-padded to a byte
    boundary — the lossless-JPEG encoder hot loop."""
    vals = np.ascontiguousarray(vals, dtype=np.int64)
    lens = np.ascontiguousarray(lens, dtype=np.uint8)
    out = np.empty(int(lens.astype(np.int64).sum()) // 8 + 2, dtype=np.uint8)
    n = library().rpf_ljpeg_pack_bits(vals, lens, vals.size, out)
    if n < 0:
        raise ValueError("rpf_ljpeg_pack_bits failed")
    return out[:n].tobytes()


def jpeg_encode_ycc420(y, cb, cr, quality: int = 92) -> bytes:
    """Baseline JFIF 4:2:0 encode from planar YCbCr u8 (the planes come
    from io/jpegenc's conversion on the render's device)."""
    lib = library()
    y = np.ascontiguousarray(y, dtype=np.uint8)
    cb = np.ascontiguousarray(cb, dtype=np.uint8)
    cr = np.ascontiguousarray(cr, dtype=np.uint8)
    h, w = y.shape
    ch, cw = (h + 1) // 2, (w + 1) // 2
    if cb.shape != (ch, cw) or cr.shape != (ch, cw):
        raise ValueError(
            f"chroma planes must be ({ch}, {cw}), got {cb.shape}/{cr.shape}")
    # Start at 2 bytes/pixel (noise at quality 100 measures ~1.98 B/px)
    # and grow on overflow; the worst case (max-magnitude coefficients
    # everywhere plus full byte stuffing) is ~10 B/px, the last rung.
    out_len = ctypes.c_int64(0)
    rc = 3
    for bpp in (2, 4, 10):
        cap = int(h) * int(w) * bpp + (1 << 16)
        out = np.empty(cap, dtype=np.uint8)
        rc = lib.rpf_jpeg_encode_ycc420(
            y, cb, cr, h, w, int(quality), out, cap, ctypes.byref(out_len))
        if rc != 3:
            break
    if rc != 0:
        raise ValueError(f"rpf_jpeg_encode_ycc420 failed (rc={rc})")
    return out[: out_len.value].tobytes()


def _wire_rejected(fn: str, rc: int):
    """The error of an assembler that refused its wire: its data broke a
    size category or a stream-length invariant (rc 1), which encode_jpeg
    answers with the next wire; any other code is a plain failure."""
    if rc == 1:
        return JpegWireDataError(f"{fn} rejected the wire data (rc={rc})")
    return ValueError(f"{fn} failed (rc={rc})")


def jpeg_encode_sparse(counts, bitmaps, values, escapes, h: int, w: int,
                       quality: int = 92, grid=None) -> bytes:
    """Baseline JFIF 4:2:0 entropy coding of the nibble wire
    (io/jpegenc._encode_sparse_device): per-block zigzag presence bitmaps,
    the nonzero values as packed 4-bit two's-complement nibbles (low nibble
    first) with 0x8 escaping to the int16 ``escapes`` stream, DC slots
    carrying same-component deltas over the whole grid, all in MCU scan
    order. ``grid``: (mcu_rows, mcu_cols) of a padded grid larger than
    ceil(h/16) x ceil(w/16); its padding blocks are walked for the stream's
    alignment but not emitted."""
    lib = library()
    counts = np.ascontiguousarray(counts, dtype=np.uint8)
    bitmaps = np.ascontiguousarray(bitmaps, dtype=np.uint32)
    values = np.ascontiguousarray(values, dtype=np.uint8)
    escapes = np.ascontiguousarray(escapes, dtype=np.int16)
    h, w = int(h), int(w)
    gr, gc = ((h + 15) // 16, (w + 15) // 16) if grid is None else (
        int(grid[0]), int(grid[1]))
    nblocks = gr * gc * 6
    if counts.shape != (nblocks,) or bitmaps.shape != (nblocks, 2):
        raise ValueError(
            f"expected counts ({nblocks},) and bitmaps ({nblocks}, 2) for "
            f"grid {gr}x{gc} MCUs, got {counts.shape}/{bitmaps.shape}")
    out_len = ctypes.c_int64(0)
    rc = 3
    for bpp in (2, 4, 10):
        cap = h * w * bpp + (1 << 16)
        out = np.empty(cap, dtype=np.uint8)
        rc = lib.rpf_jpeg_encode_sparse(
            counts, bitmaps, values, values.size, escapes, escapes.size,
            h, w, gr, gc, int(quality), out, cap, ctypes.byref(out_len))
        if rc != 3:
            break
    if rc != 0:
        raise _wire_rejected("rpf_jpeg_encode_sparse", rc)
    return out[: out_len.value].tobytes()


def jpeg_encode_prepacked(bit_lens, words, h: int, w: int,
                          quality: int = 92, grid=None) -> bytes:
    """Assemble a JFIF stream from prepacked entropy bits
    (io/jpegbits.encode_prepacked_device: the card already Huffman-coded
    each block into an MSB-first bit string, word-aligned per block; the
    host shifts the strings onto the running bit position and stuffs 0x00
    after 0xFF). ``bit_lens``: u16 [nblocks] per-block bit counts over the
    (possibly padded) MCU grid, 0 for padding blocks; ``words``: u32, the
    concatenated per-block word streams in scan order; ``grid`` as in
    ``jpeg_encode_sparse``."""
    lib = library()
    bit_lens = np.ascontiguousarray(bit_lens, dtype=np.uint16)
    words = np.ascontiguousarray(words, dtype=np.uint32)
    h, w = int(h), int(w)
    gr, gc = ((h + 15) // 16, (w + 15) // 16) if grid is None else (
        int(grid[0]), int(grid[1]))
    nblocks = gr * gc * 6
    if bit_lens.shape != (nblocks,):
        raise ValueError(
            f"expected bit_lens ({nblocks},) for grid {gr}x{gc} MCUs, "
            f"got {bit_lens.shape}")
    out_len = ctypes.c_int64(0)
    # Headers (< 1 KiB) + the scan bits with worst-case 0xFF stuffing (2x)
    # + EOI: one attempt always suffices.
    cap = int(bit_lens.astype(np.int64).sum()) // 8 * 2 + (1 << 16)
    out = np.empty(cap, dtype=np.uint8)
    rc = lib.rpf_jpeg_encode_prepacked(
        bit_lens, bit_lens.size, words, words.size, h, w, int(quality),
        out, cap, ctypes.byref(out_len))
    if rc != 0:
        raise _wire_rejected("rpf_jpeg_encode_prepacked", rc)
    return out[: out_len.value].tobytes()


def jpeg_encode_packed(words, total_bits: int, h: int, w: int,
                       quality: int = 92) -> bytes:
    """Assemble a JFIF stream from the packed scan
    (io/jpegbits.encode_packed_device: ``words`` u32 MSB-first hold the
    ENTIRE entropy-coded scan, ``total_bits`` its exact bit length; the
    native side writes the headers, stuffs 0x00 after 0xFF, pads the last
    byte with 1 bits and appends EOI)."""
    lib = library()
    words = np.ascontiguousarray(words, dtype=np.uint32)
    total_bits = int(total_bits)
    if words.ndim != 1 or total_bits < 0 or \
            words.size != (total_bits + 31) // 32:
        raise JpegWireDataError(
            f"packed scan mismatch: {words.size} words for {total_bits} bits")
    out_len = ctypes.c_int64(0)
    # Headers (< 1 KiB) + scan with worst-case 0xFF stuffing (2x) + EOI.
    cap = total_bits // 8 * 2 + (1 << 16)
    out = np.empty(cap, dtype=np.uint8)
    rc = lib.rpf_jpeg_encode_packed(
        words, words.size, total_bits, int(h), int(w), int(quality),
        out, cap, ctypes.byref(out_len))
    if rc != 0:
        raise _wire_rejected("rpf_jpeg_encode_packed", rc)
    return out[: out_len.value].tobytes()


def arw2_decode(payload: bytes, width: int, height: int, curve):
    """Sony ARW2 block decode -> u16 [height, width] (curve-mapped); the
    scalar ``io/vendor_packed.decode_arw2_py`` is its test oracle."""
    lib = library()
    c = np.ascontiguousarray(curve, dtype=np.uint16)
    if c.shape != (4096,):
        raise ValueError(f"curve must be u16[4096], got {c.shape}")
    out = np.empty((height, width), dtype=np.uint16)
    rc = lib.rpf_arw2_decode(bytes(payload), len(payload),
                             int(width), int(height), c, out)
    if rc != 0:
        raise ValueError(f"rpf_arw2_decode failed: {rc}")
    return out


def pana_decode_raw4(payload: bytes, width: int, height: int):
    """Panasonic RAW4 bitstream decode -> u16 [height, width]; the Python
    ``io/vendor_packed.decode_pana_raw4_py`` is its test oracle. A
    truncated stream raises the container readers' typed DngError."""
    lib = library()
    out = np.empty((height, width), dtype=np.uint16)
    rc = lib.rpf_pana_decode_raw4(bytes(payload), len(payload),
                                  int(width), int(height), out)
    if rc == 4:
        from ..io.dng import DngError

        raise DngError("RAW4 bitstream truncated")
    if rc != 0:
        raise ValueError(f"rpf_pana_decode_raw4 failed: {rc}")
    return out


def cfa_block_means(t_u16, ph: int, pw: int, tile_flat, black: float,
                    span: float):
    """Per-CFA-tile channel means of a u16 block -> f32 [3, eh, ew] in
    [0, 1] (the decode gate's superpixel develop, engine/instant)."""
    lib = library()
    t = np.ascontiguousarray(t_u16, dtype=np.uint16)
    h, w = t.shape
    if ph <= 0 or pw <= 0 or h % ph or w % pw:
        raise ValueError(f"block {t.shape} not a multiple of tile "
                         f"({ph}, {pw})")
    eh, ew = h // ph, w // pw
    tile = np.ascontiguousarray(tile_flat, dtype=np.int32).reshape(-1)
    if tile.size != ph * pw:
        raise ValueError("tile size mismatch")
    out = np.empty((3, eh, ew), dtype=np.float32)
    rc = lib.rpf_cfa_block_means(t, eh, ew, ph, pw, tile,
                                 float(black), float(span), out)
    if rc != 0:
        raise ValueError(f"rpf_cfa_block_means failed (rc={rc})")
    return out


def hostdev_develop(planes, masks, mrow, lut_idx, luts, mats,
                    vig_strength: float):
    """Fused host develop: [3, H, W] linear f32 -> u8 HWC in one pass.

    ``masks``: f32 [M, H, W] 0/1 (None for the single-mask session);
    ``mrow``/``lut_idx``/``luts``/``mats``: the packed per-mask scalars,
    LUT row table, concatenated i32 LUT rows and colour-matrix block built
    by ``engine/hostdev._pack_native`` (which owns the semantics)."""
    lib = library()
    planes = np.ascontiguousarray(planes, dtype=np.float32)
    if planes.ndim != 3 or planes.shape[0] != 3:
        raise ValueError(f"planes must be [3, H, W], got {planes.shape}")
    _, h, w = planes.shape
    mrow = np.ascontiguousarray(mrow, dtype=np.float32)
    n_masks = mrow.shape[0]
    if masks is None:
        if n_masks != 1:
            raise ValueError("masks required when more than one mask")
        marr = np.zeros(1, dtype=np.float32)
    else:
        marr = np.ascontiguousarray(masks, dtype=np.float32)
        if marr.shape != (n_masks, h, w):
            raise ValueError(
                f"masks must be ({n_masks}, {h}, {w}), got {marr.shape}")
    lut_idx = np.ascontiguousarray(lut_idx, dtype=np.int32)
    if lut_idx.shape != (n_masks, 4):
        raise ValueError(f"lut_idx must be ({n_masks}, 4), got {lut_idx.shape}")
    luts = np.ascontiguousarray(luts, dtype=np.int32)
    n_rows = int(luts.size) // 65536
    if luts.size != n_rows * 65536:
        raise ValueError("luts must be a whole number of 65536-entry rows")
    if luts.size == 0:
        luts = np.zeros(1, dtype=np.int32)
    mats = np.ascontiguousarray(mats, dtype=np.float32)
    if mats.size != 39:
        raise ValueError(f"mats must have 39 entries, got {mats.size}")
    out = np.empty((h, w, 3), dtype=np.uint8)
    rc = lib.rpf_hostdev_develop(
        planes, h, w, n_masks, marr, mrow.reshape(-1), lut_idx.reshape(-1),
        luts.reshape(-1), n_rows, mats.reshape(-1), float(vig_strength), out)
    if rc != 0:
        raise ValueError(f"rpf_hostdev_develop failed (rc={rc})")
    return out


def _check_planes_point(planes, point_yx):
    p = np.ascontiguousarray(planes, dtype=np.float32)
    if p.ndim != 3 or p.shape[0] != 3:
        raise ValueError(f"planes must be [3, H, W], got {p.shape}")
    py, px = int(point_yx[0]), int(point_yx[1])
    if not (0 <= py < p.shape[1] and 0 <= px < p.shape[2]):
        raise ValueError(f"point {point_yx} outside {p.shape[1:]}")
    return p, py, px


def _mats18(mats18):
    m = np.ascontiguousarray(mats18, dtype=np.float32)
    if m.size != 18:
        raise ValueError(f"mats18 must have 18 entries, got {m.size}")
    return m.reshape(-1)


def similarity_logits(planes, point_yx, tolerance: float, sigma: float,
                      mats18):
    """OKLab similarity logits (``engine/hostdev.similarity_logits_np``'s
    native mirror); ``mats18`` = M1, M2 row-major f32[18]."""
    lib = library()
    p, py, px = _check_planes_point(planes, point_yx)
    out = np.empty(p.shape[1:], dtype=np.float32)
    rc = lib.rpf_similarity_logits(p, p.shape[1], p.shape[2], py, px,
                                   float(tolerance), float(sigma),
                                   _mats18(mats18), out)
    if rc != 0:
        raise ValueError(f"rpf_similarity_logits failed (rc={rc})")
    return out


def geodesic_logits(planes, point_yx, tolerance: float, edge_weight: float,
                    spatial_cost: float, sweeps: int, mats18):
    """Geodesic smart-select logits (``engine/hostdev.smart_logits_np``'s
    native mirror)."""
    lib = library()
    p, py, px = _check_planes_point(planes, point_yx)
    if not 0 <= int(sweeps) <= 64:
        raise ValueError(f"sweeps must be in [0, 64], got {sweeps}")
    out = np.empty(p.shape[1:], dtype=np.float32)
    rc = lib.rpf_geodesic_logits(p, p.shape[1], p.shape[2], py, px,
                                 float(edge_weight), float(spatial_cost),
                                 int(sweeps), float(tolerance),
                                 _mats18(mats18), out)
    if rc != 0:
        raise ValueError(f"rpf_geodesic_logits failed (rc={rc})")
    return out


def _check_planes(planes):
    p = np.ascontiguousarray(planes, dtype=np.float32)
    if p.ndim != 3 or p.shape[0] != 3:
        raise ValueError(f"planes must be [3, H, W], got {p.shape}")
    return p


def warp_f32(planes, strength: float):
    """Radial lens-distortion warp over [3, H, W] f32, bit-identical to
    ``engine/hostdev.warp_np`` (IEEE f32 arithmetic in the same order).
    ``strength`` is the already-scaled f32(-0.5 * distortion / 100)."""
    lib = library()
    p = _check_planes(planes)
    out = np.empty_like(p)
    rc = lib.rpf_warp_f32(p, p.shape[1], p.shape[2], float(strength), out)
    if rc != 0:
        raise ValueError(f"rpf_warp_f32 failed (rc={rc})")
    return out


def unsharp_f32(planes, taps, amount: float):
    """Separable-Gaussian unsharp over [3, H, W] f32, bit-identical to
    ``engine/hostdev.unsharp_np`` for the same taps."""
    lib = library()
    p = _check_planes(planes)
    t = np.ascontiguousarray(taps, dtype=np.float32)
    if t.ndim != 1 or t.size % 2 == 0 or t.size > 129:
        raise ValueError(f"taps must be odd-length 1-D (<=129), got {t.shape}")
    out = np.empty_like(p)
    rc = lib.rpf_unsharp_f32(p, p.shape[1], p.shape[2], t, t.size // 2,
                             float(amount), out)
    if rc != 0:
        raise ValueError(f"rpf_unsharp_f32 failed (rc={rc})")
    return out


def available() -> bool:
    """True once the library is built and loaded, False when it cannot be
    (``NativeBuildError``). For API parity with the JAX package: every
    caller in the port calls the functions, which raise on a failed build."""
    try:
        library()
    except NativeBuildError:
        return False
    return True


def pchip_build_lut(xs, ys, lo=0, hi=65535, lut_size=65536):
    """PCHIP expansion of i32 control points into an i32 LUT of
    ``lut_size`` entries, clamped to [lo, hi]: ``core/curve.build_lut``'s
    semantics, bit for bit. Raises ``CurveError`` on x values that do not
    increase."""
    lib = library()
    xs = np.ascontiguousarray(xs, dtype=np.int32)
    ys = np.ascontiguousarray(ys, dtype=np.int32)
    out = np.empty(lut_size, dtype=np.int32)
    rc = lib.rpf_pchip_build_lut(xs, ys, len(xs), lo, hi, lut_size, out)
    if rc == 2:
        from ..core.curve import CurveError

        raise CurveError("control point x values must be strictly increasing")
    if rc != 0:
        raise ValueError(f"rpf_pchip_build_lut failed: {rc}")
    return out


def resize_bilinear(src_hwc, dh, dw):
    """Half-texel-centred bilinear resize of f32 HWC to (dh, dw)."""
    lib = library()
    src = np.ascontiguousarray(src_hwc, dtype=np.float32)
    h, w, ch = src.shape
    out = np.empty((dh, dw, ch), dtype=np.float32)
    rc = lib.rpf_resize_bilinear_f32(src, h, w, ch, out, dh, dw)
    if rc != 0:
        raise ValueError(f"rpf_resize_bilinear_f32 failed: {rc}")
    return out


def srgb_u8_to_linear(u8):
    """sRGB-encoded u8 -> linear f32 (a 256-entry decode table)."""
    lib = library()
    src = np.ascontiguousarray(u8, dtype=np.uint8)
    out = np.empty(src.shape, dtype=np.float32)
    lib.rpf_srgb_u8_to_linear_f32(src, out, src.size)
    return out


def linear_to_srgb_u8(f32):
    """Linear f32 -> sRGB u8, clamped and truncated."""
    lib = library()
    src = np.ascontiguousarray(f32, dtype=np.float32)
    out = np.empty(src.shape, dtype=np.uint8)
    lib.rpf_linear_f32_to_srgb_u8(src, out, src.size)
    return out


def histogram_rgbl(hwc):
    """256-bin R, G, B and BT.601 gray histograms of an sRGB f32 HWC image
    -> i32 [4, 256]."""
    lib = library()
    src = np.ascontiguousarray(hwc, dtype=np.float32)
    h, w, ch = src.shape
    if ch != 3:
        raise ValueError(f"histogram_rgbl needs HWC RGB, got {src.shape}")
    out = np.zeros((4, 256), dtype=np.int32)
    lib.rpf_histogram_rgbl_f32(src, h, w, out)
    return out


def binarize_mask(src, threshold):
    """1.0 where ``src >= threshold``, else 0.0 (f32)."""
    lib = library()
    s = np.ascontiguousarray(src, dtype=np.float32)
    out = np.empty(s.shape, dtype=np.float32)
    lib.rpf_binarize_mask_f32(s, out, s.size, float(threshold))
    return out


def png_unfilter(rows, filters, bpp: int):
    """Undo PNG row filters (PNG spec 4.5.4) IN PLACE on ``rows`` [h, stride]
    u8, a writable C-contiguous array (the filter bytes already split off
    into ``filters`` [h] u8); returns ``rows``. ``bpp``: bytes per pixel.
    Raises ``ImageIOError`` on an unknown filter type (a malformed file);
    ``io/image_io._png_unfilter`` is its numpy oracle."""
    from ..io.image_io import ImageIOError

    lib = library()
    if not (isinstance(rows, np.ndarray) and rows.dtype == np.uint8
            and rows.ndim == 2 and rows.flags.c_contiguous
            and rows.flags.writeable):
        raise ValueError("png_unfilter needs writable C-contiguous u8 rows "
                         "[h, stride] (it unfilters in place)")
    filters = np.ascontiguousarray(filters, dtype=np.uint8)
    h, stride = rows.shape
    if filters.shape != (h,):
        raise ValueError(f"filters must be ({h},), got {filters.shape}")
    rc = lib.rpf_png_unfilter(rows, filters, h, stride, int(bpp))
    if rc != 0:
        bad = filters[filters > 4]
        raise ImageIOError(f"PNG filter type {int(bad[0])}" if bad.size
                           else f"png_unfilter failed (code {rc}): "
                           f"{h}x{stride} rows, bpp {bpp}")
    return rows
