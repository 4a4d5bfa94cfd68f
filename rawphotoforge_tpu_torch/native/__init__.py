"""ctypes loader for the port's native host library (``rpf_native.cpp``).

The source is the port's own copy of the parts of the JAX package's
native runtime the RAW batch path calls: the lossless-JPEG scan decoder
and bit packer (``io/ljpeg``), the baseline JPEG 4:2:0 encoder
(``io/jpegenc``), the Sony ARW2 and Panasonic RAW4 decoders
(``io/vendor_packed``) and the per-CFA-tile block means of the decode gate
(``engine/instant``). The library is built at first use (never at import) with
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
import time
from pathlib import Path

import numpy as np

from .._errbase import PhotoEditorError

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
