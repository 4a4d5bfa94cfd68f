"""Minimal DNG (TIFF-EP) RAW container: reader + writer — the JAX
package's ``io/dng.py`` on the host, as the port's own copy (Sony ARW2
data decodes through io/vendor_packed, the previews of non-TIFF
containers come from io/vendor_preview).

Replaces the reference's rawler/rawpy dependency for the RAW ingestion layer
(rust-godot-legacy/photo-editor/src/image.rs:509-557 decodes 29 formats via
rawler; python-legacy editor.py:169-181 via rawpy). This implementation
covers the DNG subset the framework owns natively:

* classic TIFF structure (II/MM byte order, IFD chains, SubIFDs)
* uncompressed (Compression=1) CFA strips, 8/12/14/16 bits per sample
* lossless-JPEG (Compression=7, ITU-T.81 SOF3) CFA strips AND tiles —
  the encoding nearly all real-world DNGs use (io/ljpeg.py; tiles decode
  in parallel through the native scan decoder)
* Deflate (Compression=8 / legacy 32946) CFA strips and tiles: integer
  16/8-bit with Predictor 1/2/34892/34893 (none / horizontal / X2 / X4),
  and IEEE-float HDR data (SampleFormat=3, fp16/fp32) with the TIFF TN3
  floating-point Predictor 3 — the encoding Adobe writes for float DNGs.
  fp24 needs non-IEEE exponent-bias math with no offline ground truth, so
  it raises a typed error instead of risking a silently wrong decode.
* the color tags needed for develop: CFAPattern, BlackLevel, WhiteLevel,
  AsShotNeutral, ColorMatrix1, Orientation, plus basic EXIF rationals

* lossy-JPEG DNG (Compression=34892) over PhotometricInterpretation=
  LinearRaw RGB — the demosaiced format Adobe's lossy DNGs use; decoded
  via Pillow and developed without the demosaic stage
* DNG opcode lists: OpcodeList1 FixBadPixelsConstant/List (defective-
  pixel interpolation on the stored mosaic), OpcodeList2 GainMap +
  FixVignetteRadial + MapPolynomial + MapTable + DeltaPerRow/Column +
  ScalePerRow/Column (shading/tone/flat-field corrections at the
  normalized linear-reference stage), and OpcodeList3 WarpRectilinear +
  WarpFisheye + FixVignetteRadial (applied post-demosaic by develop) +
  TrimBounds (composed into the final crop) — every DNG 1.3 opcode, the
  corrections phone DNGs/ProRAW carry; read_dng(apply_opcodes=False) is
  the lossless transcode mode that re-serializes them instead
* embedded JPEG preview extraction (``extract_preview``) from preview
  IFDs / EXIF thumbnails, Pillow-validated

plus a writer that emits valid uncompressed, lossless-JPEG (optionally
tiled), or deflate (integer u16 / fp16 / fp32; CFA or LinearRaw) DNGs,
optionally with an embedded JPEG preview IFD — used for tests, fixtures,
and archival re-compression (`cli convert`).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Optional

import numpy as np

# TIFF tag ids.
T_NEW_SUBFILE_TYPE = 254
T_WIDTH = 256
T_LENGTH = 257
T_BITS_PER_SAMPLE = 258
T_COMPRESSION = 259
T_PHOTOMETRIC = 262
T_MAKE = 271
T_MODEL = 272
T_STRIP_OFFSETS = 273
T_ORIENTATION = 274
T_SAMPLES_PER_PIXEL = 277
T_ROWS_PER_STRIP = 278
T_STRIP_BYTE_COUNTS = 279
T_PREDICTOR = 317
T_SUB_IFDS = 330
T_SAMPLE_FORMAT = 339
T_TILE_WIDTH = 322
T_TILE_LENGTH = 323
T_TILE_OFFSETS = 324
T_TILE_BYTE_COUNTS = 325
T_CFA_REPEAT_DIM = 33421
T_CFA_PATTERN = 33422
T_DATETIME = 306
T_DATETIME_ORIGINAL = 36867
T_EXPOSURE_TIME = 33434
T_F_NUMBER = 33437
T_EXIF_IFD = 34665
T_ISO = 34855
T_FOCAL_LENGTH = 37386
T_FOCAL_LENGTH_35MM = 41989     # FocalLengthIn35mmFilm (crop factor route)
T_LENS_MODEL = 42036
T_DNG_VERSION = 50706
T_LINEARIZATION_TABLE = 50712
T_OPCODE_LIST_1 = 51008         # applied to the stored image (DNG 1.3)
T_OPCODE_LIST_2 = 51009         # applied after linearization (DNG 1.3)
T_OPCODE_LIST_3 = 51022         # applied after demosaicking (DNG 1.3)
T_BLACK_LEVEL = 50714
T_WHITE_LEVEL = 50717
T_DEFAULT_CROP_ORIGIN = 50719
T_DEFAULT_CROP_SIZE = 50720
# Sony ARW vendor tags carried in the raw IFD (exiftool Sony.pm /
# libraw sony_arw tag handling).
T_SONY_BLACK_LEVEL = 0x7310     # 4 per-CFA-site shorts
T_SONY_WHITE_LEVEL = 0x787F     # WhiteLevel (1-3 values)
T_SONY_WB_RGGB = 0x7313         # WB_RGGBLevels (multiplier levels)
T_SONY_CURVE = 0x7010           # ARW2 companding-curve knots (4 shorts)
COMPRESSION_SONY_ARW2 = 32767   # Sony cRAW / ARW2 packed blocks
T_COLOR_MATRIX_1 = 50721
T_AS_SHOT_NEUTRAL = 50728
T_ACTIVE_AREA = 50829

PHOTOMETRIC_CFA = 32803
PHOTOMETRIC_LINEAR_RAW = 34892   # demosaiced RAW (DNG spec)
COMPRESSION_LOSSY_JPEG = 34892   # baseline DCT JPEG (DNG 1.4 lossy)

_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
               11: 4, 12: 8}
_TYPE_FMT = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 11: "f", 12: "d"}


from .._errbase import PhotoEditorError
from ..utils.profiling import span


class DngError(PhotoEditorError, ValueError):
    """Unsupported or malformed RAW container."""


@dataclasses.dataclass
class RawImage:
    """Decoded CFA RAW: everything develop_raw needs (SURVEY.md §7.2 step 4)."""

    mosaic: np.ndarray            # [H, W] raw CFA values: u16, or f32 (HDR DNG)
    pattern: str                  # "RGGB"|"BGGR"|"GRBG"|"GBRG"|"XTRANS", or
                                  # "RGB" (demosaiced LinearRaw: mosaic is
                                  # [H, W, 3] and the develop path skips
                                  # demosaic)
    black_level: float
    white_level: float
    wb_gains: tuple               # (r, g, b) camera WB multipliers, g == 1
    xyz_to_cam: Optional[np.ndarray]  # 3x3 ColorMatrix1, None if absent
    orientation: int = 1
    exif: dict = dataclasses.field(default_factory=dict)
    # DNG DefaultCropOrigin/Size (x, y, w, h) relative to the decoded
    # mosaic — the recommended final crop, applied after demosaic (the v1
    # DefaultCropOrigin auto-crop, python-legacy raw_photo_forge.py:2006+).
    default_crop: Optional[tuple] = None
    # DNG OpcodeList3 WarpRectilinear (opcode 1): (coefs f32 [P, 6],
    # center f32 [2] relative) — applied post-demosaic by develop.
    warp_rectilinear: Optional[tuple] = None
    # DNG OpcodeList3 WarpFisheye (opcode 2): (coefs f32 [P, 4],
    # center f32 [2] relative) — theta-polynomial fisheye remap,
    # applied post-demosaic like the rectilinear warp (r5: the last
    # DNG 1.3 opcode).
    warp_fisheye: Optional[tuple] = None
    # DNG OpcodeList3 FixVignetteRadial (opcode 3): (k f32 [5],
    # center f32 [2] relative) — applied post-demosaic by develop, in
    # the file's listed order relative to WarpRectilinear
    # (vignette_first True = the vignette opcode precedes the warp).
    vignette_radial: Optional[tuple] = None
    vignette_first: bool = False
    # Raw (unapplied) OpcodeList1/2/3 blobs, kept ONLY by
    # read_dng(apply_opcodes=False) so write_dng can re-serialize them —
    # the lossless-transcode path (cli convert).
    opcode_lists: Optional[tuple] = None
    # False when the container carried NO usable camera WB (vendor RAWs
    # whose WB lives in encrypted/undocumented maker notes): the develop
    # path then estimates gray-world gains instead of rendering the raw
    # sensor response (develop_raw_image).
    wb_known: bool = True
    # True when the sensor data came through a memory-derived bitstream
    # codec (io/vendor_packed: Sony ARW2, Panasonic RAW4): parse_raw then
    # auto-correlates a host superpixel develop against the file's own
    # embedded camera preview and REFUSES the decode (typed DngError ->
    # preview fallback) below the 0.9 gate, so a misremembered packing
    # rule can never pass silently.
    needs_verification: bool = False

    @property
    def shape(self):
        return self.mosaic.shape


def _read_ifd(data: bytes, off: int, bo: str) -> tuple[dict, int]:
    (count,) = struct.unpack_from(bo + "H", data, off)
    entries = {}
    for i in range(count):
        tag, typ, n = struct.unpack_from(bo + "HHI", data, off + 2 + i * 12)
        val_off = off + 2 + i * 12 + 8
        size = _TYPE_SIZES.get(typ, 1) * n
        if size > 4:
            (val_off,) = struct.unpack_from(bo + "I", data, val_off)
        entries[tag] = (typ, n, val_off)
    (next_off,) = struct.unpack_from(bo + "I", data, off + 2 + count * 12)
    return entries, next_off


def _value(data: bytes, entry, bo: str):
    typ, n, off = entry
    if typ == 2:  # ASCII
        raw = data[off : off + n]
        return raw.split(b"\x00")[0].decode("ascii", "replace")
    if typ in (5, 10):  # rational
        fmt = "II" if typ == 5 else "ii"
        vals = []
        for i in range(n):
            num, den = struct.unpack_from(bo + fmt, data, off + 8 * i)
            vals.append(num / den if den else 0.0)
        return vals if n > 1 else vals[0]
    fmt = _TYPE_FMT.get(typ)
    if fmt is None:
        return data[off : off + n]
    vals = list(struct.unpack_from(bo + str(n) + fmt, data, off))
    return vals if n > 1 else vals[0]


def _unpack_bits(packed: np.ndarray, bits: int, count: int) -> np.ndarray:
    """Unpack big-endian bit-packed samples (12/14-bit DNG strips)."""
    u = np.unpackbits(packed)
    u = u[: count * bits].reshape(count, bits)
    weights = (1 << np.arange(bits - 1, -1, -1)).astype(np.uint32)
    return (u.astype(np.uint32) * weights).sum(axis=1).astype(np.uint16)


# Predictor tag values (TIFF 6.0 + TIFF TN3 + DNG 1.4 / exiftool table):
# 1 none, 2 horizontal differencing, 3 floating-point (TN3),
# 34892/34893 horizontal differencing X2/X4 (CFA column pitch).
_INT_PREDICTOR_STEP = {1: 0, 2: 1, 34892: 2, 34893: 4}


def _deflate_decode_block(
    raw: bytes, bh: int, bw: int, bits: int, predictor: int,
    sample_format: int, bo: str, spp: int = 1,
) -> np.ndarray:
    """One deflate strip/tile -> [bh, bw] (or [bh, bw, spp]) samples.

    Integer predictors store per-row left-differences at the given column
    pitch (wrapping u16 math — verified against Pillow's independent
    TIFF deflate+predictor decoder); with ``spp`` interleaved samples the
    difference pitch is one *pixel*, i.e. ``spp`` samples (TIFF 6.0 §14).
    The TN3 float predictor stores each row as big-endian byte planes
    with byte-wise differencing at byte stride ``spp`` (libtiff
    fpDiff/fpAcc layout).
    """
    import zlib

    if sample_format == 3 and bits not in (16, 32):
        raise DngError(
            f"unsupported float DNG depth {bits} (fp16/fp32 decode "
            f"natively; fp24 has no IEEE layout to verify against)"
        )
    try:
        data = zlib.decompress(raw)
    except zlib.error as e:
        raise DngError(f"bad deflate stream: {e}") from e
    bps = bits // 8
    wc = bw * spp  # samples per row
    need = bh * wc * bps
    if len(data) < need:
        raise DngError(
            f"deflate chunk holds {len(data)} bytes, expected {need}"
        )

    def _shape(arr):
        return arr.reshape(bh, bw) if spp == 1 else arr.reshape(bh, bw, spp)

    if sample_format == 3:  # IEEE floating point (HDR DNG)
        if predictor == 3:
            rows = np.frombuffer(data, np.uint8, count=need).reshape(
                bh, bps * wc
            )
            # Undo byte-wise horizontal differencing (mod-256 running sum
            # at byte stride spp), then reassemble samples from big-endian
            # byte planes.
            acc = rows.astype(np.uint64)
            for lane in range(spp):
                acc[:, lane::spp] = np.cumsum(acc[:, lane::spp], axis=1)
            acc = acc.astype(np.uint8)
            be = np.moveaxis(acc.reshape(bh, bps, wc), 1, 2)
            arr = np.frombuffer(
                np.ascontiguousarray(be).tobytes(),
                dtype=">f2" if bits == 16 else ">f4",
            )
        elif predictor == 1:
            arr = np.frombuffer(
                data, dtype=bo + ("f2" if bits == 16 else "f4"),
                count=bh * wc,
            )
        else:
            raise DngError(f"unsupported float predictor {predictor}")
        return _shape(arr.astype(np.float32))

    if bits == 16:
        arr = np.frombuffer(data, dtype=bo + "u2", count=bh * wc)
        wrap_dtype = np.uint16
    elif bits == 8:
        arr = np.frombuffer(data, np.uint8, count=bh * wc)
        wrap_dtype = np.uint8  # differences wrap at the sample width
    else:
        raise DngError(f"unsupported deflate bit depth {bits}")
    arr = arr.reshape(bh, wc)
    step = _INT_PREDICTOR_STEP.get(predictor)
    if step is None:
        raise DngError(f"unsupported integer predictor {predictor}")
    if step > 1 and spp != 1:
        raise DngError(
            f"CFA-pitch predictor {predictor} with {spp} samples/pixel"
        )
    stride = step * spp
    if stride:
        out = arr.astype(np.uint64)
        for lane in range(stride):
            out[:, lane::stride] = np.cumsum(out[:, lane::stride], axis=1)
        arr = out.astype(wrap_dtype)
    return _shape(np.ascontiguousarray(arr.astype(np.uint16)))


def _deflate_encode_block(
    block: np.ndarray, predictor: int, level: int = 6
) -> bytes:
    """Inverse of _deflate_decode_block for the writer (round-trip gated).

    ``block`` is [h, w] single-sample or [h, w, spp] interleaved."""
    import zlib

    spp = 1 if block.ndim == 2 else block.shape[2]
    bh = block.shape[0]
    wc = block.shape[1] * spp
    if block.dtype.kind == "f":
        bps = block.dtype.itemsize
        if predictor == 3:
            be = np.frombuffer(
                np.ascontiguousarray(block.astype(">f2" if bps == 2 else ">f4")
                                     ).tobytes(), np.uint8,
            ).reshape(bh, wc, bps)
            planes = np.moveaxis(be, 2, 1).reshape(bh, bps * wc)
            diff = planes.astype(np.int64)
            diff[:, spp:] = diff[:, spp:] - diff[:, :-spp]
            payload = diff.astype(np.uint8).tobytes()
        elif predictor == 1:
            payload = np.ascontiguousarray(
                block.astype("<f2" if bps == 2 else "<f4")).tobytes()
        else:
            raise DngError(f"unsupported float predictor {predictor}")
        return zlib.compress(payload, level)

    step = _INT_PREDICTOR_STEP.get(predictor)
    if step is None:
        raise DngError(f"unsupported integer predictor {predictor}")
    if step > 1 and spp != 1:
        raise DngError(
            f"CFA-pitch predictor {predictor} with {spp} samples/pixel"
        )
    flat = block.reshape(bh, wc)
    out = flat.astype(np.int64)
    stride = step * spp
    if stride:
        out[:, stride:] -= flat[:, :-stride].astype(np.int64)
    return zlib.compress(out.astype("<u2").tobytes(), level)


def _assemble_chunks(
    decode_one, n_chunks, height, width, rows_per, cols_per, dtype,
    tiled: bool, parallel: bool = True, channels: int = 0,
) -> np.ndarray:
    """Paste decoded strips/tiles into the mosaic (TIFF 6.0 §15 layout:
    tiles across then down; edge tiles stored padded to full tile size and
    cropped here; the last strip is stored short).
    ``decode_one(i, stored_h, stored_w)`` returns [>=h_take, >=w_take]
    samples for chunk i, whose *stored* block dims are passed in.
    ``channels`` > 0 assembles interleaved multi-sample data [H, W, C].
    """
    if rows_per is None or cols_per is None or rows_per < 1 or cols_per < 1:
        raise DngError(
            f"bad strip/tile geometry: rows_per={rows_per} cols_per={cols_per}"
        )
    tiles_across = (width + cols_per - 1) // cols_per
    tiles_down = (height + rows_per - 1) // rows_per
    if n_chunks != tiles_across * tiles_down:
        # A truncated offsets list would otherwise decode to silently
        # zero-filled (black) image regions.
        raise DngError(
            f"{n_chunks} strips/tiles for a {tiles_down}x{tiles_across} grid"
        )
    shape = (height, width) if channels == 0 else (height, width, channels)
    mosaic = np.zeros(shape, dtype=dtype)

    def one(i):
        ty, tx = divmod(i, tiles_across)
        y0, x0 = ty * rows_per, tx * cols_per
        h_take = min(rows_per, height - y0)
        w_take = min(cols_per, width - x0)
        stored_h = rows_per if tiled else h_take
        samples = decode_one(i, stored_h, cols_per)
        if samples.shape[0] < h_take or samples.shape[1] < w_take:
            raise DngError(
                f"chunk {i} decodes to {samples.shape}, expected at least "
                f"({h_take}, {w_take})"
            )
        mosaic[y0 : y0 + h_take, x0 : x0 + w_take] = samples[:h_take, :w_take]

    if parallel and n_chunks > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(min(8, n_chunks)) as pool:
            list(pool.map(one, range(n_chunks)))
    else:
        for i in range(n_chunks):
            one(i)
    return mosaic


def _decode_ljpeg_chunks(
    data: bytes, offsets, counts, height, width, rows_per, cols_per
) -> np.ndarray:
    """Assemble a CFA mosaic from lossless-JPEG tiles or strips.

    DNG stores lossless-JPEG CFA data as independent SOF3 streams, usually
    2-component with columns interleaved (sample x of component c maps to
    mosaic column x*ncomp+c); the decoded stream width must equal the tile
    (or image) width. Tiles are laid out across then down, edge tiles
    padded (TIFF 6.0 §15); the pad is cropped here. Tiles decode in
    parallel threads — the native scan decoder releases the GIL.
    """
    from . import ljpeg

    def one(i, _stored_h, _stored_w):
        o, c = offsets[i], counts[i]
        try:
            samples, _frame = ljpeg.decode(data[o : o + c])
        except ljpeg.LJpegError as e:
            raise DngError(f"chunk {i}: {e}") from e
        return samples

    with span("open.ljpeg"):
        return _assemble_chunks(
            one, len(offsets), height, width, rows_per, cols_per,
            np.uint16, tiled=cols_per < width or rows_per < height,
        )


def _parse_warp_body(body: bytes):
    """Decode one WarpRectilinear (opcode 1) body.

    Params: u32 plane count (1 shared or 3 per-plane), per plane 6 f64
    (kr0..kr3, kt0, kt1), then 2 f64 relative optical center."""
    (nplanes,) = struct.unpack_from(">I", body, 0)
    if nplanes not in (1, 3):
        raise DngError(
            f"WarpRectilinear with {nplanes} coefficient sets")
    coefs = np.frombuffer(
        body, ">f8", count=nplanes * 6, offset=4
    ).reshape(nplanes, 6).astype(np.float32)
    ccx, ccy = struct.unpack_from(">2d", body, 4 + nplanes * 48)
    return coefs, np.asarray([ccx, ccy], dtype=np.float32)


def _parse_warp_rectilinear(opcodes: bytes):
    """Extract WarpRectilinear (opcode 1) from an opcode list, or None."""
    for op_id, body in _iter_opcodes(opcodes):
        if op_id == 1:
            return _parse_warp_body(body)
    return None


def _parse_fisheye_body(body: bytes):
    """Decode one WarpFisheye (opcode 2) body.

    Params: u32 plane count (1 shared or 3 per-plane), per plane 4 f64
    radial terms over theta (kr0..kr3), then 2 f64 relative optical
    center — the rectilinear layout minus the tangential pair."""
    (nplanes,) = struct.unpack_from(">I", body, 0)
    if nplanes not in (1, 3):
        raise DngError(f"WarpFisheye with {nplanes} coefficient sets")
    coefs = np.frombuffer(
        body, ">f8", count=nplanes * 4, offset=4
    ).reshape(nplanes, 4).astype(np.float32)
    ccx, ccy = struct.unpack_from(">2d", body, 4 + nplanes * 32)
    return coefs, np.asarray([ccx, ccy], dtype=np.float32)


def _opcodes_contain(opcodes: bytes, want_ids) -> bool:
    """Scan an opcode list's headers for any of the given ids (cheap)."""
    if isinstance(want_ids, int):
        want_ids = (want_ids,)
    try:
        (count,) = struct.unpack_from(">I", opcodes, 0)
        pos = 4
        for _ in range(count):
            op_id, _v, _f, nbytes = struct.unpack_from(">IIII", opcodes, pos)
            if op_id in want_ids:
                return True
            pos += 16 + nbytes
    except struct.error:
        return False
    return False


def _iter_opcodes(opcodes: bytes):
    """Yield (op_id, body) for each opcode in a big-endian opcode list
    (u32 count, then per opcode u32 id/dng_version/flags/nbytes +
    params). struct.error propagates to the caller's DngError wrap."""
    (count,) = struct.unpack_from(">I", opcodes, 0)
    pos = 4
    for _ in range(count):
        op_id, _ver, _flags, nbytes = struct.unpack_from(
            ">IIII", opcodes, pos)
        pos += 16
        yield op_id, opcodes[pos : pos + nbytes]
        pos += nbytes


def _vignette_radial_gain(h: int, w: int, k, center) -> np.ndarray:
    """FixVignetteRadial gain surface (DNG 1.3 opcode 3, dng_sdk
    dng_vignette_radial_params): gain = 1 + k0 r^2 + k1 r^4 + k2 r^6
    + k3 r^8 + k4 r^10, where r is the distance from the optical center
    (given in relative [0,1] image coordinates, like WarpRectilinear's)
    normalized so the corner FARTHEST from the center has r = 1."""
    cy = float(center[1]) * (h - 1)
    cx = float(center[0]) * (w - 1)
    yy = (np.arange(h, dtype=np.float64) - cy)[:, None]
    xx = (np.arange(w, dtype=np.float64) - cx)[None, :]
    m2 = max(cy, h - 1 - cy) ** 2 + max(cx, w - 1 - cx) ** 2
    r2 = (yy * yy + xx * xx) / max(m2, 1e-12)
    g = np.ones_like(r2)
    p = np.ones_like(r2)
    for ki in k:
        p = p * r2
        g = g + float(ki) * p
    return g.astype(np.float32)


def _parse_vignette_radial(opcodes: bytes):
    """Extract FixVignetteRadial (opcode 3) from an opcode list, or
    None. Params: 5 f64 k0..k4, then 2 f64 relative optical center."""
    for op_id, body in _iter_opcodes(opcodes):
        if op_id != 3:
            continue
        vals = struct.unpack_from(">7d", body, 0)
        return (np.asarray(vals[:5], dtype=np.float32),
                np.asarray(vals[5:7], dtype=np.float32))
    return None


def _area_lattice(body, h, w, offset=0):
    """Decode the 8-u32 DNG AreaSpec (top,left,bottom,right, plane,
    planes, row_pitch, col_pitch) into (rows, cols, plane, planes) index
    vectors clipped to an h x w image, or None for an empty area."""
    (top, left, bottom, right, plane, planes, row_pitch,
     col_pitch) = struct.unpack_from(">8I", body, offset)
    bottom = min(bottom, h)
    right = min(right, w)
    if top >= bottom or left >= right:
        return None
    rows = np.arange(top, bottom, max(row_pitch, 1))
    cols = np.arange(left, right, max(col_pitch, 1))
    return rows, cols, plane, planes


# Opcode ids OpcodeList2 application understands (DNG 1.3 §opcodes).
# FixVignetteRadial, MapTable, MapPolynomial, GainMap, DeltaPerRow,
# DeltaPerColumn, ScalePerRow, ScalePerColumn
_LIST2_IDS = (3, 7, 8, 9, 10, 11, 12, 13)


def _apply_one_gain_map(out: np.ndarray, body: bytes) -> None:
    """Apply ONE GainMap opcode (id 9) body to ``out`` in place.

    GainMap params: AreaSpec (top,left,bottom,right, plane,planes,
    row_pitch,col_pitch u32), points_v,points_h (u32),
    spacing_v,spacing_h, origin_v,origin_h (f64), map_planes (u32),
    then f32 gains [points_v][points_h][map_planes]. Gains sample
    bilinearly in normalized image coordinates and multiply the pixels
    of the opcode's pitched area."""
    h, w = out.shape[:2]
    area = _area_lattice(body, h, w)
    pts_v, pts_h = struct.unpack_from(">2I", body, 32)
    spacing_v, spacing_h, origin_v, origin_h = struct.unpack_from(
        ">4d", body, 40)
    (map_planes,) = struct.unpack_from(">I", body, 72)
    n = pts_v * pts_h * map_planes
    gains = np.frombuffer(body, ">f4", count=n, offset=76).reshape(
        pts_v, pts_h, map_planes).astype(np.float32)
    if area is None or pts_v < 1 or pts_h < 1:
        return
    rows, cols, plane, planes = area
    # Normalized image coordinates -> fractional map indices.
    mv = ((rows / max(h - 1, 1)) - origin_v) / max(spacing_v, 1e-12)
    mh = ((cols / max(w - 1, 1)) - origin_h) / max(spacing_h, 1e-12)
    mv = np.clip(mv, 0.0, pts_v - 1.0)
    mh = np.clip(mh, 0.0, pts_h - 1.0)
    v0 = np.minimum(mv.astype(np.int32), pts_v - 2 if pts_v > 1 else 0)
    h0 = np.minimum(mh.astype(np.int32), pts_h - 2 if pts_h > 1 else 0)
    fv = (mv - v0)[:, None] if pts_v > 1 else np.zeros((len(rows), 1))
    fh = (mh - h0)[None, :] if pts_h > 1 else np.zeros((1, len(cols)))
    v1 = np.minimum(v0 + 1, pts_v - 1)
    h1 = np.minimum(h0 + 1, pts_h - 1)

    def interp(g):
        return ((1 - fv) * (1 - fh) * g[np.ix_(v0, h0)]
                + (1 - fv) * fh * g[np.ix_(v0, h1)]
                + fv * (1 - fh) * g[np.ix_(v1, h0)]
                + fv * fh * g[np.ix_(v1, h1)]).astype(np.float32)

    sub = out[np.ix_(rows, cols)]
    if sub.ndim == 3:
        # LinearRaw: honor the Plane/Planes selectors — each
        # opcode touches channels [plane, plane+planes), sampling
        # map plane min(j, map_planes-1) for channel offset j.
        nch = sub.shape[2]
        p0 = min(plane, nch)
        pn = min(planes if planes > 0 else nch, nch - p0)
        for j in range(pn):
            gm = interp(gains[..., min(j, map_planes - 1)])
            sub[..., p0 + j] *= gm
        out[np.ix_(rows, cols)] = sub
    else:
        # CFA: the pitched (top, left, row/col pitch) lattice IS
        # the plane selection; one map plane applies to it.
        out[np.ix_(rows, cols)] = sub * interp(gains[..., 0])


def _apply_one_map_polynomial(out: np.ndarray, body: bytes) -> None:
    """Apply ONE MapPolynomial opcode (id 8) body to ``out`` in place.

    Params: AreaSpec (8 u32), u32 degree, then degree+1 f64
    coefficients. Output = sum coef_i * value^i over the pitched area
    and plane selection, clipped to [0, 1] (the linear-reference range
    OpcodeList2 is defined over — dng_sdk clamps the same way)."""
    h, w = out.shape[:2]
    area = _area_lattice(body, h, w)
    (degree,) = struct.unpack_from(">I", body, 32)
    if degree > 32:
        raise ValueError(f"MapPolynomial degree {degree}")
    coefs = struct.unpack_from(f">{degree + 1}d", body, 36)
    if area is None:
        return
    rows, cols, plane, planes = area
    sub = out[np.ix_(rows, cols)].astype(np.float64)

    def poly(v):
        acc = np.full_like(v, coefs[degree])
        for c in coefs[degree - 1 :: -1] if degree else []:
            acc = acc * v + c
        return np.clip(acc, 0.0, 1.0).astype(np.float32)

    if sub.ndim == 3:
        nch = sub.shape[2]
        p0 = min(plane, nch)
        pn = min(planes if planes > 0 else nch, nch - p0)
        res = out[np.ix_(rows, cols)]
        for j in range(pn):
            res[..., p0 + j] = poly(sub[..., p0 + j])
        out[np.ix_(rows, cols)] = res
    else:
        out[np.ix_(rows, cols)] = poly(sub)


def _apply_one_map_table(out: np.ndarray, body: bytes) -> None:
    """Apply ONE MapTable opcode (id 7) body to ``out`` in place.

    Params: AreaSpec (8 u32), u32 tableSize (1..65536), then tableSize
    big-endian u16 entries. The table is defined over the 16-bit
    linear-reference domain: each value indexes round(v * 65535), the
    table is conceptually extended to 65536 entries by replicating its
    last entry (dng_sdk dng_opcode_MapTable's fill), and the looked-up
    entry maps back as table[i] / 65535."""
    h, w = out.shape[:2]
    area = _area_lattice(body, h, w)
    (count,) = struct.unpack_from(">I", body, 32)
    if not 1 <= count <= 65536:
        raise ValueError(f"MapTable size {count}")
    if len(body) < 36 + 2 * count:
        raise ValueError("MapTable body truncated")
    table = (np.frombuffer(body, ">u2", count=count, offset=36)
             .astype(np.float32) / 65535.0)
    if area is None:
        return
    rows, cols, plane, planes = area

    def lut(v):
        # fp32 HDR deflate mosaics can carry isolated NaNs; rint/clip
        # pass NaN through and the int32 cast would yield a platform-
        # dependent garbage index (IndexError aborting the whole decode
        # on some platforms, silent nonsense on others). Map NaN to
        # index 0 deterministically instead.
        idx = np.clip(np.rint(np.nan_to_num(v) * 65535.0),
                      0, count - 1).astype(np.int32)
        return table[idx]

    sub = out[np.ix_(rows, cols)]
    if sub.ndim == 3:
        nch = sub.shape[2]
        p0 = min(plane, nch)
        pn = min(planes if planes > 0 else nch, nch - p0)
        for j in range(pn):
            sub[..., p0 + j] = lut(sub[..., p0 + j])
        out[np.ix_(rows, cols)] = sub
    else:
        out[np.ix_(rows, cols)] = lut(sub)


def _apply_one_per_row_col(out: np.ndarray, body: bytes,
                           op_id: int) -> None:
    """Apply ONE DeltaPerRow/DeltaPerColumn/ScalePerRow/ScalePerColumn
    opcode (ids 10/11/12/13) body to ``out`` in place.

    Params: AreaSpec (8 u32), u32 count, then count f32 values — one
    per pitched row (PerRow) or pitched column (PerColumn) of the area.
    Delta adds, Scale multiplies; results are clipped to [0, 1] (the
    linear-reference range OpcodeList2 is defined over, matching the
    MapPolynomial convention above). A table shorter than the area's
    row/column lattice is malformed (dng_sdk rejects it too)."""
    h, w = out.shape[:2]
    area = _area_lattice(body, h, w)
    (count,) = struct.unpack_from(">I", body, 32)
    if len(body) < 36 + 4 * count:
        raise ValueError("per-row/column opcode body truncated")
    vals = np.frombuffer(body, ">f4", count=count,
                         offset=36).astype(np.float32)
    if area is None:
        return
    rows, cols, plane, planes = area
    per_row = op_id in (10, 12)
    n = len(rows) if per_row else len(cols)
    if count < n:
        raise ValueError(
            f"opcode {op_id} carries {count} values for {n} "
            f"{'rows' if per_row else 'columns'}")
    vec = vals[:n][:, None] if per_row else vals[:n][None, :]

    def apply(v):
        r = v + vec if op_id in (10, 11) else v * vec
        return np.clip(r, 0.0, 1.0).astype(np.float32)

    sub = out[np.ix_(rows, cols)]
    if sub.ndim == 3:
        nch = sub.shape[2]
        p0 = min(plane, nch)
        pn = min(planes if planes > 0 else nch, nch - p0)
        for j in range(pn):
            sub[..., p0 + j] = apply(sub[..., p0 + j])
        out[np.ix_(rows, cols)] = sub
    else:
        out[np.ix_(rows, cols)] = apply(sub)


def _apply_gain_maps(mosaic: np.ndarray, opcodes: bytes) -> np.ndarray:
    """Apply OpcodeList2 opcodes in listed order — GainMap (id 9, the
    per-plane shading correction phone DNGs rely on), FixVignetteRadial
    (id 3, radial polynomial shading gain), MapPolynomial (id 8,
    per-value tone mapping some HDR DNGs carry), MapTable (id 7), and
    the per-row/column flat-field corrections DeltaPerRow/DeltaPerColumn/
    ScalePerRow/ScalePerColumn (ids 10-13). ``mosaic`` must
    already hold linear reference values (normalized floats — the stage
    OpcodeList2 is defined at).

    Opcode lists are big-endian: u32 count, then per opcode
    (u32 id, u32 dng_version, u32 flags, u32 nbytes, params). Unknown
    opcodes are skipped (the optional-flag pragmatics real decoders
    use).
    """
    out = mosaic.astype(np.float32, copy=True)
    h, w = out.shape[:2]
    try:
        for op_id, body in _iter_opcodes(opcodes):
            if op_id == 9:
                _apply_one_gain_map(out, body)
            elif op_id == 3:
                vals = struct.unpack_from(">7d", body, 0)
                g = _vignette_radial_gain(h, w, vals[:5], vals[5:7])
                out *= g if out.ndim == 2 else g[:, :, None]
            elif op_id == 8:
                _apply_one_map_polynomial(out, body)
            elif op_id == 7:
                _apply_one_map_table(out, body)
            elif op_id in (10, 11, 12, 13):
                _apply_one_per_row_col(out, body, op_id)
    except (struct.error, ValueError, IndexError) as e:
        raise DngError(f"malformed OpcodeList2: {e}") from e
    return out


def _shifted(a: np.ndarray, dy: int, dx: int):
    """(values, valid) of ``a`` shifted by (dy, dx) with zero fill —
    out-of-bounds positions are invalid (no wraparound)."""
    h, w = a.shape
    out = np.zeros_like(a)
    valid = np.zeros((h, w), bool)
    ys, yd = (slice(dy, h), slice(0, h - dy)) if dy >= 0 else (
        slice(0, h + dy), slice(-dy, h))
    xs, xd = (slice(dx, w), slice(0, w - dx)) if dx >= 0 else (
        slice(0, w + dx), slice(-dx, w))
    out[yd, xd] = a[ys, xs]
    valid[yd, xd] = True
    return out, valid


def _interpolate_bad_pixels(mosaic: np.ndarray, bad: np.ndarray,
                            period: tuple[int, int]) -> np.ndarray:
    """Replace ``bad`` pixels with the mean of their nearest GOOD
    same-CFA-channel neighbors (the straight/diagonal lattice at the
    CFA period — same-period offsets always hit the same channel in any
    repeating CFA). Larger bad clusters (FixBadPixelsList rects) fill
    iteratively from their rims; pixels no pass can reach (pathological
    all-bad inputs) are left stored."""
    py, px = max(int(period[0]), 1), max(int(period[1]), 1)
    m = mosaic.astype(np.float32, copy=True)
    bad = bad.copy()
    offs = [(-py, 0), (py, 0), (0, -px), (0, px),
            (-py, -px), (-py, px), (py, -px), (py, px)]
    for _ in range(64):
        if not bad.any():
            break
        acc = np.zeros_like(m)
        cnt = np.zeros(m.shape, np.int32)
        for dy, dx in offs:
            v, ok = _shifted(m, dy, dx)
            okg, _ = _shifted((~bad).astype(np.uint8), dy, dx)
            use = ok & (okg != 0)
            acc += np.where(use, v, 0.0)
            cnt += use
        fix = bad & (cnt > 0)
        if not fix.any():
            break  # unreachable cluster: give up rather than loop
        m[fix] = acc[fix] / cnt[fix]
        bad &= ~fix
    if mosaic.dtype.kind in "ui":
        info = np.iinfo(mosaic.dtype)
        return np.clip(np.rint(m), info.min, info.max).astype(mosaic.dtype)
    return m.astype(mosaic.dtype)


def _apply_opcode_list1(mosaic: np.ndarray, opcodes: bytes,
                        period: tuple[int, int]) -> np.ndarray:
    """Apply OpcodeList1 bad-pixel opcodes to the STORED mosaic (the
    stage OpcodeList1 is defined at — before LinearizationTable and the
    ActiveArea crop, full-sensor coordinates).

    FixBadPixelsConstant (id 4: u32 constant, u32 bayerPhase): every
    pixel equal to the constant is defective and is interpolated from
    same-channel neighbors (integer mosaics only — the constant marker
    is an integer-data device convention).
    FixBadPixelsList (id 5: u32 bayerPhase, u32 point count, u32 rect
    count, then (row, col) u32 points and (top, left, bottom, right)
    u32 rects): listed pixels/areas are defective.
    The bayerPhase parameter is redundant with the file's CFAPattern
    (which this reader already phase-corrects); interpolation uses the
    CFA-period lattice, which is phase-safe for any repeating CFA.
    Other list-1 opcodes are skipped (optional-flag pragmatics)."""
    h, w = mosaic.shape[:2]
    bad = np.zeros((h, w), bool)
    try:
        for op_id, body in _iter_opcodes(opcodes):
            if op_id == 4 and mosaic.dtype.kind in "ui":
                constant, _phase = struct.unpack_from(">2I", body, 0)
                bad |= mosaic == constant
            elif op_id == 5:
                _phase, npts, nrects = struct.unpack_from(">3I", body, 0)
                pts = np.frombuffer(body, ">u4", count=2 * npts,
                                    offset=12).reshape(npts, 2)
                inb = (pts[:, 0] < h) & (pts[:, 1] < w)
                bad[pts[inb, 0], pts[inb, 1]] = True
                roff = 12 + 8 * npts
                rects = np.frombuffer(body, ">u4", count=4 * nrects,
                                      offset=roff).reshape(nrects, 4)
                for top, left, bottom, right in rects:
                    bad[min(top, h) : min(bottom, h),
                        min(left, w) : min(right, w)] = True
    except (struct.error, ValueError, IndexError) as e:
        raise DngError(f"malformed OpcodeList1: {e}") from e
    if not bad.any():
        return mosaic
    return _interpolate_bad_pixels(mosaic, bad, period)


T_JPEG_INTERCHANGE = 513        # EXIF thumbnail offset (IFD1)
T_JPEG_INTERCHANGE_LEN = 514
T_JPG_FROM_RAW = 0x002E         # Panasonic RW2: full JPEG as a tag value


def _format_exif(lookup) -> dict:
    """Shared EXIF field formatting for the TIFF-family RAW readers
    (DNG walker + CR2). ``lookup(tag_id)`` returns the raw tag value or
    None; one formatting rule set keeps DNG and CR2 sessions reporting
    identically-formatted EXIF (the lens-DB resolver matches on these
    strings)."""
    # Every field guards its own type: a crafted/corrupt file can store
    # any tag with any TIFF type, and one junk field must neither raise
    # (AttributeError/TypeError escape the error taxonomy) nor suppress
    # the other, valid fields.
    exif = {}
    make, model = lookup(T_MAKE), lookup(T_MODEL)
    if isinstance(make, str) and make.strip():
        exif["Make"] = make.strip()
    if isinstance(model, str) and model.strip():
        exif["Model"] = model.strip()
    et = lookup(T_EXPOSURE_TIME)
    if isinstance(et, (int, float)) and et > 0:
        exif["ExposureTime"] = f"1/{round(1.0 / et)}" if et < 1 else str(et)
    fn = lookup(T_F_NUMBER)
    if isinstance(fn, (int, float)) and fn > 0:
        exif["FNumber"] = str(fn)
    iso = lookup(T_ISO)
    if isinstance(iso, list) and iso:
        iso = iso[0]
    if isinstance(iso, (int, float)) and iso > 0:
        exif["ISO"] = str(int(iso))
    fl = lookup(T_FOCAL_LENGTH)
    if isinstance(fl, list) and fl:
        fl = fl[0]
    if isinstance(fl, (int, float)) and fl > 0:
        exif["FocalLength"] = str(fl)
    f35 = lookup(T_FOCAL_LENGTH_35MM)
    if isinstance(f35, list) and f35:
        f35 = f35[0]
    if isinstance(f35, (int, float)) and f35 > 0:
        # Not one of the reference's 11 display fields, but the lens-DB
        # crop-factor rescale keys on it (lensdb.profile_from_exif:
        # crop = FocalLengthIn35mmFilm / FocalLength).
        exif["FocalLengthIn35mmFilm"] = str(int(f35))
    lens = lookup(T_LENS_MODEL)
    if isinstance(lens, str) and lens.strip():
        exif["LensModel"] = lens.strip()
    # Capture time: prefer DateTimeOriginal (EXIF sub-IFD) over the file
    # modification DateTime (IFD0).
    # each candidate is validated on its own: a truthy mis-typed
    # DateTimeOriginal must not suppress a valid IFD0 DateTime string.
    for dt in (lookup(T_DATETIME_ORIGINAL), lookup(T_DATETIME)):
        if isinstance(dt, str) and dt.strip():
            exif["DateTime"] = dt.strip()
            break
    return exif


def _walk_all_ifds(data: bytes, bo: str) -> list[dict]:
    """IFD0 chain plus every SubIFD of each — the full IFD forest."""
    (ifd0_off,) = struct.unpack_from(bo + "I", data, 4)
    ifds = []
    off = ifd0_off
    seen = set()
    while off and off not in seen and off + 2 <= len(data):
        seen.add(off)
        entries, off = _read_ifd(data, off, bo)
        ifds.append(entries)
    for e in list(ifds):
        if T_SUB_IFDS in e:
            subs = _value(data, e[T_SUB_IFDS], bo)
            for s in subs if isinstance(subs, list) else [subs]:
                if isinstance(s, int) and 0 < s < len(data) and s not in seen:
                    seen.add(s)
                    sub, _ = _read_ifd(data, s, bo)
                    ifds.append(sub)
    return ifds


def extract_container_tags(data: bytes, tags) -> dict:
    """First-found raw values for ``tags`` across a TIFF container's IFD
    forest (plus EXIF sub-IFDs), without decoding sensor data. Returns
    {} for non-TIFF or malformed input; never raises (best-effort
    metadata). Callers merging several TIFF streams (CR3 CMT blocks)
    merge at THIS tag level so cross-stream preferences like
    DateTimeOriginal-over-DateTime still hold after the merge."""
    out: dict = {}
    try:
        if data[:2] == b"II":
            bo = "<"
        elif data[:2] == b"MM":
            bo = ">"
        else:
            return out
        (magic,) = struct.unpack_from(bo + "H", data, 2)
        # TIFF + Olympus ORF variants + Panasonic RW2 (0x55).
        if magic not in (42, 0x4F52, 0x5352, 0x0055):
            return out
        ifds = _walk_all_ifds(data, bo)
        seen_exif = set()
        for e in list(ifds):
            if T_EXIF_IFD in e:
                try:
                    off = _value(data, e[T_EXIF_IFD], bo)
                    if isinstance(off, int) and off not in seen_exif:
                        seen_exif.add(off)
                        sub, _ = _read_ifd(data, off, bo)
                        ifds.append(sub)
                except (struct.error, KeyError):
                    pass
        for t in tags:
            for e in ifds:
                if t in e:
                    try:
                        out[t] = _value(data, e[t], bo)
                        break
                    except (struct.error, KeyError):
                        continue
        return out
    except Exception:  # noqa: BLE001 — best-effort metadata, never fatal
        return out


_EXIF_TAGS = (T_MAKE, T_MODEL, T_EXPOSURE_TIME, T_F_NUMBER, T_ISO,
              T_FOCAL_LENGTH, T_FOCAL_LENGTH_35MM, T_LENS_MODEL,
              T_DATETIME_ORIGINAL, T_DATETIME)


def extract_container_exif(data: bytes) -> dict:
    """Capture metadata from a TIFF-structured container WITHOUT decoding
    sensor data: walk the full IFD forest (plus EXIF sub-IFDs) and build
    the same dict read_dng produces. Used by the embedded-preview
    fallback — the camera preview JPEG usually has no EXIF of its own,
    but the container's TIFF tags (Make/Model/ExposureTime/DateTime) are
    still authoritative. Returns {} for non-TIFF or malformed input."""
    return _format_exif(extract_container_tags(data, _EXIF_TAGS).get)


def _best_jpeg(cands) -> Optional[bytes]:
    """Largest-AREA candidate that survives a FULL Pillow decode
    (verify() passes SOF3 structure and says nothing about truncation).

    Candidates rank by decoded pixel dimensions from a cheap header
    parse — NOT by slice length: vendor-preview slices run from an SOI to
    their region end, so byte length measures the enclosing region (a
    thumbnail inside a big region would beat a full-size preview). The
    winner is trimmed to the bytes the decoder actually consumed, so
    megabytes of trailing sensor payload after the EOI never leak into
    the returned 'JPEG'. Accepts bytes or zero-copy memoryviews; only
    candidates that reach the full decode are materialized."""
    import io as _io

    from PIL import Image as PILImage

    def header_area(cand):
        try:
            with PILImage.open(_io.BytesIO(cand)) as im:
                return im.size[0] * im.size[1]
        except Exception:  # noqa: BLE001 — unparseable header
            return -1

    for cand in sorted(cands, key=header_area, reverse=True):
        try:
            bio = _io.BytesIO(cand)
            img = PILImage.open(bio)
            img.load()
            # bio.tell() after the full decode bounds the JPEG's true
            # length (the decoder stops at EOI, modulo read-ahead).
            end = min(len(cand), bio.tell())
            return bytes(cand[:end]) if end < len(cand) else (
                cand if isinstance(cand, bytes) else bytes(cand))
        except Exception:  # noqa: BLE001 — try the next candidate
            continue
    return None


def extract_preview(data: bytes) -> Optional[bytes]:
    """Return the largest embedded JPEG preview/thumbnail, or None.

    RAW containers usually embed rendered JPEG previews (DNG preview
    IFDs with Compression=7 and a non-CFA photometric; Canon CR2's IFD0
    full-size preview with Compression=6; EXIF IFD1 thumbnails via
    JPEGInterchangeFormat) — the instant-display images the reference
    gets from rawler/exiftool. Non-TIFF vendor containers (Fujifilm RAF,
    Canon CR3 BMFF) route through io/vendor_preview. Candidates are
    validated with Pillow (so an SOF3/corrupt strip can't masquerade as
    a decodable preview); malformed containers return None rather than
    raising."""
    try:
        if data[:2] == b"II":
            bo = "<"
        elif data[:2] == b"MM":
            bo = ">"
        else:
            from .vendor_preview import vendor_preview_candidates

            return _best_jpeg(vendor_preview_candidates(data))
        cands = []
        for e in _walk_all_ifds(data, bo):
            def val(t, default=None):
                return _value(data, e[t], bo) if t in e else default

            cand = None
            if T_JPG_FROM_RAW in e:
                v = val(T_JPG_FROM_RAW)
                if isinstance(v, (bytes, bytearray)):
                    cand = bytes(v)
            elif T_JPEG_INTERCHANGE in e and T_JPEG_INTERCHANGE_LEN in e:
                o = val(T_JPEG_INTERCHANGE)
                n = val(T_JPEG_INTERCHANGE_LEN)
                if isinstance(o, int) and isinstance(n, int):
                    cand = data[o : o + n]
            else:
                comp = val(T_COMPRESSION, 1)
                photometric = val(T_PHOTOMETRIC, 0)
                if comp in (6, 7) and photometric != PHOTOMETRIC_CFA:
                    offs = val(T_STRIP_OFFSETS)
                    cnts = val(T_STRIP_BYTE_COUNTS)
                    if isinstance(offs, list):
                        offs, cnts = offs[0], (
                            cnts[0] if isinstance(cnts, list) else cnts)
                    if isinstance(offs, int) and isinstance(cnts, int):
                        cand = data[offs : offs + cnts]
            if cand and cand[:2] == b"\xff\xd8":
                cands.append(cand)
        return _best_jpeg(cands)
    except Exception:  # noqa: BLE001 — best-effort on untrusted bytes
        return None


def read_dng(data: bytes, apply_opcodes: bool = True) -> RawImage:
    """Parse DNG/TIFF bytes into a RawImage.

    Untrusted-input contract: malformed bytes (truncation, corruption)
    raise DngError — low-level parse failures never escape (the CLI and
    server map PhotoEditorError to friendly failures; fuzzed in
    tests/test_dng_fuzz.py).

    ``apply_opcodes=False`` is the lossless-transcode mode: GainMap is
    NOT baked in (the mosaic keeps its stored integer values), the warp
    is not scheduled for develop, and the raw OpcodeList2/3 blobs ride on
    ``RawImage.opcode_lists`` so write_dng re-serializes them."""
    import struct as _struct

    try:
        return _read_dng(data, apply_opcodes)
    except (PhotoEditorError, MemoryError):
        raise
    except (_struct.error, ValueError, IndexError, KeyError, TypeError,
            OverflowError, OSError) as e:
        raise DngError(f"malformed RAW container: {e}") from e


def _read_dng(data: bytes, apply_opcodes: bool = True) -> RawImage:
    if data[:2] == b"II":
        bo = "<"
    elif data[:2] == b"MM":
        bo = ">"
    else:
        raise DngError("not a TIFF container")
    (magic,) = struct.unpack_from(bo + "H", data, 2)
    # 42 is classic TIFF; Olympus ORF keeps the TIFF structure but stamps
    # 'RO'/'SR' (0x4F52/0x5352) as the magic (exiftool Olympus notes).
    if magic not in (42, 0x4F52, 0x5352):
        raise DngError(f"bad TIFF magic 0x{magic:04X}")
    (ifd0_off,) = struct.unpack_from(bo + "I", data, 4)

    # Walk IFD0 + SubIFDs; pick the CFA IFD (PhotometricInterpretation 32803),
    # falling back to the largest strip-bearing IFD.
    ifds = []
    entries, next_off = _read_ifd(data, ifd0_off, bo)
    ifds.append(entries)
    if T_SUB_IFDS in entries:
        try:
            subs = _value(data, entries[T_SUB_IFDS], bo)
        except struct.error:
            subs = []  # out-of-line pointer array past EOF
        subs = subs if isinstance(subs, list) else [subs]
        for s in subs:
            # One corrupt/mis-typed SubIFD pointer must not abort the
            # decode (the raw IFD may be elsewhere in the chain; same
            # posture as the EXIF-pointer guard below and
            # _walk_all_ifds' bounds check).
            if not isinstance(s, int) or not 0 < s < len(data):
                continue
            try:
                sub_entries, _ = _read_ifd(data, s, bo)
            except (struct.error, ValueError, KeyError, TypeError):
                continue
            ifds.append(sub_entries)
    seen_offsets = {ifd0_off}
    while next_off and next_off not in seen_offsets:
        # The seen-set breaks cyclic next-IFD pointers in crafted files —
        # an unguarded walk loops forever (same guard as _walk_all_ifds
        # and the CR2 walker).
        seen_offsets.add(next_off)
        more, next_off = _read_ifd(data, next_off, bo)
        ifds.append(more)
    # Real DNGs keep ExposureTime/FNumber/ISO/FocalLength/LensModel in an
    # EXIF sub-IFD (tag 34665), not IFD0 — and which IFD carries the
    # pointer varies (IFD0 in Adobe files; the raw SubIFD in files whose
    # IFD0 is a preview, like ours). Check every walked IFD.
    exif_seen = set()
    for e in list(ifds):
        if T_EXIF_IFD not in e:
            continue
        try:
            off = _value(data, e[T_EXIF_IFD], bo)
            # A mis-typed pointer tag (ASCII/list) must not abort the
            # sensor decode; same guard as extract_container_exif.
            if not isinstance(off, int) or off in exif_seen:
                continue
            exif_seen.add(off)
            exif_ifd, _ = _read_ifd(data, off, bo)
            ifds.append(exif_ifd)
        except (struct.error, KeyError, TypeError):
            pass

    cfa_ifd = photometric = None
    for want in (PHOTOMETRIC_CFA, PHOTOMETRIC_LINEAR_RAW):
        for e in ifds:
            if e.get(T_PHOTOMETRIC) and _value(data, e[T_PHOTOMETRIC], bo) == want:
                cfa_ifd, photometric = e, want
                break
        if cfa_ifd is not None:
            break
    if cfa_ifd is None:
        raise DngError(
            "no CFA or LinearRaw IFD found (not a RAW, or preview only)"
        )

    def tag(e, t, default=None):
        return _value(data, e[t], bo) if t in e else default

    width = tag(cfa_ifd, T_WIDTH)
    height = tag(cfa_ifd, T_LENGTH)
    # Sanity caps protect against corrupted dimension tags turning into
    # multi-GB allocations (largest real sensors are ~150 MP).
    if not (isinstance(width, int) and isinstance(height, int)
            and 0 < width <= 65535 and 0 < height <= 65535
            and width * height <= 500_000_000):
        raise DngError(f"implausible RAW dimensions {width}x{height}")
    bits = tag(cfa_ifd, T_BITS_PER_SAMPLE, 16)
    if isinstance(bits, list):
        bits = bits[0]
    compression = tag(cfa_ifd, T_COMPRESSION, 1)
    if compression not in (1, 7, 8, 32946, COMPRESSION_LOSSY_JPEG,
                           COMPRESSION_SONY_ARW2):
        raise DngError(
            f"unsupported DNG compression {compression} (supported: 1 "
            f"uncompressed, 7 lossless JPEG, 8/32946 deflate, 34892 lossy "
            f"JPEG, 32767 Sony ARW2)"
        )
    sample_format = tag(cfa_ifd, T_SAMPLE_FORMAT, 1)
    if isinstance(sample_format, list):
        sample_format = sample_format[0]
    if sample_format not in (1, 3):
        raise DngError(f"unsupported SampleFormat {sample_format}")
    if sample_format == 3 and compression not in (1, 8, 32946):
        # Floating-point data is handled on the uncompressed and deflate
        # paths only; letting it fall into an integer entropy branch would
        # reinterpret half-float bits as u16 — silently wrong output
        # instead of a typed error.
        raise DngError(
            f"float DNG (SampleFormat=3) with compression {compression} "
            f"is not supported (uncompressed or deflate only)"
        )
    predictor = int(tag(cfa_ifd, T_PREDICTOR, 1))

    tiled = T_TILE_OFFSETS in cfa_ifd
    if tiled:
        offsets = tag(cfa_ifd, T_TILE_OFFSETS)
        counts = tag(cfa_ifd, T_TILE_BYTE_COUNTS)
    else:
        offsets = tag(cfa_ifd, T_STRIP_OFFSETS)
        counts = tag(cfa_ifd, T_STRIP_BYTE_COUNTS)
    offsets = offsets if isinstance(offsets, list) else [offsets]
    counts = counts if isinstance(counts, list) else [counts]

    pattern = None
    arw2_white_default = None
    if photometric == PHOTOMETRIC_LINEAR_RAW:
        spp = tag(cfa_ifd, T_SAMPLES_PER_PIXEL, 1)
        if spp != 3:
            raise DngError(
                f"LinearRaw with {spp} samples/pixel is not supported"
            )
        rows_per = (
            tag(cfa_ifd, T_TILE_LENGTH) if tiled
            else tag(cfa_ifd, T_ROWS_PER_STRIP, height)
        )
        cols_per = tag(cfa_ifd, T_TILE_WIDTH) if tiled else width
        if compression == COMPRESSION_LOSSY_JPEG:
            import io as _io

            from PIL import Image as PILImage

            def _one_jpeg(i, stored_h, stored_w):
                o, c = offsets[i], counts[i]
                try:
                    arr = np.array(PILImage.open(_io.BytesIO(data[o : o + c])))
                except Exception as e:  # noqa: BLE001 — PIL raises its own
                    # hierarchy (incl. DecompressionBombError, a direct
                    # Exception subclass) on corrupt embedded JPEGs.
                    raise DngError(f"lossy chunk {i}: {e}") from e
                if arr.ndim != 3 or arr.shape[2] != 3:
                    raise DngError(
                        f"lossy chunk {i} decodes to shape {arr.shape}, "
                        f"expected RGB"
                    )
                return arr.astype(np.uint16)

            mosaic = _assemble_chunks(
                _one_jpeg, len(offsets), height, width, rows_per,
                cols_per, np.uint16, tiled=tiled, channels=3,
            )
        elif compression in (8, 32946):
            # Deflate LinearRaw — the layout HDR-merge tools emit
            # (fp16/fp32 demosaiced data), plus integer u16/u8.
            def _one_deflate3(i, stored_h, stored_w):
                o, c = offsets[i], counts[i]
                return _deflate_decode_block(
                    data[o : o + c], stored_h, stored_w, bits, predictor,
                    sample_format, bo, spp=3,
                )

            mosaic = _assemble_chunks(
                _one_deflate3, len(offsets), height, width, rows_per,
                cols_per,
                np.float32 if sample_format == 3 else np.uint16,
                tiled=tiled, channels=3,
            )
        elif compression == 1:
            if tiled:
                raise DngError("tiled uncompressed LinearRaw is not supported")
            strip_data = b"".join(
                data[o : o + c] for o, c in zip(offsets, counts)
            )
            n_samples = width * height * 3
            if sample_format == 3:
                if bits not in (16, 32):
                    raise DngError(
                        f"unsupported float LinearRaw depth {bits}"
                    )
                arr = np.frombuffer(
                    strip_data, dtype=bo + ("f2" if bits == 16 else "f4"),
                    count=n_samples,
                ).astype(np.float32)
            elif bits == 16:
                arr = np.frombuffer(strip_data, dtype=bo + "u2", count=n_samples)
            elif bits == 8:
                arr = np.frombuffer(
                    strip_data, dtype=np.uint8, count=n_samples
                ).astype(np.uint16)
            else:
                raise DngError(f"unsupported LinearRaw bit depth {bits}")
            mosaic = arr.reshape(height, width, 3)
        else:
            raise DngError(
                f"unsupported LinearRaw compression {compression}"
            )
        pattern = "RGB"
    elif compression in (7, 8, 32946):
        rows_per = (
            tag(cfa_ifd, T_TILE_LENGTH) if tiled
            else tag(cfa_ifd, T_ROWS_PER_STRIP, height)
        )
        cols_per = tag(cfa_ifd, T_TILE_WIDTH) if tiled else width
        if compression == 7:
            mosaic = _decode_ljpeg_chunks(
                data, offsets, counts, height, width, rows_per, cols_per
            )
        else:
            def _one_deflate(i, stored_h, stored_w):
                o, c = offsets[i], counts[i]
                return _deflate_decode_block(
                    data[o : o + c], stored_h, stored_w, bits, predictor,
                    sample_format, bo,
                )

            mosaic = _assemble_chunks(
                _one_deflate, len(offsets), height, width, rows_per,
                cols_per,
                np.float32 if sample_format == 3 else np.uint16,
                tiled=tiled,
            )
    elif compression == COMPRESSION_SONY_ARW2:
        # Sony ARW2 (cRAW): 8-bit/pixel packed 16-pixel blocks, decoded
        # through the tag-0x7010 companding curve (io/vendor_packed —
        # memory-derived codec, auto-gated by parse_raw's
        # preview-correlation check via needs_verification below).
        from .vendor_packed import decode_arw2, sony_arw2_curve

        if tiled:
            raise DngError("tiled ARW2 is not supported")
        if sample_format != 1:
            raise DngError("ARW2 with non-integer SampleFormat")
        knots = tag(cfa_ifd, T_SONY_CURVE)
        arw2_curve = sony_arw2_curve(knots)
        strip_data = b"".join(data[o : o + c] for o, c in zip(offsets, counts))
        mosaic = decode_arw2(strip_data, width, height, arw2_curve)
        # The curve maps 11-bit codes into the same domain as the Sony
        # black/white tags; when the white tag is absent the curve's own
        # maximum output is the exact representable ceiling.
        arw2_white_default = float(arw2_curve[4094])
    else:
        if compression != 1:
            raise DngError(
                f"compression {compression} is only supported for LinearRaw"
            )
        if tiled:
            raise DngError("tiled uncompressed DNG is not supported")
        strip_data = b"".join(data[o : o + c] for o, c in zip(offsets, counts))
        n_samples = width * height
        if sample_format == 3:
            if bits not in (16, 32):
                raise DngError(
                    f"unsupported float DNG depth {bits} (fp16/fp32 decode "
                    f"natively; fp24 has no IEEE layout to verify against)"
                )
            mosaic = np.frombuffer(
                strip_data, dtype=bo + ("f2" if bits == 16 else "f4"),
                count=n_samples,
            ).astype(np.float32)
        elif bits == 16:
            mosaic = np.frombuffer(strip_data, dtype=bo + "u2", count=n_samples)
        elif bits == 8:
            mosaic = np.frombuffer(
                strip_data, dtype=np.uint8, count=n_samples
            ).astype(np.uint16)
        elif bits in (10, 12, 14):
            packed = np.frombuffer(strip_data, dtype=np.uint8)
            mosaic = _unpack_bits(packed, bits, n_samples)
        else:
            raise DngError(f"unsupported bit depth {bits}")
        mosaic = mosaic.reshape(height, width)

    # OpcodeList1 (DNG 1.3): defined on the STORED image, before
    # LinearizationTable and the ActiveArea crop — full-sensor
    # coordinates. Bad-pixel fixes (FixBadPixelsConstant/List) are the
    # list-1 opcodes cameras actually emit; others are skipped. They
    # describe defective CFA sites, so they only apply to 2-D mosaics
    # (a LinearRaw DNG carrying one is ignored rather than crashed on).
    oplist1 = tag(cfa_ifd, T_OPCODE_LIST_1)
    oplist1 = bytes(oplist1) if isinstance(oplist1, (bytes, bytearray)) \
        else None
    if apply_opcodes and oplist1 is not None and mosaic.ndim == 2 \
            and _opcodes_contain(oplist1, (4, 5)):
        # CFARepeatPatternDim falls back through the whole IFD chain,
        # exactly like the CFA-pattern parse below (real TIFF-EP files
        # store it outside the CFA sub-IFD).
        rep1 = tag(cfa_ifd, T_CFA_REPEAT_DIM)
        if rep1 is None:
            for e in ifds:
                if T_CFA_REPEAT_DIM in e:
                    try:
                        rep1 = _value(data, e[T_CFA_REPEAT_DIM], bo)
                    except struct.error:
                        pass
                    break
        rep1 = rep1 if rep1 is not None else [2, 2]
        rep1 = [int(v) for v in (rep1 if isinstance(rep1, list)
                                 else [rep1, rep1])]
        mosaic = _apply_opcode_list1(mosaic, oplist1,
                                     (rep1[0] or 2, rep1[1] or 2))

    # Sensor linearization (DNG spec 1.4 LinearizationTable, tag 50712):
    # raw values index the table before black/white scaling — some cameras
    # store companded data.
    lintab = tag(cfa_ifd, T_LINEARIZATION_TABLE)
    if lintab is not None and mosaic.dtype.kind == "u":
        lt = np.asarray(
            lintab if isinstance(lintab, list) else [lintab], dtype=np.uint16
        )
        mosaic = lt[np.minimum(mosaic, len(lt) - 1)]

    # ActiveArea (tag 50829: top, left, bottom, right): masked border
    # pixels are cropped out; the CFA phase shifts with the crop origin.
    phase_y = phase_x = 0
    active = tag(cfa_ifd, T_ACTIVE_AREA)
    if isinstance(active, list) and len(active) == 4:
        top, left, bottom, right = (int(v) for v in active)
        if not (0 <= top < bottom <= height and 0 <= left < right <= width):
            raise DngError(f"ActiveArea {active} outside {height}x{width}")
        mosaic = mosaic[top:bottom, left:right]
        height, width = mosaic.shape[:2]
        phase_y, phase_x = top, left

    # CFA pattern: 2x2 Bayer or 6x6 X-Trans (CFARepeatPatternDim). Both
    # tags fall back through the whole IFD chain the same way, so they are
    # always sourced consistently.
    def any_ifd(t, default=None):
        for e in ifds:
            if t in e:
                try:
                    return _value(data, e[t], bo)
                except struct.error:
                    # An out-of-line value offset past EOF (corruption
                    # confined to a metadata tag) must not abort the
                    # sensor decode — _format_exif's one-junk-field
                    # contract, and the posture extract_container_tags
                    # already takes per tag.
                    return default
        return default

    cfa = tag(cfa_ifd, T_CFA_PATTERN) or any_ifd(T_CFA_PATTERN)
    rep = tag(cfa_ifd, T_CFA_REPEAT_DIM) or any_ifd(T_CFA_REPEAT_DIM) or [2, 2]
    rep = [int(v) for v in (rep if isinstance(rep, list) else [rep, rep])]
    if pattern is not None:
        pass  # LinearRaw: demosaiced data, no CFA layout to parse
    elif cfa is None:
        pattern = "RGGB"
    else:
        ph, pw = rep
        n = ph * pw
        if isinstance(cfa, (bytes, bytearray)):
            vals = list(cfa[:n])
        elif isinstance(cfa, list):
            vals = [int(v) for v in cfa[:n]]
        else:
            vals = [int(cfa)]
        if len(vals) < n:
            raise DngError(f"CFAPattern has {len(vals)} codes, expected {n}")
        layout = np.asarray(vals, dtype=np.int32).reshape(ph, pw)
        # ActiveArea origin shifts the CFA phase (modulo the repeat dims).
        eff = np.empty_like(layout)
        for y in range(ph):
            for x in range(pw):
                eff[y, x] = layout[(y + phase_y) % ph, (x + phase_x) % pw]
        if (ph, pw) == (2, 2):
            names = {0: "R", 1: "G", 2: "B"}
            pattern = "".join(names.get(int(v), "G") for v in eff.reshape(-1))
            if pattern not in ("RGGB", "BGGR", "GRBG", "GBRG"):
                raise DngError(f"unsupported CFA pattern {pattern}")
        elif (ph, pw) == (6, 6):
            from ..ops.demosaic import XTRANS

            if not np.array_equal(eff, XTRANS):
                raise DngError(
                    "6x6 CFA layout is not the canonical X-Trans matrix"
                )
            pattern = "XTRANS"
        else:
            raise DngError(f"unsupported CFA repeat dim {ph}x{pw}")

    # Vendor MakerNote (PEF 'AOC', ORF 'OLYMPUS'): documented black/WB
    # fields, used only when the standard DNG + Sony tags are absent
    # (vendor_raw.parse_makernote_wb — formulas from dcraw/exiftool,
    # real files gated by preview_correlation).
    mn_info: dict = {}
    for e in ifds:
        if 0x927C in e:
            from .vendor_raw import parse_makernote_wb

            mn_info = parse_makernote_wb(
                str(any_ifd(T_MAKE) or ""), data, e[0x927C], bo)
            break

    black = any_ifd(T_BLACK_LEVEL)
    if black is None:
        # Sony ARW keeps its black level in the vendor tag 0x7310 of the
        # raw IFD (exiftool Sony BlackLevel, 4 per-CFA-site shorts).
        black = any_ifd(T_SONY_BLACK_LEVEL)
    if black is None:
        black = mn_info.get("black", 0)
    if isinstance(black, list):
        black = float(np.mean(black))
    # Floating-point DNG data is already scene-linear; the spec default
    # white level for SampleFormat=3 is 1.0.
    white = any_ifd(T_WHITE_LEVEL)
    if white is None:
        white = any_ifd(T_SONY_WHITE_LEVEL)  # exiftool Sony WhiteLevel
    if white is None and arw2_white_default is not None:
        # ARW2 stores 8 bits/pixel; (1 << bits) - 1 would be nonsense —
        # the decoded domain's ceiling is the companding curve's maximum.
        white = arw2_white_default
    if white is None:
        white = 1.0 if sample_format == 3 else (1 << bits) - 1
    if isinstance(white, list):
        white = float(white[0])

    wb_known = True
    neutral = any_ifd(T_AS_SHOT_NEUTRAL)
    sony_wb = any_ifd(T_SONY_WB_RGGB)
    if neutral:
        n = np.asarray(neutral, dtype=np.float64)
        wb = tuple((n[1] / np.maximum(n, 1e-8)).tolist())  # gains, g == 1
    elif isinstance(sony_wb, list) and len(sony_wb) >= 4 \
            and all(v > 0 for v in sony_wb[:4]):
        # Sony WB_RGGBLevels (0x7313): multiplier levels in CFA order.
        r, g1, _g2, b = (float(v) for v in sony_wb[:4])
        wb = (r / g1, 1.0, b / g1)
    elif mn_info.get("wb") is not None:
        wb = tuple(mn_info["wb"])
    else:
        wb = (1.0, 1.0, 1.0)
        if pattern != "RGB" and any_ifd(T_DNG_VERSION) is None:
            # A non-DNG TIFF-EP RAW (uncompressed NEF/ARW/ORF/PEF…)
            # whose camera WB lives in an undocumented maker note:
            # flag it so develop estimates gains instead of rendering
            # the unbalanced sensor response (rawpy's no-camera-WB
            # fallback, python-legacy editor.py:169-181 use_camera_wb).
            wb_known = False

    cm = any_ifd(T_COLOR_MATRIX_1)
    xyz_to_cam = (
        np.asarray(cm, dtype=np.float64).reshape(3, 3) if cm is not None else None
    )

    # OpcodeList2 (DNG 1.3): GainMap (id 9), FixVignetteRadial (id 3),
    # MapPolynomial (id 8) — all defined at the linear-reference-value
    # stage, so normalize first and hand develop a float mosaic with
    # black=0/white=1 (phone DNGs — ProRAW, Pixel — rely on this for
    # lens shading).
    oplist2 = tag(cfa_ifd, T_OPCODE_LIST_2)
    oplist3 = tag(cfa_ifd, T_OPCODE_LIST_3)
    oplist2 = bytes(oplist2) if isinstance(oplist2, (bytes, bytearray)) else None
    oplist3 = bytes(oplist3) if isinstance(oplist3, (bytes, bytearray)) else None
    warp = None
    fisheye = None
    vignette = None
    vignette_first = False
    trim = None
    opcode_lists = None
    if not apply_opcodes:
        # Lossless-transcode mode: keep the stored pixel values and the
        # opcode blobs verbatim for re-serialization.
        if oplist1 is not None or oplist2 is not None or oplist3 is not None:
            opcode_lists = (oplist1, oplist2, oplist3)
    else:
        if oplist2 is not None and _opcodes_contain(oplist2, _LIST2_IDS):
            span = max(float(white) - float(black), 1e-9)
            norm = (mosaic.astype(np.float32) - float(black)) / span
            mosaic = _apply_gain_maps(norm, oplist2)
            black, white = 0.0, 1.0
        # OpcodeList3 (post-demosaic corrections, phone DNGs): parsed
        # here, applied by the develop path IN LISTED ORDER — opcode
        # lists apply sequentially, and for FixVignetteRadial before
        # vs after WarpRectilinear the order is observable (the gain
        # samples a different radius at warped corners).
        if oplist3 is not None and _opcodes_contain(oplist3, (1, 2, 3, 6)):
            try:
                for op_id, body in _iter_opcodes(oplist3):
                    if op_id == 1 and warp is None:
                        warp = _parse_warp_body(body)
                    elif op_id == 2 and fisheye is None:
                        fisheye = _parse_fisheye_body(body)
                    elif op_id == 3 and vignette is None:
                        vals = struct.unpack_from(">7d", body, 0)
                        vignette = (
                            np.asarray(vals[:5], dtype=np.float32),
                            np.asarray(vals[5:7], dtype=np.float32))
                        if warp is None and fisheye is None:
                            vignette_first = True
                    elif op_id == 6 and trim is None:
                        # TrimBounds (id 6): u32 top,left,bottom,right.
                        # Realized as a crop on the developed image
                        # (intersected with DefaultCrop below) — i.e.
                        # evaluated after any warp regardless of list
                        # position; real files carrying TrimBounds
                        # alongside a warp are not known to exist.
                        trim = struct.unpack_from(">4I", body, 0)
            except (struct.error, ValueError) as e:
                raise DngError(f"malformed OpcodeList3: {e}") from e

    try:
        orientation = int(any_ifd(T_ORIENTATION, 1) or 1)
    except (TypeError, ValueError):
        orientation = 1  # mis-typed tag (ASCII/list): same as CR2's guard
    if not 1 <= orientation <= 8:
        orientation = 1  # junk tag: display as stored rather than raising

    default_crop = None
    dco = tag(cfa_ifd, T_DEFAULT_CROP_ORIGIN)
    dcs = tag(cfa_ifd, T_DEFAULT_CROP_SIZE)
    if isinstance(dco, list) and isinstance(dcs, list):
        cx, cy = int(dco[0]), int(dco[1])        # [horizontal, vertical]
        cw, ch = int(dcs[0]), int(dcs[1])
        if 0 <= cx and 0 <= cy and cx + cw <= width and cy + ch <= height \
                and cw > 0 and ch > 0:
            default_crop = (cx, cy, cw, ch)

    if trim is not None:
        # TrimBounds composes with DefaultCrop as a rectangle
        # intersection in decoded-mosaic coordinates (DefaultCropOrigin
        # is defined relative to the active area, not to opcode trims).
        t, l, b, r = (int(v) for v in trim)
        b, r = min(b, height), min(r, width)
        if t >= b or l >= r:
            raise DngError(f"TrimBounds {trim} leaves an empty image")
        x0, y0, x1, y1 = l, t, r, b
        if default_crop is not None:
            cx, cy, cw, ch = default_crop
            ix0, iy0 = max(x0, cx), max(y0, cy)
            ix1, iy1 = min(x1, cx + cw), min(y1, cy + ch)
            if ix0 >= ix1 or iy0 >= iy1:
                # Symmetric with the empty-trim DngError above: two
                # disjoint "the visible image is here" claims cannot be
                # reconciled — silently preferring one would render a
                # region the other metadata source says is invalid.
                raise DngError(
                    f"TrimBounds {trim} and DefaultCrop {default_crop} "
                    "do not intersect")
            x0, y0, x1, y1 = ix0, iy0, ix1, iy1
        if (x0, y0, x1, y1) != (0, 0, width, height):
            default_crop = (x0, y0, x1 - x0, y1 - y0)

    exif = _format_exif(any_ifd)

    return RawImage(
        mosaic=np.ascontiguousarray(mosaic),
        pattern=pattern,
        black_level=float(black),
        white_level=float(white),
        wb_gains=wb,
        xyz_to_cam=xyz_to_cam,
        orientation=orientation,
        exif=exif,
        default_crop=default_crop,
        warp_rectilinear=warp,
        warp_fisheye=fisheye,
        vignette_radial=vignette,
        vignette_first=vignette_first,
        opcode_lists=opcode_lists,
        wb_known=wb_known,
        needs_verification=(compression == COMPRESSION_SONY_ARW2),
    )


def write_dng(
    raw: RawImage,
    compression: int = 1,
    tile: Optional[tuple[int, int]] = None,
    predictor: int = 1,
    active_area: Optional[tuple] = None,
    linearization_table: Optional[np.ndarray] = None,
    opcode_list_1: Optional[bytes] = None,
    opcode_list_2: Optional[bytes] = None,
    opcode_list_3: Optional[bytes] = None,
    preview_jpeg: Optional[bytes] = None,
) -> bytes:
    """Emit a minimal valid CFA DNG (little-endian).

    ``compression=1`` writes uncompressed strips; ``compression=7`` writes
    lossless-JPEG (SOF3, 2-component column-interleaved — the layout real
    DNG converters emit); ``compression=8`` writes deflate (integer u16
    with ``predictor`` 1/2/34892/34893, or — when ``raw.mosaic`` is
    floating point — fp16/fp32 HDR data with the TN3 float ``predictor``
    3). With ``tile=(th, tw)`` the compressed variants are tiled (tw must
    be even for SOF3); otherwise one strip covers the image.
    """
    is_rgb = raw.mosaic.ndim == 3
    if is_rgb and raw.mosaic.shape[2] != 3:
        raise DngError(f"LinearRaw mosaic must be [H, W, 3], got "
                       f"{raw.mosaic.shape}")
    h, w = raw.mosaic.shape[:2]
    is_float = raw.mosaic.dtype.kind == "f"
    if is_rgb and compression not in (1, 8):
        raise DngError("LinearRaw writes as uncompressed or deflate")
    if is_float:
        if compression not in (1, 8):
            raise DngError(
                "floating-point mosaics write as uncompressed or deflate")
        bits = 16 if raw.mosaic.dtype == np.float16 else 32
        mosaic = np.ascontiguousarray(
            raw.mosaic.astype("<f2" if bits == 16 else "<f4"))
        if compression == 8 and predictor != 3:
            # Integer predictors (1/2/X2/X4) have no float meaning; remap
            # to the TN3 float predictor — the layout Adobe writes — so
            # callers like `cli convert --codec deflate` work on the float
            # DNGs the reader supports.
            predictor = 3
    else:
        bits = 16
        mosaic = np.ascontiguousarray(raw.mosaic.astype("<u2"))
        if is_rgb and predictor in (34892, 34893):
            predictor = 2  # CFA-pitch predictors are meaningless for RGB

    chunks: list[bytes] = []
    if compression == 8:
        def enc8(block: np.ndarray) -> bytes:
            return _deflate_encode_block(block, predictor)

        if tile is not None:
            th, tw = tile
            for y0 in range(0, h, th):
                for x0 in range(0, w, tw):
                    block = mosaic[y0 : y0 + th, x0 : x0 + tw]
                    if block.shape[:2] != (th, tw):
                        pad = [(0, th - block.shape[0]),
                               (0, tw - block.shape[1])]
                        if block.ndim == 3:
                            pad.append((0, 0))
                        block = np.pad(block, pad, mode="edge")
                    chunks.append(enc8(block))
        else:
            chunks.append(enc8(mosaic))
    elif compression == 7:
        from . import ljpeg

        precision = max(2, int(raw.mosaic.max()).bit_length())

        def enc(block: np.ndarray) -> bytes:
            bh, bw = block.shape
            ncomp = 2 if bw % 2 == 0 else 1
            return ljpeg.encode(
                block.reshape(bh, bw // ncomp, ncomp),
                precision=precision, predictor=predictor, huffman="optimal",
            )

        if tile is not None:
            th, tw = tile
            if tw % 2:
                raise DngError("tile width must be even for 2-component SOF3")
            for y0 in range(0, h, th):
                for x0 in range(0, w, tw):
                    block = mosaic[y0 : y0 + th, x0 : x0 + tw]
                    # Edge tiles are padded to full tile size (TIFF 6.0 §15).
                    if block.shape != (th, tw):
                        block = np.pad(
                            block,
                            ((0, th - block.shape[0]), (0, tw - block.shape[1])),
                            mode="edge",
                        )
                    chunks.append(enc(block))
        else:
            chunks.append(enc(mosaic))
    elif compression == 1:
        if tile is not None:
            raise DngError("tiling is only supported with compression 7/8")
        chunks.append(mosaic.tobytes())
    else:
        raise DngError(f"unsupported write compression {compression}")
    strip = b"".join(chunks)

    if is_rgb:
        cfa_rep = cfa = None
    elif raw.pattern == "XTRANS":
        from ..ops.demosaic import XTRANS

        cfa_rep = [6, 6]
        cfa = bytes(int(v) for v in XTRANS.reshape(-1))
    else:
        cfa_codes = {"R": 0, "G": 1, "B": 2}
        cfa_rep = [2, 2]
        cfa = bytes(cfa_codes[c] for c in raw.pattern)

    entries = []  # (tag, type, count, packed_value_bytes_or_payload)
    extra = []    # out-of-line payloads, filled with offsets later

    def _pack_tag(tag, typ, values):
        if typ == 2:
            payload = values.encode("ascii", "replace") + b"\x00"
            n = len(payload)
        elif typ == 5:  # rational list of (num, den)
            payload = b"".join(struct.pack("<II", a, b) for a, b in values)
            n = len(values)
        else:
            fmt = _TYPE_FMT[typ]
            vals = values if isinstance(values, (list, tuple)) else [values]
            payload = struct.pack("<" + str(len(vals)) + fmt, *vals)
            n = len(vals)
        return [tag, typ, n, payload]

    def add(tag, typ, values):
        entries.append(_pack_tag(tag, typ, values))

    def _neutral_rat(g):
        # AsShotNeutral = 1/gain as an *unsigned* u32 RATIONAL. A zero or
        # tiny gain (crafted AsShotNeutral on the convert transcode path)
        # would overflow the numerator at the fixed 1e6 denominator and
        # escape as struct.error; floor the gain so the largest numerator
        # stays < 2^32, and keep it >= 1 so a huge gain can't serialize a
        # zero neutral (division by zero on read-back).
        num = int(round(1e6 / max(float(g), 2.4e-4)))
        return (min(max(num, 1), 0xFFFFFFFF), 1000000)

    neutral_g = raw.wb_gains
    as_shot = [_neutral_rat(neutral_g[0]), (1000000, 1000000),
               _neutral_rat(neutral_g[2])]

    add(T_NEW_SUBFILE_TYPE, 4, 0)
    add(T_WIDTH, 4, w)
    add(T_LENGTH, 4, h)
    add(T_BITS_PER_SAMPLE, 3, [bits] * 3 if is_rgb else bits)
    add(T_COMPRESSION, 3, compression)
    add(T_PHOTOMETRIC, 3,
        PHOTOMETRIC_LINEAR_RAW if is_rgb else PHOTOMETRIC_CFA)
    if is_float:
        add(T_SAMPLE_FORMAT, 3, [3] * 3 if is_rgb else 3)
    if compression == 8 and predictor != 1:
        add(T_PREDICTOR, 3, predictor)
    if "Make" in raw.exif:
        add(T_MAKE, 2, raw.exif["Make"])
    if "Model" in raw.exif:
        add(T_MODEL, 2, raw.exif["Model"])
    if "DateTime" in raw.exif:
        add(T_DATETIME, 2, str(raw.exif["DateTime"]))

    # EXIF sub-IFD: the capture metadata the reader's _format_exif parses
    # back (the reference round-trips it through exiftool). String fields
    # come from the _format_exif conventions ("1/250", "2.8", ...).
    def _exif_rat(v):
        from .exif import parse_rational

        nd = parse_rational(v)
        return None if nd is None else [nd]

    exif_entries = []
    for tag, key in ((T_EXPOSURE_TIME, "ExposureTime"),
                     (T_F_NUMBER, "FNumber"),
                     (T_FOCAL_LENGTH, "FocalLength")):
        if key in raw.exif:
            r = _exif_rat(raw.exif[key])
            if r is not None:
                exif_entries.append(_pack_tag(tag, 5, r))
    if "ISO" in raw.exif:
        try:
            iso = int(float(raw.exif["ISO"]))
            if 0 <= iso <= 0xFFFF:
                exif_entries.append(_pack_tag(T_ISO, 3, iso))
        except (ValueError, OverflowError):
            pass
    if "FocalLengthIn35mmFilm" in raw.exif:
        try:
            f35 = int(float(raw.exif["FocalLengthIn35mmFilm"]))
            if 0 < f35 <= 0xFFFF:
                exif_entries.append(_pack_tag(T_FOCAL_LENGTH_35MM, 3, f35))
        except (ValueError, OverflowError):
            pass
    if "LensModel" in raw.exif:
        exif_entries.append(_pack_tag(T_LENS_MODEL, 2,
                                      str(raw.exif["LensModel"])))
    if "DateTime" in raw.exif:
        exif_entries.append(_pack_tag(T_DATETIME_ORIGINAL, 2,
                                      str(raw.exif["DateTime"])))
    if exif_entries:
        add(T_EXIF_IFD, 4, 0)  # patched once the layout is known
    if tile is not None:
        add(T_TILE_WIDTH, 4, tile[1])
        add(T_TILE_LENGTH, 4, tile[0])
        add(T_TILE_OFFSETS, 4, [0] * len(chunks))  # patched below
        add(T_TILE_BYTE_COUNTS, 4, [len(c) for c in chunks])
    else:
        add(T_STRIP_OFFSETS, 4, 0)  # patched below
        add(T_ROWS_PER_STRIP, 4, h)
        add(T_STRIP_BYTE_COUNTS, 4, len(strip))
    add(T_ORIENTATION, 3, raw.orientation)
    add(T_SAMPLES_PER_PIXEL, 3, 3 if is_rgb else 1)
    if not is_rgb:
        add(T_CFA_REPEAT_DIM, 3, cfa_rep)
        entries.append([T_CFA_PATTERN, 1, len(cfa), cfa])
    add(T_DNG_VERSION, 1, [1, 4, 0, 0])
    if is_float:
        # Fractional levels for HDR data go out as rationals (the reader's
        # generic tag parser returns them as floats either way). The
        # denominator shrinks for large values so the u32 numerator
        # cannot overflow (e.g. white_level=16383.0 on float data).
        def _rat(v):
            # RATIONAL is unsigned: a negative level (crafted input on the
            # convert transcode path) must not escape as struct.error.
            v = max(0.0, float(v))
            den = 1000000
            while den > 1 and round(v * den) > 0xFFFFFFFF:
                den //= 10
            return (int(round(v * den)), den)

        add(T_BLACK_LEVEL, 5, [_rat(raw.black_level)])
        add(T_WHITE_LEVEL, 5, [_rat(raw.white_level)])
    else:
        add(T_BLACK_LEVEL, 3, int(raw.black_level))
        add(T_WHITE_LEVEL, 3, int(raw.white_level))
    if active_area is not None:
        add(T_ACTIVE_AREA, 4, [int(v) for v in active_area])
    if linearization_table is not None:
        add(T_LINEARIZATION_TABLE, 3,
            [int(v) for v in np.asarray(linearization_table)])
    if raw.opcode_lists is not None:
        # read_dng(apply_opcodes=False) re-serialization (3-tuple of
        # list-1/2/3 blobs; explicit kwargs win).
        if opcode_list_1 is None:
            opcode_list_1 = raw.opcode_lists[0]
        if opcode_list_2 is None:
            opcode_list_2 = raw.opcode_lists[1]
        if opcode_list_3 is None:
            opcode_list_3 = raw.opcode_lists[2]
    if opcode_list_1 is not None:
        entries.append([T_OPCODE_LIST_1, 7, len(opcode_list_1),
                        bytes(opcode_list_1)])
    if opcode_list_2 is not None:
        entries.append([T_OPCODE_LIST_2, 7, len(opcode_list_2),
                        bytes(opcode_list_2)])
    if opcode_list_3 is not None:
        entries.append([T_OPCODE_LIST_3, 7, len(opcode_list_3),
                        bytes(opcode_list_3)])
    if raw.default_crop is not None:
        cx, cy, cw, ch = raw.default_crop
        add(T_DEFAULT_CROP_ORIGIN, 4, [cx, cy])
        add(T_DEFAULT_CROP_SIZE, 4, [cw, ch])
    if raw.xyz_to_cam is not None:
        m = raw.xyz_to_cam.reshape(-1)
        add(T_COLOR_MATRIX_1, 11, [float(v) for v in m])
    add(T_AS_SHOT_NEUTRAL, 5, as_shot)

    entries.sort(key=lambda e: e[0])

    # Optional embedded preview: IFD0 becomes a JPEG preview IFD (the
    # standard DNG layout other software shows as the thumbnail) whose
    # SubIFDs tag points at the raw IFD below.
    preview_block = b""
    if preview_jpeg:
        import io as _io

        from PIL import Image as PILImage

        pw, ph = PILImage.open(_io.BytesIO(preview_jpeg)).size
        pent = [
            (254, 4, 1, 1),          # NewSubfileType: reduced-res preview
            (256, 4, 1, pw), (257, 4, 1, ph),
            (258, 3, 3, 0),          # BitsPerSample [8,8,8]: TIFF 6.0
            #                          requires count == SamplesPerPixel;
            #                          3 SHORTs are out-of-line (below)
            (259, 3, 1, 7), (262, 3, 1, 6),  # JPEG, YCbCr
            (273, 4, 1, 0),          # StripOffsets (patched below)
            (277, 3, 1, 3), (278, 4, 1, ph),
            (279, 4, 1, len(preview_jpeg)),
            (330, 4, 1, 0),          # SubIFDs -> raw IFD (patched below)
        ]
        pifd_size = 2 + len(pent) * 12 + 4
        bps_off = 8 + pifd_size      # the [8,8,8] SHORT triple
        jpeg_off = bps_off + 8       # 6 bytes + 2 pad keeps JPEG even
        raw_base = jpeg_off + len(preview_jpeg) + (len(preview_jpeg) & 1)
        pifd = struct.pack("<H", len(pent))
        for t, ty, n, v in pent:
            if t == 258:
                v = bps_off
            elif t == 273:
                v = jpeg_off
            elif t == 330:
                v = raw_base
            pifd += struct.pack("<HHI", t, ty, n)
            pifd += (struct.pack("<I", v) if ty == 4 or t == 258
                     else struct.pack("<HH", v, 0))
        pifd += struct.pack("<I", 0)  # preview IFD ends the IFD0 chain
        preview_block = (pifd + struct.pack("<HHH", 8, 8, 8) + b"\x00\x00"
                         + preview_jpeg
                         + (b"\x00" if len(preview_jpeg) & 1 else b""))

    header_size = 8 + len(preview_block)
    ifd_size = 2 + len(entries) * 12 + 4
    data_off = header_size + ifd_size
    out_of_line = bytearray()
    for e in entries:
        if len(e[3]) > 4:
            e.append(data_off + len(out_of_line))
            pad = b"\x00" if len(e[3]) % 2 else b""
            out_of_line += e[3] + pad
        else:
            e.append(None)

    # EXIF sub-IFD block sits between the out-of-line payloads and the
    # image data; serialize it against its absolute base offset.
    exif_block = b""
    exif_base = data_off + len(out_of_line)
    if exif_entries:
        exif_entries.sort(key=lambda e: e[0])
        eifd_size = 2 + len(exif_entries) * 12 + 4
        eool = bytearray()
        eb = struct.pack("<H", len(exif_entries))
        for tag, typ, n, payload in exif_entries:
            eb += struct.pack("<HHI", tag, typ, n)
            if len(payload) > 4:
                eb += struct.pack("<I", exif_base + eifd_size + len(eool))
                eool += payload + (b"\x00" if len(payload) % 2 else b"")
            else:
                eb += payload.ljust(4, b"\x00")[:4]
        eb += struct.pack("<I", 0)
        exif_block = eb + bytes(eool)
        for e in entries:
            if e[0] == T_EXIF_IFD:
                e[3] = struct.pack("<I", exif_base)

    # Patch chunk offsets now that the data start is known.
    strip_off = data_off + len(out_of_line) + len(exif_block)
    chunk_offs = np.cumsum([0] + [len(c) for c in chunks[:-1]]) + strip_off
    for e in entries:
        if e[0] in (T_STRIP_OFFSETS, T_TILE_OFFSETS):
            packed_offs = struct.pack(
                "<" + str(len(chunks)) + "I", *(int(o) for o in chunk_offs)
            )
            if e[4] is None:  # inline (single chunk)
                e[3] = packed_offs
            else:
                pos = e[4] - data_off
                out_of_line[pos : pos + len(packed_offs)] = packed_offs

    buf = bytearray()
    buf += b"II" + struct.pack("<HI", 42, 8)
    buf += preview_block
    buf += struct.pack("<H", len(entries))
    for tag, typ, n, payload, off in entries:
        buf += struct.pack("<HHI", tag, typ, n)
        if off is not None:
            buf += struct.pack("<I", off)
        else:
            buf += payload.ljust(4, b"\x00")[:4]
    buf += struct.pack("<I", 0)  # no next IFD
    buf += out_of_line
    buf += exif_block
    buf += strip
    return bytes(buf)
