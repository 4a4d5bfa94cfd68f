"""Canon CR2 RAW container reader — the JAX package's ``io/cr2.py``, as
the port's own copy (the sliced SOF3 stream decodes through the port's
``io/ljpeg``).

Replaces rawler's Canon decoder for the framework
(rust-godot-legacy/photo-editor/src/image.rs:14-179 routes .cr2 through
rawler). Re-derived from the public CR2 layout (Laurent Clevy's
"Understanding What is stored in a Canon RAW .CR2 file" + the ITU-T.81
lossless-JPEG annex, which io/ljpeg.py implements):

* TIFF little-endian container with a ``CR\\x02`` marker at byte 8 and a
  chain of 4 IFDs; the RAW lives in the last strip-bearing IFD
  (Compression=6 "old JPEG" pointing at an SOF3 stream).
* The sensor image is stored in vertical slices (tag 0xC640: [n, w_a, w_b]
  -> n slices of w_a columns then one of w_b): the flat lossless-JPEG
  sample stream fills each slice top-to-bottom before moving right.
* Canon MakerNote (standard IFD, no header) supplies SensorInfo (tag 0xE0:
  sensor dims + active-area borders; the masked left border measures the
  black level) and ColorData (tag 0x4001: as-shot RGGB white-balance
  levels at a word offset keyed on the tag's element count, the same
  dispatch exiftool/dcraw use).
"""

from __future__ import annotations

import struct

import numpy as np

from .._errbase import PhotoEditorError
from .dng import (
    DngError, RawImage, T_DATETIME, _format_exif, _read_ifd, _value,
    T_COMPRESSION, T_STRIP_OFFSETS, T_STRIP_BYTE_COUNTS, T_MAKE, T_MODEL,
    T_ORIENTATION, T_LENS_MODEL,
)
from . import ljpeg

T_EXIF_IFD = 34665
T_MAKERNOTE = 37500
T_CR2_SLICES = 0xC640
T_CANON_SENSOR_INFO = 0x00E0
T_CANON_LENS_MODEL = 0x0095
T_CANON_COLOR_DATA = 0x4001

# ColorData variant -> word offset of WB_RGGBLevelsAsShot, keyed on the
# 0x4001 element count (exiftool Canon.pm ColorData1..11 dispatch).
_COLORDATA_WB_OFFSET = {}
for _n in (582,):                                     # ColorData1 (20D/350D)
    _COLORDATA_WB_OFFSET[_n] = 0x19
for _n in (653,):                                     # ColorData2 (1DmkII)
    _COLORDATA_WB_OFFSET[_n] = 0x18
for _n in (796,):                                     # ColorData3 (40D)
    _COLORDATA_WB_OFFSET[_n] = 0x3F
for _n in (674, 692, 702, 1227, 1250, 1251, 1337, 1338, 1346):  # ColorData4
    _COLORDATA_WB_OFFSET[_n] = 0x3F
for _n in (5120,):                                    # ColorData5 (PowerShot)
    _COLORDATA_WB_OFFSET[_n] = 0x47
for _n in (1273, 1275):                               # ColorData6 (600D/1200D)
    _COLORDATA_WB_OFFSET[_n] = 0x3F
for _n in (1312, 1313, 1316, 1506):                   # ColorData7 (5DmkIII..)
    _COLORDATA_WB_OFFSET[_n] = 0x3F
for _n in (1560, 1592, 1353, 1602):                   # ColorData8 (5DS/80D..)
    _COLORDATA_WB_OFFSET[_n] = 0x3F
for _n in (1816, 1820, 1824):                         # ColorData9 (M50/SX740)
    _COLORDATA_WB_OFFSET[_n] = 0x47
for _n in (2024, 3656):                               # ColorData10 (90D/1DXm3)
    _COLORDATA_WB_OFFSET[_n] = 0x55
for _n in (3973, 4528):                               # ColorData11 (R5/R6)
    _COLORDATA_WB_OFFSET[_n] = 0x69


def is_cr2(data: bytes) -> bool:
    return (
        len(data) > 12
        and data[:4] == b"II\x2a\x00"
        and data[8:10] == b"CR"
        and data[10] == 2
    )


def _unslice(samples: np.ndarray, slices, height: int, width: int) -> np.ndarray:
    """Re-arrange the flat lossless-JPEG sample stream into sensor layout.

    Each slice's columns are filled top-to-bottom from the stream before
    the next slice starts (CR2 spec §3.4 / dcraw canon_sraw unslicing)."""
    flat = samples.reshape(-1)
    if flat.size != height * width:
        raise DngError(
            f"CR2 stream has {flat.size} samples, sensor is {height}x{width}"
        )
    if not slices or slices[0] == 0:
        return flat.reshape(height, width)
    n, w_a, w_b = slices
    if n * w_a + w_b != width:
        raise DngError(f"CR2 slices {slices} do not cover width {width}")
    out = np.empty((height, width), dtype=samples.dtype)
    pos = 0
    x0 = 0
    for ws in [w_a] * n + [w_b]:
        cnt = ws * height
        out[:, x0 : x0 + ws] = flat[pos : pos + cnt].reshape(height, ws)
        pos += cnt
        x0 += ws
    return out


def _bayer_pattern_at(top: int, left: int) -> str:
    """Canon sensors are RGGB at the sensor origin; the active-area crop
    shifts the phase by its (top, left) parity."""
    grid = [["R", "G"], ["G", "B"]]
    return (
        grid[top % 2][left % 2]
        + grid[top % 2][(left + 1) % 2]
        + grid[(top + 1) % 2][left % 2]
        + grid[(top + 1) % 2][(left + 1) % 2]
    )


def _safe_orientation(v) -> int:
    try:
        o = int(v or 1)
    except (TypeError, ValueError):
        return 1
    return o if 1 <= o <= 8 else 1


def read_cr2(data: bytes) -> RawImage:
    """Parse CR2 bytes into a RawImage.

    Untrusted-input contract (same as read_dng): malformed bytes raise
    DngError; low-level parse failures never escape."""
    try:
        return _read_cr2(data)
    except (PhotoEditorError, MemoryError):
        raise
    except (struct.error, ValueError, IndexError, KeyError, TypeError,
            OverflowError, OSError) as e:
        raise DngError(f"malformed CR2 container: {e}") from e


def _read_cr2(data: bytes) -> RawImage:
    if not is_cr2(data):
        raise DngError("not a CR2 container (missing CR\\x02 marker)")
    bo = "<"
    (ifd0_off,) = struct.unpack_from(bo + "I", data, 4)

    ifds = []
    off = ifd0_off
    seen = set()
    while off and off not in seen:
        seen.add(off)
        entries, off = _read_ifd(data, off, bo)
        ifds.append(entries)

    def tag(e, t, default=None):
        return _value(data, e[t], bo) if t in e else default

    # The RAW IFD: last one carrying strips with "old JPEG" compression.
    raw_ifd = None
    for e in ifds:
        if T_STRIP_OFFSETS in e and tag(e, T_COMPRESSION) == 6:
            raw_ifd = e
    if raw_ifd is None:
        raise DngError("no CR2 RAW IFD (compression=6 strips) found")

    strip_off = tag(raw_ifd, T_STRIP_OFFSETS)
    strip_cnt = tag(raw_ifd, T_STRIP_BYTE_COUNTS)
    if isinstance(strip_off, list):
        strip_off, strip_cnt = strip_off[0], strip_cnt[0]
    slices = tag(raw_ifd, T_CR2_SLICES)

    samples, frame = ljpeg.decode(data[strip_off : strip_off + strip_cnt])
    sensor_h, sensor_w = frame.rows, frame.width
    mosaic_full = _unslice(samples, slices, sensor_h, sensor_w)

    # EXIF + MakerNote (both are plain IFDs).
    exif_entries = {}
    maker_entries = {}
    if T_EXIF_IFD in ifds[0]:
        try:
            # A mis-typed or out-of-range EXIF pointer must drop the
            # metadata, not abort a sensor decode whose strips are fine
            # (the same guard the DNG walker applies to its EXIF/SubIFD
            # pointers).
            exif_off = tag(ifds[0], T_EXIF_IFD)
            if isinstance(exif_off, int) and 0 < exif_off < len(data):
                exif_entries, _ = _read_ifd(data, exif_off, bo)
        except (struct.error, KeyError, TypeError, ValueError):
            exif_entries = {}
        if T_MAKERNOTE in exif_entries:
            typ, n, mn_off = exif_entries[T_MAKERNOTE]
            try:
                maker_entries, _ = _read_ifd(data, mn_off, bo)
            except (struct.error, KeyError):
                maker_entries = {}

    # Active area + black level from SensorInfo's masked border.
    top = left = 0
    bottom, right = sensor_h, sensor_w
    black = 0.0
    sensor_info = tag(maker_entries, T_CANON_SENSOR_INFO)
    if isinstance(sensor_info, list) and len(sensor_info) >= 9:
        # [_, width, height, _, _, left, top, right, bottom, ...]
        left, top = sensor_info[5], sensor_info[6]
        right, bottom = sensor_info[7] + 1, sensor_info[8] + 1
        if not (0 <= top < bottom <= sensor_h and 0 <= left < right <= sensor_w):
            raise DngError(f"CR2 SensorInfo borders {sensor_info[5:9]} out of range")
        if left >= 4:
            # Masked pixels left of the active area measure the black level.
            black = float(np.mean(mosaic_full[top:bottom, : left - 2]))
    mosaic = mosaic_full[top:bottom, left:right]

    # White balance from ColorData.
    wb = (1.0, 1.0, 1.0)
    cd = maker_entries.get(T_CANON_COLOR_DATA)
    if cd is not None:
        _typ, n, cd_off = cd
        word = _COLORDATA_WB_OFFSET.get(n)
        if word is not None and cd_off + 2 * word + 8 <= len(data):
            r, g1, g2, b = struct.unpack_from("<4H", data, cd_off + 2 * word)
            g = (g1 + g2) / 2.0
            if g > 0 and r > 0 and b > 0:
                wb = (r / g, 1.0, b / g)

    def _lookup(t):
        # Same formatting as the DNG walker (dng._format_exif); only the
        # tag locations are Canon-specific: Make/Model in IFD0, shooting
        # fields in the EXIF sub-IFD, the lens name in the MakerNote.
        if t in (T_MAKE, T_MODEL, T_DATETIME):
            return tag(ifds[0], t)
        if t == T_LENS_MODEL:
            return tag(maker_entries, T_CANON_LENS_MODEL)
        return tag(exif_entries, t)

    exif = _format_exif(_lookup)

    return RawImage(
        mosaic=np.ascontiguousarray(mosaic),
        pattern=_bayer_pattern_at(top, left),
        black_level=black,
        white_level=float((1 << frame.precision) - 1),
        wb_gains=wb,
        xyz_to_cam=None,  # Canon matrices live in a per-model table; the
        # develop falls back to identity + WB (rawpy's use_camera_wb analog)
        orientation=_safe_orientation(tag(ifds[0], T_ORIENTATION, 1)),
        exif=exif,
    )
