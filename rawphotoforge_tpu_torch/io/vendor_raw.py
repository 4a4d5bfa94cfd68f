"""Vendor RAW sensor decode — the NON-entropy-coded variants; the JAX
package's ``io/vendor_raw.py``, as the port's own copy.

Scope (match rust-godot-legacy/photo-editor/src/image.rs:14-179, :509-557
which routes these through rawler):

* Nikon NEF / Sony ARW / generic TIFF-EP RAWs with ``Compression=1``
  decode through the io/dng.py TIFF walker (16-bit plain and 12/14-bit
  packed with the TIFF MSB-first fill order — the layout dcraw's
  ``packed_load_raw`` implements for uncompressed NEF). This module adds
  the vendor MakerNote black/WB plumbing (``parse_makernote_wb``), the
  fixture writers and the decode-verification gate.
* Panasonic RW2 (``II`` + magic 0x0055): dedicated tag set
  (sensor dims/borders 0x0002-0x0007, CFA 0x0009, bits 0x000A, black
  0x001C-0x001E with dcraw's +15 convention, WB 0x0024-0x0026 or
  0x0011/0x0012, raw offset 0x0118), plain 16-bit little-endian payloads
  and the 12-bit RAW4 packing (io/vendor_packed).
* Fujifilm RAF: the fixed big-endian pointer table (header offset 84)
  to a CFA-header record list + uncompressed CFA block. Record 0x0100
  carries sensor dims, 0x0131 the 36-entry X-Trans color map (stored
  reversed, dcraw parse_fuji), 0x2FF0 the (G, R, G2, B) WB levels.
  Rotated SuperCCD layouts (no 0x0131 record) are rejected.

Sony ARW2 (compression 32767, routed through the io/dng walker) and
Panasonic RAW4 are memory-derived structural codecs, so parse_raw gates
every real-file decode against the embedded camera preview
(needs_verification). Huffman-table entropy codecs (NEF compression
34713, Fuji lossless, Panasonic 14-bit v5/v6) raise typed errors: those
files open on their embedded preview.

Silent-wrong detector (``preview_correlation``): develop the decoded
sensor data, downsample, and Pearson-correlate its luma against the
file's own embedded camera preview. Wrong packing / CFA phase / byte
order produces near-zero or negative correlation on real files; the
acceptance gate is 0.9.
"""

from __future__ import annotations

import functools
import struct
from typing import Optional

import numpy as np

from .dng import DngError, RawImage, _read_ifd, _value
from .._errbase import PhotoEditorError


def _typed_errors(fn):
    """Same untrusted-input contract as read_dng: malformed bytes raise
    DngError; low-level parse failures never escape."""

    @functools.wraps(fn)
    def wrapper(data: bytes, *a, **kw):
        try:
            return fn(data, *a, **kw)
        except (PhotoEditorError, MemoryError):
            raise
        except (struct.error, ValueError, IndexError, KeyError, TypeError,
                OverflowError, OSError) as e:
            raise DngError(f"malformed RAW container: {e}") from e

    return wrapper

# ---------------------------------------------------------------------------
# Panasonic RW2
# ---------------------------------------------------------------------------

RW2_MAGIC = 0x0055

# exiftool PanasonicRaw tag ids.
_RW2_SENSOR_WIDTH = 0x0002
_RW2_SENSOR_HEIGHT = 0x0003
_RW2_TOP = 0x0004
_RW2_LEFT = 0x0005
_RW2_BOTTOM = 0x0006
_RW2_RIGHT = 0x0007
_RW2_CFA = 0x0009
_RW2_BITS = 0x000A
_RW2_COMPRESSION = 0x000B
_RW2_LINEARITY = (0x000E, 0x000F, 0x0010)   # white clip per channel
_RW2_RED_BALANCE = 0x0011                   # older bodies: gains * 256
_RW2_BLUE_BALANCE = 0x0012
_RW2_BLACK = (0x001C, 0x001D, 0x001E)
_RW2_WB_LEVELS = (0x0024, 0x0025, 0x0026)   # WBRed/Green/BlueLevel
_RW2_RAW_FORMAT = 0x002D                    # exiftool RawFormat (4 = RAW4)
_RW2_JPG_FROM_RAW = 0x002E
_RW2_RAW_OFFSET = 0x0118
_RW2_MAKE = 271
_RW2_MODEL = 272
_RW2_ORIENTATION = 274

# exiftool PanasonicRaw 0x0009 CFAPattern values.
_RW2_CFA_NAMES = {1: "RGGB", 2: "GRBG", 3: "GBRG", 4: "BGGR"}


def is_rw2(data: bytes) -> bool:
    return (len(data) >= 8 and data[:2] == b"II"
            and struct.unpack_from("<H", data, 2)[0] == RW2_MAGIC)


@_typed_errors
def read_rw2(data: bytes) -> RawImage:
    """Parse a Panasonic RW2 container (uncompressed payloads only).

    The compressed "Panasonic RAW" bitstreams (tag 0x000B != 1 or a
    payload smaller than the plain-16-bit size) raise DngError — the
    caller's preview fallback handles them."""
    if not is_rw2(data):
        raise DngError("not an RW2 container")
    (ifd0,) = struct.unpack_from("<I", data, 4)
    entries, _ = _read_ifd(data, ifd0, "<")

    def tag(t, default=None):
        return _value(data, entries[t], "<") if t in entries else default

    sw, sh = tag(_RW2_SENSOR_WIDTH), tag(_RW2_SENSOR_HEIGHT)
    if not (isinstance(sw, int) and isinstance(sh, int)
            and 0 < sw <= 65535 and 0 < sh <= 65535
            and sw * sh <= 500_000_000):
        raise DngError(f"implausible RW2 sensor dimensions {sw}x{sh}")
    off = tag(_RW2_RAW_OFFSET)
    if not isinstance(off, int) or not 0 < off < len(data):
        raise DngError("RW2 raw data offset missing or out of range")
    # The raw block runs to EOF unless the JPG-from-RAW tag value sits
    # after it (tag values > 4 bytes are stored as offsets).
    end = len(data)
    if _RW2_JPG_FROM_RAW in entries:
        _, n, joff = entries[_RW2_JPG_FROM_RAW]
        if n > 4 and off < joff < end:
            end = joff
    avail = end - off
    need = sw * sh * 2
    bits_tag = int(tag(_RW2_BITS, 12) or 12)
    raw_fmt = tag(_RW2_RAW_FORMAT)
    needs_verification = False
    # The 12-bit fixed bit-group packing (exiftool RawFormat 4, dcraw
    # pana_bits) is table-free and decodes via io/vendor_packed —
    # memory-derived, so the result is flagged for parse_raw's
    # preview-correlation gate. The RawFormat tag takes precedence over
    # the payload-size heuristic (RAW4 blocks round up to 16 KB, so a
    # tiny packed payload can exceed its plain-16-bit size); 14-bit
    # v5/v6 entropy-coded streams stay typed-rejected.
    if raw_fmt == 4 and bits_tag == 12:
        from .vendor_packed import decode_pana_raw4

        mosaic = decode_pana_raw4(data[off:end], sw, sh)
        needs_verification = True
    elif (raw_fmt is None or raw_fmt <= 3) and avail >= need:
        # Plain 16-bit payload. RawFormat >= 4 never takes this branch:
        # a compressed stream whose blocks happen to exceed the plain
        # size must not be reinterpreted as pixels (silent-wrong).
        mosaic = np.frombuffer(data, dtype="<u2", count=sw * sh,
                               offset=off).reshape(sh, sw)
    elif bits_tag == 12 and raw_fmt in (None, 3) and avail < need:
        from .vendor_packed import decode_pana_raw4

        mosaic = decode_pana_raw4(data[off:end], sw, sh)
        needs_verification = True
    else:
        raise DngError(
            f"RW2 payload is {avail} bytes for {sw}x{sh} at "
            f"{bits_tag}-bit (RawFormat {raw_fmt}); only plain "
            f"16-bit and 12-bit RAW4 packing decode — the 14-bit "
            f"v5/v6 entropy streams have no offline ground truth")

    # Sensor borders crop the optically-black frame; the CFA phase
    # follows the crop origin parity.
    top = int(tag(_RW2_TOP, 0) or 0)
    left = int(tag(_RW2_LEFT, 0) or 0)
    bottom = int(tag(_RW2_BOTTOM, sh) or sh)
    right = int(tag(_RW2_RIGHT, sw) or sw)
    if not (0 <= top < bottom <= sh and 0 <= left < right <= sw):
        raise DngError(f"RW2 borders {(top, left, bottom, right)} outside "
                       f"{sh}x{sw}")
    mosaic = mosaic[top:bottom, left:right]

    cfa = tag(_RW2_CFA, 1)
    pattern = _RW2_CFA_NAMES.get(int(cfa) if isinstance(cfa, int) else 1)
    if pattern is None:
        raise DngError(f"unknown RW2 CFAPattern code {cfa}")
    if (top % 2, left % 2) != (0, 0):
        grid = np.array([[pattern[0], pattern[1]],
                         [pattern[2], pattern[3]]])
        grid = np.roll(grid, (-top % 2, -left % 2), axis=(0, 1))
        pattern = "".join(grid.reshape(-1))

    bits = bits_tag
    blacks = [tag(t) for t in _RW2_BLACK]
    if all(isinstance(b, int) for b in blacks):
        # dcraw/libraw add 15 to the stored RW2 black levels (the sensor
        # pedestal sits above the tag value).
        black = float(np.mean([b + 15 for b in blacks]))
    else:
        black = 0.0
    limits = [tag(t) for t in _RW2_LINEARITY]
    if all(isinstance(v, int) and v > 0 for v in limits):
        white = float(min(limits))
    else:
        white = float((1 << bits) - 1)

    wb = (1.0, 1.0, 1.0)
    wb_known = False
    levels = [tag(t) for t in _RW2_WB_LEVELS]
    if all(isinstance(v, int) and v > 0 for v in levels):
        r, g, b = (float(v) for v in levels)
        wb = (r / g, 1.0, b / g)
        wb_known = True
    else:
        rb, bb = tag(_RW2_RED_BALANCE), tag(_RW2_BLUE_BALANCE)
        if isinstance(rb, int) and isinstance(bb, int) and rb > 0 and bb > 0:
            wb = (rb / 256.0, 1.0, bb / 256.0)
            wb_known = True

    try:
        orientation = int(tag(_RW2_ORIENTATION, 1) or 1)
    except (TypeError, ValueError):
        orientation = 1
    if not 1 <= orientation <= 8:
        orientation = 1

    from .dng import extract_container_exif

    return RawImage(
        mosaic=np.ascontiguousarray(mosaic),
        pattern=pattern,
        black_level=black,
        white_level=white,
        wb_gains=wb,
        xyz_to_cam=None,
        orientation=orientation,
        exif=dict(extract_container_exif(data)),
        wb_known=wb_known,
        needs_verification=needs_verification,
    )


def write_rw2(raw: RawImage, jpg_from_raw: Optional[bytes] = None,
              borders: Optional[tuple] = None,
              raw_format: int = 1) -> bytes:
    """Serialize a minimal uncompressed RW2 (fixture writer: the decode
    contract above, nothing more). ``raw.mosaic`` must be u16 [H, W]
    covering the FULL sensor; ``borders`` = (top, left, bottom, right)
    writes the sensor-border crop tags (``raw.pattern`` names the CFA at
    the border origin, as cameras do). ``raw_format=4`` packs the
    payload as a 12-bit RAW4 bitstream (io/vendor_packed.encode_pana_
    raw4 — sample values must be <= 4095 and fixture-representable)."""
    if raw.mosaic.ndim != 2 or raw.mosaic.dtype != np.uint16:
        raise DngError("write_rw2 needs a u16 [H, W] mosaic")
    h, w = raw.mosaic.shape
    top, left, bottom, right = borders if borders else (0, 0, h, w)
    stored_pattern = raw.pattern
    if (top % 2, left % 2) != (0, 0):
        # The tag describes the FULL-sensor pattern; the reader rolls it
        # to the border origin — store the inverse roll.
        grid = np.array([[raw.pattern[0], raw.pattern[1]],
                         [raw.pattern[2], raw.pattern[3]]])
        grid = np.roll(grid, (top % 2, left % 2), axis=(0, 1))
        stored_pattern = "".join(grid.reshape(-1))
    cfa_code = {v: k for k, v in _RW2_CFA_NAMES.items()}.get(stored_pattern)
    if cfa_code is None:
        raise DngError(f"RW2 cannot carry CFA pattern {raw.pattern!r}")
    black = int(round(raw.black_level)) - 15
    if black < 0:
        raise DngError("RW2 black level must be >= 15 (dcraw pedestal)")
    g = 1024
    wb_r, wb_b = int(round(raw.wb_gains[0] * g)), int(round(raw.wb_gains[2] * g))

    entries = [
        (_RW2_SENSOR_WIDTH, 3, [w]),
        (_RW2_SENSOR_HEIGHT, 3, [h]),
        (_RW2_TOP, 3, [top]), (_RW2_LEFT, 3, [left]),
        (_RW2_BOTTOM, 3, [bottom]), (_RW2_RIGHT, 3, [right]),
        (_RW2_CFA, 3, [cfa_code]),
        (_RW2_BITS, 3, [12 if raw_format == 4 else 16]),
        (_RW2_COMPRESSION, 3, [1]),
        (_RW2_RAW_FORMAT, 3, [raw_format]),
        (_RW2_LINEARITY[0], 3, [int(raw.white_level)]),
        (_RW2_LINEARITY[1], 3, [int(raw.white_level)]),
        (_RW2_LINEARITY[2], 3, [int(raw.white_level)]),
        (_RW2_BLACK[0], 3, [black]), (_RW2_BLACK[1], 3, [black]),
        (_RW2_BLACK[2], 3, [black]),
        (_RW2_WB_LEVELS[0], 3, [wb_r]), (_RW2_WB_LEVELS[1], 3, [g]),
        (_RW2_WB_LEVELS[2], 3, [wb_b]),
        (_RW2_MAKE, 2, b"Panasonic\x00"),
        (_RW2_MODEL, 2, (raw.exif.get("Model") or "DMC-FIXTURE").encode()
         + b"\x00"),
        (_RW2_ORIENTATION, 3, [int(raw.orientation)]),
    ]
    if raw_format == 4:
        from .vendor_packed import encode_pana_raw4

        payload = encode_pana_raw4(raw.mosaic)
    else:
        payload = raw.mosaic.astype("<u2").tobytes()
    jpg = jpg_from_raw or b""
    n = len(entries) + (1 if jpg else 0) + 1  # + raw offset tag
    ifd_off = 8
    data_off = ifd_off + 2 + 12 * (n) + 4
    out_tail = bytearray()

    def put(blob: bytes) -> int:
        nonlocal out_tail
        off = data_off + len(out_tail)
        out_tail += blob
        if len(out_tail) % 2:
            out_tail += b"\x00"
        return off

    jpg_entry = None
    if jpg:
        jpg_entry = (_RW2_JPG_FROM_RAW, 7, jpg)
    raw_off_placeholder = (_RW2_RAW_OFFSET, 4, [0])

    all_entries = sorted(entries + ([jpg_entry] if jpg_entry else [])
                         + [raw_off_placeholder])
    # First pass: lay out out-of-line values, remembering where the raw
    # payload will land (after everything else).
    ifd = bytearray(struct.pack("<H", len(all_entries)))
    fixups = {}
    for tag_id, typ, val in all_entries:
        if typ == 2 or typ == 7:
            blob = bytes(val)
            if len(blob) <= 4:
                packed = blob.ljust(4, b"\x00")
                ifd += struct.pack("<HHI", tag_id, typ, len(blob)) + packed
            else:
                off = put(blob)
                ifd += struct.pack("<HHII", tag_id, typ, len(blob), off)
        else:
            fmt = {3: "H", 4: "I"}[typ]
            blob = struct.pack("<" + fmt * len(val), *val)
            if len(blob) <= 4:
                ifd += struct.pack("<HHI", tag_id, typ, len(val))
                ifd += blob.ljust(4, b"\x00")
            else:
                off = put(blob)
                ifd += struct.pack("<HHII", tag_id, typ, len(val), off)
        if tag_id == _RW2_RAW_OFFSET:
            fixups[_RW2_RAW_OFFSET] = len(ifd) - 4
    ifd += struct.pack("<I", 0)  # next IFD
    raw_offset = data_off + len(out_tail)
    struct.pack_into("<I", ifd, fixups[_RW2_RAW_OFFSET], raw_offset)
    header = struct.pack("<2sHI", b"II", RW2_MAGIC, ifd_off)
    return bytes(header + ifd + out_tail + payload)


# ---------------------------------------------------------------------------
# Fujifilm RAF
# ---------------------------------------------------------------------------

# Single home of the container sniff: the preview extractor and this
# sensor decoder must never disagree on what is a RAF file.
from .vendor_preview import RAF_MAGIC, is_raf  # noqa: F401

_RAF_DIMS = 0x0100          # (height u16, width u16) big-endian
_RAF_LAYOUT = 0x0130        # SuperCCD layout flags
_RAF_XTRANS = 0x0131        # 36 color codes, stored reversed (dcraw)
_RAF_WB = 0x2FF0            # (G, R, G2, B) u16 levels (dcraw cam_mul[c^1])


def _raf_pointers(data: bytes):
    if len(data) < 108:
        raise DngError("RAF header truncated")
    jpeg_off, jpeg_len, meta_off, meta_len, cfa_off, cfa_len = \
        struct.unpack_from(">IIIIII", data, 84)
    return jpeg_off, jpeg_len, meta_off, meta_len, cfa_off, cfa_len


def _raf_records(data: bytes, meta_off: int, meta_len: int):
    if not (0 < meta_off and meta_off + 4 <= len(data)):
        raise DngError("RAF meta pointer out of range")
    (count,) = struct.unpack_from(">I", data, meta_off)
    if count > 4096:
        raise DngError(f"implausible RAF record count {count}")
    recs = {}
    off = meta_off + 4
    end = min(len(data), meta_off + max(meta_len, 4))
    for _ in range(count):
        if off + 4 > end:
            break
        tag, size = struct.unpack_from(">HH", data, off)
        off += 4
        if off + size > end:
            break
        recs[tag] = data[off:off + size]
        off += size
    return recs


@_typed_errors
def read_raf(data: bytes) -> RawImage:
    """Parse a Fujifilm RAF container: fixed-offset *uncompressed* CFA.

    Requires the 0x0131 color-map record (X-Trans generation, or a
    2x2-periodic Bayer map); rotated SuperCCD layouts and compressed
    payloads raise DngError (preview fallback). Byte order of the
    16-bit samples is sniffed: the orientation whose values stay in
    sensor range with the lower neighbor-difference energy wins (both
    conventions exist in the wild; a wrong choice scores ~0 on the
    preview-correlation gate)."""
    if not is_raf(data):
        raise DngError("not a RAF container")
    _, _, meta_off, meta_len, cfa_off, cfa_len = _raf_pointers(data)
    recs = _raf_records(data, meta_off, meta_len)
    if _RAF_DIMS not in recs or len(recs[_RAF_DIMS]) < 4:
        raise DngError("RAF sensor-dimension record (0x0100) missing")
    h, w = struct.unpack_from(">HH", recs[_RAF_DIMS], 0)
    if not (0 < w <= 65535 and 0 < h <= 65535 and w * h <= 500_000_000):
        raise DngError(f"implausible RAF dimensions {w}x{h}")
    if _RAF_XTRANS not in recs or len(recs[_RAF_XTRANS]) < 36:
        raise DngError(
            "RAF without a 0x0131 color map (rotated SuperCCD layout) "
            "is not supported")
    # dcraw parse_fuji stores the 36 codes REVERSED: xtrans_abs[0][35-c].
    codes = [recs[_RAF_XTRANS][35 - i] & 3 for i in range(36)]
    grid = np.asarray(codes, dtype=np.int32).reshape(6, 6)
    from ..ops.demosaic import XTRANS

    if np.array_equal(grid, XTRANS):
        pattern = "XTRANS"
    elif np.array_equal(grid, np.tile(grid[:2, :2], (3, 3))):
        names = {0: "R", 1: "G", 2: "B"}
        pattern = "".join(names[int(grid[y, x])]
                          for y in range(2) for x in range(2))
        if pattern not in ("RGGB", "BGGR", "GRBG", "GBRG"):
            raise DngError(f"unsupported RAF Bayer map {pattern}")
    else:
        raise DngError("RAF color map is neither X-Trans nor 2x2 Bayer")

    need = w * h * 2
    if not (0 < cfa_off and cfa_off + need <= len(data)):
        raise DngError(
            f"RAF CFA payload too small for {w}x{h} 16-bit samples — "
            f"compressed Fuji data has no offline ground truth")
    le = np.frombuffer(data, dtype="<u2", count=w * h, offset=cfa_off)
    be = np.frombuffer(data, dtype=">u2", count=w * h, offset=cfa_off)

    def score(a):
        # In-range (14-bit sensors) and locally smooth wins.
        if a.max() >= 1 << 14:
            return np.inf
        row = a[: min(w * 8, a.size)].astype(np.int64)
        return float(np.abs(np.diff(row)).mean())

    mosaic = (le if score(le) <= score(be) else be).reshape(h, w)

    wb = (1.0, 1.0, 1.0)
    wb_known = False
    if _RAF_WB in recs and len(recs[_RAF_WB]) >= 8:
        g0, r, _g1, b = struct.unpack_from(">HHHH", recs[_RAF_WB], 0)
        if g0 > 0 and r > 0 and b > 0:
            wb = (r / g0, 1.0, b / g0)
            wb_known = True

    white = float((1 << 14) - 1) if mosaic.max() < (1 << 14) else 65535.0
    from .raw import container_exif

    return RawImage(
        mosaic=np.ascontiguousarray(mosaic.astype(np.uint16)),
        pattern=pattern,
        # Fuji does not expose the pedestal outside the maker note;
        # 0 is the documented approximation (shadows sit slightly high
        # on real files — the correlation gate still passes, and the
        # preview fallback remains one flag away).
        black_level=0.0,
        white_level=white,
        wb_gains=wb,
        xyz_to_cam=None,
        orientation=1,
        exif=container_exif(data),
        wb_known=wb_known,
    )


def write_raf(raw: RawImage, jpeg_preview: Optional[bytes] = None) -> bytes:
    """Serialize a minimal uncompressed RAF (fixture writer)."""
    if raw.mosaic.ndim != 2 or raw.mosaic.dtype != np.uint16:
        raise DngError("write_raf needs a u16 [H, W] mosaic")
    h, w = raw.mosaic.shape
    from ..ops.demosaic import NAMED_CFA, XTRANS

    if raw.pattern == "XTRANS":
        grid = XTRANS
    elif raw.pattern in NAMED_CFA and raw.pattern != "XTRANS":
        tile = np.asarray(NAMED_CFA[raw.pattern])
        grid = np.tile(tile, (3, 3))
    else:
        raise DngError(f"RAF cannot carry CFA pattern {raw.pattern!r}")
    codes = bytes(int(grid[i // 6, i % 6]) for i in range(36))
    rev = bytes(codes[35 - i] for i in range(36))  # stored reversed

    g = 302
    wb_rec = struct.pack(
        ">HHHH", g, int(round(raw.wb_gains[0] * g)), g,
        int(round(raw.wb_gains[2] * g)))
    records = [
        (_RAF_DIMS, struct.pack(">HH", h, w)),
        (_RAF_LAYOUT, b"\x00\x00"),
        (_RAF_XTRANS, rev),
        (_RAF_WB, wb_rec),
    ]
    meta = bytearray(struct.pack(">I", len(records)))
    for tag, payload in records:
        meta += struct.pack(">HH", tag, len(payload)) + payload

    jpeg = jpeg_preview or b""
    header_len = 148  # fixed header incl. pointer table + padding
    jpeg_off = header_len
    meta_off = jpeg_off + len(jpeg)
    cfa_off = meta_off + len(meta)
    payload = raw.mosaic.astype("<u2").tobytes()

    header = bytearray(header_len)
    header[:len(RAF_MAGIC)] = RAF_MAGIC
    header[16:20] = b"0201"
    model = (raw.exif.get("Model") or "X-FIXTURE").encode()[:31]
    header[28:28 + len(model)] = model
    struct.pack_into(">IIIIII", header, 84, jpeg_off, len(jpeg),
                     meta_off, len(meta), cfa_off, len(payload))
    return bytes(header) + jpeg + bytes(meta) + payload


# ---------------------------------------------------------------------------
# TIFF-EP fixture writer (uncompressed NEF/ARW-shaped files)
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# Vendor MakerNote black/WB extraction (PEF, ORF)
# ---------------------------------------------------------------------------

T_MAKERNOTE = 0x927C


def parse_makernote_wb(make: str, data: bytes, entry, bo: str) -> dict:
    """Extract documented black/WB fields from a vendor MakerNote.

    Only formats whose layout is publicly documented (exiftool/dcraw are
    the sources) are parsed; anything else returns {} and the caller
    falls back to gray-world gains with ``wb_known=False``. Every real
    vendor file's decode can be checked by ``preview_correlation`` — a
    wrong parse here cannot pass silently.

    * Pentax PEF (dcraw parse_makernote, exiftool Pentax.pm): MakerNote
      is ``AOC\\x00`` + byte-order mark + a plain TIFF IFD whose value
      offsets are FILE-ABSOLUTE in PEF. Tag 0x0200 BlackPoint (4 shorts,
      CFA-site order -> mean), 0x0201 WhitePoint = the as-shot WB levels
      (4 shorts, R G G B order: gains r=v0/v1, b=v3/v1).
    * Olympus ORF (dcraw parse_makernote 0x2040/0x0100, exiftool
      Olympus.pm): ``OLYMPUS\\x00`` + self-relative TIFF structure; the
      ImageProcessing sub-IFD (tag 0x2040) carries 0x0100 WB_RBLevels
      (R and B levels x256, green = 256) and 0x0600 BlackLevel2
      (4 shorts -> mean). Legacy ``OLYMP\\x00`` notes carry a plain IFD
      with file-absolute offsets (no sub-IFD parsing attempted).

    Returns a dict with optional keys ``wb`` ((r, 1, b) gains) and
    ``black`` (float)."""
    typ, n, off = entry
    if typ not in (1, 7) or n < 8 or off + n > len(data):
        return {}
    blob = data[off : off + n]
    try:
        if blob[:4] == b"AOC\x00" or blob[:8] == b"PENTAX \x00":
            # Pentax: optional II/MM right after the signature overrides
            # the container byte order (exiftool: PEF notes usually match
            # the file's).
            base = 4 if blob[:4] == b"AOC\x00" else 8
            mbo = bo
            if blob[base:base + 2] in (b"II", b"MM"):
                mbo = "<" if blob[base:base + 2] == b"II" else ">"
                base += 2
            entries, _ = _read_ifd(data, off + base, mbo)
            out = {}
            bp = entries.get(0x0200)
            if bp is not None:
                v = _value(data, bp, mbo)
                if isinstance(v, list) and len(v) >= 4:
                    out["black"] = float(np.mean(v[:4]))
            wp = entries.get(0x0201)
            if wp is not None:
                v = _value(data, wp, mbo)
                if isinstance(v, list) and len(v) >= 4 \
                        and all(x > 0 for x in v[:4]):
                    r, g1, _g2, b = (float(x) for x in v[:4])
                    out["wb"] = (r / g1, 1.0, b / g1)
            return out
        if blob[:8] == b"OLYMPUS\x00":
            # New-style Olympus: offsets relative to the MakerNote start.
            mbo = "<" if blob[8:10] == b"II" else ">"
            # IFD begins right after the 12-byte header; entry value
            # offsets are relative to ``off`` (the note's file offset).
            entries, _ = _read_ifd(blob, 12, mbo)
            ip = entries.get(0x2040)
            if ip is None:
                return {}
            if ip[0] in (4, 13):
                # LONG/IFD pointer: the value is a note-relative offset.
                # Type 13 (IFD) is absent from the shared _TYPE_SIZES
                # table, so read the u32 directly at the entry's value
                # slot instead of going through _value.
                (ip_off,) = struct.unpack_from(mbo + "I", blob, ip[2])
            else:
                # UNDEFINED: the sub-IFD is stored inline as the tag's
                # payload; _read_ifd already resolved its start.
                ip_off = ip[2]
            if isinstance(ip_off, int) and 0 < ip_off < n:
                sub, _ = _read_ifd(blob, ip_off, mbo)
                out = {}
                wbl = sub.get(0x0100)
                if wbl is not None:
                    v = _value(blob, wbl, mbo)
                    v = v if isinstance(v, list) else [v]
                    if len(v) >= 2 and all(x > 0 for x in v[:2]):
                        out["wb"] = (float(v[0]) / 256.0, 1.0,
                                     float(v[1]) / 256.0)
                bl2 = sub.get(0x0600)
                if bl2 is not None:
                    v = _value(blob, bl2, mbo)
                    if isinstance(v, list) and len(v) >= 4:
                        out["black"] = float(np.mean(v[:4]))
                return out
            return {}
    except (struct.error, ValueError, IndexError, KeyError, TypeError,
            ZeroDivisionError):
        return {}
    return {}


def pack_bits_msb(values: np.ndarray, bits: int) -> bytes:
    """Pack u16 samples at ``bits`` per sample, MSB-first (the TIFF fill
    order io/dng._unpack_bits inverts; dcraw packed_load_raw layout for
    uncompressed packed NEF)."""
    v = np.asarray(values, dtype=np.uint32).reshape(-1)
    weights = (1 << np.arange(bits - 1, -1, -1)).astype(np.uint32)
    u = ((v[:, None] & weights) > 0).astype(np.uint8)
    return np.packbits(u.reshape(-1)).tobytes()


def write_tiff_ep(raw: RawImage, bits: int = 16, make: str = "NIKON",
                  compression: int = 1,
                  sony_tags: bool = False,
                  preview_jpeg: Optional[bytes] = None,
                  magic: int = 42,
                  makernote: Optional[bytes] = None,
                  arw2_curve_knots: Optional[list] = None) -> bytes:
    """Serialize a TIFF-EP RAW the way NEF/ARW/ORF/PEF/SRW/3FR structure
    theirs: IFD0 (Make/Model, optional preview strip) + a SubIFD
    carrying the CFA sensor plane (Photometric 32803, TIFF-EP
    CFARepeatPatternDim/CFAPattern, 12/14-bit MSB-first packing or plain
    16-bit). ``sony_tags`` adds the ARW vendor black/white/WB tags;
    ``compression=7`` writes a REAL lossless-JPEG (SOF3) strip — the
    Sony-lossless-class layout the generic walker decodes via io/ljpeg —
    any other non-1 value produces the opaque entropy-coded stand-in
    used to test the typed-rejection path. ``magic`` stamps the vendor
    TIFF magic (0x4F52/0x5352 for the two ORF flavors); ``makernote``
    embeds a MakerNote blob in the Exif IFD (parse_makernote_wb
    fixtures). Fixture writer for the test suite and the
    decode-verification harness."""
    if raw.mosaic.ndim != 2 or raw.mosaic.dtype != np.uint16:
        raise DngError("write_tiff_ep needs a u16 [H, W] mosaic")
    if raw.pattern not in ("RGGB", "BGGR", "GRBG", "GBRG"):
        raise DngError(f"TIFF-EP fixture cannot carry {raw.pattern!r}")
    if bits not in (8, 12, 14, 16):
        raise DngError(f"unsupported fixture bit depth {bits}")
    h, w = raw.mosaic.shape
    if bits not in (8, 16) and (w * bits) % 8:
        raise DngError("packed fixture rows must be byte-aligned")
    if compression == 32767:
        # Sony ARW2 fixture: raw.mosaic carries the PRE-curve 11-bit
        # codes; the reader maps them through the tag-0x7010 curve, so
        # tests compare against curve[codes << 1]. Real ARW2 stamps
        # BitsPerSample=8 — callers pass bits=8 for realism.
        from .vendor_packed import encode_arw2

        payload = encode_arw2(raw.mosaic)
    elif compression == 1:
        if bits == 16:
            payload = raw.mosaic.astype("<u2").tobytes()
        else:
            if int(raw.mosaic.max()) >= 1 << bits:
                raise DngError(f"mosaic exceeds {bits}-bit range")
            payload = pack_bits_msb(raw.mosaic, bits)
    elif compression == 7:
        from . import ljpeg

        if int(raw.mosaic.max()) >= 1 << bits:
            raise DngError(f"mosaic exceeds {bits}-bit range")
        ncomp = 2 if w % 2 == 0 else 1
        payload = ljpeg.encode(
            raw.mosaic.reshape(h, w // ncomp, ncomp),
            precision=bits, huffman="optimal")
    else:
        payload = b"\x00" * 64  # opaque entropy-coded stand-in

    cfa_codes = bytes({"R": 0, "G": 1, "B": 2}[c] for c in raw.pattern)

    out = bytearray(b"II" + struct.pack("<H", magic) + b"\x00\x00\x00\x00")

    def put(blob: bytes) -> int:
        off = len(out)
        out.extend(blob)
        if len(out) % 2:
            out.append(0)
        return off

    def build_ifd(entries, next_ifd=0) -> bytes:
        entries = sorted(entries)
        ifd = bytearray(struct.pack("<H", len(entries)))
        for tag, typ, val in entries:
            if isinstance(val, tuple) and val and val[0] == "ptr":
                # Pre-placed payload: (\"ptr\", absolute_offset, count) —
                # MakerNote blobs whose INTERNAL offsets depend on where
                # they land (Pentax file-absolute convention).
                _, off, n = val
                ifd += struct.pack("<HHII", tag, typ, n, off)
                continue
            if typ in (2, 7):
                blob = bytes(val)
                n = len(blob)
            elif typ == 5:  # RATIONAL list of (num, den)
                blob = b"".join(struct.pack("<II", a, b) for a, b in val)
                n = len(val)
            else:
                fmt = {1: "B", 3: "H", 4: "I"}[typ]
                blob = struct.pack("<" + fmt * len(val), *val)
                n = len(val)
            if len(blob) <= 4:
                ifd += struct.pack("<HHI", tag, typ, n)
                ifd += blob.ljust(4, b"\x00")
            else:
                off = put(blob)
                ifd += struct.pack("<HHII", tag, typ, n, off)
        ifd += struct.pack("<I", next_ifd)
        return bytes(ifd)

    mn_off = mn_len = 0
    if makernote is not None:
        # Placed FIRST (offset 8, right after the header) so a callable
        # ``makernote(offset)`` can bake file-absolute internal offsets
        # (the Pentax MakerNote convention) deterministically.
        mn_blob = (makernote(len(out)) if callable(makernote)
                   else bytes(makernote))
        mn_len = len(mn_blob)
        mn_off = put(mn_blob)
    payload_off = put(payload)
    pv_off = put(preview_jpeg) if preview_jpeg else 0

    sub_entries = [
        (254, 4, [0]),                      # NewSubfileType: full-res
        (256, 4, [w]), (257, 4, [h]),
        (258, 3, [bits]),
        (259, 3, [compression]),
        (262, 3, [32803]),                  # PhotometricInterpretation CFA
        (273, 4, [payload_off]),
        (277, 3, [1]),
        (278, 4, [h]),
        (279, 4, [len(payload)]),
        (33421, 3, [2, 2]),                 # CFARepeatPatternDim
        (33422, 7, cfa_codes),              # CFAPattern (TIFF-EP)
    ]
    if sony_tags:
        blk = int(round(raw.black_level))
        sub_entries += [
            (0x7310, 3, [blk, blk, blk, blk]),
            (0x787F, 3, [int(raw.white_level)]),
        ]
        if arw2_curve_knots is not None:
            sub_entries.append(
                (0x7010, 3, [int(k) for k in arw2_curve_knots[:4]]))
        if tuple(raw.wb_gains) != (1.0, 1.0, 1.0):
            g = 1024
            sub_entries.append(
                (0x7313, 3, [int(round(raw.wb_gains[0] * g)), g, g,
                             int(round(raw.wb_gains[2] * g))]))
    sub_ifd = build_ifd(sub_entries)
    sub_off = put(sub_ifd)

    # Lens EXIF rides in a real NEF/ARW's Exif IFD; the lens-profile
    # auto-resolution flow (io/lensdb.profile_for_exif) needs these to be
    # testable on vendor fixtures, not just DNGs.
    ex = raw.exif or {}

    def _rat100(v):
        return (int(round(float(v) * 100)), 100)

    exif_entries = []
    if ex.get("FNumber") is not None:
        exif_entries.append((0x829D, 5, [_rat100(ex["FNumber"])]))
    if ex.get("FocalLength") is not None:
        exif_entries.append((0x920A, 5, [_rat100(ex["FocalLength"])]))
    if ex.get("FocalLengthIn35mmFilm") is not None:
        exif_entries.append((0xA405, 3,
                             [int(ex["FocalLengthIn35mmFilm"])]))
    if ex.get("LensModel"):
        exif_entries.append(
            (0xA434, 2, (str(ex["LensModel"]) + "\x00").encode()))
    if mn_off:
        exif_entries.append((0x927C, 7, ("ptr", mn_off, mn_len)))
    exif_off = put(build_ifd(exif_entries)) if exif_entries else 0

    ifd0_entries = [
        (254, 4, [1]),                      # reduced-resolution (preview)
        (271, 2, (make + "\x00").encode()),
        (272, 2, ((raw.exif.get("Model") or "FIXTURE") + "\x00").encode()),
        (274, 3, [int(raw.orientation)]),
        (330, 4, [sub_off]),                # SubIFDs -> raw
    ]
    if exif_off:
        ifd0_entries.append((34665, 4, [exif_off]))  # ExifIFDPointer
    if preview_jpeg:
        ifd0_entries += [
            (513, 4, [pv_off]),             # JPEGInterchangeFormat
            (514, 4, [len(preview_jpeg)]),
        ]
    ifd0 = build_ifd(ifd0_entries)
    ifd0_off = put(ifd0)
    struct.pack_into("<I", out, 4, ifd0_off)
    return bytes(out)


# ---------------------------------------------------------------------------
# Decode verification: correlate the developed sensor data against the
# file's own embedded camera preview (the silent-wrong detector).
# ---------------------------------------------------------------------------

def preview_correlation(data: bytes, raw: Optional[RawImage] = None,
                        size: int = 64, device=None) -> Optional[float]:
    """Pearson correlation between the developed sensor decode and the
    embedded camera preview, on luma at a small common grid.

    Returns None when the container has no decodable preview. A correct
    decode of a real file scores well above 0.9 (the camera preview is a
    tone-curved render of the same scene; Pearson tolerates the monotone
    curve); wrong bit packing, CFA phase, or byte order scores near
    zero under EVERY orientation.

    Orientation: develop_raw_image applies the container's Orientation
    tag but vendor preview strips usually carry none of their own, so
    for portrait captures the two renders can be 90/180-degree rotated
    or mirrored relative to each other. The correlation is therefore
    taken as the max over the 8 dihedral placements of the developed
    grid — a correct decode passes under whichever relation holds, a
    wrong unpacking stays near zero under all 8. Both renders run on
    ``device`` (the card unless the caller asks for the CPU)."""
    from .raw import decode_embedded_preview, develop_raw_image, parse_raw

    pv = decode_embedded_preview(data, device)
    if pv is None:
        return None
    pv_planes = pv[0].cpu().numpy()
    if raw is None:
        raw = parse_raw(data)
    dev_planes, _ = develop_raw_image(raw, method="bilinear", device=device)
    return dihedral_luma_correlation(dev_planes.cpu().numpy(), pv_planes,
                                     size=size)


def dihedral_luma_correlation(dev_planes: np.ndarray,
                              pv_planes: np.ndarray,
                              size: int = 64) -> float:
    """Max Pearson correlation of two [3, H, W] renders' luma over the 8
    dihedral placements at a small common grid (the preview_correlation
    core, shared with parse_raw's host-side auto-gate)."""

    def luma_small(planes):
        y = (0.2126 * planes[0] + 0.7152 * planes[1] + 0.0722 * planes[2])
        h, w = y.shape
        ys = (np.arange(size) + 0.5) * h / size
        xs = (np.arange(size) + 0.5) * w / size
        # Box-mean pooling: average each target cell (nearest-bin), so
        # demosaic/scaling detail differences wash out.
        yi = np.minimum((ys).astype(np.int64), h - 1)
        xi = np.minimum((xs).astype(np.int64), w - 1)
        # Use block means when the image is much larger than the grid.
        if h >= 2 * size and w >= 2 * size:
            bh, bw = h // size, w // size
            t = y[: bh * size, : bw * size].reshape(size, bh, size, bw)
            return t.mean(axis=(1, 3))
        return y[np.ix_(yi, xi)]

    a_grid = luma_small(np.asarray(dev_planes, dtype=np.float32))
    b = luma_small(np.asarray(pv_planes, dtype=np.float32))
    b = b.reshape(-1).astype(np.float64)
    b -= b.mean()
    bb = float((b * b).sum())

    best = 0.0
    for flip in (False, True):
        g = a_grid[:, ::-1] if flip else a_grid
        for k in range(4):
            a = np.rot90(g, k).reshape(-1).astype(np.float64)
            a -= a.mean()
            denom = float(np.sqrt((a * a).sum() * bb))
            if denom > 0.0:
                best = max(best, float((a * b).sum() / denom))
    return best


#: Acceptance gate for preview_correlation on real files.
CORRELATION_GATE = 0.9
