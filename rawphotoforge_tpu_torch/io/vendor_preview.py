"""Embedded-preview extraction for non-TIFF RAW containers — the JAX
package's ``io/vendor_preview.py``, as the port's own copy.

Two vendor container families don't use the TIFF/IFD structure the DNG
walker (io/dng.extract_preview) handles:

* Fujifilm RAF — a fixed proprietary header (``FUJIFILMCCD-RAW``) with
  big-endian (offset, length) pointers to an embedded full-EXIF JPEG at
  header offset 84 (the layout libopenraw/exiftool document).
* Canon CR3 — ISO base media (BMFF/MP4) boxes: a THMB thumbnail and a
  PRVW preview live inside vendor ``uuid`` boxes, and the full-size
  rendered JPEG is the first track chunk at the head of ``mdat``. The
  reference opens CR3 through rawler's BMFF decoder
  (rust-godot-legacy/photo-editor/src/image.rs:14-179).
* Sigma X3F — ``FOVb`` header; the last 4 bytes of the file point (u32
  LE) at a ``SECd`` directory whose IMAG/IMA2 entries are image
  sections (``SECi`` header; format 18 = JPEG-compressed preview) —
  the layout x3f_tools/libopenraw document. rawler routes ``.x3f``
  through its x3f module (image.rs:14-179).

These extractors only *locate* JPEG byte ranges — every candidate is
validated by a full Pillow decode in io/dng.extract_preview before
anything is returned, so the loose scanning here can never surface
garbage. Candidates run from an SOI marker to the end of their
enclosing region (not to the first EOI marker: EXIF APP1 segments embed
thumbnails with their own EOI, and a structural JPEG decode stops at
the true end regardless of trailing bytes). Sensor decode for these
containers (other than uncompressed RAF, io/vendor_raw) is a deliberate
non-goal (vendor entropy codecs); the preview is the opening path.
"""

from __future__ import annotations

import struct

RAF_MAGIC = b"FUJIFILMCCD-RAW"
_SOI = b"\xff\xd8\xff"
_MAX_CAND = 64 << 20  # cap one candidate slice (mdat can be huge)


def _soi_candidates(data: bytes, lo: int, hi: int, out: list,
                    max_soi: int = 4) -> None:
    """Append SOI->region-end slices (zero-copy memoryviews — only the
    winning candidate is ever materialized) for up to max_soi SOI
    markers."""
    mv = memoryview(data)
    pos = lo
    for _ in range(max_soi):
        soi = data.find(_SOI, pos, hi)
        if soi < 0:
            return
        out.append(mv[soi:min(hi, soi + _MAX_CAND)])
        pos = soi + 2


def is_raf(data: bytes) -> bool:
    return data[:len(RAF_MAGIC)] == RAF_MAGIC


def is_bmff(data: bytes) -> bool:
    return len(data) >= 12 and data[4:8] == b"ftyp"


def raf_preview_candidates(data: bytes) -> list:
    """JPEG candidates from a Fujifilm RAF container.

    The (offset, length) pointer pair at header offset 84 is
    authoritative; a bounded SOI scan over the header region backs it up
    for variant layouts."""
    cands: list = []
    if len(data) >= 92:
        off, ln = struct.unpack_from(">II", data, 84)
        if 0 < off < len(data) and 0 < ln <= len(data) - off \
                and data[off:off + 3] == _SOI:
            cands.append(memoryview(data)[off:off + ln])
    if not cands:
        _soi_candidates(data, len(RAF_MAGIC), min(len(data), 8 << 20), cands)
    return cands


def _iter_boxes(data: bytes, lo: int, hi: int):
    """Yield (fourcc, payload_start, payload_end) for ISO-BMFF boxes."""
    off = lo
    for _ in range(256):  # bound adversarial box chains
        if off + 8 > hi:
            return
        (size,) = struct.unpack_from(">I", data, off)
        typ = data[off + 4:off + 8]
        hdr = 8
        if size == 1:
            if off + 16 > hi:
                return
            (size,) = struct.unpack_from(">Q", data, off + 8)
            hdr = 16
        elif size == 0:
            size = hi - off
        if size < hdr or off + size > hi:
            return
        yield typ, off + hdr, off + size
        off += size


def bmff_preview_candidates(data: bytes) -> list:
    """JPEG candidates from an ISO-BMFF RAW container (Canon CR3).

    Scans vendor ``uuid`` payloads (THMB/PRVW live there, at both the
    top level and inside ``moov``) and the head of ``mdat`` (the
    full-size JPEG track chunk leads the media data in the CR3 layout).
    """
    cands: list = []
    budget = [2048]  # total boxes parsed, across all nesting levels

    def walk(lo: int, hi: int, depth: int) -> None:
        if depth > 3:
            return
        for typ, s, e in _iter_boxes(data, lo, hi):
            budget[0] -= 1
            if budget[0] <= 0 or len(cands) >= 16:
                return
            if typ == b"uuid" and e - s >= 16:
                _soi_candidates(data, s + 16, e, cands)
            elif typ == b"moov":
                walk(s, e, depth + 1)
            elif typ == b"mdat":
                # Only accept a JPEG that *leads* the media data; deep
                # SOI scans of compressed sensor payload are noise.
                soi = data.find(_SOI, s, min(e, s + 4096))
                if soi >= 0:
                    cands.append(
                        memoryview(data)[soi:min(e, soi + _MAX_CAND)])

    walk(0, len(data), 0)
    return cands


def bmff_exif_tiff_blocks(data: bytes) -> list:
    """TIFF-structured metadata payloads from a BMFF RAW container.

    Canon CR3 stores capture metadata as bare little-endian TIFF streams
    in CMT boxes nested moov > uuid(Canon 85c0b687...) — CMT1 is IFD0
    (Make/Model/DateTime), CMT2 the EXIF IFD content
    (ExposureTime/FNumber/ISO/FocalLength/LensModel as plain IFD0 tags
    of that stream). CMT3 (MakerNote) / CMT4 (GPS) are skipped: vendor
    tag IDs collide numerically with standard ones and would surface
    garbage values. Order is CMT1 before CMT2 as encountered; callers
    merge first-wins."""
    blocks: list = []
    budget = [2048]

    def walk(lo: int, hi: int, depth: int) -> None:
        if depth > 4:
            return
        for typ, s, e in _iter_boxes(data, lo, hi):
            budget[0] -= 1
            if budget[0] <= 0 or len(blocks) >= 8:
                return
            if typ in (b"CMT1", b"CMT2") and data[s:s + 2] in (b"II", b"MM"):
                blocks.append(memoryview(data)[s:e])
            elif typ == b"moov":
                walk(s, e, depth + 1)
            elif typ == b"uuid" and e - s >= 16:
                walk(s + 16, e, depth + 1)

    walk(0, len(data), 0)
    return blocks


X3F_MAGIC = b"FOVb"


def is_x3f(data: bytes) -> bool:
    return data[:4] == X3F_MAGIC


def x3f_preview_candidates(data: bytes) -> list:
    """JPEG candidates from a Sigma X3F container.

    Structure (all integers little-endian): the file's last 4 bytes are
    the offset of the directory section — ``SECd``, version, entry
    count, then 12-byte entries (offset, length, 4-char type). Entries
    typed ``IMAG``/``IMA2`` point at image sections: a 28-byte ``SECi``
    header (magic, version, type, format, columns, rows, rowSize)
    followed by the image data; format 18 is a JPEG-compressed preview.
    The directory walk targets exactly those payloads — a blind SOI
    scan from byte 0 would burn its candidate budget on false SOI
    markers inside the compressed sensor payload that precedes the
    previews in real files. Falls back to the bounded generic scan when
    the directory is damaged."""
    cands: list = []
    try:
        (dir_off,) = struct.unpack_from("<I", data, len(data) - 4)
        if 8 <= dir_off <= len(data) - 12 \
                and data[dir_off:dir_off + 4] == b"SECd":
            (n,) = struct.unpack_from("<I", data, dir_off + 8)
            mv = memoryview(data)
            for i in range(min(n, 64)):
                base = dir_off + 12 + 12 * i
                if base + 12 > len(data) or len(cands) >= 8:
                    break
                off, ln, typ = struct.unpack_from("<II4s", data, base)
                if typ not in (b"IMAG", b"IMA2"):
                    continue
                if not (0 < off < len(data)) or ln < 28 \
                        or ln > len(data) - off:
                    continue
                if data[off:off + 4] != b"SECi":
                    continue
                payload = off + 28
                if data[payload:payload + 3] == _SOI:
                    cands.append(
                        mv[payload:min(off + ln, payload + _MAX_CAND)])
                else:
                    # Format-3/6 sections (uncompressed/huffman sensor
                    # data) are skipped by the SOI check; variant header
                    # paddings get a scan bounded to the section.
                    _soi_candidates(data, payload, off + ln, cands,
                                    max_soi=2)
    except Exception:  # noqa: BLE001 — fall through to the generic scan
        pass
    if not cands:
        _soi_candidates(data, 0, len(data), cands, max_soi=8)
    return cands


def generic_jpeg_candidates(data: bytes) -> list:
    """Last-resort bounded SOI scan for containers with no structured
    extractor (Minolta MRW, …). Every candidate still has to survive
    the caller's full Pillow decode, so a false SOI in compressed
    sensor payload costs one fast header-parse failure and nothing
    else."""
    cands: list = []
    _soi_candidates(data, 0, len(data), cands, max_soi=8)
    return cands


def vendor_preview_candidates(data: bytes) -> list:
    if is_raf(data):
        return raf_preview_candidates(data)
    if is_bmff(data):
        return bmff_preview_candidates(data)
    if is_x3f(data):
        return x3f_preview_candidates(data)
    return generic_jpeg_candidates(data)
