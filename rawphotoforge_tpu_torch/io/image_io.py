"""Image file I/O: decode to linear-light planar float32, encode from sRGB.

The JAX package's ``io/image_io.py`` for the display formats. Reference
contract (rust/photo-editor/src/image.rs):
* read_image (:386-480) — decode JPEG/PNG/WebP/TIFF, apply EXIF
  orientation, convert sRGB-encoded formats to *linear* sRGB (TIFF is
  passed through untouched, :430-440), produce float32 RGB.
* write_image (:482-511) — clamp to [0,1], truncate to u8, encode.
* 16-bit P6 PPM (max=65535, big-endian) treated as already-linear data
  (web-ts/core/image.ts:146-195).

Pillow is imported lazily, inside the PIL-format paths: PPM16 in and
PPM16/PNG16 out need only numpy and zlib. RAW containers (DNG, the
TIFF-structured RAWs and the vendor containers) decode through ``io/raw``.
"""

from __future__ import annotations

import io as _io
import os

import numpy as np
import torch

from .._errbase import PhotoEditorError
from ..core.color import srgb_to_linear

SUPPORTED_EXTENSIONS = {
    ".jpg": "JPEG", ".jpeg": "JPEG", ".png": "PNG",
    ".webp": "WEBP", ".tif": "TIFF", ".tiff": "TIFF",
    ".ppm": "PPM16", ".dng": "DNG",
}

# TIFF-structured and vendor RAW containers (the JAX package's io/raw).
RAW_EXTENSIONS = {
    ".dng", ".arw", ".nef", ".nrw", ".cr2", ".orf", ".pef", ".raf",
    ".rw2", ".srw", ".kdc", ".dcr", ".erf", ".3fr", ".fff", ".iiq",
    ".mos", ".mef", ".mrw", ".sr2", ".srf", ".x3f", ".crw", ".cr3",
    ".rwl", ".raw",
}

# A JPEG export of at least io/jpegenc.SPARSE_MIN_PIXELS goes through
# io/jpegenc's device wires (the packed wire first: the card emits the
# finished entropy-coded scan, io/jpegbits) instead of the u8 RGB fetch +
# Pillow, as the JAX package's does.


class ImageIOError(PhotoEditorError, ValueError):
    """Unsupported or undecodable image data (errors.rs taxonomy)."""


def format_for_path(path: str) -> str:
    ext = os.path.splitext(path)[1].lower()
    if ext not in SUPPORTED_EXTENSIONS:
        if ext in RAW_EXTENSIONS:
            return "DNG"
        raise ImageIOError(f"unsupported image format: {ext!r}")
    return SUPPORTED_EXTENSIONS[ext]


def format_for_bytes(data: bytes) -> str:
    """Best-effort format from container magic, for data without a file
    name: TIFF-structured and vendor RAW containers route to the RAW walker
    ("DNG"), a 16-bit P6 PPM to "PPM16" (only when its maxval token is
    65535; '#' ends a token and runs to the end of the line, as in
    ``_parse_ppm16``), everything else to "JPEG", whose decode (Pillow)
    identifies common bitmaps by magic itself."""
    head = data[:16]
    if (head[:4] in (b"II*\x00", b"MM\x00*", b"IIU\x00")
            or head[:8] == b"FUJIFILM"          # RAF
            or head[4:8] == b"ftyp"             # Canon CR3 (ISO-BMFF)
            or head[:4] == b"FOVb"):            # Sigma X3F
        return "DNG"
    if head[:2] == b"P6":
        toks: list[bytes] = []
        i, n, cur = 2, min(len(data), 4096), b""
        while i < n and len(toks) < 3:
            ch = data[i:i + 1]
            if ch == b"#":
                if cur:
                    toks.append(cur)
                    cur = b""
                while i < n and data[i:i + 1] not in (b"\n", b"\r"):
                    i += 1
            elif ch.isspace():
                if cur:
                    toks.append(cur)
                    cur = b""
            else:
                cur += ch
            i += 1
        if cur and len(toks) < 3:
            toks.append(cur)
        if len(toks) == 3 and toks[2] == b"65535":
            return "PPM16"
    return "JPEG"


def _parse_ppm16(data: bytes) -> np.ndarray:
    """16-bit big-endian P6 PPM -> u16 HWC samples (image.ts:146-195).

    Header tokens are separated by any whitespace, '#' comments run to end
    of line, and exactly one whitespace byte after maxval precedes the
    pixel data."""
    try:
        pos = 0
        n = len(data)
        fields = []
        while len(fields) < 4:
            while pos < n and data[pos:pos + 1].isspace():
                pos += 1
            if pos < n and data[pos:pos + 1] == b"#":
                pos = data.index(b"\n", pos) + 1
                continue
            start = pos
            while pos < n and not data[pos:pos + 1].isspace() \
                    and data[pos:pos + 1] != b"#":
                pos += 1
            if pos == start:
                raise ImageIOError("truncated PPM header")
            fields.append(data[start:pos])
        pos += 1  # the single whitespace byte terminating maxval
        magic = fields[0]
        w, h, maxval = int(fields[1]), int(fields[2]), int(fields[3])
        if magic != b"P6":
            raise ImageIOError("PPM must be binary P6")
        if maxval != 65535:
            raise ImageIOError("only 16-bit PPM (max=65535) is supported")
        if not (0 < w <= 65535 and 0 < h <= 65535):
            raise ImageIOError(f"bad PPM dimensions {w}x{h}")
        raw = np.frombuffer(data, dtype=">u2", count=w * h * 3, offset=pos)
        return raw.reshape(h, w, 3).astype(np.uint16)
    except ImageIOError:
        raise
    except (ValueError, IndexError, OverflowError) as e:
        raise ImageIOError(f"malformed PPM: {e}") from e


def decode_ppm16(data: bytes) -> np.ndarray:
    """16-bit P6 PPM -> float32 HWC in [0,1]."""
    return _parse_ppm16(data).astype(np.float32) / 65535.0


def encode_ppm16(hwc: np.ndarray) -> bytes:
    """float32 HWC [0,1] -> 16-bit big-endian P6 PPM bytes."""
    h, w = hwc.shape[:2]
    u16 = (np.clip(hwc, 0.0, 1.0) * 65535.0).astype(">u2")
    return b"P6\n%d %d\n65535\n" % (w, h) + u16.tobytes()


def _png_unfilter(rows: np.ndarray, filters: np.ndarray, bpp: int) -> np.ndarray:
    """PNG row unfiltering (PNG spec 4.5.4) in numpy: the test oracle of
    ``native.png_unfilter``, which the open path runs. Filters 0/2
    vectorize, 1 (Sub) is a per-lane cumulative sum, 3/4 (Average/Paeth)
    loop over the row's bytes in Python."""
    h, stride = rows.shape
    out = rows.astype(np.int32)
    for y in range(h):
        f = int(filters[y])
        row = out[y]
        up = out[y - 1] if y > 0 else np.zeros(stride, np.int32)
        if f == 0:
            pass
        elif f == 1:
            lanes = row[: stride - stride % bpp].reshape(-1, bpp)
            np.cumsum(lanes, axis=0, out=lanes)
        elif f == 2:
            row += up
        elif f == 3:
            for x in range(stride):
                a = row[x - bpp] & 0xFF if x >= bpp else 0
                row[x] += (a + (up[x] & 0xFF)) >> 1
                row[x] &= 0xFF
        elif f == 4:
            for x in range(stride):
                a = row[x - bpp] & 0xFF if x >= bpp else 0
                b = up[x] & 0xFF
                c = up[x - bpp] & 0xFF if x >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (
                    b if pb <= pc else c)
                row[x] = (row[x] + pred) & 0xFF
        else:
            raise ImageIOError(f"PNG filter type {f}")
        out[y] = row & 0xFF
    return out.astype(np.uint8)


# Adam7 interlace pass origins/strides (PNG spec 8.2): (x0, y0, dx, dy).
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _parse_png48(data: bytes) -> np.ndarray | None:
    """Decode a 16-bit-per-channel PNG at full depth -> u16 HWC RGB, or None
    for PNGs Pillow decodes at full depth itself. Pillow READS 16-bit
    RGB/RGBA/LA PNGs by truncating to 8 bits; the reference decodes them at
    full depth (image.rs:386-480), and PNG16 exports must round-trip.
    Raises ImageIOError on a malformed file (including any CRC mismatch)."""
    import struct
    import zlib

    if data[:8] != b"\x89PNG\r\n\x1a\n" or len(data) < 33:
        return None
    if data[12:16] != b"IHDR":
        return None
    w, h, depth, ctype, comp, filt, ilace = struct.unpack(
        ">IIBBBBB", data[16:29])
    if depth != 16 or ctype not in (0, 2, 4, 6):
        return None
    if ctype == 0 and ilace == 0:
        return None  # Pillow: full-depth I;16B
    channels = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
    bpp = channels * 2
    from .. import native

    def unfilter(buf: bytes, ph: int, pw: int) -> np.ndarray:
        stride = pw * bpp
        grid = np.frombuffer(buf, np.uint8).reshape(ph, 1 + stride)
        # The native unfilter writes in place: hand it a writable copy of
        # the rows (np.frombuffer's view is read-only).
        rows = grid[:, 1:].copy()
        native.png_unfilter(rows, grid[:, 0].copy(), bpp)
        return rows.view(">u2").reshape(ph, pw, channels).astype(np.uint16)

    try:
        if comp != 0 or filt != 0:
            raise ValueError(f"compression/filter method {comp}/{filt}")
        if ilace not in (0, 1):
            raise ValueError(f"interlace method {ilace}")
        if not (0 < w <= 1 << 24 and 0 < h <= 1 << 24):
            raise ValueError(f"dimensions {w}x{h}")
        if w * h > (1 << 28):
            raise ValueError(f"unreasonable pixel count {w * h}")
        idat = []
        pos = 8
        while pos + 8 <= len(data):
            (ln,) = struct.unpack_from(">I", data, pos)
            tag = data[pos + 4 : pos + 8]
            if pos + 12 + ln > len(data):
                raise ValueError(f"truncated {tag!r} chunk")
            (crc,) = struct.unpack_from(">I", data, pos + 8 + ln)
            if zlib.crc32(data[pos + 4 : pos + 8 + ln]) != crc:
                raise ValueError(f"bad CRC in {tag!r} chunk")
            if tag == b"IDAT":
                idat.append(data[pos + 8 : pos + 8 + ln])
            pos += 12 + ln
            if tag == b"IEND":
                break
        raw = zlib.decompress(b"".join(idat))
        if ilace == 0:
            if len(raw) != h * (1 + w * bpp):
                raise ValueError(
                    f"IDAT inflates to {len(raw)} bytes, "
                    f"want {h * (1 + w * bpp)}")
            out = unfilter(raw, h, w)
        else:
            out = np.zeros((h, w, channels), np.uint16)
            off = 0
            for x0, y0, dx, dy in _ADAM7:
                pw = (w - x0 + dx - 1) // dx
                ph = (h - y0 + dy - 1) // dy
                if pw == 0 or ph == 0:
                    continue
                n = ph * (1 + pw * bpp)
                if off + n > len(raw):
                    raise ValueError("truncated interlaced image data")
                out[y0::dy, x0::dx] = unfilter(raw[off:off + n], ph, pw)
                off += n
            if off != len(raw):
                raise ValueError(
                    f"{len(raw) - off} trailing bytes after the last "
                    "interlace pass")
        if ctype == 6:
            out = out[:, :, :3]
        elif ctype == 4:
            out = np.repeat(out[:, :, :1], 3, axis=2)
        elif ctype == 0:
            out = np.repeat(out, 3, axis=2)
        return np.ascontiguousarray(out)
    except (ValueError, zlib.error, struct.error) as e:
        raise ImageIOError(f"malformed 16-bit PNG: {e}") from e


def encode_png16(u16_hwc: np.ndarray,
                 exif_bytes: bytes | None = None) -> bytes:
    """u16 HWC RGB -> 48-bit (16-bit/channel) PNG bytes: IHDR depth 16 /
    color type 2, one zlib IDAT of filter-0 rows with big-endian samples,
    optional eXIf chunk (the TIFF-structured payload, APP1 prefix
    stripped). Pillow cannot write 48-bit RGB PNGs."""
    import struct
    import zlib

    a = np.ascontiguousarray(u16_hwc)
    if a.ndim != 3 or a.shape[2] != 3 or a.dtype != np.uint16:
        raise ImageIOError(
            f"encode_png16 needs u16 HWC RGB, got {a.dtype} {a.shape}")
    h, w = a.shape[:2]

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload)))

    ihdr = struct.pack(">IIBBBBB", w, h, 16, 2, 0, 0, 0)
    rows = a.astype(">u2").tobytes()
    stride = w * 6
    raw = b"".join(b"\x00" + rows[i * stride:(i + 1) * stride]
                   for i in range(h))
    out = [b"\x89PNG\r\n\x1a\n", chunk(b"IHDR", ihdr)]
    if exif_bytes:
        blob = normalize_exif_blob(exif_bytes)
        if blob.startswith(b"Exif\x00\x00"):
            blob = blob[6:]
        if blob:
            out.append(chunk(b"eXIf", blob))
    out.append(chunk(b"IDAT", zlib.compress(raw, 6)))
    out.append(chunk(b"IEND", b""))
    return b"".join(out)


def _orient_np(planes: np.ndarray, o: int) -> np.ndarray:
    """EXIF orientation (2..8) of [C, H, W] host planes (image.rs:559-608)."""
    if o == 2:
        return planes[:, :, ::-1]
    if o == 3:
        return planes[:, ::-1, ::-1]
    if o == 4:
        return planes[:, ::-1, :]
    if o == 5:
        return planes.transpose(0, 2, 1)
    if o == 6:
        return planes[:, ::-1, :].transpose(0, 2, 1)
    if o == 7:
        return planes[:, ::-1, ::-1].transpose(0, 2, 1)
    if o == 8:
        return planes[:, :, ::-1].transpose(0, 2, 1)
    return planes


def pad_to_bucket_np(arr: np.ndarray, bucket: int) -> np.ndarray:
    """Host-side edge-pad of [..., H, W] up to multiples of ``bucket``."""
    *lead, h, w = arr.shape
    ph = (-h) % bucket
    pw = (-w) % bucket
    if ph == 0 and pw == 0:
        return arr
    return np.pad(arr, [(0, 0)] * len(lead) + [(0, ph), (0, pw)], mode="edge")


def _upload(chw: np.ndarray, scale, linearize: bool, device) -> torch.Tensor:
    """Host integer (or float) planes -> device f32 planes: the samples
    cross at their native width (``utils/transfer.put_np``) and are
    normalized on the device (a u16 plane travels as its i16 bit
    pattern)."""
    from ..utils.transfer import put_np

    chw = np.ascontiguousarray(chw)
    if chw.dtype == np.uint16:
        t = put_np(chw.view(np.int16), device=device).to(torch.int32) & 0xFFFF
    else:
        t = put_np(chw, device=device)
    y = t.to(torch.float32)
    if scale is not None:
        # A device-tensor divisor: true division, as the JAX package
        # divides (a Python-scalar divisor multiplies by the reciprocal on
        # the card).
        y = y / torch.tensor(float(scale), dtype=torch.float32, device=device)
    return srgb_to_linear(y) if linearize else y


class HostDecoded:
    """The host half of a decode: metadata, the true shape, and
    ``upload_padded(device, bucket)``, which edge-pads the pixels on the
    host up to the bucket grid and moves them to the device.

    ``instant``: the sRGB u8 HWC instant preview (``engine/instant``), or
    None; ``instant_linear``: small linear planes [3, h, w] f32 matching it
    (the ``engine/hostdev`` era-render source), or None when the decode had
    no cheap linear form (``HostOpen.instant_linear`` recovers them from
    ``instant``)."""

    __slots__ = ("exif", "shape", "_chw", "_scale", "_linearize", "instant",
                 "instant_linear")

    def __init__(self, exif, chw, scale, linearize, instant=None,
                 instant_linear=None):
        self.exif = exif
        self.shape = tuple(chw.shape[1:])
        self._chw = chw
        self._scale = scale
        self._linearize = linearize
        self.instant = instant
        self.instant_linear = instant_linear

    def upload(self, device) -> torch.Tensor:
        return _upload(self._chw, self._scale, self._linearize, device)

    def upload_padded(self, device, bucket: int) -> torch.Tensor:
        return _upload(pad_to_bucket_np(self._chw, bucket), self._scale,
                       self._linearize, device)


def decode_image_host(data: bytes, fmt: str,
                      instant_long_edge: int | None = None):
    """Container parse on the host: every file-content error surfaces here.
    PPM16 samples are linear already; PIL formats other than TIFF are
    linearized on the device after the upload (image.rs:430-440); RAW
    containers ("DNG") return ``io/raw.RawHostDecoded``, whose upload runs
    the device develop. With ``instant_long_edge``, the instant preview (at
    most that long edge) is made from the host pixels the decode holds —
    no device work (``engine/instant``)."""
    if fmt == "PPM16":
        u16 = _parse_ppm16(data)
        chw = np.ascontiguousarray(u16.transpose(2, 0, 1))
        pv = lin = None
        if instant_long_edge:
            from ..engine import instant

            lin = instant.quick_linear_from_linear_rgb(
                chw.astype(np.float32) / 65535.0, instant_long_edge)
            pv = instant._to_u8_hwc(lin)
        return HostDecoded({}, chw, 65535.0, False, instant=pv,
                           instant_linear=lin)
    if fmt == "DNG":
        from .raw import decode_raw_host

        return decode_raw_host(data, instant_long_edge=instant_long_edge)
    from PIL import Image as PILImage, ImageOps

    from .exif import parse_exif

    try:
        img = PILImage.open(_io.BytesIO(data))
        exif = parse_exif(img)
        raw_exif = img.info.get("exif")
        if raw_exif:
            # Raw blob for metadata write-back into exports; editors pop it.
            exif["_exif_bytes"] = raw_exif
        png48 = _parse_png48(data) if fmt == "PNG" else None
        if png48 is not None:
            try:
                o = int(img.getexif().get(0x0112, 1) or 1)
            except Exception:  # noqa: BLE001 — orientation is best-effort
                o = 1
            arr = np.ascontiguousarray(
                _orient_np(png48.transpose(2, 0, 1), o).transpose(1, 2, 0))
            scale = 65535.0
        else:
            img = ImageOps.exif_transpose(img)
            if img.mode in ("I;16", "I;16B", "I;16L"):
                arr, scale = np.asarray(img, dtype=np.uint16), 65535.0
            elif img.mode == "I":
                # 32-bit integer mode: values may exceed 65535.
                arr, scale = np.asarray(img, dtype=np.float32) / 65535.0, None
            elif img.mode == "F":
                arr, scale = np.asarray(img, dtype=np.float32), None
            else:
                if img.mode not in ("RGB", "L"):
                    img = img.convert("RGB")
                arr, scale = np.asarray(img, dtype=np.uint8), 255.0
    except (PhotoEditorError, MemoryError):
        raise
    except Exception as e:  # noqa: BLE001 — PIL raises OSError/ValueError/
        # SyntaxError subclasses at open, transpose or pixel access.
        raise ImageIOError(f"failed to decode {fmt}: {e}") from e
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    linearize = fmt != "TIFF"
    pv = lin = None
    if instant_long_edge:
        from ..engine import instant

        if scale == 255.0:
            # sRGB u8 source: the linear era-render planes are recovered
            # from the u8 instant on demand (lossless round trip).
            pv = instant.quick_from_srgb_u8(arr, instant_long_edge)
        else:
            hostf = arr.astype(np.float32)
            if scale is not None:
                hostf /= np.float32(scale)
            planes_h = hostf.transpose(2, 0, 1)
            if linearize:
                # Encoded-space resize, like quick_from_srgb_u8 (a stand-in
                # image; sub-quantization difference at preview scale).
                small = instant._fit_long_edge(planes_h, instant_long_edge)
                pv = np.ascontiguousarray(
                    np.clip(small * 255.0 + 0.5, 0.0, 255.0)
                    .astype(np.uint8).transpose(1, 2, 0))
            else:
                lin = instant.quick_linear_from_linear_rgb(
                    planes_h, instant_long_edge)
                pv = instant._to_u8_hwc(lin)
    return HostDecoded(exif, np.ascontiguousarray(arr.transpose(2, 0, 1)),
                       scale, linearize, instant=pv, instant_linear=lin)


def decode_image(data: bytes, fmt: str, device=None,
                 instant_out: dict | None = None):
    """Decode container bytes -> (linear planes f32 [3, H, W] on ``device``,
    exif dict): EXIF orientation applied, sRGB formats linearized (TIFF
    passed through, image.rs:430-440), RAW containers developed.

    ``instant_out``: optional dict; when given, the host instant preview
    (``"srgb_u8_hwc"``, at most ``instant_out.get("long_edge", 1280)`` px)
    is stashed from the host data the decode holds, when it has one."""
    from .._device import resolve_device

    dev = resolve_device(device)
    edge = None
    if instant_out is not None:
        edge = int(instant_out.get("long_edge", 1280))
    hd = decode_image_host(data, fmt, instant_long_edge=edge)
    if instant_out is not None and hd.instant is not None:
        instant_out["srgb_u8_hwc"] = hd.instant
    return hd.upload(dev), hd.exif


def read_image(path: str, device=None):
    """Load a file -> (linear planes f32 [3, H, W] on ``device``, exif)."""
    fmt = format_for_path(path)
    with open(path, "rb") as f:
        data = f.read()
    return decode_image(data, fmt, device=device)


def normalize_exif_blob(exif_bytes: bytes) -> bytes:
    """Reset the Orientation tag to 1 in a raw EXIF blob (pixels are
    rotated upright at decode); blobs already at 1 pass through untouched,
    as does a blob PIL cannot parse."""
    try:
        from PIL import Image as PILImage

        ex = PILImage.Exif()
        ex.load(exif_bytes)
        if ex.get(274, 1) == 1:
            return exif_bytes
        ex[274] = 1  # Orientation = normal
        return ex.tobytes()
    except Exception:  # noqa: BLE001 - unparseable blob: pass through
        return exif_bytes


def build_exif_bytes(exif: dict | None) -> bytes | None:
    """Synthesize an EXIF APP1 payload from a parsed metadata dict (Make,
    Model, Software, ExposureTime, FNumber, ISO, FocalLength, LensModel,
    DateTime), or None when nothing is writable."""
    if not exif:
        return None
    from PIL import Image as PILImage
    from PIL.TiffImagePlugin import IFDRational as _Rat

    from .exif import parse_rational

    def _rat(v):
        nd = parse_rational(v)
        return None if nd is None else _Rat(*nd)

    ex = PILImage.Exif()
    wrote = False
    for tag, key in ((271, "Make"), (272, "Model"), (305, "Software")):
        v = exif.get(key)
        if v:
            ex[tag] = str(v)
            wrote = True
    sub = ex.get_ifd(0x8769)  # Exif sub-IFD
    for tag, key in ((33434, "ExposureTime"), (33437, "FNumber"),
                     (37386, "FocalLength")):
        v = exif.get(key)
        if v is not None:
            r = _rat(v)
            if r is not None:
                sub[tag] = r
                wrote = True
    iso = exif.get("ISO")
    if iso is not None:
        try:
            sub[34855] = int(float(iso))
            wrote = True
        except (ValueError, OverflowError):
            pass
    lens = exif.get("LensModel")
    if lens:
        sub[42036] = str(lens)
        wrote = True
    dt = exif.get("DateTime") or exif.get("DateTimeOriginal")
    if dt:
        ex[306] = str(dt)          # DateTime (IFD0)
        sub[36867] = str(dt)       # DateTimeOriginal
        wrote = True
    if not wrote:
        return None
    import struct as _struct

    try:
        return ex.tobytes()
    except (TypeError, ValueError, OSError, _struct.error):
        return None


def encode_image(planes: torch.Tensor, fmt: str, quality: int = 95,
                 exif_bytes=None, host_crop=None, on_stage=None) -> bytes:
    """sRGB-encoded f32 [3,H,W] in [0,1] -> container bytes. A JPEG of at
    least ``jpegenc.SPARSE_MIN_PIXELS`` goes through the JPEG device wires
    (io/jpegenc.encode_jpeg); otherwise quantization runs on the planes'
    device, so the copy to the host carries 1 or 2 bytes per sample.
    ``host_crop`` (r0, r1, c0, c1) is applied on the host after the fetch.
    ``on_stage(name)`` is called entering the 'fetch' (device to host) and
    'encode' (host container encode) stages: the progress of an async
    export."""
    from ..utils.transfer import fetch_np, fetch_u8_hwc, fetch_u16_hwc

    stage = on_stage or (lambda _name: None)

    def hcrop(hwc):
        if host_crop is None:
            return hwc
        r0, r1, c0, c1 = host_crop
        return np.ascontiguousarray(hwc[r0:r1, c0:c1])

    if fmt == "DNG":
        raise ImageIOError(
            "cannot encode a developed image as DNG; use io.dng.write_dng "
            "for CFA mosaics (or the editor's save_hdr_dng for the "
            "scene-linear render)")
    if fmt == "PNG16":
        stage("fetch")
        hwc = hcrop(fetch_u16_hwc(planes))
        stage("encode")
        return encode_png16(hwc, exif_bytes=exif_bytes)
    if fmt == "PPM16":
        # PPM16 is a LINEAR container (the decode takes its samples as
        # linear light): undo the render's sRGB OETF before storing.
        lin = srgb_to_linear(torch.clamp(planes, 0.0, 1.0))
        stage("fetch")
        hwc = hcrop(fetch_np(lin).transpose(1, 2, 0))
        stage("encode")
        return encode_ppm16(hwc)
    if fmt == "JPEG" and host_crop is None:
        from . import jpegenc

        npix = int(planes.shape[-2]) * int(planes.shape[-1])
        if npix >= jpegenc.SPARSE_MIN_PIXELS:
            # Export-sized: the device wires. Previews stay on the u8 path;
            # a crop (host_crop) cannot slice DCT blocks, so it does too.
            return jpegenc.encode_jpeg(planes, quality=quality,
                                       exif_bytes=exif_bytes,
                                       on_stage=on_stage)
    from PIL import Image as PILImage

    stage("fetch")
    u8 = hcrop(fetch_u8_hwc(planes))
    stage("encode")
    img = PILImage.fromarray(u8, mode="RGB")
    buf = _io.BytesIO()
    save_kwargs = {}
    if fmt in ("JPEG", "WEBP"):
        save_kwargs["quality"] = quality
    if exif_bytes and fmt in ("JPEG", "PNG", "WEBP", "TIFF"):
        save_kwargs["exif"] = normalize_exif_blob(exif_bytes)
    img.save(buf, format=fmt, **save_kwargs)
    return buf.getvalue()


def write_image(path: str, srgb_planes: torch.Tensor, quality: int = 95) -> None:
    """Write sRGB-encoded planes [3, H, W] to a file by extension."""
    fmt = format_for_path(path)
    data = encode_image(srgb_planes, fmt, quality=quality)
    with open(path, "wb") as f:
        f.write(data)


def linear_planes_to_srgb_u8(planes: torch.Tensor) -> np.ndarray:
    """Linear [3, H, W] -> sRGB u8 HWC on the host (thumbnails, mask UIs)."""
    from ..core.color import linear_to_srgb
    from ..utils.transfer import fetch_u8_hwc

    return fetch_u8_hwc(linear_to_srgb(torch.clamp(planes, 0.0, 1.0)))
