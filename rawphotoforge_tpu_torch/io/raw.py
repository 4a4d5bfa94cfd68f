"""RAW ingestion glue: RAW bytes -> linear sRGB planes on the device.

The JAX package's ``io/raw.py``: container parse on the host (``io/dng``
for DNG and TIFF-structured RAWs, Sony ARW2 included; ``io/cr2``;
``io/vendor_raw`` for Panasonic RW2 and Fujifilm RAF), the decode gate of
the memory-derived codecs (ARW2, RAW4) against the file's embedded camera
preview, then normalize -> WB -> demosaic -> camera matrix on the device
(``ops/demosaic``), the DNG OpcodeList3 warps and radial vignette
(``ops/lenscorr``), DefaultCrop and EXIF orientation.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from .._device import resolve_device
from ..ops import demosaic as dm
from ..ops.develop import replicate_true_edges
from ..ops.geometry import orient_exif
from ..utils.profiling import span
from .dng import RawImage, read_dng
from .image_io import RAW_EXTENSIONS


def is_raw_image(path: str) -> bool:
    """Extension-based RAW detection (image.rs:14-179)."""
    return os.path.splitext(path)[1].lower() in RAW_EXTENSIONS


def parse_raw(data: bytes, apply_opcodes: bool = True) -> RawImage:
    """Sniff the container type and parse RAW bytes into a RawImage.

    Canon CR2 carries a CR\\x02 marker at byte 8; Panasonic RW2 stamps
    TIFF magic 0x0055; Fujifilm RAF has its fixed ``FUJIFILMCCD-RAW``
    header; everything else TIFF-structured (DNG, uncompressed
    NEF/ARW/other TIFF-EP RAWs, Sony ARW2) goes through the DNG walker.
    A decode through a memory-derived codec (``needs_verification``) must
    pass the embedded-preview gate. ``apply_opcodes=False`` is the
    lossless-transcode mode (see read_dng)."""
    from .cr2 import is_cr2, read_cr2
    from .vendor_raw import is_raf, is_rw2, read_raf, read_rw2

    if is_cr2(data):
        raw = read_cr2(data)
    elif is_rw2(data):
        raw = read_rw2(data)
    elif is_raf(data):
        raw = read_raf(data)
    else:
        raw = read_dng(data, apply_opcodes=apply_opcodes)
    if raw.needs_verification:
        verify_memory_derived_decode(data, raw)
    return raw


def gate_correlation(data: bytes, raw: RawImage):
    """The decode gate's correlation: a host superpixel develop of the
    decoded mosaic (``engine/instant``) against the file's embedded camera
    preview (JPEG draft decode at >= 256 px), max Pearson over the 8
    dihedral placements. None when there is no usable preview."""
    import io as _io

    from PIL import Image as PILImage

    from ..engine import instant
    from .dng import extract_preview
    from .vendor_raw import dihedral_luma_correlation

    jpeg = extract_preview(data)
    if jpeg is None:
        return None
    try:
        img = PILImage.open(_io.BytesIO(jpeg))
        # JPEG draft mode: decode at the nearest 1/2^k scale >= 256 px —
        # the correlation pools to a 64-grid anyway.
        img.draft("RGB", (256, 256))
        pv_u8 = np.asarray(img.convert("RGB"))
    except Exception:  # noqa: BLE001 — a corrupt preview can't verify
        return None
    if pv_u8.ndim != 3 or min(pv_u8.shape[:2]) < 8:
        return None
    pv_lin = instant.linear_from_srgb_u8(np.ascontiguousarray(pv_u8))
    dev = instant.quick_linear_from_raw(raw, 128)
    if dev is None:
        return None
    return dihedral_luma_correlation(dev, pv_lin)


def verify_memory_derived_decode(data: bytes, raw: RawImage) -> None:
    """The silent-wrong gate of the memory-derived bitstream codecs
    (io/vendor_packed: Sony ARW2, Panasonic RAW4): below the 0.9 gate the
    decode is REFUSED with a typed DngError, and callers' preview fallback
    then opens the file loudly (``opened_from_preview`` carries this
    message). Files without a decodable embedded preview pass unverified
    (fixtures; every real camera writes one)."""
    from .dng import DngError
    from .vendor_raw import CORRELATION_GATE

    corr = gate_correlation(data, raw)
    if corr is not None and corr < CORRELATION_GATE:
        raise DngError(
            f"memory-derived packed decode failed the embedded-preview "
            f"correlation gate ({corr:.3f} < {CORRELATION_GATE}); "
            f"refusing possibly-wrong sensor data")


def decode_embedded_preview(data: bytes, device=None):
    """Decode the embedded camera-rendered JPEG preview of a RAW file:
    (linear planes f32 [3, H, W] on ``device``, exif dict), or None when
    there is no decodable preview."""
    hd = decode_embedded_preview_host(data)
    if hd is None:
        return None
    return hd.upload(resolve_device(device)), hd.exif


def decode_embedded_preview_host(data: bytes,
                                 instant_long_edge: int | None = None):
    """Host phase of decode_embedded_preview: preview extraction, the
    Pillow decode (with its instant preview at ``instant_long_edge``) and
    the container-EXIF merge (image_io.HostDecoded)."""
    from .._errbase import PhotoEditorError
    from .dng import extract_preview
    from .image_io import ImageIOError, decode_image_host

    jpeg = extract_preview(data)
    if jpeg is None:
        return None
    try:
        hd = decode_image_host(jpeg, "JPEG",
                               instant_long_edge=instant_long_edge)
    except PhotoEditorError:
        raise
    except Exception as e:  # noqa: BLE001 — PIL's hierarchy stays inside
        raise ImageIOError(f"embedded preview failed to decode: {e}") from e
    exif = hd.exif
    # The container's tags are the capture record; the preview's parsed
    # tags fill per field, and its raw blob is dropped when the container
    # knows fields the blob lacks (write-back prefers the blob verbatim).
    merged = container_exif(data)
    pv_fields = {k for k in exif if k != "_exif_bytes"}
    if merged and any(k not in pv_fields for k in merged):
        exif.pop("_exif_bytes", None)
    merged.update(exif)
    hd.exif = merged
    return hd


def container_exif(data: bytes) -> dict:
    """Best-effort capture metadata from any RAW container, without
    decoding sensor data: the TIFF IFD forest for TIFF-structured files,
    or the CMT metadata boxes of a BMFF container (Canon CR3)."""
    from .dng import _EXIF_TAGS, _format_exif, extract_container_exif
    from .vendor_preview import bmff_exif_tiff_blocks, is_bmff

    exif = dict(extract_container_exif(data))
    if not exif and is_bmff(data):
        # Merge the CMT streams at the raw-TAG level, then format once:
        # CMT1 (IFD0 stream) holds DateTime(306), CMT2 (EXIF stream)
        # DateTimeOriginal(36867) — a per-block format + dict merge would
        # let CMT1's modification time shadow the capture time.
        from .dng import extract_container_tags

        tags: dict = {}
        for blk in bmff_exif_tiff_blocks(data):
            for t, v in extract_container_tags(bytes(blk), _EXIF_TAGS).items():
                tags.setdefault(t, v)
        if tags:
            exif = _format_exif(tags.get)
    return exif


def estimate_gray_world_gains(mosaic: np.ndarray, pattern: str,
                              black: float, white: float) -> tuple:
    """Gray-world WB gains from per-CFA-channel means (host numpy), for
    RAWs without a usable camera WB; clipped to [0.25, 8]."""
    m = np.asarray(mosaic)
    if m.ndim == 3:  # demosaiced RGB
        sub = m[:: max(1, m.shape[0] // 512), :: max(1, m.shape[1] // 512)]
        means = sub.reshape(-1, 3).astype(np.float64).mean(axis=0)
    else:
        tile = np.asarray(dm.NAMED_CFA[pattern])
        ph, pw = tile.shape
        th, tw = m.shape[0] // ph, m.shape[1] // pw
        if th == 0 or tw == 0:
            return (1.0, 1.0, 1.0)
        # Subsample whole CFA tiles (every channel phase kept).
        t = m[: th * ph, : tw * pw].reshape(th, ph, tw, pw)
        t = t[:: max(1, th // 512), :, :: max(1, tw // 512), :]
        sub = t.reshape(t.shape[0] * ph, t.shape[2] * pw)
        yy, xx = np.mgrid[0:sub.shape[0], 0:sub.shape[1]]
        chan = tile[yy % ph, xx % pw]
        vals = sub.astype(np.float64)
        means = np.array([
            vals[chan == c].mean() if (chan == c).any() else 1.0
            for c in range(3)
        ])
    span = max(float(white) - float(black), 1e-9)
    means = np.maximum((means - float(black)) / span, 1e-6)
    gains = np.clip(means[1] / means, 0.25, 8.0)
    return (float(gains[0]), 1.0, float(gains[2]))


def with_effective_wb(raw: RawImage) -> RawImage:
    """Substitute gray-world gains when the container had no usable camera
    WB (wb_known=False)."""
    if not raw.wb_known and tuple(raw.wb_gains) == (1.0, 1.0, 1.0):
        raw = dataclasses.replace(
            raw, wb_gains=estimate_gray_world_gains(
                raw.mosaic, raw.pattern, raw.black_level, raw.white_level))
    return raw


def cam2srgb_for(raw: RawImage) -> np.ndarray:
    """The camera -> linear sRGB matrix of a RAW (identity without a
    ColorMatrix1)."""
    if raw.xyz_to_cam is not None:
        return dm.cam_matrix_to_srgb(raw.xyz_to_cam)
    return np.eye(3, dtype=np.float32)


def upload_mosaic(mosaic: np.ndarray, device) -> torch.Tensor:
    """Host CFA samples -> a device tensor for ``normalize_mosaic``, through
    ``utils/transfer.put_np``: a u16 mosaic crosses at 2 B/sample as its
    i16 bit pattern and widens on the device; float (HDR) data crosses as
    f32."""
    from ..utils.transfer import put_np

    m = np.ascontiguousarray(mosaic)
    if m.dtype == np.uint16:
        return put_np(m.view(np.int16), device=device).to(torch.int32) & 0xFFFF
    return put_np(m.astype(np.float32, copy=False), device=device)


def normalized_mosaic(raw: RawImage, mosaic: np.ndarray, device) -> torch.Tensor:
    """Upload + black/white normalize on the device."""
    return dm.normalize_mosaic(upload_mosaic(mosaic, device),
                               raw.black_level, raw.white_level)


# Which mosaic sides take the bucket pad, per EXIF orientation:
# (pad_top, pad_left), chosen so orient_exif maps the pad to the OUTPUT's
# bottom/right and the true region lands at the origin.
_PAD_SIDES = {
    0: (False, False), 1: (False, False), 2: (False, True),
    3: (True, True), 4: (True, False), 5: (False, False),
    6: (True, False), 7: (True, True), 8: (False, True),
}


def bucket_pads(raw: RawImage):
    """Reflect-pad amounts (ph, pw) for the bucket-stable develop, or None
    when the file must take the per-extent path (the JAX package's rules:
    a DefaultCrop adds one bucket per axis so the bucket-size crop slice
    stays in bounds; a crop under rotation, an odd top/left Bayer pad, or
    a 1-px pad fall back)."""
    from ..engine.editor import SHAPE_BUCKET

    h, w = raw.mosaic.shape[:2]
    if h < 2 or w < 2:
        return None
    ph, pw = (-h) % SHAPE_BUCKET, (-w) % SHAPE_BUCKET
    sides = _PAD_SIDES.get(raw.orientation)
    if sides is None:
        return None
    if raw.orientation not in (0, 1):
        if raw.default_crop is not None:
            return None
        if raw.pattern in dm.BAYER_PATTERNS and (
                (sides[0] and ph % 2) or (sides[1] and pw % 2)):
            return None
    if raw.default_crop is not None:
        cx, cy, cw, ch = raw.default_crop
        if not (0 <= cy and 0 <= cx and cy + ch <= h and cx + cw <= w
                and ch >= 1 and cw >= 1):
            return None
        ph += SHAPE_BUCKET
        pw += SHAPE_BUCKET
    if ph == 1 or pw == 1:
        return None
    return ph, pw


def bucket_stable_eligible(raw: RawImage) -> bool:
    """Whether this RAW takes the bucket-stable develop
    (develop_raw_image_padded): Bayer, X-Trans or LinearRaw, with pads
    ``bucket_pads`` accepts. Its true region equals develop_raw_image's
    output bit for bit (Bayer: the reflect pad reproduces Malvar's own
    edge reflection and keeps the phase; X-Trans: pad sites count as
    absent samples of the masked normalized convolution). A file with
    OpcodeList3 warps or a radial vignette develops on the bucket grid
    with coordinates normalized by the true extent, so only orientations
    whose pad lands bottom/right before orientation qualify."""
    if raw.pattern not in dm.BAYER_PATTERNS and raw.pattern not in (
            "RGB", "XTRANS"):
        return False
    if has_opcode_list3(raw) and _PAD_SIDES.get(raw.orientation) != (
            False, False):
        return False
    return bucket_pads(raw) is not None


def has_opcode_list3(raw: RawImage) -> bool:
    """Whether the file carries post-demosaic OpcodeList3 stages."""
    return (raw.warp_rectilinear is not None or raw.warp_fisheye is not None
            or raw.vignette_radial is not None)


def apply_opcode_list3(planes: torch.Tensor, raw: RawImage,
                       extent=None) -> torch.Tensor:
    """DNG OpcodeList3 WarpRectilinear / WarpFisheye (the geometric
    correction phone DNGs rely on) and FixVignetteRadial, post-demosaic
    and before DefaultCrop, in the file's listed order (``vignette_first``:
    the gain is evaluated on pre-warp coordinates). ``extent``: the true
    (h, w) of bucket-padded planes."""
    from ..ops.lenscorr import (vignette_radial_gain, warp_fisheye,
                                warp_rectilinear)

    def warp(p):
        if raw.warp_rectilinear is not None:
            coefs, center = raw.warp_rectilinear
            p = warp_rectilinear(p, coefs, center, extent=extent)
        if raw.warp_fisheye is not None:
            coefs, center = raw.warp_fisheye
            p = warp_fisheye(p, coefs, center, extent=extent)
        return p

    def vignette(p):
        k, center = raw.vignette_radial
        g = vignette_radial_gain(p.shape[1], p.shape[2], k, center,
                                 extent=extent, device=p.device)
        return p * g[None, :, :]

    steps = [(warp, raw.warp_rectilinear is not None
              or raw.warp_fisheye is not None),
             (vignette, raw.vignette_radial is not None)]
    if raw.vignette_first:
        steps.reverse()
    for fn, present in steps:
        if present:
            planes = fn(planes)
    return planes


def develop_raw_image_padded(raw: RawImage, method: str = "malvar",
                             device=None) -> torch.Tensor:
    """Bucket-stable develop: reflect-pad the mosaic on the host to the
    128-bucket shape, develop the padded grid on ``device``, slice the
    DefaultCrop at bucket size, orient, and edge-replicate the true region
    into the pad. Returns planes [3, Hb, Wb] whose true region equals
    develop_raw_image's output."""
    from ..engine.editor import bucket_shape

    dev = resolve_device(device)
    pads = bucket_pads(raw)
    if pads is None or not bucket_stable_eligible(raw):
        raise ValueError("this RAW is not bucket-stable eligible")
    raw = with_effective_wb(raw)
    m = raw.mosaic
    pad_top, pad_left = _PAD_SIDES[raw.orientation]
    pad = [(pads[0], 0) if pad_top else (0, pads[0]),
           (pads[1], 0) if pad_left else (0, pads[1])]
    pad += [(0, 0)] * (m.ndim - 2)
    # numpy on the host: torch's reflect pad needs a batch dimension and
    # refuses pads as wide as the image.
    with span("open.pad"):
        mosaic01 = normalized_mosaic(raw, np.pad(m, pad, mode="reflect"), dev)
    cam = cam2srgb_for(raw)
    if raw.pattern == "RGB":
        planes = dm.develop_linear_raw(mosaic01, raw.wb_gains, cam)
    elif raw.pattern == "XTRANS":
        th0, tw0 = raw.mosaic.shape[:2]
        origin = (pads[0] if pad_top else 0, pads[1] if pad_left else 0)
        planes = dm.develop_raw(mosaic01, raw.wb_gains, cam,
                                pattern=raw.pattern, method=method,
                                true_shape=(th0, tw0), true_origin=origin)
    else:
        planes = dm.develop_raw(mosaic01, raw.wb_gains, cam,
                                pattern=raw.pattern, method=method)
    if has_opcode_list3(raw):
        # bucket_stable_eligible put the pad bottom/right, so the true
        # region sits at the origin when coordinates normalize by it.
        planes = apply_opcode_list3(planes, raw, extent=raw.mosaic.shape[:2])
    if raw.default_crop is not None:
        cx, cy, cw, ch = raw.default_crop
        bh, bw = bucket_shape(ch, cw)
        planes = planes[:, cy : cy + bh, cx : cx + bw]
    planes = orient_exif(planes, raw.orientation)
    th, tw = raw.mosaic.shape[:2]
    if raw.default_crop is not None:
        th, tw = raw.default_crop[3], raw.default_crop[2]
    if raw.orientation in (5, 6, 7, 8):
        th, tw = tw, th
    return replicate_true_edges(planes, th, tw)


def develop_raw_image(raw: RawImage, method: str = "malvar", device=None):
    """RawImage -> (linear sRGB planes f32 [3, H, W] on ``device``, exif)."""
    dev = resolve_device(device)
    raw = with_effective_wb(raw)
    mosaic01 = normalized_mosaic(raw, raw.mosaic, dev)
    cam = cam2srgb_for(raw)
    if raw.pattern == "RGB":
        planes = dm.develop_linear_raw(mosaic01, raw.wb_gains, cam)
    else:
        planes = dm.develop_raw(mosaic01, raw.wb_gains, cam,
                                pattern=raw.pattern, method=method)
    planes = apply_opcode_list3(planes, raw)
    if raw.default_crop is not None:
        cx, cy, cw, ch = raw.default_crop
        planes = planes[:, cy : cy + ch, cx : cx + cw]
    return orient_exif(planes, raw.orientation), dict(raw.exif)


def read_raw(path_or_bytes, method: str = "malvar", device=None):
    """Load a RAW file (path or bytes) -> (linear planes on ``device``,
    exif)."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    return develop_raw_image(parse_raw(data), method=method, device=device)


class RawHostDecoded:
    """The host half of a RAW decode (image_io.HostDecoded's contract):
    metadata and the final true shape, knowable without developing, the
    superpixel instant preview (``instant`` u8 HWC and its linear planes
    ``instant_linear``, or None), and the device half as ``upload`` /
    ``upload_padded``."""

    __slots__ = ("exif", "shape", "raw", "instant", "instant_linear")

    def __init__(self, raw: RawImage, instant=None, instant_linear=None):
        self.raw = raw
        self.instant = instant
        self.instant_linear = instant_linear
        self.exif = dict(raw.exif)
        h, w = raw.mosaic.shape[:2]
        if raw.default_crop is not None:
            h, w = raw.default_crop[3], raw.default_crop[2]
        if raw.orientation in (5, 6, 7, 8):
            h, w = w, h
        self.shape = (h, w)

    def upload(self, device) -> torch.Tensor:
        return develop_raw_image(self.raw, device=device)[0]

    def upload_padded(self, device, bucket: int) -> torch.Tensor:
        """Planes on the ``bucket`` grid of ``shape``: the bucket-stable
        develop where the file allows it, else the exact-extent develop
        edge-padded on the device."""
        from ..engine.editor import SHAPE_BUCKET, bucket_shape

        if bucket == SHAPE_BUCKET and bucket_stable_eligible(self.raw):
            return develop_raw_image_padded(self.raw, device=device)
        planes = self.upload(device)
        hb, wb = bucket_shape(*self.shape, bucket=bucket)
        return replicate_true_edges(
            torch.nn.functional.pad(planes, (0, wb - self.shape[1], 0,
                                             hb - self.shape[0])),
            *self.shape)


def decode_raw_host(data: bytes,
                    instant_long_edge: int | None = None) -> RawHostDecoded:
    """Host phase of a RAW decode: the container parse (every file-content
    error surfaces here) and, with ``instant_long_edge``, the superpixel
    instant preview (``engine/instant``); the develop runs at upload."""
    raw = parse_raw(data)
    pv = lin = None
    if instant_long_edge:
        from ..engine import instant

        with span("open.instant"):
            lin = instant.quick_linear_from_raw(raw, instant_long_edge)
            if lin is not None:
                pv = instant._to_u8_hwc(lin)
    return RawHostDecoded(raw, instant=pv, instant_linear=lin)


def synthetic_raw(
    planes_linear: np.ndarray,
    pattern: str = "RGGB",
    black_level: int = 512,
    white_level: int = 16383,
    wb_gains=(2.0, 1.0, 1.5),
    xyz_to_cam: np.ndarray | None = None,
) -> RawImage:
    """Mosaic a linear RGB image into a synthetic RawImage (tests, smoke):
    divide by the WB gains, optionally push through the inverse develop
    matrix, sample the CFA, quantize into [black, white]."""
    rgb = np.asarray(planes_linear, dtype=np.float32)
    assert rgb.ndim == 3 and rgb.shape[0] == 3
    _, h, w = rgb.shape
    if xyz_to_cam is not None:
        srgb2cam = np.linalg.inv(dm.cam_matrix_to_srgb(xyz_to_cam))
        rgb = np.einsum("ij,jhw->ihw", srgb2cam.astype(np.float32), rgb)
    inv_gains = 1.0 / np.asarray(wb_gains, dtype=np.float32)
    rgb = rgb * inv_gains[:, None, None]

    tile = np.asarray(dm.NAMED_CFA[pattern], dtype=np.int64)
    ph, pw = tile.shape
    yy, xx = np.mgrid[0:h, 0:w]
    chan = tile[yy % ph, xx % pw]
    mosaic01 = np.take_along_axis(
        rgb.reshape(3, -1), chan.reshape(1, -1), axis=0).reshape(h, w)
    span = white_level - black_level
    mosaic = np.clip(np.round(mosaic01 * span + black_level), 0,
                     white_level).astype(np.uint16)
    return RawImage(
        mosaic=mosaic,
        pattern=pattern,
        black_level=float(black_level),
        white_level=float(white_level),
        wb_gains=tuple(float(g) for g in wb_gains),
        xyz_to_cam=xyz_to_cam,
        exif={"Make": "Synthetic", "Model": "rawphotoforge-tpu"},
    )


def raw_image_from_numpy(fields: dict) -> RawImage:
    """The port's RawImage from the JAX package's RawImage fields (numpy
    and Python values already; ``dataclasses.asdict`` of one), so tests
    feed both packages the same decoded file."""
    names = {f.name for f in dataclasses.fields(RawImage)}
    return RawImage(**{k: v for k, v in fields.items() if k in names})
