"""Host-side instant previews in pure numpy — the JAX package's
``engine/instant.py``, as the port's own copy.

An *approximate* render of a RAW or display image, milliseconds on the
host with no device work: the decode gate of ``io/raw.parse_raw``
correlates ``quick_linear_from_raw`` against the file's embedded camera
preview (``linear_from_srgb_u8``), and the editor surfaces that show an
instant preview while the device render runs are still to port
(ROADMAP.md). It is a stand-in, never the product.

Approximation contract (vs the device develop, ops/demosaic.develop_raw):

* demosaic is per-CFA-tile block means (one RGB superpixel per 2x2 Bayer /
  6x6 X-Trans tile, ``native.cfa_block_means`` for u16 mosaics) instead of
  Malvar / directional NC — soft, not wrong;
* the same normalize -> WB -> camera-matrix -> sRGB math, in f32;
* DNG WarpRectilinear and lens profiles are skipped (sub-preview-pixel at
  these scales); DefaultCrop and EXIF orientation are applied.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..native import NativeBuildError

# sRGB OETF constants — the contract of core.color.linear_to_srgb
# (wgpu_shader.wgsl:95-103).
_SRGB_THRESH = 0.0031308


def linear_to_srgb_np(c: np.ndarray) -> np.ndarray:
    c = np.asarray(c, dtype=np.float32)
    return np.where(
        c <= _SRGB_THRESH,
        c * np.float32(12.92),
        np.float32(1.055) * np.power(np.maximum(c, 0.0), np.float32(1 / 2.4))
        - np.float32(0.055),
    )


def resize_bilinear_np(planes: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """Numpy mirror of ops.geometry.resize_bilinear (half-texel centers,
    edge-clamped +1 neighbor) over [C, H, W] float32 planes."""
    p = np.asarray(planes, dtype=np.float32)
    c, h, w = p.shape
    sy = (np.arange(dh, dtype=np.float32) + 0.5) * np.float32(h / dh) - 0.5
    sx = (np.arange(dw, dtype=np.float32) + 0.5) * np.float32(w / dw) - 0.5
    y0 = np.maximum(np.floor(sy), 0.0).astype(np.int32)
    x0 = np.maximum(np.floor(sx), 0.0).astype(np.int32)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    ty = (sy - y0.astype(np.float32))[None, :, None]
    tx = (sx - x0.astype(np.float32))[None, None, :]
    rows0 = p[:, y0, :]
    rows1 = p[:, y1, :]
    c00 = rows0[:, :, x0]
    c10 = rows0[:, :, x1]
    c01 = rows1[:, :, x0]
    c11 = rows1[:, :, x1]
    cx0 = c00 * (1.0 - tx) + c10 * tx
    cx1 = c01 * (1.0 - tx) + c11 * tx
    return cx0 * (1.0 - ty) + cx1 * ty


def _orient_np(planes: np.ndarray, orientation: int) -> np.ndarray:
    """Numpy mirror of ops.geometry.orient_exif over [C, H, W]."""
    o = orientation
    if o in (0, 1):
        return planes
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
    return planes  # invalid orientations already raised upstream


def _fit_long_edge(planes: np.ndarray, long_edge: int) -> np.ndarray:
    _, h, w = planes.shape
    if max(h, w) <= long_edge:
        return planes
    from ..ops.geometry import resize_long_edge_shape

    dh, dw = resize_long_edge_shape(h, w, long_edge)
    return resize_bilinear_np(planes, dh, dw)


def _to_u8_hwc(linear_planes: np.ndarray) -> np.ndarray:
    srgb = linear_to_srgb_np(np.clip(linear_planes, 0.0, 1.0))
    u8 = np.clip(srgb * 255.0, 0.0, 255.0).astype(np.uint8)
    return np.ascontiguousarray(u8.transpose(1, 2, 0))


def quick_from_linear_rgb(
    planes: np.ndarray, long_edge: int, orientation: int = 1
) -> np.ndarray:
    """Linear [3, H, W] f32 -> instant sRGB u8 HWC at <= long_edge."""
    return _to_u8_hwc(
        quick_linear_from_linear_rgb(planes, long_edge, orientation))


def quick_linear_from_linear_rgb(
    planes: np.ndarray, long_edge: int, orientation: int = 1
) -> np.ndarray:
    """Linear [3, H, W] f32 -> small linear planes (the era-render source
    for engine.hostdev live edits)."""
    p = _orient_np(np.asarray(planes, dtype=np.float32), orientation)
    return _fit_long_edge(p, long_edge)


def linear_from_srgb_u8(hwc_u8: np.ndarray) -> np.ndarray:
    """Instant sRGB u8 HWC -> linear [3, h, w] f32 — the inverse of the
    encode half of _to_u8_hwc (EOTF mirror of core.color.srgb_to_linear).
    Used to recover era-render source planes from an already-encoded
    instant preview."""
    c = hwc_u8.astype(np.float32).transpose(2, 0, 1) / np.float32(255.0)
    return np.where(
        c <= np.float32(0.04045),
        c / np.float32(12.92),
        np.power((c + np.float32(0.055)) / np.float32(1.055),
                 np.float32(2.4)),
    ).astype(np.float32)


def quick_from_srgb_u8(
    hwc: np.ndarray, long_edge: int, orientation: int = 1
) -> np.ndarray:
    """Already-sRGB u8 HWC (a decoded JPEG/PNG) -> instant preview.

    Resizes in encoded space — the instant path deliberately skips the
    decode->linear->resize->encode round trip (a sub-quantization
    difference at preview scales, and this is a stand-in image)."""
    arr = np.asarray(hwc)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    planes = arr.astype(np.float32).transpose(2, 0, 1) / np.float32(255.0)
    p = _orient_np(planes, orientation)
    p = _fit_long_edge(p, long_edge)
    u8 = np.clip(p * 255.0 + 0.5, 0.0, 255.0).astype(np.uint8)
    return np.ascontiguousarray(u8.transpose(1, 2, 0))


def quick_from_raw(raw, long_edge: int) -> Optional[np.ndarray]:
    """RawImage -> instant sRGB u8 HWC preview, pure numpy.

    Superpixel develop: per-CFA-tile channel means stand in for the
    demosaic; the WB/matrix/encode math matches io.raw.develop_raw_image.
    Returns None for exotic layouts (never raises — instant previews are
    strictly best-effort)."""
    lin = quick_linear_from_raw(raw, long_edge)
    return None if lin is None else _to_u8_hwc(lin)


def quick_linear_from_raw(raw, long_edge: int) -> Optional[np.ndarray]:
    """RawImage -> small LINEAR planes [3, h, w] f32 (pre-encode half of
    quick_from_raw; the develop side of the decode gate). Returns None for
    exotic layouts; a native library that cannot be built raises."""
    try:
        from ..ops.demosaic import NAMED_CFA, cam_matrix_to_srgb

        mosaic = np.asarray(raw.mosaic)
        black = np.float32(raw.black_level)
        span = np.float32(max(raw.white_level - raw.black_level, 1e-9))

        if raw.pattern == "RGB":
            if mosaic.ndim != 3 or mosaic.shape[-1] != 3:
                return None
            rgb = np.clip(
                (mosaic.astype(np.float32) - black) / span, 0.0, 1.0
            ).transpose(2, 0, 1)
        else:
            tile = NAMED_CFA.get(raw.pattern)
            if tile is None or mosaic.ndim != 2:
                return None  # unknown layout: no instant (best-effort)
            tile = np.asarray(tile)
            ph, pw = tile.shape
            th, tw = mosaic.shape[0] // ph, mosaic.shape[1] // pw
            if th < 8 or tw < 8:
                return None
            if max(th, tw) > long_edge:
                # Decimate to the TARGET grid first: gather only the CFA
                # tiles the preview will show (center-sampled, the
                # nearest-tile analog of the half-texel resize) instead
                # of block-meaning all ~6M superpixels and bilinearly
                # resizing them down — ~5x less touched data at 24MP
                # Bayer, and the later _fit_long_edge is a no-op. A
                # stand-in trades that aliasing for latency by design.
                from ..ops.geometry import resize_long_edge_shape

                dh, dw = resize_long_edge_shape(th, tw, long_edge)
                yi = np.minimum(
                    ((np.arange(dh) + 0.5) * (th / dh)).astype(np.int64),
                    th - 1)
                xi = np.minimum(
                    ((np.arange(dw) + 0.5) * (tw / dw)).astype(np.int64),
                    tw - 1)
                rows = (yi[:, None] * ph
                        + np.arange(ph)[None, :]).reshape(-1)
                cols = (xi[:, None] * pw
                        + np.arange(pw)[None, :]).reshape(-1)
                t = mosaic[np.ix_(rows, cols)]
                eh, ew = dh, dw
            else:
                t = mosaic[: th * ph, : tw * pw]
                eh, ew = th, tw
            # Per-channel block means: the C++ hot loop visits every u16
            # sample once (native/rpf_native.cpp rpf_cfa_block_means; a
            # native library that cannot be built raises, never a silent
            # stand-in). Float (HDR) mosaics accumulate (ph*pw) strided
            # views in numpy, in the same f32 summation order (site
            # dy-major). Normalization is applied to the MEANS (linear;
            # the clip commutes for in-range data — stand-in contract).
            if t.dtype == np.uint16:
                from .. import native

                rgb = native.cfa_block_means(
                    t, ph, pw, tile.reshape(-1), float(black), float(span))
            else:
                sums = np.zeros((3, eh, ew), dtype=np.float32)
                counts = np.zeros(3, dtype=np.float32)
                for dy in range(ph):
                    for dx in range(pw):
                        ch = int(tile[dy, dx])
                        sums[ch] += t[dy::ph, dx::pw]
                        counts[ch] += 1.0
                rgb = np.clip(
                    (sums / counts[:, None, None] - black) / span, 0.0, 1.0)

        gains = np.asarray(raw.wb_gains, dtype=np.float32)
        if not raw.wb_known and tuple(raw.wb_gains) == (1.0, 1.0, 1.0):
            from ..io.raw import estimate_gray_world_gains

            gains = np.asarray(
                estimate_gray_world_gains(
                    raw.mosaic, raw.pattern, raw.black_level, raw.white_level
                ),
                dtype=np.float32,
            )
        rgb = rgb * gains[:, None, None]
        if raw.xyz_to_cam is not None:
            m = cam_matrix_to_srgb(raw.xyz_to_cam).astype(np.float32)
            rgb = np.einsum("ij,jhw->ihw", m, rgb)

        if raw.default_crop is not None:
            # Scale the FULL-resolution crop to superpixel coordinates.
            cx, cy, cw, chh = raw.default_crop
            sy = rgb.shape[1] / max(mosaic.shape[0], 1)
            sx = rgb.shape[2] / max(mosaic.shape[1], 1)
            y0, y1 = int(cy * sy), max(int(cy * sy) + 1, int((cy + chh) * sy))
            x0, x1 = int(cx * sx), max(int(cx * sx) + 1, int((cx + cw) * sx))
            rgb = rgb[:, y0:y1, x0:x1]
        rgb = _orient_np(rgb, raw.orientation)
        return np.ascontiguousarray(
            _fit_long_edge(rgb, long_edge).astype(np.float32))
    except NativeBuildError:
        raise
    except Exception:  # noqa: BLE001 — best-effort by contract
        return None


def encode_instant_jpeg(hwc_u8: np.ndarray, quality: int = 90) -> bytes:
    """Host JPEG encode of an instant preview (PIL; no device involved)."""
    import io as _io

    from PIL import Image

    buf = _io.BytesIO()
    Image.fromarray(hwc_u8, mode="RGB").save(buf, "JPEG", quality=quality)
    return buf.getvalue()


def instant_histogram(hwc_u8: np.ndarray) -> np.ndarray:
    """[4, 256] R/G/B/luma histogram of an instant preview (u8 domain) —
    the stand-in for ops.stats.histogram_rgbl while the device program
    compiles. The gray row uses the SAME BT.601 weights (0.299/0.587/
    0.114, truncating bin index) as the device reduction and the
    reference's cv2 RGB2GRAY source — Rec.709 weights here would make
    the luma histogram visibly jump the moment the device render swaps
    in (e.g. saturated red: bin ~76 vs ~54)."""
    out = np.zeros((4, 256), dtype=np.int64)
    for ch in range(3):
        out[ch] = np.bincount(hwc_u8[:, :, ch].reshape(-1), minlength=256)
    luma = (
        0.299 * hwc_u8[:, :, 0]
        + 0.587 * hwc_u8[:, :, 1]
        + 0.114 * hwc_u8[:, :, 2]
    )
    out[3] = np.bincount(
        np.clip(luma, 0, 255).astype(np.uint8).reshape(-1),
        minlength=256,
    )
    return out
