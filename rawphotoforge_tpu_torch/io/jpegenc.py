"""JPEG export on the dense wire: YCbCr 4:2:0 on the render's device, one
u8 fetch (1.5 B/px), and the native baseline encoder on the host.

The JAX package's ``io/jpegenc.py`` for its dense path (``_ycc420_f32``,
the u8 rounding of ``_to_ycc420_jit``, ``_to_ycc420_np``, the dense branch
of ``encode_jpeg``, ``_splice_app1``). Its sparse-coefficient and
device-entropy wires (``io/jpegbits``) are not ported yet: an explicit
``sparse=True`` raises ``NotPortedError``. Output is baseline JFIF (SOF0,
4:2:0, Annex K tables) from ``native/rpf_native.cpp``.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from .._errbase import NotPortedError

# BT.601 full-range RGB -> YCbCr (the JFIF convention).
_YCC = np.array([
    [0.299, 0.587, 0.114],
    [-0.168736, -0.331264, 0.5],
    [0.5, -0.418688, -0.081312],
], dtype=np.float32)


def _ycc420_f32(planes: torch.Tensor):
    """JFIF colour convert + 4:2:0 subsample on the planes' device, f32 in
    [0, 255]: (y [H, W], cb, cr [ceil(H/2), ceil(W/2)])."""
    rgb = torch.clamp(planes, 0.0, 1.0) * 255.0
    r, g, b = rgb[0], rgb[1], rgb[2]
    m = [[float(v) for v in row] for row in _YCC]
    y = m[0][0] * r + m[0][1] * g + m[0][2] * b
    cb = 128.0 + m[1][0] * r + m[1][1] * g + m[1][2] * b
    cr = 128.0 + m[2][0] * r + m[2][1] * g + m[2][2] * b
    h, w = y.shape

    def sub2(x):
        # Edge-replicate to even dims, then the 2x2 mean.
        rows = torch.clamp(torch.arange(h + h % 2, device=x.device), max=h - 1)
        cols = torch.clamp(torch.arange(w + w % 2, device=x.device), max=w - 1)
        x = x[rows][:, cols]
        return x.reshape(x.shape[0] // 2, 2, x.shape[1] // 2, 2).mean(dim=(1, 3))

    return y, sub2(cb), sub2(cr)


def to_ycc420_u8(planes: torch.Tensor):
    """sRGB f32 [3, H, W] -> (y, cb, cr) u8 on the host: converted and
    rounded (half to even, clipped) on the planes' device, so the fetch
    carries 1.5 B/px."""
    from ..utils.transfer import fetch_np

    def u8(x):
        return torch.clamp(torch.round(x), 0.0, 255.0).to(torch.uint8)

    return tuple(fetch_np(u8(x)) for x in _ycc420_f32(planes))


def _to_ycc420_np(planes: np.ndarray):
    """Host numpy twin of ``to_ycc420_u8`` (the JAX package's host path)."""
    rgb = np.clip(np.asarray(planes, dtype=np.float32), 0.0, 1.0) * 255.0
    ycc = np.einsum("ij,jhw->ihw", _YCC, rgb)
    y, cb, cr = ycc[0], 128.0 + ycc[1], 128.0 + ycc[2]
    h, w = y.shape
    cbp = np.pad(cb, ((0, h % 2), (0, w % 2)), mode="edge")
    crp = np.pad(cr, ((0, h % 2), (0, w % 2)), mode="edge")
    ph, pw = cbp.shape
    cb2 = cbp.reshape(ph // 2, 2, pw // 2, 2).mean(axis=(1, 3))
    cr2 = crp.reshape(ph // 2, 2, pw // 2, 2).mean(axis=(1, 3))

    def u8(x):
        return np.clip(np.round(x), 0.0, 255.0).astype(np.uint8)

    return u8(y), u8(cb2), u8(cr2)


def _splice_app1(jpeg: bytes, exif_bytes: bytes) -> bytes:
    """Insert an EXIF APP1 segment right after SOI (ITU-T.81 B.2.4.4 /
    JEITA CP-3451: the EXIF APP1 precedes other marker segments)."""
    if not jpeg.startswith(b"\xff\xd8"):
        return jpeg
    from .image_io import normalize_exif_blob

    # Pixels are already upright: reset a stored Orientation to 1.
    payload = normalize_exif_blob(exif_bytes)
    if not payload.startswith(b"Exif\x00\x00"):
        payload = b"Exif\x00\x00" + payload
    if len(payload) + 2 > 0xFFFF:  # segment length field is 16-bit
        return jpeg
    seg = b"\xff\xe1" + struct.pack(">H", len(payload) + 2) + payload
    return jpeg[:2] + seg + jpeg[2:]


def encode_jpeg(planes, quality: int = 92, exif_bytes: bytes | None = None,
                sparse: bool | None = None) -> bytes:
    """sRGB-encoded f32 [3, H, W] in [0, 1] (a tensor on any device, or a
    numpy array) -> baseline JFIF bytes through the dense wire. An
    ``exif_bytes`` payload is spliced in as the APP1 segment."""
    from .. import native

    if sparse:
        raise NotPortedError("the sparse JPEG export wires",
                             "io/jpegbits packed/prepacked/nibble wires")
    if isinstance(planes, torch.Tensor):
        y, cb, cr = to_ycc420_u8(planes)
    else:
        y, cb, cr = _to_ycc420_np(planes)
    body = native.jpeg_encode_ycc420(y, cb, cr, quality=quality)
    if exif_bytes:
        body = _splice_app1(body, exif_bytes)
    return body
