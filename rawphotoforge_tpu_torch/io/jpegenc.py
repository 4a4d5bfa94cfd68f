"""JPEG export: the lossy half of baseline JPEG on the render's device, the
entropy coding on the device too, and a native assembler on the host.

The JAX package's ``io/jpegenc.py``: the shared coefficient model of its
device wires (JFIF colour conversion, 4:2:0 chroma, the 8x8 fDCT,
libjpeg-convention quantization, zigzag, DC deltas; ``blockify``,
``dc_delta`` and ``clamp_fill``, the torch twins of ``_block_stages``), the
nibble wire (``_sparsify``, ``_encode_sparse_device`` with native
``rpf_jpeg_encode_sparse``), the numpy oracles, and ``encode_jpeg``. A
tensor goes through the device wires in the JAX package's order — packed,
prepacked (``io/jpegbits``), nibble — and to the dense wire (YCbCr 4:2:0
u8, 1.5 B/px, native ``rpf_jpeg_encode_ycc420``) only when every device
wire refused its data; a numpy array takes the dense host path. On a CUDA
tensor the coefficients come from the hand-written ``jpeg_blocks_kernel``
(``kernels/jpeg_wire``), on a CPU tensor from ``blockify`` here; the two
are bit-identical. All wires give byte-identical baseline JFIF (SOF0,
4:2:0, Annex K tables) for the same coefficients.

The JAX package pads device inputs to a 128-pixel bucket so that its
programs compile once per bucket; CUDA has no per-shape compile, so the
port encodes the true extent directly (``true_shape`` still accepts a
padded render, as the editor's bucket renders are).
"""

from __future__ import annotations

import functools
import struct
import sys
import traceback

import numpy as np
import torch

from .._errbase import JpegWireDataError

# BT.601 full-range RGB -> YCbCr (the JFIF convention).
_YCC = np.array([
    [0.299, 0.587, 0.114],
    [-0.168736, -0.331264, 0.5],
    [0.5, -0.418688, -0.081312],
], dtype=np.float32)

# From this pixel count encode_image sends a JPEG export of a tensor to
# encode_jpeg's device wires; smaller frames (previews) keep the u8 RGB
# fetch and Pillow.
SPARSE_MIN_PIXELS = 4 << 20

# Annex K.1/K.2 base quantization tables in natural (row-major) order — the
# same constants as native/rpf_native.cpp kQLum/kQChr.
_QLUM = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99,
], dtype=np.int64)
_QCHR = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
], dtype=np.int64)

# Zigzag position -> natural index (T.81 Figure 5 sequence).
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], dtype=np.int32)


def _dct8(dtype):
    """D[u, x] = C(u)/2 * cos((2x+1) u pi / 16) — the direct T.81 fDCT
    matrix (native block_coeffs uses the identical constants)."""
    u = np.arange(8)[:, None].astype(np.float64)
    x = np.arange(8)[None, :].astype(np.float64)
    cu = np.where(u == 0, 1.0 / np.sqrt(2.0), 1.0)
    return (0.5 * cu * np.cos((2 * x + 1) * u * np.pi / 16.0)).astype(dtype)


@functools.lru_cache(maxsize=8)
def _quant_tables(quality: int):
    """libjpeg-convention quality scaling of the Annex K tables, natural
    order (mirror of native scale_qtbl — integer arithmetic)."""
    quality = max(1, min(100, int(quality)))
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality

    def t(base):
        return np.clip((base * scale + 50) // 100, 1, 255).astype(np.int32)

    return t(_QLUM), t(_QCHR)


def _i32_bits(t: torch.Tensor) -> torch.Tensor:
    """u32 values held in an int64 tensor -> int32 with the same 32 bits
    (what the kernels write; numpy reads them back as ``uint32``)."""
    return (t - ((t >> 31) << 32)).to(torch.int32)


# -- the coefficient model (torch twins of the JAX package's _block_stages) --

def _ycc_f32(planes: torch.Tensor):
    """JFIF colour conversion per pixel, f32 in [0, 255], in the JAX
    package's operation order (``_ycc420_f32``): (y, cb, cr) [H, W]."""
    rgb = torch.clamp(planes, 0.0, 1.0) * 255.0
    r, g, b = rgb[0], rgb[1], rgb[2]
    m = [[float(v) for v in row] for row in _YCC]
    y = m[0][0] * r + m[0][1] * g + m[0][2] * b
    cb = 128.0 + m[1][0] * r + m[1][1] * g + m[1][2] * b
    cr = 128.0 + m[2][0] * r + m[2][1] * g + m[2][2] * b
    return y, cb, cr


def _clamped_index(n: int, last: int, device):
    """min(k, last) for k < n: the indices of an edge-replicating gather."""
    return torch.clamp(torch.arange(n, device=device), max=last)


def clamp_fill(img: torch.Tensor, th: int, tw: int, shape=None) -> torch.Tensor:
    """Rows and columns at or beyond (th, tw) replaced by the last true row
    and column (gathers). ``shape`` (default: the image's own) may extend
    the grid past the image: the MCU edge pad."""
    h, w = img.shape[-2:] if shape is None else shape
    rows = _clamped_index(h, th - 1, img.device)
    cols = _clamped_index(w, tw - 1, img.device)
    return img[..., rows, :][..., cols]


def _chroma(p: torch.Tensor, cy, cx, th: int, tw: int) -> torch.Tensor:
    """The 4:2:0 chroma sample at chroma rows ``cy`` and columns ``cx``:
    the mean of its 2x2 luma-grid sources (each clamped to the true extent:
    the edge replicate to even dims) as one fixed sum times 0.25."""
    def at(a, b):
        rows = torch.clamp(2 * cy + a, max=th - 1)
        cols = torch.clamp(2 * cx + b, max=tw - 1)
        return p[rows][:, cols]

    return (((at(0, 0) + at(0, 1)) + at(1, 0)) + at(1, 1)) * 0.25


def _ycc420_f32(planes: torch.Tensor):
    """JFIF colour convert + 4:2:0 subsample on the planes' device, f32 in
    [0, 255]: (y [H, W], cb, cr [ceil(H/2), ceil(W/2)]) — the dense wire's
    planes, with blockify's arithmetic."""
    y, cb, cr = _ycc_f32(planes)
    h, w = y.shape
    cy = torch.arange((h + 1) // 2, device=y.device)
    cx = torch.arange((w + 1) // 2, device=y.device)
    return y, _chroma(cb, cy, cx, h, w), _chroma(cr, cy, cx, h, w)


def _u8_grid(v: torch.Tensor) -> torch.Tensor:
    """Round to the u8 grid (half to even, clipped), staying f32."""
    return torch.clamp(torch.round(v), 0.0, 255.0)


def blockify(planes: torch.Tensor, qlum, qchr, true_hw=None) -> torch.Tensor:
    """sRGB f32 [3, H, W] -> quantized zigzag blocks int16 [N, 64], N = 6
    ceil(H/16) ceil(W/16), in MCU scan order (Y tl, tr, bl, br, Cb, Cr): the
    plain twin of ``jpeg_blocks_kernel``, on any device.

    ``true_hw`` (th, tw): the true extent of a padded render; every sample
    at or beyond it is an edge replica of the true image — at luma level
    before the 4:2:0 subsample and at chroma level after it, so boundary
    blocks equal those of a direct encode of the true extent whatever the
    padding holds. Per sample, in the kernel's order: the JFIF conversion,
    the 2x2 chroma sum times 0.25, rounding to the u8 grid (half to even),
    the level shift, the fDCT as rows then columns of sequential 8-term
    sums, the division by q and rounding half away from zero."""
    _, h, w = planes.shape
    th, tw = (h, w) if true_hw is None else (int(true_hw[0]), int(true_hw[1]))
    if not (0 < th <= h and 0 < tw <= w):
        raise ValueError(f"true extent {th}x{tw} outside planes {h}x{w}")
    dev = planes.device
    mh, mw = -(-h // 16), -(-w // 16)
    y, cb, cr = _ycc_f32(planes.to(torch.float32))
    ylum = _u8_grid(clamp_fill(y, th, tw, (mh * 16, mw * 16))) - 128.0
    cy = _clamped_index(mh * 8, (th + 1) // 2 - 1, dev)
    cx = _clamped_index(mw * 8, (tw + 1) // 2 - 1, dev)
    cbs = _u8_grid(_chroma(cb, cy, cx, th, tw)) - 128.0
    crs = _u8_grid(_chroma(cr, cy, cx, th, tw)) - 128.0
    yb = (ylum.reshape(mh, 2, 8, mw, 2, 8).permute(0, 3, 1, 4, 2, 5)
          .reshape(mh * mw, 4, 8, 8))

    def chroma_blocks(c):
        return c.reshape(mh, 8, mw, 8).permute(0, 2, 1, 3).reshape(mh * mw, 1, 8, 8)

    x = torch.cat([yb, chroma_blocks(cbs), chroma_blocks(crs)], 1).reshape(-1, 8, 8)
    d = torch.from_numpy(_dct8(np.float32)).to(dev)
    # Rows: t[n, y, u] = sum_x D[u, x] x[n, y, x]; then columns:
    # o[n, v, u] = sum_y D[v, y] t[n, y, u]; each a sequential 8-term sum.
    t = d[:, 0] * x[:, :, 0:1]
    for k in range(1, 8):
        t = t + d[:, k] * x[:, :, k:k + 1]
    o = d[:, 0:1] * t[:, 0:1, :]
    for k in range(1, 8):
        o = o + d[:, k:k + 1] * t[:, k:k + 1, :]
    q = torch.from_numpy(np.stack([np.asarray(qlum)] * 4 + [np.asarray(qchr)] * 2)
                         .astype(np.float32)).to(dev)
    rq = o.reshape(mh * mw, 6, 64) / q          # IEEE division, tensor by tensor
    qi = torch.copysign(torch.floor(torch.abs(rq) + 0.5), rq)
    zig = torch.from_numpy(_ZIGZAG.astype(np.int64)).to(dev)
    return qi[:, :, zig].reshape(mh * mw * 6, 64).to(torch.int16)


def dc_delta(blocks: torch.Tensor) -> torch.Tensor:
    """Each DC as the delta against the previous same-component block in
    MCU scan order over the whole grid (the nibble wire's chain)."""
    m = blocks.shape[0] // 6
    b3 = blocks.reshape(m, 6, 64).clone()
    dc = b3[:, :, 0].to(torch.int32)

    def delta(seq):
        return seq - torch.cat([seq.new_zeros(1), seq[:-1]])

    dy = delta(dc[:, :4].reshape(-1)).reshape(m, 4)
    b3[:, :, 0] = torch.cat([dy, delta(dc[:, 4])[:, None],
                             delta(dc[:, 5])[:, None]], 1).to(blocks.dtype)
    return b3.reshape(m * 6, 64)


# -- the nibble wire ----------------------------------------------------------

def _sparsify(blocks: torch.Tensor):
    """The nibble wire's compaction, as torch ops on the blocks' device:
    (counts u8 [N], bitmaps int64 [N, 2] (u32 presence bits over zigzag
    positions, low word first), packed nibbles u8 [(n+1)//2], escapes i16
    [n_escapes], n_values, n_escapes). Boolean indexing takes the nonzero
    values in row-major order, which is the wire order: block by block,
    ascending zigzag. Values in [-7, 7] ride the 4-bit two's-complement
    stream (low nibble first); the code 0x8 escapes a value to the i16
    stream; an odd count leaves the last byte's high nibble zero."""
    nz = blocks != 0
    counts = nz.sum(1).to(torch.uint8)
    weight = torch.ones(32, dtype=torch.int64, device=blocks.device) << torch.arange(
        32, device=blocks.device)
    nz64 = nz.to(torch.int64)
    bitmaps = torch.stack([(nz64[:, :32] * weight).sum(1),
                           (nz64[:, 32:] * weight).sum(1)], 1)
    vals = blocks[nz].to(torch.int16)
    esc = (vals > 7) | (vals < -7)
    nib = torch.where(esc, torch.full_like(vals, 8), vals & 15).to(torch.uint8)
    if nib.numel() % 2:
        nib = torch.cat([nib, nib.new_zeros(1)])
    packed = nib[0::2] | (nib[1::2] << 4)
    escapes = vals[esc]
    return counts, bitmaps, packed, escapes, int(vals.numel()), int(escapes.numel())


def wire_extent(planes, true_shape):
    """(h, w, grid, padded) of an encode: the true extent, the MCU grid the
    coefficients cover, and whether ``planes`` is a padded render (then
    MCU-aligned, as the JAX package requires)."""
    _, ph, pw = planes.shape
    if true_shape is None:
        return ph, pw, (-(-ph // 16), -(-pw // 16)), False
    h, w = int(true_shape[0]), int(true_shape[1])
    if ph % 16 or pw % 16:
        raise ValueError(f"padded planes must be MCU-aligned (multiples of "
                         f"16), got {ph}x{pw}")
    if h > ph or w > pw:
        raise ValueError(f"true_shape {h}x{w} exceeds planes {ph}x{pw}")
    return h, w, (ph // 16, pw // 16), (h, w) != (ph, pw)


def _encode_sparse_device(planes, quality: int, stage=None,
                          true_shape=None) -> bytes:
    """The nibble wire: coefficients on the planes' device, the nonzero
    ones compacted there (~0.5 B each, plus 8 B/block of presence bitmaps
    over the link), then the native entropy coder. With ``true_shape`` the
    value stream is fetched only up to the last true block, and the coder
    walks the padded grid while emitting only true blocks."""
    from .. import native
    from ..kernels import jpeg_wire
    from ..utils.transfer import fetch_np

    stage = stage or (lambda _name: None)
    h, w, grid, padded = wire_extent(planes, true_shape)
    qlum, qchr = _quant_tables(quality)
    blocks = jpeg_wire.blocks(planes, qlum, qchr, (h, w))
    _, bitmaps, vals, esc, n, _ = _sparsify(dc_delta(blocks))
    stage("fetch")
    host_bitmaps = fetch_np(_i32_bits(bitmaps)).view(np.uint32)
    # The counts never cross the link: the host popcounts the bitmaps.
    host_counts = _popcount_rows(host_bitmaps)
    if padded:
        # The value prefix ends at the last true block.
        mcu_r, mcu_c = -(-h // 16), -(-w // 16)
        last = ((mcu_r - 1) * grid[1] + (mcu_c - 1)) * 6 + 5
        n = int(host_counts[: last + 1].astype(np.int64).sum())
    host_vals = fetch_np(vals[: (n + 1) // 2])
    host_esc = fetch_np(esc)
    stage("encode")
    return native.jpeg_encode_sparse(host_counts, host_bitmaps, host_vals,
                                     host_esc, h, w, quality=quality, grid=grid)


def available() -> bool:
    """Whether the native entropy coders load (``native.available``)."""
    from .. import native

    return native.available()


# -- numpy oracles --------------------------------------------------------------

def _to_ycc420_np(planes: np.ndarray):
    """Host numpy YCbCr 4:2:0 u8 (the JAX package's host path)."""
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


def _blocks_np(planes: np.ndarray, quality: int) -> np.ndarray:
    """Float64 oracle of the coefficient stage: [N, 64] i32 blocks in the
    same MCU scan order (the f32 stage tracks it within one step)."""
    y, cb, cr = _to_ycc420_np(planes)
    qlum, qchr = _quant_tables(quality)
    d = _dct8(np.float64)
    h, w = y.shape
    mh, mw = -(-h // 16), -(-w // 16)

    def blocks_of(plane, grid_h, grid_w, q):
        p = plane.astype(np.float64)
        p = np.pad(p, ((0, grid_h - p.shape[0]), (0, grid_w - p.shape[1])),
                   mode="edge") - 128.0
        nbh, nbw = grid_h // 8, grid_w // 8
        bl = p.reshape(nbh, 8, nbw, 8).transpose(0, 2, 1, 3)
        t = np.einsum("abyx,ux->abyu", bl, d)
        o = np.einsum("abyu,vy->abvu", t, d)
        rq = o.reshape(nbh, nbw, 64) / q.astype(np.float64)
        qi = (np.sign(rq) * np.floor(np.abs(rq) + 0.5)).astype(np.int32)
        return qi[:, :, _ZIGZAG]

    yb = blocks_of(y, mh * 16, mw * 16, qlum)
    yb = (yb.reshape(mh, 2, mw, 2, 64).transpose(0, 2, 1, 3, 4)
            .reshape(mh * mw, 4, 64))
    cbb = blocks_of(cb, mh * 8, mw * 8, qchr).reshape(mh * mw, 1, 64)
    crb = blocks_of(cr, mh * 8, mw * 8, qchr).reshape(mh * mw, 1, 64)
    return np.concatenate([yb, cbb, crb], axis=1).reshape(mh * mw * 6, 64)


def _dc_delta_np(blocks: np.ndarray) -> np.ndarray:
    """Exact integer mirror of ``dc_delta``."""
    blocks = np.asarray(blocks, dtype=np.int32).copy()
    m = blocks.shape[0] // 6
    b3 = blocks.reshape(m, 6, 64)
    dc = b3[:, :, 0].copy()

    def delta(seq):
        out = seq.copy()
        out[1:] -= seq[:-1]
        return out

    b3[:, :, 0] = np.concatenate(
        [delta(dc[:, :4].reshape(-1)).reshape(m, 4),
         delta(dc[:, 4])[:, None], delta(dc[:, 5])[:, None]], axis=1)
    return b3.reshape(m * 6, 64)


def _sparsify_np(blocks: np.ndarray):
    """Exact integer mirror of ``_sparsify``: (counts u8, bitmaps u32
    [N,2], packed-nibble values u8, escapes i16, n_values, n_escapes)."""
    blocks = np.asarray(blocks, dtype=np.int32)
    nz = blocks != 0
    counts = nz.sum(axis=1)
    w32 = (np.uint64(1) << np.arange(32, dtype=np.uint64))
    lo = (nz[:, :32] * w32).sum(axis=1).astype(np.uint32)
    hi = (nz[:, 32:] * w32).sum(axis=1).astype(np.uint32)
    vals16 = blocks[nz].astype(np.int16)
    esc = (vals16 > 7) | (vals16 < -7)
    nib = np.where(esc, 8, vals16 & 15).astype(np.uint8)
    if nib.size % 2:
        nib = np.concatenate([nib, np.zeros(1, np.uint8)])
    packed = (nib[0::2] | (nib[1::2] << 4)).astype(np.uint8)
    return (counts.astype(np.uint8), np.stack([lo, hi], axis=1),
            packed, vals16[esc], int(counts.sum()), int(esc.sum()))


# byte -> set-bit count, for deriving per-block counts from bitmaps on the
# host (the counts stream itself never crosses the link).
_POP8 = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None],
                      axis=1).sum(axis=1).astype(np.uint8)


def _popcount_rows(bitmaps: np.ndarray) -> np.ndarray:
    """Per-row popcount of [N, 2] u32 presence bitmaps -> u8 [N]."""
    b = np.ascontiguousarray(bitmaps, dtype=np.uint32)
    return _POP8[b.view(np.uint8).reshape(b.shape[0], 8)].sum(
        axis=1, dtype=np.uint8)


# -- the dense wire and the entry point -----------------------------------------

def to_ycc420_u8(planes: torch.Tensor):
    """sRGB f32 [3, H, W] -> (y, cb, cr) u8 on the host: converted and
    rounded (half to even, clipped) on the planes' device, so the fetch
    carries 1.5 B/px."""
    from ..utils.transfer import fetch_np

    return tuple(fetch_np(_u8_grid(x).to(torch.uint8)) for x in _ycc420_f32(planes))


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


# The device wires that have degraded once (each is logged the first time).
_wire_fallback_warned: set = set()


def encode_jpeg(planes, quality: int = 92, exif_bytes: bytes | None = None,
                sparse: bool | None = None, on_stage=None,
                true_shape=None) -> bytes:
    """sRGB-encoded f32 [3, H, W] in [0, 1] -> baseline JFIF bytes.

    A tensor (on the card, or on the CPU through the kernels' twins) takes
    the device wires: packed first (the card emits the finished scan; the
    link carries exactly the entropy-coded bits), then prepacked (per-block
    bit strings), then the nibble wire. A wire degrades to the next only
    on ``JpegWireDataError`` (its data broke the wire's conditions: a
    coefficient outside the baseline Huffman domain, or lengths that do not
    add up), logged once per wire; a failed build or launch raises. When
    every device wire refused its data, the dense wire (YCbCr 4:2:0 u8)
    encodes. ``sparse=False`` asks for the dense wire; ``sparse=True`` for
    a device wire, raising when none can serve. A numpy array takes the
    host path. ``true_shape``: the true (h, w) of a padded render (MCU-
    aligned planes). ``on_stage(name)`` is called entering 'fetch' and
    'encode'. An ``exif_bytes`` payload is spliced in as the APP1 segment.
    """
    from .. import native

    stage = on_stage or (lambda _name: None)
    tensor = isinstance(planes, torch.Tensor)
    if sparse and not tensor:
        # An explicit device-wire request that cannot be served fails
        # loudly instead of handing back dense-wire bytes.
        raise RuntimeError("sparse JPEG export requires a tensor (the device "
                           "wires); got a host array")
    body = None
    if tensor and sparse is not False:
        from . import jpegbits

        for enc, label in ((jpegbits.encode_packed_device, "packed"),
                           (jpegbits.encode_prepacked_device, "prepacked"),
                           (_encode_sparse_device, "nibble")):
            try:
                body = enc(planes, quality, stage, true_shape=true_shape)
                break
            except JpegWireDataError:
                if sparse and label == "nibble":
                    raise
                if label not in _wire_fallback_warned:
                    _wire_fallback_warned.add(label)
                    print(f"{label} JPEG export wire refused its data; "
                          "falling back:\n" + traceback.format_exc(limit=3),
                          file=sys.stderr)
    if body is None:
        if true_shape is not None:
            planes = planes[:, : int(true_shape[0]), : int(true_shape[1])]
        stage("fetch")
        y, cb, cr = to_ycc420_u8(planes) if tensor else _to_ycc420_np(planes)
        stage("encode")
        body = native.jpeg_encode_ycc420(y, cb, cr, quality=quality)
    if exif_bytes:
        body = _splice_app1(body, exif_bytes)
    return body
