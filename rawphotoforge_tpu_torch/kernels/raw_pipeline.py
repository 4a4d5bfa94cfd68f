"""The one-pass RAW develop kernel — CUDA C++ for Hopper — and its plain twin.

Replaces the JAX package's Pallas kernel ``kernels/raw_pipeline.py:
_raw_kernel`` (wrapper ``raw_develop_fused``): in one pass, a normalized
CFA mosaic -> per-site white balance -> demosaic (Malvar-He-Cutler for the
four Bayer patterns; the directional-green residual normalized convolution
for X-Trans) -> 3x3 camera matrix clipped to [0, 1] -> radius-2 unsharp
mask -> vignette -> the per-mask edit stack -> sRGB. The CUDA source is
``csrc/raw_develop.cu``; the per-pixel stack is ``csrc/edit_stack.cuh``,
shared with the develop kernel (``kernels/fused``).

Bound on the H100: bytes on paper — 4 B/px of mosaic in and 12 B/px of
sRGB out, 16 B/px: ~0.115 ms for 24 MP at 3.35 TB/s. As with the develop
kernel, the exact arithmetic (IEEE divisions and square roots, no
contraction) is what sets the time.

Design: both CFAs walk column strips in steps of rows, keeping the window
and plane rows the next step shares, one wave of resident blocks. Bayer: a
124-column strip (its 128 plane columns are one warp, 4 a lane), 16-row
steps, the strips' steps split evenly over the wave; the window loads as
16-byte vectors inside the image and at mirror indices over its border;
Malvar takes one branch per warp and element; the unsharp sums each plane
column's 5 rows once and shares them across lanes by a shuffle, in the
twin's order; 4 outputs a lane with float4 stores. X-Trans: a 48-column
strip + 12 px, 24-row steps that keep the window, green-estimate and plane
rows. There is no tile-multiple padding: the kernel reads mirror (Bayer)
or periodic (X-Trans) indices where the Pallas wrapper padded, and its CFA
phases are global, so outputs do not depend on any strip or step size:
unlike the JAX wrapper, the port takes no tile sizes.

``raw_develop_fused`` takes the twin for a CPU tensor and the kernel for a
CUDA tensor; there is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.params import DevelopParams
from ..ops import pointwise
from ..ops.demosaic import (BAYER_PATTERNS, XTRANS, _cfa_channel_map,
                            apply_wb_mosaic, malvar_from_padded, pad_reflect)
from ..ops.sharpen import _gauss_taps
from . import fused

HALO = 4          # 2 for the demosaic stencil + 2 for the sharpen radius
XT_HALO = 12      # two 6x6 CFA periods: the residual demosaic's 9 px + 2

# Triangle taps of the normalized convolutions (ops/demosaic._NC_KERNEL_1D).
_NC_TAPS = (1.0, 2.0, 3.0, 4.0, 3.0, 2.0, 1.0)

# Kernel launches since the counts were last set to 0, by __global__
# kernel (the twin never counts): lets a run show that the main path went
# through each kernel.
KERNEL_LAUNCHES = {"bayer_kernel": 0, "xtrans_kernel": 0}
# Build record of the loaded library (kernels/cuda_build.build), or None.
BUILD = None
_LIB = None


def _validate(mosaic01, params, pattern, masks):
    """The JAX wrapper's argument checks (raw_pipeline.py:384-412, same
    ValueErrors) but its tile checks, plus the shapes the kernel needs.
    Returns M."""
    if mosaic01.ndim != 2:
        raise ValueError(f"expected a mosaic [H, W], got {tuple(mosaic01.shape)}")
    h, w = mosaic01.shape
    if pattern != "XTRANS" and pattern not in BAYER_PATTERNS:
        raise ValueError(f"unknown CFA pattern {pattern!r}")
    if pattern == "XTRANS" and (h < XT_HALO or w < XT_HALO):
        # The phase-preserving border copies 12 rows/cols of the image.
        raise ValueError(f"an X-Trans mosaic needs at least "
                         f"{XT_HALO}x{XT_HALO} sites, got {h}x{w}")
    m = params.gains.shape[0]
    if m > 1:
        if masks is None:
            raise ValueError(f"params pack {m} masks; pass masks [M, H, W]")
        if tuple(masks.shape) != (m, h, w):
            raise ValueError(f"masks shape {tuple(masks.shape)} does not "
                             f"match {m} masks of a {h}x{w} mosaic")
    return m


def _f32(x, device) -> torch.Tensor:
    """A tensor, array or number as f32 on ``device`` (a host value copied
    without waiting for the work queued on the card)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(
        device, non_blocking=True)


# -- the plain twin -----------------------------------------------------------

def _conv7y(x, eh):
    """7-tap triangle filter down the rows: [(eh+6), W] -> [eh, W]."""
    return sum(t * x[i : i + eh, :] for i, t in enumerate(_NC_TAPS))


def _conv7x(x, ew):
    """7-tap triangle filter along the columns: [H, (ew+6)] -> [H, ew]."""
    return sum(t * x[:, i : i + ew] for i, t in enumerate(_NC_TAPS))


def _xtrans(m, th, tw):
    """The kernel's residual demosaic of the periodically padded X-Trans
    mosaic ``m`` [(th+24), (tw+24)] -> (r, g, b) [th+4, tw+4] (2 px of
    margin for the sharpen). The JAX kernel's ``_xtrans`` on one window
    covering the image: phase masks from the global (y mod 6, x mod 6), no
    2-D fallback of the 1-D green (every X-Trans row and column holds a
    green within any 7-window)."""
    eh0, ew0 = th + 4, tw + 4          # demosaic output extent (offset 10)
    eh1, ew1 = th + 10, tw + 10        # g_est extent (offset 7)
    ehs, ews = th + 16, tw + 16        # conv-input / mask extent (offset 4)

    # Mask-extent site 0 is global -8 (the window starts at -12).
    chan = _cfa_channel_map(ehs, ews, XTRANS, m.device, origin=(8, 8))
    mr = (chan == 0).to(torch.float32)
    mg = (chan == 1).to(torch.float32)
    mb = (chan == 2).to(torch.float32)
    mw = m[4 : 4 + ehs, 4 : 4 + ews]

    gx = torch.abs(m[4 : 4 + ehs, 5 : 5 + ews] - m[4 : 4 + ehs, 3 : 3 + ews])
    gy = torch.abs(m[5 : 5 + ehs, 4 : 4 + ews] - m[3 : 3 + ehs, 4 : 4 + ews])
    sgx = _conv7x(_conv7y(gx, eh1), ew1)
    sgy = _conv7x(_conv7y(gy, eh1), ew1)

    prod = mw * mg
    g_h = _conv7x(prod[3 : 3 + eh1, :], ew1) / torch.clamp(
        _conv7x(mg[3 : 3 + eh1, :], ew1), min=1e-8)
    g_v = _conv7y(prod[:, 3 : 3 + ew1], eh1) / torch.clamp(
        _conv7y(mg[:, 3 : 3 + ew1], eh1), min=1e-8)
    g_est = torch.where(sgx > sgy, g_v, g_h)

    m0 = m[10 : 10 + eh0, 10 : 10 + ew0]
    g = torch.where(mg[6 : 6 + eh0, 6 : 6 + ew0] > 0, m0,
                    g_est[3 : 3 + eh0, 3 : 3 + ew0])

    d = m[7 : 7 + eh1, 7 : 7 + ew1] - g_est

    def chroma(mask):
        mk = mask[3 : 3 + eh1, 3 : 3 + ew1]
        num = _conv7x(_conv7y(d * mk, eh0), ew0)
        den = _conv7x(_conv7y(mk, eh0), ew0)
        est = g + num / torch.clamp(den, min=1e-8)
        return torch.where(mask[6 : 6 + eh0, 6 : 6 + ew0] > 0, m0, est)

    return chroma(mr), g, chroma(mb)


def _blur5(x, th, tw, taps):
    """Separable radius-2 Gaussian of padded ``x`` [(th+4), (tw+4)] ->
    [th, tw]: rows first, each sum left to right (the kernel's order)."""
    rows = sum(taps[k] * x[k : k + th, :] for k in range(5))
    return sum(taps[k] * rows[:, k : k + tw] for k in range(5))


def raw_develop_fused_ref(
    mosaic01: torch.Tensor,
    wb_gains,
    cam2srgb,
    params: DevelopParams,
    sharpen_amount,
    pattern: str = "RGGB",
    masks: torch.Tensor | None = None,
    identity_oklch: bool = False,
) -> torch.Tensor:
    """The plain torch twin of the CUDA kernel, on any device: the same
    arithmetic in the same order on whole planes. The CPU path of
    ``raw_develop_fused`` and the reference the kernel is held to."""
    m = _validate(mosaic01, params, pattern, masks)
    dev = mosaic01.device
    h, w = mosaic01.shape
    s = params.breaks.shape[-1]
    balanced = apply_wb_mosaic(mosaic01.to(torch.float32), pattern,
                               _f32(wb_gains, dev))
    if pattern == "XTRANS":
        # Phase-preserving border: each edge continues with its own first
        # or last 12 rows/cols, so every padded site keeps its 6x6 phase.
        k = XT_HALO
        padded = torch.cat([balanced[:k], balanced, balanced[-k:]], 0)
        padded = torch.cat([padded[:, :k], padded, padded[:, -k:]], 1)
        r, g, b = _xtrans(padded, h, w)
    else:
        # Reflect (-1 -> 1) AFTER the WB, so a mirrored site carries its
        # source site's gain; site (-2, -2) keeps the phase of (0, 0).
        r, g, b = malvar_from_padded(pad_reflect(balanced, HALO), h + 4,
                                     w + 4, pattern)

    cam = _f32(cam2srgb, dev)
    cr = torch.clamp(cam[0, 0] * r + cam[0, 1] * g + cam[0, 2] * b, 0.0, 1.0)
    cg = torch.clamp(cam[1, 0] * r + cam[1, 1] * g + cam[1, 2] * b, 0.0, 1.0)
    cb = torch.clamp(cam[2, 0] * r + cam[2, 1] * g + cam[2, 2] * b, 0.0, 1.0)

    # Unsharp on the clipped planes, reading their 2-px margin (computed
    # from the padded mosaic); amount 0 keeps the un-maxed value.
    amt = _f32(sharpen_amount, dev).reshape(())
    taps = [float(t) for t in _gauss_taps(1.0, 2)]
    r, g, b = cr[2:-2, 2:-2], cg[2:-2, 2:-2], cb[2:-2, 2:-2]
    apply_s = amt != 0.0
    r, g, b = (torch.where(apply_s, torch.clamp(
        x + amt * (x - _blur5(p, h, w, taps)), min=0.0), x)
        for x, p in ((r, cr), (g, cg), (b, cb)))

    # Vignette on the true extent (params.extent when set, else H, W).
    ys = torch.arange(h, dtype=torch.int32, device=dev)[:, None]
    xs = torch.arange(w, dtype=torch.int32, device=dev)[None, :]
    hf = torch.where(params.extent[0] > 0, params.extent[0],
                     torch.tensor(float(h), device=dev))
    wf = torch.where(params.extent[1] > 0, params.extent[1],
                     torch.tensor(float(w), device=dev))
    r, g, b = pointwise.vignette(r, g, b, params.vignette, hf, wf, ys, xs)

    # Row 0 of ``masks`` is the main mask: unconditional, never read.
    def sel_for(k):
        return None if k == 0 else masks[k] != 0

    knots, coeffs = fused.pack_curve_tables(params, m, s)
    slots = params.default_slots
    r, g, b = fused.edit_stack(
        r, g, b, sel_for, params.gains, params.tone,
        params.bright_channel.to(torch.float32), knots, coeffs, m, s,
        fused.skips_oklch(params, identity_oklch),
        lambda k, slot: slots[k][slot])
    return torch.stack([r, g, b])


# -- the CUDA kernel ----------------------------------------------------------

def library():
    """The built and loaded kernel library (built at the first call)."""
    global _LIB, BUILD
    if _LIB is None:
        from .cuda_build import build

        lib, BUILD = build("rpf_raw_develop", "raw_develop.cu")
        fn = lib.rpf_raw_develop_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def pattern_code(pattern: str) -> tuple[int, int]:
    """(pattern, r_in_row0) as ``csrc/raw_develop.cu`` takes them: the 2x2
    Bayer tile as four 2-bit channel ids (site (y&1, x&1) at bits
    2*(2*(y&1) + (x&1))), or -1 for X-Trans."""
    if pattern == "XTRANS":
        return -1, 0
    tile = BAYER_PATTERNS[pattern]
    code = sum(int(tile[k >> 1][k & 1]) << (2 * k) for k in range(4))
    return code, int(0 in tile[0])


def pack_table(params: DevelopParams, m: int, s: int, slots, sharpen_amount,
               cam2srgb, wb_gains, device) -> torch.Tensor:
    """The kernel's one small f32 table, in ``csrc/raw_develop.cu`` order:
    [vignette, true_h, true_w, sharpen] [cam2srgb 9] [wb gains 3]
    [gauss taps 5] then the develop kernel's edit tables (slot bits,
    gains, tone, channel, knots, coefficients)."""
    edit = fused.pack_table(params, m, s, slots, None, device)[4:]
    taps = _f32(_gauss_taps(1.0, 2), device)
    return torch.cat([
        params.vignette.reshape(1), params.extent.reshape(2),
        _f32(sharpen_amount, device).reshape(1),
        _f32(cam2srgb, device).reshape(9), _f32(wb_gains, device).reshape(3),
        taps, edit,
    ]).to(torch.float32).contiguous()


def _launch(mosaic01, wb_gains, cam2srgb, params, sharpen_amount, pattern,
            masks, m, identity_oklch):
    dev = mosaic01.device
    if mosaic01.dtype != torch.float32:
        raise ValueError(f"mosaic must be float32, got {mosaic01.dtype}")
    mosaic01 = mosaic01.contiguous()
    h, w = mosaic01.shape
    s = params.breaks.shape[-1]
    fused.check_segments(s)
    table = pack_table(params, m, s, params.default_slots, sharpen_amount,
                       cam2srgb, wb_gains, dev)
    if (table.numel() + 3) * 4 > fused._MAX_SMEM_BYTES // 2:
        raise ValueError(f"{m} masks with {s}-segment curves need "
                         f"{(table.numel() + 3) * 4} B of tables, over the half of "
                         f"a block's shared memory the RAW kernel leaves "
                         f"them")
    regional = None
    if m > 1:
        if masks.device != dev:
            raise ValueError("masks must be on the mosaic's device")
        regional = masks[1:]
        if regional.dtype == torch.bool:
            regional = regional.view(torch.uint8)
        elif regional.dtype != torch.uint8:
            regional = (regional != 0).to(torch.uint8)
        regional = regional.contiguous()
    code, r_in_row0 = pattern_code(pattern)
    out = torch.empty((3, h, w), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = library().rpf_raw_develop_launch(
            mosaic01.data_ptr(),
            None if regional is None else regional.data_ptr(),
            table.data_ptr(), table.numel(), out.data_ptr(), m, s, h, w,
            code, r_in_row0, int(fused.skips_oklch(params, identity_oklch)),
            stream)
    if err != 0:
        raise RuntimeError(f"RAW develop kernel launch failed: CUDA error {err}")
    KERNEL_LAUNCHES["xtrans_kernel" if code < 0 else "bayer_kernel"] += 1
    return out


def raw_develop_fused(
    mosaic01: torch.Tensor,
    wb_gains,
    cam2srgb,
    params: DevelopParams,
    sharpen_amount,
    pattern: str = "RGGB",
    masks: torch.Tensor | None = None,
    identity_oklch: bool = False,
) -> torch.Tensor:
    """Whole-RAW-pipeline develop: normalized CFA ``mosaic01`` f32 [H, W]
    (not yet white-balanced) -> sRGB f32 [3, H, W] in [0, 1]. ``wb_gains``
    (r, g, b), ``cam2srgb`` 3x3, ``sharpen_amount`` the unsharp amount
    (0 = none). With regional masks pass ``masks`` [M, H, W] (row 0, the
    main mask, is never read; a regional mask applies where non-zero).
    Default curves take the develop kernel's bit-identical shortcuts by
    ``params.default_slots``; ``identity_oklch`` permits skipping the
    OKLCH round trip as ``kernels/fused.develop_post_geo_fused`` does
    (<= 3e-3 from the full path).

    A CPU tensor runs the plain twin; a CUDA tensor launches the kernel
    (or raises). Each kernel counts its launches in ``KERNEL_LAUNCHES``."""
    m = _validate(mosaic01, params, pattern, masks)
    if mosaic01.device.type == "cpu":
        return raw_develop_fused_ref(
            mosaic01, wb_gains, cam2srgb, params, sharpen_amount, pattern,
            masks, identity_oklch)
    if mosaic01.device.type != "cuda":
        raise ValueError(f"no RAW develop kernel for device {mosaic01.device}")
    return _launch(mosaic01, wb_gains, cam2srgb, params, sharpen_amount,
                   pattern, masks, m, identity_oklch)
