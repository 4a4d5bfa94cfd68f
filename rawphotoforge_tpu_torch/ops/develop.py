"""The full non-destructive develop stack — the exact-LUT semantics anchor.

The torch re-expression of the JAX package's ``ops/develop.py``: lens
distortion -> vignette -> per-mask (WB -> tone -> brightness LUT) -> OKLCH
per-mask (hue/sat/light by hue LUT) -> sRGB encode, with the *exact*
65536-entry i32 LUT gathers (floor indexing, truncating stores). It is the
oracle the develop kernel (``kernels/fused``) is held to.

Layout: planar float32 [3, H, W]. Masks are [M, H, W] (u8 or f32); a
mask's edits apply where the mask is non-zero; mask 0 is the all-ones main
mask (lib.rs:100-113).
"""

from __future__ import annotations

import torch

from ..core import color
from ..core.numerics import div
from ..core.params import BRIGHTNESS, HUE, SATURATION, LIGHTNESS, DevelopParams
from . import pointwise
from .geometry import lens_distortion

LUT_MAX = 65535.0


def _lut_index(v):
    """WGSL ``u32(v * 65535)``: truncation toward zero, then clamped to the
    table (``jnp.take`` clips where torch indexing would raise)."""
    return torch.clamp((v * LUT_MAX).to(torch.int64), 0, 65535)


def _fetch(lut_row, idx):
    """lut_fetch (wgpu_shader.wgsl:184-194): clamp table values to [0, 65535]."""
    return torch.clamp(lut_row[idx], 0, 65535)


def geometry_stage(planes: torch.Tensor, distortion, extent=None) -> torch.Tensor:
    """Lens-distortion resample of [3, H, W] planes (``extent``: true (h, w)
    for bucket-padded arrays)."""
    r, g, b = lens_distortion(planes[0], planes[1], planes[2], distortion, extent)
    return torch.stack([r, g, b])


def _coords(h_img, w_img, params: DevelopParams, device, row_offset=0):
    hf = torch.where(params.extent[0] > 0, params.extent[0],
                     torch.tensor(float(h_img), device=device))
    wf = torch.where(params.extent[1] > 0, params.extent[1],
                     torch.tensor(float(w_img), device=device))
    ys = torch.arange(h_img, dtype=torch.int32, device=device)[:, None] + row_offset
    xs = torch.arange(w_img, dtype=torch.int32, device=device)[None, :]
    return hf, wf, ys, xs


def develop_post_geo(
    planes: torch.Tensor, params: DevelopParams, masks: torch.Tensor | None,
    row_offset: int = 0,
) -> torch.Tensor:
    """Develop stack *after* lens distortion: vignette -> per-mask linear
    pass -> per-mask OKLCH pass -> sRGB encode.

    ``masks=None`` is the single-mask session: mask row 0 is all-ones by
    construction, so its selects are elided and no [1, H, W] ones stack is
    ever materialized. ``row_offset``: global row index of the first row
    (the vignette's coordinates) when ``planes`` is a row slab of a larger
    image whose true extent rides in ``params.extent``."""
    r, g, b = planes[0], planes[1], planes[2]
    h_img, w_img = r.shape
    num_masks = 1 if masks is None else masks.shape[0]

    hf, wf, ys, xs = _coords(h_img, w_img, params, planes.device, int(row_offset))
    r, g, b = pointwise.vignette(r, g, b, params.vignette, hf, wf, ys, xs)

    # Per-mask linear-RGB pass: WB -> tone -> brightness LUT (wgsl:279-308).
    for k in range(num_masks):
        sel = None if masks is None else masks[k] != 0
        rk, gk, bk = pointwise.white_balance(r, g, b, params.gains[k])
        rk, gk, bk = pointwise.tone(rk, gk, bk, params.tone[k])
        lut = params.luts[k, BRIGHTNESS]
        # Channel selector (v1 tone_curve_lut channel arg; 3 = all).
        ch = params.bright_channel[k]
        rc = div(_fetch(lut, _lut_index(rk)).to(torch.float32), LUT_MAX)
        gc = div(_fetch(lut, _lut_index(gk)).to(torch.float32), LUT_MAX)
        bc = div(_fetch(lut, _lut_index(bk)).to(torch.float32), LUT_MAX)
        rk = torch.where((ch == 0) | (ch == 3), rc, rk)
        gk = torch.where((ch == 1) | (ch == 3), gc, gk)
        bk = torch.where((ch == 2) | (ch == 3), bc, bk)
        if sel is None:
            r, g, b = rk, gk, bk
        else:
            r = torch.where(sel, rk, r)
            g = torch.where(sel, gk, g)
            b = torch.where(sel, bk, b)

    # Per-mask OKLCH pass: hue remap + sat/light gains by hue (wgsl:310-331).
    L, C, H = color.linear_srgb_to_oklch(r, g, b)
    for k in range(num_masks):
        sel = None if masks is None else masks[k] != 0
        h_idx = _lut_index(H)
        new_hue = div(_fetch(params.luts[k, HUE], h_idx).to(torch.float32), LUT_MAX)
        sat_gain = div(_fetch(params.luts[k, SATURATION], h_idx).to(torch.float32), 32767.5)
        light_gain = div(_fetch(params.luts[k, LIGHTNESS], h_idx).to(torch.float32), 32767.5)
        if sel is None:
            H, C, L = new_hue, C * sat_gain, L * light_gain
        else:
            H = torch.where(sel, new_hue, H)
            C = torch.where(sel, C * sat_gain, C)
            L = torch.where(sel, L * light_gain, L)
    r, g, b = color.oklch_to_linear_srgb(L, C, H)

    out = torch.stack(
        [color.linear_to_srgb(r), color.linear_to_srgb(g), color.linear_to_srgb(b)]
    )
    return torch.clamp(out, 0.0, 1.0)


def develop(planes: torch.Tensor, params: DevelopParams,
            masks: torch.Tensor | None) -> torch.Tensor:
    """Run the whole develop stack: f32 [3, H, W] linear planes -> sRGB f32
    [3, H, W] clamped to [0, 1] (wgpu_shader.wgsl:335-336)."""
    return develop_post_geo(
        geometry_stage(planes, params.distortion, params.extent), params, masks
    )


def develop_batch(imgs: torch.Tensor, params: DevelopParams,
                  masks: torch.Tensor | None) -> torch.Tensor:
    """Batch develop: one shared edit (``params``, ``masks``) applied to each
    image of a stack [N, 3, H, W] — the kernel of the 256-image export
    configuration."""
    return torch.stack([develop(img, params, masks) for img in imgs])


def replicate_true_edges(planes: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """Re-edge-replicate the true image into the bucket pad after a warp.

    The warp maps pad pixels out of bounds -> black; a downstream stencil
    (unsharp_mask, radius 2) must see replicated edges like the unwarped
    path does, or the last true rows/cols sharpen against black."""
    _, ph, pw = planes.shape
    rows = torch.clamp(torch.arange(ph, device=planes.device), max=th - 1)
    cols = torch.clamp(torch.arange(pw, device=planes.device), max=tw - 1)
    return planes[:, rows][:, :, cols]


def encode_u8(srgb_planes: torch.Tensor) -> torch.Tensor:
    """sRGB f32 [3,H,W] in [0,1] -> u8, truncating like Rust ``as u8``
    (image.rs:375-383)."""
    return (torch.clamp(srgb_planes, 0.0, 1.0) * 255.0).to(torch.uint8)


def encode_u16(srgb_planes: torch.Tensor) -> torch.Tensor:
    """sRGB f32 [3,H,W] in [0,1] -> u16 (for 16-bit PNG/PPM export)."""
    return (torch.clamp(srgb_planes, 0.0, 1.0) * 65535.0).to(torch.uint16)
