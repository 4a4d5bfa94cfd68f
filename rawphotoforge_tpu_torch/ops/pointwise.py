"""Pointwise develop-stack stages: white balance, tone, vignette.

Numerical contract: wgpu_shader.wgsl — tone() at :200-259, vignette() at
:166-178, WB multiply at :286-288; the same operation order as the JAX
package's ``ops/pointwise.py`` (``csrc/edit_stack.cuh`` mirrors it in
CUDA). Planar float32 tensors; per-mask scalars may be 0-d tensors, so
nothing here waits on the device.
"""

from __future__ import annotations

import torch

from ..core.color import luma
from ..core.numerics import div


def white_balance(r, g, b, gains):
    """Per-channel gains; gains is a length-3 vector (r_gain, g_gain, b_gain)."""
    return r * gains[0], g * gains[1], b * gains[2]


def tone(r, g, b, tone_vec):
    """Exposure / shadow / highlight / black / white / contrast + clamp.

    ``tone_vec`` is the packed [exposure_ev, contrast, shadow, highlight,
    black, white] row (already /100-scaled). The WGSL ``if x != 0``
    branches around black/white/contrast become selects, so the zero case
    is bit-identical.
    """
    exposure, contrast, shadow, highlight, black, white = (
        tone_vec[0], tone_vec[1], tone_vec[2], tone_vec[3], tone_vec[4], tone_vec[5],
    )
    mul = torch.exp2(exposure)
    r, g, b = r * mul, g * mul, b * mul

    y = luma(r, g, b)

    shadow_gain = 1.0 + shadow * torch.clamp(1.0 - y, 0.0, 1.0)
    r, g, b = r * shadow_gain, g * shadow_gain, b * shadow_gain

    highlight_gain = 1.0 + highlight * torch.clamp(y, 0.0, 1.0)
    r, g, b = r * highlight_gain, g * highlight_gain, b * highlight_gain

    t = torch.clamp(y, 0.0, 1.0)
    black_lift = black * ((1.0 - t) * (1.0 - t))
    apply_black = black != 0.0
    r = torch.where(apply_black, r + black_lift, r)
    g = torch.where(apply_black, g + black_lift, g)
    b = torch.where(apply_black, b + black_lift, b)

    white_lift = white * (t * t)
    apply_white = white != 0.0
    r = torch.where(apply_white, r + white_lift, r)
    g = torch.where(apply_white, g + white_lift, g)
    b = torch.where(apply_white, b + white_lift, b)

    c = 1.0 + contrast
    apply_c = contrast != 0.0
    r = torch.where(apply_c, (r - 0.5) * c + 0.5, r)
    g = torch.where(apply_c, (g - 0.5) * c + 0.5, g)
    b = torch.where(apply_c, (b - 0.5) * c + 0.5, b)

    return (
        torch.clamp(r, 0.0, 1.0),
        torch.clamp(g, 0.0, 1.0),
        torch.clamp(b, 0.0, 1.0),
    )


def vignette(r, g, b, vignette_value, full_h, full_w, ys, xs):
    """Vignette multiply. ``ys``/``xs`` are row/col coordinate tensors
    (broadcastable to the plane shape); full_h/full_w are the *full image*
    dimensions (the true extent when bucket-padded). Contract:
    wgpu_shader.wgsl:166-178."""
    strength = div(-vignette_value, 100.0) * 2.0
    cy = (ys.to(torch.float32) / full_h - 0.5) * 1.5
    cx = (xs.to(torch.float32) / full_w - 0.5) * 1.5
    dist = torch.sqrt(cx * cx + cy * cy)
    t = torch.clamp(div(dist - 0.25, 0.75), 0.0, 1.0)
    falloff = t * torch.sqrt(t)  # pow(t, 1.5) without the exp/log pow
    gain = torch.clamp(1.0 - strength * falloff, 0.0, 4.0)
    apply = strength != 0.0
    return (
        torch.where(apply, r * gain, r),
        torch.where(apply, g * gain, g),
        torch.where(apply, b * gain, b),
    )
