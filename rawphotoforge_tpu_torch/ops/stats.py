"""On-device image statistics: histograms and clipping fractions.

The reference computes a 256-bin luma + R/G/B histogram over the preview
(python-legacy raw_photo_forge.py:1849-1862). Here one ``torch.bincount``
over the four rows (offset by row) counts all 1024 bins in one pass; the
JAX package's per-bin reductions existed only because a scatter-add
serializes on the TPU.
"""

from __future__ import annotations

import torch

from ..core.color import luma
from ..core.numerics import div

NUM_BINS = 256


def _bins(srgb_planes: torch.Tensor) -> torch.Tensor:
    r, g, b = srgb_planes[0], srgb_planes[1], srgb_planes[2]
    # OpenCV RGB2GRAY weights (the reference feeds cv2 the u8 preview).
    gray = 0.299 * r + 0.587 * g + 0.114 * b
    vals = torch.stack([r, g, b, gray]).reshape(4, -1)
    return torch.clamp((vals * 255.0).to(torch.int32), 0, NUM_BINS - 1)


def histogram_rgbl(srgb_planes: torch.Tensor) -> torch.Tensor:
    """sRGB-encoded planes [3, H, W] -> i64 [4, 256]: R, G, B, gray rows
    (gray with the BT.601 weights on the display-encoded planes)."""
    idx = _bins(srgb_planes).to(torch.int64)
    idx = idx + NUM_BINS * torch.arange(4, device=idx.device)[:, None]
    return torch.bincount(idx.reshape(-1), minlength=4 * NUM_BINS).reshape(
        4, NUM_BINS)


def _rect_slice(srgb_planes, rect):
    y0, y1, x0, x1 = (int(v) for v in rect)
    return srgb_planes[:, y0:y1, x0:x1]


def histogram_rgbl_rect(srgb_planes: torch.Tensor, rect) -> torch.Tensor:
    """histogram_rgbl restricted to ``rect`` = (y0, y1, x0, x1), exclusive
    ends."""
    return histogram_rgbl(_rect_slice(srgb_planes, rect))


def clipping_stats(srgb_planes: torch.Tensor) -> dict:
    """Fractions of highlight- and shadow-clipped pixels (any channel), as
    0-d f32 tensors."""
    hi = torch.any(srgb_planes >= 1.0 - 0.5 / 255.0, dim=0)
    lo = torch.any(srgb_planes <= 0.5 / 255.0, dim=0)
    n = hi.numel()
    return {
        "highlight_clip_fraction": div(hi.sum().to(torch.float32), n),
        "shadow_clip_fraction": div(lo.sum().to(torch.float32), n),
    }


def clipping_stats_rect(srgb_planes: torch.Tensor, rect) -> dict:
    """clipping_stats restricted to ``rect`` = (y0, y1, x0, x1)."""
    return clipping_stats(_rect_slice(srgb_planes, rect))


def luma_linear(planes: torch.Tensor) -> torch.Tensor:
    """Rec.709 luma of linear planes [3, H, W] (wgpu_shader.wgsl:218)."""
    return luma(planes[0], planes[1], planes[2])
