"""Unsharp-mask sharpening (separable Gaussian), a stencil stage.

Runs on linear-light planes between the geometry stage and the pointwise
stack: two 1-D shift-and-multiply-add passes with reflect padding (the
JAX package's ``ops/sharpen.py`` order of accumulation), then
``out = x + amount * (x - blur)``.
"""

from __future__ import annotations

import numpy as np
import torch


def _gauss_taps(sigma: float, radius: int) -> np.ndarray:
    xs = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (xs / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _pad_index(n: int, radius: int) -> np.ndarray:
    """Source indices of numpy 'reflect' padding by ``radius`` (degrading
    to edge replication when the axis is not longer than the radius)."""
    idx = np.arange(-radius, n + radius)
    if n > radius:
        idx = np.abs(idx)
        idx = np.where(idx > n - 1, 2 * (n - 1) - idx, idx)
    return np.clip(idx, 0, n - 1)


def _blur_axis(x: torch.Tensor, taps: np.ndarray, axis: int) -> torch.Tensor:
    radius = (len(taps) - 1) // 2
    n = x.shape[axis]
    idx = torch.from_numpy(_pad_index(n, radius)).to(x.device)
    xp = torch.index_select(x, axis, idx)
    out = torch.zeros_like(x)
    for i, w in enumerate(taps):
        out = out + float(w) * xp.narrow(axis, i, n)
    return out


def gaussian_blur(planes: torch.Tensor, sigma: float = 1.0, radius: int = 2) -> torch.Tensor:
    """Separable Gaussian blur of [C, H, W] planes (reflect padding)."""
    taps = _gauss_taps(sigma, radius)
    return _blur_axis(_blur_axis(planes, taps, 1), taps, 2)


def unsharp_mask(
    planes: torch.Tensor,
    amount: float,
    sigma: float = 1.0,
    radius: int = 2,
    threshold: float = 0.0,
) -> torch.Tensor:
    """Unsharp mask on linear planes [3, H, W]: out = x + amount * (x -
    gaussian(x)), clamped at 0; pixels whose |highpass| is below
    ``threshold`` are left untouched. amount == 0 is the identity."""
    amount = float(np.float32(amount))
    if amount == 0.0:
        return planes
    blur = gaussian_blur(planes, sigma=sigma, radius=radius)
    high = planes - blur
    if threshold > 0.0:
        high = torch.where(torch.abs(high) >= threshold, high, 0.0)
    return torch.clamp(planes + amount * high, min=0.0)
