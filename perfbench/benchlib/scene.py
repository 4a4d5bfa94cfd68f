"""The benchmark's inputs, made on the device from the seed: a linear
scene, its CFA mosaic as the camera would record it, and the regional
masks' logits.

The scene is a photograph's mix of smooth gradients, hard-edged objects of
many colours, clipped highlights and sensor noise, so that every curve,
hue band and mask boundary sees pixels. Every seed gives the same amount of
work: the same sizes, the same number of objects and highlights, the same
noise level and the same mask coverage; only positions and colours move,
and which object takes which of the fixed sizes.
"""

from __future__ import annotations

import numpy as np
import torch

from reference.raw_session import cam_to_srgb, wb_gains

N_DISCS = 24
N_RECTS = 24
N_HIGHLIGHTS = 2
NOISE = 0.01


def _generator(seed: int, device, stream: int) -> torch.Generator:
    """A torch generator on ``device`` for one named stream of the seed."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1000003 + stream) % (1 << 63))
    return g


def _u(g, n, device, lo=0.0, hi=1.0):
    return lo + (hi - lo) * torch.rand(n, generator=g, device=device)


def _dealt(g, n: int, device, lo: float, hi: float) -> torch.Tensor:
    """``n`` values evenly spread over [lo, hi], in an order the seed
    shuffles: every seed gets the same set."""
    even = lo + (hi - lo) * (torch.arange(n, device=device) + 0.5) / n
    return even[torch.randperm(n, generator=g, device=device)]


def scene(seed: int, h: int, w: int, device) -> torch.Tensor:
    """Linear scene-referred RGB [3, h, w] f32, >= 0 (highlights above 1)."""
    g = _generator(seed, device, 1)
    yy = torch.linspace(0.0, 1.0, h, device=device)[:, None]
    xx = torch.linspace(0.0, 1.0, w, device=device)[None, :]
    ang = float(_u(g, 1, device, 0.0, 2 * np.pi))
    ramp = np.cos(ang) * (xx - 0.5) + np.sin(ang) * (yy - 0.5) + 0.5
    base = _u(g, (3, 2), device, 0.05, 0.7)
    planes = base[:, 0, None, None] + (base[:, 1] - base[:, 0])[:, None, None] * ramp
    planes = planes + 0.1 * torch.sin(6.0 * (xx + yy))[None]
    short = min(h, w)
    for kind, n in (("disc", N_DISCS), ("rect", N_RECTS),
                    ("highlight", N_HIGHLIGHTS)):
        cy, cx = _u(g, n, device) * h, _u(g, n, device) * w
        size = _dealt(g, n, device, 0.02, 0.15) * short
        aspect = _dealt(g, n, device, 0.5, 2.0)
        colour = _u(g, (n, 3), device, 0.01, 1.0)
        for i in range(n):
            dy = (torch.arange(h, device=device)[:, None] - cy[i]).abs()
            dx = (torch.arange(w, device=device)[None, :] - cx[i]).abs()
            if kind == "rect":
                inside = (dy < size[i]) & (dx < size[i] * aspect[i])
            else:
                inside = dy * dy + (dx / aspect[i]) ** 2 < size[i] * size[i]
            col = colour[i] if kind != "highlight" else torch.full(
                (3,), 1.6, device=device)
            planes = torch.where(inside[None], col[:, None, None], planes)
    noise = torch.randn((3, h, w), generator=g, device=device)
    return torch.clamp(planes * (1.0 + NOISE * noise) + 0.2 * NOISE * noise, min=0.0)


def mosaic(planes: torch.Tensor, meta: dict) -> torch.Tensor:
    """The sensor's u16-valued CFA samples (int32 [h, w]) of a linear sRGB
    scene: through the inverse camera matrix, divided by the as-shot white
    balance, sampled on the CFA and quantized into [black, white]."""
    dev = planes.device
    srgb2cam = torch.from_numpy(np.linalg.inv(
        cam_to_srgb(meta["color_matrix"]).astype(np.float64)).astype(np.float32)).to(dev)
    cam = torch.einsum("ij,jhw->ihw", srgb2cam, planes)
    cam = cam / torch.tensor(wb_gains(meta["as_shot_neutral"]), dtype=torch.float32,
                             device=dev)[:, None, None]
    cfa = np.asarray(meta["cfa"], dtype=np.int64)
    ph, pw = cfa.shape
    _, h, w = planes.shape
    ys = torch.arange(h, device=dev)[:, None] % ph
    xs = torch.arange(w, device=dev)[None, :] % pw
    chan = torch.from_numpy(cfa.reshape(-1)).to(dev)[ys * pw + xs]
    m01 = torch.gather(cam, 0, chan[None]).squeeze(0)
    black, white = float(meta["black_level"]), float(meta["white_level"])
    return torch.clamp(torch.round(m01 * (white - black) + black), 0, white).to(torch.int32)


def _threshold_to_coverage(f: torch.Tensor, coverage: float) -> torch.Tensor:
    """``f`` shifted so that ``f >= 0`` selects ``coverage`` of the frame
    (the threshold is the quantile of a regular subsample)."""
    sample = f[::7, ::7].reshape(-1).sort().values
    k = min(sample.numel() - 1, max(0, int(round((1.0 - coverage) * sample.numel()))))
    return f - sample[k]


def mask_logits(kind: str, coverage: float, seed: int, index: int, h: int, w: int,
                device) -> torch.Tensor:
    """f32 [h, w] logits of one regional mask, selected where >= 0:
    ``linear`` a graduated filter (a half plane), ``radial`` an ellipse,
    ``blob`` a brush stroke of eight dabs. Each shape is fixed and the seed
    mirrors it up-down, so every seed's mask covers the same columns: the
    kernel's blocks split the frame by columns and stride over the rows,
    and a left-right mirror, which moves the masked work between blocks,
    moved the kernel's time by 5 %."""
    g = _generator(seed, device, 100 + index)
    yy = torch.linspace(0.0, 1.0, h, device=device)[:, None]
    xx = torch.linspace(0.0, 1.0, w, device=device)[None, :] * (w / h)
    if kind == "linear":
        ang = 0.35
        f = np.cos(ang) * xx + np.sin(ang) * yy
    elif kind == "radial":
        f = -((yy - 0.42) ** 2 + ((xx - 0.45 * w / h) / 1.25) ** 2)
    elif kind == "blob":
        path = ((0.35, 0.30), (0.40, 0.36), (0.43, 0.43), (0.47, 0.48),
                (0.52, 0.52), (0.55, 0.58), (0.60, 0.62), (0.63, 0.69))
        f = torch.full((h, w), -1e30, device=device)
        for y, x in path:
            f = torch.maximum(f, -((yy - y) ** 2 + (xx - x * w / h) ** 2))
    else:
        raise ValueError(f"unknown mask kind {kind!r}")
    f = _threshold_to_coverage(f.expand(h, w).contiguous(), coverage)
    return f.flip(0) if bool(torch.rand(1, generator=g, device=device) < 0.5) else f
