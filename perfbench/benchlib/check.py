"""The comparison that decides ``correct``: a render the program produced
against the plain reference's render of the same edit state."""

from __future__ import annotations

import torch

OFF_BY = 2e-3
# OKLab chroma below which a pixel's hue is rounding noise: the hue curves'
# gains read there can land anywhere on the curve, on either side.
CHROMA_FLOOR = 3e-3

# Linear sRGB to OKLab (Ottosson's matrices), for the reference's chroma.
_M1 = ((0.4122214708, 0.5363325363, 0.0514459929),
       (0.2119034982, 0.6806995451, 0.1073969566),
       (0.0883024619, 0.2817188376, 0.6299787005))
_AB = ((1.9779984951, -2.4285922050, 0.4505937099),
       (0.0259040371, 0.7827717662, -0.8086757660))


def chroma(srgb: torch.Tensor) -> torch.Tensor:
    """OKLab chroma [h, w] of an sRGB image [3, h, w] in [0, 1]."""
    c = srgb.to(torch.float32)
    lin = torch.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)
    lms = [torch.clamp(sum(k * lin[j] for j, k in enumerate(row)), min=0.0) ** (1.0 / 3.0)
           for row in _M1]
    a, b = (sum(k * lms[j] for j, k in enumerate(row)) for row in _AB)
    return torch.sqrt(a * a + b * b)


def gaps(program: torch.Tensor, reference: torch.Tensor) -> dict:
    """Program against reference, sRGB [3, h, w] in [0, 1]:

    - ``max_gap``: the largest |program - reference| over every channel of
      the pixels whose chroma in the reference is at least
      ``CHROMA_FLOOR`` (a near-neutral pixel's hue, and with it every
      gain the hue curves give it, is rounding noise on both sides);
    - ``share_off``: the share of all values, near-neutral pixels
      included, off by more than ``OFF_BY`` (half a step of an 8-bit
      export).

    Logged beside them, held to no limit: ``max_gap_all`` over every pixel
    and ``neutral_share``, the share of pixels under the floor."""
    if tuple(program.shape) != tuple(reference.shape):
        return {"max_gap": float("inf"), "share_off": 1.0}
    d = (program.to(torch.float32) - reference.to(torch.float32)).abs_()
    bad = torch.isnan(d)
    if bool(bad.any()):
        return {"max_gap": float("inf"), "share_off": float(bad.sum()) / d.numel()}
    chromatic = chroma(reference) >= CHROMA_FLOOR
    per_pixel = d.amax(0)
    return {"max_gap": float(per_pixel[chromatic].max()) if bool(chromatic.any()) else 0.0,
            "share_off": float((d > OFF_BY).sum()) / d.numel(),
            "max_gap_all": float(per_pixel.max()),
            "neutral_share": float((~chromatic).sum()) / chromatic.numel()}


def worst(readings: list[dict]) -> dict:
    """The worst of each number over the compared renders."""
    keys = dict.fromkeys(k for r in readings for k in r)
    return {k: max(r[k] for r in readings if k in r) for k in keys}


def judge(numbers: dict, limits: dict | None) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) for the numbers a cell's
    limits hold; no limits (or no numbers) is not correct."""
    if not limits or not numbers:
        return False, {k: {"value": v, "limit": None} for k, v in numbers.items()}
    held = {k: {"value": numbers[k], "limit": lim["limit"]}
            for k, lim in limits.items() if not k.startswith("_")}
    return all(v["value"] <= v["limit"] for v in held.values()), held
