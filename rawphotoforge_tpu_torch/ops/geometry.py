"""Geometric stages: lens-distortion resampling and bilinear resize.

Contracts (the JAX package's ``ops/geometry.py``):
* lens distortion — wgpu_shader.wgsl:109-164 (barrel/pincushion warp with
  bilinear sampling, out-of-range pixels become black).
* bilinear long-edge resize — the preview-pyramid builder,
  web/main.ts:958-1026 (half-texel-centered sampling, edge clamped).

Both are gathers (advanced indexing on the device). They run once per
geometry-parameter change, not per slider move: the editor caches their
outputs.
"""

from __future__ import annotations

import torch

from ..core.numerics import div


def snap_near_integer(s: torch.Tensor) -> torch.Tensor:
    """Snap sampling coordinates within a few ulps of an integer, so that
    ulp noise in the coordinate cannot become a full-pixel sampling error
    across a pixel boundary. The threshold scales with magnitude (one f32
    ulp at x=4096 is 2.4e-4)."""
    r = torch.round(s)
    thr = torch.clamp(torch.abs(s) * 6e-7, min=1e-4)  # ~5 ulps
    return torch.where(torch.abs(s - r) < thr, r, s)


def _bilinear_gather(plane, y0, y1, x0, x1, ty, tx):
    """Sample one plane at the four integer corners and lerp."""
    c00 = plane[y0, x0]
    c10 = plane[y0, x1]
    c01 = plane[y1, x0]
    c11 = plane[y1, x1]
    cx0 = c00 * (1.0 - tx) + c10 * tx
    cx1 = c01 * (1.0 - tx) + c11 * tx
    return cx0 * (1.0 - ty) + cx1 * ty


def warp_coords(ys, xs, hf, wf, strength):
    """Source coordinates of the radial warp for destination pixels
    (ys, xs) (contract: wgpu_shader.wgsl:109-164).

    Returns (py, px, oob): f32 source pixel coordinates and the
    out-of-range mask (black pixels).
    """
    u = xs.to(torch.float32) / wf
    v = ys.to(torch.float32) / hf
    cu = u - 0.5
    cv = v - 0.5
    aspect = wf / hf
    cu = cu * aspect
    r2 = cu * cu + cv * cv
    denom = 1.0 + strength * r2
    du = cu / denom
    dv = cv / denom
    fu = du / aspect + 0.5
    fv = dv + 0.5
    oob = (fu < 0.0) | (fu > 1.0) | (fv < 0.0) | (fv > 1.0)
    px = fu * (wf - 1.0)
    py = fv * (hf - 1.0)
    return py, px, oob


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def lens_distortion(r, g, b, distortion, extent=None):
    """Radial lens-distortion resample of full planes.

    ``distortion`` is the raw slider value (-100..100); strength =
    -0.5 * d / 100. At strength 0 the planes pass through untouched (the
    shader's early return, wgsl:118-120). ``extent``: optional true (h, w)
    for bucket-padded arrays — coordinates normalize by the true extent;
    pixels beyond it land out of bounds and come out black.
    """
    h, w = r.shape
    dev = r.device
    strength = -0.5 * div(_f32(distortion, dev), 100.0)
    if float(strength) == 0.0:
        return r, g, b
    if extent is None:
        hf, wf = _f32(h, dev), _f32(w, dev)
    else:
        ext = _f32(extent, dev)
        hf = torch.where(ext[0] > 0, ext[0], _f32(h, dev))
        wf = torch.where(ext[1] > 0, ext[1], _f32(w, dev))
    ys = torch.arange(h, dtype=torch.int32, device=dev)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=torch.int32, device=dev)[None, :].expand(h, w)
    py, px, oob = warp_coords(ys, xs, hf, wf, strength)
    px = snap_near_integer(px)
    py = snap_near_integer(py)
    x0f = torch.floor(px)
    y0f = torch.floor(py)
    wi = int((wf - 1.0).to(torch.int32))
    hi = int((hf - 1.0).to(torch.int32))
    x0 = torch.clamp(x0f.to(torch.int64), 0, wi)
    y0 = torch.clamp(y0f.to(torch.int64), 0, hi)
    x1 = torch.clamp(x0 + 1, max=wi)
    y1 = torch.clamp(y0 + 1, max=hi)
    tx = px - x0f
    ty = py - y0f
    return tuple(
        torch.where(oob, 0.0, _bilinear_gather(p, y0, y1, x0, x1, ty, tx))
        for p in (r, g, b)
    )


def resize_long_edge_shape(h: int, w: int, target_long_edge: int) -> tuple[int, int]:
    """Destination shape of the long-edge resize (web/main.ts:968-977),
    rounding the short edge half away from zero like JS Math.round."""
    if w >= h:
        dw = target_long_edge
        dh = int(h * (target_long_edge / w) + 0.5)
    else:
        dh = target_long_edge
        dw = int(w * (target_long_edge / h) + 0.5)
    return max(dh, 1), max(dw, 1)


def _lerp4(planes, y0, y1, x0, x1, ty, tx):
    rows0 = planes[:, y0, :]
    rows1 = planes[:, y1, :]
    c00 = rows0[:, :, x0]
    c10 = rows0[:, :, x1]
    c01 = rows1[:, :, x0]
    c11 = rows1[:, :, x1]
    cx0 = c00 * (1.0 - tx) + c10 * tx
    cx1 = c01 * (1.0 - tx) + c11 * tx
    return cx0 * (1.0 - ty) + cx1 * ty


def resize_bilinear(planes: torch.Tensor, dh: int, dw: int) -> torch.Tensor:
    """Half-texel-centered bilinear resize of stacked planes [C, H, W].

    Contract: web/main.ts:984-1019 — source coordinate
    s = (d + 0.5) * scale - 0.5, floor clamped at 0, +1 neighbor clamped at
    the edge.
    """
    _, h, w = planes.shape
    dev = planes.device
    scale_y = h / dh
    scale_x = w / dw
    sy = (torch.arange(dh, dtype=torch.float32, device=dev) + 0.5) * scale_y - 0.5
    sx = (torch.arange(dw, dtype=torch.float32, device=dev) + 0.5) * scale_x - 0.5
    y0 = torch.clamp(torch.floor(sy), min=0.0).to(torch.int64)
    x0 = torch.clamp(torch.floor(sx), min=0.0).to(torch.int64)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    ty = (sy - y0.to(torch.float32))[None, :, None]
    tx = (sx - x0.to(torch.float32))[None, None, :]
    return _lerp4(planes, y0, y1, x0, x1, ty, tx)


def resize_bilinear_extents(planes: torch.Tensor, extents, out_shape: tuple
                            ) -> torch.Tensor:
    """Bucket-stable bilinear resize: ``resize_bilinear`` semantics on a
    bucket-padded [C, Hp, Wp] stack whose top-left ``extents[:2]`` =
    (src_h, src_w) region holds the real image; ``extents[2:]`` =
    (dst_h, dst_w) is the true destination extent and ``out_shape`` the
    padded output grid. Sampling clamps to the true source extent (pad
    values are never read); output rows/cols beyond the destination extent
    replicate the last true row/col (``mode="edge"`` padding)."""
    dev = planes.device
    dhp, dwp = out_shape
    ef = torch.as_tensor(extents, device=dev).to(torch.float32)
    h, w, dh, dw = ef[0], ef[1], ef[2], ef[3]
    di = torch.minimum(torch.arange(dhp, dtype=torch.float32, device=dev), dh - 1.0)
    dj = torch.minimum(torch.arange(dwp, dtype=torch.float32, device=dev), dw - 1.0)
    sy = (di + 0.5) * (h / dh) - 0.5
    sx = (dj + 0.5) * (w / dw) - 0.5
    y0f = torch.clamp(torch.floor(sy), min=0.0)
    x0f = torch.clamp(torch.floor(sx), min=0.0)
    hi1 = int(extents[0]) - 1
    wi1 = int(extents[1]) - 1
    y0 = torch.clamp(y0f.to(torch.int64), max=hi1)
    x0 = torch.clamp(x0f.to(torch.int64), max=wi1)
    y1 = torch.clamp(y0 + 1, max=hi1)
    x1 = torch.clamp(x0 + 1, max=wi1)
    ty = (sy - y0f)[None, :, None]
    tx = (sx - x0f)[None, None, :]
    return _lerp4(planes, y0, y1, x0, x1, ty, tx)
