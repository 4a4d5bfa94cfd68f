"""Profile-driven lens corrections (vignetting, distortion, chromatic
aberration) and the DNG OpcodeList3 warps, on torch tensors.

The JAX package's ``ops/lenscorr.py`` (capability parity with v1's lensfun
integration, python-legacy/raw_image_editor/editor.py:425-711): given a
lens profile, apply (1) devignetting gain, (2) geometric distortion
remap, (3) per-channel transverse-chromatic-aberration remap. Profiles
are explicit parameter sets (JSON-serializable) in the standard lensfun
math models (``io/lensdb`` resolves them from EXIF).

Models (r = radius normalized so the half-diagonal is 1):
* vignetting 'pa' model:  gain(r) = 1 + k1 r^2 + k2 r^4 + k3 r^6
  (correction multiplies by 1/gain).
* distortion 'poly3':     r_src = r_d (1 - k1 + k1 r_d^2)
* distortion 'poly5':     r_src = r_d (1 + k1 r_d^2 + k2 r_d^4)
* distortion 'ptlens':    r_src = r_d (a r_d^3 + b r_d^2 + c r_d + 1-a-b-c)
* TCA 'linear':           r_src_R = r * vr,  r_src_B = r * vb
  (green is the reference channel).

Devignetting is pointwise; each remap is a coordinate computation and a
bilinear gather per channel, in the JAX package's f32 operation order.
Scalars live on the planes' device as 0-d f32 tensors, so a division
rounds as one f32 division on the card too (``core/numerics``).
``extent`` is the true (h, w) of bucket-padded planes: coordinates
normalize by it and samples clamp to it.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

import torch


@dataclasses.dataclass
class LensProfile:
    """One lens+settings correction set (lensfun model parameters)."""

    name: str = "unnamed"
    # Vignetting (pa model), applied on linear light.
    vignetting: Optional[tuple] = None          # (k1, k2, k3)
    # Geometric distortion.
    distortion_model: str = "poly3"             # 'poly3' | 'poly5' | 'ptlens'
    distortion: Optional[tuple] = None          # poly3: (k1,); poly5: (k1, k2);
    #                                             ptlens: (a, b, c)
    # Transverse chromatic aberration (linear model).
    tca: Optional[tuple] = None                 # (vr, vb)
    # Crop-factor coordinate rescale: the model polynomials are evaluated
    # at r_cal = r_image * radius_scale (calib_crop / camera_crop; 1.0 =
    # same crop as calibration).
    radius_scale: float = 1.0
    # True when the coefficients come from a database marked
    # provenance="approximate" (the bundled starter set, data/lenses.xml)
    # rather than calibrated lensfun data.
    approximate: bool = False

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, s: str) -> "LensProfile":
        d = json.loads(s)
        known = {f.name for f in dataclasses.fields(cls)}
        d = {k: v for k, v in d.items() if k in known}  # tolerate extras
        for k in ("vignetting", "distortion", "tca"):
            if d.get(k) is not None:
                d[k] = tuple(d[k])
        return cls(**d)


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _extent(h: int, w: int, extent, device):
    """(hf, wf) as 0-d f32 tensors: the true extent, or the array's own
    dims where ``extent`` is None or not positive."""
    hf, wf = _f32(h, device), _f32(w, device)
    if extent is None:
        return hf, wf
    ext = _f32(extent, device)
    return (torch.where(ext[0] > 0, ext[0], hf),
            torch.where(ext[1] > 0, ext[1], wf))


def _iota(h: int, w: int, device):
    ys = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    return ys.expand(h, w), xs.expand(h, w)


def _radius2(h, w, device, extent=None):
    """Squared radius map, normalized so the half-diagonal is 1 (lensfun
    convention), plus the centered coordinate grids."""
    hf, wf = _extent(h, w, extent, device)
    ys, xs = _iota(h, w, device)
    cx = (wf - 1.0) * 0.5
    cy = (hf - 1.0) * 0.5
    half_diag = torch.sqrt(cx * cx + cy * cy)
    dx = (xs - cx) / half_diag
    dy = (ys - cy) / half_diag
    return dx, dy, dx * dx + dy * dy, half_diag, cx, cy, hf, wf


def devignette(planes: torch.Tensor, k, extent=None,
               radius_scale=1.0) -> torch.Tensor:
    """Divide out the pa-model vignetting falloff. ``k`` = (k1, k2, k3);
    ``radius_scale`` maps image radii into the calibration frame
    (LensProfile.radius_scale)."""
    _, h, w = planes.shape
    dev = planes.device
    k = _f32(k, dev)
    _, _, r2, *_ = _radius2(h, w, dev, extent)
    r2 = r2 * _f32(radius_scale, dev) ** 2
    gain = 1.0 + r2 * (k[0] + r2 * (k[1] + r2 * k[2]))
    return planes / torch.clamp(gain, min=1e-4)


def bilinear_sample(plane: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor,
                    hf, wf) -> torch.Tensor:
    """Sample ``plane`` at float coordinates (bilinear, edge clamp);
    hf/wf bound the valid extent (true dims under bucket padding)."""
    # Near-integer stability: ops/geometry.snap_near_integer, the one home
    # of the fix for every bilinear warp sampler.
    from .geometry import snap_near_integer

    sx, sy = snap_near_integer(sx), snap_near_integer(sy)
    wi = int((wf - 1.0).to(torch.int32))
    hi = int((hf - 1.0).to(torch.int32))
    x0 = torch.clamp(torch.floor(sx).to(torch.int64), 0, wi)
    y0 = torch.clamp(torch.floor(sy).to(torch.int64), 0, hi)
    x1 = torch.clamp(x0 + 1, max=wi)
    y1 = torch.clamp(y0 + 1, max=hi)
    # Weights relative to the *clamped* corner: a coordinate an ulp below 0
    # must not interpolate a full step toward the next row/col.
    tx = torch.clamp(sx - x0.to(torch.float32), 0.0, 1.0)
    ty = torch.clamp(sy - y0.to(torch.float32), 0.0, 1.0)
    c00 = plane[y0, x0]
    c10 = plane[y0, x1]
    c01 = plane[y1, x0]
    c11 = plane[y1, x1]
    return (c00 * (1 - tx) + c10 * tx) * (1 - ty) + (
        c01 * (1 - tx) + c11 * tx
    ) * ty


def _remap_radial(plane: torch.Tensor, scale: torch.Tensor, geom) -> torch.Tensor:
    """Sample ``plane`` at radially scaled coordinates (bilinear, edge
    clamp). ``scale`` is the per-pixel ratio r_src / r_dst; geom is the
    _radius2 output tuple."""
    dx, dy, _, half_diag, cx, cy, hf, wf = geom
    sx = dx * scale * half_diag + cx
    sy = dy * scale * half_diag + cy
    return bilinear_sample(plane, sx, sy, hf, wf)


def _distortion_scale(r2: torch.Tensor, coeffs: torch.Tensor,
                      model: str) -> torch.Tensor:
    """Per-pixel r_src/r_dst ratio for a distortion model (lensfun math)."""
    if model == "poly3":
        return 1.0 - coeffs[0] + coeffs[0] * r2
    if model == "poly5":
        return 1.0 + r2 * (coeffs[0] + r2 * coeffs[1])
    if model == "ptlens":
        r = torch.sqrt(torch.clamp(r2, min=1e-20))
        a, b, c = coeffs[0], coeffs[1], coeffs[2]
        return a * r2 * r + b * r2 + c * r + (1.0 - a - b - c)
    raise ValueError(f"unknown distortion model {model!r}")


def correct_distortion(planes: torch.Tensor, coeffs, model: str = "poly3",
                       extent=None, radius_scale=1.0) -> torch.Tensor:
    """Geometric distortion correction: resample at the model's r_src.
    The model is evaluated at calibration-frame radii (r * radius_scale);
    the resulting r_src/r_dst ratio is normalization-invariant."""
    _, h, w = planes.shape
    dev = planes.device
    geom = _radius2(h, w, dev, extent)
    r2c = geom[2] * _f32(radius_scale, dev) ** 2
    scale = _distortion_scale(r2c, _f32(coeffs, dev), model)
    return torch.stack([_remap_radial(planes[i], scale, geom) for i in range(3)])


def _warp_grid(h: int, w: int, center, device, extent=None):
    """Shared DNG-warp coordinate setup: normalized center-relative grids
    (dx, dy), r^2, and the (cx, cy, mmax, hf, wf) frame — the coordinate
    model WarpRectilinear and WarpFisheye both use (dng_sdk
    dng_lens_correction: normalize by the max center-to-corner distance)."""
    hf, wf = _extent(h, w, extent, device)
    ys, xs = _iota(h, w, device)
    center = _f32(center, device)
    cx = center[0] * (wf - 1.0)
    cy = center[1] * (hf - 1.0)
    # Max distance from the optical center to any image corner.
    mx = torch.maximum(cx, (wf - 1.0) - cx)
    my = torch.maximum(cy, (hf - 1.0) - cy)
    mmax = torch.sqrt(mx * mx + my * my)
    dx = (xs - cx) / mmax
    dy = (ys - cy) / mmax
    r2 = dx * dx + dy * dy
    return dx, dy, r2, cx, cy, mmax, hf, wf


def warp_rectilinear(planes: torch.Tensor, coefs, center,
                     extent=None) -> torch.Tensor:
    """DNG WarpRectilinear (OpcodeList3 opcode 1) — the geometric
    distortion correction phone DNGs carry.

    ``coefs`` f32 [P, 6] with P in {1, 3} (shared or per-RGB-plane):
    kr0..kr3 radial, kt0/kt1 tangential. ``center`` f32 [2] = optical
    center in relative (x, y) image coordinates. Model (DNG 1.3 spec /
    dng_sdk dng_lens_correction convention): coordinates about the
    center, normalized by the maximum center-to-corner distance;
      f(r) = kr0 + kr1 r^2 + kr2 r^4 + kr3 r^6
      x_src = f x + kt0 (2 x y) + kt1 (r^2 + 2 x^2)
      y_src = f y + kt1 (2 x y) + kt0 (r^2 + 2 y^2)
    """
    _, h, w = planes.shape
    dev = planes.device
    dx, dy, r2, cx, cy, mmax, hf, wf = _warp_grid(h, w, center, dev, extent)
    coefs = _f32(coefs, dev)
    n_coef = coefs.shape[0]
    out = []
    for p in range(3):
        k = coefs[min(p, n_coef - 1)]
        fr = k[0] + r2 * (k[1] + r2 * (k[2] + r2 * k[3]))
        sx_n = fr * dx + k[4] * (2.0 * dx * dy) + k[5] * (r2 + 2.0 * dx * dx)
        sy_n = fr * dy + k[5] * (2.0 * dx * dy) + k[4] * (r2 + 2.0 * dy * dy)
        sx = sx_n * mmax + cx
        sy = sy_n * mmax + cy
        out.append(bilinear_sample(planes[p], sx, sy, hf, wf))
    return torch.stack(out)


def warp_fisheye(planes: torch.Tensor, coefs, center,
                 extent=None) -> torch.Tensor:
    """DNG WarpFisheye (OpcodeList3 opcode 2) — fisheye-to-rectilinear
    remapping.

    ``coefs`` f32 [P, 4] with P in {1, 3}: kr0..kr3 radial terms over
    theta. Same coordinate frame as WarpRectilinear; per the DNG 1.3
    spec / dng_sdk dng_warp_params_fisheye::EvaluateRatio, with r the
    normalized center distance and t = atan(r):
      r_src = t (kr0 + kr1 t^2 + kr2 t^4 + kr3 t^6)
      (x_src, y_src) = (dx, dy) * r_src / r     (ratio -> kr0 as r -> 0)
    """
    _, h, w = planes.shape
    dev = planes.device
    dx, dy, r2, cx, cy, mmax, hf, wf = _warp_grid(h, w, center, dev, extent)
    r = torch.sqrt(r2)
    t = torch.atan(r)
    t2 = t * t
    coefs = _f32(coefs, dev)
    n_coef = coefs.shape[0]
    out = []
    for p in range(3):
        k = coefs[min(p, n_coef - 1)]
        poly = k[0] + t2 * (k[1] + t2 * (k[2] + t2 * k[3]))
        # ratio = t*poly/r with the exact r->0 limit poly (t/r -> 1).
        ratio = torch.where(r > 1e-12, t * poly / torch.clamp(r, min=1e-12),
                            poly)
        sx = dx * ratio * mmax + cx
        sy = dy * ratio * mmax + cy
        out.append(bilinear_sample(planes[p], sx, sy, hf, wf))
    return torch.stack(out)


def vignette_radial_gain(h: int, w: int, k, center, extent=None,
                         device=None) -> torch.Tensor:
    """DNG FixVignetteRadial (OpcodeList3 opcode 3) gain surface, f32:
    gain = 1 + k0 r^2 + ... + k4 r^10 with r the distance from the optical
    center (relative [0,1] coordinates), normalized so the farthest corner
    has r = 1 (dng_sdk dng_vignette_radial_params). ``extent``: the true
    (h, w) when (h, w) is a bucket-padded grid, so the true region's gain
    matches an unpadded evaluation elementwise."""
    dev = torch.device("cpu") if device is None else device
    hf, wf = _extent(h, w, extent, dev)
    ys, xs = _iota(h, w, dev)
    center = _f32(center, dev)
    cy = center[1] * (hf - 1.0)
    cx = center[0] * (wf - 1.0)
    m2 = (torch.maximum(cy, (hf - 1.0) - cy) ** 2
          + torch.maximum(cx, (wf - 1.0) - cx) ** 2)
    dy = ys - cy
    dx = xs - cx
    r2 = (dy * dy + dx * dx) / torch.clamp(m2, min=1e-12)
    k = _f32(k, dev)
    # Horner in r2: 1 + r2(k0 + r2(k1 + r2(k2 + r2(k3 + r2 k4)))).
    g = k[4]
    for i in (3, 2, 1, 0):
        g = k[i] + r2 * g
    return 1.0 + r2 * g


def correct_tca(planes: torch.Tensor, vr, vb, extent=None) -> torch.Tensor:
    """Linear-model TCA: radially rescale R and B toward green."""
    _, h, w = planes.shape
    dev = planes.device
    geom = _radius2(h, w, dev, extent)
    ones = torch.ones((h, w), dtype=torch.float32, device=dev)
    r_fix = _remap_radial(planes[0], ones * _f32(vr, dev), geom)
    b_fix = _remap_radial(planes[2], ones * _f32(vb, dev), geom)
    return torch.stack([r_fix, planes[1], b_fix])


def correct_tca_distortion(planes: torch.Tensor, coeffs, vr, vb,
                           model: str = "poly3", extent=None,
                           radius_scale=1.0) -> torch.Tensor:
    """TCA + distortion as ONE composed remap per channel: both are radial
    scales about the same center, so r_src = r * s_dist(r) * v_channel
    (one bilinear gather per channel, no bilinear-of-bilinear softening —
    the single composed remap of lensfunpy's
    apply_subpixel_geometry_distortion, editor.py:620-650)."""
    _, h, w = planes.shape
    dev = planes.device
    geom = _radius2(h, w, dev, extent)
    r2c = geom[2] * _f32(radius_scale, dev) ** 2
    scale = _distortion_scale(r2c, _f32(coeffs, dev), model)
    return torch.stack([
        _remap_radial(planes[0], scale * _f32(vr, dev), geom),
        _remap_radial(planes[1], scale, geom),
        _remap_radial(planes[2], scale * _f32(vb, dev), geom),
    ])


def apply_profile(planes: torch.Tensor, profile: LensProfile,
                  extent=None) -> torch.Tensor:
    """Full correction chain (lensfun order: devignette -> TCA ->
    distortion, editor.py:425-711). TCA and distortion fuse into one
    composed remap when both are present."""
    rs = getattr(profile, "radius_scale", 1.0) or 1.0
    if profile.vignetting is not None:
        planes = devignette(planes, profile.vignetting, extent, radius_scale=rs)
    if profile.tca is not None and profile.distortion is not None:
        return correct_tca_distortion(
            planes, profile.distortion, profile.tca[0], profile.tca[1],
            model=profile.distortion_model, extent=extent, radius_scale=rs)
    if profile.tca is not None:
        planes = correct_tca(planes, profile.tca[0], profile.tca[1], extent)
    if profile.distortion is not None:
        planes = correct_distortion(
            planes, profile.distortion, model=profile.distortion_model,
            extent=extent, radius_scale=rs)
    return planes
