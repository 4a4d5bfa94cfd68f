"""Mask generation and refinement tools, on torch tensors.

The JAX package's ``ops/masking.py`` (the reference's masking surface:
SAM2 point-prompted masks, python-legacy editor.py:1120-1159; threshold
binarization, lib.rs:481-499):

* ``similarity_mask`` / ``similarity_mask_points`` — point-prompted
  selection by OKLab colour distance to the sampled colour, with an
  optional spatial falloff; soft logits (>= 0 selected, like SAM logits);
* ``combine_labeled_logits`` — include/exclude labelled prompts;
* ``geodesic_distance`` / ``smart_select_mask`` / ``smart_select_points``
  — object selection by an edge-aware geodesic flood: alternating
  directional sweeps (``kernels/geodesic``: the hand-written sweep kernel
  on the card, its torch twin on the CPU), so the selection stops at
  contrast boundaries;
* ``feather_mask``, ``luminance_range_mask``, ``mask_overlay``.

Divisions by a scalar go through ``core/numerics.div`` (one correctly
rounded f32 division on every device, as the JAX package divides).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import color
from ..core.numerics import div
from ..kernels import geodesic
from .sharpen import gaussian_blur

# The flood's distance outside the seeds.
BIG = 1e9


def _oklab(planes):
    """Linear RGB planes -> OKLab (L, a, b) — cartesian, not LCh."""
    return color.linear_srgb_to_oklab(planes[0], planes[1], planes[2])


def _f32(v) -> float:
    return float(np.float32(v))


def _pixels(points_yx, h: int, w: int) -> np.ndarray:
    """Prompt pixels as int64 [N, 2] (y, x), each inside the h x w frame (a
    torch index would wrap a negative one and raise past the edge)."""
    pts = np.asarray(points_yx, dtype=np.int64).reshape(-1, 2)
    if not ((pts >= 0) & (pts < (h, w))).all():
        raise ValueError(f"prompt pixels {pts.tolist()} outside the {h}x{w} frame")
    return pts


def similarity_mask(planes: torch.Tensor, point_yx, color_tolerance: float,
                    spatial_sigma: float, spatial_falloff: bool = True
                    ) -> torch.Tensor:
    """Point-prompted selection logits from colour similarity.

    ``planes`` linear RGB [3, H, W]; ``point_yx`` the prompt pixel (y, x);
    ``color_tolerance`` the OKLab distance at which the logit crosses zero;
    ``spatial_sigma`` the Gaussian falloff radius in pixels (only with
    ``spatial_falloff``). Returns f32 [H, W] logits in [-1, 1]."""
    _, h, w = planes.shape
    (py, px), = _pixels(point_yx, h, w).tolist()
    L, A, B = _oklab(planes)
    dist = torch.sqrt((L - L[py, px]) ** 2 + (A - A[py, px]) ** 2
                      + (B - B[py, px]) ** 2)
    logits = 1.0 - div(dist, max(_f32(color_tolerance), _f32(1e-6)))
    if spatial_falloff:
        dev = planes.device
        ys = (torch.arange(h, dtype=torch.int32, device=dev) - py).to(torch.float32)
        xs = (torch.arange(w, dtype=torch.int32, device=dev) - px).to(torch.float32)
        d2 = (ys ** 2)[:, None] + (xs ** 2)[None, :]
        s = np.float32(max(_f32(spatial_sigma), 1.0))
        spatial = torch.exp(div(-0.5 * d2, float(s * s)))
        logits = logits * spatial - (1.0 - spatial)
    return torch.clamp(logits, -1.0, 1.0)


def combine_labeled_logits(stack: torch.Tensor, labels) -> torch.Tensor:
    """Combine per-point logits ``stack`` f32 [N, H, W] under ``labels`` [N]
    (1 include, 0 exclude; python-legacy editor.py:1147-1152). Includes
    reduce by max; a pixel that matches an exclude point at least as
    strongly as any include is carved out to min(s_inc, -s_exc). With no
    exclude points this is exactly the include max."""
    lab = (torch.as_tensor(labels).reshape(-1, 1, 1) > 0).to(stack.device)
    neg = torch.full((), -2.0, dtype=stack.dtype, device=stack.device)
    s_inc = torch.where(lab, stack, neg).amax(0)
    s_exc = torch.where(lab, neg, stack).amax(0)
    return torch.where(s_exc >= s_inc, torch.minimum(s_inc, -s_exc), s_inc)


def similarity_mask_points(planes: torch.Tensor, points_yx, labels,
                           color_tolerance: float, spatial_sigma: float,
                           spatial_falloff: bool = True) -> torch.Tensor:
    """Labelled multi-point similarity selection: ``points_yx`` [(y, x),
    ...], each point's ``similarity_mask`` combined under
    ``combine_labeled_logits``."""
    stack = torch.stack([
        similarity_mask(planes, p, color_tolerance, spatial_sigma,
                        spatial_falloff=spatial_falloff)
        for p in np.asarray(points_yx).reshape(-1, 2)])
    return combine_labeled_logits(stack, labels)


def step_costs(planes: torch.Tensor, edge_weight: float, spatial_cost: float):
    """The flood's step costs ``||OKLab(p) - OKLab(q)|| * edge_weight +
    spatial_cost`` between vertical neighbours (gv f32 [H-1, W]) and
    horizontal ones (gh f32 [H, W-1]), each a view whose rows lie
    ``kernels/geodesic.pitch(W)`` floats apart (the flood kernel's layout)."""
    L, A, B = _oklab(planes)
    ew, sc = _f32(edge_weight), _f32(spatial_cost)

    def grad_cost(dim):
        dl, da, db = (torch.diff(c, dim=dim) for c in (L, A, B))
        g = torch.sqrt(dl * dl + da * da + db * db) * ew
        # Rows geodesic.pitch(W) floats apart, as the flood kernel takes them.
        out = geodesic.pitched_empty(*g.shape, planes.device, planes.shape[-1])
        return torch.add(g, sc, out=out)

    return grad_cost(0), grad_cost(1)


def geodesic_distance(planes: torch.Tensor, point_yx, edge_weight: float,
                      spatial_cost: float, sweeps: int = 4) -> torch.Tensor:
    """Edge-aware geodesic distance from a seed pixel ``(y, x)`` or a seed
    set [(y, x), ...] (multi-seed distance is the min over the seeds).

    4-connected grid, per-step cost ``step_costs``; ``sweeps`` rounds of
    down/right/up/left relaxations (Toivanen-style distance transform):
    paths with at most 2 * sweeps direction changes are exact, and the
    result converges to the Dijkstra solution as sweeps grow."""
    _, h, w = planes.shape
    gv, gh = step_costs(planes, edge_weight, spatial_cost)
    d = geodesic.pitched_empty(h, w, planes.device).fill_(BIG)
    for y, x in _pixels(point_yx, h, w).tolist():
        d[y, x] = 0.0
    return geodesic.flood(d, gv, gh, sweeps)


def smart_select_mask(planes: torch.Tensor, point_yx, tolerance: float = 0.15,
                      edge_weight: float = 12.0, spatial_cost: float = 0.002,
                      sweeps: int = 4) -> torch.Tensor:
    """Point-prompted object selection: the geodesic flood grows from the
    prompt until accumulated OKLab contrast exceeds ``tolerance``. Unlike
    ``similarity_mask`` it respects connectivity. Logits in [-1, 1]."""
    d = geodesic_distance(planes, point_yx, edge_weight, spatial_cost,
                          sweeps=sweeps)
    return torch.clamp(1.0 - div(d, _f32(max(tolerance, 1e-6))), -1.0, 1.0)


def smart_select_points(planes: torch.Tensor, include_yx, exclude_yx=None,
                        tolerance: float = 0.15, edge_weight: float = 12.0,
                        spatial_cost: float = 0.002, sweeps: int = 4
                        ) -> torch.Tensor:
    """Labelled multi-point object selection: one flood from every include
    seed at once; exclude seeds run their own flood, and pixels
    geodesically at least as close to an exclude seed are carved out (the
    rule of ``combine_labeled_logits``). A single include point reproduces
    ``smart_select_mask``."""
    kw = dict(tolerance=tolerance, edge_weight=edge_weight,
              spatial_cost=spatial_cost, sweeps=sweeps)
    li = smart_select_mask(planes, np.asarray(include_yx).reshape(-1, 2), **kw)
    if exclude_yx is None or len(exclude_yx) == 0:
        return li
    le = smart_select_mask(planes, np.asarray(exclude_yx).reshape(-1, 2), **kw)
    return torch.where(le >= li, torch.minimum(li, -le), li)


def feather_mask(mask: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """Soften mask edges with a Gaussian (applied before binarization)."""
    return gaussian_blur(mask[None], sigma=max(radius / 2.0, 0.5),
                         radius=radius)[0]


def luminance_range_mask(planes: torch.Tensor, lo: float, hi: float,
                         softness: float = 0.05) -> torch.Tensor:
    """Select by linear luminance band [lo, hi] with soft shoulders —
    logits >= 0 inside the band."""
    y = color.luma(planes[0], planes[1], planes[2])
    s = np.float32(max(softness, 1e-6))
    rise = div(y - float(np.float32(lo) - s), float(s))
    fall = div(float(np.float32(hi) + s) - y, float(s))
    return torch.clamp(torch.minimum(rise, fall) - 1.0, -1.0, 1.0)


def mask_overlay(srgb_planes: torch.Tensor, mask01: torch.Tensor,
                 tint=(1.0, 0.2, 0.2), alpha: float = 0.5) -> torch.Tensor:
    """Tint a binarized mask over an sRGB render (get_mask_image analog,
    editor.py:1173-1189)."""
    m = mask01 * alpha
    return torch.stack([srgb_planes[c] * (1.0 - m) + float(np.float32(tint[c])) * m
                        for c in range(3)])
