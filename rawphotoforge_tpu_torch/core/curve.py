"""PCHIP curves and 65536-entry tone-curve LUTs (numpy, float32).

A copy of the JAX package's ``core/curve.py`` numerics, kept here so the
port imports nothing of that package. Numerical contract: the reference's
monotone-cubic-Hermite interpolation with harmonic-mean slopes and clamped
extrapolation, computed in float32 (rust/photo-editor/src/
interpolation.rs:11-123). Control points are i32 in the LUT domain
[0, 65535]; the LUT has 65536 entries; float results are truncated toward
zero on the i32 cast and clamped by the setters.

Two forms:

* ``build_lut`` — the exact 65536-entry i32 LUT, the semantics anchor of
  ``ops/develop.develop_post_geo``.
* ``pchip_coeffs`` — per-segment monomial coefficients padded to a static
  segment count, evaluated per pixel by the develop kernel
  (``kernels/fused``) by segment selection + Horner; ``eval_packed`` is
  that evaluation on torch tensors.

Every function here is bit-identical to its JAX-package twin (tested).
"""

from __future__ import annotations

import numpy as np
import torch

from .._errbase import PhotoEditorError

CURVE_RESOLUTION = 65536  # rust/photo-editor/src/lib.rs:17
MAX_CTRL = 32  # static padding bound for control points (UI uses <= ~16)


class CurveError(PhotoEditorError, ValueError):
    """Raised for invalid control points (mirrors InterpolationError,
    rust/photo-editor/src/errors.rs)."""


def pchip_slopes_f32(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Per-knot tangents, float32, harmonic-mean weighting.

    Contract: interpolation.rs:42-77. Endpoints use one-sided secants;
    interior knots use 0 where secants change sign, else the weighted
    harmonic mean with weights w1 = 2*h[i] + h[i-1], w2 = h[i] + 2*h[i-1].
    """
    x = np.asarray(x, dtype=np.float32)
    y = np.asarray(y, dtype=np.float32)
    if x.shape != y.shape:
        raise CurveError(f"mismatched control point lengths: {x.shape} vs {y.shape}")
    n = x.shape[0]
    if n < 2:
        raise CurveError(f"need at least 2 control points, got {n}")
    h = x[1:] - x[:-1]
    if np.any(h <= 0):
        raise CurveError("control point x values must be strictly increasing")
    delta = (y[1:] - y[:-1]) / h
    slopes = np.zeros(n, dtype=np.float32)
    slopes[0] = delta[0]
    slopes[-1] = delta[-1]
    if n > 2:
        d0 = delta[:-1]
        d1 = delta[1:]
        w1 = np.float32(2.0) * h[1:] + h[:-1]
        w2 = h[1:] + np.float32(2.0) * h[:-1]
        with np.errstate(divide="ignore", invalid="ignore"):
            harm = (w1 + w2) / (w1 / d0 + w2 / d1)
        slopes[1:-1] = np.where(d0 * d1 <= 0.0, np.float32(0.0), harm)
    return slopes


def pchip_eval_f32(x: np.ndarray, y: np.ndarray, x_eval: np.ndarray) -> np.ndarray:
    """Vectorized float32 PCHIP evaluation (Hermite basis form).

    Mirror of interpolation.rs:80-120: clamp outside [x0, xn-1],
    binary-search the segment, evaluate h00*y0 + h10*h*m0 + h01*y1 + h11*h*m1.
    """
    x = np.asarray(x, dtype=np.float32)
    y = np.asarray(y, dtype=np.float32)
    xe = np.asarray(x_eval, dtype=np.float32)
    slopes = pchip_slopes_f32(x, y)
    n = x.shape[0]
    h = x[1:] - x[:-1]

    i = np.searchsorted(x, xe, side="right") - 1
    i = np.clip(i, 0, n - 2)

    hv = h[i]
    t = ((xe - x[i]) / hv).astype(np.float32)
    t2 = t * t
    t3 = t2 * t
    h00 = np.float32(2.0) * t3 - np.float32(3.0) * t2 + np.float32(1.0)
    h10 = t3 - np.float32(2.0) * t2 + t
    h01 = np.float32(-2.0) * t3 + np.float32(3.0) * t2
    h11 = t3 - t2
    out = h00 * y[i] + h10 * hv * slopes[i] + h01 * y[i + 1] + h11 * hv * slopes[i + 1]
    out = out.astype(np.float32)
    # Clamped extrapolation (interpolation.rs:82-89).
    out = np.where(xe <= x[0], y[0], out)
    out = np.where(xe >= x[-1], y[-1], out)
    return out.astype(np.float32)


def build_lut(
    control_x: np.ndarray,
    control_y: np.ndarray,
    lo: int = 0,
    hi: int = CURVE_RESOLUTION - 1,
) -> np.ndarray:
    """Expand i32 control points into the 65536-entry i32 LUT.

    Matches PhotoEditor::set_*_curve (lib.rs:300-479): evaluate the f32 PCHIP
    at integer indices 0..65535, truncate toward zero to i32, clamp to
    [lo, hi].
    """
    cx = np.asarray(control_x)
    cy = np.asarray(control_y)
    if cx.size == 0:
        raise CurveError("empty control points")
    xe = np.arange(CURVE_RESOLUTION, dtype=np.float32)
    vals = pchip_eval_f32(cx, cy, xe)
    # Rust `f32 as i32` truncates toward zero and saturates.
    return np.clip(np.trunc(vals), lo, hi).astype(np.int32)


def identity_lut() -> np.ndarray:
    """Default brightness/hue curve: lut[i] = i (lib.rs:58-59)."""
    return np.arange(CURVE_RESOLUTION, dtype=np.int32)


def constant_lut(value: int = 32767) -> np.ndarray:
    """Default saturation/lightness curve: constant 32767 (lib.rs:60-61)."""
    return np.full(CURVE_RESOLUTION, value, dtype=np.int32)


# The default curves' control points: the identity (brightness, hue) and
# the constant 32767 gain (saturation, lightness).
IDENTITY_POINTS = (
    np.array([0, CURVE_RESOLUTION - 1], dtype=np.int32),
    np.array([0, CURVE_RESOLUTION - 1], dtype=np.int32),
)
CONSTANT_POINTS = (
    np.array([0, CURVE_RESOLUTION - 1], dtype=np.int32),
    np.array([32767, 32767], dtype=np.int32),
)


def pchip_coeffs(
    control_x: np.ndarray,
    control_y: np.ndarray,
    max_ctrl: int = MAX_CTRL,
) -> tuple[np.ndarray, np.ndarray]:
    """Pack a PCHIP curve into static-shape (breaks, coeffs) for in-kernel eval.

    Returns:
      breaks:  float32 [max_ctrl]  — knot x positions; padded with 2*65536 so
               padded knots are never selected (inputs are <= 65535).
      coeffs:  float32 [max_ctrl, 4] — per-segment monomial coefficients
               (a, b, c, d) of y = a + b*dt + c*dt^2 + d*dt^3 with
               dt = u - breaks[i]. Row n_real-1 holds the constant y_last so
               u == x_last lands on the clamped value; remaining pad rows
               repeat that constant.
    """
    cx = np.asarray(control_x, dtype=np.float32)
    cy = np.asarray(control_y, dtype=np.float32)
    if cx.size == 1:
        cx = np.array([0.0, CURVE_RESOLUTION - 1], dtype=np.float32)
        cy = np.array([cy[0], cy[0]], dtype=np.float32)
    n = cx.shape[0]
    if n > max_ctrl:
        raise CurveError(f"too many control points: {n} > {max_ctrl}")
    slopes = pchip_slopes_f32(cx, cy)
    h = cx[1:] - cx[:-1]
    y0 = cy[:-1]
    y1 = cy[1:]
    m0 = slopes[:-1] * h
    m1 = slopes[1:] * h
    # Hermite -> monomial in t = dt/h:  y = y0 + m0*t + (-3y0 -2m0 +3y1 -m1)t^2
    #                                      + (2y0 + m0 - 2y1 + m1)t^3
    a = y0
    b = m0 / h
    c = (-3.0 * y0 - 2.0 * m0 + 3.0 * y1 - m1) / (h * h)
    d = (2.0 * y0 + m0 - 2.0 * y1 + m1) / (h * h * h)

    breaks = np.full(max_ctrl, 2.0 * CURVE_RESOLUTION, dtype=np.float32)
    coeffs = np.zeros((max_ctrl, 4), dtype=np.float32)
    breaks[:n] = cx
    coeffs[: n - 1, 0] = a
    coeffs[: n - 1, 1] = b
    coeffs[: n - 1, 2] = c
    coeffs[: n - 1, 3] = d
    # Clamp-above region and pad rows: constant y_last.
    coeffs[n - 1 :, 0] = cy[-1]
    return breaks, coeffs.astype(np.float32)


def lut_to_coeffs(lut: np.ndarray, max_ctrl: int = MAX_CTRL) -> tuple[np.ndarray, np.ndarray]:
    """Approximate an arbitrary 65536-entry LUT by a packed PCHIP curve
    sampled at ``max_ctrl`` evenly spaced knots. Exact reproduction of an
    arbitrary LUT needs the gather-based anchor path instead."""
    lut = np.asarray(lut)
    xs = np.linspace(0, CURVE_RESOLUTION - 1, max_ctrl).round().astype(np.int32)
    xs = np.unique(xs)
    return pchip_coeffs(xs, lut[xs], max_ctrl=max_ctrl)


def eval_packed(u: torch.Tensor, breaks: torch.Tensor,
                coeffs: torch.Tensor) -> torch.Tensor:
    """Branchless packed-PCHIP evaluation at LUT-domain positions ``u``
    (f32, [0, 65535]); ``breaks`` f32 [S] knot positions and ``coeffs`` f32
    [S, 4] monomial coefficients as ``pchip_coeffs`` pads them.

    Per element: segment index i = (#breaks <= u) - 1 clamped to [0, S-1]
    (row S-1 is the constant clamp row, so u >= x_last gives y_last), the
    segment's coefficients chosen by S selects, one Horner evaluation."""
    s = breaks.shape[0]
    u = torch.maximum(u, breaks[0])
    idx = torch.zeros(u.shape, dtype=torch.int32, device=u.device)
    for j in range(1, s):
        idx = idx + (u >= breaks[j]).to(torch.int32)
    idx = torch.clamp(idx, max=s - 1)
    x0 = torch.zeros_like(u)
    a, b, c, d = (torch.zeros_like(u) for _ in range(4))
    for j in range(s):
        sel = idx == j
        x0 = torch.where(sel, breaks[j], x0)
        a = torch.where(sel, coeffs[j, 0], a)
        b = torch.where(sel, coeffs[j, 1], b)
        c = torch.where(sel, coeffs[j, 2], c)
        d = torch.where(sel, coeffs[j, 3], d)
    dt = u - x0
    return a + dt * (b + dt * (c + dt * d))
