"""v1-style tone LUT builder: slider params -> one 65536-entry tone curve.

The JAX package's ``core/tonelut.py`` (the Python generation's tone model,
python-legacy/raw_image_editor/editor.py:715-778
``_create_tone_lut_from_params``): exposure + a 7-point PCHIP tone curve +
contrast baked into a LUT over input luminance,

  x -> clip(x * 2^EV) -> PCHIP through (0, p5, p25, p50, p75, p95, 1) with
  black/shadow/highlight/white moving the control-point *outputs* ->
  contrast around 0.5 -> clip -> u16 domain.

Feed it to ``EditParameters.set_curve(BRIGHTNESS, raw_lut=...)`` to
reproduce the v1 pipeline in the current engine. Host numpy; scipy is
imported inside the function.
"""

from __future__ import annotations

import numpy as np

from .curve import CURVE_RESOLUTION

P5, P25, P50, P75, P95 = 0.05, 0.25, 0.50, 0.75, 0.95


def tone_lut_from_params(exposure: float = 0.0, contrast: int = 0,
                         shadow: int = 0, highlight: int = 0, black: int = 0,
                         white: int = 0, dtype=np.float32) -> np.ndarray:
    """Build the v1 tone LUT; float values in [0, 65535]. Each slider moves
    its percentile's output toward the midtone (or the p95 point for
    white), editor.py:755-762."""
    from scipy import interpolate

    x = np.linspace(0.0, 1.0, CURVE_RESOLUTION, dtype=np.float32)
    x_ev = np.clip(x * (2.0 ** exposure), 0.0, 1.0)

    black_l = P5 + (P50 - P5) * (black / 100.0)
    shadow_l = P25 + (P50 - P25) * (shadow / 100.0)
    highlight_l = P75 + (P95 - P75) * (highlight / 100.0)
    white_l = P95 + (P95 - P50) * (white / 100.0)

    xs = np.array([0.0, P5, P25, P50, P75, P95, 1.0], dtype=np.float32)
    ys = np.clip(np.array([0.0, black_l, shadow_l, P50, highlight_l, white_l,
                           1.0], dtype=np.float32), 0.0, 1.0)
    mapped = interpolate.PchipInterpolator(xs, ys)(x_ev)

    c = 1.0 + contrast / 100.0
    contrasted = 0.5 + (mapped - 0.5) * c
    return (np.clip(contrasted, 0.0, 1.0) * 65535.0).astype(dtype)


def tone_lut_i32(**kwargs) -> np.ndarray:
    """Integer LUT ready for EditParameters.set_curve(raw_lut=...)."""
    return tone_lut_from_params(**kwargs).astype(np.int32)
