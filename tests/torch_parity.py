"""Shared helpers of the port's parity tests (tests/test_torch_*.py)."""

import numpy as np

from conftest import random_linear_image
from test_develop import assert_close

from rawphotoforge_tpu_torch.core.params import (
    BRIGHTNESS, HUE, LIGHTNESS, SATURATION, EditParameters)


def full_stack_edit():
    """Every slider family and all four curves on one mask (the Pallas
    tests' full-stack edit, test_pallas.py:40-48)."""
    p = EditParameters()
    p.set_tone(exposure=0.9, contrast=30, shadow=25, highlight=-15, black=8, white=-6)
    p.set_whitebalance(temperature=40, tint=-20)
    p.set_vignette(55)
    p.set_curve(BRIGHTNESS, [0, 20000, 45000, 65535], [2000, 28000, 43000, 65535])
    p.set_curve(HUE, [0, 30000, 65535], [8000, 35000, 62000])
    p.set_curve(SATURATION, [0, 40000, 65535], [36000, 28000, 36000])
    p.set_curve(LIGHTNESS, [0, 65535], [30000, 36000])
    return p


def nongray_image(rng, h=48, w=160):
    """random_linear_image with its black and white corner blocks tinted.

    An exactly gray pixel has OKLab a = b = 0 up to f32 noise, so its hue
    (and the hue-indexed hue/sat/light curves) is decided by the last ulp
    of a and b — which XLA and torch round differently (XLA contracts
    multiply-adds). The tinted corners keep their clamping role (values at
    0 and above 1) without the undefined hue."""
    img = random_linear_image(rng, h, w)
    img[:4, :4] = (0.0, 0.004, 0.011)
    img[-4:, -4:] = (1.0, 1.3, 0.93)
    return img


def assert_close_across(ours, ref, max_gray=3e-2, **kw):
    """assert_close for a port render against a JAX render (HWC).

    Pixels the tone stage clamps to exact gray (all channels 0) have no
    hue either, and the hue-indexed lightness curve then scales them by an
    ulp-decided gain in each framework. Pixels that are gray in BOTH
    renders but at different levels are left out of the comparison; there
    must be few of them (``max_gray``: a +50 contrast on half the pixels
    of the random test image clamps ~1% of them to black), and every other
    pixel meets assert_close. (Eager JAX rounds a gray pixel's a and b
    exactly as torch does; jit-fused XLA does not.)"""
    ours = np.asarray(ours, np.float64)
    ref = np.asarray(ref, np.float64)
    gray = (np.ptp(ours, axis=-1) < 1e-6) & (np.ptp(ref, axis=-1) < 1e-6)
    undefined = gray & (np.abs(ours - ref).max(axis=-1) > 1e-4)
    assert undefined.mean() <= max_gray, (
        f"{100 * undefined.mean():.2f}% gray pixels at different levels")
    assert_close(ours[~undefined][:, None], ref[~undefined][:, None], **kw)
