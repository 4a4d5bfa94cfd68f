"""Polynomial/iterative math shared by the develop kernel and its twin.

The JAX package needed these because Mosaic has no atan2/sin/cos lowering;
the port keeps the SAME polynomials so its kernel computes what the Pallas
kernel computes (``csrc/ktrig.cuh`` holds them as ``__device__``
functions, constant for constant and operation for operation). Inputs and
outputs are *turns* in [0, 1), the hue encoding of wgpu_shader.wgsl:72-74.

``srgb_oetf`` is the sRGB OETF of both CUDA kernels' edit stack and of its
plain twin (``kernels/fused.edit_stack``): x^(1/2.4) as exp2(log2(x)/2.4),
which on the H100 takes less time than CUDA's exact ``powf``. The OKLab
cube root stays ``torch.pow`` (``core/color``), as in the exact-LUT anchor.

``cbrt_fast`` and ``linear_to_srgb_fast`` (exponent bit-hack seed plus two
Halley steps; x^(1/2.4) = cbrt(sqrt(sqrt(x^5)))) are kept for the accuracy
test only: in the develop kernel on the H100 they took more time than
``powf`` (measurements in PERF.md, section 6), and the cube root's last ulp,
unlike ``pow``'s, gives an exactly gray pixel another hue than the
anchor's.
"""

from __future__ import annotations

import torch

_TWO_PI = 6.28318530718
_PI = 3.14159265359
_HALF_PI = 1.5707963267948966
_QUARTER_PI = 0.7853981633974483
_TAN_PI_8 = 0.41421356237309503


def _atan_unit(t):
    """atan(t) for t in [0, 1], Cephes atanf reduction + odd polynomial."""
    hi = t > _TAN_PI_8
    tr = torch.where(hi, (t - 1.0) / (t + 1.0), t)
    s = tr * tr
    p = ((8.05374449538e-2 * s - 1.38776856032e-1) * s + 1.99777106478e-1) * s \
        - 3.33329491539e-1
    r = tr + tr * s * p
    return torch.where(hi, r + _QUARTER_PI, r)


def atan2_turns(y, x):
    """atan2(y, x) / 2pi wrapped into [0, 1) without a hardware atan2."""
    ax = torch.abs(x)
    ay = torch.abs(y)
    hi = torch.maximum(ax, ay)
    lo = torch.minimum(ax, ay)
    t = lo / torch.clamp(hi, min=1e-30)
    r = _atan_unit(t)
    r = torch.where(ay > ax, _HALF_PI - r, r)
    r = torch.where(x < 0.0, _PI - r, r)
    r = torch.where(y < 0.0, -r, r)
    h = r * (1.0 / _TWO_PI)
    return torch.where(h < 0.0, h + 1.0, h)


def cbrt_fast(x):
    """max(x, 0)^(1/3): bit-hack exponent seed + two Halley iterations."""
    # abs() after the clamp: a kept -0.0 sign bit would turn the seed
    # into a NaN pattern.
    x = torch.abs(torch.clamp(x, min=0.0))
    i = x.view(torch.int32)
    y = (torch.div(i, 3, rounding_mode="floor") + 709921077).to(
        torch.int32).view(torch.float32)
    for _ in range(2):
        y3 = y * y * y
        # Guard must be a NORMAL float (1e-38 flushes to zero on FTZ).
        y = y * (y3 + 2.0 * x) / (2.0 * y3 + x + 1e-30)
    return y


def linear_to_srgb_fast(c):
    """The sRGB OETF with x^(1/2.4) = cbrt(sqrt(sqrt(x^5)))."""
    x = torch.clamp(c, min=0.0)
    x5 = x * x
    x5 = x5 * x5 * x
    root = cbrt_fast(torch.sqrt(torch.sqrt(x5)))
    return torch.where(c <= 0.0031308, c * 12.92, 1.055 * root - 0.055)


def srgb_oetf(c):
    """The sRGB OETF of the CUDA kernels' edit stack (wgpu_shader.wgsl:
    95-103), unclamped: x^(1/2.4) as exp2(log2(x) / 2.4). On the card
    torch's exp2 and log2 are the kernel's exp2f and log2f, so the twin
    rounds as the kernel does; within a few ulps of ``torch.pow``."""
    root = torch.exp2(torch.log2(torch.clamp(c, min=0.0)) * (1.0 / 2.4))
    return torch.where(c <= 0.0031308, c * 12.92, 1.055 * root - 0.055)


def sincos_turns(h):
    """(sin, cos) of 2*pi*h for h in [0, 1).

    Reduction: k = floor(2h + 1/2) in {0, 1, 2}; u = h - k/2 in
    [-1/4, 1/4]; sin(2*pi*h) = (-1)^k sin(2*pi*u), likewise cos.
    """
    k = torch.floor(2.0 * h + 0.5)
    u = h - 0.5 * k
    sign = 1.0 - 2.0 * (k - 2.0 * torch.floor(0.5 * k))
    z = u * _TWO_PI
    z2 = z * z
    sin_p = z * (1.0 + z2 * (-1.6666667163e-1 + z2 * (8.3333337680e-3
            + z2 * (-1.9841270114e-4 + z2 * (2.7557314297e-6
            + z2 * -2.5050759689e-8)))))
    cos_p = 1.0 + z2 * (-0.5 + z2 * (4.1666667908e-2 + z2 * (-1.3888889225e-3
            + z2 * (2.4801587642e-5 + z2 * (-2.7557314297e-7
            + z2 * 2.0875723372e-9)))))
    return sign * sin_p, sign * cos_p
