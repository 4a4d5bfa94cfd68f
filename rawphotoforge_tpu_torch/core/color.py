"""Color-space primitives on planar torch tensors.

Numerical contract: the WGSL kernel of the reference (sRGB EOTF/OETF at
wgpu_shader.wgsl:85-103, OKLab matrices at :40-62, OKLCH round trip at
:64-83), the same constants and operation order as the JAX package's
``core/color.py``. All functions take planar channel tuples ``(r, g, b)``
of identically shaped float32 tensors.
"""

from __future__ import annotations

import torch

from .numerics import div

TWO_PI = 6.28318530718  # 2 * 3.14159265359, matches the WGSL literal

# Rec.709 / sRGB luma weights (wgpu_shader.wgsl:218).
LUMA_R = 0.2126
LUMA_G = 0.7152
LUMA_B = 0.0722

# linear sRGB -> LMS (OKLab M1), row-major.
M1 = (
    (0.4122214708, 0.5363325363, 0.0514459929),
    (0.2119034982, 0.6806995451, 0.1073969566),
    (0.0883024619, 0.2817188376, 0.6299787005),
)

# LMS -> linear sRGB (OKLab M1^-1), row-major.
M1_INV = (
    (4.0767416621, -3.3077115913, 0.2309699292),
    (-1.2684380046, 2.6097574011, -0.3413193965),
    (-0.0041960863, -0.7034186147, 1.7076147010),
)

# cbrt(LMS) -> OKLab (M2), row-major.
M2 = (
    (0.2104542553, 0.7936177850, -0.0040720468),
    (1.9779984951, -2.4285922050, 0.4505937099),
    (0.0259040371, 0.7827717662, -0.8086757660),
)

# OKLab -> cbrt(LMS) (M2^-1), row-major.
M2_INV = (
    (1.0, 0.3963377774, 0.2158037573),
    (1.0, -0.1055613458, -0.0638541728),
    (1.0, -0.0894841775, -1.2914855480),
)


def _mat3_apply(m, a, b, c):
    """Row-major 3x3 matrix times planar vector, unrolled."""
    x = m[0][0] * a + m[0][1] * b + m[0][2] * c
    y = m[1][0] * a + m[1][1] * b + m[1][2] * c
    z = m[2][0] * a + m[2][1] * b + m[2][2] * c
    return x, y, z


def srgb_to_linear(c: torch.Tensor) -> torch.Tensor:
    """sRGB-encoded [0,1] -> linear-light. EOTF of wgpu_shader.wgsl:85-93."""
    return torch.where(
        c <= 0.04045,
        div(c, 12.92),
        torch.pow(div(c + 0.055, 1.055), 2.4),
    )


def linear_to_srgb(c: torch.Tensor) -> torch.Tensor:
    """Linear-light -> sRGB-encoded. OETF of wgpu_shader.wgsl:95-103, not
    clamped here (the shader clamps at store time, :336); negative inputs
    take the ``c <= 0.0031308`` linear branch."""
    return torch.where(
        c <= 0.0031308,
        c * 12.92,
        1.055 * torch.pow(torch.clamp(c, min=0.0), 1.0 / 2.4) - 0.055,
    )


def _atan2_turns(y, x):
    h = div(torch.atan2(y, x), TWO_PI)
    return torch.where(h < 0.0, h + 1.0, h)


def _sincos_turns(h):
    ang = h * TWO_PI
    return torch.sin(ang), torch.cos(ang)


def _cbrt(x):
    return torch.pow(torch.clamp(x, min=0.0), 1.0 / 3.0)


def linear_srgb_to_oklab(r, g, b, cbrt=_cbrt):
    """Planar linear sRGB -> cartesian OKLab (L, a, b); LMS is clamped at 0
    before the cube root (wgpu_shader.wgsl:64-72)."""
    l_, m_, s_ = _mat3_apply(M1, r, g, b)
    return _mat3_apply(M2, cbrt(l_), cbrt(m_), cbrt(s_))


def linear_srgb_to_oklch(r, g, b, atan2_turns=_atan2_turns, cbrt=_cbrt):
    """Planar linear sRGB -> (L, C, h) with h in turns [0, 1)
    (wgpu_shader.wgsl:64-75). ``atan2_turns`` is injectable: the develop
    kernel's plain twin passes the polynomial one from kernels/ktrig."""
    L, A, B = linear_srgb_to_oklab(r, g, b, cbrt=cbrt)
    C = torch.sqrt(A * A + B * B)
    return L, C, atan2_turns(B, A)


def oklch_to_linear_srgb(L, C, h, sincos_turns=_sincos_turns):
    """Planar (L, C, h-in-turns) -> linear sRGB (wgpu_shader.wgsl:77-84)."""
    sin_h, cos_h = sincos_turns(h)
    A = C * cos_h
    B = C * sin_h
    l_, m_, s_ = _mat3_apply(M2_INV, L, A, B)
    l_ = l_ * l_ * l_
    m_ = m_ * m_ * m_
    s_ = s_ * s_ * s_
    return _mat3_apply(M1_INV, l_, m_, s_)


def luma(r, g, b):
    """Rec.709 relative luminance of linear RGB (wgpu_shader.wgsl:218)."""
    return LUMA_R * r + LUMA_G * g + LUMA_B * b


def apply_gamma(x: torch.Tensor, gamma=(2.222, 4.5 / 255.0)) -> torch.Tensor:
    """v1's rawpy-style display gamma (python-legacy editor.py:47-76), as
    the JAX package's ``apply_gamma``: clip to [0, 1]; below
    ``threshold = (c/(g-1))**g`` the linear segment ``x * c/(g-1)``, above
    it ``(1+c) * x**(1/g) - c``, with the reference's quirk of dividing the
    slope argument by 255 once more (the default's effective c is
    4.5/255/255). Not used by the v4 develop contract (sRGB,
    ``linear_to_srgb``); kept for v1-workflow compatibility."""
    g, c = gamma
    c = c / 255.0
    x = torch.clamp(x, 0.0, 1.0)
    threshold = (c / (g - 1.0)) ** g
    return torch.where(
        x < threshold,
        x * (c / (g - 1.0)),
        (1.0 + c) * torch.pow(x, 1.0 / g) - c,
    ).to(torch.float32)
