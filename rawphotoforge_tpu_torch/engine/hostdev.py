"""Host-side develop: the anchor pipeline mirrored in numpy and C++ — the
JAX package's ``engine/hostdev.py``, as the port's own copy.

Lets the server render LIVE edits during the *instant era* of an async
open — while the device phase (upload, develop, the first renders) runs —
and render slider-drag (LOW) previews on the host from a once-fetched copy
of the LOW original (``app/server``), so the UI is interactive from t=0
like the reference (web/main.ts:652-695, wgpu_shader.wgsl:265-337). It
mirrors `ops.develop.develop_post_geo`
(vignette -> WB -> tone -> brightness LUT -> OKLCH hue/sat/light LUTs ->
sRGB) plus the editor's geometry stage (lens-distortion warp + unsharp)
for the MAIN mask only — the only mask that can exist during an open —
at the instant preview's resolution (~1 MPix: a few hundred ms of numpy,
zero device work).

``render_u8_hwc`` and the mask logits take the fused C++ path of the port's
native library (``native/rpf_native.cpp``, built at first use) unless the
caller passes ``native=False``: a failed build raises, there is no silent
numpy fallback (the numpy mirror is the test oracle).

Fidelity: identical formula sequences and the exact 65536-entry i32 LUT
gathers (`core.curve` builds LUTs host-side already); differences vs the
device anchor are f32 reassociation noise, gated in tests/test_hostdev.py
and tests/test_torch_hostdev.py.
The serving contract stays "approximate, explicitly marked": the source
pixels are the superpixel instant decode, not the real demosaic.
"""

from __future__ import annotations

import numpy as np

from ..core.color import (
    LUMA_B, LUMA_G, LUMA_R, M1, M1_INV, M2, M2_INV, TWO_PI,
)
from ..core.params import BRIGHTNESS, HUE, LIGHTNESS, SATURATION
# The device unsharp's tap builder is already pure numpy — import it
# rather than mirror it, so a change there can't silently drift the era
# render from the device render it stands in for.
from ..ops.sharpen import _gauss_taps as _gauss_taps_np
from .instant import linear_to_srgb_np

LUT_MAX = 65535.0

_f32 = np.float32


def _mat3_np(m, a, b, c):
    """3x3 color-matrix apply via one BLAS sgemm over [3, N].

    The naive broadcast form (9 muls + 6 adds as separate numpy ops)
    spends ~50 ms per call at era resolution in temporary churn — the
    profile's top cost. sgemm does it in one pass; accumulation-order
    differences vs the elementwise formula are f32 ulp noise, inside
    the anchor-vs-mirror gates (tests/test_hostdev.py)."""
    flat = np.empty((3, a.size), dtype=np.float32)
    flat[0], flat[1], flat[2] = a.ravel(), b.ravel(), c.ravel()
    out = np.asarray(m, dtype=np.float32) @ flat
    return (out[0].reshape(a.shape), out[1].reshape(a.shape),
            out[2].reshape(a.shape))


def _lut_fetch_np(lut_row: np.ndarray, v: np.ndarray) -> np.ndarray:
    """WGSL lut_fetch: u32(v * 65535) truncating index, table clamp."""
    idx = (v * _f32(LUT_MAX)).astype(np.int32)
    return np.clip(np.take(lut_row, idx), 0, 65535)


def warp_np(planes: np.ndarray, distortion: float) -> np.ndarray:
    """Radial lens-distortion resample (ops.geometry contract,
    wgpu_shader.wgsl:109-164) over [3, H, W]; OOB pixels go black."""
    if distortion == 0.0:
        return planes
    _, h, w = planes.shape
    strength = _f32(-0.5 * (distortion / 100.0))
    hf, wf = _f32(h), _f32(w)
    v = (np.arange(h, dtype=np.float32) / hf)[:, None]
    u = (np.arange(w, dtype=np.float32) / wf)[None, :]
    cu = (u - _f32(0.5)) * _f32(wf / hf)
    cv = v - _f32(0.5)
    r2 = cu * cu + cv * cv
    denom = _f32(1.0) + strength * r2
    fu = (cu / denom) / _f32(wf / hf) + _f32(0.5)
    fv = cv / denom + _f32(0.5)
    oob = (fu < 0.0) | (fu > 1.0) | (fv < 0.0) | (fv > 1.0)
    px = fu * (wf - 1.0)
    py = fv * (hf - 1.0)
    x0f = np.floor(px)
    y0f = np.floor(py)
    x0 = np.clip(x0f.astype(np.int32), 0, w - 1)
    y0 = np.clip(y0f.astype(np.int32), 0, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    tx = (px - x0f).astype(np.float32)
    ty = (py - y0f).astype(np.float32)
    out = np.empty_like(planes)
    for c in range(3):
        p = planes[c]
        top = p[y0, x0] * (1.0 - tx) + p[y0, x1] * tx
        bot = p[y1, x0] * (1.0 - tx) + p[y1, x1] * tx
        out[c] = np.where(oob, _f32(0.0), top * (1.0 - ty) + bot * ty)
    return out


def _blur_axis_np(x: np.ndarray, taps: np.ndarray, axis: int) -> np.ndarray:
    radius = (len(taps) - 1) // 2
    pad = [(0, 0)] * x.ndim
    pad[axis] = (radius, radius)
    mode = "reflect" if x.shape[axis] > radius else "edge"
    xp = np.pad(x, pad, mode=mode)
    out = np.zeros_like(x)
    n = x.shape[axis]
    sl = [slice(None)] * x.ndim
    for i, wgt in enumerate(taps):
        sl[axis] = slice(i, i + n)
        out += wgt * xp[tuple(sl)]
    return out


def unsharp_np(planes: np.ndarray, amount: float,
               sigma: float = 1.0, radius: int = 2) -> np.ndarray:
    """ops.sharpen.unsharp_mask mirror: x + amount * (x - gaussian(x))."""
    if amount == 0.0:
        return planes
    taps = _gauss_taps_np(sigma, radius)
    blur = _blur_axis_np(_blur_axis_np(planes, taps, 1), taps, 2)
    return np.maximum(planes + _f32(amount) * (planes - blur), 0.0)


def _tone_np(r, g, b, exposure, contrast, shadow, highlight, black, white):
    """ops.pointwise.tone mirror (wgpu_shader.wgsl:200-259); slider
    values already /100-scaled like the packed tone row."""
    mul = _f32(np.exp2(exposure))
    r, g, b = r * mul, g * mul, b * mul
    y = _f32(LUMA_R) * r + _f32(LUMA_G) * g + _f32(LUMA_B) * b

    sg = _f32(1.0) + _f32(shadow) * np.clip(_f32(1.0) - y, 0.0, 1.0)
    r, g, b = r * sg, g * sg, b * sg
    hg = _f32(1.0) + _f32(highlight) * np.clip(y, 0.0, 1.0)
    r, g, b = r * hg, g * hg, b * hg

    t = np.clip(y, 0.0, 1.0)
    if black != 0.0:
        lift = _f32(black) * ((_f32(1.0) - t) * (_f32(1.0) - t))
        r, g, b = r + lift, g + lift, b + lift
    if white != 0.0:
        lift = _f32(white) * (t * t)
        r, g, b = r + lift, g + lift, b + lift
    if contrast != 0.0:
        c = _f32(1.0 + contrast)
        r = (r - _f32(0.5)) * c + _f32(0.5)
        g = (g - _f32(0.5)) * c + _f32(0.5)
        b = (b - _f32(0.5)) * c + _f32(0.5)
    return (np.clip(r, 0.0, 1.0), np.clip(g, 0.0, 1.0),
            np.clip(b, 0.0, 1.0))


def _vignette_np(r, g, b, vignette_value):
    """ops.pointwise.vignette mirror (wgpu_shader.wgsl:166-178)."""
    strength = _f32((-vignette_value / 100.0) * 2.0)
    if strength == 0.0:
        return r, g, b
    h, w = r.shape
    cy = ((np.arange(h, dtype=np.float32) / _f32(h) - 0.5) * 1.5)[:, None]
    cx = ((np.arange(w, dtype=np.float32) / _f32(w) - 0.5) * 1.5)[None, :]
    dist = np.sqrt(cx * cx + cy * cy, dtype=np.float32)
    t = np.clip((dist - _f32(0.25)) / _f32(0.75), 0.0, 1.0)
    gain = np.clip(_f32(1.0) - strength * (t * np.sqrt(t)), 0.0, 4.0)
    return r * gain, g * gain, b * gain


def _oklch_from_linear(r, g, b):
    l_, m_, s_ = _mat3_np(M1, r, g, b)
    cbrt = lambda x: np.cbrt(np.maximum(x, 0.0), dtype=np.float32)  # noqa: E731
    L, A, B = _mat3_np(M2, cbrt(l_), cbrt(m_), cbrt(s_))
    C = np.sqrt(A * A + B * B, dtype=np.float32)
    H = np.arctan2(B, A, dtype=np.float32) / _f32(TWO_PI)
    H = np.where(H < 0.0, H + _f32(1.0), H)
    return L, C, H


def _linear_from_oklch(L, C, H):
    ang = H * _f32(TWO_PI)
    A = C * np.cos(ang, dtype=np.float32)
    B = C * np.sin(ang, dtype=np.float32)
    l_, m_, s_ = _mat3_np(M2_INV, L, A, B)
    return _mat3_np(M1_INV, l_ * l_ * l_, m_ * m_ * m_, s_ * s_ * s_)


def _linear_pass_np(r, g, b, params):
    """One mask's linear-RGB chain: WB -> tone -> brightness LUT with the
    v1 channel selector (the per-mask body of ops.develop's first loop)."""
    gains = params.gains()
    r, g, b = r * _f32(gains[0]), g * _f32(gains[1]), b * _f32(gains[2])
    r, g, b = _tone_np(
        r, g, b, float(params.exposure), params.contrast / 100.0,
        params.shadow / 100.0, params.highlight / 100.0,
        params.black / 100.0, params.white / 100.0,
    )
    if not params.curves[BRIGHTNESS].is_default(BRIGHTNESS) or \
            params.brightness_channel != 3:
        lut = params.curves[BRIGHTNESS].lut(BRIGHTNESS)
        ch = params.brightness_channel
        if ch in (0, 3):
            r = _lut_fetch_np(lut, r).astype(np.float32) / _f32(LUT_MAX)
        if ch in (1, 3):
            g = _lut_fetch_np(lut, g).astype(np.float32) / _f32(LUT_MAX)
        if ch in (2, 3):
            b = _lut_fetch_np(lut, b).astype(np.float32) / _f32(LUT_MAX)
    return r, g, b


def _geo_np(linear_planes: np.ndarray, main, native: bool = False) -> np.ndarray:
    """The era geometry stage shared by both develop paths: lens-
    distortion warp + unsharp over [3, H, W] (no-ops at default sliders).

    ``native=True`` routes through rpf_warp_f32/rpf_unsharp_f32 — pure
    IEEE f32 arithmetic in the numpy mirror's exact operation order, so
    the outputs are BIT-identical (asserted in tests/test_hostdev.py);
    it exists purely so sharpness/distortion drags during the era stay
    at fused-develop frame rates."""
    planes = np.asarray(linear_planes, dtype=np.float32)
    distortion = float(main.lens_distortion)
    amount = float(main.sharpness) / 100.0 * 2.0
    if native:
        from .. import native as _native

        if distortion != 0.0:
            planes = _native.warp_f32(
                planes, _f32(-0.5 * (distortion / 100.0)))
        if amount != 0.0:
            planes = _native.unsharp_f32(planes, _gauss_taps_np(1.0, 2),
                                         amount)
        return planes
    planes = warp_np(planes, distortion)
    return unsharp_np(planes, amount)


def develop_np(linear_planes: np.ndarray, params,
               masks: np.ndarray | None = None) -> np.ndarray:
    """Develop linear [3, H, W] f32 -> clipped sRGB f32.

    ``params`` is one core.params.EditParameters (main mask) or a list of
    them — one per mask, mask 0 = main; ``masks`` is f32 [M, H, W]
    binarized 0/1 (row 0, the all-ones main mask, is never read — the
    same elision the kernel applies). Order matches PhotoEditor.apply:
    warp -> unsharp -> vignette -> per-mask (WB -> tone -> brightness
    LUT) -> per-mask OKLCH LUTs -> sRGB encode; globals (warp, sharpen,
    vignette) come from main, like ops.develop.
    """
    plist = list(params) if isinstance(params, (list, tuple)) else [params]
    main = plist[0]
    planes = _geo_np(linear_planes, main)

    r, g, b = planes[0], planes[1], planes[2]
    r, g, b = _vignette_np(r, g, b, float(main.vignette))

    for k, p in enumerate(plist):
        rk, gk, bk = _linear_pass_np(r, g, b, p)
        if k == 0:
            r, g, b = rk, gk, bk
        else:
            sel = masks[k] == 1.0
            r = np.where(sel, rk, r)
            g = np.where(sel, gk, g)
            b = np.where(sel, bk, b)

    def oklch_default(p):
        return all(p.curves[slot].is_default(slot)
                   for slot in (HUE, SATURATION, LIGHTNESS))

    if not all(oklch_default(p) for p in plist):
        L, C, H = _oklch_from_linear(r, g, b)
        for k, p in enumerate(plist):
            if oklch_default(p):
                # Default curves are a near-identity staircase (the
                # identity_oklch shortcut, <= ~2e-3): skip this mask.
                continue
            h_idx = (H * _f32(LUT_MAX)).astype(np.int32)
            new_h = np.clip(np.take(p.curves[HUE].lut(HUE), h_idx),
                            0, 65535).astype(np.float32) / _f32(LUT_MAX)
            sat = np.clip(
                np.take(p.curves[SATURATION].lut(SATURATION), h_idx),
                0, 65535).astype(np.float32) / _f32(32767.5)
            light = np.clip(
                np.take(p.curves[LIGHTNESS].lut(LIGHTNESS), h_idx),
                0, 65535).astype(np.float32) / _f32(32767.5)
            if k == 0:
                H, C, L = new_h, C * sat, L * light
            else:
                sel = masks[k] == 1.0
                H = np.where(sel, new_h, H)
                C = np.where(sel, C * sat, C)
                L = np.where(sel, L * light, L)
        r, g, b = _linear_from_oklch(L, C, H)

    out = np.stack([linear_to_srgb_np(r), linear_to_srgb_np(g),
                    linear_to_srgb_np(b)])
    return np.clip(out, 0.0, 1.0)


_MATS39 = None


def _mats39() -> np.ndarray:
    """f32[39] color-matrix block for the native fused develop:
    M1, M2, M2_INV, M1_INV row-major + the Rec.709 luma weights."""
    global _MATS39
    if _MATS39 is None:
        _MATS39 = np.concatenate([
            np.asarray(M1, np.float32).ravel(),
            np.asarray(M2, np.float32).ravel(),
            np.asarray(M2_INV, np.float32).ravel(),
            np.asarray(M1_INV, np.float32).ravel(),
            np.asarray([LUMA_R, LUMA_G, LUMA_B], np.float32),
        ])
    return _MATS39


def _pack_native(plist):
    """(mrow, lut_idx, luts) for native.hostdev_develop.

    Mirrors develop_np's activation conditions exactly: a mask's
    brightness LUT row exists iff the curve is non-default OR the v1
    channel selector is set; its OKLCH rows exist iff any of
    hue/sat/light is non-default (the identity_oklch staircase shortcut
    otherwise). Scalars carry the same f32 pre-scaling develop_np
    applies (slider/100, exp2 of exposure, 1 + contrast)."""
    m = len(plist)
    mrow = np.zeros((m, 16), np.float32)
    lut_idx = np.full((m, 4), -1, np.int32)
    rows: list[np.ndarray] = []
    for k, p in enumerate(plist):
        mrow[k, 0:3] = p.gains()
        mrow[k, 3] = _f32(np.exp2(float(p.exposure)))
        mrow[k, 4] = _f32(p.contrast / 100.0)
        mrow[k, 5] = _f32(p.shadow / 100.0)
        mrow[k, 6] = _f32(p.highlight / 100.0)
        mrow[k, 7] = _f32(p.black / 100.0)
        mrow[k, 8] = _f32(p.white / 100.0)
        mrow[k, 11] = _f32(1.0 + p.contrast / 100.0)
        bright_active = (not p.curves[BRIGHTNESS].is_default(BRIGHTNESS)
                         or p.brightness_channel != 3)
        mrow[k, 9] = float(p.brightness_channel) if bright_active else -1.0
        if bright_active:
            lut_idx[k, 0] = len(rows)
            rows.append(p.curves[BRIGHTNESS].lut(BRIGHTNESS))
        if not all(p.curves[s].is_default(s)
                   for s in (HUE, SATURATION, LIGHTNESS)):
            for j, slot in enumerate((HUE, SATURATION, LIGHTNESS)):
                lut_idx[k, 1 + j] = len(rows)
                rows.append(p.curves[slot].lut(slot))
    luts = (np.ascontiguousarray(np.stack(rows), dtype=np.int32)
            if rows else np.zeros((0,), np.int32))
    return mrow, lut_idx, luts


def render_u8_hwc(linear_planes: np.ndarray, params,
                  masks: np.ndarray | None = None,
                  native: bool | None = None) -> np.ndarray:
    """develop -> truncating u8 HWC (the reference's `as u8` store,
    image.rs:375-383) — the era preview the server encodes to JPEG.

    ``native=None`` (the default) or True takes the fused single-pass C++
    path (~5x faster at era resolution; u8 output differs from the numpy
    mirror only by boundary-straddle flips of 1, gated in
    tests/test_hostdev.py), building the native library at the first call
    and raising ``native.NativeBuildError`` when it cannot; False runs the
    numpy mirror (the test oracle)."""
    plist = list(params) if isinstance(params, (list, tuple)) else [params]
    if native is None or native:
        from .. import native as _native

        planes = _geo_np(linear_planes, plist[0], native=True)
        mrow, lut_idx, luts = _pack_native(plist)
        return _native.hostdev_develop(
            planes, masks if len(plist) > 1 else None, mrow, lut_idx,
            luts, _mats39(),
            _f32((-float(plist[0].vignette) / 100.0) * 2.0))
    srgb = develop_np(linear_planes, plist, masks)
    u8 = (srgb * _f32(255.0)).astype(np.uint8)
    return np.ascontiguousarray(u8.transpose(1, 2, 0))


def _oklab_np(linear_planes: np.ndarray):
    p = np.asarray(linear_planes, dtype=np.float32)
    l_, m_, s_ = _mat3_np(M1, p[0], p[1], p[2])
    cbrt = lambda x: np.cbrt(np.maximum(x, 0.0), dtype=np.float32)  # noqa: E731
    return _mat3_np(M2, cbrt(l_), cbrt(m_), cbrt(s_))


def _mats18() -> np.ndarray:
    """f32[18] = M1, M2 row-major — the OKLab block the native selection
    mirrors take (same constants as _mats39's head)."""
    return _mats39()[:18]


def similarity_logits_np(linear_planes: np.ndarray,
                         point_yx: tuple[int, int],
                         color_tolerance: float,
                         spatial_sigma: float = 0.0,
                         native: bool | None = None) -> np.ndarray:
    """numpy mirror of ops.masking.similarity_mask: OKLab-distance logits
    around the prompted pixel's color, optional Gaussian spatial falloff
    — the era's host-side point-prompted selection. ``native=None`` or
    True takes the C++ mirror (~7x; deviations are cbrt ulp noise plus a
    separable-exp spatial term, gated in tests), False the numpy code."""
    if native is None or native:
        from .. import native as _native

        return _native.similarity_logits(
            linear_planes, point_yx, color_tolerance, spatial_sigma,
            _mats18())
    L, A, B = _oklab_np(linear_planes)
    y, x = int(point_yx[0]), int(point_yx[1])
    dist = np.sqrt((L - L[y, x]) ** 2 + (A - A[y, x]) ** 2
                   + (B - B[y, x]) ** 2, dtype=np.float32)
    logits = _f32(1.0) - dist / _f32(max(color_tolerance, 1e-6))
    if spatial_sigma > 0:
        h, w = logits.shape
        yy = (np.arange(h, dtype=np.float32) - _f32(y))[:, None]
        xx = (np.arange(w, dtype=np.float32) - _f32(x))[None, :]
        d2 = yy * yy + xx * xx
        # The device formula: blend toward -1 away from the point
        # (ops/masking.py: logits*spatial - (1 - spatial), sigma >= 1).
        spatial = np.exp(-_f32(0.5) * d2
                         / _f32(max(spatial_sigma, 1.0)) ** 2)
        logits = logits * spatial - (_f32(1.0) - spatial)
    return np.clip(logits, -1.0, 1.0).astype(np.float32)


def combine_labeled_logits_np(stack: np.ndarray,
                              labels: np.ndarray) -> np.ndarray:
    """numpy mirror of ops.masking.combine_labeled_logits (include max;
    exclude-dominant pixels carved to min(s_inc, -s_exc))."""
    lab = np.asarray(labels).reshape(-1, 1, 1) > 0
    neg = np.float32(-2.0)
    s_inc = np.max(np.where(lab, stack, neg), axis=0)
    s_exc = np.max(np.where(lab, neg, stack), axis=0)
    return np.where(s_exc >= s_inc, np.minimum(s_inc, -s_exc),
                    s_inc).astype(np.float32)


def similarity_logits_points_np(linear_planes: np.ndarray,
                                points_yx, labels,
                                color_tolerance: float,
                                spatial_sigma: float = 0.0,
                                native: bool | None = None) -> np.ndarray:
    """Labeled multi-point era selection: per-point similarity_logits_np
    combined under the include/exclude rule (the era half of
    ops.masking.similarity_mask_points)."""
    stack = np.stack([
        similarity_logits_np(linear_planes, p, color_tolerance,
                             spatial_sigma, native=native)
        for p in points_yx
    ])
    return combine_labeled_logits_np(stack, np.asarray(labels))


def smart_logits_points_np(linear_planes: np.ndarray,
                           include_yx, exclude_yx=None,
                           tolerance: float = 0.15,
                           edge_weight: float = 12.0,
                           spatial_cost: float = 0.002,
                           sweeps: int = 4,
                           native: bool | None = None) -> np.ndarray:
    """Labeled multi-point era object selection. Multi-seed geodesic
    distance = elementwise min over per-seed runs for the true distance;
    the sweep approximation composes the same way here (each seed's run
    uses the identical relaxation schedule), so the era stand-in stays
    within the usual approximation of the device's one multi-seed run."""
    def flood(pts):
        # max over per-seed clipped logits == logits of the min distance
        # (the clip is monotone in d), so seed-set composition is exact.
        ds = [smart_logits_np(linear_planes, p, tolerance, edge_weight,
                              spatial_cost, sweeps, native=native)
              for p in pts]
        return np.max(np.stack(ds), axis=0).astype(np.float32)

    li = flood(include_yx)
    if not exclude_yx:
        return li
    le = flood(exclude_yx)
    return np.where(le >= li, np.minimum(li, -le), li).astype(np.float32)


def _sweep_down_np(d: np.ndarray, step_cost: np.ndarray) -> np.ndarray:
    """In-place top->bottom relaxation: d[y] = min(d[y], d[y-1] + cost[y])
    — the numpy mirror of ops.masking._sweep_down (the in-place update
    reads the just-relaxed previous row, exactly like the scan carry)."""
    for y in range(1, d.shape[0]):
        np.minimum(d[y], d[y - 1] + step_cost[y], out=d[y])
    return d


def geodesic_distance_np(linear_planes: np.ndarray,
                         point_yx: tuple[int, int],
                         edge_weight: float, spatial_cost: float,
                         sweeps: int = 4) -> np.ndarray:
    """numpy mirror of ops.masking.geodesic_distance: Toivanen-style
    alternating raster sweeps of the edge-aware distance transform."""
    L, A, B = _oklab_np(linear_planes)
    h, w = L.shape

    def grad_cost(axis):
        dl = np.diff(L, axis=axis)
        da = np.diff(A, axis=axis)
        db = np.diff(B, axis=axis)
        g = (np.sqrt(dl * dl + da * da + db * db, dtype=np.float32)
             * _f32(edge_weight) + _f32(spatial_cost))
        pad_fwd = [(0, 0), (0, 0)]
        pad_fwd[axis] = (1, 0)
        pad_bwd = [(0, 0), (0, 0)]
        pad_bwd[axis] = (0, 1)
        return np.pad(g, pad_fwd), np.pad(g, pad_bwd)

    cost_down, cost_up = grad_cost(0)
    cost_right, cost_left = grad_cost(1)
    # Contiguous pre-oriented copies (the device hoists its flips too).
    cost_up_f = np.ascontiguousarray(cost_up[::-1])
    cost_right_t = np.ascontiguousarray(cost_right.T)
    cost_left_ft = np.ascontiguousarray(cost_left[:, ::-1].T)

    d = np.full((h, w), 1e9, dtype=np.float32)
    d[int(point_yx[0]), int(point_yx[1])] = 0.0
    for _ in range(sweeps):
        d = _sweep_down_np(d, cost_down)
        d = _sweep_down_np(np.ascontiguousarray(d[::-1]), cost_up_f)[::-1]
        d = _sweep_down_np(np.ascontiguousarray(d.T), cost_right_t).T
        d = _sweep_down_np(np.ascontiguousarray(d[:, ::-1].T),
                           cost_left_ft).T[:, ::-1]
        d = np.ascontiguousarray(d)
    return d


def smart_logits_np(linear_planes: np.ndarray, point_yx: tuple[int, int],
                    tolerance: float = 0.15, edge_weight: float = 12.0,
                    spatial_cost: float = 0.002,
                    sweeps: int = 4,
                    native: bool | None = None) -> np.ndarray:
    """numpy mirror of ops.masking.smart_select_mask — the era's
    host-side edge-aware object selection. ``native=None`` or True takes
    the C++ sweeps (identical relaxation order; cbrt ulp noise only, gated
    in tests), False the numpy code."""
    if native is None or native:
        from .. import native as _native

        return _native.geodesic_logits(
            linear_planes, point_yx, tolerance, edge_weight,
            spatial_cost, sweeps, _mats18())
    d = geodesic_distance_np(linear_planes, point_yx, edge_weight,
                             spatial_cost, sweeps=sweeps)
    return np.clip(_f32(1.0) - d / _f32(max(tolerance, 1e-6)),
                   -1.0, 1.0).astype(np.float32)


def mask_overlay_np(srgb_u8_hwc: np.ndarray, mask01: np.ndarray,
                    tint=(1.0, 0.2, 0.2), alpha: float = 0.5) -> np.ndarray:
    """numpy mirror of ops.masking.mask_overlay over a u8 HWC render."""
    img = srgb_u8_hwc.astype(np.float32) / _f32(255.0)
    m = (mask01 * _f32(alpha))[:, :, None]
    t = np.asarray(tint, dtype=np.float32)[None, None, :]
    out = img * (1.0 - m) + t * m
    return np.clip(out * 255.0, 0.0, 255.0).astype(np.uint8)
