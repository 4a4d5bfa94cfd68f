"""Plain PyTorch reference of a RAW editing session's full-resolution render.

What a photographer sees after opening a CFA RAW and editing it: the
normalized mosaic (black/white levels) is white-balanced per CFA site,
demosaiced (Malvar-He-Cutler for a 2x2 Bayer layout, the residual
normalized convolution for a 6x6 X-Trans layout), taken through the
camera matrix to linear sRGB, warped by the lens-distortion slider and
sharpened by the unsharp mask, then developed per mask (WB -> tone ->
brightness curve, then OKLCH hue/saturation/lightness curves by hue),
vignetted and sRGB-encoded.

It works from the benchmark's own inputs only: the u16 mosaic and the
metadata the benchmark wrote into the DNG, the mask logits it handed to
the editor, and the edit state its script reached. It imports nothing of
the program under test. Curves are the exact 65536-entry i32 tables of a
float32 PCHIP (harmonic-mean slopes, clamped ends, truncation toward
zero); LUT lookups index by ``trunc(v * 65535)``.

The image is held on the 128-pixel bucket grid the session uses: the
mosaic is reflect-padded bottom/right before the demosaic, the true region
is edge-replicated into the pad after the demosaic and after the warp, and
the unsharp mask reflects at the grid's border. Divisions by a constant
are correctly rounded divisions.

``dtype`` sets the precision of every float stage: float32 is the
reference, bfloat16 its control.
"""

from __future__ import annotations

import numpy as np
import torch

BUCKET = 128
LUT_MAX = 65535.0
TWO_PI = 6.28318530718

# The Rec. 709 luma weights and the OKLab matrices.
LUMA = (0.2126, 0.7152, 0.0722)
M1 = ((0.4122214708, 0.5363325363, 0.0514459929),
      (0.2119034982, 0.6806995451, 0.1073969566),
      (0.0883024619, 0.2817188376, 0.6299787005))
M1_INV = ((4.0767416621, -3.3077115913, 0.2309699292),
          (-1.2684380046, 2.6097574011, -0.3413193965),
          (-0.0041960863, -0.7034186147, 1.7076147010))
M2 = ((0.2104542553, 0.7936177850, -0.0040720468),
      (1.9779984951, -2.4285922050, 0.4505937099),
      (0.0259040371, 0.7827717662, -0.8086757660))
M2_INV = ((1.0, 0.3963377774, 0.2158037573),
          (1.0, -0.1055613458, -0.0638541728),
          (1.0, -0.0894841775, -1.2914855480))
SRGB_TO_XYZ = np.array([[0.4124564, 0.3575761, 0.1804375],
                        [0.2126729, 0.7151522, 0.0721750],
                        [0.0193339, 0.1191920, 0.9503041]], dtype=np.float64)
NC_TAPS = (1.0, 2.0, 3.0, 4.0, 3.0, 2.0, 1.0)


def _div(x, s):
    """``x / s`` as one correctly rounded division (a divisor on the
    tensor's device takes torch's true-division path)."""
    return x / torch.full((), s, dtype=x.dtype, device=x.device)


def _mat3(m, a, b, c):
    return (m[0][0] * a + m[0][1] * b + m[0][2] * c,
            m[1][0] * a + m[1][1] * b + m[1][2] * c,
            m[2][0] * a + m[2][1] * b + m[2][2] * c)


def bucket(n: int) -> int:
    return n + (-n) % BUCKET


# -- camera colour ---------------------------------------------------------------

def cam_to_srgb(xyz_to_cam) -> np.ndarray:
    """DNG ColorMatrix (XYZ D65 -> camera) -> camera -> linear sRGB: rows of
    xyz_to_cam @ sRGB->XYZ normalized to sum 1, then the pseudo-inverse."""
    cam_rgb = np.asarray(xyz_to_cam, dtype=np.float64).reshape(3, 3) @ SRGB_TO_XYZ
    cam_rgb = cam_rgb / cam_rgb.sum(axis=1, keepdims=True)
    return np.linalg.pinv(cam_rgb).astype(np.float32)


def wb_gains(neutral) -> tuple:
    """AsShotNeutral (r, g, b) -> per-channel gains, green = 1."""
    n = np.asarray(neutral, dtype=np.float64)
    return tuple((n[1] / np.maximum(n, 1e-8)).tolist())


# -- the RAW front end -------------------------------------------------------------

def _reflect_index(n: int, before: int, after: int, device) -> torch.Tensor:
    return torch.from_numpy(np.pad(np.arange(n), (before, after),
                                   mode="reflect")).to(device)


def _edge_index(n_true: int, n: int, device) -> torch.Tensor:
    return torch.clamp(torch.arange(n, device=device), max=n_true - 1)


def replicate_true_edges(planes, th: int, tw: int):
    _, ph, pw = planes.shape
    return planes[:, _edge_index(th, ph, planes.device)][
        :, :, _edge_index(tw, pw, planes.device)]


def _iota(h, w, device):
    ys = torch.arange(h, dtype=torch.int32, device=device)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=torch.int32, device=device)[None, :].expand(h, w)
    return ys, xs


def _channel_map(h, w, cfa: np.ndarray, device) -> torch.Tensor:
    ph, pw = cfa.shape
    ys, xs = _iota(h, w, device)
    flat = torch.from_numpy(np.asarray(cfa, np.int64).reshape(-1)).to(device)
    return flat[((ys % ph) * pw + xs % pw).long()]


def malvar(m, cfa: np.ndarray):
    """Malvar-He-Cutler 5x5 demosaic of a Bayer mosaic [H, W] (reflect
    padded by 2) -> (r, g, b)."""
    h, w = m.shape
    p = m[_reflect_index(h, 2, 2, m.device)][:, _reflect_index(w, 2, 2, m.device)]

    def sh(dy, dx):
        return p[2 + dy: 2 + dy + h, 2 + dx: 2 + dx + w]

    c = sh(0, 0)
    cross1 = sh(-1, 0) + sh(1, 0) + sh(0, -1) + sh(0, 1)
    diag1 = sh(-1, -1) + sh(-1, 1) + sh(1, -1) + sh(1, 1)
    ud2 = sh(-2, 0) + sh(2, 0)
    lr2 = sh(0, -2) + sh(0, 2)
    axial2 = sh(-2, 0) + sh(2, 0) + sh(0, -2) + sh(0, 2)
    ud1 = sh(-1, 0) + sh(1, 0)
    lr1 = sh(0, -1) + sh(0, 1)
    g_at_cb = (4.0 * c + 2.0 * cross1 - axial2) * 0.125
    same_row = (5.0 * c + 4.0 * lr1 - diag1 - lr2 + 0.5 * ud2) * 0.125
    same_col = (5.0 * c + 4.0 * ud1 - diag1 - ud2 + 0.5 * lr2) * 0.125
    opp = (6.0 * c + 2.0 * diag1 - 1.5 * axial2) * 0.125

    chan = _channel_map(h, w, cfa, m.device)
    is_r, is_g, is_b = chan == 0, chan == 1, chan == 2
    ys, _ = _iota(h, w, m.device)
    row_has_r = (ys % 2 == 0) if 0 in cfa[0] else (ys % 2 != 0)
    g = torch.where(is_g, c, g_at_cb)
    r = torch.where(is_r, c, torch.where(
        is_g, torch.where(row_has_r, same_row, same_col), opp))
    b = torch.where(is_b, c, torch.where(
        is_g, torch.where(row_has_r, same_col, same_row), opp))
    return r, g, b


def residual_cfa(mosaic, cfa: np.ndarray, true_hw):
    """Demosaic of a periodic CFA (X-Trans): green by 1-D normalized
    convolution along the axis of lower gradient, then the colour
    residuals (mosaic - green estimate) spread from their sites and added
    back onto green. Sites outside the true region count as absent."""
    h, w = mosaic.shape
    dev = mosaic.device
    chan = _channel_map(h, w, cfa, dev)
    pad = len(NC_TAPS) // 2

    def conv1d(x, axis):
        if axis == 0:
            xp = torch.nn.functional.pad(x, (0, 0, pad, pad))
            return sum(t * xp[i: i + h, :] for i, t in enumerate(NC_TAPS))
        xp = torch.nn.functional.pad(x, (pad, pad))
        return sum(t * xp[:, i: i + w] for i, t in enumerate(NC_TAPS))

    def shifted(x, d, axis):
        lo, hi = max(-d, 0), max(d, 0)
        xp = torch.nn.functional.pad(
            x, (lo, hi, 0, 0) if axis == 1 else (0, 0, lo, hi))
        return xp.narrow(axis, hi, h if axis == 0 else w)

    def spread(x):
        return conv1d(conv1d(x, 0), 1)

    def nc(values, mask):
        return spread(values * mask) / torch.clamp(spread(mask), min=1e-8)

    def nc1d(values, mask, axis):
        den = conv1d(mask, axis)
        return conv1d(values * mask, axis) / torch.clamp(den, min=1e-8), den

    ys, xs = _iota(h, w, dev)
    valid = ((ys < int(true_hw[0])) & (xs < int(true_hw[1]))).to(mosaic.dtype)
    masks = [(chan == c).to(mosaic.dtype) * valid for c in range(3)]
    mz = mosaic * valid

    g2d = nc(mosaic, masks[1])
    g_h, den_h = nc1d(mosaic, masks[1], axis=1)
    g_v, den_v = nc1d(mosaic, masks[1], axis=0)
    g_h = torch.where(den_h > 0.5, g_h, g2d)
    g_v = torch.where(den_v > 0.5, g_v, g2d)

    def grad(axis):
        va = shifted(valid, 1, axis)
        vb = shifted(valid, -1, axis)
        return torch.abs(shifted(mz, 1, axis) - shifted(mz, -1, axis)) * va * vb

    g_est = torch.where(spread(grad(1)) > spread(grad(0)), g_v, g_h)
    g = torch.where(masks[1] > 0, mosaic, g_est)
    out = []
    for c in (0, 2):
        est = g + nc(mosaic - g_est, masks[c])
        out.append(torch.where(masks[c] > 0, mosaic, est))
    return out[0], g, out[1]


def develop_mosaic(mosaic_u16, meta: dict, device, dtype=torch.float32):
    """u16 CFA mosaic [h, w] -> linear sRGB planes [3, Hb, Wb] on the
    bucket grid (true region at the origin, edge-replicated pad)."""
    m = torch.as_tensor(np.ascontiguousarray(mosaic_u16).astype(np.int32)).to(device)
    h, w = m.shape
    hb, wb = bucket(h), bucket(w)
    m = m[_reflect_index(h, 0, hb - h, device)][:, _reflect_index(w, 0, wb - w, device)]
    black, white = float(meta["black_level"]), float(meta["white_level"])
    v = torch.clamp(_div(m.to(dtype) - black, white - black), 0.0, 1.0)
    cfa = np.asarray(meta["cfa"], dtype=np.int32)
    gains = torch.tensor(wb_gains(meta["as_shot_neutral"]), dtype=torch.float32,
                         device=device).to(dtype)
    v = v * gains[_channel_map(hb, wb, cfa, device)]
    if cfa.shape == (2, 2):
        r, g, b = malvar(v, cfa)
    else:
        r, g, b = residual_cfa(v, cfa, (h, w))
    cam = torch.from_numpy(cam_to_srgb(meta["color_matrix"])).to(device).to(dtype)
    planes = torch.stack([cam[0, 0] * r + cam[0, 1] * g + cam[0, 2] * b,
                          cam[1, 0] * r + cam[1, 1] * g + cam[1, 2] * b,
                          cam[2, 0] * r + cam[2, 1] * g + cam[2, 2] * b])
    return replicate_true_edges(torch.clamp(planes, 0.0, 1.0), h, w)


# -- geometry and sharpening ----------------------------------------------------------

def _snap(s):
    r = torch.round(s)
    thr = torch.clamp(torch.abs(s) * 6e-7, min=1e-4)
    return torch.where(torch.abs(s - r) < thr, r, s)


def lens_distortion(planes, distortion: float, true_hw):
    """Radial warp (strength = -0.5 * slider / 100) with bilinear sampling
    inside the true extent; sources outside it are black."""
    _, hb, wb = planes.shape
    dev, dt = planes.device, planes.dtype
    strength = -0.5 * _div(torch.tensor(float(distortion), dtype=dt, device=dev), 100.0)
    hf = torch.tensor(float(true_hw[0]), dtype=dt, device=dev)
    wf = torch.tensor(float(true_hw[1]), dtype=dt, device=dev)
    ys, xs = _iota(hb, wb, dev)
    cu = (xs.to(dt) / wf - 0.5) * (wf / hf)
    cv = ys.to(dt) / hf - 0.5
    denom = 1.0 + strength * (cu * cu + cv * cv)
    fu = (cu / denom) / (wf / hf) + 0.5
    fv = cv / denom + 0.5
    oob = (fu < 0.0) | (fu > 1.0) | (fv < 0.0) | (fv > 1.0)
    px = _snap(fu * (wf - 1.0))
    py = _snap(fv * (hf - 1.0))
    x0f, y0f = torch.floor(px), torch.floor(py)
    wi, hi = int(true_hw[1]) - 1, int(true_hw[0]) - 1
    x0 = torch.clamp(x0f.to(torch.int64), 0, wi)
    y0 = torch.clamp(y0f.to(torch.int64), 0, hi)
    x1 = torch.clamp(x0 + 1, max=wi)
    y1 = torch.clamp(y0 + 1, max=hi)
    tx, ty = px - x0f, py - y0f
    out = []
    for p in planes:
        top = p[y0, x0] * (1.0 - tx) + p[y0, x1] * tx
        bot = p[y1, x0] * (1.0 - tx) + p[y1, x1] * tx
        out.append(torch.where(oob, 0.0, top * (1.0 - ty) + bot * ty))
    return torch.stack(out)


def unsharp(planes, amount: float, sigma: float = 1.0, radius: int = 2):
    """x + amount * (x - gauss(x)), clamped at 0; the separable 5-tap
    Gaussian reflects at the grid's border."""
    xs = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (xs / sigma) ** 2)
    taps = (k / k.sum()).astype(np.float32)

    def blur(x, axis):
        n = x.shape[axis]
        xp = torch.index_select(x, axis, _reflect_index(n, radius, radius, x.device))
        out = torch.zeros_like(x)
        for i, t in enumerate(taps):
            out = out + float(t) * xp.narrow(axis, i, n)
        return out

    amount = float(np.float32(amount))
    return torch.clamp(planes + amount * (planes - blur(blur(planes, 1), 2)), min=0.0)


def geometry(planes, distortion: float, sharpness: float, true_hw):
    if distortion != 0:
        planes = replicate_true_edges(lens_distortion(planes, distortion, true_hw),
                                      *true_hw)
    if sharpness != 0:
        planes = unsharp(planes, sharpness / 100.0 * 2.0)
    return planes


# -- curves ------------------------------------------------------------------------------

def pchip_lut(cx, cy) -> np.ndarray:
    """The exact 65536-entry i32 table of a float32 PCHIP through integer
    control points: harmonic-mean interior slopes (0 where the secants
    change sign), one-sided end slopes, clamped outside the knots,
    truncated toward zero and clamped to [0, 65535]."""
    x = np.asarray(cx, dtype=np.float32)
    y = np.asarray(cy, dtype=np.float32)
    n = x.shape[0]
    h = x[1:] - x[:-1]
    delta = (y[1:] - y[:-1]) / h
    slopes = np.zeros(n, dtype=np.float32)
    slopes[0], slopes[-1] = delta[0], delta[-1]
    if n > 2:
        d0, d1 = delta[:-1], delta[1:]
        w1 = np.float32(2.0) * h[1:] + h[:-1]
        w2 = h[1:] + np.float32(2.0) * h[:-1]
        with np.errstate(divide="ignore", invalid="ignore"):
            harm = (w1 + w2) / (w1 / d0 + w2 / d1)
        slopes[1:-1] = np.where(d0 * d1 <= 0.0, np.float32(0.0), harm)
    xe = np.arange(65536, dtype=np.float32)
    i = np.clip(np.searchsorted(x, xe, side="right") - 1, 0, n - 2)
    hv = h[i]
    t = ((xe - x[i]) / hv).astype(np.float32)
    t2 = t * t
    t3 = t2 * t
    h00 = np.float32(2.0) * t3 - np.float32(3.0) * t2 + np.float32(1.0)
    h10 = t3 - np.float32(2.0) * t2 + t
    h01 = np.float32(-2.0) * t3 + np.float32(3.0) * t2
    h11 = t3 - t2
    out = (h00 * y[i] + h10 * hv * slopes[i] + h01 * y[i + 1]
           + h11 * hv * slopes[i + 1]).astype(np.float32)
    out = np.where(xe <= x[0], y[0], out)
    out = np.where(xe >= x[-1], y[-1], out).astype(np.float32)
    return np.clip(np.trunc(out), 0, 65535).astype(np.int32)


def curve_luts(curves, device) -> torch.Tensor:
    """[4, 65536] i32 tables of (bright, hue, sat, light); a None curve is
    the slot's default: the identity for brightness and hue, the constant
    32767 (a gain of 1) for saturation and lightness."""
    rows = []
    for k, c in enumerate(curves):
        if c is not None:
            rows.append(pchip_lut(*c))
        elif k < 2:
            rows.append(np.arange(65536, dtype=np.int32))
        else:
            rows.append(np.full(65536, 32767, dtype=np.int32))
    return torch.from_numpy(np.stack(rows)).to(device)


# -- the develop stack -------------------------------------------------------------------

def _lut_index(v):
    return torch.clamp((v * LUT_MAX).to(torch.int64), 0, 65535)


def _fetch(lut, idx, dt):
    return torch.clamp(lut[idx], 0, 65535).to(dt)


def _tone(r, g, b, p, dt):
    exposure = torch.tensor(np.float32(p["exposure"]), device=r.device).to(dt)
    contrast, shadow, highlight, black, white = (
        float(np.float32(p[k] / 100.0)) for k in
        ("contrast", "shadow", "highlight", "black", "white"))
    mul = torch.exp2(exposure)
    r, g, b = r * mul, g * mul, b * mul
    y = LUMA[0] * r + LUMA[1] * g + LUMA[2] * b
    s = 1.0 + shadow * torch.clamp(1.0 - y, 0.0, 1.0)
    r, g, b = r * s, g * s, b * s
    hl = 1.0 + highlight * torch.clamp(y, 0.0, 1.0)
    r, g, b = r * hl, g * hl, b * hl
    t = torch.clamp(y, 0.0, 1.0)
    if black != 0.0:
        lift = black * ((1.0 - t) * (1.0 - t))
        r, g, b = r + lift, g + lift, b + lift
    if white != 0.0:
        lift = white * (t * t)
        r, g, b = r + lift, g + lift, b + lift
    if contrast != 0.0:
        c = 1.0 + contrast
        r, g, b = (r - 0.5) * c + 0.5, (g - 0.5) * c + 0.5, (b - 0.5) * c + 0.5
    return (torch.clamp(r, 0.0, 1.0), torch.clamp(g, 0.0, 1.0),
            torch.clamp(b, 0.0, 1.0))


def _srgb_oetf(c):
    return torch.where(c <= 0.0031308, c * 12.92,
                       1.055 * torch.pow(torch.clamp(c, min=0.0), 1.0 / 2.4) - 0.055)


def develop_rows(planes, masks, params, luts, row0: int, true_hw):
    """The develop stack on a block of rows of the true region. ``masks``:
    bool [M, rows, w] (row 0 of the stack all true) or None for the main
    mask alone; ``params``: the masks' slider dicts, main first."""
    dt = planes.dtype
    dev = planes.device
    r, g, b = planes[0], planes[1], planes[2]
    rows, w = r.shape
    vig = float(params[0]["vignette"])
    strength = float(_div(torch.tensor(-vig, dtype=torch.float32), 100.0)) * 2.0
    if strength != 0.0:
        ys = torch.arange(rows, dtype=torch.int32, device=dev)[:, None] + row0
        xs = torch.arange(w, dtype=torch.int32, device=dev)[None, :]
        cy = (_div(ys.to(dt), float(true_hw[0])) - 0.5) * 1.5
        cx = (_div(xs.to(dt), float(true_hw[1])) - 0.5) * 1.5
        dist = torch.sqrt(cx * cx + cy * cy)
        t = torch.clamp(_div(dist - 0.25, 0.75), 0.0, 1.0)
        gain = torch.clamp(1.0 - strength * (t * torch.sqrt(t)), 0.0, 4.0)
        r, g, b = r * gain, g * gain, b * gain

    for k, p in enumerate(params):
        temp, tint = p["temperature"] / 100.0, p["tint"] / 100.0
        gk = [float(np.float32(v)) for v in
              (1.0 + 0.5 * temp, 1.0 - 0.25 * tint, 1.0 - 0.5 * temp)]
        rk, gg, bk = _tone(r * gk[0], g * gk[1], b * gk[2], p, dt)
        lut = luts[k][0]
        rk = _div(_fetch(lut, _lut_index(rk), dt), LUT_MAX)
        gg = _div(_fetch(lut, _lut_index(gg), dt), LUT_MAX)
        bk = _div(_fetch(lut, _lut_index(bk), dt), LUT_MAX)
        if masks is None:
            r, g, b = rk, gg, bk
        else:
            sel = masks[k]
            r, g, b = (torch.where(sel, rk, r), torch.where(sel, gg, g),
                       torch.where(sel, bk, b))

    lms = _mat3(M1, r, g, b)
    L, A, B = _mat3(M2, *(torch.pow(torch.clamp(v, min=0.0), 1.0 / 3.0) for v in lms))
    C = torch.sqrt(A * A + B * B)
    H = _div(torch.atan2(B, A), TWO_PI)
    H = torch.where(H < 0.0, H + 1.0, H)
    for k in range(len(params)):
        idx = _lut_index(H)
        new_h = _div(_fetch(luts[k][1], idx, dt), LUT_MAX)
        sat = _div(_fetch(luts[k][2], idx, dt), 32767.5)
        light = _div(_fetch(luts[k][3], idx, dt), 32767.5)
        if masks is None:
            H, C, L = new_h, C * sat, L * light
        else:
            sel = masks[k]
            H = torch.where(sel, new_h, H)
            C = torch.where(sel, C * sat, C)
            L = torch.where(sel, L * light, L)
    ang = H * TWO_PI
    l_, m_, s_ = _mat3(M2_INV, L, C * torch.cos(ang), C * torch.sin(ang))
    r, g, b = _mat3(M1_INV, l_ * l_ * l_, m_ * m_ * m_, s_ * s_ * s_)
    return torch.clamp(torch.stack([_srgb_oetf(r), _srgb_oetf(g), _srgb_oetf(b)]),
                       0.0, 1.0)


def render(linear, state: dict, mask_logits, device, block_rows: int = 1024):
    """The full-resolution render of one edit state: sRGB [3, h, w] on
    ``device`` in ``linear``'s dtype. ``linear``: ``develop_mosaic``'s
    planes; ``state``: ``{"masks": [slider dict, ...], "main": {...}}`` as
    the benchmark's script keeps it (main first); ``mask_logits``: the
    regional masks' f32 logits [h, w] (host arrays), selected where
    ``>= 0``."""
    true_hw = tuple(state["true_hw"])
    h, w = true_hw
    main = state["main"]
    geo = geometry(linear, main["lens_distortion"], main["sharpness"], true_hw)
    params = [dict(p, vignette=main["vignette"]) for p in state["masks"]]
    luts = [curve_luts(p["curves"], device) for p in params]
    out = torch.empty((3, h, w), dtype=linear.dtype, device=device)
    for r0 in range(0, h, block_rows):
        r1 = min(h, r0 + block_rows)
        masks = None
        if len(params) > 1:
            rows = [torch.ones((r1 - r0, w), dtype=torch.bool, device=device)]
            rows += [torch.from_numpy(np.ascontiguousarray(lg[r0:r1] >= 0.0)).to(device)
                     for lg in mask_logits]
            masks = torch.stack(rows)
        out[:, r0:r1] = develop_rows(geo[:, r0:r1, :w], masks, params, luts, r0, true_hw)
    return out

