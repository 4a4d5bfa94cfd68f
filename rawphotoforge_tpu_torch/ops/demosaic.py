"""Bayer and X-Trans demosaic + the camera colour pipeline — the RAW
develop front end, on torch tensors.

The JAX package's ``ops/demosaic.py``: CFA mosaic -> black/white-level
normalize -> white balance -> demosaic -> camera matrix -> linear sRGB
(rawpy postprocess semantics: camera WB, linear gamma, no auto-bright).
The editor's RAW open path develops through these functions, and they
are the "composed" reference the one-pass RAW kernel
(``kernels/raw_pipeline``) is held to.

Demosaic is shifted-plane arithmetic with the same operation order as
the JAX package: reflect-pad by index (numpy's ``reflect`` indices, so a
pad wider than the image cycles exactly as ``jnp.pad`` does), neighbour
sums, then a per-site select on the CFA phase. Divisions by constants go
through ``core/numerics.div`` so the card rounds as the CPU does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.numerics import div

# CFA patterns: 2x2 tile of channel indices (0=R, 1=G, 2=B), row-major.
BAYER_PATTERNS = {
    "RGGB": ((0, 1), (1, 2)),
    "BGGR": ((2, 1), (1, 0)),
    "GRBG": ((1, 0), (2, 1)),
    "GBRG": ((1, 2), (0, 1)),
}

# Fuji X-Trans 6x6 CFA layout (0=R, 1=G, 2=B), the canonical matrix.
XTRANS = np.array(
    [
        [1, 1, 0, 1, 1, 2],
        [1, 1, 2, 1, 1, 0],
        [2, 0, 1, 0, 2, 1],
        [1, 1, 2, 1, 1, 0],
        [1, 1, 0, 1, 1, 2],
        [0, 2, 1, 2, 0, 1],
    ],
    dtype=np.int32,
)

NAMED_CFA = {"XTRANS": XTRANS}
NAMED_CFA.update({
    k: np.asarray(v, dtype=np.int32) for k, v in BAYER_PATTERNS.items()
})

# Triangle-weighted 7-tap window of the normalized convolutions.
_NC_KERNEL_1D = np.array([1.0, 2.0, 3.0, 4.0, 3.0, 2.0, 1.0], dtype=np.float32)

# sRGB (D65) -> XYZ, to turn a DNG ColorMatrix (XYZ->cam) into cam->sRGB.
SRGB_TO_XYZ = np.array(
    [
        [0.4124564, 0.3575761, 0.1804375],
        [0.2126729, 0.7151522, 0.0721750],
        [0.0193339, 0.1191920, 0.9503041],
    ],
    dtype=np.float64,
)


def reflect_index(n: int, pad: int, device) -> torch.Tensor:
    """Source indices of numpy ``reflect`` padding of a length-``n`` axis
    by ``pad`` on both sides (-1 maps to 1, not 0; wide pads cycle)."""
    return torch.from_numpy(np.pad(np.arange(n), pad, mode="reflect")).to(device)


def pad_reflect(m: torch.Tensor, pad: int) -> torch.Tensor:
    """``jnp.pad(m, pad, mode="reflect")`` of a 2-D tensor, by gather."""
    h, w = m.shape
    return m[reflect_index(h, pad, m.device)][:, reflect_index(w, pad, m.device)]


def _iota(h: int, w: int, device):
    ys = torch.arange(h, dtype=torch.int32, device=device)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=torch.int32, device=device)[None, :].expand(h, w)
    return ys, xs


def _bayer_chan(h: int, w: int, pattern: str, device) -> torch.Tensor:
    """[H, W] channel ids of a Bayer pattern whose tile starts at (0, 0)."""
    tile = torch.tensor(BAYER_PATTERNS[pattern], dtype=torch.int32, device=device)
    ys, xs = _iota(h, w, device)
    return tile[ys % 2, xs % 2]


def _phase_masks(h: int, w: int, pattern: str, device):
    """Boolean [H, W] masks: which pixels carry R, G, B samples."""
    chan = _bayer_chan(h, w, pattern, device)
    return chan == 0, chan == 1, chan == 2


def _row_has_r(h: int, w: int, pattern: str, device) -> torch.Tensor:
    """Whether each row's colour samples (besides green) are red."""
    ys, _ = _iota(h, w, device)
    r_in_row0 = 0 in BAYER_PATTERNS[pattern][0]
    return (ys % 2 == 0) if r_in_row0 else (ys % 2 != 0)


def demosaic_bilinear(mosaic: torch.Tensor, pattern: str = "RGGB") -> torch.Tensor:
    """Bilinear demosaic of a CFA mosaic [H, W] -> planar RGB [3, H, W]."""
    h, w = mosaic.shape
    p = pad_reflect(mosaic, 1)
    c = p[1:-1, 1:-1]
    n = p[:-2, 1:-1]
    s = p[2:, 1:-1]
    e = p[1:-1, 2:]
    wv = p[1:-1, :-2]
    ne = p[:-2, 2:]
    nw = p[:-2, :-2]
    se = p[2:, 2:]
    sw = p[2:, :-2]

    cross = (n + s + e + wv) * 0.25
    horiz = (e + wv) * 0.5
    vert = (n + s) * 0.5
    diag = (ne + nw + se + sw) * 0.25

    is_r, is_g, is_b = _phase_masks(h, w, pattern, mosaic.device)
    row_has_r = _row_has_r(h, w, pattern, mosaic.device)
    g = torch.where(is_g, c, cross)
    r = torch.where(is_r, c, torch.where(
        is_g, torch.where(row_has_r, horiz, vert), diag))
    b = torch.where(is_b, c, torch.where(
        is_g, torch.where(row_has_r, vert, horiz), diag))
    return torch.stack([r, g, b])


def malvar_from_padded(m: torch.Tensor, h: int, w: int, pattern: str,
                       split_axial: bool = True):
    """Malvar-He-Cutler demosaic of ``m`` [(h+4), (w+4)] (2 px of context
    on each side; CFA phase (0, 0) at m[2, 2]) -> (r, g, b) [h, w].

    ``split_axial`` sums the four distance-2 neighbours as ud2 + lr2, as
    the one-pass RAW kernel does; False sums them left to right, as
    ``demosaic_malvar`` of the JAX package does (one rounding apart)."""

    def sh(dy, dx):
        return m[2 + dy : 2 + dy + h, 2 + dx : 2 + dx + w]

    c = sh(0, 0)
    cross1 = sh(-1, 0) + sh(1, 0) + sh(0, -1) + sh(0, 1)
    diag1 = sh(-1, -1) + sh(-1, 1) + sh(1, -1) + sh(1, 1)
    ud2 = sh(-2, 0) + sh(2, 0)
    lr2 = sh(0, -2) + sh(0, 2)
    axial2 = (ud2 + lr2 if split_axial
              else sh(-2, 0) + sh(2, 0) + sh(0, -2) + sh(0, 2))
    ud1 = sh(-1, 0) + sh(1, 0)
    lr1 = sh(0, -1) + sh(0, 1)

    g_at_cb = (4.0 * c + 2.0 * cross1 - axial2) * 0.125
    same_row = (5.0 * c + 4.0 * lr1 - diag1 - lr2 + 0.5 * ud2) * 0.125
    same_col = (5.0 * c + 4.0 * ud1 - diag1 - ud2 + 0.5 * lr2) * 0.125
    opp = (6.0 * c + 2.0 * diag1 - 1.5 * axial2) * 0.125

    is_r, is_g, is_b = _phase_masks(h, w, pattern, m.device)
    row_has_r = _row_has_r(h, w, pattern, m.device)
    g = torch.where(is_g, c, g_at_cb)
    r = torch.where(is_r, c, torch.where(
        is_g, torch.where(row_has_r, same_row, same_col), opp))
    b = torch.where(is_b, c, torch.where(
        is_g, torch.where(row_has_r, same_col, same_row), opp))
    return r, g, b


def demosaic_malvar(mosaic: torch.Tensor, pattern: str = "RGGB") -> torch.Tensor:
    """Malvar-He-Cutler (2004) gradient-corrected demosaic [H, W] -> [3, H, W]
    (5x5 linear stencil, reflect-padded by 2)."""
    h, w = mosaic.shape
    return torch.stack(malvar_from_padded(pad_reflect(mosaic, 2), h, w,
                                          pattern, split_axial=False))


def _cfa_channel_map(h: int, w: int, cfa: np.ndarray, device,
                     origin=(0, 0)) -> torch.Tensor:
    """[H, W] i32 channel ids of a periodic CFA layout; site (y, x) gets
    cfa[(y - oy) % ph, (x - ox) % pw] (``origin`` = where the true region
    starts on a padded grid)."""
    ph, pw = cfa.shape
    ys, xs = _iota(h, w, device)
    flat = torch.from_numpy(np.asarray(cfa, np.int32).reshape(-1)).to(device)
    return flat[(((ys - int(origin[0])) % ph) * pw
                 + (xs - int(origin[1])) % pw).long()]


def demosaic_cfa(mosaic: torch.Tensor, cfa: np.ndarray,
                 method: str = "residual", true_shape=None,
                 true_origin=None) -> torch.Tensor:
    """Demosaic an arbitrary periodic CFA (X-Trans and friends).

    ``method="nc"``: plain normalized convolution per channel.
    ``method="residual"`` (default): directional green by 1-D normalized
    convolution along the lower-gradient axis, then the chroma residuals
    (mosaic - green estimate) spread from their sample sites and added
    back onto green.

    The sample-validity mask is the boundary handling: convolutions
    zero-pad and the normalizer shrinks to the in-window sample mass.
    ``true_shape`` (h, w) / ``true_origin`` (oy, ox) mark a padded grid:
    samples outside the true region count as absent, so the true region
    of a padded develop equals the exact-shape develop bit for bit."""
    h, w = mosaic.shape
    dev = mosaic.device
    cfa = np.asarray(cfa, dtype=np.int32)
    origin = (0, 0) if true_origin is None else (int(true_origin[0]),
                                                 int(true_origin[1]))
    chan = _cfa_channel_map(h, w, cfa, dev, origin)
    taps = [float(t) for t in _NC_KERNEL_1D]
    pad = len(taps) // 2

    def conv1d(x, axis):
        if axis == 0:
            xp = torch.nn.functional.pad(x, (0, 0, pad, pad))
            return sum(t * xp[i : i + h, :] for i, t in enumerate(taps))
        xp = torch.nn.functional.pad(x, (pad, pad))
        return sum(t * xp[:, i : i + w] for i, t in enumerate(taps))

    def shifted(x, d, axis):
        """out[i] = x[i + d] along ``axis``, zero-filled out of range."""
        lo, hi = max(-d, 0), max(d, 0)
        xp = torch.nn.functional.pad(
            x, (lo, hi, 0, 0) if axis == 1 else (0, 0, lo, hi))
        n = h if axis == 0 else w
        return xp.narrow(axis, hi, n)

    def spread(x):
        return conv1d(conv1d(x, 0), 1)

    def nc(values, mask):
        return spread(values * mask) / torch.clamp(spread(mask), min=1e-8)

    def nc1d(values, mask, axis):
        den = conv1d(mask, axis)
        return conv1d(values * mask, axis) / torch.clamp(den, min=1e-8), den

    if true_shape is None:
        valid = torch.ones((h, w), dtype=torch.float32, device=dev)
        masks = [(chan == c).to(torch.float32) for c in range(3)]
        mz = mosaic
    else:
        ys, xs = _iota(h, w, dev)
        vy = (ys >= origin[0]) & (ys < origin[0] + int(true_shape[0]))
        vx = (xs >= origin[1]) & (xs < origin[1] + int(true_shape[1]))
        valid = (vy & vx).to(torch.float32)
        masks = [(chan == c).to(torch.float32) * valid for c in range(3)]
        mz = mosaic * valid

    if method == "nc":
        return torch.stack([
            torch.where(m > 0, mosaic, nc(mosaic, m)) for m in masks])
    if method != "residual":
        raise ValueError(f"unknown CFA demosaic method {method!r}")

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

    planes = []
    for c in (0, 2):
        est = g + nc(mosaic - g_est, masks[c])
        planes.append(torch.where(masks[c] > 0, mosaic, est))
    return torch.stack([planes[0], g, planes[1]])


def normalize_mosaic(raw_values: torch.Tensor, black_level, white_level) -> torch.Tensor:
    """Integer CFA values -> float32 [0, 1]: (v - black) / (white - black),
    clipped (the rawler/rawpy normalization)."""
    v = div(raw_values.to(torch.float32) - float(black_level),
            float(white_level) - float(black_level))
    return torch.clamp(v, 0.0, 1.0)


def _gains_tensor(gains, device) -> torch.Tensor:
    return torch.as_tensor(gains, dtype=torch.float32).to(device)


def apply_wb_mosaic(mosaic: torch.Tensor, pattern: str, gains,
                    true_origin=None) -> torch.Tensor:
    """Per-CFA-site white-balance gains applied *before* demosaic.
    ``gains`` is (r, g, b); ``pattern`` a Bayer name or a NAMED_CFA key.
    ``true_origin``: (oy, ox) of the true region on a padded grid whose
    pads land top/left — per-site gains follow the absolute phase."""
    h, w = mosaic.shape
    gains = _gains_tensor(gains, mosaic.device)
    if pattern in BAYER_PATTERNS:
        is_r, is_g, _ = _phase_masks(h, w, pattern, mosaic.device)
        gain = torch.where(is_r, gains[0], torch.where(is_g, gains[1], gains[2]))
        return mosaic * gain
    origin = (0, 0) if true_origin is None else true_origin
    chan = _cfa_channel_map(h, w, NAMED_CFA[pattern], mosaic.device, origin)
    return mosaic * gains[chan.long()]


def camera_to_srgb(planes: torch.Tensor, cam2srgb) -> torch.Tensor:
    """Apply the 3x3 camera->linear-sRGB matrix to planar [3, H, W]."""
    r, g, b = planes[0], planes[1], planes[2]
    m = _gains_tensor(cam2srgb, planes.device)
    return torch.stack([
        m[0, 0] * r + m[0, 1] * g + m[0, 2] * b,
        m[1, 0] * r + m[1, 1] * g + m[1, 2] * b,
        m[2, 0] * r + m[2, 1] * g + m[2, 2] * b,
    ])


def cam_matrix_to_srgb(xyz_to_cam: np.ndarray) -> np.ndarray:
    """DNG ColorMatrix (XYZ D65 -> camera) -> camera -> linear-sRGB: the
    dcraw recipe (cam_rgb = xyz_to_cam @ srgb_to_xyz, rows normalized to
    sum 1, pseudo-inverse). Host numpy."""
    cam_rgb = np.asarray(xyz_to_cam, dtype=np.float64) @ SRGB_TO_XYZ
    cam_rgb = cam_rgb / cam_rgb.sum(axis=1, keepdims=True)
    return np.linalg.pinv(cam_rgb).astype(np.float32)


def develop_raw(mosaic01: torch.Tensor, wb_gains, cam2srgb,
                pattern: str = "RGGB", method: str = "malvar",
                true_shape=None, true_origin=None) -> torch.Tensor:
    """Normalized CFA mosaic [H, W] in [0, 1] -> linear sRGB [3, H, W]:
    WB on the mosaic -> demosaic -> camera matrix -> clip to [0, 1].
    Bayer takes Malvar (or bilinear); X-Trans, or Bayer with
    ``method="residual"``/``"nc"``, takes ``demosaic_cfa``."""
    if method not in ("malvar", "bilinear", "residual", "nc"):
        raise ValueError(f"unknown demosaic method {method!r}")
    m = apply_wb_mosaic(mosaic01, pattern, wb_gains, true_origin=true_origin)
    if pattern in BAYER_PATTERNS and method in ("malvar", "bilinear"):
        demosaic = demosaic_malvar if method == "malvar" else demosaic_bilinear
        rgb = demosaic(m, pattern)
    else:
        cfa_method = method if method in ("residual", "nc") else "residual"
        rgb = demosaic_cfa(m, NAMED_CFA[pattern], method=cfa_method,
                           true_shape=true_shape, true_origin=true_origin)
    return torch.clamp(camera_to_srgb(rgb, cam2srgb), 0.0, 1.0)


def develop_linear_raw(rgb01: torch.Tensor, wb_gains, cam2srgb) -> torch.Tensor:
    """Normalized LinearRaw [H, W, 3] in [0, 1] -> linear sRGB [3, H, W]:
    per-channel WB, camera matrix, clip (no demosaic)."""
    wb = _gains_tensor(wb_gains, rgb01.device)
    planes = torch.movedim(rgb01 * wb[None, None, :], -1, 0)
    return torch.clamp(camera_to_srgb(planes, cam2srgb), 0.0, 1.0)
