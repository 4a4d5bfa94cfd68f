"""Edit parameters: the non-destructive edit state and its packed device form.

Two representations, as in the JAX package:

* ``EditParameters`` — the user-facing, per-mask parameter set mirroring the
  reference's struct (rust/photo-editor/src/lib.rs:19-64). Setters clamp
  exactly like the reference setters (lib.rs:255-298). JSON-serializable,
  and the JSON is the same as the JAX package's, so a preset written by one
  package loads in the other.

* ``DevelopParams`` — a dataclass of stacked torch tensors, one row per
  mask, consumed by the develop functions: [M] scalar vectors,
  [M, 4, 65536] i32 LUTs (anchor path) and [M, 4, S] / [M, 4, S, 4] packed
  curve coefficients (kernel path).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

import numpy as np
import torch

from .._device import resolve_device
from . import curve as curve_mod
from .curve import CURVE_RESOLUTION, MAX_CTRL

# Packing work done since the counts were last set to 0, one per
# ``CurveState.packed`` call: a PCHIP fit (``curve_fits``) or a reuse of the
# curve's last fit (``curve_fit_hits``).
COUNTS = {"curve_fits": 0, "curve_fit_hits": 0}

# Curve slot order, fixed: matches binding order wgpu_shader.wgsl:12-15.
BRIGHTNESS, HUE, SATURATION, LIGHTNESS = 0, 1, 2, 3
CURVE_NAMES = ("brightness", "hue", "saturation", "lightness")

# Reference v1 preset key -> curve slot (current names + the legacy
# aliases the reference's own loader migrates, raw_photo_forge.py:2305).
_V1_CURVE_KEYS = {
    "brightness_curve_points": BRIGHTNESS,
    "oklch_h_curve_points": HUE, "hue_curve_points": HUE,
    "oklch_c_curve_points": SATURATION,
    "saturation_curve_points": SATURATION,
    "oklch_l_curve_points": LIGHTNESS,
    "lightness_curve_points": LIGHTNESS,
}


def _default_points(slot: int) -> tuple[np.ndarray, np.ndarray]:
    pts = (curve_mod.IDENTITY_POINTS if slot in (BRIGHTNESS, HUE)
           else curve_mod.CONSTANT_POINTS)
    return pts[0].copy(), pts[1].copy()


@dataclasses.dataclass
class CurveState:
    """One curve: control points (preferred) or a raw 65536-entry LUT."""

    control_x: Optional[np.ndarray] = None
    control_y: Optional[np.ndarray] = None
    raw_lut: Optional[np.ndarray] = None  # set only when user supplies a LUT
    # The last fit of the control points, (key, breaks, coeffs), read-only:
    # ``packed`` fits again only when the key (slot, segment count, the
    # points' bytes) differs, so an edit that moves no curve fits none.
    # Checked by value, so points changed in place are never served stale.
    _fit: Optional[tuple] = dataclasses.field(
        default=None, init=False, compare=False, repr=False)

    def lut(self, slot: int) -> np.ndarray:
        if self.raw_lut is not None:
            return np.clip(self.raw_lut, 0, CURVE_RESOLUTION - 1).astype(np.int32)
        if self.control_x is None:
            return (
                curve_mod.identity_lut()
                if slot in (BRIGHTNESS, HUE)
                else curve_mod.constant_lut()
            )
        return curve_mod.build_lut(self.control_x, self.control_y)

    def packed(self, slot: int, max_ctrl: int = MAX_CTRL) -> tuple[np.ndarray, np.ndarray]:
        if self.raw_lut is not None:
            # Not kept: a raw LUT renders on the exact-LUT path, whose
            # 65536-entry ``lut`` each pack outweighs this fit.
            COUNTS["curve_fits"] += 1
            return curve_mod.lut_to_coeffs(self.raw_lut, max_ctrl=max_ctrl)
        cx, cy = (
            (np.asarray(self.control_x), np.asarray(self.control_y))
            if self.control_x is not None
            else _default_points(slot)
        )
        key = (slot, max_ctrl, cx.dtype.str, cx.tobytes(),
               cy.dtype.str, cy.tobytes())
        if self._fit is not None and self._fit[0] == key:
            COUNTS["curve_fit_hits"] += 1
            return self._fit[1], self._fit[2]
        COUNTS["curve_fits"] += 1
        breaks, coeffs = curve_mod.pchip_coeffs(cx, cy, max_ctrl=max_ctrl)
        breaks.flags.writeable = coeffs.flags.writeable = False
        self._fit = (key, breaks, coeffs)
        return breaks, coeffs

    def num_points(self, slot: int) -> int:
        if self.raw_lut is not None:
            return MAX_CTRL
        if self.control_x is None:
            return 2
        return max(2, len(self.control_x))

    def is_default(self, slot: int) -> bool:
        if self.raw_lut is not None:
            return False
        if self.control_x is None:
            return True
        dx, dy = _default_points(slot)
        return (
            len(self.control_x) == len(dx)
            and np.array_equal(self.control_x, dx)
            and np.array_equal(self.control_y, dy)
        )

    def to_json(self):
        if self.raw_lut is not None:
            return {"raw_lut": np.asarray(self.raw_lut).tolist()}
        if self.control_x is None:
            return None
        return {
            "x": np.asarray(self.control_x).tolist(),
            "y": np.asarray(self.control_y).tolist(),
        }

    @classmethod
    def from_json(cls, obj):
        """The inverse of ``to_json`` (no validation: ``EditParameters``
        passes the state through ``set_curve``)."""
        if obj is None:
            return cls()
        if "raw_lut" in obj:
            return cls(raw_lut=np.asarray(obj["raw_lut"], dtype=np.int32))
        return cls(
            control_x=np.asarray(obj["x"], dtype=np.int32),
            control_y=np.asarray(obj["y"], dtype=np.int32),
        )


@dataclasses.dataclass
class EditParameters:
    """Per-mask edit parameters; ranges/clamps per lib.rs:255-298.

    Integer sliders are in [-100, 100]; exposure is EV in [-10, 10].
    """

    exposure: float = 0.0
    contrast: int = 0
    shadow: int = 0
    highlight: int = 0
    black: int = 0
    white: int = 0
    wb_temperature: int = 0
    wb_tint: int = 0
    vignette: int = 0
    lens_distortion: int = 0
    sharpness: int = 0  # main-only unsharp amount, 0..100
    mask_range: float = 0.0
    # Brightness-curve channel selector: 0=R, 1=G, 2=B, 3=all (v1's
    # tone_curve_lut channel argument; v4 always applies to all three).
    brightness_channel: int = 3
    curves: list = dataclasses.field(
        default_factory=lambda: [CurveState() for _ in range(4)]
    )

    # -- setters (clamping mirrors the reference) ---------------------------
    def set_tone(self, exposure=0.0, contrast=0, shadow=0, highlight=0, black=0, white=0):
        self.exposure = float(np.clip(exposure, -10.0, 10.0))
        self.contrast = int(np.clip(contrast, -100, 100))
        self.shadow = int(np.clip(shadow, -100, 100))
        self.highlight = int(np.clip(highlight, -100, 100))
        self.black = int(np.clip(black, -100, 100))
        self.white = int(np.clip(white, -100, 100))

    def set_whitebalance(self, temperature=0, tint=0):
        self.wb_temperature = int(np.clip(temperature, -100, 100))
        self.wb_tint = int(np.clip(tint, -100, 100))

    def set_vignette(self, value=0):
        self.vignette = int(np.clip(value, -100, 100))

    def set_lens_distortion(self, value=0):
        self.lens_distortion = int(np.clip(value, -100, 100))

    def set_sharpness(self, value=0):
        self.sharpness = int(np.clip(value, 0, 100))

    def set_curve(self, slot: int, control_x=None, control_y=None, raw_lut=None,
                  channel: Optional[int] = None):
        """Set one of the four curves; mirrors set_*_curve (lib.rs:300-479).

        ``channel`` (BRIGHTNESS slot only): apply the curve to one RGB
        channel (0/1/2) or all three (3, the default). Everything is
        validated before any state changes."""
        if channel is not None:
            if slot != BRIGHTNESS:
                raise curve_mod.CurveError(
                    "channel selection applies to the brightness curve only")
            if channel not in (0, 1, 2, 3):
                raise curve_mod.CurveError(f"bad curve channel {channel}")
        if raw_lut is not None:
            raw_lut = np.asarray(raw_lut, dtype=np.int32)
            if raw_lut.shape != (CURVE_RESOLUTION,):
                raise curve_mod.CurveError(
                    f"raw curve must have {CURVE_RESOLUTION} entries, got {raw_lut.shape}"
                )
            new_state = CurveState(raw_lut=raw_lut)
        else:
            if control_x is None or control_y is None:
                raise curve_mod.CurveError("need either raw_lut or control points")
            cx = np.asarray(control_x, dtype=np.int32)
            cy = np.asarray(control_y, dtype=np.int32)
            if cx.shape != cy.shape:
                raise curve_mod.CurveError("mismatched control point lengths")
            if cx.size < 2:
                raise curve_mod.CurveError(
                    f"need at least 2 control points, got {cx.size}")
            if cx.size > MAX_CTRL:
                raise curve_mod.CurveError(
                    f"too many control points: {cx.size} > {MAX_CTRL}")
            curve_mod.pchip_slopes_f32(cx, cy)  # monotonicity, eagerly
            new_state = CurveState(control_x=cx, control_y=cy)
        if channel is not None:
            self.brightness_channel = int(channel)
        self.curves[slot] = new_state

    def gains(self) -> tuple[float, float, float]:
        """WB slider -> RGB gains (gpu_image_processing.rs:236-238)."""
        t = self.wb_temperature / 100.0
        g = self.wb_tint / 100.0
        return (1.0 + 0.5 * t, 1.0 - 0.25 * g, 1.0 - 0.5 * t)

    # -- serialization ------------------------------------------------------
    def to_json(self) -> dict:
        return {
            "exposure": self.exposure,
            "contrast": self.contrast,
            "shadow": self.shadow,
            "highlight": self.highlight,
            "black": self.black,
            "white": self.white,
            "wb_temperature": self.wb_temperature,
            "wb_tint": self.wb_tint,
            "vignette": self.vignette,
            "lens_distortion": self.lens_distortion,
            "sharpness": self.sharpness,
            "mask_range": self.mask_range,
            "brightness_channel": self.brightness_channel,
            "curves": {
                CURVE_NAMES[i]: self.curves[i].to_json() for i in range(4)
            },
        }

    @classmethod
    def from_json(cls, d: dict) -> "EditParameters":
        p = cls()
        p.set_tone(
            d.get("exposure", 0.0), d.get("contrast", 0), d.get("shadow", 0),
            d.get("highlight", 0), d.get("black", 0), d.get("white", 0),
        )
        p.set_whitebalance(d.get("wb_temperature", 0), d.get("wb_tint", 0))
        p.set_vignette(d.get("vignette", 0))
        p.set_lens_distortion(d.get("lens_distortion", 0))
        p.set_sharpness(d.get("sharpness", 0))
        p.mask_range = float(d.get("mask_range", 0.0))
        p.brightness_channel = int(d.get("brightness_channel", 3))
        cd = d.get("curves", {})
        for i in range(4):
            c = cd.get(CURVE_NAMES[i])
            if c is None:
                continue  # keep the slot's default curve
            # Through set_curve: a preset's curves get the setters'
            # validation, so a bad preset fails here, not at render time.
            st = CurveState.from_json(c)
            p.set_curve(i, st.control_x, st.control_y, raw_lut=st.raw_lut)
        if "curves" not in d:
            # Reference v1 preset: flat *_curve_points lists of [x, y]
            # pairs (raw_photo_forge.py:2259-2283, aliases :2305-2315).
            for key, slot in _V1_CURVE_KEYS.items():
                pts = d.get(key)
                if pts:
                    try:
                        xs = [q[0] for q in pts]
                        ys = [q[1] for q in pts]
                    except (TypeError, IndexError) as e:
                        raise ValueError(
                            f"preset key {key!r} must hold [x, y] pairs"
                        ) from e
                    p.set_curve(slot, xs, ys)
        return p

    def dumps(self) -> str:
        return json.dumps(self.to_json())

    @classmethod
    def loads(cls, s: str) -> "EditParameters":
        return cls.from_json(json.loads(s))


@dataclasses.dataclass
class DevelopParams:
    """Packed per-mask parameters as stacked tensors (M = number of masks
    incl. the main mask, row 0; only the main row's vignette and
    lens_distortion are used, wgpu_shader.wgsl:270-276):

      gains:    f32 [M, 3]   WB (r, g, b) gains
      tone:     f32 [M, 6]   exposure(EV), contrast, shadow, highlight,
                             black, white — already /100-scaled
      vignette: f32 []       main-mask vignette slider value
      distortion: f32 []     main-mask lens-distortion slider value
      luts:     i32 [M, 4, 65536]   exact LUTs (anchor path)
      bright_channel: i32 [M]       brightness-curve channel (0/1/2, 3=all)
      breaks:   f32 [M, 4, S]       packed curve knots (kernel path)
      coeffs:   f32 [M, 4, S, 4]    packed curve monomial coefficients
      extent:   f32 [2]   true (height, width) when the image arrays are
                          bucket-padded; (0, 0) means "use the array shape".
      default_slots: M host tuples of (bright, hue, sat, light) booleans,
                          never uploaded: True where that mask's curve is
                          the slot's default, so the develop kernels take
                          its shortcut (bit-identical to evaluating it).
    """

    gains: torch.Tensor
    tone: torch.Tensor
    vignette: torch.Tensor
    distortion: torch.Tensor
    luts: torch.Tensor
    bright_channel: torch.Tensor
    breaks: torch.Tensor
    coeffs: torch.Tensor
    extent: torch.Tensor
    default_slots: tuple

    @property
    def num_masks(self) -> int:
        return self.gains.shape[0]

    def to(self, device) -> "DevelopParams":
        return dataclasses.replace(self, **{
            name: getattr(self, name).to(device) for name in _FIELDS})


_FIELDS = ("gains", "tone", "vignette", "distortion", "luts",
           "bright_channel", "breaks", "coeffs", "extent")
_INT_FIELDS = ("luts", "bright_channel")


def develop_params_from_numpy(d: dict, device) -> DevelopParams:
    """The port's DevelopParams from the JAX package's DevelopParams fields
    given as numpy arrays (same names, same layout) — so both packages
    compute on identical inputs. ``d["default_slots"]``, when present, is
    the shortcut table (``default_curve_slots``); without it no curve
    takes a shortcut."""
    out = {}
    for name in _FIELDS:
        arr = np.asarray(d[name])
        dtype = np.int32 if name in _INT_FIELDS else np.float32
        out[name] = torch.from_numpy(np.array(arr, dtype=dtype))
    m = out["gains"].shape[0]
    slots = d.get("default_slots", ((False,) * 4,) * m)
    if len(slots) != m or any(len(sl) != 4 for sl in slots):
        raise ValueError(f"default_slots needs {m} (bright, hue, sat, light) "
                         f"tuples, got {slots!r}")
    out["default_slots"] = tuple(tuple(bool(b) for b in sl) for sl in slots)
    return DevelopParams(**out).to(resolve_device(device))


def default_curve_slots(param_list) -> tuple:
    """Per-mask (bright, hue, sat, light) default-curve booleans — the slot
    table ``pack_params`` stores as ``DevelopParams.default_slots``: each
    default slot skips its packed-PCHIP sweep for that mask only in the
    develop kernels, bit-identical to evaluating the default curve."""
    return tuple(
        tuple(e.curves[slot].is_default(slot)
              for slot in (BRIGHTNESS, HUE, SATURATION, LIGHTNESS))
        for e in param_list
    )


def pack_params(
    param_list: list[EditParameters],
    extent: Optional[tuple[int, int]] = None,
    build_luts: bool = True,
    device=None,
) -> DevelopParams:
    """Stack per-mask EditParameters into a DevelopParams on ``device``
    (the card unless the caller asks for the CPU).

    Mask 0 must be the main mask. ``extent``: true (h, w) when image arrays
    are bucket-padded. ``build_luts=False`` packs placeholder [M, 4, 1]
    LUTs: the develop kernel evaluates curves from the packed coefficients
    and never reads ``luts`` (the exact-LUT anchor path requires
    build_luts=True). Packing is numpy; one upload per call. A curve is
    fitted only when its points or the padded segment count changed since
    its last pack (``CurveState.packed``). The curves' shortcut table,
    ``default_slots``, is ``default_curve_slots(param_list)``.
    """
    dev = resolve_device(device)
    if not param_list:
        raise ValueError("need at least the main mask parameters")
    m = len(param_list)
    # Pad packed curves to the next power of two above the largest actual
    # control-point count: each segment costs the kernel one compare and
    # five selects per pixel, so padding to MAX_CTRL would burn an order
    # of magnitude more work than typical <=8-point curves need.
    s = max(p.curves[slot].num_points(slot) for p in param_list for slot in range(4))
    s = min(1 << (s - 1).bit_length(), MAX_CTRL)
    gains = np.zeros((m, 3), dtype=np.float32)
    tone = np.zeros((m, 6), dtype=np.float32)
    bright_channel = np.full(m, 3, dtype=np.int32)
    luts = np.zeros(
        (m, 4, CURVE_RESOLUTION if build_luts else 1), dtype=np.int32
    )
    breaks = np.zeros((m, 4, s), dtype=np.float32)
    coeffs = np.zeros((m, 4, s, 4), dtype=np.float32)
    for i, p in enumerate(param_list):
        gains[i] = p.gains()
        bright_channel[i] = p.brightness_channel
        tone[i] = (
            p.exposure,
            p.contrast / 100.0,
            p.shadow / 100.0,
            p.highlight / 100.0,
            p.black / 100.0,
            p.white / 100.0,
        )
        for slot in range(4):
            if build_luts:
                luts[i, slot] = p.curves[slot].lut(slot)
            b, c = p.curves[slot].packed(slot, max_ctrl=s)
            breaks[i, slot] = b
            coeffs[i, slot] = c
    main = param_list[0]
    return develop_params_from_numpy(
        dict(gains=gains, tone=tone,
             vignette=np.float32(main.vignette),
             distortion=np.float32(main.lens_distortion),
             luts=luts, bright_channel=bright_channel,
             breaks=breaks, coeffs=coeffs,
             extent=np.asarray(extent if extent is not None else (0.0, 0.0),
                               dtype=np.float32),
             default_slots=default_curve_slots(param_list)),
        dev)
