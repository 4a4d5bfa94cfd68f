"""PhotoEditor: the non-destructive editing session, on torch tensors.

The JAX package's ``engine/editor.py`` for the interactive develop frame
(rust/photo-editor/src/lib.rs:77-516 plus the UIs' policies: preview
pyramid web/main.ts:82-91, presets raw_photo_forge.py:2259-2341, mask
invert raw_photo_forge.py:2552):

* holds the linear-light original as device-resident planar f32,
  bucket-padded, plus lazily built MID/LOW copies (3-level pyramid);
* per-mask EditParameters; mask "main" (index 0, all ones) always exists;
* ``apply()`` is a pure function of (original, params, masks): packed
  params are rebuilt only when an edit changes them, and the geometry
  stage (lens-distortion warp + unsharp) is cached per level;
* a render runs the develop kernel (``kernels/fused``) — or, with
  ``use_kernel=False`` or a raw-LUT curve, the exact-LUT anchor.

Sessions live on ``device`` (the card unless the caller asks for the CPU).
Similarity/smart/model masks, lens profiles, host instant previews, the
sparse JPEG export and HDR DNG export are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

import numpy as np
import torch

from .._device import resolve_device
from .._errbase import PhotoEditorError
from ..core.color import linear_to_srgb
from ..core.params import EditParameters, default_curve_slots, pack_params
from ..io import image_io
from ..kernels import fused
from ..ops import develop as dev
from ..ops.geometry import (resize_bilinear, resize_bilinear_extents,
                            resize_long_edge_shape)
from ..ops.sharpen import unsharp_mask
from ..ops.stats import (clipping_stats, clipping_stats_rect, histogram_rgbl,
                         histogram_rgbl_rect)

FULL, MID, LOW = "full", "mid", "low"
DEFAULT_MID_LONG_EDGE = 1280  # uiPreviewSize default (web/main.ts:31-35)
DEFAULT_LOW_LONG_EDGE = 400   # dragPreviewSize default

# Arrays are padded up to multiples of this, as in the JAX package, so a
# session's buffers have the same shapes as the reference's; positional
# effects normalize by the true extent (DevelopParams.extent).
SHAPE_BUCKET = 128


def crop_slice_for_grid(crop_rect, full_hw, grid_hw):
    """FULL-coordinate crop rect -> (r0, r1, c0, c1) slice of an (h, w)
    render grid, or None. Int-truncated starts; ends floored but kept
    strictly past the start so the slice is never empty."""
    if crop_rect is None:
        return None
    fh, fw = full_hw
    h, w = grid_hw
    x0, y0, x1, y1 = crop_rect
    sy, sx = h / fh, w / fw
    return (int(y0 * sy), max(int(y0 * sy) + 1, int(y1 * sy)),
            int(x0 * sx), max(int(x0 * sx) + 1, int(x1 * sx)))


def bucket_shape(h: int, w: int, bucket: int = SHAPE_BUCKET) -> tuple[int, int]:
    """The padded (h, w) of an (h, w) image."""
    return (h + (-h) % bucket, w + (-w) % bucket)


def _pad_to_bucket(arr: torch.Tensor, edge: bool) -> torch.Tensor:
    """Pad the trailing two dims up to bucket multiples: edge replication
    for image planes (stencils see plausible neighbors), zeros for masks
    (pad pixels are never selected)."""
    *lead, h, w = arr.shape
    ph, pw = bucket_shape(h, w)
    if (ph, pw) == (h, w):
        return arr
    if not edge:
        return torch.nn.functional.pad(arr, (0, pw - w, 0, ph - h))
    rows = torch.clamp(torch.arange(ph, device=arr.device), max=h - 1)
    cols = torch.clamp(torch.arange(pw, device=arr.device), max=w - 1)
    return arr[..., rows, :][..., cols]


class MaskNotFound(PhotoEditorError, KeyError):
    """Mirrors PhotoEditorError::MaskNotFound (errors.rs)."""


class _Mask:
    __slots__ = ("name", "data_full", "params", "_levels", "logits")

    def __init__(self, name: str, data_full, params: EditParameters,
                 logits=None):
        self.name = name
        self.data_full = data_full  # u8 [H, W] on the device, 0/1
        self.params = params
        self.logits = logits        # host f32 pre-threshold values
        self._levels: dict[str, torch.Tensor] = {}


def _not_ported(what: str, item: str) -> PhotoEditorError:
    return PhotoEditorError(
        f"{what} is not ported yet (ROADMAP.md, still to port: {item})")


class PhotoEditor:
    """A single-image editing session with a 3-level preview pyramid."""

    def __init__(
        self,
        planes,
        exif: Optional[dict] = None,
        mid_long_edge: int = DEFAULT_MID_LONG_EDGE,
        low_long_edge: int = DEFAULT_LOW_LONG_EDGE,
        use_kernel: bool = True,
        true_shape: Optional[tuple] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        planes = torch.as_tensor(planes, dtype=torch.float32).to(self.device)
        if planes.ndim != 3 or planes.shape[0] != 3:
            raise ValueError(f"expected planar [3, H, W] image, got {tuple(planes.shape)}")
        if true_shape is not None:
            # ``planes`` is ALREADY bucket-padded and ``true_shape`` is the
            # real extent.
            h, w = int(true_shape[0]), int(true_shape[1])
            if tuple(planes.shape[1:]) != bucket_shape(h, w):
                raise ValueError(
                    f"true_shape {true_shape} does not bucket-pad to the "
                    f"given planes shape {tuple(planes.shape[1:])}")
            full_padded = planes
        else:
            _, h, w = planes.shape
            full_padded = _pad_to_bucket(planes, edge=True)
        self.exif = dict(exif or {})
        # Raw EXIF blob for write-back into exports.
        self._exif_bytes = self.exif.pop("_exif_bytes", None)
        self._use_kernel = bool(use_kernel)
        # Non-destructive crop rect (x0, y0, x1, y1) in FULL pixel coords.
        self.crop_rect = None
        # Per level: bucket-padded planes (MID/LOW built lazily) + true extent.
        self._originals: dict[str, torch.Tensor] = {FULL: full_padded}
        self._extents: dict[str, tuple[int, int]] = {FULL: (h, w)}
        for level, edge in ((MID, mid_long_edge), (LOW, low_long_edge)):
            if max(h, w) > edge:
                self._extents[level] = resize_long_edge_shape(h, w, edge)
            else:
                self._extents[level] = (h, w)

        # The main mask is all-ones by construction; no plane is stored.
        self.masks: list[_Mask] = [_Mask("main", None, EditParameters())]

        # Dirty-stage caches.
        self._packed = None            # DevelopParams, rebuilt on edit
        self._packed_with_luts = None  # build_luts state of _packed
        self._mask_stack: dict[str, torch.Tensor] = {}
        self._geo_cache: dict[str, tuple[tuple, torch.Tensor]] = {}
        self._rendered: dict[str, tuple[int, torch.Tensor]] = {}
        self._version = 0              # bumped on every edit

    @property
    def use_kernel(self) -> bool:
        return self._use_kernel

    @use_kernel.setter
    def use_kernel(self, value: bool) -> None:
        # The two paths agree to curve-evaluation tolerance, not bit
        # exactly: a render cached on the other path must not be served.
        value = bool(value)
        if value != self._use_kernel:
            self._use_kernel = value
            self._rendered.clear()

    # -- construction -------------------------------------------------------
    @classmethod
    def open(cls, path: str, lens_correct=False, **kwargs) -> "PhotoEditor":
        """Open an image file (display formats and 16-bit PPM)."""
        if lens_correct:
            raise _not_ported("lens-profile correction",
                              "ops/lenscorr and io/lensdb")
        fmt = image_io.format_for_path(path)
        with open(path, "rb") as f:
            data = f.read()
        return cls.from_bytes(data, fmt, **kwargs)

    @classmethod
    def from_bytes(cls, data: bytes, fmt: str, device=None,
                   **kwargs) -> "PhotoEditor":
        """Decode container bytes on the host, upload bucket-padded planes
        to ``device`` and build the session."""
        dev_ = resolve_device(device)
        hd = image_io.decode_image_host(data, fmt)
        return cls(hd.upload_padded(dev_, SHAPE_BUCKET), exif=hd.exif,
                   true_shape=hd.shape, device=dev_, **kwargs)

    @classmethod
    def from_rgb_f32(cls, hwc: np.ndarray, **kwargs) -> "PhotoEditor":
        """From an HWC float32 linear RGB array (lib.rs:125-166)."""
        arr = np.ascontiguousarray(np.asarray(hwc, dtype=np.float32).transpose(2, 0, 1))
        return cls(torch.from_numpy(arr), **kwargs)

    # -- geometry -----------------------------------------------------------
    @property
    def shape(self) -> tuple[int, int]:
        """True (unpadded) image dimensions."""
        return self._extents[FULL]

    def level_shape(self, level: str) -> tuple[int, int]:
        """True (unpadded) dimensions at a pyramid level."""
        return self._extents[level]

    def _original_at(self, level: str) -> torch.Tensor:
        """Bucket-padded original planes at a pyramid level, built lazily
        with the extent-aware resize (pad values are never sampled)."""
        cached = self._originals.get(level)
        if cached is not None:
            return cached
        h, w = self._extents[FULL]
        dh, dw = self._extents[level]
        if (dh, dw) == (h, w):
            out = self._originals[FULL]  # small image: the level aliases FULL
        else:
            out = resize_bilinear_extents(self._originals[FULL],
                                          (h, w, dh, dw), bucket_shape(dh, dw))
        self._originals[level] = out
        return out

    # -- mask management ----------------------------------------------------
    def _find(self, name: Optional[str]) -> _Mask:
        name = name or "main"
        for m in self.masks:
            if m.name == name:
                return m
        raise MaskNotFound(f"the specified mask '{name}' does not exist")

    def add_mask(self, name: str, data: np.ndarray) -> None:
        """Add a regional mask; binarized at the main mask_range threshold
        (v >= mask_range -> 1, lib.rs:481-499). ``data`` is [H, W] float at
        full resolution; the logits stay on the host for re-thresholding."""
        if not name:
            raise ValueError("mask name must be non-empty")
        if name == "main" or any(m.name == name for m in self.masks):
            raise ValueError(f"mask name {name!r} already exists")
        thr = self._find("main").params.mask_range
        arr = np.asarray(data, dtype=np.float32)
        if arr.shape != self.shape:
            raise ValueError(f"mask shape {arr.shape} != image shape {self.shape}")
        self.masks.append(_Mask(name, self._binarize(arr, thr),
                                EditParameters(), logits=arr))
        self._invalidate(masks_changed=True)

    def _binarize(self, logits: np.ndarray, thr: float) -> torch.Tensor:
        return torch.from_numpy((logits >= thr).astype(np.uint8)).to(self.device)

    def remove_mask(self, name: str) -> None:
        """Remove a regional mask; 'main' is not removable (lib.rs:501-505)."""
        if name == "main":
            return
        self._find(name)  # raises MaskNotFound for typos
        self.masks = [m for m in self.masks if m.name != name]
        self._invalidate(masks_changed=True)

    def invert_mask(self, name: str) -> None:
        """Invert a regional mask in place (raw_photo_forge.py:2552-2607)."""
        if name == "main":
            return
        m = self._find(name)
        m.data_full = 1 - m.data_full
        m.logits = None  # inversion detaches the mask from its logits
        m._levels.clear()
        self._invalidate(masks_changed=True)

    def mask_names(self) -> list[str]:
        return [m.name for m in self.masks]

    # -- edits --------------------------------------------------------------
    def params(self, mask_name: Optional[str] = None) -> EditParameters:
        """The live EditParameters for a mask — read-only by contract:
        mutate through the editor's setters, which invalidate caches."""
        return self._find(mask_name).params

    def _edited(self):
        self._invalidate(masks_changed=False)

    def set_tone(self, exposure=0.0, contrast=0, shadow=0, highlight=0,
                 black=0, white=0, mask_name=None):
        self._find(mask_name).params.set_tone(
            exposure, contrast, shadow, highlight, black, white)
        self._edited()

    def set_whitebalance(self, temperature=0, tint=0, mask_name=None):
        self._find(mask_name).params.set_whitebalance(temperature, tint)
        self._edited()

    def set_vignette(self, value=0):
        self._find(None).params.set_vignette(value)
        self._edited()

    def set_lens_distortion(self, value=0):
        self._find(None).params.set_lens_distortion(value)
        self._edited()

    def set_sharpness(self, value=0):
        self._find(None).params.set_sharpness(value)
        self._edited()

    def set_mask_range(self, value: float):
        """Change the binarization threshold AND re-threshold every regional
        mask from its stored logits (masks whose logits are gone keep
        their data)."""
        self._find(None).params.mask_range = float(value)
        changed = False
        for m in self.masks[1:]:
            if m.logits is not None:
                m.data_full = self._binarize(m.logits, value)
                m._levels.clear()
                changed = True
        if changed:
            self._invalidate(masks_changed=True)

    def set_curve(self, slot, control_x=None, control_y=None, raw_lut=None,
                  mask_name=None, channel=None):
        self._find(mask_name).params.set_curve(
            slot, control_x, control_y, raw_lut, channel=channel)
        self._edited()

    def set_crop(self, x0: int, y0: int, x1: int, y1: int):
        """Non-destructive crop in FULL pixel coordinates (exclusive ends),
        applied to renders at every level; it slices the cached uncropped
        render, so it invalidates nothing."""
        h, w = self.shape
        x0, x1 = sorted((int(x0), int(x1)))
        y0, y1 = sorted((int(y0), int(y1)))
        x0 = max(0, x0)
        y0 = max(0, y0)
        x1 = min(w, x1)
        y1 = min(h, y1)
        if x1 - x0 < 1 or y1 - y0 < 1:
            raise ValueError(f"empty crop rect ({x0},{y0})-({x1},{y1})")
        self.crop_rect = (x0, y0, x1, y1)

    def clear_crop(self):
        self.crop_rect = None

    @property
    def cropped_shape(self) -> tuple[int, int]:
        if self.crop_rect is None:
            return self.shape
        x0, y0, x1, y1 = self.crop_rect
        return (y1 - y0, x1 - x0)

    def reset(self):
        """Drop all regional masks, reset main params (lib.rs:227-235), and
        clear the crop."""
        self.masks = [m for m in self.masks if m.name == "main"]
        self.masks[0].params = EditParameters()
        self.crop_rect = None
        self._invalidate(masks_changed=True)

    # -- cache plumbing -----------------------------------------------------
    def _invalidate(self, masks_changed: bool):
        self._version += 1
        self._packed = None
        self._rendered.clear()
        if masks_changed:
            self._mask_stack.clear()

    def _use_exact_path(self) -> bool:
        """The exact-LUT anchor renders when asked for, or when some curve
        is a raw 65536-entry LUT (which the packed-PCHIP refit can only
        approximate)."""
        return not self.use_kernel or any(
            c.raw_lut is not None for m in self.masks for c in m.params.curves)

    def _packed_params(self, level: str):
        want_luts = self._use_exact_path()
        if self._packed is None or self._packed_with_luts != want_luts:
            # The kernel never reads the exact LUTs: skip building them.
            self._packed = pack_params([m.params for m in self.masks],
                                       build_luts=want_luts, device=self.device)
            self._packed_with_luts = want_luts
        # Same packed stack for every level; only the true extent differs.
        return dataclasses.replace(
            self._packed,
            extent=torch.tensor(self._extents[level], dtype=torch.float32,
                                device=self.device))

    def _masks_at(self, level: str) -> torch.Tensor:
        """The [M, Hb, Wb] u8 mask stack at a level: the develop consumers
        only test mask != 0, so u8 rows cost a quarter of f32 rows."""
        if level not in self._mask_stack:
            h, w = self.level_shape(level)
            rows = []
            for m in self.masks:
                if level not in m._levels:
                    if m.name == "main":
                        m._levels[level] = torch.ones(
                            (h, w), dtype=torch.uint8, device=self.device)
                    elif tuple(m.data_full.shape) == (h, w):
                        m._levels[level] = m.data_full
                    else:
                        resized = resize_bilinear(
                            m.data_full[None].to(torch.float32), h, w)[0]
                        # Preserve binarization after interpolation.
                        m._levels[level] = (resized >= 0.5).to(torch.uint8)
                rows.append(m._levels[level])
            self._mask_stack[level] = _pad_to_bucket(torch.stack(rows),
                                                     edge=False)
        return self._mask_stack[level]

    def _geo_at(self, level: str) -> torch.Tensor:
        """Geometry + sharpen stage output, cached per
        (level, distortion, sharpness)."""
        main = self._find("main").params
        key = (float(main.lens_distortion), float(main.sharpness))
        cached = self._geo_cache.get(level)
        if cached is not None and cached[0] == key:
            return cached[1]
        out = self._original_at(level)
        th, tw = self._extents[level]
        if key[0] != 0.0:
            out = dev.geometry_stage(out, key[0], self._extents[level])
            if out.shape[1] > th or out.shape[2] > tw:
                # The warp blackens the bucket pad; restore edge
                # replication before the stencil reads it.
                out = dev.replicate_true_edges(out, th, tw)
        if key[1] != 0.0:
            out = unsharp_mask(out, key[1] / 100.0 * 2.0)
        self._geo_cache[level] = (key, out)
        return out

    # -- rendering ----------------------------------------------------------
    def apply(self, level: str = FULL, cropped: bool = True) -> torch.Tensor:
        """Render the edit stack at a pyramid level -> sRGB f32 [3, h, w]
        (true, unpadded dimensions; the crop applied unless
        ``cropped=False``). The uncropped render is cached per edit
        version and level."""
        cached = self._rendered.get(level)
        if cached is None or cached[0] != self._version:
            out = self._render_padded(level)
            h, w = self._extents[level]
            self._rendered[level] = (self._version, out[:, :h, :w])
        out = self._rendered[level][1]
        cs = self._crop_slice(level) if cropped else None
        if cs is not None:
            out = out[:, cs[0]:cs[1], cs[2]:cs[3]]
        return out

    def apply_padded(self, level: str = FULL):
        """The bucket-padded render + true extent: ``(planes [3, Hb, Wb],
        (h, w))``. Not cached."""
        return self._render_padded(level), self._extents[level]

    def _render_padded(self, level: str) -> torch.Tensor:
        """Render the edit stack at ``level`` on the bucket-padded grid."""
        params = self._packed_params(level)
        geo = self._geo_at(level)
        # Single-mask sessions pass no mask array at all.
        masks = None if len(self.masks) == 1 else self._masks_at(level)
        if self._use_exact_path():
            return dev.develop_post_geo(geo, params, masks)
        # Untouched curves take the kernel's shortcuts, per curve family:
        # default brightness curves skip the brightness sweeps; default
        # hue/sat/light curves also skip the OKLCH round trip
        # (identity_oklch, <= ~2e-3). Multi-mask sessions pass the
        # per-mask slot table too (bit-identical to the general kernel).
        slots = default_curve_slots([m.params for m in self.masks])
        db = all(sl[0] for sl in slots)
        doc = all(sl[1] and sl[2] and sl[3] for sl in slots)
        return fused.develop_post_geo_fused(
            geo, params, masks,
            main_mask_all_ones=True,
            default_bright_curves=db,
            default_oklch_curves=doc,
            identity_oklch=doc,
            default_curve_slots=slots if len(self.masks) > 1 else None,
        )

    def histogram(self, level: str = MID) -> np.ndarray:
        """[4, 256] R/G/B/gray histogram of the current render at ``level``
        (the cropped region when a crop rect is set)."""
        cs = self._crop_slice(level)
        if cs is None:
            return histogram_rgbl(self.apply(level)).cpu().numpy()
        return histogram_rgbl_rect(self.apply(level, cropped=False),
                                   cs).cpu().numpy()

    def clipping(self, level: str = MID) -> dict:
        cs = self._crop_slice(level)
        if cs is None:
            stats = clipping_stats(self.apply(level))
        else:
            stats = clipping_stats_rect(self.apply(level, cropped=False), cs)
        return {k: float(v) for k, v in stats.items()}

    def original_srgb(self, level: str = MID,
                      cropped: bool = True) -> torch.Tensor:
        """sRGB-encoded *unedited* original at a pyramid level (the
        press-to-compare view, main.gd:602-609)."""
        h, w = self._extents[level]
        lin = self._original_at(level)[:, :h, :w]
        out = torch.clamp(linear_to_srgb(torch.clamp(lin, 0.0, 1.0)), 0.0, 1.0)
        cs = self._crop_slice(level) if cropped else None
        if cs is not None:
            out = out[:, cs[0]:cs[1], cs[2]:cs[3]]
        return out

    def _crop_slice(self, level: str):
        """Level-space (cy0, cy1, cx0, cx1) of the crop rect, or None."""
        return crop_slice_for_grid(self.crop_rect, self.shape,
                                   self._extents[level])

    def get_srgb_f32(self, level: str = FULL) -> np.ndarray:
        """HWC float32 sRGB render (the wasm get_rgb_f32 surface)."""
        from ..utils.transfer import fetch_np

        return fetch_np(self.apply(level)).transpose(1, 2, 0)

    # -- export -------------------------------------------------------------
    def save(self, path: str, quality: int = 95, bit_depth: int = 8) -> None:
        """Full-resolution render + encode (web/main.ts:910-954: always
        re-render FULL before export), the original EXIF written back.
        ``bit_depth=16`` selects the 48-bit PNG encoder for .png outputs
        (PPM is inherently 16-bit). The bytes exist before the file opens,
        so a failure never truncates an existing file."""
        fmt = image_io.format_for_path(path)
        if fmt == "DNG":
            raise _not_ported("HDR DNG export", "HDR DNG export")
        if bit_depth == 16:
            if fmt == "PNG":
                fmt = "PNG16"
            elif fmt != "PPM16":
                raise image_io.ImageIOError(
                    f"16-bit export supports .png/.ppm, not {fmt}")
        elif bit_depth != 8:
            raise image_io.ImageIOError(f"bit depth {bit_depth}")
        data = self.save_bytes(fmt, quality=quality)
        with open(path, "wb") as f:
            f.write(data)

    def export_exif_bytes(self):
        """The EXIF payload exports carry: the original blob, or one
        synthesized from the parsed metadata (None when there is none)."""
        if self._exif_bytes is not None:
            return self._exif_bytes
        return image_io.build_exif_bytes(self.exif)

    def save_bytes(self, fmt: str, quality: int = 95) -> bytes:
        """Encode the FULL render (dense path: full-frame render, crop
        applied on the host after the fetch)."""
        return image_io.encode_image(
            self.apply(FULL, cropped=False), fmt, quality=quality,
            exif_bytes=self.export_exif_bytes(),
            host_crop=self._crop_slice(FULL))

    # -- presets / session checkpointing ------------------------------------
    def preset_json(self) -> str:
        """Serialize the complete edit state (all masks' parameters and the
        crop) — the JAX package's preset format."""
        return json.dumps(
            {"version": 1,
             "crop": list(self.crop_rect) if self.crop_rect else None,
             "masks": [
                 {"name": m.name, "params": m.params.to_json()} for m in self.masks
             ]}
        )

    def load_preset_json(self, s: str) -> None:
        """Restore edit parameters; regional-mask params apply only to masks
        that still exist by name. All-or-nothing: everything is validated
        before any state changes."""
        obj = json.loads(s)
        if "masks" not in obj:
            # Reference v1 preset: one flat EditParameters dict -> main.
            params = EditParameters.from_json(obj)
            self.masks[0].params = params
            self._invalidate(masks_changed=False)
            self.set_mask_range(params.mask_range)
            return
        by_name = {m["name"]: m["params"] for m in obj["masks"]}
        staged = [
            (m, EditParameters.from_json(by_name[m.name]))
            for m in self.masks if m.name in by_name
        ]
        crop = obj.get("crop")
        if crop:
            try:
                self.set_crop(*crop)
            except (TypeError, ValueError) as e:
                raise ValueError(f"preset crop rect {crop!r} is invalid "
                                 f"for this image: {e}") from e
        else:
            self.crop_rect = None
        for m, params in staged:
            m.params = params
        self._invalidate(masks_changed=False)
        self.set_mask_range(self._find("main").params.mask_range)

    def save_preset(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.preset_json())

    def load_preset(self, path: str) -> None:
        with open(path) as f:
            self.load_preset_json(f.read())
