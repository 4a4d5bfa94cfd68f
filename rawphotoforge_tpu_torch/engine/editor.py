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
``open(lens_correct=...)`` applies a lens profile resolved from EXIF
(``io/lensdb`` -> ``ops/lenscorr``) to the original at load time.
Regional masks come as finished logits (``add_mask``) or from a point
prompt on the current render: colour similarity, the geodesic smart select
(``ops/masking``; its flood runs on the sweep kernel, ``kernels/geodesic``)
or an external segmenter (``engine/segmenter``); ``mask_overlay_srgb``
shows one. ``save_hdr_dng`` exports the scene-linear render as a float
LinearRaw DNG.

Opening is split in two, as in the JAX package: ``open_host`` parses the
container and makes the host instant preview (``engine/instant``) with no
device work, and ``from_host`` uploads and builds the session on a given
device (the server runs it on a background thread while the instant
preview and ``engine/hostdev`` renders carry the UI). ``export_render`` /
``export_encode`` split an export into the render (under the server's
lock) and the fetch + encode (outside it); an uncropped JPEG renders on
the bucket grid and goes through the JPEG device wires with its true
extent.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

import numpy as np
import torch

from .._device import resolve_device
from .._errbase import PhotoEditorError
from ..core.color import linear_to_srgb, srgb_to_linear
from ..core.params import EditParameters, pack_params
from ..io import image_io
from ..kernels import fused, geometry
from ..ops import develop as dev
from ..ops.geometry import (resize_bilinear, resize_bilinear_extents,
                            resize_long_edge_shape)
from ..ops.stats import (clipping_stats, clipping_stats_rect, histogram_rgbl,
                         histogram_rgbl_rect)
from ..utils.profiling import span
from . import prewarm

FULL, MID, LOW = "full", "mid", "low"
DEFAULT_MID_LONG_EDGE = 1280  # uiPreviewSize default (web/main.ts:31-35)
DEFAULT_LOW_LONG_EDGE = 400   # dragPreviewSize default

# Arrays are padded up to multiples of this, as in the JAX package, so a
# session's buffers have the same shapes as the reference's; positional
# effects normalize by the true extent (DevelopParams.extent).
SHAPE_BUCKET = 128

# Geometry work the renders have done, since the counts were last set to 0:
# one per lens-distortion warp and one per unsharp mask ``_geo_at`` runs.
COUNTS = {"warps": 0, "unsharps": 0}


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


def pad_to_bucket_np(arr: np.ndarray, bucket: int = SHAPE_BUCKET) -> np.ndarray:
    """Host-side edge-pad of [..., H, W] up to multiples of ``bucket``
    (``io/image_io.pad_to_bucket_np`` with the session's bucket)."""
    return image_io.pad_to_bucket_np(arr, bucket)


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


def _normalize_points(point_xy, points_xy, labels):
    """The point prompt of the three selection APIs: a single ``point_xy``
    OR labelled ``points_xy``/``labels`` (v1 predictor interface,
    python-legacy editor.py:1147-1152). Returns ([(x, y), ...], [1/0, ...]);
    labels default to all-include."""
    if points_xy is not None:
        pts = [(int(p[0]), int(p[1])) for p in points_xy]
        if not pts:
            raise ValueError("points_xy is empty")
        if labels is None:
            labs = [1] * len(pts)
        else:
            labs = [1 if int(v) else 0 for v in labels]
            if len(labs) != len(pts):
                raise ValueError(f"{len(labs)} labels for {len(pts)} points")
        if point_xy is not None:
            raise ValueError("pass point_xy OR points_xy, not both")
        return pts, labs
    if point_xy is None:
        raise ValueError("a point prompt is required")
    return [(int(point_xy[0]), int(point_xy[1]))], [1]


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


class HostOpen:
    """Result of ``PhotoEditor.open_host``: the host-decoded image (with
    its instant preview and metadata) plus the pending device phase. The
    server answers /open from this and runs ``PhotoEditor.from_host`` on a
    background thread."""

    __slots__ = ("decoded", "preview_reason")

    def __init__(self, decoded, preview_reason):
        self.decoded = decoded             # io.image_io.HostDecoded
        self.preview_reason = preview_reason

    @property
    def shape(self) -> tuple[int, int]:
        return tuple(self.decoded.shape)

    @property
    def exif(self) -> dict:
        return self.decoded.exif

    @property
    def instant(self):
        """sRGB u8 HWC instant preview, or None."""
        return self.decoded.instant

    @property
    def instant_linear(self):
        """Small linear planes [3, h, w] f32 matching ``instant`` (the
        engine/hostdev era-render source), recovered from the u8 instant
        when the decode had no cheap linear form."""
        lin = self.decoded.instant_linear
        if lin is None and self.decoded.instant is not None:
            from . import instant as _instant

            lin = self.decoded.instant_linear = _instant.linear_from_srgb_u8(
                self.decoded.instant)
        return lin


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
        # The decode error when a RAW opened on its embedded preview.
        self.opened_from_preview = None
        # Name of the auto-applied lens profile (open(lens_correct=True))
        # and whether it came from an approximate-provenance database (the
        # bundled starter set) rather than calibrated lensfun data.
        self.applied_lens_profile = None
        self.applied_lens_approximate = False
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
        # Host instant preview (sRGB u8 HWC, <= MID long edge) set by
        # from_host when the decode had host pixels; None otherwise.
        self.instant_srgb_u8: Optional[np.ndarray] = None
        self._instant_jpeg = None  # (quality, bytes) cache

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
    def open(cls, path: str, lens_correct=False, lens_db_paths=None,
             preview_fallback: bool = True, **kwargs) -> "PhotoEditor":
        """Open an image file (display formats, 16-bit PPM, DNG and the
        vendor RAW containers). With ``lens_correct`` truthy, resolve the
        EXIF camera/lens against the lens database (the bundled profiles
        plus any lensfun XML in ``lens_db_paths``) and apply the matched
        profile: ``applied_lens_profile`` names it and
        ``applied_lens_approximate`` gives its provenance;
        ``lens_correct="calibrated-only"`` skips approximate profiles.
        ``preview_fallback``: see ``from_bytes``."""
        resolve_device(kwargs.get("device"))  # the no-card error comes first
        fmt = image_io.format_for_path(path)
        with open(path, "rb") as f:
            data = f.read()
        ed = cls.from_bytes(data, fmt, preview_fallback=preview_fallback,
                            **kwargs)
        if lens_correct:
            from ..io.lensdb import LensDatabase

            prof = LensDatabase.load(lens_db_paths).profile_from_exif(
                ed.exif,
                calibrated_only=(lens_correct == "calibrated-only"))
            if prof is not None:
                ed.apply_lens_profile(prof)
                ed.applied_lens_profile = prof.name
                ed.applied_lens_approximate = bool(prof.approximate)
        return ed

    @classmethod
    def from_bytes(cls, data: bytes, fmt: str, device=None,
                   preview_fallback: bool = True, **kwargs) -> "PhotoEditor":
        """Decode container bytes on the host, upload bucket-padded planes
        to ``device`` and build the session (a RAW develops on the bucket
        grid where it can, ``io/raw.develop_raw_image_padded``). When RAW
        sensor data cannot decode (a vendor entropy codec, or a decode the
        embedded-preview gate refuses) and the file carries a
        camera-rendered JPEG preview, the session opens on the preview,
        with ``opened_from_preview`` recording the decode error, unless
        ``preview_fallback`` is False. ``open_host`` then ``from_host``."""
        dev_ = resolve_device(device)  # the no-card error comes first
        prewarm.build_async(dev_)  # the session's kernels build during the decode
        ho = cls.open_host(
            data, fmt, preview_fallback=preview_fallback,
            mid_long_edge=int(kwargs.get("mid_long_edge",
                                         DEFAULT_MID_LONG_EDGE)))
        return cls.from_host(ho, device=dev_, **kwargs)

    @classmethod
    def open_host(cls, data: bytes, fmt: str, preview_fallback: bool = True,
                  mid_long_edge: int = DEFAULT_MID_LONG_EDGE) -> HostOpen:
        """Host phase of ``from_bytes``: container parse, EXIF and the
        instant preview — every file-content error surfaces here, with no
        device work. Pass the result to ``from_host`` (possibly on another
        thread) to run the device phase."""
        preview_reason = None
        try:
            hd = image_io.decode_image_host(data, fmt,
                                            instant_long_edge=mid_long_edge)
        except PhotoEditorError as e:
            from ..io.raw import decode_embedded_preview_host

            hd = (decode_embedded_preview_host(
                      data, instant_long_edge=mid_long_edge)
                  if preview_fallback and fmt == "DNG" else None)
            if hd is None:
                raise
            preview_reason = str(e)
        return HostOpen(hd, preview_reason)

    @classmethod
    def from_host(cls, ho: HostOpen, device=None, **kwargs) -> "PhotoEditor":
        """Device phase: upload the bucket-padded planes to ``device`` (the
        card unless the caller asks for the CPU) and build the session.
        Safe to call off-thread: it touches no shared state and uses only
        the device it is given."""
        dev_ = resolve_device(device)
        hd = ho.decoded
        ed = cls(hd.upload_padded(dev_, SHAPE_BUCKET), exif=hd.exif,
                 true_shape=hd.shape, device=dev_, **kwargs)
        ed.opened_from_preview = ho.preview_reason
        ed.instant_srgb_u8 = hd.instant
        return ed

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

    def add_similarity_mask(self, name: str, point_xy=None,
                            color_tolerance: float = 0.1,
                            spatial_sigma: float = 0.0, points_xy=None,
                            labels=None) -> None:
        """Point-prompted selection by OKLab similarity to the colour at
        ``point_xy`` (x, y) on the current FULL render (v1 re-applies edits
        before predicting, raw_photo_forge.py:2409-2411), thresholded by
        mask_range like any mask. Labelled prompts: ``points_xy`` [(x, y),
        ...] with ``labels`` [1/0, ...] (ops/masking.combine_labeled_logits)."""
        from ..ops.masking import similarity_mask, similarity_mask_points

        pts, labs = _normalize_points(point_xy, points_xy, labels)
        base = srgb_to_linear(self.apply(FULL, cropped=False))
        sigma = spatial_sigma if spatial_sigma > 0 else 1.0
        if len(pts) == 1 and labs[0]:
            x, y = pts[0]
            logits = similarity_mask(base, (y, x), color_tolerance, sigma,
                                     spatial_falloff=spatial_sigma > 0)
        else:
            logits = similarity_mask_points(
                base, [(y, x) for x, y in pts], labs, color_tolerance, sigma,
                spatial_falloff=spatial_sigma > 0)
        h, w = self.shape
        self.add_mask(name, logits[:h, :w].cpu().numpy())

    def add_smart_mask(self, name: str, point_xy=None, tolerance: float = 0.15,
                       edge_weight: float = 12.0, points_xy=None,
                       labels=None) -> None:
        """Point-prompted object selection: the edge-aware geodesic flood
        (ops/masking.smart_select_mask) over the current MID render,
        upsampled to FULL (v1's resize-to-levels flow for SAM masks,
        raw_photo_forge.py:2427-2474). It respects connectivity and stops
        at contrast boundaries. Labelled prompts grow the flood from every
        include seed; exclude seeds run a competing flood
        (ops/masking.smart_select_points)."""
        from ..ops.masking import smart_select_mask, smart_select_points

        pts, labs = _normalize_points(point_xy, points_xy, labels)
        mh, mw = self._extents[MID]
        h, w = self.shape

        def to_level(x, y):  # full-res prompt -> MID coordinates (y, x)
            return (min(mh - 1, max(0, int(y * mh / h))),
                    min(mw - 1, max(0, int(x * mw / w))))

        base = srgb_to_linear(self.apply(MID, cropped=False))
        inc = [to_level(x, y) for (x, y), lab in zip(pts, labs) if lab]
        exc = [to_level(x, y) for (x, y), lab in zip(pts, labs) if not lab]
        if not inc:
            raise ValueError("smart selection needs at least one include point")
        if len(inc) == 1 and not exc:
            logits = smart_select_mask(base, inc[0], tolerance=tolerance,
                                       edge_weight=edge_weight)
        else:
            logits = smart_select_points(base, inc, exc or None,
                                         tolerance=tolerance,
                                         edge_weight=edge_weight)
        if (mh, mw) != (h, w):
            logits = resize_bilinear(logits[None], h, w)[0]
        self.add_mask(name, logits.cpu().numpy())

    def add_model_mask(self, name: str, point_xy=None, segmenter=None,
                       points_xy=None, labels=None) -> None:
        """Point-prompted AI mask through an external segmenter adapter
        (v1's SAM2 workflow, editor.py:1120-1159): the model sees the
        current FULL render as u8, its logits are resampled to full
        resolution and thresholded by mask_range. ``segmenter`` is an
        adapter or a spec for engine/segmenter.make_segmenter; labelled
        prompts pass through to it."""
        from ..utils.transfer import fetch_u8_hwc
        from .segmenter import make_segmenter, segment_to_mask

        seg = (segmenter if hasattr(segmenter, "segment")
               else make_segmenter(segmenter))
        pts, labs = _normalize_points(point_xy, points_xy, labels)
        rgb_u8 = fetch_u8_hwc(self.apply(FULL, cropped=False))
        if len(pts) == 1 and labs[0]:
            logits = segment_to_mask(seg, rgb_u8, pts[0], device=self.device)
        else:
            logits = segment_to_mask(seg, rgb_u8, pts, labels=labs,
                                     device=self.device)
        self.add_mask(name, logits)

    # -- lens profile correction (load-time, python-legacy editor.py:425-711)
    def apply_lens_profile(self, profile) -> None:
        """Apply a LensProfile (devignette -> TCA -> distortion) to the
        session's original at every pyramid level built so far: the
        corrected image becomes the new original all edits derive from."""
        from ..ops.lenscorr import apply_profile

        # Small images alias MID/LOW to the FULL tensor: correct each
        # unique buffer once and share the result across aliased levels.
        done: dict[int, torch.Tensor] = {}
        for level in list(self._originals):
            src = self._originals[level]
            key = id(src)
            if key not in done:
                done[key] = apply_profile(src, profile, self._extents[level])
            self._originals[level] = done[key]
        self._geo_cache.clear()
        self._invalidate(masks_changed=False)

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
            with span("editor.pack_params"):
                self._packed = pack_params([m.params for m in self.masks],
                                           build_luts=want_luts,
                                           device=self.device)
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
        with span("editor.geometry"):
            # Warp, edge replication and unsharp: one kernel launch on the
            # card, the plain ops on the CPU (kernels/geometry). The kernel
            # takes contiguous planes; a portrait photo's oriented planes
            # can be a transposed view.
            out = geometry.geometry_sharpen(
                self._original_at(level).contiguous(), key[0], key[1] / 100.0 * 2.0,
                self._extents[level])
            if key[0] != 0.0:
                COUNTS["warps"] += 1
            if key[1] != 0.0:
                COUNTS["unsharps"] += 1
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
        with span("editor.render"):
            params = self._packed_params(level)
            geo = self._geo_at(level)
            # Single-mask sessions pass no mask array at all.
            masks = None if len(self.masks) == 1 else self._masks_at(level)
            if self._use_exact_path():
                return dev.develop_post_geo(geo, params, masks)
            # Untouched curves take the kernel's shortcuts by the params'
            # slot table; with every hue/sat/light curve untouched the
            # OKLCH round trip is skipped too (<= ~2e-3).
            return fused.develop_post_geo_fused(geo, params, masks,
                                                identity_oklch=True)

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

    # -- instant (host-side) previews ----------------------------------------
    def instant_preview_jpeg(self, quality: int = 88) -> Optional[bytes]:
        """JPEG bytes of the host instant preview, or None: no device work
        (the approximate preview engine/instant made at decode time,
        encoded on the host and cached). It shows the ORIGINAL image, not
        pending edits."""
        if self.instant_srgb_u8 is None:
            return None
        img = self._instant_cropped()
        # The cache keys on quality too.
        cached = self._instant_jpeg
        if cached is not None and self.crop_rect is None \
                and cached[0] == quality:
            return cached[1]
        from . import instant

        jpeg = instant.encode_instant_jpeg(img, quality=quality)
        if self.crop_rect is None:
            self._instant_jpeg = (quality, jpeg)
        return jpeg

    def instant_histogram(self) -> Optional[np.ndarray]:
        """[4, 256] histogram of the instant preview, or None (the host
        stand-in for histogram())."""
        if self.instant_srgb_u8 is None:
            return None
        from . import instant

        return instant.instant_histogram(self._instant_cropped())

    def _instant_cropped(self) -> np.ndarray:
        img = self.instant_srgb_u8
        cs = crop_slice_for_grid(self.crop_rect, self.shape, img.shape[:2])
        return img if cs is None else img[cs[0]:cs[1], cs[2]:cs[3]]

    def _crop_slice(self, level: str):
        """Level-space (cy0, cy1, cx0, cx1) of the crop rect, or None."""
        return crop_slice_for_grid(self.crop_rect, self.shape,
                                   self._extents[level])

    def mask_overlay_srgb(self, name: str, level: str = MID,
                          cropped: bool = True) -> torch.Tensor:
        """The current render with the named mask tinted red (python-legacy
        get_mask_image, editor.py:1173-1189); ``cropped=False`` gives the
        full frame."""
        from ..ops.masking import mask_overlay

        idx = next((i for i, m in enumerate(self.masks) if m.name == name), None)
        if idx is None:
            raise MaskNotFound(f"the specified mask '{name}' does not exist")
        srgb = self.apply(level, cropped=cropped)
        h, w = self._extents[level]
        mask = self._masks_at(level)[idx][:h, :w].to(torch.float32)
        cs = self._crop_slice(level) if cropped else None
        if cs is not None:
            mask = mask[cs[0]:cs[1], cs[2]:cs[3]]
        return mask_overlay(srgb, mask)

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
        synthesized from the parsed metadata (None when there is none).
        When an approximate-provenance lens profile was applied, the
        synthesized payload says so in its Software tag."""
        if self._exif_bytes is not None:
            return self._exif_bytes
        exif = self.exif
        if self.applied_lens_approximate and self.applied_lens_profile:
            exif = dict(exif)
            exif["Software"] = (
                "rawphotoforge-tpu (lens correction: APPROXIMATE bundled "
                f"profile '{self.applied_lens_profile}')")
        return image_io.build_exif_bytes(exif)

    def export_render(self, fmt: str):
        """The device-render half of a (non-DNG) export: the render and the
        route, consumed by ``export_encode``. An uncropped JPEG takes the
        bucket-padded render with its true extent (the JPEG device wires
        walk the padded block grid and emit only the true blocks);
        everything else the full-frame render plus a host crop slice.
        Renders are new tensors that later edits never write to, so
        ``export_encode`` may run without the session lock."""
        host_crop = self._crop_slice(FULL)
        if fmt == "JPEG" and host_crop is None:
            img, true_shape = self.apply_padded(FULL)
            return ("sparse", img, true_shape, None)
        return ("dense", self.apply(FULL, cropped=False), None, host_crop)

    def export_encode(self, snapshot, fmt: str, quality: int = 95,
                      exif_bytes: bytes | None = None,
                      on_stage=None) -> bytes:
        """Encode an ``export_render`` snapshot (fetch + host encode);
        ``on_stage(name)`` is called entering each stage."""
        kind, img, true_shape, host_crop = snapshot
        if kind == "sparse":
            from ..io import jpegenc

            return jpegenc.encode_jpeg(
                img, quality=quality, exif_bytes=exif_bytes,
                on_stage=on_stage, true_shape=true_shape)
        return image_io.encode_image(
            img, fmt, quality=quality, exif_bytes=exif_bytes,
            on_stage=on_stage, host_crop=host_crop)

    def save_bytes(self, fmt: str, quality: int = 95) -> bytes:
        """The export's bytes: ``export_render`` then ``export_encode``."""
        return self.export_encode(
            self.export_render(fmt), fmt, quality=quality,
            exif_bytes=self.export_exif_bytes())

    def hdr_dng_render(self):
        """The device half of the HDR DNG export: the FULL scene-linear
        render (sRGB OETF undone, full frame) on the device, the crop slice
        to apply on the host after the fetch, and an EXIF snapshot."""
        return (srgb_to_linear(self.apply(FULL, cropped=False)),
                self._crop_slice(FULL), dict(self.exif))

    def hdr_dng_bytes(self, dtype=np.float16) -> bytes:
        """The edited image as a floating-point LinearRaw DNG (deflate, TN3
        predictor): the linear render, so reopening it as a RAW and
        developing with identity WB/matrix reproduces this session's
        render."""
        linear, crop, exif = self.hdr_dng_render()
        return hdr_dng_encode(linear, exif, dtype=dtype, host_crop=crop)

    def save_hdr_dng(self, path: str, dtype=np.float16) -> None:
        data = self.hdr_dng_bytes(dtype)  # render before touching the file
        with open(path, "wb") as f:
            f.write(data)

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


def hdr_dng_encode(linear, exif: dict, dtype=np.float16, on_stage=None,
                   host_crop=None) -> bytes:
    """The host half of the HDR DNG export: fetch the scene-linear render
    and encode it as a float LinearRaw DNG (deflate, TN3 predictor).
    ``on_stage(name)`` is called entering the 'fetch' and 'encode' stages;
    ``host_crop`` (r0, r1, c0, c1) is applied after the fetch."""
    from ..io.dng import RawImage, write_dng
    from ..utils.transfer import fetch_np

    if on_stage:
        on_stage("fetch")
    hwc = fetch_np(linear).transpose(1, 2, 0).astype(dtype)
    if host_crop is not None:
        r0, r1, c0, c1 = host_crop
        hwc = np.ascontiguousarray(hwc[r0:r1, c0:c1])
    if on_stage:
        on_stage("encode")
    raw = RawImage(mosaic=hwc, pattern="RGB", black_level=0.0, white_level=1.0,
                   wb_gains=(1.0, 1.0, 1.0), xyz_to_cam=None, exif=dict(exif))
    return write_dng(raw, compression=8)
