"""External promptable-segmentation adapters for AI masks.

The JAX package's ``engine/segmenter.py`` (v1's SAM2 point-prompt masking,
python-legacy editor.py:43-44 and :1120-1159). No segmentation weights ship;
the adapters run any external promptable segmenter and feed its logits back
into the mask pipeline at full resolution:

* ``CallableSegmenter`` — an in-process callable ``fn(rgb_u8_hwc, (x, y))
  -> logits [h, w]`` (a loaded torch module, or a test stub);
* ``SubprocessSegmenter`` — ``cmd <image.png> <x> <y> <out.npy>`` per
  request; the command writes float logits (any resolution) to out.npy;
* ``TorchScriptSegmenter`` — a TorchScript module loaded once on the CPU,
  called as ``module(image_f32_chw_01, point_xy_tensor) -> logits``.

Labelled multi-point prompts (v1's predictor interface, editor.py:1147-1152):
``segment(rgb_u8, points, labels)`` with points [(x, y), ...] and labels
[1/0, ...]; the callable gets ``fn(rgb_u8, points, labels)``, the subprocess
``cmd <image.png> --points "x1,y1,l1;x2,y2,l2" <out.npy>``, the TorchScript
module ``module(image, points_f32 [N, 2], labels_f32 [N])``.
Single-include-point calls keep the single-point encodings above.

``segment_to_mask`` resamples the logits bilinearly to the image size on
an explicit torch device (``ops/geometry.resize_bilinear``); thresholding
stays in ``PhotoEditor.add_mask``. Pillow is imported only by the
subprocess adapter.
"""

from __future__ import annotations

import os
import subprocess
import tempfile

import numpy as np
import torch

from .._device import resolve_device
from .._errbase import PhotoEditorError


class SegmenterError(PhotoEditorError, RuntimeError):
    """External segmenter failed or returned malformed logits."""


class CallableSegmenter:
    def __init__(self, fn, name: str = "callable"):
        self.fn = fn
        self.name = name

    def segment(self, rgb_u8: np.ndarray, point_xy, labels=None) -> np.ndarray:
        if labels is None:
            out = self.fn(rgb_u8, tuple(point_xy))
        else:
            out = self.fn(rgb_u8, [tuple(p) for p in point_xy], list(labels))
        if isinstance(out, torch.Tensor):
            out = out.detach().cpu().numpy()
        out = np.asarray(out, dtype=np.float32)
        if out.ndim != 2:
            raise SegmenterError(
                f"segmenter {self.name!r} returned shape {out.shape}, "
                f"expected 2-D logits")
        return out


def _logits_2d(logits: np.ndarray) -> np.ndarray:
    if logits.ndim == 3:
        logits = logits[0]
    if logits.ndim != 2:
        raise SegmenterError(f"bad logits shape {logits.shape}")
    return logits.astype(np.float32)


class SubprocessSegmenter:
    """Run ``cmd image.png x y out.npy`` per request."""

    def __init__(self, cmd: list[str], timeout: float = 120.0):
        if not cmd:
            raise SegmenterError("empty segmenter command")
        self.cmd = list(cmd)
        self.timeout = timeout
        self.name = os.path.basename(self.cmd[0])

    def segment(self, rgb_u8: np.ndarray, point_xy, labels=None) -> np.ndarray:
        from PIL import Image as PILImage

        with tempfile.TemporaryDirectory(prefix="rpf_seg_") as d:
            img_path = os.path.join(d, "image.png")
            out_path = os.path.join(d, "logits.npy")
            PILImage.fromarray(rgb_u8).save(img_path)
            if labels is None:
                x, y = point_xy
                argv = [img_path, str(int(x)), str(int(y)), out_path]
            else:
                spec = ";".join(f"{int(x)},{int(y)},{int(lab)}"
                                for (x, y), lab in zip(point_xy, labels))
                argv = [img_path, "--points", spec, out_path]
            try:
                proc = subprocess.run(self.cmd + argv, capture_output=True,
                                      timeout=self.timeout)
            except (OSError, subprocess.TimeoutExpired) as e:
                raise SegmenterError(f"segmenter {self.name!r} failed: {e}") from e
            if proc.returncode != 0:
                raise SegmenterError(
                    f"segmenter {self.name!r} exited {proc.returncode}: "
                    f"{proc.stderr.decode(errors='replace')[-500:]}")
            try:
                logits = np.load(out_path)
            except (OSError, ValueError) as e:
                raise SegmenterError(
                    f"segmenter {self.name!r} wrote no readable logits") from e
        return _logits_2d(logits)


class TorchScriptSegmenter:
    """A TorchScript module on the CPU: module(image_f32_chw, point_f32[2])
    -> logits tensor."""

    def __init__(self, path: str):
        try:
            self.module = torch.jit.load(path, map_location="cpu")
        except (OSError, RuntimeError) as e:
            raise SegmenterError(f"cannot load TorchScript {path!r}: {e}") from e
        self.name = os.path.basename(path)

    def segment(self, rgb_u8: np.ndarray, point_xy, labels=None) -> np.ndarray:
        img = torch.from_numpy(rgb_u8.astype(np.float32).transpose(2, 0, 1) / 255.0)
        if labels is None:
            pt = torch.tensor([float(point_xy[0]), float(point_xy[1])])
        else:
            pt = torch.tensor([[float(x), float(y)] for x, y in point_xy])
            lab = torch.tensor([float(v) for v in labels])
        # torch.jit.Error (a script-level `raise` inside forward) is not a
        # RuntimeError: its MRO is (Error, Exception).
        try:
            with torch.no_grad():
                out = (self.module(img, pt) if labels is None
                       else self.module(img, pt, lab))
        except (RuntimeError, torch.jit.Error) as e:
            raise SegmenterError(f"segmenter {self.name!r} failed: {e}") from e
        return _logits_2d(out.detach().cpu().numpy())


def make_segmenter(spec):
    """Build an adapter from a spec: a callable, a command list/string
    (subprocess), or a {"type": ..., ...} dict."""
    if spec is None:
        return None
    if callable(spec):
        return CallableSegmenter(spec)
    if isinstance(spec, str):
        # shlex, not str.split: a quoted executable path may hold spaces.
        import shlex

        return SubprocessSegmenter(shlex.split(spec))
    if isinstance(spec, (list, tuple)):
        return SubprocessSegmenter(list(spec))
    if isinstance(spec, dict):
        kind = spec.get("type", "subprocess")
        if kind == "subprocess":
            if "cmd" not in spec:
                raise SegmenterError("subprocess segmenter spec needs 'cmd'")
            return SubprocessSegmenter(spec["cmd"], spec.get("timeout", 120.0))
        if kind == "torchscript":
            if "path" not in spec:
                raise SegmenterError("torchscript segmenter spec needs 'path'")
            return TorchScriptSegmenter(spec["path"])
        raise SegmenterError(f"unknown segmenter type {kind!r}")
    raise SegmenterError(f"cannot build a segmenter from {type(spec).__name__}")


def segment_to_mask(segmenter, rgb_u8: np.ndarray, point_xy, labels=None,
                    device=None) -> np.ndarray:
    """Run the adapter and resample its logits to the image resolution on
    ``device`` (the card unless the caller asks for the CPU); host f32
    [h, w]. ``labels`` switches to the labelled multi-point protocol with
    ``point_xy`` a list of (x, y) points."""
    h, w = rgb_u8.shape[:2]
    if labels is None:
        # The two-argument call keeps duck-typed adapters with a
        # segment(rgb, point) method working for single-point prompts.
        logits = segmenter.segment(rgb_u8, point_xy)
    else:
        logits = segmenter.segment(rgb_u8, point_xy, labels=labels)
    if logits.shape != (h, w):
        from ..ops.geometry import resize_bilinear

        src = torch.from_numpy(np.ascontiguousarray(logits, np.float32))
        logits = resize_bilinear(src[None].to(resolve_device(device)), h, w)[0]
        logits = logits.cpu().numpy()
    return logits
