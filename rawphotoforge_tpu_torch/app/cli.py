"""Command-line develop tool of the port (the JAX package's ``app/cli.py``
``develop`` subcommand, with the same edit flags).

Usage:
  python -m rawphotoforge_tpu_torch.app.cli develop IN OUT [edit flags]
      [--device cuda|cpu]

Edit flags mirror the UI sliders: exposure EV in [-6, 6]; all other
sliders integer [-100, 100]; curves as comma-separated control points
"x:y,x:y,...". The session runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from .._device import synchronize
from .._errbase import PhotoEditorError
from ..core.params import BRIGHTNESS, HUE, SATURATION, LIGHTNESS
from ..engine.editor import FULL, PhotoEditor
from ..io import image_io


def _parse_curve(spec: str):
    try:
        xs, ys = [], []
        for pair in spec.split(","):
            x, y = pair.split(":")
            xs.append(int(x))
            ys.append(int(y))
    except ValueError as e:
        raise PhotoEditorError(
            f"bad curve spec {spec!r} (want 'x:y,x:y,...'): {e}") from e
    return np.asarray(xs, dtype=np.int32), np.asarray(ys, dtype=np.int32)


def _add_edit_flags(p: argparse.ArgumentParser):
    p.add_argument("--exposure", type=float, default=0.0)
    p.add_argument("--contrast", type=int, default=0)
    p.add_argument("--shadow", type=int, default=0)
    p.add_argument("--highlight", type=int, default=0)
    p.add_argument("--black", type=int, default=0)
    p.add_argument("--white", type=int, default=0)
    p.add_argument("--wb-temperature", type=int, default=0)
    p.add_argument("--wb-tint", type=int, default=0)
    p.add_argument("--vignette", type=int, default=0)
    p.add_argument("--lens-distortion", type=int, default=0)
    p.add_argument("--sharpness", type=int, default=0)
    p.add_argument("--crop", type=str, default=None,
                   help='crop rect "x0,y0,x1,y1" in source pixels')
    p.add_argument("--brightness-curve", type=str, default=None,
                   help='control points "x:y,x:y,..." in [0,65535]')
    p.add_argument("--hue-curve", type=str, default=None)
    p.add_argument("--saturation-curve", type=str, default=None)
    p.add_argument("--lightness-curve", type=str, default=None)
    p.add_argument("--preset", type=str, default=None,
                   help="JSON preset file (overrides other edit flags)")
    p.add_argument("--save-preset", type=str, default=None)
    p.add_argument("--quality", type=int, default=95)
    p.add_argument("--bit-depth", type=int, default=8, choices=(8, 16),
                   help="16 -> 48-bit PNG (output must be .png or .ppm)")
    p.add_argument("--exact-path", action="store_true",
                   help="render with the exact-LUT anchor instead of the "
                        "develop kernel")
    p.add_argument("--histogram", action="store_true",
                   help="print the 4x256 histogram summary")
    p.add_argument("--lens-correct", nargs="?", const="auto", default=None,
                   choices=["auto", "calibrated-only"],
                   help="lens-profile correction (not ported yet)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the session (default: the card)")


def _set_edit_flags(target, args):
    target.set_tone(args.exposure, args.contrast, args.shadow,
                    args.highlight, args.black, args.white)
    target.set_whitebalance(args.wb_temperature, args.wb_tint)
    target.set_vignette(args.vignette)
    target.set_lens_distortion(args.lens_distortion)
    target.set_sharpness(args.sharpness)
    for slot, spec in (
        (BRIGHTNESS, args.brightness_curve),
        (HUE, args.hue_curve),
        (SATURATION, args.saturation_curve),
        (LIGHTNESS, args.lightness_curve),
    ):
        if spec:
            xs, ys = _parse_curve(spec)
            target.set_curve(slot, xs, ys)


def _apply_edit_flags(ed: PhotoEditor, args):
    if args.crop:
        try:
            x0, y0, x1, y1 = (int(v) for v in args.crop.split(","))
            ed.set_crop(x0, y0, x1, y1)
        except ValueError as e:
            raise PhotoEditorError(
                f"bad crop {args.crop!r} (want 'x0,y0,x1,y1' inside the "
                f"image): {e}") from e
    if args.preset:
        ed.load_preset(args.preset)
        return
    _set_edit_flags(ed, args)


def cmd_develop(args) -> int:
    if args.lens_correct:
        raise PhotoEditorError(
            "--lens-correct is not ported yet (ROADMAP.md, still to port: "
            "ops/lenscorr and io/lensdb)")
    if os.path.splitext(args.input)[1].lower() in image_io.RAW_EXTENSIONS:
        raise PhotoEditorError(image_io.NOT_PORTED_RAW)
    if args.output.lower().endswith(".dng"):
        raise PhotoEditorError(
            "the .dng HDR export is not ported yet (ROADMAP.md, still to "
            "port: HDR DNG export)")
    if args.bit_depth == 16 and not args.output.lower().endswith(
            (".png", ".ppm")):
        raise image_io.ImageIOError(
            "--bit-depth 16 needs a .png or .ppm output")
    fmt = image_io.format_for_path(args.output)
    if fmt == "DNG":
        raise image_io.ImageIOError(
            f"cannot develop to {os.path.splitext(args.output)[1]}; use a "
            "display format (.jpg/.png/.webp/.tif/.ppm)")
    t0 = time.perf_counter()
    ed = PhotoEditor.open(args.input, use_kernel=not args.exact_path,
                          device=args.device)
    t_load = time.perf_counter() - t0
    _apply_edit_flags(ed, args)
    t1 = time.perf_counter()
    ed.apply(FULL, cropped=False)
    synchronize(ed.device)
    t_dev = time.perf_counter() - t1
    ed.save(args.output, quality=args.quality, bit_depth=args.bit_depth)
    t_total = time.perf_counter() - t0
    h, w = ed.shape
    mpix = h * w / 1e6
    print(
        f"developed {w}x{h} ({mpix:.1f} MPix) on {ed.device}: load "
        f"{t_load * 1e3:.0f} ms, develop {t_dev * 1e3:.1f} ms "
        f"({mpix / t_dev:.0f} MPix/s), total {t_total * 1e3:.0f} ms "
        f"-> {args.output}"
    )
    if args.save_preset:
        ed.save_preset(args.save_preset)
    if args.histogram:
        hist = ed.histogram(FULL)
        for name, row in zip(("R", "G", "B", "Y"), hist):
            peak = int(np.argmax(row))
            print(f"  hist {name}: peak bin {peak}, mass {int(row.sum())}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="rawphotoforge-tpu-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_dev = sub.add_parser("develop", help="develop one image")
    p_dev.add_argument("input")
    p_dev.add_argument("output")
    _add_edit_flags(p_dev)
    p_dev.set_defaults(fn=cmd_develop)
    args = ap.parse_args(argv)
    try:
        return args.fn(args)
    except (PhotoEditorError, FileNotFoundError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
