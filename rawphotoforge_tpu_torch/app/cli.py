"""Command-line tool of the port (the JAX package's ``app/cli.py``
``info``, ``develop``, ``batch``, ``convert``, ``devices`` and ``serve``
subcommands, with the same flags).

Usage:
  python -m rawphotoforge_tpu_torch.app.cli info IMAGE [--preview OUT.jpg]
      [--verify-decode] [--lens-db PATH] [--device cuda|cpu]
  python -m rawphotoforge_tpu_torch.app.cli develop IN OUT [edit flags]
      [--device cuda|cpu]
  python -m rawphotoforge_tpu_torch.app.cli batch IN_DIR OUT_DIR
      [edit flags] [--no-mesh] [--device cuda|cpu]
  python -m rawphotoforge_tpu_torch.app.cli convert IN OUT.dng
      [--codec ljpeg|deflate] [--tile HxW] [--no-preview]
  python -m rawphotoforge_tpu_torch.app.cli devices
  python -m rawphotoforge_tpu_torch.app.cli serve [IMAGE] [--port 8080]
      [--segmenter CMD] [--no-host-drag] [--lens-correct] [--lens-db PATH]
      [--device cuda|cpu]

``develop`` to a ``.dng`` writes the scene-linear render as a float
LinearRaw DNG (``PhotoEditor.save_hdr_dng``). ``convert`` and ``devices``
are host commands; ``info`` decodes the image on ``--device``.

``batch`` with more than one rank — run under ``torchrun`` (one process a
card), or on a host that shows several cards (it then spawns one rank a
card) — shards the images over the ranks (``_batch_mesh_path``), unless
``--no-mesh``, ``--preset`` or ``--crop`` is given:

  torchrun --nproc-per-node N -m rawphotoforge_tpu_torch.app.cli batch IN OUT

``batch`` of a directory of RAW files (DNG, CR2, ARW, RW2, RAF, ...)
develops each one through the one-pass RAW kernel (``kernels/raw_pipeline``)
— a DNG with OpcodeList3 warps through demosaic, warp and the develop
kernel — and writes JPEGs through the packed device wire (``io/jpegenc``,
``io/jpegbits``: the JPEG kernels of ``kernels/jpeg_wire`` emit the finished
scan, the host writes headers and stuffing); other inputs, and
``--lens-correct``, go through the editor.

Edit flags mirror the UI sliders: exposure EV in [-6, 6]; all other
sliders integer [-100, 100]; curves as comma-separated control points
"x:y,x:y,...". ``develop``, ``batch`` and ``serve`` run on the card the
settings' ``device_index`` names (``engine/session``) unless ``--device``
says otherwise (``--device cpu`` for the CPU); ``info`` on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import datetime
import glob
import os
import sys
import time

import numpy as np

from .._device import resolve_device
from .._errbase import PhotoEditorError
from ..core.params import (BRIGHTNESS, HUE, SATURATION, LIGHTNESS,
                           EditParameters, pack_params)
from ..engine.editor import FULL, PhotoEditor
from ..io import image_io
from ..utils.profiling import fetch_sync


# How long a rank of a multi-rank batch waits for its peers (the
# rendezvous, each collective).
_WORLD_TIMEOUT = datetime.timedelta(seconds=600)


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
                   help="auto-apply a lens profile matched from EXIF; "
                        "'calibrated-only' skips the bundled approximate "
                        "profiles (only real lensfun DBs via --lens-db)")
    p.add_argument("--lens-db", type=str, action="append", default=None,
                   help="extra lensfun XML file/dir (repeatable)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device of the session (default: the card the "
                        "settings' device_index names)")


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


def cmd_info(args) -> int:
    if args.preview:
        from ..io.dng import extract_preview

        with open(args.image, "rb") as f:
            jpeg = extract_preview(f.read())
        if jpeg is None:
            print("no embedded JPEG preview found")
        else:
            with open(args.preview, "wb") as f:
                f.write(jpeg)
            print(f"embedded preview: {len(jpeg)} bytes -> {args.preview}")
    from ..io.raw import decode_embedded_preview, is_raw_image

    try:
        planes, exif = image_io.read_image(args.image, device=args.device)
    except PhotoEditorError as e:
        if not is_raw_image(args.image):
            raise
        with open(args.image, "rb") as f:
            res = decode_embedded_preview(f.read(), args.device)
        if res is None:
            raise
        planes, exif = res
        print(f"sensor data not decodable ({e}); dimensions are the "
              f"embedded camera preview's")
    _, h, w = planes.shape
    print(f"{args.image}: {w}x{h} ({w * h / 1e6:.1f} MPix)")
    for k, v in sorted(exif.items()):
        if k.startswith("_"):
            continue  # _exif_bytes: the raw APP1 blob, not a field
        print(f"  {k}: {v}")
    if exif.get("LensModel") or exif.get("Model"):
        # What --lens-correct would apply, with its provenance.
        from ..io.lensdb import LensDatabase

        prof = LensDatabase.load(args.lens_db).profile_from_exif(exif)
        if prof is not None:
            prov = (" (APPROXIMATE bundled profile, not calibrated data)"
                    if prof.approximate else " (calibrated)")
            print(f"  lens profile match: {prof.name}{prov}")
    if args.verify_decode:
        # Silent-wrong detector for vendor RAW decodes: the developed sensor
        # data against the file's own embedded camera preview.
        from ..io.vendor_raw import CORRELATION_GATE, preview_correlation

        if not is_raw_image(args.image):
            print("verify-decode: not a RAW container, nothing to verify")
            return 0
        try:
            with open(args.image, "rb") as f:
                corr = preview_correlation(f.read(), device=args.device)
        except PhotoEditorError as e:
            print(f"verify-decode: sensor data not decodable ({e})")
            return 0
        if corr is None:
            print("verify-decode: no embedded preview to correlate against")
            return 0
        verdict = ("ok" if corr >= CORRELATION_GATE
                   else f"SUSPECT (below gate {CORRELATION_GATE})")
        print(f"verify-decode: preview correlation {corr:.4f} -> {verdict}")
        if corr < CORRELATION_GATE:
            return 1
    return 0


def _session_device(args):
    """``--device`` when given; else the card the settings' device_index
    names (the adapter picker, settings_window.gd:46-49), else the default
    card. Without a card and without ``--device`` this raises."""
    if args.device is not None:
        return resolve_device(args.device)
    from ..engine.session import Settings

    return resolve_device(Settings.load().select_device())


def cmd_develop(args) -> int:
    # A .dng output exports the scene-linear render (float LinearRaw DNG);
    # everything else is checked as a display format before rendering.
    hdr_out = args.output.lower().endswith(".dng")
    if args.bit_depth == 16 and not args.output.lower().endswith(
            (".png", ".ppm")):
        raise image_io.ImageIOError(
            "--bit-depth 16 needs a .png or .ppm output")
    if not hdr_out and image_io.format_for_path(args.output) == "DNG":
        # A vendor RAW extension maps to "DNG"; only .dng is the HDR export.
        raise image_io.ImageIOError(
            f"cannot develop to {os.path.splitext(args.output)[1]}; use .dng "
            "for scene-linear HDR or a display format "
            "(.jpg/.png/.webp/.tif/.ppm)")
    args.device = _session_device(args)
    t0 = time.perf_counter()
    ed = PhotoEditor.open(args.input, use_kernel=not args.exact_path,
                          lens_correct=args.lens_correct,
                          lens_db_paths=args.lens_db, device=args.device)
    t_load = time.perf_counter() - t0
    if ed.opened_from_preview:
        print(f"WARNING: sensor data not decodable "
              f"({ed.opened_from_preview}); editing the embedded "
              f"camera-rendered JPEG preview instead")
    if args.lens_correct:
        print(f"lens profile: {_lens_note(ed)}")
    _apply_edit_flags(ed, args)
    t1 = time.perf_counter()
    fetch_sync(ed.apply(FULL, cropped=False))
    t_dev = time.perf_counter() - t1
    if hdr_out:
        ed.save_hdr_dng(args.output)
    else:
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


def _lens_note(ed) -> str:
    """The applied lens profile with its provenance: a bundled approximate
    correction must be told apart from a calibrated lensfun profile."""
    if not ed.applied_lens_profile:
        return "no match"
    if ed.applied_lens_approximate:
        return (f"{ed.applied_lens_profile} (APPROXIMATE bundled "
                "profile, not calibrated data; use --lens-db with a real "
                "lensfun DB or --lens-correct calibrated-only)")
    return ed.applied_lens_profile


def _params_from_args(args) -> EditParameters:
    p = EditParameters()
    _set_edit_flags(p, args)
    return p


def _batch_out_name(path, output_dir, taken) -> str:
    """Collision-safe output path: RAW+JPEG shooting pairs (IMG_0001.CR2
    + IMG_0001.JPG) must not overwrite each other's develop."""
    stem = os.path.splitext(os.path.basename(path))[0]
    name = stem + ".jpg"
    if name in taken:
        ext = os.path.splitext(path)[1].lstrip(".").lower()
        name = f"{stem}_{ext}.jpg"
        i = 2
        while name in taken:
            name = f"{stem}_{ext}_{i}.jpg"
            i += 1
    taken.add(name)
    return os.path.join(output_dir, name)


def edit_planes(planes, edit: EditParameters, extent):
    """Sharpen + the fused develop kernel on already-linear planes."""
    from ..kernels import fused
    from ..ops.sharpen import unsharp_mask

    packed = pack_params([edit], extent=extent, build_luts=False,
                         device=planes.device)
    if edit.sharpness:
        planes = unsharp_mask(planes, edit.sharpness / 100.0 * 2.0)
    # masks=None: the all-ones main mask is never materialized. Untouched
    # hue/sat/light curves skip the OKLCH round trip (<= 3e-3).
    return fused.develop_post_geo_fused(planes, packed, None,
                                        identity_oklch=True)


def raw_fast_render(raw, edit: EditParameters, device):
    """One RAW of the batch fast path -> its sRGB render [3, H, W] after
    DefaultCrop and orientation. A Bayer or X-Trans mosaic takes the
    one-pass RAW kernel (one launch); LinearRaw data, a DNG with
    OpcodeList3 warps (they run between the demosaic and the edit stack),
    and a DefaultCrop under a vignette or sharpen (those must see the
    cropped frame, as ``develop`` does) take the generic demosaic +
    develop kernel. As in the JAX package's batch, an OpcodeList3 radial
    vignette is not applied here (``develop`` applies it)."""
    from ..io.raw import cam2srgb_for, normalized_mosaic, with_effective_wb
    from ..kernels.raw_pipeline import raw_develop_fused
    from ..ops import demosaic as dm
    from ..ops.geometry import orient_exif
    from ..ops.lenscorr import warp_fisheye, warp_rectilinear

    raw = with_effective_wb(raw)
    h, w = raw.mosaic.shape[:2]
    mos01 = normalized_mosaic(raw, raw.mosaic, device)
    cam = cam2srgb_for(raw)
    crop_first = raw.default_crop is not None and (
        edit.vignette != 0 or edit.sharpness != 0)
    warped = raw.warp_rectilinear is not None or raw.warp_fisheye is not None
    if raw.pattern != "RGB" and not warped and not crop_first:
        packed = pack_params([edit], extent=(h, w), build_luts=False,
                             device=device)
        srgb = raw_develop_fused(
            mos01, raw.wb_gains, cam, packed,
            np.float32(edit.sharpness / 100.0 * 2.0), pattern=raw.pattern,
            identity_oklch=True)
    else:
        if raw.pattern == "RGB":
            planes = dm.develop_linear_raw(mos01, raw.wb_gains, cam)
        else:
            planes = dm.develop_raw(mos01, raw.wb_gains, cam,
                                    pattern=raw.pattern)
        if raw.warp_rectilinear is not None:
            planes = warp_rectilinear(planes, *raw.warp_rectilinear)
        if raw.warp_fisheye is not None:
            planes = warp_fisheye(planes, *raw.warp_fisheye)
        if crop_first:
            cx, cy, cw, ch = raw.default_crop
            srgb = edit_planes(planes[:, cy : cy + ch, cx : cx + cw], edit,
                               (ch, cw))
        else:
            srgb = edit_planes(planes, edit, (h, w))
    if raw.default_crop is not None and not crop_first:
        cx, cy, cw, ch = raw.default_crop
        srgb = srgb[:, cy : cy + ch, cx : cx + cw]
    return orient_exif(srgb, raw.orientation)


def _batch_raw_fast_path(paths, args) -> int:
    """Batch-develop RAW files: host parse (LJPEG decode included), upload
    + normalize, one RAW-kernel launch per image, then the JPEG device
    wire (blocks, Huffman and pack kernels; the scan fetched) and the
    native assembler."""
    from ..io import jpegenc
    from ..io.raw import decode_embedded_preview, parse_raw

    dev = resolve_device(args.device)
    edit = _params_from_args(args)
    t0 = time.perf_counter()
    total_pix = 0
    taken: set = set()
    for p in paths:
        with open(p, "rb") as f:
            data = f.read()
        preview_note = ""
        try:
            raw = parse_raw(data)
        except PhotoEditorError as e:
            # Sensor data that cannot decode (a vendor entropy codec, or a
            # decode the embedded-preview gate refuses): develop the
            # camera-rendered preview instead of aborting the batch.
            res = decode_embedded_preview(data, dev)
            if res is None:
                raise
            raw = None
            planes, pv_exif = res
            preview_note = f"  [embedded preview; sensor decode: {e}]"
        if raw is None:
            srgb = edit_planes(planes, edit, tuple(planes.shape[1:]))
            exif_b = (pv_exif.get("_exif_bytes")
                      or image_io.build_exif_bytes(pv_exif))
        else:
            srgb = raw_fast_render(raw, edit, dev)
            exif_b = image_io.build_exif_bytes(raw.exif)
        out = _batch_out_name(p, args.output_dir, taken)
        body = jpegenc.encode_jpeg(srgb, quality=args.quality,
                                   exif_bytes=exif_b)
        with open(out, "wb") as f:
            f.write(body)
        # The ENCODED frame (post-DefaultCrop) counts, not the mosaic.
        total_pix += srgb.shape[1] * srgb.shape[2]
        print(f"  {p} -> {out}{preview_note}")
    dt = time.perf_counter() - t0
    n = len(paths)
    print(f"batch (fused raw path) on {dev}: {n} images, "
          f"{total_pix / 1e6:.4g} MPix in {dt:.1f} s "
          f"({total_pix / 1e6 / dt:.4g} MPix/s end-to-end)")
    return 0


def cmd_batch(args) -> int:
    import torch.distributed as dist

    from ..io.raw import is_raw_image

    if (dist.is_available() and not dist.is_initialized()
            and int(os.environ.get("WORLD_SIZE", "1")) > 1):
        # Under torchrun: join its world for this batch (nccl on the cards,
        # gloo with --device cpu) and leave it after.
        dist.init_process_group(_world_backend(args.device), init_method="env://",
                                timeout=_WORLD_TIMEOUT)
        try:
            return cmd_batch(args)
        finally:
            dist.destroy_process_group()
    if args.bit_depth != 8:
        print("batch exports JPEG; --bit-depth 16 is develop-only "
              "(use develop with a .png output)", file=sys.stderr)
        return 1
    paths = sorted(
        p for p in glob.glob(os.path.join(args.input_dir, "*"))
        if os.path.splitext(p)[1].lower() in image_io.SUPPORTED_EXTENSIONS
        or is_raw_image(p))
    if not paths:
        print(f"no images found in {args.input_dir}", file=sys.stderr)
        return 1
    os.makedirs(args.output_dir, exist_ok=True)
    # More than one rank: shard the batch over them (SURVEY §2.6). Presets
    # (they can add masks and crops the shared-edit step does not model)
    # and --crop stay on the single-device loop, as in the JAX package.
    mesh_ok = not args.no_mesh and not args.preset and not args.crop
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if world > 1:
        if mesh_ok:
            return _batch_mesh_path(paths, args)
        if dist.get_rank() != 0:
            return 0  # rank 0 runs the single-device loop
    elif mesh_ok and args.device in (None, "cuda"):
        import torch

        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n > 1:
            return _spawn_mesh_batch(paths, args, n)
    args.device = _session_device(args)

    # The one-pass RAW kernel has no lens-distortion (geometry) stage and
    # no profile-correction stage: with --lens-distortion or --lens-correct
    # set, the editor path keeps batch output equal to `develop` with the
    # same flags.
    if (all(is_raw_image(p) for p in paths) and not args.preset
            and not args.crop and not args.exact_path
            and args.lens_distortion == 0 and not args.lens_correct):
        return _batch_raw_fast_path(paths, args)

    t0 = time.perf_counter()
    total_pix = 0
    taken: set = set()
    for p in paths:
        ed = PhotoEditor.open(p, use_kernel=not args.exact_path,
                              lens_correct=args.lens_correct,
                              lens_db_paths=args.lens_db, device=args.device)
        _apply_edit_flags(ed, args)
        out = _batch_out_name(p, args.output_dir, taken)
        ed.save(out, quality=args.quality)
        h, w = ed.shape
        total_pix += h * w
        note = f"  [lens: {_lens_note(ed)}]" if args.lens_correct else ""
        print(f"  {p} -> {out}{note}")
    dt = time.perf_counter() - t0
    print(f"batch: {len(paths)} images, {total_pix / 1e6:.4g} MPix in "
          f"{dt:.1f} s ({total_pix / 1e6 / dt:.4g} MPix/s end-to-end)")
    return 0


def _batch_mesh_path(paths, args) -> int:
    """The batch sharded over the ranks of the default process group (one
    process a card; SURVEY §2.6's batch data parallelism).

    Every rank runs this. Image i belongs to rank i % N (the 'batch' axis of
    ``parallel/mesh.make_mesh``), which opens it on its own device (decode,
    demosaic, geometry and sharpen in the editor) and runs the editor's
    render -> encode tail (``export_batch_editor_packed_step``: the
    exact-LUT anchor ``develop_post_geo`` and the packed JPEG wire). The
    output names come from the whole sorted list on every rank, and each
    file is written once, by its owner. Rank 0 prints one line per image in
    input order and the summary.

    The files equal the single-device loop's (``--no-mesh --exact-path``)
    byte for byte: the same planes, the same anchor program, integer math
    after the u8-grid round. An image whose packed wire refuses its data
    (``JpegWireDataError``) takes the editor's own export chain instead
    (``save_bytes("JPEG")``). A failure on one rank is reported by rank 0
    after every rank has finished; every rank then returns 2."""
    import traceback

    import torch
    import torch.distributed as dist

    from .. import native
    from .._errbase import JpegWireDataError
    from ..io import jpegbits, jpegenc
    from ..parallel import mesh as pmesh

    msh = pmesh.make_mesh(devices=_mesh_devices(args.device, dist.get_world_size(),
                                                dist.get_backend()))
    if msh.device.type == "cuda":
        torch.cuda.set_device(msh.device)  # nccl's object collectives
    nb = msh.shape["batch"]
    qlum, qchr = jpegenc._quant_tables(args.quality)
    t0 = time.perf_counter()
    taken: set = set()
    outs = [_batch_out_name(p, args.output_dir, taken) for p in paths]
    done, error = [], None
    try:
        for i in range(msh.batch_index, len(paths), nb):
            # use_kernel=False: the step renders on the exact-LUT anchor, so
            # the packed params must carry the built LUTs, and the fallback
            # renders on the same path.
            ed = PhotoEditor.open(paths[i], use_kernel=False,
                                  lens_correct=args.lens_correct,
                                  lens_db_paths=args.lens_db, device=msh.device)
            _apply_edit_flags(ed, args)
            th, tw = ed.shape
            words, totals = pmesh.export_batch_editor_packed_step(
                ed._geo_at(FULL)[None], ed._packed_params(FULL), msh, qlum,
                qchr, (th, tw))
            nw, nbits, bad = totals[0].tolist()
            try:
                jpegbits._check_totals(nw, nbits, bad,
                                       6 * -(-th // 16) * -(-tw // 16), packed=True)
                body = native.jpeg_encode_packed(
                    jpegbits.fetch_scan(words[0], nw), nbits, th, tw,
                    quality=args.quality)
                exif_b = ed.export_exif_bytes()
                if exif_b:
                    body = jpegenc._splice_app1(body, exif_b)
            except JpegWireDataError:
                body = ed.save_bytes("JPEG", quality=args.quality)
            with open(outs[i], "wb") as f:
                f.write(body)
            note = f"  [lens: {_lens_note(ed)}]" if args.lens_correct else ""
            done.append((i, f"  {paths[i]} -> {outs[i]}{note}", th * tw))
    except Exception as e:  # noqa: BLE001 - the other ranks wait at the gather
        traceback.print_exc()
        error = f"rank {msh.rank}: {type(e).__name__}: {e}"
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, (done, error))
    errors = [e for _, e in gathered if e]
    if dist.get_rank() == 0:
        if errors:
            print("error: " + "; ".join(errors), file=sys.stderr)
        else:
            rows = sorted(r for d, _ in gathered for r in d)
            for _, line, _ in rows:
                print(line)
            total_pix = sum(px for _, _, px in rows)
            dt = time.perf_counter() - t0
            print(f"batch (mesh x{nb}): {len(paths)} images, "
                  f"{total_pix / 1e6:.4g} MPix in {dt:.1f} s "
                  f"({total_pix / 1e6 / dt:.4g} MPix/s end-to-end)")
    return 2 if errors else 0


def _mesh_devices(device, world: int, backend: str):
    """``make_mesh``'s ``devices`` for a ``--device``: None or "cuda" give
    each rank the card ``LOCAL_RANK`` names, "cpu" stays, and so does one
    named card ("cuda:0"), which gloo ranks may share; NCCL takes one rank
    a card, so there a named card is refused in a world of several ranks."""
    import torch

    if device is None:
        return None
    dev = torch.device(device)
    if dev.type != "cuda":
        return device
    if dev.index is None:
        return None
    if world > 1 and backend == "nccl":
        raise PhotoEditorError(
            f"--device {device} names one card, but each of the {world} ranks "
            "needs its own: pass --device cuda (rank r takes cuda:LOCAL_RANK) "
            "or choose the cards with CUDA_VISIBLE_DEVICES")
    return device


def _mesh_rank_main(rank, world, init_file, paths, args):
    """One spawned rank of ``_spawn_mesh_batch``."""
    import torch
    import torch.distributed as dist

    os.environ["LOCAL_RANK"] = str(rank)
    backend = _world_backend(args.device)
    if backend == "gloo":
        # CPU ranks share the host's cores: one intra-op thread each, as
        # torchrun gives its workers.
        torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=world, timeout=_WORLD_TIMEOUT)
    try:
        rc = _batch_mesh_path(paths, args)
    finally:
        dist.destroy_process_group()
    sys.exit(rc)


def _world_backend(device) -> str:
    """The process group's backend for a ``--device``: ``gloo`` for the
    CPU, ``nccl`` for the cards."""
    return "gloo" if device is not None and str(device).startswith("cpu") else "nccl"


def _spawn_mesh_batch(paths, args, world: int) -> int:
    """Run ``_batch_mesh_path`` in ``world`` spawned ranks (one a card over
    ``nccl``, or CPU ranks over ``gloo`` with ``--device cpu``) that meet
    through a file in a temporary directory. Returns 0 when every rank did."""
    import multiprocessing
    import tempfile

    if _world_backend(args.device) == "nccl":
        # Build the kernels and the native library once, here: ranks
        # building at once would race for the same files.
        from .. import native
        from ..kernels import jpeg_wire

        native.library()
        jpeg_wire.library()
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        init = os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_mesh_rank_main,
                             args=(r, world, init, paths, args))
                 for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join()
    return 0 if all(p.exitcode == 0 for p in procs) else 2


def cmd_convert(args) -> int:
    """Transcode a RAW file to a compressed DNG, the pixel data bit for bit:
    ``--codec ljpeg`` (default) writes lossless JPEG with per-image optimal
    Huffman tables, ``--codec deflate`` Compression=8 with the CFA-pitch
    predictor. Stored values pass through verbatim and opcode lists are
    re-serialized, not applied; the embedded preview is carried over."""
    from ..io.dng import extract_preview, write_dng
    from ..io.raw import parse_raw

    with open(args.input, "rb") as f:
        src = f.read()
    raw = parse_raw(src, apply_opcodes=False)
    preview = None if args.no_preview else extract_preview(src)
    tile = None
    if args.tile:
        try:
            th, tw = (int(v) for v in args.tile.split("x"))
        except ValueError as e:
            raise PhotoEditorError(
                f"bad tile {args.tile!r} (want 'HxW', e.g. 256x256)") from e
        tile = (th, tw)
    if args.codec == "deflate":
        out = write_dng(raw, compression=8, predictor=34892, tile=tile,
                        preview_jpeg=preview)
    else:
        out = write_dng(raw, compression=7, tile=tile, preview_jpeg=preview)
    with open(args.output, "wb") as f:
        f.write(out)
    h, w = raw.mosaic.shape[:2]
    print(f"converted {w}x{h} {raw.pattern} mosaic: "
          f"{len(src)} -> {len(out)} bytes "
          f"({len(src) / max(len(out), 1):.2f}x)")
    return 0


def cmd_devices(args) -> int:
    """List the CUDA devices (the GPU adapter picker,
    settings_window.gd:46-49). The CPU is not an accelerator: with no card
    this says so and fails."""
    import torch

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        print("no CUDA device is available", file=sys.stderr)
        return 1
    for i in range(n):
        props = torch.cuda.get_device_properties(i)
        print(f"[{i}] cuda: {props.name} ({props.total_memory / 2**30:.1f} GiB, "
              f"{props.multi_processor_count} SMs)")
    return 0


def cmd_serve(args) -> int:
    from .server import main as server_main

    return server_main(
        ([args.image] if args.image else [])
        + ["--port", str(args.port)]
        + (["--segmenter", args.segmenter] if args.segmenter else [])
        + (["--no-host-drag"] if args.no_host_drag else [])
        + (["--lens-correct", args.lens_correct_srv]
           if args.lens_correct_srv else [])
        + sum((["--lens-db", d] for d in (args.lens_db_srv or [])), [])
        + (["--device", args.device] if args.device else []))


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="rawphotoforge-tpu-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_info = sub.add_parser("info", help="print image dims + EXIF")
    p_info.add_argument("image")
    p_info.add_argument("--preview", type=str, default=None,
                        help="extract the embedded JPEG preview to this path")
    p_info.add_argument("--verify-decode", action="store_true",
                        help="correlate the developed sensor decode against "
                             "the embedded camera preview (exit 1 below the "
                             "0.9 gate)")
    p_info.add_argument("--lens-db", type=str, action="append", default=None,
                        help="extra lensfun XML file/dir for the lens "
                             "profile match line (repeatable)")
    p_info.add_argument("--device", type=str, default="cuda",
                        help="torch device of the decode (default: the card)")
    p_info.set_defaults(fn=cmd_info)
    p_dev = sub.add_parser("develop", help="develop one image")
    p_dev.add_argument("input")
    p_dev.add_argument("output")
    _add_edit_flags(p_dev)
    p_dev.set_defaults(fn=cmd_develop)
    p_batch = sub.add_parser("batch", help="develop a directory of images")
    p_batch.add_argument("input_dir")
    p_batch.add_argument("output_dir")
    p_batch.add_argument("--no-mesh", action="store_true",
                         help="stay on the single-device loop even with more "
                              "than one rank (a torchrun world, or several "
                              "cards)")
    _add_edit_flags(p_batch)
    p_batch.set_defaults(fn=cmd_batch)
    p_cv = sub.add_parser("convert", help="transcode a RAW to a compressed DNG")
    p_cv.add_argument("input")
    p_cv.add_argument("output")
    p_cv.add_argument("--tile", type=str, default=None,
                      help='tile size "HxW" (e.g. 256x256); default: one strip')
    p_cv.add_argument("--codec", choices=("ljpeg", "deflate"), default="ljpeg",
                      help="DNG compression: lossless JPEG (7) or deflate (8)")
    p_cv.add_argument("--no-preview", action="store_true",
                      help="do not carry the source's embedded JPEG preview "
                           "into the output")
    p_cv.set_defaults(fn=cmd_convert)
    p_ls = sub.add_parser("devices", help="list the CUDA devices")
    p_ls.set_defaults(fn=cmd_devices)
    p_srv = sub.add_parser("serve", help="run the interactive preview server")
    p_srv.add_argument("image", nargs="?")
    p_srv.add_argument("--port", type=int, default=8080)
    p_srv.add_argument("--segmenter", type=str, default=None,
                       help="external AI-mask command: cmd image.png x y out.npy")
    p_srv.add_argument("--no-host-drag", action="store_true",
                       help="render LOW drag previews on the device instead "
                            "of the host mirror")
    p_srv.add_argument("--lens-correct", dest="lens_correct_srv",
                       nargs="?", const="auto", default=None,
                       choices=["auto", "calibrated-only"],
                       help="auto-apply a lens profile matched from each "
                            "opened file's EXIF ('calibrated-only' skips "
                            "bundled approximate profiles)")
    p_srv.add_argument("--lens-db", dest="lens_db_srv", action="append",
                       default=None,
                       help="extra lensfun XML file/dir (repeatable)")
    p_srv.add_argument("--device", type=str, default=None,
                       help="torch device of the sessions (default: the card "
                            "the settings' device_index names)")
    p_srv.set_defaults(fn=cmd_serve)
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    try:
        return args.fn(args)
    except (PhotoEditorError, FileNotFoundError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
