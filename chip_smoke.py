#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (rawphotoforge_tpu_torch) on one card.

Run from the root of a checkout, on a machine with an NVIDIA card:

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):
 1. the card's name and power limit; build of the develop kernel (nvcc,
    sm_90a) with its build seconds and ptxas register/spill report;
 2. the kernel held against its plain torch twin at 48x160, 37x150 and
    4096x6016 for every variant, the shortcut variants' bit-identity and
    identity_oklch's 3e-3 bound;
 3. the interactive develop frame at full size: a seeded 4000x6000 linear
    image in a PhotoEditor on the card with the benchmark edit, geometry,
    sharpening and three regional masks (M=4): FULL/MID/LOW renders,
    histogram, clipping, the kernel render against the exact-LUT anchor,
    and `cli develop` on a 24 MP 16-bit PPM; the launch count of the
    kernel over that run;
 4. CUDA-event timings per 24 MP variant beside the byte and operation
    bounds, the twin's time, and the editor's render latency per level.

The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}. Without a card, or without the rest of the
repository beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

SEED = 20261016
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32 FLOP/s outside the
# tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
TIGHT, LOOSE, FRAC = 1e-4, 5e-3, 2e-3  # tests/test_develop.py:14
# A 24 MP photo and the bucket-padded grid the editor renders it on.
PHOTO_HW = (4000, 6000)
BUCKET_HW = (4096, 6016)


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0].strip()


# -- comparison -------------------------------------------------------------

def compare(ours, ref, tight=TIGHT, loose=LOOSE, frac=FRAC, what=""):
    """tests/test_develop.py:14's assert_close on planar card tensors:
    almost all values within ``tight``, none beyond ``loose`` except
    out-of-bounds black flips. Returns the max abs difference."""
    black_flip = (ours == 0).all(0) ^ (ref == 0).all(0)
    diff = (ours - ref).abs()
    keep = ~black_flip.expand_as(diff)
    d = diff[keep]
    flips = black_flip.float().mean().item()
    over = (d > tight).float().mean().item() if d.numel() else 0.0
    dmax = d.max().item() if d.numel() else 0.0
    if not (flips < 1e-3 and over <= frac and dmax <= loose):
        gray = ((ours.amax(0) - ours.amin(0)) < 1e-6) & (
            (ref.amax(0) - ref.amin(0)) < 1e-6)
        raise SmokeFailure(
            f"{what}: {100 * over:.4f}% > {tight} (allowed {100 * frac}%), "
            f"max {dmax:.3e} (allowed {loose}), black flips {flips:.2e}, "
            f"gray pixels {gray.float().mean().item():.2e}")
    return float(diff.max().item())


def bit_identical(a, b, what):
    import torch

    check(torch.equal(a, b), f"{what}: not bit-identical "
          f"(max diff {(a - b).abs().max().item():.3e})")


# -- the edits ----------------------------------------------------------------

def bench_edit(p):
    """bench.py:204-213's edit: tone, WB, vignette and all four curves."""
    from rawphotoforge_tpu_torch.core.params import (
        BRIGHTNESS, HUE, LIGHTNESS, SATURATION)

    p.set_tone(exposure=0.7, contrast=25, shadow=30, highlight=-20,
               black=5, white=-5)
    p.set_whitebalance(temperature=25, tint=-10)
    p.set_vignette(40)
    p.set_curve(BRIGHTNESS, [0, 16000, 40000, 65535], [1000, 20000, 46000, 65535])
    p.set_curve(HUE, [0, 30000, 65535], [4000, 33000, 63000])
    p.set_curve(SATURATION, [0, 40000, 65535], [36000, 30000, 36000])
    p.set_curve(LIGHTNESS, [0, 65535], [31000, 35000])


def regional_edits():
    """Three regional masks' parameters, each editing other curve families
    (the slot table then elides the untouched ones per mask)."""
    from rawphotoforge_tpu_torch.core.params import (
        BRIGHTNESS, HUE, SATURATION, EditParameters)

    a = EditParameters()
    a.set_tone(exposure=-0.4, highlight=-30)
    a.set_curve(SATURATION, [0, 65535], [30000, 38000])
    b = EditParameters()
    b.set_curve(HUE, [0, 20000, 65535], [3000, 24000, 65535])
    c = EditParameters()
    c.set_tone(contrast=30)
    c.set_curve(BRIGHTNESS, [0, 30000, 65535], [0, 36000, 65535])
    return [a, b, c]


def region_logits(h, w):
    """Full-resolution logits of three regions: a sky band, a disc, stripes."""
    yy = np.arange(h, dtype=np.float32)[:, None] / h
    xx = np.arange(w, dtype=np.float32)[None, :] / w
    sky = np.broadcast_to(1.0 - yy / 0.3, (h, w))
    disc = 1.0 - np.sqrt((yy - 0.6) ** 2 + (xx - 0.4) ** 2) / 0.2
    stripes = np.broadcast_to(((np.arange(w) // 64) % 2 == 0).astype(np.float32)
                              [None, :], (h, w))
    return [np.ascontiguousarray(m, dtype=np.float32) for m in (sky, disc, stripes)]


# -- variants of the kernel call ---------------------------------------------

def variants(h, w, dev, rng):
    """(name, planes, params, masks, flags, bit-identical partner flags or
    None) for the kernel-vs-twin phase at one shape."""
    import torch

    from rawphotoforge_tpu_torch.core.params import (
        BRIGHTNESS, EditParameters, default_curve_slots, pack_params)

    planes = torch.from_numpy(
        (rng.random((3, h, w), dtype=np.float32) ** 2) * 1.2).to(dev)
    full = EditParameters()
    bench_edit(full)
    tone_only = EditParameters()
    tone_only.set_tone(exposure=0.8, contrast=20, shadow=15)
    tone_only.set_whitebalance(temperature=30)
    tone_only.set_vignette(40)
    drag = EditParameters()
    drag.set_tone(exposure=0.4)
    drag.set_vignette(25)
    drag.set_curve(BRIGHTNESS, [0, 20000, 65535], [3000, 26000, 65535])
    stack = [full, *regional_edits()]
    masks = np.zeros((4, h, w), np.uint8)
    masks[0] = 1
    for k, logit in enumerate(region_logits(h, w), start=1):
        masks[k] = logit >= 0.0
    masks = torch.from_numpy(masks).to(dev)
    ones_f32 = torch.ones((1, h, w), device=dev)
    p_full = pack_params([full], device=dev)
    p_tone = pack_params([tone_only], device=dev)
    p_drag = pack_params([drag], device=dev)
    p_m4 = pack_params(stack, device=dev)
    main = dict(main_mask_all_ones=True)
    return planes, [
        ("general", p_full, None, main, None),
        ("default_bright_curves", p_tone, None,
         dict(main, default_bright_curves=True), main),
        ("default_oklch_curves", p_drag, None,
         dict(main, default_oklch_curves=True), main),
        ("identity_oklch", p_tone, None,
         dict(main, default_bright_curves=True, default_oklch_curves=True,
              identity_oklch=True), None),
        ("main_mask_all_ones", p_full, None, main, "explicit_ones"),
        ("m4_u8_slots", p_m4, masks,
         dict(main, default_curve_slots=default_curve_slots(stack)), main),
    ], ones_f32


def phase_kernel_vs_twin(dev, log):
    import torch

    from rawphotoforge_tpu_torch.kernels import fused

    rng = np.random.default_rng(SEED)
    worst = {}
    for h, w in ((48, 160), (37, 150), BUCKET_HW):
        planes, cases, ones_f32 = variants(h, w, dev, rng)
        for name, params, masks, flags, partner in cases:
            out = fused.develop_post_geo_fused(planes, params, masks, **flags)
            torch.cuda.synchronize()
            ref = fused.develop_post_geo_fused_ref(planes, params, masks, **flags)
            err = compare(out, ref, what=f"{name} {h}x{w} kernel vs twin")
            worst[name] = max(worst.get(name, 0.0), err)
            note = ""
            if partner == "explicit_ones":
                other = fused.develop_post_geo_fused(planes, params, ones_f32,
                                                     main_mask_all_ones=False)
                bit_identical(out, other, f"{name} {h}x{w} vs an f32 ones row")
                note = "; bit-identical to an explicit f32 ones row"
            elif partner is not None:
                general = fused.develop_post_geo_fused(planes, params, masks, **partner)
                bit_identical(out, general, f"{name} {h}x{w} vs general kernel")
                note = "; bit-identical to the general kernel"
            if name == "identity_oklch":
                general = fused.develop_post_geo_fused(
                    planes, params, masks, main_mask_all_ones=True,
                    default_bright_curves=True, default_oklch_curves=True)
                dev_max = (out - general).abs().max().item()
                check(dev_max < 3e-3, f"identity_oklch {h}x{w}: {dev_max:.3e} "
                      "from the full path (bound 3e-3)")
                note = f"; {dev_max:.3e} from the full OKLCH path (bound 3e-3)"
            log(f"phase 2: {name} {h}x{w}: kernel vs twin max abs err "
                f"{err:.3e}{note}")
        del planes, cases
        torch.cuda.empty_cache()
    return worst


# -- the main path ------------------------------------------------------------

def phase_main_path(dev, log):
    import torch

    from rawphotoforge_tpu_torch.app import cli
    from rawphotoforge_tpu_torch.core.params import EditParameters
    from rawphotoforge_tpu_torch.engine.editor import FULL, LOW, MID, PhotoEditor
    from rawphotoforge_tpu_torch.io import image_io
    from rawphotoforge_tpu_torch.kernels import fused

    h, w = PHOTO_HW
    rng = np.random.default_rng(SEED + 1)
    img = rng.random((h, w, 3), dtype=np.float32) ** 2
    logits = region_logits(h, w)
    regional = regional_edits()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    ppm = os.path.join(tmp, "in.ppm")
    with open(ppm, "wb") as f:
        f.write(image_io.encode_ppm16(img))
    out_ppm = os.path.join(tmp, "out.ppm")
    cli_flags = ["--exposure", "0.7", "--contrast", "25", "--shadow", "30",
                 "--highlight", "-20", "--black", "5", "--white", "-5",
                 "--wb-temperature", "25", "--wb-tint", "-10", "--vignette", "40",
                 "--lens-distortion", "-20", "--sharpness", "30",
                 "--brightness-curve", "0:1000,16000:20000,40000:46000,65535:65535",
                 "--hue-curve", "0:4000,30000:33000,65535:63000",
                 "--saturation-curve", "0:36000,40000:30000,65535:36000",
                 "--lightness-curve", "0:31000,65535:35000"]

    main = EditParameters()
    bench_edit(main)
    main.set_sharpness(30)
    main.set_lens_distortion(-20)
    names = [f"region{k}" for k in range(len(regional))]
    preset = json.dumps({"version": 1, "crop": None, "masks": [
        {"name": n, "params": p.to_json()}
        for n, p in zip(["main", *names], [main, *regional])]})

    fused.LAUNCHES = 0  # the main path's run starts here
    t0 = time.perf_counter()
    ed = PhotoEditor.from_rgb_f32(img, device=dev)
    for name, logit in zip(names, logits):
        ed.add_mask(name, logit)
    ed.load_preset_json(preset)
    renders = {}
    for level in (FULL, MID, LOW):
        renders[level] = ed.apply(level)
        torch.cuda.synchronize()
    hist_full = ed.histogram(FULL)
    hist_mid = ed.histogram(MID)
    clip = ed.clipping(FULL)
    rc = cli.main(["develop", ppm, out_ppm, *cli_flags, "--device", str(dev),
                   "--histogram"])
    torch.cuda.synchronize()
    launches = fused.LAUNCHES  # the main path's run ends here
    t_main = time.perf_counter() - t0
    check(rc == 0, f"cli develop exited {rc}")
    check(launches > 0, "the main path never launched the develop kernel")
    log(f"phase 3: main path (editor FULL/MID/LOW + histogram + clipping + "
        f"cli develop) in {t_main:.2f} s; develop kernel launches {launches}")

    for level, r in renders.items():
        lh, lw = ed.level_shape(level)
        check(tuple(r.shape) == (3, lh, lw), f"{level} render shape {tuple(r.shape)}")
        check(bool(torch.isfinite(r).all()) and float(r.min()) >= 0.0
              and float(r.max()) <= 1.0, f"{level} render not finite in [0, 1]")
    check(hist_full.shape == (4, 256) and (hist_full.sum(1) == h * w).all(),
          "FULL histogram mass")
    mh, mw = ed.level_shape(MID)
    check((hist_mid.sum(1) == mh * mw).all(), "MID histogram mass")
    check(all(0.0 <= v <= 1.0 for v in clip.values()), f"clipping {clip}")
    log(f"phase 3: levels FULL {ed.level_shape(FULL)} MID {ed.level_shape(MID)} "
        f"LOW {ed.level_shape(LOW)}; clipping {clip}")

    # The kernel render against the exact-LUT anchor on the card.
    kernel_full = renders[FULL]
    ed.use_kernel = False
    anchor_full = ed.apply(FULL)
    err = compare(kernel_full, anchor_full,
                  what="editor FULL kernel vs exact-LUT anchor")
    for level in (MID, LOW):
        compare(renders[level], ed.apply(level),
                what=f"editor {level} kernel vs exact-LUT anchor")
    log(f"phase 3: editor kernel render vs exact-LUT anchor (M=4, geometry + "
        f"sharpen): max abs err {err:.3e}, within the assert_close rule")
    ed.use_kernel = True

    # The CLI round trip: its file equals the same render made in process.
    ref = PhotoEditor.open(ppm, device=dev)
    cli._set_edit_flags(ref, _parse_flags(cli_flags))
    expect = image_io.encode_image(ref.apply(FULL, cropped=False), "PPM16")
    with open(out_ppm, "rb") as f:
        got = f.read()
    check(got == expect, "cli develop output differs from the in-process render")
    decoded = image_io.decode_ppm16(got)
    check(decoded.shape == (h, w, 3) and np.isfinite(decoded).all(),
          "cli output shape/finite")
    log(f"phase 3: cli develop {w}x{h} PPM16 -> PPM16 round trip: "
        f"{len(got)} bytes, equal to the in-process render")
    for p in (ppm, out_ppm):
        os.unlink(p)
    os.rmdir(tmp)
    return ed, launches, kernel_full


def _parse_flags(flags):
    import argparse

    from rawphotoforge_tpu_torch.app import cli

    ap = argparse.ArgumentParser()
    cli._add_edit_flags(ap)
    return ap.parse_args(flags)


# -- timing -------------------------------------------------------------------

def op_count(m, s, slots, identity, coverage, vignette_on):
    """f32 operations of the kernel per pixel, summed over the frame's
    masks: each add/sub/mul/div/compare/select/min/max/floor/sqrt/pow/exp2
    counts as one (transcendentals at the f32 rate, a generous bound). A
    mask's chain runs only where it is selected: ``coverage[k]`` is the
    selected share of the frame (data dependent)."""
    curve = 16 + 6 * (s - 1)   # index, segment selects, Horner, truncate
    stair = 5
    ops = 26 * vignette_on + 4 * m   # vignette; mask tests
    for k in range(m):
        bright = 3 + 58 + 3 * (stair if slots[k][0] else curve) + 6
        ops += coverage[k] * bright
    if identity:
        return ops + 27                 # OETF x3 + clamps
    ops += 81                           # to OKLCH: 2 matrices, 3 cbrt, atan2
    for k in range(m):
        per = (stair if slots[k][1] else curve) + sum(
            0 if slots[k][j] else curve for j in (2, 3)) + 2
        ops += coverage[k] * per
    return ops + 77 + 27                # back from OKLCH; OETF + clamps


def time_events(fn, reps, warm=2):
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_timing(dev, ed, card, log):
    import torch

    from rawphotoforge_tpu_torch.core.params import (
        BRIGHTNESS, EditParameters, default_curve_slots, pack_params)
    from rawphotoforge_tpu_torch.engine.editor import FULL, LOW, MID
    from rawphotoforge_tpu_torch.kernels import fused

    hb, wb = BUCKET_HW
    hw = hb * wb
    rng = np.random.default_rng(SEED + 2)
    planes = torch.from_numpy(rng.random((3, hb, wb), dtype=np.float32) ** 2).to(dev)
    full = EditParameters()
    bench_edit(full)
    tone = EditParameters()
    tone.set_tone(exposure=0.7, contrast=25, shadow=30, highlight=-20, black=5, white=-5)
    tone.set_whitebalance(temperature=25, tint=-10)
    tone.set_vignette(40)
    drag = EditParameters()
    drag.set_tone(exposure=0.7, contrast=25)
    drag.set_vignette(40)
    drag.set_curve(BRIGHTNESS, [0, 16000, 40000, 65535], [1000, 20000, 46000, 65535])
    stack = [full, *regional_edits()]
    m4_masks = ed._masks_at(FULL)  # the editor's own u8 stack
    coverage = [1.0] + [float(m4_masks[k].float().mean()) for k in range(1, 4)]
    one = dict(main_mask_all_ones=True)
    cases = [
        ("full_stack", [full], None, one),
        ("slider_only", [tone], None, dict(one, default_bright_curves=True,
                                           default_oklch_curves=True,
                                           identity_oklch=True)),
        ("tone_curve_drag", [drag], None, dict(one, default_oklch_curves=True,
                                               identity_oklch=True)),
        ("m4_regional", stack, m4_masks,
         dict(one, default_curve_slots=default_curve_slots(stack))),
    ]
    results = {}
    for name, plist, masks, flags in cases:
        params = pack_params(plist, extent=PHOTO_HW, device=dev)
        m, s = len(plist), params.breaks.shape[-1]
        slots = fused._slot_table(m, flags.get("default_bright_curves", False),
                                  flags.get("default_oklch_curves", False),
                                  flags.get("default_curve_slots"))
        ms = time_events(lambda: fused.develop_post_geo_fused(
            planes, params, masks, **flags), reps=20)
        plain = time_events(lambda: fused.develop_post_geo_fused_ref(
            planes, params, masks, **flags), reps=2, warm=1)
        main_only = masks is None
        nbytes = 24 * hw + (0 if main_only else m * hw) + 4 * (4 + 11 * m + 20 * m * s)
        ops = op_count(m, s, slots, flags.get("identity_oklch", False),
                       coverage if m > 1 else [1.0], 1) * hw
        t_bytes = nbytes / PEAK_BYTES_S * 1e3
        t_ops = ops / PEAK_F32_S * 1e3
        bound = max(t_bytes, t_ops)
        by = "bytes" if t_bytes >= t_ops else "operations"
        results[name] = dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                             bytes=nbytes, ops=ops)
        log(f"phase 4: {name} {wb}x{hb} M={m} S={s}: kernel {ms:.4f} ms/frame; "
            f"bound {bound:.4f} ms by {by} (bytes {nbytes / 1e6:.1f} MB -> "
            f"{t_bytes:.4f} ms at 3.35 TB/s; ops {ops / 1e9:.2f} G -> "
            f"{t_ops:.4f} ms at 67 TFLOP/s f32); {100 * bound / ms:.1f}% of "
            f"roofline; plain twin {plain:.2f} ms (no yardstick); "
            f"library_ms none [{card}]")

    # Editor render latency per level: one slider move (a tone edit on the
    # main mask) then apply(level), host clock around work that ends in a
    # synchronize; geometry stays cached, as in a real drag.
    for level in (FULL, MID, LOW):
        ed.apply(level)
        torch.cuda.synchronize()
        times = []
        for i in range(7):
            ed.set_tone(exposure=0.7 + 0.01 * (i % 2), contrast=25, shadow=30,
                        highlight=-20, black=5, white=-5)
            t0 = time.perf_counter()
            ed.apply(level)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        lh, lw = ed.level_shape(level)
        log(f"phase 4: editor {level} {lw}x{lh} M=4 render after a slider move: "
            f"median {sorted(times)[3]:.3f} ms, min {min(times):.3f} ms "
            f"(host clock, 7 moves) [{card}]")
    # The host part of that latency: repacking the edit state after a move.
    times = []
    for _ in range(7):
        t0 = time.perf_counter()
        pack_params([m.params for m in ed.masks], build_luts=False, device=dev)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    log(f"phase 4: pack_params after a slider move (M=4, upload included): "
        f"median {sorted(times)[3]:.3f} ms (host clock, 7 runs) [{card}]")
    return results


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    try:
        from rawphotoforge_tpu_torch.kernels import fused
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})",
              file=sys.stderr)
        return 2

    def log(msg):
        print(msg, flush=True)

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    card = card_line()
    log(card)
    kind = torch.cuda.get_device_name(0)
    log(f"phase 1: torch {torch.__version__} CUDA {torch.version.cuda}; "
        f"device {kind} [{card}]")
    fused.library()
    build = fused.BUILD
    log(f"phase 1: built {os.path.relpath(build['path'], ROOT)} in "
        f"{build['seconds']:.2f} s")
    for line in build["log"].splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            log(f"phase 1: ptxas: {line.strip()}")

    worst = phase_kernel_vs_twin(dev, log)
    ed, launches, _ = phase_main_path(dev, log)
    timing = phase_timing(dev, ed, card, log)

    main_case = timing["m4_regional"]
    table = {"kernels": [{
        "name": "develop_post_geo_fused",
        "route": "cuda",
        "source": "rawphotoforge_tpu_torch/csrc/develop.cu",
        "replaces": "rawphotoforge_tpu/kernels/fused.py:488",
        "launches": launches,
        "max_abs_err": max(worst.values()),
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": None,
    }]}
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(table))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
