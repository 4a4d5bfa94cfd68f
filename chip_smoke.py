#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (rawphotoforge_tpu_torch) on one card.

Run from the root of a checkout, on a machine with an NVIDIA card:

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):
 1. the card's name and power limit; the builds, started together, of the
    develop kernel, the RAW kernel, the JPEG kernels, the geodesic flood and
    the geometry kernel (nvcc, sm_90a) and of the native host library (g++),
    with build seconds and the ptxas register/spill report;
 2a. the edit stack's device functions against their torch twins, bit for
    bit and exhaustively: the OKLab cube root over every f32 in [0, 2],
    the sRGB OETF over every f32 in [0, 64], and the curve rescales (a
    multiply and a correction) over all 65536 whole inputs;
 2. the develop kernel held against its plain torch twin, bit for bit:
    curve rows of S = 1, 2, 4, 8 and 16 segments at 48x160 and 37x150, and
    every variant at 48x160, 37x150, 4096x6013 (a width that is not a
    multiple of 4) and 4096x6016; the shortcut variants' bit-identity and
    identity_oklch's 3e-3 bound (each shortcut against the same params with
    their slot table cleared, the general kernel);
 3. the interactive develop frame at full size: a seeded 4000x6000 linear
    image in a PhotoEditor on the card with the benchmark edit, geometry,
    sharpening and three regional masks (M=4): FULL/MID/LOW renders,
    histogram, clipping, the kernel render against the exact-LUT anchor,
    and `cli develop` on a 24 MP 16-bit PPM; the launch counts of the
    develop and geometry kernels over that run;
 3b. the geometry kernel's output that editor cached, at each level, bit
    for bit the plain torch chain (its twin) on the card; the kernel against
    the chain at 45 MP in four slider cases, and CUDA-event times there
    beside its byte bound;
 4. CUDA-event timings per 24 MP variant beside the byte and operation
    bounds, the twin's time, and the editor's render latency per level;
 5. the one-pass RAW kernel held against its plain torch twin, bit for
    bit: the four Bayer patterns at 64x512, 50x300, 37x150 and the Bayer
    kernel's edge shapes (BAYER_EDGE_HW; 70x380 once more with the mosaic
    one float off the 16-byte grid) and X-Trans at 96x768, 100x700, 12x12
    and 61x133, each with
    M=1 / M=3 (u8 masks), sharpen 0 / 0.8, the default-curve shortcuts
    (bit-identical to the general kernel) and identity_oklch (3e-3
    bound), plus one full-size frame of each CFA;
 9. (run after phase 5, before the batch uses them) the three JPEG kernels
    (csrc/jpeg_encode.cu) held against their plain twins bit for bit:
    hand-fed worst-case blocks through the Huffman and pack kernels and
    hand-fed words and bit lengths through the pack kernel, then 37x50,
    61x97, a 128x128 render with a 100x72 true extent, 24 MP and 45.4 MP
    through all three; the packed, prepacked and nibble wires' files
    byte-identical and decoding at their true size; CUDA-event times of
    each kernel at 24 MP beside its byte bound (the pack's counting its
    zero-filled output) and its twin's time;
 6. the RAW main path: a 24 MP RGGB lossless-JPEG DNG and a 26 MP X-Trans
    DNG (orientation 6) written with the port's write_dng, developed by
    `cli batch` on the card (exactly one launch of each RAW kernel, Bayer
    and X-Trans, and of each JPEG kernel per file, no twin call); each
    pre-JPEG render held against the composed path on the card (demosaic
    -> unsharp -> develop kernel) on the trimmed interior; each JPEG byte
    for byte the encode of that render oriented on the card, whose JPEG
    blocks on the card equal the CPU twin's of the host rotation;
 7. CUDA-event timings of the RAW kernel (Bayer 24 MP and 45.4 MP,
    X-Trans 26 MP; batch flags and full curves)
    beside its bounds and the twin's time; the batch's MPix/s end to end,
    its per-image stage times (each stage's function wrapped here between
    two synchronizes: parse, upload, RAW kernel, the JPEG device wire also
    by CUDA events, the scan fetch with its bytes, the JPEG assembly) and
    the card's idle share under the profiler;
 8. the vendor path: a 24 MP Canon CR2 (odd sensor borders, a lens the
    bundled database knows), two 24 MP Sony ARW2 (one whose embedded
    preview matches its sensor data, one whose preview is another image),
    a 26 MP X-Trans Fujifilm RAF, a 20 MP plain Panasonic RW2, a small RAW4
    RW2 and a 24 MP DNG with WarpRectilinear + FixVignetteRadial, written
    with tests/torch_fixtures.py; `cli batch` of them and the
    lens-corrected editor open on the card (one RAW-kernel launch per
    Bayer or X-Trans file, one develop-kernel launch for the warped DNG,
    the refused ARW2's preview and the editor's FULL render); each kernel
    against its twin on every vendor-decoded mosaic, the JPEG sizes, the
    refused ARW2 opening from its preview, the warp on the card against
    the CPU, the lens-corrected render against the exact-LUT anchor; and
    per-file stage times (parse + decode, the gate, upload, kernels, the
    JPEG device wire, scan fetch and assembly), then the vendor batch's
    MPix/s and the card's idle share under the profiler;
 10. masks and exports: the geodesic flood kernel (csrc/geodesic.cu) held
    against its plain twin bit for bit, every direction and whole floods
    (corner seeds, a 3-seed set, a NaN pixel, 1, 4 and 12 rounds; one
    launch each) at 37x50, 61x97, 128x128, 1x300, 300x1, 853x1281,
    4000x96, 96x6000 and MID 853x1280, with CUDA-event times of the MID
    flood (and of its column and row sweeps alone) beside its chain bound
    (the dependent steps, from the kernel's SASS and the SM clock) and its
    byte bound, the twin and torch.cumsum + torch.cummin; then on a seeded
    6000x4000 session on the card: add_similarity_mask (a point; labelled
    points), add_smart_mask (a point; include + exclude: 1 + 2 geodesic
    launches, one a flood, no twin call),
    add_model_mask (a stub segmenter on the card), mask_overlay_srgb at MID,
    the FULL render with the new masks against the exact-LUT anchor,
    save_hdr_dng of it reopened by read_raw (within 2e-3, f16), `cli
    convert` of phase 6's DNG (ljpeg and deflate, the mosaic bit for bit),
    `cli info --verify-decode` of phase 8's matching ARW2 and `cli devices`.
 11. the interactive server (app/server.serve, what `cli serve` runs) on the
    card, driven over HTTP from this process with phase 6's 24 MP RGGB
    lossless-JPEG DNG: the instant startup (serve(None, initial_file=...)),
    an open for timings, then a gated open: POST /open returns before the
    device phase ends, the era /preview carries X-RPF-Instant, the era MID
    preview after an /edit equals encode_instant_jpeg(hostdev.render_u8_hwc)
    of the same state byte for byte; at the swap the era edit is replayed
    and the MID preview equals a direct editor's (PhotoEditor.from_bytes of
    the DNG with the same state) byte for byte; 20 drag ticks each with the
    host drag on (X-RPF-HostDrag, no host-drag failure, the host frame
    within tests/test_hostdev.py's u8 rule of the card's LOW render) and
    off; 10 MID releases; a smart mask (one geodesic launch); an async JPEG
    export byte for byte the direct editor's save_bytes("JPEG") (the three
    JPEG kernels launched); no twin call. Prints the open timings, the era
    LOW tick, the drag ticks' p50/p95 with the X-RPF-Drag-Us split, the MID
    release p50, the smart mask, the export and the launch counts.
 12. the multi-device layer (parallel/mesh, parallel/spatial, `cli batch`'s
    mesh path) on the card, after four 24 MP RGGB lossless-JPEG DNGs are
    written (phase 6's writer, a seed each). 12a, a torch.distributed world
    of one rank over NCCL in this process: `_batch_mesh_path` over the four
    DNGs, its files byte for byte those of `batch --no-mesh --exact-path`;
    develop_spatial_sharded(use_kernel=True) at 4096x6016 with phase 4's
    M=4 stack, bit for bit the editor's kernel render; histogram_sharded
    through a real NCCL all_reduce == histogram_rgbl; and
    export_batch_raw_fused_packed_step on a 6000x4000 RGGB and a 6240x4160
    X-Trans mosaic, each scan the single-device packed wire's. 12b, two
    gloo ranks in spawned processes (neither imports jax or a test module)
    on the same card, every rank on 'sp': develop_spatial_sharded(
    use_kernel=True) with distortion 35 (the kernel's rows == the
    single-slab kernel on the gathered geometry bit for bit; the warp within
    5e-5 x h/64 of the single warp), demosaic_sharded (bit for bit),
    raw_develop_sharded (within 3e-7), histogram_sharded (exact) and the
    mesh batch of the four DNGs over both ranks (byte for byte). Prints each
    step's ms (CUDA events for device work, the host clock with its halo
    exchanges), the exchanges' bytes, the mesh batch's MPix/s and the
    launches of each kernel on the path (no twin call). First, the
    transfers: utils/transfer's put_np and fetch_np against plain torch
    copies of the same 24 MP arrays (host clock).
 13. the card fuzz (tools/torch_card_fuzz.py) at reduced counts: 6 random
    full-parameter develop draws (M in {1, 2, 3}) against the exact-LUT
    anchor (assert_fuzz_close, the staircase gate), 2 slot-elision draws,
    2 Bayer and 1 X-Trans RAW draws against the composed path, 1 each of
    identity_oklch and a tone curve on it (3e-3), and 1 each of the nibble,
    prepacked and packed JPEG wires against their numpy mirrors (three
    files byte-identical); every kernel call bit for bit its twin. Prints
    each part's worst deviation and twin equality; a failed seed fails.
 14. the 16-bit PNG open: a seeded 6000x4000 48-bit PNG with mixed row
    filters (half Paeth) written here, opened as a user does
    (PhotoEditor.open on the card, then `cli develop` to a 16-bit PPM): the
    session's planes equal to the source's, the render against the
    exact-LUT anchor, the file equal to the in-process render; the open's host ms split into
    inflate, the native unfilter, the rest of the decode and upload (the
    numpy unfilter only on the first 32 rows, against the native one).

Other modes print only measurements, or check what one card cannot show:

    python3 chip_smoke.py --kernel-times   # one JSON line of kernel times
    python3 chip_smoke.py --develop-ab     # the develop kernel with one
                                           # stage of its edit stack cut out
    python3 chip_smoke.py --bayer-ab       # the Bayer RAW kernel at other
                                           # step heights and block sizes,
                                           # and with one stage cut out
    python3 chip_smoke.py --geodesic-ab    # the flood kernel with one
                                           # stage cut out
    python3 chip_smoke.py --geometry-ab    # the geometry kernel with other
                                           # tiles and block sizes
    python3 chip_smoke.py --mesh-cards     # a host with several cards:
                                           # phase 12b over NCCL, one rank a
                                           # card, and `cli batch` spawned and
                                           # under torchrun

A copy of this script placed in another checkout (for example the parent
commit unpacked under build/) times that checkout's kernels with
--kernel-times on the same cases; run the two in turns in one call.

The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}. Without a card, or without the rest of the
repository beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import datetime
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

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
# RAW frames: a 24 MP Bayer sensor, a 26 MP X-Trans sensor, and the
# 45.4 MP north-star size (BASELINE.md).
BAYER_HW = (4000, 6000)
XTRANS_HW = (4160, 6240)
NORTH_STAR_HW = (5504, 8256)
# The Bayer kernel's edges: frames narrower than one 124-column strip or
# one 16-row step, widths that are not a multiple of the strip or of 4
# (scalar loads and stores), strips whose window lies inside the image
# (16-byte loads), and a frame tall enough that a band walks several steps.
BAYER_EDGE_HW = ((2, 2), (3, 5), (7, 9), (17, 65), (33, 130), (61, 133),
                 (45, 255), (70, 380), (515, 8000))
# The RAW batch's edit: sliders and sharpening, default curves (the
# kernel's identity_oklch variant), as `cli batch` flags.
RAW_FLAGS = ["--exposure", "0.5", "--contrast", "20", "--shadow", "15",
             "--highlight", "-10", "--wb-temperature", "10", "--vignette", "30",
             "--sharpness", "30"]
XYZ_TO_CAM = np.array([[0.8, -0.1, -0.05], [-0.3, 1.1, 0.15],
                       [-0.05, 0.15, 0.65]])


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
    """(name, params, masks, flags, bit-identical partner: None, "general"
    (the params with no shortcut) or "explicit_ones") for the kernel-vs-twin
    phase at one shape, with the planes and an f32 all-ones mask row."""
    import torch

    from rawphotoforge_tpu_torch.core.params import (
        BRIGHTNESS, EditParameters, pack_params)

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
    return planes, [
        ("general", p_full, None, {}, None),
        ("default_curves", p_tone, None, {}, "general"),
        ("oklch_default", p_drag, None, {}, "general"),
        ("identity_oklch", p_tone, None, dict(identity_oklch=True), None),
        ("main_only", p_full, None, {}, "explicit_ones"),
        ("m4_u8_slots", p_m4, masks, {}, "general"),
    ], ones_f32


def _f32_bits(x):
    return int(np.float32(x).view(np.int32))


def sweep_device_fn(dev, name, twin, lo, hi, chunk=1 << 26):
    """fused.device_fn(name) against ``twin`` on every f32 from ``lo`` to
    ``hi`` (both included, 0 <= lo <= hi), chunk by chunk on the card.
    Returns (values, values whose bit patterns differ)."""
    import torch

    from rawphotoforge_tpu_torch.kernels import fused

    a, b = _f32_bits(lo), _f32_bits(hi)
    total = differ = 0
    for s in range(a, b + 1, chunk):
        x = torch.arange(s, min(b + 1, s + chunk), dtype=torch.int32,
                         device=dev).view(torch.float32)
        got = fused.device_fn(name, x)
        ref = twin(x)
        differ += int((got.view(torch.int32) != ref.view(torch.int32)).sum())
        total += x.numel()
        del x, got, ref
    return total, differ


def phase_device_functions(dev, log):
    """Phase 2a: the edit stack's OKLab cube root, its OETF and the two
    divisions it now takes as a multiply and a correction, exhaustively
    against their torch twins, bit for bit."""
    import torch

    from rawphotoforge_tpu_torch.core import color
    from rawphotoforge_tpu_torch.core.numerics import div
    from rawphotoforge_tpu_torch.kernels import fused, ktrig

    for name, twin, lo, hi, what in (
            ("cbrt_pow", color._cbrt, 0.0, 2.0, "every f32 in [0, 2]"),
            ("srgb_oetf", ktrig.srgb_oetf, 0.0, 1.0, "every f32 in [0, 1]"),
            ("srgb_oetf", ktrig.srgb_oetf, 1.0, 64.0, "every f32 in [1, 64]")):
        n, bad = sweep_device_fn(dev, name, twin, lo, hi)
        log(f"phase 2a: {name} vs its torch twin over {what}: {n} values, "
            f"{bad} differ")
        check(bad == 0, f"{name}: {bad} of {n} values differ from the twin")
    whole = torch.arange(65536, dtype=torch.float32, device=dev)
    for name, d in (("div_65535", 65535.0), ("div_32767_5", 32767.5)):
        got = fused.device_fn(name, whole)
        bad = int((got.view(torch.int32) != div(whole, d).view(torch.int32)).sum())
        log(f"phase 2a: {name} (multiply + one residual correction) vs the "
            f"IEEE quotient over all 65536 whole y in [0, 65535]: {bad} differ")
        check(bad == 0, f"{name}: {bad} quotients differ")
    torch.cuda.empty_cache()


def curve_rows(dev, s):
    """A 2-mask edit whose packed curve rows have S = ``s`` segments (S = 1:
    the first segment of an S = 2 row, extended over the whole domain)."""
    import dataclasses

    from rawphotoforge_tpu_torch.core.params import (
        BRIGHTNESS, HUE, LIGHTNESS, EditParameters, pack_params)

    n = {1: 2, 2: 2, 4: 3, 8: 7, 16: 15}[s]  # control points that pack into s
    xs = np.linspace(0, 65535, n).round().astype(int).tolist()
    rng = np.random.default_rng(SEED + 10 + s)
    ys = np.sort(rng.integers(0, 65536, n)).tolist()
    main = EditParameters()
    main.set_tone(exposure=0.5, contrast=20)
    main.set_vignette(35)
    main.set_curve(BRIGHTNESS, xs, ys)
    main.set_curve(HUE, xs, rng.integers(0, 65536, n).tolist())
    reg = EditParameters()
    reg.set_tone(exposure=-0.3)
    reg.set_curve(LIGHTNESS, xs, rng.integers(20000, 45000, n).tolist())
    params = pack_params([main, reg], device=dev)
    if s == 1:
        params = dataclasses.replace(
            params, breaks=params.breaks[..., :1].contiguous(),
            coeffs=params.coeffs[..., :1, :].contiguous())
    check(params.breaks.shape[-1] == s, f"curve rows packed S="
          f"{params.breaks.shape[-1]}, want {s}")
    return params


def phase_kernel_vs_twin(dev, log):
    import torch

    from rawphotoforge_tpu_torch.kernels import fused

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_fixtures import no_shortcuts

    rng = np.random.default_rng(SEED)
    worst = {}
    # Every S a curve row can pack into, on two small shapes (the second
    # with a width that is not a multiple of 4), u8 regional masks.
    for h, w in ((48, 160), (37, 150)):
        planes = torch.from_numpy(rng.random((3, h, w), dtype=np.float32)).to(dev)
        masks = torch.ones((2, h, w), dtype=torch.uint8, device=dev)
        masks[1, :, ::3] = 0
        for s in (1, 2, 4, 8, 16):
            params = curve_rows(dev, s)
            out = fused.develop_post_geo_fused(planes, params, masks)
            torch.cuda.synchronize()
            bit_identical(out, fused.develop_post_geo_fused_ref(planes, params, masks),
                          f"S={s} {h}x{w} kernel vs twin")
        log(f"phase 2: curve rows S=1, 2, 4, 8, 16 at {h}x{w} (M=2, u8 "
            f"masks): kernel == twin bit for bit")
    for h, w in ((48, 160), (37, 150), (BUCKET_HW[0], BUCKET_HW[1] - 3), BUCKET_HW):
        planes, cases, ones_f32 = variants(h, w, dev, rng)
        for name, params, masks, flags, partner in cases:
            out = fused.develop_post_geo_fused(planes, params, masks, **flags)
            torch.cuda.synchronize()
            ref = fused.develop_post_geo_fused_ref(planes, params, masks, **flags)
            err = compare(out, ref, what=f"{name} {h}x{w} kernel vs twin")
            bit_identical(out, ref, f"{name} {h}x{w} kernel vs twin")
            worst[name] = max(worst.get(name, 0.0), err)
            note = ""
            if partner == "explicit_ones":
                other = fused.develop_post_geo_fused(planes, params, ones_f32)
                bit_identical(out, other, f"{name} {h}x{w} vs an f32 ones row")
                note = "; bit-identical to an explicit f32 ones row"
            elif partner == "general":
                general = fused.develop_post_geo_fused(
                    planes, no_shortcuts(params), masks)
                bit_identical(out, general, f"{name} {h}x{w} vs general kernel")
                note = "; bit-identical to the general kernel"
            if name == "identity_oklch":
                check(fused.skips_oklch(params, True),
                      "identity_oklch case does not skip the OKLCH pass")
                general = fused.develop_post_geo_fused(planes, params, masks)
                dev_max = (out - general).abs().max().item()
                check(dev_max < 3e-3, f"identity_oklch {h}x{w}: {dev_max:.3e} "
                      "from the full path (bound 3e-3)")
                note = f"; {dev_max:.3e} from the full OKLCH path (bound 3e-3)"
            log(f"phase 2: {name} {h}x{w}: kernel == twin bit for bit "
                f"(max abs err {err:.3e}){note}")
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
    from rawphotoforge_tpu_torch.kernels import fused, geometry

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
    geometry.KERNEL_LAUNCHES = dict.fromkeys(geometry.KERNEL_LAUNCHES, 0)
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
    geo_launches = geometry.KERNEL_LAUNCHES["geometry_sharpen_kernel"]
    t_main = time.perf_counter() - t0
    check(rc == 0, f"cli develop exited {rc}")
    check(launches > 0, "the main path never launched the develop kernel")
    check(geo_launches > 0, "the main path never launched the geometry kernel")
    log(f"phase 3: main path (editor FULL/MID/LOW + histogram + clipping + "
        f"cli develop) in {t_main:.2f} s; develop kernel launches {launches}, "
        f"geometry kernel launches {geo_launches}")

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
    return ed, launches, geo_launches


def phase_geometry_kernel(dev, ed, card, log):
    """Phase 3b: the geometry stage phase 3's editor cached (lens distortion
    -20, sharpness 30: the kernel's output) bit for bit against the plain
    torch chain, kernels/geometry's twin, on the card at each level's bucket
    grid; then the kernel against the chain at 45 MP (GEOMETRY_TIME_HW,
    true extent GEOMETRY_TIME_EXTENT) with both sliders, each alone and at
    the range's end, and its times there (``geometry_times``). Returns the
    kernel's row of the kernels table."""
    import torch

    from rawphotoforge_tpu_torch.engine.editor import FULL, LOW, MID
    from rawphotoforge_tpu_torch.kernels import geometry

    main = ed._find("main").params
    dist, amount = float(main.lens_distortion), float(main.sharpness) / 100.0 * 2.0
    before = dict(geometry.KERNEL_LAUNCHES)
    for level in (FULL, MID, LOW):
        plain = geometry.geometry_sharpen_ref(ed._original_at(level).contiguous(), dist,
                                              amount, ed.level_shape(level))
        same_bits(ed._geo_at(level), plain,
                  f"phase 3b: editor {level} geometry kernel vs the plain chain")
    check(geometry.KERNEL_LAUNCHES == before, "phase 3b: the editor's geometry cache missed")
    log(f"phase 3b: editor geometry (distortion {dist}, sharpness {main.sharpness}) at "
        f"FULL/MID/LOW {[ed._original_at(lv).shape[1:] for lv in (FULL, MID, LOW)]} "
        f"bit for bit the plain chain on the card")

    h, w = GEOMETRY_TIME_HW
    planes = geometry_planes(np.random.default_rng(SEED + 11), h, w, dev)
    err = 0.0
    for d, sharp in ((40.0, 55.0), (-100.0, 5.0), (0.0, 100.0), (100.0, 0.0)):
        a = sharp / 100.0 * 2.0
        ours = geometry.geometry_sharpen(planes, d, a, GEOMETRY_TIME_EXTENT)
        plain = geometry.geometry_sharpen_ref(planes, d, a, GEOMETRY_TIME_EXTENT)
        same_bits(ours, plain, f"phase 3b: {w}x{h} distortion {d} sharpness {sharp}")
        err = max(err, float((ours - plain).abs().max()))
        del ours, plain
    times = {}
    info = geometry_times(dev, times, planes)
    del planes
    torch.cuda.empty_cache()
    check(info["launches_per_call"] == 1.0,
          f"phase 3b: {info['launches_per_call']} geometry launches a call, not 1")
    key = f"{w}x{h}"
    row = dict(ms=times[f"geometry_stage_{key}"], plain_ms=times[f"geometry_plain_{key}"],
               bound_ms=info["bound_ms"], bound_by="bytes", max_abs_err=err)
    log(f"phase 3b: {w}x{h} (true {GEOMETRY_TIME_EXTENT[1]}x{GEOMETRY_TIME_EXTENT[0]}) "
        f"kernel bit for bit the plain chain in 4 slider cases; distortion 40 sharpness "
        f"55: kernel {row['ms']:.4f} ms, {info['stage_pct_of_bound']:.1f}% of the "
        f"{row['bound_ms']:.4f} ms byte bound; plain chain {row['plain_ms']:.4f} ms [{card}]")
    return row


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


def m4_masks(dev):
    """Phase 3's M=4 u8 mask stack at FULL on the bucket grid, as the editor
    builds it: row 0 all ones on the photo, rows 1..3 the regions' logits
    >= 0, zero in the padding."""
    import torch

    (h, w), (hb, wb) = PHOTO_HW, BUCKET_HW
    masks = np.zeros((4, hb, wb), np.uint8)
    masks[0, :h, :w] = 1
    for k, logit in enumerate(region_logits(h, w), start=1):
        masks[k, :h, :w] = logit >= 0.0
    return torch.from_numpy(masks).to(dev)


def develop_cases(dev):
    """Phase 4's timed develop-kernel calls on the 24 MP bucket grid:
    (planes, [(name, param list, masks, flags)]); each param list's default
    curves take their shortcuts (``DevelopParams.default_slots``)."""
    import torch

    from rawphotoforge_tpu_torch.core.params import BRIGHTNESS, EditParameters

    hb, wb = BUCKET_HW
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
    return planes, [
        ("full_stack", [full], None, {}),
        ("slider_only", [tone], None, dict(identity_oklch=True)),
        ("tone_curve_drag", [drag], None, dict(identity_oklch=True)),
        ("m4_regional", stack, m4_masks(dev), {}),
    ]


def phase_timing(dev, ed, card, log):
    import torch

    from rawphotoforge_tpu_torch.core.params import pack_params
    from rawphotoforge_tpu_torch.engine.editor import FULL, LOW, MID
    from rawphotoforge_tpu_torch.kernels import fused

    hb, wb = BUCKET_HW
    hw = hb * wb
    planes, cases = develop_cases(dev)
    results = {}
    for name, plist, masks, flags in cases:
        params = pack_params(plist, extent=PHOTO_HW, device=dev)
        m, s = len(plist), params.breaks.shape[-1]
        if masks is not None:
            check(torch.equal(masks[1:], ed._masks_at(FULL)[1:]),
                  "phase 4's regional masks differ from the editor's")
            coverage = [1.0] + [float(masks[k].float().mean()) for k in range(1, m)]
        slots = params.default_slots
        identity = fused.skips_oklch(params, flags.get("identity_oklch", False))
        ms = time_events(lambda: fused.develop_post_geo_fused(
            planes, params, masks, **flags), reps=20)
        plain = time_events(lambda: fused.develop_post_geo_fused_ref(
            planes, params, masks, **flags), reps=2, warm=1)
        main_only = masks is None
        nbytes = 24 * hw + (0 if main_only else m * hw) + 4 * (4 + 11 * m + 20 * m * s)
        ops = op_count(m, s, slots, identity,
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


# -- the RAW kernel -------------------------------------------------------------

def raw_edits():
    """(sliders-only edit, full-curve edit, M=3 stack) for the RAW kernel."""
    from rawphotoforge_tpu_torch.core.params import EditParameters

    tone = EditParameters()
    tone.set_tone(exposure=0.5, contrast=20, shadow=15, highlight=-10)
    tone.set_whitebalance(temperature=10)
    tone.set_vignette(30)
    full = EditParameters()
    bench_edit(full)
    return tone, full, [full, *regional_edits()[:2]]


def raw_cam():
    from rawphotoforge_tpu_torch.ops.demosaic import cam_matrix_to_srgb

    return cam_matrix_to_srgb(XYZ_TO_CAM)


def phase_raw_kernel_vs_twin(dev, log):
    import torch

    from rawphotoforge_tpu_torch.core.params import pack_params
    from rawphotoforge_tpu_torch.kernels import raw_pipeline as rp

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_fixtures import no_shortcuts

    rng = np.random.default_rng(SEED + 3)
    tone, full, stack = raw_edits()
    cam = raw_cam()
    wb = (1.9, 1.0, 1.5)
    # (pattern, (h, w), storage offset of the mosaic in floats)
    shapes = [(p, hw, 0) for p in ("RGGB", "BGGR", "GRBG", "GBRG")
              for hw in ((64, 512), (50, 300), (37, 150), *BAYER_EDGE_HW)]
    shapes += [("RGGB", (70, 380), 1),
               ("XTRANS", (96, 768), 0), ("XTRANS", (100, 700), 0),
               ("XTRANS", (12, 12), 0), ("XTRANS", (61, 133), 0),
               ("RGGB", BAYER_HW, 0), ("XTRANS", XTRANS_HW, 0)]
    worst = {"bayer": 0.0, "xtrans": 0.0}
    for pattern, (h, w), offset in shapes:
        mosaic = torch.from_numpy(rng.random((h, w), dtype=np.float32)).to(dev)
        if offset:  # a contiguous view off the 16-byte grid: scalar loads
            mosaic = torch.cat([mosaic.new_zeros(offset), mosaic.reshape(-1)])[
                offset:].view(h, w)
        masks = np.zeros((3, h, w), np.uint8)
        masks[0] = 1
        for k, logit in enumerate(region_logits(h, w)[:2], start=1):
            masks[k] = logit >= 0.0
        masks = torch.from_numpy(masks).to(dev)
        p_full = pack_params([full], extent=(h, w), device=dev)
        p_tone = pack_params([tone], extent=(h, w), device=dev)
        p_m3 = pack_params(stack, extent=(h, w), device=dev)
        cases = [
            ("M1_sharpen0", p_full, None, 0.0, {}),
            ("M3_u8_sharpen0.8", p_m3, masks, 0.8, {}),
            ("shortcuts", p_tone, None, 0.8, {}),
            ("identity_oklch", p_tone, None, 0.8, dict(identity_oklch=True)),
        ]
        notes = []
        for name, params, mk, amt, flags in cases:
            args = (mosaic, wb, cam, params, np.float32(amt))
            what = f"RAW {pattern} {h}x{w} {name}"
            out = rp.raw_develop_fused(*args, pattern=pattern, masks=mk, **flags)
            torch.cuda.synchronize()
            ref = rp.raw_develop_fused_ref(*args, pattern=pattern, masks=mk,
                                           **flags)
            kind = "xtrans" if pattern == "XTRANS" else "bayer"
            worst[kind] = max(worst[kind], float((out - ref).abs().max().item()))
            bit_identical(out, ref, f"{what} kernel vs twin")
            if name == "shortcuts":
                general = rp.raw_develop_fused(
                    mosaic, wb, cam, no_shortcuts(params), np.float32(amt),
                    pattern=pattern)
                bit_identical(out, general, f"{what} shortcuts vs general kernel")
            if name == "identity_oklch":
                general = rp.raw_develop_fused(*args, pattern=pattern)
                dev_max = float((out - general).abs().max().item())
                check(dev_max < 3e-3, f"{what}: {dev_max:.3e} from the full "
                      "path (bound 3e-3)")
                notes.append(f"identity_oklch {dev_max:.3e} from the full path")
        at = f" at storage offset {offset}" if offset else ""
        log(f"phase 5: RAW {pattern} {h}x{w}{at}: kernel == twin bit for bit in "
            f"{len(cases)} cases (M=1/M=3 u8, sharpen 0/0.8, shortcuts "
            f"bit-identical to the general kernel; {'; '.join(notes)})")
        del mosaic, masks
        torch.cuda.empty_cache()
    return worst


def write_raw_dir(tmp, log):
    """The main path's input: a 24 MP RGGB lossless-JPEG DNG and a 26 MP
    X-Trans DNG (uncompressed, EXIF orientation 6: a portrait shot),
    written with the port's write_dng from seeded smooth-plus-texture
    scenes."""
    import dataclasses

    from rawphotoforge_tpu_torch.io import dng, raw as rawio

    rng = np.random.default_rng(SEED + 4)
    files = {}
    for name, pattern, (h, w), orientation, kw in (
            ("bayer24.dng", "RGGB", BAYER_HW, 1, dict(compression=7)),
            ("xtrans26.dng", "XTRANS", XTRANS_HW, 6, dict(compression=1))):
        raw = rawio.synthetic_raw(smooth_scene(rng, h, w), pattern,
                                  xyz_to_cam=XYZ_TO_CAM)
        raw = dataclasses.replace(raw, orientation=orientation, exif={
            "Make": "Synthetic", "Model": "chip-smoke"})
        t0 = time.perf_counter()
        data = dng.write_dng(raw, **kw)
        path = os.path.join(tmp, name)
        with open(path, "wb") as f:
            f.write(data)
        files[name] = (path, (h, w), orientation)
        log(f"phase 6: wrote {name}: {pattern} {w}x{h} orientation "
            f"{orientation}, {len(data)} bytes "
            f"({'lossless JPEG' if kw['compression'] == 7 else 'uncompressed'}) "
            f"in {time.perf_counter() - t0:.2f} s")
    return files


def run_batch(in_dir, out_dir, dev):
    """`cli batch` on the card; returns (rc, its stdout), echoed."""
    from rawphotoforge_tpu_torch.app import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["batch", in_dir, out_dir, *RAW_FLAGS, "--device", str(dev)])
    sys.stdout.write(buf.getvalue())
    return rc, buf.getvalue()


def phase_raw_main_path(dev, log):
    import dataclasses

    import torch
    from PIL import Image

    from rawphotoforge_tpu_torch.app import cli
    from rawphotoforge_tpu_torch.core.params import pack_params
    from rawphotoforge_tpu_torch.io import image_io, jpegenc, raw as rawio
    from rawphotoforge_tpu_torch.kernels import fused, jpeg_wire, raw_pipeline as rp
    from rawphotoforge_tpu_torch.ops import demosaic as dm
    from rawphotoforge_tpu_torch.ops.geometry import orient_exif
    from rawphotoforge_tpu_torch.ops.sharpen import unsharp_mask

    tmp = tempfile.mkdtemp(prefix="chip_smoke_raw_")
    in_dir, out_dir = os.path.join(tmp, "in"), os.path.join(tmp, "out")
    os.makedirs(in_dir)
    files = write_raw_dir(in_dir, log)

    twin_calls = [0]
    real_twin = rp.raw_develop_fused_ref

    def counted_twin(*a, **k):
        twin_calls[0] += 1
        return real_twin(*a, **k)

    rp.raw_develop_fused_ref = counted_twin
    rp.KERNEL_LAUNCHES = dict.fromkeys(rp.KERNEL_LAUNCHES, 0)  # run starts
    jpeg_wire.KERNEL_LAUNCHES = dict.fromkeys(jpeg_wire.KERNEL_LAUNCHES, 0)
    fused.LAUNCHES = 0
    t0 = time.perf_counter()
    try:
        rc, out = run_batch(in_dir, out_dir, dev)
        torch.cuda.synchronize()
    finally:
        rp.raw_develop_fused_ref = real_twin
    # the RAW main path's run ends here
    per_kernel = dict(rp.KERNEL_LAUNCHES, **jpeg_wire.KERNEL_LAUNCHES)
    t_main = time.perf_counter() - t0
    check(rc == 0, f"cli batch exited {rc}")
    want = dict(bayer_kernel=1, xtrans_kernel=1,
                **dict.fromkeys(jpeg_wire.KERNEL_LAUNCHES, len(files)))
    check(per_kernel == want, f"batch launches by kernel {per_kernel} (want {want})")
    check(twin_calls[0] == 0, f"the RAW twin ran {twin_calls[0]} times on the "
          "main path")
    log(f"phase 6: RAW main path (cli batch of {len(files)} DNGs on the card) in "
        f"{t_main:.2f} s; kernel launches {per_kernel}, RAW twin calls "
        f"{twin_calls[0]}, develop kernel launches {fused.LAUNCHES}")

    flags = _parse_flags(RAW_FLAGS)
    edit = cli._params_from_args(flags)
    for name, (path, (h, w), orientation) in files.items():
        jpg = os.path.join(out_dir, os.path.splitext(name)[0] + ".jpg")
        with Image.open(jpg) as im:
            got = np.asarray(im.convert("RGB")).astype(np.int32)
        upright_hw = (w, h) if orientation == 6 else (h, w)
        check(got.shape == (*upright_hw, 3), f"{jpg} decodes to {got.shape}")
        # The one-pass render before orientation, against the composed path
        # on the card.
        with open(path, "rb") as f:
            raw = rawio.parse_raw(f.read())
        render = cli.raw_fast_render(
            dataclasses.replace(raw, orientation=1), edit, dev)
        mos01 = rawio.normalized_mosaic(raw, raw.mosaic, dev)
        xt = raw.pattern == "XTRANS"
        planes = dm.develop_raw(mos01, raw.wb_gains, rawio.cam2srgb_for(raw),
                                pattern=raw.pattern,
                                method="residual" if xt else "malvar")
        planes = unsharp_mask(planes, edit.sharpness / 100.0 * 2.0)
        composed = fused.develop_post_geo_fused(
            planes, pack_params([edit], extent=(h, w), build_luts=False,
                                device=dev),
            None, identity_oklch=True)
        trim = 14 if xt else 4
        err = compare(render[:, trim:-trim, trim:-trim],
                      composed[:, trim:-trim, trim:-trim], loose=1e-2,
                      what=f"{name} one-pass vs composed")
        check(bool(torch.isfinite(render).all()), f"{name} render not finite")
        del mos01, planes, composed
        # What the batch did after the kernel: the file holds exactly the
        # JPEG of this render oriented on the card, and the card's JPEG
        # blocks of it (jpeg_blocks_kernel) equal the CPU twin's of the host
        # rotation of the render, bit for bit.
        oriented = orient_exif(render, raw.orientation)
        with open(jpg, "rb") as f:
            check(f.read() == jpegenc.encode_jpeg(
                oriented, quality=flags.quality,
                exif_bytes=image_io.build_exif_bytes(raw.exif)),
                f"{name}: the batch JPEG is not the encode of the render")
        hwc = render.cpu().numpy().transpose(1, 2, 0)
        if orientation == 6:
            hwc = np.rot90(hwc, -1)
        host = torch.from_numpy(np.ascontiguousarray(hwc.transpose(2, 0, 1)))
        q = jpegenc._quant_tables(flags.quality)
        bit_identical(jpeg_wire.blocks(oriented, *q).cpu(), jpegenc.blockify(host, *q),
                      f"{name}: card JPEG blocks vs the CPU twin of the host rotation")
        log(f"phase 6: {name}: JPEG {upright_hw[1]}x{upright_hw[0]} decodes "
            f"(orientation {orientation}); one-pass render vs composed path "
            f"(demosaic -> unsharp -> develop kernel) on the {trim}-px-trimmed "
            f"interior: max abs err {err:.3e} (assert_close, loose 1e-2); the "
            f"JPEG is byte for byte the encode of the card-oriented render; its "
            f"blocks on the card == the CPU twin's of the host rotation, bit "
            f"for bit")
        del render
        torch.cuda.empty_cache()
    return per_kernel, in_dir, tmp


def raw_op_count(pattern, sharpen_on):
    """f32 operations of the RAW kernel per output pixel before the edit
    stack, counted as op_count counts them: WB 1; Malvar 26 (a site
    computes only its own phase's estimates: green sites 7 neighbour sums,
    two 8-op filters and 2 selects; red and blue sites 9 sums, two 5-6-op
    filters and 2 selects; the phase test) or the X-Trans residual demosaic
    160 (gradients 4, two 7x7 separable energy sums 52, two 1-D green NCs
    32, 3 selects and d, two chroma NCs 62, phase tests 6); camera matrix +
    clip 21; unsharp 69 when the amount is not 0."""
    demosaic = 160 if pattern == "XTRANS" else 26
    return 1 + demosaic + 21 + (69 if sharpen_on else 0)


class StageClock:
    """Wraps the function of each stage of a run: host ms between two
    synchronizes; for a stage of kind "events" also the device ms between
    two CUDA events, for kind "bytes" also the bytes of the arrays it
    returns. A context manager: the functions are restored on exit."""

    def __init__(self, stages):
        self.stages = stages
        self.ms, self.device_ms, self.nbytes, self._real = {}, {}, {}, []

    def __enter__(self):
        import torch

        for mod, attr, name, kind in self.stages:
            fn = getattr(mod, attr)

            def timed(*a, _fn=fn, _name=name, _kind=kind, **k):
                torch.cuda.synchronize()
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                t = time.perf_counter()
                try:
                    out = _fn(*a, **k)
                    ev[1].record()
                finally:
                    torch.cuda.synchronize()
                    self.ms[_name] = self.ms.get(_name, 0.0) + (
                        time.perf_counter() - t) * 1e3
                if _kind == "events":
                    self.device_ms[_name] = self.device_ms.get(_name, 0.0) + (
                        ev[0].elapsed_time(ev[1]))
                if _kind == "bytes":
                    self.nbytes[_name] = self.nbytes.get(_name, 0) + out.nbytes
                return out

            self._real.append((mod, attr, fn))
            setattr(mod, attr, timed)
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self._real:
            setattr(mod, attr, fn)

    def line(self, n=1):
        """The stages per image (of ``n``), with device ms and bytes."""
        parts = []
        for name, ms in self.ms.items():
            extra = ""
            if name in self.device_ms:
                extra = f" (device {self.device_ms[name] / n:.3f} by CUDA events)"
            if name in self.nbytes:
                extra = f" ({self.nbytes[name] / n / 1e6:.3f} MB)"
            parts.append(f"{name} {ms / n:.2f}{extra}")
        return ", ".join(parts)


def jpeg_stages():
    """The packed JPEG wire's stages: the device wire (blocks, Huffman and
    pack kernels), the fetch of the finished scan, the native assembly."""
    from rawphotoforge_tpu_torch import native
    from rawphotoforge_tpu_torch.io import jpegbits

    return ((jpegbits, "wire_packed_extent", "JPEG device wire", "events"),
            (jpegbits, "fetch_scan", "scan fetch", "bytes"),
            (native, "jpeg_encode_packed", "JPEG assembly", None))


def staged_batch(in_dir, out_dir, dev):
    """`cli batch` once more with the function of each stage wrapped
    (StageClock): (wall ms, the clock) summed over the images. The stages:
    host parse (LJPEG decode included), upload + normalize, the RAW kernel,
    the JPEG device wire, the scan fetch, the JPEG assembly."""
    import torch

    from rawphotoforge_tpu_torch.io import raw as rawio
    from rawphotoforge_tpu_torch.kernels import raw_pipeline as rp

    stages = ((rawio, "parse_raw", "parse+LJPEG decode", None),
              (rawio, "normalized_mosaic", "upload+normalize", None),
              (rp, "raw_develop_fused", "RAW kernel", "events"), *jpeg_stages())
    with StageClock(stages) as clock:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc, _ = run_batch(in_dir, out_dir, dev)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    check(rc == 0, f"cli batch (staged) exited {rc}")
    check(len(clock.ms) == len(stages), f"stages seen: {sorted(clock.ms)}")
    return wall_ms, clock


def device_busy(run, log, what, card):
    """Runs ``run()`` (a warm batch: (rc, its stdout)) under the profiler
    and logs its throughput line and the card's busy and idle share of its
    wall (device events: kernels and copies, one stream, so their sum is
    their union)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rc, out = run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    check(rc == 0, f"{what} (traced) exited {rc}")
    rate = [ln.strip() for ln in out.splitlines() if "MPix/s end-to-end" in ln]
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy_ms = sum(by_name.values())
    if busy_ms == 0.0:
        log(f"{what}: the profiler saw no device events: the device busy "
            "share is not measured")
        return
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log(f"{what} under the profiler ({rate[0] if rate else 'no rate line'}): "
        f"{wall_ms:.1f} ms wall, device busy "
        f"{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.2f} %, idle "
        f"{100 - 100 * busy_ms / wall_ms:.2f} %); top device events: "
        + "; ".join(f"{n[:60]} {t:.2f} ms" for n, t in top) + f" [{card}]")


RAW_FRAMES = (("RGGB", BAYER_HW), ("RGGB", NORTH_STAR_HW), ("XTRANS", XTRANS_HW))


def raw_variants():
    """Phase 7's edits per frame: (name, edit, flags)."""
    tone, full, _ = raw_edits()
    return (("batch_flags", tone, dict(identity_oklch=True)),
            ("full_curves", full, {}))


def raw_args(dev, mosaic, edit):
    from rawphotoforge_tpu_torch.core.params import pack_params

    h, w = mosaic.shape
    params = pack_params([edit], extent=(h, w), build_luts=False, device=dev)
    return (mosaic, (1.9, 1.0, 1.5), raw_cam(), params,
            np.float32(30 / 100.0 * 2.0))


def phase_raw_timing(dev, card, in_dir, tmp, log):
    import torch

    from rawphotoforge_tpu_torch.kernels import fused, raw_pipeline as rp

    rng = np.random.default_rng(SEED + 5)
    results = {}
    for pattern, (h, w) in RAW_FRAMES:
        hw = h * w
        mosaic = torch.from_numpy(rng.random((h, w), dtype=np.float32)).to(dev)
        for variant, edit, flags in raw_variants():
            args = raw_args(dev, mosaic, edit)
            s = args[3].breaks.shape[-1]
            ms = time_events(lambda: rp.raw_develop_fused(
                *args, pattern=pattern, **flags), reps=20)
            plain = time_events(lambda: rp.raw_develop_fused_ref(
                *args, pattern=pattern, **flags), reps=2, warm=1)
            nbytes = 16 * hw + 4 * (21 + 11 + 20 * s)
            ops = (raw_op_count(pattern, True) + op_count(
                1, s, args[3].default_slots,
                fused.skips_oklch(args[3], flags.get("identity_oklch", False)),
                [1.0], 1)) * hw
            t_bytes = nbytes / PEAK_BYTES_S * 1e3
            t_ops = ops / PEAK_F32_S * 1e3
            bound = max(t_bytes, t_ops)
            by = "bytes" if t_bytes >= t_ops else "operations"
            key = f"{pattern}_{w}x{h}_{variant}"
            results[key] = dict(ms=ms, plain_ms=plain, bound_ms=bound,
                                bound_by=by)
            log(f"phase 7: RAW kernel {pattern} {w}x{h} ({hw / 1e6:.1f} MP) "
                f"{variant} S={s}: {ms:.4f} ms/frame ({hw / ms / 1e6:.1f} "
                f"GPix/s); bound {bound:.4f} ms by {by} (bytes "
                f"{nbytes / 1e6:.1f} MB -> {t_bytes:.4f} ms at 3.35 TB/s; ops "
                f"{ops / 1e9:.2f} G -> {t_ops:.4f} ms at 67 TFLOP/s f32); "
                f"{100 * bound / ms:.1f}% of roofline; plain twin {plain:.2f} ms "
                f"(no yardstick); 1 launch/image; library_ms none [{card}]")
        del mosaic
        torch.cuda.empty_cache()

    # The batch again, warm: MPix/s end to end, then once more with each
    # stage timed.
    rc, out = run_batch(in_dir, os.path.join(tmp, "out2"), dev)
    check(rc == 0, f"cli batch (timed) exited {rc}")
    rate_line = [ln for ln in out.splitlines() if "MPix/s end-to-end" in ln]
    check(rate_line, "cli batch printed no throughput line")
    log(f"phase 7: cli batch, warm, 2 DNGs (24 MP Bayer LJPEG + 26 MP X-Trans): "
        f"{rate_line[0].strip()} [{card}]")
    wall_ms, clock = staged_batch(in_dir, os.path.join(tmp, "out_staged"), dev)
    n = len(os.listdir(in_dir))
    log(f"phase 7: cli batch with each stage between synchronizes, ms/image: "
        + clock.line(n) + f", rest (file I/O, crop/orientation, EXIF) "
        f"{(wall_ms - sum(clock.ms.values())) / n:.2f}; wall {wall_ms / n:.2f} "
        f"ms/image [{card}]")
    device_busy(lambda: run_batch(in_dir, os.path.join(tmp, "out3"), dev), log,
                "phase 7: cli batch", card)
    return results


# -- the JPEG device wires ------------------------------------------------------

# Phase 9's frames: small, odd, a padded render with its true extent, the
# blocks kernel's edges (a 1x1 true extent; a row pitch off the 16-byte grid
# with 33 chunks in one strip; 3 MCU rows, 195 chunks, fewer than a wave of
# blocks), the 24 MP and 45.4 MP frames, and the export's own case: the
# 24 MP photo on its bucket grid, whose chunks inside the true width stage
# by 16-byte copies, the strips beyond the true height from its last true
# rows; (h, w, true extent or None).
JPEG_SHAPES = ((37, 50, None), (61, 97, None), (128, 128, (100, 72)),
               (17, 33, (1, 1)), (16, 4099, (9, 4097)), (40, 8256, None),
               (*BAYER_HW, None), (*NORTH_STAR_HW, None), (*BUCKET_HW, PHOTO_HW))
JPEG_QUALITY = 95   # cli batch's default


def jpeg_edge_blocks():
    """Hand-fed worst cases for the Huffman and pack kernels: int16 blocks
    with absolute DCs over 6 MCUs (grid 3 x 2): every AC at +-1023 (the
    52-word bound), DC deltas of +-2047 (absolute DCs alternating 1023 and
    -1024 along each chain of MCUs 3..5), ZRL runs of 16, 32 and 47 zeros,
    a nonzero last lane (no EOB), all-zero blocks. The second array adds an
    AC of 1024 and a DC delta past 2047, outside the baseline domain."""
    b = np.zeros((36, 64), np.int16)
    b[6:12, 1:] = 1023
    b[7, 1:] = -1023
    b[12, 17], b[13, 34], b[14, 48], b[15, 63] = 3, -5, 7, 1
    for chain in ([18, 19, 20, 21, 24, 25, 26, 27, 30, 31, 32, 33],  # Y
                  [22, 28, 34], [23, 29, 35]):                        # Cb, Cr
        for i, blk in enumerate(chain):
            b[blk, 0] = 1023 if i % 2 == 0 else -1024
    oob = b.copy()
    oob[20, 5] = 1024
    oob[31, 0] = 3000
    return b, oob


# The bit lengths jpeg_lane_extremes gives its targeted blocks: 32k - 1,
# 32k and 32k + 1 for k = 1 .. 6.
LANE_TARGET_BITS = tuple(32 * k + d for k in range(1, 7) for d in (-1, 0, 1))


def jpeg_lane_extremes():
    """Hand-fed lane extremes for the Huffman kernel's warp formulation:
    int16 blocks with absolute DCs on a grid of 4 MCU columns, the first 3
    rows and 3 columns true, (blocks [96, 64], (grid_c, mcu_r, mcu_c)).
    In the true MCUs' luma chain: 59-bit lanes (one nonzero at zigzag 63,
    |v| >= 512: 3 ZRLs, then (14, 10)) behind a 2-bit and a 20-bit DC, so the
    lane spans two and three words; nonzeros at 31/32/33, at 32 alone and at
    31 and 33 (the seam between a lane's two positions); a nonzero only at
    1; a DC-only block; blocks of exactly LANE_TARGET_BITS bits (runs of +-1
    from zigzag 1, the last ones +-2, so lanes end on word boundaries).
    Chroma: DC-only blocks with DC deltas of +-2047, a nonzero only at 1,
    only at 63. The padding MCUs (column 3, row 3) hold +-1023 everywhere:
    they must code to nothing."""
    from rawphotoforge_tpu_torch.io import jpegbits

    grid_c, mcu_r, mcu_c = 4, 3, 3
    lengths = jpegbits.huffman_table() & 31

    def ac_only(pairs):
        b = np.zeros(64, np.int32)
        for pos, v in pairs:
            b[pos] = v
        return b

    def with_dc(dc, b):
        b = b.copy()
        b[0] = dc
        return b

    luma = [with_dc(0, ac_only([(63, 700)])), with_dc(1500, ac_only([(63, -513)])),
            with_dc(1500, ac_only([(31, 5), (32, -6), (33, 7)])),
            with_dc(1500, ac_only([(32, 1)])), with_dc(1500, ac_only([(31, -2), (33, 900)])),
            with_dc(0, ac_only([(1, 3)])), with_dc(700, np.zeros(64, np.int32)),
            with_dc(0, np.zeros(64, np.int32))]
    for target in LANE_TARGET_BITS:
        # The DC deltas of these blocks are 0 (the chain's DC stays 0), a
        # 2-bit DC; then n coefficients of 3 bits, r of them +-2 (4 bits),
        # and a 4-bit EOB.
        n, r = divmod(target - 2 - 4, 3)
        b = np.zeros(64, np.int32)
        b[1:n + 1] = np.where(np.arange(n) % 2 == 0, 1, -1)
        b[n + 1 - r:n + 1] *= 2
        luma.append(b)
    assert (int(lengths[0]), int(lengths[24 + 1]), int(lengths[24 + 2]),
            int(lengths[24])) == (2, 2, 2, 4)
    # (Cb, Cr) of the first MCUs: DC deltas 0 / 2047, -2047 / -2047,
    # 2047 / 1023, then 5 / -1018 with an AC at 1 and at 63.
    chroma = [with_dc(dc, np.zeros(64, np.int32)) for dc in (0, 2047, -2047, 0, 0, 1023)]
    chroma += [with_dc(5, ac_only([(1, -1)])), with_dc(5, ac_only([(63, 600)]))]
    true_mcus = mcu_r * mcu_c
    luma += [np.zeros(64, np.int32)] * (4 * true_mcus - len(luma))
    chroma += [np.zeros(64, np.int32)] * (2 * true_mcus - len(chroma))
    rows = 4
    blocks = np.zeros((rows * grid_c * 6, 64), np.int32)
    filler = np.where(np.arange(64) % 2 == 0, 1023, -1023)
    m = 0
    for mcu in range(rows * grid_c):
        r, c = divmod(mcu, grid_c)
        if r >= mcu_r or c >= mcu_c:
            blocks[6 * mcu:6 * mcu + 6] = filler
            continue
        blocks[6 * mcu:6 * mcu + 4] = luma[4 * m:4 * m + 4]
        blocks[6 * mcu + 4] = chroma[2 * m]
        blocks[6 * mcu + 5] = chroma[2 * m + 1]
        m += 1
    return blocks.astype(np.int16), (grid_c, mcu_r, mcu_c)


def jpeg_pack_extremes():
    """Hand-fed (words int32 [N, 52], bits int32 [N]) for the pack kernel,
    as the Huffman kernel leaves them (each block's bit string MSB-first in
    its first ceil(bits / 32) words, zero after its last bit; the slot's
    words after those hold seeded garbage, which the pack must ignore):
    long runs of 0-bit blocks; runs of 1-6-bit blocks, so that 6-30 blocks
    share one scan word; full 1664-bit blocks (all 52 words), back to back
    and after 1-31-bit blocks, so that they land at every shift; blocks of
    32k - 1, 32k and 32k + 1 bits. Returns [(what, words, bits)]: the
    whole sequence with a total of an exact multiple of 32 bits, and the
    same less its last block (a total that is not)."""
    from rawphotoforge_tpu_torch.io import jpegbits

    rng = np.random.default_rng(SEED + 19)
    full = 32 * jpegbits.BLOCK_WORDS
    lengths = [0] * 300
    lengths += [int(v) for v in rng.integers(1, 7, 400)]
    lengths += [0] * 50 + [full] * 4
    for k in range(1, 32):
        lengths += [k, full]
    lengths += [32 * k + e for k in (1, 2, 26, 51) for e in (-1, 0, 1)]
    lengths += [int(v) for v in rng.integers(1, 7, 64)] + [0] * 70 + [3] * 40
    tail = (-sum(lengths)) % 32
    if tail == 0:
        lengths.append(16)
        tail = 16
    lengths.append(tail)
    bits = np.asarray(lengths, np.int64)
    n = bits.size
    words = rng.integers(0, 1 << 32, (n, jpegbits.BLOCK_WORDS), dtype=np.uint64)
    nw = (bits + 31) >> 5
    j = np.arange(jpegbits.BLOCK_WORDS)[None, :]
    # The block's last word keeps its high (bits - 32 (nw - 1)) bits.
    keep = np.where(j < nw[:, None] - 1, 32,
                    np.where(j == nw[:, None] - 1, bits[:, None] - 32 * (nw[:, None] - 1), 0))
    coded = (words >> (32 - keep).astype(np.uint64)) << (32 - keep).astype(np.uint64)
    coded = np.where(keep == 0, 0, coded)
    words = np.where(j < nw[:, None], coded, words).astype(np.uint32).view(np.int32)
    assert int(bits.sum()) % 32 == 0 and bits[:-1].sum() % 32 != 0
    return [("pack extremes, total a multiple of 32", words, bits.astype(np.int32)),
            ("pack extremes less the last block", words[:-1].copy(),
             bits[:-1].astype(np.int32))]


def scan_oracle(words, bits):
    """The scan as one Python integer: each block's bit string appended,
    MSB-first (an oracle independent of the twins' shift arithmetic).
    Returns the scan's ceil(total / 32) words, u32 in int64."""
    acc, total = 0, 0
    for row, nb in zip(words.view(np.uint32), bits.tolist()):
        if nb == 0:
            continue
        nw = -(-nb // 32)
        v = 0
        for word in row[:nw].tolist():
            v = (v << 32) | word
        acc = (acc << nb) | (v >> (32 * nw - nb))
        total += nb
    nwords = -(-total // 32)
    acc <<= 32 * nwords - total
    return np.asarray([(acc >> (32 * (nwords - 1 - i))) & 0xFFFFFFFF
                       for i in range(nwords)], np.int64)


def jpeg_scene(rng, h, w, dev):
    """A seeded smooth scene with texture, as the batch renders look."""
    import torch

    yy = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None]
    xx = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :]
    planes = np.stack([0.2 + 0.6 * yy * np.ones_like(xx), 0.1 + 0.7 * xx * np.ones_like(yy),
                       0.4 + 0.3 * np.sin(9.0 * (xx + yy))])
    planes += 0.12 * rng.random((3, h, w), dtype=np.float32)
    return torch.from_numpy(planes).to(dev)


def _entropy_vs_twins(blocks, grid_c, mcu_r, mcu_c, what):
    """The Huffman and pack kernels against their twins on ``blocks``
    (a CUDA int16 tensor): bit for bit. Returns (words, bits, bad) of the
    kernel."""
    import torch

    from rawphotoforge_tpu_torch.io import jpegbits, jpegenc
    from rawphotoforge_tpu_torch.kernels import jpeg_wire as jw

    words, bits, bad = jw.huffman(blocks, grid_c, mcu_r, mcu_c)
    torch.cuda.synchronize()
    mask = jpegbits._true_mask(blocks.shape[0], grid_c, mcu_r, mcu_c, blocks.device)
    rbits, rwords, _, rbad = jpegbits.prepack(
        jpegbits._dc_delta_masked(blocks, mask), mask)
    bit_identical(words, jpegenc._i32_bits(rwords), f"{what}: Huffman kernel words")
    bit_identical(bits, rbits.to(torch.int32), f"{what}: Huffman kernel bit lengths")
    check(int(bad) == int(rbad), f"{what}: out-of-domain {int(bad)} vs twin {int(rbad)}")
    _pack_vs_twins(words, bits, what)
    return words, bits, bad


def _pack_vs_twins(words, bits, what):
    """The pack kernel against its twins on CUDA (words, bits), packed and
    prepacked: bit for bit."""
    import torch

    from rawphotoforge_tpu_torch.io import jpegbits, jpegenc
    from rawphotoforge_tpu_torch.kernels import jpeg_wire as jw

    w64, b64 = words.to(torch.int64) & 0xFFFFFFFF, bits.to(torch.int64)
    for packed, twin in ((True, jpegbits.scan_from_words), (False, jpegbits.concat_words)):
        out = jw.pack(words, bits, packed=packed)
        torch.cuda.synchronize()
        bit_identical(out, jpegenc._i32_bits(twin(w64, b64)),
                      f"{what}: pack kernel ({'packed' if packed else 'prepacked'})")


def phase_jpeg_kernels(dev, card, log):
    """Phase 9: the three JPEG kernels against their twins, bit for bit:
    hand-fed worst-case blocks through the Huffman and pack kernels (the
    scan also against the serial oracle packed_np); every JPEG_SHAPES frame
    through all three (the blocks also against the CPU twin at the small
    shapes); the packed, prepacked and nibble wires' files byte-identical,
    each decoding at its true size; then CUDA-event times of each kernel and
    of the device wire at 24 MP beside the byte bounds and the twins'
    times. Returns {kernel: row of the kernel line}."""
    import io as _io

    import torch
    from PIL import Image

    from rawphotoforge_tpu_torch.io import jpegbits, jpegenc
    from rawphotoforge_tpu_torch.kernels import jpeg_wire as jw

    good, oob = jpeg_edge_blocks()
    longest = 0
    for grid in ((3, 2, 3), (3, 2, 2), (3, 1, 3)):
        blocks = torch.from_numpy(good).to(dev)
        words, bits, bad = _entropy_vs_twins(blocks, *grid, f"edge blocks {grid}")
        longest = max(longest, int(bits.max()))
        check(int(bad) == 0 and longest <= 32 * jpegbits.BLOCK_WORDS,
              f"edge blocks {grid}: bad {int(bad)}, longest {longest} bits")
        mask = jpegbits._true_mask(36, *grid)
        ref_words, ref_bits = jpegbits.packed_np(
            jpegbits._dc_delta_masked(torch.from_numpy(good), mask).numpy(), mask.numpy())
        scan = jw.pack(words, bits, packed=True)
        check(np.array_equal(jpegbits.fetch_scan(scan, ref_words.size), ref_words)
              and int(bits.sum()) == ref_bits, f"edge blocks {grid}: scan vs packed_np")
    _, _, bad = _entropy_vs_twins(torch.from_numpy(oob).to(dev), 3, 2, 3,
                                  "out-of-domain blocks")
    check(int(bad) > 0, "the out-of-domain blocks were not flagged")
    extremes, (grid_c, mcu_r, mcu_c) = jpeg_lane_extremes()
    n_ext = extremes.shape[0]
    for grid in ((grid_c, mcu_r, mcu_c), (grid_c, n_ext // 6 // grid_c, grid_c)):
        blocks = torch.from_numpy(extremes).to(dev)
        words, bits, bad = _entropy_vs_twins(blocks, *grid, f"lane extremes {grid}")
        mask = jpegbits._true_mask(n_ext, *grid)
        ref_words, ref_bits = jpegbits.packed_np(
            jpegbits._dc_delta_masked(torch.from_numpy(extremes), mask).numpy(),
            mask.numpy())
        scan = jw.pack(words, bits, packed=True)
        check(int(bad) == 0 and (grid[1] != mcu_r
                                 or set(LANE_TARGET_BITS) <= set(bits.tolist()))
              and np.array_equal(jpegbits.fetch_scan(scan, ref_words.size), ref_words)
              and int(bits.sum()) == ref_bits, f"lane extremes {grid}: scan vs packed_np")
    for what, words_np, bits_np in jpeg_pack_extremes():
        words = torch.from_numpy(words_np).to(dev)
        bits = torch.from_numpy(bits_np).to(dev)
        _pack_vs_twins(words, bits, what)
        scan = jw.pack(words, bits, packed=True)
        ref = scan_oracle(words_np, bits_np)
        check(np.array_equal(jpegbits.fetch_scan(scan, ref.size).astype(np.int64)
                             & 0xFFFFFFFF, ref), f"{what}: scan vs the serial oracle")
    log(f"phase 9: pack extremes ({bits_np.size + 1} and {bits_np.size} hand-fed "
        f"blocks: runs of 0-bit blocks, of 1-6-bit blocks, 1664-bit blocks at "
        f"every shift, 32k-1/32k/32k+1 bits, garbage past each block's words, a "
        f"total of a multiple of 32 bits and not): pack kernel == twins bit for "
        f"bit, packed and prepacked; scans == the serial oracle")
    log(f"phase 9: hand-fed blocks (+-1023 ACs: {longest}-bit blocks of "
        f"the {32 * jpegbits.BLOCK_WORDS}-bit bound, +-2047 DC deltas, ZRL chains, "
        f"no-EOB, padding grids 3x2/2 and 3x1; lane extremes: 59-bit lanes over "
        f"2 and 3 words, the 31/32/33 seam, blocks of 32k-1/32k/32k+1 bits for "
        f"k <= 6, DC-only, padding MCUs between true ones): Huffman and pack "
        f"kernels == twins bit for bit, scans == packed_np; out-of-domain lanes "
        f"== twin's")

    rng = np.random.default_rng(SEED + 9)
    qlum, qchr = jpegenc._quant_tables(JPEG_QUALITY)
    for h, w, true_hw in JPEG_SHAPES:
        th, tw = true_hw or (h, w)
        planes = jpeg_scene(rng, h, w, dev)
        blocks = jw.blocks(planes, qlum, qchr, (th, tw))
        torch.cuda.synchronize()
        bit_identical(blocks, jpegenc.blockify(planes, qlum, qchr, (th, tw)),
                      f"{h}x{w} blocks kernel vs twin")
        if h * w < 1 << 20:
            bit_identical(blocks.cpu(), jpegenc.blockify(planes.cpu(), qlum, qchr,
                                                         (th, tw)),
                          f"{h}x{w} blocks kernel vs the CPU twin")
        grid = (-(-w // 16), -(-th // 16), -(-tw // 16))
        _, bits, _ = _entropy_vs_twins(blocks, *grid, f"{h}x{w}")
        # The wires take a padded render only MCU-aligned: an unaligned
        # frame's files are of its true extent.
        src, shape = planes, true_hw
        if true_hw and (h % 16 or w % 16):
            src, shape = planes[:, :th, :tw].contiguous(), None
        files = [enc(src, JPEG_QUALITY, true_shape=shape) for enc in (
            jpegbits.encode_packed_device, jpegbits.encode_prepacked_device,
            jpegenc._encode_sparse_device)]
        check(files[0] == files[1] == files[2],
              f"{h}x{w}: the wires' files differ ({[len(f) for f in files]} bytes)")
        with Image.open(_io.BytesIO(files[0])) as im:
            im.load()
            check(im.size == (tw, th), f"{h}x{w}: the file decodes at {im.size}")
        log(f"phase 9: {w}x{h}" + (f" (true {tw}x{th})" if true_hw else "")
            + f": blocks, Huffman and pack kernels == twins bit for bit"
            + (" (blocks also == the CPU twin)" if h * w < 1 << 20 else "")
            + f"; packed == prepacked == nibble file, {len(files[0])} bytes "
            f"({int(bits.to(torch.int64).sum()) / 8 / (th * tw):.3f} B/px of scan), "
            f"decodes at {tw}x{th}")
        del planes, blocks, bits, files, src
        torch.cuda.empty_cache()

    # Times at 24 MP, the batch's Bayer frame.
    h, w = BAYER_HW
    case = jpeg_time_case(dev, rng, h, w)
    rows = {}
    for name in ("jpeg_blocks_kernel", "jpeg_huffman_kernel", "jpeg_pack_kernel"):
        kernel, twin, nbytes, iface_bytes, ops = case[name]
        ms = time_events(kernel, reps=20)
        plain = time_events(twin, reps=2, warm=1)
        t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_F32_S * 1e3
        bound = max(t_bytes, t_ops)
        by = "bytes" if t_bytes >= t_ops else "operations"
        rows[name] = dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by)
        iface = ""
        if iface_bytes != nbytes:
            t_iface = max(iface_bytes / PEAK_BYTES_S * 1e3, t_ops)
            iface = (f"; interface bound {t_iface:.4f} ms (the 52-word slots as laid "
                     f"out: {iface_bytes / 1e6:.1f} MB), {100 * t_iface / ms:.1f}% of it")
        log(f"phase 9: {name} {w}x{h} q{JPEG_QUALITY}: {ms:.4f} ms; bound "
            f"{bound:.4f} ms by {by} (bytes {nbytes / 1e6:.1f} MB -> {t_bytes:.4f} "
            f"ms at 3.35 TB/s; ops {ops / 1e9:.3f} G -> {t_ops:.4f} ms); "
            f"{100 * bound / ms:.1f}% of roofline{iface}; plain twin {plain:.2f} ms "
            f"(no yardstick); library_ms none [{card}]")
    wire_ms = time_events(case["packed_wire"], reps=10)
    log(f"phase 9: the packed device wire (blocks + Huffman + cumsum + pack) "
        f"{w}x{h}: {wire_ms:.4f} ms; its scan {4 * case['scan_words'] / 1e6:.3f} MB "
        f"({4 * case['scan_words'] / (h * w):.3f} B/px; the dense wire fetched 1.5 B/px) "
        f"[{card}]")
    return rows


def jpeg_time_case(dev, rng, h, w):
    """The JPEG kernels' timed calls on a seeded h x w jpeg_scene at
    JPEG_QUALITY, through the jpeg_wire API (a copy of this script in
    another checkout times that checkout's kernels):
    {kernel: (call, twin call, bytes the function must move, bytes of the
    interface's 52-word slots, operations)}, "packed_wire" (blocks + Huffman
    + cumsum + pack) and "scan_words". The blocks kernel ~35 operations a
    coefficient (two 8-term sums, the division, the rounding) and ~20 a
    pixel (colour conversion, chroma mean); the Huffman lanes ~4 a
    coefficient; the pack ~8 a word. This run's bit strings set the
    data-dependent bytes: the Huffman kernel must write the coded words
    (its interface writes every slot whole, 4 * 52 bytes a block); the pack
    call must read them (its interface holds them in those slots) and the
    bit lengths, and write its whole output, the scan and its zero tail
    (int32 [N * 52 + 1], which wire_packed_extent's contract holds).
    "pack_inputs": the Huffman kernel's (words, bits)."""
    import torch

    from rawphotoforge_tpu_torch.io import jpegbits, jpegenc
    from rawphotoforge_tpu_torch.kernels import jpeg_wire as jw

    qlum, qchr = jpegenc._quant_tables(JPEG_QUALITY)
    planes = jpeg_scene(rng, h, w, dev)
    blocks = jw.blocks(planes, qlum, qchr)
    n = blocks.shape[0]
    grid = (-(-w // 16), -(-h // 16), -(-w // 16))
    words, bits, _ = jw.huffman(blocks, *grid)
    mask = jpegbits._true_mask(n, *grid, dev)
    bits64 = bits.to(torch.int64)
    nwords = int(((bits64 + 31) >> 5).sum())
    total_words = (int(bits64.sum()) + 31) // 32
    w64 = words.to(torch.int64) & 0xFFFFFFFF
    slots = 4 * jpegbits.BLOCK_WORDS * n
    return {
        "jpeg_blocks_kernel": (
            lambda: jw.blocks(planes, qlum, qchr),
            lambda: jpegenc.blockify(planes, qlum, qchr),
            12 * h * w + 2 * 64 * n, 12 * h * w + 2 * 64 * n, 64 * n * 35 + 20 * h * w),
        "jpeg_huffman_kernel": (
            lambda: jw.huffman(blocks, *grid),
            lambda: jpegbits.prepack(jpegbits._dc_delta_masked(blocks, mask), mask),
            2 * 64 * n + 4 * nwords + 4 * n, 2 * 64 * n + slots + 4 * n, 64 * n * 4),
        "jpeg_pack_kernel": (
            lambda: jw.pack(words, bits, packed=True),
            lambda: jpegbits.scan_from_words(w64, bits64),
            4 * nwords + 4 * n + 4 * (n * jpegbits.BLOCK_WORDS + 1),
            slots + 4 * n + 4 * (n * jpegbits.BLOCK_WORDS + 1), 8 * nwords),
        "packed_wire": lambda: jpegbits.wire_packed_extent(planes, qlum, qchr, h, w),
        "scan_words": total_words,
        "pack_inputs": (words, bits),
    }


# -- vendor containers, the decode gate, lens correction ------------------------

# Phase 8's files: (name, kind, what the batch runs for it).
VENDOR_FILES = (
    ("canon24.cr2", "CR2 6000x4000 active, odd borders (BGGR), lens EF 50mm",
     "bayer_kernel"),
    ("sony24.arw", "ARW2 6016x4000, matching preview (gate passes)",
     "bayer_kernel"),
    ("sony24_bad.arw", "ARW2 6016x4000, mismatched preview (gate refuses)",
     "preview"),
    ("fuji26.raf", "RAF X-Trans 6240x4160", "xtrans_kernel"),
    ("pana20.rw2", "RW2 plain 16-bit 5184x3888, sensor borders", "bayer_kernel"),
    ("pana_raw4.rw2", "RW2 RAW4 448x320, matching preview", "bayer_kernel"),
    ("warp24.dng", "DNG 6000x4000, WarpRectilinear + FixVignetteRadial",
     "develop"),
)
ARW2_HW = (4000, 6016)   # a 24 MP Sony sensor (width a multiple of 32)
RW2_HW = (3888, 5184)    # a 20 MP Panasonic sensor's active area
RAW4_HW = (320, 448)
VENDOR_WARP = ([[0.97, 0.04, -0.01, 0.0, 0.001, -0.001]], (0.5, 0.5))
VENDOR_VIGNETTE = ((0.2, -0.05, 0.0, 0.0, 0.0), (0.5, 0.5))
BAD_PREVIEW_HW = (1000, 1504)


def write_vendor_dir(in_dir, log):
    """Phase 8's input, written with the port's writers (tests/
    torch_fixtures.py): full-size vendor RAWs of seeded scenes; the RAW4
    file is small (its fixture encoder is a Python loop). Returns
    {name: (path, upright (h, w) of its JPEG)}."""
    import dataclasses

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_fixtures as fx

    from rawphotoforge_tpu_torch.io import dng, raw as rawio

    rng = np.random.default_rng(SEED + 8)
    files = {}

    def put(name, data, upright, t0):
        path = os.path.join(in_dir, name)
        with open(path, "wb") as f:
            f.write(data)
        files[name] = (path, upright)
        log(f"phase 8: wrote {name}: {len(data)} bytes in "
            f"{time.perf_counter() - t0:.2f} s")

    h, w = BAYER_HW
    t0 = time.perf_counter()
    border = (73, 51, 73 + w - 1, 51 + h - 1)  # left, top, right, bottom
    sensor = fx.cr2_sensor(rng, h + 56, w + 96, border)
    slice_w = (w + 96) // 4 // 2 * 2  # three slices of this, then the rest
    put("canon24.cr2", fx.build_cr2(
        sensor, slices=(3, slice_w, w + 96 - 3 * slice_w), sensor_border=border,
        lens_model="EF 50mm f/1.8 II", fnumber=2.8), (h, w), t0)

    t0 = time.perf_counter()
    codes = fx.arw2_codes(rng, *ARW2_HW)
    good, _ = fx.arw2_file(codes, preview="match")
    put("sony24.arw", good, ARW2_HW, t0)
    t0 = time.perf_counter()
    bad, _ = fx.arw2_file(codes, preview=fx.noise_preview(SEED, *BAD_PREVIEW_HW))
    put("sony24_bad.arw", bad, BAD_PREVIEW_HW, t0)
    del codes, good, bad

    t0 = time.perf_counter()
    xh, xw = XTRANS_HW
    xt = rawio.synthetic_raw(fx.scene(rng, xh, xw), "XTRANS", black_level=0,
                             wb_gains=(1.7, 1.0, 1.3))
    put("fuji26.raf", fx.raf_file(xt.mosaic, "XTRANS"), (xh, xw), t0)
    del xt

    t0 = time.perf_counter()
    ph, pw = RW2_HW
    pana = rawio.synthetic_raw(fx.scene(rng, ph + 8, pw + 16), "GRBG",
                               black_level=157, white_level=4095,
                               wb_gains=(1.8, 1.0, 1.4))
    put("pana20.rw2", fx.rw2_file(pana.mosaic, "GRBG",
                                  borders=(4, 8, ph + 4, pw + 8)), (ph, pw), t0)
    del pana

    t0 = time.perf_counter()
    # A smooth scene: RAW4's fixture encoder needs same-colour neighbours
    # within 127 levels of each other.
    raw4 = rawio.synthetic_raw(fx.scene(rng, *RAW4_HW, texture=0.01), "RGGB",
                               black_level=157, white_level=4095,
                               wb_gains=(1.8, 1.0, 1.4))
    put("pana_raw4.rw2", fx.rw2_file(raw4.mosaic, "RGGB", raw_format=4,
                                     preview=fx.matching_preview(raw4, 256)),
        RAW4_HW, t0)

    t0 = time.perf_counter()
    warp = rawio.synthetic_raw(fx.scene(rng, h, w), "RGGB", xyz_to_cam=XYZ_TO_CAM)
    warp = dataclasses.replace(warp, exif={"Make": "Synthetic", "Model": "phone"})
    put("warp24.dng", dng.write_dng(warp, opcode_list_3=fx.opcode_list3(
        warp=VENDOR_WARP, vignette=VENDOR_VIGNETTE)), (h, w), t0)
    return files


def phase_vendor_main_path(dev, log):
    """Phase 8: `cli batch` of the vendor directory and the lens-corrected
    editor open on the card, with every launch counter zeroed just before
    and read just after; then each kernel against its twin on every
    vendor-decoded mosaic, the JPEG sizes, the gate-refused ARW2 opening
    from its preview, the warp on the card against the CPU, and the
    lens-corrected FULL render against the exact-LUT anchor."""
    import dataclasses

    import torch
    from PIL import Image

    from rawphotoforge_tpu_torch.app import cli
    from rawphotoforge_tpu_torch.core.params import EditParameters, pack_params
    from rawphotoforge_tpu_torch.engine.editor import FULL, PhotoEditor
    from rawphotoforge_tpu_torch.io import raw as rawio
    from rawphotoforge_tpu_torch.kernels import fused, jpeg_wire, raw_pipeline as rp
    from rawphotoforge_tpu_torch.ops import demosaic as dm
    from rawphotoforge_tpu_torch.ops.lenscorr import warp_rectilinear

    tmp = tempfile.mkdtemp(prefix="chip_smoke_vendor_")
    in_dir, out_dir = os.path.join(tmp, "in"), os.path.join(tmp, "out")
    os.makedirs(in_dir)
    files = write_vendor_dir(in_dir, log)
    cr2_path = files["canon24.cr2"][0]
    # The editor's edit: bench_edit's curves (no identity_oklch shortcut,
    # so the kernel render and the exact-LUT anchor compute the same stack).
    lens_edit = EditParameters()
    bench_edit(lens_edit)

    twin_calls = [0]
    real_twins = (rp.raw_develop_fused_ref, fused.develop_post_geo_fused_ref)

    def counted(fn):
        def twin(*a, **k):
            twin_calls[0] += 1
            return fn(*a, **k)
        return twin

    rp.raw_develop_fused_ref = counted(real_twins[0])
    fused.develop_post_geo_fused_ref = counted(real_twins[1])
    rp.KERNEL_LAUNCHES = dict.fromkeys(rp.KERNEL_LAUNCHES, 0)  # run starts
    jpeg_wire.KERNEL_LAUNCHES = dict.fromkeys(jpeg_wire.KERNEL_LAUNCHES, 0)
    fused.LAUNCHES = 0
    t0 = time.perf_counter()
    try:
        rc, out = run_batch(in_dir, out_dir, dev)
        ed = PhotoEditor.open(cr2_path, lens_correct=True, device=dev)
        ed.load_preset_json(json.dumps({"version": 1, "crop": None, "masks": [
            {"name": "main", "params": lens_edit.to_json()}]}))
        lens_full = ed.apply(FULL)
        torch.cuda.synchronize()
    finally:
        rp.raw_develop_fused_ref, fused.develop_post_geo_fused_ref = real_twins
    counts = dict(rp.KERNEL_LAUNCHES, develop=fused.LAUNCHES,
                  **jpeg_wire.KERNEL_LAUNCHES)  # run ends here
    t_main = time.perf_counter() - t0
    check(rc == 0, f"cli batch of the vendor files exited {rc}")
    want = {"bayer_kernel": 0, "xtrans_kernel": 0, "develop": 1,
            **dict.fromkeys(jpeg_wire.KERNEL_LAUNCHES, len(VENDOR_FILES))}
    for _, _, route in VENDOR_FILES:
        want["develop" if route == "preview" else route] += 1
    check(counts == want, f"vendor path launches {counts} (want {want})")
    check(twin_calls[0] == 0, f"a twin ran {twin_calls[0]} times on the "
          "vendor path")
    log(f"phase 8: vendor path (cli batch of {len(files)} files + the "
        f"lens-corrected editor open and FULL render of canon24.cr2) in "
        f"{t_main:.2f} s; launches {counts}, twin calls {twin_calls[0]}")
    rate = [ln for ln in out.splitlines() if "MPix/s end-to-end" in ln]
    check(rate, "cli batch printed no throughput line")
    log(f"phase 8: {rate[0].strip()}")

    # The mismatched ARW2: refused by the gate, developed from its preview
    # by the batch and opened from it by the editor, loudly.
    bad_line = [ln for ln in out.splitlines() if "sony24_bad.arw" in ln]
    check(bad_line and "embedded preview" in bad_line[0]
          and "correlation gate" in bad_line[0],
          f"the mismatched ARW2's batch line: {bad_line}")
    bad_ed = PhotoEditor.open(files["sony24_bad.arw"][0], device=dev)
    check(bad_ed.opened_from_preview is not None
          and "correlation gate" in bad_ed.opened_from_preview,
          f"editor opened sony24_bad.arw with {bad_ed.opened_from_preview!r}")
    check(bad_ed.shape == BAD_PREVIEW_HW, f"preview session {bad_ed.shape}")
    log(f"phase 8: sony24_bad.arw refused by the gate and opened from its "
        f"{BAD_PREVIEW_HW[1]}x{BAD_PREVIEW_HW[0]} preview (batch and editor): "
        f"{bad_ed.opened_from_preview}")
    del bad_ed

    # Every JPEG decodes at its upright size.
    for name, (path, (h, w)) in files.items():
        jpg = os.path.join(out_dir, os.path.splitext(name)[0] + ".jpg")
        with Image.open(jpg) as im:
            check(im.size == (w, h), f"{jpg}: {im.size}, want {(w, h)}")
    log(f"phase 8: all {len(files)} JPEGs decode at their upright sizes")

    # Each kernel against its twin on every vendor-decoded mosaic, with the
    # batch's edit and flags (these launches are outside the counted run).
    flags = _parse_flags(RAW_FLAGS)
    edit = cli._params_from_args(flags)
    worst = {"bayer_kernel": 0.0, "xtrans_kernel": 0.0}
    for name, kind, route in VENDOR_FILES:
        if route not in worst:
            continue
        with open(files[name][0], "rb") as f:
            raw = rawio.with_effective_wb(rawio.parse_raw(f.read()))
        h, w = raw.mosaic.shape
        mos01 = rawio.normalized_mosaic(raw, raw.mosaic, dev)
        args = (mos01, raw.wb_gains, rawio.cam2srgb_for(raw),
                pack_params([edit], extent=(h, w), build_luts=False, device=dev),
                np.float32(edit.sharpness / 100.0 * 2.0))
        kw = dict(pattern=raw.pattern, identity_oklch=True)
        out_k = rp.raw_develop_fused(*args, **kw)
        torch.cuda.synchronize()
        ref = rp.raw_develop_fused_ref(*args, **kw)
        worst[route] = max(worst[route], float((out_k - ref).abs().max().item()))
        bit_identical(out_k, ref, f"{name} {route} vs twin")
        log(f"phase 8: {name} ({kind}): {raw.pattern} {w}x{h}, {route} == twin "
            f"bit for bit")
        del mos01, args, out_k, ref
    torch.cuda.empty_cache()

    # The warped DNG's generic route: the warp on the card against the CPU
    # on the same demosaiced planes, and the develop kernel against its
    # twin on the warped planes.
    with open(files["warp24.dng"][0], "rb") as f:
        wraw = rawio.with_effective_wb(rawio.parse_raw(f.read()))
    check(wraw.warp_rectilinear is not None and wraw.vignette_radial is not None,
          "warp24.dng lost its OpcodeList3")
    planes = dm.develop_raw(rawio.normalized_mosaic(wraw, wraw.mosaic, dev),
                            wraw.wb_gains, rawio.cam2srgb_for(wraw),
                            pattern=wraw.pattern)
    warped = warp_rectilinear(planes, *wraw.warp_rectilinear)
    warped_cpu = warp_rectilinear(planes.cpu(), *wraw.warp_rectilinear)
    werr = compare(warped.cpu(), warped_cpu, what="warp card vs CPU")
    h, w = wraw.mosaic.shape
    packed = pack_params([edit], extent=(h, w), build_luts=False, device=dev)
    kw = dict(identity_oklch=True)
    out_k = fused.develop_post_geo_fused(warped, packed, None, **kw)
    torch.cuda.synchronize()
    bit_identical(out_k, fused.develop_post_geo_fused_ref(warped, packed, None, **kw),
                  "warp24.dng develop kernel vs twin")
    log(f"phase 8: warp24.dng: WarpRectilinear on the card vs the CPU on the "
        f"same planes: max abs err {werr:.3e} (assert_close); the develop "
        f"kernel on the warped planes == twin bit for bit")
    del planes, warped, warped_cpu, out_k

    # The lens-corrected editor: the profile applied, and its FULL kernel
    # render against the exact-LUT anchor.
    check(ed.applied_lens_profile is not None
          and "50mm" in ed.applied_lens_profile,
          f"lens profile {ed.applied_lens_profile!r}")
    plain = PhotoEditor.open(cr2_path, device=dev)
    moved = float((ed._original_at(FULL) - plain._original_at(FULL)).abs().max())
    check(moved > 1e-3, f"lens correction moved the original by {moved:.3e}")
    del plain
    ed.use_kernel = False
    lens_err = compare(lens_full, ed.apply(FULL),
                       what="lens-corrected FULL kernel vs exact-LUT anchor")
    log(f"phase 8: canon24.cr2 with lens_correct=True: profile "
        f"{ed.applied_lens_profile!r} (approximate {ed.applied_lens_approximate}),"
        f" original moved by up to {moved:.3e}; FULL kernel render vs exact-LUT "
        f"anchor: max abs err {lens_err:.3e} (assert_close)")
    del ed, lens_full
    torch.cuda.empty_cache()
    return counts, worst, files, tmp


def staged_vendor_files(files, tmp, dev, card, log):
    """`cli batch` of each vendor file alone, with the function of each
    stage wrapped (StageClock): per-file host ms of the parse + decode and
    of the decode gate, the upload, the kernels, the JPEG device wire, the
    scan fetch (and its bytes) and the JPEG assembly."""
    import torch

    from rawphotoforge_tpu_torch.io import raw as rawio
    from rawphotoforge_tpu_torch.kernels import fused, raw_pipeline as rp
    from rawphotoforge_tpu_torch.ops import demosaic as dm, lenscorr

    stages = ((rawio, "parse_raw", "parse+decode", None),
              (rawio, "verify_memory_derived_decode", "gate", None),
              (rawio, "decode_embedded_preview", "preview decode", None),
              (rawio, "normalized_mosaic", "upload+normalize", None),
              (rp, "raw_develop_fused", "RAW kernel", None),
              (dm, "develop_raw", "demosaic", None),
              (lenscorr, "warp_rectilinear", "warp", None),
              (fused, "develop_post_geo_fused", "develop kernel", None),
              *jpeg_stages())
    for name, (path, _) in files.items():
        one = os.path.join(tmp, "one_" + name.replace(".", "_"))
        os.makedirs(one)
        os.symlink(path, os.path.join(one, name))
        with StageClock(stages) as clock:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rc, _ = run_batch(one, one + "_out", dev)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        check(rc == 0, f"cli batch of {name} alone exited {rc}")
        # parse_raw runs the gate inside it; the parse + decode is the rest.
        clock.ms["parse+decode"] = clock.ms.get("parse+decode", 0.0) - clock.ms.get(
            "gate", 0.0)
        log(f"phase 8: {name} alone, ms: " + clock.line() + f", rest "
            f"{wall - sum(clock.ms.values()):.2f}; wall {wall:.2f} [{card}]")
    device_busy(lambda: run_batch(os.path.join(tmp, "in"), os.path.join(tmp, "out2"),
                                  dev), log, "phase 8: vendor cli batch, warm", card)


# -- masks and exports (the regional-mask slice) -----------------------------

# Phase 10's sweep shapes: small, odd, square, one row, one column, a width
# one past the MID width (not a multiple of the kernel's 32-chain tile),
# chains longer than the kernel's ring of five 32-cell chunks (4000 rows,
# 6000 columns: the walk back re-reads chunks the ring no longer holds);
# then the MID level of a 6000x4000 photo (the editor floods at MID).
GEODESIC_HW = ((37, 50), (61, 97), (128, 128), (1, 300), (300, 1), (853, 1281),
               (4000, 96), (96, 6000))
MID_HW = (853, 1280)
FLOOD_SWEEPS = 4   # the editor's rounds: one launch a flood
# Shapes whose floods also run at other round counts, and those counts.
GEODESIC_ROUNDS_HW = ((61, 97), (4000, 96), (96, 6000))
GEODESIC_ROUNDS = (1, 12)
# Where a flood gets a NaN pixel.
GEODESIC_NAN_HW = ((61, 97), (4000, 96))


def same_bits(a, b, what):
    """Bit for bit, with a NaN wherever the twin has one (torch's NaN
    payloads differ from kernel to kernel)."""
    import torch

    nan = torch.isnan(b)
    check(torch.equal(torch.isnan(a), nan), f"{what}: NaN positions differ")
    keep = ~nan
    check(torch.equal(a[keep].view(torch.int32), b[keep].view(torch.int32)),
          f"{what}: not bit-identical (max diff "
          f"{(a[keep] - b[keep]).abs().max().item() if keep.any() else 0:.3e})")


def geodesic_costs(rng, h, w, dev, nan=False):
    """Step costs of a seeded textured frame, as the editor's flood makes
    them (ops/masking.step_costs, edge weight 12, spatial cost 0.002)."""
    import torch

    from rawphotoforge_tpu_torch.ops import masking

    planes = rng.random((3, h, w), dtype=np.float32) * 0.8 + 0.1
    if nan:
        planes[1, h // 2, w // 3] = np.nan
    return masking.step_costs(torch.from_numpy(planes).to(dev), 12.0, 0.002)


def twin_flood(d, gv, gh, sweeps=FLOOD_SWEEPS):
    from rawphotoforge_tpu_torch.kernels import geodesic

    for _ in range(sweeps):
        for direction in geodesic.DIRECTIONS:
            geodesic.sweep_ref(d, gv, gh, direction)
    return d


def library_flood(d, gv, gh, sweeps=FLOOD_SWEEPS):
    """The same relaxations in exact arithmetic as PyTorch scans: with S the
    cumulative cost along the sweep, a down sweep is cummin(d - S) + S and
    an up sweep its reverse (torch.cumsum + torch.cummin a sweep, plus the
    elementwise terms). Not bit-equal to the recurrence in f32 (the 1e9
    sentinels, cancellation): a yardstick of time only, never on the path."""
    import torch

    def scan(d, c, dim, backward):
        zero = torch.zeros_like(c.narrow(dim, 0, 1))
        s = torch.cat([zero, torch.cumsum(c, dim)], dim)
        if not backward:
            return torch.cummin(d - s, dim).values + s
        return torch.flip(torch.cummin(torch.flip(d + s, (dim,)), dim).values,
                          (dim,)) - s

    for _ in range(sweeps):
        d = scan(d, gv, 0, False)
        d = scan(d, gv, 0, True)
        d = scan(d, gh, 1, False)
        d = scan(d, gh, 1, True)
    return d


def sm_clock_mhz():
    """The card's maximum SM clock (nvidia-smi clocks.max.sm), MHz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return float(out.stdout.strip().splitlines()[0])


def geodesic_step_sass():
    """The flood kernel's instructions from cuobjdump -sass of the built
    library: the count of each opcode the walk's dependent step uses (FADD,
    FMNMX), whether the min is the NaN-propagating one, and whether the
    grid barrier's acquire invalidates L1 (CCTL). None without cuobjdump."""
    from rawphotoforge_tpu_torch.kernels import geodesic

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    out = subprocess.run([tool, "-sass", geodesic.BUILD["path"]], capture_output=True,
                         text=True, timeout=120)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr.strip()}")
    ops = []
    for ln in out.stdout.splitlines():
        if ln.strip().startswith("/*") and "*/" in ln:
            words = ln.split("*/", 1)[1].split("/*")[0].split()
            if words and words[0].startswith("@"):
                words = words[1:]
            if words:
                ops.append(" ".join(words))
    count = lambda op: sum(1 for o in ops if o.split(".")[0].split()[0] == op)
    return dict(FADD=count("FADD"), FMNMX=count("FMNMX"), CCTL=count("CCTL"),
                nan_min=any("FMNMX" in o and ".NAN" in o for o in ops),
                instructions=len(ops))


def phase_geodesic_kernel(dev, card, log):
    """Phase 10, part 1: the flood kernel against its twin, bit for bit,
    for every direction (one launch each) and for whole floods (corner
    seeds, a multi-seed set, a NaN pixel, 1 and 12 rounds; one launch
    each) at GEODESIC_HW and at MID; then CUDA-event times of the flood at
    MID and of its column and row sweeps alone, beside the byte bound (d,
    gv, gh read once, d written once) and the chain bound (the dependent
    add+min steps, their instructions read from the kernel's SASS, 4 cycles
    each), one chain's measured step, the twin's time and the PyTorch
    scans' time. Returns the kernel row."""
    import torch

    from rawphotoforge_tpu_torch.kernels import geodesic
    from rawphotoforge_tpu_torch.ops.masking import BIG

    rng = np.random.default_rng(SEED + 10)
    for h, w in (*GEODESIC_HW, MID_HW):
        gv, gh = geodesic_costs(rng, h, w, dev)
        d0 = torch.from_numpy(np.where(rng.random((h, w)) < 0.05, 0.0,
                                       rng.random((h, w)) * 40).astype(np.float32)).to(dev)
        for direction in geodesic.DIRECTIONS:
            ours, ref = d0.clone(), d0.clone()
            before = geodesic.KERNEL_LAUNCHES["geodesic_sweep_kernel"]
            geodesic.sweep(ours, gv, gh, direction)
            torch.cuda.synchronize()
            check(geodesic.KERNEL_LAUNCHES["geodesic_sweep_kernel"] == before + 1,
                  f"{h}x{w} {direction}: not one launch")
            geodesic.sweep_ref(ref, gv, gh, direction)
            same_bits(ours, ref, f"{h}x{w} {direction} sweep vs twin")
        seed_sets = [[(0, 0)], [(h - 1, w - 1)], [(0, w - 1), (h - 1, 0), (h // 2, w // 2)]]
        nan = (h, w) in GEODESIC_NAN_HW
        rounds = [FLOOD_SWEEPS] * 3 + (list(GEODESIC_ROUNDS)
                                       if (h, w) in GEODESIC_ROUNDS_HW else [])
        for k, n_rounds in enumerate(rounds):
            seeds = seed_sets[min(k, 2)]
            with_nan = nan and k == 2
            if with_nan:
                gv, gh = geodesic_costs(rng, h, w, dev, nan=True)
            start = torch.full((h, w), BIG, device=dev)
            for y, x in seeds:
                start[y, x] = 0.0
            before = geodesic.KERNEL_LAUNCHES["geodesic_sweep_kernel"]
            ours = geodesic.flood(start.clone(), gv, gh, n_rounds)
            torch.cuda.synchronize()
            check(geodesic.KERNEL_LAUNCHES["geodesic_sweep_kernel"] == before + 1,
                  f"{h}x{w} flood: not one launch")
            same_bits(ours, twin_flood(start.clone(), gv, gh, n_rounds),
                      f"{h}x{w} flood of {n_rounds} rounds from {seeds}"
                      + (" (NaN pixel)" if with_nan else ""))
            check(bool(torch.isnan(ours).any()) == (nan and k >= 2),
                  f"{h}x{w}: NaN propagation")
        log(f"phase 10: geodesic flood kernel {w}x{h}: down/up/right/left sweeps and "
            f"floods of {sorted(set(rounds))} rounds (one launch each) from corner, "
            f"opposite-corner and 3-seed sets == twin bit for bit"
            + (" (from the 3-seed flood on, a NaN pixel: NaN where the twin has NaN)"
               if nan else ""))

    # Times at MID.
    h, w = MID_HW
    gv, gh = geodesic_costs(rng, h, w, dev)
    d = torch.full((h, w), BIG, device=dev)
    d[h // 2, w // 2] = 0.0
    # The flood's work does not depend on the data (no early exit), so
    # repeated floods of one map time the same work.
    flood_ms = time_events(lambda: geodesic.flood(d, gv, gh), reps=10)
    col_ms = time_events(lambda: (geodesic.sweep(d, gv, gh, "down"),
                                  geodesic.sweep(d, gv, gh, "up")), reps=20) / 2
    row_ms = time_events(lambda: (geodesic.sweep(d, gv, gh, "right"),
                                  geodesic.sweep(d, gv, gh, "left")), reps=20) / 2
    plain = time_events(lambda: twin_flood(d.clone(), gv, gh), reps=1, warm=1)
    library = time_events(lambda: library_flood(d, gv, gh), reps=10)
    # One chain's step time on the card: a down sweep over one column of n
    # cells, at two lengths (the difference takes out the launch).
    steps_ns = {}
    for n in (1 << 14, 1 << 17):
        gcv = torch.rand((n - 1, 1), device=dev)
        one = torch.rand((n, 1), device=dev)
        steps_ns[n] = time_events(lambda: geodesic.sweep(
            one, gcv, torch.empty((n, 0), device=dev), "down"), reps=5) * 1e6
    step_ns = (steps_ns[1 << 17] - steps_ns[1 << 14]) / ((1 << 17) - (1 << 14))
    # A flood reads d, gv and gh once and writes d once; 2 operations (an
    # add and a min) a step.
    nbytes = 4 * (2 * h * w + (h - 1) * w + h * (w - 1))
    ops = 2 * FLOOD_SWEEPS * 2 * ((h - 1) * w + h * (w - 1))
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_F32_S * 1e3
    bound = max(t_bytes, t_ops)
    by = "bytes" if t_bytes >= t_ops else "operations"
    # The chain: each round walks a column 2 (H - 1) steps, then (after
    # every column) a row 2 (W - 1) steps; a step is the dependent FADD and
    # FMNMX, 4 cycles each (the CUDA C++ Programming Guide's latency of an
    # arithmetic instruction from compute capability 7.x on), at the
    # card's maximum SM clock.
    chain_steps = FLOOD_SWEEPS * 2 * ((h - 1) + (w - 1))
    sass = geodesic_step_sass()
    mhz = sm_clock_mhz()
    t_chain = chain_steps * 2 * 4 / (mhz * 1e6) * 1e3
    log(f"phase 10: geodesic flood kernel SASS: {sass} (the walk's step: one FADD, "
        f"one FMNMX{'.NAN' if sass and sass['nan_min'] else ''}); SM clock max "
        f"{mhz:.0f} MHz; one chain's step on the card {step_ns:.3f} ns "
        f"({step_ns * mhz / 1e3:.2f} cycles; a down sweep over 2^14 and 2^17 "
        f"cells: {steps_ns[1 << 14] / 1e3:.2f} / {steps_ns[1 << 17] / 1e3:.2f} us) "
        f"[{card}]")
    log(f"phase 10: geodesic flood {w}x{h} (MID), {FLOOD_SWEEPS} rounds, one launch: "
        f"{flood_ms:.4f} ms; a column sweep (down or up alone) {col_ms:.4f} ms, a row "
        f"sweep (right or left) {row_ms:.4f} ms; chain bound {t_chain:.4f} ms "
        f"({chain_steps} dependent steps x 8 cycles at {mhz:.0f} MHz), "
        f"{100 * t_chain / flood_ms:.1f}% of it; byte bound {t_bytes:.4f} ms "
        f"({nbytes / 1e6:.1f} MB at 3.35 TB/s; ops {ops / 1e6:.1f} M -> {t_ops:.4f} "
        f"ms), {100 * bound / flood_ms:.2f}% of it; plain twin (a torch loop over "
        f"rows/columns) {plain:.2f} ms; library (torch.cumsum + torch.cummin, a flood) "
        f"{library:.4f} ms [{card}]")
    return dict(ms=flood_ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                library_ms=library, col_ms=col_ms, row_ms=row_ms)


def mask_scene(h, w):
    """A seeded 24 MP scene with regions to select: a smooth green backdrop,
    a red disc and a dark blue band, light noise. Every region keeps its
    chroma after bench_edit's white balance: a near-gray pixel's hue is
    f32 noise, and bench_edit's lightness curve (hue-indexed, 31000 at hue
    0 and 35000 at hue 1) jumps at the hue wrap, so such a pixel may take
    either side in the kernel and in the anchor."""
    rng = np.random.default_rng(SEED + 11)
    yy = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None]
    xx = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :]
    img = np.empty((h, w, 3), np.float32)
    img[..., 0] = 0.12 + 0.08 * yy
    img[..., 1] = 0.35 + 0.1 * xx
    img[..., 2] = 0.18 + 0.05 * (yy + xx)
    disc = (yy - 0.5) ** 2 + ((xx - 0.3) * w / h) ** 2 <= 0.2 ** 2
    img[disc] = (0.7, 0.15, 0.08)
    img[(xx > 0.7) & (xx < 0.8) & np.ones_like(yy, bool)] = (0.03, 0.05, 0.15)
    img += 0.002 * rng.random((h, w, 3), dtype=np.float32)
    return img


def phase_masks_and_exports(dev, card, log, dng_path, arw_path):
    """Phase 10, part 2: this slice's path on a 6000x4000 session on the
    card, every launch count zeroed just before and read just after:
    add_similarity_mask (a point; labelled points), add_smart_mask (a point;
    include + exclude: 1 + 2 geodesic launches, one a flood, no twin call),
    add_model_mask (an in-process stub on the card), mask_overlay_srgb at
    MID, a FULL render with the new masks, save_hdr_dng of it; then the FULL
    render against the exact-LUT anchor, the HDR DNG reopened by read_raw
    against the render, `cli convert` of phase 6's DNG (ljpeg and deflate,
    the mosaic kept bit for bit), `cli info --verify-decode` of phase 8's
    matching ARW2 and `cli devices`. Returns the path's launches by kernel
    (geodesic, develop, RAW and JPEG)."""
    import torch

    from rawphotoforge_tpu_torch.app import cli
    from rawphotoforge_tpu_torch.core.color import srgb_to_linear
    from rawphotoforge_tpu_torch.engine.editor import FULL, MID, PhotoEditor
    from rawphotoforge_tpu_torch.io import dng, raw as rawio
    from rawphotoforge_tpu_torch.kernels import fused, geodesic, jpeg_wire
    from rawphotoforge_tpu_torch.kernels import raw_pipeline as rp
    from rawphotoforge_tpu_torch.utils import transfer

    from rawphotoforge_tpu_torch.core.params import EditParameters

    h, w = PHOTO_HW
    img = mask_scene(h, w)
    main_edit = EditParameters()
    bench_edit(main_edit)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_masks_")
    hdr_path = os.path.join(tmp, "render.dng")
    disc_xy = (int(0.3 * w), h // 2)

    def stub(rgb_u8, point_xy):
        """A segmenter stand-in on the card: +1 in a 300-px disc around the
        click, the red channel's excess elsewhere."""
        t = torch.from_numpy(rgb_u8).to(dev).to(torch.float32)
        yy = torch.arange(t.shape[0], device=dev, dtype=torch.float32)[:, None]
        xx = torch.arange(t.shape[1], device=dev, dtype=torch.float32)[None, :]
        inside = (xx - point_xy[0]) ** 2 + (yy - point_xy[1]) ** 2 <= 300.0 ** 2
        return torch.where(inside, 1.0, t[..., 0] / 255.0 - 1.0)[::4, ::4]

    twin_calls = [0]
    real_twin = geodesic.sweep_ref

    def counted(*a, **k):
        twin_calls[0] += 1
        return real_twin(*a, **k)

    walls = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[name] = (time.perf_counter() - t0) * 1e3
        return out

    geodesic.sweep_ref = counted
    geodesic.KERNEL_LAUNCHES = dict.fromkeys(geodesic.KERNEL_LAUNCHES, 0)  # run starts
    rp.KERNEL_LAUNCHES = dict.fromkeys(rp.KERNEL_LAUNCHES, 0)
    jpeg_wire.KERNEL_LAUNCHES = dict.fromkeys(jpeg_wire.KERNEL_LAUNCHES, 0)
    fused.LAUNCHES = 0
    t0 = time.perf_counter()
    try:
        ed = PhotoEditor.from_rgb_f32(img, device=dev)
        # bench_edit's curves: no identity_oklch shortcut, so the kernel
        # render and the exact-LUT anchor compute the same stack.
        ed.load_preset_json(json.dumps({"version": 1, "crop": None, "masks": [
            {"name": "main", "params": main_edit.to_json()}]}))
        timed("add_similarity_mask (a point)", lambda: ed.add_similarity_mask(
            "sim", disc_xy, color_tolerance=0.15))
        timed("add_similarity_mask (3 labelled points)", lambda: ed.add_similarity_mask(
            "sim_pts", points_xy=[disc_xy, (int(0.75 * w), h // 2), (w // 10, h // 10)],
            labels=[1, 0, 1], color_tolerance=0.2))
        timed("add_smart_mask (a point)", lambda: ed.add_smart_mask(
            "smart", disc_xy, tolerance=0.5))
        smart_launches = geodesic.KERNEL_LAUNCHES["geodesic_sweep_kernel"]
        timed("add_smart_mask (include + exclude)", lambda: ed.add_smart_mask(
            "smart_pts", points_xy=[(w // 10, h // 10), (int(0.9 * w), h // 10)],
            labels=[1, 0], tolerance=0.5))
        timed("add_model_mask (a stub on the card)", lambda: ed.add_model_mask(
            "model", disc_xy, segmenter=stub))
        for k, name in enumerate(("smart", "sim", "smart_pts"), start=1):
            ed.set_tone(exposure=0.5 - 0.3 * k, contrast=10 * k, mask_name=name)
        overlay = timed("mask_overlay_srgb (MID)", lambda: ed.mask_overlay_srgb("smart", MID))
        full = timed("FULL render (M=6)", lambda: ed.apply(FULL))
        with StageClock(((transfer, "fetch_np", "fetch", "bytes"),
                         (dng, "write_dng", "encode", None))) as clock:
            timed("save_hdr_dng (24 MP, f16)", lambda: ed.save_hdr_dng(hdr_path))
    finally:
        geodesic.sweep_ref = real_twin
    launches = dict(geodesic.KERNEL_LAUNCHES, develop=fused.LAUNCHES,
                    **rp.KERNEL_LAUNCHES, **jpeg_wire.KERNEL_LAUNCHES)  # run ends
    t_main = time.perf_counter() - t0
    check(smart_launches == 1, f"one-point smart mask: {smart_launches} "
          f"geodesic launches (want 1, one flood)")
    check(launches["geodesic_sweep_kernel"] == 3,
          f"geodesic launches {launches['geodesic_sweep_kernel']} (want 3: one "
          f"flood, then an include and an exclude flood)")
    check(twin_calls[0] == 0, f"the geodesic twin ran {twin_calls[0]} times")
    check(launches["develop"] > 0, "the mask path never launched the develop kernel")
    log(f"phase 10: masks and exports on a {w}x{h} session (similarity x2, smart x2, "
        f"model, overlay, FULL render, HDR DNG) in {t_main:.2f} s; launches {launches}, "
        f"geodesic twin calls {twin_calls[0]}")
    log("phase 10: host wall, ms: " + ", ".join(
        f"{k} {v:.2f}" for k, v in walls.items()) + f"; HDR DNG stages: {clock.line()}, "
        f"{os.path.getsize(hdr_path)} bytes [{card}]")

    # Each mask selects part of the frame, the prompts' pixels among them.
    mh, mw = ed.level_shape(MID)
    for name in ("sim", "sim_pts", "smart", "smart_pts", "model"):
        m = ed._find(name)
        cover = float(m.data_full.float().mean())
        check(0.0 < cover < 1.0 and m.logits.shape == (h, w)
              and np.isfinite(m.logits).all(), f"mask {name}: cover {cover}")
        log(f"phase 10: mask {name}: {100 * cover:.2f} % of the frame selected")
    for name in ("sim", "smart", "model"):
        check(int(ed._find(name).data_full[disc_xy[1], disc_xy[0]]) == 1,
              f"mask {name} misses its prompt pixel")
    check(tuple(overlay.shape) == (3, mh, mw) and bool(torch.isfinite(overlay).all())
          and float(overlay.min()) >= 0.0 and float(overlay.max()) <= 1.0,
          f"overlay {tuple(overlay.shape)}")
    kernel_full = full.clone()
    ed.use_kernel = False
    err = compare(kernel_full, ed.apply(FULL),
                  what="FULL render with the new masks vs exact-LUT anchor")
    ed.use_kernel = True
    log(f"phase 10: FULL render with the 5 new masks (M=6) vs exact-LUT anchor: "
        f"max abs err {err:.3e} (assert_close); overlay {mw}x{mh} in [0, 1]")

    got, _ = rawio.read_raw(hdr_path, device=dev)
    want = srgb_to_linear(kernel_full)
    check(tuple(got.shape) == tuple(want.shape), f"HDR DNG reopens as {tuple(got.shape)}")
    hdr_err = float((got - want).abs().max())
    check(hdr_err <= 2e-3, f"HDR DNG round trip off by {hdr_err:.3e} (f16 bound 2e-3)")
    log(f"phase 10: HDR DNG {w}x{h} reopened by read_raw on the card: max abs err "
        f"{hdr_err:.3e} against the linear render (f16 bound 2e-3)")
    del ed, full, kernel_full, got, want, overlay
    torch.cuda.empty_cache()

    # The host commands.
    with open(dng_path, "rb") as f:
        src = rawio.parse_raw(f.read(), apply_opcodes=False)
    for codec in ("ljpeg", "deflate"):
        out = os.path.join(tmp, f"convert_{codec}.dng")
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["convert", dng_path, out, "--codec", codec])
        ms = (time.perf_counter() - t0) * 1e3
        check(rc == 0, f"cli convert --codec {codec} exited {rc}")
        with open(out, "rb") as f:
            back = rawio.parse_raw(f.read(), apply_opcodes=False)
        check(np.array_equal(back.mosaic, src.mosaic) and back.pattern == src.pattern,
              f"cli convert --codec {codec}: the mosaic changed")
        log(f"phase 10: cli convert {os.path.basename(dng_path)} --codec {codec}: "
            f"{buf.getvalue().strip()}; mosaic bit for bit; {ms:.0f} ms [{card}]")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["info", arw_path, "--verify-decode", "--device", str(dev)])
    lines = buf.getvalue().strip().splitlines()
    check(rc == 0 and lines and lines[-1].endswith("-> ok"),
          f"cli info --verify-decode exited {rc}: {lines[-1:] }")
    log(f"phase 10: cli info --verify-decode {os.path.basename(arw_path)}: "
        f"{lines[0]} ... {lines[-1]}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["devices"])
    check(rc == 0 and buf.getvalue().startswith("[0] cuda: "), f"cli devices: {rc}")
    log(f"phase 10: cli devices: {buf.getvalue().strip()}")
    shutil.rmtree(tmp, ignore_errors=True)
    return launches


# -- the interactive server (phase 11) -----------------------------------------

# The era's edit, then the drag state (no sharpening or distortion: the host
# drag unsharps the true extent, the card the bucket-padded grid) and the
# regional edit on the smart mask.
SERVER_EDIT = {"exposure": 0.6, "contrast": 20, "shadow": 15, "wb_temperature": 15,
               "vignette": 25,
               "curve_brightness": [[0, 0], [20000, 26000], [45000, 47000], [65535, 65535]]}
DRAG_TICKS = 20


def _http(base, path, body=None):
    """(ms, status, headers, bytes) of one request to the server."""
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data,
                                 method="GET" if data is None else "POST")
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as r:
        out = r.read()
        return (time.perf_counter() - t0) * 1e3, r.status, dict(r.headers), out


def _pct(xs, q):
    return float(np.percentile(np.asarray(xs, dtype=np.float64), q))


def phase_server(dev, card, log, dng_path):
    """Phase 11: the interactive server on the card (app/server.serve, the
    entry point of `cli serve`), driven over HTTP in this process with
    phase 6's 24 MP RGGB lossless-JPEG DNG: the instant startup, a gated
    open (the era: the instant preview, an era edit rendered by
    engine/hostdev and held byte for byte against the same render made
    here), the swap (the era edit replayed; the MID preview byte for byte a
    direct editor's), drag ticks with the host drag on and off, MID
    releases, a smart mask (one geodesic launch a flood) and an async JPEG
    export (byte for byte the direct editor's save_bytes). An ungated open
    gives the open timings. Every launch count is zeroed just before and
    read just after, and no twin may run. Returns the path's launches by
    kernel."""
    import threading
    import urllib.request

    import torch

    from rawphotoforge_tpu_torch.app import server as srv
    from rawphotoforge_tpu_torch.engine import hostdev, instant
    from rawphotoforge_tpu_torch.engine.editor import LOW, MID, PhotoEditor
    from rawphotoforge_tpu_torch.engine.session import Settings
    from rawphotoforge_tpu_torch.io import image_io, jpegbits, jpegenc, raw as rawio
    from rawphotoforge_tpu_torch.kernels import fused, geodesic, geometry, jpeg_wire
    from rawphotoforge_tpu_torch.utils.transfer import fetch_u8_hwc

    with open(dng_path, "rb") as f:
        data = f.read()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_server_")
    twin_calls = {}
    twins = [(fused, "develop_post_geo_fused_ref"), (geodesic, "sweep_ref"),
             (geometry, "geometry_sharpen_ref"), (jpegenc, "blockify"),
             (jpegbits, "prepack"), (jpegbits, "scan_from_words"),
             (jpegbits, "concat_words")]
    real = {(m, n): getattr(m, n) for m, n in twins}

    def counted(name, fn):
        def call(*a, **k):
            twin_calls[name] = twin_calls.get(name, 0) + 1
            return fn(*a, **k)
        return call

    gate = threading.Event()
    gate.set()
    real_from_host = PhotoEditor.from_host.__func__

    def gated_from_host(cls, ho, **kw):
        gate.wait(timeout=300)
        return real_from_host(cls, ho, **kw)

    def uncounted(fn):
        """A reference computation: its launches are not the path's. The
        server's own threads (the open, the warm-up) are joined first."""
        for t in threading.enumerate():
            if t.name in ("rpf-open", "rpf-prewarm"):
                t.join(300)
        saved = (fused.LAUNCHES, dict(geodesic.KERNEL_LAUNCHES),
                 dict(jpeg_wire.KERNEL_LAUNCHES), dict(geometry.KERNEL_LAUNCHES))
        try:
            return fn()
        finally:
            fused.LAUNCHES = saved[0]
            geodesic.KERNEL_LAUNCHES.update(saved[1])
            jpeg_wire.KERNEL_LAUNCHES.update(saved[2])
            geometry.KERNEL_LAUNCHES.update(saved[3])

    for (m, n), fn in real.items():
        setattr(m, n, counted(n, fn))
    PhotoEditor.from_host = classmethod(gated_from_host)
    geodesic.KERNEL_LAUNCHES = dict.fromkeys(geodesic.KERNEL_LAUNCHES, 0)  # run starts
    jpeg_wire.KERNEL_LAUNCHES = dict.fromkeys(jpeg_wire.KERNEL_LAUNCHES, 0)
    geometry.KERNEL_LAUNCHES = dict.fromkeys(geometry.KERNEL_LAUNCHES, 0)
    fused.LAUNCHES = 0
    t_phase = time.perf_counter()
    times = {}
    httpd = None
    try:
        t0 = time.perf_counter()
        httpd = srv.serve(None, port=0, settings=Settings(),
                          settings_path=os.path.join(tmp, "settings.json"),
                          initial_file=(data, "p.dng"), device=dev)
        app = httpd.app
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        times["serve() (startup host decode)"] = (time.perf_counter() - t0) * 1e3
        check(app.device_ready.wait(300), "the startup open never became ready")
        times["startup: serve() -> device ready"] = (time.perf_counter() - t0) * 1e3
        check(app.device == dev, f"the server's device is {app.device}")

        # An ungated open: the open timings, the host decode's stages apart.
        clock = StageClock(((rawio, "parse_raw", "parse + LJPEG decode", None),
                            (instant, "quick_linear_from_raw", "superpixel instant", None),
                            (instant, "encode_instant_jpeg", "instant JPEG", None),
                            (instant, "instant_histogram", "instant histogram", None)))
        t0 = time.perf_counter()
        req = urllib.request.Request(base + "/open?name=p.dng", data=data, method="POST")
        with clock, urllib.request.urlopen(req, timeout=300) as r:
            out = json.loads(r.read())
        t_post = time.perf_counter()
        ready_at_return = app.device_ready.is_set()
        _, _, hdr, _ = _http(base, "/preview?level=mid")
        t_first = time.perf_counter()
        check(out.get("instant"), f"/open answered {out}")
        check(app.device_ready.wait(300), "the open never became ready")
        t_ready = time.perf_counter()
        times["POST /open"] = (t_post - t0) * 1e3
        times["open -> first instant preview"] = (t_first - t0) * 1e3
        times["open -> device ready"] = (t_ready - t0) * 1e3
        log(f"phase 11: POST /open's host stages, ms: {clock.line()}; the device phase "
            f"(upload, demosaic, MID render, histogram) {(t_ready - t_post) * 1e3:.2f} "
            f"after the POST returned [{card}]")
        log(f"phase 11: ungated open: the device phase had "
            f"{'ended' if ready_at_return else 'not ended'} when POST /open returned; "
            f"the first preview was {'instant' if 'X-RPF-Instant' in hdr else 'a device render'}")

        # The era, gated: deterministic checks.
        gate.clear()
        t0 = time.perf_counter()
        req = urllib.request.Request(base + "/open?name=p.dng", data=data, method="POST")
        with urllib.request.urlopen(req, timeout=300) as r:
            out = json.loads(r.read())
        check(out.get("instant") and not app.device_ready.is_set(),
              "POST /open did not return before the device phase ended")
        _, st, hdr, _ = _http(base, "/preview?level=mid")
        check(st == 200 and hdr.get("X-RPF-Instant") == "1",
              "an era /preview lacks X-RPF-Instant")
        era_ticks = []
        for i in range(5):  # the first builds the era's LOW planes
            ms_edit, _, _, _ = _http(base, "/edit", dict(SERVER_EDIT, exposure=0.5 + 0.02 * i))
            ms_low, _, hdr, _ = _http(base, "/preview?level=low")
            check(hdr.get("X-RPF-Instant") == "1", "the era LOW tick is not instant")
            era_ticks.append(ms_edit + ms_low)
        ms_edit, _, _, _ = _http(base, "/edit", SERVER_EDIT)
        times["era LOW tick (POST /edit + GET LOW), first"] = era_ticks[0]
        times["era LOW tick, median of the next 4"] = _pct(era_ticks[1:], 50)
        _, _, hdr, era_mid = _http(base, "/preview?level=mid")
        ho = PhotoEditor.open_host(data, "DNG", mid_long_edge=Settings().ui_preview_size)
        want = instant.encode_instant_jpeg(hostdev.render_u8_hwc(
            ho.instant_linear, [srv.EditorApp._state_to_params(SERVER_EDIT)]))
        check(era_mid == want, "the era preview differs from encode_instant_jpeg("
              "hostdev.render_u8_hwc(...)) of the same state")
        log(f"phase 11: era: POST /open returned before the device phase ended, "
            f"/preview carries X-RPF-Instant, the era MID preview after /edit == "
            f"encode_instant_jpeg(hostdev.render_u8_hwc) byte for byte ({len(want)} bytes)")
        gate.set()
        check(app.device_ready.wait(300), "the gated open never became ready")
        _, _, _, params = _http(base, "/params")
        params = json.loads(params)
        check(params["exposure"] == SERVER_EDIT["exposure"]
              and params["contrast"] == SERVER_EDIT["contrast"]
              and params["vignette"] == SERVER_EDIT["vignette"],
              f"the era edit was not replayed: {params}")

        # The reference: a direct editor of the same DNG on the card.
        ref = uncounted(lambda: PhotoEditor.from_bytes(data, "DNG", device=dev))
        app.apply_state(SERVER_EDIT, editor=ref)
        _, _, hdr, mid = _http(base, "/preview?level=mid")
        check("X-RPF-Instant" not in hdr, "the MID preview after the swap is instant")
        check(mid == uncounted(lambda: image_io.encode_image(
            ref.apply(MID, cropped=False), "JPEG", quality=90)),
              "the MID preview after the swap differs from the direct editor's")
        log("phase 11: swap: the era edit replayed (/params); the MID preview == the "
            "direct editor's encode_image(apply(MID)) byte for byte")

        # Drag ticks: POST /edit + GET LOW, host drag on, then off.
        drag = {}
        splits = []
        for host_drag in (True, False):
            app.host_drag = host_drag
            ticks = []
            for i in range(DRAG_TICKS + 2):
                body = dict(SERVER_EDIT, exposure=0.3 + 0.03 * i)
                ms_edit, _, _, _ = _http(base, "/edit", body)
                ms_low, st, hdr, _ = _http(base, "/preview?level=low")
                check(st == 200 and (hdr.get("X-RPF-HostDrag") == "1") == host_drag,
                      f"drag tick with host_drag={host_drag}: headers {hdr}")
                if i >= 2:  # the first two warm the path
                    ticks.append(ms_edit + ms_low)
                    if host_drag:
                        splits.append([int(v) for v in hdr["X-RPF-Drag-Us"].split(",")])
            drag[host_drag] = ticks
        app.host_drag = True
        check(not app._hostdrag_warned, "a host-drag render failed (logged)")
        host_u8 = app._hostdrag_frame()
        card_u8 = uncounted(lambda: fetch_u8_hwc(app.editor.apply(LOW, cropped=False)))
        check(host_u8.shape == card_u8.shape, f"host frame {host_u8.shape} vs card "
              f"{card_u8.shape}")
        d = np.abs(host_u8.astype(np.int16) - card_u8.astype(np.int16))
        flips, big = float((d > 0).mean()), float((d > 16).mean())
        # tests/test_hostdev.py's _assert_u8_close rule.
        check(np.median(d) == 0 and flips < 0.05 and big < 1e-3,
              f"host drag frame vs the card's LOW render: median {np.median(d)}, "
              f"flips {flips:.3e}, >16 {big:.3e}")
        log(f"phase 11: host drag frame {host_u8.shape[1]}x{host_u8.shape[0]} vs the "
            f"card's LOW render of the same state: {100 * flips:.3f} % of samples "
            f"differ, max {int(d.max())}, > 16 on {100 * big:.4f} % (the "
            f"_assert_u8_close rule of tests/test_hostdev.py)")

        # MID releases: POST /edit + GET MID.
        releases = []
        last = None
        for i in range(10):
            last = dict(SERVER_EDIT, exposure=0.4 + 0.02 * i, contrast=20 + i)
            ms_edit, _, _, _ = _http(base, "/edit", last)
            ms_mid, _, _, _ = _http(base, "/preview?level=mid")
            releases.append(ms_edit + ms_mid)
        _, _, _, hist = _http(base, "/histogram")
        check(np.asarray(json.loads(hist)).shape == (4, 256), "histogram shape")

        # A smart mask, then a regional edit on it.
        h, w = app.editor.shape
        smart = {"name": "smart", "point": [w // 3, h // 2], "smart": True,
                 "tolerance": 0.5}
        before = geodesic.KERNEL_LAUNCHES["geodesic_sweep_kernel"]
        ms_smart, st, _, _ = _http(base, "/mask/add", smart)
        flood = geodesic.KERNEL_LAUNCHES["geodesic_sweep_kernel"] - before
        check(st == 200 and flood == 1,
              f"/mask/add smart: {flood} geodesic launches (want 1, one flood)")
        times["/mask/add smart (MID flood)"] = ms_smart
        regional = {"_target": "smart", "exposure": -0.5, "contrast": 15}
        _http(base, "/edit", regional)
        app.apply_state(last, editor=ref)
        uncounted(lambda: ref.add_smart_mask("smart", tuple(smart["point"]),
                                             smart["tolerance"], 12.0))
        app.apply_state(regional, editor=ref)
        _, _, _, mid = _http(base, "/preview?level=mid")
        check(mid == uncounted(lambda: image_io.encode_image(
            ref.apply(MID, cropped=False), "JPEG", quality=90)),
              "the MID preview with the smart mask differs from the direct editor's")

        # The async JPEG export.
        jpeg_before = dict(jpeg_wire.KERNEL_LAUNCHES)
        t0 = time.perf_counter()
        _, _, _, job = _http(base, "/export/start", {"fmt": "jpeg"})
        job = json.loads(job)["job"]
        while True:
            _, _, _, stt = _http(base, f"/export/status?job={job}")
            stt = json.loads(stt)
            if stt["state"] != "running":
                break
            time.sleep(0.002)
        _, st, _, exported = _http(base, f"/export/result?job={job}")
        times["async JPEG export (start -> result)"] = (time.perf_counter() - t0) * 1e3
        check(st == 200 and stt["state"] == "done", f"export job: {stt}")
        grew = {k: jpeg_wire.KERNEL_LAUNCHES[k] - jpeg_before[k] for k in jpeg_before}
        check(all(v > 0 for v in grew.values()), f"export JPEG kernel launches {grew}")
        torch.cuda.synchronize()
    finally:
        PhotoEditor.from_host = classmethod(real_from_host)
        for (m, n), fn in real.items():
            setattr(m, n, fn)
        gate.set()
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
    launches = dict(geodesic.KERNEL_LAUNCHES, develop=fused.LAUNCHES,
                    **jpeg_wire.KERNEL_LAUNCHES, **geometry.KERNEL_LAUNCHES)  # run ends
    t_phase = time.perf_counter() - t_phase
    expect = ref.save_bytes("JPEG")
    check(exported == expect, "the async export differs from the direct editor's "
          "save_bytes('JPEG')")
    check(launches["develop"] > 0, "the server path never launched the develop kernel")
    check(not twin_calls, f"twins ran on the server path: {twin_calls}")
    log(f"phase 11: smart mask: {flood} geodesic launches; async JPEG export "
        f"{len(exported)} bytes == the direct editor's save_bytes('JPEG'); stages "
        f"{stt['stages_ms']} ms; JPEG kernel launches {grew}")
    log("phase 11: host wall, ms: " + ", ".join(f"{k} {v:.2f}" for k, v in times.items())
        + f" [{card}]")
    sp = np.asarray(splits, dtype=np.float64) / 1e3
    log(f"phase 11: drag ticks (POST /edit + GET /preview?level=low, {DRAG_TICKS} each), "
        f"ms: host drag p50 {_pct(drag[True], 50):.3f} p95 {_pct(drag[True], 95):.3f} "
        f"(X-RPF-Drag-Us p50: render {_pct(sp[:, 0], 50):.3f}, encode "
        f"{_pct(sp[:, 1], 50):.3f}, lock wait {_pct(sp[:, 2], 50):.3f}); device drag "
        f"p50 {_pct(drag[False], 50):.3f} p95 {_pct(drag[False], 95):.3f} [{card}]")
    log(f"phase 11: MID release (POST /edit + GET /preview?level=mid, 10), ms: p50 "
        f"{_pct(releases, 50):.3f} p95 {_pct(releases, 95):.3f} [{card}]")
    log(f"phase 11: server path in {t_phase:.2f} s; launches {launches}; twin calls "
        f"{sum(twin_calls.values())}")
    del ref
    shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


# -- the multi-device path (phase 12) -------------------------------------------

MESH_DNGS = 4          # 24 MP RGGB lossless-JPEG DNGs for the mesh batch
MESH_RANKS = 2         # phase 12b: gloo ranks on the one card
MESH_DEADLINE_S = 600  # phase 12b's ranks are killed after this
# The row-sharded warp against the single-device warp: tests/test_sharding.py's
# 5e-5 at 64 rows, scaled with the height (the coordinates' ulps grow with h).
WARP_TOL_PER_ROW = 5e-5 / 64
RAW_SHARDED_TOL = 3e-7  # MULTICHIP_r05.json: raw_develop_sharded.rgb 2.98e-07


def smooth_scene(rng, h, w):
    """Phase 6's seeded smooth-plus-texture linear scene [3, h, w]."""
    yy = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None]
    xx = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :]
    scene = np.stack([0.15 + 0.6 * yy * np.ones_like(xx),
                      0.1 + 0.5 * xx * np.ones_like(yy),
                      0.3 + 0.3 * np.sin(6.0 * (xx + yy))])
    return scene + 0.15 * rng.random((3, h, w), dtype=np.float32)


def write_mesh_dngs(tmp, log):
    """Four 24 MP RGGB lossless-JPEG DNGs, each from its own seed."""
    import dataclasses

    from rawphotoforge_tpu_torch.io import dng, raw as rawio

    h, w = BAYER_HW
    d = os.path.join(tmp, "mesh_dngs")
    os.makedirs(d)

    def one(i):
        raw = rawio.synthetic_raw(smooth_scene(np.random.default_rng(SEED + 40 + i), h, w),
                                  "RGGB", xyz_to_cam=XYZ_TO_CAM)
        raw = dataclasses.replace(raw, exif={"Make": "Synthetic",
                                             "Model": f"chip-smoke-mesh-{i}"})
        with open(os.path.join(d, f"mesh{i}.dng"), "wb") as f:
            f.write(dng.write_dng(raw, compression=7))

    t0 = time.perf_counter()
    with ThreadPoolExecutor(MESH_DNGS) as pool:
        list(pool.map(one, range(MESH_DNGS)))
    log(f"phase 12: wrote {MESH_DNGS} {w}x{h} RGGB lossless-JPEG DNGs in "
        f"{time.perf_counter() - t0:.2f} s")
    return d


def launch_counts():
    """Every kernel's launch counter, by kernel name."""
    from rawphotoforge_tpu_torch.kernels import (fused, geodesic, geometry, jpeg_wire,
                                                 raw_pipeline)

    return dict(develop=fused.LAUNCHES, **raw_pipeline.KERNEL_LAUNCHES,
                **jpeg_wire.KERNEL_LAUNCHES, **geodesic.KERNEL_LAUNCHES,
                **geometry.KERNEL_LAUNCHES)


def zero_launches():
    from rawphotoforge_tpu_torch.kernels import (fused, geodesic, geometry, jpeg_wire,
                                                 raw_pipeline)

    fused.LAUNCHES = 0
    for counts in (raw_pipeline.KERNEL_LAUNCHES, jpeg_wire.KERNEL_LAUNCHES,
                   geodesic.KERNEL_LAUNCHES, geometry.KERNEL_LAUNCHES):
        for k in counts:
            counts[k] = 0


class PathLaunches:
    """Launches of the mesh path's steps only: the counters are set to 0
    just before each step (``with acc.step():``) and read just after; the
    single-device references the steps are held to run outside."""

    def __init__(self):
        self.total = {}

    @contextlib.contextmanager
    def step(self):
        import torch

        zero_launches()
        yield
        torch.cuda.synchronize()
        for k, v in launch_counts().items():
            self.total[k] = self.total.get(k, 0) + v


@contextlib.contextmanager
def counted_twins():
    """Counts calls of every kernel's plain twin while the block runs."""
    from rawphotoforge_tpu_torch.io import jpegbits, jpegenc
    from rawphotoforge_tpu_torch.kernels import fused, geodesic, raw_pipeline

    calls = {}
    twins = [(fused, "develop_post_geo_fused_ref"),
             (raw_pipeline, "raw_develop_fused_ref"), (geodesic, "sweep_ref"),
             (jpegenc, "blockify"), (jpegbits, "prepack"),
             (jpegbits, "scan_from_words"), (jpegbits, "concat_words")]
    real = {(m, n): getattr(m, n) for m, n in twins}

    def counted(name, fn):
        def call(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)
        return call

    for (m, n), fn in real.items():
        setattr(m, n, counted(n, fn))
    try:
        yield calls
    finally:
        for (m, n), fn in real.items():
            setattr(m, n, fn)


def mesh_batch(paths, out_dir, dev):
    """`cli batch`'s mesh path (``_batch_mesh_path``) over ``paths`` in the
    current world; returns (rc, rank's stdout, host s)."""
    from rawphotoforge_tpu_torch.app import cli

    args = cli._parser().parse_args(["batch", os.path.dirname(paths[0]), out_dir,
                                     *RAW_FLAGS, "--device", str(dev)])
    os.makedirs(out_dir, exist_ok=True)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli._batch_mesh_path(paths, args)
    return rc, buf.getvalue(), time.perf_counter() - t0


def same_files(a, b):
    names = sorted(os.listdir(a))
    check(names == sorted(os.listdir(b)) and names,
          f"file sets differ: {names} vs {sorted(os.listdir(b))}")
    for n in names:
        with open(os.path.join(a, n), "rb") as fa, open(os.path.join(b, n), "rb") as fb:
            check(fa.read() == fb.read(), f"{n}: the mesh batch's bytes differ from "
                  "the single-device loop's (--no-mesh --exact-path)")
    return names


def m4_session(dev, distortion=0):
    """Phase 4's M=4 case: planes on the 24 MP bucket grid, the edit stack
    packed with the photo's true extent, the u8 masks and the editor's
    kernel flags."""
    from rawphotoforge_tpu_torch.core.params import pack_params

    planes, cases = develop_cases(dev)
    _, stack, masks, flags = cases[-1]
    stack[0].set_lens_distortion(distortion)
    params = pack_params(stack, extent=PHOTO_HW, build_luts=False, device=dev)
    return planes, params, masks, flags


def phase_mesh_one(dev, card, log, tmp, dng_dir):
    """Phase 12a: a world of one rank over NCCL in this process."""
    import torch
    import torch.distributed as dist

    from rawphotoforge_tpu_torch.app import cli
    from rawphotoforge_tpu_torch.io import jpegbits, jpegenc
    from rawphotoforge_tpu_torch.kernels import fused
    from rawphotoforge_tpu_torch.kernels.raw_pipeline import raw_develop_fused
    from rawphotoforge_tpu_torch.ops.stats import histogram_rgbl
    from rawphotoforge_tpu_torch.parallel import mesh as pm

    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                            rank=0, world_size=1, timeout=datetime.timedelta(seconds=300))
    acc = PathLaunches()
    try:
        with counted_twins() as twins:
            paths = sorted(os.path.join(dng_dir, n) for n in os.listdir(dng_dir))
            with acc.step():
                rc, out, wall = mesh_batch(paths, os.path.join(tmp, "mesh_out"), dev)
            sys.stdout.write(out)
            check(rc == 0 and "batch (mesh x1)" in out, f"mesh batch exited {rc}")
            twins_batch = dict(twins)
        single = os.path.join(tmp, "single_out")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["batch", dng_dir, single, "--no-mesh", "--exact-path",
                           *RAW_FLAGS, "--device", str(dev)])
        check(rc == 0, f"the single-device loop exited {rc}")
        names = same_files(os.path.join(tmp, "mesh_out"), single)
        rate = [ln for ln in out.splitlines() if "MPix/s" in ln][0].strip()
        single_rate = [ln for ln in buf.getvalue().splitlines() if "MPix/s" in ln][0]
        log(f"phase 12a: {rate}; {len(names)} files == `batch --no-mesh "
            f"--exact-path` byte for byte (that loop: {single_rate.strip()}); "
            f"wall {wall * 1e3:.1f} ms [{card}]")

        m = pm.make_mesh(devices=dev)
        planes, params, masks, flags = m4_session(dev)
        with counted_twins() as twins:
            with acc.step():
                out_rows = pm.develop_spatial_sharded(
                    pm.shard_rows(planes, m), params, pm.shard_rows(masks, m), m,
                    use_kernel=True)
                hist = pm.histogram_sharded(out_rows, m)
            ms = time_events(lambda: pm.develop_spatial_sharded(
                planes, params, masks, m, use_kernel=True), reps=10)
            twins_dev = dict(twins)
        editor = fused.develop_post_geo_fused(planes, params, masks, **flags)
        check(torch.equal(pm.gather_rows(out_rows, m), editor),
              "develop_spatial_sharded(use_kernel=True) differs from the editor's "
              "kernel render")
        check(torch.equal(hist, histogram_rgbl(editor)),
              "histogram_sharded (NCCL all_reduce) differs from histogram_rgbl")
        hb, wb = BUCKET_HW
        log(f"phase 12a: develop_spatial_sharded(use_kernel=True) {wb}x{hb} M=4 == "
            f"the editor's kernel render bit for bit, {ms:.4f} ms by CUDA events; "
            f"histogram_sharded (NCCL all_reduce) == histogram_rgbl [{card}]")
        del planes, masks, editor, out_rows

        qlum, qchr = jpegenc._quant_tables(JPEG_QUALITY)
        tone, _, _ = raw_edits()
        rng = np.random.default_rng(SEED + 12)
        with counted_twins() as twins:
            for pattern, (h, w) in (("RGGB", BAYER_HW), ("XTRANS", XTRANS_HW)):
                mosaic = torch.from_numpy(rng.random((h, w), dtype=np.float32)).to(dev)
                args = raw_args(dev, mosaic, tone)
                with acc.step():
                    words, totals = pm.export_batch_raw_fused_packed_step(
                        mosaic[None], *args[1:], m, qlum, qchr, pattern=pattern)
                step_ms = time_events(lambda: pm.export_batch_raw_fused_packed_step(
                    mosaic[None], *args[1:], m, qlum, qchr, pattern=pattern), reps=5)
                s_words, s_totals = jpegbits.wire_packed(
                    raw_develop_fused(*args, pattern=pattern), qlum, qchr)
                check(torch.equal(words[0], s_words) and torch.equal(totals[0], s_totals),
                      f"the mesh RAW step's {pattern} scan differs from the "
                      "single-device packed wire")
                log(f"phase 12a: export_batch_raw_fused_packed_step {pattern} {w}x{h}: "
                    f"scan ({int(totals[0, 0])} words) == the single-device packed "
                    f"wire's; {step_ms:.4f} ms by CUDA events (RAW kernel + JPEG "
                    f"wire) [{card}]")
                del mosaic, words, s_words
            twins_raw = dict(twins)
        for name, calls in (("batch", twins_batch), ("develop", twins_dev),
                            ("RAW step", twins_raw)):
            check(not calls, f"twins ran on phase 12a's {name}: {calls}")
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return acc.total


def mesh_rank(rank, world, init, out_path, dng_dir, out_dir, device, backend):
    """Phase 12b: one rank (spawned; imports neither jax nor a test
    module): a gloo rank on the shared card, or (``--mesh-cards``) an NCCL
    rank on its own card. Writes (status, results) to ``out_path``."""
    import pickle
    import traceback

    import torch
    import torch.distributed as dist

    from rawphotoforge_tpu_torch.kernels import fused
    from rawphotoforge_tpu_torch.ops import demosaic as dm
    from rawphotoforge_tpu_torch.ops.develop import geometry_stage
    from rawphotoforge_tpu_torch.ops.sharpen import unsharp_mask
    from rawphotoforge_tpu_torch.ops.stats import histogram_rgbl
    from rawphotoforge_tpu_torch.parallel import mesh as pm, spatial

    dev = torch.device(device)
    torch.cuda.set_device(dev)
    os.environ["LOCAL_RANK"] = str(rank)  # as torchrun sets it
    res = {"ms": {}, "checks": {}}
    halo = {"ms": 0.0, "bytes": 0, "calls": 0}  # the current step's exchanges
    real_p2p = spatial._p2p

    def timed_p2p(mesh, sends, recvs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = real_p2p(mesh, sends, recvs)
        halo["ms"] += (time.perf_counter() - t0) * 1e3
        halo["bytes"] += sum(t.numel() * t.element_size() for t, _ in sends)
        halo["calls"] += 1
        return got

    def device_ms(fn):
        """fn's result, its CUDA-event ms, host ms, and the host ms, bytes
        and count of the halo exchanges inside it."""
        torch.cuda.synchronize()
        halo.update(ms=0.0, bytes=0, calls=0)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t0 = time.perf_counter()
        ev[0].record()
        out = fn()
        ev[1].record()
        torch.cuda.synchronize()
        return out, (ev[0].elapsed_time(ev[1]), (time.perf_counter() - t0) * 1e3,
                     halo["ms"], halo["bytes"], halo["calls"])

    def timed(name, step):
        """Runs ``step`` twice; keeps the first call's output and both
        calls' times (cold, warm) under ``name``. The first call is the
        path's: its launches count."""
        with acc.step():
            out, cold = device_ms(step)
        res["ms"][name] = (cold, device_ms(step)[1])
        return out

    try:
        dist.init_process_group(backend, init_method=f"file://{init}", rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=300))
        spatial._p2p = timed_p2p
        acc = PathLaunches()
        m = pm.make_mesh(1, world, devices=dev)  # every rank on 'sp'
        with counted_twins() as twins:
            planes, params, masks, _ = m4_session(dev, distortion=35)
            h = planes.shape[1]
            blk, mblk = pm.shard_rows(planes, m), pm.shard_rows(masks, m)
            ext = params.extent
            rows = timed("develop_spatial_sharded(use_kernel=True), distortion 35",
                         lambda: pm.develop_spatial_sharded(
                             blk, params, mblk, m, use_kernel=True, h=h))
            geo_rows = spatial.distortion_sharded(blk, params.distortion, m,
                                                  extent=ext, h=h)
            geo, out = pm.gather_rows(geo_rows, m), pm.gather_rows(rows, m)
            hist = pm.histogram_sharded(rows, m)
            if rank == 0:
                one = geometry_stage(planes, 35.0, ext)
                res["checks"]["warp max abs err"] = float((geo - one).abs().max())
                res["checks"]["kernel == single-slab kernel"] = bool(torch.equal(
                    out, fused.develop_post_geo_fused(geo, params, masks)))
                res["checks"]["histogram exact"] = bool(torch.equal(
                    hist, histogram_rgbl(out)))
            del planes, masks, blk, mblk, rows, geo_rows, geo, out

            rng = np.random.default_rng(SEED + 13)
            mosaic = torch.from_numpy(rng.random(BAYER_HW, dtype=np.float32)).to(dev)
            mrows = pm.shard_rows(mosaic, m)
            wb, cam, amount = (1.9, 1.0, 1.5), raw_cam(), 0.6
            rgb = timed("demosaic_sharded",
                        lambda: spatial.demosaic_sharded(mrows, m, "RGGB"))
            raw_rows = timed("raw_develop_sharded", lambda: spatial.raw_develop_sharded(
                mrows, wb, cam, m, "RGGB", amount))
            rgb, raw_out = pm.gather_rows(rgb, m), pm.gather_rows(raw_rows, m)
            if rank == 0:
                res["checks"]["demosaic bit for bit"] = bool(torch.equal(
                    rgb, dm.demosaic_malvar(mosaic, "RGGB")))
                single = unsharp_mask(torch.clamp(dm.camera_to_srgb(dm.demosaic_malvar(
                    dm.apply_wb_mosaic(mosaic, "RGGB", wb), "RGGB"), cam), 0.0, 1.0),
                    amount)
                res["checks"]["raw_develop_sharded max abs err"] = float(
                    (raw_out - single).abs().max())
            del mosaic, mrows, rgb, raw_rows, raw_out
            torch.cuda.empty_cache()

            paths = sorted(os.path.join(dng_dir, n) for n in os.listdir(dng_dir))
            with acc.step():
                # An NCCL rank names no card: each takes cuda:LOCAL_RANK.
                rc, text, wall = mesh_batch(paths, out_dir,
                                            "cuda" if backend == "nccl" else dev)
            res["batch"] = (rc, text, wall)
        res["launches"] = acc.total
        res["twins"] = dict(twins)
        dist.barrier()
        status = ("ok", res)
    except BaseException:  # noqa: BLE001 - reported to the parent
        status = ("error", traceback.format_exc())
    finally:
        spatial._p2p = real_p2p
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(out_path, "wb") as f:
        pickle.dump(status, f)


def phase_mesh_two(dev, card, log, tmp, dng_dir, single_dir, backend="gloo",
                   devices=None, tag="phase 12b"):
    """Phase 12b: two gloo ranks (spawned processes) on the one card; or
    with ``backend`` "nccl" and ``devices`` one rank a card."""
    import multiprocessing
    import pickle

    devices = devices or [str(dev)] * MESH_RANKS
    ranks = len(devices)
    ctx = multiprocessing.get_context("spawn")
    init = os.path.join(tmp, f"rendezvous_{backend}")
    out_dir = os.path.join(tmp, f"mesh_out_{backend}")
    procs = [ctx.Process(target=mesh_rank, args=(r, ranks, init,
                                                 os.path.join(tmp, f"{backend}{r}.pkl"),
                                                 dng_dir, out_dir, devices[r], backend))
             for r in range(ranks)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    end = time.monotonic() + MESH_DEADLINE_S
    for p in procs:
        p.join(max(0.0, end - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    check(not hung, f"{tag}: ranks {hung} still running after {MESH_DEADLINE_S} s")
    results = []
    for r in range(ranks):
        path = os.path.join(tmp, f"{backend}{r}.pkl")
        check(os.path.exists(path), f"{tag}: rank {r} exited with "
              f"{procs[r].exitcode} and no result")
        with open(path, "rb") as f:
            status, value = pickle.load(f)
        check(status == "ok", f"{tag}: rank {r} failed:\n{value}")
        results.append(value)
    wall = time.perf_counter() - t0
    r0 = results[0]
    c = r0["checks"]
    h = BUCKET_HW[0]
    check(c["kernel == single-slab kernel"], f"{tag}: the sharded develop kernel "
          "differs from the single-slab kernel on the gathered geometry")
    check(c["warp max abs err"] <= WARP_TOL_PER_ROW * h,
          f"{tag}: the sharded warp is {c['warp max abs err']} off the single warp")
    check(c["demosaic bit for bit"], f"{tag}: demosaic_sharded differs")
    check(c["raw_develop_sharded max abs err"] <= RAW_SHARDED_TOL,
          f"{tag}: raw_develop_sharded {c['raw_develop_sharded max abs err']} off")
    check(c["histogram exact"], f"{tag}: histogram_sharded differs")
    for r, res in enumerate(results):
        check(not res["twins"], f"{tag}: twins ran on rank {r}: {res['twins']}")
        check(res["batch"][0] == 0, f"{tag}: rank {r}'s mesh batch exited "
              f"{res['batch'][0]}")
    names = same_files(out_dir, single_dir)
    rate = [ln for ln in r0["batch"][1].splitlines() if "MPix/s" in ln][0].strip()
    where = "on one card" if len(set(devices)) == 1 else "one a card"
    log(f"{tag}: {ranks} {backend} ranks {where}, 'sp' = {ranks}, "
        f"{BUCKET_HW[1]}x{h}: develop_spatial_sharded(use_kernel=True, distortion 35) "
        f"== the single-slab kernel on the gathered geometry bit for bit; warp max "
        f"abs err {c['warp max abs err']:.3g} (bound {WARP_TOL_PER_ROW * h:.3g} = "
        f"5e-5 x {h}/64); demosaic_sharded bit for bit; raw_develop_sharded max abs "
        f"err {c['raw_develop_sharded max abs err']:.3g} (bound {RAW_SHARDED_TOL}); "
        f"histogram_sharded exact")
    for r, res in enumerate(results):
        steps = "; ".join(
            f"{k} {ev:.3f} by CUDA events, {hst:.1f} host, of it {n} halo "
            f"exchanges {hms:.1f} host ({nb / 1e6:.3f} MB sent) [first call "
            f"{cold[0]:.3f} / {cold[1]:.1f} / {cold[2]:.1f}]"
            for k, (cold, (ev, hst, hms, nb, n)) in res["ms"].items())
        log(f"{tag}: rank {r}, warm (second call) ms: {steps} [{card}]")
    log(f"{tag}: mesh batch over {ranks} ranks: {rate}; {len(names)} files "
        f"== `batch --no-mesh --exact-path` byte for byte; rank walls "
        + ", ".join(f"{res['batch'][2] * 1e3:.1f}" for res in results)
        + f" ms; {tag} {wall:.1f} s [{card}]")
    total = {}
    for res in results:
        for k, v in res["launches"].items():
            total[k] = total.get(k, 0) + v
    return total


def transfer_times(dev, card, log):
    """utils/transfer against plain torch copies, host clock (median of 5,
    each call synchronized): put_np vs torch.from_numpy(a).to(dev) for a
    24 MP u16 mosaic (as its i16 bits), 24 MP u8 planes (a JPEG's) and 24 MP
    f32 planes, fetch_np vs
    .cpu() for a 24 MP JPEG scan's bytes and the 24 MP f32 render."""
    import torch

    from rawphotoforge_tpu_torch.utils.transfer import fetch_np, put_np

    def med(fn):
        ts = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ts[1:]))

    rng = np.random.default_rng(SEED + 14)
    h, w = BAYER_HW
    parts = []
    for name, arr in (("u16 mosaic", rng.integers(0, 65535, (h, w), dtype=np.uint16)
                       .view(np.int16)),
                      ("u8 planes", rng.integers(0, 255, (3, h, w), dtype=np.uint8)),
                      ("f32 planes", rng.random((3, h, w), dtype=np.float32))):
        ours = med(lambda: put_np(arr, device=dev))
        plain = med(lambda: torch.from_numpy(arr).to(dev))
        check(torch.equal(put_np(arr, device=dev).cpu(), torch.from_numpy(arr)),
              f"put_np changed the {name}")
        parts.append(f"upload {name} {arr.nbytes / 1e6:.1f} MB: put_np {ours:.2f} ms, "
                     f"torch .to() {plain:.2f} ms")
    for name, n in (("scan words", 14_484_000 // 4), ("f32 render", 3 * h * w)):
        t = torch.rand(n, device=dev)
        ours = med(lambda: fetch_np(t))
        plain = med(lambda: t.cpu().numpy())
        check(np.array_equal(fetch_np(t), t.cpu().numpy()), f"fetch_np changed the {name}")
        parts.append(f"fetch {name} {4 * n / 1e6:.1f} MB: fetch_np {ours:.2f} ms, "
                     f".cpu() {plain:.2f} ms")
        del t
    log("phase 12: transfers (host clock, median of 5): " + "; ".join(parts)
        + f" [{card}]")


def phase_mesh(dev, card, log):
    """Phase 12: the multi-device layer (parallel/mesh, parallel/spatial,
    `cli batch`'s mesh path) on the card: a world of one over NCCL here,
    then two gloo ranks in spawned processes."""
    import torch

    transfer_times(dev, card, log)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        dng_dir = write_mesh_dngs(tmp, log)
        t0 = time.perf_counter()
        one = phase_mesh_one(dev, card, log, tmp, dng_dir)
        log(f"phase 12a: {time.perf_counter() - t0:.1f} s; launches {one}")
        torch.cuda.empty_cache()
        two = phase_mesh_two(dev, card, log, tmp, dng_dir,
                             os.path.join(tmp, "single_out"))
        log(f"phase 12b: launches (both ranks) {two}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = {k: one.get(k, 0) + two.get(k, 0) for k in set(one) | set(two)}
    for k in ("develop", "bayer_kernel", "xtrans_kernel", "jpeg_blocks_kernel",
              "jpeg_huffman_kernel", "jpeg_pack_kernel"):
        check(launches.get(k, 0) > 0, f"phase 12 never launched {k}")
    log(f"phase 12: launches {launches}; twin calls 0")
    return launches


# -- the geometry-and-sharpen kernel (csrc/geometry.cu) ---------------------------

# (H, W, true extent or None) of the cases held bit for bit to the twin:
# whole 64x32 tiles, partial tiles, W % 4 != 0, a bucket pad (one of a row
# and a column among them), and axes of 1, 2 and 3 pixels, where the blur's
# reflect degrades to clipping.
GEOMETRY_HW = ((96, 128, None), (70, 131, (69, 130)), (128, 256, (100, 230)),
               (37, 50, (36, 49)), (33, 65, None), (1, 7, None), (2, 9, None),
               (3, 5, None), (7, 1, None), (6, 2, (5, 2)), (9, 3, (9, 2)))
# Lens-distortion slider values: the range's ends, near 0 on both sides, 0
# (the sharpen-only path), and 0.125, whose coordinates land within the snap
# threshold of whole pixels (snap_near_integer moves them).
GEOMETRY_DISTORTIONS = (-100.0, -40.0, -1.0, 0.0, 0.125, 1.0, 40.0, 100.0)
GEOMETRY_SHARPNESS = (0.0, 5.0, 100.0)
# The north star's bucket grid and true extent (PERF.md's 45 MP cells).
GEOMETRY_TIME_HW = (5504, 8192)
GEOMETRY_TIME_EXTENT = (5464, 8192)


def geometry_planes(rng, h, w, dev):
    """Seeded planes for the geometry kernel's cases: linear values in
    [0, 1), squared as a render's shadows are."""
    import torch

    return torch.from_numpy(rng.random((3, h, w), dtype=np.float32) ** 2).to(dev)


# -- the card fuzz (phase 13) ------------------------------------------------------

# Phase 13's seeds a part; tools/torch_card_fuzz.py runs 24, 8, 8, 4, 4, 4,
# 4, 4, 4 and 8 by default.
CARD_FUZZ_COUNTS = {"fused": 6, "slots": 2, "raw": 2, "xtrans": 1, "identity": 1,
                    "tone": 1, "sparse": 1, "prepacked": 1, "packed": 1, "geometry": 4}


def load_card_fuzz():
    """tools/torch_card_fuzz.py as a module (tools/ is not a package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_card_fuzz", os.path.join(ROOT, "tools", "torch_card_fuzz.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_card_fuzz(dev, card, log):
    """Phase 13: tools/torch_card_fuzz.py at CARD_FUZZ_COUNTS: random
    full-parameter draws through every kernel, each against its reference
    and bit for bit against its twin; any failed seed fails the run."""
    fuzz = load_card_fuzz()
    t0 = time.perf_counter()
    result = fuzz.run(dev, CARD_FUZZ_COUNTS, log=lambda m: log(f"phase 13: {m}"))
    for key, _, _ in fuzz.PARTS:
        part = result[key]
        worst = ", ".join(f"{k} {v:.3e}" for k, v in part.items()
                          if k.startswith("worst_"))
        log(f"phase 13: {key}: {part['seeds']} seeds, {part['fails']} failed"
            + (f"; {worst}" if worst else "")
            + f"; every kernel == its twin bit for bit: {part.get('twin_equal')}")
    check(result["ok"], "phase 13: a card-fuzz seed failed")
    log(f"phase 13: card fuzz passed in {time.perf_counter() - t0:.1f} s [{card}]")


# -- the 16-bit PNG open (phase 14) --------------------------------------------------

PNG_ORACLE_ROWS = 32   # rows the numpy unfilter checks at 24 MP (it loops in Python)
PNG_FLAGS = ["--exposure", "0.4", "--contrast", "15", "--shadow", "20",
             "--wb-temperature", "10", "--vignette", "25",
             "--brightness-curve", "0:0,20000:26000,65535:65535",
             "--hue-curve", "0:2000,40000:41000,65535:64000"]


def png_filter_types(n):
    """Row filters of phase 14's PNG: even rows Paeth, odd rows cycling
    None, Sub, Up, Average."""
    y = np.arange(n)
    return np.where(y % 2 == 0, 4, (y // 2) % 4).astype(np.uint8)


def phase_png_open(dev, card, log):
    """Phase 14: a 6000x4000 48-bit PNG with mixed row filters (half of
    them Paeth) opened as a user does (PhotoEditor.open on the card, then
    `cli develop` to a 16-bit PPM): the session's planes equal to the
    source's, the render against the exact-LUT anchor, the open's host ms
    split into inflate, native unfilter, the rest of the decode and upload;
    the numpy unfilter only on the first rows. Returns the path's
    launches."""
    import zlib

    import torch

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_fixtures as fx

    from rawphotoforge_tpu_torch import native
    from rawphotoforge_tpu_torch.app import cli
    from rawphotoforge_tpu_torch.engine.editor import FULL, PhotoEditor
    from rawphotoforge_tpu_torch.io import image_io

    h, w = PHOTO_HW
    rng = np.random.default_rng(SEED + 14)
    t0 = time.perf_counter()
    src = np.ascontiguousarray((np.clip(fx.scene(rng, h, w, texture=0.05), 0, 1)
                                * 65535).astype(np.uint16).transpose(1, 2, 0))
    raw = fx.png48_raw(src, png_filter_types)
    data = fx.png48_bytes(src, level=6, raw=raw)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_png_")
    path, out_ppm = os.path.join(tmp, "photo.png"), os.path.join(tmp, "out.ppm")
    with open(path, "wb") as f:
        f.write(data)
    paeth = float((png_filter_types(h) == 4).mean())
    log(f"phase 14: wrote a {w}x{h} 48-bit PNG ({len(data) / 1e6:.1f} MB, "
        f"{100 * paeth:.0f}% Paeth rows, the others None/Sub/Up/Average) in "
        f"{time.perf_counter() - t0:.1f} s")

    # The numpy oracle only on the first rows: at this size it takes minutes.
    stride, n = w * 6, PNG_ORACLE_ROWS
    grid = np.frombuffer(raw, np.uint8, count=n * (1 + stride)).reshape(n, 1 + stride)
    t = time.perf_counter()
    ora = image_io._png_unfilter(grid[:, 1:].copy(), grid[:, 0].copy(), 6)
    ora_ms = (time.perf_counter() - t) * 1e3
    nat = native.png_unfilter(grid[:, 1:].copy(), grid[:, 0].copy(), 6)
    want = src[:n].astype(">u2").view(np.uint8).reshape(n, stride)
    check(np.array_equal(ora, want) and np.array_equal(nat, want),
          "phase 14: the first rows' unfilter differs from the source")
    del raw, grid

    zero_launches()
    torch.cuda.synchronize()
    with StageClock(((zlib, "decompress", "inflate", None),
                     (native, "png_unfilter", "native unfilter", None),
                     (image_io, "decode_image_host", "host decode", None))) as clock:
        t = time.perf_counter()
        ed = PhotoEditor.open(path, device=dev)
        torch.cuda.synchronize()
        open_ms = (time.perf_counter() - t) * 1e3
    cli._set_edit_flags(ed, _parse_flags(PNG_FLAGS))
    t = time.perf_counter()
    render = ed.apply(FULL, cropped=False)
    torch.cuda.synchronize()
    render_ms = (time.perf_counter() - t) * 1e3
    rc = cli.main(["develop", path, out_ppm, *PNG_FLAGS, "--bit-depth", "16",
                   "--device", str(dev)])
    torch.cuda.synchronize()
    launches = launch_counts()  # the path's run ends here
    check(rc == 0, f"phase 14: cli develop exited {rc}")
    check(launches["develop"] > 0, "phase 14 never launched the develop kernel")

    inflate, unfilter = clock.ms["inflate"], clock.ms["native unfilter"]
    rest = clock.ms["host decode"] - inflate - unfilter
    log(f"phase 14: PhotoEditor.open of the {w}x{h} 48-bit PNG on the card: "
        f"{open_ms:.1f} ms = inflate {inflate:.1f} + native unfilter "
        f"{unfilter:.1f} ({h * stride / unfilter / 1e3:.0f} MB/s) + the rest of "
        f"the host decode {rest:.1f} + file read, upload and session "
        f"{open_ms - clock.ms['host decode']:.1f}; first FULL render "
        f"{render_ms:.1f} ms; the numpy unfilter took {ora_ms:.1f} ms for "
        f"{n} rows ({ora_ms * h / n / 1e3:.1f} s for the image at that rate) "
        f"[{card}]")

    # The session's own FULL planes, as the open decoded and uploaded them,
    # against the source through the same u16 -> linear conversion: a fault
    # in the decode or its hand-over (byte order, channels, scale) shows.
    check(ed.shape == (h, w), f"phase 14: session shape {ed.shape}")
    held = ed._original_at(FULL)[:, :h, :w]
    want = image_io._upload(src.transpose(2, 0, 1), 65535.0, True, dev)
    check(torch.equal(held, want),
          "phase 14: the session's planes differ from the source's")
    del held, want
    ed.use_kernel = False
    anchor = ed.apply(FULL, cropped=False)
    err = compare(render, anchor, what="phase 14: PNG render kernel vs exact-LUT anchor")
    ed.use_kernel = True
    with open(out_ppm, "rb") as f:
        got = f.read()
    check(got == image_io.encode_image(render, "PPM16"),
          "phase 14: cli develop's PPM differs from the in-process render")
    log(f"phase 14: the session's FULL planes == the source's (all {h * w * 3} "
        f"samples, bit for bit after the u16 -> linear upload); kernel "
        f"render vs exact-LUT anchor max abs err {err:.3e}, within the "
        f"assert_close rule; cli develop -> 16-bit PPM ({len(got)} bytes) == "
        f"the in-process render; launches {launches}")
    del ed, render, anchor, data, src
    shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


def _cli_lines(cmd, timeout):
    """Runs a CLI command line from the repository's root; (rc, stdout,
    stderr, host s)."""
    t0 = time.perf_counter()
    p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=timeout)
    return p.returncode, p.stdout, p.stderr, time.perf_counter() - t0


def mesh_cards(dev, card, log):
    """--mesh-cards, on a host with several cards: phase 12b's checks over
    NCCL, one rank a card and every rank on 'sp' (halos card to card, the
    histogram's all_reduce); then `cli batch` of the four DNGs as a user
    runs it: with no --device (it spawns one NCCL rank a card), under
    torchrun with --device cuda, and under torchrun with --device cuda:1,
    which each rank refuses. Every mesh batch's files equal those of
    `--no-mesh --exact-path`; the one-card loops' rates are printed beside
    the mesh's."""
    import torch

    from rawphotoforge_tpu_torch.app import cli

    n = torch.cuda.device_count()
    check(n >= 2, f"--mesh-cards needs several cards, this host shows {n}")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cards_")
    try:
        dng_dir = write_mesh_dngs(tmp, log)
        rates = {}
        for name, flags in (("exact", ["--no-mesh", "--exact-path"]),
                            ("fused", ["--no-mesh"]), ("fused warm", ["--no-mesh"])):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(["batch", dng_dir, os.path.join(tmp, name.replace(" ", "_")),
                               *flags, *RAW_FLAGS, "--device", str(dev)])
            check(rc == 0, f"--mesh-cards: the one-card loop {flags} exited {rc}")
            rates[name] = [ln for ln in buf.getvalue().splitlines() if "MPix/s" in ln][0]
        single = os.path.join(tmp, "exact")
        log(f"cards: one card, `--no-mesh --exact-path`: {rates['exact'].strip()}; "
            f"`--no-mesh` (fused RAW loop, warm): {rates['fused warm'].strip()} [{card}]")
        launches = phase_mesh_two(dev, card, log, tmp, dng_dir, single, backend="nccl",
                                  devices=[f"cuda:{r}" for r in range(n)], tag="cards")
        log(f"cards: launches ({n} NCCL ranks) {launches}")
        cli_cmd = [sys.executable, "-m", "rawphotoforge_tpu_torch.app.cli", "batch",
                   dng_dir]
        run = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               f"--nproc-per-node={n}", "-m", "rawphotoforge_tpu_torch.app.cli",
               "batch", dng_dir]
        for name, cmd in (("spawned", [*cli_cmd, os.path.join(tmp, "spawned"), *RAW_FLAGS]),
                          ("torchrun", [*run, os.path.join(tmp, "torchrun"), *RAW_FLAGS,
                                        "--device", "cuda"])):
            rc, out, err, wall = _cli_lines(cmd, 300)
            check(rc == 0 and f"batch (mesh x{n})" in out,
                  f"cards: `cli batch` ({name}) exited {rc}:\n{out[-2000:]}\n{err[-4000:]}")
            names = same_files(os.path.join(tmp, name), single)
            rate = [ln for ln in out.splitlines() if "MPix/s" in ln][0].strip()
            log(f"cards: `cli batch` {name} ({n} NCCL ranks): {rate}; {len(names)} "
                f"files == `--no-mesh --exact-path` byte for byte; process wall "
                f"{wall:.1f} s [{card}]")
        rc, out, err, _ = _cli_lines([*run, os.path.join(tmp, "one_card"), *RAW_FLAGS,
                                      "--device", "cuda:1"], 300)
        check(rc != 0 and "names one card" in err,
              f"cards: torchrun with --device cuda:1 exited {rc}:\n{err[-2000:]}")
        check(not os.listdir(os.path.join(tmp, "one_card")),
              "cards: the refused batch wrote files")
        log(f"cards: torchrun with --device cuda:1: every rank refused it (exit {rc}), "
            "no files")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def median_time(fn, windows=5, reps=20):
    """The median over ``windows`` CUDA-event windows of ``reps`` launches."""
    return sorted(time_events(fn, reps=reps) for _ in range(windows))[windows // 2]


def table_packed_once(fused, call):
    """median_time of ``call`` with ``fused.pack_table`` answering every
    call with the table it packed at the first: the develop wrapper's
    launch as it ships, without its per-call table packing."""
    real, memo = fused.pack_table, []

    def once(*a, **k):
        if not memo:
            memo.append(real(*a, **k))
        return memo[0]

    fused.pack_table = once
    try:
        return median_time(call)
    finally:
        fused.pack_table = real


def kernel_times(dev, card, jpeg_only=False):
    """Only the kernels' times of phases 4, 7 and 9 (median of 5 windows of
    20 launches; no bounds, no twin), from the package beside this file: a
    copy of this script in another checkout times that checkout's kernels
    on the same cases. Each develop case is timed once more with its table
    packed once (``..._table_packed_once``); the three JPEG kernels and the
    packed wire run at 24 MP and 45.4 MP on jpeg_scene (``jpeg_only``:
    only these, ``--kernel-times --jpeg``), with the pack call's parts
    alone; then the MID flood (both modes) and, but with ``--jpeg``, the
    45 MP geometry stage (``geometry_times``)."""
    import torch

    from rawphotoforge_tpu_torch.core.params import pack_params
    from rawphotoforge_tpu_torch.kernels import fused, geodesic, raw_pipeline as rp

    times = {}
    planes, cases = develop_cases(dev) if not jpeg_only else (None, [])
    for name, plist, masks, flags in cases:
        params = pack_params(plist, extent=PHOTO_HW, device=dev)

        def call():
            return fused.develop_post_geo_fused(planes, params, masks, **flags)

        times[f"develop_{name}"] = median_time(call)
        times[f"develop_{name}_table_packed_once"] = table_packed_once(fused, call)
    del planes, cases
    rng = np.random.default_rng(SEED + 5)
    for pattern, (h, w) in RAW_FRAMES if not jpeg_only else ():
        mosaic = torch.from_numpy(rng.random((h, w), dtype=np.float32)).to(dev)
        for variant, edit, flags in raw_variants():
            args = raw_args(dev, mosaic, edit)
            times[f"raw_{pattern}_{w}x{h}_{variant}"] = median_time(
                lambda: rp.raw_develop_fused(*args, pattern=pattern, **flags))
        del mosaic
        torch.cuda.empty_cache()
    for h, w in (BAYER_HW, NORTH_STAR_HW):
        case = jpeg_time_case(dev, np.random.default_rng(SEED + 9), h, w)
        for name in ("jpeg_blocks_kernel", "jpeg_huffman_kernel", "jpeg_pack_kernel",
                     "packed_wire"):
            call = case[name] if name == "packed_wire" else case[name][0]
            times[f"{name}_{w}x{h}"] = median_time(call)
        for part, call in pack_parts(dev, *case["pack_inputs"]).items():
            times[f"jpeg_pack_{part}_{w}x{h}"] = median_time(call)
        del case
        torch.cuda.empty_cache()
    h, w = MID_HW
    gv, gh = geodesic_costs(np.random.default_rng(SEED + 10), h, w, dev)
    d = torch.full((h, w), 1e9, device=dev)
    d[h // 2, w // 2] = 0.0
    times[f"flood_{h}x{w}"] = median_time(lambda: geodesic.flood(d, gv, gh))
    out = {"card": card, "root": ROOT, "ms": times}
    if not jpeg_only:
        del d, gv, gh
        out["geometry"] = geometry_times(dev, times)
    return out


def geometry_times(dev, times, planes=None):
    """The editor's geometry stage at 45 MP (GEOMETRY_TIME_HW, true extent
    GEOMETRY_TIME_EXTENT; lens distortion 40, sharpness 55, as a geodrag
    tick; ``planes`` seeded when not given): ``geometry_stage_<w>x<h>`` as
    this tree's editor runs it (the kernel through kernels/geometry) and
    ``geometry_plain_<w>x<h>``, the plain torch chain (its twin) on the
    card, into ``times``. A tree from before the kernel has neither and
    times its editor's chain for both. Returns the byte bound (the planes
    read once and written once at 3.35 TB/s), the stage's share of it and
    its kernel launches a call."""
    import torch

    h, w = GEOMETRY_TIME_HW
    ext, dist, amount = GEOMETRY_TIME_EXTENT, 40.0, 55.0 / 100.0 * 2.0
    if planes is None:
        planes = geometry_planes(np.random.default_rng(SEED + 11), h, w, dev)
    try:
        from rawphotoforge_tpu_torch.kernels import geometry
        stage, plain = geometry.geometry_sharpen, geometry.geometry_sharpen_ref
        counter = geometry.KERNEL_LAUNCHES
    except ImportError:  # the parent's _geo_at on a padded grid
        from rawphotoforge_tpu_torch.ops import develop as dev_ops
        from rawphotoforge_tpu_torch.ops.sharpen import unsharp_mask

        def plain(p, d, a, e):
            return unsharp_mask(dev_ops.replicate_true_edges(
                dev_ops.geometry_stage(p, d, e), *e), a)

        stage, counter = plain, {}
    before = counter.get("geometry_sharpen_kernel", 0)
    calls = 5 * (2 + 20)  # median_time's windows, each warmed twice
    key = f"{w}x{h}"
    times[f"geometry_stage_{key}"] = median_time(lambda: stage(planes, dist, amount, ext))
    launches = (counter.get("geometry_sharpen_kernel", 0) - before) / calls
    times[f"geometry_plain_{key}"] = median_time(lambda: plain(planes, dist, amount, ext))
    del planes
    torch.cuda.empty_cache()
    bound_ms = 2 * 3 * h * w * 4 / PEAK_BYTES_S * 1e3
    return {"bound_ms": bound_ms,
            "stage_pct_of_bound": 100.0 * bound_ms / times[f"geometry_stage_{key}"],
            "launches_per_call": launches}


def pack_parts(dev, words, bits):
    """The pack call's parts, each alone (the kernel through the library's
    C entry, whose signature a parent tree shares): the zeroed output
    (``torch.zeros`` of N * 52 + 1 words), the offsets (the cast, cumsum
    and subtraction) and the kernel on precomputed offsets."""
    import torch

    from rawphotoforge_tpu_torch.io import jpegbits
    from rawphotoforge_tpu_torch.kernels import jpeg_wire as jw

    n = bits.shape[0]
    size = n * jpegbits.BLOCK_WORDS + 1
    lib, stream = jw.library(), torch.cuda.current_stream(dev).cuda_stream
    bits64 = bits.to(torch.int64)
    offsets = torch.cumsum(bits64, 0) - bits64
    out = torch.zeros(size, dtype=torch.int32, device=dev)

    def offsets_call():
        b = bits.to(torch.int64)
        return torch.cumsum(b, 0) - b

    return {
        "zeros": lambda: torch.zeros(size, dtype=torch.int32, device=dev),
        "offsets": offsets_call,
        "kernel_alone": lambda: lib.rpf_jpeg_pack_launch(
            words.data_ptr(), bits.data_ptr(), offsets.data_ptr(), n, 1,
            out.data_ptr(), stream),
    }


# --develop-ab: since no profiler runs on the card's machine, the develop
# kernel built from a copy of csrc/ with one stage of the edit stack cut out
# (wrong output; its time tells the stage's share): the curve evaluation (a
# curve returns its input), the OKLab cube roots, the OETF's power, atan2's
# divisions, the vignette. Each cut replaces an exact line of csrc/, and the
# mode fails when that line is no longer there.
_AB_OETF = "RPF_F(1.055) * exp2f(log2f(fmaxf(c, 0.0f)) * RPF_F(1.0 / 2.4))"
_AB_CBRT = "return powf(fmaxf(x, 0.0f), RPF_F(1.0 / 3.0));"
_AB_CURVE = ("  const float u = clampf(floorf(v * kLutMax), 0.0f, kLutMax);\n"
             "  const float y = clampf(floorf(eval_curve(u, kn, co, S)), 0.0f, 65535.0f);")
AB_VARIANTS = {
    "shipped": [],
    "without_curves": [(_AB_CURVE, "  const float y = v;")],
    "without_cube_root": [(_AB_CBRT, "return x;")],
    "without_oetf_power": [(_AB_OETF, "c")],
    "without_atan2_divisions": [
        ("  const float t = lo / fmaxf(hi, RPF_F(1e-30));", "  const float t = lo * hi;"),
        ("  const float tr = hi ? (t - 1.0f) / (t + 1.0f) : t;", "  const float tr = hi ? t - 1.0f : t;")],
    "without_vignette": [("  if (strength == 0.0f) return;", "  return;")],
}
# --bayer-ab: the Bayer RAW kernel built with other step heights, a
# register cap for 5 resident blocks or other block sizes (each
# bit-identical to the shipped build; their times chose the shipped one),
# and with one stage cut out as
# in --develop-ab (wrong output): the unsharp, Malvar and the camera
# matrix, the vignette, the edit stack, and all four (the data movement
# alone, beside a torch copy of the same bytes).
_AB_BSH = "constexpr int BSW = 124, BSH = 16, BHALO = 4;"
_AB_T128 = ("constexpr int kThreads = 256;", "constexpr int kThreads = 128;")
_AB_MIN5 = ("__launch_bounds__(kThreads)\nbayer_kernel(",
            "__launch_bounds__(kThreads, 5)\nbayer_kernel(")
BAYER_AB_VARIANTS = {
    "shipped": [],
    "step8": [(_AB_BSH, _AB_BSH.replace("BSH = 16", "BSH = 8"))],
    "step32": [(_AB_BSH, _AB_BSH.replace("BSH = 16", "BSH = 32"))],
    "min_5_blocks": [_AB_MIN5],
    "blocks_of_128_step8": [_AB_T128, (_AB_BSH, _AB_BSH.replace("BSH = 16", "BSH = 8"))],
    "blocks_of_128": [_AB_T128],
    "blocks_of_512": [("constexpr int kThreads = 256;", "constexpr int kThreads = 512;")],
    "without_unsharp": [("  const float amt = tab[3];\n  const float strength",
                         "  const float amt = 0.0f;\n  const float strength")],
    "without_malvar_cam": [("        float cr, cg, cb;\n        cam_clip(cam, r, g, bb, cr, cg, cb);",
                            "        const float cr = c, cg = c, cb = c;")],
    "without_vignette": [("        rpf::vignette(r, g, b, strength, ay, rpf::pick(ax, j));\n", "")],
    "without_edit_stack": [("        rpf::edit_stack<IDENTITY>(r, g, b, t, sel);\n", "")],
}
BAYER_AB_VARIANTS["data_movement_only"] = [
    cut for k in ("without_unsharp", "without_malvar_cam", "without_vignette",
                  "without_edit_stack") for cut in BAYER_AB_VARIANTS[k]]


def ab_run(mod, source, fn_name, variants, cases, card, log, tag, rounds=3):
    """Times ``cases`` ([(name, call)]) with ``mod``'s kernel library built
    from a copy of csrc/ with each of ``variants`` (name -> [(exact text,
    replacement)]; all nvcc runs at once), the builds in turns (A B C ... C
    B A), beside each one's largest deviation from the shipped build."""
    import ctypes
    import pathlib

    import torch

    from rawphotoforge_tpu_torch.kernels import cuda_build

    mod.library()
    shipped = mod._LIB
    procs = {}
    for name, subs in variants.items():
        src = pathlib.Path(cuda_build.BUILD_DIR) / "ab" / tag / name
        src.mkdir(parents=True, exist_ok=True)
        texts = {f.name: f.read_text() for f in cuda_build.CSRC.iterdir()}
        for a, b in subs:
            check(any(a in t for t in texts.values()),
                  f"--{tag}: {a!r} is not in csrc/")
            texts = {n: t.replace(a, b) for n, t in texts.items()}
        for n, t in texts.items():
            (src / n).write_text(t)
        procs[name] = (src / "lib.so", subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(src / "lib.so"),
             str(src / source)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, p) in procs.items():
        out = p.communicate()[0]
        check(p.returncode == 0, f"--{tag}: {name} did not build:\n{out}")
        lib = ctypes.CDLL(str(so))
        fn = getattr(lib, fn_name)
        fn.argtypes = getattr(shipped, fn_name).argtypes
        fn.restype = ctypes.c_int
        libs[name] = lib
    try:
        for case, call in cases:
            times = {k: [] for k in libs}
            outs = {}
            order = list(libs) + list(reversed(libs))
            for _ in range(rounds):
                for k in order:
                    mod._LIB = libs[k]
                    times[k].append(time_events(call, reps=20))
            for k in libs:
                mod._LIB = libs[k]
                outs[k] = call()
            torch.cuda.synchronize()
            for k in libs:
                ts = sorted(times[k])
                dev_max = (outs[k] - outs["shipped"]).abs().max().item()
                log(f"{tag}: {case}: {k}: median {ts[len(ts) // 2]:.4f} ms "
                    f"(min {ts[0]:.4f}, max {ts[-1]:.4f}; {len(ts)} windows of 20 "
                    f"launches); max abs {dev_max:.3e} from shipped [{card}]")
    finally:
        mod._LIB = shipped


def develop_ab(dev, card, log):
    """The develop kernel with each of AB_VARIANTS on phase 4's cases."""
    from rawphotoforge_tpu_torch.core.params import pack_params
    from rawphotoforge_tpu_torch.kernels import fused

    planes, cases = develop_cases(dev)
    calls = []
    for case, plist, masks, flags in cases:
        params = pack_params(plist, extent=PHOTO_HW, device=dev)
        calls.append((case, lambda params=params, masks=masks, flags=flags:
                      fused.develop_post_geo_fused(planes, params, masks, **flags)))
    ab_run(fused, "develop.cu", "rpf_develop_launch", AB_VARIANTS, calls, card,
           log, "develop-ab")


def bayer_ab(dev, card, log):
    """The RAW kernel with each of BAYER_AB_VARIANTS on phase 7's Bayer
    cases."""
    import torch

    from rawphotoforge_tpu_torch.kernels import raw_pipeline as rp

    rng = np.random.default_rng(SEED + 5)
    calls = []
    for pattern, (h, w) in RAW_FRAMES[:2]:
        mosaic = torch.from_numpy(rng.random((h, w), dtype=np.float32)).to(dev)
        for variant, edit, flags in raw_variants():
            args = raw_args(dev, mosaic, edit)
            calls.append((f"{pattern}_{w}x{h}_{variant}",
                          lambda args=args, flags=flags, pattern=pattern:
                          rp.raw_develop_fused(*args, pattern=pattern, **flags)))
    ab_run(rp, "raw_develop.cu", "rpf_raw_develop_launch", BAYER_AB_VARIANTS,
           calls, card, log, "bayer-ab")
    # The kernel's bytes (the mosaic read, three planes written) moved by
    # torch's copy kernel: a mosaic broadcast into a [3, H, W] output.
    for h, w in (BAYER_HW, NORTH_STAR_HW):
        src = torch.rand((h, w), device=dev).expand(3, h, w)
        dst = torch.empty((3, h, w), device=dev)
        ms = median_time(lambda: dst.copy_(src))
        log(f"bayer-ab: RGGB_{w}x{h}: torch copy of the same bytes "
            f"({16 * h * w / 1e6:.1f} MB): median {ms:.4f} ms "
            f"({16 * h * w / ms / 1e9:.3f} TB/s) [{card}]")
        del src, dst


# --jpeg-ab: the JPEG Huffman kernel built with a stage cut out (wrong
# output; the time tells the stage's share): without its string assembly
# (the shared-memory atomicOrs), without its code lookups, without both.
_AB_HUFF_OR = ("      if (len_a) or_string(sw, z_a, zrl, zrl_len, body_a, blen_a, before & 0xFFFF);\n"
               "      if (len_b)\n"
               "        or_string(sw, z_b, zrl, zrl_len, body_b, blen_b, total_a + (before >> 16));\n")
_AB_HUFF_CODES = [("blen_a = lane_body(lane, prev_a, va, cd, body_a, bad);", "blen_a = 3; body_a = 5;"),
                  ("blen_b = lane_body(32 + lane, prev_b, vb, cd, body_b, bad);",
                   "blen_b = 3; body_b = 5;")]
JPEG_HUFFMAN_AB_VARIANTS = {
    "shipped": [],
    "without_string_assembly": [(_AB_HUFF_OR, "")],
    "without_code_lookups": _AB_HUFF_CODES,
    "without_both": [(_AB_HUFF_OR, ""), *_AB_HUFF_CODES],
}


def jpeg_ab(dev, card, log):
    """The Huffman kernel with each of JPEG_HUFFMAN_AB_VARIANTS at 24 MP,
    then a torch copy of the Huffman and blocks kernels' bytes (the data
    movement alone, on torch's copy kernel)."""
    import torch

    from rawphotoforge_tpu_torch.kernels import jpeg_wire as jw

    h, w = BAYER_HW
    case = jpeg_time_case(dev, np.random.default_rng(SEED + 9), h, w)
    huffman, blocks = case["jpeg_huffman_kernel"], case["jpeg_blocks_kernel"]
    ab_run(jw, "jpeg_encode.cu", "rpf_jpeg_huffman_launch", JPEG_HUFFMAN_AB_VARIANTS,
           [(f"huffman_{w}x{h}", lambda: huffman[0]()[0])], card, log, "jpeg-ab")
    for name, nbytes in (("huffman (interface)", huffman[3]), ("blocks", blocks[2])):
        src = torch.empty(nbytes // 8, dtype=torch.int32, device=dev)
        dst = torch.empty_like(src)
        ms = median_time(lambda: dst.copy_(src))
        log(f"jpeg-ab: {name}: torch copy of the same bytes ({nbytes / 1e6:.1f} MB, "
            f"half read, half written): median {ms:.4f} ms [{card}]")
        del src, dst


# --geodesic-ab: the flood kernel built from a copy of csrc/ with a stage
# cut out (wrong output; its time tells the stage's share): the walker's
# chain (each step's min and add without the carry, so the steps do not
# wait on each other), the copier's copies into shared memory, the
# storer's stores of the results; and with 2 visits of copies in flight
# instead of 3 (bit-identical).
_AB_FWD = "      dv[i] = min_nan(dv[i], carry);\n      carry = dv[i] + cv[i];"
_AB_BWD = "      dv[i] = min_nan(dv[i], carry + cv[i]);\n      carry = dv[i];"
_AB_NO_WALKER = [("    if (role == kWalker) {\n      const int len", "    if (false) {\n      const int len"),
                 ("    if (role == kWalker) {\n      put_back", "    if (false) {\n      put_back")]
_AB_NO_COPIER = ("      if (needs_copy(v + kAhead)) {", "      if (false) {")
_AB_NO_STORER = [("    } else if (v > 0) {\n      load_results", "    } else if (false) {\n      load_results"),
                 ("    } else if (role == kStorer && v > 0) {", "    } else if (false) {")]
GEODESIC_AB_VARIANTS = {
    "shipped": [],
    "without_chain": [(_AB_FWD, "      dv[i] = min_nan(dv[i], cv[i] + carry);"),
                      (_AB_BWD, "      dv[i] = min_nan(dv[i], cv[i] + carry);")],
    "without_copies": [("    copy16(sd + so + it * kStep, bd ? t.d + g : t.d, bd);\n"
                        "    copy16(sc + so + it * kStep, bc ? t.c + g : t.d, bc);\n", "")],
    "without_stores": [("    if (move_bytes<kRows>(t, k, it, lane, false))\n"
                        "      *reinterpret_cast<float4*>(t.d + go + it * 4 * t.P) = v[it];\n",
                        "")],
    "ahead_2": [("constexpr int kAhead = 3;", "constexpr int kAhead = 2;")],
    "walker_only": [_AB_NO_COPIER, *_AB_NO_STORER],
    "copier_only": [*_AB_NO_WALKER, *_AB_NO_STORER],
    "storer_only": [*_AB_NO_WALKER, _AB_NO_COPIER],
    "barriers_only": [*_AB_NO_WALKER, _AB_NO_COPIER, *_AB_NO_STORER],
}


def geodesic_ab(dev, card, log):
    """The flood kernel with each of GEODESIC_AB_VARIANTS: a MID flood (each
    call clones d, 4.4 MB, inside the time), a MID column and row sweep and
    a down sweep over one column of 2^15 cells (one chain)."""
    import torch

    from rawphotoforge_tpu_torch.kernels import geodesic

    h, w = MID_HW
    gv, gh = geodesic_costs(np.random.default_rng(SEED + 10), h, w, dev)
    d = geodesic.flood(torch_full_seeded(dev, h, w), gv, gh)
    n = 1 << 15
    one, gcv = torch.rand((n, 1), device=dev), torch.rand((n - 1, 1), device=dev)
    ab_run(geodesic, "geodesic.cu", "rpf_geodesic_flood_launch", GEODESIC_AB_VARIANTS,
           [(f"flood_{h}x{w}", lambda: geodesic.flood(d.clone(), gv, gh)),
            (f"down_{h}x{w}", lambda: _swept(geodesic, d, gv, gh, "down")),
            (f"right_{h}x{w}", lambda: _swept(geodesic, d, gv, gh, "right")),
            (f"down_{n}x1 (one chain)", lambda: _swept(
                geodesic, one, gcv, torch.empty((n, 0), device=dev), "down"))],
           card, log, "geodesic-ab")


# --geometry-ab: the geometry-and-sharpen kernel built with other output
# tiles and block sizes (each bit-identical to the shipped build; their
# times chose the shipped 64x32 tile of 256 threads), on a geodrag tick at
# 45 MP, the sharpen alone and the warp alone, then a torch copy of the
# same bytes (the data movement alone, on torch's copy kernel).
_AB_GEO_TILE = "constexpr int kTileW = 64, kTileH = 32, kRadius = 2"


def _geo_tile(w, h):
    return [(_AB_GEO_TILE, f"constexpr int kTileW = {w}, kTileH = {h}, kRadius = 2")]


GEOMETRY_AB_VARIANTS = {
    "shipped": [],
    "tile_32x16": _geo_tile(32, 16),
    "tile_32x32": _geo_tile(32, 32),
    "tile_64x16": _geo_tile(64, 16),
    "tile_128x16": _geo_tile(128, 16),
    "blocks_of_128": [("constexpr int kThreads = 256;", "constexpr int kThreads = 128;")],
    "blocks_of_512": [("constexpr int kThreads = 256;", "constexpr int kThreads = 512;")],
}


def geometry_ab(dev, card, log):
    """The geometry kernel with each of GEOMETRY_AB_VARIANTS at 45 MP."""
    import torch

    from rawphotoforge_tpu_torch.kernels import geometry

    h, w = GEOMETRY_TIME_HW
    planes = geometry_planes(np.random.default_rng(SEED + 11), h, w, dev)
    cases = [(f"{name}_{w}x{h}", lambda d=d, s=s: geometry.geometry_sharpen(
        planes, d, s / 100.0 * 2.0, GEOMETRY_TIME_EXTENT))
        for name, d, s in (("geodrag_tick", 40.0, 55.0), ("sharpen_only", 0.0, 55.0),
                           ("warp_only", 40.0, 0.0))]
    ab_run(geometry, "geometry.cu", "rpf_geometry_sharpen_launch", GEOMETRY_AB_VARIANTS,
           cases, card, log, "geometry-ab")
    dst = torch.empty_like(planes)
    ms = median_time(lambda: dst.copy_(planes))
    log(f"geometry-ab: torch copy of the planes ({planes.numel() * 8 / 1e9:.3f} GB, half "
        f"read, half written): median {ms:.4f} ms [{card}]")


def torch_full_seeded(dev, h, w):
    """A MID distance map: 1e9 everywhere but a seed at the centre."""
    import torch

    d = torch.full((h, w), 1e9, device=dev)
    d[h // 2, w // 2] = 0.0
    return d


def _swept(geodesic, d, gv, gh, direction):
    out = d.clone()
    geodesic.sweep(out, gv, gh, direction)
    return out


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
    from rawphotoforge_tpu_torch import native
    from rawphotoforge_tpu_torch.kernels import geodesic, jpeg_wire, raw_pipeline

    # One build per source, all started together (a copy of this script in
    # a tree from before the geometry kernel builds the others).
    libs = (fused, raw_pipeline, jpeg_wire, geodesic, native)
    try:
        from rawphotoforge_tpu_torch.kernels import geometry
        libs += (geometry,)
    except ImportError:
        pass
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:
        for fut in [pool.submit(m.library) for m in libs]:
            fut.result()
    log(f"phase 1: builds done in {time.perf_counter() - t0:.2f} s")
    for mod in libs:
        build = mod.BUILD
        log(f"phase 1: built {os.path.relpath(build['path'], ROOT)} in "
            f"{build['seconds']:.2f} s")
        for line in build["log"].splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"phase 1: ptxas: {line.strip()}")

    if "--kernel-times" in sys.argv:
        print(json.dumps(kernel_times(dev, card, jpeg_only="--jpeg" in sys.argv)))
        return 0
    if "--develop-ab" in sys.argv:
        develop_ab(dev, card, log)
        return 0
    if "--bayer-ab" in sys.argv:
        bayer_ab(dev, card, log)
        return 0
    if "--jpeg-ab" in sys.argv:
        jpeg_ab(dev, card, log)
        return 0
    if "--geodesic-ab" in sys.argv:
        geodesic_ab(dev, card, log)
        return 0
    if "--geometry-ab" in sys.argv:
        geometry_ab(dev, card, log)
        return 0
    if "--mesh-cards" in sys.argv:
        mesh_cards(dev, card, log)
        return 0
    phase_device_functions(dev, log)
    worst = phase_kernel_vs_twin(dev, log)
    ed, launches, geo_launches = phase_main_path(dev, log)
    geometry_row = phase_geometry_kernel(dev, ed, card, log)
    timing = phase_timing(dev, ed, card, log)
    del ed
    torch.cuda.empty_cache()
    raw_worst = phase_raw_kernel_vs_twin(dev, log)
    jpeg_rows = phase_jpeg_kernels(dev, card, log)
    batch_launches, raw_dir, raw_tmp = phase_raw_main_path(dev, log)
    raw_timing = phase_raw_timing(dev, card, raw_dir, raw_tmp, log)
    vendor_launches, vendor_worst, vendor_files, vendor_tmp = (
        phase_vendor_main_path(dev, log))
    staged_vendor_files(vendor_files, vendor_tmp, dev, card, log)
    geodesic_row = phase_geodesic_kernel(dev, card, log)
    mask_launches = phase_masks_and_exports(
        dev, card, log, os.path.join(raw_dir, "bayer24.dng"),
        vendor_files["sony24.arw"][0])
    server_launches = phase_server(dev, card, log, os.path.join(raw_dir, "bayer24.dng"))
    shutil.rmtree(raw_tmp, ignore_errors=True)
    shutil.rmtree(vendor_tmp, ignore_errors=True)
    mesh_launches = phase_mesh(dev, card, log)
    phase_card_fuzz(dev, card, log)
    png_launches = phase_png_open(dev, card, log)
    # Each kernel's launches, summed over the main paths that drive it (each
    # counted from zero just before its path and read just after).
    log(f"launches by path: develop frame {launches} (geometry {geo_launches}), "
        f"RAW batch {batch_launches}, "
        f"vendor path {vendor_launches}, masks and exports {mask_launches}, "
        f"server {server_launches}, multi-device {mesh_launches}, "
        f"16-bit PNG open {png_launches}")
    launches += (vendor_launches["develop"] + mask_launches["develop"]
                 + server_launches["develop"] + mesh_launches["develop"]
                 + png_launches["develop"])
    for k in batch_launches:
        batch_launches[k] += (vendor_launches[k] + mask_launches[k]
                              + server_launches.get(k, 0) + mesh_launches.get(k, 0))
    mask_launches["geodesic_sweep_kernel"] += (server_launches["geodesic_sweep_kernel"]
                                               + mesh_launches.get("geodesic_sweep_kernel", 0))
    for k in ("bayer_kernel", "xtrans_kernel"):
        raw_worst[k.split("_")[0]] = max(raw_worst[k.split("_")[0]], vendor_worst[k])

    main_case = timing["m4_regional"]
    bayer_case = raw_timing[f"RGGB_{BAYER_HW[1]}x{BAYER_HW[0]}_batch_flags"]
    xtrans_case = raw_timing[f"XTRANS_{XTRANS_HW[1]}x{XTRANS_HW[0]}_batch_flags"]
    raw_src = "rawphotoforge_tpu_torch/csrc/raw_develop.cu"
    raw_tpu = "rawphotoforge_tpu/kernels/raw_pipeline.py:485"
    rows = [("develop_post_geo_fused", "rawphotoforge_tpu_torch/csrc/develop.cu",
             "rawphotoforge_tpu/kernels/fused.py:488", launches,
             max(worst.values()), main_case),
            ("raw_develop_fused/bayer_kernel", raw_src, raw_tpu,
             batch_launches["bayer_kernel"], raw_worst["bayer"], bayer_case),
            ("raw_develop_fused/xtrans_kernel", raw_src, raw_tpu,
             batch_launches["xtrans_kernel"], raw_worst["xtrans"], xtrans_case)]
    # The JPEG kernels replace jnp code (no Pallas kernel): each is held to
    # its twin bit for bit, so its largest difference is 0.
    jpeg_jnp = {"jpeg_blocks_kernel": "rawphotoforge_tpu/io/jpegbits.py:668 "
                "(jnp, no Pallas: jpegenc.py:194 blockify)",
                "jpeg_huffman_kernel": "rawphotoforge_tpu/io/jpegbits.py:368 "
                "(jnp, no Pallas: _lanes, _assemble, prepack)",
                "jpeg_pack_kernel": "rawphotoforge_tpu/io/jpegbits.py:502 "
                "(jnp, no Pallas: packed)"}
    rows += [(name, "rawphotoforge_tpu_torch/csrc/jpeg_encode.cu", jpeg_jnp[name],
              batch_launches[name], 0.0, row) for name, row in jpeg_rows.items()]
    # The geodesic flood kernel replaces a lax.scan (no Pallas kernel); it
    # is held to its twin bit for bit. Its times are one flood at MID (one
    # launch); library_ms is torch.cumsum + torch.cummin for the same flood
    # (two calls a sweep). bound_ms is the contract's bytes-or-operations
    # bound; phase 10 logs the chain bound, which sets the flood, beside it.
    rows.append(("geodesic_sweep_kernel", "rawphotoforge_tpu_torch/csrc/geodesic.cu",
                 "rawphotoforge_tpu/ops/masking.py:123-199 (lax.scan, no Pallas)",
                 mask_launches["geodesic_sweep_kernel"], 0.0, geodesic_row))
    # The geometry kernel replaces jnp code (no Pallas kernel) and is held to
    # its twin, the plain chain, bit for bit (phase 3b). Its times: a
    # geodrag tick at 45 MP; bound_ms the planes read once and written once.
    rows.append(("geometry_sharpen_kernel", "rawphotoforge_tpu_torch/csrc/geometry.cu",
                 "rawphotoforge_tpu/ops/geometry.py lens_distortion + ops/sharpen.py "
                 "unsharp_mask (jnp, no Pallas)",
                 geo_launches + server_launches["geometry_sharpen_kernel"]
                 + mesh_launches.get("geometry_sharpen_kernel", 0),
                 geometry_row["max_abs_err"], geometry_row))
    table = {"kernels": [{
        "name": name, "route": "cuda", "source": src, "replaces": tpu,
        "launches": n, "max_abs_err": err, "ms": case["ms"],
        "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
        "bound_by": case["bound_by"], "library_ms": case.get("library_ms"),
    } for name, src, tpu, n, err, case in rows]}
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(table))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
