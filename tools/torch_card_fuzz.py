#!/usr/bin/env python3
"""Kernel fuzz of the PyTorch/CUDA port on the card: the port's counterpart
of tools/tpu_fuzz.py, part for part.

Random full-parameter draws (tests/torch_fixtures.random_params, the same
Generator calls as tests/test_fuzz.py's) through the hand-written CUDA
kernels, each held against the port's references and, bit for bit, against
its plain torch twin on the same inputs:

 1. the develop kernel (csrc/develop.cu) at 256x512 with M in {1, 2, 3}
    masks against the exact-LUT anchor (ops/develop.develop_post_geo) under
    assert_fuzz_close and assert_staircase_explained;
 1b. per-mask default-curve slot elision (the packed params' slot table),
    bit for bit the general kernel (the same params with the table cleared);
 2. the Bayer RAW kernel (csrc/raw_develop.cu) against the composed path
    (demosaic -> unsharp -> develop kernel);
 3. the X-Trans RAW kernel, the same on the interior (the outer 14 px, as
    in the TPU tool);
 4. identity_oklch and 5. a custom tone curve on the identity_oklch
    variant, within 3e-3 of the general kernel;
 6-8. the nibble, prepacked and packed JPEG wires at 512x768: each device
    stream equal to its exact numpy mirror seeded from the device blocks,
    the three files byte-identical (full grid and a padded extent), and
    the blocks, Huffman and pack kernels (csrc/jpeg_encode.cu) equal to
    their twins;
 9. the geometry-and-sharpen kernel (csrc/geometry.cu) on random frames,
    extents, lens-distortion and sharpness draws, bit for bit its twin.

Run from the root of a checkout, on a machine with an NVIDIA card:

    python3 tools/torch_card_fuzz.py --out CARDFUZZ.json

It exits non-zero on any failed seed. The artifact's ``sources`` is the
SHA-256 of the files the run executed (``sources_digest``: the port's
package, this tool, tests/torch_fixtures.py and chip_smoke.py), so a
checkout can be matched to it without git. chip_smoke.py runs the parts
at reduced counts (``run``). Imports neither jax nor the JAX package.
"""

from __future__ import annotations

import argparse
import datetime
import hashlib
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (ROOT, os.path.join(ROOT, "tests")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from rawphotoforge_tpu_torch import native  # noqa: E402  (after the path)
from rawphotoforge_tpu_torch.core.params import (  # noqa: E402
    CurveState, default_curve_slots, pack_params)
from rawphotoforge_tpu_torch.io import jpegbits, jpegenc  # noqa: E402
from rawphotoforge_tpu_torch.kernels import fused, geometry, raw_pipeline  # noqa: E402
from rawphotoforge_tpu_torch.kernels import jpeg_wire as jw  # noqa: E402
from rawphotoforge_tpu_torch.ops import demosaic as dm  # noqa: E402
from rawphotoforge_tpu_torch.ops import develop as anchor  # noqa: E402
from rawphotoforge_tpu_torch.ops.sharpen import unsharp_mask  # noqa: E402
from rawphotoforge_tpu_torch.utils.transfer import fetch_np  # noqa: E402
from torch_fixtures import (  # noqa: E402
    assert_fuzz_close, assert_staircase_explained, fuzz_deviation, no_shortcuts,
    random_params)

H, W = 256, 512          # the develop parts' frame (tools/tpu_fuzz.py)
RAW_HW = (192, 512)
XTRANS_HW = (192, 768)
XTRANS_TRIM = 14
WIRE_HW = (512, 768)     # the JPEG wires' frame
WIRE_PAD = (37, 11)      # rows and columns cut off for the padded extent
QUALITY = 92
OKLCH_BOUND = 3e-3       # identity_oklch's documented bound
# Seeds a part, as tools/tpu_fuzz.py's defaults (--seeds 24, --raw-seeds 8;
# the geometry part, which that tool lacks, takes --raw-seeds too).
DEFAULT_COUNTS = {"fused": 24, "slots": 8, "raw": 8, "xtrans": 4,
                  "identity": 4, "tone": 4, "sparse": 4, "prepacked": 4,
                  "packed": 4, "geometry": 8}
XYZ_TO_CAM = np.array([[0.8, -0.1, -0.05], [-0.3, 1.1, 0.15],
                       [-0.05, 0.15, 0.65]])


def _summary(seeds, keys=("max", "median")):
    out = {"seeds": len(seeds), "fails": sum(not s["ok"] for s in seeds)}
    for k in keys:
        vals = [s[k] for s in seeds if k in s]
        if vals:
            out[f"worst_{k}_dev"] = max(vals)
    out["twin_equal"] = all(s["twin_equal"] for s in seeds)
    out["per_seed"] = seeds
    return out


# -- the develop kernel ---------------------------------------------------------

def part_fused(dev, n, log):
    """Part 1: the develop kernel against the exact-LUT anchor and its twin."""
    seeds = []
    for seed in range(n):
        r = np.random.default_rng(seed + 1000)
        planes = torch.from_numpy(r.random((3, H, W)).astype(np.float32)).to(dev)
        masks = torch.from_numpy(np.stack(
            [np.ones((H, W), np.float32)]
            + [(r.random((H, W)) > 0.5).astype(np.float32)
               for _ in range(seed % 3)])).to(dev)
        params = pack_params([random_params(r, allow_geometry=False)
                              for _ in range(masks.shape[0])], device=dev)
        ours = fused.develop_post_geo_fused(planes, params, masks)
        twin = fused.develop_post_geo_fused_ref(planes, params, masks)
        ref = anchor.develop_post_geo(planes, params, masks)
        rec = {"seed": seed, "masks": int(masks.shape[0]),
               "twin_equal": torch.equal(ours, twin), **fuzz_deviation(ours, ref)}
        try:
            assert_fuzz_close(ours, ref)
            rec["flip_frac"], _ = assert_staircase_explained(
                ours, planes, params, masks)
            rec["ok"] = rec["twin_equal"]
            note = f"max={rec['max']:.2e}, flips={rec['flip_frac']:.2%}"
        except AssertionError as e:
            rec["ok"], note = False, f"FAIL {e}"
        log(f"develop seed {seed}: {'ok' if rec['ok'] else 'FAIL'} "
            f"(M={rec['masks']}, {note}, twin_equal={rec['twin_equal']})")
        seeds.append(rec)
    return _summary(seeds)


def part_slots(dev, n, log):
    """Part 1b: per-mask default-curve slot elision, bit for bit the
    general kernel (and the twin)."""
    seeds = []
    for seed in range(n):
        r = np.random.default_rng(seed + 9000)
        m = 2 + seed % 3
        edits = []
        for _ in range(m):
            e = random_params(r, allow_geometry=False)
            for slot in range(4):
                if r.random() < 0.6:
                    e.curves[slot] = CurveState()
            edits.append(e)
        slots = default_curve_slots(edits)
        planes = torch.from_numpy(r.random((3, H, W)).astype(np.float32)).to(dev)
        masks = torch.from_numpy(np.stack(
            [np.ones((H, W), np.float32)]
            + [(r.random((H, W)) > 0.5).astype(np.float32)
               for _ in range(m - 1)])).to(dev)
        params = pack_params(edits, device=dev)
        general = fused.develop_post_geo_fused(planes, no_shortcuts(params), masks)
        elided = fused.develop_post_geo_fused(planes, params, masks)
        twin = fused.develop_post_geo_fused_ref(planes, params, masks)
        n_diff = int((general != elided).sum())
        twin_eq = torch.equal(elided, twin)
        ok = n_diff == 0 and twin_eq and params.default_slots == slots
        n_elided = sum(sum(sl) for sl in slots)
        log(f"slots seed {seed}: {'ok' if ok else 'FAIL'} (M={m}, "
            f"{n_elided}/{4 * m} slots default, diff_px={n_diff}, "
            f"twin_equal={twin_eq})")
        seeds.append({"seed": seed, "masks": m, "ok": ok, "twin_equal": twin_eq,
                      "slots": [list(map(bool, sl)) for sl in slots],
                      "diff_px": n_diff})
    return _summary(seeds, keys=())


# -- the RAW kernels ----------------------------------------------------------------

def _raw_part(dev, n, log, xtrans):
    """Parts 2 and 3: the one-pass RAW kernel against the composed path
    (demosaic -> unsharp -> develop kernel) and its twin."""
    cam = dm.cam_matrix_to_srgb(XYZ_TO_CAM)
    seeds = []
    for seed in range(n):
        r = np.random.default_rng(seed + (3000 if xtrans else 2000))
        pattern = "XTRANS" if xtrans else ("RGGB", "BGGR", "GRBG", "GBRG")[seed % 4]
        hw = XTRANS_HW if xtrans else RAW_HW
        mosaic = torch.from_numpy(r.random(hw).astype(np.float32)).to(dev)
        wb = np.array([r.uniform(1.2, 2.4), 1.0, r.uniform(1.1, 2.0)],
                      dtype=np.float32)
        params = pack_params([random_params(r, allow_geometry=False)], device=dev)
        sharpen = np.float32(r.uniform(0.0, 1.5))
        args = (mosaic, tuple(float(g) for g in wb), cam, params, sharpen)
        one_pass = raw_pipeline.raw_develop_fused(*args, pattern=pattern)
        twin = raw_pipeline.raw_develop_fused_ref(*args, pattern=pattern)
        rgb = dm.develop_raw(mosaic, args[1], cam, pattern=pattern,
                             method="residual" if xtrans else "malvar")
        if sharpen != 0.0:
            rgb = unsharp_mask(rgb, float(sharpen))
        composed = fused.develop_post_geo_fused(rgb, params, None)
        if xtrans:
            t = XTRANS_TRIM
            stats = fuzz_deviation(one_pass[:, t:-t, t:-t], composed[:, t:-t, t:-t])
        else:
            stats = fuzz_deviation(one_pass, composed)
        twin_eq = torch.equal(one_pass, twin)
        ok = (stats["median"] < 1e-4 and stats["mean"] < 2e-3
              and stats["max"] < 0.08 and twin_eq)
        log(f"{'xtrans' if xtrans else 'raw'} seed {seed}: "
            f"{'ok' if ok else 'FAIL'} ({pattern}, sharpen={float(sharpen):.2f}, "
            f"median={stats['median']:.2e} mean={stats['mean']:.2e} "
            f"max={stats['max']:.2e}, twin_equal={twin_eq})")
        rec = {"seed": seed, "sharpen": float(sharpen), "ok": ok,
               "twin_equal": twin_eq, **stats}
        if not xtrans:
            rec = {"seed": seed, "pattern": pattern, **rec}
        seeds.append(rec)
    return _summary(seeds)


def part_raw(dev, n, log):
    return _raw_part(dev, n, log, xtrans=False)


def part_xtrans(dev, n, log):
    return _raw_part(dev, n, log, xtrans=True)


# -- the OKLCH shortcuts ------------------------------------------------------------

def _oklch_part(dev, n, log, tone_curve):
    """Part 4 (default curves, identity_oklch against the full OKLCH path)
    and part 5 (a custom brightness curve on the identity_oklch variant
    against the general kernel): within 3e-3, each call equal to its twin."""
    seeds = []
    for seed in range(n):
        r = np.random.default_rng(seed + (5000 if tone_curve else 4000))
        planes = torch.from_numpy(r.random((3, H, W)).astype(np.float32)).to(dev)
        p = random_params(r, allow_geometry=False)
        for slot in range(1 if tone_curve else 0, 4):
            p.curves[slot].control_x = None
            p.curves[slot].control_y = None
            p.curves[slot].raw_lut = None
        if tone_curve:
            xs = np.sort(r.choice(65533, size=2, replace=False) + 1)
            p.set_curve(0, [0, int(xs[0]), int(xs[1]), 65535],
                        sorted(int(v) for v in r.integers(0, 65536, size=4)))
        params = pack_params([p], device=dev)
        # The tone-curve part's reference is the general kernel, the other's
        # the full OKLCH path with the default-curve shortcuts.
        full_params = no_shortcuts(params) if tone_curve else params
        full = fused.develop_post_geo_fused(planes, full_params, None)
        fast = fused.develop_post_geo_fused(planes, params, None,
                                            identity_oklch=True)
        twin_eq = (torch.equal(full, fused.develop_post_geo_fused_ref(
            planes, full_params, None)) and torch.equal(
            fast, fused.develop_post_geo_fused_ref(planes, params, None,
                                                   identity_oklch=True)))
        mx = float((full - fast).abs().max().item())
        ok = mx < OKLCH_BOUND and twin_eq and fused.skips_oklch(params, True)
        name = "tone-curve" if tone_curve else "identity_oklch"
        log(f"{name} seed {seed}: {'ok' if ok else 'FAIL'} (max={mx:.2e}, "
            f"twin_equal={twin_eq})")
        seeds.append({"seed": seed, "ok": ok, "twin_equal": twin_eq, "max": mx})
    return _summary(seeds, keys=("max",))


def part_identity(dev, n, log):
    return _oklch_part(dev, n, log, tone_curve=False)


def part_tone(dev, n, log):
    return _oklch_part(dev, n, log, tone_curve=True)


# -- the JPEG wires -----------------------------------------------------------------

def _wire_planes(dev, r):
    base = r.random((3, 1, 1)).astype(np.float32)
    planes = np.clip(base + 0.15 * r.standard_normal(
        (3, *WIRE_HW)).astype(np.float32), 0.0, 1.0)
    return torch.from_numpy(planes).to(dev)


def _jpeg_kernels(planes, true_hw=None):
    """The three JPEG kernels on ``planes`` against their twins on the same
    inputs: (blocks, equal to the twins)."""
    qlum, qchr = jpegenc._quant_tables(QUALITY)
    _, h, w = planes.shape
    th, tw = true_hw or (h, w)
    blocks = jw.blocks(planes, qlum, qchr, (th, tw))
    eq = torch.equal(blocks, jpegenc.blockify(planes, qlum, qchr, (th, tw)))
    grid = (-(-w // 16), -(-th // 16), -(-tw // 16))
    words, bits, bad = jw.huffman(blocks, *grid)
    mask = jpegbits._true_mask(blocks.shape[0], *grid, blocks.device)
    rbits, rwords, _, rbad = jpegbits.prepack(
        jpegbits._dc_delta_masked(blocks, mask), mask)
    eq &= (torch.equal(words, jpegenc._i32_bits(rwords))
           and torch.equal(bits, rbits.to(torch.int32)) and int(bad) == int(rbad))
    w64, b64 = words.to(torch.int64) & 0xFFFFFFFF, bits.to(torch.int64)
    for packed, twin in ((True, jpegbits.scan_from_words),
                         (False, jpegbits.concat_words)):
        eq &= torch.equal(jw.pack(words, bits, packed=packed),
                     jpegenc._i32_bits(twin(w64, b64)))
    return blocks, eq


def _padded_files(planes, encode):
    """(``encode``'s file, the nibble wire's file) of the padded extent."""
    true = (WIRE_HW[0] - WIRE_PAD[0], WIRE_HW[1] - WIRE_PAD[1])
    return (encode(planes, QUALITY, true_shape=true),
            jpegenc._encode_sparse_device(planes, QUALITY, true_shape=true))


def part_sparse(dev, n, log):
    """Part 6: the nibble wire. The device compaction (dc_delta +
    _sparsify on the blocks kernel's output) equals its exact numpy mirror
    seeded from the device blocks; the native coder gives one file from
    either; the nibble wire's file is that file."""
    h, w = WIRE_HW
    seeds = []
    for seed in range(n):
        r = np.random.default_rng(seed + 6000)
        planes = _wire_planes(dev, r)
        blocks, twin_eq = _jpeg_kernels(planes)
        ref = jpegenc._sparsify_np(jpegenc._dc_delta_np(fetch_np(blocks)))
        counts, bitmaps, vals, esc, nv, ne = jpegenc._sparsify(
            jpegenc.dc_delta(blocks))
        host_bitmaps = fetch_np(jpegenc._i32_bits(bitmaps)).view(np.uint32)
        host = (fetch_np(counts), host_bitmaps, fetch_np(vals), fetch_np(esc))
        stream_ok = (nv == ref[4] and ne == ref[5]
                     and all(np.array_equal(a, b) for a, b in zip(host, ref[:4])))
        from_device = native.jpeg_encode_sparse(*host, h, w, quality=QUALITY)
        from_mirror = native.jpeg_encode_sparse(*ref[:4], h, w, quality=QUALITY)
        wire_file = jpegenc._encode_sparse_device(planes, QUALITY)
        ok = stream_ok and from_device == from_mirror == wire_file and twin_eq
        density = nv / (host[0].size * 64)
        log(f"nibble seed {seed}: {'ok' if ok else 'FAIL'} (density={density:.2f}, "
            f"escapes={ne}, stream_ok={stream_ok}, twin_equal={twin_eq})")
        seeds.append({"seed": seed, "ok": ok, "twin_equal": twin_eq,
                      "n_values": nv, "n_escapes": ne, "density": density})
    return _summary(seeds, keys=())


def part_prepacked(dev, n, log):
    """Part 7: the prepacked wire. Its device bit lengths and words equal
    the serial oracle seeded from the device blocks; its file equals the
    nibble wire's, full grid and padded extent."""
    h, w = WIRE_HW
    qlum, qchr = jpegenc._quant_tables(QUALITY)
    seeds = []
    for seed in range(n):
        r = np.random.default_rng(seed + 7000)
        planes = _wire_planes(dev, r)
        blocks, twin_eq = _jpeg_kernels(planes)
        ref_lens, ref_words = jpegbits.prepacked_np(
            jpegenc._dc_delta_np(fetch_np(blocks)))
        bits, flat, totals = jpegbits.wire(planes, qlum, qchr)
        n_words = int(totals[0])
        hl = fetch_np(bits).astype(np.uint16)
        hw = jpegbits.fetch_scan(flat, n_words)
        stream_ok = (np.array_equal(hl, ref_lens) and n_words == ref_words.size
                     and np.array_equal(hw, ref_words))
        from_device = native.jpeg_encode_prepacked(hl, hw, h, w, quality=QUALITY)
        from_nibble = jpegenc._encode_sparse_device(planes, QUALITY)
        padded, padded_nb = _padded_files(planes, jpegbits.encode_prepacked_device)
        ok = (stream_ok and from_device == from_nibble and padded == padded_nb
              and twin_eq)
        total_bits = int(hl.astype(np.int64).sum())
        log(f"prepacked seed {seed}: {'ok' if ok else 'FAIL'} (bits={total_bits}, "
            f"words={n_words}, stream_ok={stream_ok}, "
            f"full_eq={from_device == from_nibble}, padded_eq={padded == padded_nb}, "
            f"twin_equal={twin_eq})")
        seeds.append({"seed": seed, "ok": ok, "twin_equal": twin_eq,
                      "total_bits": total_bits, "n_words": n_words})
    return _summary(seeds, keys=())


def part_packed(dev, n, log):
    """Part 8: the packed wire. Its device scan equals the serial oracle
    word for word; its file equals the nibble wire's, full grid and padded
    extent."""
    h, w = WIRE_HW
    qlum, qchr = jpegenc._quant_tables(QUALITY)
    seeds = []
    for seed in range(n):
        r = np.random.default_rng(seed + 8000)
        planes = _wire_planes(dev, r)
        blocks, twin_eq = _jpeg_kernels(planes)
        ref_words, ref_bits = jpegbits.packed_np(
            jpegenc._dc_delta_np(fetch_np(blocks)))
        scan, totals = jpegbits.wire_packed(planes, qlum, qchr)
        n_words, n_bits, bad = (int(x) for x in totals.tolist())
        hw = jpegbits.fetch_scan(scan, n_words)
        stream_ok = (bad == 0 and n_bits == ref_bits
                     and n_words == ref_words.size and np.array_equal(hw, ref_words))
        from_device = native.jpeg_encode_packed(hw, n_bits, h, w, quality=QUALITY)
        from_nibble = jpegenc._encode_sparse_device(planes, QUALITY)
        padded, padded_nb = _padded_files(planes, jpegbits.encode_packed_device)
        ok = (stream_ok and from_device == from_nibble and padded == padded_nb
              and twin_eq)
        log(f"packed seed {seed}: {'ok' if ok else 'FAIL'} (bits={n_bits}, "
            f"words={n_words}, stream_ok={stream_ok}, "
            f"full_eq={from_device == from_nibble}, padded_eq={padded == padded_nb}, "
            f"twin_equal={twin_eq})")
        seeds.append({"seed": seed, "ok": ok, "twin_equal": twin_eq,
                      "total_bits": n_bits, "n_words": n_words})
    return _summary(seeds, keys=())


# -- the geometry-and-sharpen kernel ------------------------------------------------

def part_geometry(dev, n, log):
    """Part 9: the geometry-and-sharpen kernel, bit for bit its twin (on
    the CPU), on random frames (1 to 400 rows, 1 to 600 columns), true
    extents (the whole frame or a pad of up to 127 rows and columns), lens
    distortion (0 one draw in four, else -100..100) and sharpness (0 one
    draw in four, else 0..100)."""
    seeds = []
    for seed in range(n):
        r = np.random.default_rng(seed + 10000)
        h, w = int(r.integers(1, 401)), int(r.integers(1, 601))
        extent = None
        if r.random() < 0.5:
            extent = (max(1, h - int(r.integers(0, 128))), max(1, w - int(r.integers(0, 128))))
        distortion = 0.0 if r.random() < 0.25 else float(r.uniform(-100.0, 100.0))
        sharpness = 0.0 if r.random() < 0.25 else float(r.uniform(0.0, 100.0))
        planes = torch.from_numpy(r.random((3, h, w), dtype=np.float32) ** 2).to(dev)
        amount = sharpness / 100.0 * 2.0
        before = geometry.KERNEL_LAUNCHES["geometry_sharpen_kernel"]
        ours = geometry.geometry_sharpen(planes, distortion, amount, extent)
        launches = geometry.KERNEL_LAUNCHES["geometry_sharpen_kernel"] - before
        twin = geometry.geometry_sharpen_ref(planes.cpu(), distortion, amount, extent)
        ours = ours.cpu()
        nan = torch.isnan(twin)
        twin_eq = (torch.equal(torch.isnan(ours), nan) and torch.equal(
            ours[~nan].view(torch.int32), twin[~nan].view(torch.int32)))
        want = int(dev.type == "cuda" and (distortion != 0.0 or sharpness != 0.0))
        ok = twin_eq and launches == want
        log(f"geometry seed {seed}: {'ok' if ok else 'FAIL'} ({h}x{w}, extent {extent}, "
            f"distortion {distortion:.3f}, sharpness {sharpness:.3f}, "
            f"launches={launches}, twin_equal={twin_eq})")
        seeds.append({"seed": seed, "ok": ok, "twin_equal": twin_eq, "hw": [h, w],
                      "extent": extent, "distortion": distortion,
                      "sharpness": sharpness})
    return _summary(seeds, keys=())


# (artifact key, count key, part) in tools/tpu_fuzz.py's order.
PARTS = (("fused_kernel", "fused", part_fused),
         ("slot_elision", "slots", part_slots),
         ("raw_kernel", "raw", part_raw),
         ("xtrans_kernel", "xtrans", part_xtrans),
         ("identity_oklch", "identity", part_identity),
         ("tone_curve_identity", "tone", part_tone),
         ("sparse_wire", "sparse", part_sparse),
         ("prepacked_wire", "prepacked", part_prepacked),
         ("packed_wire", "packed", part_packed),
         ("geometry_kernel", "geometry", part_geometry))


def run(dev, counts=None, log=print) -> dict:
    """Every part at ``counts`` seeds (DEFAULT_COUNTS where a key is
    missing) on ``dev``: {artifact key: block, ..., "seconds": {...},
    "ok": bool}. A part's exception fails that part and is recorded."""
    counts = {**DEFAULT_COUNTS, **(counts or {})}
    out, seconds = {}, {}
    for key, count_key, part in PARTS:
        t0 = time.perf_counter()
        try:
            out[key] = part(dev, counts[count_key], log)
        except Exception as e:  # noqa: BLE001 -- recorded as the part's failure
            log(f"{key}: FAIL {traceback.format_exc()}")
            out[key] = {"seeds": counts[count_key], "fails": counts[count_key],
                        "error": f"{type(e).__name__}: {e}", "per_seed": []}
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        seconds[key] = round(time.perf_counter() - t0, 3)
        log(f"{key}: {out[key]['seeds']} seeds, {out[key]['fails']} failed "
            f"({seconds[key]:.1f} s)")
    out["seconds"] = seconds
    out["ok"] = all(out[k]["fails"] == 0 for k, _, _ in PARTS)
    return out


def sources_digest(root=ROOT) -> dict:
    """SHA-256 over the sources a run executes, in path order (each path,
    a NUL, the file's bytes): every file of rawphotoforge_tpu_torch/ but
    the build cache, this tool, tests/torch_fixtures.py, chip_smoke.py."""
    paths = [os.path.join("tools", "torch_card_fuzz.py"),
             os.path.join("tests", "torch_fixtures.py"), "chip_smoke.py"]
    pkg = os.path.join(root, "rawphotoforge_tpu_torch")
    for d, dirs, files in os.walk(pkg):
        dirs[:] = [x for x in dirs if x not in ("__pycache__", "build")]
        paths += [os.path.relpath(os.path.join(d, f), root) for f in files
                  if f.endswith((".py", ".cu", ".cuh", ".cpp", ".h"))]
    h = hashlib.sha256()
    for rel in sorted(p.replace(os.sep, "/") for p in paths):
        h.update(rel.encode() + b"\0")
        with open(os.path.join(root, rel), "rb") as f:
            h.update(f.read())
    return {"sha256": h.hexdigest(), "files": len(paths)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="write the JSON artifact here (e.g. CARDFUZZ.json)")
    ap.add_argument("--seeds", type=int, default=DEFAULT_COUNTS["fused"],
                    help="develop-kernel draws (part 1)")
    ap.add_argument("--raw-seeds", type=int, default=DEFAULT_COUNTS["raw"],
                    help="Bayer draws (part 2) and geometry draws (part 9); parts "
                         "3-8 take half, at least 2")
    args = ap.parse_args(argv)
    from chip_smoke import card_line

    if not torch.cuda.is_available():
        print("torch_card_fuzz: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    half = max(2, args.raw_seeds // 2)
    counts = {"fused": args.seeds, "raw": args.raw_seeds,
              **{k: half for k in ("xtrans", "identity", "tone", "sparse",
                                   "prepacked", "packed")},
              "geometry": args.raw_seeds}
    card = card_line()
    print(f"device: {card}", flush=True)
    result = run(dev, counts, log=lambda m: print(m, flush=True))
    print("CARD FUZZ RESULT:", "PASS" if result["ok"] else "FAIL", flush=True)
    if args.out:
        try:
            head = subprocess.run(["git", "-C", ROOT, "rev-parse", "HEAD"],
                                  capture_output=True, text=True,
                                  timeout=10).stdout.strip() or "no git checkout"
        except OSError:
            head = "no git checkout"
        artifact = {
            "git_head": head,
            "sources": sources_digest(),
            "backend": dev.type,
            "device": card,
            "torch": torch.__version__,
            "when_utc": datetime.datetime.now(datetime.timezone.utc).isoformat(
                timespec="seconds"),
            "shape": [3, H, W],
            **result,
        }
        path = args.out if os.path.isabs(args.out) else os.path.join(ROOT, args.out)
        with open(path, "w") as f:
            json.dump(artifact, f, indent=1)
        print(f"wrote {args.out}", flush=True)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
