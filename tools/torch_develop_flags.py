#!/usr/bin/env python3
"""Compile-flag A/B of the port's CUDA develop kernel on one card.

Builds ``rawphotoforge_tpu_torch/csrc/develop.cu`` three ways — the
shipped flags (exact division and square root, no multiply-add
contraction), with contraction (``-fmad=true``), and with
``--use_fast_math`` — and times each on the 24 MP bucket grid for the
editor's four dispatch variants, in turns (A B C C B A ...), beside each
build's deviation from the shipped one. It measures how far the kernel's
time is set by its arithmetic rather than its bytes; the port ships only
the first build (the others break the slot shortcuts' bit-identity and
the twin's bit-equality).

    python3 tools/torch_develop_flags.py
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from rawphotoforge_tpu_torch.core.params import (
        BRIGHTNESS, EditParameters, default_curve_slots, pack_params)
    from rawphotoforge_tpu_torch.kernels import cuda_build, fused

    card = cs.card_line()
    shipped = list(cuda_build.NVCC_FLAGS)
    fmad = [f if f != "-fmad=false" else "-fmad=true" for f in shipped]
    fast = [f for f in shipped if not f.startswith(("-fmad", "-prec"))] + [
        "--use_fast_math"]
    builds = {"shipped": shipped, "fmad": fmad, "fast_math": fast}
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    procs = {}
    for name, flags in builds.items():
        out = os.path.join(cuda_build.BUILD_DIR, f"librpf_develop_ab_{name}.so")
        procs[name] = (out, subprocess.Popen(
            [cuda_build._nvcc(), *flags, "-o", out,
             str(cuda_build.CSRC / "develop.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            print(log, file=sys.stderr)
            return 1
        regs = sorted({ln.split("Used")[1].split(",")[0].strip()
                       for ln in log.splitlines() if "Used" in ln})
        print(f"build {name}: {' '.join(builds[name][-4:])} ... registers {regs}")
        lib = ctypes.CDLL(out)
        lib.rpf_develop_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        lib.rpf_develop_launch.restype = ctypes.c_int
        libs[name] = lib

    dev = torch.device("cuda", 0)
    hb, wb = cs.BUCKET_HW
    rng = np.random.default_rng(cs.SEED + 3)
    planes = torch.from_numpy(rng.random((3, hb, wb), dtype=np.float32) ** 2).to(dev)
    full = EditParameters()
    cs.bench_edit(full)
    tone = EditParameters()
    tone.set_tone(exposure=0.7, contrast=25, shadow=30, highlight=-20, black=5, white=-5)
    tone.set_vignette(40)
    drag = EditParameters()
    drag.set_tone(exposure=0.7, contrast=25)
    drag.set_curve(BRIGHTNESS, [0, 16000, 40000, 65535], [1000, 20000, 46000, 65535])
    stack = [full, *cs.regional_edits()]
    masks = np.zeros((4, hb, wb), np.uint8)
    masks[0] = 1
    for k, logit in enumerate(cs.region_logits(hb, wb), start=1):
        masks[k] = logit >= 0.0
    masks = torch.from_numpy(masks).to(dev)
    cases = [
        ("full_stack", [full], None, (False, False), None),
        ("slider_only", [tone], None, (True, True), None),
        ("tone_curve_drag", [drag], None, (False, True), None),
        ("m4_regional", stack, masks, (False, False), default_curve_slots(stack)),
    ]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream(dev).cuda_stream
    for name, plist, mk, (db, doc), slots_in in cases:
        params = pack_params(plist, extent=cs.PHOTO_HW, device=dev)
        m, s = len(plist), params.breaks.shape[-1]
        slots = fused._slot_table(m, db, doc, slots_in)
        table = fused.pack_table(params, m, s, slots, None, dev)
        main_only = mk is None
        outs = {}

        def run(lib):
            out = torch.empty_like(planes)
            err = lib.rpf_develop_launch(
                planes.data_ptr(), None if main_only else mk.data_ptr(),
                0 if main_only else 1, table.data_ptr(), table.numel(),
                out.data_ptr(), m, s, hb, wb, int(main_only), int(doc),
                sms * 8, stream)
            if err:
                raise RuntimeError(f"launch failed: {err}")
            return out

        times = {k: [] for k in libs}
        order = list(libs) + list(reversed(libs))
        for _ in range(3):
            for k in order:
                times[k].append(cs.time_events(lambda: run(libs[k]), reps=10))
        for k in libs:
            outs[k] = run(libs[k])
        torch.cuda.synchronize()
        for k in libs:
            d = (outs[k] - outs["shipped"]).abs()
            print(f"{name}: {k}: median {sorted(times[k])[len(times[k]) // 2]:.4f} ms "
                  f"({len(times[k])} runs of 10 launches, CUDA events); vs shipped: "
                  f"max abs {d.max().item():.3e}, "
                  f"{100 * (d > 1e-4).float().mean().item():.4f}% > 1e-4 [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
