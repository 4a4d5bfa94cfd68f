#!/usr/bin/env python3
"""Extended CPU soak of the PyTorch/CUDA port, the counterpart of
tools/soak.py: heavier fuzzing than the test suite's, on the CPU, outside
the tests.

 1. 1500 mutations per container variant (the DNG family of
    tests/test_dng_fuzz.py, a CR2, NEF/ARW TIFF-EP, RW2, RAF, ARW2 and
    RAW4) through the port's ``io/raw.parse_raw``: each must parse or raise
    the port's typed PhotoEditorError, and must decide as the JAX
    package's parser does on the same bytes (both parse to the same
    mosaic, or both raise);
 2. 12 extra editor cache-coherence sequences on the port's
    ``PhotoEditor(device="cpu")`` (tests/test_torch_fuzz.py's, with and
    without the develop kernel's twin);
 3. 6 extra geodesic-vs-Dijkstra configurations on the port's
    ``ops/masking.geodesic_distance``.

Run from the root of a checkout (it imports the JAX package for the
reference decisions, and the tests' fixture helpers, as the tests do):

    python tools/torch_soak.py

Exits non-zero on any failure.
"""

import os
import sys
import time
import zlib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

MUTATIONS = 1500
EDITOR_SEEDS = range(100, 112)
GEODESIC_SEEDS = range(50, 56)


def mutate(data: bytes, rng, trial: int) -> bytes:
    """tools/soak.py's four mutations, by ``trial % 4``: truncate, flip 1-15
    bytes, zero a span of up to 255 bytes, splice 8 bytes from elsewhere."""
    buf = bytearray(data)
    kind = trial % 4
    if kind == 0:
        buf = buf[: int(rng.integers(1, len(buf)))]
    elif kind == 1:
        for _ in range(int(rng.integers(1, 16))):
            buf[int(rng.integers(0, len(buf)))] = int(rng.integers(0, 256))
    elif kind == 2:
        a = int(rng.integers(0, len(buf) - 1))
        b = min(len(buf), a + int(rng.integers(1, 256)))
        buf[a:b] = bytes(b - a)
    else:
        a = int(rng.integers(0, len(buf) - 8))
        b = int(rng.integers(0, len(buf) - 8))
        buf[a: a + 8] = data[b: b + 8]
    return bytes(buf)


def container_variants() -> dict:
    """tools/soak.py's containers, written by the JAX package's writers (the
    same bytes go to both parsers)."""
    from rawphotoforge_tpu.io import dng
    from rawphotoforge_tpu.io import vendor_raw as vr
    from rawphotoforge_tpu.io.raw import synthetic_raw

    from test_cr2 import build_cr2
    from test_dng_fuzz import _variants

    variants = dict(_variants())
    rng0 = np.random.default_rng(12345)
    variants["cr2"] = build_cr2(rng0.integers(0, 16000, size=(48, 48), dtype=np.uint16))
    img = rng0.random((3, 48, 48), dtype=np.float32) * 0.8

    def vraw(pattern):
        return synthetic_raw(img, pattern=pattern, black_level=512, white_level=16383)

    variants["nef"] = vr.write_tiff_ep(vraw("RGGB"), bits=14, make="NIKON CORPORATION")
    variants["arw"] = vr.write_tiff_ep(vraw("RGGB"), bits=16, make="SONY")
    variants["rw2"] = vr.write_rw2(vraw("GBRG"))
    variants["raf"] = vr.write_raf(vraw("XTRANS"))
    codes = (300 + rng0.integers(0, 100, (24, 64))).astype(np.uint16)
    arw2 = dng.RawImage(mosaic=codes, pattern="RGGB", black_level=512,
                        white_level=16300, wb_gains=(2.0, 1.0, 1.5),
                        xyz_to_cam=None, exif={})
    variants["arw2"] = vr.write_tiff_ep(
        arw2, bits=8, make="SONY", compression=32767, sony_tags=True,
        arw2_curve_knots=[4000, 8000, 12000, 16000])
    m12 = (500 + np.cumsum(rng0.integers(-30, 31, (14, 28)), axis=1)
           ).clip(16, 4095).astype(np.uint16)
    variants["raw4"] = vr.write_rw2(dng.RawImage(
        mosaic=m12, pattern="RGGB", black_level=157, white_level=4095,
        wb_gains=(1.0, 1.0, 1.0), xyz_to_cam=None, exif={}), raw_format=4)
    return variants


def soak_containers(fails, log):
    from rawphotoforge_tpu._errbase import PhotoEditorError as JaxError
    from rawphotoforge_tpu.io.raw import parse_raw as jax_parse

    from rawphotoforge_tpu_torch._errbase import PhotoEditorError
    from rawphotoforge_tpu_torch.io.raw import parse_raw

    from test_torch_dng_fuzz import _outcome, _same_mosaic

    for name, data in sorted(container_variants().items()):
        rng = np.random.default_rng(zlib.crc32(("soak" + name).encode()))
        before = len(fails)
        parsed = 0
        for trial in range(MUTATIONS):
            buf = mutate(data, rng, trial)
            ours, got = _outcome(parse_raw, PhotoEditorError, buf)
            theirs, ref = _outcome(jax_parse, JaxError, buf)
            if ours == "untyped" or ours != theirs:
                fails.append((name, trial, ours, theirs,
                              got if ours == "untyped" else ""))
            elif ours == "ok":
                parsed += 1
                if not _same_mosaic(got.mosaic, ref.mosaic):
                    fails.append((name, trial, "mosaic differs", got.mosaic.shape,
                                  ref.mosaic.shape))
        log(f"soak fuzz {name}: {MUTATIONS} mutations, {parsed} parsed, "
            f"{len(fails) - before} failures")


def soak_editor(fails, log):
    import test_torch_fuzz

    for seed in EDITOR_SEEDS:
        use_kernel = bool(seed % 2)
        try:
            test_torch_fuzz.test_editor_cache_coherence_random_sequences(seed, use_kernel)
            ok = True
        except Exception as e:  # noqa: BLE001 -- recorded as a failure
            ok = False
            fails.append(("editor-fuzz", seed, type(e).__name__, str(e)[:160]))
        log(f"soak editor seed {seed} (use_kernel={use_kernel}): "
            f"{'ok' if ok else 'FAIL'}")


def soak_geodesic(fails, log):
    import torch

    from rawphotoforge_tpu_torch.ops import masking

    from test_torch_masking import _dijkstra

    for seed in GEODESIC_SEEDS:
        rng = np.random.default_rng(seed)
        h, w = int(rng.integers(8, 20)), int(rng.integers(8, 20))
        planes = rng.random((3, h, w)).astype(np.float32)
        point = (int(rng.integers(0, h)), int(rng.integers(0, w)))
        ew = float(rng.uniform(2, 12))
        got = masking.geodesic_distance(torch.from_numpy(planes), point, ew, 0.01,
                                        sweeps=14).numpy()
        want = _dijkstra(planes, [point], ew, 0.01)
        ok = bool(np.allclose(got, want, rtol=1e-4, atol=1e-5))
        if not ok:
            fails.append(("geodesic", seed, "mismatch",
                          f"max {np.abs(got - want).max():.2e}"))
        log(f"soak geodesic seed {seed} ({h}x{w}): {'ok' if ok else 'FAIL'}")


def main() -> int:
    def log(msg):
        print(msg, flush=True)

    fails = []
    t0 = time.perf_counter()
    for part in (soak_containers, soak_editor, soak_geodesic):
        t = time.perf_counter()
        part(fails, log)
        log(f"{part.__name__}: {time.perf_counter() - t:.1f} s")
    log(f"SOAK RESULT: {'PASS' if not fails else f'{len(fails)} FAILURES'} "
        f"in {time.perf_counter() - t0:.1f} s")
    for f in fails[:20]:
        log(f"   {f}")
    return 0 if not fails else 1


if __name__ == "__main__":
    sys.exit(main())
