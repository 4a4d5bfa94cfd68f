"""Vendor RAW fixtures written with the port's own writers, free of jax:
the port's CPU tests and chip_smoke.py (on a machine that has no jax)
both build their files here.

* ``build_cr2``: a spec-shaped Canon CR2 (4-IFD TIFF chain, sliced SOF3
  stream through the port's ``io/ljpeg``, Canon MakerNote SensorInfo and
  ColorData) — the CR2 writer of tests/test_cr2.py, plus FNumber and
  FocalLengthIn35mmFilm for lens-profile lookups.
* ``arw2_file`` / ``rw2_file`` / ``raf_file``: Sony ARW2 (TIFF-EP,
  compression 32767), Panasonic RW2 (plain 16-bit or RAW4) and Fujifilm
  RAF (Bayer or X-Trans) through ``io/vendor_raw``'s writers.
* ``matching_preview``: an embedded-preview JPEG that is a downscaled
  develop of the file's own sensor data (the decode gate passes), and
  ``noise_preview``: one of another image (the gate refuses).
* ``opcode_list3``: a DNG OpcodeList3 of WarpRectilinear / WarpFisheye
  and FixVignetteRadial, in a given order.
* ``png_forward_filter`` / ``png48_bytes``: the PNG spec's forward row
  filters, vectorised (each reads only raw bytes), and a 16-bit PNG of
  those rows, plain or Adam7-interlaced (Pillow cannot write 48-bit RGB).
* ``random_params``, ``assert_fuzz_close`` and
  ``assert_staircase_explained``: the full-parameter fuzz's draws and
  gates (tests/test_fuzz.py), on the port's EditParameters and its
  exact-LUT anchor (``ops/develop.develop_post_geo``), on any device.
"""

from __future__ import annotations

import dataclasses
import io
import struct

import numpy as np

from rawphotoforge_tpu_torch.io import ljpeg
from rawphotoforge_tpu_torch.io.dng import RawImage


def scene(rng, h, w, texture=0.15):
    """A seeded smooth-plus-texture linear scene [3, h, w] f32."""
    yy = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None]
    xx = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :]
    planes = np.stack([0.15 + 0.6 * yy * np.ones_like(xx),
                       0.1 + 0.5 * xx * np.ones_like(yy),
                       0.3 + 0.3 * np.sin(6.0 * (xx + yy))])
    return planes + texture * rng.random((3, h, w), dtype=np.float32)


def build_cr2(mosaic_full: np.ndarray, slices=(1, 20, 28),
              sensor_border=(8, 4, 47, 31), wb_rggb=(2100, 1024, 1024, 1500),
              colordata_count=1312, wb_word_offset=0x3F, predictor=1,
              lens_model=None, focal_length=50, fnumber=None,
              focal_35mm=None, orientation=1) -> bytes:
    """A minimal spec-shaped CR2 around a full-sensor u16 mosaic.
    ``sensor_border`` = (left, top, right, bottom), the last two inclusive
    (Canon SensorInfo); ``slices`` = (n, w_a, w_b) of tag 0xC640."""
    h, w = mosaic_full.shape
    out = bytearray(b"II\x2a\x00" + b"\x00" * 4 + b"CR\x02\x00" + b"\x00" * 4)

    def add_blob(b: bytes) -> int:
        off = len(out)
        out.extend(b)
        if len(out) % 2:
            out.append(0)
        return off

    def add_ifd(entries, next_off=0) -> int:
        off = len(out)
        out.extend(struct.pack("<H", len(entries)))
        for tag, typ, cnt, val in sorted(entries):
            out.extend(struct.pack("<HHI", tag, typ, cnt))
            if isinstance(val, int):
                out.extend(struct.pack("<I", val))
            else:
                out.extend(val.ljust(4, b"\x00")[:4])
        out.extend(struct.pack("<I", next_off))
        return off

    # Sliced sample stream: slice columns fill top-to-bottom, in stream order.
    if slices and slices[0]:
        n, w_a, w_b = slices
        parts = []
        x0 = 0
        for ws in [w_a] * n + [w_b]:
            parts.append(mosaic_full[:, x0 : x0 + ws].reshape(-1))
            x0 += ws
        stream = np.concatenate(parts)
    else:
        stream = mosaic_full.reshape(-1)
    scan = ljpeg.encode(stream.reshape(h, w // 2, 2), precision=14,
                        predictor=predictor)
    scan_off = add_blob(scan)

    sensor_info = [17, w, h, 0, 0, *sensor_border, 0, 0, 0, 0, 0, 0, 0, 0]
    si_off = add_blob(struct.pack(f"<{len(sensor_info)}H", *sensor_info))
    cd = np.zeros(colordata_count, dtype="<u2")
    cd[wb_word_offset : wb_word_offset + 4] = wb_rggb
    cd_off = add_blob(cd.tobytes())
    maker_entries = [
        (0x00E0, 3, len(sensor_info), si_off),
        (0x4001, 3, colordata_count, cd_off),
    ]
    if lens_model:
        lm = lens_model.encode() + b"\x00"
        maker_entries.append((0x0095, 2, len(lm), add_blob(lm)))
    maker_off = add_ifd(maker_entries)
    exif_entries = [
        (0x829A, 5, 1, add_blob(struct.pack("<II", 1, 125))),  # 1/125 s
        (0x8827, 3, 1, struct.pack("<H", 400)),               # ISO
        (0x920A, 5, 1, add_blob(struct.pack("<II", focal_length, 1))),
        (0x927C, 7, 64, maker_off),                           # MakerNote
    ]
    if fnumber is not None:
        exif_entries.append(
            (0x829D, 5, 1, add_blob(struct.pack("<II", round(fnumber * 10), 10))))
    if focal_35mm is not None:
        exif_entries.append((0xA405, 3, 1, struct.pack("<H", focal_35mm)))
    exif_off = add_ifd(exif_entries)
    slice_off = add_blob(struct.pack("<3H", *slices))
    raw_ifd = add_ifd([
        (259, 3, 1, struct.pack("<H", 6)),             # Compression = old JPEG
        (273, 4, 1, scan_off),
        (279, 4, 1, struct.pack("<I", len(scan))),
        (0xC640, 3, 3, slice_off),
    ])
    make_off = add_blob(b"Canon\x00")
    model_off = add_blob(b"Canon EOS synthetic\x00")
    dt = b"2026:08:17 09:00:00\x00"
    ifd0 = add_ifd([
        (271, 2, 6, make_off),
        (272, 2, 20, model_off),
        (274, 3, 1, struct.pack("<H", orientation)),
        (306, 2, len(dt), add_blob(dt)),
        (34665, 4, 1, exif_off),
    ], next_off=raw_ifd)
    struct.pack_into("<I", out, 4, ifd0)
    struct.pack_into("<I", out, 12, raw_ifd)
    return bytes(out)


def cr2_sensor(rng, h, w, border, black=300):
    """A full CR2 sensor u16 [h, w]: a masked border at ~``black`` (read
    noise) around a seeded active area; ``border`` = (left, top, right,
    bottom) as in build_cr2 (right/bottom inclusive)."""
    left, top, right, bottom = border
    m = (black + rng.integers(0, 9, (h, w))).astype(np.uint16)
    ah, aw = bottom + 1 - top, right + 1 - left
    lin = scene(rng, ah, aw).mean(axis=0)
    m[top:bottom + 1, left:right + 1] = np.clip(
        black + lin * 14000, 0, (1 << 14) - 1).astype(np.uint16)
    return m


def smooth12(rng, h, w, step=30, lo=16, hi=4095, base=1000):
    """RAW4-fixture-representable 12-bit content: same-parity steps stay
    inside the sh=0 continuation window of encode_pana_raw4."""
    return (base + np.cumsum(rng.integers(-step, step + 1, (h, w)),
                             axis=1)).clip(lo, hi).astype(np.uint16)


def jpeg_bytes(hwc_u8: np.ndarray, quality: int = 92) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(hwc_u8)).save(buf, "JPEG",
                                                       quality=quality)
    return buf.getvalue()


def matching_preview(raw: RawImage, long_edge: int = 512) -> bytes:
    """A camera-preview stand-in: JPEG of the host superpixel develop of
    ``raw`` (the decoded sensor data), so the decode gate passes."""
    from rawphotoforge_tpu_torch.engine import instant

    return jpeg_bytes(instant.quick_from_raw(raw, long_edge))


def noise_preview(seed: int, h: int = 96, w: int = 128) -> bytes:
    """A preview of another image (seeded noise): the gate refuses."""
    rng = np.random.default_rng(seed)
    return jpeg_bytes(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))


ARW2_KNOTS = [800 << 2, 1600 << 2, 2400 << 2, 3200 << 2]


def arw2_codes(rng, h, w):
    """Pre-curve 11-bit ARW2 codes of a seeded RGGB scene."""
    from rawphotoforge_tpu_torch.io.raw import synthetic_raw

    raw = synthetic_raw(scene(rng, h, w), "RGGB", black_level=32,
                        white_level=2047, wb_gains=(2.0, 1.0, 1.5))
    return raw.mosaic


def arw2_file(codes: np.ndarray, preview=None, knots=ARW2_KNOTS,
              orientation: int = 1) -> tuple[bytes, RawImage]:
    """(ARW2 bytes, the RawImage its reader gives) for pre-curve 11-bit
    ``codes`` (the block coding is lossy where a block spans more than 7
    bits); ``preview``: None, "match" (matching_preview) or JPEG bytes."""
    from rawphotoforge_tpu_torch.io.vendor_packed import (
        decode_arw2, encode_arw2, sony_arw2_curve)
    from rawphotoforge_tpu_torch.io.vendor_raw import write_tiff_ep

    curve = sony_arw2_curve(knots)
    h, w = codes.shape
    decoded = RawImage(
        mosaic=decode_arw2(encode_arw2(codes), w, h, curve), pattern="RGGB",
        black_level=512.0, white_level=float(curve[4094]),
        wb_gains=(2.0, 1.0, 1.5), xyz_to_cam=None, orientation=orientation,
        exif={"Model": "ILCE-FIXTURE"})
    if isinstance(preview, str) and preview == "match":
        preview = matching_preview(decoded)
    fields = dataclasses.replace(decoded, mosaic=codes)
    return write_tiff_ep(fields, bits=8, make="SONY", compression=32767,
                         sony_tags=True, arw2_curve_knots=knots,
                         preview_jpeg=preview), decoded


def rw2_file(mosaic: np.ndarray, pattern="RGGB", borders=None,
             raw_format: int = 1, preview=None, black=157,
             white=4095) -> bytes:
    """A Panasonic RW2 of a full-sensor u16 mosaic (``pattern`` names the
    CFA at the border origin)."""
    from rawphotoforge_tpu_torch.io.vendor_raw import write_rw2

    raw = RawImage(mosaic=mosaic, pattern=pattern, black_level=float(black),
                   white_level=float(white), wb_gains=(1.8, 1.0, 1.4),
                   xyz_to_cam=None, exif={"Model": "DMC-FIXTURE"})
    return write_rw2(raw, jpg_from_raw=preview, borders=borders,
                     raw_format=raw_format)


def raf_file(mosaic: np.ndarray, pattern="XTRANS", preview=None) -> bytes:
    """A Fujifilm RAF of a u16 mosaic (Bayer or X-Trans)."""
    from rawphotoforge_tpu_torch.io.vendor_raw import write_raf

    raw = RawImage(mosaic=mosaic, pattern=pattern, black_level=0.0,
                   white_level=16383.0, wb_gains=(1.7, 1.0, 1.3),
                   xyz_to_cam=None, exif={"Model": "X-FIXTURE"})
    return write_raf(raw, jpeg_preview=preview)


def opcode_list3(warp=None, fisheye=None, vignette=None,
                 vignette_first=False) -> bytes:
    """A big-endian DNG OpcodeList3: WarpRectilinear (id 1, ``warp`` =
    (coefs [P, 6], (cx, cy))), WarpFisheye (id 2, ``fisheye`` = (coefs
    [P, 4], (cx, cy))) and FixVignetteRadial (id 3, ``vignette`` = (k [5],
    (cx, cy))), the vignette first or last."""
    ops = []
    for op_id, spec in ((1, warp), (2, fisheye)):
        if spec is not None:
            coefs = np.asarray(spec[0], dtype=np.float64)
            body = struct.pack(">I", coefs.shape[0])
            body += coefs.astype(">f8").tobytes()
            body += struct.pack(">2d", *spec[1])
            ops.append((op_id, body))
    if vignette is not None:
        k, (cx, cy) = vignette
        vig = (3, struct.pack(">7d", *k, cx, cy))
        ops = [vig] + ops if vignette_first else ops + [vig]
    out = struct.pack(">I", len(ops))
    for op_id, body in ops:
        out += struct.pack(">IIII", op_id, 0x01030000, 0, len(body)) + body
    return out


# -- 16-bit PNG -------------------------------------------------------------------

# Adam7 interlace pass origins/strides (PNG spec 8.2): (x0, y0, dx, dy).
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def png_forward_filter(rows: np.ndarray, ftypes, bpp: int) -> bytes:
    """The PNG forward filter (spec 4.5.4 / 9.2) of u8 rows [h, stride],
    row y with filter ``ftypes[y]`` (0-4); returns the filter-byte-led
    rows. The encoder's predictors read only raw bytes, so every row and
    column is filtered at once."""
    cur = rows.astype(np.int16)
    h, stride = cur.shape
    ft = np.asarray(ftypes, dtype=np.uint8).reshape(h)
    zero_col = np.zeros((h, bpp), np.int16)
    a = np.concatenate([zero_col, cur[:, :-bpp]], axis=1)[:, :stride]
    b = np.concatenate([np.zeros((1, stride), np.int16), cur[:-1]], axis=0)
    c = np.concatenate([zero_col, b[:, :-bpp]], axis=1)[:, :stride]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    f = ft[:, None]
    pred = np.select([f == 1, f == 2, f == 3, f == 4],
                     [a, b, (a + b) >> 1, paeth], 0)
    out = np.empty((h, 1 + stride), np.uint8)
    out[:, 0] = ft
    out[:, 1:] = ((cur - pred) & 0xFF).astype(np.uint8)
    return out.tobytes()


def png48_raw(u16: np.ndarray, ftypes_for=None, interlace: bool = False) -> bytes:
    """The filtered image data (before deflate) of a 16-bit PNG of u16
    [h, w, c], big-endian samples, its rows filtered with
    ``ftypes_for(n_rows)`` (default all 0); Adam7-interlaced with
    ``interlace`` (each pass filtered on its own)."""
    h, w, ch = u16.shape
    bpp = 2 * ch
    ftypes_for = ftypes_for or (lambda n: np.zeros(n, np.uint8))

    def filtered(img):
        rows = np.ascontiguousarray(img.astype(">u2")).view(np.uint8)
        rows = rows.reshape(img.shape[0], img.shape[1] * bpp)
        return png_forward_filter(rows, ftypes_for(img.shape[0]), bpp)

    if interlace:
        return b"".join(filtered(u16[y0::dy, x0::dx])
                        for x0, y0, dx, dy in ADAM7 if x0 < w and y0 < h)
    return filtered(u16)


def png48_bytes(u16: np.ndarray, ftypes_for=None, interlace: bool = False,
                level: int = 6, raw: bytes | None = None) -> bytes:
    """A 16-bit PNG of u16 [h, w, c] (c = 1 gray, 2 gray+alpha, 3 RGB,
    4 RGBA): ``png48_raw``'s data (or ``raw``, made so) in one IDAT
    deflated at ``level``."""
    import zlib

    h, w, ch = u16.shape
    if raw is None:
        raw = png48_raw(u16, ftypes_for, interlace)

    def chunk(tag, payload):
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload)))

    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16, ctype, 0, 0,
                                          int(interlace)))
            + chunk(b"IDAT", zlib.compress(raw, level))
            + chunk(b"IEND", b""))


# -- the full-parameter fuzz --------------------------------------------------------

def no_shortcuts(params):
    """Packed params with their curve shortcut table cleared: the develop
    kernels then evaluate every curve, the general path a shortcut must
    equal bit for bit."""
    return dataclasses.replace(
        params, default_slots=((False,) * 4,) * params.num_masks)


def random_params(r: np.random.Generator, allow_geometry=True):
    """tests/test_fuzz.py's ``_random_params`` on the port's
    EditParameters: the same Generator calls in the same order, so a seed
    gives the same edit in both packages."""
    from rawphotoforge_tpu_torch.core.params import (
        BRIGHTNESS, HUE, LIGHTNESS, SATURATION, EditParameters)

    p = EditParameters()
    p.set_tone(
        exposure=float(r.uniform(-3, 3)),
        contrast=int(r.integers(-100, 101)),
        shadow=int(r.integers(-100, 101)),
        highlight=int(r.integers(-100, 101)),
        black=int(r.integers(-60, 61)),
        white=int(r.integers(-60, 61)),
    )
    p.set_whitebalance(int(r.integers(-100, 101)), int(r.integers(-100, 101)))
    p.set_vignette(int(r.integers(-100, 101)))
    if allow_geometry:
        p.set_lens_distortion(int(r.integers(-100, 101)))
    for slot in (BRIGHTNESS, HUE, SATURATION, LIGHTNESS):
        n = int(r.integers(2, 7))
        xs = np.sort(r.choice(65536, size=n, replace=False)).astype(np.int32)
        xs[0], xs[-1] = 0, 65535
        xs = np.unique(xs)
        if slot in (SATURATION, LIGHTNESS):
            # Hue-independent gains: a near-neutral pixel's hue is rounding
            # noise, so a hue-varying sat/light curve has no one answer.
            ys = np.full(len(xs), r.integers(20000, 46000), dtype=np.int32)
        else:
            ys = np.sort(r.integers(0, 65536, size=len(xs))).astype(np.int32)
        p.set_curve(slot, xs, ys)
    return p


def fuzz_deviation(ours, ref) -> dict:
    """Median, mean and max of |ours - ref| (tensors or arrays), in f64."""
    d = np.abs(_f64(ours) - _f64(ref))
    return {"median": float(np.median(d)), "mean": float(d.mean()),
            "max": float(d.max())}


def _f64(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def assert_fuzz_close(ours, ref, step=0.06):
    """tests/test_fuzz.py's fuzz-grade rule: random curves have steep
    segments, so ulp-level divergence flips single LUT indices on some
    pixels, each flip bounded by one staircase step; bound the
    distribution, not the flip count."""
    d = fuzz_deviation(ours, ref)
    assert d["median"] < 5e-5, f"median {d['median']:.2e}"
    assert d["mean"] < 1e-3, f"mean {d['mean']:.2e}"
    assert d["max"] < step, f"max {d['max']:.2e}"


def staircase_candidate_outputs(planes, packed, masks) -> np.ndarray:
    """The exact-LUT anchor with each curve family's LUT shifted one index
    either way: every value an ulp-induced index flip can give. Returns
    f64 [9, 3, H, W] (the unshifted anchor first)."""
    from rawphotoforge_tpu_torch.ops import develop as dev

    outs = [_f64(dev.develop_post_geo(planes, packed, masks))]
    luts = packed.luts
    for fam in range(4):
        for d in (-1, 1):
            sh = luts.clone()
            if d == 1:
                sh[:, fam, :-1] = luts[:, fam, 1:]
            else:
                sh[:, fam, 1:] = luts[:, fam, :-1]
            outs.append(_f64(dev.develop_post_geo(
                planes, dataclasses.replace(packed, luts=sh), masks)))
    return np.stack(outs)


def assert_staircase_explained(kern, planes, packed, masks, thresh=1e-3,
                               fit_tol=2e-3, max_flip_frac=0.05):
    """tests/test_fuzz.py's staircase gate: every value more than
    ``thresh`` from the anchor must lie within the envelope of the anchor
    run with each curve family's LUT shifted one index either way (plus
    ``fit_tol``), and at most ``max_flip_frac`` of the values may deviate.
    Returns (flip_frac, 0)."""
    cands = staircase_candidate_outputs(planes, packed, masks)
    kern = _f64(kern)
    outliers = np.abs(kern - cands[0]) > thresh
    frac = float(outliers.mean())
    assert frac < max_flip_frac, (
        f"{frac:.3%} of pixel-channels deviate >{thresh} "
        f"(bound {max_flip_frac:.1%})")
    lo = cands.min(axis=0) - fit_tol
    hi = cands.max(axis=0) + fit_tol
    bad = outliers & ((kern < lo) | (kern > hi))
    if bad.any():
        idx = np.argwhere(bad)[:5]
        detail = "; ".join(
            f"[{','.join(map(str, i))}] kern={kern[tuple(i)]:.5f} "
            f"env=[{lo[tuple(i)]:.5f},{hi[tuple(i)]:.5f}] "
            f"anchor={cands[0][tuple(i)]:.5f}" for i in idx)
        raise AssertionError(
            f"{int(bad.sum())} pixel-channels deviate >{thresh} yet lie "
            f"outside the adjacent-staircase envelope: {detail}")
    return frac, 0
