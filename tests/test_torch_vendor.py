"""The port's vendor RAW containers against the JAX package's on the CPU.

Seeded numpy fixtures written by the port's writers (tests/torch_fixtures)
go through both packages' readers: the mosaics are byte-equal and the
metadata equal (pattern at odd sensor borders, black/white, WB, crop,
orientation, EXIF) for Canon CR2, Panasonic RW2 (plain and RAW4),
Fujifilm RAF (Bayer and X-Trans) and Sony ARW2; the native ARW2 and RAW4
decoders equal their Python oracles; the RAF/CR3/X3F preview candidates
and the BMFF EXIF merge agree; the decode gate's correlation is within
1e-6 of the JAX package's with the same decision; each vendor mosaic
through the RAW kernel's twin meets assert_close_across against the JAX
Pallas kernel (interpret mode); and ``cli batch`` of a CR2 + RAF + ARW2
directory agrees with the JAX ``batch --no-mesh``."""

import dataclasses
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from rawphotoforge_tpu.app import cli as jcli
from rawphotoforge_tpu.core.params import EditParameters as JEdit, pack_params as jpack
from rawphotoforge_tpu.engine import instant as jinstant
from rawphotoforge_tpu.engine.editor import PhotoEditor as JEditor
from rawphotoforge_tpu.io import (cr2 as jcr2, dng as jdng, raw as jraw,
                                  vendor_packed as jvp, vendor_preview as jvpv,
                                  vendor_raw as jvr)
from rawphotoforge_tpu.kernels import raw_pipeline as jrp
from rawphotoforge_tpu.ops import demosaic as jdm

from rawphotoforge_tpu_torch import native
from rawphotoforge_tpu_torch.app import cli as tcli
from rawphotoforge_tpu_torch.core.params import pack_params
from rawphotoforge_tpu_torch.engine import instant as tinstant
from rawphotoforge_tpu_torch.engine.editor import FULL, PhotoEditor
from rawphotoforge_tpu_torch.io import (cr2 as tcr2, dng as tdng, raw as traw,
                                        vendor_packed as tvp,
                                        vendor_preview as tvpv,
                                        vendor_raw as tvr)
from rawphotoforge_tpu_torch.kernels import raw_pipeline as trp

import torch_fixtures as fx
from test_preview import _box, _cr3, _fake_soi_noise, _jpeg, _mini_tiff, _raf, _x3f
from torch_parity import assert_close_across, full_stack_edit

FIELDS = ("pattern", "black_level", "white_level", "wb_gains", "orientation",
          "default_crop", "exif", "wb_known", "needs_verification")
# Decoded-JPEG tolerance between the two packages' JPEG encoders
# (tests/test_torch_batch.py).
JPEG_MAX, JPEG_FRAC_OVER_1 = 6, 0.02


def _assert_same_raw(ours, ref):
    assert ours.mosaic.dtype == ref.mosaic.dtype
    assert ours.mosaic.tobytes() == ref.mosaic.tobytes()
    assert ours.mosaic.shape == ref.mosaic.shape
    for f in FIELDS:
        assert getattr(ours, f) == getattr(ref, f), f
    assert (ours.xyz_to_cam is None) == (ref.xyz_to_cam is None)


def _both(data):
    ours, ref = traw.parse_raw(data), jraw.parse_raw(data)
    _assert_same_raw(ours, ref)
    return ours, ref


# -- Canon CR2 ------------------------------------------------------------

CR2_CASES = {
    # name: (sensor h, w, border (left, top, right, bottom), slices,
    #        ColorData element count, WB word offset)
    "even_cd7": (32, 48, (8, 4, 47, 31), (1, 20, 28), 1312, 0x3F),
    "odd_left_cd1": (32, 48, (9, 4, 47, 31), (2, 16, 16), 582, 0x19),
    "odd_top_cd11": (34, 50, (8, 5, 49, 33), (0, 0, 0), 4528, 0x69),
    "odd_both_cd9": (34, 50, (9, 5, 46, 30), (3, 10, 20), 1824, 0x47),
}


@pytest.mark.parametrize("case", sorted(CR2_CASES))
def test_cr2_matches_jax(case):
    h, w, border, slices, count, word = CR2_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    data = fx.build_cr2(fx.cr2_sensor(rng, h, w, border), slices=slices,
                        sensor_border=border, colordata_count=count,
                        wb_word_offset=word, lens_model="EF 50mm f/1.8 II",
                        fnumber=4.0)
    ours, _ = _both(data)
    left, top, right, bottom = border
    assert ours.mosaic.shape == (bottom + 1 - top, right + 1 - left)
    assert ours.pattern == jcr2._bayer_pattern_at(top, left)


def test_cr2_malformed_bytes_raise_typed_errors():
    rng = np.random.default_rng(3)
    data = fx.build_cr2(fx.cr2_sensor(rng, 32, 48, (8, 4, 47, 31)))
    for cut in (20, 200, len(data) // 2):
        with pytest.raises(tdng.DngError):
            tcr2.read_cr2(data[:cut])
        with pytest.raises(jdng.DngError):
            jcr2.read_cr2(data[:cut])


# -- Panasonic RW2 ---------------------------------------------------------

RW2_CASES = {
    # name: (raw_format, pattern at the border origin, borders)
    "plain_full": (1, "RGGB", None),
    "plain_odd_borders": (1, "GBRG", (1, 3, 29, 57)),
    "raw4_full": (4, "BGGR", None),
    "raw4_odd_borders": (4, "GRBG", (3, 1, 27, 55)),
}


@pytest.mark.parametrize("case", sorted(RW2_CASES))
def test_rw2_matches_jax(case):
    fmt, pattern, borders = RW2_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    sensor = fx.smooth12(rng, 30, 58)
    ours, _ = _both(fx.rw2_file(sensor, pattern, borders, raw_format=fmt))
    assert ours.needs_verification == (fmt == 4)
    t, l, b, r = borders or (0, 0, 30, 58)
    assert np.array_equal(ours.mosaic, sensor[t:b, l:r])
    assert ours.pattern == pattern


# -- Fujifilm RAF ----------------------------------------------------------

@pytest.mark.parametrize("pattern,hw", [("XTRANS", (36, 48)), ("XTRANS", (40, 62)),
                                        ("GRBG", (24, 40)), ("BGGR", (26, 38))])
def test_raf_matches_jax(pattern, hw):
    rng = np.random.default_rng(hw[0] * hw[1])
    mosaic = rng.integers(100, 16000, hw).astype(np.uint16)
    ours, _ = _both(fx.raf_file(mosaic, pattern, preview=_jpeg(12, 16, seed=5)))
    assert ours.pattern == pattern and np.array_equal(ours.mosaic, mosaic)


def test_raf_xtrans_map_is_the_canonical_grid():
    """The RAF color map (stored reversed) names X-Trans only when it
    equals the canonical XTRANS grid the RAW kernel assumes."""
    from rawphotoforge_tpu_torch.ops.demosaic import XTRANS

    rng = np.random.default_rng(8)
    mosaic = rng.integers(100, 16000, (36, 48)).astype(np.uint16)
    data = bytearray(fx.raf_file(mosaic, "XTRANS"))
    recs = tvr._raf_records(bytes(data), *tvr._raf_pointers(bytes(data))[2:4])
    codes = [recs[tvr._RAF_XTRANS][35 - i] for i in range(36)]
    assert np.array_equal(np.asarray(codes).reshape(6, 6), XTRANS)
    # One site changed: neither X-Trans nor a 2x2 Bayer map -> typed error
    # in both packages.
    i = bytes(data).index(bytes(recs[tvr._RAF_XTRANS]))
    data[i] = (data[i] + 1) % 3
    for reader, err in ((tvr.read_raf, tdng.DngError), (jvr.read_raf, jdng.DngError)):
        with pytest.raises(err):
            reader(bytes(data))


# -- Sony ARW2 and the packed codecs ---------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_arw2_native_matches_oracles(seed):
    """The native decoder equals the scalar oracle and the JAX decoder on
    arbitrary payloads (degenerate blocks, shift saturation, cross-block
    delta reads)."""
    rng = np.random.default_rng(seed)
    h, w = 6, 128
    payload = rng.integers(0, 256, h * w, dtype=np.uint8).tobytes()
    knots = sorted(int(k) << 2 for k in rng.integers(0, 4096, 4))
    curve = tvp.sony_arw2_curve(knots)
    assert np.array_equal(curve, jvp.sony_arw2_curve(knots))
    ours = tvp.decode_arw2(payload, w, h, curve)
    assert np.array_equal(ours, tvp.decode_arw2_py(payload, w, h, curve))
    assert np.array_equal(ours, jvp.decode_arw2(payload, w, h, curve))


def test_arw2_encoder_matches_jax():
    codes = fx.arw2_codes(np.random.default_rng(4), 8, 96)
    assert tvp.encode_arw2(codes) == jvp.encode_arw2(codes)
    with pytest.raises(tdng.DngError):
        tvp.decode_arw2(b"\x00" * 240, 48, 5)


@pytest.mark.parametrize("preview", [None, "match"])
def test_arw2_container_matches_jax(preview):
    codes = fx.arw2_codes(np.random.default_rng(5), 24, 96)
    data, decoded = fx.arw2_file(codes, preview=preview)
    ours, _ = _both(data)
    assert ours.needs_verification
    assert np.array_equal(ours.mosaic, decoded.mosaic)


def test_raw4_native_matches_oracles():
    rng = np.random.default_rng(6)
    m = fx.smooth12(rng, 20, 700, step=45)
    enc = tvp.encode_pana_raw4(m)
    assert enc == jvp.encode_pana_raw4(m)
    ours = tvp.decode_pana_raw4(enc, 700, 20)
    assert np.array_equal(ours, m)
    assert np.array_equal(ours, tvp.decode_pana_raw4_py(enc, 700, 20))
    assert np.array_equal(ours, jvp.decode_pana_raw4(enc, 700, 20))
    with pytest.raises(tdng.DngError, match="truncated"):
        tvp.decode_pana_raw4(enc[:0x4000], 700, 60)


def test_packed_decoders_raise_without_the_native_library(monkeypatch):
    """No silent Python fallback: a native library that cannot be built
    fails the vendor decode and the decode gate."""
    def refuse():
        raise native.NativeBuildError("no C++ compiler")

    codes = fx.arw2_codes(np.random.default_rng(7), 24, 64)
    data, decoded = fx.arw2_file(codes, preview="match")
    raw4 = fx.rw2_file(fx.smooth12(np.random.default_rng(8), 12, 28), raw_format=4)
    monkeypatch.setattr(native, "library", refuse)
    for fn in (lambda: traw.parse_raw(data), lambda: traw.parse_raw(raw4),
               lambda: tinstant.quick_linear_from_raw(decoded, 128)):
        with pytest.raises(native.NativeBuildError):
            fn()


# -- embedded previews of non-TIFF containers ------------------------------

def _preview_containers():
    jpeg = _jpeg(20, 28, seed=41)
    return {
        "raf_pointer": _raf(jpeg),
        "raf_scan": _raf(jpeg, good_pointer=False),
        "cr3_mdat": _cr3(_jpeg(10, 14, seed=43), _jpeg(40, 56, seed=44),
                         thumb_jpeg=_jpeg(6, 8)),
        "cr3_uuid": _cr3(_jpeg(10, 14, seed=45), b"\x00" * 4096),
        "x3f_dir": _x3f([(b"IMA2", 18, _jpeg(8, 10, seed=54)),
                         (b"IMAG", 18, _jpeg(16, 22, seed=52))],
                        sensor_noise=_fake_soi_noise()),
        "x3f_damaged": _x3f([(b"IMA2", 18, _jpeg(16, 22, seed=52))])[:-4]
        + b"\xf0\xff\xff\xff",
    }


@pytest.mark.parametrize("name", sorted(_preview_containers()))
def test_vendor_preview_matches_jax(name):
    data = _preview_containers()[name]
    ours = tdng.extract_preview(data)
    assert ours is not None and ours == jdng.extract_preview(data)
    assert len(tvpv.vendor_preview_candidates(data)) >= 1


def _cr3_with_cmt():
    make = b"Canon\x00"
    cmt1 = _mini_tiff([(271, 2, len(make), (make,)),
                       (306, 2, 20, (b"2026:08:17 23:59:59\x00",))])
    cmt2 = _mini_tiff([(0x829A, 5, 1, (b"\x01\x00\x00\x00\xfa\x00\x00\x00",)),
                       (0x8827, 3, 1, b"\x90\x01"),
                       (36867, 2, 20, (b"2020:01:01 10:00:00\x00",))])
    canon_uuid = bytes.fromhex("85c0b687820f11e08111f4ce462b6a48")
    inner = _box(b"uuid", canon_uuid + _box(b"CMT1", cmt1) + _box(b"CMT2", cmt2))
    ftyp = _box(b"ftyp", b"crx \x00\x00\x00\x01isomcrx ")
    return (ftyp + _box(b"moov", inner)
            + _box(b"mdat", _jpeg(20, 28, seed=50) + b"\x00" * 256))


def test_bmff_exif_merge_matches_jax():
    data = _cr3_with_cmt()
    assert [bytes(b) for b in tvpv.bmff_exif_tiff_blocks(data)] == [
        bytes(b) for b in jvpv.bmff_exif_tiff_blocks(data)]
    assert traw.container_exif(data) == jraw.container_exif(data)
    ours = traw.decode_embedded_preview_host(data)
    ref = jraw.decode_embedded_preview_host(data)
    assert ours.exif == ref.exif and ours.exif["DateTime"] == "2020:01:01 10:00:00"
    assert ours.shape == (20, 28)


@pytest.mark.parametrize("name", ["a.cr3", "b.raf", "c.x3f"])
def test_editor_opens_preview_only_containers(tmp_path, name):
    jpeg = _jpeg(24, 32, seed=46)
    blob = {"a.cr3": _cr3(_jpeg(8, 10), jpeg), "b.raf": _raf(jpeg),
            "c.x3f": _x3f([(b"IMA2", 18, jpeg)])}[name]
    p = tmp_path / name
    p.write_bytes(blob)
    ed = PhotoEditor.open(str(p), device="cpu")
    ref = JEditor.open(str(p), use_pallas=False)
    assert ed.shape == ref.shape == (24, 32)
    assert ed.opened_from_preview and ref.opened_from_preview
    np.testing.assert_allclose(ed._original_at(FULL).numpy(),
                               np.asarray(ref._original_at(FULL)), atol=1e-6)
    with pytest.raises(tdng.DngError):
        PhotoEditor.open(str(p), device="cpu", preview_fallback=False)


# -- the decode gate -------------------------------------------------------

def _jax_gate_correlation(data, raw):
    """The JAX package's gate (io/raw._verify_memory_derived_decode) up to
    its decision: the same preview decode, superpixel develop and
    correlation."""
    import io as _io

    pil = Image.open(_io.BytesIO(jdng.extract_preview(data)))
    pil.draft("RGB", (256, 256))
    pv = jinstant.linear_from_srgb_u8(np.ascontiguousarray(
        np.asarray(pil.convert("RGB"))))
    return jvr.dihedral_luma_correlation(
        jinstant.quick_linear_from_raw(raw, 128), pv)


def _gate_files():
    rng = np.random.default_rng(9)
    codes = fx.arw2_codes(rng, 64, 96)
    arw_ok, _ = fx.arw2_file(codes, preview="match")
    arw_bad, _ = fx.arw2_file(codes, preview=fx.noise_preview(10))
    m = fx.smooth12(rng, 56, 84, base=700)
    raw4 = tdng.RawImage(mosaic=m, pattern="RGGB", black_level=157.0,
                         white_level=4095.0, wb_gains=(1.8, 1.0, 1.4),
                         xyz_to_cam=None)
    rw2_ok = fx.rw2_file(m, raw_format=4, preview=fx.matching_preview(raw4, 128))
    rw2_bad = fx.rw2_file(m, raw_format=4, preview=fx.noise_preview(11))
    return {"arw2_ok": arw_ok, "arw2_bad": arw_bad, "rw2_ok": rw2_ok,
            "rw2_bad": rw2_bad}


@pytest.mark.parametrize("name", ["arw2_ok", "arw2_bad", "rw2_ok", "rw2_bad"])
def test_gate_correlation_and_decision_match_jax(name):
    data = _gate_files()[name]
    rw2 = name.startswith("rw2")
    raw = (tvr.read_rw2 if rw2 else tdng.read_dng)(data)
    assert raw.needs_verification
    ours = traw.gate_correlation(data, raw)
    ref = _jax_gate_correlation(data, (jvr.read_rw2 if rw2 else jdng.read_dng)(data))
    assert abs(ours - ref) <= 1e-6, (ours, ref)
    accepted = name.endswith("ok")
    assert (ours >= tvr.CORRELATION_GATE) == accepted
    if accepted:
        _both(data)
    else:
        for parse, err in ((traw.parse_raw, tdng.DngError),
                           (jraw.parse_raw, jdng.DngError)):
            with pytest.raises(err, match="correlation gate"):
                parse(data)


def test_gate_refused_file_opens_from_its_preview(tmp_path):
    data = _gate_files()["arw2_bad"]
    p = tmp_path / "bad.arw"
    p.write_bytes(data)
    ed = PhotoEditor.open(str(p), device="cpu")
    ref = JEditor.open(str(p), use_pallas=False)
    assert "correlation gate" in ed.opened_from_preview
    assert ed.opened_from_preview == ref.opened_from_preview
    assert ed.shape == ref.shape == (96, 128)


def test_instant_superpixel_develop_matches_jax():
    """engine/instant's host develop of a u16 mosaic (native block means)
    and of float data (numpy), against the JAX package's."""
    rng = np.random.default_rng(12)
    for pattern, hw in (("RGGB", (64, 96)), ("XTRANS", (72, 96)),
                        ("GBRG", (600, 900))):
        raw = traw.synthetic_raw(fx.scene(rng, *hw), pattern)
        raw = dataclasses.replace(raw, orientation=6, wb_known=False,
                                  wb_gains=(1.0, 1.0, 1.0))
        ours = tinstant.quick_linear_from_raw(raw, 128)
        ref = jinstant.quick_linear_from_raw(raw, 128)
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)
        flt = dataclasses.replace(raw, mosaic=raw.mosaic.astype(np.float32))
        np.testing.assert_allclose(tinstant.quick_linear_from_raw(flt, 128),
                                   jinstant.quick_linear_from_raw(flt, 128),
                                   rtol=0, atol=1e-6)
    u8 = rng.integers(0, 256, (20, 30, 3), dtype=np.uint8)
    assert np.array_equal(tinstant.linear_from_srgb_u8(u8),
                          jinstant.linear_from_srgb_u8(u8))
    assert np.array_equal(tinstant.instant_histogram(u8),
                          jinstant.instant_histogram(u8))


# -- vendor mosaics through the RAW kernel ----------------------------------

def _vendor_files():
    rng = np.random.default_rng(13)
    border = (9, 5, 136, 52)  # odd left/top: a GBRG/BGGR phase
    cr2 = fx.build_cr2(fx.cr2_sensor(rng, 54, 140, border), slices=(2, 48, 44),
                       sensor_border=border)
    arw, _ = fx.arw2_file(fx.arw2_codes(rng, 40, 128), preview="match")
    x = traw.synthetic_raw(fx.scene(rng, 48, 132), "XTRANS",
                           white_level=16383, black_level=0)
    raf = fx.raf_file(x.mosaic, "XTRANS")
    rw2 = fx.rw2_file(fx.smooth12(rng, 42, 134, base=900), "GRBG",
                      borders=(1, 3, 41, 131))
    return {"a.cr2": cr2, "b.arw": arw, "c.raf": raf, "d.rw2": rw2}


@pytest.mark.parametrize("name", ["a.cr2", "b.arw", "c.raf", "d.rw2"])
def test_vendor_raw_through_the_kernel_twin_matches_pallas(name):
    data = _vendor_files()[name]
    ours_raw, ref_raw = _both(data)
    ours_raw = traw.with_effective_wb(ours_raw)
    ref_raw = jraw._with_effective_wb(ref_raw)
    assert ours_raw.wb_gains == ref_raw.wb_gains
    h, w = ours_raw.mosaic.shape
    edit = full_stack_edit()
    jedit = JEdit.from_json(edit.to_json())
    mos01 = traw.normalized_mosaic(ours_raw, ours_raw.mosaic, torch.device("cpu"))
    cam = traw.cam2srgb_for(ours_raw)
    ours = trp.raw_develop_fused(
        mos01, ours_raw.wb_gains, cam,
        pack_params([edit], extent=(h, w), device="cpu"), np.float32(0.6),
        pattern=ours_raw.pattern)
    jmos = jdm.normalize_mosaic(jnp.asarray(ref_raw.mosaic), ref_raw.black_level,
                                ref_raw.white_level)
    tile = (48, 384) if ours_raw.pattern == "XTRANS" else (16, 128)
    ref = jrp.raw_develop_fused(
        jmos, jnp.asarray(ref_raw.wb_gains, jnp.float32),
        jnp.asarray(cam), jpack([jedit], extent=(h, w)), jnp.float32(0.6),
        pattern=ref_raw.pattern, tile_h=tile[0], tile_w=tile[1])
    assert tuple(ours.shape) == tuple(ref.shape) == (3, h, w)
    assert_close_across(ours.numpy().transpose(1, 2, 0),
                        np.asarray(ref).transpose(1, 2, 0))


# -- cli batch of a vendor directory -----------------------------------------

FLAGS = ["--exposure", "0.4", "--contrast", "15", "--vignette", "30",
         "--sharpness", "20"]


@pytest.fixture(scope="module")
def vendor_batches(tmp_path_factory):
    src = tmp_path_factory.mktemp("vendor")
    files = _vendor_files()
    for name in ("a.cr2", "b.arw", "c.raf"):
        (src / name).write_bytes(files[name])
    (src / "e_bad.arw").write_bytes(_gate_files()["arw2_bad"])
    out = tmp_path_factory.mktemp("vout")
    assert tcli.main(["batch", str(src), str(out / "t"), *FLAGS,
                      "--device", "cpu"]) == 0
    assert jcli.main(["batch", str(src), str(out / "j"), *FLAGS,
                      "--no-mesh"]) == 0
    return out / "t", out / "j"


def _decode(path):
    return np.asarray(Image.open(path).convert("RGB")).astype(np.int32)


@pytest.mark.parametrize("stem", ["a", "b", "c", "e_bad"])
def test_vendor_batch_matches_jax(vendor_batches, stem):
    ours_dir, ref_dir = vendor_batches
    a, b = _decode(ours_dir / f"{stem}.jpg"), _decode(ref_dir / f"{stem}.jpg")
    assert a.shape == b.shape
    d = np.abs(a - b)
    assert d.max() <= JPEG_MAX and (d > 1).mean() <= JPEG_FRAC_OVER_1


def test_vendor_batch_launch_rule_and_preview_note(tmp_path, capsys):
    """Every vendor RAW of the batch takes the fast path on the CPU twin
    (no kernel launch here), and the gate-refused ARW2 is developed from
    its preview with the gate's message on its line."""
    src = tmp_path / "in"
    src.mkdir()
    (src / "a.cr2").write_bytes(_vendor_files()["a.cr2"])
    (src / "bad.arw").write_bytes(_gate_files()["arw2_bad"])
    before = dict(trp.KERNEL_LAUNCHES)
    assert tcli.main(["batch", str(src), str(tmp_path / "o"), "--device", "cpu"]) == 0
    assert trp.KERNEL_LAUNCHES == before
    out = capsys.readouterr().out
    line = [ln for ln in out.splitlines() if "bad.arw" in ln][0]
    assert "embedded preview" in line and "correlation gate" in line
    assert "fused raw path" in out
    assert sorted(os.listdir(tmp_path / "o")) == ["a.jpg", "bad.jpg"]
