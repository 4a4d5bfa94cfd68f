"""The port's lens corrections against the JAX package's on the CPU:
every ``ops/lenscorr`` function on the same seeded planes (shared and
per-plane warp coefficients, with and without a bucket-padded extent) at
assert_close (tight 1e-4 / frac 2e-3 / loose 5e-3; the measured maximum is
logged), ``io/lensdb`` lookups on the bundled XML and a user database,
OpcodeList3 DNGs through ``io/raw.develop_raw_image[_padded]``,
``PhotoEditor.open(lens_correct=...)`` and ``cli develop --lens-correct``."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from rawphotoforge_tpu.app import cli as jcli
from rawphotoforge_tpu.engine.editor import PhotoEditor as JEditor
from rawphotoforge_tpu.io import lensdb as jlensdb, raw as jraw
from rawphotoforge_tpu.ops import lenscorr as jlc

from rawphotoforge_tpu_torch.app import cli as tcli
from rawphotoforge_tpu_torch.engine.editor import FULL, MID, PhotoEditor
from rawphotoforge_tpu_torch.io import dng as tdng, lensdb as tlensdb, raw as traw
from rawphotoforge_tpu_torch.ops import lenscorr as tlc

import torch_fixtures as fx
from test_develop import assert_close
from test_lensdb import _XML
from torch_parity import assert_close_across

H, W = 40, 56           # true extent
HB, WB = 64, 128        # a bucket-padded grid of it
WARP1 = [[0.96, 0.05, -0.01, 0.002, 0.003, -0.002]]
WARP3 = [[0.96, 0.05, -0.01, 0.002, 0.003, -0.002],
         [0.97, 0.04, -0.01, 0.0, 0.0, 0.001],
         [0.95, 0.06, -0.02, 0.003, -0.002, 0.0]]
FISH1 = [[0.93, 0.06, -0.01, 0.0]]
FISH3 = [[0.93, 0.06, -0.01, 0.0], [0.92, 0.07, 0.0, 0.0],
         [0.94, 0.05, -0.02, 0.001]]
CENTER = (0.45, 0.55)
VIG_K = (0.3, -0.1, 0.05, 0.0, 0.0)


def _planes(padded):
    rng = np.random.default_rng(21)
    h, w = (HB, WB) if padded else (H, W)
    return rng.random((3, h, w), dtype=np.float32)


def _close(ours, ref, what):
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    ref = np.asarray(ref)
    assert ours.shape == ref.shape
    print(f"{what}: max abs {np.abs(ours - ref).max():.3e}")
    assert_close(np.moveaxis(ours, 0, -1) if ours.ndim == 3 else ours[..., None],
                 np.moveaxis(ref, 0, -1) if ref.ndim == 3 else ref[..., None])


PROFILES = {
    "vignetting": tlc.LensProfile(vignetting=(-0.5, 0.12, -0.02)),
    "poly3": tlc.LensProfile(distortion=(-0.03,)),
    "poly5": tlc.LensProfile(distortion_model="poly5", distortion=(-0.02, 0.01)),
    "ptlens": tlc.LensProfile(distortion_model="ptlens",
                              distortion=(0.01, -0.03, 0.005)),
    "tca": tlc.LensProfile(tca=(1.0004, 0.9995)),
    "tca_poly3_crop": tlc.LensProfile(
        vignetting=(-0.4, 0.1, 0.0), distortion=(-0.02,), tca=(1.0003, 0.9996),
        radius_scale=0.625),
}


@pytest.mark.parametrize("padded", [False, True], ids=["exact", "extent"])
@pytest.mark.parametrize("name", sorted(PROFILES))
def test_apply_profile_matches_jax(name, padded):
    prof = PROFILES[name]
    jprof = jlc.LensProfile.from_json(prof.to_json())
    planes = _planes(padded)
    extent = (H, W) if padded else None
    ours = tlc.apply_profile(torch.from_numpy(planes), prof, extent)
    ref = jlc.apply_profile(jnp.asarray(planes), jprof,
                            None if extent is None else jnp.asarray(extent, jnp.float32))
    _close(ours[:, :H, :W], np.asarray(ref)[:, :H, :W], f"apply_profile {name}")


@pytest.mark.parametrize("padded", [False, True], ids=["exact", "extent"])
@pytest.mark.parametrize("coefs", [WARP1, WARP3], ids=["P1", "P3"])
def test_warp_rectilinear_matches_jax(coefs, padded):
    planes = _planes(padded)
    extent = (H, W) if padded else None
    ours = tlc.warp_rectilinear(torch.from_numpy(planes),
                                np.asarray(coefs, np.float32), CENTER, extent=extent)
    ref = jlc.warp_rectilinear(
        jnp.asarray(planes), jnp.asarray(coefs, jnp.float32),
        jnp.asarray(CENTER, jnp.float32),
        extent=None if extent is None else jnp.asarray(extent, jnp.float32))
    _close(ours[:, :H, :W], np.asarray(ref)[:, :H, :W], "warp_rectilinear")


@pytest.mark.parametrize("padded", [False, True], ids=["exact", "extent"])
@pytest.mark.parametrize("coefs", [FISH1, FISH3], ids=["P1", "P3"])
def test_warp_fisheye_matches_jax(coefs, padded):
    planes = _planes(padded)
    extent = (H, W) if padded else None
    ours = tlc.warp_fisheye(torch.from_numpy(planes),
                            np.asarray(coefs, np.float32), CENTER, extent=extent)
    ref = jlc.warp_fisheye(
        jnp.asarray(planes), jnp.asarray(coefs, jnp.float32),
        jnp.asarray(CENTER, jnp.float32),
        extent=None if extent is None else jnp.asarray(extent, jnp.float32))
    _close(ours[:, :H, :W], np.asarray(ref)[:, :H, :W], "warp_fisheye")


@pytest.mark.parametrize("padded", [False, True], ids=["exact", "extent"])
def test_vignette_radial_gain_matches_jax(padded):
    h, w = (HB, WB) if padded else (H, W)
    extent = (H, W) if padded else None
    ours = tlc.vignette_radial_gain(h, w, VIG_K, CENTER, extent=extent)
    ref = jlc.vignette_radial_gain(
        h, w, VIG_K, CENTER,
        extent=None if extent is None else jnp.asarray(extent, jnp.float32))
    np.testing.assert_allclose(ours[:H, :W].numpy(), np.asarray(ref)[:H, :W],
                               rtol=2e-6, atol=0)


def test_single_functions_match_jax():
    """devignette, correct_distortion, correct_tca, correct_tca_distortion
    and bilinear_sample one by one (apply_profile composes them)."""
    planes = _planes(True)
    ext = (H, W)
    jext = jnp.asarray(ext, jnp.float32)
    t, j = torch.from_numpy(planes), jnp.asarray(planes)
    k = (-0.5, 0.12, -0.02)
    _close(tlc.devignette(t, k, ext, radius_scale=0.8)[:, :H, :W],
           np.asarray(jlc.devignette(j, jnp.asarray(k, jnp.float32), jext,
                                     radius_scale=jnp.float32(0.8)))[:, :H, :W],
           "devignette")
    for model, co in (("poly3", (-0.03,)), ("poly5", (-0.02, 0.01)),
                      ("ptlens", (0.01, -0.03, 0.005))):
        _close(tlc.correct_distortion(t, co, model, ext, 0.9)[:, :H, :W],
               np.asarray(jlc.correct_distortion(
                   j, jnp.asarray(co, jnp.float32), model, jext,
                   jnp.float32(0.9)))[:, :H, :W], f"correct_distortion {model}")
    _close(tlc.correct_tca(t, 1.0005, 0.9994, ext)[:, :H, :W],
           np.asarray(jlc.correct_tca(j, jnp.float32(1.0005), jnp.float32(0.9994),
                                      jext))[:, :H, :W], "correct_tca")
    _close(tlc.correct_tca_distortion(t, (0.01, -0.03, 0.005), 1.0005, 0.9994,
                                      "ptlens", ext)[:, :H, :W],
           np.asarray(jlc.correct_tca_distortion(
               j, jnp.asarray((0.01, -0.03, 0.005), jnp.float32),
               jnp.float32(1.0005), jnp.float32(0.9994), "ptlens",
               jext))[:, :H, :W], "correct_tca_distortion")
    rng = np.random.default_rng(5)
    sx = rng.uniform(-2.0, W + 2.0, (H, W)).astype(np.float32)
    sy = rng.uniform(-2.0, H + 2.0, (H, W)).astype(np.float32)
    sx[0, :8] = np.arange(8, dtype=np.float32) + 3e-5  # near-integer snaps
    ours = tlc.bilinear_sample(t[0], torch.from_numpy(sx), torch.from_numpy(sy),
                               torch.tensor(float(H)), torch.tensor(float(W)))
    ref = jlc.bilinear_sample(j[0], jnp.asarray(sx), jnp.asarray(sy),
                              jnp.float32(H), jnp.float32(W))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


def test_profile_json_round_trip_across_packages():
    prof = PROFILES["tca_poly3_crop"]
    assert jlc.LensProfile.from_json(prof.to_json()).to_json() == prof.to_json()
    assert tlc.LensProfile.from_json('{"name": "x", "extra": 1}').name == "x"


# -- the lens database -------------------------------------------------------

EXIFS = [
    {"Make": "Canon", "LensModel": "EF 50mm f/1.8 II", "FocalLength": "50.0",
     "FNumber": "2.8"},
    {"Make": "Canon", "LensModel": "EF 24-105mm f/4L IS USM", "FocalLength": "60",
     "FNumber": "5.6", "FocalLengthIn35mmFilm": "96"},
    {"Make": "SONY", "LensModel": "FE 28-70mm F3.5-5.6 OSS", "FocalLength": "35"},
    {"Make": "FUJIFILM", "LensModel": "XF35mmF1.4 R", "FocalLength": "35",
     "FNumber": "2"},
    {"Make": "Canon", "LensModel": "Sigma 35mm F1.4 DG HSM Art",
     "FocalLength": "35", "FNumber": "1.4"},
    {"Make": "TestCo", "LensModel": "TestCo Prime 50mm f/1.8 (serial 1)",
     "FocalLength": "50", "FNumber": "2.0", "FocalLengthIn35mmFilm": "80"},
    {"Make": "TestCo", "LensModel": "TestCo Zoom 24-70mm F2.8",
     "FocalLength": "28"},
    {"Model": "Phone X"},
]


@pytest.mark.parametrize("calibrated_only", [False, True])
def test_lensdb_lookups_match_jax(tmp_path, calibrated_only):
    (tmp_path / "user.xml").write_text(_XML)
    ours_db = tlensdb.LensDatabase.load([str(tmp_path)])
    ref_db = jlensdb.LensDatabase.load([str(tmp_path)])
    assert len(ours_db.lenses) == len(ref_db.lenses) >= 20
    found = 0
    for exif in EXIFS:
        ours = ours_db.profile_from_exif(exif, calibrated_only=calibrated_only)
        ref = ref_db.profile_from_exif(exif, calibrated_only=calibrated_only)
        assert (ours is None) == (ref is None), exif
        if ours is not None:
            found += 1
            assert dataclasses.asdict(ours) == dataclasses.asdict(ref), exif
    assert found >= (2 if calibrated_only else 6)


def test_bundled_database_is_the_ports_own_copy():
    import os

    assert os.path.dirname(os.path.abspath(tlensdb._BUNDLED)).endswith(
        os.path.join("rawphotoforge_tpu_torch", "data"))
    with open(tlensdb._BUNDLED, "rb") as a, open(jlensdb._BUNDLED, "rb") as b:
        assert a.read() == b.read()


# -- OpcodeList3 DNGs through the develop ------------------------------------

def _opcode_dng(opcodes, pattern="RGGB", h=H, w=W, **fields):
    rng = np.random.default_rng(31)
    raw = traw.synthetic_raw(fx.scene(rng, h, w), pattern,
                             wb_gains=(1.6, 1.0, 1.3))
    raw = dataclasses.replace(raw, **fields)
    return tdng.write_dng(raw, opcode_list_3=opcodes)


OPCODE_CASES = {
    "warp_then_vignette": dict(warp=(WARP1, CENTER), vignette=(VIG_K, CENTER)),
    "vignette_then_warp": dict(warp=(WARP3, CENTER), vignette=(VIG_K, (0.5, 0.5)),
                               vignette_first=True),
    "fisheye": dict(fisheye=(FISH1, CENTER)),
    "xtrans_warp_crop": dict(warp=(WARP1, (0.5, 0.5))),
}


@pytest.mark.parametrize("case", sorted(OPCODE_CASES))
def test_opcode_list3_develops_match_jax(case):
    fields = {}
    pattern = "RGGB"
    if case == "xtrans_warp_crop":
        pattern = "XTRANS"
        fields = dict(default_crop=(3, 5, 44, 30))
    data = _opcode_dng(fx.opcode_list3(**OPCODE_CASES[case]), pattern, **fields)
    ours_raw, ref_raw = traw.parse_raw(data), jraw.parse_raw(data)
    assert ours_raw.vignette_first == ref_raw.vignette_first
    assert traw.has_opcode_list3(ours_raw)
    ours, exif = traw.develop_raw_image(ours_raw, device="cpu")
    ref, jexif = jraw.develop_raw_image(ref_raw)
    assert exif == jexif
    _close(ours, ref, f"develop_raw_image {case}")
    assert traw.bucket_stable_eligible(ours_raw) == jraw.bucket_stable_eligible(ref_raw)
    assert traw.bucket_stable_eligible(ours_raw)
    padded = traw.develop_raw_image_padded(ours_raw, device="cpu")
    ref_p = np.asarray(jraw.develop_raw_image_padded(ref_raw))
    assert tuple(padded.shape) == ref_p.shape
    h, w = ours.shape[1:]
    _close(padded[:, :h, :w], ref_p[:, :h, :w], f"develop_raw_image_padded {case}")
    # The padded develop's true region equals the exact-extent develop
    # elementwise (coordinates normalize by the true extent).
    assert torch.equal(padded[:, :h, :w], ours)


def test_opcode_files_under_rotation_take_the_exact_path():
    data = _opcode_dng(fx.opcode_list3(warp=(WARP1, CENTER)), orientation=6)
    raw = traw.parse_raw(data)
    assert not traw.bucket_stable_eligible(raw)
    assert not jraw.bucket_stable_eligible(jraw.parse_raw(data))
    ed = PhotoEditor.from_bytes(data, "DNG", device="cpu")
    assert ed.shape == (W, H)
    ref, _ = jraw.develop_raw_image(jraw.parse_raw(data))
    _close(ed._original_at(FULL)[:, :W, :H], ref, "rotated opcode file")


def test_batch_routes_a_warped_dng_through_the_develop_kernel(tmp_path,
                                                            monkeypatch):
    """`cli batch` of a warped DNG: demosaic -> warp -> the develop
    kernel's wrapper (not the one-pass RAW kernel), as the JAX package's
    batch; the decoded JPEGs agree within the encoders' bound
    (tests/test_torch_batch.py)."""
    from rawphotoforge_tpu_torch.kernels import fused, raw_pipeline as trp

    calls = {"raw": 0, "develop": 0}

    def counted(name, fn):
        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(trp, "raw_develop_fused",
                        counted("raw", trp.raw_develop_fused))
    monkeypatch.setattr(fused, "develop_post_geo_fused",
                        counted("develop", fused.develop_post_geo_fused))
    src = tmp_path / "in"
    src.mkdir()
    (src / "w.dng").write_bytes(_opcode_dng(
        fx.opcode_list3(warp=(WARP3, CENTER), vignette=(VIG_K, CENTER)), h=48, w=72))
    flags = ["--exposure", "0.3", "--contrast", "10"]
    assert tcli.main(["batch", str(src), str(tmp_path / "t"), *flags,
                      "--device", "cpu"]) == 0
    assert calls == {"raw": 0, "develop": 1}
    assert jcli.main(["batch", str(src), str(tmp_path / "j"), *flags,
                      "--no-mesh"]) == 0
    a = np.asarray(Image.open(tmp_path / "t" / "w.jpg").convert("RGB")).astype(int)
    b = np.asarray(Image.open(tmp_path / "j" / "w.jpg").convert("RGB")).astype(int)
    assert a.shape == b.shape == (48, 72, 3)
    d = np.abs(a - b)
    assert d.max() <= 6 and (d > 1).mean() <= 0.02


# -- the editor and the CLI ----------------------------------------------------

def _lens_cr2(tmp_path, lens="EF 50mm f/1.8 II"):
    rng = np.random.default_rng(41)
    border = (8, 4, 103, 75)
    p = tmp_path / "lens.cr2"
    p.write_bytes(fx.build_cr2(fx.cr2_sensor(rng, 76, 104, border),
                               slices=(2, 40, 24), sensor_border=border,
                               lens_model=lens, fnumber=2.8))
    return p


@pytest.mark.parametrize("mode", [True, "calibrated-only"])
def test_editor_lens_correct_matches_jax(tmp_path, mode):
    p = _lens_cr2(tmp_path)
    ours = PhotoEditor.open(str(p), lens_correct=mode, device="cpu",
                            use_kernel=False, mid_long_edge=48, low_long_edge=24)
    ref = JEditor.open(str(p), lens_correct=mode, use_pallas=False,
                       mid_long_edge=48, low_long_edge=24)
    assert ours.applied_lens_profile == ref.applied_lens_profile
    assert ours.applied_lens_approximate == ref.applied_lens_approximate
    if mode is True:
        assert "50mm" in ours.applied_lens_profile and ours.applied_lens_approximate
    else:
        assert ours.applied_lens_profile is None
    h, w = ours.shape
    _close(ours._original_at(FULL)[:, :h, :w],
           np.asarray(ref._originals[FULL])[:, :h, :w], "lens-corrected original")
    for ed in (ours, ref):
        ed.set_tone(exposure=0.4, contrast=20)
        ed.set_vignette(20)
    for level in (FULL, MID):
        assert_close_across(ours.apply(level).numpy().transpose(1, 2, 0),
                            np.asarray(ref.apply(level)).transpose(1, 2, 0))
    assert ours.export_exif_bytes() == ref.export_exif_bytes()


def test_apply_lens_profile_corrects_each_buffer_once():
    rng = np.random.default_rng(3)
    ed = PhotoEditor.from_rgb_f32(rng.random((30, 40, 3), dtype=np.float32),
                                  device="cpu")
    ed._original_at(MID)  # a small image: MID aliases FULL
    assert ed._originals[MID] is ed._originals[FULL]
    ed.apply(FULL)
    ed.apply_lens_profile(PROFILES["poly3"])
    assert ed._originals[MID] is ed._originals[FULL]
    assert not ed._geo_cache and not ed._rendered


def test_cli_develop_lens_correct_matches_jax(tmp_path, capsys):
    p = _lens_cr2(tmp_path)
    ours, ref = tmp_path / "o.png", tmp_path / "r.png"
    flags = ["--exposure", "0.3", "--lens-correct"]
    assert tcli.main(["develop", str(p), str(ours), *flags, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "lens profile: Canon EF 50mm f/1.8 II (APPROXIMATE" in out
    assert jcli.main(["develop", str(p), str(ref), *flags, "--jnp-path"]) == 0
    a = np.asarray(Image.open(ours).convert("RGB")).astype(np.float64) / 255.0
    b = np.asarray(Image.open(ref).convert("RGB")).astype(np.float64) / 255.0
    assert a.shape == b.shape == (72, 96, 3)
    assert_close(a, b, tight=1.0 / 255.0 + 1e-9, loose=2.0 / 255.0 + 1e-9)
    # No match: the note says so and the develop proceeds.
    q = _lens_cr2(tmp_path, lens="Unknown 13mm")
    assert tcli.main(["develop", str(q), str(tmp_path / "n.png"), "--lens-correct",
                      "--device", "cpu"]) == 0
    assert "lens profile: no match" in capsys.readouterr().out
