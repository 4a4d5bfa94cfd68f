"""The port's ``cli batch`` on a directory of small DNGs, on the CPU,
against the JAX package's ``batch --no-mesh`` on the same files and flags:
Bayer (lossless JPEG), X-Trans, a DefaultCrop under a vignette (the
crop-first route) and orientation 6. Both write JPEGs through their packed
device wire, on the same coefficient model; the renders before the JPEG
meet assert_close, and their f32 differences move a few coefficients across
a quantization step, so the decoded files agree within a few u8 levels.
Also: the dense and packed JPEG wires, the editor route of a mixed
directory, and ``develop`` of a DNG."""

import argparse
import dataclasses
import io
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from rawphotoforge_tpu.app import cli as jcli
from rawphotoforge_tpu.core.params import EditParameters as JEdit, pack_params as jpack
from rawphotoforge_tpu.io import dng as jdng, jpegenc as jjpeg, raw as jraw
from rawphotoforge_tpu.kernels import fused as jfused, raw_pipeline as jrp
from rawphotoforge_tpu.ops import demosaic as jdm
from rawphotoforge_tpu.ops.sharpen import unsharp_mask as junsharp

from rawphotoforge_tpu_torch.app import cli as tcli
from rawphotoforge_tpu_torch.io import jpegbits as tbits, jpegenc as tjpeg, raw as traw
from rawphotoforge_tpu_torch.kernels import raw_pipeline as trp

from test_develop import assert_close
from torch_parity import assert_close_across

XYZ_TO_CAM = np.array([[0.8, -0.1, -0.05], [-0.3, 1.1, 0.15],
                       [-0.05, 0.15, 0.65]])
FLAGS = ["--exposure", "0.4", "--contrast", "15", "--vignette", "30",
         "--sharpness", "20", "--brightness-curve", "0:0,30000:34000,65535:65535"]
# Decoded-JPEG tolerance between the two packages' batch files (u8
# levels): measured max 3, and at most 1.2 % of samples (c_crop.dng) differ
# by more than 1.
JPEG_MAX, JPEG_FRAC_OVER_1 = 3, 0.015


def _planes(h=96, w=144):
    rng = np.random.default_rng(11)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    smooth = np.stack([yy / h, xx / w, (yy + xx) / (h + w)])
    return 0.8 * smooth + 0.1 * rng.random((3, h, w), dtype=np.float32)


FILES = {
    "a_rggb.dng": (dict(pattern="RGGB"), {}, dict(compression=7)),
    "b_xtrans.dng": (dict(pattern="XTRANS"), {}, {}),
    "c_crop.dng": (dict(pattern="GRBG"), dict(default_crop=(8, 6, 120, 80)), {}),
    "d_orient6.dng": (dict(pattern="RGGB"), dict(orientation=6),
                      dict(compression=7, tile=(48, 72))),
}


@pytest.fixture(scope="module")
def dng_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("dngs")
    for name, (syn, fields, write) in FILES.items():
        raw = dataclasses.replace(
            jraw.synthetic_raw(_planes(), xyz_to_cam=XYZ_TO_CAM, **syn), **fields)
        (d / name).write_bytes(jdng.write_dng(raw, **write))
    return d


@pytest.fixture(scope="module")
def batches(dng_dir, tmp_path_factory):
    out = tmp_path_factory.mktemp("out")
    assert tcli.main(["batch", str(dng_dir), str(out / "t"), *FLAGS,
                      "--device", "cpu"]) == 0
    assert jcli.main(["batch", str(dng_dir), str(out / "j"), *FLAGS,
                      "--no-mesh"]) == 0
    return out / "t", out / "j"


def _decode(path):
    return np.asarray(Image.open(path).convert("RGB")).astype(np.int32)


@pytest.mark.parametrize("name", sorted(FILES))
def test_batch_jpegs_match_jax(batches, name):
    ours_dir, ref_dir = batches
    stem = os.path.splitext(name)[0] + ".jpg"
    a, b = _decode(ours_dir / stem), _decode(ref_dir / stem)
    assert a.shape == b.shape
    expect = {"c_crop.dng": (80, 120), "d_orient6.dng": (144, 96)}.get(name, (96, 144))
    assert a.shape[:2] == expect
    d = np.abs(a - b)
    assert d.max() <= JPEG_MAX and (d > 1).mean() <= JPEG_FRAC_OVER_1


def _edit_pair():
    parser = argparse.ArgumentParser()
    tcli._add_edit_flags(parser)
    edit = tcli._params_from_args(parser.parse_args(FLAGS))
    return edit, JEdit.from_json(edit.to_json())


@pytest.mark.parametrize("name", ["a_rggb.dng", "c_crop.dng"])
def test_pre_jpeg_renders_match_jax(dng_dir, name):
    """The port's fast-path render against the JAX package's: the one-pass
    kernel for the RGGB file, the crop-first route for the cropped one."""
    data = (dng_dir / name).read_bytes()
    edit, jedit = _edit_pair()
    ours = tcli.raw_fast_render(traw.parse_raw(data), edit, torch.device("cpu"))
    raw = jraw.parse_raw(data)
    h, w = raw.mosaic.shape
    mos01 = jdm.normalize_mosaic(jnp.asarray(raw.mosaic), raw.black_level,
                                 raw.white_level)
    cam = jnp.asarray(jdm.cam_matrix_to_srgb(raw.xyz_to_cam))
    wb = jnp.asarray(raw.wb_gains, jnp.float32)
    sharpen = jnp.float32(jedit.sharpness / 100.0 * 2.0)
    if raw.default_crop is None:
        ref = jrp.raw_develop_fused(
            mos01, wb, cam, jpack([jedit], extent=(h, w), build_luts=False),
            sharpen, pattern=raw.pattern, tile_h=16, tile_w=128,
            default_oklch_curves=True, identity_oklch=True)
    else:
        cx, cy, cw, ch = raw.default_crop
        planes = jdm.develop_raw(mos01, wb, cam, pattern=raw.pattern)
        planes = junsharp(planes[:, cy:cy + ch, cx:cx + cw], sharpen)
        ref = jfused.develop_post_geo_fused(
            planes, jpack([jedit], extent=(ch, cw), build_luts=False), None,
            main_mask_all_ones=True, default_oklch_curves=True,
            identity_oklch=True, tile_h=16, tile_w=128)
    assert tuple(ours.shape) == tuple(ref.shape)
    assert_close_across(ours.numpy().transpose(1, 2, 0),
                        np.asarray(ref).transpose(1, 2, 0))


def test_batch_prints_stage_times(dng_dir, tmp_path, capsys):
    """The batch prints one line per file and its end-to-end rate; the
    per-stage times are taken by chip_smoke.py, outside the product loop."""
    assert tcli.main(["batch", str(dng_dir), str(tmp_path), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "4 images" in out and "MPix/s end-to-end" in out
    assert out.count(" -> ") == len(FILES) and "stage ms" not in out


def test_dense_wire_matches_jax_encoder(rng):
    planes = rng.random((3, 37, 50), dtype=np.float32)
    exif = b"Exif\x00\x00" + Image.Exif().tobytes()
    body = tjpeg.encode_jpeg(planes, quality=90, exif_bytes=exif)
    assert body == jjpeg.encode_jpeg(planes, quality=90, exif_bytes=exif)
    # The dense wire of a tensor converts on the planes' device.
    tensor = torch.from_numpy(planes)
    from_tensor = tjpeg.encode_jpeg(tensor, quality=90, sparse=False)
    assert _decode(io.BytesIO(from_tensor)).shape == (37, 50, 3)
    assert np.abs(_decode(io.BytesIO(from_tensor))
                  - _decode(io.BytesIO(tjpeg.encode_jpeg(planes, quality=90)))).max() <= 1
    # sparse=True on a tensor: the packed wire's bytes, as by default.
    packed = tbits.encode_packed_device(tensor, 90)
    assert tjpeg.encode_jpeg(tensor, quality=90, sparse=True) == packed
    assert tjpeg.encode_jpeg(tensor, quality=90) == packed


def test_mixed_directory_takes_the_editor_route(dng_dir, tmp_path, capsys):
    src = tmp_path / "in"
    src.mkdir()
    (src / "a_rggb.dng").write_bytes((dng_dir / "a_rggb.dng").read_bytes())
    from rawphotoforge_tpu_torch.io import image_io

    (src / "a_rggb.ppm").write_bytes(image_io.encode_ppm16(
        _planes(40, 60).transpose(1, 2, 0)))
    assert tcli.main(["batch", str(src), str(tmp_path / "o"), "--device", "cpu",
                      "--exposure", "0.3"]) == 0
    assert sorted(os.listdir(tmp_path / "o")) == ["a_rggb.jpg", "a_rggb_ppm.jpg"]
    assert "batch: 2 images" in capsys.readouterr().out


def test_develop_accepts_a_dng(dng_dir, tmp_path):
    ours, ref = tmp_path / "o.png", tmp_path / "r.png"
    args = [str(dng_dir / "d_orient6.dng")]
    assert tcli.main(["develop", *args, str(ours), *FLAGS, "--device", "cpu"]) == 0
    assert jcli.main(["develop", *args, str(ref), *FLAGS, "--jnp-path"]) == 0
    a = _decode(ours).astype(np.float64) / 255.0
    b = _decode(ref).astype(np.float64) / 255.0
    assert a.shape == b.shape == (144, 96, 3)
    assert_close(a, b, tight=1.0 / 255.0 + 1e-9, loose=2.0 / 255.0 + 1e-9)


def test_batch_needs_the_card_unless_asked(dng_dir, tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("the no-card error is for machines without a card")
    assert tcli.main(["batch", str(dng_dir), str(tmp_path)]) == 2
    assert "device='cpu'" in capsys.readouterr().err


def test_batch_kernel_is_the_twin_on_the_cpu(dng_dir, tmp_path):
    before = dict(trp.KERNEL_LAUNCHES)
    assert tcli.main(["batch", str(dng_dir), str(tmp_path), "--device", "cpu"]) == 0
    assert trp.KERNEL_LAUNCHES == before
