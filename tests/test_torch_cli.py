"""The port's CLI against the JAX package's on the same files: ``develop``
of a small 16-bit PPM (and its typed errors), the host commands ``info``
(stdout fields, ``--preview``, ``--verify-decode``, the lens-match line),
``convert`` (the output DNG's bytes and mosaic), ``devices`` and
``batch --no-mesh``; plus the I/O surface they stand on (``io/image_io``'s
``format_for_bytes`` / ``read_image`` / ``write_image`` /
``linear_planes_to_srgb_u8``, ``io/raw.read_raw``) and ``core/tonelut``,
bit for bit where the JAX functions are host code."""

import numpy as np
import pytest

from rawphotoforge_tpu.app import cli as jcli
from rawphotoforge_tpu.io import image_io as jio

from rawphotoforge_tpu_torch.app import cli as tcli
from rawphotoforge_tpu_torch.io import image_io as tio

from torch_parity import assert_close_across, nongray_image

FLAGS = ["--exposure", "0.6", "--contrast", "20", "--wb-temperature", "15",
         "--vignette", "30", "--lens-distortion", "-20", "--sharpness", "25",
         "--brightness-curve", "0:0,30000:36000,65535:65535",
         "--hue-curve", "0:3000,65535:63000",
         "--saturation-curve", "0:30000,65535:36000"]


@pytest.fixture
def ppm(rng, tmp_path):
    path = tmp_path / "in.ppm"
    path.write_bytes(tio.encode_ppm16(nongray_image(rng, 40, 70)))
    return path


@pytest.mark.parametrize("exact", [False, True])
def test_develop_ppm_matches_jax_cli(ppm, tmp_path, capsys, exact):
    ours = tmp_path / "ours.ppm"
    ref = tmp_path / "ref.ppm"
    extra = ["--exact-path"] if exact else []
    assert tcli.main(["develop", str(ppm), str(ours), *FLAGS, *extra,
                      "--device", "cpu", "--histogram"]) == 0
    out = capsys.readouterr().out
    assert "developed 70x40" in out and "hist Y" in out
    assert jcli.main(["develop", str(ppm), str(ref), *FLAGS, "--jnp-path"]) == 0
    a = tio.decode_ppm16(ours.read_bytes())
    b = jio.decode_ppm16(ref.read_bytes())
    assert a.shape == b.shape == (40, 70, 3)
    # The files hold the LINEAR render (sRGB OETF undone) at 16 bits; the
    # sRGB renders met assert_close, and the EOTF's slope is below 1.
    assert_close_across(a, b, tight=2e-4)


def test_develop_png16_and_preset(ppm, tmp_path):
    out = tmp_path / "o.png"
    preset = tmp_path / "p.json"
    assert tcli.main(["develop", str(ppm), str(out), *FLAGS, "--bit-depth", "16",
                      "--device", "cpu", "--save-preset", str(preset)]) == 0
    u16 = tio._parse_png48(out.read_bytes())
    assert u16.shape == (40, 70, 3) and u16.dtype == np.uint16
    again = tmp_path / "again.png"
    assert tcli.main(["develop", str(ppm), str(again), "--preset", str(preset),
                      "--bit-depth", "16", "--device", "cpu"]) == 0
    assert again.read_bytes() == out.read_bytes()


@pytest.mark.parametrize("args,needle", [
    # Ids kept from when vendor RAW input, --lens-correct and the .dng HDR
    # export were refused here as not ported (all three are ported now:
    # test_torch_vendor.py, test_torch_lenscorr.py, test_torch_hdr_dng.py).
    # A vendor RAW extension is still no output format, as in the JAX CLI.
    pytest.param(["IN", "out.cr2"], "scene-linear HDR", id="args1-HDR export"),
    pytest.param(["IN", "out.jpg", "--bit-depth", "16"], "bit-depth 16",
                 id="args3-bit-depth 16"),
])
def test_develop_rejects_later_slices_with_typed_errors(ppm, capsys, args, needle):
    args = [str(ppm) if a == "IN" else a for a in args]
    assert tcli.main(["develop", *args, "--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert needle in err
    assert jcli.main(["develop", *args]) == 2
    assert needle in capsys.readouterr().err


def test_develop_defaults_to_the_card(ppm, tmp_path, capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("the no-card error is for machines without a card")
    assert tcli.main(["develop", str(ppm), str(tmp_path / "o.ppm")]) == 2
    assert "device='cpu'" in capsys.readouterr().err


# -- the host commands ----------------------------------------------------------

import dataclasses  # noqa: E402
import io  # noqa: E402

import torch  # noqa: E402

from rawphotoforge_tpu.core import tonelut as jtonelut  # noqa: E402
from rawphotoforge_tpu.io import dng as jdng, raw as jraw  # noqa: E402

from rawphotoforge_tpu_torch.core import tonelut as ttonelut  # noqa: E402
from rawphotoforge_tpu_torch.io import dng as tdng, raw as traw  # noqa: E402

import torch_fixtures as fx  # noqa: E402

XYZ_TO_CAM = np.array([[0.8, -0.1, -0.05], [-0.3, 1.1, 0.15],
                       [-0.05, 0.15, 0.65]])


def _run(main, argv, capsys):
    rc = main(argv)
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


def _jpeg(rng, h=24, w=32):
    return fx.jpeg_bytes(rng.integers(0, 255, (h, w, 3), dtype=np.uint8))


@pytest.fixture
def files(rng, tmp_path):
    """A DNG (DefaultCrop, orientation 6, a preview, EXIF with a lens the
    bundled database knows), an ARW2 whose preview matches its sensor data,
    one whose preview is another image, and a PNG."""
    scene = fx.scene(rng, 48, 64)
    raw = dataclasses.replace(
        traw.synthetic_raw(scene, "RGGB", xyz_to_cam=XYZ_TO_CAM),
        orientation=6, default_crop=(2, 4, 56, 40),
        exif={"Make": "Canon", "Model": "Canon EOS 5D Mark IV",
              "LensModel": "EF 50mm f/1.8 II", "FNumber": "2.8",
              "ExposureTime": "1/125", "ISO": "200"})
    out = {"dng": tmp_path / "a.dng", "arw": tmp_path / "b.arw",
           "arw_bad": tmp_path / "c.arw", "png": tmp_path / "d.png"}
    out["dng"].write_bytes(tdng.write_dng(raw, preview_jpeg=_jpeg(rng)))
    codes = fx.arw2_codes(rng, 64, 96)
    out["arw"].write_bytes(fx.arw2_file(codes, preview="match")[0])
    out["arw_bad"].write_bytes(fx.arw2_file(codes, preview=fx.noise_preview(10))[0])
    from PIL import Image

    Image.fromarray((nongray_image(rng, 20, 30) * 255).clip(0, 255).astype(
        np.uint8)).save(out["png"])
    return out


def _same_lines(ours, ref):
    """Line for line; the verify-decode correlation within 1e-4 (the gates'
    correlations agree within 1e-6, printed to 4 decimals)."""
    a, b = ours.splitlines(), ref.splitlines()
    assert len(a) == len(b), (ours, ref)
    for x, y in zip(a, b):
        if x.startswith("verify-decode: preview correlation"):
            assert abs(float(x.split()[3]) - float(y.split()[3])) <= 1e-4
            assert x.split("->")[1] == y.split("->")[1]
        else:
            assert x == y


@pytest.mark.parametrize("name,extra", [
    ("dng", []), ("dng", ["--verify-decode"]), ("arw", ["--verify-decode"]),
    ("arw_bad", ["--verify-decode"]), ("png", ["--verify-decode"]),
])
def test_info_matches_jax_cli(files, capsys, name, extra):
    path = str(files[name])
    rc, ours, err = _run(tcli.main, ["info", path, *extra, "--device", "cpu"], capsys)
    jrc, ref, _ = _run(jcli.main, ["info", path, *extra], capsys)
    assert rc == jrc, err
    _same_lines(ours, ref)
    if name == "dng":
        assert f"{path}: 40x56 (0.0 MPix)" in ours
        assert "lens profile match: " in ours
    if name == "arw_bad":
        # The gate refuses the decode: dimensions from the preview, and the
        # verification reports the refusal (exit 0, as in the JAX CLI).
        assert "embedded camera preview's" in ours
        assert "verify-decode: sensor data not decodable" in ours and rc == 0
    if name == "arw":
        assert ours.splitlines()[-1].endswith("-> ok") and rc == 0


def test_info_preview_extraction(files, tmp_path, capsys):
    ours, ref = tmp_path / "p1.jpg", tmp_path / "p2.jpg"
    rc, out, _ = _run(tcli.main, ["info", str(files["dng"]), "--preview", str(ours),
                                  "--device", "cpu"], capsys)
    assert rc == 0 and "embedded preview: " in out
    assert jcli.main(["info", str(files["dng"]), "--preview", str(ref)]) == 0
    assert ours.read_bytes() == ref.read_bytes()
    rc, out, _ = _run(tcli.main, ["info", str(files["png"]), "--preview",
                                  str(tmp_path / "none.jpg"), "--device", "cpu"], capsys)
    assert rc == 0 and "no embedded JPEG preview found" in out


@pytest.mark.parametrize("name", ["dng", "arw"])
@pytest.mark.parametrize("flags", [[], ["--codec", "deflate"], ["--tile", "16x32"],
                                   ["--no-preview"]], ids=lambda f: "-".join(f) or "ljpeg")
def test_convert_matches_jax_cli(files, tmp_path, capsys, name, flags):
    src = files[name]
    ours, ref = tmp_path / "ours.dng", tmp_path / "ref.dng"
    rc, out, err = _run(tcli.main, ["convert", str(src), str(ours), *flags], capsys)
    jrc, jout, _ = _run(jcli.main, ["convert", str(src), str(ref), *flags], capsys)
    assert rc == jrc == 0, err
    assert out == jout and out.startswith("converted ")
    assert ours.read_bytes() == ref.read_bytes()
    got = tdng.read_dng(ours.read_bytes(), apply_opcodes=False)
    want = traw.parse_raw(src.read_bytes(), apply_opcodes=False)
    assert np.array_equal(got.mosaic, want.mosaic) and got.pattern == want.pattern
    assert (tdng.extract_preview(ours.read_bytes()) is None) == ("--no-preview" in flags)


def test_convert_bad_tile_is_typed(files, tmp_path, capsys):
    rc, _, err = _run(tcli.main, ["convert", str(files["dng"]), str(tmp_path / "o.dng"),
                                  "--tile", "big"], capsys)
    assert rc == 2 and "bad tile" in err


def test_devices_lists_cuda_devices_only(capsys, monkeypatch):
    """The JAX CLI lists its backend's devices (the CPU here); the port
    lists CUDA devices and, with none, says so and fails: the CPU is not an
    accelerator."""
    jrc, jout, _ = _run(jcli.main, ["devices"], capsys)
    assert jrc == 0 and jout.startswith("[0] cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out, err = _run(tcli.main, ["devices"], capsys)
    assert rc == 1 and out == "" and "no CUDA device" in err

    class Props:
        name, total_memory, multi_processor_count = "NVIDIA H100 80GB HBM3", 80 << 30, 132

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda i: Props)
    rc, out, _ = _run(tcli.main, ["devices"], capsys)
    assert rc == 0 and out.splitlines() == [
        f"[{i}] cuda: NVIDIA H100 80GB HBM3 (80.0 GiB, 132 SMs)" for i in range(2)]


def test_batch_accepts_no_mesh(files, tmp_path, capsys):
    src = tmp_path / "in"
    src.mkdir()
    (src / "a.dng").write_bytes(files["dng"].read_bytes())
    rc, out, err = _run(tcli.main, ["batch", str(src), str(tmp_path / "out"),
                                    "--no-mesh", "--device", "cpu"], capsys)
    assert rc == 0, err
    assert "1 images" in out and (tmp_path / "out" / "a.jpg").exists()


# -- the I/O surface and the v1 tone LUT ---------------------------------------

@pytest.mark.parametrize("kw", [{}, dict(exposure=0.7, contrast=25, shadow=30,
                                         highlight=-20, black=10, white=-15),
                                dict(exposure=-1.5, contrast=-40, white=60)])
def test_tonelut_bit_equal(kw):
    ours = ttonelut.tone_lut_from_params(**kw)
    assert np.array_equal(ours, jtonelut.tone_lut_from_params(**kw))
    assert ours.dtype == np.float32 and ours.shape == (65536,)
    lut = ttonelut.tone_lut_i32(**kw)
    assert np.array_equal(lut, jtonelut.tone_lut_i32(**kw)) and lut.dtype == np.int32


def test_format_for_bytes_matches_jax(files):
    heads = [files[k].read_bytes() for k in ("dng", "arw", "png")]
    heads += [b"FUJIFILMCCD-RAW 0201", b"\x00\x00\x00\x18ftypcrx ", b"FOVb....",
              b"P6\n# c\n4 2\n65535\n" + bytes(48), b"P6 4 2 255\n" + bytes(24),
              b"P6#x\n4 2 65535 ", b"\xff\xd8\xff\xe0", b"IIU\x00" + bytes(12)]
    for data in heads:
        assert tio.format_for_bytes(data) == jio.format_for_bytes(data), data[:16]


@pytest.mark.parametrize("name", ["png", "dng", "ppm"])
def test_read_image_matches_jax(files, ppm, name):
    path = str(ppm if name == "ppm" else files[name])
    ours, exif = tio.read_image(path, device="cpu")
    ref, jexif = jio.read_image(path)
    assert tuple(ours.shape) == tuple(ref.shape)
    assert {k: v for k, v in exif.items() if k != "_exif_bytes"} == {
        k: v for k, v in jexif.items() if k != "_exif_bytes"}
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    data = open(path, "rb").read()
    planes, _ = tio.decode_image(data, tio.format_for_path(path), device="cpu")
    assert torch.equal(planes, ours)


def test_read_raw_matches_jax(files):
    data = files["dng"].read_bytes()
    ours, exif = traw.read_raw(data, device="cpu")
    ref, jexif = jraw.read_raw(data)
    assert exif == jexif and tuple(ours.shape) == tuple(ref.shape) == (3, 56, 40)
    assert np.abs(ours.numpy() - np.asarray(ref)).max() <= 1e-5
    again, _ = traw.read_raw(str(files["dng"]), device="cpu")
    assert torch.equal(again, ours)


def test_write_image_and_srgb_u8_match_jax(rng, tmp_path):
    lin = rng.uniform(-0.1, 1.2, (3, 18, 26)).astype(np.float32)
    ours = tio.linear_planes_to_srgb_u8(torch.from_numpy(lin))
    ref = jio.linear_planes_to_srgb_u8(lin)
    assert ours.dtype == np.uint8 and ours.shape == (18, 26, 3)
    # The truncating u8 cast of OETF outputs a few f32 ulps apart.
    assert np.abs(ours.astype(int) - ref.astype(int)).max() <= 1
    srgb = rng.random((3, 18, 26), dtype=np.float32)
    for ext in ("png", "ppm"):
        a, b = tmp_path / f"a.{ext}", tmp_path / f"b.{ext}"
        tio.write_image(str(a), torch.from_numpy(srgb))
        jio.write_image(str(b), srgb)
        assert a.read_bytes() == b.read_bytes()
    with pytest.raises(tio.ImageIOError):
        tio.write_image(str(tmp_path / "x.dng"), torch.from_numpy(srgb))
