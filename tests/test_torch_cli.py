"""The port's ``cli develop`` on a small 16-bit PPM, against the JAX
package's CLI on the same file and flags; and the typed errors for the
outputs that later slices of the port bring."""

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
    # Ids kept from when vendor RAW input and --lens-correct were refused
    # here too (both are ported now: test_torch_vendor.py and
    # test_torch_lenscorr.py).
    pytest.param(["IN", "out.dng"], "HDR export", id="args1-HDR export"),
    pytest.param(["IN", "out.jpg", "--bit-depth", "16"], "bit-depth 16",
                 id="args3-bit-depth 16"),
])
def test_develop_rejects_later_slices_with_typed_errors(ppm, capsys, args, needle):
    args = [str(ppm) if a == "IN" else a for a in args]
    assert tcli.main(["develop", *args, "--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert needle in err
    if needle != "bit-depth 16":
        assert "ROADMAP.md" in err


def test_develop_defaults_to_the_card(ppm, tmp_path, capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("the no-card error is for machines without a card")
    assert tcli.main(["develop", str(ppm), str(tmp_path / "o.ppm")]) == 2
    assert "device='cpu'" in capsys.readouterr().err
