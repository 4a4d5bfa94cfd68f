"""The port's HDR DNG export against the JAX package's on the CPU:
``engine/editor.hdr_dng_encode`` of the same f16 and f32 planes gives the
JAX function's bytes; the editor's round trip meets the bounds of JAX
``tests/test_editor.py:370-393`` (f16 within 2e-3, f32 within 1e-6 of the
clipped render); ``cli develop OUT.dng`` writes a float LinearRaw DNG whose
data meets ``assert_close_across`` against the JAX CLI's file."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rawphotoforge_tpu.app import cli as jcli
from rawphotoforge_tpu.engine import editor as jeditor
from rawphotoforge_tpu.io import dng as jdng

from rawphotoforge_tpu_torch.app import cli as tcli
from rawphotoforge_tpu_torch.core.color import srgb_to_linear
from rawphotoforge_tpu_torch.engine import editor as teditor
from rawphotoforge_tpu_torch.engine.editor import FULL, PhotoEditor
from rawphotoforge_tpu_torch.io import dng as tdng, image_io
from rawphotoforge_tpu_torch.io.raw import read_raw

from conftest import random_linear_image
from torch_parity import assert_close_across, nongray_image

EXIF = {"Make": "Canon", "Model": "EOS R5", "ExposureTime": "1/250",
        "FNumber": "2.8", "ISO": "400", "LensModel": "RF50mm F1.2 L USM"}


@pytest.mark.parametrize("dtype", [np.float16, np.float32])
@pytest.mark.parametrize("crop", [None, (3, 17, 5, 29)])
def test_hdr_dng_encode_bytes_equal_jax(rng, dtype, crop):
    linear = rng.uniform(0.0, 1.3, (3, 21, 34)).astype(np.float32)
    stages = []
    ours = teditor.hdr_dng_encode(torch.from_numpy(linear), EXIF, dtype=dtype,
                                  on_stage=stages.append, host_crop=crop)
    ref = jeditor.hdr_dng_encode(jnp.asarray(linear), EXIF, dtype=dtype,
                                 host_crop=crop)
    assert ours == ref
    assert stages == ["fetch", "encode"]
    raw = tdng.read_dng(ours)
    assert raw.pattern == "RGB" and raw.mosaic.dtype == np.float32
    assert raw.exif["Make"] == "Canon" and raw.exif["ExposureTime"] == "1/250"


def test_save_hdr_dng_round_trip(rng, tmp_path):
    """JAX tests/test_editor.py:370-393 on the port: the edited linear render
    round-trips through the float DNG within fp16 quantization, and the f32
    export equals the clipped render within 1e-6."""
    img = random_linear_image(rng, 24, 32)
    ed = PhotoEditor.from_rgb_f32(img, device="cpu", use_kernel=False)
    ed.set_tone(exposure=0.6, contrast=25)
    ed.set_vignette(30)
    p = tmp_path / "hdr.dng"
    ed.save_hdr_dng(str(p))
    want = srgb_to_linear(ed.apply()).numpy()
    got, exif = read_raw(str(p), device="cpu")
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3)
    ed.save_hdr_dng(str(p), dtype=np.float32)
    got32, _ = read_raw(p.read_bytes(), device="cpu")
    np.testing.assert_allclose(got32.numpy(), np.clip(want, 0, 1), atol=1e-6)


def test_hdr_dng_matches_jax_editor(rng):
    img = nongray_image(rng, 30, 44)
    ours = PhotoEditor.from_rgb_f32(img, device="cpu", use_kernel=False, exif=dict(EXIF))
    ref = jeditor.PhotoEditor.from_rgb_f32(img, use_pallas=False, exif=dict(EXIF))
    for ed in (ours, ref):
        ed.set_tone(exposure=0.5, contrast=20)
        ed.set_whitebalance(temperature=15)
        ed.set_crop(3, 4, 40, 27)
    a, b = tdng.read_dng(ours.hdr_dng_bytes()), jdng.read_dng(ref.hdr_dng_bytes())
    assert a.mosaic.shape == b.mosaic.shape == (23, 37, 3)
    assert a.exif == b.exif
    assert_close_across(a.mosaic, b.mosaic)
    lin, crop, exif = ours.hdr_dng_render()
    assert crop == (4, 27, 3, 40) and tuple(lin.shape) == (3, 30, 44)
    assert exif["Model"] == "EOS R5"


def test_save_dng_is_not_a_display_encode(rng, tmp_path):
    """save() to .dng refuses before touching the file, as the JAX editor
    does (the HDR export is save_hdr_dng)."""
    ed = PhotoEditor.from_rgb_f32(random_linear_image(rng, 16, 20), device="cpu")
    out = tmp_path / "keep.dng"
    out.write_bytes(b"precious")
    with pytest.raises(image_io.ImageIOError, match="cannot encode a developed"):
        ed.save(str(out))
    assert out.read_bytes() == b"precious"


def test_cli_develop_hdr_dng_output(rng, tmp_path):
    from PIL import Image

    src = tmp_path / "in.png"
    arr = (nongray_image(rng, 20, 28) * 255).clip(0, 255).astype(np.uint8)
    Image.fromarray(arr).save(src)
    ours, ref = tmp_path / "ours.dng", tmp_path / "ref.dng"
    flags = ["--exposure", "0.4", "--contrast", "10"]
    assert tcli.main(["develop", str(src), str(ours), *flags, "--exact-path",
                      "--device", "cpu"]) == 0
    assert jcli.main(["develop", str(src), str(ref), *flags, "--jnp-path"]) == 0
    a, b = tdng.read_dng(ours.read_bytes()), jdng.read_dng(ref.read_bytes())
    assert a.pattern == b.pattern == "RGB" and a.mosaic.dtype == np.float32
    assert a.mosaic.shape == b.mosaic.shape == (20, 28, 3)
    assert_close_across(a.mosaic, b.mosaic)
    # A vendor RAW extension is not the HDR export.
    assert tcli.main(["develop", str(src), str(tmp_path / "o.cr2"), "--device",
                      "cpu"]) == 2
