"""The port's RAW host I/O against the JAX package's on the CPU: DNG bytes
written by both writers are equal, both readers return the same fields
for the same file, the lossless-JPEG codec agrees, and the device
develops (exact extent and bucket-stable padded) agree for Bayer and
X-Trans at EXIF orientations 1-8, each with and without a DefaultCrop.
Plus the editor's RAW open and its embedded-preview fallback (the vendor
containers and OpcodeList3 are in test_torch_vendor.py and
test_torch_lenscorr.py)."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rawphotoforge_tpu.io import dng as jdng, ljpeg as jljpeg, raw as jraw

from rawphotoforge_tpu_torch.engine.editor import FULL, PhotoEditor
from rawphotoforge_tpu_torch.io import dng as tdng, ljpeg as tljpeg, raw as traw

XYZ_TO_CAM = np.array([[0.8, -0.1, -0.05], [-0.3, 1.1, 0.15],
                       [-0.05, 0.15, 0.65]])
WRITES = [
    dict(compression=1), dict(compression=7), dict(compression=7, tile=(32, 48)),
    dict(compression=8), dict(compression=8, tile=(32, 48), predictor=34892),
]


def _planes(rng, h=64, w=96):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    smooth = np.stack([yy / h, xx / w, (yy + xx) / (h + w)])
    return (0.7 * smooth + 0.2 * rng.random((3, h, w), dtype=np.float32))


def _raws(rng, pattern, **fields):
    j = dataclasses.replace(
        jraw.synthetic_raw(_planes(rng), pattern, xyz_to_cam=XYZ_TO_CAM),
        **fields)
    return j, traw.raw_image_from_numpy(dataclasses.asdict(j))


def _assert_same_raw(a, b):
    assert np.array_equal(a.mosaic, b.mosaic) and a.mosaic.dtype == b.mosaic.dtype
    for f in ("pattern", "black_level", "white_level", "wb_gains", "orientation",
              "default_crop", "exif", "wb_known"):
        assert getattr(a, f) == getattr(b, f), f
    assert (a.xyz_to_cam is None) == (b.xyz_to_cam is None)
    if a.xyz_to_cam is not None:
        assert np.array_equal(a.xyz_to_cam, b.xyz_to_cam)


@pytest.mark.parametrize("pattern", ["RGGB", "XTRANS"])
@pytest.mark.parametrize("kw", WRITES, ids=lambda k: "-".join(map(str, k.values())))
def test_write_and_read_dng_match(rng, pattern, kw):
    j, t = _raws(rng, pattern, orientation=6, default_crop=(2, 4, 80, 50),
                 exif={"Make": "Synthetic", "Model": "m", "ISO": "200",
                       "ExposureTime": "1/250", "FNumber": "2.8"})
    data = jdng.write_dng(j, **kw)
    assert tdng.write_dng(t, **kw) == data
    _assert_same_raw(tdng.read_dng(data), jdng.read_dng(data))


def test_ljpeg_codec_matches(rng):
    samples = rng.integers(0, 4096, (24, 20, 2)).astype(np.uint16)
    for kw in (dict(precision=12, predictor=1), dict(precision=14, predictor=6,
                                                     restart_interval=15)):
        enc = jljpeg.encode(samples, **kw)
        assert tljpeg.encode(samples, **kw) == enc
        ours, frame = tljpeg.decode(enc)
        ref, _ = jljpeg.decode(enc)
        assert np.array_equal(ours, ref) and frame.ncomp == 2


def test_preview_and_container_exif(rng):
    from PIL import Image
    import io

    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 255, (40, 60, 3)).astype(np.uint8)).save(
        buf, "JPEG")
    j, _ = _raws(rng, "RGGB", exif={"Make": "Synthetic", "Model": "m",
                                    "DateTime": "2024:01:02 03:04:05"})
    data = jdng.write_dng(j, preview_jpeg=buf.getvalue())
    assert tdng.extract_preview(data) == jdng.extract_preview(data)
    assert tdng.extract_container_exif(data) == jdng.extract_container_exif(data)


def _jax_padded(raw):
    return np.asarray(jraw.develop_raw_image_padded(raw))


CROP = (3, 5, 70, 41)
# The first five cases keep their ids from before the orientations were
# widened; then EXIF orientations 1-8, each with and without a DefaultCrop,
# for a Bayer pattern (cycling through the four) and for X-Trans.
_FIRST = [("RGGB", {}), ("GRBG", {"orientation": 6}), ("XTRANS", {}),
          ("XTRANS", {"orientation": 6}), ("RGGB", {"default_crop": CROP})]
_WIDE = [(pattern, dict({"orientation": o}, **({"default_crop": CROP} if crop else {})))
         for o in range(1, 9) for crop in (False, True)
         for pattern in (("RGGB", "GBRG", "GRBG", "BGGR")[o % 4], "XTRANS")]
DEVELOP_CASES = [pytest.param(p, f, id=f"{p}-fields{i}") for i, (p, f) in enumerate(_FIRST)] + [
    pytest.param(p, f, id=f"{p}-o{f['orientation']}" + ("-crop" if "default_crop" in f else ""))
    for p, f in _WIDE
    if (p, f) not in _FIRST and not (f == {"orientation": 1} and (p, {}) in _FIRST)]


@pytest.mark.parametrize("pattern,fields", DEVELOP_CASES)
def test_develop_raw_image_matches(rng, pattern, fields):
    j, t = _raws(rng, pattern, **fields)
    ours, exif = traw.develop_raw_image(t, device="cpu")
    ref, jexif = jraw.develop_raw_image(j)
    assert exif == jexif
    assert tuple(ours.shape) == tuple(ref.shape)
    assert np.abs(ours.numpy() - np.asarray(ref)).max() <= 1e-5
    assert traw.bucket_stable_eligible(t) == jraw.bucket_stable_eligible(j)
    if traw.bucket_stable_eligible(t):
        padded = traw.develop_raw_image_padded(t, device="cpu")
        ref_p = _jax_padded(j)
        assert tuple(padded.shape) == ref_p.shape
        assert np.abs(padded.numpy() - ref_p).max() <= 1e-5
        h, w = ours.shape[1:]
        # The true region of the padded develop is the exact develop.
        assert torch.equal(padded[:, :h, :w], ours)


def test_gray_world_gains_match(rng):
    j, t = _raws(rng, "XTRANS", wb_known=False, wb_gains=(1.0, 1.0, 1.0))
    assert traw.with_effective_wb(t).wb_gains == jraw._with_effective_wb(j).wb_gains
    assert traw.synthetic_raw(_planes(np.random.default_rng(3)), "GBRG").mosaic.tobytes() \
        == jraw.synthetic_raw(_planes(np.random.default_rng(3)), "GBRG").mosaic.tobytes()


def test_editor_opens_a_dng(rng, tmp_path):
    j, t = _raws(rng, "XTRANS", orientation=6)
    path = tmp_path / "x.dng"
    path.write_bytes(jdng.write_dng(j, compression=7))
    ed = PhotoEditor.open(str(path), device="cpu")
    assert ed.shape == (96, 64) and ed.opened_from_preview is None
    ref = _jax_padded(jraw.parse_raw(path.read_bytes()))
    assert np.abs(ed._original_at(FULL).numpy() - ref).max() <= 1e-5
    out = ed.apply(FULL)
    assert tuple(out.shape) == (3, 96, 64) and bool(torch.isfinite(out).all())


def test_editor_falls_back_to_the_embedded_preview(rng, monkeypatch):
    from PIL import Image
    import io

    buf = io.BytesIO()
    Image.fromarray(np.full((30, 50, 3), 128, np.uint8)).save(buf, "JPEG")
    j, _ = _raws(rng, "RGGB")
    data = jdng.write_dng(j, preview_jpeg=buf.getvalue())

    def refuse(_data):
        raise tdng.DngError("sensor data the port cannot decode")

    monkeypatch.setattr(traw, "parse_raw", refuse)
    ed = PhotoEditor.from_bytes(data, "DNG", device="cpu")
    assert ed.shape == (30, 50)
    assert "cannot decode" in ed.opened_from_preview
    # Without a preview to open, the decode error propagates.
    with pytest.raises(tdng.DngError, match="cannot decode"):
        PhotoEditor.from_bytes(jdng.write_dng(j), "DNG", device="cpu")
