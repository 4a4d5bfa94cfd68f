"""The port's PhotoEditor against the JAX package's, on the same image,
masks and preset JSON; plus the session behaviours (masks, crop, presets,
caches, export, the device rule) at small sizes on the CPU."""

import json

import numpy as np
import pytest
import torch

from rawphotoforge_tpu.engine.editor import PhotoEditor as JEditor

from rawphotoforge_tpu_torch._errbase import PhotoEditorError
from rawphotoforge_tpu_torch.core.params import BRIGHTNESS, HUE, LIGHTNESS, SATURATION
from rawphotoforge_tpu_torch.engine.editor import (
    FULL, LOW, MID, MaskNotFound, PhotoEditor)
from rawphotoforge_tpu_torch.io import image_io
from rawphotoforge_tpu_torch.kernels import fused

from test_develop import assert_close
from torch_parity import assert_close_across, nongray_image

KW = dict(mid_long_edge=40, low_long_edge=20)


def _edit(ed, with_masks=True):
    ed.set_tone(exposure=0.6, contrast=20, shadow=10, highlight=-10)
    ed.set_whitebalance(temperature=20, tint=-5)
    ed.set_vignette(35)
    ed.set_lens_distortion(-25)
    ed.set_sharpness(30)
    ed.set_curve(BRIGHTNESS, [0, 20000, 65535], [1000, 24000, 65535])
    ed.set_curve(HUE, [0, 30000, 65535], [4000, 33000, 63000])
    if with_masks:
        h, w = ed.shape
        a = np.zeros((h, w), np.float32)
        a[h // 4:(3 * h) // 4, :w // 2] = 1.0
        b = np.tile((np.arange(w) % 3 == 0).astype(np.float32), (h, 1))
        ed.add_mask("left", a)
        ed.add_mask("stripes", b)
        ed.set_tone(exposure=-0.5, contrast=30, mask_name="left")
        ed.set_curve(SATURATION, [0, 65535], [30000, 38000], mask_name="stripes")


def _pair(rng, h=48, w=80, use_kernel=True, with_masks=True):
    img = nongray_image(rng, h, w)
    ours = PhotoEditor.from_rgb_f32(img, device="cpu", use_kernel=use_kernel, **KW)
    ref = JEditor.from_rgb_f32(img, use_pallas=False, **KW)
    _edit(ours, with_masks)
    # The JAX session gets the same edits through the preset JSON (masks
    # cross as numpy arrays: the same logits added by name).
    if with_masks:
        for m in ours.masks[1:]:
            ref.add_mask(m.name, m.logits)
    ref.load_preset_json(ours.preset_json())
    return ours, ref


@pytest.mark.parametrize("level", [FULL, MID, LOW])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_renders_match_jax_editor(rng, level, use_kernel):
    """Port renders (kernel twin, or exact-LUT anchor) vs the JAX editor's
    exact-LUT anchor render, geometry and sharpen active, M=3."""
    ours, ref = _pair(rng, use_kernel=use_kernel)
    a = ours.apply(level).numpy()
    b = np.asarray(ref.apply(level))
    assert a.shape == b.shape == (3, *ours.level_shape(level))
    assert_close_across(a.transpose(1, 2, 0), b.transpose(1, 2, 0))


def test_histogram_crop_and_clipping_match_jax_editor(rng):
    ours, ref = _pair(rng, use_kernel=False)
    # Histograms of renders that agree to assert_close: within one count
    # per bin for the few pixels that sit on a bin edge.
    for level in (FULL, MID):
        ho, hr = ours.histogram(level), np.asarray(ref.histogram(level))
        assert ho.shape == (4, 256) and np.abs(ho - hr).max() <= 1
    for ed in (ours, ref):
        ed.set_crop(7, 5, 61, 40)
    assert ours.cropped_shape == ref.cropped_shape == (35, 54)
    a, b = ours.apply(FULL).numpy(), np.asarray(ref.apply(FULL))
    assert a.shape == b.shape == (3, 35, 54)
    assert_close_across(a.transpose(1, 2, 0), b.transpose(1, 2, 0))
    ho, hr = ours.histogram(MID), np.asarray(ref.histogram(MID))
    assert np.abs(ho - hr).max() <= 1 and ho.sum() == hr.sum()
    co, cr = ours.clipping(FULL), ref.clipping(FULL)
    for k in co:
        assert co[k] == pytest.approx(cr[k], abs=2.0 / (35 * 54))


def test_kernel_path_matches_exact_path_within_port(rng):
    """The editor's kernel render (slot table, M=3) against its own
    exact-LUT anchor render: the kernel-vs-anchor gate."""
    img = nongray_image(rng, 48, 80)
    img[:4, :4] = 0.0  # gray is well-defined within one framework
    eds = [PhotoEditor.from_rgb_f32(img, device="cpu", use_kernel=k, **KW)
           for k in (True, False)]
    for ed in eds:
        _edit(ed)
    for level in (FULL, LOW):
        assert_close(eds[0].apply(level).numpy().transpose(1, 2, 0),
                     eds[1].apply(level).numpy().transpose(1, 2, 0))


def test_slider_only_session_takes_identity_variant(rng, monkeypatch):
    seen = {}
    real = fused.develop_post_geo_fused

    def spy(*a, **kw):
        seen.update(kw)
        return real(*a, **kw)

    monkeypatch.setattr(fused, "develop_post_geo_fused", spy)
    ed = PhotoEditor.from_rgb_f32(nongray_image(rng, 32, 48), device="cpu", **KW)
    ed.set_tone(exposure=0.5)
    ed.apply(FULL)
    assert seen["identity_oklch"] and seen["default_bright_curves"]
    assert seen["default_curve_slots"] is None
    ed.set_curve(LIGHTNESS, [0, 65535], [30000, 36000])
    ed.apply(FULL)
    assert not seen["identity_oklch"] and not seen["default_oklch_curves"]


def test_masks_lifecycle_invert_and_rethreshold(rng):
    ed = PhotoEditor.from_rgb_f32(nongray_image(rng, 40, 64), device="cpu", **KW)
    logits = np.linspace(0, 1, 40 * 64, dtype=np.float32).reshape(40, 64)
    ed.add_mask("grad", logits)
    assert ed.mask_names() == ["main", "grad"]
    assert ed.masks[1].data_full.dtype == torch.uint8
    with pytest.raises(ValueError):
        ed.add_mask("grad", logits)
    with pytest.raises(ValueError):
        ed.add_mask("", logits)
    with pytest.raises(MaskNotFound):
        ed.set_tone(exposure=1.0, mask_name="nope")
    ed.set_tone(exposure=1.5, mask_name="grad")
    stack = ed._masks_at(FULL)
    assert stack.dtype == torch.uint8 and tuple(stack.shape) == (2, 128, 128)
    assert int(stack[1].sum()) == 40 * 64  # threshold 0: every pixel
    ed.set_mask_range(0.5)
    assert int(ed._masks_at(FULL)[1].sum()) == int((logits >= 0.5).sum())
    before = ed.apply(FULL).clone()
    ed.invert_mask("grad")
    assert int(ed._masks_at(FULL)[1].sum()) == int((logits < 0.5).sum())
    assert not torch.equal(before, ed.apply(FULL))
    low = ed._masks_at(LOW)
    assert low.dtype == torch.uint8 and set(low.unique().tolist()) <= {0, 1}
    ed.remove_mask("grad")
    with pytest.raises(MaskNotFound):
        ed.remove_mask("grad")
    assert ed.mask_names() == ["main"]


def test_render_cache_geo_cache_and_reset(rng):
    ed = PhotoEditor.from_rgb_f32(nongray_image(rng, 40, 64), device="cpu", **KW)
    a = ed.apply(LOW)
    assert ed.apply(LOW) is a
    ed.set_lens_distortion(30)
    geo = ed._geo_at(FULL)
    ed.set_tone(exposure=1.0)
    assert ed._geo_at(FULL) is geo  # tone edits never re-run the warp
    ed.set_crop(0, 0, 10, 10)
    ed.reset()
    assert ed.crop_rect is None and ed.params().to_json() == type(ed.params())().to_json()


def test_preset_round_trip_and_atomic_load(rng):
    ours, ref = _pair(rng)
    ours.set_crop(3, 4, 50, 30)
    s = ours.preset_json()
    ref.load_preset_json(s)
    assert json.loads(ref.preset_json()) == json.loads(s)
    fresh = PhotoEditor.from_rgb_f32(nongray_image(rng, 48, 80), device="cpu", **KW)
    fresh.load_preset_json(ref.preset_json())
    assert fresh.crop_rect == (3, 4, 50, 30)
    bad = json.loads(s)
    bad["crop"] = [500, 500, 600, 600]
    state = fresh.preset_json()
    with pytest.raises(ValueError):
        fresh.load_preset_json(json.dumps(bad))
    assert fresh.preset_json() == state


def test_bucket_padded_open_and_true_shape(rng, tmp_path):
    img = nongray_image(rng, 40, 70)
    path = tmp_path / "in.ppm"
    path.write_bytes(image_io.encode_ppm16(img))
    ed = PhotoEditor.open(str(path), device="cpu", **KW)
    assert ed.shape == (40, 70) and tuple(ed._originals[FULL].shape) == (3, 128, 128)
    ref = JEditor.open(str(path), use_pallas=False, **KW)
    # u16 / 65535 on the host-decoded samples; XLA folds the constant
    # division into a reciprocal multiply, so one ulp apart at most.
    np.testing.assert_allclose(ed._originals[FULL].numpy(),
                               np.asarray(ref._originals[FULL]), rtol=1.2e-7, atol=0)
    with pytest.raises(ValueError):
        PhotoEditor(torch.zeros((3, 64, 64)), true_shape=(40, 70), device="cpu")


def test_save_and_reopen(rng, tmp_path):
    ed = PhotoEditor.from_rgb_f32(nongray_image(rng, 40, 64), device="cpu", **KW)
    ed.set_tone(exposure=0.3)
    srgb = ed.apply(FULL).numpy()
    ed.save(str(tmp_path / "o.png"))
    ed.save(str(tmp_path / "o16.png"), bit_depth=16)
    ed.save(str(tmp_path / "o.ppm"))
    from PIL import Image

    u8 = np.asarray(Image.open(tmp_path / "o.png"))
    np.testing.assert_array_equal(u8, (np.clip(srgb, 0, 1) * 255).astype(np.uint8).transpose(1, 2, 0))
    u16 = image_io._parse_png48((tmp_path / "o16.png").read_bytes())
    np.testing.assert_array_equal(u16, (np.clip(srgb, 0, 1) * 65535).astype(np.uint16).transpose(1, 2, 0))
    back = PhotoEditor.open(str(tmp_path / "o16.png"), device="cpu", **KW)
    assert back.shape == (40, 64)
    lin = image_io.decode_ppm16((tmp_path / "o.ppm").read_bytes())
    assert lin.shape == (40, 64, 3) and np.isfinite(lin).all()
    with pytest.raises(image_io.ImageIOError):
        ed.save(str(tmp_path / "o.jpg"), bit_depth=16)
    with pytest.raises(PhotoEditorError, match="ROADMAP"):
        ed.save(str(tmp_path / "o.dng"))


def test_large_jpeg_export_names_the_missing_encoder():
    planes = torch.zeros((3, 2048, 2048))
    with pytest.raises(image_io.ImageIOError, match="ROADMAP"):
        image_io.encode_image(planes, "JPEG")


def test_device_rule(rng):
    img = nongray_image(rng, 16, 16)
    if torch.cuda.is_available():
        pytest.skip("the no-card error is for machines without a card")
    for make in (lambda: PhotoEditor.from_rgb_f32(img),
                 lambda: PhotoEditor(torch.zeros((3, 8, 8)))):
        with pytest.raises(PhotoEditorError, match="device='cpu'"):
            make()
    from rawphotoforge_tpu_torch.core.params import EditParameters, pack_params

    with pytest.raises(PhotoEditorError, match="device='cpu'"):
        pack_params([EditParameters()])
    with pytest.raises(PhotoEditorError, match="lens"):
        PhotoEditor.open("x.ppm", lens_correct=True, device="cpu")


def test_original_srgb_and_apply_padded_match_jax_editor(rng):
    ours, ref = _pair(rng, use_kernel=False)
    for ed in (ours, ref):
        ed.set_crop(4, 6, 70, 44)
    for level, cropped in ((MID, True), (FULL, False)):
        a = ours.original_srgb(level, cropped=cropped).numpy()
        b = np.asarray(ref.original_srgb(level, cropped=cropped))
        # Resize and OETF only: a few f32 ulps between the frameworks.
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-6)
    padded, extent = ours.apply_padded(FULL)
    assert extent == (48, 80) and tuple(padded.shape) == (3, 128, 128)
    assert torch.equal(padded[:, :48, :80], ours.apply(FULL, cropped=False))
