"""The hand-written CUDA develop kernel against its plain torch twin, on the
card. Every test here needs a CUDA device and skips without one (the
kernel has no CPU mode). The file imports neither jax nor the test
helpers, so on a machine without jax it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from rawphotoforge_tpu_torch.core.params import (
    BRIGHTNESS, HUE, LIGHTNESS, SATURATION, EditParameters, default_curve_slots,
    pack_params)
from rawphotoforge_tpu_torch.engine.editor import FULL, LOW, PhotoEditor
from rawphotoforge_tpu_torch.kernels import fused

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the develop kernel has no CPU mode")
    return torch.device("cuda")


def _close(ours, ref, tight=1e-4, loose=5e-3, frac=2e-3):
    """tests/test_develop.py:14's rule (tight 1e-4 for all but 2e-3 of the
    values, none beyond 5e-3), on card tensors."""
    d = (ours - ref).abs()
    assert (d > tight).float().mean().item() <= frac
    assert d.max().item() <= loose


def _params():
    p = EditParameters()
    p.set_tone(exposure=0.9, contrast=30, shadow=25, highlight=-15, black=8, white=-6)
    p.set_whitebalance(temperature=40, tint=-20)
    p.set_vignette(55)
    p.set_curve(BRIGHTNESS, [0, 20000, 45000, 65535], [2000, 28000, 43000, 65535])
    p.set_curve(HUE, [0, 30000, 65535], [8000, 35000, 62000])
    p.set_curve(SATURATION, [0, 40000, 65535], [36000, 28000, 36000])
    p.set_curve(LIGHTNESS, [0, 65535], [30000, 36000])
    q = EditParameters()
    q.set_tone(exposure=-0.4, contrast=40)
    q.set_curve(SATURATION, [0, 65535], [30000, 38000])
    r = EditParameters()
    r.set_curve(HUE, [0, 20000, 65535], [3000, 24000, 65535])
    return [p, q, r]


def _inputs(dev, h, w, m, dtype=torch.uint8):
    rng = np.random.default_rng(7)
    planes = torch.from_numpy(rng.random((3, h, w), dtype=np.float32) ** 2).to(dev)
    masks = (rng.random((m, h, w)) > 0.5).astype(np.uint8)
    masks[0] = 1
    return planes, torch.from_numpy(masks).to(dev).to(dtype)


@pytest.mark.parametrize("h,w", [(48, 160), (37, 150), (512, 768)])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
def test_kernel_matches_twin(dev, h, w, dtype):
    plist = _params()
    planes, masks = _inputs(dev, h, w, 3, dtype)
    params = pack_params(plist, extent=(h - 3, w - 5), device=dev)
    before = fused.LAUNCHES
    out = fused.develop_post_geo_fused(planes, params, masks, row_offset=5.0)
    torch.cuda.synchronize()
    assert fused.LAUNCHES == before + 1
    ref = fused.develop_post_geo_fused_ref(planes, params, masks, row_offset=5.0)
    _close(out, ref)


def test_shortcuts_bit_identical_on_the_card(dev):
    plist = _params()
    planes, masks = _inputs(dev, 64, 256, 3)
    params = pack_params(plist, device=dev)
    general = fused.develop_post_geo_fused(planes, params, masks)
    slots = fused.develop_post_geo_fused(planes, params, masks,
                                         default_curve_slots=default_curve_slots(plist))
    assert torch.equal(general, slots)
    tone = EditParameters()
    tone.set_tone(exposure=0.8, contrast=20)
    one = pack_params([tone], device=dev)
    base = fused.develop_post_geo_fused(planes, one, None, main_mask_all_ones=True)
    fast = fused.develop_post_geo_fused(planes, one, None, main_mask_all_ones=True,
                                        default_bright_curves=True,
                                        default_oklch_curves=True)
    assert torch.equal(base, fast)
    ident = fused.develop_post_geo_fused(planes, one, None, main_mask_all_ones=True,
                                         default_bright_curves=True,
                                         default_oklch_curves=True, identity_oklch=True)
    assert (ident - fast).abs().max().item() < 3e-3


def test_cuda_tensors_never_reach_the_twin(dev, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the twin ran for a CUDA tensor")

    monkeypatch.setattr(fused, "develop_post_geo_fused_ref", refuse)
    planes, _ = _inputs(dev, 16, 128, 1)
    params = pack_params([EditParameters()], device=dev)
    fused.develop_post_geo_fused(planes, params, None, main_mask_all_ones=True)
    with pytest.raises(ValueError, match="masks must be"):
        fused.develop_post_geo_fused(planes, params,
                                     torch.ones((1, 16, 128), dtype=torch.int32, device=dev))


def test_editor_on_the_card_matches_cpu_session(dev):
    rng = np.random.default_rng(3)
    img = rng.random((96, 160, 3), dtype=np.float32) ** 2
    eds = [PhotoEditor.from_rgb_f32(img, device=d, mid_long_edge=80, low_long_edge=40)
           for d in (dev, "cpu")]
    logits = np.zeros((96, 160), np.float32)
    logits[20:60, 30:120] = 1.0
    for ed in eds:
        ed.set_tone(exposure=0.5, contrast=20)
        ed.set_lens_distortion(-20)
        ed.set_sharpness(25)
        ed.set_curve(BRIGHTNESS, [0, 30000, 65535], [0, 35000, 65535])
        ed.add_mask("r", logits)
        ed.set_curve(SATURATION, [0, 65535], [30000, 36000], mask_name="r")
    for level in (FULL, LOW):
        _close(eds[0].apply(level).cpu(), eds[1].apply(level))
