"""The port's counterpart of tests/test_fuzz.py: random full-parameter
draws through the port's exact-LUT anchor and its develop kernel's twin,
held against the JAX package's anchor; the jax-free copy of the draws
(tests/torch_fixtures.random_params, which tools/torch_card_fuzz.py and
chip_smoke.py use on the card) against the JAX one; and random editor
cache-coherence sequences on the port's PhotoEditor."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rawphotoforge_tpu.core.params import pack_params as jpack
from rawphotoforge_tpu.ops import develop as jdev

from rawphotoforge_tpu_torch.core.params import pack_params
from rawphotoforge_tpu_torch.kernels import fused
from rawphotoforge_tpu_torch.ops import develop as tdev

from conftest import random_linear_image
from test_fuzz import _random_params as jax_random_params
from torch_fixtures import (assert_fuzz_close, assert_staircase_explained,
                            random_params)

PACKED_FIELDS = ("gains", "tone", "vignette", "distortion", "luts",
                 "bright_channel", "breaks", "coeffs", "extent")


def _draw(seed, h, w, max_masks, geometry_first):
    """The same draw as tests/test_fuzz.py's: image, one edit a mask, then
    the masks, from two Generators of one seed (one for each package)."""
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
    img = (rj.random((h, w, 3), dtype=np.float32) ** 1.8).astype(np.float32)
    rt.random((h, w, 3), dtype=np.float32)
    n_masks = int(rj.integers(1, max_masks + 1))
    rt.integers(1, max_masks + 1)
    jp = [jax_random_params(rj, allow_geometry=geometry_first and k == 0)
          for k in range(n_masks)]
    tp = [random_params(rt, allow_geometry=geometry_first and k == 0)
          for k in range(n_masks)]
    masks = np.zeros((n_masks, h, w), dtype=np.float32)
    masks[0] = 1.0
    for k in range(1, n_masks):
        masks[k] = (rj.random((h, w)) > 0.5).astype(np.float32)
        rt.random((h, w))
    assert rj.random() == rt.random()  # both consumed the same draws
    return img, masks, jp, tp


@pytest.mark.parametrize("seed", range(32))
def test_random_params_copy_packs_like_the_jax_draw(seed):
    """tests/torch_fixtures.random_params makes the same Generator calls as
    tests/test_fuzz.py's _random_params: the packed parameters are equal."""
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
    geo = bool(seed % 2)
    jp = jpack([jax_random_params(rj, allow_geometry=geo) for _ in range(1 + seed % 3)])
    tp = pack_params([random_params(rt, allow_geometry=geo) for _ in range(1 + seed % 3)],
                     device="cpu")
    assert rj.random() == rt.random()
    for name in PACKED_FIELDS:
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)), err_msg=name)


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_port_anchor_vs_jax_anchor(seed):
    """The port's exact-LUT anchor (geometry included) against the JAX
    package's develop_jit on random full-parameter draws, 40x56."""
    img, masks, jp, tp = _draw(1000 + seed, 40, 56, 3, geometry_first=True)
    planes = img.transpose(2, 0, 1).copy()
    ref = np.asarray(jdev.develop_jit(jnp.asarray(planes), jpack(jp),
                                      jnp.asarray(masks)))
    ours = tdev.develop(torch.from_numpy(planes), pack_params(tp, device="cpu"),
                        torch.from_numpy(masks)).numpy()
    assert_fuzz_close(ours.transpose(1, 2, 0), ref.transpose(1, 2, 0))


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_port_twin_vs_jax_anchor(seed):
    """The develop kernel's twin (what the CUDA kernel equals bit for bit)
    against the JAX package's exact-LUT anchor on random draws, 32x128,
    and every outlier explained by an adjacent-index flip of the port's
    own anchor."""
    img, masks, jp, tp = _draw(2000 + seed, 32, 128, 2, geometry_first=False)
    planes = img.transpose(2, 0, 1).copy()
    anchor = np.asarray(jdev.develop_post_geo_jit(jnp.asarray(planes), jpack(jp),
                                                  jnp.asarray(masks)))
    params = pack_params(tp, device="cpu")
    tplanes, tmasks = torch.from_numpy(planes), torch.from_numpy(masks)
    twin = fused.develop_post_geo_fused(tplanes, params, tmasks)
    assert_fuzz_close(twin.numpy().transpose(1, 2, 0), anchor.transpose(1, 2, 0))
    assert_staircase_explained(twin, tplanes, params, tmasks)


def _fresh_from_final_state(ed, img, kw):
    """A new editor handed only ``ed``'s final state (tests/test_fuzz.py's
    reconstruction: logits where the mask kept them, a detached data copy
    for inverted masks)."""
    from rawphotoforge_tpu_torch.engine.editor import PhotoEditor

    fresh = PhotoEditor.from_rgb_f32(img, **kw)
    fresh.set_mask_range(0.5)
    for m in ed.masks[1:]:
        src = m.logits if m.logits is not None else m.data_full.cpu().numpy()
        fresh.add_mask(m.name, np.asarray(src, dtype=np.float32))
        fm = next(x for x in fresh.masks if x.name == m.name)
        if m.logits is None:
            fm.logits = None
        fm.data_full = m.data_full
        fm._levels.clear()
    fresh._invalidate(masks_changed=True)
    fresh.load_preset_json(ed.preset_json())
    if ed.crop_rect is None:
        fresh.clear_crop()
    return fresh


@pytest.mark.parametrize("seed,use_kernel", [(1234, False), (1234, True), (7, True)])
def test_editor_cache_coherence_random_sequences(seed, use_kernel):
    """After any random sequence of edits, mask ops, crops, resets and
    interleaved renders, the port's editor renders what a fresh editor
    handed only the final state renders (tests/test_fuzz.py:174)."""
    from rawphotoforge_tpu_torch.engine.editor import FULL, LOW, MID, PhotoEditor

    rng = np.random.default_rng(seed)
    img = random_linear_image(rng, 40, 56)
    kw = dict(use_kernel=use_kernel, mid_long_edge=32, low_long_edge=16,
              device="cpu")
    ed = PhotoEditor.from_rgb_f32(img, **kw)
    ed.set_mask_range(0.5)
    levels = [FULL, MID, LOW]
    mask_n = 0
    for _ in range(40):
        op = rng.integers(0, 15)
        target = str(rng.choice([m.name for m in ed.masks]))
        tgt = None if target == "main" else target
        if op == 0:
            ed.set_tone(exposure=float(rng.uniform(-2, 2)),
                        contrast=int(rng.integers(-80, 81)), mask_name=tgt)
        elif op == 1:
            ed.set_whitebalance(int(rng.integers(-80, 81)),
                                int(rng.integers(-80, 81)), mask_name=tgt)
        elif op == 2:
            ed.set_vignette(int(rng.integers(-100, 101)))
        elif op == 3:
            ed.set_lens_distortion(int(rng.integers(-100, 101)))
        elif op == 4:
            ed.set_sharpness(int(rng.integers(0, 80)))
        elif op == 5:
            slot = int(rng.integers(0, 4))
            xs = np.sort(rng.choice(65536, size=3, replace=False))
            ys = rng.integers(0, 65536, size=3)
            ed.set_curve(slot, xs, ys, mask_name=tgt)
        elif op == 6 and mask_n < 3:
            mask_n += 1
            ed.add_mask(f"m{mask_n}", (rng.random((40, 56)) > 0.5).astype(np.float32))
        elif op == 7 and tgt:
            ed.invert_mask(target)
        elif op == 8 and tgt and rng.random() < 0.3:
            ed.remove_mask(target)
        elif op == 9:
            ed.set_crop(int(rng.integers(0, 20)), int(rng.integers(0, 15)),
                        int(rng.integers(30, 56)), int(rng.integers(25, 40)))
        elif op == 10:
            ed.clear_crop()
        elif op == 11 and rng.random() < 0.15:
            ed.reset()
            mask_n = 0
        elif op == 12 and mask_n < 3:
            mask_n += 1
            ed.add_similarity_mask(
                f"m{mask_n}", (int(rng.integers(0, 56)), int(rng.integers(0, 40))),
                color_tolerance=float(rng.uniform(0.05, 0.3)))
        elif op == 13 and mask_n < 3:
            mask_n += 1
            ed.add_smart_mask(
                f"m{mask_n}", (int(rng.integers(0, 56)), int(rng.integers(0, 40))),
                tolerance=float(rng.uniform(0.1, 0.4)))
        elif op == 14:
            xs = np.sort(rng.choice(65536, size=3, replace=False))
            ys = rng.integers(0, 65536, size=3)
            ed.set_curve(0, xs, ys, mask_name=tgt, channel=int(rng.integers(0, 4)))
        if rng.random() < 0.6:
            ed.apply(str(rng.choice(levels)))

    fresh = _fresh_from_final_state(ed, img, kw)
    for level in levels:
        assert torch.equal(ed.apply(level), fresh.apply(level)), level
