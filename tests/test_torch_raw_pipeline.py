"""The port's one-pass RAW kernel module on the CPU: its plain twin against
the JAX package's Pallas RAW kernel (interpret mode) on the same seeded
inputs, against the port's own composed path (demosaic -> unsharp ->
develop twin, with the JAX tests' trims), the shortcut variants'
bit-identity, the argument checks and the dispatch rule. The CUDA kernel
itself is held to the twin in test_torch_cuda.py and chip_smoke.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rawphotoforge_tpu.core.params import EditParameters as JEdit, pack_params as jpack
from rawphotoforge_tpu.kernels import raw_pipeline as jrp
from rawphotoforge_tpu.ops import demosaic as jdm

from rawphotoforge_tpu_torch.core.params import (
    BRIGHTNESS, HUE, SATURATION, EditParameters, pack_params)
from rawphotoforge_tpu_torch.kernels import fused, raw_pipeline as rp
from rawphotoforge_tpu_torch.ops import demosaic as dm
from rawphotoforge_tpu_torch.ops.sharpen import unsharp_mask

from test_develop import assert_close
from torch_fixtures import no_shortcuts
from torch_parity import assert_close_across

WB = np.asarray([1.8, 1.0, 1.4], np.float32)
CAM = jdm.cam_matrix_to_srgb(np.array(
    [[0.8, -0.1, -0.05], [-0.3, 1.1, 0.15], [-0.05, 0.15, 0.65]]))


def _edit():
    """tests/test_raw_pipeline.py's edit."""
    p = EditParameters()
    p.set_tone(exposure=0.6, contrast=25, shadow=20, highlight=-10, black=5, white=-5)
    p.set_whitebalance(temperature=20, tint=-10)
    p.set_vignette(35)
    p.set_curve(BRIGHTNESS, [0, 20000, 65535], [2000, 30000, 65535])
    p.set_curve(SATURATION, [0, 65535], [36000, 36000])
    return p


def _regional():
    q = EditParameters()
    q.set_tone(contrast=60)
    q.set_curve(HUE, [0, 30000, 65535], [2000, 33000, 63000])
    return q


def _masks(h, w):
    masks = np.zeros((2, h, w), np.float32)
    masks[0] = 1.0
    masks[1, h // 6:h // 2, w // 8:(5 * w) // 8] = 1.0
    return masks


def _hwc(x):
    return np.asarray(x).transpose(1, 2, 0)


def _twin(mosaic, plist, sharpen, masks=None, general=False, **kw):
    """The port's RAW develop on the CPU; ``general`` clears the params'
    curve shortcuts, so every curve is evaluated."""
    params = pack_params(plist, device="cpu")
    if general:
        params = no_shortcuts(params)
    return rp.raw_develop_fused(
        torch.from_numpy(mosaic), WB, CAM, params,
        np.float32(sharpen), masks=None if masks is None else torch.from_numpy(masks),
        **kw).numpy()


def _pallas(mosaic, plist, sharpen, masks=None, **kw):
    jparams = jpack([JEdit.from_json(e.to_json()) for e in plist])
    return np.asarray(jrp.raw_develop_fused(
        jnp.asarray(mosaic), jnp.asarray(WB), jnp.asarray(CAM), jparams,
        jnp.float32(sharpen), masks=None if masks is None else jnp.asarray(masks),
        **kw))


PALLAS_CASES = {
    # name: (pattern, h, w, sharpen, regional mask, tile (h, w))
    "rggb": ("RGGB", 64, 256, 0.0, False, (16, 128)),
    "rggb_sharpen": ("RGGB", 64, 256, 0.8, False, (16, 128)),
    "grbg": ("GRBG", 32, 256, 0.0, False, (16, 128)),
    "gbrg_50x300": ("GBRG", 50, 300, 0.5, False, (16, 128)),
    "bggr_m2": ("BGGR", 64, 256, 0.5, True, (16, 128)),
    "xtrans_m2_sharpen": ("XTRANS", 96, 768, 0.8, True, (48, 384)),
    # Across the CUDA Bayer kernel's 124-column strips and 16-row steps,
    # with ragged and narrow edges.
    "rggb_18x130_sharpen": ("RGGB", 18, 130, 0.8, False, (16, 128)),
    "grbg_m2_70x260": ("GRBG", 70, 260, 0.5, True, (16, 128)),
    "bggr_34x133_sharpen": ("BGGR", 34, 133, 0.8, False, (16, 128)),
    "gbrg_6x9": ("GBRG", 6, 9, 0.5, False, (16, 128)),
}


@pytest.mark.parametrize("case", sorted(PALLAS_CASES))
def test_twin_matches_pallas_raw_kernel(rng, case):
    """Port twin vs the JAX RAW kernel (interpret mode), whole frame
    borders included: the same border rules (Bayer reflect after WB,
    X-Trans phase-preserving copy) and arithmetic, so only curve-index
    flips of f32 rounding differ (the assert_close rule)."""
    pattern, h, w, sharpen, regional, (th, tw) = PALLAS_CASES[case]
    mosaic = rng.random((h, w), dtype=np.float32)
    plist = [_edit(), _regional()] if regional else [_edit()]
    masks = _masks(h, w) if regional else None
    ours = _twin(mosaic, plist, sharpen, masks, pattern=pattern)
    # The tiles are the JAX kernel's; the port's kernel takes none.
    ref = _pallas(mosaic, plist, sharpen, masks, pattern=pattern, tile_h=th,
                  tile_w=tw)
    assert ours.shape == ref.shape == (3, h, w)
    assert_close_across(_hwc(ours), _hwc(ref))


def test_twin_matches_pallas_xtrans_smooth_borders():
    """A smooth X-Trans frame at the kernel's default tiles, borders
    included."""
    h, w = 96, 768
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    mosaic = (0.2 + 0.5 * (yy / h) * (xx / w)).astype(np.float32)
    ours = _twin(mosaic, [EditParameters()], 0.0, pattern="XTRANS")
    ref = _pallas(mosaic, [EditParameters()], 0.0, pattern="XTRANS")
    assert_close_across(_hwc(ours), _hwc(ref))


def _composed(mosaic, plist, sharpen, pattern, masks=None):
    """The port's composed path: develop_raw -> unsharp_mask -> the
    develop twin."""
    method = "residual" if pattern == "XTRANS" else "malvar"
    rgb = dm.develop_raw(torch.from_numpy(mosaic), WB, CAM, pattern=pattern,
                         method=method)
    rgb = unsharp_mask(rgb, sharpen)
    return fused.develop_post_geo_fused(
        rgb, pack_params(plist, device="cpu"),
        None if masks is None else torch.from_numpy(masks)).numpy()


@pytest.mark.parametrize("pattern,h,w,sharpen,trim,regional", [
    ("RGGB", 64, 512, 0.0, 0, False),
    ("RGGB", 64, 512, 0.8, 0, False),
    ("GRBG", 32, 256, 0.0, 0, False),
    ("RGGB", 50, 300, 0.5, 4, False),
    ("RGGB", 64, 256, 0.0, 0, True),
    ("XTRANS", 96, 768, 0.0, 14, False),
    ("XTRANS", 96, 768, 0.8, 14, False),
    ("XTRANS", 100, 700, 0.5, 14, False),
])
def test_one_pass_matches_composed(rng, pattern, h, w, sharpen, trim, regional):
    """The JAX tests' one-pass-vs-composed gate on the port alone
    (test_raw_pipeline.py: loose 1e-2; X-Trans compared on the 14-px
    trimmed interior, 50x300 Bayer on the 4-px one): the sharpen margin
    and the X-Trans border differ from the composed path only there."""
    mosaic = rng.random((h, w), dtype=np.float32)
    plist = [_edit(), _regional()] if regional else [_edit()]
    masks = _masks(h, w) if regional else None
    one = _twin(mosaic, plist, sharpen, masks, pattern=pattern)
    multi = _composed(mosaic, plist, sharpen, pattern, masks)
    s = slice(trim, h - trim) if trim else slice(None)
    t = slice(trim, w - trim) if trim else slice(None)
    assert_close(_hwc(one[:, s, t]), _hwc(multi[:, s, t]), loose=1e-2)


@pytest.mark.parametrize("pattern", ["RGGB", "XTRANS"])
def test_shortcut_variants_bit_identical(rng, pattern):
    h, w = (64, 256) if pattern == "RGGB" else (48, 96)
    mosaic = rng.random((h, w), dtype=np.float32)
    p = EditParameters()
    p.set_tone(exposure=0.6, contrast=20)
    p.set_vignette(30)
    general = _twin(mosaic, [p], 0.5, pattern=pattern, general=True)
    fast = _twin(mosaic, [p], 0.5, pattern=pattern)
    np.testing.assert_array_equal(general, fast)
    ident = _twin(mosaic, [p], 0.5, pattern=pattern, identity_oklch=True)
    assert not np.array_equal(ident, general)  # the round trip was skipped
    assert np.abs(ident - general).max() < 3e-3
    # A regional mask's default slots take their shortcuts too.
    masks = _masks(h, w)
    np.testing.assert_array_equal(
        _twin(mosaic, [p, _regional()], 0.5, masks, pattern=pattern, general=True),
        _twin(mosaic, [p, _regional()], 0.5, masks, pattern=pattern))
    # With a real hue curve identity_oklch only permits: the full path runs.
    p.set_curve(HUE, [0, 30000, 65535], [2000, 33000, 63000])
    np.testing.assert_array_equal(
        _twin(mosaic, [p], 0.5, pattern=pattern, identity_oklch=True),
        _twin(mosaic, [p], 0.5, pattern=pattern, general=True))


def test_sharpen_zero_keeps_the_clipped_value(rng):
    """amount 0 is the identity (no max(., 0) on the clipped planes), and
    a mask row 0 of zeros is never read."""
    mosaic = rng.random((32, 128), dtype=np.float32)
    plist = [EditParameters(), _regional()]
    masks = _masks(32, 128)
    a = _twin(mosaic, plist, 0.0, masks)
    masks[0] = 0.0
    np.testing.assert_array_equal(a, _twin(mosaic, plist, 0.0, masks))


def test_argument_checks(rng):
    mosaic = rng.random((48, 384), dtype=np.float32)
    with pytest.raises(ValueError, match="unknown CFA pattern"):
        _twin(mosaic, [EditParameters()], 0.0, pattern="RGBG")
    with pytest.raises(ValueError, match="expected a mosaic"):
        _twin(mosaic[None], [EditParameters()], 0.0)
    with pytest.raises(ValueError, match="pass masks"):
        _twin(mosaic, [EditParameters(), _regional()], 0.0)
    with pytest.raises(ValueError, match="at least 12x12"):
        _twin(mosaic[:10], [EditParameters()], 0.0, pattern="XTRANS")


def test_cpu_tensor_runs_the_twin_uncounted(rng):
    mosaic = torch.from_numpy(rng.random((16, 64), dtype=np.float32))
    params = pack_params([_edit()], device="cpu")
    before = dict(rp.KERNEL_LAUNCHES)
    out = rp.raw_develop_fused(mosaic, WB, CAM, params, np.float32(0.3))
    ref = rp.raw_develop_fused_ref(mosaic, WB, CAM, params, np.float32(0.3))
    assert torch.equal(out, ref) and rp.KERNEL_LAUNCHES == before


@pytest.mark.parametrize("pattern,code", [
    ("RGGB", (0b10010100, 1)), ("BGGR", (0b00010110, 0)),
    ("GRBG", (0b01100001, 1)), ("GBRG", (0b01001001, 0)), ("XTRANS", (-1, 0))])
def test_pattern_codes(pattern, code):
    assert rp.pattern_code(pattern) == code
