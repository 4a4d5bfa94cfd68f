"""The port's develop kernel module on the CPU: its plain twin against the
JAX package's Pallas kernel (interpret mode) and exact-LUT anchor, the
shortcut variants' bit-identity, the argument checks and the dispatch
rule. The CUDA kernel itself is held to the twin in test_torch_cuda.py
and chip_smoke.py (it has no CPU mode)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rawphotoforge_tpu.core.params import EditParameters as JEdit, pack_params as jpack
from rawphotoforge_tpu.kernels import fused as jfused
from rawphotoforge_tpu.ops import develop as jdev

from rawphotoforge_tpu_torch.core.params import (
    BRIGHTNESS, HUE, LIGHTNESS, SATURATION, EditParameters, default_curve_slots,
    pack_params)
from rawphotoforge_tpu_torch.kernels import fused
from rawphotoforge_tpu_torch.ops import develop as tdev

from test_develop import assert_close
from torch_parity import assert_close_across, full_stack_edit, nongray_image


def _multi():
    main = EditParameters()
    main.set_tone(exposure=0.4)
    reg = EditParameters()
    reg.set_tone(contrast=50)
    reg.set_curve(SATURATION, [0, 65535], [45000, 45000])
    return [main, reg]


def _inputs(rng, plist, h, w, regional=True):
    img = nongray_image(rng, h, w).transpose(2, 0, 1).copy()
    masks = np.ones((len(plist), h, w), dtype=np.float32)
    if regional and len(plist) > 1:
        masks[1:] = 0.0
        masks[1, h // 6:h // 2, w // 8:(5 * w) // 8] = 1.0
    return img, masks


def _jax(plist, extent=None):
    return jpack([JEdit.from_json(e.to_json()) for e in plist], extent=extent)


def _twin(img, plist, masks, **kw):
    return fused.develop_post_geo_fused(
        torch.from_numpy(img), pack_params(plist, device="cpu"),
        None if masks is None else torch.from_numpy(masks), **kw).numpy()


def _hwc(x):
    return np.asarray(x).transpose(1, 2, 0)


PALLAS_CASES = {
    # name: (param list, h, w)
    "general": (lambda: [full_stack_edit()], 48, 160),
    "multi_mask": (_multi, 48, 160),
    "ragged_tiles": (lambda: [_ragged()], 37, 150),
    "vignette_offsets": (lambda: [_vignette90()], 64, 256),
    "steep_curve": (lambda: [_steep()], 48, 160),
}


def _ragged():
    p = EditParameters()
    p.set_tone(exposure=1.2, contrast=-20)
    p.set_vignette(-45)
    return p


def _vignette90():
    p = EditParameters()
    p.set_vignette(90)
    return p


def _steep():
    p = EditParameters()
    p.set_curve(BRIGHTNESS, [0, 8000, 12000, 65535], [0, 2000, 60000, 65535])
    return p


@pytest.mark.parametrize("case", sorted(PALLAS_CASES))
def test_twin_matches_pallas_kernel(rng, case):
    """Port twin vs the JAX Pallas kernel (interpret mode) on the same
    inputs: the kernel-vs-anchor rule of test_pallas.py, loose 2e-2 / frac
    2e-2 for the steep curve (test_pallas.py:97: steep segments amplify
    Horner reassociation into more one-index flips)."""
    make, h, w = PALLAS_CASES[case]
    plist = make()
    img, masks = _inputs(rng, plist, h, w)
    ours = _twin(img, plist, masks)
    ref = jfused.develop_post_geo_fused(jnp.asarray(img), _jax(plist),
                                        jnp.asarray(masks), tile_h=16, tile_w=128)
    kw = dict(loose=2e-2, frac=2e-2) if case == "steep_curve" else {}
    assert_close_across(_hwc(ours), _hwc(ref), **kw)


ANCHOR_CASES = ["defaults", "general", "multi_mask", "channel", "extent"]


@pytest.mark.parametrize("case", ANCHOR_CASES)
@pytest.mark.parametrize("mask_dtype", [np.float32, np.uint8])
def test_twin_matches_jax_anchor(rng, case, mask_dtype):
    """Port twin vs the JAX exact-LUT anchor, the gate the Pallas kernel
    itself meets (tight 1e-4, frac 2e-3, loose 5e-3)."""
    extent = None
    if case == "defaults":
        plist = [EditParameters()]
    elif case == "general":
        plist = [full_stack_edit()]
    elif case == "multi_mask":
        plist = [full_stack_edit(), *_multi()]
    elif case == "channel":
        p = full_stack_edit()
        p.set_curve(BRIGHTNESS, [0, 30000, 65535], [0, 38000, 65535], channel=0)
        plist = [p]
    else:
        plist, extent = [full_stack_edit()], (40, 150)
    img, masks = _inputs(rng, plist, 48, 160)
    params = pack_params(plist, extent=extent, device="cpu")
    ours = fused.develop_post_geo_fused(
        torch.from_numpy(img), params, torch.from_numpy(masks.astype(mask_dtype))).numpy()
    ref = jdev.develop_post_geo_jit(jnp.asarray(img), _jax(plist, extent), jnp.asarray(masks))
    assert_close_across(_hwc(ours), _hwc(ref))


def test_twin_matches_port_anchor(rng):
    """Within the port (one framework, so gray pixels round alike): twin vs
    the exact-LUT anchor under plain assert_close, masks=None form."""
    plist = [full_stack_edit()]
    img = nongray_image(rng, 48, 160).transpose(2, 0, 1).copy()
    img[:, :4, :4] = 0.0  # exact gray is fine within one framework
    params = pack_params(plist, device="cpu")
    ours = fused.develop_post_geo_fused(torch.from_numpy(img), params, None,
                                        main_mask_all_ones=True).numpy()
    ref = tdev.develop_post_geo(torch.from_numpy(img), params, None).numpy()
    assert_close(_hwc(ours), _hwc(ref))


def _planes(rng):
    return torch.from_numpy(nongray_image(rng, 48, 160).transpose(2, 0, 1).copy())


def test_default_curve_flags_bit_identical(rng):
    """The default-curve shortcut flags are bit-identical to evaluating the
    default curves (test_pallas.py:127-178), including each family alone."""
    planes = _planes(rng)
    ones = torch.ones((1, 48, 160))
    p = EditParameters()
    p.set_tone(exposure=0.8, contrast=20, shadow=15)
    p.set_whitebalance(temperature=30)
    p.set_vignette(40)
    packed = pack_params([p], device="cpu")
    general = fused.develop_post_geo_fused(planes, packed, ones)
    fast = fused.develop_post_geo_fused(planes, packed, ones, default_bright_curves=True,
                                        default_oklch_curves=True)
    assert torch.equal(general, fast)
    reg = EditParameters()
    reg.set_tone(exposure=-0.6)
    m2 = torch.ones((2, 48, 160))
    m2[1, :20] = 0.0
    packed2 = pack_params([p, reg], device="cpu")
    assert torch.equal(
        fused.develop_post_geo_fused(planes, packed2, m2),
        fused.develop_post_geo_fused(planes, packed2, m2, default_bright_curves=True,
                                     default_oklch_curves=True))
    pb = EditParameters()
    pb.set_tone(exposure=0.4)
    pb.set_curve(BRIGHTNESS, [0, 20000, 65535], [3000, 26000, 65535])
    packedb = pack_params([pb], device="cpu")
    assert torch.equal(fused.develop_post_geo_fused(planes, packedb, ones),
                       fused.develop_post_geo_fused(planes, packedb, ones,
                                                    default_oklch_curves=True))
    ph = EditParameters()
    ph.set_curve(HUE, [0, 30000, 65535], [5000, 32000, 64000])
    packedh = pack_params([ph], device="cpu")
    assert torch.equal(fused.develop_post_geo_fused(planes, packedh, ones),
                       fused.develop_post_geo_fused(planes, packedh, ones,
                                                    default_bright_curves=True))


def test_default_curve_slots_bit_identical(rng):
    """Per-mask per-slot shortcuts (test_pallas.py:312-350): bit-identical
    to the general path, and within the anchor gate."""
    main = EditParameters()
    main.set_tone(exposure=0.4, contrast=15)
    main.set_curve(BRIGHTNESS, [0, 30000, 65535], [2000, 35000, 65535])
    m1 = EditParameters()
    m1.set_tone(exposure=-0.3)
    m1.set_curve(SATURATION, [0, 65535], [30000, 36000])
    m2 = EditParameters()
    m2.set_curve(HUE, [0, 20000, 65535], [3000, 24000, 65535])
    params = [main, m1, m2]
    slots = default_curve_slots(params)
    assert slots == ((False, True, True, True),
                     (True, True, False, True),
                     (True, False, True, True))
    h, w = 48, 160
    planes = _planes(rng)
    masks = np.ones((3, h, w), dtype=np.float32)
    masks[1] = (np.arange(w) % 2 == 0)[None, :]
    masks[2] = (np.arange(h) % 3 == 0)[:, None]
    packed = pack_params(params, device="cpu")
    general = fused.develop_post_geo_fused(planes, packed, torch.from_numpy(masks))
    elided = fused.develop_post_geo_fused(planes, packed, torch.from_numpy(masks),
                                          default_curve_slots=slots)
    assert torch.equal(general, elided)
    anchor = tdev.develop_post_geo(planes, pack_params(params, device="cpu"),
                                   torch.from_numpy(masks))
    assert_close(_hwc(elided.numpy()), _hwc(anchor.numpy()))


def test_identity_oklch_near_exact(rng):
    """identity_oklch skips the OKLCH round trip: within 3e-3 of the full
    path (test_pallas.py:199-232), also with a custom brightness curve."""
    planes = _planes(rng)
    ones = torch.ones((1, 48, 160))
    p = EditParameters()
    p.set_tone(exposure=0.8, contrast=20, shadow=15)
    p.set_whitebalance(temperature=30)
    p.set_vignette(40)
    packed = pack_params([p], device="cpu")
    full = fused.develop_post_geo_fused(planes, packed, ones, default_bright_curves=True,
                                        default_oklch_curves=True)
    fast = fused.develop_post_geo_fused(planes, packed, ones, default_bright_curves=True,
                                        default_oklch_curves=True, identity_oklch=True)
    assert (full - fast).abs().max() < 3e-3
    p.set_curve(BRIGHTNESS, [0, 20000, 65535], [3000, 26000, 65535])
    packedb = pack_params([p], device="cpu")
    full = fused.develop_post_geo_fused(planes, packedb, ones)
    fast = fused.develop_post_geo_fused(planes, packedb, ones, default_oklch_curves=True,
                                        identity_oklch=True)
    assert (full - fast).abs().max() < 3e-3


def test_mask_dtypes_and_main_only_agree(rng):
    """u8, bool and f32 masks select the same pixels; masks=None with
    main_mask_all_ones equals an explicit all-ones row."""
    plist = [full_stack_edit(), *_multi()]
    img, masks = _inputs(rng, plist, 48, 160)
    planes = torch.from_numpy(img)
    params = pack_params(plist, device="cpu")
    f32 = fused.develop_post_geo_fused(planes, params, torch.from_numpy(masks))
    for m in (masks.astype(np.uint8), masks.astype(bool)):
        assert torch.equal(f32, fused.develop_post_geo_fused(planes, params, torch.from_numpy(m)))
    one = pack_params(plist[:1], device="cpu")
    explicit = fused.develop_post_geo_fused(planes, one, torch.ones((1, 48, 160)))
    assert torch.equal(explicit, fused.develop_post_geo_fused(planes, one, None,
                                                              main_mask_all_ones=True))


def test_row_offset_continues_vignette(rng):
    """A block of rows rendered with ``row_offset`` equals those rows of the
    whole-frame render (vignette on global coordinates, true extent)."""
    p = _vignette90()
    img = nongray_image(rng, 64, 128).transpose(2, 0, 1).copy()
    whole = fused.develop_post_geo_fused(
        torch.from_numpy(img), pack_params([p], extent=(64, 128), device="cpu"),
        None, main_mask_all_ones=True)
    part = fused.develop_post_geo_fused(
        torch.from_numpy(img[:, 24:]), pack_params([p], extent=(64, 128), device="cpu"),
        None, main_mask_all_ones=True, row_offset=24.0)
    assert torch.equal(whole[:, 24:], part)


def test_argument_checks_raise_like_pallas():
    planes = torch.zeros((3, 16, 128))
    two = pack_params([EditParameters(), EditParameters()], build_luts=False, device="cpu")
    for rows in (1, 3):
        with pytest.raises(ValueError, match="packed mask count"):
            fused.develop_post_geo_fused(planes, two, torch.ones((rows, 16, 128)))
    one = pack_params([EditParameters()], device="cpu")
    with pytest.raises(ValueError, match="default_oklch_curves"):
        fused.develop_post_geo_fused(planes, one, None, main_mask_all_ones=True,
                                     identity_oklch=True)
    with pytest.raises(ValueError, match="default_oklch_curves"):
        fused.develop_post_geo_fused(planes, one, None, main_mask_all_ones=True,
                                     default_bright_curves=True, identity_oklch=True)
    with pytest.raises(ValueError, match="default_curve_slots"):
        fused.develop_post_geo_fused(planes, two, torch.ones((2, 16, 128)),
                                     default_curve_slots=((True,) * 4,))
    with pytest.raises(ValueError, match="main_mask_all_ones"):
        fused.develop_post_geo_fused(planes, one, None)
    with pytest.raises(ValueError, match="single mask"):
        fused.develop_post_geo_fused(planes, two, None, main_mask_all_ones=True)


def test_dispatch_cpu_runs_twin_and_other_devices_raise():
    planes = torch.zeros((3, 16, 128))
    params = pack_params([EditParameters()], device="cpu")
    before = fused.LAUNCHES
    out = fused.develop_post_geo_fused(planes, params, None, main_mask_all_ones=True)
    assert fused.LAUNCHES == before  # the twin never counts as a launch
    assert torch.equal(out, fused.develop_post_geo_fused_ref(
        planes, params, None, main_mask_all_ones=True))
    with pytest.raises(ValueError, match="no develop kernel"):
        fused.develop_post_geo_fused(planes.to("meta"), params, None,
                                     main_mask_all_ones=True)


@pytest.mark.parametrize("m,s", [(1, 2), (3, 4), (4, 8)])
def test_kernel_table_layout(m, s):
    """The wrapper's one table holds what csrc/develop.cu reads, in its
    order: 4 + 11M + 20MS floats."""
    plist = [EditParameters() for _ in range(m)]
    pts = list(range(0, 65536, 65535 // (s - 1)))[:s]
    plist[-1].set_curve(LIGHTNESS, pts, [32767] * s)
    params = pack_params(plist, extent=(40, 150), device="cpu")
    assert params.breaks.shape[-1] == s
    slots = fused._slot_table(m, False, True, None)
    table = fused.pack_table(params, m, s, slots, 7.0, torch.device("cpu"))
    assert table.numel() == 4 + 11 * m + 20 * m * s
    assert table[:4].tolist() == [0.0, 40.0, 150.0, 7.0]
    assert table[4:4 + m].tolist() == [14.0] * m  # hue|sat|light = 2|4|8
    gains = table[4 + m:4 + 4 * m]
    assert torch.equal(gains, params.gains.reshape(-1))
    assert torch.equal(table[-16 * m * s:], params.coeffs.reshape(-1))
