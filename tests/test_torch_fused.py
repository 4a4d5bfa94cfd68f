"""The port's develop kernel module on the CPU: its plain twin against the
JAX package's Pallas kernel (interpret mode) and exact-LUT anchor, the
shortcut variants' bit-identity, the argument checks and the dispatch
rule. The CUDA kernel itself is held to the twin in test_torch_cuda.py
and chip_smoke.py (it has no CPU mode)."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rawphotoforge_tpu.core.params import EditParameters as JEdit, pack_params as jpack
from rawphotoforge_tpu.kernels import fused as jfused
from rawphotoforge_tpu.ops import develop as jdev

from rawphotoforge_tpu_torch.core import color as tcolor
from rawphotoforge_tpu_torch.core.params import (
    BRIGHTNESS, HUE, LIGHTNESS, SATURATION, EditParameters, default_curve_slots,
    pack_params)
from rawphotoforge_tpu_torch.engine.editor import FULL, PhotoEditor
from rawphotoforge_tpu_torch.kernels import fused
from rawphotoforge_tpu_torch.ops import develop as tdev

from test_develop import assert_close
from torch_fixtures import no_shortcuts
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
    ours = fused.develop_post_geo_fused(torch.from_numpy(img), params,
                                        None).numpy()
    ref = tdev.develop_post_geo(torch.from_numpy(img), params, None).numpy()
    assert_close(_hwc(ours), _hwc(ref))


def _planes(rng):
    return torch.from_numpy(nongray_image(rng, 48, 160).transpose(2, 0, 1).copy())


def test_default_curve_flags_bit_identical(rng):
    """The default-curve shortcuts the packed params carry are
    bit-identical to evaluating the default curves (test_pallas.py:127-178),
    for every curve default, on two masks, and for each family alone."""
    planes = _planes(rng)
    ones = torch.ones((1, 48, 160))
    p = EditParameters()
    p.set_tone(exposure=0.8, contrast=20, shadow=15)
    p.set_whitebalance(temperature=30)
    p.set_vignette(40)
    packed = pack_params([p], device="cpu")
    assert packed.default_slots == ((True,) * 4,)
    general = fused.develop_post_geo_fused(planes, no_shortcuts(packed), ones)
    fast = fused.develop_post_geo_fused(planes, packed, ones)
    assert torch.equal(general, fast)
    reg = EditParameters()
    reg.set_tone(exposure=-0.6)
    m2 = torch.ones((2, 48, 160))
    m2[1, :20] = 0.0
    packed2 = pack_params([p, reg], device="cpu")
    assert packed2.default_slots == ((True,) * 4,) * 2
    assert torch.equal(
        fused.develop_post_geo_fused(planes, no_shortcuts(packed2), m2),
        fused.develop_post_geo_fused(planes, packed2, m2))
    pb = EditParameters()
    pb.set_tone(exposure=0.4)
    pb.set_curve(BRIGHTNESS, [0, 20000, 65535], [3000, 26000, 65535])
    packedb = pack_params([pb], device="cpu")
    assert packedb.default_slots == ((False, True, True, True),)
    assert torch.equal(fused.develop_post_geo_fused(planes, no_shortcuts(packedb), ones),
                       fused.develop_post_geo_fused(planes, packedb, ones))
    ph = EditParameters()
    ph.set_curve(HUE, [0, 30000, 65535], [5000, 32000, 64000])
    packedh = pack_params([ph], device="cpu")
    assert packedh.default_slots == ((True, False, True, True),)
    assert torch.equal(fused.develop_post_geo_fused(planes, no_shortcuts(packedh), ones),
                       fused.develop_post_geo_fused(planes, packedh, ones))


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
    assert packed.default_slots == slots
    general = fused.develop_post_geo_fused(planes, no_shortcuts(packed),
                                           torch.from_numpy(masks))
    elided = fused.develop_post_geo_fused(planes, packed, torch.from_numpy(masks))
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
    full = fused.develop_post_geo_fused(planes, packed, ones)
    fast = fused.develop_post_geo_fused(planes, packed, ones, identity_oklch=True)
    assert fused.skips_oklch(packed, True)
    assert not torch.equal(full, fast)  # the round trip was skipped
    assert (full - fast).abs().max() < 3e-3
    p.set_curve(BRIGHTNESS, [0, 20000, 65535], [3000, 26000, 65535])
    packedb = pack_params([p], device="cpu")
    full = fused.develop_post_geo_fused(planes, no_shortcuts(packedb), ones)
    fast = fused.develop_post_geo_fused(planes, packedb, ones, identity_oklch=True)
    assert fused.skips_oklch(packedb, True)
    assert not torch.equal(full, fast)
    assert (full - fast).abs().max() < 3e-3


@pytest.mark.parametrize("slot", [HUE, SATURATION, LIGHTNESS])
def test_identity_oklch_only_permits(rng, slot):
    """identity_oklch=True with a real hue, saturation or lightness curve
    (on the main mask or a regional one) runs the full OKLCH path: the same
    bits as identity_oklch=False."""
    planes = _planes(rng)
    pts = [0, 30000, 65535]
    vals = [4000, 33000, 63000] if slot == HUE else [30000, 36000, 33000]
    p = EditParameters()
    p.set_tone(exposure=0.5)
    p.set_curve(slot, pts, vals)
    packed = pack_params([p], device="cpu")
    assert not fused.skips_oklch(packed, True)
    assert torch.equal(
        fused.develop_post_geo_fused(planes, packed, None, identity_oklch=True),
        fused.develop_post_geo_fused(planes, packed, None))
    reg = EditParameters()
    reg.set_curve(slot, pts, vals)
    two = pack_params([EditParameters(), reg], device="cpu")
    masks = torch.ones((2, 48, 160))
    masks[1, :, ::2] = 0.0
    assert not fused.skips_oklch(two, True)
    assert torch.equal(
        fused.develop_post_geo_fused(planes, two, masks, identity_oklch=True),
        fused.develop_post_geo_fused(planes, two, masks))


def test_mask_dtypes_and_main_only_agree(rng):
    """u8, bool and f32 masks select the same pixels; masks=None (the
    all-ones main mask, never read) equals an explicit all-ones row."""
    plist = [full_stack_edit(), *_multi()]
    img, masks = _inputs(rng, plist, 48, 160)
    planes = torch.from_numpy(img)
    params = pack_params(plist, device="cpu")
    f32 = fused.develop_post_geo_fused(planes, params, torch.from_numpy(masks))
    for m in (masks.astype(np.uint8), masks.astype(bool)):
        assert torch.equal(f32, fused.develop_post_geo_fused(planes, params, torch.from_numpy(m)))
    one = pack_params(plist[:1], device="cpu")
    explicit = fused.develop_post_geo_fused(planes, one, torch.ones((1, 48, 160)))
    assert torch.equal(explicit, fused.develop_post_geo_fused(planes, one, None))


def test_row_offset_continues_vignette(rng):
    """A block of rows rendered with ``row_offset`` equals those rows of the
    whole-frame render (vignette on global coordinates, true extent)."""
    p = _vignette90()
    img = nongray_image(rng, 64, 128).transpose(2, 0, 1).copy()
    whole = fused.develop_post_geo_fused(
        torch.from_numpy(img), pack_params([p], extent=(64, 128), device="cpu"),
        None)
    part = fused.develop_post_geo_fused(
        torch.from_numpy(img[:, 24:]), pack_params([p], extent=(64, 128), device="cpu"),
        None, row_offset=24.0)
    assert torch.equal(whole[:, 24:], part)


def test_argument_checks_raise_like_pallas():
    planes = torch.zeros((3, 16, 128))
    two = pack_params([EditParameters(), EditParameters()], build_luts=False, device="cpu")
    for rows in (1, 3):
        with pytest.raises(ValueError, match="packed mask count"):
            fused.develop_post_geo_fused(planes, two, torch.ones((rows, 16, 128)))
    with pytest.raises(ValueError, match="masks shape"):
        fused.develop_post_geo_fused(planes, two, torch.ones((2, 16, 64)))
    with pytest.raises(ValueError, match="expected planes"):
        fused.develop_post_geo_fused(planes[:2], two, torch.ones((2, 16, 128)))
    with pytest.raises(ValueError, match="single mask"):
        fused.develop_post_geo_fused(planes, two, None)


def test_dispatch_cpu_runs_twin_and_other_devices_raise():
    planes = torch.zeros((3, 16, 128))
    params = pack_params([EditParameters()], device="cpu")
    before = fused.LAUNCHES
    out = fused.develop_post_geo_fused(planes, params, None)
    assert fused.LAUNCHES == before  # the twin never counts as a launch
    assert torch.equal(out, fused.develop_post_geo_fused_ref(planes, params, None))
    with pytest.raises(ValueError, match="no develop kernel"):
        fused.develop_post_geo_fused(planes.to("meta"), params, None)


@pytest.mark.parametrize("identity", [False, True])
def test_twin_oetf_within_pow_form(rng, monkeypatch, identity):
    """The twin's edit stack with the kernels' OETF (exp2/log2) against the
    same stack with the anchor's torch.pow OETF: the assert_close rule, and
    exactly black pixels stay 0 with no NaN."""
    p = full_stack_edit()
    if identity:
        p = EditParameters()
        p.set_tone(exposure=0.8, contrast=20, shadow=15)
        p.set_vignette(40)
    img = nongray_image(rng, 48, 160).transpose(2, 0, 1).copy()
    img[:, :4, :4] = 0.0
    flags = dict(identity_oklch=identity)
    params = pack_params([p], device="cpu")
    assert fused.skips_oklch(params, identity) == identity
    ours = fused.develop_post_geo_fused(torch.from_numpy(img), params, None, **flags)
    monkeypatch.setattr(fused.ktrig, "srgb_oetf", tcolor.linear_to_srgb)
    pow_form = fused.develop_post_geo_fused(torch.from_numpy(img), params, None,
                                            **flags)
    assert not torch.isnan(ours).any()
    assert_close(_hwc(ours.numpy()), _hwc(pow_form.numpy()))


def test_curve_rows_need_power_of_two_segments():
    """The kernels binary-search a curve row: S must be a power of two, as
    pack_params pads it (1, 2, 4, ... 32)."""
    for s in (1, 2, 4, 8, 16, 32):
        fused.check_segments(s)
    for s in (0, 3, 6, 12):
        with pytest.raises(ValueError, match="power-of-two"):
            fused.check_segments(s)
    sizes = {pack_params([_curve_with(n)], device="cpu").breaks.shape[-1]
             for n in range(2, 17)}
    assert sizes == {2, 4, 8, 16}


def _curve_with(n):
    p = EditParameters()
    xs = np.linspace(0, 65535, n).round().astype(int).tolist()
    p.set_curve(BRIGHTNESS, xs, xs)
    return p


@pytest.mark.parametrize("m,s", [(1, 2), (3, 4), (4, 8)])
def test_kernel_table_layout(m, s):
    """The wrapper's one table holds what csrc/develop.cu reads, in its
    order: 4 + 11M + 20MS floats."""
    plist = [EditParameters() for _ in range(m)]
    pts = list(range(0, 65536, 65535 // (s - 1)))[:s]
    plist[-1].set_curve(LIGHTNESS, pts, [32767] * s)
    params = pack_params(plist, extent=(40, 150), device="cpu")
    assert params.breaks.shape[-1] == s
    table = fused.pack_table(params, m, s, params.default_slots, 7.0,
                             torch.device("cpu"))
    assert table.numel() == 4 + 11 * m + 20 * m * s
    assert table[:4].tolist() == [0.0, 40.0, 150.0, 7.0]
    # bright|hue|sat|light = 1|2|4|8; the last mask's lightness is edited
    # but at s = 2, where its two points at 32767 are the default curve
    last = 15.0 if s == 2 else 7.0
    assert table[4:4 + m].tolist() == [15.0] * (m - 1) + [last]
    gains = table[4 + m:4 + 4 * m]
    assert torch.equal(gains, params.gains.reshape(-1))
    assert torch.equal(table[-16 * m * s:], params.coeffs.reshape(-1))


# -- the editor's launch input against caller-built flags ---------------------

def _caller_built_slots(plist):
    """The develop launch's slot table and OKLCH skip as the editor worked
    them out before the table moved into the packed params: all-mask
    flags from ``default_curve_slots``, merged with the per-mask table of
    a multi-mask session."""
    slots = default_curve_slots(plist)
    db = all(sl[0] for sl in slots)
    doc = all(sl[1] and sl[2] and sl[3] for sl in slots)
    m = len(plist)
    return fused._slot_table(m, db, doc, slots if m > 1 else None), doc


def _session_curves(ed, rng, mask_name=None, points=(8, 6, 5, 4)):
    """Curves as the benchmark's sessions set them: brightness and hue near
    the diagonal, hue ends pinned, saturation and lightness gains by hue
    that end where they start."""
    for slot, n in enumerate(points):
        xs = np.linspace(0, 65535, n).round().astype(int)
        xs[1:-1] += rng.integers(-2000, 2001, size=n - 2)
        if slot in (BRIGHTNESS, HUE):
            band = 6000 if slot == BRIGHTNESS else 3000
            ys = np.clip(xs + rng.integers(-band, band + 1, size=n), 0, 65535)
            if slot == HUE:
                ys[0], ys[-1] = 0, 65535
        else:
            ys = rng.integers(20000, 49000, size=n)
            ys[-1] = ys[0]
        ed.set_curve(slot, xs.tolist(), ys.tolist(), mask_name=mask_name)


def _spy_launches(monkeypatch):
    seen = []
    real = fused.develop_post_geo_fused

    def spy(planes, params, masks, **kw):
        seen.append((params, masks, kw))
        return real(planes, params, masks, **kw)

    monkeypatch.setattr(fused, "develop_post_geo_fused", spy)
    return seen


def _move_point(ed, slot, mask_name=None, dy=1500):
    c = ed.params(mask_name).curves[slot]
    xs, ys = c.control_x.tolist(), c.control_y.tolist()
    ys[1] = int(np.clip(ys[1] + dy, 0, 65535))
    ed.set_curve(slot, xs, ys, mask_name=mask_name)


def _maskdrag(ed, rng):
    h, w = ed.shape
    for i, name in enumerate(("gradient", "radial", "brush")):
        logits = np.full((h, w), -1.0, np.float32)
        logits[i * h // 4:(i + 2) * h // 4, : (w * (i + 1)) // 4] = 1.0
        ed.add_mask(name, logits)
    for name in (None, "gradient", "radial", "brush"):
        _session_curves(ed, rng, name)
    yield
    ed.set_tone(exposure=0.4, contrast=12, mask_name="radial")
    yield
    _move_point(ed, SATURATION, "gradient")
    yield
    ed.set_whitebalance(temperature=20, tint=-8)
    yield
    _move_point(ed, BRIGHTNESS, "brush")
    yield
    ed.set_vignette(30)
    yield
    # Mask edits: a fresh mask keeps its default curves, then goes again.
    ed.add_mask("fresh", np.ones(ed.shape, np.float32))
    yield
    ed.set_tone(exposure=-0.2, mask_name="fresh")
    yield
    ed.remove_mask("fresh")
    yield


def _drag(ed, rng):
    _session_curves(ed, rng)
    yield
    ed.set_tone(exposure=0.3, shadow=-12)
    yield
    _move_point(ed, HUE)
    yield
    _move_point(ed, LIGHTNESS)
    yield
    ed.set_vignette(45)
    yield


def _sliders(ed, rng):
    yield
    ed.set_tone(exposure=0.6, contrast=15, highlight=-20)
    yield
    ed.set_whitebalance(temperature=-10)
    yield
    ed.set_vignette(25)
    yield
    ed.set_curve(BRIGHTNESS, [0, 30000, 65535], [1500, 33000, 65535])
    yield


@pytest.mark.parametrize("session", ["maskdrag", "drag", "sliders"])
def test_editor_launch_table_equals_caller_built_flags(rng, monkeypatch, session):
    """For the benchmark cells' session shapes (M = 4 with 8/6/5/4-point
    curves, M = 1 with curves, M = 1 sliders only) through tone, curve and
    mask edits, the editor's develop launch gets the table bytes, the
    mask-array elision and the OKLCH skip that the caller-built flags gave
    it."""
    seen = _spy_launches(monkeypatch)
    ed = PhotoEditor.from_rgb_f32(nongray_image(rng, 24, 40), device="cpu",
                                  mid_long_edge=20, low_long_edge=10)
    steps = {"maskdrag": _maskdrag, "drag": _drag, "sliders": _sliders}[session]
    cpu = torch.device("cpu")
    for _ in steps(ed, rng):
        ed.apply(FULL)
        params, masks, kw = seen[-1]
        assert kw == {"identity_oklch": True}
        plist = [mk.params for mk in ed.masks]
        m, s = len(plist), params.breaks.shape[-1]
        flagged, flagged_skip = _caller_built_slots(plist)
        assert torch.equal(
            fused.pack_table(params, m, s, params.default_slots, None, cpu),
            fused.pack_table(params, m, s, flagged, None, cpu))
        assert fused.skips_oklch(params, kw["identity_oklch"]) == flagged_skip
        assert (masks is None) == (m == 1)
    assert len(seen) >= 5


def test_single_mask_partial_oklch_defaults_render_as_before(rng):
    """One mask with a hue curve and default saturation and lightness: the
    params' table marks those two default where the caller-built all-family
    flag marked none. Only those slot bits differ, and the render is the
    same, bit for bit."""
    p = EditParameters()
    p.set_tone(exposure=0.3)
    p.set_curve(HUE, [0, 30000, 65535], [0, 33000, 65535])
    plist = [p]
    params = pack_params(plist, device="cpu")
    flagged, skip = _caller_built_slots(plist)
    assert params.default_slots == ((True, False, True, True),)
    assert flagged == [(True, False, False, False)] and not skip
    cpu = torch.device("cpu")
    s = params.breaks.shape[-1]
    new = fused.pack_table(params, 1, s, params.default_slots, None, cpu)
    old = fused.pack_table(params, 1, s, flagged, None, cpu)
    assert new[4].item() == 13.0 and old[4].item() == 1.0
    assert torch.equal(torch.cat([new[:4], new[5:]]), torch.cat([old[:4], old[5:]]))
    planes = _planes(rng)
    assert torch.equal(
        fused.develop_post_geo_fused(planes, params, None, identity_oklch=True),
        fused.develop_post_geo_fused(
            planes, dataclasses.replace(params, default_slots=tuple(flagged)),
            None, identity_oklch=True))
