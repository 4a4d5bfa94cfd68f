"""Port parity, core layer: curve, params, color, ktrig, pointwise.

The same numpy inputs go through the JAX package (on the CPU) and the
torch port (device="cpu"). Curves and packing are compared bit for bit;
the float stages with the tolerance stated beside each check.
"""

import dataclasses
import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rawphotoforge_tpu.core import color as jcolor
from rawphotoforge_tpu.core import curve as jcurve
from rawphotoforge_tpu.core import params as jparams
from rawphotoforge_tpu.kernels import ktrig as jktrig
from rawphotoforge_tpu.ops import pointwise as jpw

from rawphotoforge_tpu_torch.core import color as tcolor
from rawphotoforge_tpu_torch.core import curve as tcurve
from rawphotoforge_tpu_torch.core import params as tparams
from rawphotoforge_tpu_torch.kernels import ktrig as tktrig
from rawphotoforge_tpu_torch.ops import pointwise as tpw

# f32 transcendental implementations differ by a few ulps between XLA's CPU
# backend and torch's; 2e-6 absolute on values in [0, ~1.5] is ~16 ulps.
ULPS = 2e-6

CURVES = [
    ([0, 65535], [0, 65535]),
    ([0, 65535], [32767, 32767]),
    ([0, 16000, 40000, 65535], [1000, 20000, 46000, 65535]),
    ([0, 8000, 12000, 65535], [0, 2000, 60000, 65535]),
    ([0, 30000, 65535], [4000, 33000, 63000]),
    ([0, 40000, 65535], [36000, 30000, 36000]),
    ([100, 5000, 9000, 20000, 33000, 41000, 60000], [0, 9000, 4000, 30000, 31000, 50000, 65535]),
]


@pytest.mark.parametrize("cx,cy", CURVES)
def test_build_lut_bit_identical(cx, cy):
    np.testing.assert_array_equal(tcurve.build_lut(cx, cy), jcurve.build_lut(cx, cy))
    np.testing.assert_array_equal(tcurve.pchip_slopes_f32(cx, cy),
                                  jcurve.pchip_slopes_f32(cx, cy))


@pytest.mark.parametrize("cx,cy", CURVES)
@pytest.mark.parametrize("max_ctrl", [8, 32])
def test_pchip_coeffs_bit_identical(cx, cy, max_ctrl):
    tb, tc = tcurve.pchip_coeffs(cx, cy, max_ctrl=max_ctrl)
    jb, jc = jcurve.pchip_coeffs(cx, cy, max_ctrl=max_ctrl)
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(tc, jc)


def test_default_luts_and_lut_refit_bit_identical():
    np.testing.assert_array_equal(tcurve.identity_lut(), jcurve.identity_lut())
    np.testing.assert_array_equal(tcurve.constant_lut(), jcurve.constant_lut())
    lut = jcurve.build_lut(*CURVES[3])
    for a, b in zip(tcurve.lut_to_coeffs(lut), jcurve.lut_to_coeffs(lut)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(tcurve.CurveError):
        tcurve.pchip_slopes_f32([0, 0], [1, 2])


def _edit_sets():
    p = tparams.EditParameters()
    p.set_tone(exposure=0.7, contrast=25, shadow=30, highlight=-20, black=5, white=-5)
    p.set_whitebalance(temperature=25, tint=-10)
    p.set_vignette(40)
    p.set_lens_distortion(-30)
    p.set_sharpness(20)
    for slot, (cx, cy) in enumerate(CURVES[2:6]):
        p.set_curve(slot, cx, cy)
    q = tparams.EditParameters()
    q.set_tone(exposure=-1.2, contrast=-40)
    q.set_curve(tparams.BRIGHTNESS, [0, 30000, 65535], [0, 35000, 65535], channel=1)
    r = tparams.EditParameters()
    r.set_curve(tparams.LIGHTNESS, *CURVES[6])
    r.set_curve(tparams.HUE, raw_lut=jcurve.build_lut(*CURVES[4]))
    return [[tparams.EditParameters()], [p], [p, q], [p, q, r]]


def _to_jax(param_list):
    return [jparams.EditParameters.from_json(e.to_json()) for e in param_list]


@pytest.mark.parametrize("case", range(4))
@pytest.mark.parametrize("build_luts", [True, False])
def test_pack_params_bit_identical(case, build_luts):
    tl = _edit_sets()[case]
    jl = _to_jax(tl)
    t = tparams.pack_params(tl, extent=(40, 64), build_luts=build_luts, device="cpu")
    j = jparams.pack_params(jl, extent=(40, 64), build_luts=build_luts)
    for name in tparams._FIELDS:
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)), err_msg=name)
    assert tparams.default_curve_slots(tl) == jparams.default_curve_slots(jl)


def _edit_step(rng, params):
    """One random edit of ``params`` in place: a tone or white-balance
    slider, a curve point moved along x, y or both (through ``set_curve``
    or in place), a
    point added or taken away (the padded segment count moves with the
    largest), or a mask added in place of the last regional one."""
    kind = rng.choice(["tone", "wb", "move", "move_in_place", "count", "mask"])
    e = params[int(rng.integers(len(params)))]
    slot = int(rng.integers(4))
    st = e.curves[slot]
    cx = (st.control_x if st.control_x is not None
          else tparams._default_points(slot)[0]).copy()
    cy = (st.control_y if st.control_y is not None
          else tparams._default_points(slot)[1]).copy()
    if kind == "tone":
        e.set_tone(exposure=rng.uniform(-2, 2), contrast=int(rng.integers(-60, 61)))
    elif kind == "wb":
        e.set_whitebalance(int(rng.integers(-80, 81)), int(rng.integers(-80, 81)))
    elif kind in ("move", "move_in_place") and len(cx) > 2:
        k = int(rng.integers(1, len(cx) - 1))
        axes = rng.choice(["x", "y", "xy"])
        if "x" in axes and cx[k + 1] - cx[k - 1] > 2:
            cx[k] = rng.integers(cx[k - 1] + 1, cx[k + 1])
        if "y" in axes:
            cy[k] = rng.integers(0, 65536)
        if kind == "move":
            e.set_curve(slot, cx, cy)
        else:
            st.control_x[:], st.control_y[:] = cx, cy
    elif kind == "count":
        gaps = np.flatnonzero(np.diff(cx) > 2)
        if len(cx) < 12 and len(gaps) and rng.random() < 0.6:
            g = int(rng.choice(gaps))
            x = int(rng.integers(cx[g] + 1, cx[g + 1]))
            e.set_curve(slot, np.insert(cx, g + 1, x),
                        np.insert(cy, g + 1, int(rng.integers(0, 65536))))
        elif len(cx) > 2:
            k = int(rng.integers(1, len(cx) - 1))
            e.set_curve(slot, np.delete(cx, k), np.delete(cy, k))
    elif kind == "mask":
        m = tparams.EditParameters()
        m.set_curve(tparams.SATURATION, [0, 20000, 45000, 65535],
                    [30000, int(rng.integers(20000, 45000)), 33000, 30000])
        if len(params) < 6:
            params.append(m)
        else:
            params[-1] = m


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_params_with_a_warm_fit_memo_is_bit_identical(seed):
    import copy

    rng = np.random.default_rng(seed)
    params = [tparams.EditParameters() for _ in range(4)]
    for e, (cx, cy) in zip(params, CURVES[2:6]):
        e.set_curve(tparams.BRIGHTNESS, cx, cy)
        e.set_curve(tparams.LIGHTNESS, [0, 40000, 65535], [36000, 30000, 36000])
    tparams.pack_params(params, build_luts=False, device="cpu")
    fits = hits = 0
    for _ in range(60):
        _edit_step(rng, params)
        before = dict(tparams.COUNTS)
        warm = tparams.pack_params(params, build_luts=False, device="cpu")
        fits += tparams.COUNTS["curve_fits"] - before["curve_fits"]
        hits += tparams.COUNTS["curve_fit_hits"] - before["curve_fit_hits"]
        fresh = copy.deepcopy(params)
        for e in fresh:
            for c in e.curves:
                c._fit = None
        cold = tparams.pack_params(fresh, build_luts=False, device="cpu")
        for name in tparams._FIELDS:
            assert torch.equal(getattr(warm, name), getattr(cold, name)), name
        assert warm.default_slots == cold.default_slots
    # Most warm packs refit one curve or none; a mask added or a segment
    # count changed refits them all.
    assert 0 < fits < hits
    # ... and the end state packs as the JAX package packs it.
    j = jparams.pack_params(_to_jax(params), build_luts=False)
    assert np.array_equal(warm.coeffs.numpy(), np.asarray(j.coeffs))
    assert np.array_equal(warm.breaks.numpy(), np.asarray(j.breaks))


@pytest.mark.parametrize("case", range(4))
def test_develop_params_from_numpy_matches_pack(case):
    jl = _to_jax(_edit_sets()[case])
    j = jparams.pack_params(jl, extent=(12, 34))
    d = {name: np.asarray(getattr(j, name)) for name in tparams._FIELDS}
    t = tparams.develop_params_from_numpy(d, device="cpu")
    for name in tparams._FIELDS:
        np.testing.assert_array_equal(getattr(t, name).numpy(), d[name])
    assert t.gains.dtype == torch.float32 and t.luts.dtype == torch.int32


def _slot_sessions():
    """Sessions of 1, 3 and 4 masks mixing default, edited (including an
    edit back to the default points) and raw-LUT curves."""
    sets = _edit_sets()
    s = tparams.EditParameters()
    s.set_curve(tparams.SATURATION, [0, 65535], [32767, 32767])  # the default
    s.set_curve(tparams.BRIGHTNESS, raw_lut=jcurve.build_lut(*CURVES[2]))
    return {"one_default": sets[0], "one_edited": sets[1],
            "three": sets[3], "four": [*sets[3], s]}


@pytest.mark.parametrize("session", sorted(_slot_sessions()))
def test_pack_params_sets_default_slots(session):
    """The packed params carry the curves' shortcut table: exactly
    ``default_curve_slots`` of the edits, kept by ``to`` and by
    ``dataclasses.replace`` of another field."""
    plist = _slot_sessions()[session]
    for build_luts in (True, False):
        t = tparams.pack_params(plist, extent=(40, 64), build_luts=build_luts,
                                device="cpu")
        assert t.default_slots == tparams.default_curve_slots(plist)
        assert len(t.default_slots) == t.num_masks == len(plist)
        assert t.to("cpu").default_slots == t.default_slots
        moved = dataclasses.replace(t, extent=torch.zeros(2))
        assert moved.default_slots == t.default_slots
    if session == "four":
        assert t.default_slots[3] == (False, True, True, True)
        assert t.default_slots[2][1] is False  # a raw LUT is never default


@pytest.mark.parametrize("case", range(4))
def test_develop_params_from_numpy_without_slots_takes_no_shortcut(case):
    """Params built from the JAX package's fields (no ``default_slots``)
    take no curve shortcut; a table of the wrong length is refused."""
    plist = _edit_sets()[case]
    j = jparams.pack_params(_to_jax(plist), extent=(12, 34))
    d = {name: np.asarray(getattr(j, name)) for name in tparams._FIELDS}
    t = tparams.develop_params_from_numpy(d, device="cpu")
    assert t.default_slots == ((False,) * 4,) * len(plist)
    slots = tparams.default_curve_slots(plist)
    with_slots = tparams.develop_params_from_numpy(dict(d, default_slots=slots),
                                                   device="cpu")
    assert with_slots.default_slots == slots
    with pytest.raises(ValueError, match="default_slots"):
        tparams.develop_params_from_numpy(
            dict(d, default_slots=((True,) * 4,) * (len(plist) + 1)), device="cpu")
    with pytest.raises(ValueError, match="default_slots"):
        tparams.develop_params_from_numpy(
            dict(d, default_slots=((True,) * 3,) * len(plist)), device="cpu")


@pytest.mark.parametrize("case", range(4))
def test_preset_json_round_trips_between_packages(case):
    for t in _edit_sets()[case]:
        j = jparams.EditParameters.from_json(json.loads(t.dumps()))
        assert json.loads(j.dumps()) == json.loads(t.dumps())
        back = tparams.EditParameters.loads(j.dumps())
        assert back.to_json() == t.to_json()


def test_v1_preset_loads_identically():
    v1 = {"exposure": 1.5, "contrast": 20, "wb_temperature": -30,
          "brightness_curve_points": [[0, 0], [30000, 40000], [65535, 65535]],
          "hue_curve_points": [[0, 1000], [65535, 64000]]}
    assert (tparams.EditParameters.from_json(v1).to_json()
            == jparams.EditParameters.from_json(v1).to_json())


def test_setters_validate_before_mutating():
    p = tparams.EditParameters()
    with pytest.raises(tcurve.CurveError):
        p.set_curve(tparams.HUE, [0, 65535], [0, 65535], channel=1)
    with pytest.raises(tcurve.CurveError):
        p.set_curve(tparams.BRIGHTNESS, [0], [0])
    with pytest.raises(tcurve.CurveError):
        p.set_curve(tparams.BRIGHTNESS, list(range(33)), list(range(33)))
    assert p.to_json() == tparams.EditParameters().to_json()
    p.set_tone(exposure=50, contrast=-500)
    assert (p.exposure, p.contrast) == (10.0, -100)


def _rand(rng, shape, lo=-0.2, hi=1.3):
    return (lo + (hi - lo) * rng.random(shape)).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_srgb_transfer_functions(rng):
    x = _rand(rng, (64, 96))
    np.testing.assert_allclose(tcolor.linear_to_srgb(_t(x)).numpy(),
                               np.asarray(jcolor.linear_to_srgb(jnp.asarray(x))),
                               rtol=0, atol=ULPS)
    y = _rand(rng, (64, 96), 0.0, 1.0)
    np.testing.assert_allclose(tcolor.srgb_to_linear(_t(y)).numpy(),
                               np.asarray(jcolor.srgb_to_linear(jnp.asarray(y))),
                               rtol=0, atol=ULPS)


def test_oklch_round_trip_and_luma(rng):
    r, g, b = (_rand(rng, (48, 160), 0.0, 1.0) for _ in range(3))
    tl = tcolor.linear_srgb_to_oklch(_t(r), _t(g), _t(b))
    jl = jcolor.linear_srgb_to_oklch(jnp.asarray(r), jnp.asarray(g), jnp.asarray(b))
    # L and C: a few ulps. Hue in turns: atan2(B, A) turns an ulp of A or
    # B into ulp/C turns, so it is held to 2e-6 (with wrap-around) only
    # where the chroma is not tiny (C > 1e-2).
    for a, e in zip(tl[:2], jl[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), rtol=0, atol=ULPS)
    dh = np.abs(tl[2].numpy() - np.asarray(jl[2]))
    dh = np.minimum(dh, 1.0 - dh)[np.asarray(jl[1]) > 1e-2]
    assert dh.max() < 2e-6, dh.max()
    tb = tcolor.oklch_to_linear_srgb(*tl)
    jb = jcolor.oklch_to_linear_srgb(*jl)
    for a, e in zip(tb, jb):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(
        tcolor.luma(_t(r), _t(g), _t(b)).numpy(),
        np.asarray(jcolor.luma(jnp.asarray(r), jnp.asarray(g), jnp.asarray(b))))


def test_ktrig_polynomials(rng):
    y = _rand(rng, (4000,), -1.0, 1.0)
    x = _rand(rng, (4000,), -1.0, 1.0)
    y[:4] = [0.0, 0.0, -0.5, 0.5]
    x[:4] = [1.0, -1.0, 0.0, 0.0]
    np.testing.assert_allclose(tktrig.atan2_turns(_t(y), _t(x)).numpy(),
                               np.asarray(jktrig.atan2_turns(jnp.asarray(y), jnp.asarray(x))),
                               rtol=0, atol=1e-7)
    h = _rand(rng, (4000,), 0.0, 1.0)
    for a, e in zip(tktrig.sincos_turns(_t(h)), jktrig.sincos_turns(jnp.asarray(h))):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), rtol=0, atol=1e-7)


def test_ktrig_fast_powers_accuracy():
    """cbrt_fast / linear_to_srgb_fast against float64 references, with the
    -0.0 / subnormal edge cases (the JAX package's accuracy gate)."""
    xs = np.concatenate([
        [-1.0, -0.0, 0.0, 1e-45, 1e-38, 1e-30, 0.0031308, 1.3],
        np.logspace(-12, 0.2, 5000),
    ]).astype(np.float32)
    out = tktrig.cbrt_fast(_t(xs)).numpy()
    assert not np.isnan(out).any()
    ref = np.cbrt(np.maximum(xs, 0).astype(np.float64))
    rel = np.abs(out - ref) / np.maximum(ref, 1e-30)
    assert rel[xs > 1e-20].max() < 1e-6
    s = tktrig.linear_to_srgb_fast(_t(xs)).numpy()
    xx = np.maximum(xs.astype(np.float64), 0)
    sref = np.where(xs <= 0.0031308, xs * 12.92, 1.055 * xx ** (1 / 2.4) - 0.055)
    assert np.abs(s - sref).max() < 1e-6
    # Same as the JAX function away from subnormals (which XLA's CPU
    # backend flushes to zero).
    normal = xs > 1e-20
    np.testing.assert_allclose(
        out[normal], np.asarray(jktrig.cbrt_fast(jnp.asarray(xs)))[normal],
        rtol=1e-6, atol=0)


def test_srgb_oetf_matches_pow_form(rng):
    """The kernels' OETF (x^(1/2.4) as exp2(log2(x)/2.4)) against the
    torch.pow form of the exact-LUT anchor and the JAX package's, on a
    dense sample with values below 0, on the linear segment and above 1."""
    x = np.concatenate([_rand(rng, (20000,), -0.2, 1.3),
                        np.linspace(0.0, 0.01, 5001), np.linspace(1.0, 64.0, 5001),
                        [0.0, -0.0, 0.0031308, 1.0]]).astype(np.float32)
    ours = tktrig.srgb_oetf(_t(x)).numpy()
    np.testing.assert_allclose(ours, tcolor.linear_to_srgb(_t(x)).numpy(),
                               rtol=ULPS, atol=ULPS)
    np.testing.assert_allclose(ours, np.asarray(jcolor.linear_to_srgb(jnp.asarray(x))),
                               rtol=ULPS, atol=ULPS)


def test_srgb_oetf_clamped_store_above_one_and_black():
    """What the edit stack stores: above 1 the clamped OETF is exactly 1.0,
    as the pow form's is (dense sample up to 1e6, where x^5 would have
    overflowed an x^5-based root); black stays exactly 0, with no NaN."""
    x = torch.from_numpy(np.concatenate([
        np.linspace(1.001, 4.0, 20001), np.logspace(0.7, 6, 5001)]).astype(np.float32))
    ours = torch.clamp(tktrig.srgb_oetf(x), 0.0, 1.0)
    assert torch.equal(ours, torch.ones_like(x))
    assert torch.equal(ours, torch.clamp(tcolor.linear_to_srgb(x), 0.0, 1.0))
    black = tktrig.srgb_oetf(torch.zeros(4))
    assert not torch.isnan(black).any() and torch.equal(black, torch.zeros(4))


TONES = [
    (0.0, 0.0, 0.0, 0.0, 0.0, 0.0),
    (0.7, 0.25, 0.30, -0.20, 0.05, -0.05),
    (-1.5, -0.6, -0.4, 0.5, -0.2, 0.3),
    (2.0, 1.0, 1.0, -1.0, 1.0, -1.0),
]


@pytest.mark.parametrize("tv", TONES)
def test_white_balance_and_tone(rng, tv):
    r, g, b = (_rand(rng, (48, 160), 0.0, 1.2) for _ in range(3))
    gains = np.asarray([1.2, 0.95, 0.8], np.float32)
    tvec = np.asarray(tv, np.float32)
    tt = tpw.tone(*tpw.white_balance(_t(r), _t(g), _t(b), _t(gains)), _t(tvec))
    jt = jpw.tone(*jpw.white_balance(jnp.asarray(r), jnp.asarray(g),
                                     jnp.asarray(b), jnp.asarray(gains)),
                  jnp.asarray(tvec))
    # exp2 of the exposure may differ by an ulp between the two math
    # libraries; everything after is the same op order.
    for a, e in zip(tt, jt):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), rtol=0, atol=ULPS)


@pytest.mark.parametrize("value", [0.0, 40.0, -75.0, 100.0])
def test_vignette(rng, value):
    h, w = 48, 160
    r, g, b = (_rand(rng, (h, w), 0.0, 1.0) for _ in range(3))
    ys = np.arange(h, dtype=np.int32)[:, None]
    xs = np.arange(w, dtype=np.int32)[None, :]
    # A bucket-padded frame normalizes by its true extent (40 x 150 here).
    tv = tpw.vignette(_t(r), _t(g), _t(b), torch.tensor(value), torch.tensor(40.0),
                      torch.tensor(150.0), _t(ys), _t(xs))
    jv = jpw.vignette(jnp.asarray(r), jnp.asarray(g), jnp.asarray(b),
                      jnp.float32(value), jnp.float32(40.0), jnp.float32(150.0),
                      jnp.asarray(ys), jnp.asarray(xs))
    for a, e in zip(tv, jv):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), rtol=0, atol=ULPS)


@pytest.mark.parametrize("gamma", [(2.222, 4.5 / 255.0), (2.4, 12.92), (1.8, 0.0)])
def test_apply_gamma_matches_jax(gamma):
    x = np.linspace(-0.2, 1.3, 20001, dtype=np.float32)
    t = tcolor.apply_gamma(torch.from_numpy(x), gamma).numpy()
    j = np.asarray(jcolor.apply_gamma(jnp.asarray(x), gamma))
    assert t.dtype == np.float32
    np.testing.assert_allclose(t, j, atol=ULPS, rtol=0)


@pytest.mark.parametrize("xs,ys", CURVES)
@pytest.mark.parametrize("max_ctrl", [8, 16])
def test_eval_packed_matches_jax(xs, ys, max_ctrl):
    """The packed-PCHIP evaluation at every LUT position (and beyond both
    ends): the same selects and Horner steps in f32, bit for bit."""
    breaks, coeffs = tcurve.pchip_coeffs(np.asarray(xs, np.int32),
                                         np.asarray(ys, np.int32), max_ctrl=max_ctrl)
    u = np.arange(-100, 65636, dtype=np.float32)
    t = tcurve.eval_packed(torch.from_numpy(u), torch.from_numpy(breaks),
                           torch.from_numpy(coeffs)).numpy()
    j = np.asarray(jcurve.eval_packed(jnp.asarray(u), jnp.asarray(breaks),
                                      jnp.asarray(coeffs)))
    np.testing.assert_array_equal(t, j)


# -- the last public names ----------------------------------------------------

def test_default_curve_points_equal_jax():
    for name in ("IDENTITY_POINTS", "CONSTANT_POINTS"):
        ours, ref = getattr(tcurve, name), getattr(jcurve, name)
        assert len(ours) == len(ref) == 2
        for a, b in zip(ours, ref):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    # They are the control points of the default curves the kernel packs.
    for slot, pts in ((tparams.BRIGHTNESS, tcurve.IDENTITY_POINTS),
                      (tparams.HUE, tcurve.IDENTITY_POINTS),
                      (tparams.SATURATION, tcurve.CONSTANT_POINTS),
                      (tparams.LIGHTNESS, tcurve.CONSTANT_POINTS)):
        for a, b in zip(tparams._default_points(slot), pts):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("obj", [
    None, {"x": [0, 30000, 65535], "y": [0, 36000, 65535]},
    {"raw_lut": list(range(0, 65536 * 2, 2))}])
def test_curve_state_from_json_equals_jax(obj):
    ours, ref = tparams.CurveState.from_json(obj), jparams.CurveState.from_json(obj)
    for field in ("control_x", "control_y", "raw_lut"):
        a, b = getattr(ours, field), getattr(ref, field)
        assert (a is None) == (b is None), field
        if a is not None:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert ours.to_json() == ref.to_json()
    if obj is not None:
        for slot in range(4):
            np.testing.assert_array_equal(ours.lut(slot), ref.lut(slot))


def test_edit_parameters_from_json_through_curve_state_round_trips():
    p = tparams.EditParameters()
    p.set_tone(exposure=0.4, contrast=12)
    p.set_curve(tparams.BRIGHTNESS, [0, 21000, 65535], [500, 30000, 65535], channel=1)
    p.set_curve(tparams.SATURATION, raw_lut=np.full(65536, 30000))
    d = p.to_json()
    q = tparams.EditParameters.from_json(json.loads(json.dumps(d)))
    assert q.to_json() == d
    assert jparams.EditParameters.from_json(d).to_json() == d
    with pytest.raises(tcurve.CurveError):  # set_curve's validation still runs
        tparams.EditParameters.from_json(
            {"curves": {"brightness": {"x": [0, 0, 65535], "y": [0, 1, 2]}}})


def test_jpegenc_available_and_editor_pad_to_bucket_np():
    from rawphotoforge_tpu.engine.editor import pad_to_bucket_np as jpad
    from rawphotoforge_tpu.io import jpegenc as jjpegenc

    from rawphotoforge_tpu_torch.engine.editor import SHAPE_BUCKET, pad_to_bucket_np
    from rawphotoforge_tpu_torch.io import jpegenc

    assert jpegenc.available() is True and jjpegenc.available() is True
    arr = np.arange(2 * 5 * 131, dtype=np.float32).reshape(2, 5, 131)
    assert SHAPE_BUCKET == 128
    for bucket in ((), (16,)):
        np.testing.assert_array_equal(pad_to_bucket_np(arr, *bucket), jpad(arr, *bucket))
    assert pad_to_bucket_np(arr).shape == (2, 128, 256)
