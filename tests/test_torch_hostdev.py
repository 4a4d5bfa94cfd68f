"""The port's engine/hostdev (numpy mirror + the native host develop)
against the JAX package's engine/hostdev on the same seeded inputs.

Both sides run the same numpy code and the same C++ source (the port's
native/rpf_native.cpp holds a copy of the JAX package's host-develop
functions; the port builds it without -fopenmp, whose pragmas only split
independent rows over threads), so every output is compared bit for bit.
The port's mirror is also held against the port's own device anchor (the
plain torch develop on the CPU) with the JAX tests' fuzz bound, and
``render_u8_hwc(native=None)`` must never take the numpy path."""

import numpy as np
import pytest
import torch

from rawphotoforge_tpu.engine import hostdev as jhd

from rawphotoforge_tpu_torch import native as tnative
from rawphotoforge_tpu_torch.core.params import EditParameters as TEdit, pack_params
from rawphotoforge_tpu_torch.engine import hostdev as thd
from rawphotoforge_tpu_torch.ops import develop as tdev
from rawphotoforge_tpu_torch.ops.sharpen import unsharp_mask

from test_fuzz import _random_params, assert_fuzz_close


def _params(r, n, geometry=True):
    """n random JAX EditParameters (geometry sliders on the main mask) and
    their port twins through the shared JSON schema."""
    jl = [_random_params(r, allow_geometry=geometry and k == 0) for k in range(n)]
    if geometry:
        jl[0].set_sharpness(int(r.integers(0, 101)))
    return jl, [TEdit.from_json(p.to_json()) for p in jl]


def _image(r, h=40, w=56):
    return (r.random((3, h, w), dtype=np.float32) ** 1.8).astype(np.float32)


def _masks(r, n, h, w):
    if n == 1:
        return None
    m = (r.random((n, h, w)) > 0.5).astype(np.float32)
    m[0] = 1.0
    return m


@pytest.mark.parametrize("seed", range(4))
def test_develop_np_matches_jax(seed):
    r = np.random.default_rng(8100 + seed)
    img = _image(r)
    n = 1 + seed % 3
    jl, tl = _params(r, n)
    masks = _masks(r, n, 40, 56)
    want = jhd.develop_np(img, jl, masks)
    got = thd.develop_np(img, tl, masks)
    assert got.dtype == np.float32 and np.array_equal(got, want)


@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_render_u8_hwc_matches_jax(seed, native):
    r = np.random.default_rng(8200 + seed)
    img = _image(r, 36, 52)
    n = 1 + seed % 3
    jl, tl = _params(r, n)
    masks = _masks(r, n, 36, 52)
    want = jhd.render_u8_hwc(img, jl, masks, native=native)
    got = thd.render_u8_hwc(img, tl, masks, native=native)
    assert got.shape == (36, 52, 3) and got.dtype == np.uint8
    assert np.array_equal(got, want)


def test_render_u8_hwc_default_params_and_geometry_match_jax():
    """The default session (no LUT rows at all) and the native warp +
    unsharp inside the fused path, against the JAX package."""
    r = np.random.default_rng(8250)
    img = _image(r, 33, 47)
    for build in (lambda p: None,
                  lambda p: (p.set_lens_distortion(-60), p.set_sharpness(80)),
                  lambda p: p.set_vignette(100)):
        tp, jp = TEdit(), TEdit()
        build(tp)
        build(jp)
        want = jhd.render_u8_hwc(img, jhd_params(jp))
        assert np.array_equal(thd.render_u8_hwc(img, tp), want)


def jhd_params(tp):
    """The JAX twin of a port EditParameters."""
    from rawphotoforge_tpu.core.params import EditParameters as JEdit

    return JEdit.from_json(tp.to_json())


@pytest.mark.parametrize("native", [False, True])
def test_selection_logits_match_jax(native):
    r = np.random.default_rng(8300)
    img = (0.1 + 0.8 * r.random((3, 30, 42), dtype=np.float32)).astype(np.float32)
    for sigma in (0.0, 6.0):
        assert np.array_equal(
            thd.similarity_logits_np(img, (11, 23), 0.15, sigma, native=native),
            jhd.similarity_logits_np(img, (11, 23), 0.15, sigma, native=native))
    pts, labs = [(3, 4), (20, 30), (11, 23)], [1, 0, 1]
    assert np.array_equal(
        thd.similarity_logits_points_np(img, pts, labs, 0.1, 0.0, native=native),
        jhd.similarity_logits_points_np(img, pts, labs, 0.1, 0.0, native=native))
    assert np.array_equal(thd.smart_logits_np(img, (14, 8), 0.4, 12.0, native=native),
                          jhd.smart_logits_np(img, (14, 8), 0.4, 12.0, native=native))
    assert np.array_equal(
        thd.smart_logits_points_np(img, [(14, 8), (2, 2)], [(25, 40)], 0.3,
                                   native=native),
        jhd.smart_logits_points_np(img, [(14, 8), (2, 2)], [(25, 40)], 0.3,
                                   native=native))


def test_geodesic_distance_and_overlay_match_jax():
    r = np.random.default_rng(8350)
    img = r.random((3, 25, 31), dtype=np.float32)
    assert np.array_equal(thd.geodesic_distance_np(img, (5, 7), 12.0, 0.002),
                          jhd.geodesic_distance_np(img, (5, 7), 12.0, 0.002))
    u8 = (r.random((25, 31, 3)) * 255).astype(np.uint8)
    m = (r.random((25, 31)) > 0.5).astype(np.float32)
    assert np.array_equal(thd.mask_overlay_np(u8, m), jhd.mask_overlay_np(u8, m))
    stack = r.uniform(-1, 1, (3, 25, 31)).astype(np.float32)
    assert np.array_equal(thd.combine_labeled_logits_np(stack, [1, 0, 1]),
                          jhd.combine_labeled_logits_np(stack, [1, 0, 1]))


@pytest.mark.parametrize("distortion", [-100.0, -35.0, 40.0, 100.0])
def test_warp_matches_jax_and_native_is_bit_identical(distortion):
    r = np.random.default_rng(8400)
    img = r.random((3, 29, 45), dtype=np.float32)
    want = jhd.warp_np(img, distortion)
    assert np.array_equal(thd.warp_np(img, distortion), want)
    strength = np.float32(-0.5 * (distortion / 100.0))
    assert np.array_equal(tnative.warp_f32(img, strength), want)


@pytest.mark.parametrize("amount", [0.3, 1.0, 2.0])
def test_unsharp_matches_jax_and_native_is_bit_identical(amount):
    r = np.random.default_rng(8450)
    img = r.random((3, 21, 34), dtype=np.float32)
    want = jhd.unsharp_np(img, amount)
    assert np.array_equal(thd.unsharp_np(img, amount), want)
    got = tnative.unsharp_f32(img, thd._gauss_taps_np(1.0, 2), amount)
    assert np.array_equal(got, want)
    tiny = r.random((3, 2, 1), dtype=np.float32)  # edge-mode padding
    assert np.array_equal(tnative.unsharp_f32(tiny, thd._gauss_taps_np(1.0, 2), amount),
                          jhd.unsharp_np(tiny, amount))


@pytest.mark.parametrize("seed", range(3))
def test_develop_np_tracks_the_port_device_anchor(seed):
    """The mirror against the port's own plain torch pipeline on the CPU
    (warp -> unsharp -> develop_post_geo), with the JAX tests' fuzz bound."""
    r = np.random.default_rng(8500 + seed)
    img = _image(r)
    n = 1 + seed % 3
    _, tl = _params(r, n)
    masks = _masks(r, n, 40, 56)
    got = thd.develop_np(img, tl, masks)
    main = tl[0]
    planes = torch.from_numpy(img)
    geo = tdev.geometry_stage(planes, float(main.lens_distortion))
    if main.sharpness:
        geo = unsharp_mask(geo, main.sharpness / 100.0 * 2.0)
    packed = pack_params(tl, device="cpu")
    want = tdev.develop_post_geo(
        geo, packed, None if masks is None else torch.from_numpy(masks))
    assert_fuzz_close(got.transpose(1, 2, 0), want.numpy().transpose(1, 2, 0))


def test_native_none_never_takes_the_numpy_path(monkeypatch):
    """native=None is the native library: the numpy mirror never runs, and
    a failed build raises instead of falling back."""
    r = np.random.default_rng(8600)
    img = _image(r, 16, 20)
    p = TEdit()
    p.set_tone(exposure=0.4)

    def no_mirror(*a, **k):
        raise AssertionError("the numpy mirror ran")

    monkeypatch.setattr(thd, "develop_np", no_mirror)
    monkeypatch.setattr(thd, "geodesic_distance_np", no_mirror)
    monkeypatch.setattr(thd, "_oklab_np", no_mirror)
    assert thd.render_u8_hwc(img, p).shape == (16, 20, 3)
    thd.similarity_logits_np(img, (3, 3), 0.1)
    thd.smart_logits_np(img, (3, 3))

    def failed_build():
        raise tnative.NativeBuildError("building rpf_native.cpp failed")

    monkeypatch.setattr(tnative, "library", failed_build)
    for call in (lambda: thd.render_u8_hwc(img, p),
                 lambda: thd.render_u8_hwc(img, p, native=True),
                 lambda: thd.similarity_logits_np(img, (3, 3), 0.1),
                 lambda: thd.smart_logits_np(img, (3, 3))):
        with pytest.raises(tnative.NativeBuildError):
            call()
    monkeypatch.undo()
    # native=False is the numpy oracle and needs no library.
    monkeypatch.setattr(tnative, "library", failed_build)
    assert thd.render_u8_hwc(img, p, native=False).shape == (16, 20, 3)
