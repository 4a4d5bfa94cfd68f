"""Port parity, ops layer: geometry, sharpen, the exact-LUT develop anchor,
stats. Same numpy inputs through the JAX package (CPU) and the port
(device="cpu"), each tolerance stated beside its check."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rawphotoforge_tpu.core.params import EditParameters as JEdit, pack_params as jpack
from rawphotoforge_tpu.ops import develop as jdev
from rawphotoforge_tpu.ops import geometry as jgeo
from rawphotoforge_tpu.ops import sharpen as jsharp
from rawphotoforge_tpu.ops import stats as jstats

from rawphotoforge_tpu_torch.core.params import (
    BRIGHTNESS, HUE, SATURATION, EditParameters, pack_params)
from rawphotoforge_tpu_torch.ops import develop as tdev
from rawphotoforge_tpu_torch.ops import geometry as tgeo
from rawphotoforge_tpu_torch.ops import sharpen as tsharp
from rawphotoforge_tpu_torch.ops import stats as tstats

from test_develop import assert_close
from torch_parity import assert_close_across, full_stack_edit, nongray_image


def _planes(rng, h=48, w=160):
    return nongray_image(rng, h, w).transpose(2, 0, 1).copy()


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_snap_and_warp_coords(rng):
    s = (rng.random(4096) * 4096).astype(np.float32)
    s[:64] = np.round(s[:64]) + np.float32(1e-5)
    np.testing.assert_array_equal(tgeo.snap_near_integer(_t(s)).numpy(),
                                  np.asarray(jgeo.snap_near_integer(jnp.asarray(s))))
    ys, xs = np.mgrid[0:48, 0:160].astype(np.int32)
    tw = tgeo.warp_coords(_t(ys), _t(xs), torch.tensor(48.0), torch.tensor(160.0),
                          torch.tensor(-0.2))
    jw = jgeo.warp_coords(jnp.asarray(ys), jnp.asarray(xs), jnp.float32(48.0),
                          jnp.float32(160.0), jnp.float32(-0.2))
    for a, e in zip(tw[:2], jw[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(tw[2].numpy(), np.asarray(jw[2]))


@pytest.mark.parametrize("distortion", [0.0, 1.0, 35.0, -60.0])
@pytest.mark.parametrize("extent", [None, (40, 150)])
def test_lens_distortion(rng, distortion, extent):
    p = _planes(rng)
    t = tdev.geometry_stage(_t(p), distortion, extent)
    j = jdev.geometry_stage_jit(jnp.asarray(p), jnp.float32(distortion),
                                None if extent is None else jnp.asarray(extent, jnp.float32))
    if distortion == 0.0:
        np.testing.assert_array_equal(t.numpy(), p)  # the identity short-cut
    # Bilinear weights from coordinates equal to ~1e-4 px (the warp's f32
    # divisions are fused differently by XLA); black-border flips are
    # what assert_close's out-of-bounds allowance is for.
    assert_close(t.numpy().transpose(1, 2, 0), np.asarray(j).transpose(1, 2, 0))


def test_resize(rng):
    p = _planes(rng, 48, 160)
    assert tgeo.resize_long_edge_shape(48, 160, 64) == jgeo.resize_long_edge_shape(48, 160, 64)
    assert tgeo.resize_long_edge_shape(4000, 6000, 1280) == (853, 1280)
    t = tgeo.resize_bilinear(_t(p), 19, 64)
    j = jgeo.resize_bilinear(jnp.asarray(p), 19, 64)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-6)
    padded = np.pad(p, ((0, 0), (0, 80), (0, 96)), mode="edge")
    t = tgeo.resize_bilinear_extents(_t(padded), (48, 160, 19, 64), (128, 128))
    j = jgeo.resize_bilinear_extents(jnp.asarray(padded),
                                     jnp.asarray([48, 160, 19, 64], jnp.int32), (128, 128))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-6)
    # In-extent values match the plain resize (one f32 ulp in the scale).
    np.testing.assert_allclose(t.numpy()[:, :19, :64],
                               tgeo.resize_bilinear(_t(p), 19, 64).numpy(),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("amount", [0.0, 0.4, 2.0])
def test_sharpen(rng, amount):
    p = _planes(rng)
    np.testing.assert_array_equal(tsharp._gauss_taps(1.0, 2), jsharp._gauss_taps(1.0, 2))
    np.testing.assert_allclose(tsharp.gaussian_blur(_t(p)).numpy(),
                               np.asarray(jsharp.gaussian_blur(jnp.asarray(p))),
                               rtol=0, atol=1e-6)
    t = tsharp.unsharp_mask(_t(p), amount)
    j = jsharp.unsharp_mask(jnp.asarray(p), jnp.float32(amount))
    # Same taps and order of accumulation: a few ulps.
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=5e-6)


def test_sharpen_thin_image_degrades_to_edge_padding(rng):
    p = _planes(rng, 2, 160)
    np.testing.assert_allclose(tsharp.gaussian_blur(_t(p)).numpy(),
                               np.asarray(jsharp.gaussian_blur(jnp.asarray(p))),
                               rtol=0, atol=1e-6)


def _regional():
    q = EditParameters()
    q.set_tone(contrast=50, exposure=-0.4)
    q.set_curve(SATURATION, [0, 65535], [45000, 45000])
    r = EditParameters()
    r.set_curve(BRIGHTNESS, [0, 30000, 65535], [0, 38000, 65535], channel=2)
    r.set_curve(HUE, [0, 20000, 65535], [3000, 24000, 65535])
    return [q, r]


def _jax_params(param_list, extent=None):
    return jpack([JEdit.from_json(e.to_json()) for e in param_list], extent=extent)


def _masks(rng, m, h, w):
    masks = (rng.random((m, h, w)) > 0.5).astype(np.float32)
    masks[0] = 1.0
    return masks


@pytest.mark.parametrize("case,mask_dtype", [
    (case, dtype) for case in ("defaults", "full", "regional", "channel", "extent")
    for dtype in ("none", "f32", "u8")
    if not (case == "regional" and dtype == "none")])  # masks=None: one mask
def test_develop_anchor_matches_jax_anchor(rng, case, mask_dtype):
    """The exact-LUT anchor: held to the JAX anchor with the kernel-vs-
    anchor rule (tight 1e-4, frac 2e-3, loose 5e-3) — the two compute the
    same LUT gathers, so only transcendental ulps can flip a LUT step."""
    h, w = 48, 160
    p = _planes(rng, h, w)
    extent = (40, 150) if case == "extent" else None
    plist = {"defaults": [EditParameters()], "full": [full_stack_edit()],
             "regional": [full_stack_edit(), *_regional()],
             "channel": [_regional()[1]], "extent": [full_stack_edit()]}[case]
    masks = None if mask_dtype == "none" else _masks(rng, len(plist), h, w)
    tm = None if masks is None else _t(masks.astype(np.uint8) if mask_dtype == "u8" else masks)
    t = tdev.develop_post_geo(_t(p), pack_params(plist, extent=extent, device="cpu"), tm)
    j = jdev.develop_post_geo_jit(jnp.asarray(p), _jax_params(plist, extent),
                                  None if masks is None else jnp.asarray(masks))
    assert_close_across(t.numpy().transpose(1, 2, 0), np.asarray(j).transpose(1, 2, 0))


def test_develop_with_distortion_and_edges(rng):
    p = _planes(rng, 48, 160)
    params = [full_stack_edit()]
    params[0].set_lens_distortion(-45)
    t = tdev.develop(_t(p), pack_params(params, device="cpu"), None)
    j = jdev.develop_jit(jnp.asarray(p), _jax_params(params), None)
    assert_close_across(t.numpy().transpose(1, 2, 0), np.asarray(j).transpose(1, 2, 0))
    np.testing.assert_array_equal(
        tdev.replicate_true_edges(_t(p), 40, 150).numpy(),
        np.asarray(jdev.replicate_true_edges(jnp.asarray(p), 40, 150)))


def test_encode_u8_u16(rng):
    x = (rng.random((3, 48, 160)) * 1.4 - 0.2).astype(np.float32)
    np.testing.assert_array_equal(tdev.encode_u8(_t(x)).numpy(),
                                  np.asarray(jdev.encode_u8(jnp.asarray(x))))
    np.testing.assert_array_equal(tdev.encode_u16(_t(x)).numpy(),
                                  np.asarray(jdev.encode_u16(jnp.asarray(x))))


def test_histogram_and_clipping(rng):
    x = (rng.random((3, 48, 160)) * 1.1 - 0.05).astype(np.float32)
    # Same f32 gray weights and truncation: equal counts (a bin may differ
    # by one count where the gray value lands within an ulp of an edge).
    th = tstats.histogram_rgbl(_t(x)).numpy()
    jh = np.asarray(jstats.histogram_rgbl(jnp.asarray(x)))
    assert np.abs(th - jh).max() <= 1 and th.sum() == jh.sum()
    rect = (5, 40, 17, 150)
    th = tstats.histogram_rgbl_rect(_t(x), rect).numpy()
    jh = np.asarray(jstats.histogram_rgbl_rect(jnp.asarray(x), jnp.asarray(rect, jnp.int32)))
    assert np.abs(th - jh).max() <= 1 and th.sum() == jh.sum() == 4 * 35 * 133
    for tc, jc in ((tstats.clipping_stats(_t(x)), jstats.clipping_stats(jnp.asarray(x))),
                   (tstats.clipping_stats_rect(_t(x), rect),
                    jstats.clipping_stats_rect(jnp.asarray(x), jnp.asarray(rect, jnp.int32)))):
        for k in ("highlight_clip_fraction", "shadow_clip_fraction"):
            assert float(tc[k]) == pytest.approx(float(jc[k]), abs=1e-7)
