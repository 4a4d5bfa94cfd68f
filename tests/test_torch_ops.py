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

from chip_smoke import (GEOMETRY_DISTORTIONS, GEOMETRY_HW, GEOMETRY_SHARPNESS,
                        geometry_planes)
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


def test_develop_batch_matches_jax(rng):
    """One shared edit over a stack [N, 3, H, W]: each image the port's
    develop, and the JAX develop_batch within the cross-package rule; the
    package root exports it, as the JAX package's does."""
    import rawphotoforge_tpu_torch as port

    imgs = np.stack([_planes(rng, 24, 40) for _ in range(3)])
    plist = [full_stack_edit()]
    t = port.develop_batch(_t(imgs), pack_params(plist, device="cpu"), None)
    for i in range(3):
        np.testing.assert_array_equal(
            t[i].numpy(), tdev.develop(_t(imgs[i]), pack_params(plist, device="cpu"),
                                       None).numpy())
    j = np.asarray(jdev.develop_batch(jnp.asarray(imgs), _jax_params(plist), None))
    for a, b in zip(t.numpy(), j):
        assert_close_across(a.transpose(1, 2, 0), b.transpose(1, 2, 0))


def test_develop_post_geo_row_offset_renders_a_slab(rng):
    """A row slab with its global row offset and the whole image's extent
    renders the slab's rows of the whole render (the vignette's rows)."""
    p = _planes(rng, 48, 160)
    plist = [full_stack_edit()]
    whole = tdev.develop_post_geo(_t(p), pack_params(plist, device="cpu"), None)
    slab = tdev.develop_post_geo(_t(p[:, 20:33]),
                                 pack_params(plist, extent=(48, 160), device="cpu"),
                                 None, row_offset=20)
    np.testing.assert_array_equal(slab.numpy(), whole[:, 20:33].numpy())


def test_luma_linear_matches_jax(rng):
    x = (rng.random((3, 48, 160)) * 1.2).astype(np.float32)
    np.testing.assert_array_equal(tstats.luma_linear(_t(x)).numpy(),
                                  np.asarray(jstats.luma_linear(jnp.asarray(x))))


# -- the geometry-and-sharpen stage (kernels/geometry.py) -------------------------

def _kernel_model(planes, distortion, amount, extent, snapped=None):
    """csrc/geometry.cu's definition of each output pixel, in numpy float32:
    S(r, c) the warped value at the reflected index clamped to the extent
    it reads, then the 5-tap blur over rows and columns in _blur_axis's
    order and the unsharp. ``snapped`` (a list) gets the number of
    coordinates snap_near_integer moved."""
    f32 = np.float32
    _, h, w = planes.shape
    th, tw = extent
    strength = f32(-0.5) * (f32(distortion) / f32(100.0))
    warp = distortion != 0.0 and strength != 0.0
    rep = distortion != 0.0 and (h > th or w > tw)
    ch, cw = (th - 1, tw - 1) if rep else (h - 1, w - 1)

    def snap(s):
        r = np.rint(s)
        thr = np.maximum(np.abs(s) * f32(6e-7), f32(1e-4))
        near = np.abs(s - r) < thr
        if snapped is not None:
            snapped.append(int((near & (s != r)).sum()))
        return np.where(near, r, s)

    def sample(rows, cols):
        r, c = np.minimum(rows, ch), np.minimum(cols, cw)
        if not warp:
            return planes[:, r][:, :, c]
        hf, wf = f32(th), f32(tw)
        aspect = wf / hf
        cu = ((c.astype(f32) / wf - f32(0.5)) * aspect)[None, :]
        cv = (r.astype(f32) / hf - f32(0.5))[:, None]
        denom = f32(1.0) + strength * (cu * cu + cv * cv)
        fu = (cu / denom) / aspect + f32(0.5)
        fv = cv / denom + f32(0.5)
        oob = (fu < 0) | (fu > 1) | (fv < 0) | (fv > 1)
        px, py = snap(fu * (wf - f32(1))), snap(fv * (hf - f32(1)))
        x0f, y0f = np.floor(px), np.floor(py)
        x0 = np.clip(x0f, 0, tw - 1).astype(np.int64)
        y0 = np.clip(y0f, 0, th - 1).astype(np.int64)
        x1, y1 = np.minimum(x0 + 1, tw - 1), np.minimum(y0 + 1, th - 1)
        tx, ty = px - x0f, py - y0f
        cx0 = planes[:, y0, x0] * (f32(1) - tx) + planes[:, y0, x1] * tx
        cx1 = planes[:, y1, x0] * (f32(1) - tx) + planes[:, y1, x1] * tx
        return np.where(oob, f32(0), cx0 * (f32(1) - ty) + cx1 * ty)

    a32 = f32(amount)
    if a32 == 0:
        return sample(np.arange(h), np.arange(w))
    taps = tsharp._gauss_taps(1.0, 2)
    s = sample(tsharp._pad_index(h, 2), tsharp._pad_index(w, 2))
    v = f32(0) + taps[0] * s[:, 0:h]
    for i in range(1, 5):
        v = v + taps[i] * s[:, i:i + h]
    b = f32(0) + taps[0] * v[:, :, 0:w]
    for i in range(1, 5):
        b = b + taps[i] * v[:, :, i:i + w]
    x = s[:, 2:h + 2, 2:w + 2]
    y = x + a32 * (x - b)
    return np.where(y < 0, f32(0), y)


def _geometry_case_planes(h, w):
    return geometry_planes(np.random.default_rng(h * 1000 + w), h, w, "cpu")


@pytest.mark.parametrize("h,w,extent", GEOMETRY_HW)
@pytest.mark.parametrize("distortion", GEOMETRY_DISTORTIONS)
def test_geometry_twin_is_the_editor_chain_and_the_kernels_definition(
        h, w, extent, distortion):
    """On the CPU the wrapper runs its twin, the editor's former chain (warp,
    edge replication, unsharp), and never counts a launch; csrc/geometry.cu's
    per-pixel definition, computed in numpy, equals the twin bit for bit."""
    from rawphotoforge_tpu_torch.kernels import geometry

    planes = _geometry_case_planes(h, w)
    ext = extent or (h, w)
    for sharpness in GEOMETRY_SHARPNESS:
        amount = sharpness / 100.0 * 2.0
        before = dict(geometry.KERNEL_LAUNCHES)
        twin = geometry.geometry_sharpen(planes, distortion, amount, extent)
        assert geometry.KERNEL_LAUNCHES == before  # the twin never counts
        assert torch.equal(twin, geometry.geometry_sharpen_ref(planes, distortion,
                                                               amount, extent))
        if distortion == 0.0 and sharpness == 0.0:
            assert twin is planes
        np.testing.assert_array_equal(
            _kernel_model(planes.numpy(), distortion, amount, ext).view(np.int32),
            twin.numpy().view(np.int32), err_msg=f"{distortion} {sharpness}")


def test_geometry_snap_case_moves_coordinates():
    """GEOMETRY_DISTORTIONS' snap case lands coordinates within the
    threshold of whole pixels (snap_near_integer moves some), so the
    kernel's snap is checked against the twin's."""
    moved = []
    for h, w, extent in GEOMETRY_HW:
        _kernel_model(_geometry_case_planes(h, w).numpy(), 0.125, 0.0,
                      extent or (h, w), snapped=moved)
    assert sum(moved) > 0


def test_geometry_wrapper_refuses_bad_inputs():
    from rawphotoforge_tpu_torch.kernels import geometry

    planes = torch.rand(3, 8, 12)
    for bad, match in ((planes.double(), "float32"), (planes[:2], r"\[3, H, W\]"),
                       (planes[0], r"\[3, H, W\]"),
                       (planes.transpose(1, 2), "contiguous")):
        with pytest.raises(ValueError, match=match):
            geometry.geometry_sharpen(bad, 20.0, 0.5)
    with pytest.raises(TypeError, match="threshold"):  # the kernel computes none
        geometry.geometry_sharpen(planes, 20.0, 0.5, threshold=0.1)
    with pytest.raises(ValueError, match="extent"):
        geometry.geometry_sharpen(planes, 20.0, 0.5, (9, 12))
