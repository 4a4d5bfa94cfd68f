"""The port's masks against the JAX package's on the CPU: ``ops/masking``
(similarity, labelled logits, the geodesic flood and smart select, feather,
luminance, overlay), the sweep kernel's plain twin (``kernels/geodesic``),
and the editor's ``add_similarity_mask`` / ``add_smart_mask`` /
``add_model_mask`` / ``mask_overlay_srgb`` on the same image and prompts.

Tolerances: the geodesic distance meets the JAX test's rtol=1e-4,
atol=1e-5 (``tests/test_smart_select.py:61``) against both JAX and the
scipy Dijkstra oracle; ``combine_labeled_logits`` is exact; the other maps
agree within 1e-5 (the frameworks' OKLab cube roots differ by an ulp).
Editor logits meet ``torch_parity.assert_close_across``, and binarized
masks may differ only where the JAX logit lies within 1e-2 of the
threshold."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rawphotoforge_tpu.engine.editor import PhotoEditor as JEditor
from rawphotoforge_tpu.ops import masking as jm

from rawphotoforge_tpu_torch.engine.editor import FULL, LOW, MID, MaskNotFound, PhotoEditor
from rawphotoforge_tpu_torch.kernels import geodesic
from rawphotoforge_tpu_torch.ops import masking as tm

from conftest import random_linear_image
from torch_parity import assert_close_across, nongray_image

ATOL = 1e-5
KW = dict(mid_long_edge=32, low_long_edge=16)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _planes(seed, h, w, lo=0.2, span=0.5):
    rng = np.random.default_rng(seed)
    return (rng.random((3, h, w)).astype(np.float32) * span + lo)


def _two_regions(h=18, w=24):
    """Left/right halves of one colour, split by a dark vertical bar."""
    planes = np.full((3, h, w), 0.5, dtype=np.float32)
    planes[:, :, w // 2 - 1 : w // 2 + 1] = 0.02
    return planes


def _jax_geodesic(planes, seeds, edge_weight, spatial_cost, sweeps):
    return np.asarray(jm.geodesic_distance(
        jnp.asarray(planes), jnp.asarray(seeds, dtype=jnp.int32),
        jnp.float32(edge_weight), jnp.float32(spatial_cost), sweeps=sweeps))


def _dijkstra(planes, seeds, edge_weight, spatial_cost):
    """Exact geodesic distances (scipy) on the same 4-connected cost graph,
    from the JAX package's OKLab (tests/test_smart_select.py's oracle)."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import dijkstra

    lab = np.stack([np.asarray(c) for c in jm._oklab(jnp.asarray(planes))], -1)
    h, w = lab.shape[:2]
    idx = np.arange(h * w).reshape(h, w)
    rows, cols, vals = [], [], []
    for a, b, da in ((idx[:, :-1], idx[:, 1:], lab[:, 1:] - lab[:, :-1]),
                     (idx[:-1], idx[1:], lab[1:] - lab[:-1])):
        c = np.linalg.norm(da, axis=-1) * edge_weight + spatial_cost
        rows += [a.ravel(), b.ravel()]
        cols += [b.ravel(), a.ravel()]
        vals += [c.ravel(), c.ravel()]
    g = coo_matrix((np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
                   shape=(h * w, h * w))
    seeds = np.asarray(seeds).reshape(-1, 2)
    d = dijkstra(g.tocsr(), indices=[int(idx[y, x]) for y, x in seeds])
    return d.min(0).reshape(h, w)


# -- the geodesic flood -------------------------------------------------------

@pytest.mark.parametrize("h,w,seeds", [
    (14, 17, (6, 4)),
    (14, 17, (0, 0)),
    (14, 17, (13, 16)),
    (9, 23, [(0, 22), (8, 0), (4, 11)]),
    (1, 30, (0, 7)),
    (25, 1, (3, 0)),
])
def test_geodesic_distance_matches_jax_and_dijkstra(h, w, seeds):
    planes = _planes(5, h, w)
    ours = tm.geodesic_distance(_t(planes), seeds, 8.0, 0.01, sweeps=12).numpy()
    ref = _jax_geodesic(planes, seeds, 8.0, 0.01, 12)
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ours, _dijkstra(planes, seeds, 8.0, 0.01),
                               rtol=1e-4, atol=1e-5)
    for y, x in np.asarray(seeds).reshape(-1, 2):
        assert ours[y, x] == 0.0


def test_geodesic_default_sweeps_match_jax():
    """Four rounds (the editor's flood) on a textured 40x56 image: the
    partial solution agrees with JAX's too, not only the converged one."""
    planes = _planes(11, 40, 56, lo=0.05, span=0.9)
    ours = tm.geodesic_distance(_t(planes), (20, 28), 12.0, 0.002).numpy()
    np.testing.assert_allclose(ours, _jax_geodesic(planes, (20, 28), 12.0, 0.002, 4),
                               rtol=1e-4, atol=1e-5)


def _numpy_sweep(d, gv, gh, direction):
    """The recurrence in float32 numpy, cell by cell, for the twin."""
    d = d.copy()
    h, w = d.shape
    fmin = lambda a, b: a if np.isnan(a) else (b if np.isnan(b) else min(a, b))  # noqa: E731
    if direction == "down":
        for y in range(1, h):
            for x in range(w):
                d[y, x] = fmin(d[y, x], np.float32(d[y - 1, x] + gv[y - 1, x]))
    elif direction == "up":
        for y in range(h - 2, -1, -1):
            for x in range(w):
                d[y, x] = fmin(d[y, x], np.float32(d[y + 1, x] + gv[y, x]))
    elif direction == "right":
        for x in range(1, w):
            for y in range(h):
                d[y, x] = fmin(d[y, x], np.float32(d[y, x - 1] + gh[y, x - 1]))
    else:
        for x in range(w - 2, -1, -1):
            for y in range(h):
                d[y, x] = fmin(d[y, x], np.float32(d[y, x + 1] + gh[y, x]))
    return d


@pytest.mark.parametrize("direction", geodesic.DIRECTIONS)
def test_sweep_twin_is_the_recurrence(direction):
    """Each direction of the twin (the wrapper's CPU path) equals the
    recurrence walked cell by cell, bit for bit; a NaN cost propagates."""
    rng = np.random.default_rng(3)
    h, w = 7, 9
    d = np.where(rng.random((h, w)) < 0.2, 0.0, 1e9).astype(np.float32)
    d[3, 4] = 0.5
    gv = rng.random((h - 1, w)).astype(np.float32)
    gh = rng.random((h, w - 1)).astype(np.float32)
    gv[2, 5] = gh[4, 3] = np.nan
    want = _numpy_sweep(d, gv, gh, direction)
    got = _t(d)
    before = dict(geodesic.KERNEL_LAUNCHES)
    geodesic.sweep(got, _t(gv), _t(gh), direction)
    assert geodesic.KERNEL_LAUNCHES == before  # a CPU tensor takes the twin
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_array_equal(got.numpy()[ok], want[ok])


def test_nan_pixel_floods_as_in_jax():
    """A NaN pixel makes NaN step costs, and the min propagates NaN (as
    jnp.minimum does) through the whole flood."""
    planes = _planes(8, 12, 15)
    planes[1, 6, 9] = np.nan
    ours = tm.geodesic_distance(_t(planes), (2, 2), 12.0, 0.002).numpy()
    ref = _jax_geodesic(planes, (2, 2), 12.0, 0.002, 4)
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(ref))
    # The NaN reaches every pixel the flood reaches: all of them.
    assert np.isnan(ours).all()


def _chainwise_flood(d, gv, gh, sweeps):
    """The flood in the card kernel's order, float32 numpy, cell by cell:
    each column walked down and straight back up, one column after another,
    then each row right and straight back left; a NaN operand of the min
    propagates."""
    d = d.copy()
    h, w = d.shape
    with np.errstate(invalid="ignore"):
        for _ in range(sweeps):
            for x in range(w):
                col = d[:, x]
                for y in range(1, h):
                    col[y] = np.minimum(col[y], col[y - 1] + gv[y - 1, x])
                for y in range(h - 2, -1, -1):
                    col[y] = np.minimum(col[y], col[y + 1] + gv[y, x])
            for y in range(h):
                row = d[y]
                for x in range(1, w):
                    row[x] = np.minimum(row[x], row[x - 1] + gh[y, x - 1])
                for x in range(w - 2, -1, -1):
                    row[x] = np.minimum(row[x], row[x + 1] + gh[y, x])
    return d


@pytest.mark.parametrize("h,w,seeds", [(23, 31, (11, 15)), (9, 40, [(0, 39), (8, 0)]),
                                       (37, 6, (36, 5))])
@pytest.mark.parametrize("sweeps", [1, 4, 12])
@pytest.mark.parametrize("nan", [False, True])
def test_chainwise_flood_is_the_twins_flood(h, w, seeds, sweeps, nan):
    """Walking each chain forward and straight back (the card kernel's
    fusion of down with up and of right with left) is the twin's flood bit
    for bit, NaN positions included, and meets JAX's geodesic_distance at
    the flood's rtol 1e-4."""
    planes = _planes(17 + h, h, w, lo=0.05, span=0.9)
    if nan:
        planes[1, h // 2, w // 3] = np.nan
    gv, gh = (t.numpy() for t in tm.step_costs(_t(planes), 12.0, 0.002))
    d0 = np.full((h, w), tm.BIG, np.float32)
    for y, x in np.asarray(seeds).reshape(-1, 2):
        d0[y, x] = 0.0
    want = _chainwise_flood(d0, gv, gh, sweeps)
    got = tm.geodesic_distance(_t(planes), seeds, 12.0, 0.002, sweeps=sweeps).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(want).any() == nan
    ok = ~np.isnan(want)
    np.testing.assert_array_equal(got[ok].view(np.int32), want[ok].view(np.int32))
    np.testing.assert_allclose(want, _jax_geodesic(planes, seeds, 12.0, 0.002, sweeps),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("h,w", [(5, 8), (5, 9), (1, 3), (4, 1)])
def test_flood_arrays_are_pitched_views(h, w):
    """step_costs and geodesic_distance hand the flood views whose rows lie
    geodesic.pitch(W) floats apart (a multiple of 4), the layout the card
    kernel reads in place; _pitched keeps such a view and pads a copy of a
    contiguous array whose rows are not."""
    p = geodesic.pitch(w)
    assert p % 4 == 0 and w <= p < w + 4
    gv, gh = tm.step_costs(_t(_planes(3, h, w)), 12.0, 0.002)
    assert gv.shape == (h - 1, w) and gh.shape == (h, w - 1)
    for t in (gv, gh):
        if t.numel():
            assert t.stride(-1) == 1 and (t.shape[0] <= 1 or t.stride(0) == p)
            assert geodesic._pitched(t, p) is t
    flat = torch.arange(h * w, dtype=torch.float32).reshape(h, w)
    padded = geodesic._pitched(flat, p)
    assert (padded is flat) == (p == w or h == 0)
    assert torch.equal(padded[:, :w], flat) and not padded[:, w:].any()
    d = tm.geodesic_distance(_t(_planes(3, h, w)), (0, 0), 12.0, 0.002)
    assert d.shape == (h, w) and (h == 1 or d.stride(0) == p) and d[0, 0] == 0.0


def test_sweep_wrapper_checks_its_inputs():
    d = torch.zeros((4, 5))
    gv, gh = torch.zeros((3, 5)), torch.zeros((4, 4))
    with pytest.raises(ValueError, match="step costs"):
        geodesic.sweep(d, gh, gv, "down")
    with pytest.raises(ValueError, match="float32"):
        geodesic.sweep(d.double(), gv, gh, "down")
    with pytest.raises(ValueError, match="direction"):
        geodesic.sweep(d, gv, gh, "diagonal")
    with pytest.raises(ValueError, match=r"d \[H, W\]"):
        geodesic.sweep(d[None], gv, gh, "down")


# -- similarity, labels, luminance, feather, overlay ---------------------------

@pytest.mark.parametrize("falloff,sigma", [(False, 1.0), (True, 6.0)])
def test_similarity_mask_matches_jax(falloff, sigma):
    planes = _planes(4, 20, 30, lo=0.0, span=1.0)
    ours = tm.similarity_mask(_t(planes), (5, 7), 0.1, sigma, falloff).numpy()
    ref = np.asarray(jm.similarity_mask(
        jnp.asarray(planes), jnp.asarray([5, 7]), jnp.float32(0.1),
        jnp.float32(sigma), spatial_falloff=falloff))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=ATOL)


def test_similarity_points_match_jax():
    planes = _planes(6, 16, 22)
    pts, labs = [(4, 5), (12, 18), (8, 2)], [1, 0, 1]
    ours = tm.similarity_mask_points(_t(planes), pts, labs, 0.3, 1.0, False).numpy()
    ref = np.asarray(jm.similarity_mask_points(
        jnp.asarray(planes), jnp.asarray(pts, dtype=jnp.int32),
        jnp.asarray(labs, dtype=jnp.int32), jnp.float32(0.3), jnp.float32(1.0),
        spatial_falloff=False))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("labels", [[1, 1, 0], [1, 1], [0, 1, 0, 1]])
def test_combine_labeled_logits_exact(labels):
    rng = np.random.default_rng(len(labels))
    stack = rng.uniform(-1, 1, (len(labels), 9, 11)).astype(np.float32)
    stack[-1, :3, :3] = stack[0, :3, :3]  # ties: an exclude as strong as an include
    ours = tm.combine_labeled_logits(_t(stack), labels).numpy()
    ref = np.asarray(jm.combine_labeled_logits(jnp.asarray(stack), jnp.asarray(labels)))
    np.testing.assert_array_equal(ours, ref)


def test_combine_labeled_logits_rules():
    stack = _t([[[0.8, -0.5], [0.1, 0.9]],     # include A
                [[-0.2, 0.7], [-0.9, -0.1]],   # include B
                [[0.9, -1.0], [0.05, -1.0]]])  # exclude
    out = tm.combine_labeled_logits(stack, [1, 1, 0]).numpy()
    np.testing.assert_allclose(out[0, 0], -0.9, atol=1e-6)  # carved
    np.testing.assert_allclose(out[0, 1], 0.7, atol=1e-6)
    np.testing.assert_allclose(out[1, 0], 0.1, atol=1e-6)
    out2 = tm.combine_labeled_logits(stack[:2], [1, 1]).numpy()
    np.testing.assert_array_equal(out2, np.maximum(stack[0].numpy(), stack[1].numpy()))


@pytest.mark.parametrize("lo,hi,soft", [(0.2, 0.6, 0.05), (0.0, 0.3, 0.1)])
def test_luminance_range_mask_matches_jax(lo, hi, soft):
    planes = random_linear_image(np.random.default_rng(2), 16, 24).transpose(2, 0, 1)
    ours = tm.luminance_range_mask(_t(planes), lo, hi, soft).numpy()
    ref = np.asarray(jm.luminance_range_mask(jnp.asarray(planes), lo, hi, soft))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=ATOL)
    assert ours.min() >= -1 and ours.max() <= 1


@pytest.mark.parametrize("radius", [1, 3, 4])
def test_feather_mask_matches_jax(radius):
    m = np.zeros((32, 32), np.float32)
    m[8:24, 8:24] = 1.0
    ours = tm.feather_mask(_t(m), radius=radius).numpy()
    ref = np.asarray(jm.feather_mask(jnp.asarray(m), radius=radius))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=ATOL)
    assert 0 < ours[7, 15] < 1


def test_mask_overlay_matches_jax():
    rng = np.random.default_rng(9)
    srgb = rng.random((3, 16, 16)).astype(np.float32)
    mask = (rng.random((16, 16)) > 0.5).astype(np.float32)
    for tint, alpha in (((1.0, 0.2, 0.2), 0.5), ((1, 0, 0), 1.0)):
        ours = tm.mask_overlay(_t(srgb), _t(mask), tint=tint, alpha=alpha).numpy()
        ref = np.asarray(jm.mask_overlay(jnp.asarray(srgb), jnp.asarray(mask),
                                         tint=tint, alpha=alpha))
        np.testing.assert_allclose(ours, ref, rtol=0, atol=ATOL)
    full = tm.mask_overlay(_t(srgb), torch.ones(16, 16), tint=(1, 0, 0), alpha=1.0)
    np.testing.assert_allclose(full[0].numpy(), 1.0, atol=1e-6)
    np.testing.assert_allclose(full[1].numpy(), 0.0, atol=1e-6)


# -- the selection semantics (tests/test_smart_select.py, test_extras.py) ------

def test_smart_select_respects_connectivity():
    planes = _two_regions()
    h, w = planes.shape[1:]
    logits = tm.smart_select_mask(_t(planes), (h // 2, 3), tolerance=0.3,
                                  edge_weight=12.0, spatial_cost=0.001).numpy()
    ref = np.asarray(jm.smart_select_mask(jnp.asarray(planes), (h // 2, 3),
                                          tolerance=0.3, edge_weight=12.0,
                                          spatial_cost=0.001))
    np.testing.assert_allclose(logits, ref, rtol=0, atol=ATOL)
    assert (logits[:, : w // 2 - 1] >= 0).mean() > 0.95
    assert (logits[:, w // 2 + 1 :] < 0).all()
    sim = tm.similarity_mask(_t(planes), (h // 2, 3), 0.1, 1.0, False).numpy()
    assert (sim[:, w // 2 + 1 :] >= 0).all()  # similarity leaks by design


def test_smart_points_exclude_splits_region():
    h, w = 16, 40
    p = _t(np.full((3, h, w), 0.5, dtype=np.float32))
    assert (tm.smart_select_mask(p, (8, 4), tolerance=1.0).numpy() >= 0).all()
    split = tm.smart_select_points(p, [(8, 4)], [(8, w - 5)], tolerance=1.0).numpy()
    ref = np.asarray(jm.smart_select_points(jnp.asarray(p.numpy()), [(8, 4)],
                                            [(8, w - 5)], tolerance=1.0))
    np.testing.assert_allclose(split, ref, rtol=0, atol=ATOL)
    assert (split[:, :10] >= 0).all() and (split[:, -10:] < 0).all()


def test_smart_points_multi_include_is_union():
    p = _t(_two_regions(18, 24))
    left_only = tm.smart_select_mask(p, (9, 4), tolerance=0.15).numpy()
    assert (left_only[:, 16:] < 0).all()
    both = tm.smart_select_points(p, [(9, 4), (9, 20)], None, tolerance=0.15).numpy()
    assert (both[:, :10] >= 0).all() and (both[:, 16:] >= 0).all()


def test_similarity_points_exclude_carves_color():
    h, w = 20, 30
    planes = np.zeros((3, h, w), dtype=np.float32)
    planes[:, :, : w // 2] = 0.55
    planes[0, :, w // 2:], planes[1, :, w // 2:], planes[2, :, w // 2:] = 0.62, 0.55, 0.50
    p = _t(planes)
    assert (tm.similarity_mask(p, (10, 5), 0.5, 1.0, False).numpy() >= 0).all()
    both = tm.similarity_mask_points(p, [(10, 5), (10, w - 5)], [1, 0], 0.5, 1.0,
                                     False).numpy()
    assert (both[:, : w // 2] >= 0).all() and (both[:, w // 2:] < 0).all()


def test_similarity_mask_selects_region_and_falls_off():
    img = np.full((3, 48, 64), 0.2, dtype=np.float32)
    img[:, :24, :] = np.array([0.8, 0.2, 0.1])[:, None, None]
    logits = tm.similarity_mask(_t(img), (5, 10), 0.1, 1.0, False).numpy()
    assert (logits[:24] > 0).mean() > 0.99 and (logits[26:] < 0).mean() > 0.99
    flat = tm.similarity_mask(_t(np.full((3, 64, 64), 0.5, np.float32)), (8, 8),
                              0.1, 6.0, True).numpy()
    assert flat[8, 8] > 0 and flat[60, 60] < 0


# -- the editor ---------------------------------------------------------------

def _editor_pair(img, **kw):
    ours = PhotoEditor.from_rgb_f32(img, device="cpu", use_kernel=False, **KW)
    ref = JEditor.from_rgb_f32(img, use_pallas=False, **KW)
    for ed in (ours, ref):
        ed.set_tone(exposure=0.4, contrast=15)
        ed.set_whitebalance(temperature=10)
        if kw.get("mask_range") is not None:
            ed.set_mask_range(kw["mask_range"])
    return ours, ref


def _assert_masks_match(ours, ref, name):
    a, b = ours._find(name), ref._find(name)
    assert isinstance(a.logits, np.ndarray) and a.logits.shape == ours.shape
    assert_close_across(a.logits[..., None], np.asarray(b.logits)[..., None])
    thr = ours.params().mask_range
    got = a.data_full.numpy().astype(np.float32)
    want = np.asarray(b.data_full)
    near = np.abs(np.asarray(b.logits) - thr) <= 1e-2
    assert ((got == want) | near).all()
    return got


PROMPTS = {
    "similarity-point": ("add_similarity_mask", dict(point_xy=(10, 8), color_tolerance=0.3)),
    "similarity-falloff": ("add_similarity_mask", dict(point_xy=(30, 20),
                                                       color_tolerance=0.4,
                                                       spatial_sigma=12.0)),
    "similarity-labels": ("add_similarity_mask", dict(points_xy=[(10, 8), (50, 30),
                                                                 (40, 10)],
                                                      labels=[1, 0, 1],
                                                      color_tolerance=0.35)),
    "smart-point": ("add_smart_mask", dict(point_xy=(12, 10), tolerance=0.6)),
    "smart-labels": ("add_smart_mask", dict(points_xy=[(12, 10), (50, 30), (60, 5)],
                                            labels=[1, 0, 1], tolerance=0.6)),
}


@pytest.mark.parametrize("case", sorted(PROMPTS))
def test_editor_masks_match_jax_editor(rng, case):
    method, kw = PROMPTS[case]
    ours, ref = _editor_pair(nongray_image(rng, 40, 64))
    getattr(ours, method)("sel", **kw)
    getattr(ref, method)("sel", **kw)
    got = _assert_masks_match(ours, ref, "sel")
    assert 0 < got.mean() < 1  # selects some pixels, not all
    for ed in (ours, ref):
        ed.set_tone(exposure=1.0, mask_name="sel")
    assert_close_across(ours.apply(FULL).numpy().transpose(1, 2, 0),
                        np.asarray(ref.apply(FULL)).transpose(1, 2, 0))


def _disk_logits(img, center, radius=9):
    """A stub model: +1 inside a disk around the click, the red channel
    elsewhere (so the logits depend on the render)."""
    h, w = img.shape[:2]
    yy, xx = np.mgrid[0:h, 0:w]
    inside = (xx - center[0]) ** 2 + (yy - center[1]) ** 2 <= radius ** 2
    return np.where(inside, 1.0, img[..., 0] / 255.0 - 1.0).astype(np.float32)


def test_editor_model_mask_matches_jax_editor(rng):
    ours, ref = _editor_pair(nongray_image(rng, 40, 64), mask_range=0.5)
    for ed in (ours, ref):
        ed.add_model_mask("ai", (32, 20), lambda im, pt: _disk_logits(im, pt))
        ed.add_model_mask("ai2", segmenter=lambda im, pts, labs: _disk_logits(
            im, pts[0])[::2, ::2], points_xy=[(12, 12), (40, 30)], labels=[1, 0])
    got = _assert_masks_match(ours, ref, "ai")
    assert got[20, 32] == 1.0 and 100 < got.sum() < 400
    _assert_masks_match(ours, ref, "ai2")


@pytest.mark.parametrize("level,cropped", [(MID, True), (FULL, False), (LOW, True)])
def test_mask_overlay_srgb_matches_jax_editor(rng, level, cropped):
    ours, ref = _editor_pair(nongray_image(rng, 40, 64))
    for ed in (ours, ref):
        ed.add_smart_mask("s", (12, 10), tolerance=0.6)
        ed.set_crop(4, 6, 60, 36)
    a = ours.mask_overlay_srgb("s", level, cropped=cropped).numpy()
    b = np.asarray(ref.mask_overlay_srgb("s", level, cropped=cropped))
    assert a.shape == b.shape
    assert_close_across(a.transpose(1, 2, 0), b.transpose(1, 2, 0))
    with pytest.raises(MaskNotFound):
        ours.mask_overlay_srgb("nope")


def test_editor_similarity_flow():
    h, w = 40, 64
    img = np.full((h, w, 3), 0.2, dtype=np.float32)
    img[:20] = [0.7, 0.3, 0.1]
    ed = PhotoEditor.from_rgb_f32(img, device="cpu", **KW)
    ed.add_similarity_mask("region", (10, 5), color_tolerance=0.1)
    ed.set_tone(exposure=2.0, mask_name="region")
    out = ed.apply(FULL).numpy()
    ref = PhotoEditor.from_rgb_f32(img, device="cpu", **KW).apply(FULL).numpy()
    assert out[:, :18].mean() > ref[:, :18].mean() + 0.05
    np.testing.assert_allclose(out[:, 22:], ref[:, 22:], atol=1e-6)


@pytest.mark.parametrize("method,kw", [
    ("add_similarity_mask", dict(color_tolerance=0.05)),
    ("add_smart_mask", dict(tolerance=0.08)),
])
def test_prompts_select_on_the_rendered_image(method, kw):
    """A strong vignette darkens only the render's corners: a tight prompt
    at the centre must leave them out (v1 predicts on the rendered image,
    raw_photo_forge.py:2409-2411)."""
    h, w = 48, 48
    img = np.full((h, w, 3), 0.5, dtype=np.float32)
    ed = PhotoEditor.from_rgb_f32(img, device="cpu", **KW)
    ed.set_vignette(-100)
    getattr(ed, method)("m", (w // 2, h // 2), **kw)
    mask = ed._find("m").data_full.numpy()
    assert mask[h // 2, w // 2] == 1 and mask[0, 0] == 0 and mask[-1, -1] == 0


def test_smart_mask_end_to_end_and_logits_on_host():
    planes = _two_regions(40, 64)
    ed = PhotoEditor(_t(planes), device="cpu")
    ed.add_smart_mask("subject", (8, 20), tolerance=0.3)
    assert isinstance(ed._find("subject").logits, np.ndarray)
    ed.set_tone(exposure=1.0, mask_name="subject")
    out = ed.apply().numpy()
    base = PhotoEditor(_t(planes), device="cpu").apply().numpy()
    assert (out[:, 20, 8] > base[:, 20, 8] + 0.05).all()
    np.testing.assert_allclose(out[:, 20, 52], base[:, 20, 52], atol=1e-5)
    before = ed._find("subject").data_full.float().mean()
    ed.set_mask_range(0.9)
    assert ed._find("subject").data_full.float().mean() < before


def test_prompt_validation():
    ed = PhotoEditor.from_rgb_f32(np.full((16, 16, 3), 0.4, np.float32),
                                  device="cpu", **KW)
    with pytest.raises(ValueError, match="point prompt"):
        ed.add_similarity_mask("a")
    with pytest.raises(ValueError, match="not both"):
        ed.add_smart_mask("a", (1, 1), points_xy=[(2, 2)])
    with pytest.raises(ValueError, match="labels"):
        ed.add_similarity_mask("a", points_xy=[(1, 1)], labels=[1, 0])
    with pytest.raises(ValueError, match="include"):
        ed.add_smart_mask("a", points_xy=[(1, 1)], labels=[0])
    for bad in ((16, 3), (-1, 3)):
        with pytest.raises(ValueError, match="outside the 16x16 frame"):
            ed.add_similarity_mask("a", bad)
    with pytest.raises(ValueError, match="outside"):
        tm.geodesic_distance(torch.ones((3, 4, 5)), [(0, 0), (4, 0)], 12.0, 0.002)
