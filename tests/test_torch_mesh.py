"""The port's parallel/mesh on four CPU ranks (torch.distributed, gloo) in
the meshes (2, 2), (1, 4) and (4, 1), against the port's single-device
functions and the JAX package's sharded functions on its 8-device CPU mesh
(tests/conftest.py), with the JAX tests' tolerances (tests/test_sharding.py):
sharded == single within 1e-6 (here: bit for bit), histograms exact, JPEG
streams byte for byte the single-device wire's. Across the packages: the
renders meet assert_close_across, and the files decode within the batch
bound of tests/test_torch_batch.py (1.5 % of samples over 1), none beyond
one quantization step's reach (tests/test_torch_jpegenc.py).

One world of four ranks runs every case (tests/torch_dist.mesh_case) once
for the module."""

import io

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from rawphotoforge_tpu import native as jnative
from rawphotoforge_tpu.core.params import EditParameters as JEdit, pack_params as jpack
from rawphotoforge_tpu.io import jpegenc as jjpeg
from rawphotoforge_tpu.ops import demosaic as jdm
from rawphotoforge_tpu.parallel import mesh as jmesh

from rawphotoforge_tpu_torch import native
from rawphotoforge_tpu_torch.core.params import BRIGHTNESS, SATURATION
from rawphotoforge_tpu_torch.io import jpegbits, jpegenc
from rawphotoforge_tpu_torch.kernels import fused
from rawphotoforge_tpu_torch.kernels.raw_pipeline import raw_develop_fused
from rawphotoforge_tpu_torch.ops import develop as tdev, stats as tstats
from rawphotoforge_tpu_torch.parallel import mesh as pm

from conftest import random_linear_image
from torch_dist import (FIRST_CALL_FRAMES, MESH_SHAPES, apply_edit, mesh_case, start_world,
                        warm_port_cpu)
from torch_fixtures import scene
from torch_parity import assert_close_across
from test_torch_batch import JPEG_FRAC_OVER_1

QUALITY = 92
QSTEP_REACH = 9
XYZ_TO_CAM = np.array([[0.8, -0.1, -0.05], [-0.3, 1.1, 0.15],
                       [-0.05, 0.15, 0.65]])
EDIT = [("set_tone", (0.8, 25, 10)), ("set_whitebalance", (20, -10)),
        ("set_vignette", (35,))]
WARP_EDIT = [("set_tone", (0.5, 15)), ("set_lens_distortion", (-70,))]
KERNEL_EDIT = [("set_tone", (0.6, 20)), ("set_vignette", (45,)),
               ("set_curve", (BRIGHTNESS, [0, 30000, 65535], [5000, 33000, 62000]))]
GEO_EDIT = [("set_tone", (0.5, 10)), ("set_vignette", (30,)),
            ("set_curve", (SATURATION, [0, 65535], [40000, 36000]))]
SHAPE_IDS = [f"{b}x{s}" for b, s in MESH_SHAPES]


def _planes(rng, h, w):
    return random_linear_image(rng, h, w).transpose(2, 0, 1).copy()


def _smooth(rng, h, w, texture=0.1):
    """A smooth scene with texture, in [0, 1]: what the JPEG comparisons
    across the packages are bounded on (tests/test_torch_batch.py)."""
    return np.clip(scene(rng, h, w, texture), 0.0, 1.0).astype(np.float32)


@pytest.fixture(scope="module")
def inputs():
    warm_port_cpu()
    rng = np.random.default_rng(1234)
    h, w = 64, 256
    masks = (rng.random((1, h, w)) > 0.5).astype(np.float32)
    return dict(
        imgs=np.stack([_planes(rng, 32, 128) for _ in range(8)]),
        planes=dict(img=_planes(rng, 64, 128), edit=EDIT, warp_edit=WARP_EDIT),
        uneven={"62": _planes(rng, 62, 128), "63": _planes(rng, 63, 128)},
        kernel={"64x256": dict(img=_planes(rng, h, w), masks=masks, edit=KERNEL_EDIT),
                "67x256": dict(img=_planes(rng, 67, 256),
                               masks=np.ones((1, 67, 256), np.float32),
                               edit=[("set_vignette", (40,))])},
        srgb=np.stack([_smooth(rng, 32, 128) * (0.5 + 0.06 * i) for i in range(8)]),
        mosaics=dict(frames={"RGGB": np.stack([_smooth(rng, 32, 128)[1] for _ in range(4)]),
                             "XTRANS": np.stack([_smooth(rng, 48, 96)[1] for _ in range(4)])},
                     wb=(1.8, 1.0, 1.4),
                     cam=jdm.cam_matrix_to_srgb(XYZ_TO_CAM), edit=EDIT,
                     sharpen=0.5),
        geos=dict(planes=np.stack([np.pad(_smooth(rng, 60, 120),
                                          [(0, 0), (0, 4), (0, 8)], mode="edge")
                                   for _ in range(4)]),
                  true=(60, 120), edit=GEO_EDIT),
        quality=QUALITY)


@pytest.fixture(scope="module", autouse=True)
def ranks(inputs, tmp_path_factory):
    """mesh_case on four gloo ranks, started before the module's first test:
    they run while this process builds the references."""
    return start_world(mesh_case, 4, tmp_path_factory.mktemp("mesh_world"),
                       first_calls=True, **inputs)


@pytest.fixture(scope="module")
def world(ranks, refs):
    """{shape: {name: result}} of each rank, collected after the references
    are built."""
    return ranks.results()


@pytest.fixture(scope="module")
def jax_mesh():
    return jmesh.make_mesh(n_batch=4, n_spatial=2)


def _tpack(spec, extent=None):
    from rawphotoforge_tpu_torch.core.params import EditParameters, pack_params

    return pack_params([apply_edit(EditParameters(), spec)], extent=extent,
                       device="cpu")


def _jpack(spec, extent=None):
    return jpack([apply_edit(JEdit(), spec)], extent=extent)


def _hwc(x):
    return np.asarray(x).transpose(1, 2, 0)


def _decode(jpeg: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(jpeg)).convert("RGB")).astype(np.int32)


def _files_agree(a: bytes, b: bytes):
    """The two packages' files of the same pixels: at most 1.5 % of samples
    more than 1 level apart (tests/test_torch_batch.py), none beyond one
    quantization step's reach (9 levels, tests/test_torch_jpegenc.py:190):
    the packages' fDCTs sum in another order, so a coefficient that
    straddles a step lands one step apart (ROADMAP C)."""
    if a == b:
        return
    da, db = _decode(a), _decode(b)
    assert da.shape == db.shape
    d = np.abs(da - db)
    assert d.max() <= QSTEP_REACH and (d > 1).mean() <= JPEG_FRAC_OVER_1, (
        d.max(), (d > 1).mean())


def _r(world, shape, name, rank=0):
    return world[rank][shape][name]


def _jax_packed_files(words, totals, h, w):
    out = []
    for i in range(words.shape[0]):
        nw, nbits = int(totals[i, 0]), int(totals[i, 1])
        out.append(jnative.jpeg_encode_packed(np.asarray(words[i])[:nw], nbits, h, w,
                                              quality=QUALITY))
    return out


def _np_all(ts):
    return tuple(t.numpy() for t in ts)


@pytest.fixture(scope="module")
def refs(inputs, jax_mesh):
    """Every reference of the comparisons, built once for the module: the
    port's single-device results and the JAX package's sharded ones on its
    8-device CPU mesh (neither depends on the port's mesh shape)."""
    r = {}
    imgs = inputs["imgs"]
    r["batch_develop"] = tdev.develop_batch(torch.from_numpy(imgs), _tpack(EDIT),
                                            torch.ones((1,) + imgs.shape[2:])).numpy()
    r["batch_develop_jax"] = np.asarray(jax.jit(jmesh.batch_develop_sharded,
                                                static_argnums=3)(
        jnp.asarray(imgs), _jpack(EDIT), jnp.ones((1,) + imgs.shape[2:]), jax_mesh))

    img = inputs["planes"]["img"]
    ones = torch.ones((1,) + img.shape[1:])
    r["spatial"] = tdev.develop(torch.from_numpy(img), _tpack(EDIT), ones).numpy()
    r["spatial_jax"] = np.asarray(jax.jit(jmesh.develop_spatial_sharded,
                                          static_argnums=3)(
        jnp.asarray(img), _jpack(EDIT), jnp.ones((1,) + img.shape[1:]), jax_mesh))
    for key, x in (("64", img), ("63", inputs["uneven"]["63"])):
        r[f"hist_{key}"] = tstats.histogram_rgbl(torch.from_numpy(x)).numpy()
        r[f"hist_{key}_jax"] = np.asarray(jax.jit(jmesh.histogram_sharded,
                                                  static_argnums=1)(jnp.asarray(x), jax_mesh))

    params = _tpack(WARP_EDIT)
    geo = tdev.geometry_stage(torch.from_numpy(img), params.distortion)
    warped = tdev.develop_post_geo(geo, params, ones)
    r["full_step_warp"] = (warped.numpy(), tstats.histogram_rgbl(warped).numpy())
    ref, ref_hist, _ = jax.jit(jmesh.full_step, static_argnums=3)(
        jnp.asarray(img), _jpack(WARP_EDIT), jnp.ones((1,) + img.shape[1:]), jax_mesh)
    r["full_step_warp_jax"] = (np.asarray(ref), np.asarray(ref_hist))
    for key, x in inputs["uneven"].items():
        h = x.shape[1]
        single = tdev.develop(torch.from_numpy(x), _tpack(EDIT), torch.ones((1, h, 128)))
        r[f"full_step_{key}"] = (
            single.numpy(), float(tstats.clipping_stats(single)["highlight_clip_fraction"]))

    # The JAX package's sharded Pallas develop: interpret mode, 8 'sp' shards.
    sp_mesh = jmesh.make_mesh(n_batch=1, n_spatial=8)
    for key, case in inputs["kernel"].items():
        h, w = case["img"].shape[1:]
        r[f"kernel_{key}"] = fused.develop_post_geo_fused(
            torch.from_numpy(case["img"]), _tpack(case["edit"], extent=(h, w)),
            torch.from_numpy(case["masks"])).numpy()
        r[f"kernel_{key}_jax"] = np.asarray(jax.jit(jmesh.develop_spatial_sharded,
                                                    static_argnums=(3, 4))(
            jnp.asarray(case["img"]), _jpack(case["edit"], extent=(h, w)),
            jnp.asarray(case["masks"]), sp_mesh, True))

    qlum, qchr = jpegenc._quant_tables(QUALITY)
    jq = tuple(jnp.asarray(t) for t in jjpeg._quant_tables(QUALITY))
    from rawphotoforge_tpu.io import jpegbits as jbits

    caps = (jbits.PACKED_ENT_WORDS, jbits.PACKED_OUT_WORDS)
    srgb = [torch.from_numpy(p) for p in inputs["srgb"]]
    r["wire"] = [_np_all(jpegbits.wire(p, qlum, qchr)) for p in srgb]
    r["wire_packed"] = [_np_all(jpegbits.wire_packed(p, qlum, qchr)) for p in srgb]
    words, totals = jax.jit(jmesh.entropy_batch_packed_sharded, static_argnums=1)(
        jnp.asarray(inputs["srgb"]), jax_mesh, *jq)
    r["srgb_files_jax"] = _jax_packed_files(np.asarray(words), np.asarray(totals), 32, 128)
    r["develop_wires"] = [_np_all(jpegbits.wire_packed(torch.from_numpy(x), qlum, qchr))
                          for x in r["batch_develop"]]

    mos = inputs["mosaics"]
    for pattern, frames in mos["frames"].items():
        r[f"raw_{pattern}"] = [_np_all(jpegbits.wire_packed(raw_develop_fused(
            torch.from_numpy(f), mos["wb"], mos["cam"], _tpack(mos["edit"]),
            mos["sharpen"], pattern=pattern), qlum, qchr)) for f in frames]
    words, totals = jax.jit(
        jmesh.export_batch_raw_fused_packed_step, static_argnums=(5, 8, 9, 10))(
        jnp.asarray(mos["frames"]["RGGB"]), jnp.asarray(mos["wb"]),
        jnp.asarray(mos["cam"]), _jpack(mos["edit"]), jnp.float32(mos["sharpen"]),
        jax_mesh, *jq, "RGGB", *caps)
    r["raw_files_jax"] = _jax_packed_files(np.asarray(words), np.asarray(totals), 32, 128)

    # The JAX package's CLI mesh step's files of the padded geometries.
    geos = inputs["geos"]
    th, tw = geos["true"]
    gp = _tpack(GEO_EDIT, extent=(th, tw))
    r["editor"] = [_np_all(jpegbits.wire_packed_extent(
        tdev.develop_post_geo(torch.from_numpy(g), gp, None), qlum, qchr, th, tw))
        for g in geos["planes"]]
    jw, jt = jax.jit(jmesh.export_batch_editor_packed_step,
                     static_argnums=(2, 5, 6, 7))(
        jnp.asarray(geos["planes"]), _jpack(GEO_EDIT, extent=(th, tw)), jax_mesh,
        *jq, (th, tw), *caps)
    r["editor_files_jax"] = _jax_packed_files(np.asarray(jw), np.asarray(jt), th, tw)
    return r


def test_make_mesh_without_a_process_group_raises():
    from rawphotoforge_tpu_torch.errors import PhotoEditorError

    with pytest.raises(PhotoEditorError, match="process group"):
        pm.make_mesh()


def test_first_develop_call_of_a_fresh_process(ranks, world):
    """Each rank is a fresh process: its first develop calls, on two
    intra-op threads, equal its later calls bit for bit. (A first torch
    sqrt split over threads could give one thread ~12-bit roots, up to
    1.5e-3 off after the develop; ops/pointwise readies the library on one
    thread when the package is imported, ROADMAP C.)"""
    assert len(ranks.first_calls) == 4
    for rank, first in enumerate(ranks.first_calls):
        assert sorted(first) == sorted(FIRST_CALL_FRAMES)
        for (h, w), (first_vs_second, second_vs_third, rows) in first.items():
            assert second_vs_third == 0.0, (rank, (h, w), second_vs_third)
            assert first_vs_second == 0.0 and rows == [], (rank, (h, w), first_vs_second, rows)


def test_make_mesh_cuda_gives_each_rank_its_card(world):
    """make_mesh(devices="cuda") in a world of four: rank r on cuda:r (its
    LOCAL_RANK), not four ranks on one index-less device."""
    assert [res["cuda_device"] for res in world] == [f"cuda:{r}" for r in range(4)]


def test_rank_device_gives_each_rank_its_card(monkeypatch):
    """``devices`` None or "cuda": rank r computes on the card LOCAL_RANK
    names, each rank its own; a named card ("cuda:0", ranks sharing it
    under gloo) and "cpu" are kept; a list is indexed by rank."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for rank in range(4):
        monkeypatch.setenv("LOCAL_RANK", str(rank))
        for devices in (None, "cuda", torch.device("cuda")):
            assert pm._rank_device(devices, rank) == torch.device("cuda", rank)
        assert pm._rank_device("cuda:0", rank) == torch.device("cuda", 0)
        assert pm._rank_device("cpu", rank) == torch.device("cpu")
        assert pm._rank_device(["cpu", "cuda:3", "cpu", "cuda:1"], rank) == torch.device(
            ["cpu", "cuda:3", "cpu", "cuda:1"][rank])


@pytest.mark.parametrize("shape", MESH_SHAPES, ids=SHAPE_IDS)
def test_mesh_shape_and_coordinates(world, shape):
    nb, ns = shape
    for rank, res in enumerate(world):
        assert res[shape]["shape"] == {"batch": nb, "sp": ns}
        assert res[shape]["coords"] == divmod(rank, ns)


def test_mesh_smaller_than_the_world(world, inputs):
    """make_mesh(1, 2) in a world of four: ranks 0 and 1 form it (the
    histogram of their rows), ranks 2 and 3 are outside and are refused."""
    want = tstats.histogram_rgbl(torch.from_numpy(inputs["planes"]["img"])).numpy()
    for rank, res in enumerate(world):
        kind, got = res["part"]
        assert kind == "cpu"
        if rank < 2:
            np.testing.assert_array_equal(got, want)
        else:
            assert "not in the 1 x 2 mesh" in got


def test_make_mesh_too_many_ranks_rejected(world):
    for res in world:
        assert all(e is not None and "devices" in e for e in res["too_many"])


@pytest.mark.parametrize("shape", MESH_SHAPES, ids=SHAPE_IDS)
def test_batch_develop_sharded_matches_single(world, refs, shape):
    sharded = _r(world, shape, "batch_develop")
    np.testing.assert_allclose(sharded, refs["batch_develop"], atol=1e-6, rtol=0)
    for a, b in zip(sharded, refs["batch_develop_jax"]):
        assert_close_across(_hwc(a), _hwc(b))


@pytest.mark.parametrize("shape", MESH_SHAPES, ids=SHAPE_IDS)
def test_export_batch_step(world, inputs, shape):
    u8 = _r(world, shape, "export_u8")
    assert u8.dtype == np.uint8 and u8.shape == (8, 3, 32, 128)
    np.testing.assert_array_equal(
        u8, tdev.encode_u8(torch.from_numpy(_r(world, shape, "batch_develop"))).numpy())


@pytest.mark.parametrize("shape", MESH_SHAPES, ids=SHAPE_IDS)
def test_spatial_develop_sharded_matches_single(world, refs, shape):
    sharded = _r(world, shape, "spatial")
    np.testing.assert_allclose(sharded, refs["spatial"], atol=1e-6, rtol=0)
    assert_close_across(_hwc(sharded), _hwc(refs["spatial_jax"]))


@pytest.mark.parametrize("shape", MESH_SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("key", ["64", "63"])
def test_histogram_sharded_exact(world, refs, shape, key):
    name = "hist" if key == "64" else f"hist_{key}"
    want = refs[f"hist_{key}"]
    for res in world:  # the same on every rank
        np.testing.assert_array_equal(res[shape][name], want)
    np.testing.assert_array_equal(want, refs[f"hist_{key}_jax"])


@pytest.mark.parametrize("shape", MESH_SHAPES, ids=SHAPE_IDS)
def test_full_step_with_distortion(world, refs, shape):
    single, single_hist = refs["full_step_warp"]
    ref, ref_hist = refs["full_step_warp_jax"]
    srgb, hist, clip = _r(world, shape, "full_step_warp")
    np.testing.assert_allclose(srgb, single, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(hist, single_hist)
    assert_close_across(_hwc(srgb), _hwc(ref))
    assert int(hist.sum()) == int(ref_hist.sum()) == 4 * 64 * 128


@pytest.mark.parametrize("shape", MESH_SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("key", ["62", "63"])
def test_full_step_uneven_height(world, inputs, refs, shape, key):
    h = inputs["uneven"][key].shape[1]
    srgb, hist, clip = _r(world, shape, f"full_step_{key}")
    single, want = refs[f"full_step_{key}"]
    assert srgb.shape == (3, h, 128)
    np.testing.assert_allclose(srgb, single, atol=1e-6, rtol=0)
    assert int(hist.sum()) == 4 * h * 128
    assert clip == pytest.approx(want, abs=1e-6)


@pytest.mark.parametrize("shape", MESH_SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("key", ["64x256", "67x256"])
def test_spatial_kernel_sharded_matches_single_kernel(world, refs, shape, key):
    """use_kernel=True: the develop kernel's twin on each slab with its
    global row offset equals the single-slab twin bit for bit, and the
    JAX package's sharded Pallas kernel (interpret mode, 8 'sp' shards)
    within assert_close_across."""
    sharded = _r(world, shape, f"kernel_{key}")
    np.testing.assert_array_equal(sharded, refs[f"kernel_{key}"])
    assert_close_across(_hwc(sharded), _hwc(refs[f"kernel_{key}_jax"]))


@pytest.mark.parametrize("shape", MESH_SHAPES, ids=SHAPE_IDS)
def test_entropy_batch_sharded_bit_exact(world, inputs, refs, shape):
    """The prepacked wire per rank equals the single-device wire bit for
    bit; its file equals the packed wire's and decodes within the batch
    bound of the JAX package's file."""
    lens, words, totals = _r(world, shape, "entropy")
    nblocks = (32 // 16) * (128 // 16) * 6
    assert lens.shape == (8, nblocks) and words.shape == (8, nblocks * 52)
    for i in range(len(inputs["srgb"])):
        s_lens, s_words, s_totals = refs["wire"][i]
        nw = int(s_totals[0])
        assert int(totals[i, 2]) == 0
        np.testing.assert_array_equal(totals[i], s_totals)
        np.testing.assert_array_equal(lens[i], s_lens)
        np.testing.assert_array_equal(words[i], s_words)
        a = native.jpeg_encode_prepacked(lens[i].astype(np.uint16),
                                         words[i][:nw].view(np.uint32), 32, 128,
                                         quality=QUALITY)
        assert a[:2] == b"\xff\xd8" and a[-2:] == b"\xff\xd9"
        _files_agree(a, refs["srgb_files_jax"][i])


@pytest.mark.parametrize("shape", MESH_SHAPES, ids=SHAPE_IDS)
def test_entropy_batch_packed_sharded_bit_exact(world, inputs, refs, shape):
    words, totals = _r(world, shape, "entropy_packed")
    lens_p, words_p, totals_p = _r(world, shape, "entropy")
    for i in range(len(inputs["srgb"])):
        s_words, s_totals = refs["wire_packed"][i]
        nw, nbits, bad = (int(x) for x in totals[i])
        assert bad == 0 and nw == (nbits + 31) // 32
        np.testing.assert_array_equal(totals[i], s_totals)
        np.testing.assert_array_equal(words[i], s_words)
        assert not words[i][nw:].any()
        a = native.jpeg_encode_packed(words[i][:nw].view(np.uint32), nbits, 32, 128,
                                      quality=QUALITY)
        b = native.jpeg_encode_prepacked(
            lens_p[i].astype(np.uint16), words_p[i][:int(totals_p[i, 0])]
            .view(np.uint32), 32, 128, quality=QUALITY)
        assert a == b
        _files_agree(a, refs["srgb_files_jax"][i])


@pytest.mark.parametrize("shape", MESH_SHAPES, ids=SHAPE_IDS)
def test_export_batch_jpeg_steps(world, refs, shape):
    """The composed steps (sharded develop feeding each wire) emit the
    wires of the sharded develop's renders."""
    srgb = _r(world, shape, "batch_develop")
    qlum, qchr = jpegenc._quant_tables(QUALITY)
    words, totals = _r(world, shape, "jpeg_packed_step")
    lens_p, words_p, totals_p = _r(world, shape, "jpeg_step")
    for i in range(8):
        if np.array_equal(srgb[i], refs["batch_develop"][i]):
            s_words, s_totals = refs["develop_wires"][i]
        else:
            s_words, s_totals = _np_all(jpegbits.wire_packed(torch.from_numpy(srgb[i]),
                                                             qlum, qchr))
        np.testing.assert_array_equal(words[i], s_words)
        np.testing.assert_array_equal(totals[i], s_totals)
        nw, nbits, bad = (int(x) for x in totals[i])
        assert bad == 0 and 0 < nw == (nbits + 31) // 32
        assert int(totals_p[i, 2]) == 0 and 0 < int(totals_p[i, 0]) <= words_p.shape[1]
        assert int(lens_p[i].astype(np.int64).sum()) == int(totals_p[i, 1])


@pytest.mark.parametrize("shape", MESH_SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("pattern", ["RGGB", "XTRANS"])
def test_export_batch_raw_fused_packed_matches_single(world, inputs, refs, shape, pattern):
    """One image per rank: the RAW kernel's twin and the packed wire give
    the single-device scan byte for byte (and the JAX package's mesh step
    a file within the batch bound, RGGB)."""
    frames = inputs["mosaics"]["frames"][pattern]
    nb = shape[0]
    words, totals = _r(world, shape, f"raw_{pattern}")
    assert words.shape[0] == totals.shape[0] == nb
    h, w = frames.shape[1:]
    for i in range(nb):
        s_words, s_totals = refs[f"raw_{pattern}"][i]
        np.testing.assert_array_equal(totals[i], s_totals)
        np.testing.assert_array_equal(words[i], s_words)
        nw, nbits, bad = (int(x) for x in totals[i])
        assert bad == 0 and nw > 0 and not words[i][nw:].any()
        if pattern == "RGGB":
            a = native.jpeg_encode_packed(words[i][:nw].view(np.uint32), nbits, h, w,
                                          quality=QUALITY)
            _files_agree(a, refs["raw_files_jax"][i])


def test_export_batch_raw_fused_packed_rejects_two_images(world):
    for res in world:
        for shape in MESH_SHAPES:
            assert "one image per rank" in res[shape]["raw_two_images"]


@pytest.mark.parametrize("shape", MESH_SHAPES, ids=SHAPE_IDS)
def test_export_batch_editor_packed_matches_single(world, inputs, refs, shape):
    """The CLI's mesh step: the anchor render and the packed wire on the
    padded grid (true blocks only) equal the single-device scan, and the
    JAX package's step gives a file within the batch bound."""
    th, tw = inputs["geos"]["true"]
    words, totals = _r(world, shape, "editor_packed")
    for i in range(len(inputs["geos"]["planes"])):
        s_words, s_totals = refs["editor"][i]
        np.testing.assert_array_equal(totals[i], s_totals)
        np.testing.assert_array_equal(words[i], s_words)
        nw, nbits, _ = (int(x) for x in totals[i])
        a = native.jpeg_encode_packed(words[i][:nw].view(np.uint32), nbits, th, tw,
                                      quality=QUALITY)
        _files_agree(a, refs["editor_files_jax"][i])
