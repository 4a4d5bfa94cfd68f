"""The port's parallel/spatial on four CPU ranks (torch.distributed, gloo):
the halo exchange, the row-sharded demosaic, the multi-hop warp and the
sharded RAW front end, in the meshes (2, 2), (1, 4) and (4, 1), against the
port's single-device functions (bit for bit: the same torch code runs on
each slab) and the JAX package's (tests/test_sharding.py's tolerances:
1e-5 for the demosaic and the RAW front end, 5e-5 for the warp at 64 rows,
h * 3e-6 for an uneven height). Also ``ops/geometry.max_row_displacement``
against the JAX function.

One world of four ranks runs every case (tests/torch_dist.spatial_case)
once for the module."""

import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rawphotoforge_tpu.ops import develop as jdev
from rawphotoforge_tpu.ops.geometry import max_row_displacement as jmax_disp
from rawphotoforge_tpu.parallel import mesh as jmesh, spatial as jspatial

from rawphotoforge_tpu_torch.ops import demosaic as dm
from rawphotoforge_tpu_torch.ops.develop import geometry_stage
from rawphotoforge_tpu_torch.ops.geometry import max_row_displacement
from rawphotoforge_tpu_torch.ops.sharpen import unsharp_mask
from rawphotoforge_tpu_torch.parallel import spatial

from conftest import random_linear_image
from torch_dist import spatial_case, start_world, warm_port_cpu

XYZ_TO_CAM = np.array([[0.8, -0.1, -0.05], [-0.3, 1.1, 0.15],
                       [-0.05, 0.15, 0.65]])
STRENGTHS = {"22": (-100, -60, 0, 35, 100), "14": (-100, 80)}


def _planes(rng, h, w):
    return random_linear_image(rng, h, w).transpose(2, 0, 1).copy()


@pytest.fixture(scope="module")
def inputs():
    warm_port_cpu()
    rng = np.random.default_rng(1234)
    padded = np.pad(_planes(rng, 60, 120), [(0, 0), (0, 4), (0, 8)], mode="edge")
    return dict(
        exchange=np.arange(16 * 5, dtype=np.float32).reshape(16, 5),
        demosaic=rng.random((64, 128), dtype=np.float32),
        bilinear=rng.random((32, 128), dtype=np.float32),
        warp=dict(img={"22": _planes(rng, 64, 128), "14": _planes(rng, 64, 96)},
                  strengths=STRENGTHS),
        uneven=dict(img=_planes(rng, 71, 128), d=-60.0),
        extent=dict(img=padded, d=-55.0, true=(60.0, 120.0)),
        raw=dict(mosaic=rng.random((64, 128), dtype=np.float32), wb=(1.8, 1.0, 1.4),
                 cam=dm.cam_matrix_to_srgb(XYZ_TO_CAM), sharpen=0.7),
        rejects={"30": np.zeros((30, 128), np.float32),
                 "4": np.zeros((4, 128), np.float32),
                 "34": np.zeros((34, 48), np.float32)},
        odd=rng.random((33, 48), dtype=np.float32))


@pytest.fixture(scope="module", autouse=True)
def ranks(inputs, tmp_path_factory):
    """spatial_case on four gloo ranks, started before the module's first
    test: they run while this process computes its references."""
    return start_world(spatial_case, 4, tmp_path_factory.mktemp("spatial_world"),
                       **inputs)


@pytest.fixture(scope="module")
def world(ranks):
    return ranks.results()


@pytest.fixture(scope="module")
def jax_mesh():
    return jmesh.make_mesh(n_batch=4, n_spatial=2)


def test_exchange_rows_reflects_at_the_edges(world, inputs):
    """Each of four 'sp' ranks gets its neighbours' HALO rows; the first
    and last reflect their own boundary like np.pad(..., 'reflect')."""
    want = np.pad(inputs["exchange"], [(spatial.HALO, spatial.HALO), (0, 0)],
                  mode="reflect")
    for rank, res in enumerate(world):
        np.testing.assert_array_equal(res["exchange"], want[rank * 4:rank * 4 + 8])


@pytest.mark.parametrize("key", ["22", "14"])
def test_demosaic_sharded_matches_single(world, inputs, jax_mesh, key):
    mosaic = inputs["demosaic"]
    single = dm.demosaic_malvar(torch.from_numpy(mosaic), "RGGB").numpy()
    np.testing.assert_array_equal(world[0][f"demosaic_{key}"], single)
    ref = jax.jit(jspatial.demosaic_sharded, static_argnums=(1, 2, 3))(
        jnp.asarray(mosaic), jax_mesh, "RGGB", "malvar")
    np.testing.assert_allclose(single, np.asarray(ref), atol=1e-5, rtol=0)


def test_demosaic_sharded_bilinear_and_pattern(world, inputs, jax_mesh):
    mosaic = inputs["bilinear"]
    single = dm.demosaic_bilinear(torch.from_numpy(mosaic), "GRBG").numpy()
    np.testing.assert_array_equal(world[0]["bilinear"], single)
    ref = jax.jit(jspatial.demosaic_sharded, static_argnums=(1, 2, 3))(
        jnp.asarray(mosaic), jax_mesh, "GRBG", "bilinear")
    np.testing.assert_allclose(single, np.asarray(ref), atol=1e-5, rtol=0)


@pytest.mark.parametrize("key", ["30", "4", "34"])
def test_demosaic_sharded_rejects(world, key):
    """Heights that do not split into even shards, and shards no taller
    than the halo, raise with the JAX package's messages on every rank."""
    want = "halo" if key == "4" else "divisible by 2 \\* sp axis size"
    for res in world:
        assert res["rejects"][key] is not None
        assert re.search(want, res["rejects"][key])


def test_demosaic_sharded_odd_height_single_shard(world, inputs):
    """One 'sp' rank takes an odd height, like the unsharded demosaic."""
    want = dm.demosaic_malvar(torch.from_numpy(inputs["odd"]), "RGGB").numpy()
    for res in world:
        np.testing.assert_array_equal(res["odd_single_shard"], want)


@pytest.mark.parametrize("key,d", [(k, d) for k, ds in STRENGTHS.items() for d in ds])
def test_distortion_sharded_matches_single(world, inputs, key, d):
    """(2, 2): one hop; (1, 4): 64x96 over four 16-row slabs needs a
    24-row halo, two hops with the outer one trimmed. The rows equal the
    single-device warp's bit for bit, and the JAX warp within 5e-5."""
    img = inputs["warp"]["img"][key]
    single = geometry_stage(torch.from_numpy(img), float(d)).numpy()
    np.testing.assert_array_equal(world[0][f"warp_{key}_{d}"], single)
    ref = jdev.geometry_stage(jnp.asarray(img), jnp.float32(d))
    np.testing.assert_allclose(single, np.asarray(ref), atol=5e-5, rtol=0)
    if d == 0:
        assert all(res["warp_22_0_identity"] for res in world)


def test_distortion_halo_spans_two_hops():
    h_local = 64 // 4
    halo = max_row_displacement(64, 96, 100.0)
    assert h_local < halo < 2 * h_local


@pytest.mark.parametrize("name", ["warp_uneven", "warp_uneven_14"])
def test_distortion_sharded_uneven_height(world, inputs, name):
    img = inputs["uneven"]["img"]
    h = img.shape[1]
    single = geometry_stage(torch.from_numpy(img), inputs["uneven"]["d"]).numpy()
    got = world[0][name]
    assert got.shape == (3, h, 128)
    np.testing.assert_array_equal(got, single)
    ref = jdev.geometry_stage(jnp.asarray(img), jnp.float32(inputs["uneven"]["d"]))
    np.testing.assert_allclose(single, np.asarray(ref), atol=h * 3e-6, rtol=0)


def test_distortion_sharded_respects_extent(world, inputs):
    """A bucket-padded buffer warps by its true extent, as the
    single-device warp does."""
    case = inputs["extent"]
    th, tw = (int(v) for v in case["true"])
    single = geometry_stage(torch.from_numpy(case["img"]), case["d"],
                            case["true"]).numpy()
    np.testing.assert_array_equal(world[0]["warp_extent"], single)
    ref = np.asarray(jdev.geometry_stage_jit(
        jnp.asarray(case["img"]), jnp.float32(case["d"]),
        jnp.asarray(case["true"], jnp.float32)))
    a, b = single[:, :th, :tw], ref[:, :th, :tw]
    assert np.isclose(a, b, atol=2e-4).mean() > 0.999
    np.testing.assert_allclose(np.sort(a.ravel()), np.sort(b.ravel()), atol=2e-3)


@pytest.mark.parametrize("key", ["sharp", "plain"])
def test_raw_develop_sharded_matches_single(world, inputs, jax_mesh, key):
    raw = inputs["raw"]
    mosaic = torch.from_numpy(raw["mosaic"])
    single = torch.clamp(dm.camera_to_srgb(dm.demosaic_malvar(
        dm.apply_wb_mosaic(mosaic, "RGGB", raw["wb"]), "RGGB"), raw["cam"]), 0, 1)
    amount = raw["sharpen"] if key == "sharp" else None
    if amount is not None:
        single = unsharp_mask(single, amount)
    np.testing.assert_array_equal(world[0][f"raw_{key}"], single.numpy())
    ref = jax.jit(jspatial.raw_develop_sharded, static_argnums=(3, 4))(
        jnp.asarray(raw["mosaic"]), jnp.asarray(raw["wb"]), jnp.asarray(raw["cam"]),
        jax_mesh, "RGGB", None if amount is None else jnp.float32(amount))
    np.testing.assert_allclose(single.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


@pytest.mark.parametrize("bound", [100.0, 60.0, 10.0])
def test_max_row_displacement_equals_jax(bound):
    for h, w in ((64, 96), (96, 64), (128, 128), (4000, 6000), (61, 97), (10, 200),
                 (8, 1000), (3, 5)):
        assert max_row_displacement(h, w, bound) == jmax_disp(h, w, bound), (h, w)
