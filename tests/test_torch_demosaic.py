"""The port's ops/demosaic against the JAX package's on the CPU: the same
seeded numpy mosaics through both, every function, all four Bayer
patterns, X-Trans (residual and plain normalized convolution) and the
padded-grid true_shape/true_origin mode. Max abs difference <= 1e-5 (f32
arithmetic in the same order; the only slack is XLA's fusion rounding)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rawphotoforge_tpu.ops import demosaic as jdm

from rawphotoforge_tpu_torch.ops import demosaic as tdm

TOL = 1e-5
XYZ_TO_CAM = np.array([[0.8, -0.1, -0.05], [-0.3, 1.1, 0.15],
                       [-0.05, 0.15, 0.65]])
WB = (1.8, 1.0, 1.4)


def _close(ours, ref, tol=TOL):
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    ref = np.asarray(ref)
    assert ours.shape == ref.shape
    assert np.abs(ours.astype(np.float64) - ref).max() <= tol


@pytest.fixture
def mosaic(rng):
    return rng.random((36, 54), dtype=np.float32)


def test_constants_match():
    assert tdm.BAYER_PATTERNS == jdm.BAYER_PATTERNS
    assert np.array_equal(tdm.XTRANS, jdm.XTRANS)
    assert set(tdm.NAMED_CFA) == set(jdm.NAMED_CFA)
    for k in jdm.NAMED_CFA:
        assert np.array_equal(tdm.NAMED_CFA[k], jdm.NAMED_CFA[k])
    assert np.array_equal(tdm.cam_matrix_to_srgb(XYZ_TO_CAM),
                          jdm.cam_matrix_to_srgb(XYZ_TO_CAM))


def test_normalize_mosaic(rng):
    raw = rng.integers(0, 16384, (20, 30)).astype(np.uint16)
    ours = tdm.normalize_mosaic(torch.from_numpy(raw.astype(np.int32)), 512.0,
                                16383.0)
    ref = jdm.normalize_mosaic(jnp.asarray(raw), 512.0, 16383.0)
    _close(ours, ref, 0.0)


@pytest.mark.parametrize("pattern", sorted(jdm.BAYER_PATTERNS))
def test_bayer_demosaics_and_wb(mosaic, pattern):
    m = torch.from_numpy(mosaic)
    _close(tdm.apply_wb_mosaic(m, pattern, WB),
           jdm.apply_wb_mosaic(jnp.asarray(mosaic), pattern, jnp.asarray(WB)), 0.0)
    _close(tdm.demosaic_bilinear(m, pattern),
           jdm.demosaic_bilinear(jnp.asarray(mosaic), pattern))
    _close(tdm.demosaic_malvar(m, pattern),
           jdm.demosaic_malvar(jnp.asarray(mosaic), pattern))


@pytest.mark.parametrize("method", ["residual", "nc"])
@pytest.mark.parametrize("pattern", ["XTRANS", "RGGB"])
def test_demosaic_cfa(mosaic, pattern, method):
    cfa = jdm.NAMED_CFA[pattern]
    _close(tdm.demosaic_cfa(torch.from_numpy(mosaic), cfa, method=method),
           jdm.demosaic_cfa(jnp.asarray(mosaic), cfa, method=method))


@pytest.mark.parametrize("origin", [(0, 0), (5, 4)])
def test_demosaic_cfa_padded_grid(rng, origin):
    """true_shape/true_origin: the true region of a padded grid equals the
    exact-shape develop (pad sites count as absent samples)."""
    mosaic = rng.random((40, 50), dtype=np.float32)
    shape = (30, 41)
    ours = tdm.demosaic_cfa(torch.from_numpy(mosaic), tdm.XTRANS,
                            true_shape=shape, true_origin=origin)
    ref = jdm.demosaic_cfa(jnp.asarray(mosaic), jdm.XTRANS,
                           true_shape=jnp.asarray(shape, jnp.int32),
                           true_origin=jnp.asarray(origin, jnp.int32))
    _close(ours, ref)
    _close(tdm.apply_wb_mosaic(torch.from_numpy(mosaic), "XTRANS", WB,
                               true_origin=origin),
           jdm.apply_wb_mosaic(jnp.asarray(mosaic), "XTRANS", jnp.asarray(WB),
                               true_origin=jnp.asarray(origin, jnp.int32)), 0.0)
    oy, ox = origin
    exact = tdm.demosaic_cfa(
        torch.from_numpy(np.ascontiguousarray(
            mosaic[oy:oy + shape[0], ox:ox + shape[1]])), tdm.XTRANS)
    assert torch.equal(ours[:, oy:oy + shape[0], ox:ox + shape[1]], exact)


@pytest.mark.parametrize("pattern,method", [
    ("RGGB", "malvar"), ("GBRG", "bilinear"), ("XTRANS", "residual"),
    ("XTRANS", "nc"), ("BGGR", "residual")])
def test_develop_raw(mosaic, pattern, method):
    cam = jdm.cam_matrix_to_srgb(XYZ_TO_CAM)
    ours = tdm.develop_raw(torch.from_numpy(mosaic), WB, cam, pattern=pattern,
                           method=method)
    ref = jdm.develop_raw(jnp.asarray(mosaic), jnp.asarray(WB), jnp.asarray(cam),
                          pattern=pattern, method=method)
    _close(ours, ref)
    with pytest.raises(ValueError, match="demosaic method"):
        tdm.develop_raw(torch.from_numpy(mosaic), WB, cam, method="ahd")


def test_linear_raw_and_camera_matrix(rng):
    rgb = rng.random((12, 20, 3), dtype=np.float32)
    cam = jdm.cam_matrix_to_srgb(XYZ_TO_CAM)
    _close(tdm.develop_linear_raw(torch.from_numpy(rgb), WB, cam),
           jdm.develop_linear_raw(jnp.asarray(rgb), jnp.asarray(WB), jnp.asarray(cam)))
    planes = rng.random((3, 12, 20), dtype=np.float32)
    _close(tdm.camera_to_srgb(torch.from_numpy(planes), cam),
           jdm.camera_to_srgb(jnp.asarray(planes), jnp.asarray(cam)))
