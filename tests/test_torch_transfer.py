"""The port's utils/transfer on the CPU: the integer planners give the JAX
package's values; put_np / fetch_np / fetch_np_prefix / fetch_banded /
start_banded move the bytes exactly (on a CPU tensor the staging is a plain
copy; the pinned path on the card is tests/test_torch_cuda.py's); the
uploads of the RAW mosaic and of integer images go through put_np."""

import numpy as np
import pytest
import torch

from rawphotoforge_tpu.utils import transfer as jtransfer

from rawphotoforge_tpu_torch.errors import PhotoEditorError
from rawphotoforge_tpu_torch.utils import transfer


@pytest.mark.parametrize("itemsize", [1, 2, 4])
@pytest.mark.parametrize("band_bytes", [1 << 20, 8 << 20])
def test_prefix_fetch_elems_equals_jax(itemsize, band_bytes):
    for size in (0, 1, 1000, 3_000_000, 40_000_000):
        for n in (-3, 0, 1, 999, 16_384, 65_536, 300_000, 2_000_001, size, size + 7):
            assert (transfer.prefix_fetch_elems(n, size, itemsize, band_bytes)
                    == jtransfer.prefix_fetch_elems(n, size, itemsize, band_bytes)), (n, size)


@pytest.mark.parametrize("itemsize", [1, 2, 4])
@pytest.mark.parametrize("band_bytes", [1 << 20, 4 << 20])
def test_banded_planners_equal_jax(itemsize, band_bytes):
    for size in (0, 5, 70_000, 1_000_000, 29_000_000):
        bounds = transfer.banded_bounds(size, itemsize, band_bytes)
        assert bounds == jtransfer.banded_bounds(size, itemsize, band_bytes)
        for n in (-1, 0, 1, 17_000, size // 2, size, size + 1):
            assert (transfer.banded_fetch_elems(n, bounds)
                    == jtransfer.banded_fetch_elems(n, bounds)), (size, n)


@pytest.mark.parametrize("shape,dtype", [
    ((3, 37, 53), np.float32), ((257, 31), np.int16), ((1001,), np.uint8),
    ((2, 2), np.int32)])
@pytest.mark.parametrize("bands", [None, 2, 3, 64])
def test_put_and_fetch_round_trip(shape, dtype, bands):
    rng = np.random.default_rng(7)
    host = (rng.random(shape) * 200).astype(dtype)
    t = transfer.put_np(host, bands=bands, device="cpu")
    assert t.dtype == torch.from_numpy(host).dtype and tuple(t.shape) == shape
    np.testing.assert_array_equal(t.numpy(), host)
    back = transfer.fetch_np(t, bands=bands)
    np.testing.assert_array_equal(back, host)
    assert back.dtype == host.dtype


def test_put_np_copies_views_and_passes_tensors():
    view = np.arange(60, dtype=np.float32).reshape(5, 12).T
    got = transfer.put_np(view, bands=3, device="cpu")
    np.testing.assert_array_equal(got.numpy(), view)
    host = np.arange(6, dtype=np.float32)
    got = transfer.put_np(host, device="cpu")
    host[0] = 99.0  # the upload is a copy
    assert float(got[0]) == 0.0
    t = torch.ones(3)
    assert transfer.put_np(t) is t
    np.testing.assert_array_equal(transfer.fetch_np(np.arange(4)), np.arange(4))


def test_put_np_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(PhotoEditorError, match="no CUDA device"):
        transfer.put_np(np.zeros(4, np.float32))


def test_fetch_np_prefix():
    """tests/test_transfer.py's prefix cases on a CPU tensor."""
    n_total = 5_000_000
    host = np.arange(n_total, dtype=np.int16)
    t = torch.from_numpy(host)
    small_band = 1 << 20
    for n in (0, 1, 1000, small_band // 2 - 1, small_band // 2, small_band,
              small_band + 7, n_total, n_total + 99):
        got = transfer.fetch_np_prefix(t, n, band_bytes=small_band)
        np.testing.assert_array_equal(got, host[:min(n, n_total)])
    np.testing.assert_array_equal(transfer.fetch_np_prefix(host, 17), host[:17])
    np.testing.assert_array_equal(
        transfer.fetch_np_prefix(torch.from_numpy(host[:64].reshape(8, 8)), 10), host[:10])
    empty = transfer.fetch_np_prefix(torch.zeros(0, dtype=torch.int16), 5)
    assert empty.shape == (0,) and empty.dtype == np.int16


def test_fetch_banded_and_start_banded():
    size = 300_000
    host = np.arange(size, dtype=np.int32)
    bounds = transfer.banded_bounds(size, 4, band_bytes=256 << 10)
    bands = [torch.from_numpy(host[a:b].copy()) for a, b in zip(bounds[:-1], bounds[1:])]
    for n in (0, 1, 16_384, 16_385, 100_000, size, size + 5):
        transfer.start_banded(bands, bounds, n)
        np.testing.assert_array_equal(transfer.fetch_banded(bands, bounds, n),
                                      host[:min(n, size)])
    with pytest.raises(ValueError, match="bands"):
        transfer.fetch_banded(bands[:-1], bounds, 10)


def test_mosaic_and_image_uploads_go_through_put_np(monkeypatch):
    """The u16 mosaic crosses as its i16 bit pattern and widens on the
    device; integer image planes cross at their width."""
    from rawphotoforge_tpu_torch.io import image_io, raw

    seen = []
    real = transfer.put_np

    def spy(arr, *a, **kw):
        seen.append(arr.dtype)
        return real(arr, *a, **kw)

    monkeypatch.setattr(transfer, "put_np", spy)
    m = np.array([[0, 1, 40000], [65535, 32768, 7]], dtype=np.uint16)
    got = raw.upload_mosaic(m, "cpu")
    np.testing.assert_array_equal(got.numpy(), m.astype(np.int32))
    assert seen == [np.int16]
    chw = np.array([[[0, 65535], [40000, 3]]], dtype=np.uint16)
    got = image_io._upload(chw, 65535.0, False, torch.device("cpu"))
    np.testing.assert_allclose(got.numpy(), chw / 65535.0, rtol=1e-7)
    assert seen == [np.int16, np.int16]
