"""The port's native host helpers (native/rpf_native.cpp) against the JAX
package's native library, bit for bit, on the inputs of
tests/test_native.py; the PNG row unfilter against its numpy oracle and
through the port's 16-bit PNG decode (io/image_io._parse_png48), which
runs the native unfilter and raises when the library cannot be built."""

import numpy as np
import pytest

from rawphotoforge_tpu import native as jnative
from rawphotoforge_tpu.core import curve as jcurve

from rawphotoforge_tpu_torch import native
from rawphotoforge_tpu_torch.core import curve as tcurve
from rawphotoforge_tpu_torch.io import image_io

import oracle
from torch_fixtures import png48_bytes, png_forward_filter

# Only the tests that call the JAX package's native library need its build;
# the port-only tests run wherever the port's library builds.
needs_jax_native = pytest.mark.skipif(
    not jnative.available(), reason="the JAX package's native library is not built")

PCHIP_CASES = [
    ([0, 65535], [0, 65535]),
    ([0, 65535], [32767, 32767]),
    ([0, 20000, 45000, 65535], [0, 30000, 40000, 65535]),
    ([0, 30000, 65535], [10000, 50000, 20000]),
    ([5000, 60000], [10000, 62000]),
    ([0, 8000, 12000, 65535], [0, 2000, 60000, 65535]),
]


@needs_jax_native
@pytest.mark.parametrize("xs,ys", PCHIP_CASES)
def test_pchip_lut_bit_identical_to_jax_native(xs, ys):
    xs = np.asarray(xs, dtype=np.int32)
    ys = np.asarray(ys, dtype=np.int32)
    got = native.pchip_build_lut(xs, ys)
    np.testing.assert_array_equal(got, jnative.pchip_build_lut(xs, ys))
    # ... and the port's numpy build_lut (which stays numpy).
    np.testing.assert_array_equal(got, tcurve.build_lut(xs, ys))
    lo_hi = native.pchip_build_lut(xs, ys, 1000, 60000, 4096)
    np.testing.assert_array_equal(
        lo_hi, jnative.pchip_build_lut(xs, ys, 1000, 60000, 4096))


@needs_jax_native
def test_pchip_lut_error_is_the_ports_curve_error():
    with pytest.raises(tcurve.CurveError):
        native.pchip_build_lut(np.array([0, 0, 10], np.int32),
                               np.array([0, 1, 2], np.int32))
    with pytest.raises(jcurve.CurveError):
        jnative.pchip_build_lut(np.array([0, 0, 10], np.int32),
                                np.array([0, 1, 2], np.int32))
    with pytest.raises(ValueError):
        native.pchip_build_lut(np.array([0], np.int32), np.array([0], np.int32))


@needs_jax_native
@pytest.mark.parametrize("src_hw,dst_hw", [((10, 20), (4, 7)), ((9, 13), (23, 31)),
                                           ((1, 1), (3, 2))])
def test_resize_bilinear_bit_identical_to_jax_native(rng, src_hw, dst_hw):
    src = rng.random((*src_hw, 3)).astype(np.float32)
    got = native.resize_bilinear(src, *dst_hw)
    assert got.shape == (*dst_hw, 3)
    np.testing.assert_array_equal(got, jnative.resize_bilinear(src, *dst_hw))
    with pytest.raises(ValueError):
        native.resize_bilinear(src, 0, 4)


@needs_jax_native
def test_srgb_conversions_bit_identical_to_jax_native(rng):
    u8 = np.arange(256, dtype=np.uint8)
    lin = native.srgb_u8_to_linear(u8)
    np.testing.assert_array_equal(lin, jnative.srgb_u8_to_linear(u8))
    np.testing.assert_allclose(
        lin, oracle.srgb_to_linear(u8.astype(np.float32) / 255.0), atol=1e-6)
    f = np.concatenate([lin, rng.uniform(-0.5, 2.0, 4096).astype(np.float32),
                        np.array([np.nan, np.inf, -np.inf], np.float32)])
    np.testing.assert_array_equal(native.linear_to_srgb_u8(f),
                                  jnative.linear_to_srgb_u8(f))
    back = native.linear_to_srgb_u8(lin)
    assert np.abs(back.astype(int) - u8.astype(int)).max() <= 1
    np.testing.assert_array_equal(
        native.linear_to_srgb_u8(np.array([-0.5, 2.0], np.float32)), [0, 255])


@needs_jax_native
def test_histogram_bit_identical_to_jax_native(rng):
    hwc = rng.random((37, 53, 3)).astype(np.float32)
    hwc[0, :4, 0] = (np.nan, -1.0, 2.0, 0.5)
    got = native.histogram_rgbl(hwc)
    assert got.shape == (4, 256) and got.dtype == np.int32
    np.testing.assert_array_equal(got, jnative.histogram_rgbl(hwc))
    np.testing.assert_array_equal(got.sum(axis=1), [37 * 53] * 4)
    for c in range(3):
        idx = np.clip(np.nan_to_num(hwc[..., c] * 255, nan=0.0), 0, 255)
        np.testing.assert_array_equal(
            got[c], np.bincount(idx.astype(np.int32).ravel(), minlength=256))


@needs_jax_native
def test_binarize_mask_bit_identical_to_jax_native(rng):
    v = rng.standard_normal(1000).astype(np.float32).reshape(20, 50)
    got = native.binarize_mask(v, 0.3)
    np.testing.assert_array_equal(got, (v >= 0.3).astype(np.float32))
    np.testing.assert_array_equal(got, jnative.binarize_mask(v, 0.3))


def test_available_after_a_build_and_false_after_a_failed_one(monkeypatch):
    assert native.available()

    def broken():
        raise native.NativeBuildError("no compiler")

    monkeypatch.setattr(native, "library", broken)
    assert not native.available()


def test_decode_scan_rejects_out_of_range_mcus():
    """tests/test_native.py:108 on the port's library: the MCU window is
    checked in C++."""
    from rawphotoforge_tpu_torch.io import ljpeg

    rng = np.random.default_rng(0)
    samples = rng.integers(0, 4096, size=(8, 8, 1)).astype(np.uint16)
    frame = ljpeg.parse(ljpeg.encode(samples, precision=12))
    out = np.zeros((frame.rows, frame.width), dtype=np.uint16)
    luts = [ljpeg._build_huffman_lut(frame.counts[t], frame.values[t],
                                     int(frame.nvalues[t]))
            for t in range(frame.counts.shape[0])]
    sym = np.concatenate([s for s, _ in luts])
    ln = np.concatenate([n for _, n in luts])
    for start, count in ((0, frame.rows * frame.mcus_per_row + 1), (-1, 4)):
        with pytest.raises(ljpeg.LJpegError):
            native.ljpeg_decode_scan(frame.scan, out, frame, start, count, sym, ln)


def test_jpeg_encoder_rejects_oversize_dimensions():
    """tests/test_native.py:130 on the port's library."""
    import ctypes

    y = np.zeros((1, 8), dtype=np.uint8)
    cb = cr = np.zeros((1, 4), dtype=np.uint8)
    out = np.empty(1 << 16, dtype=np.uint8)
    out_len = ctypes.c_int64(0)
    rc = native.library().rpf_jpeg_encode_ycc420(
        y, cb, cr, 70000, 8, 92, out, out.size, ctypes.byref(out_len))
    assert rc != 0


# -- the PNG row unfilter ---------------------------------------------------------

def _filtered(rng, h, stride, bpp, ftypes):
    rows = rng.integers(0, 256, size=(h, stride), dtype=np.uint8)
    grid = np.frombuffer(png_forward_filter(rows, ftypes, bpp),
                         np.uint8).reshape(h, 1 + stride)
    return rows, grid


@needs_jax_native
@pytest.mark.parametrize("bpp", [2, 4, 6, 8])
def test_png_unfilter_matches_oracle_and_jax_native(rng, bpp):
    h, stride = 23, bpp * 11
    ftypes = np.array([0, 1, 2, 3, 4] * 4 + [4, 3, 1], np.uint8)
    rows, grid = _filtered(rng, h, stride, bpp, ftypes)
    filt = np.ascontiguousarray(grid[:, 0])
    ours = grid[:, 1:].copy()
    assert native.png_unfilter(ours, filt, bpp) is ours   # in place
    np.testing.assert_array_equal(ours, rows)
    np.testing.assert_array_equal(
        image_io._png_unfilter(np.ascontiguousarray(grid[:, 1:]), filt, bpp), rows)
    np.testing.assert_array_equal(
        jnative.png_unfilter(grid[:, 1:].copy(), filt, bpp), rows)


@pytest.mark.parametrize("f", [0, 1, 2, 3, 4])
def test_png_unfilter_each_filter_alone(rng, f):
    rows, grid = _filtered(rng, 9, 6 * 5, 6, [f] * 9)
    ours = grid[:, 1:].copy()
    native.png_unfilter(ours, grid[:, 0].copy(), 6)
    np.testing.assert_array_equal(ours, rows)


def test_png_unfilter_bad_filter_and_bad_arguments():
    rows = np.zeros((3, 12), np.uint8)
    with pytest.raises(image_io.ImageIOError, match="filter type 5"):
        native.png_unfilter(rows, np.array([0, 5, 0], np.uint8), 6)
    with pytest.raises(ValueError, match="writable"):
        native.png_unfilter(np.frombuffer(bytes(36), np.uint8).reshape(3, 12),
                            np.zeros(3, np.uint8), 6)
    with pytest.raises(ValueError, match="filters"):
        native.png_unfilter(rows, np.zeros(2, np.uint8), 6)
    with pytest.raises(image_io.ImageIOError):
        native.png_unfilter(rows, np.zeros(3, np.uint8), 13)  # bpp > stride


def test_png48_all_filter_types_decode(rng):
    """tests/test_io.py:485 on the port: every filter type (0-4, mixed per
    row) inverts through _parse_png48, equal to the JAX decode."""
    from rawphotoforge_tpu.io.image_io import _parse_png48 as jparse

    from test_io import _png48_wrap, _png_forward_filter

    h, w = 10, 7
    u16 = rng.integers(0, 65536, size=(h, w, 3)).astype(np.uint16)
    rows = np.frombuffer(u16.astype(">u2").tobytes(), np.uint8).reshape(h, w * 6)
    ftypes = [0, 1, 2, 3, 4, 4, 3, 2, 1, 0]
    raw = _png_forward_filter(rows, ftypes)
    assert png_forward_filter(rows, ftypes, 6) == raw  # the vectorised filter
    data = _png48_wrap(w, h, raw)
    got = image_io._parse_png48(data)
    np.testing.assert_array_equal(got, u16)
    np.testing.assert_array_equal(got, jparse(data))


@pytest.mark.parametrize("ch", [1, 2, 3, 4])
def test_png48_adam7_mixed_filters_decode(rng, ch):
    """Adam7-interlaced 16-bit PNGs with mixed filters in every pass go
    through the same native unfilter, equal to the source and to JAX."""
    from rawphotoforge_tpu.io.image_io import _parse_png48 as jparse

    u16 = rng.integers(0, 65536, size=(13, 11, ch)).astype(np.uint16)
    data = png48_bytes(u16, lambda n: np.arange(n) % 5, interlace=True)
    got = image_io._parse_png48(data)
    want = {1: np.repeat(u16, 3, 2), 2: np.repeat(u16[..., :1], 3, 2),
            3: u16, 4: u16[..., :3]}[ch]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jparse(data))


def test_parse_png48_runs_the_native_unfilter(rng, monkeypatch):
    """The decode never calls the numpy oracle: with it made to raise, a
    mixed-filter PNG (plain and interlaced) still decodes."""
    def oracle_called(*_a, **_k):
        raise AssertionError("the numpy unfilter ran on the open path")

    monkeypatch.setattr(image_io, "_png_unfilter", oracle_called)
    calls = []
    real = native.png_unfilter
    monkeypatch.setattr(native, "png_unfilter",
                        lambda *a: calls.append(a[2]) or real(*a))
    u16 = rng.integers(0, 65536, size=(16, 9, 3)).astype(np.uint16)
    for interlace in (False, True):
        data = png48_bytes(u16, lambda n: (np.arange(n) * 3) % 5, interlace)
        np.testing.assert_array_equal(image_io._parse_png48(data), u16)
    assert calls == [6] + [6] * 7


def test_png_open_raises_when_the_library_cannot_be_built(rng, monkeypatch):
    u16 = rng.integers(0, 65536, size=(8, 8, 3)).astype(np.uint16)
    data = png48_bytes(u16, lambda n: np.full(n, 4))

    def broken():
        raise native.NativeBuildError("building rpf_native.cpp failed")

    monkeypatch.setattr(native, "library", broken)
    with pytest.raises(native.NativeBuildError):
        image_io._parse_png48(data)
    with pytest.raises(native.NativeBuildError):
        image_io.decode_image_host(data, "PNG")


def test_png48_bad_filter_byte_is_a_typed_error():
    rows = np.zeros((4, 31), np.uint8)
    rows[2, 0] = 9
    from test_io import _png48_wrap

    with pytest.raises(image_io.ImageIOError, match="filter type 9"):
        image_io._parse_png48(_png48_wrap(5, 4, rows.tobytes()))
