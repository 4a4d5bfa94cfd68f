"""The port's coefficient model and nibble wire (io/jpegenc) against the JAX
package's io/jpegenc, on the CPU: the constants and quantization tables,
``blockify`` against ``_block_stages().blockify`` (with and without a true
extent) and against the float64 oracle within the JAX tests' bound, the DC
deltas and the nibble compaction against the numpy oracles, files equal to
the JAX package's where the coefficients agree, and the routing of
encode_jpeg and image_io.encode_image — the cases of tests/test_jpegenc.py.

Where the two packages' f32 fDCTs differ (XLA's dot against the port's
sequential sums), a coefficient that straddles a quantization boundary
lands one step apart: STRADDLE_FRAC bounds how many (on these inputs at
most 0.09 % of the coefficients, each one step)."""

import io

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from rawphotoforge_tpu.io import jpegenc as jjpeg

from rawphotoforge_tpu_torch import native
from rawphotoforge_tpu_torch.io import image_io, jpegbits as tbits, jpegenc as tjpeg
from rawphotoforge_tpu_torch.kernels import jpeg_wire

STRADDLE_FRAC = 0.005   # as tests/test_jpegenc.py:219 bounds f32 vs f64


def _noise(h, w, seed):
    return np.random.default_rng(seed).random((3, h, w)).astype(np.float32)


def _decode(data):
    return np.array(Image.open(io.BytesIO(data)).convert("RGB"))


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 99.0 if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def _jax_blockify(planes, quality, true_hw=None):
    qlum, qchr = jjpeg._quant_tables(quality)
    return np.asarray(jjpeg._block_stages().blockify(
        jnp.asarray(planes), jnp.asarray(qlum), jnp.asarray(qchr), true_hw))


def _port_blockify(planes, quality, true_hw=None):
    return tjpeg.blockify(torch.from_numpy(planes), *tjpeg._quant_tables(quality),
                          true_hw).numpy().astype(np.int32)


def _straddles(a, b):
    """Differing coefficients: each one step, few in all."""
    diff = a != b
    assert np.abs(a - b)[diff].max(initial=0) <= 1
    assert diff.mean() < STRADDLE_FRAC, diff.mean()
    return int(diff.sum())


@pytest.mark.parametrize("quality", [1, 40, 50, 92, 100])
def test_constants_and_tables_match_jax(quality):
    for name in ("_YCC", "_QLUM", "_QCHR", "_ZIGZAG"):
        np.testing.assert_array_equal(getattr(tjpeg, name), getattr(jjpeg, name))
    np.testing.assert_array_equal(tjpeg._dct8(np.float32), jjpeg._dct8(np.float32))
    for ours, ref in zip(tjpeg._quant_tables(quality), jjpeg._quant_tables(quality)):
        np.testing.assert_array_equal(ours, ref)
    assert tjpeg.SPARSE_MIN_PIXELS == jjpeg.SPARSE_MIN_PIXELS


@pytest.mark.parametrize("h,w", [(37, 50), (61, 97), (48, 64), (16, 16), (15, 17),
                                 (40, 8256)])
def test_blockify_matches_jax(h, w):
    planes = _noise(h, w, h * 7 + w)
    _straddles(_port_blockify(planes, 92), _jax_blockify(planes, 92))


@pytest.mark.parametrize("h,w,ph,pw", [(100, 72, 128, 128), (37, 50, 48, 64),
                                       (40, 56, 48, 64), (1, 1, 17, 33),
                                       (9, 4097, 16, 4099), (30, 200, 64, 256)])
def test_blockify_true_extent_matches_jax_and_a_direct_encode(h, w, ph, pw):
    """A padded render with noise in the padding: the luma-level fill
    before the subsample and the chroma-level fill after it give the blocks
    of a direct encode of the true extent (bit for bit, within the port),
    and the JAX package's within straddles."""
    planes = _noise(ph, pw, h + w)
    ours = _port_blockify(planes, 90, (h, w))
    _straddles(ours, _jax_blockify(planes, 90, (h, w)))
    direct = _port_blockify(np.ascontiguousarray(planes[:, :h, :w]), 90)
    mask = tbits._true_mask(ours.shape[0], -(-pw // 16), -(-h // 16), -(-w // 16)).numpy()
    np.testing.assert_array_equal(ours[mask], direct)


def test_blockify_tracks_f64_oracle():
    planes = _noise(48, 64, 7)
    _straddles(_port_blockify(planes, 92), tjpeg._blocks_np(planes, 92))


def test_blocks_wrapper_is_the_twin_on_the_cpu():
    planes = torch.from_numpy(_noise(37, 50, 2))
    before = dict(jpeg_wire.KERNEL_LAUNCHES)
    out = jpeg_wire.blocks(planes, *tjpeg._quant_tables(92))
    assert jpeg_wire.KERNEL_LAUNCHES == before
    assert out.dtype == torch.int16 and tuple(out.shape) == (6 * 3 * 4, 64)
    assert torch.equal(out, tjpeg.blockify(planes, *tjpeg._quant_tables(92)))
    with pytest.raises(ValueError, match="true extent"):
        jpeg_wire.blocks(planes, *tjpeg._quant_tables(92), (38, 50))


def test_numpy_oracles_match_jax():
    planes = _noise(40, 56, 3)
    np.testing.assert_array_equal(tjpeg._blocks_np(planes, 92), jjpeg._blocks_np(planes, 92))
    blocks = jjpeg._blocks_np(planes, 92)
    np.testing.assert_array_equal(tjpeg._dc_delta_np(blocks), jjpeg._dc_delta_np(blocks))
    for ours, ref in zip(tjpeg._sparsify_np(blocks), jjpeg._sparsify_np(blocks)):
        np.testing.assert_array_equal(ours, ref)
    bm = tjpeg._sparsify_np(blocks)[1]
    np.testing.assert_array_equal(tjpeg._popcount_rows(bm), jjpeg._popcount_rows(bm))
    for ours, ref in zip(tjpeg._to_ycc420_np(planes), jjpeg._to_ycc420_np(planes)):
        np.testing.assert_array_equal(ours, ref)


def _synth_blocks(nblocks, seed=0):
    """All-zero blocks, a lone last-lane coefficient (ZRL chains), dense
    blocks, magnitudes up to the baseline size limits (tests/
    test_jpegenc.py's _synth_blocks)."""
    rng = np.random.default_rng(seed)
    blocks = np.zeros((nblocks, 64), dtype=np.int32)
    for i in range(nblocks):
        kind = i % 5
        if kind == 0:
            continue
        if kind == 1:
            blocks[i, 63] = int(rng.integers(1, 100))
            blocks[i, 0] = int(rng.integers(-1016, 1017))
            continue
        n = int(rng.integers(1, 64))
        pos = rng.choice(64, size=n, replace=False)
        blocks[i, pos] = rng.integers(-1023, 1024, size=n)
        blocks[i, 0] = int(rng.integers(-1016, 1017))
    return blocks


def test_dc_delta_matches_np_and_jax():
    blocks = _synth_blocks(60, seed=2)
    ours = tjpeg.dc_delta(torch.from_numpy(blocks)).numpy()
    np.testing.assert_array_equal(ours, tjpeg._dc_delta_np(blocks))
    np.testing.assert_array_equal(
        ours, np.asarray(jjpeg._block_stages().dc_delta(jnp.asarray(blocks))))


@pytest.mark.parametrize("seed", [1, 3])
def test_sparsify_equals_np_oracle(seed):
    blocks = _synth_blocks(60, seed=seed)
    counts, bitmaps, packed, esc, nv, ne = tjpeg._sparsify(torch.from_numpy(blocks))
    ref = tjpeg._sparsify_np(blocks)
    np.testing.assert_array_equal(counts.numpy(), ref[0])
    np.testing.assert_array_equal(bitmaps.numpy().astype(np.uint32), ref[1])
    np.testing.assert_array_equal(packed.numpy(), ref[2])
    np.testing.assert_array_equal(esc.numpy(), ref[3])
    assert (nv, ne) == (ref[4], ref[5])


def test_nibble_wire_boundaries():
    """+-7 ride the nibbles, -8 and +-8 escape, an odd count leaves a zero
    high nibble; the native coder takes the stream."""
    blocks = np.zeros((6, 64), dtype=np.int32)
    blocks[0, [0, 1, 2, 3, 4]] = [7, -7, 8, -8, 1]
    counts, bitmaps, packed, esc, nv, ne = tjpeg._sparsify(torch.from_numpy(blocks))
    assert (nv, ne) == (5, 2) and esc.tolist() == [8, -8]
    assert packed.tolist() == [7 | ((-7 & 15) << 4), 8 | (8 << 4), 1]
    data = native.jpeg_encode_sparse(counts.numpy(), bitmaps.numpy().astype(np.uint32),
                                     packed.numpy(), esc.numpy(), 16, 16, quality=92)
    assert data.startswith(b"\xff\xd8") and data.endswith(b"\xff\xd9")


def test_packed_file_equals_jax_on_blockwise_constant_gray():
    """Gray 16x16-constant tiles make every fDCT exact, so the port's packed
    wire, the JAX package's encode_jpeg (its packed wire) and the dense
    native encoder give the same bytes."""
    rng = np.random.default_rng(5)
    tiles = rng.choice(np.arange(0, 256, 16), size=(3, 4))
    gray = np.kron(tiles, np.ones((16, 16))).astype(np.float32) / 255.0
    planes = np.stack([gray, gray, gray])
    ours = tjpeg.encode_jpeg(torch.from_numpy(planes), quality=92)
    assert ours == jjpeg.encode_jpeg(jnp.asarray(planes), quality=92)
    assert ours == jjpeg.encode_jpeg(planes, quality=92)     # the dense host path


@pytest.mark.parametrize("h,w", [(48, 64), (37, 50), (61, 97), (100, 72)])
def test_packed_file_equals_jax_where_the_blocks_agree(h, w):
    """On random planes the file is the JAX package's byte for byte when no
    coefficient straddles; otherwise the decoded images agree within one
    quantization step's reach: an AC basis function peaks at 1/4, the
    largest step at quality 90 is 20, and the colour matrix scales Cb by
    1.772 into blue — 9 levels."""
    planes = _noise(h, w, 90 + h)
    ours = tjpeg.encode_jpeg(torch.from_numpy(planes), quality=90)
    ref = jjpeg.encode_jpeg(jnp.asarray(planes), quality=90)
    # The JAX package encodes device inputs as a 128-bucket padded render.
    padded = np.pad(planes, ((0, 0), (0, -h % 128), (0, -w % 128)), mode="edge")
    n = _straddles(_port_blockify(planes, 90),
                   _jax_blockify(padded, 90, (h, w))[
                       tbits._true_mask(6 * padded.shape[1] // 16 * padded.shape[2] // 16,
                                        padded.shape[2] // 16, -(-h // 16),
                                        -(-w // 16)).numpy()])
    if n == 0:
        assert ours == ref
    else:
        assert np.abs(_decode(ours).astype(int) - _decode(ref).astype(int)).max() <= 9


@pytest.mark.parametrize("h,w", [(64, 96), (33, 47), (17, 23), (8, 8)])
def test_packed_end_to_end_tracks_dense(h, w):
    planes = _noise(h, w, h * 100 + w)
    src_u8 = (np.clip(planes, 0, 1) * 255.0).astype(np.uint8)
    wire = tjpeg.encode_jpeg(torch.from_numpy(planes), quality=92)
    dense = tjpeg.encode_jpeg(planes, quality=92)
    d = _decode(wire)
    assert d.shape == (h, w, 3)
    assert _psnr(d.transpose(2, 0, 1), src_u8) > _psnr(
        _decode(dense).transpose(2, 0, 1), src_u8) - 1.0
    assert wire.startswith(b"\xff\xd8") and wire.endswith(b"\xff\xd9")


def test_sparse_true_needs_a_tensor():
    with pytest.raises(RuntimeError, match="tensor"):
        tjpeg.encode_jpeg(np.zeros((3, 16, 16), np.float32), sparse=True)


def test_exif_and_dense_wire_of_a_tensor():
    planes = torch.from_numpy(_noise(40, 56, 11))
    exif = b"Exif\x00\x00" + Image.Exif().tobytes()
    body = tjpeg.encode_jpeg(planes, quality=90, exif_bytes=exif)
    assert body[2:4] == b"\xff\xe1"
    assert _decode(body).shape == (40, 56, 3)
    dense = tjpeg.encode_jpeg(planes, quality=90, sparse=False)
    assert np.abs(_decode(dense).astype(int) - _decode(
        tjpeg.encode_jpeg(planes.numpy(), quality=90)).astype(int)).max() <= 1


def test_encode_image_routes_large_tensors_through_the_packed_wire(monkeypatch):
    planes = torch.from_numpy(_noise(48, 64, 4))
    monkeypatch.setattr(tjpeg, "SPARSE_MIN_PIXELS", 48 * 64)
    assert image_io.encode_image(planes, "JPEG", quality=92) == \
        tbits.encode_packed_device(planes, 92)
    monkeypatch.setattr(tjpeg, "SPARSE_MIN_PIXELS", 48 * 64 + 1)
    gated = image_io.encode_image(planes, "JPEG", quality=92)
    assert gated != tbits.encode_packed_device(planes, 92)   # the u8 + Pillow path
    assert _decode(gated).shape == (48, 64, 3)
    cropped = image_io.encode_image(planes, "JPEG", quality=92, host_crop=(4, 36, 8, 56))
    assert _decode(cropped).shape == (32, 48, 3)


def test_native_sparse_rejects_malformed_wire_data():
    blocks = _synth_blocks(12, seed=3)[:6]
    counts, bitmaps, vals, esc, _, ne = tjpeg._sparsify_np(tjpeg._dc_delta_np(blocks))
    assert ne > 0
    assert native.jpeg_encode_sparse(counts, bitmaps, vals, esc, 16, 16)[:2] == b"\xff\xd8"
    bad_counts = counts.copy()
    bad_counts[0] += 1
    esc_bad = esc.copy()
    esc_bad[-1] = 32000
    for args in ((bad_counts, bitmaps, vals, esc), (counts, bitmaps, vals, esc_bad),
                 (counts, bitmaps, vals, esc[:-1])):
        with pytest.raises(ValueError):
            native.jpeg_encode_sparse(*args, 16, 16)
    with pytest.raises(ValueError):
        native.jpeg_encode_sparse(counts, bitmaps, vals, esc, 64, 64)


def test_native_sparse_rejects_dc_accumulation_overflow():
    nblocks = 2 * 2 * 6
    counts = np.zeros(nblocks, dtype=np.uint8)
    bitmaps = np.zeros((nblocks, 2), dtype=np.uint32)
    vals, esc = [], []
    for b in range(nblocks):
        if b % 6 < 4:
            counts[b], bitmaps[b, 0] = 1, 1
            vals.append(8)
            esc.append(2047)
    packed = np.array(vals, np.uint8)
    packed = (packed[0::2] | (packed[1::2] << 4)).astype(np.uint8)
    with pytest.raises(ValueError):
        native.jpeg_encode_sparse(counts, bitmaps, packed, np.array(esc, np.int16),
                                  32, 32)
