"""The port's JPEG entropy wires (io/jpegbits, kernels/jpeg_wire on the CPU
twins, the native assemblers) against the JAX package's io/jpegbits, on the
CPU: numpy-seeded blocks through both packages' prepack/packed stages (bit
for bit, and against the serial numpy oracles), the three wires' files
byte-identical to each other, the wire order of encode_jpeg, and the native
assemblers' validation — the cases of tests/test_jpegbits.py."""

import io

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from rawphotoforge_tpu.io import jpegbits as jbits

from rawphotoforge_tpu_torch import native
from rawphotoforge_tpu_torch._errbase import JpegWireDataError
from rawphotoforge_tpu_torch.io import jpegbits as tbits, jpegenc as tjpeg
from rawphotoforge_tpu_torch.kernels import jpeg_wire


def _rand_blocks(rng, n, max_nnz=30, amp=1023):
    """Random sparse zigzag blocks inside the baseline domain (|AC| <= 1023,
    |DC delta| <= 2047), as tests/test_jpegbits.py makes them."""
    blocks = np.zeros((n, 64), np.int32)
    nnz = rng.integers(0, max_nnz + 1, n)
    for b in range(n):
        idx = rng.choice(63, nnz[b], replace=False) + 1
        blocks[b, idx] = rng.integers(-amp, amp + 1, nnz[b])
    blocks[:, 0] = rng.integers(-2000, 2001, n)
    return blocks


def _edge_blocks():
    """Dense max-magnitude blocks (the 52-word worst case), ZRL chains, a
    last-lane nonzero (no EOB), negative DC deltas."""
    blocks = np.zeros((6 * 4, 64), np.int32)
    blocks[6:12, 1:] = 1023
    blocks[6:12, 0] = 2047
    blocks[7, 1:] = -1023
    blocks[12, 17] = 3
    blocks[13, 34] = -5
    blocks[14, 48] = 7
    blocks[15, 63] = 1
    blocks[18:24, 0] = -2047
    return blocks


def _u32(t):
    return t.numpy().astype(np.uint32)


def _prepack_both(blocks, mask):
    """(port lens, words [N, 52], nwords, bad), (the same from JAX)."""
    ours = tbits.prepack(torch.from_numpy(blocks), torch.from_numpy(mask))
    ref = jbits._prepacked_jit().prepack(jnp.asarray(blocks), jnp.asarray(mask))
    return ours, [np.asarray(a) for a in ref]


def _stream(words, nwords):
    return np.concatenate([words[b, : int(nwords[b])] for b in range(words.shape[0])]
                          or [np.zeros(0, np.uint32)]).astype(np.uint32)


def _check_prepack(blocks, mask):
    (bits, words, nwords, bad), (lens_j, words_j, nwords_j, bad_j) = _prepack_both(
        blocks, mask)
    np.testing.assert_array_equal(bits.numpy(), lens_j)
    np.testing.assert_array_equal(_u32(words), words_j)       # the whole grid
    np.testing.assert_array_equal(nwords.numpy(), nwords_j)
    assert int(bad) == int(bad_j)
    lens_o, words_o = jbits.prepacked_np(blocks, mask)
    np.testing.assert_array_equal(bits.numpy(), lens_o)
    np.testing.assert_array_equal(_stream(_u32(words), nwords.numpy()), words_o)
    return bits


def _check_packed(blocks, mask):
    scan, (tw, tb, bad) = tbits.packed(torch.from_numpy(blocks), torch.from_numpy(mask))
    scan = _u32(scan)
    flat_j, tot_j = jbits._prepacked_jit().packed(
        jnp.asarray(blocks), jnp.asarray(mask), jbits.BLOCK_WORDS_ROT,
        jbits.BLOCK_WORDS_ROT)
    tot_j = [int(x) for x in np.asarray(tot_j)]
    assert (int(tw), int(tb), int(bad)) == tuple(tot_j[:3]) and int(tw) == tot_j[4]
    np.testing.assert_array_equal(scan[: int(tw)], np.asarray(flat_j)[: int(tw)])
    words_o, bits_o = jbits.packed_np(blocks, mask)
    assert int(tb) == bits_o
    np.testing.assert_array_equal(scan[: int(tw)], words_o)
    assert not scan[int(tw):].any()                        # deterministic zero tail


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prepack_matches_jax_and_oracle(seed):
    blocks = _rand_blocks(np.random.default_rng(seed), 6 * 8)
    _check_prepack(blocks, np.ones(48, bool))


def test_prepack_edge_blocks():
    bits = _check_prepack(_edge_blocks(), np.ones(24, bool))
    assert int(bits.max()) <= 32 * tbits.BLOCK_WORDS


def test_prepack_flags_out_of_domain_coefficients():
    """|AC| >= 1024 and a DC delta of size 12 have no Annex K.3 symbol: both
    packages count one bad lane, the oracle raises."""
    mask = np.ones(6, bool)
    for slot, value in ((5, 1024), (0, 2048)):
        blocks = np.zeros((6, 64), np.int32)
        blocks[2 if slot else 0, slot] = value
        with pytest.raises(ValueError, match="Huffman domain"):
            jbits.prepacked_np(blocks, mask)
        (_, _, _, bad), (_, _, _, bad_j) = _prepack_both(blocks, mask)
        assert int(bad) == int(bad_j) == 1


def test_prepack_mask_zeroes_padding_blocks():
    blocks = _rand_blocks(np.random.default_rng(3), 6 * 6)
    mask = np.ones(36, bool)
    mask[6:12] = False
    bits = _check_prepack(blocks, mask)
    assert (bits.numpy()[6:12] == 0).all()


def test_masked_dc_delta_matches_jax():
    rng = np.random.default_rng(4)
    blocks = np.zeros((5 * 6, 64), np.int32)
    blocks[:, 0] = rng.integers(-900, 900, 30)
    mask = np.ones((5, 6), bool)
    mask[2, :] = False
    mask[4, 3:] = False
    ours = tbits._dc_delta_masked(torch.from_numpy(blocks),
                                  torch.from_numpy(mask.reshape(-1)))
    ref = jbits._prepacked_jit().dc_delta_masked(jnp.asarray(blocks),
                                                 jnp.asarray(mask.reshape(-1)))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    # And the true mask itself.
    np.testing.assert_array_equal(tbits._true_mask(6 * 12, 4, 2, 3).numpy(),
                                  ((np.arange(72) // 6 // 4) < 2)
                                  & ((np.arange(72) // 6 % 4) < 3))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_packed_matches_jax_and_oracle(seed):
    blocks = _rand_blocks(np.random.default_rng(seed), 6 * 8)
    _check_packed(blocks, np.ones(48, bool))


@pytest.mark.parametrize("lead_dc", [0, 3, -100, 2047])
def test_packed_minimal_blocks_share_words(lead_dc):
    """Minimal blocks pack an MCU into 32 bits; a leading DC delta knocks
    every later block off word phase."""
    blocks = np.zeros((6 * 9, 64), np.int32)
    blocks[0, 0] = lead_dc
    _check_packed(blocks, np.ones(54, bool))


def test_packed_edge_blocks_and_padding():
    _check_packed(_edge_blocks(), np.ones(24, bool))
    blocks = _rand_blocks(np.random.default_rng(21), 6 * 6)
    mask = np.ones(36, bool)
    mask[24:] = False
    _check_packed(blocks, mask)


@pytest.mark.parametrize("padded", [True, False])
def test_prepack_lane_extremes_match_jax_oracle(padded):
    """chip_smoke.jpeg_lane_extremes (the card's hand-fed lane extremes:
    59-bit lanes over two and three words, the 31/32/33 seam, blocks of 32k
    and 32k +- 1 bits, DC-only blocks, padding MCUs between true ones):
    prepack after the masked DC deltas against the JAX oracle prepacked_np,
    on the set's own padded grid and with every MCU true."""
    from chip_smoke import LANE_TARGET_BITS, jpeg_lane_extremes

    blocks, (grid_c, mcu_r, mcu_c) = jpeg_lane_extremes()
    n = blocks.shape[0]
    if not padded:
        mcu_r, mcu_c = n // 6 // grid_c, grid_c
    mask = tbits._true_mask(n, grid_c, mcu_r, mcu_c)
    deltas = tbits._dc_delta_masked(torch.from_numpy(blocks), mask)
    bits, words, nwords, bad = tbits.prepack(deltas, mask)
    lens_o, words_o = jbits.prepacked_np(deltas.numpy(), mask.numpy())
    np.testing.assert_array_equal(bits.numpy(), lens_o)
    np.testing.assert_array_equal(_stream(_u32(words), nwords.numpy()), words_o)
    assert int(bad) == 0
    # With every MCU true the padding MCUs' DCs join the chain and shift
    # the targeted blocks' DC deltas.
    assert not padded or set(LANE_TARGET_BITS) <= set(bits.tolist())
    _, length, _ = tbits._lanes(deltas, mask)
    ends = torch.cumsum(length, 1)
    assert int(length.max()) == 59
    assert bool(((ends % 32 == 0) & (length > 0) & (ends < bits[:, None])).any())


@pytest.mark.parametrize("case", [0, 1])
def test_pack_extremes_match_the_serial_chop(case):
    """chip_smoke.jpeg_pack_extremes (the card's hand-fed pack inputs: runs
    of 0-bit and 1-6-bit blocks, 1664-bit blocks at every shift, garbage
    past each block's words, totals on and off a multiple of 32 bits)
    through jpeg_wire.pack on the CPU (the twins): the packed scan is the
    strings appended as one integer and chopped by the JAX package's
    _chop_words_np, and chip_smoke.scan_oracle; prepacked, each block's
    words chopped alone; both zero-tailed."""
    from chip_smoke import jpeg_pack_extremes, scan_oracle

    what, words, bits = jpeg_pack_extremes()[case]
    acc, total, pre = 0, 0, []
    for row, nb in zip(words.view(np.uint32), bits.tolist()):
        nw = -(-nb // 32)
        v = 0
        for word in row[:nw].tolist():
            v = (v << 32) | word
        v >>= 32 * nw - nb
        acc, total = (acc << nb) | v, total + nb
        pre += jbits._chop_words_np(v, nb)
    chop = np.asarray(jbits._chop_words_np(acc, total), np.uint32)
    assert (total % 32 == 0) == (case == 0)
    before = dict(jpeg_wire.KERNEL_LAUNCHES)
    scan = jpeg_wire.pack(torch.from_numpy(words), torch.from_numpy(bits)).numpy()
    flat = jpeg_wire.pack(torch.from_numpy(words), torch.from_numpy(bits),
                          packed=False).numpy()
    assert jpeg_wire.KERNEL_LAUNCHES == before
    assert scan.size == words.size + 1 and flat.size == words.size
    np.testing.assert_array_equal(scan.view(np.uint32)[: chop.size], chop)
    np.testing.assert_array_equal(chop.astype(np.int64), scan_oracle(words, bits))
    assert not scan[chop.size:].any()
    np.testing.assert_array_equal(flat.view(np.uint32)[: len(pre)],
                                  np.asarray(pre, np.uint32))
    assert not flat[len(pre):].any()


def test_huffman_wrapper_is_the_twin_on_the_cpu():
    """On a CPU tensor jpeg_wire.huffman and .pack run the twins (no
    launch counted): the masked DC chain, the 52-word strings, and the scan
    of packed_np."""
    rng = np.random.default_rng(5)
    grid_c, mcu_r, mcu_c = 3, 2, 2
    blocks = _rand_blocks(rng, 6 * grid_c * 3, amp=200)
    blocks[:, 0] = rng.integers(-1000, 1000, blocks.shape[0])
    mask = tbits._true_mask(blocks.shape[0], grid_c, mcu_r, mcu_c)
    before = dict(jpeg_wire.KERNEL_LAUNCHES)
    words, bits, bad = jpeg_wire.huffman(torch.from_numpy(blocks).to(torch.int16),
                                         grid_c, mcu_r, mcu_c)
    scan = jpeg_wire.pack(words, bits, packed=True)
    flat = jpeg_wire.pack(words, bits, packed=False)
    assert jpeg_wire.KERNEL_LAUNCHES == before
    assert words.dtype == bits.dtype == scan.dtype == torch.int32
    deltas = tbits._dc_delta_masked(torch.from_numpy(blocks), mask).numpy()
    words_o, bits_o = jbits.packed_np(deltas, mask.numpy())
    assert int(bits.sum()) == bits_o and int(bad) == 0
    np.testing.assert_array_equal(scan.numpy().view(np.uint32)[: words_o.size], words_o)
    lens_o, pre_o = jbits.prepacked_np(deltas, mask.numpy())
    np.testing.assert_array_equal(bits.numpy(), lens_o)
    np.testing.assert_array_equal(flat.numpy().view(np.uint32)[: pre_o.size], pre_o)


def _noise(h, w, seed):
    return torch.from_numpy(np.random.default_rng(seed).random((3, h, w), np.float32))


@pytest.mark.parametrize("h,w", [(64, 80), (48, 56), (33, 47), (37, 50), (61, 97)])
def test_wires_byte_identical(h, w):
    planes = _noise(h, w, 30)
    a = tjpeg._encode_sparse_device(planes, 90)
    b = tbits.encode_prepacked_device(planes, 90)
    c = tbits.encode_packed_device(planes, 90)
    assert a == b == c


@pytest.mark.parametrize("h,w,ph,pw", [(100, 72, 128, 128), (144, 272, 256, 384)])
def test_padded_wires_byte_identical_to_a_direct_encode(h, w, ph, pw):
    """A padded render with noise in its padding, encoded with true_shape,
    gives a direct encode's bytes on every wire."""
    full = _noise(ph, pw, 31)
    direct = tbits.encode_packed_device(full[:, :h, :w].contiguous(), 90)
    for enc in (tjpeg._encode_sparse_device, tbits.encode_prepacked_device,
                tbits.encode_packed_device):
        assert enc(full, 90, true_shape=(h, w)) == direct
    assert tjpeg.encode_jpeg(full, quality=90, true_shape=(h, w)) == direct


def test_padded_planes_must_be_mcu_aligned():
    with pytest.raises(ValueError, match="MCU-aligned"):
        tbits.encode_packed_device(_noise(40, 40, 1), 90, true_shape=(30, 30))
    with pytest.raises(ValueError, match="exceeds"):
        tbits.encode_packed_device(_noise(32, 32, 1), 90, true_shape=(40, 30))


def test_stream_decodes_via_pillow():
    h, w = 64, 96
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    planes = np.stack([yy / h, xx / w, (yy + xx) / (h + w)])
    data = tbits.encode_packed_device(torch.from_numpy(planes), 92)
    dec = np.array(Image.open(io.BytesIO(data)).convert("RGB"))
    assert dec.shape == (h, w, 3)
    src = (np.clip(planes, 0, 1) * 255).astype(np.float64)
    mse = np.mean((dec.transpose(2, 0, 1) - src) ** 2)
    assert 10 * np.log10(255.0 ** 2 / max(mse, 1e-9)) > 30.0


def test_wire_functions_compose():
    """The un-jitted wires (for composition by a multi-device export) give
    the streams the encode paths fetch, with int64 totals."""
    planes = _noise(48, 64, 7)
    qlum, qchr = tjpeg._quant_tables(92)
    scan, totals = tbits.wire_packed(planes, qlum, qchr)
    assert totals.dtype == torch.int64
    tw, tb, bad = totals.tolist()
    assert bad == 0 and tw == (tb + 31) // 32
    assert native.jpeg_encode_packed(tbits.fetch_scan(scan, tw), tb, 48, 64,
                                     quality=92) == tbits.encode_packed_device(planes, 92)
    padded = torch.cat([planes, _noise(48, 64, 8)], 2)[:, :, :80]
    scan2, totals2 = tbits.wire_packed_extent(padded, qlum, qchr, 48, 64)
    assert torch.equal(scan2[: tw], scan[: tw]) and totals2.tolist() == [tw, tb, 0]
    bits, flat, ptot = tbits.wire(planes, qlum, qchr)
    assert ptot.tolist()[1:] == [tb, 0]
    assert native.jpeg_encode_prepacked(
        bits.numpy().astype(np.uint16), tbits.fetch_scan(flat, ptot.tolist()[0]),
        48, 64, quality=92) == tbits.encode_packed_device(planes, 92)


def test_encode_jpeg_wire_order(monkeypatch, capsys):
    """encode_jpeg takes the packed wire first and degrades packed ->
    prepacked -> nibble -> dense on JpegWireDataError alone, byte-
    identically, logging each wire's first degradation; any other error
    (a failed build or launch) raises."""
    planes = _noise(64, 80, 14)
    calls = []
    real = tbits.encode_packed_device

    def spy(*a, **k):
        calls.append("packed")
        return real(*a, **k)

    monkeypatch.setattr(tbits, "encode_packed_device", spy)
    auto = tjpeg.encode_jpeg(planes, quality=90)
    assert calls == ["packed"] and auto.startswith(b"\xff\xd8")

    def refuse(*a, **k):
        raise JpegWireDataError("refused")

    monkeypatch.setattr(tjpeg, "_wire_fallback_warned", set())
    monkeypatch.setattr(tbits, "encode_packed_device", refuse)
    assert tjpeg.encode_jpeg(planes, quality=90) == auto
    assert "packed JPEG export wire refused its data" in capsys.readouterr().err
    monkeypatch.setattr(tbits, "encode_prepacked_device", refuse)
    assert tjpeg.encode_jpeg(planes, quality=90) == auto
    assert tjpeg.encode_jpeg(planes, quality=90, sparse=True) == auto
    monkeypatch.setattr(tjpeg, "_encode_sparse_device", refuse)
    with pytest.raises(JpegWireDataError):
        tjpeg.encode_jpeg(planes, quality=90, sparse=True)
    # Every device wire refused: the dense wire encodes, as sparse=False does.
    assert tjpeg.encode_jpeg(planes, quality=90) == tjpeg.encode_jpeg(
        planes, quality=90, sparse=False)

    def crash(*a, **k):
        raise RuntimeError("CUDA error 700")

    monkeypatch.setattr(tbits, "encode_packed_device", crash)
    with pytest.raises(RuntimeError, match="CUDA error"):
        tjpeg.encode_jpeg(planes, quality=90)


def test_out_of_domain_blocks_raise_the_typed_error(monkeypatch):
    """A bad lane count from the Huffman stage makes the packed and
    prepacked wires raise JpegWireDataError before any fetch."""
    planes = _noise(32, 32, 3)
    real = jpeg_wire.huffman

    def with_bad(*a, **k):
        words, bits, bad = real(*a, **k)
        return words, bits, bad + 1

    monkeypatch.setattr(jpeg_wire, "huffman", with_bad)
    for enc in (tbits.encode_packed_device, tbits.encode_prepacked_device):
        with pytest.raises(JpegWireDataError, match="Huffman domain"):
            enc(planes, 90)


@pytest.mark.parametrize("seed", range(4))
def test_native_prepacked_survives_random_wires(seed):
    """Arbitrary (lens, words) either raise ValueError or give a SOI..EOI
    framed stream — never a crash or a read past the buffers."""
    rng = np.random.default_rng(100 + seed)
    for _ in range(200):
        nblocks = 6 * int(rng.integers(1, 5))
        lens = rng.integers(0, 1700, nblocks).astype(np.uint16)
        words = rng.integers(0, 2**32, int(rng.integers(0, 80)),
                             dtype=np.uint64).astype(np.uint32)
        try:
            out = native.jpeg_encode_prepacked(lens, words, 16, nblocks // 6 * 16,
                                               quality=90)
        except ValueError:
            continue
        assert out[:2] == b"\xff\xd8" and out[-2:] == b"\xff\xd9"


def test_native_prepacked_rejects_malformed_wire():
    blocks = _rand_blocks(np.random.default_rng(13), 6)
    lens, words = jbits.prepacked_np(blocks, np.ones(6, bool))
    ok = native.jpeg_encode_prepacked(lens, words, 16, 16, quality=90)
    assert ok[:2] == b"\xff\xd8"
    bad = lens.copy()
    bad[0] = 2000
    for args in ((lens, words[:-1]), (lens, np.concatenate([words, words[:1]])),
                 (bad, words)):
        with pytest.raises(JpegWireDataError):
            native.jpeg_encode_prepacked(*args, 16, 16, quality=90)


def test_native_packed_roundtrip_and_validation():
    blocks = _rand_blocks(np.random.default_rng(33), 6)
    words, bits = jbits.packed_np(blocks, np.ones(6, bool))
    out = native.jpeg_encode_packed(words, bits, 16, 16, quality=90)
    lens, pre = jbits.prepacked_np(blocks, np.ones(6, bool))
    assert out == native.jpeg_encode_prepacked(lens, pre, 16, 16, quality=90)
    for args in ((words[:-1], bits), (words, bits + 64), (words, -1)):
        with pytest.raises(ValueError):
            native.jpeg_encode_packed(*args, 16, 16, quality=90)


@pytest.mark.parametrize("seed", range(2))
def test_native_packed_survives_random_wires(seed):
    rng = np.random.default_rng(200 + seed)
    for _ in range(200):
        nbits = int(rng.integers(0, 2000))
        nwords = (nbits + 31) // 32 if rng.random() < 0.8 else int(rng.integers(0, 70))
        words = rng.integers(0, 2**32, nwords, dtype=np.uint64).astype(np.uint32)
        try:
            out = native.jpeg_encode_packed(words, nbits, 16, 16, quality=90)
        except ValueError:
            continue
        assert out[:2] == b"\xff\xd8" and out[-2:] == b"\xff\xd9"


def test_native_assemblers_match_jax_builds():
    """The port's copies of the three assemblers give the JAX package's
    native library's bytes on the same wires."""
    from rawphotoforge_tpu import native as jnative

    if not jnative.available():
        pytest.skip("the JAX package's native library is not built here")
    blocks = _rand_blocks(np.random.default_rng(40), 6 * 4)
    mask = np.ones(24, bool)
    words, bits = jbits.packed_np(blocks, mask)
    lens, pre = jbits.prepacked_np(blocks, mask)
    assert native.jpeg_encode_packed(words, bits, 32, 32) == jnative.jpeg_encode_packed(
        words, bits, 32, 32)
    assert native.jpeg_encode_prepacked(lens, pre, 32, 32) == \
        jnative.jpeg_encode_prepacked(lens, pre, 32, 32)
    blocks[:, 0] = np.random.default_rng(41).integers(-1000, 1001, 24)  # absolute DCs
    sp = tjpeg._sparsify_np(tjpeg._dc_delta_np(blocks))
    assert native.jpeg_encode_sparse(*sp[:4], 32, 32) == jnative.jpeg_encode_sparse(
        *sp[:4], 32, 32)
