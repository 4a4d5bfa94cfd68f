"""The port's DNG OpcodeList2 GainMap (io/dng.py, opcode 9) on the opcode
bytes of tests/test_gainmap.py: equal to the JAX package's results and to
that file's scalar (loop-based) bilinear oracle."""

import struct

import numpy as np
import pytest

from rawphotoforge_tpu.io import dng as jdng

from rawphotoforge_tpu_torch.io import dng

from test_gainmap import _gain_map_opcode, _opcode_list, _oracle_apply


def _both(norm, opcodes):
    """The port's and the JAX package's _apply_gain_maps on copies of
    ``norm``; they must agree to the last bit."""
    ours = dng._apply_gain_maps(norm.copy(), opcodes)
    ref = np.asarray(jdng._apply_gain_maps(norm.copy(), opcodes))
    np.testing.assert_array_equal(ours, ref)
    return ours


@pytest.mark.parametrize("seed,shape,pts", [(0, (20, 28), (3, 4)),
                                            (5, (33, 17), (5, 2)),
                                            (6, (9, 41), (1, 6))])
def test_gain_map_matches_scalar_oracle_and_jax(seed, shape, pts):
    rng = np.random.default_rng(seed)
    h, w = shape
    pts_v, pts_h = pts
    norm = rng.random((h, w)).astype(np.float32)
    gains = rng.uniform(0.8, 2.0, size=(pts_v, pts_h)).astype(np.float32)
    sv = 1.0 / max(pts_v - 1, 1)
    sh = 1.0 / max(pts_h - 1, 1)
    op = _gain_map_opcode(0, 0, h, w, 1, 1, pts_v, pts_h, sv, sh, 0.0, 0.0, gains)
    got = _both(norm, _opcode_list([(9, op)]))
    want = _oracle_apply(norm, 0, 0, h, w, 1, 1, pts_v, pts_h, sv, sh, 0.0, 0.0, gains)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_pitched_area_touches_only_its_lattice():
    rng = np.random.default_rng(1)
    norm = rng.random((16, 16)).astype(np.float32)
    gains = np.full((2, 2), 1.5, dtype=np.float32)
    op = _gain_map_opcode(0, 0, 16, 16, 2, 2, 2, 2, 1.0, 1.0, 0.0, 0.0, gains)
    got = _both(norm, _opcode_list([(9, op)]))
    np.testing.assert_allclose(got[0::2, 0::2], norm[0::2, 0::2] * 1.5, rtol=1e-6)
    np.testing.assert_array_equal(got[1::2, :], norm[1::2, :])
    np.testing.assert_array_equal(got[0::2, 1::2], norm[0::2, 1::2])


def test_sub_area_with_origin_matches_oracle():
    """An area inside the frame, a map origin and spacing of its own."""
    rng = np.random.default_rng(8)
    norm = rng.random((24, 30)).astype(np.float32)
    gains = rng.uniform(0.9, 1.6, size=(3, 3)).astype(np.float32)
    op = _gain_map_opcode(3, 5, 20, 27, 1, 1, 3, 3, 0.4, 0.35, 0.1, 0.15, gains)
    got = _both(norm, _opcode_list([(9, op)]))
    want = _oracle_apply(norm, 3, 5, 20, 27, 1, 1, 3, 3, 0.4, 0.35, 0.1, 0.15, gains)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_unknown_opcodes_skipped():
    norm = np.ones((8, 8), dtype=np.float32)
    weird = _opcode_list([(4, b"\x00" * 8),
                          (9, _gain_map_opcode(0, 0, 8, 8, 1, 1, 1, 1, 1.0, 1.0,
                                               0.0, 0.0, np.asarray([[2.0]])))])
    np.testing.assert_allclose(_both(norm, weird), 2.0)


def test_end_to_end_dng_with_gain_map():
    """A DNG carrying OpcodeList2 decodes in the port to a float mosaic
    with the gains folded in, equal to the JAX decode, and develops."""
    from rawphotoforge_tpu_torch.io.raw import develop_raw_image

    rng = np.random.default_rng(2)
    h, w = 24, 32
    mosaic = rng.integers(600, 15000, size=(h, w), dtype=np.uint16)
    raw = dng.RawImage(mosaic=mosaic, pattern="RGGB", black_level=512.0,
                       white_level=16383.0, wb_gains=(2.0, 1.0, 1.5), xyz_to_cam=None)
    gains = np.asarray([[1.0, 1.4], [1.2, 2.0]], dtype=np.float32)
    op = _gain_map_opcode(0, 0, h, w, 1, 1, 2, 2, 1.0, 1.0, 0.0, 0.0, gains)
    data = dng.write_dng(raw, opcode_list_2=_opcode_list([(9, op)]))
    back = dng.read_dng(data)
    assert back.mosaic.dtype == np.float32
    assert back.black_level == 0.0 and back.white_level == 1.0
    np.testing.assert_array_equal(back.mosaic, jdng.read_dng(data).mosaic)
    norm = (mosaic.astype(np.float32) - 512.0) / (16383.0 - 512.0)
    want = _oracle_apply(norm, 0, 0, h, w, 1, 1, 2, 2, 1.0, 1.0, 0.0, 0.0, gains)
    np.testing.assert_allclose(back.mosaic, want, rtol=1e-5)
    planes, _ = develop_raw_image(back, device="cpu")
    assert tuple(planes.shape) == (3, h, w)


def test_malformed_opcode_list_is_typed():
    norm = np.ones((4, 4), dtype=np.float32)
    bad = struct.pack(">I", 2) + struct.pack(">IIII", 9, 0, 0, 400)
    with pytest.raises(dng.DngError):
        dng._apply_gain_maps(norm, bad)
    with pytest.raises(jdng.DngError):
        jdng._apply_gain_maps(norm, bad)


def test_linear_raw_per_plane_selectors():
    norm = np.ones((8, 8, 3), dtype=np.float32)
    ops = []
    for ch, g in enumerate((1.5, 2.0, 3.0)):
        body = struct.pack(">10I", 0, 0, 8, 8, ch, 1, 1, 1, 1, 1)
        body += struct.pack(">4d", 1.0, 1.0, 0.0, 0.0)
        body += struct.pack(">I", 1)
        body += np.asarray([[g]], dtype=">f4").tobytes()
        ops.append((9, body))
    got = _both(norm, _opcode_list(ops))
    for ch, g in enumerate((1.5, 2.0, 3.0)):
        np.testing.assert_allclose(got[..., ch], g)


def test_multi_plane_map_single_opcode():
    norm = np.ones((6, 6, 3), dtype=np.float32)
    gains = np.asarray([1.1, 1.2, 1.3], dtype=np.float32).reshape(1, 1, 3)
    body = struct.pack(">10I", 0, 0, 6, 6, 0, 3, 1, 1, 1, 1)
    body += struct.pack(">4d", 1.0, 1.0, 0.0, 0.0)
    body += struct.pack(">I", 3)
    body += gains.astype(">f4").tobytes()
    got = _both(norm, _opcode_list([(9, body)]))
    np.testing.assert_allclose(got[0, 0], [1.1, 1.2, 1.3], rtol=1e-6)


def test_convert_mode_preserves_pixels_and_opcodes():
    """read_dng(apply_opcodes=False) + write_dng in the port is a lossless
    transcode: the pixels pass through, both opcode lists re-serialize, and
    the transcoded file decodes as the source does (in both packages)."""
    from test_warp_rect import _warp_opcode

    rng = np.random.default_rng(3)
    mosaic = rng.integers(600, 15000, size=(16, 16), dtype=np.uint16)
    raw0 = dng.RawImage(mosaic=mosaic, pattern="RGGB", black_level=512.0,
                        white_level=16383.0, wb_gains=(2.0, 1.0, 1.5), xyz_to_cam=None)
    op2 = _opcode_list([(9, _gain_map_opcode(0, 0, 16, 16, 1, 1, 1, 2, 1.0, 1.0,
                                             0.0, 0.0, np.asarray([[1.0, 1.5]])))])
    op3 = _warp_opcode([[0.95, 0.02, 0, 0, 0, 0]], (0.5, 0.5))
    src = dng.write_dng(raw0, compression=7, opcode_list_2=op2, opcode_list_3=op3)

    raw = dng.read_dng(src, apply_opcodes=False)
    assert raw.mosaic.dtype == np.uint16
    np.testing.assert_array_equal(raw.mosaic, mosaic)
    assert raw.warp_rectilinear is None
    out = dng.write_dng(raw, compression=8, predictor=34892)

    a, b = dng.read_dng(src), dng.read_dng(out)
    assert a.mosaic.dtype == b.mosaic.dtype == np.float32
    np.testing.assert_allclose(b.mosaic, a.mosaic, rtol=1e-6)
    np.testing.assert_array_equal(b.mosaic, jdng.read_dng(out).mosaic)
    assert b.warp_rectilinear is not None
    np.testing.assert_allclose(b.warp_rectilinear[0], a.warp_rectilinear[0])
