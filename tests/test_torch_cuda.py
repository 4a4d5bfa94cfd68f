"""The hand-written CUDA kernels (develop, RAW Bayer and X-Trans, the JPEG
wires, the geodesic flood, the geometry and sharpen stage) against their plain torch twins, on the card. Every test here needs a CUDA device
and skips without one (the kernels have no CPU mode). The file imports
neither jax nor the test helpers (only chip_smoke.py's case builders), so
on a machine without jax it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from rawphotoforge_tpu_torch.core.params import (
    BRIGHTNESS, HUE, LIGHTNESS, SATURATION, EditParameters, default_curve_slots,
    pack_params)
from rawphotoforge_tpu_torch.engine.editor import FULL, LOW, PhotoEditor
from rawphotoforge_tpu_torch.kernels import fused

from chip_smoke import (BAYER_EDGE_HW, GEODESIC_HW, GEOMETRY_DISTORTIONS, GEOMETRY_HW,
                        GEOMETRY_SHARPNESS, GEOMETRY_TIME_EXTENT, GEOMETRY_TIME_HW,
                        geometry_planes, same_bits, twin_flood)
from torch_fixtures import no_shortcuts

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the develop kernel has no CPU mode")
    return torch.device("cuda")


def _close(ours, ref, tight=1e-4, loose=5e-3, frac=2e-3):
    """tests/test_develop.py:14's rule (tight 1e-4 for all but 2e-3 of the
    values, none beyond 5e-3), on card tensors."""
    d = (ours - ref).abs()
    assert (d > tight).float().mean().item() <= frac
    assert d.max().item() <= loose


def _params():
    p = EditParameters()
    p.set_tone(exposure=0.9, contrast=30, shadow=25, highlight=-15, black=8, white=-6)
    p.set_whitebalance(temperature=40, tint=-20)
    p.set_vignette(55)
    p.set_curve(BRIGHTNESS, [0, 20000, 45000, 65535], [2000, 28000, 43000, 65535])
    p.set_curve(HUE, [0, 30000, 65535], [8000, 35000, 62000])
    p.set_curve(SATURATION, [0, 40000, 65535], [36000, 28000, 36000])
    p.set_curve(LIGHTNESS, [0, 65535], [30000, 36000])
    q = EditParameters()
    q.set_tone(exposure=-0.4, contrast=40)
    q.set_curve(SATURATION, [0, 65535], [30000, 38000])
    r = EditParameters()
    r.set_curve(HUE, [0, 20000, 65535], [3000, 24000, 65535])
    return [p, q, r]


def _inputs(dev, h, w, m, dtype=torch.uint8):
    rng = np.random.default_rng(7)
    planes = torch.from_numpy(rng.random((3, h, w), dtype=np.float32) ** 2).to(dev)
    masks = (rng.random((m, h, w)) > 0.5).astype(np.uint8)
    masks[0] = 1
    return planes, torch.from_numpy(masks).to(dev).to(dtype)


@pytest.mark.parametrize("h,w", [(48, 160), (37, 150), (512, 768)])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
def test_kernel_matches_twin(dev, h, w, dtype):
    plist = _params()
    planes, masks = _inputs(dev, h, w, 3, dtype)
    params = pack_params(plist, extent=(h - 3, w - 5), device=dev)
    before = fused.LAUNCHES
    out = fused.develop_post_geo_fused(planes, params, masks, row_offset=5.0)
    torch.cuda.synchronize()
    assert fused.LAUNCHES == before + 1
    ref = fused.develop_post_geo_fused_ref(planes, params, masks, row_offset=5.0)
    _close(out, ref)


def test_shortcuts_bit_identical_on_the_card(dev):
    plist = _params()
    planes, masks = _inputs(dev, 64, 256, 3)
    params = pack_params(plist, device=dev)
    assert params.default_slots == default_curve_slots(plist)
    general = fused.develop_post_geo_fused(planes, no_shortcuts(params), masks)
    slots = fused.develop_post_geo_fused(planes, params, masks)
    assert torch.equal(general, slots)
    tone = EditParameters()
    tone.set_tone(exposure=0.8, contrast=20)
    one = pack_params([tone], device=dev)
    base = fused.develop_post_geo_fused(planes, no_shortcuts(one), None)
    fast = fused.develop_post_geo_fused(planes, one, None)
    assert torch.equal(base, fast)
    ident = fused.develop_post_geo_fused(planes, one, None, identity_oklch=True)
    assert not torch.equal(ident, fast)
    assert (ident - fast).abs().max().item() < 3e-3
    # A real hue curve: identity_oklch only permits, the full path runs.
    hue = EditParameters()
    hue.set_tone(exposure=0.8)
    hue.set_curve(HUE, [0, 30000, 65535], [4000, 33000, 63000])
    packed = pack_params([hue], device=dev)
    assert torch.equal(
        fused.develop_post_geo_fused(planes, packed, None, identity_oklch=True),
        fused.develop_post_geo_fused(planes, packed, None))


def test_cuda_tensors_never_reach_the_twin(dev, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the twin ran for a CUDA tensor")

    monkeypatch.setattr(fused, "develop_post_geo_fused_ref", refuse)
    planes, _ = _inputs(dev, 16, 128, 1)
    params = pack_params([EditParameters()], device=dev)
    fused.develop_post_geo_fused(planes, params, None)
    with pytest.raises(ValueError, match="masks must be"):
        fused.develop_post_geo_fused(planes, params,
                                     torch.ones((1, 16, 128), dtype=torch.int32, device=dev))


def test_editor_on_the_card_matches_cpu_session(dev):
    rng = np.random.default_rng(3)
    img = rng.random((96, 160, 3), dtype=np.float32) ** 2
    eds = [PhotoEditor.from_rgb_f32(img, device=d, mid_long_edge=80, low_long_edge=40)
           for d in (dev, "cpu")]
    logits = np.zeros((96, 160), np.float32)
    logits[20:60, 30:120] = 1.0
    for ed in eds:
        ed.set_tone(exposure=0.5, contrast=20)
        ed.set_lens_distortion(-20)
        ed.set_sharpness(25)
        ed.set_curve(BRIGHTNESS, [0, 30000, 65535], [0, 35000, 65535])
        ed.add_mask("r", logits)
        ed.set_curve(SATURATION, [0, 65535], [30000, 36000], mask_name="r")
    for level in (FULL, LOW):
        _close(eds[0].apply(level).cpu(), eds[1].apply(level))


RAW_CAM = np.array([[1.6, -0.4, -0.2], [-0.3, 1.5, -0.2], [0.0, -0.5, 1.5]],
                   np.float32)


@pytest.mark.parametrize("pattern,h,w", [
    ("RGGB", 64, 512), ("GBRG", 50, 300), ("BGGR", 37, 150), ("GRBG", 64, 256),
    ("XTRANS", 96, 768), ("XTRANS", 100, 700)])
@pytest.mark.parametrize("sharpen,m", [(0.0, 1), (0.8, 3)])
def test_raw_kernel_bit_identical_to_twin(dev, pattern, h, w, sharpen, m):
    from rawphotoforge_tpu_torch.kernels import raw_pipeline as rp

    rng = np.random.default_rng(5)
    mosaic = torch.from_numpy(rng.random((h, w), dtype=np.float32)).to(dev)
    params = pack_params(_params()[:m], extent=(h, w), device=dev)
    _, masks = _inputs(dev, h, w, m)
    kernel = "xtrans_kernel" if pattern == "XTRANS" else "bayer_kernel"
    before = dict(rp.KERNEL_LAUNCHES)
    out = rp.raw_develop_fused(mosaic, (1.8, 1.0, 1.4), RAW_CAM, params,
                               np.float32(sharpen), pattern=pattern, masks=masks)
    torch.cuda.synchronize()
    assert rp.KERNEL_LAUNCHES == dict(before, **{kernel: before[kernel] + 1})
    ref = rp.raw_develop_fused_ref(mosaic, (1.8, 1.0, 1.4), RAW_CAM, params,
                                   np.float32(sharpen), pattern=pattern,
                                   masks=masks)
    assert torch.equal(out, ref)


@pytest.mark.parametrize("s", [1, 2, 4, 8, 16])
def test_curve_rows_bit_identical_to_twin(dev, s):
    """The binary curve search: every S a row packs into, at a width that
    is not a multiple of 4 (the scalar loads of the ragged edge)."""
    from chip_smoke import curve_rows

    planes, masks = _inputs(dev, 37, 150, 2)
    params = curve_rows(dev, s)
    out = fused.develop_post_geo_fused(planes, params, masks)
    assert torch.equal(out, fused.develop_post_geo_fused_ref(planes, params, masks))


def test_device_functions_match_twins(dev):
    """The OKLab cube root, the OETF and the divisions by a constant
    against their torch twins (chip_smoke.py phase 2a sweeps every f32)."""
    from rawphotoforge_tpu_torch.core import color
    from rawphotoforge_tpu_torch.core.numerics import div
    from rawphotoforge_tpu_torch.kernels import ktrig

    x = torch.rand(1 << 20, device=dev) * 2.0
    for name, twin in (("cbrt_pow", color._cbrt), ("srgb_oetf", ktrig.srgb_oetf)):
        assert torch.equal(fused.device_fn(name, x), twin(x)), name
    whole = torch.arange(65536, dtype=torch.float32, device=dev)
    for name, d in (("div_65535", 65535.0), ("div_32767_5", 32767.5)):
        assert torch.equal(fused.device_fn(name, whole), div(whole, d)), name


@pytest.mark.parametrize("h,w", [(12, 12), (61, 133), (100, 700)])
def test_xtrans_kernel_at_edge_shapes(dev, h, w):
    """The X-Trans kernel at sizes that are not multiples of its 48x24
    step or of 6, down to the smallest legal 12x12, bit for bit against the
    twin."""
    from rawphotoforge_tpu_torch.kernels import raw_pipeline as rp

    rng = np.random.default_rng(11)
    mosaic = torch.from_numpy(rng.random((h, w), dtype=np.float32)).to(dev)
    params = pack_params(_params()[:3], extent=(h, w), device=dev)
    _, masks = _inputs(dev, h, w, 3)
    before = dict(rp.KERNEL_LAUNCHES)
    out = rp.raw_develop_fused(mosaic, (1.8, 1.0, 1.4), RAW_CAM, params,
                               np.float32(0.8), pattern="XTRANS", masks=masks)
    torch.cuda.synchronize()
    assert rp.KERNEL_LAUNCHES["xtrans_kernel"] == before["xtrans_kernel"] + 1
    ref = rp.raw_develop_fused_ref(mosaic, (1.8, 1.0, 1.4), RAW_CAM, params,
                                   np.float32(0.8), pattern="XTRANS", masks=masks)
    assert torch.equal(out, ref)


def _bayer_bit_identical(dev, mosaic, pattern):
    """M=1 with sharpen 0 and M=3 (u8 masks) with sharpen 0.8: one launch
    each, bit for bit against the twin."""
    from rawphotoforge_tpu_torch.kernels import raw_pipeline as rp

    h, w = mosaic.shape
    _, masks = _inputs(dev, h, w, 3)
    for m, sharpen in ((1, 0.0), (3, 0.8)):
        params = pack_params(_params()[:m], extent=(h, w), device=dev)
        args = (mosaic, (1.8, 1.0, 1.4), RAW_CAM, params, np.float32(sharpen))
        mk = masks if m > 1 else None
        before = rp.KERNEL_LAUNCHES["bayer_kernel"]
        out = rp.raw_develop_fused(*args, pattern=pattern, masks=mk)
        torch.cuda.synchronize()
        assert rp.KERNEL_LAUNCHES["bayer_kernel"] == before + 1
        ref = rp.raw_develop_fused_ref(*args, pattern=pattern, masks=mk)
        assert torch.equal(out, ref), (m, sharpen)


@pytest.mark.parametrize("h,w", BAYER_EDGE_HW)
@pytest.mark.parametrize("pattern", ["RGGB", "BGGR", "GRBG", "GBRG"])
def test_bayer_kernel_at_edge_shapes(dev, pattern, h, w):
    """The Bayer strip walk at its edges: frames narrower than a 124-column
    strip or a 16-row step, widths that are not a multiple of the strip or
    of 4, inner strips (16-byte loads), a band of several steps."""
    rng = np.random.default_rng(13)
    mosaic = torch.from_numpy(rng.random((h, w), dtype=np.float32)).to(dev)
    _bayer_bit_identical(dev, mosaic, pattern)


def test_bayer_kernel_off_the_16_byte_grid(dev):
    """A contiguous mosaic view one float past a 16-byte boundary takes the
    scalar loads and stays bit for bit."""
    h, w = 70, 380
    rng = np.random.default_rng(17)
    flat = torch.from_numpy(rng.random(h * w + 1, dtype=np.float32)).to(dev)
    mosaic = flat[1:].view(h, w)
    assert mosaic.is_contiguous() and mosaic.data_ptr() % 16 == 4
    _bayer_bit_identical(dev, mosaic, "GRBG")


def test_raw_kernel_never_runs_the_twin_for_cuda(dev, monkeypatch):
    from rawphotoforge_tpu_torch.kernels import raw_pipeline as rp

    def refuse(*a, **k):
        raise AssertionError("the twin ran for a CUDA tensor")

    monkeypatch.setattr(rp, "raw_develop_fused_ref", refuse)
    mosaic = torch.rand((48, 96), device=dev)
    params = pack_params([EditParameters()], device=dev)
    rp.raw_develop_fused(mosaic, (1.0, 1.0, 1.0), np.eye(3), params,
                         np.float32(0.0), pattern="XTRANS")
    with pytest.raises(ValueError, match="float32"):
        rp.raw_develop_fused(mosaic.double(), (1.0, 1.0, 1.0), np.eye(3),
                             params, np.float32(0.0))


# -- vendor containers and lens correction on the card ----------------------

def _vendor_blobs():
    """Small vendor files from tests/torch_fixtures.py (jax-free)."""
    import torch_fixtures as fx

    from rawphotoforge_tpu_torch.io import dng, raw as rawio

    rng = np.random.default_rng(23)
    border = (9, 5, 136, 52)  # odd left/top: a BGGR active area
    cr2 = fx.build_cr2(fx.cr2_sensor(rng, 54, 140, border), slices=(2, 48, 44),
                       sensor_border=border, lens_model="EF 50mm f/1.8 II",
                       fnumber=2.8)
    arw, _ = fx.arw2_file(fx.arw2_codes(rng, 40, 128), preview="match")
    xt = rawio.synthetic_raw(fx.scene(rng, 48, 132), "XTRANS", black_level=0)
    m4 = fx.smooth12(rng, 42, 134, base=900)
    raw4 = dng.RawImage(mosaic=m4, pattern="RGGB", black_level=157.0,
                        white_level=4095.0, wb_gains=(1.8, 1.0, 1.4),
                        xyz_to_cam=None)
    return {
        "a.cr2": cr2, "b.arw": arw, "c.raf": fx.raf_file(xt.mosaic, "XTRANS"),
        "d.rw2": fx.rw2_file(fx.smooth12(rng, 42, 134, base=900), "GRBG",
                             borders=(1, 3, 41, 131)),
        "e.rw2": fx.rw2_file(m4, raw_format=4,
                             preview=fx.matching_preview(raw4, 128)),
    }


@pytest.mark.parametrize("name", ["a.cr2", "b.arw", "c.raf", "d.rw2", "e.rw2"])
def test_vendor_mosaic_through_the_raw_kernel(dev, name):
    """Each vendor-decoded mosaic (odd CR2 borders, ARW2 through the gate,
    X-Trans RAF, RW2 plain with borders and RAW4) through the RAW kernel:
    one launch, bit for bit its twin."""
    from rawphotoforge_tpu_torch.io import raw as rawio
    from rawphotoforge_tpu_torch.kernels import raw_pipeline as rp

    raw = rawio.with_effective_wb(rawio.parse_raw(_vendor_blobs()[name]))
    h, w = raw.mosaic.shape
    args = (rawio.normalized_mosaic(raw, raw.mosaic, dev), raw.wb_gains,
            rawio.cam2srgb_for(raw), pack_params(_params()[:1], extent=(h, w),
                                                 device=dev), np.float32(0.6))
    kernel = "xtrans_kernel" if raw.pattern == "XTRANS" else "bayer_kernel"
    before = dict(rp.KERNEL_LAUNCHES)
    out = rp.raw_develop_fused(*args, pattern=raw.pattern)
    torch.cuda.synchronize()
    assert rp.KERNEL_LAUNCHES == dict(before, **{kernel: before[kernel] + 1})
    assert torch.equal(out, rp.raw_develop_fused_ref(*args, pattern=raw.pattern))


def test_vendor_batch_on_the_card(dev, tmp_path):
    """`cli batch` of the vendor files, a gate-refused ARW2 and a warped
    DNG: one RAW-kernel launch per Bayer/X-Trans file, one develop-kernel
    launch each for the refused file's preview and the warped DNG."""
    import torch_fixtures as fx

    from rawphotoforge_tpu_torch.app import cli
    from rawphotoforge_tpu_torch.io import dng, raw as rawio
    from rawphotoforge_tpu_torch.kernels import raw_pipeline as rp

    src = tmp_path / "in"
    src.mkdir()
    for name, blob in _vendor_blobs().items():
        (src / name).write_bytes(blob)
    rng = np.random.default_rng(29)
    bad, _ = fx.arw2_file(fx.arw2_codes(rng, 40, 128),
                          preview=fx.noise_preview(29))
    (src / "f_bad.arw").write_bytes(bad)
    warp = rawio.synthetic_raw(fx.scene(rng, 48, 72), "RGGB")
    (src / "g.dng").write_bytes(dng.write_dng(warp, opcode_list_3=fx.opcode_list3(
        warp=([[0.96, 0.05, -0.01, 0.0, 0.0, 0.0]], (0.5, 0.5)))))
    before, dev_before = dict(rp.KERNEL_LAUNCHES), fused.LAUNCHES
    assert cli.main(["batch", str(src), str(tmp_path / "out"), "--exposure", "0.3",
                     "--device", str(dev)]) == 0
    torch.cuda.synchronize()
    assert rp.KERNEL_LAUNCHES == {"bayer_kernel": before["bayer_kernel"] + 4,
                                  "xtrans_kernel": before["xtrans_kernel"] + 1}
    assert fused.LAUNCHES == dev_before + 2
    assert len(list((tmp_path / "out").iterdir())) == 7


def test_lens_corrected_editor_on_the_card_matches_cpu(dev, tmp_path):
    p = tmp_path / "lens.cr2"
    p.write_bytes(_vendor_blobs()["a.cr2"])
    eds = [PhotoEditor.open(str(p), lens_correct=True, device=d,
                            mid_long_edge=64, low_long_edge=32)
           for d in (dev, "cpu")]
    assert eds[0].applied_lens_profile == eds[1].applied_lens_profile
    assert "50mm" in eds[0].applied_lens_profile
    for ed in eds:
        ed.set_tone(exposure=0.4, contrast=20)
        ed.set_curve(HUE, [0, 30000, 65535], [8000, 35000, 62000])
    for level in (FULL, LOW):
        _close(eds[0].apply(level).cpu(), eds[1].apply(level))


# -- the JPEG device wires ------------------------------------------------------

@pytest.mark.parametrize("h,w,true_hw", [(37, 50, None), (61, 97, None),
                                         (128, 128, (100, 72)), (512, 768, None),
                                         (17, 33, (1, 1)), (16, 4099, (9, 4097)),
                                         (40, 8256, None), (64, 256, (30, 200))])
def test_jpeg_kernels_match_twins(dev, h, w, true_hw):
    """The blocks, Huffman and pack kernels against their twins, bit for bit
    (the blocks also against the CPU twin): one launch of each. The blocks
    kernel's edges: a 1x1 true extent, a row pitch off the 16-byte grid with
    several chunks in one strip, fewer chunks than a wave of blocks, and a
    16-byte-aligned pitch with a true extent (16-byte staging of clamped
    rows and of strips beyond the true height, 4-byte staging of the chunk
    that crosses the true width)."""
    from chip_smoke import _entropy_vs_twins, jpeg_scene
    from rawphotoforge_tpu_torch.io import jpegenc
    from rawphotoforge_tpu_torch.kernels import jpeg_wire as jw

    planes = jpeg_scene(np.random.default_rng(h), h, w, dev)
    th, tw = true_hw or (h, w)
    q = jpegenc._quant_tables(95)
    before = dict(jw.KERNEL_LAUNCHES)
    blocks = jw.blocks(planes, *q, (th, tw))
    torch.cuda.synchronize()
    assert torch.equal(blocks, jpegenc.blockify(planes, *q, (th, tw)))
    assert torch.equal(blocks.cpu(), jpegenc.blockify(planes.cpu(), *q, (th, tw)))
    _entropy_vs_twins(blocks, -(-w // 16), -(-th // 16), -(-tw // 16), f"{h}x{w}")
    assert jw.KERNEL_LAUNCHES == {"jpeg_blocks_kernel": before["jpeg_blocks_kernel"] + 1,
                                  "jpeg_huffman_kernel": before["jpeg_huffman_kernel"] + 1,
                                  "jpeg_pack_kernel": before["jpeg_pack_kernel"] + 2}


def test_jpeg_edge_blocks_on_the_card(dev):
    """Hand-fed worst cases (+-1023 ACs, +-2047 DC deltas, ZRL chains, no
    EOB, padding grids), the lane extremes of the warp formulation (59-bit
    lanes, the 31/32/33 seam, blocks of 32k and 32k +- 1 bits, DC-only
    blocks, padding MCUs between true ones) and out-of-domain coefficients
    through the Huffman and pack kernels, against the twins and the serial
    oracle."""
    from chip_smoke import (LANE_TARGET_BITS, _entropy_vs_twins, jpeg_edge_blocks,
                            jpeg_lane_extremes)
    from rawphotoforge_tpu_torch.io import jpegbits
    from rawphotoforge_tpu_torch.kernels import jpeg_wire as jw

    good, oob = jpeg_edge_blocks()
    extremes, (grid_c, mcu_r, mcu_c) = jpeg_lane_extremes()
    n_ext = extremes.shape[0]
    for blocks, grid in [(good, g) for g in ((3, 2, 3), (3, 2, 2), (3, 1, 3))] + [
            (extremes, (grid_c, mcu_r, mcu_c)),
            (extremes, (grid_c, n_ext // 6 // grid_c, grid_c))]:
        words, bits, bad = _entropy_vs_twins(torch.from_numpy(blocks).to(dev), *grid,
                                             str(grid))
        assert int(bad) == 0 and int(bits.max()) <= 32 * jpegbits.BLOCK_WORDS
        mask = jpegbits._true_mask(blocks.shape[0], *grid)
        ref, nbits = jpegbits.packed_np(
            jpegbits._dc_delta_masked(torch.from_numpy(blocks), mask).numpy(),
            mask.numpy())
        assert int(bits.sum()) == nbits
        assert np.array_equal(jpegbits.fetch_scan(jw.pack(words, bits), ref.size), ref)
        if blocks is extremes and grid[1] == mcu_r:
            assert set(LANE_TARGET_BITS) <= set(bits.tolist())
    _, _, bad = _entropy_vs_twins(torch.from_numpy(oob).to(dev), 3, 2, 3, "oob")
    assert int(bad) > 0


def test_jpeg_pack_extremes_on_the_card(dev):
    """Hand-fed (words, bits) through the pack kernel, packed and
    prepacked, against its twins and the serial oracle: runs of 0-bit and
    of 1-6-bit blocks, 1664-bit blocks at every shift, garbage past each
    block's words, totals on and off a multiple of 32 bits."""
    from chip_smoke import _pack_vs_twins, jpeg_pack_extremes, scan_oracle
    from rawphotoforge_tpu_torch.io import jpegbits
    from rawphotoforge_tpu_torch.kernels import jpeg_wire as jw

    for what, words, bits in jpeg_pack_extremes():
        before = jw.KERNEL_LAUNCHES["jpeg_pack_kernel"]
        _pack_vs_twins(torch.from_numpy(words).to(dev), torch.from_numpy(bits).to(dev),
                       what)
        assert jw.KERNEL_LAUNCHES["jpeg_pack_kernel"] == before + 2
        scan = jw.pack(torch.from_numpy(words).to(dev), torch.from_numpy(bits).to(dev))
        ref = scan_oracle(words, bits)
        got = jpegbits.fetch_scan(scan, ref.size).astype(np.int64) & 0xFFFFFFFF
        assert np.array_equal(got, ref), what


@pytest.mark.parametrize("h,w,true_shape", [(61, 97, None), (128, 128, (100, 72))])
def test_jpeg_wires_byte_identical_on_the_card(dev, h, w, true_shape):
    """The packed, prepacked and nibble wires give one file on the card,
    the CPU twins' file, decoding at its true size; encode_jpeg takes the
    packed wire."""
    import io

    from PIL import Image

    from chip_smoke import jpeg_scene
    from rawphotoforge_tpu_torch.io import jpegbits, jpegenc

    planes = jpeg_scene(np.random.default_rng(3), h, w, dev)
    files = [enc(planes, 95, true_shape=true_shape) for enc in (
        jpegbits.encode_packed_device, jpegbits.encode_prepacked_device,
        jpegenc._encode_sparse_device)]
    assert files[0] == files[1] == files[2]
    assert files[0] == jpegbits.encode_packed_device(planes.cpu(), 95, true_shape=true_shape)
    assert jpegenc.encode_jpeg(planes, 95, true_shape=true_shape) == files[0]
    th, tw = true_shape or (h, w)
    with Image.open(io.BytesIO(files[0])) as im:
        assert im.size == (tw, th)


# -- the geodesic flood kernel (csrc/geodesic.cu) --------------------------------

def _geodesic_inputs(dev, h, w, seed=0, nan=False):
    from rawphotoforge_tpu_torch.ops import masking

    rng = np.random.default_rng(seed)
    planes = rng.random((3, h, w), dtype=np.float32) * 0.8 + 0.1
    if nan:
        planes[0, h // 2, w // 2] = np.nan
    return masking.step_costs(torch.from_numpy(planes).to(dev), 12.0, 0.002)


@pytest.mark.parametrize("h,w", GEODESIC_HW)
@pytest.mark.parametrize("direction", ["down", "up", "right", "left"])
def test_geodesic_sweep_bit_identical_to_twin(dev, h, w, direction):
    from rawphotoforge_tpu_torch.kernels import geodesic

    gv, gh = _geodesic_inputs(dev, h, w, seed=h * w)
    rng = np.random.default_rng(h + w)
    d0 = torch.from_numpy(np.where(rng.random((h, w)) < 0.05, 0.0,
                                   rng.random((h, w)) * 50).astype(np.float32)).to(dev)
    ours, ref = d0.clone(), d0.clone()
    before = geodesic.KERNEL_LAUNCHES["geodesic_sweep_kernel"]
    geodesic.sweep(ours, gv, gh, direction)
    torch.cuda.synchronize()
    assert geodesic.KERNEL_LAUNCHES["geodesic_sweep_kernel"] == before + 1
    geodesic.sweep_ref(ref, gv, gh, direction)
    same_bits(ours, ref, f"{h}x{w} {direction} sweep")


@pytest.mark.parametrize("h,w,seeds,nan", [
    (37, 50, [(0, 0)], False), (61, 97, [(60, 96)], True),
    (128, 128, [(0, 127), (127, 0), (64, 64)], False), (1, 300, [(0, 299)], False),
    (300, 1, [(150, 0)], False), (853, 1280, [(400, 600)], False)])
def test_geodesic_flood_bit_identical_to_twin(dev, h, w, seeds, nan):
    from rawphotoforge_tpu_torch.kernels import geodesic
    from rawphotoforge_tpu_torch.ops.masking import BIG

    gv, gh = _geodesic_inputs(dev, h, w, nan=nan)
    d0 = torch.full((h, w), BIG, device=dev)
    for y, x in seeds:
        d0[y, x] = 0.0
    before = geodesic.KERNEL_LAUNCHES["geodesic_sweep_kernel"]
    ours = geodesic.flood(d0.clone(), gv, gh)
    torch.cuda.synchronize()
    assert geodesic.KERNEL_LAUNCHES["geodesic_sweep_kernel"] == before + 1
    same_bits(ours, twin_flood(d0.clone(), gv, gh), f"{h}x{w} flood from {seeds}")
    assert bool(torch.isnan(ours).any()) == nan


@pytest.mark.parametrize("h,w,seeds,nan", [
    (853, 1281, [(0, 1280)], False), (4000, 96, [(3999, 0), (10, 95)], True),
    (96, 6000, [(50, 5999)], False), (61, 97, [(30, 40)], False)])
@pytest.mark.parametrize("sweeps", [1, 12])
def test_geodesic_flood_rounds_and_long_chains_bit_identical_to_twin(
        dev, h, w, seeds, nan, sweeps):
    """One launch a flood at 1 and 12 rounds: a width off the 32-chain tile,
    chains longer than the kernel's ring of chunks (the walk back re-reads
    the chunks the ring no longer holds), a NaN pixel on the tall shape."""
    from rawphotoforge_tpu_torch.kernels import geodesic
    from rawphotoforge_tpu_torch.ops.masking import BIG

    gv, gh = _geodesic_inputs(dev, h, w, seed=h + w, nan=nan)
    d0 = torch.full((h, w), BIG, device=dev)
    for y, x in seeds:
        d0[y, x] = 0.0
    before = geodesic.KERNEL_LAUNCHES["geodesic_sweep_kernel"]
    ours = geodesic.flood(d0.clone(), gv, gh, sweeps)
    torch.cuda.synchronize()
    assert geodesic.KERNEL_LAUNCHES["geodesic_sweep_kernel"] == before + 1
    same_bits(ours, twin_flood(d0.clone(), gv, gh, sweeps),
              f"{h}x{w} flood of {sweeps} rounds from {seeds}")
    assert bool(torch.isnan(ours).any()) == nan


@pytest.mark.parametrize("h,w", [(61, 97), (64, 128), (1, 9), (9, 1)])
def test_geodesic_flood_takes_contiguous_and_pitched_arrays(dev, h, w):
    """The kernel reads rows pitch(W) floats apart: contiguous arrays go
    through padded copies (d copied back), pitched views are read in place;
    both floods equal the twin's bit for bit."""
    from rawphotoforge_tpu_torch.kernels import geodesic
    from rawphotoforge_tpu_torch.ops.masking import BIG

    gv, gh = _geodesic_inputs(dev, h, w, seed=w)
    for t in (gv, gh):
        assert t.numel() == 0 or t.shape[0] == 1 or t.stride(0) == geodesic.pitch(w)
    d0 = torch.full((h, w), BIG, device=dev)
    d0[h // 2, w // 2] = 0.0
    pitched = geodesic.pitched_empty(h, w, dev).copy_(d0)
    flat = geodesic.flood(d0.clone(), gv.contiguous(), gh.contiguous())
    geodesic.flood(pitched, gv, gh)
    torch.cuda.synchronize()
    ref = twin_flood(d0.clone(), gv, gh)
    same_bits(flat, ref, f"{h}x{w} flood of contiguous arrays")
    same_bits(pitched, ref, f"{h}x{w} flood of pitched views")


def test_geodesic_cuda_tensors_never_reach_the_twin(dev, monkeypatch):
    from rawphotoforge_tpu_torch.engine.editor import PhotoEditor as Ed
    from rawphotoforge_tpu_torch.kernels import geodesic

    def refuse(*a, **k):
        raise AssertionError("the twin ran for a CUDA tensor")

    monkeypatch.setattr(geodesic, "sweep_ref", refuse)
    img = np.full((96, 160, 3), 0.4, np.float32)
    img[:, 80:] = (0.7, 0.2, 0.1)
    ed = Ed.from_rgb_f32(img, device=dev, mid_long_edge=80, low_long_edge=40)
    before = geodesic.KERNEL_LAUNCHES["geodesic_sweep_kernel"]
    ed.add_smart_mask("s", (20, 40), tolerance=0.3)
    ed.add_smart_mask("t", points_xy=[(20, 40), (140, 40)], labels=[1, 0])
    assert geodesic.KERNEL_LAUNCHES["geodesic_sweep_kernel"] == before + 1 + 2
    cpu = Ed.from_rgb_f32(img, device="cpu", mid_long_edge=80, low_long_edge=40)
    monkeypatch.undo()
    cpu.add_smart_mask("s", (20, 40), tolerance=0.3)
    np.testing.assert_allclose(ed._find("s").logits, cpu._find("s").logits,
                               rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="contiguous"):
        geodesic.sweep(torch.zeros((8, 6), device=dev).t(), torch.zeros((5, 8), device=dev),
                       torch.zeros((6, 7), device=dev), "down")


# -- the geometry-and-sharpen kernel (csrc/geometry.cu) ----------------------------

@pytest.mark.parametrize("h,w,extent", GEOMETRY_HW)
@pytest.mark.parametrize("distortion", GEOMETRY_DISTORTIONS)
def test_geometry_kernel_bit_identical_to_twin(dev, h, w, extent, distortion):
    """geometry_sharpen_kernel against the twin (on the CPU) at every
    sharpness: one launch a call with work, none when both sliders are 0."""
    from rawphotoforge_tpu_torch.kernels import geometry

    planes = geometry_planes(np.random.default_rng(h * 1000 + w), h, w, dev)
    host = planes.cpu()
    for sharpness in GEOMETRY_SHARPNESS:
        amount = sharpness / 100.0 * 2.0
        before = geometry.KERNEL_LAUNCHES["geometry_sharpen_kernel"]
        ours = geometry.geometry_sharpen(planes, distortion, amount, extent)
        torch.cuda.synchronize()
        work = distortion != 0.0 or sharpness != 0.0
        assert geometry.KERNEL_LAUNCHES["geometry_sharpen_kernel"] == before + work
        if not work:
            assert ours is planes
        twin = geometry.geometry_sharpen_ref(host, distortion, amount, extent)
        same_bits(ours.cpu(), twin, f"{h}x{w} extent {extent} distortion {distortion} "
                  f"sharpness {sharpness}")


@pytest.mark.parametrize("distortion,sharpness", [(40.0, 55.0), (-100.0, 5.0), (0.0, 100.0),
                                                  (100.0, 0.0)])
def test_geometry_kernel_at_45mp_equals_the_plain_chain_on_the_card(dev, distortion,
                                                                    sharpness):
    """At the north star's bucket grid (8192x5504, true 8192x5464) the kernel
    equals the plain torch chain the editor ran before it, on the card."""
    from rawphotoforge_tpu_torch.kernels import geometry

    h, w = GEOMETRY_TIME_HW
    planes = geometry_planes(np.random.default_rng(45), h, w, dev)
    ours = geometry.geometry_sharpen(planes, distortion, sharpness / 100.0 * 2.0,
                                     GEOMETRY_TIME_EXTENT)
    plain = geometry.geometry_sharpen_ref(planes, distortion, sharpness / 100.0 * 2.0,
                                          GEOMETRY_TIME_EXTENT)
    torch.cuda.synchronize()
    same_bits(ours, plain, f"45 MP distortion {distortion} sharpness {sharpness}")


def test_geometry_cuda_tensors_never_reach_the_twin(dev, monkeypatch):
    """The editor's geometry stage on the card launches the kernel once a
    cache miss with work, never the twin, and its planes equal the CPU
    editor's bit for bit."""
    from rawphotoforge_tpu_torch.engine import editor as teditor
    from rawphotoforge_tpu_torch.kernels import geometry

    def refuse(*a, **k):
        raise AssertionError("the twin ran for a CUDA tensor")

    monkeypatch.setattr(geometry, "geometry_sharpen_ref", refuse)
    img = np.random.default_rng(3).random((150, 200, 3), dtype=np.float32) ** 2
    ed = PhotoEditor.from_rgb_f32(img, device=dev, mid_long_edge=100, low_long_edge=50)
    before = geometry.KERNEL_LAUNCHES["geometry_sharpen_kernel"]
    counts = dict(teditor.COUNTS)
    misses = 0
    for d, s in ((30.0, 0.0), (30.0, 40.0), (-20.0, 40.0), (0.0, 40.0), (0.0, 0.0)):
        ed.set_lens_distortion(d)
        ed.set_sharpness(s)
        ed.apply(FULL)
        ed.apply(FULL)  # the render cache: no second geometry pass
        misses += d != 0.0 or s != 0.0
    assert geometry.KERNEL_LAUNCHES["geometry_sharpen_kernel"] == before + misses
    assert teditor.COUNTS["warps"] - counts["warps"] == 3
    assert teditor.COUNTS["unsharps"] - counts["unsharps"] == 3
    monkeypatch.undo()
    for d, s in ((-35.0, 60.0), (0.0, 25.0)):
        cpu = PhotoEditor.from_rgb_f32(img, device="cpu", mid_long_edge=100,
                                       low_long_edge=50)
        for e in (ed, cpu):
            e.set_lens_distortion(d)
            e.set_sharpness(s)
        for level in (FULL, LOW):
            same_bits(ed._geo_at(level).cpu(), cpu._geo_at(level),
                      f"editor geometry at {level}, distortion {d} sharpness {s}")


def test_server_answers_mid_preview_from_a_handler_thread_on_the_card(dev, tmp_path):
    """The interactive server on the card: a handler thread renders the MID
    preview through the develop kernel (its launch count rises) and the
    LOW drag tick renders on the host."""
    import threading
    import urllib.request

    from rawphotoforge_tpu_torch.app.server import serve
    from rawphotoforge_tpu_torch.engine.session import Settings

    rng = np.random.default_rng(11)
    ed = PhotoEditor.from_rgb_f32(rng.random((300, 450, 3), dtype=np.float32) ** 2,
                                  device=dev, mid_long_edge=200, low_long_edge=80)
    httpd = serve(ed, port=0, settings=Settings(),
                  settings_path=str(tmp_path / "s.json"), prewarm=False)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        before = fused.LAUNCHES
        with urllib.request.urlopen(base + "/preview?level=mid", timeout=120) as r:
            assert r.status == 200 and r.read()[:2] == b"\xff\xd8"
        assert fused.LAUNCHES > before
        with urllib.request.urlopen(base + "/preview?level=low", timeout=120) as r:
            assert r.headers.get("X-RPF-HostDrag") == "1"
    finally:
        httpd.shutdown()


@pytest.fixture
def nccl_world(dev, tmp_path):
    """A torch.distributed world of one rank over NCCL on the card."""
    import datetime

    import torch.distributed as dist

    if dist.is_initialized():
        pytest.skip("a process group is already initialized")
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    try:
        yield dist
    finally:
        dist.destroy_process_group()


def test_mesh_of_one_over_nccl_on_the_card(nccl_world, dev):
    """parallel/mesh on the card: the sharded kernel develop (one 'sp' rank,
    row offset 0) is the single-device kernel bit for bit, and the
    histogram through a real NCCL all_reduce is histogram_rgbl's."""
    from rawphotoforge_tpu_torch.ops.stats import histogram_rgbl
    from rawphotoforge_tpu_torch.parallel import mesh as pm

    m = pm.make_mesh(devices=dev)
    assert m.shape == {"batch": 1, "sp": 1} and m.device.type == "cuda"
    plist = _params()
    planes, masks = _inputs(dev, 512, 768, 3)
    params = pack_params(plist, extent=(512, 768), device=dev)
    before = fused.LAUNCHES
    out = pm.develop_spatial_sharded(pm.shard_rows(planes, m), params,
                                     pm.shard_rows(masks, m), m, use_kernel=True)
    assert fused.LAUNCHES == before + 1
    single = fused.develop_post_geo_fused(planes, params, masks)
    assert torch.equal(pm.gather_rows(out, m), single)
    assert torch.equal(pm.histogram_sharded(single, m), histogram_rgbl(single))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
def test_put_np_and_fetch_np_round_trip_on_the_card(dev, dtype):
    """The pinned, side-stream transfers move the bytes exactly, with and
    without bands, for whole arrays and prefixes."""
    from rawphotoforge_tpu_torch.utils import transfer

    rng = np.random.default_rng(5)
    host = (rng.random((3, 517, 771)) * 60000).astype(dtype)
    src = host.view(np.int16) if dtype == np.uint16 else host
    for bands in (None, 3):
        t = transfer.put_np(src, bands=bands, device=dev)
        assert t.device.type == "cuda"
        assert torch.equal(t.cpu(), torch.from_numpy(src))
        back = transfer.fetch_np(t, bands=bands)
        np.testing.assert_array_equal(back, src)
        np.testing.assert_array_equal(transfer.fetch_np_prefix(t, 12345),
                                      src.reshape(-1)[:12345])


def test_put_np_stages_several_bands_on_the_card(dev):
    """A 41 MB read-only u16 mosaic (as a file's parsed bytes give it, as
    its i16 bits) crosses in six 8 MB bands, bit for bit, and the caller's
    stream sees the finished upload."""
    from rawphotoforge_tpu_torch.utils import transfer

    rng = np.random.default_rng(6)
    data = rng.integers(0, 65535, (3413, 6007), dtype=np.uint16).tobytes()
    mosaic = np.frombuffer(data, dtype=np.uint16).reshape(3413, 6007)
    assert not mosaic.flags.writeable
    t = transfer.put_np(mosaic.view(np.int16), device=dev)
    total = int((t.to(torch.int64) & 0xFFFF).sum())  # on the caller's stream
    assert torch.equal(t.cpu(), torch.from_numpy(mosaic.view(np.int16).copy()))
    assert total == int(mosaic.astype(np.int64).sum())


# -- the card fuzz (tools/torch_card_fuzz.py) -------------------------------------

def test_card_fuzz_one_seed_a_part(dev):
    """Every part of the card fuzz at one seed: each kernel against its
    reference and bit for bit against its twin on random draws."""
    from chip_smoke import load_card_fuzz

    fuzz = load_card_fuzz()
    result = fuzz.run(dev, {k: 1 for k in fuzz.DEFAULT_COUNTS}, log=lambda _m: None)
    failed = {k: result[k] for k, _, _ in fuzz.PARTS if result[k]["fails"]}
    assert result["ok"], failed
    assert all(result[k]["twin_equal"] for k, _, _ in fuzz.PARTS)
