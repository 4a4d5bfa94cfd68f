"""The comparison: a near-neutral pixel's gap counts only in ``share_off``,
a chromatic pixel's in both numbers."""

import torch

from benchlib import check


def _image():
    img = torch.full((3, 4, 5), 0.5)
    img[:, 0, 0] = torch.tensor([0.8, 0.3, 0.2])   # chromatic
    return img


def test_chroma_of_gray_is_nought_and_of_a_colour_is_not():
    c = check.chroma(_image())
    assert float(c[1, 1]) < 1e-4
    assert float(c[0, 0]) > 0.05


def test_a_gap_on_a_chromatic_pixel_is_max_gap():
    ref = _image()
    prog = ref.clone()
    prog[1, 0, 0] += 0.01
    g = check.gaps(prog, ref)
    assert abs(g["max_gap"] - 0.01) < 1e-6 and g["share_off"] == 1 / ref.numel()


def test_a_gap_on_a_neutral_pixel_counts_only_in_share_off():
    ref = _image()
    prog = ref.clone()
    prog[0, 2, 3] += 0.3
    g = check.gaps(prog, ref)
    assert g["max_gap"] == 0.0
    assert g["share_off"] == 1 / ref.numel()
    assert abs(g["max_gap_all"] - 0.3) < 1e-6
    assert g["neutral_share"] == 19 / 20


def test_nan_and_a_wrong_shape_fail():
    ref = _image()
    prog = ref.clone()
    prog[2, 3, 4] = float("nan")
    assert check.gaps(prog, ref)["max_gap"] == float("inf")
    assert check.gaps(ref[:, :3], ref)["max_gap"] == float("inf")
