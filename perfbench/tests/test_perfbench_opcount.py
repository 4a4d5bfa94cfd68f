"""The frozen develop-kernel arithmetic equals chip_smoke.py phase 4's on
its four timed cases."""

import pytest

import chip_smoke
from benchlib import opcount

CASES = {
    # name: (flags, number of regional edits)
    "full_stack": (dict(main_mask_all_ones=True), 0),
    "slider_only": (dict(main_mask_all_ones=True, default_bright_curves=True,
                         default_oklch_curves=True, identity_oklch=True), 0),
    "tone_curve_drag": (dict(main_mask_all_ones=True, default_oklch_curves=True,
                             identity_oklch=True), 0),
    "m4_regional": (None, 3),
}


def _case(name):
    from rawphotoforge_tpu_torch.core.params import (
        BRIGHTNESS, EditParameters, default_curve_slots, pack_params)
    from rawphotoforge_tpu_torch.kernels import fused

    flags, regions = CASES[name]
    if name == "full_stack" or name == "m4_regional":
        p = EditParameters()
        chip_smoke.bench_edit(p)
    else:
        p = EditParameters()
        p.set_tone(exposure=0.7, contrast=25)
        p.set_vignette(40)
        if name == "tone_curve_drag":
            p.set_curve(BRIGHTNESS, [0, 16000, 40000, 65535], [1000, 20000, 46000, 65535])
    plist = [p, *chip_smoke.regional_edits()[:regions]]
    if flags is None:
        flags = dict(main_mask_all_ones=True, default_curve_slots=default_curve_slots(plist))
    s = pack_params(plist, build_luts=False, device="cpu").breaks.shape[-1]
    slots = fused._slot_table(len(plist), flags.get("default_bright_curves", False),
                              flags.get("default_oklch_curves", False),
                              flags.get("default_curve_slots"))
    return len(plist), s, slots, flags.get("identity_oklch", False)


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_count_equals_phase_4(name):
    m, s, slots, identity = _case(name)
    coverage = [1.0, 0.31, 0.22, 0.13][:m]
    assert opcount.op_count(m, s, slots, identity, coverage, 1) == \
        chip_smoke.op_count(m, s, slots, identity, coverage, 1)


@pytest.mark.parametrize("name", sorted(CASES))
def test_bytes_equal_phase_4(name):
    m, s, _, _ = _case(name)
    hb, wb = chip_smoke.BUCKET_HW
    hw = hb * wb
    main_only = m == 1
    # chip_smoke.phase_timing's byte count, as it writes it.
    phase4 = 24 * hw + (0 if main_only else m * hw) + 4 * (4 + 11 * m + 20 * m * s)
    assert opcount.develop_bytes(m, s, hw, main_only) == phase4


def test_least_time_takes_the_larger_bound():
    work = dict(m=4, s=8, slots=[(False,) * 4] * 4, identity=False,
                coverage=[1.0, 0.35, 0.18, 0.06], vignette_on=1, hw=8192 * 5504)
    t, by = opcount.develop_least_seconds(work)
    ops = opcount.op_count(4, 8, work["slots"], False, work["coverage"], 1) * work["hw"]
    assert by == "ops" and t == pytest.approx(ops / 67e12)
