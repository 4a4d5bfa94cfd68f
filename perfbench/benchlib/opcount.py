"""The H100's published peaks and the develop kernel's least work.

Peaks: NVIDIA's H100 SXM data sheet, 67 TFLOP/s in float32 outside the
tensor cores and 3.35 TB/s of HBM3, at the full 700 W power limit.

The operation and byte counts are those of the develop-kernel timing of
the port's ``chip_smoke.py`` (phase 4), frozen here so that the same edit
is counted the same way whatever implements it: they depend only on the
edit (masks M, curve segments S, which curves are defaults, how much of
the frame each mask covers, whether the vignette is on) and the frame.
"""

from __future__ import annotations

PEAK_F32_S = 67e12
PEAK_BYTES_S = 3.35e12


def op_count(m, s, slots, identity, coverage, vignette_on):
    """f32 operations of the develop stack per pixel, summed over the
    frame's masks: each add/sub/mul/div/compare/select/min/max/floor/sqrt/
    pow/exp2 counts as one (transcendentals at the f32 rate, a generous
    bound). A mask's chain runs only where it is selected: ``coverage[k]``
    is the selected share of the frame. ``slots[k]``: whether mask k's
    (brightness, hue, saturation, lightness) curves are the defaults."""
    curve = 16 + 6 * (s - 1)   # index, segment selects, Horner, truncate
    stair = 5
    ops = 26 * vignette_on + 4 * m   # vignette; mask tests
    for k in range(m):
        bright = 3 + 58 + 3 * (stair if slots[k][0] else curve) + 6
        ops += coverage[k] * bright
    if identity:
        return ops + 27                 # OETF x3 + clamps
    ops += 81                           # to OKLCH: 2 matrices, 3 cbrt, atan2
    for k in range(m):
        per = (stair if slots[k][1] else curve) + sum(
            0 if slots[k][j] else curve for j in (2, 3)) + 2
        ops += coverage[k] * per
    return ops + 77 + 27                # back from OKLCH; OETF + clamps


def develop_bytes(m, s, hw, main_only):
    """Bytes the kernel must move for one frame of ``hw`` pixels: the f32
    planes read and written, one u8 mask row per mask (none when the main
    mask is alone), and the packed edit table."""
    return 24 * hw + (0 if main_only else m * hw) + 4 * (4 + 11 * m + 20 * m * s)


def develop_least_seconds(work: dict) -> tuple[float, str]:
    """The least time one develop launch can take on the H100, and what
    bounds it (``"ops"`` or ``"bytes"``). ``work``: ``m``, ``s``, ``slots``,
    ``identity``, ``coverage``, ``vignette_on``, ``hw``."""
    ops = op_count(work["m"], work["s"], work["slots"], work["identity"],
                   work["coverage"], work["vignette_on"]) * work["hw"]
    nbytes = develop_bytes(work["m"], work["s"], work["hw"], work["m"] == 1)
    t_ops, t_bytes = ops / PEAK_F32_S, nbytes / PEAK_BYTES_S
    return (t_ops, "ops") if t_ops >= t_bytes else (t_bytes, "bytes")
