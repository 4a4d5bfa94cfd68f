"""The fused develop kernel — CUDA C++ for Hopper — and its plain twin.

Replaces the JAX package's Pallas kernel ``kernels/fused.py:_develop_kernel``
(wrapper ``develop_post_geo_fused``, body ``edit_stack``): vignette ->
per-mask (WB -> tone -> brightness curve) -> per-mask OKLCH hue/sat/light
-> sRGB encode, one pass over the post-geometry planes. The CUDA source is
``csrc/develop.cu`` with the per-pixel stack in ``csrc/edit_stack.cuh``
(shared with the RAW kernel of a later slice) and the polynomial trig in
``csrc/ktrig.cuh``.

Bound on the H100: bytes. A 24 MP frame (bucket-padded to 4096x6016 =
24.64 Mpx) reads 12 B/px of f32 planes and writes 12 B/px: 591 MB, about
0.18 ms at 3.35 TB/s; four u8 mask rows add 4 B/px (690 MB, ~0.21 ms).

Design: one thread per pixel in a grid-stride loop over the row-major
image, so every plane, mask and output access is coalesced; the small
tables (gains, tone, channel, slot bits, knots, coefficients, vignette)
are packed by the wrapper into one device buffer and staged in shared
memory once per block, where each curve segment is a uniform (broadcast)
read. Curves are evaluated exactly as the Pallas kernel does: select the
active packed-PCHIP segment, then Horner, with the index clamp before and
the truncating clamp after. M, S, H, W and the per-mask default-slot bits
are runtime values; templates cover only ``identity_oklch`` and the mask
dtype (u8 or f32). No faster design (exact u16 LUT gathers, TMA tiling)
is attempted here.

``develop_post_geo_fused`` takes the twin for a CPU tensor and the kernel
for a CUDA tensor; there is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from ..core import color
from ..core.numerics import div
from ..core.params import DevelopParams
from ..ops import pointwise
from . import ktrig

LUT_MAX = 65535.0

# Kernel launches since the count was last set to 0 (the twin never
# counts): lets a run show that the main path went through the kernel.
LAUNCHES = 0
# Build record of the loaded library (kernels/cuda_build.build), or None.
BUILD = None
_LIB = None

# Per-mask default-slot bits, in the order of default_curve_slots.
_SLOT_BITS = (1, 2, 4, 8)  # bright, hue, sat, light


def pack_curve_tables(params: DevelopParams, m: int, s: int):
    """knots [m*4, s] (sorted positions, padded with 2*65536) and coeffs
    [m*4, s*4] (the raw per-segment monomial coefficients) — the table
    convention of both the twin and the CUDA kernel."""
    knots = params.breaks.reshape(m * 4, s)
    coeffs = params.coeffs.reshape(m * 4, s * 4)
    return knots, coeffs


def _eval_curve(u, knots, coeffs, row, num_seg):
    """Selected packed-PCHIP evaluation at LUT-domain positions ``u``: per
    segment one compare and five selects, then one Horner evaluation of
    the selected segment's own coefficients (exact selection; the
    telescoped-delta form lost up to 168 LUT units to cancellation)."""
    u = torch.maximum(u, knots[row, 0])
    a = coeffs[row, 0].expand(u.shape)
    b = coeffs[row, 1].expand(u.shape)
    c = coeffs[row, 2].expand(u.shape)
    d = coeffs[row, 3].expand(u.shape)
    x0 = knots[row, 0].expand(u.shape)
    for j in range(1, num_seg):
        w = u >= knots[row, j]
        a = torch.where(w, coeffs[row, j * 4 + 0], a)
        b = torch.where(w, coeffs[row, j * 4 + 1], b)
        c = torch.where(w, coeffs[row, j * 4 + 2], c)
        d = torch.where(w, coeffs[row, j * 4 + 3], d)
        x0 = torch.where(w, knots[row, j], x0)
    dt = u - x0
    return a + dt * (b + dt * (c + dt * d))


def _staircase(v):
    """floor(v*65535) clamped to the table, as a fraction of 65535."""
    return div(torch.clamp(torch.floor(v * LUT_MAX), 0.0, LUT_MAX), LUT_MAX)


def _quantized_curve(v, knots, coeffs, row, num_seg, denom):
    """LUT-semantics curve application: index floor(v*65535) clamped to
    [0, 65535] BEFORE evaluation (a negative input reads the curve at its
    first knot, as the table does), then truncate+clamp the result like
    the i32 table and rescale by ``denom`` (65535, or 32767.5 for the
    sat/light gains, wgsl:329-330)."""
    u = torch.clamp(torch.floor(v * LUT_MAX), 0.0, LUT_MAX)
    y = _eval_curve(u, knots, coeffs, row, num_seg)
    y = torch.clamp(torch.floor(y), 0.0, 65535.0)
    return div(y, denom)


def edit_stack(r, g, b, sel_for, gains, tone, chan, knots, coeffs,
               num_masks, num_seg, identity_oklch, slot_default):
    """The per-mask edit stack (wgpu_shader.wgsl:279-336) on planar
    tensors: (WB -> tone -> brightness curve) per mask, the per-mask OKLCH
    hue/sat/light pass, then the sRGB encode. ``sel_for(k)`` is None
    (unconditional) or mask k's boolean selection; ``slot_default(k, slot)``
    says whether mask k's curve in ``slot`` takes the default-curve
    shortcut, bit-identical to evaluating the default curve."""

    def bright_chain(k, r_, g_, b_):
        r_, g_, b_ = pointwise.white_balance(r_, g_, b_, gains[k])
        r_, g_, b_ = pointwise.tone(r_, g_, b_, tone[k])
        if slot_default(k, 0):
            rc, gc, bc = _staircase(r_), _staircase(g_), _staircase(b_)
        else:
            rc, gc, bc = (_quantized_curve(v, knots, coeffs, k * 4, num_seg,
                                           LUT_MAX) for v in (r_, g_, b_))
        ch = chan[k]
        return (torch.where((ch == 0) | (ch == 3), rc, r_),
                torch.where((ch == 1) | (ch == 3), gc, g_),
                torch.where((ch == 2) | (ch == 3), bc, b_))

    for k in range(num_masks):
        sel = sel_for(k)
        rk, gk, bk = bright_chain(k, r, g, b)
        if sel is None:
            r, g, b = rk, gk, bk
        else:
            r = torch.where(sel, rk, r)
            g = torch.where(sel, gk, g)
            b = torch.where(sel, bk, b)

    if identity_oklch:
        # Default hue/sat/light curves only quantize H to 1/65536 and scale
        # C and L by 32767/32767.5: skipping the round trip deviates
        # <= ~2e-3 after the encode (documented 3e-3 bound).
        return (torch.clamp(color.linear_to_srgb(r), 0.0, 1.0),
                torch.clamp(color.linear_to_srgb(g), 0.0, 1.0),
                torch.clamp(color.linear_to_srgb(b), 0.0, 1.0))
    L, C, H = color.linear_srgb_to_oklch(r, g, b, atan2_turns=ktrig.atan2_turns)
    # Same f32 division the general path computes for a default curve.
    default_gain = torch.tensor(32767.0) / torch.tensor(32767.5)
    default_gain = default_gain.to(r.device)

    for k in range(num_masks):
        sel = sel_for(k)
        new_h = (_staircase(H) if slot_default(k, 1) else
                 _quantized_curve(H, knots, coeffs, k * 4 + 1, num_seg, LUT_MAX))
        sat_g = (default_gain if slot_default(k, 2) else
                 _quantized_curve(H, knots, coeffs, k * 4 + 2, num_seg, 32767.5))
        light_g = (default_gain if slot_default(k, 3) else
                   _quantized_curve(H, knots, coeffs, k * 4 + 3, num_seg, 32767.5))
        if sel is None:
            H, C, L = new_h, C * sat_g, L * light_g
        else:
            H = torch.where(sel, new_h, H)
            C = torch.where(sel, C * sat_g, C)
            L = torch.where(sel, L * light_g, L)
    r, g, b = color.oklch_to_linear_srgb(L, C, H, sincos_turns=ktrig.sincos_turns)
    return (torch.clamp(color.linear_to_srgb(r), 0.0, 1.0),
            torch.clamp(color.linear_to_srgb(g), 0.0, 1.0),
            torch.clamp(color.linear_to_srgb(b), 0.0, 1.0))


def _validate(planes, params, masks, main_mask_all_ones, default_oklch_curves,
              identity_oklch, default_curve_slots):
    """The Pallas wrapper's argument checks (same ValueErrors). Returns
    (m, main_only)."""
    if planes.ndim != 3 or planes.shape[0] != 3:
        raise ValueError(f"expected planes [3, H, W], got {tuple(planes.shape)}")
    if masks is None:
        if not main_mask_all_ones:
            raise ValueError(
                "masks=None requires main_mask_all_ones=True (the all-ones "
                "main mask is what justifies eliding the mask array)")
        m = params.gains.shape[0]
        if m != 1:
            raise ValueError(f"masks=None requires a single mask, got {m}")
    else:
        m = masks.shape[0]
        if m != params.gains.shape[0]:
            # A stale mask stack would mis-render with no exception.
            raise ValueError(
                f"masks rows ({m}) != packed mask count "
                f"({params.gains.shape[0]})")
        if tuple(masks.shape[1:]) != tuple(planes.shape[1:]):
            raise ValueError(f"masks shape {tuple(masks.shape)} does not "
                             f"match planes {tuple(planes.shape)}")
    if identity_oklch and not default_oklch_curves:
        # Skipping the OKLCH pass with real curves would drop the edit.
        raise ValueError("identity_oklch requires default_oklch_curves=True")
    if default_curve_slots is not None:
        if len(default_curve_slots) != m or any(
                len(sl) != 4 for sl in default_curve_slots):
            raise ValueError(
                f"default_curve_slots needs {m} (bright, hue, sat, light) "
                f"tuples, got {default_curve_slots!r}")
    return m, main_mask_all_ones and m == 1


def _slot_table(m, default_bright_curves, default_oklch_curves,
                default_curve_slots):
    """Per-mask (bright, hue, sat, light) shortcut booleans: the global
    flags are the all-mask shorthand of the per-mask slot table."""
    out = []
    for k in range(m):
        sl = (default_curve_slots[k] if default_curve_slots is not None
              else (False,) * 4)
        out.append((bool(sl[0]) or default_bright_curves,
                    bool(sl[1]) or default_oklch_curves,
                    bool(sl[2]) or default_oklch_curves,
                    bool(sl[3]) or default_oklch_curves))
    return out


def develop_post_geo_fused_ref(
    planes: torch.Tensor,
    params: DevelopParams,
    masks: torch.Tensor | None,
    main_mask_all_ones: bool = False,
    default_bright_curves: bool = False,
    default_oklch_curves: bool = False,
    identity_oklch: bool = False,
    row_offset=None,
    default_curve_slots: tuple | None = None,
) -> torch.Tensor:
    """The plain torch twin of the CUDA kernel: the same packed-PCHIP math
    and flags on whole planes, on any device. The CPU path of
    ``develop_post_geo_fused`` and the reference the kernel is held to."""
    m, main_only = _validate(planes, params, masks, main_mask_all_ones,
                             default_oklch_curves, identity_oklch,
                             default_curve_slots)
    _, h, w = planes.shape
    dev = planes.device
    s = params.breaks.shape[-1]
    knots, coeffs = pack_curve_tables(params, m, s)
    slots = _slot_table(m, default_bright_curves, default_oklch_curves,
                        default_curve_slots)
    off = torch.as_tensor(0.0 if row_offset is None else row_offset,
                          dtype=torch.float32, device=dev)
    ys = torch.arange(h, dtype=torch.int32, device=dev)[:, None].to(
        torch.float32) + off
    xs = torch.arange(w, dtype=torch.int32, device=dev)[None, :]
    hf = torch.where(params.extent[0] > 0, params.extent[0],
                     torch.tensor(float(h), device=dev))
    wf = torch.where(params.extent[1] > 0, params.extent[1],
                     torch.tensor(float(w), device=dev))
    r, g, b = pointwise.vignette(planes[0], planes[1], planes[2],
                                 params.vignette, hf, wf, ys, xs)

    def sel_for(k):
        return None if (k == 0 and main_only) else masks[k] != 0

    r, g, b = edit_stack(
        r, g, b, sel_for, params.gains, params.tone,
        params.bright_channel.to(torch.float32), knots, coeffs, m, s,
        identity_oklch, lambda k, slot: slots[k][slot])
    return torch.stack([r, g, b])


def library():
    """The built and loaded kernel library (built at the first call)."""
    global _LIB, BUILD
    if _LIB is None:
        from .cuda_build import build

        lib, BUILD = build("rpf_develop", "develop.cu")
        fn = lib.rpf_develop_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


# Shared memory a block may use on Hopper (hopper-kernels guide, 227 KB).
_MAX_SMEM_BYTES = 232448


def pack_table(params: DevelopParams, m: int, s: int, slots, row_offset,
               device) -> torch.Tensor:
    """The kernel's one small f32 table, in ``csrc/develop.cu`` order:
    [vignette, true_h, true_w, row_offset] [slot bits M] [gains 3M]
    [tone 6M] [channel M] [knots 4MS] [coeffs 16MS]."""
    bits = [float(sum(bit for bit, on in zip(_SLOT_BITS, sl) if on))
            for sl in slots]
    off = torch.as_tensor(0.0 if row_offset is None else row_offset,
                          dtype=torch.float32, device=device).reshape(1)
    knots, coeffs = pack_curve_tables(params, m, s)
    return torch.cat([
        params.vignette.reshape(1), params.extent.reshape(2), off,
        torch.tensor(bits, dtype=torch.float32, device=device),
        params.gains.reshape(-1), params.tone.reshape(-1),
        params.bright_channel.to(torch.float32).reshape(-1),
        knots.reshape(-1), coeffs.reshape(-1),
    ]).to(torch.float32).contiguous()


def _launch(planes, params, masks, m, main_only, slots, identity_oklch,
            row_offset):
    global LAUNCHES
    dev = planes.device
    if planes.dtype != torch.float32:
        raise ValueError(f"planes must be float32, got {planes.dtype}")
    planes = planes.contiguous()
    _, h, w = planes.shape
    s = params.breaks.shape[-1]
    table = pack_table(params, m, s, slots, row_offset, dev)
    if table.numel() * 4 > _MAX_SMEM_BYTES:
        raise ValueError(f"{m} masks with {s}-segment curves need "
                         f"{table.numel() * 4} B of tables, over the "
                         f"{_MAX_SMEM_BYTES} B of shared memory a block has")
    if main_only or masks is None:
        mask_kind, mask_ptr = 0, None
    else:
        if masks.device != dev:
            raise ValueError("masks must be on the planes' device")
        if masks.dtype == torch.bool:
            masks = masks.view(torch.uint8)
        if masks.dtype == torch.uint8:
            mask_kind = 1
        elif masks.dtype == torch.float32:
            mask_kind = 2
        else:
            raise ValueError(f"masks must be u8, bool or f32, got {masks.dtype}")
        masks = masks.contiguous()
        mask_ptr = masks.data_ptr()
    out = torch.empty_like(planes)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = library().rpf_develop_launch(
            planes.data_ptr(), mask_ptr, mask_kind, table.data_ptr(),
            table.numel(), out.data_ptr(), m, s, h, w, int(main_only),
            int(identity_oklch), sms * 8, stream)
    if err != 0:
        raise RuntimeError(f"develop kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


def develop_post_geo_fused(
    planes: torch.Tensor,
    params: DevelopParams,
    masks: torch.Tensor | None,
    main_mask_all_ones: bool = False,
    default_bright_curves: bool = False,
    default_oklch_curves: bool = False,
    identity_oklch: bool = False,
    row_offset=None,
    default_curve_slots: tuple | None = None,
) -> torch.Tensor:
    """Fused develop of post-geometry planes: f32 [3, H, W] linear image,
    masks [M, H, W] (u8, bool or f32; a mask applies where non-zero) ->
    sRGB-encoded f32 [3, H, W] in [0, 1]. Flags as the JAX package's
    ``develop_post_geo_fused``:

    ``main_mask_all_ones``: caller-asserted invariant that mask row 0 is
    all ones; with a single mask the mask array is not read (and may be
    ``None``).
    ``default_bright_curves`` / ``default_oklch_curves``: every mask's
    brightness curve, respectively hue/sat/light curves, are the defaults;
    their evaluations reduce to the floor staircase / a constant gain,
    bit-identical to evaluating the default curves.
    ``identity_oklch`` (requires ``default_oklch_curves``): also skip the
    OKLCH round trip — NOT bit-identical, <= 3e-3 from the full path.
    ``row_offset``: global row index of the first row (vignette coords).
    ``default_curve_slots``: per-mask (bright, hue, sat, light) shortcut
    booleans, bit-identical like the global flags.

    A CPU tensor runs the plain twin; a CUDA tensor launches the kernel
    (or raises). The kernel counts its launches in ``LAUNCHES``.
    """
    m, main_only = _validate(planes, params, masks, main_mask_all_ones,
                             default_oklch_curves, identity_oklch,
                             default_curve_slots)
    if planes.device.type == "cpu":
        return develop_post_geo_fused_ref(
            planes, params, masks, main_mask_all_ones, default_bright_curves,
            default_oklch_curves, identity_oklch, row_offset,
            default_curve_slots)
    if planes.device.type != "cuda":
        raise ValueError(f"no develop kernel for device {planes.device}")
    slots = _slot_table(m, default_bright_curves, default_oklch_curves,
                        default_curve_slots)
    return _launch(planes, params, masks, m, main_only, slots,
                   identity_oklch, row_offset)
