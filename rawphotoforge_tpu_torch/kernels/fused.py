"""The fused develop kernel — CUDA C++ for Hopper — and its plain twin.

Replaces the JAX package's Pallas kernel ``kernels/fused.py:_develop_kernel``
(wrapper ``develop_post_geo_fused``, body ``edit_stack``): vignette ->
per-mask (WB -> tone -> brightness curve) -> per-mask OKLCH hue/sat/light
-> sRGB encode, one pass over the post-geometry planes. The CUDA source is
``csrc/develop.cu`` with the per-pixel stack in ``csrc/edit_stack.cuh``
(shared with the RAW kernel of a later slice) and the polynomial trig in
``csrc/ktrig.cuh``.

Bound on the H100: bytes on paper. A 24 MP frame (bucket-padded to
4096x6016 = 24.64 Mpx) reads 12 B/px of f32 planes and writes 12 B/px:
591 MB, about 0.18 ms at 3.35 TB/s; four u8 mask rows add 4 B/px (690 MB,
~0.21 ms). The exact per-pixel arithmetic is what sets the time.

Design: a 2-D grid of 32x8-thread blocks, one wave of them; each thread
owns 4 consecutive pixels of a row (16-byte vector loads and stores, one
4-byte load per u8 mask row, mask rows as per-pixel bits) and walks down
the rows, so the vignette's column terms are computed once per thread and
its row term once per row. The small tables (gains, tone, channel, slot
bits, knots, coefficients, vignette) are packed by the wrapper into one
device buffer and staged in shared memory once per block. Curves are
evaluated as the Pallas kernel does — the active packed-PCHIP segment
(found by a binary search of the sorted knots; the twin selects it with a
compare chain), then Horner, with the index clamp before and the
truncating clamp after — and their rescale by 65535 or 32767.5 is a
multiply with one residual correction, equal to the IEEE quotient on all
65536 whole inputs. The sRGB OETF takes x^(1/2.4) as exp2(log2(x)/2.4)
(``kernels/ktrig.srgb_oetf``); the OKLab cube root stays ``powf``. M,
S, H, W and the per-mask default-slot bits (``DevelopParams.default_slots``)
are runtime values; templates cover only the OKLCH skip and the mask dtype
(u8 or f32).

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
from ..utils.profiling import span
from . import ktrig

LUT_MAX = 65535.0

# Kernel launches since the count was last set to 0 (the twin never
# counts): lets a run show that the main path went through the kernel.
LAUNCHES = 0
# Build record of the loaded library (kernels/cuda_build.build), or None.
BUILD = None
_LIB = None

# Per-mask default-slot bits, in the order of DevelopParams.default_slots.
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


def _encode(c):
    """The edit stack's store: the OETF clamped to [0, 1]."""
    return torch.clamp(ktrig.srgb_oetf(c), 0.0, 1.0)


def edit_stack(r, g, b, sel_for, gains, tone, chan, knots, coeffs,
               num_masks, num_seg, identity_oklch, slot_default):
    """The per-mask edit stack (wgpu_shader.wgsl:279-336) on planar
    tensors: (WB -> tone -> brightness curve) per mask, the per-mask OKLCH
    hue/sat/light pass, then the sRGB encode by ``kernels/ktrig.srgb_oetf``
    (the anchor, ``ops/develop``, keeps ``torch.pow``; the two agree within
    ``assert_close``). ``sel_for(k)`` is None
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
        return _encode(r), _encode(g), _encode(b)
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
    return _encode(r), _encode(g), _encode(b)


def _validate(planes, params, masks):
    """The Pallas wrapper's argument checks (same ValueErrors). Returns
    (m, main_only): ``masks=None`` states that the one mask is the all-ones
    main mask, whose array is then never read."""
    if planes.ndim != 3 or planes.shape[0] != 3:
        raise ValueError(f"expected planes [3, H, W], got {tuple(planes.shape)}")
    if masks is None:
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
    return m, masks is None


def skips_oklch(params: DevelopParams, identity_oklch: bool) -> bool:
    """Whether a launch skips the OKLCH round trip: the caller permits it
    (``identity_oklch``) and every mask's hue, saturation and lightness
    curves are the defaults by ``params.default_slots``. Skipping them
    with a real curve would drop the edit."""
    return bool(identity_oklch) and all(
        sl[1] and sl[2] and sl[3] for sl in params.default_slots)


def _slot_table(m, default_bright_curves, default_oklch_curves,
                default_curve_slots):
    """Per-mask (bright, hue, sat, light) shortcut booleans from all-mask
    flags merged with a per-mask slot table (``None``: all False). The
    kernels read ``DevelopParams.default_slots`` instead; the frozen op
    counts (``perfbench/benchlib/opcount.py``) are tested through this."""
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
    identity_oklch: bool = False,
    row_offset=None,
) -> torch.Tensor:
    """The plain torch twin of the CUDA kernel: the same packed-PCHIP math
    and shortcuts on whole planes, on any device. The CPU path of
    ``develop_post_geo_fused`` and the reference the kernel is held to."""
    m, main_only = _validate(planes, params, masks)
    _, h, w = planes.shape
    dev = planes.device
    s = params.breaks.shape[-1]
    knots, coeffs = pack_curve_tables(params, m, s)
    slots = params.default_slots
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
        skips_oklch(params, identity_oklch), lambda k, slot: slots[k][slot])
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
        dfn = lib.rpf_develop_device_fn
        dfn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                        ctypes.c_longlong, ctypes.c_void_p]
        dfn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


# Shared memory a block may use on Hopper (hopper-kernels guide, 227 KB).
_MAX_SMEM_BYTES = 232448


def check_segments(s: int) -> None:
    """The kernels binary-search a curve row of S segments: S must be a
    power of two, as ``pack_params`` pads it."""
    if s < 1 or s & (s - 1):
        raise ValueError(f"curve rows need a power-of-two segment count, got {s}")


def host_floats(values, device) -> torch.Tensor:
    """Numbers known on the host as an f32 tensor on ``device``, copied
    without waiting for the work queued on the card: a blocking copy would
    hold each launch's table packing until the previous kernel is done."""
    return torch.tensor(values, dtype=torch.float32).to(device, non_blocking=True)


def pack_table(params: DevelopParams, m: int, s: int, slots, row_offset,
               device) -> torch.Tensor:
    """The kernel's one small f32 table, in ``csrc/develop.cu`` order:
    [vignette, true_h, true_w, row_offset] [slot bits M] [gains 3M]
    [tone 6M] [channel M] [knots 4MS] [coeffs 16MS]."""
    bits = [float(sum(bit for bit, on in zip(_SLOT_BITS, sl) if on))
            for sl in slots]
    if isinstance(row_offset, torch.Tensor):
        off = row_offset.to(device=device, dtype=torch.float32).reshape(1)
    else:
        off = host_floats([0.0 if row_offset is None else row_offset], device)
    knots, coeffs = pack_curve_tables(params, m, s)
    return torch.cat([
        params.vignette.reshape(1), params.extent.reshape(2), off,
        host_floats(bits, device),
        params.gains.reshape(-1), params.tone.reshape(-1),
        params.bright_channel.to(torch.float32).reshape(-1),
        knots.reshape(-1), coeffs.reshape(-1),
    ]).to(torch.float32).contiguous()


def _launch(planes, params, masks, m, main_only, identity_oklch, row_offset):
    global LAUNCHES
    dev = planes.device
    if planes.dtype != torch.float32:
        raise ValueError(f"planes must be float32, got {planes.dtype}")
    planes = planes.contiguous()
    _, h, w = planes.shape
    s = params.breaks.shape[-1]
    check_segments(s)
    with span("develop.table"):
        table = pack_table(params, m, s, params.default_slots, row_offset,
                           dev)
    # The kernel stages the table with up to 3 floats of alignment padding.
    if (table.numel() + 3) * 4 > _MAX_SMEM_BYTES:
        raise ValueError(f"{m} masks with {s}-segment curves need "
                         f"{(table.numel() + 3) * 4} B of tables, over the "
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
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = library().rpf_develop_launch(
            planes.data_ptr(), mask_ptr, mask_kind, table.data_ptr(),
            table.numel(), out.data_ptr(), m, s, h, w, int(main_only),
            int(skips_oklch(params, identity_oklch)), 0, stream)
    if err != 0:
        raise RuntimeError(f"develop kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


# The kernel library's device functions for the exhaustive checks.
DEVICE_FNS = {"cbrt_pow": 0, "srgb_oetf": 1, "div_65535": 2, "div_32767_5": 3}


def device_fn(name: str, x: torch.Tensor) -> torch.Tensor:
    """One of the edit stack's device functions (``DEVICE_FNS``: the OKLab
    cube root, the OETF, the divisions by a constant) applied to every
    element of the f32 CUDA tensor ``x``: what the exhaustive checks hold
    against the torch twins. Not a launch of the develop kernel
    (``LAUNCHES`` does not count it)."""
    if x.device.type != "cuda" or x.dtype != torch.float32:
        raise ValueError("device_fn takes an f32 CUDA tensor")
    x = x.contiguous()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = library().rpf_develop_device_fn(
            DEVICE_FNS[name], x.data_ptr(), out.data_ptr(), x.numel(),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"device function {name} failed: CUDA error {err}")
    return out


def develop_post_geo_fused(
    planes: torch.Tensor,
    params: DevelopParams,
    masks: torch.Tensor | None,
    identity_oklch: bool = False,
    row_offset=None,
) -> torch.Tensor:
    """Fused develop of post-geometry planes: f32 [3, H, W] linear image,
    masks [M, H, W] (u8, bool or f32; a mask applies where non-zero) ->
    sRGB-encoded f32 [3, H, W] in [0, 1].

    ``masks=None``: the one mask is the all-ones main mask, and no mask
    array is read.
    Each mask's default curves (``params.default_slots``, set by
    ``pack_params``) take their shortcuts, the floor staircase or a
    constant gain, bit-identical to evaluating the default curves.
    ``identity_oklch``: permits skipping the OKLCH round trip when every
    mask's hue/sat/light curves are the defaults — NOT bit-identical,
    <= 3e-3 from the full path (``skips_oklch``).
    ``row_offset``: global row index of the first row (vignette coords).

    A CPU tensor runs the plain twin; a CUDA tensor launches the kernel
    (or raises). The kernel counts its launches in ``LAUNCHES``.
    """
    m, main_only = _validate(planes, params, masks)
    if planes.device.type == "cpu":
        return develop_post_geo_fused_ref(planes, params, masks,
                                          identity_oklch, row_offset)
    if planes.device.type != "cuda":
        raise ValueError(f"no develop kernel for device {planes.device}")
    with span("develop.launch"):
        return _launch(planes, params, masks, m, main_only, identity_oklch,
                       row_offset)
