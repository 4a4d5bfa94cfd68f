"""The geodesic flood's kernel — CUDA C++ for Hopper — and its plain twin.

Replaces the ``lax.scan`` sweeps of the JAX package's
``ops/masking.py:123-199`` (``_sweep_down`` and ``geodesic_distance``'s
rounds; jnp, no Pallas kernel). The CUDA source is ``csrc/geodesic.cu``, one
kernel, ``geodesic_sweep_kernel``: directional relaxations of a distance map
``d`` f32 [H, W] in place, ``d[y] = min(d[y], d[y-1] + c)`` down, and
likewise up, right and left, over the unpadded step costs ``gv`` f32
[H-1, W] (vertical neighbours) and ``gh`` f32 [H, W-1] (horizontal).
``flood`` runs ``sweeps`` rounds of the four directions in one launch (a
thread walks each column down and back up, then each row right and back
left, with a grid-wide barrier between the two); ``sweep`` runs one
direction through the same kernel. The kernel reads rows ``pitch(W)``
floats apart (16-byte aligned): ``ops/masking`` builds ``d``, ``gv`` and
``gh`` so (``pitched_empty``); other arrays go through padded copies.

Bound on the H100: the dependent chain (2 (H - 1) + 2 (W - 1) add+min steps
a round, serial), not bytes (16 B/px a flood).

The wrapper takes the twin for a CPU tensor and the kernel for a CUDA
tensor; there is no fallback from one to the other. Each launch counts in
``KERNEL_LAUNCHES``; the twin never counts.
"""

from __future__ import annotations

import ctypes

import torch

# Kernel launches since the count was last set to 0.
KERNEL_LAUNCHES = {"geodesic_sweep_kernel": 0}
# Build record of the loaded library (kernels/cuda_build.build), or None.
BUILD = None
_LIB = None

# Sweep directions in a round's order (the JAX package's one_round).
DIRECTIONS = ("down", "up", "right", "left")


def library():
    """The built and loaded kernel library (built at the first call)."""
    global _LIB, BUILD
    if _LIB is None:
        from .cuda_build import build

        lib, BUILD = build("rpf_geodesic", "geodesic.cu")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rpf_geodesic_flood_launch.argtypes = [p, p, p, i, i, i, i, i, p, p]
        lib.rpf_geodesic_flood_launch.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check_inputs(d, gv, gh):
    if d.ndim != 2:
        raise ValueError(f"expected d [H, W], got {tuple(d.shape)}")
    h, w = d.shape
    if tuple(gv.shape) != (h - 1, w) or tuple(gh.shape) != (h, w - 1):
        raise ValueError(f"step costs {tuple(gv.shape)} / {tuple(gh.shape)} do "
                         f"not fit d {h}x{w} (want {(h - 1, w)} / {(h, w - 1)})")
    for name, t in (("d", d), ("gv", gv), ("gh", gh)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if t.device != d.device:
            raise ValueError(f"{name} on {t.device}, d on {d.device}")
    if d.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no geodesic sweep kernel for device {d.device}")


def sweep_ref(d: torch.Tensor, gv: torch.Tensor, gh: torch.Tensor,
              direction: str) -> None:
    """The kernel's plain twin: a torch loop over rows (down/up) or columns
    (right/left) in the kernel's order, ``min(d, prev + c)``, in place."""
    h, w = d.shape
    if direction == "down":
        for y in range(1, h):
            d[y] = torch.minimum(d[y], d[y - 1] + gv[y - 1])
    elif direction == "up":
        for y in range(h - 2, -1, -1):
            d[y] = torch.minimum(d[y], d[y + 1] + gv[y])
    elif direction == "right":
        for x in range(1, w):
            d[:, x] = torch.minimum(d[:, x], d[:, x - 1] + gh[:, x - 1])
    elif direction == "left":
        for x in range(w - 2, -1, -1):
            d[:, x] = torch.minimum(d[:, x], d[:, x + 1] + gh[:, x])
    else:
        raise ValueError(f"unknown sweep direction {direction!r}")


def pitch(w: int) -> int:
    """The kernel's row pitch for width ``w``: a multiple of 4 floats, so
    that every row starts on a 16-byte boundary."""
    return -(-w // 4) * 4


def _pitched(t: torch.Tensor, p: int) -> torch.Tensor:
    """``t`` [rows, cols] itself if its rows lie ``p`` floats apart in
    16-byte aligned storage that holds them whole; else a copy that does
    (zeros in the padding)."""
    rows, cols = t.shape
    if (t.stride(-1) == 1 and (rows <= 1 or t.stride(0) == p) and t.data_ptr() % 16 == 0
            and t.untyped_storage().nbytes() >= 4 * (t.storage_offset() + rows * p)):
        return t
    out = torch.zeros((rows, p), dtype=t.dtype, device=t.device)
    out[:, :cols] = t
    return out


def pitched_empty(h: int, w: int, device, width: int | None = None) -> torch.Tensor:
    """An f32 [h, w] view whose rows lie ``pitch(width)`` floats apart
    (``width`` the flood's W, ``w`` by default): ``d``, ``gv`` or ``gh`` as
    the kernel takes them without a copy."""
    p = pitch(w if width is None else width)
    return torch.empty((h, p), dtype=torch.float32, device=device)[:, :w]


def _launch(d, gv, gh, rounds: int, only: int) -> None:
    """One launch of ``geodesic_sweep_kernel`` on CUDA tensors: ``rounds``
    rounds (only = -1) or the one direction ``DIRECTIONS[only]``. Arrays
    whose rows do not lie pitch(W) floats apart go through padded copies
    (``d`` copied back after)."""
    if d.stride(-1) != 1:
        raise ValueError("d must be contiguous: the kernel relaxes it in place")
    h, w = d.shape
    p = pitch(w)
    if h * p >= 1 << 31:
        raise ValueError(f"d {h}x{w} has 2^31 cells or more (the kernel "
                         "indexes in int32)")
    work = _pitched(d, p)
    gv, gh = _pitched(gv, p), _pitched(gh, p)
    # The grid barrier's arrival counter, zeroed for each flood.
    barrier = torch.zeros(1, dtype=torch.int32, device=d.device) if only < 0 else None
    with torch.cuda.device(d.device):
        err = library().rpf_geodesic_flood_launch(
            work.data_ptr(), gv.data_ptr(), gh.data_ptr(), h, w, p, rounds, only,
            None if barrier is None else barrier.data_ptr(),
            torch.cuda.current_stream(d.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"geodesic_sweep_kernel launch failed: CUDA error {err}")
    KERNEL_LAUNCHES["geodesic_sweep_kernel"] += 1
    if work.data_ptr() != d.data_ptr():
        d.copy_(work[:, :w])


def sweep(d: torch.Tensor, gv: torch.Tensor, gh: torch.Tensor,
          direction: str) -> None:
    """One directional relaxation of ``d`` (contiguous f32 [H, W]) in place:
    the twin for a CPU tensor, one ``geodesic_sweep_kernel`` launch for a
    CUDA one."""
    _check_inputs(d, gv, gh)
    if direction not in DIRECTIONS:
        raise ValueError(f"unknown sweep direction {direction!r}")
    if d.device.type == "cpu":
        sweep_ref(d, gv, gh, direction)
        return
    _launch(d, gv, gh, 1, DIRECTIONS.index(direction))


def flood(d: torch.Tensor, gv: torch.Tensor, gh: torch.Tensor,
          sweeps: int = 4) -> torch.Tensor:
    """``sweeps`` rounds of down, up, right, left over ``d`` (relaxed in
    place and returned): the twin's 4 * sweeps sweeps for a CPU tensor, one
    ``geodesic_sweep_kernel`` launch for a CUDA one."""
    _check_inputs(d, gv, gh)
    if d.device.type == "cpu":
        for _ in range(sweeps):
            for direction in DIRECTIONS:
                sweep_ref(d, gv, gh, direction)
    elif sweeps > 0:
        _launch(d, gv, gh, sweeps, -1)
    return d
