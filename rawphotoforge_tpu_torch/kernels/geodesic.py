"""The geodesic flood's sweep kernel — CUDA C++ for Hopper — and its plain twin.

Replaces the ``lax.scan`` sweeps of the JAX package's
``ops/masking.py:123-199`` (``_sweep_down`` and ``geodesic_distance``'s
rounds; jnp, no Pallas kernel). The CUDA source is ``csrc/geodesic.cu``, one
kernel, ``geodesic_sweep_kernel`` (``sweep``): one directional relaxation of
a distance map ``d`` f32 [H, W] in place, ``d[y] = min(d[y], d[y-1] + c)``
down, and likewise up, right and left, over the unpadded step costs ``gv``
f32 [H-1, W] (vertical neighbours) and ``gh`` f32 [H, W-1] (horizontal).
``flood`` runs ``sweeps`` rounds of the four directions: 4 launches a round.

Bound on the H100: bytes (d and the costs read once, d written once, 12 B/px
a sweep); one thread walks each chain, so the kernel is far from it.

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
        lib.rpf_geodesic_sweep_launch.argtypes = [p, p, i, i, i, p]
        lib.rpf_geodesic_sweep_launch.restype = ctypes.c_int
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


def sweep(d: torch.Tensor, gv: torch.Tensor, gh: torch.Tensor,
          direction: str) -> None:
    """One directional relaxation of ``d`` (contiguous f32 [H, W]) in place:
    the twin for a CPU tensor, ``geodesic_sweep_kernel`` for a CUDA one."""
    _check_inputs(d, gv, gh)
    if direction not in DIRECTIONS:
        raise ValueError(f"unknown sweep direction {direction!r}")
    if d.device.type == "cpu":
        sweep_ref(d, gv, gh, direction)
        return
    if not d.is_contiguous():
        raise ValueError("d must be contiguous: the kernel relaxes it in place")
    k = DIRECTIONS.index(direction)
    cost = (gv if k < 2 else gh).contiguous()
    h, w = d.shape
    with torch.cuda.device(d.device):
        err = library().rpf_geodesic_sweep_launch(
            d.data_ptr(), cost.data_ptr(), h, w, k,
            torch.cuda.current_stream(d.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"geodesic_sweep_kernel launch failed: CUDA error {err}")
    KERNEL_LAUNCHES["geodesic_sweep_kernel"] += 1


def flood(d: torch.Tensor, gv: torch.Tensor, gh: torch.Tensor,
          sweeps: int = 4) -> torch.Tensor:
    """``sweeps`` rounds of down, up, right, left over ``d`` (relaxed in
    place and returned): 4 * sweeps sweeps."""
    for _ in range(sweeps):
        for direction in DIRECTIONS:
            sweep(d, gv, gh, direction)
    return d
