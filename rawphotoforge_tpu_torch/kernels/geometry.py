"""The geometry-and-sharpen stage's kernel — CUDA C++ for Hopper — and its
plain twin.

Replaces the JAX package's ``ops/geometry.py`` lens-distortion warp and
``ops/sharpen.py`` unsharp mask (jnp, no Pallas kernel), with the edge
replication into the bucket pad between them (``ops/develop.py``
``replicate_true_edges``). The CUDA source is ``csrc/geometry.cu``, one
kernel, ``geometry_sharpen_kernel``: warp, replication and unsharp of f32
planes [3, H, W] in one launch, bit for bit the twin.

Bound on the H100: bytes. At 45 MP (8192x5504) the stage must read the
planes once and write them once, 1.082 GB: 0.323 ms at 3.35 TB/s. The twin,
a chain of torch ops, moves each plane about a dozen times through
full-frame temporaries and reads device scalars back to the host
(``lens_distortion``'s ``float(strength)``, ``warp_sample``'s extents).

Design: a block takes a 64x32 output tile, samples the warp over it and a
2-pixel halo into shared memory (the halo recomputed by its neighbours:
1.20 samples an output), blurs from there and stores once. The warp's
column and row terms are computed once a tile. The host computes the warp's
strength and the unsharp's amount and taps in numpy float32 (the library's
launcher the extents and the aspect in C float), by the same IEEE
operations the twin runs on the device, so the launch waits for nothing.

The wrapper takes the twin for a CPU tensor and the kernel for a CUDA
tensor; there is no fallback from one to the other. Each launch counts in
``KERNEL_LAUNCHES``; the twin never counts. Only the editor's geometry
stage (``PhotoEditor._geo_at``) calls it. The exact-LUT anchor
(``ops/develop.develop``) is the oracle and keeps the plain ops; the
row-sharded warp (``parallel/spatial``: slabs with a row base and a halo),
the CLI's batch unsharp and the host develop (``engine/hostdev``) are other
contracts and keep them too.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

# Kernel launches since the count was last set to 0.
KERNEL_LAUNCHES = {"geometry_sharpen_kernel": 0}
# Build record of the loaded library (kernels/cuda_build.build), or None.
BUILD = None
_LIB = None

# The unsharp mask's Gaussian: sigma and radius (ops/sharpen defaults).
SIGMA, RADIUS = 1.0, 2


def library():
    """The built and loaded kernel library (built at the first call)."""
    global _LIB, BUILD
    if _LIB is None:
        from .cuda_build import build

        lib, BUILD = build("rpf_geometry", "geometry.cu")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.rpf_geometry_sharpen_launch.argtypes = [p, p, i, i, i, i, i, i, f, f, p, p]
        lib.rpf_geometry_sharpen_launch.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _extent(planes: torch.Tensor, extent) -> tuple[int, int]:
    _, h, w = planes.shape
    if extent is None:
        return h, w
    th, tw = (int(v) for v in extent)
    if not (0 < th <= h and 0 < tw <= w):
        raise ValueError(f"extent {(th, tw)} does not fit planes {h}x{w}")
    return th, tw


def _check_inputs(planes: torch.Tensor) -> None:
    if planes.ndim != 3 or planes.shape[0] != 3:
        raise ValueError(f"expected planes [3, H, W], got {tuple(planes.shape)}")
    if planes.dtype != torch.float32:
        raise ValueError(f"planes must be float32, got {planes.dtype}")
    if not planes.is_contiguous():
        raise ValueError("planes must be contiguous")
    if planes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no geometry kernel for device {planes.device}")


def geometry_sharpen_ref(planes: torch.Tensor, distortion: float, amount: float,
                         extent=None) -> torch.Tensor:
    """The kernel's plain twin, the editor's geometry stage as torch ops:
    the lens-distortion warp (``distortion`` the slider, -100..100) with the
    pad edge-replicated after it, then the unsharp mask of ``amount``.
    ``planes`` itself when both are 0."""
    from ..ops import develop as dev
    from ..ops.sharpen import unsharp_mask

    th, tw = _extent(planes, extent)
    out = planes
    if distortion != 0.0:
        out = dev.geometry_stage(out, distortion, (th, tw))
        if out.shape[1] > th or out.shape[2] > tw:
            # The warp blackens the bucket pad; restore edge replication
            # before the stencil reads it.
            out = dev.replicate_true_edges(out, th, tw)
    if amount != 0.0:
        out = unsharp_mask(out, amount, sigma=SIGMA, radius=RADIUS)
    return out


def _launch(planes: torch.Tensor, distortion: float, amount: float,
            th: int, tw: int) -> torch.Tensor:
    """One ``geometry_sharpen_kernel`` launch, its scalars from the host."""
    from ..ops.sharpen import _gauss_taps

    _, h, w = planes.shape
    if 3 * h * w >= 1 << 31:
        raise ValueError(f"planes 3x{h}x{w} have 2^31 values or more (the "
                         "kernel indexes in int32)")
    f32 = np.float32
    # lens_distortion's strength = -0.5 * (f32(d) / 100), and its early
    # return at strength 0 (the pad is edge-replicated all the same).
    strength = f32(-0.5) * (f32(distortion) / f32(100.0))
    warp = distortion != 0.0 and strength != 0.0
    replicate = distortion != 0.0 and (h > th or w > tw)
    taps = np.ascontiguousarray(_gauss_taps(SIGMA, RADIUS), dtype=np.float32)
    out = torch.empty_like(planes)
    with torch.cuda.device(planes.device):
        err = library().rpf_geometry_sharpen_launch(
            planes.data_ptr(), out.data_ptr(), h, w, th, tw, int(warp), int(replicate),
            float(strength), float(f32(amount)), taps.ctypes.data_as(ctypes.c_void_p),
            torch.cuda.current_stream(planes.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"geometry_sharpen_kernel launch failed: CUDA error {err}")
    KERNEL_LAUNCHES["geometry_sharpen_kernel"] += 1
    return out


def geometry_sharpen(planes: torch.Tensor, distortion: float, amount: float,
                     extent=None) -> torch.Tensor:
    """The geometry stage of contiguous f32 planes [3, H, W] whose true
    extent is ``extent`` (th, tw) (the whole grid by default): the warp of
    the lens-distortion slider value ``distortion``, the pad re-replicated
    from the true edges after it, and the unsharp mask of ``amount``. The
    twin for a CPU tensor, one ``geometry_sharpen_kernel`` launch for a CUDA
    one; ``planes`` itself, with no launch, when both are 0. The unsharp
    takes no threshold: the editor passes none."""
    _check_inputs(planes)
    th, tw = _extent(planes, extent)
    if planes.device.type == "cpu":
        return geometry_sharpen_ref(planes, distortion, amount, (th, tw))
    if distortion == 0.0 and np.float32(amount) == 0.0:
        return planes
    return _launch(planes, float(distortion), float(amount), th, tw)
