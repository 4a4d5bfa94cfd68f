"""Row-sharded stencil stages with halo exchange: demosaic, sharpen and the
lens-distortion warp (the JAX package's ``parallel/spatial.py``).

One huge image is split by rows over the 'sp' ranks of a mesh
(``parallel/mesh``; each function takes and returns the rank's rows).
Pointwise stages need no communication; the stencils (the 5x5 demosaic
and the radius-2 blur) need HALO rows of each neighbour, and the warp
needs every row its bounded displacement can reach. Each rank sends its
boundary rows to its neighbours in one batch of point-to-point operations
(``dist.batch_isend_irecv``: blocking send/recv pairs in rank order would
deadlock), pads locally, and runs the same torch code as the single-device
path, so the demosaic and the sharpen equal the single-device output bit
for bit. A ``gloo`` group stages the rows through host tensors (it cannot
send CUDA tensors); ``nccl`` sends device tensors.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..core.numerics import div
from ..ops import demosaic as dm
from ..ops.sharpen import unsharp_mask
from .mesh import Mesh, _staged, row_bounds

HALO = 2  # rows of support of the 5x5 demosaic and the radius-2 blur


def _p2p(mesh: Mesh, sends, recvs) -> list[torch.Tensor]:
    """One batch of point-to-point transfers in this rank's 'sp' row.
    ``sends``: (tensor, peer 'sp' index); ``recvs``: (template tensor,
    peer 'sp' index), a tensor of the template's shape and dtype arriving
    from the peer. Returns the received tensors on the rank's device."""
    group = mesh.sp_group
    ops, bufs = [], []
    for t, peer in sends:
        wire = t.cpu() if _staged(group, t) else t
        ops.append(dist.P2POp(dist.isend, wire.contiguous(), mesh.sp_rank(peer), group))
    for like, peer in recvs:
        buf = torch.empty(like.shape, dtype=like.dtype,
                          device="cpu" if _staged(group, like) else like.device)
        bufs.append(buf)
        ops.append(dist.P2POp(dist.irecv, buf, mesh.sp_rank(peer), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return [b.to(mesh.device) for b in bufs]


def _exchange_rows(local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``local`` [h_local, ...] (rows first) with HALO rows of each
    neighbour above and below. The first and last rank mirror their own
    boundary (reflect, excluding the edge row), as the single-device
    ``np.pad(..., 'reflect')`` does."""
    i, n = mesh.sp_index, mesh.shape["sp"]
    sends, recvs = [], []
    if i > 0:     # my top rows become the bottom halo of rank i-1
        sends.append((local[:HALO], i - 1))
        recvs.append((local[:HALO], i - 1))
    if i < n - 1:  # my bottom rows become the top halo of rank i+1
        sends.append((local[-HALO:], i + 1))
        recvs.append((local[-HALO:], i + 1))
    got = _p2p(mesh, sends, recvs)
    top = local[1:HALO + 1].flip(0) if i == 0 else got[0]
    bot = local[-HALO - 1:-1].flip(0) if i == n - 1 else got[-1]
    return torch.cat([top, local, bot], 0)


def demosaic_sharded(mosaic: torch.Tensor, mesh: Mesh, pattern: str = "RGGB",
                     method: str = "malvar", h: int | None = None) -> torch.Tensor:
    """Row-sharded Bayer demosaic: this rank's rows of the mosaic [rows, W]
    in, its planar RGB rows [3, rows, W] out, equal to the single-device
    demosaic's rows bit for bit. Each rank exchanges HALO rows with its
    neighbours, demosaics its haloed block and drops the halo. With more
    than one 'sp' rank the height ``h`` (default rows x sp size) must split
    into equal even shards (CFA phase); one rank takes any height."""
    mesh.require_member()
    n = mesh.shape["sp"]
    rows = mosaic.shape[0]
    h = rows * n if h is None else int(h)
    if n > 1 and h % (2 * n) != 0:
        # Shards must start on even global rows (CFA phase) and split
        # evenly. A single shard starts at row 0 whatever the parity.
        raise ValueError(
            f"height {h} must be divisible by 2 * sp axis size ({2 * n})")
    if h // n <= HALO:
        # The edge-shard reflection needs HALO rows beyond the boundary
        # row from the same shard.
        raise ValueError(
            f"shard height {h // n} must exceed the halo ({HALO}); "
            f"use fewer 'sp' shards for a {h}-row image")
    if rows != h // n:
        raise ValueError(f"rank {mesh.rank} holds {rows} rows of a {h}-row "
                         f"image over {n} 'sp' ranks")
    demosaic = dm.demosaic_malvar if method == "malvar" else dm.demosaic_bilinear
    # Shards start on even global rows and the halo shifts the local
    # origin by HALO (even), so the local CFA phase is the global one.
    rgb = demosaic(_exchange_rows(mosaic, mesh), pattern)
    return rgb[:, HALO:-HALO, :]


def _hop_rows(mesh: Mesh, block: torch.Tensor, m: list[int]):
    """The multi-hop halo of ``block`` [h_local, 3, W]: hop j (1..k) brings
    m[j-1] rows from rank i-j (its bottom rows) and from rank i+j (its top
    rows); a missing neighbour gives zero rows. Returns (above, below),
    farthest hop first above and last below."""
    i, n = mesh.sp_index, mesh.shape["sp"]
    sends, recvs, where = [], [], []
    for j, mj in enumerate(m, start=1):
        if i + j < n:
            sends.append((block[-mj:], i + j))
            recvs.append((block[:mj], i + j))
            where.append(("below", j))
        if i - j >= 0:
            sends.append((block[:mj], i - j))
            recvs.append((block[-mj:], i - j))
            where.append(("above", j))
    got = dict(zip(where, _p2p(mesh, sends, recvs)))

    def rows(side, j):
        mj = m[j - 1]
        return got.get((side, j), block.new_zeros((mj,) + tuple(block.shape[1:])))

    above = [rows("above", j) for j in range(len(m), 0, -1)]
    below = [rows("below", j) for j in range(1, len(m) + 1)]
    return above, below


def distortion_sharded(planes: torch.Tensor, distortion, mesh: Mesh,
                       max_abs_distortion: float = 100.0, extent=None,
                       h: int | None = None) -> torch.Tensor:
    """Row-sharded lens-distortion warp with a bounded-displacement halo:
    this rank's rows of the planes [3, rows, W] in, its warped rows out.

    The warp's vertical reach over the slider range is a static bound
    (``ops/geometry.max_row_displacement``); each rank collects just the
    rows that cover it — K hops, the outermost trimmed to the residual
    halo — and computes its own destination rows with the single-device
    warp's sampling (``ops/geometry.warp_sample``: the same coordinates,
    snap and clamp), so the rows equal the single-device warp's.

    ``distortion`` is the slider value, the same on every rank: zero
    strength is the identity and every rank skips every exchange.
    ``max_abs_distortion`` is the slider bound of the halo analysis;
    ``extent`` the true (h, w) of a bucket-padded image (the warp
    normalizes and clamps by it); ``h`` the global array height (default
    rows x sp size; an uneven height pads the last slab with edge rows,
    which the clamp never samples)."""
    from ..ops.develop import geometry_stage
    from ..ops.geometry import max_row_displacement, warp_sample

    mesh.require_member()
    n = mesh.shape["sp"]
    _, rows, w = planes.shape
    if n == 1:
        return geometry_stage(planes, distortion, extent)
    dev = planes.device
    strength = -0.5 * div(torch.as_tensor(distortion, dtype=torch.float32), 100.0)
    if float(strength) == 0.0:
        return planes
    h = rows * n if h is None else int(h)
    start, stop = row_bounds(h, mesh)
    h_local = -(-h // n)
    if rows != stop - start:
        raise ValueError(f"rank {mesh.rank} holds {rows} rows of a {h}-row "
                         f"image, row_bounds gives {stop - start}")
    block = planes.transpose(0, 1)  # [rows, 3, W]
    if rows < h_local:
        fill = (block[-1:] if rows else block.new_zeros((1, 3, w)))
        block = torch.cat([block, fill.expand(h_local - rows, 3, w)], 0)
    halo = max_row_displacement(h, w, max_abs_distortion)
    if halo is None:
        halo = (n - 1) * h_local  # singular model range: gather all
    halo = min(halo, (n - 1) * h_local)
    k = -(-halo // h_local)  # hops
    m = [min(h_local, halo - (j - 1) * h_local) for j in range(1, k + 1)]
    above, below = _hop_rows(mesh, block, m)
    ext = torch.cat(above + [block] + below, 0).transpose(0, 1)  # [3, h_ext, W]
    if extent is None:
        hf = torch.tensor(float(h), device=dev)
        wf = torch.tensor(float(w), device=dev)
    else:
        e = torch.as_tensor(extent, dtype=torch.float32).to(dev)
        hf = torch.where(e[0] > 0, e[0], torch.tensor(float(h), device=dev))
        wf = torch.where(e[1] > 0, e[1], torch.tensor(float(w), device=dev))
    i = mesh.sp_index
    ys = (torch.arange(h_local, dtype=torch.int32, device=dev)[:, None]
          + i * h_local).expand(h_local, w)
    xs = torch.arange(w, dtype=torch.int32, device=dev)[None, :].expand(h_local, w)
    out = warp_sample(tuple(ext), ys, xs, hf, wf, strength.to(dev),
                      row_base=i * h_local - sum(m))
    return torch.stack(out)[:, :rows]


def raw_develop_sharded(mosaic01: torch.Tensor, wb_gains, cam2srgb,
                        mesh: Mesh, pattern: str = "RGGB", sharpen_amount=None,
                        h: int | None = None) -> torch.Tensor:
    """Row-sharded RAW front end on this rank's mosaic rows: CFA white
    balance -> halo-exchange demosaic -> camera matrix -> clip (-> haloed
    unsharp mask). Only the two halo exchanges communicate."""
    balanced = dm.apply_wb_mosaic(mosaic01, pattern, wb_gains)
    rgb = demosaic_sharded(balanced, mesh, pattern=pattern, h=h)
    rgb = torch.clamp(dm.camera_to_srgb(rgb, cam2srgb), 0.0, 1.0)
    if sharpen_amount is None:
        return rgb
    amount = float(np.float32(sharpen_amount))
    haloed = _exchange_rows(rgb.transpose(0, 1), mesh).transpose(0, 1)
    return unsharp_mask(haloed, amount)[:, HALO:-HALO, :]
