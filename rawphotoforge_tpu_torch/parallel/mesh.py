"""Multi-device parallelism on ``torch.distributed``: batch-sharded export
and spatially-sharded develop (the JAX package's ``parallel/mesh.py``).

The reference is strictly single-GPU (SURVEY.md §2.6). The JAX package
spread its work over a ('batch', 'sp') device mesh with shard_map; here
the same layout is laid over the ranks of the initialized default process
group (``torchrun``, or ``torch.distributed.init_process_group``), one
process a card:

* ``make_mesh`` — the ('batch', 'sp') layout, rank = b * n_sp + s, with one
  subgroup per 'sp' row and one per 'batch' column.
* ``batch_develop_sharded`` — images sharded over 'batch', developed per
  rank; zero communication.
* ``develop_spatial_sharded`` — one image's rows sharded over 'sp'; the
  develop stack is pointwise (the vignette takes the slab's global row
  offset), the lens-distortion warp exchanges bounded halos
  (``parallel/spatial``).
* ``histogram_sharded`` — per-rank 256-bin histograms summed with an
  all_reduce over the 'sp' row.
* ``full_step`` — develop + histogram + clip fraction of one frame.
* the export steps — per-image develop and JPEG device wires.

**The convention.** Every sharded function takes and returns the rank's
own block: its rows (axis -2) for 'sp', its images (axis 0) for 'batch';
ranks with the same 'batch' index hold the same images, ranks with the
same 'sp' index the same rows. ``shard_rows`` / ``shard_batch`` cut a
rank's block from a whole tensor (``row_bounds`` / ``batch_bounds``: an
uneven height gives the last 'sp' rank fewer rows, as an uneven count
gives the last 'batch' rank fewer images), and ``gather_rows`` /
``gather_batch`` rebuild the whole for callers that need it. Where the
global height matters (an uneven split, the warp's normalization) it is
passed as ``h``; by default h = the block's rows x the 'sp' size.

**The transport.** A ``gloo`` group cannot send CUDA tensors, so its
collectives stage through host tensors; ``nccl`` moves device tensors.
Every stencil and kernel still runs on the rank's device.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from .._device import resolve_device
from .._errbase import PhotoEditorError
from ..core.params import DevelopParams
from ..ops import develop as dev


@dataclasses.dataclass(eq=False)
class Mesh:
    """A ('batch', 'sp') layout over the ranks of the default process group.

    ``shape`` is {"batch": b, "sp": s} as in JAX; ``batch_index`` and
    ``sp_index`` are this rank's coordinates (None for a rank beyond the
    mesh); ``sp_group`` holds the ranks of this rank's 'sp' row (same
    images), ``batch_group`` those of its 'batch' column (same rows);
    ``device`` is where this rank computes."""

    shape: dict
    rank: int
    batch_index: int | None
    sp_index: int | None
    sp_group: object
    batch_group: object
    device: torch.device

    def sp_rank(self, s: int) -> int:
        """The global rank of 'sp' coordinate ``s`` in this rank's row."""
        return self.batch_index * self.shape["sp"] + s

    def require_member(self) -> None:
        if self.batch_index is None:
            raise ValueError(
                f"rank {self.rank} is not in the {self.shape['batch']} x "
                f"{self.shape['sp']} mesh")


def _rank_device(devices, rank: int) -> torch.device:
    """``devices``: None or "cuda" (the card ``LOCAL_RANK`` names: each rank
    its own), one device for this rank ("cpu", or "cuda:i" for a card the
    ranks share), or a sequence indexed by rank."""
    if isinstance(devices, (str, torch.device)):
        dev = torch.device(devices)
        if dev.type != "cuda" or dev.index is not None:
            return resolve_device(dev)
        devices = None
    if devices is None:
        local = os.environ.get("LOCAL_RANK")
        if local is None:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 1
            local = rank % max(n, 1)
        return resolve_device(f"cuda:{int(local)}")
    return resolve_device(devices[rank])


def make_mesh(n_batch: int | None = None, n_spatial: int = 1,
              devices=None) -> Mesh:
    """Build a ('batch', 'sp') mesh over the default process group; by
    default every rank on 'batch'. Every rank must call it, with the same
    shape (each creates every subgroup, in the same order). A rank computes
    on ``cuda:LOCAL_RANK`` (``devices`` None or "cuda") unless ``devices``
    says otherwise (one device, for example "cpu", or one per rank)."""
    if not dist.is_available() or not dist.is_initialized():
        raise PhotoEditorError(
            "make_mesh needs an initialized torch.distributed process group "
            "(torchrun, or torch.distributed.init_process_group)")
    world = dist.get_world_size()
    rank = dist.get_rank()
    if n_batch is None:
        n_batch = world // n_spatial
    need = n_batch * n_spatial
    if n_batch < 1 or n_spatial < 1 or need > world:
        raise ValueError(
            f"mesh shape ({n_batch} batch x {n_spatial} sp) needs {need} "
            f"devices (ranks), have {world}")
    rows = [dist.new_group([b * n_spatial + s for s in range(n_spatial)])
            for b in range(n_batch)]
    cols = [dist.new_group([b * n_spatial + s for b in range(n_batch)])
            for s in range(n_spatial)]
    b, s = divmod(rank, n_spatial) if rank < need else (None, None)
    return Mesh({"batch": n_batch, "sp": n_spatial}, rank, b, s,
                None if b is None else rows[b], None if s is None else cols[s],
                _rank_device(devices, rank))


# -- blocks --------------------------------------------------------------------

def row_bounds(h: int, mesh: Mesh) -> tuple[int, int]:
    """[start, stop) of this rank's rows of an h-row image: ceil(h / n_sp)
    rows a rank, the last ones fewer."""
    mesh.require_member()
    per = -(-h // mesh.shape["sp"])
    start = min(mesh.sp_index * per, h)
    return start, min(start + per, h)


def batch_bounds(n: int, mesh: Mesh) -> tuple[int, int]:
    """[start, stop) of this rank's images of an n-image batch."""
    mesh.require_member()
    per = -(-n // mesh.shape["batch"])
    start = min(mesh.batch_index * per, n)
    return start, min(start + per, n)


def shard_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's rows (axis -2) of a whole tensor, on its device."""
    a, b = row_bounds(x.shape[-2], mesh)
    return x[..., a:b, :].to(mesh.device)


def shard_batch(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's images (axis 0) of a whole batch, on its device."""
    a, b = batch_bounds(x.shape[0], mesh)
    return x[a:b].to(mesh.device)


def _staged(group, t: torch.Tensor) -> bool:
    """Whether a collective of ``t`` over ``group`` goes through the host."""
    return t.device.type == "cuda" and dist.get_backend(group) == "gloo"


def _all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group``'s ranks, on ``t``'s device."""
    wire = t.cpu() if _staged(group, t) else t.clone()
    dist.all_reduce(wire, op=dist.ReduceOp.SUM, group=group)
    return wire.to(t.device)


def _gather(block: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's block of ``group``, concatenated along ``dim`` in rank
    order; blocks may differ in size along ``dim``."""
    dim = dim % block.ndim
    wire = block.cpu() if _staged(group, block) else block
    n = dist.get_world_size(group)
    sizes = torch.tensor([block.shape[dim]], dtype=torch.int64, device=wire.device)
    all_sizes = [torch.empty_like(sizes) for _ in range(n)]
    dist.all_gather(all_sizes, sizes, group=group)
    sizes = [int(x.item()) for x in all_sizes]
    big = max(sizes)
    pad = list(wire.shape)
    pad[dim] = big - wire.shape[dim]
    wire = torch.cat([wire, wire.new_zeros(pad)], dim).contiguous()
    parts = [torch.empty_like(wire) for _ in range(n)]
    dist.all_gather(parts, wire, group=group)
    return torch.cat([p.narrow(dim, 0, k) for p, k in zip(parts, sizes)],
                     dim).to(block.device)


def gather_rows(block: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole image from every 'sp' rank's rows (axis -2)."""
    mesh.require_member()
    return _gather(block, mesh.sp_group, -2)


def gather_batch(block: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole batch from every 'batch' rank's images (axis 0)."""
    mesh.require_member()
    return _gather(block, mesh.batch_group, 0)


# -- sharded develop -------------------------------------------------------------

def batch_develop_sharded(imgs: torch.Tensor, params: DevelopParams,
                          masks: torch.Tensor | None, mesh: Mesh) -> torch.Tensor:
    """Data-parallel batch develop of this rank's images [n, 3, H, W] with
    the shared edit (``params`` and ``masks``, the same on every rank):
    zero communication."""
    mesh.require_member()
    return dev.develop_batch(imgs, params, masks)


def develop_spatial_sharded(
    planes: torch.Tensor, params: DevelopParams, masks: torch.Tensor | None,
    mesh: Mesh, use_kernel: bool = False, h: int | None = None,
) -> torch.Tensor:
    """Develop of one image whose rows are sharded over 'sp': this rank's
    rows of the planes [3, rows, W] and of the masks [M, rows, W] in, its
    rows of the sRGB render out.

    The lens-distortion warp, the one stage with reads across shards,
    exchanges only its bounded halo (``spatial.distortion_sharded``); the
    rest is pointwise. The slab's true global extent rides in the params
    (a slab cannot fall back to its own shape) and its first row's global
    index offsets the vignette. ``use_kernel`` runs the develop kernel
    (``kernels/fused.develop_post_geo_fused``) on the slab with that
    ``row_offset`` instead of the exact-LUT anchor: the output equals the
    single-device kernel's bit for bit."""
    from ..kernels import fused
    from . import spatial

    mesh.require_member()
    _, rows, w = planes.shape
    h = rows * mesh.shape["sp"] if h is None else int(h)
    start, _ = row_bounds(h, mesh)
    ext = torch.where(params.extent > 0, params.extent,
                      fused.host_floats([h, w], params.extent.device))
    params = dataclasses.replace(params, extent=ext)
    geo = spatial.distortion_sharded(planes, params.distortion, mesh,
                                     extent=ext, h=h)
    if use_kernel:
        return fused.develop_post_geo_fused(geo, params, masks,
                                            row_offset=float(start))
    return dev.develop_post_geo(geo, params, masks, row_offset=start)


def histogram_sharded(srgb_planes: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's rows of sRGB planes [3, rows, W] -> the whole image's
    [4, 256] histogram (``ops/stats.histogram_rgbl``), the same on every
    rank of the 'sp' row: per-rank counts summed by an all_reduce. Each
    rank bins only its own rows, so an uneven height needs no padding."""
    from ..ops.stats import histogram_rgbl

    mesh.require_member()
    return _all_reduce_sum(histogram_rgbl(srgb_planes), mesh.sp_group)


def full_step(planes: torch.Tensor, params: DevelopParams,
              masks: torch.Tensor | None, mesh: Mesh, h: int | None = None):
    """One interactive frame over the mesh: the spatially-sharded develop
    of this rank's rows, the whole image's histogram, and its highlight
    clip fraction (``ops/stats.clipping_stats``: pixels with any channel
    clipped). Returns (this rank's sRGB rows, hist [4, 256], clip f32)."""
    from ..core.numerics import div

    srgb = develop_spatial_sharded(planes, params, masks, mesh, h=h)
    hist = histogram_sharded(srgb, mesh)
    h = srgb.shape[1] * mesh.shape["sp"] if h is None else int(h)
    clipped = torch.any(srgb >= 1.0 - 0.5 / 255.0, dim=0).sum().reshape(1)
    total = _all_reduce_sum(clipped, mesh.sp_group)[0]
    return srgb, hist, div(total.to(torch.float32), h * srgb.shape[2])


def export_batch_step(imgs: torch.Tensor, params: DevelopParams,
                      masks: torch.Tensor | None, mesh: Mesh) -> torch.Tensor:
    """Batch export step: sharded develop + per-image u8 quantization."""
    return dev.encode_u8(batch_develop_sharded(imgs, params, masks, mesh))


# -- the JPEG device wires over the batch ----------------------------------------

def entropy_batch_sharded(srgb: torch.Tensor, mesh: Mesh, qlum, qchr):
    """Per-image JPEG entropy coding of this rank's renders [n, 3, H, W]
    through the prepacked wire (``io/jpegbits.wire``): (bit lengths i32
    [n, N], words i32 [n, N*52] zero-tailed, totals i64 [n, 3]). Zero
    collectives; after the u8-grid round the wire is integer math, so for
    the same pixels the streams equal the single-device wire's bit for bit.

    Consumption protocol per image i (as ``encode_prepacked_device``):
    require totals[i, 2] == 0 (no coefficient outside the baseline Huffman
    domain) and totals[i, 0] within [ceil(totals[i, 1] / 32), N*52]
    (``jpegbits._check_totals``), then feed lens[i] and words[i,
    :totals[i, 0]] to ``native.jpeg_encode_prepacked``."""
    from ..io import jpegbits

    mesh.require_member()
    outs = [jpegbits.wire(p, qlum, qchr) for p in srgb]
    return tuple(torch.stack(x) for x in zip(*outs))


def entropy_batch_packed_sharded(srgb: torch.Tensor, mesh: Mesh, qlum, qchr):
    """The packed wire over this rank's renders [n, 3, H, W]: each image's
    finished entropy-coded scan (``io/jpegbits.wire_packed``): (words i32
    [n, N*52 + 1] zero-tailed, totals i64 [n, 3]). Zero collectives.

    Consumption protocol per image i (as ``encode_packed_device``):
    require totals[i, 2] == 0 and totals[i, 0] == ceil(totals[i, 1] / 32)
    (``jpegbits._check_totals(packed=True)``); an image that fails degrades
    to the prepacked wire (``encode_prepacked_device``). Then feed
    words[i, :totals[i, 0]] and totals[i, 1] bits to
    ``native.jpeg_encode_packed``: for the same pixels the file equals the
    single-device packed wire's byte for byte."""
    from ..io import jpegbits

    mesh.require_member()
    outs = [jpegbits.wire_packed(p, qlum, qchr) for p in srgb]
    return tuple(torch.stack(x) for x in zip(*outs))


def export_batch_raw_fused_packed_step(
    mosaics: torch.Tensor, wb, cam, params: DevelopParams, sharpen,
    mesh: Mesh, qlum, qchr, pattern: str = "RGGB",
):
    """RAW -> finished JPEG scan, one image per rank: the one-pass RAW
    kernel (``kernels/raw_pipeline.raw_develop_fused``: mosaic read once,
    sRGB written once) then the packed wire, as on a single device. Zero
    collectives.

    ``mosaics`` [1, H, W] is this rank's normalized mosaic (the same on
    the ranks of an 'sp' row); ``wb`` [3], ``cam`` [3, 3], ``params`` and
    ``sharpen`` are shared. Returns (words [1, N*52 + 1], totals [1, 3]);
    consumption protocol as ``entropy_batch_packed_sharded``'s. Raises
    unless the rank holds exactly one image (the batch axis then has as
    many images as 'batch' ranks)."""
    from ..io import jpegbits
    from ..kernels.raw_pipeline import raw_develop_fused

    mesh.require_member()
    if int(mosaics.shape[0]) != 1:
        raise ValueError(
            f"one image per rank: got {mosaics.shape[0]} images on rank "
            f"{mesh.rank} of a {mesh.shape['batch']}-way batch axis")
    srgb = raw_develop_fused(mosaics[0], wb, cam, params, sharpen,
                             pattern=pattern)
    words, totals = jpegbits.wire_packed(srgb, qlum, qchr)
    return words[None], totals[None]


def export_batch_editor_packed_step(
    geos: torch.Tensor, params: DevelopParams, mesh: Mesh, qlum, qchr,
    true_shape: tuple[int, int],
):
    """The editor's render -> encode tail over this rank's images: the
    entry of the multi-rank ``cli batch`` (``app/cli._batch_mesh_path``).

    ``geos`` [n, 3, Hb, Wb] are bucket-padded post-geometry planes (what
    ``PhotoEditor._geo_at(FULL)`` holds: demosaic, crop, orientation,
    lens distortion and sharpen applied); ``params`` one shared edit with
    its extent; ``true_shape`` the true (h, w) of the images. Per image:
    ``develop_post_geo`` (the exact-LUT anchor, what the editor renders on
    its exact path) and the packed wire on the padded MCU grid (true blocks
    only), so for the same planes the scan equals a single-device
    ``PhotoEditor.save_bytes("JPEG")``'s byte for byte. Returns (words
    [n, N*52 + 1], totals [n, 3]); consumption protocol as
    ``entropy_batch_packed_sharded``'s, with native.jpeg_encode_packed at
    the true (h, w)."""
    from ..io import jpegbits

    mesh.require_member()
    th, tw = int(true_shape[0]), int(true_shape[1])
    outs = [jpegbits.wire_packed_extent(dev.develop_post_geo(g, params, None),
                                        qlum, qchr, th, tw) for g in geos]
    return tuple(torch.stack(x) for x in zip(*outs))


def export_batch_jpeg_packed_step(imgs: torch.Tensor, params: DevelopParams,
                                  masks: torch.Tensor | None, mesh: Mesh,
                                  qlum, qchr):
    """Batch export over the packed wire: sharded develop + each image's
    finished scan (``entropy_batch_packed_sharded``)."""
    srgb = batch_develop_sharded(imgs, params, masks, mesh)
    return entropy_batch_packed_sharded(srgb, mesh, qlum, qchr)


def export_batch_jpeg_step(imgs: torch.Tensor, params: DevelopParams,
                           masks: torch.Tensor | None, mesh: Mesh, qlum, qchr):
    """Batch export over the prepacked wire: sharded develop + per-image
    entropy coding (``entropy_batch_sharded``)."""
    srgb = batch_develop_sharded(imgs, params, masks, mesh)
    return entropy_batch_sharded(srgb, mesh, qlum, qchr)
