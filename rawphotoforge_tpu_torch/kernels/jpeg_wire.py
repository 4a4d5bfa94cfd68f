"""The JPEG device wires' kernels — CUDA C++ for Hopper — and their plain twins.

Replaces the JAX package's ``io/jpegbits.py`` and the block stages of
``io/jpegenc.py`` (``_block_stages``, ``_prepacked_jit``): jnp code, no
Pallas kernel, so this is a new design, not a translation. The CUDA source is
``csrc/jpeg_encode.cu``, three kernels:

- ``jpeg_blocks_kernel`` (``blocks``): sRGB f32 [3, H, W] -> quantized zigzag
  blocks int16 [N, 64] in MCU order (Y tl, tr, bl, br, Cb, Cr), N = 6
  ceil(H/16) ceil(W/16). Twin: ``io/jpegenc.blockify``.
- ``jpeg_huffman_kernel`` (``huffman``): the DC delta against the previous
  true block of the same component, then each block's baseline bit string
  into its own 52 u32 words, its bit length, and the count of coefficients
  outside the baseline Huffman domain. Twin: ``io/jpegbits.prepack`` after
  ``io/jpegbits._dc_delta_masked``.
- ``jpeg_pack_kernel`` (``pack``): the blocks' bit strings concatenated into
  the finished scan at their exclusive bit offsets (packed), or their words
  at their word offsets (prepacked); the offsets are a ``torch.cumsum``.
  Twins: ``io/jpegbits.scan_from_words`` / ``concat_words``.

Design on the H100 (bound by bytes: the planes read once, the blocks, the
bit strings and the scan). The blocks kernel is one wave of blocks walking
16-row x 128-column chunks of the MCU strips: its constants staged once a
block, the chunk's planes staged by ``cp.async`` (16-byte copies where the
row pitch is 16-byte aligned, 4-byte ones where it is not), double-
buffered, each pixel converted once, the fDCT's sequential sums from
shared memory (no tensor cores: their sums would round otherwise). The
Huffman kernel is a warp per block (a wave of 6-warp blocks, an MCU at a
time): one coalesced load of the block, a ballot for the zero runs, a
shuffle scan for the bit offsets, the words assembled in shared memory and
stored as 16-byte vectors into the block's 52-word slot. The pack kernel
is 8 lanes a block: one coalesced pass over the block's coded words, each
output word a funnel shift of a word and its neighbour's (a shuffle),
``atomicOr`` only on the block's first and last scan words. Words are u32 bit
patterns in int32 tensors on every device; the blocks kernel's output and
the Huffman kernel's slots must be 16-byte aligned, as ``torch.empty``
gives them (a misaligned tensor raises).

Each wrapper takes the twin for a CPU tensor and the kernel for a CUDA
tensor; there is no fallback from one to the other. Each kernel counts its
launches in ``KERNEL_LAUNCHES``; the twins never count.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..io import jpegbits, jpegenc

# Kernel launches since the counts were last set to 0, by __global__ kernel.
KERNEL_LAUNCHES = {"jpeg_blocks_kernel": 0, "jpeg_huffman_kernel": 0,
                   "jpeg_pack_kernel": 0}
# Build record of the loaded library (kernels/cuda_build.build), or None.
BUILD = None
_LIB = None


def library():
    """The built and loaded kernel library (built at the first call)."""
    global _LIB, BUILD
    if _LIB is None:
        from .cuda_build import build

        lib, BUILD = build("rpf_jpeg", "jpeg_encode.cu")
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.rpf_jpeg_blocks_launch.argtypes = [p, i, i, i, i, p, p, p]
        lib.rpf_jpeg_huffman_launch.argtypes = [p, i64, i, i, i, p, p, p, p, p]
        lib.rpf_jpeg_pack_launch.argtypes = [p, p, p, i64, i, p, p]
        for fn in (lib.rpf_jpeg_blocks_launch, lib.rpf_jpeg_huffman_launch,
                   lib.rpf_jpeg_pack_launch):
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _device(t: torch.Tensor, what: str) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {what} kernel for device {t.device}")
    return t.device.type


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def _block_consts(qlum, qchr) -> np.ndarray:
    """The blocks kernel's f32 constants: D[u][x] (64), qlum and qchr in
    natural order (64 + 64), the JFIF matrix (9) — the twin's values."""
    return np.concatenate([jpegenc._dct8(np.float32).ravel(),
                           np.asarray(qlum, np.float32), np.asarray(qchr, np.float32),
                           jpegenc._YCC.ravel()]).astype(np.float32)


def blocks(planes: torch.Tensor, qlum, qchr, true_hw=None) -> torch.Tensor:
    """sRGB f32 [3, H, W] -> quantized zigzag blocks int16 [N, 64] (see
    ``io/jpegenc.blockify``, the twin, for the arithmetic and ``true_hw``)."""
    if planes.ndim != 3 or planes.shape[0] != 3:
        raise ValueError(f"expected planes [3, H, W], got {tuple(planes.shape)}")
    _, h, w = planes.shape
    th, tw = (h, w) if true_hw is None else (int(true_hw[0]), int(true_hw[1]))
    if not (0 < th <= h and 0 < tw <= w):
        raise ValueError(f"true extent {th}x{tw} outside planes {h}x{w}")
    if _device(planes, "JPEG blocks") == "cpu":
        return jpegenc.blockify(planes, qlum, qchr, (th, tw))
    if planes.dtype != torch.float32:
        raise ValueError(f"planes must be float32, got {planes.dtype}")
    planes = planes.contiguous()
    from .fused import host_floats

    consts = host_floats(_block_consts(qlum, qchr).tolist(), planes.device)
    out = torch.empty((6 * (-(-h // 16)) * (-(-w // 16)), 64), dtype=torch.int16,
                      device=planes.device)
    with torch.cuda.device(planes.device):
        err = library().rpf_jpeg_blocks_launch(
            planes.data_ptr(), h, w, th, tw, consts.data_ptr(), out.data_ptr(),
            _stream(planes))
    _check(err, "jpeg_blocks_kernel")
    KERNEL_LAUNCHES["jpeg_blocks_kernel"] += 1
    return out


@functools.lru_cache(maxsize=8)
def _huffman_table(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(jpegbits.huffman_table().view(np.int32)).to(device)


def huffman(blocks: torch.Tensor, grid_c: int, mcu_r: int, mcu_c: int):
    """Entropy coding of quantized blocks [N, 64] (absolute DCs) over a grid
    of ``grid_c`` MCU columns whose first ``mcu_r`` rows and ``mcu_c``
    columns are true: (words int32 [N, 52] MSB-first, zero-padded; bit
    lengths int32 [N], 0 on padding blocks; out-of-domain count int32 [1]).
    The DC deltas chain over true blocks only."""
    n = blocks.shape[0]
    if blocks.ndim != 2 or blocks.shape[1] != 64 or n == 0 or n % 6:
        raise ValueError(f"expected blocks [6k, 64], got {tuple(blocks.shape)}")
    if not (0 < mcu_c <= grid_c and 0 < mcu_r and (n // 6) % grid_c == 0
            and mcu_r <= n // 6 // grid_c):
        raise ValueError(f"true MCUs {mcu_r}x{mcu_c} outside the grid of "
                         f"{n // 6 // max(grid_c, 1)}x{grid_c}")
    if _device(blocks, "JPEG Huffman") == "cpu":
        mask = jpegbits._true_mask(n, grid_c, mcu_r, mcu_c, blocks.device)
        bits, words, _, bad = jpegbits.prepack(
            jpegbits._dc_delta_masked(blocks, mask), mask)
        return (jpegenc._i32_bits(words), bits.to(torch.int32),
                bad.reshape(1).to(torch.int32))
    if blocks.dtype != torch.int16:
        raise ValueError(f"blocks must be int16, got {blocks.dtype}")
    blocks = blocks.contiguous()
    dev = blocks.device
    words = torch.empty((n, jpegbits.BLOCK_WORDS), dtype=torch.int32, device=dev)
    bits = torch.empty(n, dtype=torch.int32, device=dev)
    bad = torch.zeros(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = library().rpf_jpeg_huffman_launch(
            blocks.data_ptr(), n, grid_c, mcu_r, mcu_c,
            _huffman_table(dev).data_ptr(), words.data_ptr(), bits.data_ptr(),
            bad.data_ptr(), _stream(blocks))
    _check(err, "jpeg_huffman_kernel")
    KERNEL_LAUNCHES["jpeg_huffman_kernel"] += 1
    return words, bits, bad


def pack(words: torch.Tensor, bits: torch.Tensor, packed: bool = True) -> torch.Tensor:
    """The Huffman stage's per-block words -> int32 [N * 52 + 1], the
    finished scan in its first ceil(total_bits / 32) words, zeros after
    (``packed``); or int32 [N * 52], the blocks' words back to back in their
    first sum(ceil(bits / 32)) words, zeros after (prepacked). Offsets are
    int64: a 45 MP frame of noise at quality 100 exceeds 2^31 bits."""
    n = bits.shape[0]
    if words.shape != (n, jpegbits.BLOCK_WORDS) or n == 0:
        raise ValueError(f"expected words [{n}, {jpegbits.BLOCK_WORDS}], got "
                         f"{tuple(words.shape)}")
    if _device(words, "JPEG pack") == "cpu":
        bits64 = bits.to(torch.int64)
        w64 = words.to(torch.int64) & 0xFFFFFFFF
        out = (jpegbits.scan_from_words(w64, bits64) if packed
               else jpegbits.concat_words(w64, bits64))
        return jpegenc._i32_bits(out)
    if words.dtype != torch.int32 or bits.dtype != torch.int32:
        raise ValueError("words and bits must be int32")
    words, bits = words.contiguous(), bits.contiguous()
    bits64 = bits.to(torch.int64)
    step = bits64 if packed else (bits64 + 31) >> 5
    offsets = torch.cumsum(step, 0) - step
    size = n * jpegbits.BLOCK_WORDS + (1 if packed else 0)
    out = torch.zeros(size, dtype=torch.int32, device=words.device)
    with torch.cuda.device(words.device):
        err = library().rpf_jpeg_pack_launch(
            words.data_ptr(), bits.data_ptr(), offsets.data_ptr(), n,
            int(packed), out.data_ptr(), _stream(words))
    _check(err, "jpeg_pack_kernel")
    KERNEL_LAUNCHES["jpeg_pack_kernel"] += 1
    return out
