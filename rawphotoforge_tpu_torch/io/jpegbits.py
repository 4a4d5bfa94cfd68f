"""JPEG entropy coding on the device: the packed and prepacked wires.

The JAX package's ``io/jpegbits.py``. Both wires share the coefficient model
of ``io/jpegenc`` (``blockify``), so for the same pixels they give files
byte-identical to each other and to the nibble wire:

PACKED (``wire_packed_extent`` / native ``rpf_jpeg_encode_packed``, the
default): the device Huffman-codes every block (DC size category +
magnitude, run/size AC symbols, ZRLs, EOB; the Annex K.3 tables the native
coder declares in its DHT segments) and concatenates the blocks' bit strings
into the finished scan, so the link carries ceil(total_bits / 32) u32 words
and the host writes only the headers and the 0xFF stuffing.

PREPACKED (``wire`` / native ``rpf_jpeg_encode_prepacked``): the blocks'
bit strings word-aligned per block, with u16 bit lengths per block; the
host shifts each onto the running bit position.

On a CUDA tensor the work runs in the hand-written kernels of
``kernels/jpeg_wire`` (``csrc/jpeg_encode.cu``); on a CPU tensor in their
plain twins here (``prepack``, ``scan_from_words``, ``concat_words``, and
``io/jpegenc.blockify``). The JAX package's TPU shapes — select-sum
lookups, (hi, lo) u32 code pairs, sort-based compaction and fixed packed
capacities (``PACKED_ENT_WORDS``/``PACKED_OUT_WORDS``) — are not carried
over: the port sizes its scratch and scan for the worst case (52 words a
block), so its packed wire cannot overflow, and keeps bit offsets and
totals in int64. The wires degrade only on ``JpegWireDataError``: a
coefficient outside the baseline Huffman domain, or totals that do not add
up.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .._errbase import JpegWireDataError
from . import jpegenc

# ITU-T.81 Annex K.3 typical Huffman tables (the values native/
# rpf_native.cpp writes into the DHT segments — both coders must agree or
# the stream is undecodable).
DC_LUM_BITS = (0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0)
DC_CHR_BITS = (0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0)
DC_VALS = tuple(range(12))
AC_LUM_BITS = (0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D)
AC_LUM_VALS = (
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
    0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3,
    0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
    0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9,
    0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
    0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA)
AC_CHR_BITS = (0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77)
AC_CHR_VALS = (
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1,
    0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
    0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A,
    0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
    0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7,
    0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA)

# Hard per-block capacity: the worst case is every coefficient nonzero
# (ZRL replaces 16 zero lanes with 11 bits — always shorter), bounding a
# block at dc(<=11+11) + 63 ac(<=16+10) = 1660 bits -> 52 words.
BLOCK_WORDS = 52


def build_canonical(bits, vals):
    """(code u32[256], len u8[256]) canonical assignment, T.81 Annex C —
    the same algorithm as the native coder's build_huff."""
    code = np.zeros(256, np.uint32)
    length = np.zeros(256, np.uint8)
    c = 0
    k = 0
    for l in range(1, 17):
        for _ in range(bits[l - 1]):
            v = vals[k]
            k += 1
            code[v] = c
            length[v] = l
            c += 1
        c <<= 1
    return code, length


@functools.cache
def _tables():
    dcl = build_canonical(DC_LUM_BITS, DC_VALS)
    dcc = build_canonical(DC_CHR_BITS, DC_VALS)
    acl = build_canonical(AC_LUM_BITS, AC_LUM_VALS)
    acc = build_canonical(AC_CHR_BITS, AC_CHR_VALS)
    return dcl, dcc, acl, acc


@functools.cache
def huffman_table() -> np.ndarray:
    """u32 [536] of (code << 5) | length: DC lum sizes 0..11, DC chroma
    0..11, AC lum symbols 0..255, AC chroma 0..255 (0 where undefined) —
    the table of ``jpeg_huffman_kernel`` and of the twin."""
    dcl, dcc, acl, acc = _tables()

    def packed(code, length, n):
        return ((code[:n].astype(np.uint64) << 5) | length[:n]).astype(np.uint32)

    return np.concatenate([packed(*dcl, 12), packed(*dcc, 12),
                           packed(*acl, 256), packed(*acc, 256)])


# -- serial oracles -------------------------------------------------------------

def _bit_size_np(v: int) -> int:
    return int(abs(int(v))).bit_length()


def _block_bits_np(zz, chroma: bool) -> tuple[int, int]:
    """One block's complete baseline bit string as (big int, nbits) — the
    shared serial emission both numpy oracles chop differently."""
    tables = _tables()
    dc_code, dc_len = tables[1] if chroma else tables[0]
    ac_code, ac_len = tables[3] if chroma else tables[2]
    acc = 0
    nbits = 0

    def put(v, nb):
        nonlocal acc, nbits
        acc = (acc << nb) | (int(v) & ((1 << nb) - 1))
        nbits += nb

    d = int(zz[0])
    s = _bit_size_np(d)
    if s > 11 or not dc_len[s]:
        raise ValueError(
            f"DC delta {d} outside the baseline Huffman domain")
    put((int(dc_code[s]) << s) | ((d if d >= 0 else d - 1)
                                  & ((1 << s) - 1)), int(dc_len[s]) + s)
    run = 0
    for i in range(1, 64):
        v = int(zz[i])
        if v == 0:
            run += 1
            continue
        while run > 15:
            put(ac_code[0xF0], int(ac_len[0xF0]))
            run -= 16
        s = _bit_size_np(v)
        sym = (run << 4) | s
        if s > 10 or not ac_len[sym]:
            raise ValueError(
                f"AC value {v} outside the baseline Huffman domain")
        put((int(ac_code[sym]) << s) | ((v if v >= 0 else v - 1)
                                        & ((1 << s) - 1)),
            int(ac_len[sym]) + s)
        run = 0
    if run > 0:
        put(ac_code[0x00], int(ac_len[0x00]))
    return acc, nbits


def _chop_words_np(acc: int, nbits: int) -> list[int]:
    """MSB-first u32 words of a bit string, zero-padded last word."""
    nwords = (nbits + 31) // 32
    acc <<= nwords * 32 - nbits
    return [(acc >> (32 * (nwords - 1 - wi))) & 0xFFFFFFFF
            for wi in range(nwords)]


def prepacked_np(blocks: np.ndarray, true_mask: np.ndarray | None = None):
    """Serial oracle of the prepacked wire. blocks: [N, 64] zigzag
    coefficients, DC slot = delta vs the previous TRUE same-component block
    (MCU order Y,Y,Y,Y,Cb,Cr). Returns (bit_lens u16 [N], words u32
    [total_words])."""
    blocks = np.asarray(blocks)
    n = blocks.shape[0]
    lens = np.zeros(n, np.uint16)
    words: list[int] = []
    for b in range(n):
        if true_mask is not None and not true_mask[b]:
            continue
        acc, nbits = _block_bits_np(blocks[b], (b % 6) >= 4)
        lens[b] = nbits
        words.extend(_chop_words_np(acc, nbits))
    return lens, np.asarray(words, dtype=np.uint32)


def packed_np(blocks: np.ndarray, true_mask: np.ndarray | None = None):
    """Serial oracle of the packed wire: the whole scan as one contiguous
    bit stream. Returns (words u32 [ceil(total_bits/32)], total_bits)."""
    blocks = np.asarray(blocks)
    acc = 0
    nbits = 0
    for b in range(blocks.shape[0]):
        if true_mask is not None and not true_mask[b]:
            continue
        a, nb = _block_bits_np(blocks[b], (b % 6) >= 4)
        acc = (acc << nb) | a
        nbits += nb
    return np.asarray(_chop_words_np(acc, nbits), dtype=np.uint32), nbits


# -- the torch twins ------------------------------------------------------------

def _bit_size(v: torch.Tensor) -> torch.Tensor:
    """Size category: the bit length of |v| (int64; exact through float64's
    binary exponent for |v| < 2^53)."""
    return torch.frexp(torch.abs(v).to(torch.float64)).exponent.to(torch.int64)


def _magnitude(v: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The s magnitude bits of v (one's complement of |v| when negative)."""
    return torch.where(v < 0, v - 1, v) & ((1 << s) - 1)


def _zrl_runs(code: int, length: int):
    """(value, length) of 0..3 ZRL symbols in a row."""
    reps, v = [], 0
    for z in range(4):
        reps.append((v, z * length))
        v = (v << length) | code
    return reps


def _lanes(blocks: torch.Tensor, true_mask: torch.Tensor):
    """[N, 64] zigzag blocks (DC = masked delta) + bool [N] -> per-lane
    code strings (value int64, length int64) [N, 65] for DC + 63 AC (each
    with its ZRLs, <= 59 bits) + EOB, lengths zeroed on padding blocks,
    and the count of out-of-domain lanes on true blocks (AC size > 10 or
    DC size > 11: no Annex K.3 symbol; such a lane carries only its
    magnitude bits, as the kernel's does)."""
    dev = blocks.device
    b = blocks.to(torch.int64)
    n = b.shape[0]
    tab = torch.from_numpy(huffman_table().astype(np.int64)).to(dev)
    chr_i = ((torch.arange(n, device=dev) % 6) >= 4).to(torch.int64)

    d = b[:, 0]
    s_dc = _bit_size(d)
    dc_ok = s_dc <= 11
    dc_ent = torch.where(dc_ok, tab[torch.clamp(s_dc, max=11) + 12 * chr_i], 0)
    dc_val = ((dc_ent >> 5) << s_dc) | _magnitude(d, s_dc)
    dc_len = (dc_ent & 31) + s_dc

    k = torch.arange(64, device=dev)
    nz = b != 0
    coded = torch.where(nz, k, -1)
    coded[:, 0] = 0                                   # the DC is always coded
    prevmax = torch.cummax(coded, 1).values
    lastprev = torch.cat([prevmax.new_zeros(n, 1), prevmax[:, :-1]], 1)
    ac, nz_ac = b[:, 1:], nz[:, 1:]
    run = torch.where(nz_ac, (k - lastprev - 1)[:, 1:], 0)
    z, rem = run >> 4, run & 15
    s = _bit_size(ac)
    ac_ok = s <= 10
    ac_base = 24 + 256 * chr_i[:, None]
    ent = torch.where(nz_ac & ac_ok,
                      tab[ac_base + ((rem << 4) | torch.clamp(s, max=10))], 0)
    base_val = ((ent >> 5) << s) | _magnitude(ac, s)
    base_len = (ent & 31) + s
    # The z <= 3 ZRLs ahead of the symbol, by table (lum, chroma) and z.
    runs = [_zrl_runs(int(e) >> 5, int(e) & 31)
            for e in huffman_table()[[24 + 0xF0, 280 + 0xF0]]]
    zsel = 4 * chr_i[:, None] + z
    zrl_val = torch.tensor([v for r in runs for v, _ in r], device=dev)[zsel]
    zrl_len = torch.tensor([ln for r in runs for _, ln in r], device=dev)[zsel]
    ac_val = torch.where(nz_ac, (zrl_val << base_len) | base_val, 0)
    ac_len = torch.where(nz_ac, zrl_len + base_len, 0)

    eob = tab[24 + 256 * chr_i]
    eob_len = torch.where(prevmax[:, -1] < 63, eob & 31, 0)
    val = torch.cat([dc_val[:, None], ac_val, (eob >> 5)[:, None]], 1)
    length = torch.cat([dc_len[:, None], ac_len, eob_len[:, None]], 1)
    length = length * true_mask[:, None].to(torch.int64)
    bad = torch.where(true_mask, (~dc_ok).to(torch.int64)
                      + (nz_ac & ~ac_ok).sum(1), 0).sum()
    return val, length, bad


def _assemble(val: torch.Tensor, length: torch.Tensor, off: torch.Tensor,
              n_words: int) -> torch.Tensor:
    """Lane strings at bit offsets ``off`` (MSB-first, per block) -> words
    int64 [N, n_words] of u32 values. A lane of <= 59 bits touches at most
    3 words; the lanes' bits are disjoint, so summing their pieces into the
    words is their OR."""
    n = val.shape[0]
    words = torch.zeros(n * n_words, dtype=torch.int64, device=val.device)
    lane = length > 0
    row = (torch.arange(n, device=val.device) * n_words)[:, None].expand_as(val)[lane]
    val, off, end = val[lane], off[lane], (off + length)[lane]
    for kk in range(3):
        w = (off >> 5) + kk
        hit = w <= (end - 1) >> 5
        s = 32 * (w + 1) - end          # left shift when the lane ends in w
        left = (val & ((1 << torch.clamp(32 - s, 0, 32)) - 1)) << torch.clamp(s, 0, 31)
        right = (val >> torch.clamp(-s, 0, 63)) & 0xFFFFFFFF
        piece = torch.where(s >= 0, left, right)
        words.index_add_(0, (row + w)[hit], piece[hit])
    return words.reshape(n, n_words)


def prepack(blocks: torch.Tensor, true_mask: torch.Tensor):
    """[N, 64] zigzag blocks (DC = masked delta) + bool [N] -> (bit lengths
    int64 [N], words int64 [N, 52] of u32 values MSB-first and zero-padded,
    word counts int64 [N], out-of-domain count): the plain twin of
    ``jpeg_huffman_kernel`` (which also takes the DC deltas)."""
    val, length, bad = _lanes(blocks, true_mask)
    off = torch.cumsum(length, 1) - length
    bits = off[:, -1] + length[:, -1]
    return bits, _assemble(val, length, off, BLOCK_WORDS), (bits + 31) >> 5, bad


def scan_from_words(words: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Per-block words int64 [N, 52] (u32 values) and bit lengths -> the
    finished scan, int64 [N * 52 + 1] (u32 values, zeros after its
    ceil(total_bits / 32) words): each block's bits shifted onto its
    exclusive global bit offset (int64). The plain twin of
    ``jpeg_pack_kernel``, packed; disjoint bits, so a sum is their OR."""
    n = words.shape[0]
    goff = torch.cumsum(bits, 0) - bits
    r, q = (goff & 31)[:, None], (goff >> 5)[:, None]
    j = torch.arange(BLOCK_WORDS, device=words.device)[None, :]
    keep = j < ((bits + 31) >> 5)[:, None]
    scan = torch.zeros(n * BLOCK_WORDS + 1, dtype=torch.int64, device=words.device)
    scan.index_add_(0, (q + j)[keep], (words >> r)[keep])
    low = (words & ((1 << r) - 1)) << (32 - r)    # the bits that spill over
    scan.index_add_(0, (q + j + 1)[keep], low[keep])
    return scan


def concat_words(words: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Per-block words [N, 52] -> their first ceil(bits / 32) words of
    each block back to back, int64 [N * 52] zero-tailed (row-major boolean
    indexing is the block order). The plain twin of ``jpeg_pack_kernel``,
    prepacked."""
    keep = torch.arange(BLOCK_WORDS, device=words.device)[None, :] < (
        (bits + 31) >> 5)[:, None]
    flat = words[keep]
    out = torch.zeros(words.numel(), dtype=torch.int64, device=words.device)
    out[: flat.numel()] = flat
    return out


def packed(blocks: torch.Tensor, true_mask: torch.Tensor):
    """The packed wire's twin from blocks (DC = masked delta): (scan int64
    [N * 52 + 1] zero-tailed, totals int64 [3] = (total_words, total_bits,
    n_out_of_domain)). The JAX package's ``packed`` with no capacities."""
    bits, words, _, bad = prepack(blocks, true_mask)
    total = bits.sum()
    return (scan_from_words(words, bits),
            torch.stack([(total + 31) >> 5, total, bad]))


def _true_mask(nblk: int, grid_c: int, mcu_r: int, mcu_c: int,
               device=None) -> torch.Tensor:
    mcu = torch.arange(nblk, device=device) // 6
    return ((mcu // grid_c) < mcu_r) & ((mcu % grid_c) < mcu_c)


def _dc_delta_masked(blocks: torch.Tensor, true_mask: torch.Tensor) -> torch.Tensor:
    """DC -> delta vs the previous TRUE same-component block (the emitted
    prediction chain: padding blocks are not emitted, so unlike the nibble
    wire the deltas skip them)."""
    m = blocks.shape[0] // 6
    b3 = blocks.reshape(m, 6, 64).clone()
    tm = true_mask.reshape(m, 6)
    dc = b3[:, :, 0].to(torch.int64)

    def delta(seq, keep):
        idx = torch.arange(seq.numel(), device=seq.device)
        last = torch.cummax(torch.where(keep, idx, -1), 0).values
        prev_i = torch.cat([last.new_full((1,), -1), last[:-1]])
        prev = torch.where(prev_i >= 0, seq[torch.clamp(prev_i, min=0)], 0)
        return seq - prev

    dy = delta(dc[:, :4].reshape(-1), tm[:, :4].reshape(-1)).reshape(m, 4)
    b3[:, :, 0] = torch.cat([dy, delta(dc[:, 4], tm[:, 4])[:, None],
                             delta(dc[:, 5], tm[:, 5])[:, None]], 1).to(blocks.dtype)
    return b3.reshape(m * 6, 64)


# -- the wires ------------------------------------------------------------------

def _coded(planes, qlum, qchr, th, tw):
    """Blocks -> Huffman stage of a render whose true extent is th x tw:
    (words, bits, bad) through kernels/jpeg_wire."""
    from ..kernels import jpeg_wire

    blocks = jpeg_wire.blocks(planes, qlum, qchr, (th, tw))
    grid_c = -(-planes.shape[-1] // 16)
    return jpeg_wire.huffman(blocks, grid_c, -(-th // 16), -(-tw // 16))


def wire(planes, qlum, qchr, true_hw=None):
    """The prepacked wire on the planes' device, no host sync: (bit lengths
    int32 [N], words int32 [N * 52] (u32 values, the blocks' strings back to
    back, zero-tailed), totals int64 [3] = (total_words, total_bits,
    n_out_of_domain)). ``true_hw``: the true extent of a padded render."""
    from ..kernels import jpeg_wire

    _, h, w = planes.shape
    th, tw = (h, w) if true_hw is None else true_hw
    words, bits, bad = _coded(planes, qlum, qchr, th, tw)
    flat = jpeg_wire.pack(words, bits, packed=False)
    bits64 = bits.to(torch.int64)
    totals = torch.stack([((bits64 + 31) >> 5).sum(), bits64.sum(),
                          bad[0].to(torch.int64)])
    return bits, flat, totals


def wire_packed(planes, qlum, qchr):
    """The packed wire of a whole render; see ``wire_packed_extent``."""
    _, h, w = planes.shape
    return wire_packed_extent(planes, qlum, qchr, h, w)


def wire_packed_extent(planes, qlum, qchr, th, tw):
    """The packed wire on the planes' device, no host sync: (scan int32
    [N * 52 + 1], the finished entropy-coded scan in its first total_words
    words, zeros after; totals int64 [3] = (total_words, total_bits,
    n_out_of_domain)). ``th x tw`` is the true extent of a padded render:
    padding blocks carry no bits and the DC deltas chain over true blocks
    only, so the scan equals a direct encode's."""
    from ..kernels import jpeg_wire

    words, bits, bad = _coded(planes, qlum, qchr, th, tw)
    scan = jpeg_wire.pack(words, bits, packed=True)
    total = bits.to(torch.int64).sum()
    return scan, torch.stack([(total + 31) >> 5, total, bad[0].to(torch.int64)])


def fetch_scan(words: torch.Tensor, n: int) -> np.ndarray:
    """The first ``n`` words of a wire (int32 on the device) as host u32."""
    from ..utils.transfer import fetch_np

    return fetch_np(words[:n]).view(np.uint32)


def _check_totals(total_words: int, total_bits: int, bad: int, n_true: int,
                  packed: bool):
    if bad:
        # A lane without an Annex K.3 symbol would be silently undecodable.
        raise JpegWireDataError(
            f"{bad} coefficients outside the baseline Huffman domain "
            "(AC size > 10 or DC delta size > 11)")
    least = (total_bits + 31) // 32     # a packed scan has exactly these
    if not (0 <= total_bits <= 32 * BLOCK_WORDS * n_true) or not (
            total_words == least if packed
            else least <= total_words <= BLOCK_WORDS * n_true):
        raise JpegWireDataError(
            f"wire totals inconsistent (total_words={total_words}, "
            f"total_bits={total_bits}, {n_true} true blocks)")


def encode_prepacked_device(planes, quality: int, stage=None,
                            true_shape=None) -> bytes:
    """The prepacked wire: per-block bit strings on the device -> fetch ->
    native concatenation. ``true_shape`` marks a padded render."""
    from .. import native
    from ..utils.transfer import fetch_np

    stage = stage or (lambda _name: None)
    h, w, grid, _ = jpegenc.wire_extent(planes, true_shape)
    qlum, qchr = jpegenc._quant_tables(quality)
    bits, flat, totals = wire(planes, qlum, qchr, (h, w))
    stage("fetch")
    total_words, total_bits, bad = totals.tolist()
    _check_totals(total_words, total_bits, bad, 6 * -(-h // 16) * -(-w // 16),
                  packed=False)
    host_lens = fetch_np(bits.to(torch.int16)).view(np.uint16)
    host_words = fetch_scan(flat, total_words)
    stage("encode")
    return native.jpeg_encode_prepacked(host_lens, host_words, h, w,
                                        quality=quality, grid=grid)


def encode_packed_device(planes, quality: int, stage=None,
                         true_shape=None) -> bytes:
    """The packed wire: the device emits the finished scan, the link
    carries exactly its ceil(total_bits / 32) words, and the native
    assembler writes the headers and stuffs 0xFF. ``true_shape`` marks a
    padded render. Raises ``JpegWireDataError`` on out-of-domain
    coefficients or inconsistent totals."""
    from .. import native

    stage = stage or (lambda _name: None)
    h, w, _, _ = jpegenc.wire_extent(planes, true_shape)
    qlum, qchr = jpegenc._quant_tables(quality)
    scan, totals = wire_packed_extent(planes, qlum, qchr, h, w)
    stage("fetch")
    total_words, total_bits, bad = totals.tolist()
    _check_totals(total_words, total_bits, bad, 6 * -(-h // 16) * -(-w // 16),
                  packed=True)
    host_words = fetch_scan(scan, total_words)
    stage("encode")
    return native.jpeg_encode_packed(host_words, total_bits, h, w,
                                     quality=quality)
