"""A tiled lossless-JPEG CFA DNG, as a DNG converter writes one.

The layout of a camera's raw data after Adobe's DNG Converter: the CFA
mosaic cut into tiles (edge tiles padded by replication, TIFF 6.0 section
15), each tile one ITU-T T.81 lossless JPEG (SOF3) of two components with
columns interleaved, predictor 1, its own entropy-optimal Huffman table
(Annex K.2/K.3). The entropy coding runs on the device: per-sample
categories and appended bits, each tile's table from its histogram, then
every code word placed at its bit offset by one scatter; byte stuffing and
the file's structure are assembled on the host.
"""

from __future__ import annotations

import heapq
import struct

import numpy as np
import torch

M_SOF3, M_DHT, M_SOS = 0xC3, 0xC4, 0xDA


def optimal_table(freq) -> tuple[np.ndarray, np.ndarray]:
    """The canonical Huffman table (BITS counts[16], HUFFVAL) for a
    category histogram, with T.81 K.2's reserved all-ones code and K.3's
    16-bit length cap."""
    freq = np.asarray(freq, dtype=np.int64)
    present = [int(s) for s in np.flatnonzero(freq)]
    dummy = 255
    heap = [(int(freq[s]), s, [s]) for s in present] + [(1, dummy, [dummy])]
    heapq.heapify(heap)
    depth = {s: 0 for s in present + [dummy]}
    uid = 1000
    while len(heap) > 1:
        fa, _, sa = heapq.heappop(heap)
        fb, _, sb = heapq.heappop(heap)
        for s in sa + sb:
            depth[s] += 1
        heapq.heappush(heap, (fa + fb, uid, sa + sb))
        uid += 1
    counts = np.zeros(32, dtype=np.int64)
    for s in present + [dummy]:
        counts[depth[s] - 1] += 1
    i = 31
    while i > 15:
        if counts[i] > 0:
            j = i - 2
            while counts[j] == 0:
                j -= 1
            counts[i] -= 2
            counts[i - 1] += 1
            counts[j + 1] += 2
            counts[j] -= 1
        else:
            i -= 1
    i = 15
    while counts[i] == 0:
        i -= 1
    counts[i] -= 1
    values = np.asarray(sorted(present, key=lambda s: (depth[s], s)), dtype=np.uint8)
    return counts[:16].astype(np.uint8), values


def canonical_codes(counts, values) -> tuple[np.ndarray, np.ndarray]:
    """Code and length per category 0..16 of a canonical table."""
    code_of = np.zeros(17, dtype=np.int64)
    len_of = np.zeros(17, dtype=np.int64)
    code, k = 0, 0
    for ln in range(1, 17):
        for _ in range(int(counts[ln - 1])):
            code_of[int(values[k])] = code
            len_of[int(values[k])] = ln
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


def _tiles(mosaic: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """[T, th, tw] tiles across then down, edge tiles padded by edge
    replication."""
    h, w = mosaic.shape
    ty, tx = -(-h // th), -(-w // tw)
    dev = mosaic.device
    rows = torch.clamp(torch.arange(ty * th, device=dev), max=h - 1)
    cols = torch.clamp(torch.arange(tx * tw, device=dev), max=w - 1)
    m = mosaic[rows][:, cols]
    return m.view(ty, th, tx, tw).permute(0, 2, 1, 3).reshape(ty * tx, th, tw)


def encode_tiles(mosaic: torch.Tensor, tile: tuple[int, int], precision: int) -> list[bytes]:
    """Each tile of the int32 mosaic [h, w] as one two-component lossless
    JPEG (predictor 1)."""
    th, tw = tile
    s = _tiles(mosaic, th, tw).to(torch.int64)
    n_tiles = s.shape[0]
    dev = s.device
    # Predictor 1 per component (the same component one MCU to the left);
    # the first MCU of a line predicts from the line above, the scan's
    # first MCU from 2^(P-1).
    pred = torch.zeros_like(s)
    pred[:, :, 2:] = s[:, :, :-2]
    pred[:, 1:, :2] = s[:, :-1, :2]
    pred[:, 0, :2] = 1 << (precision - 1)
    d = (s - pred) & 0xFFFF
    d = d - (d >= 32768).to(torch.int64) * 65536
    mag = d.abs()
    ssss_table = torch.zeros(32769, dtype=torch.int64, device=dev)
    for k in range(1, 17):
        ssss_table[1 << (k - 1): 1 << k] = k
    ssss_table[32768] = 16
    ssss = ssss_table[mag]
    extra = torch.where(d < 0, d + (torch.ones_like(ssss) << ssss) - 1, d)
    elen = torch.where(d == -32768, torch.zeros_like(ssss), ssss)
    extra = torch.where(elen > 0, extra, torch.zeros_like(extra))

    tid = torch.arange(n_tiles, device=dev)[:, None, None]
    hist = torch.bincount((tid * 17 + ssss).reshape(-1),
                          minlength=n_tiles * 17).view(n_tiles, 17).cpu().numpy()
    tables = [optimal_table(hh) for hh in hist]
    codes = np.stack([canonical_codes(*t) for t in tables])  # [T, 2, 17]
    code_of = torch.from_numpy(codes[:, 0]).to(dev)
    len_of = torch.from_numpy(codes[:, 1]).to(dev)
    flat = (tid * 17 + ssss).reshape(n_tiles, -1)
    vals = (code_of.reshape(-1)[flat] << elen.reshape(n_tiles, -1)) | extra.reshape(n_tiles, -1)
    lens = len_of.reshape(-1)[flat] + elen.reshape(n_tiles, -1)

    # Each tile's scan starts on a byte; its last byte is padded with 1s.
    tile_bits = lens.sum(1)
    tile_bytes = (tile_bits + 7) // 8
    tile_start = torch.cumsum(tile_bytes, 0) - tile_bytes
    pos = tile_start[:, None] * 8 + torch.cumsum(lens, 1) - lens
    total = int(tile_bytes.sum())
    out = torch.zeros(total + 8, dtype=torch.int64, device=dev)
    byte = (pos >> 3).reshape(-1)
    window = (vals << (40 - lens - (pos & 7))).reshape(-1)
    for k in range(5):
        out.index_add_(0, byte + k, (window >> (32 - 8 * k)) & 0xFF)
    pad = tile_bytes * 8 - tile_bits
    last = tile_start + tile_bytes - 1
    out.index_add_(0, last, torch.where(pad > 0, (1 << pad) - 1, 0))
    scan = out[:total].to(torch.uint8).cpu().numpy()

    # Byte stuffing: a 0x00 after every 0xFF.
    ff = scan == 0xFF
    stuffed = np.insert(scan, np.flatnonzero(ff) + 1, 0)
    before = np.concatenate([[0], np.cumsum(ff)])
    starts = tile_start.cpu().numpy()
    ends = starts + tile_bytes.cpu().numpy()
    chunks = []
    for t in range(n_tiles):
        counts, values = tables[t]
        nval = int(counts.sum())
        hdr = bytearray(b"\xff\xd8")
        hdr += struct.pack(">BBHBHHB", 0xFF, M_SOF3, 8 + 3 * 2, precision, th, tw // 2, 2)
        for c in range(2):
            hdr += struct.pack(">BBB", c + 1, 0x11, 0)
        hdr += struct.pack(">BBH", 0xFF, M_DHT, 2 + 1 + 16 + nval) + b"\x00"
        hdr += counts.tobytes() + values[:nval].tobytes()
        hdr += struct.pack(">BBHB", 0xFF, M_SOS, 6 + 2 * 2, 2)
        for c in range(2):
            hdr += struct.pack(">BB", c + 1, 0x00)
        hdr += struct.pack(">BBB", 1, 0, 0)
        a = int(starts[t] + before[starts[t]])
        b = int(ends[t] + before[ends[t]])
        chunks.append(bytes(hdr) + stuffed[a:b].tobytes() + b"\xff\xd9")
    return chunks


# TIFF field types.
BYTE, ASCII, SHORT, LONG, RATIONAL, SRATIONAL = 1, 2, 3, 4, 5, 10
_FMT = {BYTE: "B", SHORT: "H", LONG: "I"}


def _entry(tag, typ, values):
    if typ == ASCII:
        payload = values.encode("ascii") + b"\x00"
        return tag, typ, len(payload), payload
    if typ in (RATIONAL, SRATIONAL):
        fmt = "<II" if typ == RATIONAL else "<ii"
        return tag, typ, len(values), b"".join(struct.pack(fmt, a, b) for a, b in values)
    values = values if isinstance(values, (list, tuple)) else [values]
    return tag, typ, len(values), struct.pack("<" + str(len(values)) + _FMT[typ], *values)


def dng_bytes(mosaic: torch.Tensor, meta: dict) -> bytes:
    """A little-endian CFA DNG of the int32 mosaic [h, w] with ``meta``'s
    levels, CFA layout, ColorMatrix1 (SRATIONAL, denominator 10000),
    AsShotNeutral (RATIONAL, denominator 1000000), make and model."""
    h, w = mosaic.shape
    th, tw = meta["tile"]
    precision = int(meta["bits"])
    chunks = encode_tiles(mosaic, (th, tw), precision)
    cfa = np.asarray(meta["cfa"], dtype=np.uint8)
    entries = [
        _entry(254, LONG, 0), _entry(256, LONG, w), _entry(257, LONG, h),
        _entry(258, SHORT, 16), _entry(259, SHORT, 7), _entry(262, SHORT, 32803),
        _entry(271, ASCII, meta["make"]), _entry(272, ASCII, meta["model"]),
        _entry(274, SHORT, 1), _entry(277, SHORT, 1),
        _entry(322, LONG, tw), _entry(323, LONG, th),
        _entry(324, LONG, [0] * len(chunks)),
        _entry(325, LONG, [len(c) for c in chunks]),
        _entry(33421, SHORT, list(cfa.shape)),
        (33422, BYTE, cfa.size, cfa.tobytes()),
        _entry(50706, BYTE, [1, 4, 0, 0]),
        _entry(50714, SHORT, int(meta["black_level"])),
        _entry(50717, SHORT, int(meta["white_level"])),
        _entry(50721, SRATIONAL, [(int(v), 10000) for v in meta["color_matrix_1e4"]]),
        _entry(50728, RATIONAL, [(int(v), 1000000) for v in meta["as_shot_neutral_1e6"]]),
    ]
    entries.sort(key=lambda e: e[0])
    data_off = 8 + 2 + 12 * len(entries) + 4
    blobs = bytearray()
    offsets = {}
    for tag, _typ, _n, payload in entries:
        if len(payload) > 4:
            offsets[tag] = data_off + len(blobs)
            blobs += payload + (b"\x00" if len(payload) % 2 else b"")
    strip_off = data_off + len(blobs)
    tile_offs = np.cumsum([0] + [len(c) for c in chunks[:-1]]) + strip_off
    packed = struct.pack("<" + str(len(chunks)) + "I", *(int(o) for o in tile_offs))
    if 324 in offsets:
        pos = offsets[324] - data_off
        blobs[pos: pos + len(packed)] = packed
    else:
        entries = [e if e[0] != 324 else (324, LONG, 1, packed) for e in entries]
    buf = bytearray(b"II" + struct.pack("<HI", 42, 8))
    buf += struct.pack("<H", len(entries))
    for tag, typ, n, payload in entries:
        buf += struct.pack("<HHI", tag, typ, n)
        buf += struct.pack("<I", offsets[tag]) if tag in offsets else payload.ljust(4, b"\x00")
    buf += struct.pack("<I", 0)
    return bytes(buf + blobs) + b"".join(chunks)
