"""Table-free packed vendor sensor bitstreams: Sony ARW2 + Panasonic RAW4
— the JAX package's ``io/vendor_packed.py`` on the host, as the port's own
copy.

These are the two compressed vendor RAW schemes that are pure structural
bit-packing — no Huffman tables — so they are re-derivable from the
documented dcraw semantics (``sony_arw2_load_raw`` for ARW2's 16-pixel
max/min/7-bit-delta blocks; ``pana_bits``/``panasonic_load_raw`` for
RW2's 14-pixel predictor groups) without any authoritative table data.

The decoders run in the port's native library (``native/rpf_native.cpp``
``rpf_arw2_decode`` / ``rpf_pana_decode_raw4``) and raise when it cannot
be built: the scalar Python decoders here (``decode_arw2_py``,
``decode_pana_raw4_py``) are the tested oracles, too slow for a sensor.
Decodes of real files are not trusted blindly: the container readers mark
the result ``RawImage.needs_verification`` and ``io.raw.parse_raw``
correlates a host superpixel develop against the file's own embedded
camera preview, refusing the decode (typed DngError -> the caller's
preview fallback) below the 0.9 gate (vendor_raw.CORRELATION_GATE).

Both fixture ENCODERS here exist for the test suite and the smoke run
only — they are not product exporters.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .dng import DngError

# ---------------------------------------------------------------------------
# Sony ARW2 (compression 32767): 8 bits/pixel average. Each row is
# ``width`` bytes; every 32-byte span holds two 16-byte blocks — the
# first covers the span's 16 EVEN columns, the second its 16 ODD columns
# (one CFA color per block). Block layout (little-endian bitstream):
#   bits 0-10   max   (11-bit value of the brightest pixel)
#   bits 11-21  min
#   bits 22-25  imax  (pixel index 0-15 holding max)
#   bits 26-29  imin
#   bits 30-127 fourteen 7-bit deltas for the remaining pixels, in index
#               order; pixel = (delta << sh) + min, clamped to 0x7ff,
#               where sh is the smallest s in 0..4 with 0x80<<s > max-min.
# Decoded 11-bit values map through the Sony tone curve (tag 0x7010) via
# curve[pix*2] into the linear sensor domain.
# ---------------------------------------------------------------------------

ARW2_SPAN = 32


def sony_arw2_curve(knots4=None) -> np.ndarray:
    """Sony ARW2 companding curve -> u16[4096] lookup.

    Knot positions come from raw-IFD tag 0x7010 (four shorts; position =
    (value >> 2) & 0xfff), bracketed by 0 and 4095. Segment i of the five
    spans (knots[i], knots[i+1]] and accumulates slope 2**i on top of the
    previous value; indices not covered by any segment keep their
    identity value (exactly the dcraw tag-28688 semantics, including
    degenerate/unsorted knots). Default knots {0,0,0,0,0,4095} give the
    pure slope-16 curve."""
    knots = [0, 0, 0, 0, 0, 4095]
    if knots4 is not None:
        vals = knots4 if isinstance(knots4, (list, tuple)) else [knots4]
        for i, v in enumerate(vals[:4]):
            knots[i + 1] = (int(v) >> 2) & 0xFFF
    curve = np.arange(4096, dtype=np.int64)
    for i in range(5):
        lo, hi = knots[i], min(knots[i + 1], 4095)
        if hi > lo:
            curve[lo + 1 : hi + 1] = (
                curve[lo] + (1 << i) * np.arange(1, hi - lo + 1, dtype=np.int64)
            )
    return np.clip(curve, 0, 65535).astype(np.uint16)


def _arw2_shift(diff: np.ndarray) -> np.ndarray:
    """Per-block delta shift: smallest sh with 0x80 << sh > max - min
    (sh in 0..4)."""
    d = diff.astype(np.int64)
    return ((d >= 0x80).astype(np.int64) + (d >= 0x100) + (d >= 0x200)
            + (d >= 0x400))


def decode_arw2(payload: bytes, width: int, height: int,
                curve: Optional[np.ndarray] = None) -> np.ndarray:
    """Decode a Sony ARW2 packed stream -> u16 [height, width] mosaic
    (curve-mapped values; black/white tags live in the same domain), in
    the native library."""
    if width % ARW2_SPAN:
        raise DngError(
            f"ARW2 width {width} is not a multiple of 32 (real Sony "
            f"sensor strips are; refusing a partial-span guess)")
    need = width * height
    if len(payload) < need:
        raise DngError(
            f"ARW2 payload is {len(payload)} bytes for {width}x{height} "
            f"(needs {need})")
    if curve is None:
        curve = sony_arw2_curve(None)
    from .. import native

    return native.arw2_decode(payload[:need], width, height,
                              np.asarray(curve, dtype=np.uint16))


def decode_arw2_py(payload: bytes, width: int, height: int,
                   curve: Optional[np.ndarray] = None) -> np.ndarray:
    """Scalar reference ARW2 decoder — a direct transliteration of the
    documented per-block algorithm, kept as the oracle the native
    decode_arw2 is tested against."""
    if width % ARW2_SPAN:
        raise DngError("ARW2 width must be a multiple of 32")
    if curve is None:
        curve = sony_arw2_curve(None)
    curve = np.asarray(curve, dtype=np.uint16)
    out = np.empty((height, width), dtype=np.uint16)
    for row in range(height):
        base_row = row * width
        rb = payload[base_row : base_row + width] + b"\x00\x00"
        col = 0
        dp = 0
        while col < width - 30:
            word = int.from_bytes(rb[dp : dp + 4], "little")
            vmax = word & 0x7FF
            vmin = (word >> 11) & 0x7FF
            imax = (word >> 22) & 0xF
            imin = (word >> 26) & 0xF
            sh = 0
            while sh < 4 and (0x80 << sh) <= vmax - vmin:
                sh += 1
            bit = 30
            for i in range(16):
                if i == imax:
                    pix = vmax
                elif i == imin:
                    pix = vmin
                else:
                    byte = dp + (bit >> 3)
                    w16 = rb[byte] | (rb[byte + 1] << 8 if byte + 1 < len(rb)
                                      else 0)
                    pix = min((((w16 >> (bit & 7)) & 0x7F) << sh) + vmin,
                              0x7FF)
                    bit += 7
                out[row, col] = curve[pix << 1]
                col += 2
            col -= 1 if col & 1 else 31
            dp += 16
    return out


def encode_arw2(mosaic11: np.ndarray) -> bytes:
    """Pack PRE-curve 11-bit values [H, W] into the ARW2 block stream
    (fixture writer). Lossy exactly like the camera: non-extreme pixels
    quantize to (delta << sh) + min with delta 7-bit — exact whenever
    max-min <= 127 in a block (sh == 0), otherwise within (1 << sh)."""
    m = np.asarray(mosaic11)
    if m.ndim != 2 or m.dtype.kind not in "ui":
        raise DngError("encode_arw2 needs an integer [H, W] mosaic")
    if int(m.max(initial=0)) > 0x7FF:
        raise DngError("ARW2 pre-curve values are 11-bit (<= 2047)")
    h, w = m.shape
    if w % ARW2_SPAN:
        raise DngError("ARW2 width must be a multiple of 32")
    nspan = w // ARW2_SPAN
    # Gather blocks: [h, nspan, 2, 16] — phase p slot i <- col 32s+p+2i.
    cols = (ARW2_SPAN * np.arange(nspan)[:, None, None]
            + np.arange(2)[None, :, None]
            + 2 * np.arange(16)[None, None, :])
    px = m[:, cols.reshape(-1)].reshape(h, nspan, 2, 16).astype(np.int64)
    blocks = px.reshape(-1, 16)
    vmax = blocks.max(axis=1)
    vmin = blocks.min(axis=1)
    imax = blocks.argmax(axis=1)
    imin = blocks.argmin(axis=1)
    clash = imax == imin                  # all-equal block
    imin = np.where(clash, (imax + 1) % 16, imin)
    sh = _arw2_shift(vmax - vmin)
    deltas = np.clip((blocks - vmin[:, None]) >> sh[:, None], 0, 0x7F)
    # Serialize: 128-bit little-endian bitstream per block.
    nblk = blocks.shape[0]
    bits = np.zeros((nblk, 128), dtype=np.uint8)

    def put(values, start, nbits):
        for k in range(nbits):
            bits[:, start + k] = (values >> k) & 1

    put(vmax, 0, 11)
    put(vmin, 11, 11)
    put(imax, 22, 4)
    put(imin, 26, 4)
    is_special = ((np.arange(16)[None, :] == imax[:, None])
                  | (np.arange(16)[None, :] == imin[:, None]))
    slot = np.cumsum(~is_special, axis=1) - 1
    # Exactly 14 non-special positions per block (imin != imax by
    # construction) fill slots 0..13; max/min positions scatter into a
    # dummy 15th column so they can never clobber a real delta.
    dstream = np.zeros((nblk, 15), dtype=np.int64)
    np.put_along_axis(dstream,
                      np.where(is_special, 14, np.clip(slot, 0, 13)),
                      np.where(is_special, 0, deltas), axis=1)
    for j in range(14):
        put(dstream[:, j], 30 + 7 * j, 7)
    packed = np.packbits(bits, axis=1, bitorder="little")    # [nblk, 16]
    return packed.reshape(h, nspan, 2, 16).reshape(h, w).tobytes()


# ---------------------------------------------------------------------------
# Panasonic RAW4 (12-bit RW2 bitstream): dcraw pana_bits semantics.
# The stream is a sequence of 0x4000-byte blocks, each stored ROTATED by
# load_flags = 0x2008 (the file block's first bytes land at
# buf[load_flags:]; its tail wraps to buf[:load_flags]). Bits are
# consumed via a decrementing 17-bit counter: vbits -= nbits
# (mod 0x20000); the value is the 16-bit little-endian window at logical
# byte vbits >> 3, shifted by vbits & 7 — i.e. the logical buffer is
# consumed from its END downward. One pixel group (14 columns: 4
# two-bit selectors + twelve 8-bit + two 8+4-bit reads) consumes
# exactly 128 bits, and the descending window positions tile those 16
# bytes with no gap or overlap (the derivation check for this
# re-implementation). Pixels come in 14-column groups with two
# interleaved predictors (even/odd columns):
#   i = col % 14; i == 0 resets pred/nonz state
#   i % 3 == 2 reads a 2-bit selector: sh = 4 >> (3 - v)   (0,1,2,4)
#   first nonzero 8-bit read per parity: pred = nonz << 4 | 4 more bits
#   afterwards: 8-bit j; j != 0 re-bases pred (subtract 0x80 << sh, mask
#   to sh low bits when negative or sh == 4) and adds j << sh.
# ---------------------------------------------------------------------------

PANA_BLOCK = 0x4000
PANA_LOAD_FLAGS = 0x2008


class _PanaBits:
    """Bit reader replicating dcraw's pana_bits exactly (block rotation,
    decrementing counter, 16-bit LE windows)."""

    def __init__(self, data: bytes, load_flags: int = PANA_LOAD_FLAGS):
        self.data = data
        self.pos = 0
        self.load_flags = load_flags
        # +1 slack byte: the final window of a block reads buf[0x4000]
        # (dcraw reads past its buffer; the bits are masked out whenever
        # the stream is well-formed, but the read must not trap).
        self.buf = np.zeros(PANA_BLOCK + 1, dtype=np.uint8)
        self.vbits = 0

    def get(self, nbits: int) -> int:
        if nbits == 0:
            self.vbits = 0
            return 0
        if self.vbits == 0:
            if self.pos >= len(self.data):
                raise DngError("RAW4 bitstream truncated")
            blk = self.data[self.pos : self.pos + PANA_BLOCK]
            self.pos += PANA_BLOCK
            blk = blk.ljust(PANA_BLOCK, b"\x00")
            lf = self.load_flags
            a = np.frombuffer(blk, dtype=np.uint8)
            self.buf[lf:PANA_BLOCK] = a[: PANA_BLOCK - lf]
            self.buf[:lf] = a[PANA_BLOCK - lf :]
        self.vbits = (self.vbits - nbits) & 0x1FFFF
        byte = (self.vbits >> 3) & 0x3FFF
        window = int(self.buf[byte]) | (int(self.buf[byte + 1]) << 8)
        return (window >> (self.vbits & 7)) & ((1 << nbits) - 1)


def decode_pana_raw4_py(payload: bytes, width: int, height: int
                        ) -> np.ndarray:
    """Pure-Python RAW4 decoder: the oracle for the native hot loop (slow
    at full sensor sizes, exact)."""
    bits = _PanaBits(payload)
    out = np.zeros((height, width), dtype=np.uint16)
    for row in range(height):
        pred0 = pred1 = nonz0 = nonz1 = 0
        sh = 0
        for col in range(width):
            i = col % 14
            if i == 0:
                pred0 = pred1 = nonz0 = nonz1 = 0
            if i % 3 == 2:
                sh = 4 >> (3 - bits.get(2))
            odd = i & 1
            nonz = nonz1 if odd else nonz0
            pred = pred1 if odd else pred0
            if nonz:
                j = bits.get(8)
                if j:
                    pred -= 0x80 << sh
                    if pred < 0 or sh == 4:
                        pred &= ~(-1 << sh)
                    pred += j << sh
            else:
                nonz = bits.get(8)
                if nonz or i > 11:
                    pred = (nonz << 4) | bits.get(4)
            if odd:
                pred1, nonz1 = pred, nonz
            else:
                pred0, nonz0 = pred, nonz
            out[row, col] = pred
    return out


def decode_pana_raw4(payload: bytes, width: int, height: int) -> np.ndarray:
    """RAW4 decode in the native library (bit for bit the Python oracle
    decode_pana_raw4_py)."""
    from .. import native

    return native.pana_decode_raw4(payload, width, height)


class _PanaBitWriter:
    """Inverse of _PanaBits: collects (nbits, value) writes at the exact
    window positions the reader will consume, then emits rotated blocks."""

    def __init__(self, load_flags: int = PANA_LOAD_FLAGS):
        self.load_flags = load_flags
        self.blocks: list[np.ndarray] = []
        self.cur = np.zeros(PANA_BLOCK + 1, dtype=np.uint16)
        self.vbits = 0
        self.started = False

    def put(self, nbits: int, value: int) -> None:
        if nbits == 0:
            return
        if self.vbits == 0 and self.started:
            self._flush_block()
        self.started = True
        self.vbits = (self.vbits - nbits) & 0x1FFFF
        byte = (self.vbits >> 3) & 0x3FFF
        # The 16-bit LE window at ``byte``: value bits [shift, shift+n)
        # live in the u16 slot; bits >= 8 belong to logical byte+1 and
        # fold over at flush. shift <= 7 and n <= 8 always fit 15 bits.
        self.cur[byte] |= (value & ((1 << nbits) - 1)) << (self.vbits & 7)

    def _flush_block(self) -> None:
        # Fold the u16 slots into bytes: slot k's bits 8-15 are logical
        # byte k+1's bits 0-7 (the high half of the 16-bit window).
        buf = np.zeros(PANA_BLOCK + 2, dtype=np.uint16)
        buf[: PANA_BLOCK + 1] = self.cur
        lo = buf[: PANA_BLOCK + 1] & 0xFF
        hi = buf[: PANA_BLOCK + 1] >> 8
        out = lo.copy()
        out[1:] |= hi[:-1]
        logical = (out & 0xFF).astype(np.uint8)[:PANA_BLOCK]
        lf = self.load_flags
        rotated = np.concatenate([logical[lf:], logical[:lf]])
        self.blocks.append(rotated)
        self.cur = np.zeros(PANA_BLOCK + 1, dtype=np.uint16)

    def tobytes(self) -> bytes:
        if self.started:
            self._flush_block()
        return b"".join(blk.tobytes() for blk in self.blocks)


def encode_pana_raw4(mosaic12: np.ndarray) -> bytes:
    """Pack a 12-bit mosaic into a RAW4 bitstream (fixture writer).

    Encoding policy: the 2-bit shift selector is always 0 (sh = 0) and
    every pixel takes either the initial path (first per-parity sample
    of each 14-column group: pred = v>>4 << 4 | v&15, needing v >= 16 or
    v == 0) or the sh=0 continuation (j = v - max(pred-128, 0), needing
    j in {0} + [1, 255]). Raises DngError when a sample is not exactly
    representable under this policy — fixtures use smooth content, which
    always is. Round-trips bit-exactly through decode_pana_raw4."""
    m = np.asarray(mosaic12)
    if m.ndim != 2 or m.dtype.kind not in "ui":
        raise DngError("encode_pana_raw4 needs an integer [H, W] mosaic")
    if int(m.max(initial=0)) > 0xFFF:
        raise DngError("RAW4 values are 12-bit (<= 4095)")
    h, w = m.shape
    wr = _PanaBitWriter()
    for row in range(h):
        vals = m[row]
        pred = [0, 0]
        nonz = [0, 0]
        for col in range(w):
            i = col % 14
            if i == 0:
                pred = [0, 0]
                nonz = [0, 0]
            if i % 3 == 2:
                wr.put(2, 0)  # selector 0 -> sh = 4 >> 3 = 0
            p = i & 1
            v = int(vals[col])
            if nonz[p]:
                base = pred[p] - 0x80
                if base < 0:
                    base = 0
                if v == pred[p]:
                    wr.put(8, 0)
                else:
                    j = v - base
                    if not 1 <= j <= 255:
                        raise DngError(
                            f"sample {v} at ({row},{col}) not "
                            f"representable from pred {pred[p]} under the "
                            f"sh=0 fixture policy")
                    wr.put(8, j)
                    pred[p] = base + j
            else:
                hi4, lo4 = v >> 4, v & 15
                if hi4 == 0 and not (v == 0 or i > 11):
                    raise DngError(
                        f"sample {v} < 16 at ({row},{col}) needs a "
                        f"nonzero leading byte (fixture policy)")
                wr.put(8, hi4)
                if hi4 or i > 11:
                    wr.put(4, lo4)
                    pred[p] = (hi4 << 4) | lo4
                nonz[p] = hi4
    return wr.tobytes()
