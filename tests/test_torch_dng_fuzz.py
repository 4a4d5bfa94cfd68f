"""The port's counterpart of tests/test_dng_fuzz.py: every mutation of a
valid container (truncation, byte flips, zeroed spans) must decode or
raise the port's typed PhotoEditorError, and the port must decide as the
JAX package does on the same bytes (both decode to the same mosaic, or
both raise)."""

import zlib

import numpy as np
import pytest

from rawphotoforge_tpu._errbase import PhotoEditorError as JaxPhotoEditorError
from rawphotoforge_tpu.io import dng as jdng

from rawphotoforge_tpu_torch._errbase import PhotoEditorError
from rawphotoforge_tpu_torch.io import dng

from test_dng_fuzz import _variants

_VARIANTS = _variants()


def mutate(data: bytes, rng, trial: int) -> bytes:
    """tests/test_dng_fuzz.py's mutations: truncate, flip 1-7 random
    bytes, or zero a span of up to 63 bytes, by ``trial % 3``."""
    buf = bytearray(data)
    kind = trial % 3
    if kind == 0:
        buf = buf[: int(rng.integers(1, len(buf)))]
    elif kind == 1:
        for _ in range(int(rng.integers(1, 8))):
            buf[int(rng.integers(0, len(buf)))] = int(rng.integers(0, 256))
    else:
        a = int(rng.integers(0, len(buf) - 1))
        b = min(len(buf), a + int(rng.integers(1, 64)))
        buf[a:b] = bytes(b - a)
    return bytes(buf)


def _outcome(parse, typed, data):
    """("ok", result) or ("typed", None); any other exception is returned
    as ("untyped", description)."""
    try:
        return "ok", parse(data)
    except typed:
        return "typed", None
    except Exception as e:  # noqa: BLE001 -- the finding under test
        return "untyped", f"{type(e).__name__}: {str(e)[:120]}"


def _same_mosaic(a, b) -> bool:
    """Integer mosaics equal; float ones (opcode gains, float DNGs) within
    the lens-correction parity bound of tests/test_torch_lenscorr.py."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.kind in "ui":
        return bool(np.array_equal(a, b))
    return bool(np.allclose(a, b, rtol=1e-5, atol=1e-6, equal_nan=True))


def _same_decisions(name, data, trials, port_parse, jax_parse, seed):
    rng = np.random.default_rng(seed)
    failures = []
    for trial in range(trials):
        buf = mutate(data, rng, trial)
        ours, got = _outcome(port_parse, PhotoEditorError, buf)
        theirs, ref = _outcome(jax_parse, JaxPhotoEditorError, buf)
        if ours == "untyped" or ours != theirs:
            failures.append((name, trial, ours, theirs, got if ours == "untyped" else ""))
        elif ours == "ok" and not _same_mosaic(got.mosaic, ref.mosaic):
            failures.append((name, trial, "mosaic", got.mosaic.shape, ref.mosaic.shape))
    return failures


@pytest.mark.parametrize("name", sorted(_VARIANTS))
def test_mutations_raise_typed_errors_where_jax_does(name):
    data = _VARIANTS[name]
    assert dng.read_dng(data).mosaic.shape == jdng.read_dng(data).mosaic.shape
    failures = _same_decisions(name, data, 120, dng.read_dng, jdng.read_dng,
                               zlib.crc32(name.encode()))
    assert not failures, failures[:5]


def test_cr2_mutations_raise_typed_errors_where_jax_does():
    from rawphotoforge_tpu.io.raw import parse_raw as jparse

    from rawphotoforge_tpu_torch.io.raw import parse_raw
    from torch_fixtures import build_cr2

    rng = np.random.default_rng(42)
    data = build_cr2(rng.integers(0, 16000, size=(48, 48), dtype=np.uint16))
    np.testing.assert_array_equal(parse_raw(data).mosaic, jparse(data).mosaic)
    failures = _same_decisions("cr2", data, 150, parse_raw, jparse, 42)
    assert not failures, failures[:5]


def test_cyclic_ifd_chain_terminates():
    """A next-IFD pointer looping back to IFD0 must not hang the port's
    parser."""
    import struct

    raw = dng.RawImage(
        mosaic=np.random.default_rng(0).integers(0, 4000, size=(8, 8), dtype=np.uint16),
        pattern="RGGB", black_level=0.0, white_level=16383.0,
        wb_gains=(1.0, 1.0, 1.0), xyz_to_cam=None)
    data = bytearray(dng.write_dng(raw))
    (n_entries,) = struct.unpack_from("<H", data, 8)
    next_ptr_at = 8 + 2 + n_entries * 12
    assert struct.unpack_from("<I", data, next_ptr_at)[0] == 0
    struct.pack_into("<I", data, next_ptr_at, 8)
    back = dng.read_dng(bytes(data))
    np.testing.assert_array_equal(back.mosaic, raw.mosaic)
    np.testing.assert_array_equal(jdng.read_dng(bytes(data)).mosaic, raw.mosaic)


def test_truncated_chunk_grid_rejected():
    """A chunk list that does not cover the strip/tile grid raises the
    port's DngError, not a silently black region."""
    with pytest.raises(dng.DngError, match="grid"):
        dng._assemble_chunks(lambda i, h, w: np.zeros((h, w), np.uint16),
                             2, 32, 32, 16, 16, np.uint16, tiled=True)
    with pytest.raises(dng.DngError, match="geometry"):
        dng._assemble_chunks(lambda i, h, w: np.zeros((h, w), np.uint16),
                             1, 32, 32, 0, 32, np.uint16, tiled=False)
