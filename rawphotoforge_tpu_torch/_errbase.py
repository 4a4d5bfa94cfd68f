"""Leaf module holding the error base class (no intra-package imports, so
every origin module can inherit from it without cycles)."""


class PhotoEditorError(Exception):
    """Base class for all framework errors (parity with the reference's
    PhotoEditorError enum, rust/photo-editor/src/errors.rs:7-49)."""


class JpegWireDataError(PhotoEditorError, ValueError):
    """The data a JPEG wire carries broke a condition of that wire: a
    coefficient outside the baseline Huffman domain, or a stream whose
    lengths and totals do not add up. ``io/jpegenc.encode_jpeg`` degrades
    to the next wire on this error and on no other."""


class NotPortedError(PhotoEditorError):
    """A feature of the JAX package that the port does not have yet; the
    message names the ROADMAP.md item that brings it."""

    def __init__(self, what: str, item: str):
        super().__init__(
            f"{what} is not ported yet (ROADMAP.md, still to port: {item})")
