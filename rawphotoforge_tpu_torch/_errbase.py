"""Leaf module holding the error base class (no intra-package imports, so
every origin module can inherit from it without cycles)."""


class PhotoEditorError(Exception):
    """Base class for all framework errors (parity with the reference's
    PhotoEditorError enum, rust/photo-editor/src/errors.rs:7-49)."""


class NotPortedError(PhotoEditorError):
    """A feature of the JAX package that the port does not have yet; the
    message names the ROADMAP.md item that brings it."""

    def __init__(self, what: str, item: str):
        super().__init__(
            f"{what} is not ported yet (ROADMAP.md, still to port: {item})")
