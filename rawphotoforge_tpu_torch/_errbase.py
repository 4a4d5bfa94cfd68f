"""Leaf module holding the error base class (no intra-package imports, so
every origin module can inherit from it without cycles)."""


class PhotoEditorError(Exception):
    """Base class for all framework errors (parity with the reference's
    PhotoEditorError enum, rust/photo-editor/src/errors.rs:7-49)."""
