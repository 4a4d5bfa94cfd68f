"""Error taxonomy — the port's user-facing exception surface.

All concrete errors derive from PhotoEditorError; catch that one at the
app boundary (the CLI does).
"""

from ._errbase import PhotoEditorError
from .core.curve import CurveError
from .io.image_io import ImageIOError
from .engine.editor import MaskNotFound

__all__ = [
    "PhotoEditorError",
    "CurveError",
    "ImageIOError",
    "MaskNotFound",
]
