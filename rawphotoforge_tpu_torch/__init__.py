"""rawphotoforge_tpu_torch — the PyTorch/CUDA port of rawphotoforge_tpu.

Same module layout and names as the JAX package; plain functions on
torch tensors inside, an explicit ``device=`` on every entry point (the
card by default, the CPU only on request), and the develop kernel written
by hand in CUDA C++ for Hopper (``csrc/``). Imports neither jax nor the
JAX package.
"""

__version__ = "0.1.0"

from .core.params import (  # noqa: F401
    BRIGHTNESS,
    HUE,
    SATURATION,
    LIGHTNESS,
    EditParameters,
    DevelopParams,
    pack_params,
)
from .core.curve import CURVE_RESOLUTION  # noqa: F401
from .ops.develop import develop, develop_batch  # noqa: F401
from .engine.editor import PhotoEditor  # noqa: F401
