"""Float32 rounding rules shared by the port's plain torch code."""

from __future__ import annotations

import torch


def div(x: torch.Tensor, s: float) -> torch.Tensor:
    """``x / s`` as one correctly rounded f32 division, on every device.

    On the card torch divides a tensor by a Python (or CPU) scalar by
    multiplying with the scalar's reciprocal, which can land an ulp away
    from the quotient the CUDA kernel and the JAX package compute — enough
    to flip a ``floor(v * 65535)`` LUT step. A divisor that lies on the
    tensor's own device takes the true-division path.
    """
    return x / torch.full((), s, dtype=torch.float32, device=x.device)
