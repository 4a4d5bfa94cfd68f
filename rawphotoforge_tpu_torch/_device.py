"""The device rule of the port: every entry point runs on the card unless
the caller asks for the CPU, and there is no silent CPU fallback."""

from __future__ import annotations

import torch

from ._errbase import PhotoEditorError


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. A CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise PhotoEditorError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
