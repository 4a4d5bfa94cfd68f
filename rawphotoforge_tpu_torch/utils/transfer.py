"""Device->host transfer helpers.

The reference's readback is one aligned copy (rust/photo-editor/src/
image.rs:202-276); on a locally attached card one ``.cpu()`` copy is the
right shape. Export quantization runs on the device first, so the copy
carries 1 (u8) or 2 (u16) bytes per sample instead of 4.
"""

from __future__ import annotations

import numpy as np
import torch


def fetch_np(t: torch.Tensor) -> np.ndarray:
    """Any tensor -> numpy on the host (one device->host copy)."""
    return t.detach().cpu().numpy()


def fetch_u8_hwc(planes: torch.Tensor) -> np.ndarray:
    """sRGB f32 planes [3,H,W] in [0,1] -> u8 HWC on the host, quantized
    and transposed on the device (truncating cast, image.rs:375-383)."""
    u8 = (torch.clamp(planes, 0.0, 1.0) * 255.0).to(torch.uint8)
    return fetch_np(u8.permute(1, 2, 0).contiguous())


def fetch_u16_hwc(planes: torch.Tensor) -> np.ndarray:
    """sRGB f32 planes [3,H,W] in [0,1] -> u16 HWC on the host, quantized
    on the device. The values (0..65535) go through i32 into i16, keeping
    their low 16 bits, and are read back as u16: 2 bytes per sample, and
    only casts every build of torch has on the card."""
    q = (torch.clamp(planes, 0.0, 1.0) * 65535.0).to(torch.int32)
    q16 = q.to(torch.int16).permute(1, 2, 0).contiguous()
    return fetch_np(q16).view(np.uint16)
