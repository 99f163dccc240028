"""Color conversions on tensors (port of camkifu_tpu/ops/color.py)."""

from __future__ import annotations

import torch

# ITU-R BT.601 luma weights, identical to cv2.cvtColor(..., COLOR_RGB2GRAY).
_LUMA = (0.299, 0.587, 0.114)


def to_float(frame: torch.Tensor) -> torch.Tensor:
    """uint8 [0,255] → float32 [0,1]. No-op for float inputs."""
    if frame.dtype == torch.uint8:
        return frame.to(torch.float32) / 255.0
    return frame.to(torch.float32)


def rgb_to_gray(frame: torch.Tensor) -> torch.Tensor:
    """(..., 3) RGB → (...,) luma, same scale as input."""
    f = frame.to(torch.float32)
    # Written out term by term, so every device rounds the same sums.
    return (f[..., 0] * _LUMA[0] + f[..., 1] * _LUMA[1]) + f[..., 2] * _LUMA[2]


def rgb_to_gray_u8(frame: torch.Tensor) -> torch.Tensor:
    """(..., 3) RGB (uint8 or float in [0,1]) → (...,) uint8 luma, rounded
    half up and clipped, as the reference does."""
    g = rgb_to_gray(frame)
    if frame.dtype != torch.uint8:
        g = g * 255.0
    return torch.clamp(g + 0.5, 0.0, 255.0).to(torch.uint8)
