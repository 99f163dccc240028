"""Separable filters: Gaussian blur, Sobel gradients (port of
camkifu_tpu/ops/filters.py).

Shift-accumulate over edge-padded slices, as the reference does, so the
sums run term by term in its order. The blur and Sobel that detection runs
at 256² on the card are fused into the edge kernel (ops/cuda/edge_kernel.py);
these versions serve the CPU path and the rectified-canvas profiles.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def gaussian_kernel1d(sigma: float, radius: int | None = None) -> np.ndarray:
    if radius is None:
        radius = max(1, int(3.0 * sigma + 0.5))
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def edge_pad(x: torch.Tensor, before: int, after: int,
             dim: int) -> torch.Tensor:
    """Pad one dim by repeating its edge values (``jnp.pad(mode="edge")``)."""
    moved = x.movedim(dim, -1)
    flat = moved.reshape(-1, 1, moved.shape[-1])
    padded = F.pad(flat, (before, after), mode="replicate")
    return padded.reshape(*moved.shape[:-1], -1).movedim(-1, dim)


def _conv1d(img: torch.Tensor, kernel: np.ndarray, axis: int) -> torch.Tensor:
    """Convolve the last two dims of ``img`` along ``axis`` (0 = rows,
    1 = columns of the image) with edge padding: shifted slices of the
    padded image, summed tap by tap in the reference's order."""
    k = np.asarray(kernel, np.float32)
    r = (len(k) - 1) // 2
    img = img.to(torch.float32)
    dim = img.ndim - 2 + axis
    padded = edge_pad(img, r, r, dim)
    n = img.shape[dim]
    out = None
    for i, t in enumerate(k):
        sl = padded.narrow(dim, i, n)
        out = float(t) * sl if out is None else out + float(t) * sl
    return out


def gaussian_blur(img: torch.Tensor, sigma: float = 1.4) -> torch.Tensor:
    """Separable Gaussian blur of (..., H, W) images."""
    k = gaussian_kernel1d(sigma)
    return _conv1d(_conv1d(img, k, 0), k, 1)


# Sobel kernels (cv2 convention).
_SOBEL_SMOOTH = np.array([1.0, 2.0, 1.0], np.float32)
_SOBEL_DIFF = np.array([-1.0, 0.0, 1.0], np.float32)


def sobel(img: torch.Tensor):
    """Sobel gradients of (..., H, W) images → (gx, gy)."""
    gx = _conv1d(_conv1d(img, _SOBEL_SMOOTH, 0), _SOBEL_DIFF, 1)
    gy = _conv1d(_conv1d(img, _SOBEL_DIFF, 0), _SOBEL_SMOOTH, 1)
    return gx, gy
