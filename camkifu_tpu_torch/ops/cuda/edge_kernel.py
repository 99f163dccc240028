"""Fused edge magnitudes on the card: blur + Sobel + NMS in one kernel.

Replaces ``camkifu_tpu/ops/pallas/edge_kernel.py:edge_magnitude`` (and its
batch-grid twin ``edge_magnitude_batch``); the CUDA source is
``camkifu_tpu_torch/csrc/edge.cu``.

What bounds it on the card: the plain path writes and rereads the blurred
image, both gradients and the magnitude (about 6 float32 passes over the
image); the kernel reads each pixel once (plus a 6-px halo per 32×32 tile,
~1.9× the tile) and writes it once. A 256² float32 image (256 KB) does not
fit one block's shared memory, so each block holds one tile and its halo
(~25 KB) and runs every stage there.

Contract (both versions): (N, H, W) or (H, W) float32 gray in [0, 1] →
the same shape of NMS magnitudes, zero within ``BORDER`` px of the edge;
exact in the interior, where the stencils (radius 6 ≤ BORDER) never reach
the padding.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from camkifu_tpu_torch.ops.cuda import _build
from camkifu_tpu_torch.ops.edges import nms_magnitude
from camkifu_tpu_torch.ops.filters import gaussian_blur, \
    gaussian_kernel1d, sobel

BORDER = 8

#: Kernel launches since the last reset (one per call on a CUDA tensor).
launches = 0

#: Launches by the number of maps they covered, reset with ``launches``.
sizes: collections.Counter = collections.Counter()


def _check(gray: torch.Tensor) -> None:
    if gray.dtype != torch.float32:
        raise TypeError(f"edge_magnitude takes float32, got {gray.dtype}")
    if gray.ndim not in (2, 3):
        raise ValueError(f"edge_magnitude takes (H, W) or (N, H, W), "
                         f"got {tuple(gray.shape)}")


def edge_magnitude(gray: torch.Tensor, sigma: float = 1.4) -> torch.Tensor:
    """The CUDA kernel. ``gray`` must be a contiguous float32 CUDA tensor."""
    global launches
    _check(gray)
    if not gray.is_cuda:
        raise ValueError("edge_magnitude launches on CUDA tensors only; "
                         "use edge_magnitude_ref on the CPU")
    if not gray.is_contiguous():
        raise ValueError("edge_magnitude needs a contiguous tensor")
    lib = _build.lib()
    taps = gaussian_kernel1d(sigma)
    if len(taps) != lib.camkifu_edge_taps():
        raise ValueError(f"the edge kernel is built for "
                         f"{lib.camkifu_edge_taps()} taps; sigma={sigma} "
                         f"gives {len(taps)}")
    x = gray if gray.ndim == 3 else gray[None]
    n, h, w = x.shape
    out = torch.empty_like(x)
    if n and h and w:
        host_taps = (ctypes.c_float * len(taps))(*taps.tolist())
        with torch.cuda.device(x.device):
            code = lib.camkifu_edge(x.data_ptr(), out.data_ptr(), n, h, w,
                                    BORDER, host_taps,
                                    _build.stream_handle(x.device))
        _build.check(code, "edge")
        launches += 1
        sizes[n] += 1
    return out if gray.ndim == 3 else out[0]


def edge_magnitude_ref(gray: torch.Tensor, sigma: float = 1.4) -> torch.Tensor:
    """Plain PyTorch version of the kernel's contract, on any device."""
    _check(gray)
    gx, gy = sobel(gaussian_blur(gray, sigma))
    mag = nms_magnitude(gx, gy)
    h, w = mag.shape[-2:]
    rows = torch.arange(h, device=mag.device)[:, None]
    cols = torch.arange(w, device=mag.device)[None, :]
    interior = ((rows >= BORDER) & (rows < h - BORDER)
                & (cols >= BORDER) & (cols < w - BORDER))
    return torch.where(interior, mag, 0.0)
