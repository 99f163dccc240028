"""Edge detection: Sobel magnitude + non-maximum suppression + hysteresis
(port of camkifu_tpu/ops/edges.py).

``edge_map`` and ``edge_map_batch`` take the fused edge kernel and the
hysteresis kernel (its thresholds selected in the same launch) on a CUDA
tensor and the plain paths on the CPU, as the
reference takes its Pallas kernel on its accelerator and the XLA path
elsewhere.
"""

from __future__ import annotations

import numpy as np
import torch

from camkifu_tpu_torch.ops.cuda import hysteresis_kernel
from camkifu_tpu_torch.ops.filters import gaussian_blur, sobel

#: Double threshold + fixed-iteration strong-edge propagation, plain
#: version (any device); ``edge_map_batch`` takes the kernel on the card.
hysteresis = hysteresis_kernel.hysteresis_ref


def _shift2(img, dy, dx):
    return torch.roll(img, shifts=(dy, dx), dims=(-2, -1))


def nms_magnitude(gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """Gradient magnitude with non-maximum suppression along the gradient
    direction, quantized to 4 sectors by ratio tests (no atan2).

    Neighbours wrap around the image border (``torch.roll``), as
    ``jnp.roll`` does in the reference."""
    mag = torch.sqrt(gx * gx + gy * gy)
    t1, t2 = float(np.tan(np.pi / 8)), float(np.tan(3 * np.pi / 8))
    ax, ay = gx.abs(), gy.abs()
    sector = torch.where(
        ay < t1 * ax, 0,
        torch.where(ay > t2 * ax, 2, torch.where(gx * gy >= 0, 1, 3)))
    # Neighbor offsets for each sector: 0→E/W, 1→NE/SW, 2→N/S, 3→NW/SE.
    n1 = torch.stack([_shift2(mag, 0, 1), _shift2(mag, 1, 1),
                      _shift2(mag, 1, 0), _shift2(mag, 1, -1)])
    n2 = torch.stack([_shift2(mag, 0, -1), _shift2(mag, -1, -1),
                      _shift2(mag, -1, 0), _shift2(mag, -1, 1)])
    sel1 = torch.gather(n1, 0, sector[None])[0]
    sel2 = torch.gather(n2, 0, sector[None])[0]
    keep = (mag >= sel1) & (mag >= sel2)
    return torch.where(keep, mag, 0.0)


def percentile(x: torch.Tensor, q: float, dim: int | None = None
               ) -> torch.Tensor:
    """``jnp.percentile(x, q)`` (linear interpolation): over all elements,
    or over ``dim`` alone."""
    if dim is None:
        x, dim = x.reshape(-1), 0
    return torch.quantile(x, q / 100.0, dim=dim, interpolation="linear")


def edge_map(gray: torch.Tensor, sigma: float = 1.4,
             low_frac: float = 0.15, high_frac: float = 0.4,
             hysteresis_iters: int = 4) -> torch.Tensor:
    """Full edge stack on a 2D gray image in [0, 1] → NMS edge magnitudes
    (``edge_map_batch`` of one frame)."""
    return edge_map_batch(gray[None], sigma, low_frac, high_frac,
                          hysteresis_iters)[0]


def edge_map_batch(grays: torch.Tensor, sigma: float = 1.4,
                   low_frac: float = 0.15, high_frac: float = 0.4,
                   hysteresis_iters: int = 4) -> torch.Tensor:
    """``edge_map`` over a batch: (N, H, W) gray in [0, 1] → (N, H, W).

    On a CUDA tensor blur+Sobel+NMS run as the fused edge kernel, one call
    for all N, and the thresholds and the hysteresis as one more launch
    (``hysteresis_adaptive``); on the CPU all of it runs as plain tensor
    ops. Both give the route the reference takes off the TPU: edge padding,
    NMS neighbours wrapped, no border band. Thresholds are fractions of
    each frame's own 99.5th percentile of a 2×-strided view, selected on
    the device; the kernel takes at most ``hysteresis_kernel.MAX_ITERS``
    steps.
    """
    if grays.is_cuda:
        from camkifu_tpu_torch.ops.cuda.edge_kernel import edge_magnitude

        mags = edge_magnitude(grays.contiguous(), sigma=sigma)
        return hysteresis_kernel.hysteresis_adaptive(
            mags, low_frac, high_frac, hysteresis_iters)
    gx, gy = sobel(gaussian_blur(grays, sigma))
    mags = nms_magnitude(gx, gy)
    return hysteresis_kernel.hysteresis_adaptive_ref(
        mags, low_frac, high_frac, hysteresis_iters)
