"""Hough vote accumulator on the card: a shared-memory scatter per θ row.

Replaces ``camkifu_tpu/ops/pallas/hough_kernel.py:hough_accumulate_pallas``;
the CUDA source is ``camkifu_tpu_torch/csrc/hough.cu``.

What bounds it on the card: the accumulator of one θ row (n_ρ floats,
1 KB at 256) lives in shared memory, so the only device-memory traffic is
K points read per row (from L2 after the first block) and one write of the
(n_θ, n_ρ) result; the time goes to 2·K shared-memory atomics per row. A
batch of frames is one launch, grid (n_θ, B): 8,192 blocks at B = 64. The
TPU version built (chunk, n_ρ) one-hot splat matrices for its MXU instead;
the plain version below does the same with explicit sums, in θ chunks,
one frame at a time.

Contract (both versions): (K, 2) or (B, K, 2) float32 (x, y) points and
(K,) or (B, K) float32 weights → (n_θ, n_ρ) or (B, n_θ, n_ρ) float32
votes, ρ(θ) = x·cosθ + y·sinθ splatted bilinearly into bins over
[-rho_max, rho_max], θ at (i + 0.5)·π/n_θ.
"""

from __future__ import annotations

import collections
import numpy as np
import torch

from camkifu_tpu_torch.ops.cuda import _build

#: Kernel launches since the last reset (one per call on a CUDA tensor).
launches = 0

#: Launches by the number of frames they covered, reset with ``launches``.
sizes: collections.Counter = collections.Counter()

#: θ rows per step of the plain version: its one-hot temporaries are
#: (rows, K, n_ρ), 64 MB of float32 at K = 4096, n_ρ = 256. It steps
#: through a batch one frame at a time, so that bound holds at any B.
REF_ROWS = 16

#: The grid's y dimension carries the frames.
MAX_BATCH = 65535

#: Largest n_ρ whose row fits the 48 KB of dynamic shared memory a launch
#: gets without opting in to more.
MAX_RHOS = 12288


def _trig(n_theta: int, device) -> torch.Tensor:
    thetas = (torch.arange(n_theta, dtype=torch.float32, device=device)
              + 0.5) * float(np.pi / n_theta)
    return torch.stack([torch.cos(thetas), torch.sin(thetas)], dim=-1)


def _bins(n_rho: int, rho_max: float):
    """(rho_scale, upper clip of the bin position), float32 as the
    reference rounds them."""
    f32 = np.float32
    rho_scale = f32(n_rho - 1) / (f32(2.0) * f32(rho_max))
    return float(rho_scale), float(f32(n_rho - 1.001))


def _check(points: torch.Tensor, weights: torch.Tensor) -> None:
    if points.dtype != torch.float32 or weights.dtype != torch.float32:
        raise TypeError("hough_accumulate takes float32 points and weights")
    if points.ndim not in (2, 3) or points.shape[-1] != 2 \
            or weights.shape != points.shape[:-1]:
        raise ValueError(f"hough_accumulate takes (K, 2) or (B, K, 2) "
                         f"points and (K,) or (B, K) weights, got "
                         f"{tuple(points.shape)} and {tuple(weights.shape)}")


def hough_accumulate(points: torch.Tensor, weights: torch.Tensor,
                     rho_max: float, n_theta: int = 128,
                     n_rho: int = 256) -> torch.Tensor:
    """The CUDA kernel; contiguous float32 CUDA tensors only."""
    global launches
    _check(points, weights)
    if not (points.is_cuda and weights.is_cuda):
        raise ValueError("hough_accumulate launches on CUDA tensors only; "
                         "use hough_accumulate_ref on the CPU")
    if not (points.is_contiguous() and weights.is_contiguous()):
        raise ValueError("hough_accumulate needs contiguous tensors")
    if not 2 <= n_rho <= MAX_RHOS:
        raise ValueError(f"n_rho must lie in [2, {MAX_RHOS}], got {n_rho}")
    pts = points if points.ndim == 3 else points[None]
    b, k = pts.shape[0], pts.shape[1]
    if b > MAX_BATCH:
        raise ValueError(f"at most {MAX_BATCH} frames per launch, got {b}")
    out = torch.empty((b, n_theta, n_rho), dtype=torch.float32,
                      device=points.device)
    if out.numel():
        lib = _build.lib()
        trig = _trig(n_theta, points.device)
        rho_scale, pos_hi = _bins(n_rho, rho_max)
        with torch.cuda.device(points.device):
            code = lib.camkifu_hough(pts.data_ptr(), weights.data_ptr(),
                                     trig.data_ptr(), out.data_ptr(), b, k,
                                     n_theta, n_rho, float(rho_max),
                                     rho_scale, pos_hi,
                                     _build.stream_handle(points.device))
        _build.check(code, "hough")
        launches += 1
        sizes[b] += 1
    return out if points.ndim == 3 else out[0]


def hough_accumulate_ref(points: torch.Tensor, weights: torch.Tensor,
                         rho_max: float, n_theta: int = 128,
                         n_rho: int = 256) -> torch.Tensor:
    """Plain PyTorch version: the splat as one-hot comparisons and sums
    over the points, one frame and ``REF_ROWS`` θ rows at a time."""
    _check(points, weights)
    if points.ndim == 3:
        out = torch.empty((points.shape[0], n_theta, n_rho),
                          dtype=torch.float32, device=points.device)
        for i in range(points.shape[0]):
            out[i] = hough_accumulate_ref(points[i], weights[i], rho_max,
                                          n_theta, n_rho)
        return out
    trig = _trig(n_theta, points.device)
    rho_scale, pos_hi = _bins(n_rho, rho_max)
    x, y = points[:, 0], points[:, 1]
    bins = torch.arange(n_rho, dtype=torch.float32, device=points.device)
    rows = []
    for t0 in range(0, n_theta, REF_ROWS):
        c = trig[t0:t0 + REF_ROWS, 0:1]
        s = trig[t0:t0 + REF_ROWS, 1:2]
        rho = x[None, :] * c + y[None, :] * s                  # (c, K)
        pos = torch.clamp((rho + rho_max) * rho_scale, 0.0, pos_hi)
        lo = torch.floor(pos)
        frac = pos - lo
        w_lo = ((1.0 - frac) * weights)[..., None]             # (c, K, 1)
        w_hi = (frac * weights)[..., None]
        onehot_lo = bins == lo[..., None]                      # (c, K, R)
        onehot_hi = bins == lo[..., None] + 1.0
        rows.append((onehot_lo * w_lo + onehot_hi * w_hi).sum(dim=1))
    return torch.cat(rows)
