"""Hough votes: top-K edge points → (θ, ρ) accumulator (port of
camkifu_tpu/ops/hough.py, the part the detection score uses).

``hough_accumulate`` launches the shared-memory scatter kernel on a CUDA
tensor and runs its plain version on the CPU.
"""

from __future__ import annotations

import torch

from camkifu_tpu.config import cvconf


def top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last dim → (values, indices).

    Ties keep the lower index first, as ``lax.top_k`` does; ``torch.topk``
    promises no order among ties, and the detector's integer-valued
    projections tie massively.
    """
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def topk_edge_points(mag: torch.Tensor, k: int = cvconf.hough_topk):
    """The K strongest edge pixels of each (..., H, W) map → (xy (..., K, 2)
    float32, weights (..., K)).

    Zero-magnitude padding points get weight 0 (they vote nowhere).
    """
    w = mag.shape[-1]
    vals, idx = top_k(mag.reshape(*mag.shape[:-2], -1), k)
    ys = (idx // w).to(torch.float32)
    xs = (idx % w).to(torch.float32)
    weights = (vals > 0).to(torch.float32) * torch.sqrt(vals.clamp(min=0.0))
    return torch.stack([xs, ys], dim=-1), weights


def hough_accumulate(points: torch.Tensor, weights: torch.Tensor,
                     rho_max: float, n_theta: int = cvconf.hough_thetas,
                     n_rho: int = cvconf.hough_rhos) -> torch.Tensor:
    """Vote K weighted points into an (n_theta, n_rho) accumulator:
    ρ(θ) = x·cosθ + y·sinθ ∈ [-rho_max, rho_max], bilinearly splatted
    into ρ bins, θ spanning [0, π). Points (B, K, 2) with weights (B, K)
    give (B, n_theta, n_rho), one accumulator per frame."""
    from camkifu_tpu_torch.ops.cuda import hough_kernel

    if points.is_cuda:
        return hough_kernel.hough_accumulate(points, weights, rho_max,
                                             n_theta, n_rho)
    return hough_kernel.hough_accumulate_ref(points, weights, rho_max,
                                             n_theta, n_rho)
