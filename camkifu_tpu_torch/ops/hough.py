"""Hough line transform: top-K edge votes → (θ, ρ) accumulator → line
peaks (port of camkifu_tpu/ops/hough.py).

``hough_accumulate`` launches the shared-memory scatter kernel on a CUDA
tensor and runs its plain version on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from camkifu_tpu_torch.config import cvconf


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


def peak_lines(acc: torch.Tensor, rho_max: float, n_peaks: int = 32,
               nms_size: int = 5, min_frac: float = 0.15):
    """NMS peaks of (..., n_theta, n_rho) accumulators → (theta (..., N),
    rho (..., N), votes (..., N)).

    θ in radians [0, π), ρ in pixels, sub-bin ρ by a parabolic fit. Peaks
    under min_frac · max get votes 0 (padding). θ wraps: the rows past
    either end are the other end's, ρ-flipped.
    """
    n_theta, n_rho = acc.shape[-2:]
    lead = acc.shape[:-2]
    # Smooth lightly in ρ to merge adjacent-bin splat mass.
    sm = 0.25 * torch.roll(acc, 1, -1) + 0.5 * acc \
        + 0.25 * torch.roll(acc, -1, -1)
    r = nms_size // 2
    padded = torch.cat([torch.flip(sm[..., -r:, :], (-1,)), sm,
                        torch.flip(sm[..., :r, :], (-1,))], dim=-2)
    # reduce_window max with a −inf init and SAME padding.
    win = F.max_pool2d(padded.reshape(-1, 1, n_theta + 2 * r, n_rho),
                       nms_size, stride=1, padding=r)
    win = win.reshape(*lead, n_theta + 2 * r, n_rho)[..., r:r + n_theta, :]
    top = sm.amax(dim=(-2, -1), keepdim=True)
    is_peak = (sm >= win) & (sm >= min_frac * top)
    flat = sm.reshape(*lead, -1)
    vals, idx = top_k(torch.where(is_peak, sm, 0.0).reshape(*lead, -1),
                      n_peaks)
    ti = idx // n_rho
    ri = idx % n_rho

    def at(rr):
        return torch.gather(flat, -1, ti * n_rho + torch.clamp(rr, 0,
                                                               n_rho - 1))

    # Parabolic sub-bin ρ refinement.
    rm1, r0, rp1 = at(ri - 1), at(ri), at(ri + 1)
    denom = rm1 - 2 * r0 + rp1
    delta = torch.where(torch.abs(denom) > 1e-6,
                        0.5 * (rm1 - rp1) / denom, 0.0)
    delta = torch.clamp(delta, -0.5, 0.5)
    theta = (ti.to(torch.float32) + 0.5) * (np.pi / n_theta)
    rho_bin = ri.to(torch.float32) + delta
    rho = rho_bin * (2.0 * rho_max) / (n_rho - 1) - rho_max
    return theta, rho, vals


def hough_lines(mag: torch.Tensor, k: int = cvconf.hough_topk,
                n_theta: int = cvconf.hough_thetas,
                n_rho: int = cvconf.hough_rhos, n_peaks: int = 32):
    """Edge-magnitude map(s) (..., H, W) → top line peaks (theta, rho,
    votes), each (..., n_peaks): one Hough launch on the card for every
    map."""
    h, w = mag.shape[-2:]
    rho_max = float(np.hypot(h, w))
    pts, wts = topk_edge_points(mag.reshape(-1, h, w), k)
    acc = hough_accumulate(pts, wts, rho_max, n_theta, n_rho)
    return peak_lines(acc.reshape(*mag.shape[:-2], n_theta, n_rho), rho_max,
                      n_peaks)
