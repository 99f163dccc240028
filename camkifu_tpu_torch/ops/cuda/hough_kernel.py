"""Hough vote accumulator on the card: 32 θ rows a block, one row a lane.

Replaces ``camkifu_tpu/ops/pallas/hough_kernel.py:hough_accumulate_pallas``;
the CUDA source is ``camkifu_tpu_torch/csrc/hough.cu``.

What bounds it on the card: about 12 floating operations per (point, θ)
pair with a non-zero weight (0.40 GFLOP, 6 µs at B = 64, K = 4096, 128 θ
rows), above its 11.5 MB of points and votes. The design keeps the adds
cheap: a block stages a frame's points in shared memory once for 32 θ
rows, every lane of a warp votes the same point into its own row (so no
two adds of a warp instruction collide or share a bank), and the warps add
in 64-bit fixed point, because the card adds integers atomically in shared
memory but not floats: each vote is rounded by at most 2^-63 of its
block's |weight| sum, so weights of any spread keep float32 precision.
Where B is small the points are also split across blocks
(``auto_splits``), whose partial rows a second kernel sums. The TPU
version built (chunk, n_ρ) one-hot splat matrices for its MXU instead; the
plain version below does the same with explicit sums, in θ chunks, one
frame at a time.

Contract (both versions): (K, 2) or (B, K, 2) float32 (x, y) points and
(K,) or (B, K) float32 weights → (n_θ, n_ρ) or (B, n_θ, n_ρ) float32
votes, ρ(θ) = x·cosθ + y·sinθ splatted bilinearly into bins over
[-rho_max, rho_max], θ at (i + 0.5)·π/n_θ.
"""

from __future__ import annotations

import collections
import functools

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

#: Largest n_ρ whose 32 rows of 64-bit bins, beside the 33 KB point tile,
#: fit the 227 KB of shared memory a block can opt in to (``MAX_BINS`` in
#: the CUDA source); the paths use 256.
MAX_RHOS = 768

#: θ rows per block (one per lane of a warp, as in the CUDA source).
ROWS = 32

#: Blocks (of 16 warps) per SM the automatic split aims for, as many as
#: an SM's shared memory holds at n_ρ = 256, and the fewest points a split
#: takes: below that a block spends more on zeroing and writing its
#: partial rows than on votes. Both from the split sweep that
#: chip_smoke.py times on an H100 at B = 1, 8 and 64.
BLOCKS_PER_SM = 2
MIN_SPLIT_POINTS = 128


def auto_splits(b: int, k: int, n_theta: int, device) -> int:
    """How many blocks share a frame's points: as many as keep the grid
    within ``BLOCKS_PER_SM`` blocks on every SM of ``device``, no split
    under ``MIN_SPLIT_POINTS``."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    blocks = b * -(-n_theta // ROWS)
    return max(1, min(BLOCKS_PER_SM * sms // blocks, k // MIN_SPLIT_POINTS))


def _trig(n_theta: int, device) -> torch.Tensor:
    thetas = (torch.arange(n_theta, dtype=torch.float32, device=device)
              + 0.5) * float(np.pi / n_theta)
    return torch.stack([torch.cos(thetas), torch.sin(thetas)], dim=-1)


@functools.lru_cache(maxsize=16)
def _trig_on(n_theta: int, device: torch.device) -> torch.Tensor:
    """``_trig`` made once per device: at B = 1 its six small launches
    took longer on the card than the kernel."""
    return _trig(n_theta, device)


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
    """The CUDA kernel; contiguous float32 CUDA tensors only, n_rho at
    most ``MAX_RHOS``. ``auto_splits`` blocks share each frame's points."""
    global launches
    _check(points, weights)
    if not (points.is_cuda and weights.is_cuda):
        raise ValueError("hough_accumulate launches on CUDA tensors only; "
                         "use hough_accumulate_ref on the CPU")
    if not (points.is_contiguous() and weights.is_contiguous()):
        raise ValueError("hough_accumulate needs contiguous tensors")
    if points.data_ptr() % 8:
        raise ValueError("hough_accumulate copies (x, y) pairs as 8-byte "
                         "words: the points must start 8-byte aligned")
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
        trig = _trig_on(n_theta, points.device)
        rho_scale, pos_hi = _bins(n_rho, rho_max)
        splits = auto_splits(b, k, n_theta, points.device)
        # Each split's partial votes, summed by a second kernel.
        partial = torch.empty((splits, *out.shape), dtype=torch.float32,
                              device=points.device) if splits > 1 else None
        with torch.cuda.device(points.device):
            code = lib.camkifu_hough(pts.data_ptr(), weights.data_ptr(),
                                     trig.data_ptr(), out.data_ptr(),
                                     partial.data_ptr() if splits > 1
                                     else None, b, k, n_theta,
                                     n_rho, splits, float(rho_max),
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
