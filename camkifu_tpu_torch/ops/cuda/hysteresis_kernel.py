"""Edge hysteresis on the card: thresholds, dilations and the masked copy
in one kernel.

Replaces no Pallas kernel: ``camkifu_tpu/ops/edges.py:50 hysteresis`` is
plain array code that XLA fuses into a few loops. Eager PyTorch runs it as
18 launches a dilation step, each a pass over the maps; the CUDA source
``camkifu_tpu_torch/csrc/hysteresis.cu`` does it in one.

What bounds it on the card: the maps read once and written once (8 bytes a
pixel). A block loads a 32 × 128 tile with a halo of ``iters`` pixels,
indices modulo H and W, packs the weak and strong flags 32 to a word in
shared memory, dilates there, and stores each magnitude it loaded or 0.0.

Contract (both versions): ``mag`` (N, H, W) or (H, W) float32; ``low`` and
``high`` Python floats or float32 tensors of one threshold a map (N values,
as (N, 1, 1) broadcasts) or one for all; ``iters`` dilation steps, at most
``MAX_ITERS`` in the kernel. Neighbours wrap around the image
(``torch.roll``). Every output pixel is its input or 0.0, so the two
versions are bitwise equal; a NaN magnitude or threshold compares false in
both.
"""

from __future__ import annotations

import collections

import torch

from camkifu_tpu_torch.ops.cuda import _build

#: Most dilation steps a launch takes (``MAX_ITERS`` in the CUDA source:
#: the halo a tile can carry); the paths use 4.
MAX_ITERS = 8

#: Kernel launches since the last reset (one per call on a CUDA tensor).
launches = 0

#: Launches by the number of maps they covered, reset with ``launches``.
sizes: collections.Counter = collections.Counter()


def _check(mag: torch.Tensor, iters: int) -> None:
    if mag.dtype != torch.float32:
        raise TypeError(f"hysteresis takes float32, got {mag.dtype}")
    if mag.ndim not in (2, 3):
        raise ValueError(f"hysteresis takes (H, W) or (N, H, W), got "
                         f"{tuple(mag.shape)}")
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")


def _per_map(t, n: int, device, name: str) -> torch.Tensor:
    """``t`` as ``n`` contiguous float32 thresholds on ``device``."""
    if not isinstance(t, torch.Tensor):
        return torch.full((n,), float(t), dtype=torch.float32, device=device)
    if t.dtype != torch.float32 or t.device != device:
        raise ValueError(f"hysteresis takes {name} as a float or a float32 "
                         f"tensor on the maps' device, got {t.dtype} on "
                         f"{t.device}")
    if t.numel() not in (1, n) or t.shape[1:].numel() != 1:
        raise ValueError(f"{name} must hold one threshold or one a map "
                         f"({n}), got {tuple(t.shape)}")
    return t.reshape(-1).expand(n).contiguous()


def hysteresis(mag: torch.Tensor, low, high, iters: int = 8) -> torch.Tensor:
    """The CUDA kernel. ``mag`` must be a contiguous float32 CUDA tensor;
    tensor thresholds are read on the card, with no host wait."""
    global launches
    _check(mag, iters)
    if not mag.is_cuda:
        raise ValueError("hysteresis launches on CUDA tensors only; use "
                         "hysteresis_ref on the CPU")
    if not mag.is_contiguous():
        raise ValueError("hysteresis needs a contiguous tensor")
    if iters > MAX_ITERS:
        raise ValueError(f"the hysteresis kernel takes at most {MAX_ITERS} "
                         f"steps, got {iters}")
    x = mag if mag.ndim == 3 else mag[None]
    n, h, w = x.shape
    lo_ptr = hi_ptr = None
    lo_val = hi_val = 0.0
    if isinstance(low, torch.Tensor) or isinstance(high, torch.Tensor):
        lo = _per_map(low, n, x.device, "low")
        hi = _per_map(high, n, x.device, "high")
        lo_ptr, hi_ptr = lo.data_ptr(), hi.data_ptr()
    else:
        lo_val, hi_val = float(low), float(high)
    out = torch.empty_like(x)
    if n and h and w:
        lib = _build.lib()
        with torch.cuda.device(x.device):
            code = lib.camkifu_hysteresis(
                x.data_ptr(), out.data_ptr(), n, h, w, lo_ptr, hi_ptr,
                lo_val, hi_val, iters,
                _build.stream_handle(x.device))
        _build.check(code, "hysteresis")
        launches += 1
        sizes[n] += 1
    return out if mag.ndim == 3 else out[0]


def hysteresis_ref(mag: torch.Tensor, low, high, iters: int = 8
                   ) -> torch.Tensor:
    """Plain PyTorch version, on any device: double threshold + fixed-
    iteration strong-edge propagation. Weak pixels survive if connected
    (8-neighbourhood) to strong ones within ``iters`` dilation steps."""
    strong = mag >= high
    weak = mag >= low
    reach = strong
    for _ in range(iters):
        dil = reach
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy or dx:
                    dil = dil | torch.roll(reach, shifts=(dy, dx),
                                           dims=(-2, -1))
        reach = dil & weak
    return torch.where(reach | strong, mag, 0.0)
