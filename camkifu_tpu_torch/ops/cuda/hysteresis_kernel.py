"""Edge hysteresis on the card: the thresholds, the dilations and the masked
copy in one kernel, the thresholds given or selected in the same launch.

Replaces no Pallas kernel: ``camkifu_tpu/ops/edges.py:50 hysteresis`` and
the strided ``jnp.percentile`` before it (``:104-105``, ``:133-136``) are
plain array code that XLA fuses into a few loops. Eager PyTorch runs the
percentile as a strided copy, a sort and some ten small launches, and each
dilation step as 18 launches, each a pass over the maps; the CUDA source
``camkifu_tpu_torch/csrc/hysteresis.cu`` does all of it in one.

What bounds it on the card: the maps read once and written once (8 bytes a
pixel); at the paths' 2 to 16 maps, the latency of one wave. The kernel
gives each map one thread-block cluster of ``CLUSTER`` blocks, a block a
band of rows across the whole width, loaded into shared memory by one bulk
copy. ``hysteresis_adaptive`` selects each map's percentile with a radix
select whose per-block histograms the blocks push into each other's shared
memory (distributed shared memory); then each block packs its band's weak
and strong flags 32 to a word, takes the ``iters`` rows of flags on
either side of its band from the blocks that hold them (rows wrap around
the map), dilates, and stores the band in one bulk copy.

Contract (both versions of each entry): ``mag`` (N, H, W) or (H, W)
float32. ``hysteresis``: ``low`` and ``high`` Python floats or float32
tensors of one threshold a map (N values, as (N, 1, 1) broadcasts) or one
for all. ``hysteresis_adaptive``: thresholds ``low_frac`` and ``high_frac``
(Python floats) times each map's ``q``-th percentile of ``mag[:, ::2,
::2]``, ``torch.quantile``'s linear interpolation to the last bit (a NaN
in that view makes both thresholds NaN). ``iters`` dilation steps, at most
``MAX_ITERS`` in the kernel. Neighbours wrap around the image
(``torch.roll``). Every output pixel is its input or 0.0, so the two
versions are bitwise equal; a NaN magnitude or threshold compares false in
both. The kernel takes maps whose bands fit its blocks' shared memory with
their flags (and, adaptive, the cluster's histograms): up to 576 × 576
adaptive and 628 × 628 with given thresholds (``smem_bytes``); it raises
beyond.
"""

from __future__ import annotations

import collections

import torch

from camkifu_tpu_torch.ops.cuda import _build

#: Most dilation steps a launch takes (``MAX_ITERS`` in the CUDA source);
#: the paths use 4.
MAX_ITERS = 8

#: Blocks a map's cluster (``CLUSTER`` in the CUDA source).
CLUSTER = 8

#: Kernel launches since the last reset (one per call on a CUDA tensor, of
#: either entry).
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


def smem_bytes(h: int, w: int, adaptive: bool) -> int:
    """Dynamic shared memory a block of an (h, w) map's cluster takes, or
    -1 for a map too large for the kernel. Builds the library."""
    return _build.lib().camkifu_hysteresis_smem(h, w, int(adaptive))


def _validate(mag: torch.Tensor, iters: int) -> None:
    _check(mag, iters)
    if not mag.is_cuda:
        raise ValueError("hysteresis launches on CUDA tensors only; use "
                         "hysteresis_ref or hysteresis_adaptive_ref on the "
                         "CPU")
    if not mag.is_contiguous():
        raise ValueError("hysteresis needs a contiguous tensor")
    if iters > MAX_ITERS:
        raise ValueError(f"the hysteresis kernel takes at most {MAX_ITERS} "
                         f"steps, got {iters}")


def _launch(mag: torch.Tensor, adaptive: bool, call) -> torch.Tensor:
    """Run ``call(lib, x, out, n, h, w, stream)`` on the validated ``mag``
    and count the launch; (N, H, W) or (H, W) out as in."""
    global launches
    x = mag if mag.ndim == 3 else mag[None]
    n, h, w = x.shape
    out = torch.empty_like(x)
    if n and h and w:
        lib = _build.lib()
        if smem_bytes(h, w, adaptive) < 0:
            raise ValueError(f"{h} × {w} maps are too large for the "
                             f"hysteresis kernel's cluster")
        with torch.cuda.device(x.device):
            code = call(lib, x, out, n, h, w, _build.stream_handle(x.device))
        _build.check(code, "hysteresis")
        launches += 1
        sizes[n] += 1
    return out if mag.ndim == 3 else out[0]


def hysteresis(mag: torch.Tensor, low, high, iters: int = 8) -> torch.Tensor:
    """The CUDA kernel with given thresholds. ``mag`` must be a contiguous
    float32 CUDA tensor; tensor thresholds are read on the card, with no
    host wait."""
    _validate(mag, iters)
    n = mag.shape[0] if mag.ndim == 3 else 1
    lo_ptr = hi_ptr = None
    lo_val = hi_val = 0.0
    if isinstance(low, torch.Tensor) or isinstance(high, torch.Tensor):
        lo = _per_map(low, n, mag.device, "low")
        hi = _per_map(high, n, mag.device, "high")
        lo_ptr, hi_ptr = lo.data_ptr(), hi.data_ptr()
    else:
        lo_val, hi_val = float(low), float(high)
    return _launch(mag, False, lambda lib, x, out, n, h, w, st:
                   lib.camkifu_hysteresis(x.data_ptr(), out.data_ptr(), n, h,
                                          w, lo_ptr, hi_ptr, lo_val, hi_val,
                                          iters, st))


def hysteresis_adaptive(mag: torch.Tensor, low_frac: float,
                        high_frac: float, iters: int = 8, q: float = 99.5
                        ) -> torch.Tensor:
    """The CUDA kernel with each map's thresholds ``low_frac`` and
    ``high_frac`` times its ``q``-th percentile of ``mag[..., ::2, ::2]``,
    selected in the same launch: one launch, no host wait."""
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"q must be in [0, 100], got {q}")
    _validate(mag, iters)
    return _launch(mag, True, lambda lib, x, out, n, h, w, st:
                   lib.camkifu_hysteresis_adaptive(
                       x.data_ptr(), out.data_ptr(), n, h, w, q / 100.0,
                       float(low_frac), float(high_frac), iters, st))


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


def hysteresis_adaptive_ref(mag: torch.Tensor, low_frac: float,
                            high_frac: float, iters: int = 8,
                            q: float = 99.5) -> torch.Tensor:
    """Plain PyTorch version of ``hysteresis_adaptive``, on any device:
    each map's ``q``-th percentile of its 2×-strided view
    (``torch.quantile``, linear), then ``hysteresis_ref`` at the two
    fractions of it."""
    x = mag if mag.ndim == 3 else mag[None]
    n = x.shape[0]
    ref = torch.quantile(x[:, ::2, ::2].reshape(n, -1), q / 100.0, dim=1,
                         interpolation="linear")[:, None, None]
    out = hysteresis_ref(x, low_frac * ref, high_frac * ref, iters)
    return out if mag.ndim == 3 else out[0]


def lerp_probe(s: torch.Tensor, e: torch.Tensor, w: torch.Tensor,
               form: int = 0) -> torch.Tensor:
    """The select's interpolation, on the card, over float32 CUDA tensors
    of (start, end, weight) triples: ``form`` 0 the kernel's own, 1 both
    products fused into their sums, 2 each operation rounded alone. For
    holding the kernel's form to ``torch.lerp``; counts no launch."""
    for t in (s, e, w):
        if not t.is_cuda or t.dtype != torch.float32 or t.shape != s.shape:
            raise ValueError("lerp_probe takes float32 CUDA tensors of one "
                             "shape")
    s, e, w = (t.contiguous() for t in (s, e, w))
    out = torch.empty_like(s)
    lib = _build.lib()
    with torch.cuda.device(s.device):
        code = lib.camkifu_hysteresis_lerp(
            s.data_ptr(), e.data_ptr(), w.data_ptr(), out.data_ptr(),
            s.numel(), form, _build.stream_handle(s.device))
    _build.check(code, "hysteresis lerp")
    return out
