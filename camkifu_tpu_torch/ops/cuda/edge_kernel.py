"""Fused edge magnitudes on the card: blur + Sobel + NMS in one kernel.

Replaces ``camkifu_tpu/ops/pallas/edge_kernel.py:edge_magnitude`` (and its
batch-grid twin ``edge_magnitude_batch``); the CUDA source is
``camkifu_tpu_torch/csrc/edge.cu``.

What bounds it on the card: the plain path writes and rereads the blurred
image, both gradients and the magnitude (about 6 float32 passes over the
image); the kernel reads each pixel once and writes it once, 8 bytes for
some 55 floating operations, so device memory bounds it. Its design keeps
every stage in registers: a warp owns a strip of columns, 4 or 8 a lane,
and walks down a segment of rows with the blur sums in the making, 3
blurred rows and 3 magnitude rows of its columns in registers; horizontal
neighbours come from the next lanes by shuffles. No shared memory, no
block-wide sync. ``auto_plan`` picks the strip width and the segments'
length from the batch and the card: a pair of maps is cut into many short
walks of narrow strips, a batch of 128 into few long ones of wide strips.
The walks cover the whole map and keep the plain version's boundary stage
by stage in registers (inputs clamped as they load, the blurred map's
edge rows and columns repeated for the Sobel). Only the NMS of the map's
outer lines, whose neighbours wrap around the map, is left to a second,
small launch of the same call, a thread an outer pixel, from the outer
lines' magnitudes that the walks write into a scratch buffer of 6 (H + W)
words a map.

Contract (both versions): (N, H, W) or (H, W) float32 gray in [0, 1] →
the same shape of NMS magnitudes, with the boundary of the reference's
XLA route (``camkifu_tpu/ops/edges.py``, its path on every backend but
the TPU): blur and Sobel pad each stage's input with its edge values, the
NMS neighbours wrap around the map. The Pallas kernel instead zeroes a
band of 8 px, which hides a board's outer lines where the camera frames it
close to the edge. The kernel is bitwise the plain version.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from camkifu_tpu_torch.ops.cuda import _build
from camkifu_tpu_torch.ops.edges import nms_magnitude
from camkifu_tpu_torch.ops.filters import gaussian_blur, \
    gaussian_kernel1d, sobel

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


#: Columns a lane of the kernel's two strip widths and the columns a strip
#: of each stores (``Design<..>::STORED`` in the CUDA source); a strip loads
#: ``MARGIN`` more on either side.
STRIPS = {4: 112, 8: 240}
MARGIN = 8

#: Wide strips where they give every SM at least ``WIDE_WARPS_PER_SM`` warps
#: of ``MIN_ROWS[8]`` rows: a batch that cannot leaves schedulers idle, and
#: narrow strips end sooner. Then the segment length aims at
#: ``WARPS_PER_SM`` warps an SM (wide strips' 250 registers a thread let 8
#: reside), no shorter than ``MIN_ROWS``: a walk spends 12 rows filling its
#: windows before its first output row. All from the sweep over widths and
#: segment lengths that chip_smoke.py times on an H100 at N = 2, 16, 128.
WIDE_WARPS_PER_SM = 4
WARPS_PER_SM = {4: 16, 8: 8}
MIN_ROWS = {4: 2, 8: 4}


def _strips(w: int, cols: int) -> int:
    return max(1, -(-(w - 2 * MARGIN) // STRIPS[cols]))


def auto_plan(n: int, h: int, w: int, device) -> tuple[int, int]:
    """(columns a lane, output rows a warp walks) for ``n`` maps of
    (h, w) on ``device``, from its SM count."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    wide = n * _strips(w, 8) * -(-h // MIN_ROWS[8]) >= WIDE_WARPS_PER_SM * sms
    cols = 8 if wide else 4
    segs = max(1, WARPS_PER_SM[cols] * sms // (n * _strips(w, cols)))
    return cols, min(h, max(MIN_ROWS[cols], -(-h // segs)))


@functools.lru_cache(maxsize=16)
def _ready(sigma: float):
    """(the kernel library, the Gaussian taps as the array its entry point
    takes), made and checked against the library once per ``sigma``."""
    lib = _build.lib()
    taps = gaussian_kernel1d(sigma)
    if len(taps) != lib.camkifu_edge_taps():
        raise ValueError(f"the edge kernel is built for "
                         f"{lib.camkifu_edge_taps()} taps; sigma={sigma} "
                         f"gives {len(taps)}")
    for cols, stored in STRIPS.items():
        if lib.camkifu_edge_strip(cols) != stored:
            raise RuntimeError(f"the edge kernel's {cols}-column strips "
                               f"store {lib.camkifu_edge_strip(cols)} "
                               f"columns, not {stored}")
    return lib, (ctypes.c_float * len(taps))(*taps.tolist())


def outer_scratch(n: int, h: int, w: int, device) -> torch.Tensor:
    """The scratch buffer of the outer lines' magnitudes and sectors that
    the kernel takes for ``n`` maps of (h, w), on ``device``."""
    per_map = _build.lib().camkifu_edge_scratch(h, w)
    return torch.empty(max(1, n * per_map), dtype=torch.float32,
                       device=device)


def edge_magnitude(gray: torch.Tensor, sigma: float = 1.4) -> torch.Tensor:
    """The CUDA kernel. ``gray`` must be a contiguous float32 CUDA tensor."""
    global launches
    _check(gray)
    if not gray.is_cuda:
        raise ValueError("edge_magnitude launches on CUDA tensors only; "
                         "use edge_magnitude_ref on the CPU")
    if not gray.is_contiguous():
        raise ValueError("edge_magnitude needs a contiguous tensor")
    lib, taps = _ready(float(sigma))
    x = gray if gray.ndim == 3 else gray[None]
    n, h, w = x.shape
    out = torch.empty_like(x)
    if n and h and w:
        cols, rows = auto_plan(n, h, w, x.device)
        scratch = outer_scratch(n, h, w, x.device)
        with torch.cuda.device(x.device):
            code = lib.camkifu_edge(x.data_ptr(), out.data_ptr(),
                                    scratch.data_ptr(), n, h, w, cols, rows,
                                    taps, _build.stream_handle(x.device))
        _build.check(code, "edge")
        launches += 1
        sizes[n] += 1
    return out if gray.ndim == 3 else out[0]


def edge_magnitude_ref(gray: torch.Tensor, sigma: float = 1.4) -> torch.Tensor:
    """Plain PyTorch version of the kernel's contract, on any device."""
    _check(gray)
    gx, gy = sobel(gaussian_blur(gray, sigma))
    return nms_magnitude(gx, gy)
