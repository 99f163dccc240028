"""Homography warp on the card: four output pixels a thread, bilinear taps.

Replaces ``camkifu_tpu/ops/pallas/warp_kernel.py:warp_to_canonical_pallas``
(which never lowered on Mosaic, so the TPU ran the XLA gather of
``camkifu_tpu/ops/warp.py:bilinear_sample``); the CUDA source is
``camkifu_tpu_torch/csrc/warp.cu``. It matches the exact bilinear sample,
not the Pallas two-pass approximation, bit for bit.

What bounds it on the card: device-memory bytes. Per output pixel it
writes 4·C bytes of float32 and needs four C-byte uint8 taps — at 128 ×
304² × 3, 142 MB each way. The design reads uint8 taps straight from the
frames (no float copy of a frame is ever made), fetches a pixel's two taps
in a source row as one or two aligned 8-byte words, computes four adjacent
pixels per thread and stores them as aligned ``float4``s with the ×1/255
fused in.

Contract (both versions): (B, H, W, C) frames, one (3, 3) or (B, 3, 3)
float32 homography mapping output (u, v) to frame (x, y) → (B, OH, OW, C)
float32 bilinear samples × ``scale``, clamped to the frame's edge. In lens
mode (``ops/lens.py``) each source coordinate is bent through a radial
lens after the homography's divide and before the clamp: a few float
operations a pixel and no extra byte.
"""

from __future__ import annotations

import torch

from camkifu_tpu_torch.config import cvconf, guiconf
from camkifu_tpu_torch.ops.cuda import _build
from camkifu_tpu_torch.ops.lens import Lens, distort_pts
from camkifu_tpu_torch.ops.warp import bilinear_sample, canonical_corners, \
    homography_dlt

#: Kernel launches since the last reset (one per call on a CUDA tensor),
#: and how many of them ran in lens mode.
launches = 0
lens_launches = 0

#: The grid's z dimension carries the batch.
MAX_BATCH = 65535


def _check(frames: torch.Tensor, hmats: torch.Tensor, lens=None) -> None:
    if frames.ndim != 4:
        raise ValueError(f"warp takes (B, H, W, C) frames, got "
                         f"{tuple(frames.shape)}")
    if hmats.dtype != torch.float32:
        raise TypeError(f"warp takes float32 homographies, got {hmats.dtype}")
    if hmats.shape not in ((3, 3), (frames.shape[0], 3, 3)):
        raise ValueError(f"warp takes (3, 3) or (B, 3, 3) homographies, got "
                         f"{tuple(hmats.shape)}")
    if isinstance(lens, torch.Tensor):
        if lens.dtype != torch.float32 or lens.shape != (frames.shape[0], 5):
            raise ValueError(f"a lens per frame is a (B, 5) float32 tensor, "
                             f"got {tuple(lens.shape)} {lens.dtype}")
    elif lens is not None and len(lens) != 5:
        raise ValueError("a shared lens is five numbers (k1, cx, cy, sx, sy)")


def warp_homography(frames: torch.Tensor, hmats: torch.Tensor,
                    out_hw: tuple[int, int], scale: float = 1.0,
                    lens=None) -> torch.Tensor:
    """The CUDA kernel; contiguous uint8 frames and float32 homographies
    on one CUDA device. ``lens``: None, five numbers (k1, cx, cy, sx, sy)
    shared by the launch and passed as kernel arguments, or a contiguous
    (B, 5) float32 tensor on the frames' device, a lens a frame."""
    global launches, lens_launches
    _check(frames, hmats, lens)
    if frames.dtype != torch.uint8:
        raise TypeError(f"the warp kernel takes uint8 frames, got "
                        f"{frames.dtype}")
    per_frame = isinstance(lens, torch.Tensor)
    if not (frames.is_cuda and hmats.device == frames.device
            and (not per_frame or lens.device == frames.device)):
        raise ValueError("warp_homography launches on CUDA tensors of one "
                         "device only; use warp_homography_ref on the CPU")
    if not (frames.is_contiguous() and hmats.is_contiguous()
            and (not per_frame or lens.is_contiguous())):
        raise ValueError("warp_homography needs contiguous tensors")
    b, h, w, c = frames.shape
    if b > MAX_BATCH:
        raise ValueError(f"at most {MAX_BATCH} frames per launch, got {b}")
    oh, ow = out_hw
    out = torch.empty((b, oh, ow, c), dtype=torch.float32,
                      device=frames.device)
    if out.numel():
        lib = _build.lib()
        h_stride = 0 if hmats.ndim == 2 else 9
        stream = _build.stream_handle(frames.device)
        with torch.cuda.device(frames.device):
            if lens is None:
                code = lib.camkifu_warp(frames.data_ptr(), hmats.data_ptr(),
                                        h_stride, out.data_ptr(), b, h, w, c,
                                        oh, ow, float(scale), stream)
            else:
                table = lens.data_ptr() if per_frame else None
                shared = (0.0,) * 5 if per_frame else tuple(map(float, lens))
                code = lib.camkifu_warp_lens(
                    frames.data_ptr(), hmats.data_ptr(), h_stride, table,
                    5, *shared, out.data_ptr(), b, h, w, c, oh, ow,
                    float(scale), stream)
        _build.check(code, "warp")
        launches += 1
        lens_launches += lens is not None
    return out


def warp_homography_ref(frames: torch.Tensor, hmats: torch.Tensor,
                        out_hw: tuple[int, int], scale: float = 1.0,
                        lens=None) -> torch.Tensor:
    """Plain PyTorch version of the kernel's contract (any dtype, any
    device): the source coordinates term by term, bent through the lens by
    ``ops.lens.distort_pts`` in float32 tensors on the frames' device (not
    Python numbers: the card divides by those through their reciprocal),
    then explicit tap indexing and the bilinear blend
    (``ops.warp.bilinear_sample``)."""
    _check(frames, hmats, lens)
    oh, ow = out_hw
    dev = frames.device
    v = torch.arange(oh, dtype=torch.float32, device=dev)[:, None]
    u = torch.arange(ow, dtype=torch.float32, device=dev)[None, :]
    H = (hmats if hmats.ndim == 3 else hmats[None])[:, :, :, None, None]
    den = H[:, 2, 0] * u + H[:, 2, 1] * v + H[:, 2, 2]       # (B|1, OH, OW)
    x = (H[:, 0, 0] * u + H[:, 0, 1] * v + H[:, 0, 2]) / den
    y = (H[:, 1, 0] * u + H[:, 1, 1] * v + H[:, 1, 2]) / den
    if lens is not None:
        table = lens.to(dev) if isinstance(lens, torch.Tensor) else \
            torch.tensor([float(f) for f in lens], dtype=torch.float32,
                         device=dev)
        src = distort_pts(Lens(*table.unbind(-1)),
                          torch.stack([x, y], -1))
        x, y = src[..., 0], src[..., 1]
    return bilinear_sample(frames, x, y) * scale


def warp_to_canonical_ref(frame: torch.Tensor, corners: torch.Tensor,
                          gsize: int = guiconf.gsize,
                          zone: int = cvconf.zone_size) -> torch.Tensor:
    """The reference's ``warp_to_canonical`` through the plain version:
    (H, W, C) frame + (4, 2) corners → (S, S, C) float32, frame scale."""
    size = gsize * zone
    H = homography_dlt(canonical_corners(gsize, zone, corners.device),
                       corners)
    return warp_homography_ref(frame[None], H, (size, size))[0]
