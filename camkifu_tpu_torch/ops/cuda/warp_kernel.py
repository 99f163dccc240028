"""Homography warp on the card: one thread per output pixel, bilinear taps.

Replaces ``camkifu_tpu/ops/pallas/warp_kernel.py:warp_to_canonical_pallas``
(which never lowered on Mosaic, so the TPU ran the XLA gather of
``camkifu_tpu/ops/warp.py:bilinear_sample``); the CUDA source is
``camkifu_tpu_torch/csrc/warp.cu``. It matches the exact bilinear sample,
not the Pallas two-pass approximation.

What bounds it on the card: device-memory bytes. Per output pixel it reads
four C-byte uint8 taps, which neighbouring threads mostly share through the
caches, and writes 4·C bytes of float32 — at 128 × 304² × 3 the writes are
142 MB against ~4 taps × 3 B of frame per pixel. The design reads uint8
taps straight from the frames (no float copy of a frame is ever made) and
fuses the ×1/255 into the store.

Contract (both versions): (B, H, W, C) frames, one (3, 3) or (B, 3, 3)
float32 homography mapping output (u, v) to frame (x, y) → (B, OH, OW, C)
float32 bilinear samples × ``scale``, clamped to the frame's edge.
"""

from __future__ import annotations

import torch

from camkifu_tpu.config import cvconf, guiconf
from camkifu_tpu_torch.ops.cuda import _build
from camkifu_tpu_torch.ops.warp import bilinear_sample, canonical_corners, \
    homography_dlt

#: Kernel launches since the last reset (one per call on a CUDA tensor).
launches = 0

#: The grid's z dimension carries the batch.
MAX_BATCH = 65535


def _check(frames: torch.Tensor, hmats: torch.Tensor) -> None:
    if frames.ndim != 4:
        raise ValueError(f"warp takes (B, H, W, C) frames, got "
                         f"{tuple(frames.shape)}")
    if hmats.dtype != torch.float32:
        raise TypeError(f"warp takes float32 homographies, got {hmats.dtype}")
    if hmats.shape not in ((3, 3), (frames.shape[0], 3, 3)):
        raise ValueError(f"warp takes (3, 3) or (B, 3, 3) homographies, got "
                         f"{tuple(hmats.shape)}")


def warp_homography(frames: torch.Tensor, hmats: torch.Tensor,
                    out_hw: tuple[int, int],
                    scale: float = 1.0) -> torch.Tensor:
    """The CUDA kernel; contiguous uint8 frames and float32 homographies
    on one CUDA device."""
    global launches
    _check(frames, hmats)
    if frames.dtype != torch.uint8:
        raise TypeError(f"the warp kernel takes uint8 frames, got "
                        f"{frames.dtype}")
    if not (frames.is_cuda and hmats.device == frames.device):
        raise ValueError("warp_homography launches on CUDA tensors of one "
                         "device only; use warp_homography_ref on the CPU")
    if not (frames.is_contiguous() and hmats.is_contiguous()):
        raise ValueError("warp_homography needs contiguous tensors")
    b, h, w, c = frames.shape
    if b > MAX_BATCH:
        raise ValueError(f"at most {MAX_BATCH} frames per launch, got {b}")
    oh, ow = out_hw
    out = torch.empty((b, oh, ow, c), dtype=torch.float32,
                      device=frames.device)
    if out.numel():
        lib = _build.lib()
        with torch.cuda.device(frames.device):
            code = lib.camkifu_warp(frames.data_ptr(), hmats.data_ptr(),
                                    0 if hmats.ndim == 2 else 9,
                                    out.data_ptr(), b, h, w, c, oh, ow,
                                    float(scale),
                                    _build.stream_handle(frames.device))
        _build.check(code, "warp")
        launches += 1
    return out


def warp_homography_ref(frames: torch.Tensor, hmats: torch.Tensor,
                        out_hw: tuple[int, int],
                        scale: float = 1.0) -> torch.Tensor:
    """Plain PyTorch version of the kernel's contract (any dtype, any
    device): the source coordinates term by term, then explicit tap
    indexing and the bilinear blend (``ops.warp.bilinear_sample``)."""
    _check(frames, hmats)
    oh, ow = out_hw
    dev = frames.device
    v = torch.arange(oh, dtype=torch.float32, device=dev)[:, None]
    u = torch.arange(ow, dtype=torch.float32, device=dev)[None, :]
    H = (hmats if hmats.ndim == 3 else hmats[None])[:, :, :, None, None]
    den = H[:, 2, 0] * u + H[:, 2, 1] * v + H[:, 2, 2]       # (B|1, OH, OW)
    x = (H[:, 0, 0] * u + H[:, 0, 1] * v + H[:, 0, 2]) / den
    y = (H[:, 1, 0] * u + H[:, 1, 1] * v + H[:, 1, 2]) / den
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
