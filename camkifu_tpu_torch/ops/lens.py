"""Radial lens distortion, one coefficient k1 (port of
camkifu_tpu/ops/lens.py).

Cheap webcams are not pinhole cameras: straight goban lines bow outward
(barrel, k1 > 0) or inward (pincushion, k1 < 0), |k1| ≈ 0.03–0.08 at this
normalization, and a straight-lattice model then reads boards cells off.
The lens is composed into sample coordinates, never into pixels: corners
stay raw (distorted) frame positions everywhere, a homography is built on
their pinhole positions, and every warp bends its source coordinates back
through the lens before the gather (the warp kernel's lens mode):

    H = homography_dlt(canonical, undistort_pts(lens, corners))
    src = distort_pts(lens, apply_homography(H, grid))      # then gather

Model (the renderers' ground truth): a pinhole point p_u appears at

    p_d = c + (p_u − c) · (1 + k1 · r_u²),   r_u = |p_u − c| / s

with c the frame center and s half the short frame side.

A ``Lens`` holds Python floats (one camera), or, from ``stack_lenses``,
(n,) float32 tensors, one camera a stream: lens i then applies to
``pts[i]``, the tensors lining up with the points' leading dimension.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch


class Lens(NamedTuple):
    """Radial model bound to one image geometry: the coefficient ``k1``,
    the distortion center (cx, cy) in this image's pixels, and the
    normalization (sx, sy): p maps to ((px − cx)/sx, (py − cy)/sy). A full
    frame has sx = sy = min(h, w)/2; an anisotropically resized copy scales
    the axes apart (``scale_lens``)."""
    k1: float | torch.Tensor
    cx: float | torch.Tensor
    cy: float | torch.Tensor
    sx: float | torch.Tensor
    sy: float | torch.Tensor


def make_lens(k1, frame_hw: tuple[int, int]) -> Lens:
    """Lens of a full (h, w) frame (the renderers' and webcams'
    convention)."""
    h, w = frame_hw
    s = min(h, w) / 2.0
    return Lens(k1, w / 2.0, h / 2.0, s, s)


def scale_lens(lens: Lens, sx: float, sy: float) -> Lens:
    """The same physical lens in the coordinates of an image scaled by
    (sx, sy), e.g. the res × res detection square of a full frame."""
    return Lens(lens.k1, lens.cx * sx, lens.cy * sy, lens.sx * sx,
                lens.sy * sy)


def identity_lens() -> Lens:
    return Lens(0.0, 0.0, 0.0, 1.0, 1.0)


def stack_lenses(lenses, device) -> Lens:
    """n single-camera lenses → one Lens whose fields are (n,) float32
    tensors on ``device``, the columns of one (n, 5) tensor made by one
    copy. Made once and held by the caller across calls: a tensor built
    from Python numbers on the card is a copy the host waits for."""
    table = torch.tensor([[float(v) for v in ln] for ln in lenses],
                         dtype=torch.float32, device=device)
    return Lens(*table.unbind(1))


def check_lens(lens) -> None:
    """Raise TypeError unless ``lens`` is None or a ``Lens``."""
    if lens is not None and not isinstance(lens, Lens):
        raise TypeError(f"lens must be an ops.lens.Lens or None, got "
                        f"{type(lens).__name__}")


def as_table(lens: Lens) -> torch.Tensor:
    """A stacked lens as its (n, 5) float32 tensor (k1, cx, cy, sx, sy),
    the warp kernel's per-frame form."""
    return torch.stack(list(lens), dim=-1)


@functools.lru_cache(maxsize=64)
def _numbers_on(values: tuple, device) -> tuple:
    """A lens of numbers as 0-d float32 tensors on ``device``, made once a
    lens and device (one copy; read only)."""
    table = torch.tensor(values, dtype=torch.float32, device=device)
    return tuple(table.unbind(0))


def _fields(lens: Lens, like: torch.Tensor):
    """The lens's fields shaped to broadcast against ``like``: (n,) tensor
    fields gain trailing axes, so lens i meets ``like[i]``. A lens of
    numbers stays numbers on the CPU, as the reference's are (its Newton
    steps fold ``3.0 * k1`` in double precision). On the card it becomes
    tensors: the card divides by a Python number through the number's
    reciprocal and by a tensor exactly, so one camera's points then take
    the bits of a stacked lens's."""
    check_lens(lens)
    if not isinstance(lens.k1, torch.Tensor):
        if like.is_cuda:
            return _numbers_on(tuple(float(v) for v in lens), like.device)
        return list(lens)
    out = []
    for v in lens:
        if 0 < v.ndim < like.ndim:
            v = v.reshape(v.shape + (1,) * (like.ndim - v.ndim))
        out.append(v)
    return out


def distort_pts(lens: Lens | None, pts: torch.Tensor) -> torch.Tensor:
    """Pinhole → raw frame coordinates (..., 2); ``pts`` itself when lens
    is None. In the warp kernel's order of operations, term by term."""
    if lens is None:
        return pts
    k1, cx, cy, sx, sy = _fields(lens, pts[..., 0])
    nx = (pts[..., 0] - cx) / sx
    ny = (pts[..., 1] - cy) / sy
    f = 1.0 + k1 * (nx * nx + ny * ny)
    return torch.stack([cx + nx * f * sx, cy + ny * f * sy], dim=-1)


def undistort_pts(lens: Lens | None, pts: torch.Tensor,
                  iters: int = 8) -> torch.Tensor:
    """Raw frame → pinhole coordinates: Newton's method on the radius,
    ``iters`` steps (<1e-3 px over the invertible domain: everywhere for
    barrel, inside the fold radius sqrt(−1/(3·k1)) for pincushion, where
    the guard on the derivative keeps the iteration finite). NaN points
    stay NaN."""
    if lens is None:
        return pts
    k1, cx, cy, sx, sy = _fields(lens, pts[..., 0])
    nx = (pts[..., 0] - cx) / sx
    ny = (pts[..., 1] - cy) / sy
    rd = torch.sqrt(nx * nx + ny * ny)
    r = rd
    for _ in range(iters):
        g = r * (1.0 + k1 * r * r) - rd
        dg = 1.0 + 3.0 * k1 * r * r
        dg = torch.where(torch.abs(dg) < 0.05,
                         torch.sign(dg) * 0.05 + (dg == 0) * 0.05, dg)
        r = r - g / dg
    f = torch.where(rd > 1e-9, r / torch.clamp(rd, min=1e-9), 1.0)
    return torch.stack([cx + nx * f * sx, cy + ny * f * sy], dim=-1)


def undistort_frame(frame: torch.Tensor, lens: Lens) -> torch.Tensor:
    """Resample a raw (H, W[, C]) frame, or a batch (B, H, W, C), to
    pinhole geometry: the warp of the identity homography in lens mode at
    the frame's own size (one launch on the card). uint8 stays uint8,
    rounded half up. Only the calibration pays this full-frame gather; the
    hot paths bend their own sample coordinates."""
    from camkifu_tpu_torch.ops.warp import warp_frames

    squeeze = frame.ndim == 2
    batch = frame.ndim == 4
    img = frame[..., None] if squeeze else frame
    if not batch:
        img = img[None]
    h, w = img.shape[1], img.shape[2]
    eye = torch.eye(3, dtype=torch.float32, device=img.device)
    out = warp_frames(img.contiguous(), eye, (h, w), lens=lens)
    if frame.dtype == torch.uint8:
        out = torch.clamp(out + 0.5, 0, 255).to(torch.uint8)
    if not batch:
        out = out[0]
    return out[..., 0] if squeeze else out
