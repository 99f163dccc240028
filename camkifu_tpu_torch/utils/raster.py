"""cv2's anti-aliased rasterisation, fitted, as coverage on tensors.

Shared by the renderer (``utils/synth.py``: filled circles) and the
overlays (``core/imgutil.py``: lines and rings). Every function returns a
coverage in [0, 1] on the device of the pixel grid it is given; callers
composite it over their own pixels.

A one-pixel cv2 ``LINE_AA`` line is drawn along its major axis, three
pixels across at each step. Its coverage here is the product of three
measured tables (``tools/make_glyph_atlas.py`` reads them off cv2 into
``core/cv2_draw.npz``): a profile of the distance to the line along the
minor axis, a gain by slope, and a ramp at each end. A circle of
thickness 1 is cv2's polygon (``ellipse2Poly``: 4, 12, 20 or 72 sides by
radius) of such lines, each blended over the last; each line is first
clipped to the image as cv2 clips it (``clip_segment``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from camkifu_tpu_torch.core.feeder import to_device

#: cv2's anti-aliased fill reaches this far past a circle's radius before
#: its one-pixel ramp ends (fitted to cv2's own circles); circles of radius
#: under 3 are 4-gons there, diamonds reaching ``AA_DIAMOND`` past theirs.
AA_REACH = 1.05
AA_DIAMOND = 1.28

#: The line tables' grids: profile at t = k / 32 (|k| ≤ 48), slope gain at
#: |dy / dx| = j / 32, end ramp at u = j / 16 from u = -1.
PROFILE_LO, PROFILE_STEP = -1.5, 32.0
GAIN_STEP = 32
RAMP_LO, RAMP_STEP = -1.0, 16.0


def _pixel_grid(h: int, w: int, device, x0: int = 0, y0: int = 0,
                dtype=torch.float32):
    """(yy (h, 1), xx (1, w)) pixel coordinates from (y0, x0)."""
    return (torch.arange(y0, y0 + h, dtype=dtype, device=device)[:, None],
            torch.arange(x0, x0 + w, dtype=dtype, device=device)[None, :])


def _disc(dx: torch.Tensor, dy: torch.Tensor, r: float) -> torch.Tensor:
    """Anti-aliased coverage of a filled cv2 circle of radius ``r`` at
    offsets (dx, dy) from its centre."""
    if r < 3:
        return (r + AA_DIAMOND - dx.abs() - dy.abs()).clamp(0.0, 1.0)
    return (r + AA_REACH - torch.sqrt(dx * dx + dy * dy)).clamp(0.0, 1.0)


class LineTables(NamedTuple):
    """The measured line tables: ``profile`` and ``ramp`` on the device,
    each padded with its value beyond either end (the profile 0 and 0, the
    ramp 0 and 1); ``gain`` on the host, read once a segment."""
    profile: torch.Tensor
    gain: np.ndarray
    ramp: torch.Tensor

    @classmethod
    def on(cls, profile, gain, ramp, device) -> "LineTables":
        pad = np.concatenate
        return cls(
            to_device(pad([[0.0], profile, [0.0]]).astype(np.float32),
                      device),
            np.asarray(gain, np.float64),
            to_device(pad([[0.0], ramp, [1.0]]).astype(np.float32), device))


def _lookup(padded: torch.Tensor, t: torch.Tensor, lo: float,
            step: float) -> torch.Tensor:
    """A table sampled at lo + i / step (``padded`` with its value beyond
    each end) linearly interpolated at ``t``. ``step`` is a power of two,
    so the scaling is exact on every device."""
    u = (t - lo) * step
    i = torch.floor(u)
    f = u - i
    last = padded.shape[0] - 1
    i = (i.to(torch.int64) + 1).clamp(0, last)
    a = padded[i]
    b = padded[(i + 1).clamp(0, last)]
    return a + (b - a) * f


def circle_points(center, radius: int) -> list[tuple[float, float]]:
    """The vertices of ``cv2.circle(img, center, radius, color, 1,
    LINE_AA)`` (``ellipse2Poly`` through ``EllipseEx``): one every 90°,
    30°, 18° or 5° by radius, at 1/65536 px, repeats dropped."""
    delta = 90 if radius < 3 else 30 if radius < 10 else \
        18 if radius < 15 else 5
    cx, cy = float(center[0]), float(center[1])
    pts: list[tuple[float, float]] = []
    for ang in range(0, 360 + delta, delta):
        a = math.radians(min(ang, 360))
        p = (round((cx + radius * math.cos(a)) * 65536) / 65536,
             round((cy + radius * math.sin(a)) * 65536) / 65536)
        if not pts or pts[-1] != p:
            pts.append(p)
    return pts


def clip_segment(p0, p1, w: int, h: int):
    """cv2's ``clipLine`` of a segment to a (w, h) image, at 1/65536 px
    (integer arithmetic, truncating): its end points moved onto the
    border, or None if it misses the image."""
    (x1, y1), (x2, y2) = [(int(round(float(p[0]) * 65536)),
                           int(round(float(p[1]) * 65536))) for p in (p0, p1)]
    right, bottom = (w << 16) - 1, (h << 16) - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1, c1 = a, (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2, c2 = a, (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1, c1 = a, 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2, c2 = a, 0
    if c1 | c2:
        return None
    return (x1 / 65536, y1 / 65536), (x2 / 65536, y2 / 65536)


def _segment_params(p0, p1, gain: np.ndarray) -> list[float]:
    """(y-major, start and minor coordinate along / across the major axis,
    slope, gain, end) of one segment, taken left to right (top to bottom
    when y-major), as cv2's ``LineAA`` walks it."""
    (x0, y0), (x1, y1) = (float(p0[0]), float(p0[1])), \
        (float(p1[0]), float(p1[1]))
    ymajor = abs(x1 - x0) <= abs(y1 - y0)       # cv2: x-major iff |dx| > |dy|
    if ymajor:
        x0, y0, x1, y1 = y0, x0, y1, x1
    if x1 < x0:
        x0, y0, x1, y1 = x1, y1, x0, y0
    k = (y1 - y0) / (x1 - x0) if x1 > x0 else 0.0
    g = float(np.interp(abs(k), np.arange(len(gain)) / GAIN_STEP, gain))
    return [float(ymajor), x0, y0, k, g, x1]


def segments_cover(yy: torch.Tensor, xx: torch.Tensor, segments,
                   tables: LineTables) -> torch.Tensor:
    """Coverage of ``cv2.line(img, p0, p1, color, 1, LINE_AA)`` for each
    (p0, p1) of ``segments`` ((x, y) floats; cv2 takes them at 1/65536
    px), each blended over the ones before it: 1 − ∏ (1 − coverage), at
    pixels (yy (h, 1), xx (1, w)). One segment's coverage is the profile
    of its distance along the minor axis, times its slope's gain, times
    the ramp at each end; all segments are computed at once."""
    if not segments:
        return torch.zeros(yy.shape[0], xx.shape[1], device=yy.device)
    par = np.asarray([_segment_params(p0, p1, tables.gain)
                      for p0, p1 in segments], np.float32)
    par = to_device(par, yy.device)[:, :, None, None]
    ymajor, a0, c0, k, g, a1 = par.unbind(1)
    along = torch.where(ymajor > 0, yy, xx)
    minor = torch.where(ymajor > 0, xx, yy)
    across = _lookup(tables.profile, minor - (c0 + (along - a0) * k),
                     PROFILE_LO, PROFILE_STEP)
    start = _lookup(tables.ramp, along - a0, RAMP_LO, RAMP_STEP)
    end = _lookup(tables.ramp, (a1 - along) + 1.0 / RAMP_STEP, RAMP_LO,
                  RAMP_STEP)
    keep = 1.0 - (across * g * (start * end)).clamp(0.0, 1.0)
    out = keep[0]
    for i in range(1, keep.shape[0]):         # in order: bitwise anywhere
        out = out * keep[i]
    return 1.0 - out
