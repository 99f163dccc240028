"""Image/geometry helpers shared by the finder families, and the preview's
overlays drawn on the device.

Parity: ``camkifu/core/imgutil.py`` (SURVEY §2.1) — ``Segment`` line-segment
math (norm, angle, intersection), drawing overlays (``draw_lines`` /
``draw_circles`` / ``draw_str`` / ``draw_metadata``), the ``around``
neighborhood iterator, the tl/tr/br/bl corner ordering, and a cyclic
buffer utility.

Copied from camkifu_tpu/core/imgutil.py: ``Segment``, ``around``,
``CyclicBuffer`` and the ``order_corners`` re-export (host code). The
reference draws with cv2 on numpy frames; here each ``draw_*`` takes an
(H, W, 3) uint8 tensor, draws on that tensor's device in the reference's
call order, touching only each primitive's bounding box, and returns the
tensor, drawn in place as cv2 draws:

- lines and rings: ``utils/raster``'s coverage of cv2's ``LINE_AA``
  (measured tables; rings are cv2's polygons of such lines), each
  primitive blended once as ``round(img + (color − img) · coverage)``;
  the fit is within the tolerances ``tests/test_torch_gui.py`` states;
- text (``FONT_HERSHEY_SIMPLEX`` at scale 0.5, the reference's black
  outline of thickness 3 under its colour of thickness 1): a glyph atlas
  measured off ``cv2.putText`` by ``tools/make_glyph_atlas.py``
  (``cv2_draw.npz`` beside this file). cv2 draws a string as the union of
  its glyphs' masks, blended once, each glyph a whole number of pixels
  after the last, so the atlas gives its strings to within 1 DN.

``annotate_preview`` is the preview window's pixel work without Tk.
"""

from __future__ import annotations

import functools
import math
import os

import numpy as np
import torch

from camkifu_tpu_torch.board.boardfinder import order_corners  # noqa: F401  (re-export)
from camkifu_tpu_torch.core.feeder import to_device
from camkifu_tpu_torch.utils.raster import (LineTables, _pixel_grid,
                                            circle_points, clip_segment,
                                            segments_cover)

#: The measured drawing data (glyph masks and advances, the line tables).
ATLAS_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "cv2_draw.npz")
#: The atlas's glyphs: printable ASCII.
FIRST_GLYPH, LAST_GLYPH = 32, 126


class Segment:
    """A 2D line segment between (x1, y1) and (x2, y2)."""

    def __init__(self, p1, p2):
        self.p1 = (float(p1[0]), float(p1[1]))
        self.p2 = (float(p2[0]), float(p2[1]))

    @property
    def norm(self) -> float:
        return math.hypot(self.p2[0] - self.p1[0], self.p2[1] - self.p1[1])

    @property
    def angle(self) -> float:
        """Orientation in [0, π) (undirected)."""
        a = math.atan2(self.p2[1] - self.p1[1], self.p2[0] - self.p1[0])
        return a % math.pi

    def intersection(self, other: "Segment"):
        """Intersection point of the *lines* through the two segments, or
        None if parallel. (The reference intersects Hough segments the same
        way to get corner candidates.)"""
        x1, y1 = self.p1
        x2, y2 = self.p2
        x3, y3 = other.p1
        x4, y4 = other.p2
        den = (x1 - x2) * (y3 - y4) - (y1 - y2) * (x3 - x4)
        if abs(den) < 1e-12:
            return None
        a = x1 * y2 - y1 * x2
        b = x3 * y4 - y3 * x4
        px = (a * (x3 - x4) - (x1 - x2) * b) / den
        py = (a * (y3 - y4) - (y1 - y2) * b) / den
        return (px, py)

    def distance_to(self, point) -> float:
        """Perpendicular distance of a point to the segment's line."""
        x1, y1 = self.p1
        x2, y2 = self.p2
        n = self.norm
        if n == 0:
            return math.hypot(point[0] - x1, point[1] - y1)
        return abs((x2 - x1) * (y1 - point[1])
                   - (x1 - point[0]) * (y2 - y1)) / n

    def __repr__(self) -> str:
        return f"Segment({self.p1} -> {self.p2})"


def around(row: int, col: int, radius: int = 1, gsize: int = 19,
           include_center: bool = False):
    """Yield in-bounds (r, c) neighbors within a square radius — the
    reference's neighborhood iterator."""
    for dr in range(-radius, radius + 1):
        for dc in range(-radius, radius + 1):
            if not include_center and dr == 0 and dc == 0:
                continue
            r, c = row + dr, col + dc
            if 0 <= r < gsize and 0 <= c < gsize:
                yield r, c


class CyclicBuffer:
    """Fixed-size rolling buffer of ndarray slots (the host-side analogue of
    the reference's per-intersection vote buffer; the device path keeps its
    votes in the SfMeta scan state instead)."""

    def __init__(self, shape, length: int, dtype=np.float32):
        self.buffer = np.zeros((length,) + tuple(shape), dtype)
        self.length = length
        self.index = 0
        self.filled = 0

    def append(self, value) -> None:
        self.buffer[self.index % self.length] = value
        self.index += 1
        self.filled = min(self.filled + 1, self.length)

    def view(self) -> np.ndarray:
        """Valid slots, oldest first."""
        if self.filled < self.length:
            return self.buffer[:self.filled]
        i = self.index % self.length
        return np.concatenate([self.buffer[i:], self.buffer[:i]])

    def __len__(self) -> int:
        return self.filled


# -- drawing on the device (the preview's overlays) -------------------------

@functools.lru_cache(maxsize=1)
def _atlas_host() -> dict:
    """The atlas file's arrays; a missing or partial file raises."""
    if not os.path.exists(ATLAS_PATH):
        raise FileNotFoundError(
            f"{ATLAS_PATH}: the glyph atlas is missing; "
            f"tools/make_glyph_atlas.py writes it")
    with np.load(ATLAS_PATH, allow_pickle=False) as data:
        atlas = {k: data[k] for k in ("masks", "advance", "origin",
                                      "thickness", "line_profile",
                                      "line_gain", "line_ramp")}
    n = LAST_GLYPH - FIRST_GLYPH + 1
    if atlas["masks"].shape[:2] != (2, n) or \
            tuple(atlas["thickness"]) != (3, 1):
        raise ValueError(f"{ATLAS_PATH}: not a glyph atlas of {n} glyphs "
                         f"at thicknesses 3 and 1")
    return atlas


@functools.lru_cache(maxsize=4)
def _atlas_on(device: torch.device):
    """(glyph coverages (2, 95, R, C) float32, line tables) on ``device``."""
    a = _atlas_host()
    masks = to_device(a["masks"].astype(np.float32) / np.float32(255.0),
                      device)
    return masks, LineTables.on(
        a["line_profile"], a["line_gain"], a["line_ramp"], device)


def _blend(img: torch.Tensor, y0: int, x0: int, cover: torch.Tensor,
           color) -> None:
    """Composite ``color`` over ``img[y0:, x0:]`` with ``cover`` (h, w),
    clipped to the image, rounded as cv2 rounds: in place."""
    h, w = img.shape[:2]
    ch, cw = cover.shape
    ya, xa = max(0, y0), max(0, x0)
    yb, xb = min(h, y0 + ch), min(w, x0 + cw)
    if ya >= yb or xa >= xb:
        return
    cov = cover[ya - y0:yb - y0, xa - x0:xb - x0, None]
    win = img[ya:yb, xa:xb].to(torch.float32)
    col = to_device(np.asarray(color, np.float32)[:img.shape[2]],
                    img.device)
    img[ya:yb, xa:xb] = torch.round(win + (col - win) * cov).clamp(
        0.0, 255.0).to(torch.uint8)


def _draw_polyline(img: torch.Tensor, pts, color) -> None:
    """One primitive of one-pixel anti-aliased lines through ``pts``, each
    clipped to the image as cv2 clips it; a line that clipping leaves
    without length is dropped (cv2 gives it about 1% coverage)."""
    h, w = img.shape[:2]
    segs = [s for s in (clip_segment(p0, p1, w, h)
                        for p0, p1 in zip(pts[:-1], pts[1:]))
            if s and s[0] != s[1]]
    if not segs:
        return
    xs = [p[0] for s in segs for p in s]
    ys = [p[1] for s in segs for p in s]
    x0, x1 = max(0, math.floor(min(xs)) - 2), min(w, math.floor(max(xs)) + 3)
    y0, y1 = max(0, math.floor(min(ys)) - 2), min(h, math.floor(max(ys)) + 3)
    _, tables = _atlas_on(img.device)
    yy, xx = _pixel_grid(y1 - y0, x1 - x0, img.device, x0, y0)
    _blend(img, y0, x0, segments_cover(yy, xx, segs, tables), color)


def draw_lines(img: torch.Tensor, segments, color=(255, 0, 0)) -> torch.Tensor:
    """``cv2.line(img, p1, p2, color, 1, LINE_AA)`` for each segment (its
    end points truncated to whole pixels, as the reference passes them)."""
    for seg in segments:
        _draw_polyline(img, [(int(seg.p1[0]), int(seg.p1[1])),
                             (int(seg.p2[0]), int(seg.p2[1]))], color)
    return img


def draw_circles(img: torch.Tensor, centers, radius: int = 5,
                 color=(0, 255, 0)) -> torch.Tensor:
    """``cv2.circle(img, (int(x), int(y)), radius, color, 1, LINE_AA)`` for
    each centre."""
    for x, y in centers:
        _draw_polyline(img, circle_points((int(x), int(y)), int(radius)),
                       color)
    return img


def _glyph_indices(text: str) -> list[int]:
    """The atlas index of each character of ``text``; one outside printable
    ASCII is drawn as '?', as cv2 draws a control character (cv2 5 draws
    other characters with glyphs of its own, which the atlas lacks)."""
    q = ord("?") - FIRST_GLYPH
    return [ord(c) - FIRST_GLYPH if FIRST_GLYPH <= ord(c) <= LAST_GLYPH
            else q for c in str(text)]


def _text_pass(img: torch.Tensor, idx: list[int], origin, layer: int,
               color) -> None:
    """One ``cv2.putText`` call: the union of the glyphs' masks of one
    thickness (``layer`` 0: 3, 1: 1), blended once."""
    atlas = _atlas_host()
    masks, _ = _atlas_on(img.device)
    oy, ox = (int(v) for v in atlas["origin"])
    adv = atlas["advance"][layer]
    rows, cols = masks.shape[2:]
    xs = np.concatenate([[0], np.cumsum([int(adv[i]) for i in idx])])[:-1]
    n, width = len(idx), int(xs[-1]) + cols
    # Each glyph's mask placed at its offset in a (n, rows, width) stack.
    place = to_device(xs[:, None] + np.arange(cols)[None, :], img.device,
                      torch.int64)
    glyphs = masks[layer][to_device(np.asarray(idx, np.int64), img.device)]
    stack = torch.zeros(n, rows, width, device=img.device)
    stack.scatter_(2, place[:, None, :].expand(n, rows, cols), glyphs)
    cover = 1.0 - torch.prod(1.0 - stack, dim=0)
    _blend(img, int(origin[1]) - oy, int(origin[0]) - ox, cover, color)


def draw_str(img: torch.Tensor, text: str, origin=(10, 20),
             color=(255, 255, 255)) -> torch.Tensor:
    """``cv2.putText(img, text, origin, FONT_HERSHEY_SIMPLEX, 0.5, ...)``
    twice, as the reference draws a label: a black outline of thickness
    3, then ``color`` at thickness 1, both ``LINE_AA``."""
    idx = _glyph_indices(text)
    if idx:
        _text_pass(img, idx, origin, 0, (0, 0, 0))
        _text_pass(img, idx, origin, 1, color)
    return img


def draw_metadata(img: torch.Tensor, metadata: dict) -> torch.Tensor:
    """Overlay a VidProcessor's metadata dict (fps, frame nr, algo messages)
    on a frame — the reference's per-window debug overlay (SURVEY §5)."""
    y = 20
    for key, value in sorted(metadata.items()):
        draw_str(img, f"{key}: {value}", origin=(10, y))
        y += 18
    return img


def annotate_preview(frame, corners, metadata, device) -> torch.Tensor:
    """The preview window's overlay (``gui/video_window.py``): ``frame``
    (H, W, 3) uint8, host or device, copied to ``device``; a ring of
    radius 8 in (255, 40, 40) at each of ``corners`` ((4, 2) or None), then
    ``metadata``'s lines. → the drawn (H, W, 3) uint8 tensor on
    ``device``."""
    device = torch.device(device)
    if isinstance(frame, torch.Tensor):
        img = frame.to(device, copy=True)
    elif device.type == "cuda":
        img = to_device(frame, device)
    else:
        img = torch.from_numpy(np.array(frame, np.uint8))
    if corners is not None:
        draw_circles(img, [(x, y) for x, y in np.asarray(corners)],
                     radius=8, color=(255, 40, 40))
    return draw_metadata(img, metadata)
