"""Synthetic goban renderer on the device (port of camkifu_tpu/utils/synth.py):
frames and whole games with known ground truth, every degradation of the
reference (wood palettes and grain, stone jitter, glare, clutter, a hand,
shadow, lens, rolling shutter, motion and defocus blur, lighting, vignette,
white balance, exposure flicker, sensor noise).

    frame, corners = render_frame(labels, device="cuda")

Random draws stay on the host, in numpy, in the reference's order and on
its seeds: wood offsets, stone jitter, glare, clutter, the hand, flicker,
white balance, variable frame rate and the move samplers. Moves, the
yielded label states and the corners (through lens and rolling shutter)
are therefore bitwise the reference's. Pixels are computed in torch on
``device``; frames come out as (H, W, 3) uint8 tensors there.

The cv2 drawing calls become:

- anti-aliased lines, circles and ellipses: analytic coverage, composited
  in the reference's paint order (a stone is painted from its own cell
  and the eight around it, row-major, each highlight after its stone);
  cv2 fills an anti-aliased circle as a polygon, so rims differ by a few
  DN (``tests/test_torch_synth.py`` states how much). cv2 draws no
  anti-aliasing on float images: the glare ellipses are filled as they
  are there, and the hand's shapes are drawn without it, as there;
- ``warpPerspective`` of the canonical board: the port's warp kernel
  (``ops.warp.warp_frames``) through the inverse homography, on a copy of
  the board padded with one zero pixel (cv2 reads 0 outside the image,
  the kernel clamps); its ``INTER_NEAREST`` mask rounds the same inverse
  map in float64;
- ``GaussianBlur``, ``filter2D``: separable or depthwise convolutions with
  a reflect-101 border; ``remap`` (lens, rolling shutter):
  ``ops.warp.bilinear_sample``, clamped as ``BORDER_REPLICATE``;
  ``dilate``: a box test on the host, where the clutter's placement is
  decided.

cv2's own calls round their results to uint8 and the reference's numpy
stages truncate; each stage keeps its own.

The per-pixel sensor noise (``noise``, ``shot_noise``), the last draw of
a frame's ``default_rng(seed)``, is numpy's own draw on either device: the
generator's state at that point goes to ``ops.cuda.pcg_normal_kernel``,
whose kernel draws the same normals on the card, bit for bit, and whose
plain version is numpy's draw itself on the CPU.
``encode_roundtrip`` is the reference's mp4 round trip through cv2's video
writer and reader, on the host; it imports cv2 when it is called.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from camkifu_tpu_torch.config import guiconf
from camkifu_tpu_torch.core.feeder import to_device
from camkifu_tpu_torch.gamemodel.move import B, W, Move
from camkifu_tpu_torch.gamemodel.rules import RuleUnsafe
from camkifu_tpu_torch.ops.cuda import pcg_normal_kernel
from camkifu_tpu_torch.utils.raster import AA_REACH, _disc, _pixel_grid

WOOD = (193, 154, 107)       # RGB board wood
LINE = (40, 30, 20)
BLACK_STONE = (28, 26, 24)
WHITE_STONE = (235, 233, 228)
TABLE = (70, 75, 60)         # background behind the board

#: Alternative looks for robustness testing: (wood, line, black, white).
PALETTES = {
    "kaya": (WOOD, LINE, BLACK_STONE, WHITE_STONE),
    "walnut": ((120, 85, 55), (25, 18, 12), (20, 20, 22), (228, 224, 210)),
    "bamboo": ((214, 190, 140), (60, 50, 35), (35, 32, 30), (240, 240, 235)),
}

#: cv2 fills a polygon with its edge pixels: an ellipse drawn without
#: anti-aliasing reaches this far past its rim (fitted to cv2's own).
FILL_REACH = 0.5
#: A one-pixel anti-aliased cv2 line: peak coverage and the half-width of
#: its tent across the line.
AA_LINE_PEAK = 0.91
AA_LINE_HALF = 1.32

#: Skin/sleeve colors for the animated hand.
_SKIN = (198, 160, 128)
_SLEEVE = (52, 56, 84)


# ---------------------------------------------------------------------------
# Host helpers: cv2's geometry, in float64 numpy.
# ---------------------------------------------------------------------------

def _perspective(src, dst) -> np.ndarray:
    """``cv2.getPerspectiveTransform``: the (3, 3) float64 H with
    dst ~ H @ src, from four point pairs."""
    a = np.zeros((8, 8))
    b = np.zeros(8)
    for i, ((x, y), (u, v)) in enumerate(zip(np.asarray(src, np.float64),
                                             np.asarray(dst, np.float64))):
        a[i] = (x, y, 1, 0, 0, 0, -x * u, -y * u)
        a[i + 4] = (0, 0, 0, x, y, 1, -x * v, -y * v)
        b[i], b[i + 4] = u, v
    return np.append(np.linalg.solve(a, b), 1.0).reshape(3, 3)


def _nearest_inside(hinv, size: int, u, v, rnd):
    """Where ``cv2.warpPerspective(..., INTER_NEAREST)`` of a (size, size)
    image lands inside it at output pixels (u, v): the inverse map in
    cv2's order of operations, rounded half to even by ``rnd``. Works on
    numpy arrays and torch tensors alike."""
    h = [[float(e) for e in row] for row in hinv]
    w = 1.0 / ((h[2][1] * v + h[2][2]) + h[2][0] * u)
    x = rnd(((h[0][1] * v + h[0][2]) + h[0][0] * u) * w)
    y = rnd(((h[1][1] * v + h[1][2]) + h[1][0] * u) * w)
    return (x >= 0) & (x < size) & (y >= 0) & (y < size)


def _clip_line(n: int, p0, p1):
    """cv2's ``clipLine`` to an (n, n) image: the segment's end points moved
    onto its border (integer arithmetic, truncating), or None if it misses
    the image."""
    (x1, y1), (x2, y2) = p0, p1
    right = bottom = n - 1

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
    return None if (c1 | c2) else ((x1, y1), (x2, y2))


def _line_kernel(n: int, p0, p1) -> np.ndarray:
    """``cv2.line(zeros((n, n)), p0, p1, 1.0, 1)``: the segment clipped to
    the image, then an 8-connected Bresenham line (cv2's ``LineIterator``,
    left to right)."""
    k = np.zeros((n, n), np.float32)
    seg = _clip_line(n, p0, p1)
    if seg is None:
        return k
    (x0, y0), (x1, y1) = seg
    if x0 > x1:
        x0, y0, x1, y1 = x1, y1, x0, y0
    dx, dy = x1 - x0, abs(y1 - y0)
    sy = 1 if y1 >= y0 else -1
    steep = dy > dx
    if steep:
        dx, dy = dy, dx
    err = dx - 2 * dy
    x, y = x0, y0
    for _ in range(dx + 1):
        k[y, x] = 1.0
        if err < 0:                         # a step on both axes
            x, y, err = x + 1, y + sy, err + 2 * dx - 2 * dy
        elif steep:
            y, err = y + sy, err - 2 * dy
        else:
            x, err = x + 1, err - 2 * dy
    return k


def _gauss_taps(ksize: int, sigma: float) -> np.ndarray:
    """``cv2.getGaussianKernel(ksize, sigma)`` for sigma > 0."""
    x = np.arange(ksize) - (ksize - 1) / 2.0
    k = np.exp(-x * x / (2.0 * sigma * sigma))
    return k / k.sum()


def _gauss_ksize(sigma: float, is_u8: bool) -> int:
    """cv2's kernel size for ``ksize=(0, 0)``: ±3σ on uint8, ±4σ on
    float images."""
    return int(np.rint(sigma * (3 if is_u8 else 4) * 2 + 1)) | 1


# ---------------------------------------------------------------------------
# Device helpers.
# ---------------------------------------------------------------------------

def _u8(x: torch.Tensor) -> torch.Tensor:
    """numpy's ``np.clip(x, 0, 255).astype(np.uint8)``: truncation."""
    return x.clamp(0.0, 255.0).to(torch.uint8)


def _u8_round(x: torch.Tensor) -> torch.Tensor:
    """cv2's ``saturate_cast<uchar>``: rounded, saturated."""
    return torch.round(x).clamp(0.0, 255.0).to(torch.uint8)


@functools.lru_cache(maxsize=8)
def _gauss_taps_on(ksize: int, sigma: float, device) -> torch.Tensor:
    return to_device(_gauss_taps(ksize, sigma).astype(np.float32), device)


def _gaussian_blur(img: torch.Tensor, ksize: int,
                   sigma: float) -> torch.Tensor:
    """``cv2.GaussianBlur(img, (ksize, ksize), sigma)`` of an (H, W) or
    (H, W, C) image, in float32, border reflect-101 (not rounded): the
    taps along x, then along y."""
    taps = _gauss_taps_on(ksize, float(sigma), img.device)
    x = img.to(torch.float32)
    flat = x.ndim == 2
    x = (x[None] if flat else x.permute(2, 0, 1))[None]     # (1, C, H, W)
    c, p = x.shape[1], ksize // 2
    x = F.conv2d(F.pad(x, (p, p, 0, 0), mode="reflect"),
                 taps.reshape(1, 1, 1, -1).expand(c, 1, 1, -1), groups=c)
    x = F.conv2d(F.pad(x, (0, 0, p, p), mode="reflect"),
                 taps.reshape(1, 1, -1, 1).expand(c, 1, -1, 1), groups=c)
    return x[0, 0] if flat else x[0].permute(1, 2, 0)


def _conv2d_same(img: torch.Tensor, k: np.ndarray) -> torch.Tensor:
    """``cv2.filter2D(img, -1, k)`` of an (H, W, C) image (correlation,
    anchor at the centre, border reflect-101), in float32."""
    n = k.shape[0]
    x = img.to(torch.float32).permute(2, 0, 1)[None]
    c = x.shape[1]
    kt = to_device(k, img.device).expand(c, 1, n, n)
    x = F.conv2d(F.pad(x, (n // 2,) * 4, mode="reflect"), kt, groups=c)
    return x[0].permute(1, 2, 0)


def _ellipse_d(yy, xx, cx, cy, ax, ay, angle_deg):
    """Normalised radius (1 on the rim) of cv2's ``ellipse(center, axes,
    angle)`` at pixels (yy, xx), and the pixel distance along the ray from
    the centre to the rim (negative inside)."""
    th = np.deg2rad(angle_deg)
    dx, dy = xx - cx, yy - cy
    qx = dx * float(np.cos(th)) + dy * float(np.sin(th))
    qy = -dx * float(np.sin(th)) + dy * float(np.cos(th))
    rho = torch.sqrt((qx / ax) ** 2 + (qy / ay) ** 2)
    dist = torch.sqrt(dx * dx + dy * dy)
    return rho, dist * (1.0 - 1.0 / torch.clamp(rho, min=1e-6))


def _capsule(yy, xx, p0, p1, half: float) -> torch.Tensor:
    """Pixels within ``half`` of the segment p0–p1: a thick cv2 line with
    round caps, not anti-aliased."""
    ax, ay = float(p0[0]), float(p0[1])
    vx, vy = float(p1[0]) - ax, float(p1[1]) - ay
    ll = vx * vx + vy * vy
    t = ((xx - ax) * vx + (yy - ay) * vy) / ll if ll else xx * 0.0
    t = t.clamp(0.0, 1.0)
    return ((xx - ax - t * vx) ** 2 + (yy - ay - t * vy) ** 2) <= half * half


def _thick_half(thickness: int) -> float:
    """cv2's half width of a thick line (odd thicknesses gain half a
    pixel)."""
    return thickness / 2.0 + 0.5 * (thickness & 1)


def _rgb(color, device) -> torch.Tensor:
    """A colour (or any short list of numbers) as float32 on ``device``,
    copied without a host wait."""
    return to_device(np.asarray(color, np.float32), device)


# ---------------------------------------------------------------------------
# The canonical board.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=4)
def _wood_grain(size: int, amp: float, key: int) -> np.ndarray:
    """Procedural wood-grain multiplier (size, size) float32: vertical
    streaks whose phase wanders smoothly down the board (growth-ring
    wiggle) over a low-frequency band pattern, deterministic per ``key``
    so the grain is stable across frames of a game. Drawn on the host, in
    the reference's draws, once a key."""
    rng = np.random.default_rng((0xD00D, key))
    x = np.arange(size, dtype=np.float32)
    wander = np.cumsum(rng.normal(0.0, 0.35, size).astype(np.float32))
    k = max(5, size // 24)
    kernel = np.ones(k, np.float32) / k
    wander = np.convolve(wander, kernel, mode="same")
    lam = size / (6.0 + rng.uniform(0, 3))         # streak wavelength
    streaks = np.sin(2 * np.pi * (x[None, :] / lam + 0.08 * wander[:, None]))
    bands = np.sin(2 * np.pi * (x[None, :] / (lam * 3.7)
                                + 0.03 * wander[:, None]) + 1.1)
    fine = rng.normal(0.0, 0.25, (size, size)).astype(np.float32)
    g = 0.55 * streaks + 0.3 * bands + 0.35 * fine
    return 1.0 + amp * g


@functools.lru_cache(maxsize=4)
def _grain_on(size: int, amp: float, key: int, device) -> torch.Tensor:
    return torch.from_numpy(_wood_grain(size, amp, key)).to(device)


@functools.lru_cache(maxsize=16)
def _stone_draws(key: int, g: int, stone_jitter: float, zone: int):
    """Per intersection, the reference's per-stone draws: the jitter
    (g, g, 2) in pixels (``default_rng((key, r, c))``) and the glare's
    (amp fraction, ax, ay) (``default_rng((0x61A2E, key, r, c))``)."""
    radius = int(zone * 0.47)
    jit = np.zeros((g, g, 2))
    glare = np.zeros((g, g, 3))
    for r in range(g):
        for c in range(g):
            if stone_jitter:
                srng = np.random.default_rng((key, r, c))
                jit[r, c] = srng.uniform(-stone_jitter, stone_jitter, 2) * zone
            grng = np.random.default_rng((0x61A2E, key, r, c))
            amp = float(grng.uniform(0.6, 1.0))
            ax = max(2, int(radius * (0.30 + 0.15 * grng.uniform())))
            glare[r, c] = (amp, ax, max(1, int(ax * 0.6)))
    return jit, glare


@functools.lru_cache(maxsize=4)
def _board_geometry(g: int, zone: int, device):
    """Static pieces of a (g·zone)² canonical board: the pixel grid, each
    pixel's cell, and the coverage of the grid lines and star points."""
    size = g * zone
    yy, xx = _pixel_grid(size, size, device)
    cell = torch.clamp(torch.arange(size, device=device) // zone, 0, g - 1)
    p = torch.tensor([float(int((i + 0.5) * zone)) for i in range(g)],
                     device=device)
    lo, hi = float(int(zone / 2)), float(int(size - zone / 2))

    def tent(d):
        return AA_LINE_PEAK * (1.0 - d / AA_LINE_HALF).clamp(0.0, 1.0)

    def along(t):
        return (torch.minimum(t - lo, hi - t) + 0.6).clamp(0.0, 1.0)

    py, px = p[cell][:, None], p[cell][None, :]
    cover_h = tent((yy - py).abs()) * along(xx)
    cover_v = tent((xx - px).abs()) * along(yy)
    keep = (1.0 - cover_h) * (1.0 - cover_v)
    if g == 19:
        star = torch.zeros(g, dtype=torch.bool, device=device)
        star[[3, 9, 15]] = True
        on = (star[cell][:, None] & star[cell][None, :]).to(torch.float32)
        keep = keep * (1.0 - _disc(xx - px, yy - py, max(2, zone // 10)) * on)
    return yy, xx, cell, keep


class _Composite:
    """A stack of opaque paints with coverage, as ``out = img·a + b``: the
    image below enters linearly, so a stack built once serves every frame
    whose paints are the same."""

    def __init__(self, a: torch.Tensor, b: torch.Tensor):
        self.a, self.b = a, b

    def paint(self, color: torch.Tensor, cover: torch.Tensor) -> None:
        keep = (1.0 - cover)[..., None]
        self.a = self.a * keep
        self.b = self.b * keep + color * cover[..., None]


@functools.lru_cache(maxsize=2)
def _board_paint(labels_key: bytes, g: int, zone: int, key: int,
                 stone_jitter: float, glare: float, palette: str, device):
    """(a (S, S, 1), b (S, S, 3), glare (S, S, 1) to add) of a board
    position: the lines and star points, then every stone and its
    highlight in row-major order; a pixel sees the stones of its own cell
    and of the eight around it."""
    labels = np.frombuffer(labels_key, np.int8).reshape(g, g)
    _wood, line, black, white = PALETTES[palette]
    yy, xx, cell, keep = _board_geometry(g, zone, device)
    comp = _Composite(keep[..., None],
                      _rgb(line, device) * (1.0 - keep)[..., None])
    radius = int(zone * 0.47)
    jit, gl = _stone_draws(key, g, stone_jitter if stone_jitter else 0.0,
                           zone)
    rc = np.mgrid[0:g, 0:g].astype(np.float64)
    cx = ((rc[1] + .5) * zone + jit[..., 0]).astype(np.int64)
    cy = ((rc[0] + .5) * zone + jit[..., 1]).astype(np.int64)
    # A table a cell, padded by one empty cell on every side.
    tab = np.zeros((6, g + 2, g + 2), np.float32)
    tab[0, 1:-1, 1:-1] = labels
    tab[1, 1:-1, 1:-1], tab[2, 1:-1, 1:-1] = cx, cy
    tab[3:, 1:-1, 1:-1] = np.moveaxis(gl, -1, 0)
    tab = to_device(tab, device)
    colors = _rgb((0, 0, 0, *black, *white), device).reshape(3, 3)
    hls = _rgb([min(255, v + 35) for col in ((0, 0, 0), black, white)
                for v in col], device).reshape(3, 3)
    hl_r, hl_off = max(1, radius // 3), radius // 3
    glare_canvas = None
    for dr in (-1, 0, 1):
        for dc in (-1, 0, 1):
            t = tab[:, cell[:, None] + 1 + dr, cell[None, :] + 1 + dc]
            lab = t[0].to(torch.int64)
            on = (lab > 0).to(torch.float32)
            comp.paint(colors[lab], _disc(xx - t[1], yy - t[2], radius) * on)
            if dr or dc:
                continue
            comp.paint(hls[lab], _disc(xx - (t[1] - hl_off),
                                       yy - (t[2] - hl_off), hl_r) * on)
            if glare:
                # Binary ellipses (cv2 draws no anti-aliasing on float
                # images), each inside its own stone's cell.
                off = int(radius * 0.38)
                _, d = _ellipse_d(yy, xx, t[1] - off, t[2] - off, t[4],
                                  t[5], -30.0)
                glare_canvas = torch.where((d <= FILL_REACH) & (lab > 0),
                                           glare * t[3], 0.0)
    if glare_canvas is not None:
        sigma = max(1.0, radius * 0.18)
        glare_canvas = 255.0 * _gaussian_blur(
            glare_canvas, _gauss_ksize(sigma, False), sigma)[..., None]
    return comp.a, comp.b, glare_canvas


def render_canonical(labels: np.ndarray, zone: int = 24,
                     rng: np.random.Generator | None = None,
                     stone_jitter: float = 0.0,
                     jitter_key: int = 0,
                     wood_texture: float = 0.0,
                     glare: float = 0.0,
                     palette: str = "kaya", device="cuda") -> torch.Tensor:
    """Draw a top-down goban: labels (g, g) int (0=E, 1=B, 2=W) → RGB
    uint8 (g·zone, g·zone, 3) on ``device``.

    The image side is g*zone with intersection (r, c) at ((c+.5)z, (r+.5)z),
    matching the canonical-warp convention.
    """
    device = torch.device(device)
    labels = np.asarray(labels, np.int8)
    g = labels.shape[0]
    size = g * zone
    rng = rng or np.random.default_rng(0)
    wood = PALETTES[palette][0]
    rows = np.clip(np.asarray(wood, np.int16)
                   + rng.integers(-8, 8, (size, 1, 1))[:, 0], 0, 255
                   ).astype(np.uint8)
    img = to_device(rows, device)[:, None, :].expand(
        size, size, 3).to(torch.float32)
    if wood_texture:
        img = _u8(img * _grain_on(size, float(wood_texture), int(jitter_key),
                                  device)[..., None]).to(torch.float32)
    a, b, glare_add = _board_paint(
        labels.tobytes(), g, zone, int(jitter_key), float(stone_jitter),
        float(glare), palette, device)
    out = _u8_round(img * a + b)
    if glare_add is not None:
        out = _u8(out.to(torch.float32) + glare_add)
    return out


def default_corners(frame_hw: tuple[int, int] = (1080, 1920),
                    perspective: float = 0.12) -> np.ndarray:
    """A plausible camera view: board fills most of the frame, mild keystone.

    Returns (4, 2) float32 (x, y) of the corner *intersections*, tl/tr/br/bl.
    """
    h, w = frame_hw
    cx, cy = w / 2.0, h / 2.0
    half = 0.42 * min(h, w)
    k = perspective * half
    return np.array([
        [cx - half + k, cy - half + k * 0.5],   # tl (pushed in: tilt away)
        [cx + half - k, cy - half + k * 0.5],   # tr
        [cx + half, cy + half],                 # br
        [cx - half, cy + half],                 # bl
    ], dtype=np.float32)


# ---------------------------------------------------------------------------
# Camera frames.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=4)
def _table_rgb(device) -> torch.Tensor:
    return to_device(np.asarray(TABLE, np.int16), device)


@functools.lru_cache(maxsize=2)
def _board_mask(hinv_key: bytes, size: int, h: int, w: int, device):
    """The (H, W) bool where the board lands in the frame (cv2's
    INTER_NEAREST warp of a (size, size) image), float64 on ``device``."""
    hinv = np.frombuffer(hinv_key, np.float64).reshape(3, 3)
    v, u = _pixel_grid(h, w, device, dtype=torch.float64)
    return _nearest_inside(hinv, size, u, v, torch.round)


@functools.lru_cache(maxsize=4)
def _shadow_map(h: int, w: int, shadow: float, device) -> torch.Tensor:
    yy, xx = _pixel_grid(h, w, device)
    cx, cy = 0.65 * w, 0.4 * h
    d = torch.sqrt(((xx - cx) / (0.35 * w)) ** 2
                   + ((yy - cy) / (0.45 * h)) ** 2)
    return (1.0 - shadow * torch.clamp(1.5 - d, 0.0, 1.0))[..., None]


@functools.lru_cache(maxsize=4)
def _lens_map(h: int, w: int, k1: float, device):
    """Where each output pixel samples the pinhole scene through a k1 lens
    (the inverse radius by 4 fixed-point steps), float32."""
    s = min(h, w) / 2.0
    ccx, ccy = w / 2.0, h / 2.0
    yy, xx = _pixel_grid(h, w, device)
    rd = torch.sqrt((xx - ccx) ** 2 + (yy - ccy) ** 2) / s
    ru = rd.clone()
    for _ in range(4):
        ru = rd / (1.0 + k1 * ru * ru)
    scale = torch.where(rd > 1e-9, ru / torch.clamp(rd, min=1e-9), 1.0)
    return ccx + (xx - ccx) * scale, ccy + (yy - ccy) * scale


@functools.lru_cache(maxsize=4)
def _gradient_map(h: int, w: int, light_gradient: float,
                  device) -> torch.Tensor:
    """The lighting gradient's (H, W, 1) factor, from numpy's float32
    linspaces as the reference makes them."""
    gx = np.linspace(1.0, 1.0 - light_gradient, w, dtype=np.float32)
    gy = np.linspace(1.0, 1.0 - 0.5 * light_gradient, h, dtype=np.float32)
    return to_device(gy[:, None] * gx[None, :], device)[..., None]


@functools.lru_cache(maxsize=4)
def _vignette_map(h: int, w: int, vignette: float, device) -> torch.Tensor:
    """The lens vignette's (H, W, 1) factor."""
    yy, xx = _pixel_grid(h, w, device)
    r2 = (((xx - w / 2) / (w / 2)) ** 2 + ((yy - h / 2) / (h / 2)) ** 2) / 2.0
    return (1.0 - vignette * r2)[..., None]


def _remap(frame: torch.Tensor, map_x, map_y) -> torch.Tensor:
    """``cv2.remap(frame, map_x, map_y, INTER_LINEAR, BORDER_REPLICATE)``."""
    from camkifu_tpu_torch.ops.warp import bilinear_sample

    return _u8_round(bilinear_sample(frame, map_x.expand(frame.shape[:2]),
                                     map_y.expand(frame.shape[:2])))


def _warp_board(canon: torch.Tensor, m: np.ndarray,
                h: int, w: int) -> torch.Tensor:
    """``cv2.warpPerspective(canon, m, (w, h), INTER_LINEAR)`` through the
    warp kernel: the inverse map, shifted onto a copy of the board padded
    with one zero pixel (cv2 reads 0 outside the image; the kernel clamps
    to its edge), rounded to uint8."""
    from camkifu_tpu_torch.core.feeder import to_device
    from camkifu_tpu_torch.ops.warp import warp_frames

    shift = np.array([[1.0, 0, 1], [0, 1, 1], [0, 0, 1]])
    hpad = to_device((shift @ np.linalg.inv(m)).astype(np.float32),
                     canon.device)
    padded = F.pad(canon, (0, 0, 1, 1, 1, 1))
    return _u8_round(warp_frames(padded[None], hpad, (h, w))[0])


def render_frame(labels: np.ndarray, corners: np.ndarray | None = None,
                 frame_hw: tuple[int, int] = (1080, 1920),
                 noise: float = 3.0, seed: int = 0,
                 stone_jitter: float = 0.0,
                 light_gradient: float = 0.0,
                 blur_sigma: float = 0.0,
                 shadow: float = 0.0,
                 jitter_seed: int | None = None,
                 wood_texture: float = 0.0,
                 vignette: float = 0.0,
                 motion_blur: tuple[float, float] | None = None,
                 hand: tuple[float, float, float] | None = None,
                 palette: str = "kaya",
                 lens_k1: float = 0.0,
                 white_balance: float = 0.0,
                 glare: float = 0.0,
                 clutter: int = 0,
                 rolling_shutter: tuple[float, float] | None = None,
                 shot_noise: float = 0.0,
                 device="cuda") -> tuple[torch.Tensor, np.ndarray]:
    """Render a camera frame of the given board state on ``device``.

    light_gradient: relative brightness falloff corner-to-corner (0.3 =
    one side of the frame 30% darker — uneven room lighting).
    blur_sigma: defocus blur in pixels (camera out of focus).
    shadow: darkness of a soft elliptical shadow over part of the board
    (0.25 = 25% darker inside, feathered edge — a player leaning in).
    wood_texture: procedural grain amplitude (0.1 ≈ visible kaya streaks).
    vignette: corner darkening of the lens (0.25 = 25% darker at corners).
    motion_blur: (dx, dy) px — directional blur of camera motion this frame.
    hand: (x, y, reach) — a hand + forearm over the board, fingertip at
    frame position (x, y); reach ∈ [0, 1] fades it in/out so render_game
    can animate a move being placed.
    lens_k1: radial lens distortion coefficient (r normalized to half the
    short frame side; >0 = barrel, <0 = pincushion). The returned
    ground-truth corners are distorted through the same model.
    glare: overhead-light specular glare saturating stone tops.
    clutter: number of static foreign objects (capture bowls, a mug) on
    the table around the board, placed per jitter_seed.
    rolling_shutter: (dx, dy) px — the full top-to-bottom scan displacement
    of a CMOS rolling shutter: row y shows the scene shifted by
    (dx, dy)·y/H. Ground-truth corners are displaced through the same model.
    shot_noise: photon shot-noise gain — per-pixel noise std becomes
    sqrt(noise² + shot_noise·I).
    Returns (frame (H, W, 3) uint8 RGB on ``device``, corners (4, 2)
    float32 (x, y)).
    """
    device = torch.device(device)
    rng = np.random.default_rng(seed)
    g = labels.shape[0]
    zone = 24
    key = jitter_seed if jitter_seed is not None else seed
    canon = render_canonical(labels, zone=zone, rng=rng,
                             stone_jitter=stone_jitter, jitter_key=key,
                             wood_texture=wood_texture, glare=glare,
                             palette=palette, device=device)
    h, w = frame_hw
    corners = default_corners(frame_hw) if corners is None else \
        np.asarray(corners, np.float32)
    lo, hi = zone / 2.0, g * zone - zone / 2.0
    src = np.array([[lo, lo], [hi, lo], [hi, hi], [lo, hi]], np.float32)
    m = _perspective(src, corners)
    table = to_device(rng.integers(-6, 6, (h, w, 1)).astype(np.int16), device)
    frame = (table + _table_rgb(device)).clamp(0, 255).to(torch.uint8)
    # Warp the board in, with a mask to blend over the table. The board slab
    # extends half a cell beyond the outer grid lines (like a real goban edge).
    hinv = np.linalg.inv(m)
    mask = _board_mask(hinv.tobytes(), g * zone, h, w, device)
    frame = torch.where(mask[..., None], _warp_board(canon, m, h, w), frame)
    if clutter:
        frame = _draw_clutter(frame, hinv, g * zone, clutter, key)
    if shadow:
        frame = _u8(frame.to(torch.float32)
                    * _shadow_map(h, w, float(shadow), device))
    if hand is not None and hand[2] > 0.0:
        frame = _draw_hand(frame, hand)
    if lens_k1:
        frame = _remap(frame, *_lens_map(h, w, float(lens_k1), device))
        s = min(h, w) / 2.0
        ccx, ccy = w / 2.0, h / 2.0
        pc = corners - np.array([ccx, ccy], np.float32)
        r_u = np.linalg.norm(pc, axis=1, keepdims=True) / s
        corners = (np.array([ccx, ccy], np.float32)
                   + pc * (1.0 + lens_k1 * r_u ** 2)).astype(np.float32)
    if rolling_shutter is not None and any(rolling_shutter):
        # Output (x, y) samples the nominal (row-0-time) scene at
        # (x − dx·y/H, y − dy·y/H).
        dx, dy = float(rolling_shutter[0]), float(rolling_shutter[1])
        yy, xx = _pixel_grid(h, w, device)
        t = yy / float(h)
        frame = _remap(frame, xx - dx * t, yy - dy * t)
        # Ground truth moves with the rows: y_out = y/(1 − dy/H), then the
        # x shear is evaluated at the row actually hit.
        cy = corners[:, 1] / max(1e-6, 1.0 - dy / float(h))
        corners = np.stack([corners[:, 0] + dx * cy / float(h), cy],
                           axis=1).astype(np.float32)
    if motion_blur is not None:
        dx, dy = float(motion_blur[0]), float(motion_blur[1])
        n_k = max(3, int(np.hypot(dx, dy)) | 1)
        if np.hypot(dx, dy) >= 1.0:
            k = _line_kernel(n_k, (int(n_k / 2 - dx / 2), int(n_k / 2 - dy / 2)),
                             (int(n_k / 2 + dx / 2), int(n_k / 2 + dy / 2)))
            k /= max(k.sum(), 1e-6)
            frame = _u8_round(_conv2d_same(frame, k))
    if blur_sigma:
        k = int(blur_sigma * 6) | 1
        frame = _u8_round(_gaussian_blur(frame, k, blur_sigma))
    if light_gradient:
        frame = _u8(frame.to(torch.float32) * _gradient_map(
            h, w, float(light_gradient), device))
    if vignette:
        frame = _u8(frame.to(torch.float32) * _vignette_map(
            h, w, float(vignette), device))
    if white_balance:
        # Miscalibrated camera WB: warm (+) boosts R and cuts B.
        frame = _white_balance(frame.to(torch.float32), white_balance)
    if shot_noise or noise:
        # Read-noise floor (``noise``), plus signal-dependent photon shot
        # noise: std grows with sqrt(intensity). numpy's draw from the
        # frame's generator, on the card by the kernel.
        st = rng.bit_generator.state["state"]
        frame = pcg_normal_kernel.sensor_noise(
            frame.contiguous(), st["state"], st["inc"], float(noise),
            float(shot_noise))
    return frame, corners


def _white_balance(f: torch.Tensor, wb: float) -> torch.Tensor:
    """R × (1 + wb), B × (1 − wb) of a float32 frame, then truncated."""
    return _u8(f * _rgb((1.0 + wb, 1.0, 1.0 - wb), f.device))


def _draw_hand(frame: torch.Tensor, hand) -> torch.Tensor:
    """A hand + forearm reaching in from the bottom edge, fingertip at
    (x, y), with a soft drop shadow under it. reach ∈ (0, 1] interpolates
    the fingertip from the bottom edge to (x, y). The geometry is the
    reference's host arithmetic; the shapes are filled as cv2 fills them
    without anti-aliasing."""
    h, w = frame.shape[:2]
    dev = frame.device
    x, y, reach = float(hand[0]), float(hand[1]), float(hand[2])
    # Entry point on the bottom edge, roughly under the target.
    ex = np.clip(x + 0.18 * w, 0, w - 1)
    tip = np.array([ex + (x - ex) * reach, h - 1 + (y - (h - 1)) * reach],
                   np.float32)
    arm_dir = np.array([ex, h - 1], np.float32) - tip
    nrm = np.linalg.norm(arm_dir) + 1e-6
    arm_dir /= nrm
    ang = np.degrees(np.arctan2(arm_dir[1], arm_dir[0]))
    yy, xx = _pixel_grid(h, w, dev)
    # Soft shadow (offset toward the light's opposite side).
    _, d = _ellipse_d(yy, xx, int(tip[0] + 12), int(tip[1] + 14), 38, 22,
                      ang)
    mask = torch.where(d <= FILL_REACH, 80.0, 0.0)
    mask = torch.where(_capsule(yy, xx, (int(tip[0] + 12 + arm_dir[0] * 30),
                                         int(tip[1] + 14 + arm_dir[1] * 30)),
                                (int(ex + 12), h - 1), _thick_half(44)),
                       60.0, mask)
    mask = torch.round(_gaussian_blur(mask, 31, 12))
    frame = _u8(frame.to(torch.float32)
                * (1.0 - (mask / 255.0) * 0.5)[..., None])
    # Forearm (sleeve) then hand blob + two fingers.
    paint = torch.full((h, w), -1, dtype=torch.int64, device=dev)
    paint[_capsule(yy, xx, (int(tip[0] + arm_dir[0] * 34),
                            int(tip[1] + arm_dir[1] * 34)),
                   (int(ex), h - 1), _thick_half(40))] = 0
    _, d = _ellipse_d(yy, xx, int(tip[0] + arm_dir[0] * 16),
                      int(tip[1] + arm_dir[1] * 16), 26, 17, ang)
    skin = d <= FILL_REACH
    f1 = tip + np.array([-arm_dir[1], arm_dir[0]]) * 5
    f2 = tip - np.array([-arm_dir[1], arm_dir[0]]) * 5
    for f in (f1, f2):
        skin |= _capsule(yy, xx, (int(f[0] + arm_dir[0] * 18),
                                  int(f[1] + arm_dir[1] * 18)),
                         (int(f[0]), int(f[1])), _thick_half(7))
    paint[skin] = 1
    colors = _rgb(_SLEEVE + _SKIN, dev).reshape(2, 3)
    base = frame.to(torch.float32)
    overlay = torch.where((paint >= 0)[..., None],
                          colors[paint.clamp(min=0)], base)
    return _u8_round(overlay * 0.96 + base * 0.04)


def _draw_clutter(frame: torch.Tensor, hinv: np.ndarray, board_size: int,
                  n: int, key: int) -> torch.Tensor:
    """Static foreign objects on the table around the board: capture bowls
    (dark glossy discs holding stone-colored discs) and a mug (straight
    bright edges). Never overlaps the board slab dilated by 12 pixels
    (cv2's 25×25 ``dilate``), decided on the host from the board's
    nearest-pixel map; deterministic per ``key``."""
    h, w = frame.shape[:2]
    dev = frame.device
    rng = np.random.default_rng((0xB071, key))
    out = frame.to(torch.float32)
    placed = 0
    for _ in range(n * 12):
        if placed >= n:
            break
        x = int(rng.uniform(0.04, 0.96) * w)
        y = int(rng.uniform(0.04, 0.96) * h)
        r = int(rng.uniform(0.035, 0.075) * min(h, w))
        y0, y1 = max(0, y - r - 4), min(h, y + r + 4)
        x0, x1 = max(0, x - r - 4), min(w, x + r + 4)
        # keep_out[y0:y1, x0:x1].any(): the board within 12 px of the box.
        ky0, ky1 = max(0, y0 - 12), min(h, y1 + 12)
        kx0, kx1 = max(0, x0 - 12), min(w, x1 + 12)
        v = np.arange(ky0, ky1, dtype=np.float64)[:, None]
        u = np.arange(kx0, kx1, dtype=np.float64)[None, :]
        if ky1 > ky0 and kx1 > kx0 and _nearest_inside(
                hinv, board_size, u, v, np.rint).any():
            continue
        # The object's window: everything it paints lies within r + 2.
        wy0, wy1 = max(0, y - r - 3), min(h, y + r + 4)
        wx0, wx1 = max(0, x - r - 3), min(w, x + r + 4)
        yy, xx = _pixel_grid(wy1 - wy0, wx1 - wx0, dev, wx0, wy0)
        comp = _Composite(torch.ones(yy.shape[0], xx.shape[1], 1,
                                     device=dev),
                          torch.zeros(yy.shape[0], xx.shape[1], 3,
                                      device=dev))
        if placed % 3 == 2:
            # A mug: bright rectangle + elliptical rim.
            col = (rng.integers(150, 230),) * 3
            ry = int(r * 0.8)
            rect = ((xx >= x - r) & (xx <= x + r) & (yy >= y - ry)
                    & (yy <= y + ry)).to(torch.float32)
            comp.paint(_rgb([int(v) for v in col], dev), rect)
            rho, d = _ellipse_d(yy, xx, x, y - ry, r, int(r * 0.35), 0.0)
            comp.paint(_rgb([int(v * 0.8) for v in col], dev),
                       (AA_REACH - d).clamp(0.0, 1.0))
        else:
            # A capture bowl: dark wooden disc with a rim highlight and a
            # few captured stones inside (alternating bowls hold B and W).
            wood = (int(rng.integers(50, 90)), int(rng.integers(35, 65)),
                    int(rng.integers(20, 45)))
            comp.paint(_rgb(wood, dev), _disc(xx - x, yy - y, r))
            d = torch.sqrt((xx - x) ** 2 + (yy - y) ** 2)
            comp.paint(_rgb([min(255, int(v * 1.6)) for v in wood], dev),
                       (1.0 + AA_REACH - (d - r).abs()).clamp(0.0, 1.0))
            stone_col = ((28, 26, 24) if placed % 3 == 0
                         else (235, 233, 228))
            for _s in range(int(rng.integers(3, 7))):
                ang = rng.uniform(0, 2 * np.pi)
                rad = rng.uniform(0, 0.55) * r
                sr = max(2, int(r * 0.22))
                comp.paint(_rgb(stone_col, dev),
                           _disc(xx - int(x + rad * np.cos(ang)),
                                 yy - int(y + rad * np.sin(ang)), sr))
        win = out[wy0:wy1, wx0:wx1]
        out[wy0:wy1, wx0:wx1] = torch.round(win * comp.a + comp.b)
        placed += 1
    return out.to(torch.uint8)


def encode_roundtrip(frames, codec: str = "mp4v", fps: int = 25,
                     path: str | None = None) -> list[np.ndarray]:
    """Encode frames to a video file and decode them back — the sensor/
    compression artifact pass (macroblocking, chroma subsampling, ringing)
    between the renderer and the pipeline. ``frames`` yields (H, W, 3)
    uint8 RGB frames, numpy arrays or tensors on any device; returns the
    decoded RGB frames as numpy arrays (copied from
    camkifu_tpu/utils/synth.py).
    """
    import os
    import tempfile

    import cv2

    own = path is None
    if own:
        fd, path = tempfile.mkstemp(suffix=".mp4")
        os.close(fd)
    try:
        # Stream rendered frames straight into the encoder: materializing
        # the full game on both sides of the codec would double the peak
        # host RSS (a synth:100 realism game at 720p is ~2 GB per side).
        vw = None
        n_in = 0
        for f in frames:
            if isinstance(f, torch.Tensor):
                f = f.cpu().numpy()
            if vw is None:
                h, w = f.shape[:2]
                vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*codec),
                                     fps, (w, h))
                if not vw.isOpened():
                    raise RuntimeError(
                        f"VideoWriter failed for codec {codec!r}")
            vw.write(f[:, :, ::-1])
            n_in += 1
        if vw is None:
            raise RuntimeError("encode round-trip got no frames")
        vw.release()
        cap = cv2.VideoCapture(path)
        out = []
        while True:
            ok, f = cap.read()
            if not ok:
                break
            out.append(f[:, :, ::-1].copy())
        cap.release()
    finally:
        if own:
            os.unlink(path)
    if len(out) != n_in:
        raise RuntimeError(
            f"encode round-trip dropped frames: {n_in} in, "
            f"{len(out)} out")
    return out


# ---------------------------------------------------------------------------
# Games.
# ---------------------------------------------------------------------------

def game_states(moves: list[Move], gsize: int = guiconf.gsize):
    """Board-state (g, g) int8 label grid after each move (rules applied,
    captures removed). Yields (state_after_move, move)."""
    rule = RuleUnsafe(gsize=gsize)
    for move in moves:
        rule.put(move)
        rule.confirm()
        yield rule.as_labels(), move


def render_game(moves: list[Move], frames_per_move=3,
                corners: np.ndarray | None = None,
                frame_hw: tuple[int, int] = (720, 1280),
                gsize: int = guiconf.gsize, seed: int = 0,
                empty_leadin: int = 2, hand_frames: int = 0,
                flicker: float = 0.0, removal_lag: int = 0,
                corners_fn=None, wb_drift: float = 0.0,
                rolling_shutter: float = 0.0, vfr: float = 0.0,
                arm_rests=None, device="cuda", **frame_kwargs):
    """Yield (frame (H, W, 3) uint8 on ``device``, state_labels) for a whole
    game: ``empty_leadin`` frames of the empty board, then
    ``frames_per_move`` frames after each move. Extra kwargs
    (stone_jitter, light_gradient, blur_sigma, shadow, wood_texture,
    vignette, …) pass through to render_frame. A generator: no game is
    held whole on the device.

    frames_per_move may be a sequence with one entry per move (a pause
    mid-game). corners_fn, if given, is called with the global frame index
    and returns that frame's (4, 2) corners — a moving camera; it
    overrides ``corners``, and the hand follows the moving pose.
    hand_frames > 0 animates a hand retreating from each just-played stone
    over that many frames. flicker > 0: a per-frame global gain doing a
    seeded random walk within [1−flicker, 1+flicker], dipping while the
    hand is in frame. removal_lag > 0 keeps captured stones on the board
    for that many frames (the yielded state is the rendered one; game truth
    is ``game_states(moves)``). rolling_shutter > 0 shears each frame by
    that fraction of its own inter-frame camera motion. vfr > 0: with
    probability vfr/2 a frame duplicates the previous one, with vfr/2 the
    camera clock jumps 1–2 steps. arm_rests: (move_index, n_frames) pairs
    of a forearm resting over the board after that move.
    """
    empty = np.zeros((gsize, gsize), np.int8)
    corners = default_corners(frame_hw) if corners is None else corners
    zone = 24
    lo, hi = zone / 2.0, gsize * zone - zone / 2.0
    src = np.array([[lo, lo], [hi, lo], [hi, hi], [lo, hi]], np.float32)
    fpm = (list(frames_per_move) if not isinstance(frames_per_move, int)
           else [frames_per_move] * len(moves))
    if len(fpm) != len(moves):
        raise ValueError(f"frames_per_move sequence has {len(fpm)} entries "
                         f"for {len(moves)} moves")

    def corners_at(idx):
        if corners_fn is None:
            return corners
        return np.asarray(corners_fn(idx), np.float32)

    rng_f = np.random.default_rng(seed + 940229)
    rng_wb = np.random.default_rng(seed + 615243)   # own stream: adding WB
    gain = 1.0                                      # must not move flicker
    wb = 0.0

    def expose(frame, hand_active):
        """Camera auto-pipeline per frame: AE gain hunting (``flicker``)
        and auto-white-balance hunting (``wb_drift``)."""
        nonlocal gain, wb
        if wb_drift:
            wb += float(rng_wb.normal(0.0, 0.25 * wb_drift))
            wb = float(np.clip(wb, -wb_drift, wb_drift))
        if not flicker and not wb_drift:
            return frame
        if flicker:
            target = 1.0 - 0.8 * flicker if hand_active else 1.0
            gain += 0.35 * (target - gain) + rng_f.normal(0.0, 0.4 * flicker)
            gain = float(np.clip(gain, 1.0 - flicker, 1.0 + flicker))
        f = frame.to(torch.float32) * gain
        if wb_drift:
            return _white_balance(f, wb)
        return _u8(f)

    def to_frame_xy(row, col, idx):
        mi = _perspective(src, np.asarray(corners_at(idx), np.float32))
        p = mi @ np.array([(col + 0.5) * zone, (row + 0.5) * zone, 1.0])
        return p[0] / p[2], p[1] / p[2]

    #: (row, col) → [color_int, frames_left] of captured-but-not-yet-removed
    #: stones; counts down across move boundaries.
    linger: dict[tuple[int, int], list[int]] = {}
    prev_state = empty
    rests = dict(arm_rests or ())
    rng_vfr = np.random.default_rng(seed + 424242)
    last_emit = None         # (frame, shown) of the previous rendered frame

    i = 0

    def render_one(shown_state, hand=None):
        """One camera frame at the current clock ``i``: VFR anomalies,
        motion-derived rolling shutter, then render. Returns
        (frame, state_shown) — for a duplicated frame, the PREVIOUS pair."""
        nonlocal i, last_emit
        if vfr and last_emit is not None:
            u = float(rng_vfr.uniform())
            if u < vfr / 2.0:                 # encoder freeze: exact dup
                return last_emit
            if u > 1.0 - vfr / 2.0:           # dropped frames: clock jumps
                i += int(rng_vfr.integers(1, 3))
        kw = frame_kwargs
        if rolling_shutter and i > 0:
            v = (np.asarray(corners_at(i), np.float32)
                 - np.asarray(corners_at(i - 1), np.float32)).mean(axis=0)
            kw = dict(frame_kwargs,
                      rolling_shutter=(rolling_shutter * float(v[0]),
                                       rolling_shutter * float(v[1])))
        frame, _ = render_frame(shown_state, corners_at(i), frame_hw,
                                seed=seed + i, jitter_seed=seed, hand=hand,
                                device=device, **kw)
        i += 1
        last_emit = (frame, shown_state)
        return last_emit

    for _ in range(empty_leadin):
        frame, shown = render_one(empty)
        yield expose(frame, False), shown
    for mi, (state, move) in enumerate(game_states(moves, gsize)):
        if removal_lag and (move.row, move.col) in linger:
            # The next move lands on a point whose captured stone is still
            # physically there: the player sweeps the dead stones off
            # first, a beat of the TRUE pre-move position.
            linger.clear()
            for _ in range(fpm[mi]):
                frame, shown = render_one(prev_state)
                yield expose(frame, False), shown
        if removal_lag:
            gone = (prev_state != 0) & (state == 0)
            for r, c in np.argwhere(gone):
                linger[(int(r), int(c))] = [int(prev_state[r, c]),
                                            removal_lag]
        prev_state = state
        for j in range(fpm[mi]):
            hand = None
            if hand_frames and j < hand_frames:
                x, y = to_frame_xy(move.row, move.col, i)
                hand = (x, y, 1.0 - j / float(hand_frames))
            shown = state
            if linger:
                shown = state.copy()
                removing = []
                for (r, c), entry in list(linger.items()):
                    color, left = entry
                    if left <= 0 or state[r, c] != 0:
                        del linger[(r, c)]     # removed, or legally reused
                        continue
                    shown[r, c] = color
                    entry[1] = left - 1
                    if left <= hand_frames:
                        removing.append((r, c, left))
                if removing and hand is None and hand_frames:
                    # The removing hand reaches IN over the group it is
                    # lifting out (reach grows as frames_left shrinks).
                    rr = float(np.mean([r for r, _, _ in removing]))
                    cc = float(np.mean([c for _, c, _ in removing]))
                    x, y = to_frame_xy(rr, cc, i)
                    hand = (x, y,
                            1.0 - min(l for _, _, l in removing)
                            / float(hand_frames))
            frame, shown_out = render_one(shown, hand=hand)
            yield expose(frame, hand is not None), shown_out
        for _ in range(rests.get(mi, 0)):
            # The player's arm RESTS over the board: fingertip parked a
            # few cells south of the move, motionless at full reach.
            rx, ry = to_frame_xy(min(gsize - 1, move.row + 3), move.col, i)
            frame, shown_out = render_one(shown, hand=(rx, ry, 0.9))
            yield expose(frame, True), shown_out


def moves_from_sgf(path: str) -> list[Move]:
    from camkifu_tpu_torch.gamemodel.kifu import Kifu
    return Kifu.load(path).moves()


def capture_rich_moves(n: int = 24, gsize: int = guiconf.gsize,
                       seed: int = 7) -> list[Move]:
    """An alternating game guaranteed to contain captures: a scripted
    opening where B captures a TWO-stone W group (move 11) and then a
    single W stone (move 19), padded to ``n`` with random capture-free
    filler."""
    assert gsize >= 9, "the scripted set pieces need at least a 9x9 board"
    gs, m = gsize, gsize // 2
    # Tenuki spots scale with the board and are hand-placed clear of both
    # capture clusters.
    t = [(gs - 2, gs - 2), (gs - 3, 2), (gs - 2, gs - 5), (2, gs - 2),
         (gs - 5, gs - 2)]
    script = [
        # B builds the surround of W (2,2)+(2,3); W tenukis elsewhere.
        (B, 3, 2), (W, 2, 2), (B, 2, 1), (W, 2, 3), (B, 1, 2), (W, *t[0]),
        (B, 1, 3), (W, *t[1]), (B, 3, 3), (W, *t[2]),
        (B, 2, 4),                         # captures W (2,2) and (2,3)
        # Single-stone capture of W at the board center.
        (W, m, m), (B, m - 1, m), (W, *t[3]), (B, m + 1, m), (W, *t[4]),
        (B, m, m - 1), (W, 3, gs - 4),
        (B, m, m + 1),                     # captures W (m, m)
    ]
    rule = RuleUnsafe(gsize=gsize)
    moves = []
    for spec in script:                    # never truncated: n < len(script)
        m = Move("np", spec, gsize=gsize)  # returns the whole script
        rule.put(m)
        rule.confirm()
        moves.append(m)
    rng = np.random.default_rng(seed)
    color = W if moves[-1].color == B else B
    tries = 0
    while len(moves) < n and tries < 80 * n:
        tries += 1
        r, c = int(rng.integers(gsize)), int(rng.integers(gsize))
        m = Move("np", (color, r, c), gsize=gsize)
        try:
            if rule.put(m):                # filler must not capture
                rule.discard()
                continue
            rule.confirm()
        except Exception:
            continue
        moves.append(m)
        color = W if color == B else B
    return moves


def gauntlet_scenario(n_moves: int = 19, seed: int = 11,
                      frame_hw: tuple[int, int] = (720, 1280),
                      gsize: int = guiconf.gsize, device="cuda"):
    """THE GAUNTLET — every adversity at once, one game. Returns
    ``(moves, frames_factory)``: the ground-truth kifu and a zero-arg
    callable yielding the footage: a capture-rich game with 60-frame
    removal lag, a handheld drifting + rotating + zooming camera, a
    mid-game camera bump, exposure flicker, white-balance hunting,
    the full realism pass, the tier-3 hazards, and an mp4 encode round
    trip (``encode_roundtrip``: the factory yields its decoded numpy
    frames). The bar is exact move-for-move agreement.
    """
    moves, render = _gauntlet(n_moves, seed, frame_hw, gsize, device)

    def frames_factory():
        return iter(encode_roundtrip(render()))

    return moves, frames_factory


def _gauntlet(n_moves: int, seed: int, frame_hw: tuple[int, int],
              gsize: int, device):
    """The gauntlet's ground-truth kifu and a zero-arg callable yielding
    its rendered (H, W, 3) uint8 frames on ``device``, before the mp4
    round trip."""
    from camkifu_tpu_torch.config import cvconf

    moves = capture_rich_moves(max(n_moves, 19), gsize=gsize, seed=seed)
    # +6: the VFR hazard duplicates ~vfr/2 of the frames and the hand
    # covers 2 more, so each move's distinct observations clear the vote
    # window with margin.
    fpm = cvconf.vote_window + 6
    fpm_list = [fpm] * len(moves)
    fpm_list[13] += 36       # the players pause after the table is knocked
    fpm_list[-1] += 12       # trailing hold so the last move's votes commit
    leadin = 6
    # The knock lands mid-pause, while the two-stone capture's dead stones
    # are STILL physically on the board.
    bump_at = leadin + sum(fpm_list[:13]) + fpm

    base = default_corners(frame_hw)
    c0 = base.mean(axis=0)
    # The camera's TOTAL excursion is fixed (10° rotation + 6% zoom over
    # the whole game); per-frame rates derive from the timeline length.
    total = leadin + sum(fpm_list)

    def cam(i):
        # Handheld: drift ≤0.7 px/frame, slow rotation and zoom.
        th = np.deg2rad(10.0) * i / total
        s = 1.0 + 0.06 * i / total
        if i >= bump_at:                   # the knock: +2° and ~31 px, once
            th += np.deg2rad(2.0)
        rot = np.array([[np.cos(th), -np.sin(th)],
                        [np.sin(th), np.cos(th)]], np.float32)
        cs = c0 + s * (base - c0) @ rot.T
        cs += np.array([6.0 * np.sin(i / 9.0), 5.0 * np.cos(i / 11.0)],
                       np.float32)
        if i >= bump_at:
            cs += np.array([26.0, -17.0], np.float32)
        return cs.astype(np.float32)

    def frames_factory():
        return (f for f, _ in render_game(
            moves, frames_per_move=fpm_list, frame_hw=frame_hw, seed=seed,
            empty_leadin=leadin, corners_fn=cam, gsize=gsize,
            hand_frames=2, flicker=0.12, wb_drift=0.08, removal_lag=60,
            stone_jitter=0.07, light_gradient=0.3, blur_sigma=1.2,
            shadow=0.18, wood_texture=0.10, vignette=0.22,
            rolling_shutter=0.7, vfr=0.12, arm_rests=[(6, fpm)],
            glare=0.5, clutter=3, shot_noise=0.4,
            palette="walnut", device=device))

    return moves, frames_factory


def sample_moves(n: int = 40, gsize: int = guiconf.gsize, seed: int = 7
                 ) -> list[Move]:
    """A random legal alternating game (no captures sought, suicide avoided)."""
    rng = np.random.default_rng(seed)
    rule = RuleUnsafe(gsize=gsize)
    moves = []
    color = B
    tries = 0
    while len(moves) < n and tries < 50 * n:
        tries += 1
        r, c = int(rng.integers(gsize)), int(rng.integers(gsize))
        try:
            rule.put(Move("np", (color, r, c), gsize=gsize))
            rule.confirm()
        except Exception:
            continue
        moves.append(Move("np", (color, r, c), gsize=gsize))
        color = W if color == B else B
    return moves
