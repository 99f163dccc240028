"""Synthetic camera stills and recorded games of a goban with known labels
and corners, drawn with numpy alone (no cv2, no JAX), for runs on machines
that have neither. Moves come from the reference's rules engine.

The board is drawn analytically in board coordinates — intersection (r, c)
at (c, r), the slab reaching half a cell past the outer lines — and every
frame pixel is mapped into it through the inverse homography of the
corners, with edges anti-aliased over one frame pixel. The corner layout
follows ``camkifu_tpu.utils.synth.default_corners``.
"""

from __future__ import annotations

import numpy as np

from camkifu_tpu_torch.gamemodel.move import B, W, Move
from camkifu_tpu_torch.gamemodel.rules import IllegalMove, RuleUnsafe

WOOD = (193, 154, 107)
LINE = (40, 30, 20)
BLACK_STONE = (28, 26, 24)
WHITE_STONE = (235, 233, 228)
TABLE = (70, 75, 60)


def default_corners(frame_hw=(1080, 1920), perspective: float = 0.12):
    """(4, 2) float32 (x, y) of the corner intersections, tl/tr/br/bl: the
    board fills most of the frame with a mild keystone."""
    h, w = frame_hw
    cx, cy = w / 2.0, h / 2.0
    half = 0.42 * min(h, w)
    k = perspective * half
    return np.array([[cx - half + k, cy - half + k * 0.5],
                     [cx + half - k, cy - half + k * 0.5],
                     [cx + half, cy + half],
                     [cx - half, cy + half]], dtype=np.float32)


def _homography(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """3×3 H with dst ~ H @ src, from 4 point pairs (float64 DLT)."""
    rows, rhs = [], []
    for (x, y), (u, v) in zip(src, dst):
        rows.append([x, y, 1, 0, 0, 0, -u * x, -u * y])
        rows.append([0, 0, 0, x, y, 1, -v * x, -v * y])
        rhs += [u, v]
    h = np.linalg.solve(np.array(rows, np.float64), np.array(rhs, np.float64))
    return np.append(h, 1.0).reshape(3, 3)


def _render_clean(labels: np.ndarray, corners: np.ndarray,
                  frame_hw) -> np.ndarray:
    """The noise-free frame (H, W, 3) float32 of a board reading."""
    h, w = frame_hw
    g = labels.shape[0]
    board = np.array([[0, 0], [g - 1, 0], [g - 1, g - 1], [0, g - 1]],
                     np.float64)
    hi = _homography(corners.astype(np.float64), board)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    den = hi[2, 0] * xx + hi[2, 1] * yy + hi[2, 2]
    bu = (hi[0, 0] * xx + hi[0, 1] * yy + hi[0, 2]) / den
    bv = (hi[1, 0] * xx + hi[1, 1] * yy + hi[1, 2]) / den
    del xx, yy, den
    # One frame pixel in board units, for one-pixel anti-aliasing.
    px = (g - 1) / float(np.linalg.norm(corners[2] - corners[3]))

    def cover(dist, radius):
        return np.clip(0.5 - (dist - radius) / px, 0.0, 1.0)

    slab = cover(np.maximum(np.abs(bu - (g - 1) / 2.0),
                            np.abs(bv - (g - 1) / 2.0)), g / 2.0)
    ru = np.clip(np.rint(bu), 0, g - 1)
    rv = np.clip(np.rint(bv), 0, g - 1)
    span = np.maximum(np.abs(bu - (g - 1) / 2.0), np.abs(bv - (g - 1) / 2.0))
    on_grid = cover(span, (g - 1) / 2.0 + 0.04)
    lines = np.maximum(cover(np.abs(bu - ru), 0.04),
                       cover(np.abs(bv - rv), 0.04)) * on_grid
    if g == 19:
        star = np.isin(ru, (3, 9, 15)) & np.isin(rv, (3, 9, 15))
        lines = np.maximum(lines, star * cover(np.hypot(bu - ru, bv - rv),
                                               0.1))

    grain = 1.0 + 0.04 * np.sin(2.0 * np.pi * (bu * 0.9 + 0.05 * bv))
    img = np.empty((h, w, 3), np.float64)
    img[:] = TABLE
    img += (np.asarray(WOOD, np.float64) * grain[..., None] - img) \
        * slab[..., None]
    img += (np.asarray(LINE, np.float64) - img) * lines[..., None]
    del grain, lines, on_grid, span

    lab = labels[rv.astype(np.int64), ru.astype(np.int64)]
    dist = np.hypot(bu - ru, bv - rv)
    radius = 0.47
    glint = np.hypot(bu - ru + radius / 3.0, bv - rv + radius / 3.0)
    for value, color in ((1, BLACK_STONE), (2, WHITE_STONE)):
        c = np.asarray(color, np.float64)
        cov = cover(dist, radius) * (lab == value)
        img += (c - img) * cov[..., None]
        hl = np.minimum(c + 35.0, 255.0)
        img += (hl - img) * (cover(glint, radius / 3.0) * cov)[..., None]
    return img.astype(np.float32)


def _noisy(img: np.ndarray, rng: np.random.Generator,
           noise: float) -> np.ndarray:
    """Gaussian sensor noise of σ ``noise``, drawn in float32 (a recorded
    game draws it for every frame)."""
    out = rng.standard_normal(img.shape, dtype=np.float32)
    out *= np.float32(noise)
    out += img
    return np.clip(out, 0, 255, out=out).astype(np.uint8)


def render_still(labels: np.ndarray, frame_hw=(1080, 1920), seed: int = 0,
                 noise: float = 3.0, corners: np.ndarray | None = None):
    """labels (g, g) int (0=E, 1=B, 2=W) → (frame (H, W, 3) uint8 RGB,
    corners (4, 2) float32); ``corners`` defaults to ``default_corners``."""
    if corners is None:
        corners = default_corners(frame_hw)
    corners = np.asarray(corners, np.float32)
    img = _render_clean(labels, corners, frame_hw)
    return _noisy(img, np.random.default_rng(seed), noise), corners


def sample_moves(n: int, gsize: int = 19, seed: int = 7) -> list[Move]:
    """A seeded random legal alternating game (no captures sought, suicide
    avoided): the sampler of ``camkifu_tpu.utils.synth.sample_moves``,
    which needs cv2 to import, on the rules engine alone."""
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
        except IllegalMove:
            continue
        moves.append(Move("np", (color, r, c), gsize=gsize))
        color = W if color == B else B
    return moves


def game_states(moves: list[Move], gsize: int = 19):
    """The (g, g) int8 board after each move, captures removed."""
    rule = RuleUnsafe(gsize=gsize)
    for move in moves:
        rule.put(move)
        rule.confirm()
        yield rule.as_labels()


def render_game(moves: list[Move], frames_per_move: int,
                frame_hw=(720, 1280), gsize: int = 19, seed: int = 0,
                empty_leadin: int = 2, noise: float = 3.0,
                corners: np.ndarray | None = None):
    """A recorded game from a fixed camera → (frames (N, H, W, 3) uint8,
    corners (4, 2) float32): ``empty_leadin`` frames of the empty board,
    then ``frames_per_move`` frames after each move. Each board state is
    rendered once; every frame gets its own sensor noise."""
    if corners is None:
        corners = default_corners(frame_hw)
    corners = np.asarray(corners, np.float32)
    rng = np.random.default_rng(seed)
    states = [(np.zeros((gsize, gsize), np.int8), empty_leadin)]
    states += [(s, frames_per_move) for s in game_states(moves, gsize)]
    frames = np.empty((sum(k for _, k in states),) + tuple(frame_hw) + (3,),
                      np.uint8)
    i = 0
    for labels, k in states:
        img = _render_clean(labels, corners, frame_hw)
        for _ in range(k):
            frames[i] = _noisy(img, rng, noise)
            i += 1
    return frames, corners
