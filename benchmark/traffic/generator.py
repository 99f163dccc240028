"""The one traffic generator: pools of camera frames drawn on the device.

A frozen copy of the port's numpy still renderer (``utils/still.py``:
``_render_clean``, ``_noisy``, ``default_corners``, ``handheld_corners``,
``distort_corners``), rewritten in plain PyTorch so that it draws on the
card from ``--seed``, in float32 and a batch of frames a call. It imports
nothing of the program: a later change to the program's renderers moves
none of these inputs.

What a cell gets is set by two data files: the configuration (board and
frame sizes, the number of streams, the camera, the noise, the lens) and
the traffic mix (frames a batch, batches in the pool, the opening's stone
count, the moves a stream plays in one pass over the pool). A camera's
corners frame by frame come from its kind's module,
``traffic/cameras/<kind>.py``, found by name. ``make_inputs`` returns:

- ``pool``: (R, S, B, H, W, 3) uint8, R batches of S streams × B frames, so
  batch r is ``pool[r]``, one contiguous block;
- ``corners``: (R, S, B, 4, 2) float32, the true corners of every frame as
  the frame shows them (through its lens);
- ``truth``: (R, S, B, g, g) int8, the board every frame shows (0 empty,
  1 black, 2 white);
- ``k1``: (S,) float32, each stream's lens coefficient (0 for a pinhole).

The pool is replayed: where it wraps, the stones its pass added are taken
off again, as a capture takes them. Every draw comes from the seed: the
openings, the moves and their frames, and the order in which the cameras
are dealt their placements and lenses (the same even grids for every
seed) from a numpy generator; the sensor noise from a ``torch.Generator``
on the device.
"""

from __future__ import annotations

import importlib
import math

import numpy as np
import torch

WOOD = (193.0, 154.0, 107.0)
LINE = (40.0, 30.0, 20.0)
BLACK_STONE = (28.0, 26.0, 24.0)
WHITE_STONE = (235.0, 233.0, 228.0)
TABLE = (70.0, 75.0, 60.0)
STONE_RADIUS = 0.47

#: Frames rendered in one call: the renderer's intermediates are this
#: many frames of float32.
RENDER_CHUNK = 8


def default_corners(frame_hw, perspective: float = 0.12) -> np.ndarray:
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


def handheld_corners(n: int, frame_hw, drift, periods, phase: float = 0.0,
                     perspective: float = 0.12) -> np.ndarray:
    """(n, 4, 2) float32 corners of a camera held in the hand: frame t
    sees ``default_corners`` moved by (drift_x·sin((t + phase)/period_x),
    drift_y·cos((t + phase)/period_y)) px."""
    base = default_corners(frame_hw, perspective)
    t = np.arange(n, dtype=np.float64) + phase
    move = np.stack([drift[0] * np.sin(t / periods[0]),
                     drift[1] * np.cos(t / periods[1])], -1)
    return (base[None] + move[:, None, :]).astype(np.float32)


def distort_corners(corners: np.ndarray, k1: float, frame_hw) -> np.ndarray:
    """Pinhole points (..., 2) → where a k1 lens shows them: p_d = c +
    (p_u − c)(1 + k1·r_u²), r normalized to half the short frame side."""
    if not k1:
        return np.asarray(corners, np.float32)
    h, w = frame_hw
    c = np.array([w / 2.0, h / 2.0], np.float64)
    pc = np.asarray(corners, np.float64) - c
    r_u = np.linalg.norm(pc, axis=-1, keepdims=True) / (min(h, w) / 2.0)
    return (c + pc * (1.0 + k1 * r_u ** 2)).astype(np.float32)


def _homography(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """3×3 H with dst ~ H @ src, from 4 point pairs (float64 DLT)."""
    rows, rhs = [], []
    for (x, y), (u, v) in zip(src, dst):
        rows.append([x, y, 1, 0, 0, 0, -u * x, -u * y])
        rows.append([0, 0, 0, x, y, 1, -v * x, -v * y])
        rhs += [u, v]
    h = np.linalg.solve(np.array(rows, np.float64), np.array(rhs, np.float64))
    return np.append(h, 1.0).reshape(3, 3)


def pinhole_grid(frame_hw, k1: float, device) -> tuple:
    """(yy, xx) float32 (H, W): where each frame pixel looks in the pinhole
    scene (the inverse radius by 4 fixed-point steps)."""
    h, w = frame_hw
    yy = torch.arange(h, dtype=torch.float32, device=device)[:, None] \
        .expand(h, w)
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, :] \
        .expand(h, w)
    if not k1:
        return yy, xx
    s = min(h, w) / 2.0
    cx, cy = w / 2.0, h / 2.0
    rd = torch.sqrt((xx - cx) ** 2 + (yy - cy) ** 2) / s
    ru = rd.clone()
    for _ in range(4):
        ru = rd / (1.0 + k1 * ru * ru)
    # Far out in a frame's corners a strong pincushion has no inverse and
    # the steps diverge: those pixels keep their own position (they show
    # the table, far from any board).
    found = torch.isfinite(ru) & (ru > 0) & (rd > 1e-9)
    scale = torch.where(found, ru / torch.clamp(rd, min=1e-9), 1.0)
    return cy + (yy - cy) * scale, cx + (xx - cx) * scale


def _color(rgb, device) -> torch.Tensor:
    return torch.tensor(rgb, dtype=torch.float32, device=device)


def render_clean(labels: torch.Tensor, corners: np.ndarray, grid,
                 line_width: float) -> torch.Tensor:
    """Noise-free frames (N, H, W, 3) float32 in [0, 255] of N boards
    ``labels`` (N, g, g) int, each seen through its pinhole ``corners``
    (N, 4, 2) on the pixel ``grid`` of ``pinhole_grid``."""
    dev = labels.device
    n, g = labels.shape[0], labels.shape[1]
    yy, xx = grid
    board = np.array([[0, 0], [g - 1, 0], [g - 1, g - 1], [0, g - 1]],
                     np.float64)
    hi = torch.tensor(np.stack([_homography(c.astype(np.float64), board)
                                for c in corners]), dtype=torch.float32,
                      device=dev)[:, :, :, None, None]        # (N, 3, 3, 1, 1)
    den = hi[:, 2, 0] * xx + hi[:, 2, 1] * yy + hi[:, 2, 2]
    # Board coordinates; a pixel on the board plane's horizon maps nowhere
    # near the board.
    far = float(4 * g)
    bu = torch.nan_to_num((hi[:, 0, 0] * xx + hi[:, 0, 1] * yy + hi[:, 0, 2])
                          / den, nan=-far, posinf=far, neginf=-far)
    bv = torch.nan_to_num((hi[:, 1, 0] * xx + hi[:, 1, 1] * yy + hi[:, 1, 2])
                          / den, nan=-far, posinf=far, neginf=-far)
    del den
    # One frame pixel in board units, for one-pixel anti-aliasing.
    px = torch.tensor([(g - 1) / float(np.linalg.norm(c[2] - c[3]))
                       for c in corners], dtype=torch.float32,
                      device=dev)[:, None, None]

    def cover(dist, radius):
        return torch.clamp(0.5 - (dist - radius) / px, 0.0, 1.0)

    mid = (g - 1) / 2.0
    span = torch.maximum(torch.abs(bu - mid), torch.abs(bv - mid))
    slab = cover(span, g / 2.0)
    ru = torch.clamp(torch.round(bu), 0, g - 1)
    rv = torch.clamp(torch.round(bv), 0, g - 1)
    half = line_width / 2.0
    on_grid = cover(span, mid + half)
    del span
    lines = torch.maximum(cover(torch.abs(bu - ru), half),
                          cover(torch.abs(bv - rv), half)) * on_grid
    del on_grid
    if g == 19:
        hoshi = torch.tensor([3.0, 9.0, 15.0], device=dev)
        star = torch.isin(ru, hoshi) & torch.isin(rv, hoshi)
        lines = torch.maximum(lines, star * cover(
            torch.hypot(bu - ru, bv - rv), 0.1))
        del star
    grain = 1.0 + 0.04 * torch.sin(2.0 * math.pi * (bu * 0.9 + 0.05 * bv))
    img = _color(TABLE, dev).expand(*bu.shape, 3).clone()
    img += (_color(WOOD, dev) * grain[..., None] - img) * slab[..., None]
    del grain, slab
    img += (_color(LINE, dev) - img) * lines[..., None]
    del lines

    bi = torch.arange(n, device=dev)[:, None, None]
    lab = labels[bi, rv.long(), ru.long()]
    dist = torch.hypot(bu - ru, bv - rv)
    glint = torch.hypot(bu - ru + STONE_RADIUS / 3.0,
                        bv - rv + STONE_RADIUS / 3.0)
    del bu, bv, ru, rv
    for value, rgb in ((1, BLACK_STONE), (2, WHITE_STONE)):
        c = _color(rgb, dev)
        cov = cover(dist, STONE_RADIUS) * (lab == value)
        img += (c - img) * cov[..., None]
        hl = torch.clamp(c + 35.0, max=255.0)
        img += (hl - img) * (cover(glint, STONE_RADIUS / 3.0) * cov)[..., None]
    return img


def add_noise(img: torch.Tensor, sigma: float,
              gen: torch.Generator) -> torch.Tensor:
    """Gaussian sensor noise of σ ``sigma`` from ``gen``, clipped and cut
    to uint8 as the still renderer does."""
    out = torch.randn(img.shape, generator=gen, dtype=torch.float32,
                      device=img.device)
    out.mul_(sigma).add_(img).clamp_(0.0, 255.0)
    return out.to(torch.uint8)


def opening_and_moves(rng: np.random.Generator, gsize: int, n_start: int,
                      n_moves: int) -> tuple[np.ndarray, list]:
    """A board of ``n_start`` stones and ``n_moves`` stones played after
    it, on distinct intersections in alternating colours from black."""
    cells = rng.permutation(gsize * gsize)[:n_start + n_moves]
    board = np.zeros(gsize * gsize, np.int8)
    colours = 1 + (np.arange(n_start + n_moves) % 2)
    board[cells[:n_start]] = colours[:n_start]
    moves = [(int(c), int(v)) for c, v in zip(cells[n_start:],
                                              colours[n_start:])]
    return board.reshape(gsize, gsize), moves


def stream_boards(board: np.ndarray, moves: list, at: list,
                  n_frames: int) -> np.ndarray:
    """(n_frames, g, g) int8: the opening, and each move from its frame
    in ``at`` (ascending) on."""
    g = board.shape[0]
    out = np.empty((n_frames, g, g), np.int8)
    cur = board.reshape(-1).copy()
    nxt = 0
    for f in range(n_frames):
        while nxt < len(moves) and at[nxt] <= f:
            cell, colour = moves[nxt]
            cur[cell] = colour
            nxt += 1
        out[f] = cur.reshape(g, g)
    return out


def camera(kind: str):
    """The camera module of ``kind``: ``traffic/cameras/<kind>.py``."""
    return importlib.import_module(f"benchmark.traffic.cameras.{kind}")


def stream_plan(cfg: dict, mix: dict, seed: int) -> list[dict]:
    """Each stream's draws, on the host from the seed: its opening and
    moves, its pinhole corners for every frame of the pool, its k1."""
    rng = np.random.default_rng(seed)
    g = cfg["gsize"]
    hw = tuple(cfg["frame_hw"])
    cam = cfg["camera"]
    n_frames = mix["pool_batches"] * mix["batch_frames"]
    lo, hi = mix["start_stones"]
    n = cfg["streams"]
    # Each seed deals the cameras the same set of placements (even grids
    # over their ranges), to the streams in its own order, so every seed
    # asks the same work.
    order = rng.permutation(n)
    k1_of = rng.permutation(n)
    lens = cam.get("k1_range")
    plan = []
    for i in range(n):
        n_start = int(rng.integers(lo, hi + 1))
        board, moves = opening_and_moves(rng, g, n_start,
                                         mix["moves_per_round"])
        at = sorted(int(f) for f in rng.integers(1, n_frames, len(moves)))
        pinhole = camera(cam["kind"]).pinhole(cam, hw, n_frames,
                                              int(order[i]), n)
        k1 = 0.0
        if lens:
            k1 = float(np.float32(lens[0] + (lens[1] - lens[0])
                                  * k1_of[i] / max(n - 1, 1)))
        plan.append({"boards": stream_boards(board, moves, at, n_frames),
                     "pinhole": np.ascontiguousarray(pinhole,
                                                     dtype=np.float32),
                     "k1": k1})
    return plan


#: Frames of noise drawn in one call.
NOISE_CHUNK = 16


def make_inputs(cfg: dict, mix: dict, seed: int, device) -> dict:
    """Render the cell's pool on ``device`` (see the module's docstring).
    A run of frames that shows one board through the same corners is
    drawn once, and its frames differ by their noise alone."""
    hw = tuple(cfg["frame_hw"])
    r, b, s = mix["pool_batches"], mix["batch_frames"], cfg["streams"]
    g = cfg["gsize"]
    plan = stream_plan(cfg, mix, seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    pool = torch.empty((r, s, b) + hw + (3,), dtype=torch.uint8,
                       device=device)
    n_frames = r * b
    for i, st in enumerate(plan):
        grid = pinhole_grid(hw, st["k1"], device)
        boards, pin = st["boards"], st["pinhole"]
        same = np.r_[False, (boards[1:] == boards[:-1]).all((1, 2))
                     & (pin[1:] == pin[:-1]).all((1, 2))]
        keys = np.flatnonzero(~same)
        ends = np.r_[keys[1:], n_frames]
        for j in range(0, len(keys), RENDER_CHUNK):
            ks = keys[j:j + RENDER_CHUNK]
            clean = render_clean(torch.as_tensor(boards[ks], device=device),
                                 pin[ks], grid, cfg["line_width"])
            for img, k, e in zip(clean, ks, ends[j:j + RENDER_CHUNK]):
                for f0 in range(int(k), int(e), NOISE_CHUNK):
                    f1 = min(f0 + NOISE_CHUNK, int(e))
                    noisy = add_noise(img.expand(f1 - f0, *img.shape),
                                      cfg["noise_sigma"], gen)
                    for f in range(f0, f1):
                        pool[f // b, i, f % b] = noisy[f - f0]
            del clean
        del grid
    corners = np.stack([distort_corners(st["pinhole"], st["k1"], hw)
                        for st in plan], 1)                  # (F, S, 4, 2)
    truth = np.stack([st["boards"] for st in plan], 1)       # (F, S, g, g)
    return {
        "pool": pool,
        "corners": torch.as_tensor(
            corners.reshape(r, b, s, 4, 2).transpose(0, 2, 1, 3, 4).copy(),
            device=device),
        "truth": torch.as_tensor(
            truth.reshape(r, b, s, g, g).transpose(0, 2, 1, 3, 4).copy(),
            device=device),
        "k1": torch.tensor([st["k1"] for st in plan], dtype=torch.float32,
                           device=device),
    }
