"""Independent OpenCV oracle — the reference's classical CPU pipeline,
rebuilt host-side with cv2, for cross-checking the port's pipeline.

Copied from camkifu_tpu/oracle_cv2.py, on the port's host code (``config``,
``core.gamesync.MoveExtractor``, ``board.boardfinder.order_corners``). It
runs on the host only; cv2 is imported inside each function that calls it.

Why this exists (VERDICT r1 item 4): the synthetic renderer and the TPU
detector share geometry conventions, so scoring the TPU pipeline only
against synth ground truth could hide a correlated systematic error. This
module re-creates the reference's *classical* vision path with cv2
primitives only — grayscale → GaussianBlur → Canny → HoughLines corner
finding (SURVEY §3.2, the reference's BoardFinderAuto), cv2.warpPerspective
rectification, cv2.kmeans k=3 luminance-ordered stone classification
(SURVEY §3.3, the reference's SfClustering), and a cyclic-buffer temporal
majority vote (SURVEY §2.1 sf_meta) — with no jax anywhere, so its moves
are an independent measurement of the same video. ``ckfilecheck --oracle
cv2`` scores it; ``--oracle both`` additionally reports TPU↔cv2
cross-agreement (the BASELINE.md north star: "≥99% move agreement vs the
OpenCV reference").

Conventions match the framework: corners are the OUTER GRID intersections
(tl/tr/br/bl, x-y pixel coordinates, OpenCV pixel-center convention).
"""

from __future__ import annotations

import numpy as np

from camkifu_tpu_torch.config import cvconf, guiconf
from camkifu_tpu_torch.core.gamesync import MoveExtractor


# ---------------------------------------------------------------------------
# Corner detection: Canny + HoughLines + even-lattice selection (SURVEY §3.2)
# ---------------------------------------------------------------------------

def _line_families(lines: np.ndarray):
    """Split (N, 2) (rho, theta) lines into the two dominant perpendicular
    orientation families (theta histogram peaks on the doubled circle)."""
    theta = lines[:, 1]
    # Doubled-angle mean-shift: lines live on a period-pi circle.
    ang2 = 2.0 * theta
    hist, edges = np.histogram(ang2, bins=36, range=(0, 2 * np.pi))
    main = edges[np.argmax(hist)] + (edges[1] - edges[0]) / 2
    d = np.angle(np.exp(1j * (ang2 - main)))
    fam_a = np.abs(d) < np.pi / 4              # within pi/8 of the main dir
    fam_b = np.abs(np.abs(d) - np.pi) < np.pi / 4
    return lines[fam_a], lines[fam_b]


def _family_axis(lines: np.ndarray) -> float:
    """Circular mean orientation of a family (period-π doubled-angle)."""
    return float(np.angle(np.exp(2j * lines[:, 1]).mean()) / 2 % np.pi)


def _signed_rho(lines: np.ndarray, theta_f: float) -> np.ndarray:
    """Re-express each (rho, theta) against the family axis theta_f: a line
    is (ρ, θ) ≡ (−ρ, θ±π), so lines on the wrapped branch flip sign."""
    rho = lines[:, 0].copy()
    flip = np.cos(lines[:, 1] - theta_f) < 0
    rho[flip] = -rho[flip]
    return rho


def _dedup(rhos: np.ndarray, lines: np.ndarray, min_gap: float = 8.0):
    """Merge near-duplicate Hough peaks (the transform reports strong lines
    several times at adjacent ρ/θ bins). Each merged group keeps the mean
    signed ρ for lattice walking and the strongest member's ORIGINAL (ρ, θ)
    for geometry — cv2.HoughLines returns lines vote-ordered, so the lowest
    original index wins. Returns (signed_rhos (M,), originals (M, 2))."""
    order = np.argsort(rhos)
    groups: list[dict] = []
    for oi in order:
        if groups and rhos[oi] - groups[-1]["last"] < min_gap:
            g = groups[-1]
            g["sum"] += rhos[oi]
            g["n"] += 1
            g["last"] = rhos[oi]
            g["best"] = min(g["best"], oi)
        else:
            groups.append({"sum": rhos[oi], "n": 1, "last": rhos[oi],
                           "best": oi})
    out_r = np.array([g["sum"] / g["n"] for g in groups])
    out_l = np.array([lines[g["best"]] for g in groups])
    return out_r, out_l


def _lattice_extremes(rhos: np.ndarray, gsize: int):
    """Find the grid's outer-line indices among parallel-line offsets.

    The grid is gsize near-evenly spaced lines (pitch drifts smoothly with
    perspective); slab/table edges sit off-pitch. Walk chains with an
    ADAPTIVE pitch (each accepted step re-estimates it, following the
    perspective drift), allowing up to two consecutive suppressed lines
    (stones can hide interior lines), and accept only a chain covering
    exactly gsize lattice positions. Returns (i_low, i_high) indices into
    ``rhos`` or None.
    """
    n = len(rhos)
    if n < gsize // 2:
        return None
    gaps = np.diff(rhos)
    pos = gaps[gaps > 4]
    if len(pos) == 0:
        return None
    p0 = float(np.median(pos))
    best = None
    for i in range(n - 1):
        for j in range(i + 1, n):
            p = rhos[j] - rhos[i]
            if not (0.55 * p0 < p < 1.7 * p0):
                continue
            cur, cp, count = j, p, 2
            while count < gsize + 2:
                nxt = None
                for mult in (1, 2, 3):       # allow suppressed lines
                    t = rhos[cur] + mult * cp
                    k = int(np.argmin(np.abs(rhos - t)))
                    if abs(rhos[k] - t) < 0.3 * cp * mult \
                            and rhos[k] > rhos[cur] + 0.5 * cp:
                        nxt = (k, (rhos[k] - rhos[cur]) / mult, mult)
                        break
                if nxt is None:
                    break
                cur, cp = nxt[0], nxt[1]
                count += nxt[2]
            if count == gsize:
                cand = (i, cur)
                span = rhos[cur] - rhos[i]
                if best is None or span > rhos[best[1]] - rhos[best[0]]:
                    best = cand
    return best


def _intersect(rho1, theta1, rho2, theta2):
    a = np.array([[np.cos(theta1), np.sin(theta1)],
                  [np.cos(theta2), np.sin(theta2)]])
    b = np.array([rho1, rho2])
    return np.linalg.solve(a, b)


def detect_corners_cv2(frame_rgb: np.ndarray,
                       gsize: int = guiconf.gsize) -> np.ndarray | None:
    """Classical corner finder: Canny edges → HoughLines → two families →
    adaptive-pitch lattice walk → the 4 outer-grid-line intersections,
    ordered tl/tr/br/bl. Returns None when no board is found."""
    import cv2

    gray = cv2.cvtColor(frame_rgb, cv2.COLOR_RGB2GRAY)
    blur = cv2.GaussianBlur(gray, (5, 5), 1.4)
    v = float(np.median(blur))
    edges = cv2.Canny(blur, max(20, 0.4 * v), max(60, 1.2 * v))
    lines = None
    for thresh in (260, 200, 150, 110, 80):
        raw = cv2.HoughLines(edges, 1, np.pi / 360, thresh)
        if raw is not None and len(raw) >= 30:
            lines = raw[:, 0, :]
            break
    if lines is None:
        return None

    fam_a, fam_b = _line_families(lines)
    if len(fam_a) < 6 or len(fam_b) < 6:
        return None
    corners = []
    ta = _family_axis(fam_a)
    tb = _family_axis(fam_b)
    ra_s, la_orig = _dedup(_signed_rho(fam_a, ta), fam_a)
    rb_s, lb_orig = _dedup(_signed_rho(fam_b, tb), fam_b)
    ia = _lattice_extremes(ra_s, gsize)
    ib = _lattice_extremes(rb_s, gsize)
    if ia is None or ib is None:
        return None
    # Intersect with each extreme line's ORIGINAL (ρ, θ): using the family
    # axis θ would tilt perspective-spread lines and drag corners by tens
    # of pixels.
    for a in ia:
        for b_ in ib:
            corners.append(_intersect(la_orig[a][0], la_orig[a][1],
                                      lb_orig[b_][0], lb_orig[b_][1]))
    corners = np.array(corners, np.float32)
    if not np.isfinite(corners).all():
        return None
    from camkifu_tpu_torch.board.boardfinder import order_corners
    return order_corners(corners)


# ---------------------------------------------------------------------------
# Stone classification: warpPerspective + kmeans (SURVEY §3.3)
# ---------------------------------------------------------------------------

def classify_frame_cv2(frame_rgb: np.ndarray, corners: np.ndarray,
                       gsize: int = guiconf.gsize,
                       zone: int = cvconf.zone_size) -> np.ndarray:
    """One frame → (g, g) int8 board reading {0 empty, 1 black, 2 white},
    via cv2.warpPerspective + cv2.kmeans(k=3) ordered by luminance — the
    reference's SfClustering (SURVEY §2.1)."""
    import cv2

    size = gsize * zone
    lo = zone / 2.0 - 0.5
    hi = size - zone / 2.0 - 0.5
    dst = np.array([[lo, lo], [hi, lo], [hi, hi], [lo, hi]], np.float32)
    m = cv2.getPerspectiveTransform(corners.astype(np.float32), dst)
    canon = cv2.warpPerspective(frame_rgb, m, (size, size))

    # Per-intersection central color means (the reference samples zones).
    zones = canon.reshape(gsize, zone, gsize, zone, 3)
    q = zone // 4
    samples = zones[:, q:-q, :, q:-q, :].mean(axis=(1, 3)) \
        .reshape(-1, 3).astype(np.float32)

    crit = (cv2.TERM_CRITERIA_EPS + cv2.TERM_CRITERIA_MAX_ITER, 12, 0.5)
    _, labels, centers = cv2.kmeans(samples, 3, None, crit, 3,
                                    cv2.KMEANS_PP_CENTERS)
    labels = labels.reshape(-1)
    luma = centers @ np.array([0.299, 0.587, 0.114], np.float32)
    order = np.argsort(luma)                   # dark, mid, bright
    dark, mid, bright = order[0], order[1], order[2]
    board = np.zeros(gsize * gsize, np.int8)
    # Self-assessment (the reference's SfClustering abstains when clusters
    # degenerate): clusters count as stones only if separated from the
    # middle (board wood) level.
    if luma[bright] - luma[mid] > 40:
        board[labels == bright] = 2
    if luma[mid] - luma[dark] > 40:
        board[labels == dark] = 1
    return board.reshape(gsize, gsize)


# ---------------------------------------------------------------------------
# Temporal vote + move extraction (SURVEY §2.1 sf_meta, cyclic buffer)
# ---------------------------------------------------------------------------

def run_pipeline_cv2(frames_iter, corners: np.ndarray | None,
                     gsize: int = guiconf.gsize,
                     vote_window: int = cvconf.vote_window,
                     extractor: MoveExtractor | None = None):
    """Drive the classical pipeline over all frames (host, no jax).

    corners=None → detect with detect_corners_cv2 on the first frames until
    one sticks (the reference accumulates until stable).
    Returns (extractor, stats dict).
    """
    import time

    extractor = extractor or MoveExtractor(gsize=gsize)
    ring: list[np.ndarray] = []
    prev_small = None
    n_frames = 0
    t0 = time.perf_counter()
    for frame in frames_iter:
        n_frames += 1
        if corners is None:
            corners = detect_corners_cv2(frame, gsize=gsize)
            if corners is None:
                continue
        # Agitation gate (frame differencing, SURVEY §3.3): skip readings
        # while the scene moves.
        small = frame[::8, ::8].astype(np.float32)
        if prev_small is not None:
            if np.mean(np.abs(small - prev_small) > 20) > 0.02:
                prev_small = small
                continue
        prev_small = small
        reading = classify_frame_cv2(frame, corners, gsize)
        ring.append(reading)
        if len(ring) > vote_window:
            ring.pop(0)
        if len(ring) < vote_window:
            continue
        stack = np.stack(ring)
        # Per-intersection majority over the window; only unanimous-enough
        # readings pass (the reference's consistency requirement).
        stable = np.zeros_like(reading)
        for v in (1, 2):
            stable[(stack == v).mean(axis=0) >= 0.8] = v
        extractor.advance(stable)
    dt = time.perf_counter() - t0
    return extractor, {"frames": n_frames, "seconds": dt,
                       "fps": n_frames / dt if dt > 0 else 0.0,
                       "corners": None if corners is None
                       else np.asarray(corners).round(1).tolist()}
