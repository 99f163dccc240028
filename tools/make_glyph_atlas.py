#!/usr/bin/env python3
"""Measure cv2's overlay rasterisation into the data file that the port's
``core/imgutil`` draws with (``camkifu_tpu_torch/core/cv2_draw.npz``).

    python3 tools/make_glyph_atlas.py [--out PATH]

Needs cv2 (the reference's drawing library); the port never imports it.

- **Glyphs.** ``cv2.putText(..., FONT_HERSHEY_SIMPLEX, 0.5, color,
  thickness, LINE_AA)`` draws a string as one coverage mask, the union of
  its glyphs' masks, blended once. Each glyph's mask is translated by
  whole pixels only (its advance is a whole number of pixels at each
  thickness), so one mask per glyph and thickness, and one advance per
  glyph and thickness, give any string: the printable ASCII range
  32–126, at thickness 3 (the reference's black outline) and 1 (its
  colour). Each advance is the shift that makes ``c + "l"`` the union of
  ``c`` and a shifted ``"l"``; the tool refuses a glyph whose union is
  off by more than 2/255.
- **Anti-aliased lines** (``cv2.line(..., 1, LINE_AA)``): across the line,
  a profile of the distance along the minor axis (from horizontal lines
  at 1/32-pixel offsets); a gain by slope (lines of slope k/32 through 7
  offsets each, fitted to the profile); the ramp at each end (from
  horizontal lines starting at 1/16-pixel offsets).

It then holds the composite of the atlas against ``cv2.putText`` on a few
strings, on a flat and a random background, and prints the largest
difference.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "camkifu_tpu_torch", "core", "cv2_draw.npz")

FIRST, LAST = 32, 126
THICKNESSES = (3, 1)
#: Where a glyph is drawn on its scratch canvas; masks keep a window
#: around it.
OX, OY, CANVAS = 24, 32, (56, 160)
STEP_T, SPAN_T = 32, 48          # profile: t = k / 32, |k| <= 48
STEP_K = 32                      # slope gain: |k| = j / 32, j <= 32
STEP_E, E_LO, E_HI = 16, -16, 18  # end ramp: u = j / 16, -16 <= j <= 18


def _put(cv2, text, thickness, bg=None, color=255, org=(OX, OY)):
    img = np.zeros(CANVAS + (3,), np.uint8) if bg is None else bg.copy()
    cv2.putText(img, text, org, cv2.FONT_HERSHEY_SIMPLEX, 0.5,
                (color,) * 3, thickness, cv2.LINE_AA)
    return img


def _shifted(m, s):
    out = np.zeros_like(m)
    out[:, s:] = m[:, :m.shape[1] - s]
    return out


def glyphs(cv2):
    """→ (masks (2, 95, R, C) uint8, advance (2, 95) int, (row, col) of the
    drawing origin in the window)."""
    chars = [chr(c) for c in range(FIRST, LAST + 1)]
    full = np.zeros((len(THICKNESSES), len(chars)) + CANVAS, np.uint8)
    adv = np.zeros((len(THICKNESSES), len(chars)), np.int64)
    for t, th in enumerate(THICKNESSES):
        ell = _put(cv2, "l", th)[..., 0] / 255.0
        for i, c in enumerate(chars):
            only = _put(cv2, c, th)[..., 0]
            pair = _put(cv2, c + "l", th)[..., 0] / 255.0
            errs = [np.abs(pair - (1 - (1 - only / 255.0)
                                   * (1 - _shifted(ell, s)))).max()
                    for s in range(32)]
            s = int(np.argmin(errs))
            if errs[s] > 2 / 255:
                raise SystemExit(f"glyph {c!r} at thickness {th}: no whole-"
                                 f"pixel advance fits ({errs[s] * 255:.1f})")
            full[t, i], adv[t, i] = only, s
    rows = np.nonzero(full.any(axis=(0, 1, 3)))[0]
    cols = np.nonzero(full.any(axis=(0, 1, 2)))[0]
    r0, r1, c0, c1 = rows[0], rows[-1] + 1, cols[0], cols[-1] + 1
    if r0 == 0 or c0 == 0 or r1 == CANVAS[0] or c1 == CANVAS[1]:
        raise SystemExit("a glyph touches its scratch canvas's border")
    return full[:, :, r0:r1, c0:c1], adv, (OY - r0, OX - c0)


def _line(cv2, p0, p1, hw=(60, 140)):
    img = np.zeros(hw + (3,), np.uint8)
    fix = [tuple(int(round(v * 65536)) for v in p) for p in (p0, p1)]
    cv2.line(img, fix[0], fix[1], (255,) * 3, 1, cv2.LINE_AA, shift=16)
    return img[..., 0] / 255.0


def line_tables(cv2):
    """→ (profile over t = k/32, k in [-48, 48]; slope gain over |k| = j/32;
    end ramp over u = j/16, j in [-16, 18])."""
    grid = np.arange(-SPAN_T, SPAN_T + 1) / STEP_T
    acc = np.zeros(len(grid))
    cnt = np.zeros(len(grid))
    for d in range(STEP_T):
        y = 20 + d / STEP_T
        a = _line(cv2, (10, y), (120, y))
        for r in range(17, 25):
            k = int(round((r - y) * STEP_T)) + SPAN_T
            if 0 <= k < len(grid):
                acc[k] += a[r, 30:100].mean()
                cnt[k] += 1
    profile = acc / np.maximum(cnt, 1)

    def prof(t):
        return np.interp(t, grid, profile, left=0.0, right=0.0)

    gain = []
    for j in range(STEP_K + 1):
        k = j / STEP_K
        num = den = 0.0
        for off in np.arange(7) / 7:
            x0, y0, x1 = 10, 10 + off, 100
            a = _line(cv2, (x0, y0), (x1, y0 + k * (x1 - x0)), hw=(140, 140))
            for x in range(20, 90):
                yc = y0 + k * (x - x0)
                ys = np.arange(int(yc) - 2, int(yc) + 3)
                p = prof(ys - yc)
                num += float((p * a[ys, x]).sum())
                den += float((p * p).sum())
        gain.append(num / den)
    ramp = np.zeros(E_HI - E_LO + 1)
    for d in range(STEP_E):
        x0 = 20 + d / STEP_E
        a = _line(cv2, (x0, 20), (80, 20))
        mid = a[19:22, 50].sum()
        for x in range(17, 25):
            j = (x - x0) * STEP_E
            if abs(j - round(j)) < 1e-9 and E_LO <= round(j) <= E_HI:
                ramp[int(round(j)) - E_LO] = a[19:22, x].sum() / mid
    ramp[-2:] = 1.0
    return (profile.astype(np.float32), np.asarray(gain, np.float32),
            ramp.astype(np.float32))


def check(cv2, masks, adv, origin) -> int:
    """The atlas's composite against ``cv2.putText`` (outline, then
    colour) on flat and random backgrounds → the largest difference."""
    chars = [chr(c) for c in range(FIRST, LAST + 1)]
    texts = ["fps: 12.5", "track_trip: None", "corners: [[100.0, 50.0]]",
             "".join(chars[:48]), "".join(chars[48:])]
    rng = np.random.default_rng(0)
    worst = 0
    for text in texts:
        for bg in (np.full(CANVAS[:1] + (600, 3), 100, np.uint8),
                   rng.integers(0, 256, CANVAS[:1] + (600, 3), np.uint8)):
            ref = _put(cv2, text, 3, bg, 0, (10, OY))
            ref = _put(cv2, text, 1, ref, 255, (10, OY))
            out = bg.astype(np.float64)
            for t, color in ((0, 0.0), (1, 255.0)):
                keep = np.ones(bg.shape[:2])
                x = 10 - origin[1]
                for c in text:
                    i = ord(c) - FIRST
                    m = masks[t, i] / 255.0
                    y0 = OY - origin[0]
                    keep[y0:y0 + m.shape[0], x:x + m.shape[1]] *= 1 - m
                    x += int(adv[t, i])
                out = np.round(out + (color - out) * (1 - keep)[..., None])
            worst = max(worst, int(np.abs(out - ref).max()))
    return worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    import cv2

    masks, adv, origin = glyphs(cv2)
    profile, gain, ramp = line_tables(cv2)
    worst = check(cv2, masks, adv, origin)
    np.savez_compressed(
        args.out, masks=masks, advance=adv.astype(np.int16),
        origin=np.asarray(origin, np.int16),
        thickness=np.asarray(THICKNESSES, np.int16),
        line_profile=profile, line_gain=gain, line_ramp=ramp,
        cv2_version=np.asarray(cv2.__version__))
    print(f"{args.out}: {masks.shape[1]} glyphs × {len(THICKNESSES)} "
          f"thicknesses, window {masks.shape[2:]} (origin {origin}); "
          f"putText against the atlas: largest difference {worst} DN; "
          f"line gain {gain[0]:.4f}..{gain[-1]:.4f}; cv2 {cv2.__version__}")
    return 0 if worst <= 1 else 1


if __name__ == "__main__":
    sys.exit(main())
