"""Which of the render's device and the codec's build decides the gauntlet.

    python3 tools/gauntlet_codec.py [--render cuda --render cpu]
                                    [--mp4 PATH ...] [--keep PATH]
                                    [--read-on cuda]

Renders ``synth.gauntlet_scenario``'s game (19 × 19, seed 11, 720p) on each
``--render`` device, then reads with ``filecheck.run_runtime(batch=16)`` on
``--read-on``: each render without a codec, and each through this machine's
cv2 mp4 round trip (``synth.encode_roundtrip``; ``--keep`` saves the first
render's mp4). Each ``--mp4`` (the gauntlet encoded elsewhere, by another
cv2 build) is decoded here and read too. Prints the renders' difference
and, for each reading, whether the kifu is exact and where it first
differs.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _read(name, frames, moves, device) -> bool:
    from camkifu_tpu_torch import filecheck

    detected, _ = filecheck.run_runtime(frames, batch=16, device=device)
    got = [(m.color, m.row, m.col) for m in detected]
    truth = [(m.color, m.row, m.col) for m in moves]
    first = next((k for k, (a, b) in enumerate(zip(got, truth)) if a != b),
                 None)
    print(f"{name}: {'EXACT' if got == truth else 'not exact'} ({len(got)} "
          f"moves; first differing index {first}"
          f"{'' if first is None else f': {got[first:first + 3]}'})",
          flush=True)
    return got == truth


def _decode(path: str) -> list[np.ndarray]:
    import cv2

    cap = cv2.VideoCapture(path)
    out = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        out.append(frame[:, :, ::-1].copy())
    cap.release()
    return out


def main(argv=None) -> int:
    import cv2

    from camkifu_tpu_torch.utils import synth

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--render", action="append", default=None,
                    help="device to render on (repeatable; default cuda "
                         "and cpu)")
    ap.add_argument("--mp4", action="append", default=[],
                    help="an mp4 of the gauntlet made elsewhere")
    ap.add_argument("--keep", default=None,
                    help="save the first render's mp4 round trip here")
    ap.add_argument("--read-on", default="cuda")
    args = ap.parse_args(argv)
    renders = args.render or ["cuda", "cpu"]
    print(f"cv2 {cv2.__version__}, torch {torch.__version__}", flush=True)
    frames = {}
    for dev in renders:
        moves, render = synth._gauntlet(19, 11, (720, 1280), 19, dev)
        t0 = time.perf_counter()
        frames[dev] = [f.cpu().numpy() for f in render()]
        print(f"render on {dev}: {len(frames[dev])} frames in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    if len(renders) > 1:
        a, b = (frames[d] for d in renders[:2])
        d = [np.abs(x.astype(np.int16) - y) for x, y in zip(a, b)]
        print(f"{renders[0]} against {renders[1]} render: mean "
              f"{np.mean([x.mean() for x in d]):.4f} DN, max "
              f"{max(int(x.max()) for x in d)} DN", flush=True)
    for i, dev in enumerate(renders):
        _read(f"{dev} render, no codec", frames[dev], moves, args.read_on)
        keep = args.keep if i == 0 else None
        _read(f"{dev} render, cv2 {cv2.__version__} round trip",
              synth.encode_roundtrip(iter(frames[dev]), path=keep), moves,
              args.read_on)
    for path in args.mp4:
        decoded = _decode(path)
        print(f"{path}: {len(decoded)} frames decoded by cv2 "
              f"{cv2.__version__}", flush=True)
        _read(f"{path}, decoded here", decoded, moves, args.read_on)
    return 0


if __name__ == "__main__":
    sys.exit(main())
