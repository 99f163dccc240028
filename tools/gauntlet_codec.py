"""Which of the renderer, the render's device, the codec's build and the
reading runtime decides the gauntlet.

    python3 tools/gauntlet_codec.py [--render cuda --render cpu]
                                    [--render reference] [--mp4 PATH ...]
                                    [--keep PATH] [--read-on cuda]
                                    [--read-on cpu] [--read-on reference]
                                    [--no-roundtrip] [--pinhole]

Renders ``synth.gauntlet_scenario``'s game (19 × 19, seed 11, 720p) on each
``--render`` device (``reference``: the JAX package's renderer, on the
CPU), then reads with ``filecheck.run_runtime(batch=16)``'s stack on each
``--read-on`` device (``reference``: the JAX package's runtime): each
render without a codec, and, unless ``--no-roundtrip``, each through this
machine's cv2 mp4 round trip (``synth.encode_roundtrip``; ``--keep``
saves the first render's mp4). Each ``--mp4`` (the gauntlet encoded
elsewhere, by another cv2 build) is decoded here and read too. Prints the
renders' difference and, for each reading, whether the kifu is exact,
where it first differs, the kifu where it is not and, for the port's
runtime, the first anchor's lens estimate. ``--pinhole`` skips the
port's first-anchor lens check (the scene's true lens) on every reading.
``reference`` needs jax, which the card's machine does not have.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _render(dev: str):
    """(moves, the codec-free frames as uint8 numpy arrays)."""
    if dev == "reference":
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        import camkifu_tpu.utils.synth as jsynth

        roundtrip = jsynth.encode_roundtrip
        jsynth.encode_roundtrip = lambda frames, **_: list(frames)
        try:
            moves, factory = jsynth.gauntlet_scenario(19, seed=11)
            return moves, list(factory())
        finally:
            jsynth.encode_roundtrip = roundtrip
    from camkifu_tpu_torch.utils import synth

    moves, render = synth._gauntlet(19, 11, (720, 1280), 19, dev)
    return moves, [f.cpu().numpy() for f in render()]


def _runtime(frames, device, pinhole: bool):
    """(moves read, the first anchor's lens estimate or None)."""
    if device == "reference":
        if pinhole:
            raise SystemExit("--pinhole applies to the port's runtime")
        from camkifu_tpu import filecheck as jfilecheck

        return jfilecheck.run_runtime(frames, batch=16)[0], None
    from camkifu_tpu_torch.board.bf_auto import BoardFinderAuto
    from camkifu_tpu_torch.core.capture import ArrayCapture
    from camkifu_tpu_torch.core.controllerv import ControllerVSeq
    from camkifu_tpu_torch.core.vmanager import VManagerSeq
    from camkifu_tpu_torch.stone.sf_meta import SfMeta

    controller = ControllerVSeq(gsize=19)
    vm = VManagerSeq(controller, video=None, bf_class=BoardFinderAuto,
                     sf_class=SfMeta, batch=16, device=device)
    vm.capture = ArrayCapture(frames)
    vm.instantiate_finders()
    vm.board_finder._lens_checked = pinhole
    vm.run()
    return controller.kifu.moves(), vm.board_finder.metadata.get("lens_k1")


def _read(name, frames, moves, device, pinhole: bool) -> bool:
    t0 = time.perf_counter()
    detected, k1 = _runtime(frames, device, pinhole)
    got = [(m.color, m.row, m.col) for m in detected]
    truth = [(m.color, m.row, m.col) for m in moves]
    first = next((k for k, (a, b) in enumerate(zip(got, truth)) if a != b),
                 None)
    print(f"{name}, read by {device}"
          f"{' with the lens check skipped' if pinhole else ''} "
          f"({time.perf_counter() - t0:.1f} s): "
          f"{'EXACT' if got == truth else 'not exact'} ({len(got)} moves; "
          f"first differing index {first}"
          f"{'' if k1 is None else f'; first anchor lens k1 {k1}'})"
          f"{'' if got == truth else f'; read {got}'}", flush=True)
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
                    help="device to render on, or 'reference' (repeatable; "
                         "default cuda and cpu)")
    ap.add_argument("--mp4", action="append", default=[],
                    help="an mp4 of the gauntlet made elsewhere")
    ap.add_argument("--keep", default=None,
                    help="save the first render's mp4 round trip here")
    ap.add_argument("--read-on", action="append", default=None,
                    help="device to read on, or 'reference' (repeatable; "
                         "default cuda)")
    ap.add_argument("--no-roundtrip", action="store_true",
                    help="read the renders without their mp4 round trip "
                         "only")
    ap.add_argument("--pinhole", action="store_true",
                    help="skip the port's first-anchor lens check")
    args = ap.parse_args(argv)
    renders = args.render or ["cuda", "cpu"]
    readers = args.read_on or ["cuda"]
    print(f"cv2 {cv2.__version__}, torch {torch.__version__}", flush=True)
    frames = {}
    for dev in renders:
        t0 = time.perf_counter()
        moves, frames[dev] = _render(dev)
        print(f"render on {dev}: {len(frames[dev])} frames in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    if len(renders) > 1:
        a, b = (frames[d] for d in renders[:2])
        d = [np.abs(x.astype(np.int16) - y) for x, y in zip(a, b)]
        print(f"{renders[0]} against {renders[1]} render: mean "
              f"{np.mean([x.mean() for x in d]):.4f} DN, max "
              f"{max(int(x.max()) for x in d)} DN", flush=True)
    for i, dev in enumerate(renders):
        runs = [(f"{dev} render, no codec", frames[dev])]
        if not args.no_roundtrip:
            keep = args.keep if i == 0 else None
            runs.append((f"{dev} render, cv2 {cv2.__version__} round trip",
                         synth.encode_roundtrip(iter(frames[dev]),
                                                path=keep)))
        for name, fr in runs:
            for reader in readers:
                _read(name, fr, moves, reader, args.pinhole)
    for path in args.mp4:
        decoded = _decode(path)
        print(f"{path}: {len(decoded)} frames decoded by cv2 "
              f"{cv2.__version__}", flush=True)
        for reader in readers:
            _read(f"{path}, decoded here", decoded, moves, reader,
                  args.pinhole)
    return 0


if __name__ == "__main__":
    sys.exit(main())
