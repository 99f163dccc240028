"""The gauntlet scenario with and without its mp4 round trip, read by the
JAX reference's runtime and by the port's, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/gauntlet_reference.py [--port] [--codec]

Renders ``camkifu_tpu.utils.synth.gauntlet_scenario(19, seed=11)`` (cv2),
by default without ``encode_roundtrip`` (the frames go straight to the
reader), reads it with ``camkifu_tpu.filecheck.run_runtime(batch=16)`` (or,
with ``--port``, with ``camkifu_tpu_torch.filecheck.run_runtime(...,
device="cpu")``) and prints whether the kifu is exact and, where not, the
moves that differ (index, truth, read). ``--codec`` keeps the round trip.
``--trace`` (with ``--port``) prints each frame at which the port's move
extractor changed the kifu: the frame's index among those it read, and
the kifu's moves from the first that changed, or the correction applied
(the stones finder's bulk self-correction).
This is the reference reading that ``chip_smoke.py``'s codec-free gauntlet
is held to: the codec-free scenario is read by both packages with moves 9
and 11 swapped; with the round trip both read it exactly.
Needs jax and cv2: not on the card's machine.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _trace_extractor() -> None:
    """Wrap the port's ``MoveExtractor.advance`` and ``apply_correction``
    to print every frame at which the kifu changed."""
    from camkifu_tpu_torch.core.gamesync import MoveExtractor

    advance = MoveExtractor.advance
    seen = {"frame": 0}

    def traced(self, labels):
        before = [(m.color, m.row, m.col) for m in self.moves]
        out = advance(self, labels)
        after = [(m.color, m.row, m.col) for m in self.moves]
        if after != before:
            k = next((k for k, (a, b) in enumerate(zip(before, after))
                      if a != b), min(len(before), len(after)))
            print(f"extractor frame {seen['frame']}: moves from index {k}: "
                  f"{before[k:]} -> {after[k:]}", flush=True)
        seen["frame"] += 1
        return out

    MoveExtractor.advance = traced
    correct = MoveExtractor.apply_correction

    def traced_correction(self, err, exp):
        print(f"extractor frame {seen['frame'] - 1}: correction {err!r} -> "
              f"{exp!r}", flush=True)
        return correct(self, err, exp)

    MoveExtractor.apply_correction = traced_correction


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--port", action="store_true",
                    help="read with the port's runtime on the CPU")
    ap.add_argument("--codec", action="store_true",
                    help="keep the scenario's mp4 round trip")
    ap.add_argument("--trace", action="store_true",
                    help="with --port: print the frames at which the "
                         "move extractor changed the kifu")
    args = ap.parse_args(argv)
    if args.trace and not args.port:
        ap.error("--trace hooks the port's move extractor: add --port")

    import camkifu_tpu.utils.synth as jsynth

    if not args.codec:
        jsynth.encode_roundtrip = lambda frames, **_: list(frames)
    t0 = time.perf_counter()
    moves, factory = jsynth.gauntlet_scenario(19, seed=11)
    frames = list(factory())
    print(f"rendered {len(frames)} frames in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if args.trace:
        _trace_extractor()
    if args.port:
        from camkifu_tpu_torch import filecheck
        detected, stats = filecheck.run_runtime(frames, batch=16,
                                                device="cpu")
    else:
        from camkifu_tpu import filecheck
        detected, stats = filecheck.run_runtime(frames, batch=16)
    want = [(m.color, m.row, m.col) for m in moves]
    got = [(m.color, m.row, m.col) for m in detected]
    print(f"{'port' if args.port else 'reference'}, "
          f"{'with' if args.codec else 'without'} the round trip: exact "
          f"{got == want}; differing (index, truth, read) "
          f"{[(k, w, g) for k, (w, g) in enumerate(zip(want, got)) if w != g]}"
          f"; {len(got)} read of {len(want)}; {stats}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
