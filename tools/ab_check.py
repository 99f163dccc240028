"""Two checkouts' render-and-read rates on the card, in one call.

    python3 tools/ab_check.py PARENT . . PARENT

Runs, for each tree in the order given and each in its own process, that
tree's ``chip_smoke.phase_check`` (the four ``synth:`` specs of
``filecheck.check``, frames/s on the host clock), ``phase_gauntlet`` (the
codec-free gauntlet's runtime; a failed gate is printed, not raised) and
``filecheck.run_runtime`` twice over the gauntlet's mp4 round trip. Every
line it adds starts with ``TREE <path>``. Unpack the parent with ``git
archive`` into a directory ``.gitignore`` lists; run parent, change,
change, parent, as host time drifts within a call.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time


def _one(root: str) -> None:
    os.chdir(root)
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from camkifu_tpu_torch import filecheck
    from camkifu_tpu_torch.ops.cuda import _build
    from camkifu_tpu_torch.utils import synth

    cs.phase_build(_build)
    dev = torch.device("cuda", 0)
    card = cs._card_line()
    tag = f"TREE {root}"
    print(tag, card, flush=True)
    t = time.perf_counter()
    cs.phase_check(dev, card)
    print(f"{tag} check phase {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    try:
        cs.phase_gauntlet(dev)
    except cs.SmokeFailure as exc:
        print(f"{tag} gauntlet gate: {exc}", flush=True)
    print(f"{tag} gauntlet phase {time.perf_counter() - t:.1f} s",
          flush=True)
    moves, factory = synth.gauntlet_scenario(19, seed=11, device=dev)
    frames = list(factory())
    for _ in range(2):
        detected, stats = filecheck.run_runtime(frames, batch=16, device=dev)
        print(f"{tag} gauntlet mp4 run_runtime {stats['fps']:.1f} frames/s, "
              f"{len(detected)} moves", flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) == 2 and argv[0] == "--one":
        _one(argv[1])
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    code = 0
    for root in argv:
        code |= subprocess.call([sys.executable, os.path.abspath(__file__),
                                 "--one", root])
    return code


if __name__ == "__main__":
    sys.exit(main())
