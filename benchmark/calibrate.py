"""The readings that the limits of ``correct`` are set from, for one cell.

    python3 benchmark/calibrate.py --workload fixed19.streams \
        --seeds 11,12,13 --control-seeds 11,12,13 [--batches 42]

For each seed, in one process on the card: draw the cell's pool, run the
system under test over ``--batches`` batches as a run does (the driver's
program, the pool's batches in order, its states carried), and compare
every batch with the plain reference as a run compares its start and its
kept batches (``checks.pairs``): the lower readings, sound runs of the
program. For each control seed, the control takes the program's place:
the reference with the canonical images, the tracker's canvases and the
scan's arithmetic in bfloat16, the precision below the configuration's
float32, carrying its own states; its numbers against the float32
reference are the upper readings. One JSON line a reading; the
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _numbers(cell, ref_mod, inputs, anchor, outs):
    from benchmark import checks

    w = cell.mix["warmup_batches"]
    warm = [o for _, _, o in outs[:w]]
    pairs = checks.pairs(ref_mod, cell.config, inputs, anchor, warm,
                         outs[w:])
    return checks.numbers(cell.config["checks"], pairs)


def readings(cell, seed: int, batches: int, control: bool, device) -> list:
    import torch

    from benchmark import spec
    from benchmark.traffic import generator

    cfg, mix = cell.config, cell.mix
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = time.perf_counter()
    ref_mod = spec.reference(cfg)
    inputs = generator.make_inputs(cfg, mix, seed, device)
    program = spec.driver(cfg).Program(cfg, mix, inputs, device)
    anchor = program.anchor
    n_pool = mix["pool_batches"]
    outs = []
    for j in range(batches):
        before = program.state()
        outs.append((j % n_pool, before, program.step(j % n_pool)))
    del program
    out = [{"workload": cell.name, "seed": seed, "side": "program",
            "numbers": _numbers(cell, ref_mod, inputs, anchor, outs),
            "seconds": time.perf_counter() - t}]
    del outs
    if control:
        low, st = [], ref_mod.start(cfg, inputs, anchor)
        with torch.no_grad():
            for j in range(batches):
                before = st
                st, o = ref_mod.step(cfg, inputs, j % n_pool, st,
                                     lowered=True)
                low.append((j % n_pool, before, o))
        out.append({"workload": cell.name, "seed": seed, "side": "control",
                    "numbers": _numbers(cell, ref_mod, inputs, anchor, low)})
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--batches", type=int, default=42)
    args = parser.parse_args(argv)

    import torch

    from benchmark import spec

    if not torch.cuda.is_available():
        print("calibrate needs a CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        for line in readings(cell, seed, args.batches, seed in controls,
                             torch.device("cuda")):
            print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
