"""The edge, hysteresis and sensor-noise kernels of several checkouts on
one card, in one call.

    python3 tools/ab_kernels.py PARENT . . PARENT

For each tree, in the order given and each in its own process: builds that
tree's kernels, then times that tree's wrappers on the same seeded inputs:
the edge kernel at N = 2, 8, 16 and 128 maps of 256² and N = 2 of 512²;
at the same shapes, on the edge kernel's magnitudes, the hysteresis tail
of ``ops.edges.edge_map_batch`` (from the magnitudes to the output) as the
tree runs it (``hysteresis_adaptive`` where the tree has it) and as a
strided ``torch.quantile``, two multiplies and the kernel with given
thresholds, and ``edge_map_batch`` whole; the noise kernel on 720p and
1080p frames with read and with shot noise. Each line gives the CUDA-event
device time a call after a spin, the bound and the share of it
(``chip_smoke.py``'s ``_cuda_ms``, ``bound_edge``, ``bound_hysteresis``,
``bound_pcg_normal``, ``quantile_route``, from this file's checkout, run on
the tree's modules), and each launch's device time and count a call from
``torch.profiler``; it starts with ``TREE <path>``. Unpack the parent with
``git archive`` into a directory ``.gitignore`` lists; run parent, change,
change, parent, as the card's clock drifts within a call. ``chip_smoke.py
--parent DIR`` runs it after its phases.
"""

from __future__ import annotations

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
EDGE_SHAPES = ((2, 256), (8, 256), (16, 256), (128, 256), (2, 512))
NOISE_HWS = ((720, 1280), (1080, 1920))
NOISE_MODES = (("read noise", 3.0, 0.0), ("shot noise", 3.0, 0.4))
REPS = 20


def _timing():
    """This checkout's ``chip_smoke.py``, for its timing helpers and
    bounds (the tree's own may predate them)."""
    spec = importlib.util.spec_from_file_location("chip_smoke_timing",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _one(root: str) -> None:
    os.chdir(root)
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    from camkifu_tpu_torch.ops import edges
    from camkifu_tpu_torch.ops.cuda import _build, edge_kernel
    from camkifu_tpu_torch.ops.cuda import hysteresis_kernel as hk
    from camkifu_tpu_torch.ops.cuda import pcg_normal_kernel as pk

    cs = _timing()
    cs.phase_build(_build)
    dev = torch.device("cuda", 0)
    tag = f"TREE {root}"
    print(tag, cs._card_line(), flush=True)

    def report(what, call, bound):
        ms = cs._cuda_ms(call, REPS)
        counts = {}
        split = cs.launch_split(call, counts=counts)
        total = sum(counts.values())
        print(f"{tag} {what}: {ms:.4f} ms, bound {bound[0]:.4f} ms by "
              f"{bound[1]}, share {bound[0] / ms:.3f}; {total:g} launches "
              f"a call: "
              + ", ".join(f"{k} {v:.4f} ms x{counts[k]:g}"
                          for k, v in split.items()), flush=True)

    gen = torch.Generator().manual_seed(0)
    for n, side in EDGE_SHAPES:
        x = torch.rand((n, side, side), generator=gen)
        x[::3] = 0.8 * (torch.linspace(0, 1, side) > 0.3).float() \
            + 0.2 * x[::3]
        x = x.to(dev)
        report(f"edge N = {n}, {side}²",
               lambda x=x: edge_kernel.edge_magnitude(x), cs.bound_edge(x))
        mags = edge_kernel.edge_magnitude(x)
        bound = cs.bound_hysteresis(mags)
        if hasattr(hk, "hysteresis_adaptive"):
            report(f"hysteresis tail (adaptive) N = {n}, {side}²",
                   lambda m=mags: hk.hysteresis_adaptive(
                       m, cs.LOW_FRAC, cs.HIGH_FRAC, cs.HYSTERESIS_ITERS),
                   bound)
        report(f"hysteresis tail (quantile route) N = {n}, {side}²",
               lambda m=mags: cs.quantile_route(m), bound)
        report(f"edge_map_batch N = {n}, {side}²",
               lambda x=x: edges.edge_map_batch(x), cs.bound_edge(x))
    for hw in NOISE_HWS:
        frame = torch.from_numpy(np.random.default_rng(1).integers(
            0, 256, (*hw, 3)).astype(np.uint8)).to(dev)
        state, inc = cs._noise_state(0, hw)
        bound = cs.bound_pcg_normal(frame.numel(),
                                    cs.noise_words(state, inc, frame.numel()))
        for name, noise, shot in NOISE_MODES:
            report(f"pcg_normal {hw[0]}p {name}",
                   lambda f=frame, s=state, i=inc, nz=noise, sh=shot:
                       pk.pcg_normal_noise(f, s, i, nz, sh), bound)


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
