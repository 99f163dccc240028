#!/usr/bin/env python3
"""Where the sensor noise kernel's time goes, on the card: the device time
of its launch (``pcg_normal_kernel`` in
``camkifu_tpu_torch/csrc/pcg_normal.cu``) and of the memset that zeroes its
tile counter and flags, from ``torch.profiler``, beside the whole call's
CUDA-event time and its bound, at 720p and 1080p, read noise and shot
noise.

    python3 tools/profile_noise.py [--reps 20]

Needs a CUDA device; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None) -> int:
    import torch

    import chip_smoke as cs
    from camkifu_tpu_torch.ops.cuda import pcg_normal_kernel as pk
    from camkifu_tpu_torch.utils import synth

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_noise: needs a CUDA device", file=sys.stderr)
        return 1
    print(cs._card_line(), flush=True)
    dev = torch.device("cuda", 0)
    for hw in cs.NOISE_HWS:
        frame, _ = synth.render_frame(cs._labels(), frame_hw=hw, noise=0,
                                      seed=2, device=dev)
        frame = frame.contiguous()
        state, inc = cs._noise_state(0, hw)
        words = cs.noise_words(state, inc, frame.numel())
        bound, by = cs.bound_pcg_normal(frame.numel(), words)
        for name, noise, shot in cs.NOISE_MODES:
            def call():
                return pk.pcg_normal_noise(frame, state, inc, noise, shot)

            ms = cs._cuda_ms(call, args.reps)
            parts = cs.launch_split(call, args.reps)
            print(f"{hw[0]}p {name}: {ms:.4f} ms a call (CUDA events), "
                  + ", ".join(f"{k} {v:.4f} ms" for k, v in parts.items())
                  + f" (profiler); bound {bound:.4f} ms by {by}, share "
                  f"{bound / ms:.3f}; {frame.numel()} normals, {words} "
                  f"words", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
