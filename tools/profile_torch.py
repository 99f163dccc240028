"""Where the port's time goes on a CUDA device (torch.profiler).

    python3 tools/profile_torch.py [--trace build/traces/torch.json]

Drives the same inputs as chip_smoke.py and profiles each stage on its
own: the still path's ``detect_corners`` on a 1080p still and
``read_board_batch`` of 128 copies of it; the recorded-video path's
``sf_meta.read_batch`` of 128 720p game frames (c3); and the full
redetect's ``detect_batch`` on 64 drifting 1080p frames, with its stage 1
(``_detect_prepare_batch``) and one chunk's shared refine apart. For each
stage it prints the host wall time per call, the device kernel time, the
device's busy share of the wall window, the number of kernels launched,
and the top kernels by device time. Needs a CUDA device; exits 1 without
one.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _profile(name, fn, reps, trace=None):
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, float("-inf")
    for s, e in spans:                      # union of device intervals
        if e > end:
            busy += e - max(s, end)
            end = e
    total = sum(e.time_range.elapsed_us() for e in kernels)
    print(f"{name}: {wall_us / reps / 1e3:.3f} ms/call host wall, "
          f"{total / reps / 1e3:.3f} ms/call device kernels, device busy "
          f"{busy / wall_us:.3f} of the window, {len(kernels) / reps:.0f} "
          f"device ops/call", flush=True)
    by_name = {}
    for e in kernels:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    for kname, (t, n) in top:
        print(f"  {t / reps / 1e3:8.4f} ms/call {n // reps:5d}x  {kname[:90]}",
              flush=True)
    if trace:
        os.makedirs(os.path.dirname(trace) or ".", exist_ok=True)
        prof.export_chrome_trace(trace.replace(".json", f"_{name}.json"))


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--trace", help="write chrome traces here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch: needs a CUDA device", file=sys.stderr)
        return 1

    import chip_smoke
    from camkifu_tpu_torch import pipeline
    from camkifu_tpu_torch.board import bf_auto
    from camkifu_tpu_torch.utils.still import render_still

    print(chip_smoke._card_line(), flush=True)
    frame, _ = render_still(chip_smoke._labels(),
                            frame_hw=chip_smoke.FRAME_HW)
    frames = torch.from_numpy(frame).cuda()[None].expand(
        chip_smoke.BATCH, *frame.shape).contiguous()
    corners, _ = bf_auto.detect_corners(frames[0])
    _profile("detect", lambda: bf_auto.detect_corners(frames[0]), 5,
             args.trace)
    _profile("classify128",
             lambda: pipeline.read_board_batch(frames, corners), 5,
             args.trace)
    del frames

    from camkifu_tpu_torch.config import cvconf
    from camkifu_tpu_torch.stone import sf_meta
    from camkifu_tpu_torch.utils.still import render_game, sample_moves

    game, game_corners = render_game(
        sample_moves(chip_smoke.FILM_MOVES, seed=5), cvconf.vote_window + 2,
        frame_hw=chip_smoke.FILM_HW, empty_leadin=chip_smoke.FILM_LEADIN)
    idx = torch.arange(chip_smoke.C3_BATCH) % game.shape[0]
    c3 = torch.from_numpy(game)[idx].cuda()
    c3_corners = torch.from_numpy(game_corners).cuda()
    state = sf_meta.init_state(device=c3.device)
    _profile("c3_read_batch128",
             lambda: sf_meta.read_batch(state, c3, c3_corners), 3, args.trace)
    del c3

    drift, _ = chip_smoke._drift_frames(torch.device("cuda", 0))
    _profile("redetect64", lambda: bf_auto.detect_batch(drift), 2, args.trace)
    _profile("redetect64_stage1",
             lambda: bf_auto._detect_prepare_batch(drift, 256), 3, args.trace)
    grays, quads, _ = bf_auto._detect_prepare_batch(drift, 256)
    chunk = bf_auto.SHARED_CHUNK
    med = torch.quantile(quads[:chunk], 0.5, dim=0)
    _profile("redetect_shared_refine_chunk8",
             lambda: bf_auto._refine_shared_batch(grays[:chunk], med,
                                                  quads[:chunk]),
             3, args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
