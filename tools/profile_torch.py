"""Where the port's time goes on a CUDA device (torch.profiler).

    python3 tools/profile_torch.py [--trace build/traces/torch.json]

Drives the same inputs as chip_smoke.py and profiles each stage on its
own: the still path's ``detect_corners`` on a 1080p still and
``read_board_batch`` of 128 copies of it; the recorded-video path's
``sf_meta.read_batch`` of 128 720p game frames (c3); and the full
redetect's ``detect_batch`` on 64 drifting 1080p frames, with its stage 1
(``_detect_prepare_batch``) and one chunk's shared refine apart; and the
handheld path (c4): ``sf_meta.track_read_batch`` of those frames twice
(128 × 1080p, 16 a chunk), with its tracker (``rectify_track_batch``),
its vote scan's share and the unfused pair (``track_corners_batch`` +
``read_batch``) apart; c5 (``parallel.mesh._read_all_streams``, 8
streams × 16 1080p frames) and ``multistream_track_read`` on the same
streams, beside one stream's 16 frames through ``track_read_batch``;
and the vision runtime (``runtime_batch``: ``VManagerSeq`` with
``BoardFinderAuto`` and ``SfMeta`` over chip_smoke.py's 720p handheld
game, batches of 16), one batch at a time: the first anchor (detection
and the lens calibration), steady tracked batches and a periodic
re-anchor. For each stage it prints the host wall time per
call, the device kernel time, the device's busy share of the wall window,
the number of kernels launched, the host's waits for the device (its
synchronizing runtime calls, less the profiler's opening synchronize and
the window's closing one; a blocking copy to or from the device is one),
and the top kernels by device time. Needs a CUDA device; exits 1 without
one.
"""


from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: CUDA runtime calls in which the host waits for the device, and how many
#: of them a profiled window makes itself: the profiler synchronizes when it
#: starts, the window when it ends (an empty stage reads 0 with these 2).
WAIT_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")
OWN_WAITS = 2


def ops_and_waits(fn) -> tuple[int, int]:
    """(device ops, host waits) of one call of ``fn``, profiled."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    ops = sum(e.device_type == torch.autograd.DeviceType.CUDA
              for e in events)
    return ops, sum(e.name in WAIT_CALLS for e in events) - OWN_WAITS


def _profile(name, fn, reps, trace=None, warmup=2):
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
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
    waits = sum(e.name in WAIT_CALLS for e in prof.events()) - OWN_WAITS
    d2h = sum("Memcpy DtoH" in e.name for e in kernels)
    print(f"{name}: {wall_us / reps / 1e3:.3f} ms/call host wall, "
          f"{total / reps / 1e3:.3f} ms/call device kernels, device busy "
          f"{busy / wall_us:.3f} of the window, {len(kernels) / reps:.0f} "
          f"device ops/call, {waits / reps:.1f} host waits/call "
          f"({d2h / reps:.1f} device-to-host copies)", flush=True)
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
    del grays, quads

    c4 = torch.cat([drift, drift])
    del drift
    seed, _ = bf_auto.detect_corners(c4[0])
    state = sf_meta.init_state(device=c4.device)
    chunk = chip_smoke.C4_CHUNK
    _profile("c4_track_read128",
             lambda: sf_meta.track_read_batch(state, c4, seed, chunk=chunk),
             3, args.trace)
    _profile("c4_rectify_track128",
             lambda: bf_auto.rectify_track_batch(c4, seed, chunk=chunk), 3,
             args.trace)
    _profile("c4_rectify_track_chunk16",
             lambda: bf_auto.rectify_track_batch(c4[:chunk], seed,
                                                 chunk=chunk), 3, args.trace)

    def unfused():
        cs, _, _, _ = bf_auto.track_corners_batch(
            c4, seed, chunk=chip_smoke.UNFUSED_CHUNK)
        return sf_meta.read_batch(state, c4, cs)

    _profile("c4_unfused128", unfused, 3, args.trace)
    del c4

    # c5 (bench.py:453-465) and the tracked engine on the same 8 streams of
    # 16 1080p frames: streams are a tensor dimension, so a call's ops
    # stay near one stream's (c4_track_read_chunk16 beside it).
    from camkifu_tpu_torch.parallel import mesh

    c5, c5_corners, _ = chip_smoke._c5_inputs(torch.device("cuda", 0))
    _profile("c5_read_all_streams",
             lambda: mesh._read_all_streams(c5, c5_corners), 5, args.trace)
    states = mesh.multistream_init_states(c5.shape[0])
    _profile("multistream_track8x16",
             lambda: mesh.multistream_track_read(states, c5, c5_corners), 3,
             args.trace)
    _profile("c4_track_read_chunk16",
             lambda: sf_meta.track_read_batch(state, c5[0], c5_corners[0],
                                              chunk=chunk), 3, args.trace)
    del c5

    # The runtime, a batch a call: each call reads the next 16 frames.
    from camkifu_tpu_torch.utils.still import handheld_corners

    n = 6 + chip_smoke.HANDHELD_MOVES * (cvconf.vote_window + 3)
    game, _ = render_game(
        sample_moves(chip_smoke.HANDHELD_MOVES, seed=5),
        cvconf.vote_window + 3, frame_hw=chip_smoke.HANDHELD_HW, seed=5,
        empty_leadin=6, corners=handheld_corners(n, chip_smoke.HANDHELD_HW),
        workers=chip_smoke.HANDHELD_RENDER_THREADS)
    _, vm, _ = chip_smoke._runtime_vm(list(game), torch.device("cuda", 0))

    def batch():
        vm.run(max_batches=1)

    _profile("runtime_batch_first_anchor", batch, 1, args.trace, warmup=0)
    _profile("runtime_batch_steady", batch, 3, args.trace, warmup=0)
    vm.board_finder._since_detect = cvconf.bf_period - 1
    _profile("runtime_batch_reanchor", batch, 1, args.trace, warmup=0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
