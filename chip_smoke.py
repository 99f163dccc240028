#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``camkifu_tpu_torch/csrc`` (nvcc,
sm_90a, one process per source), holds each kernel against its plain
PyTorch version at the shapes the paths give it, then drives three paths
once each, counting kernel launches per path:

- the still path: one board detection on a 1080p still
  (``board.bf_auto.detect_corners``) and stone classification of 128
  copies of it (``pipeline.read_board_batch``);
- the recorded-video path: a seeded 10-move game from a fixed camera at
  720p through ``filecheck.run_pipeline`` with automatic board detection
  (``detect_batch_stable``, then the ``sf_meta`` vote scan) to its moves;
- the full redetect: ``detect_batch`` on 64 drifting 1080p frames.

It checks corners, labels and moves against the renderer's ground truth
and against the plain CPU path, checks that every kernel launched on each
path, and prints the times it measured. Every phase prints one line; any
failure exits non-zero.

The last line of standard output is the result,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it lists the kernels as JSON. Without a CUDA device the
script exits with code 1 and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

#: Frames per classification batch on the main path (bench.py's c2).
BATCH = 128
FRAME_HW = (1080, 1920)
#: Corner tolerance against ground truth: tests/test_bf_auto.py's 11 px at
#: 720p, scaled to 1080p.
TOL_PX = 16.0
#: Corner agreement between the card and the plain CPU path.
TOL_CPU_PX = 0.5
WARP_ATOL = 1e-3           # [0, 1] scale; f32 source coords near x = 1920
EDGE_ATOL = 1e-4           # where both versions fire
EDGE_SUPPORT = 0.995       # intersection over union of the NMS supports
HOUGH_ATOL = 1e-2          # atomics sum in another order
#: Device spin before each kernel timing, ~50 ms at the H100's clock:
#: longer than the host takes to fill the launch queue.
SPIN_CYCLES = 100_000_000

#: The recorded game: moves, empty lead-in frames, frames per move (the
#: vote window + 2, as tests/test_sf_meta.py records), and the film batch.
FILM_HW = (720, 1280)
FILM_MOVES = 10
FILM_LEADIN = 6
FILM_BATCH = 32
#: tests/test_bf_auto.py's corner tolerance at 720p.
FILM_TOL_PX = 11.0
#: bench.py's c3 batch (128 frames through sf_meta.read_batch) and its
#: full-redetect batch (64 frames through detect_batch).
C3_BATCH = 128
REDETECT_BATCH = 64
REDETECT_RENDERS = 8
REDETECT_DRIFT = 3.0


class SmokeFailure(RuntimeError):
    pass


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _cuda_ms(fn, reps: int, spin: bool = True, warmup: int = 2) -> float:
    """Mean milliseconds per call between CUDA events, after a warm-up.

    With ``spin``, a device-side spin queued ahead of the start event lets
    the host enqueue the calls before the card reaches them, so a call
    shorter than its own launch overhead is timed by the device. Without
    it, the calls run as the host issues them, as on the main path."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if spin:
        torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _cuda_ms_runs(fn, reps: int, warmup: int = 2) -> list[float]:
    """Milliseconds of each of ``reps`` calls between CUDA events, sorted:
    host-bound paths vary from call to call, so end-to-end times report
    their median and range."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sorted(s.elapsed_time(e) for s, e in events)


def _median(xs: list[float]) -> float:
    n = len(xs)
    return (xs[(n - 1) // 2] + xs[n // 2]) / 2


def _labels() -> "np.ndarray":
    """bench.py's c2 board: 100 stones, seed 0."""
    import numpy as np

    labels = np.zeros((19, 19), np.int8)
    idx = np.random.default_rng(0).choice(361, 100, replace=False)
    labels.flat[idx[:50]] = 1
    labels.flat[idx[50:]] = 2
    return labels


def _kernel_modules() -> dict:
    from camkifu_tpu_torch.ops.cuda import edge_kernel, hough_kernel, \
        warp_kernel

    return {"warp": warp_kernel, "edge": edge_kernel, "hough": hough_kernel}


def _reset_counts() -> None:
    for m in _kernel_modules().values():
        m.launches = 0
        if hasattr(m, "sizes"):
            m.sizes.clear()


def _read_counts() -> dict:
    """{kernel: (launches, {batch size: launches})} since the reset."""
    return {k: (m.launches, dict(getattr(m, "sizes", {})))
            for k, m in _kernel_modules().items()}


def _require_launched(counts: dict, path: str) -> None:
    for name, (n, _) in counts.items():
        _require(n > 0, f"the {name} kernel did not run on the {path} path")


def phase_build(_build) -> None:
    t0 = time.perf_counter()
    path, compile_s, log = _build.build()
    _build.lib()
    print(f"build: {path.name} compiled in {compile_s:.2f} s "
          f"(ready in {time.perf_counter() - t0:.2f} s)", flush=True)
    for line in log.splitlines():
        if any(key in line for key in ("registers", "spill", "Compiling")):
            print(f"  ptxas: {line.strip()}", flush=True)


def _check_warp(frames, H, out_hw: tuple[int, int], label: str) -> float:
    """The warp kernel against its plain version on u8 ``frames``
    (B, H, W, C) through one homography, in [0, 1] scale. Returns the
    largest difference."""
    import torch

    from camkifu_tpu_torch.ops.cuda import warp_kernel

    H = H.contiguous()
    a = warp_kernel.warp_homography(frames, H, out_hw, 1.0 / 255.0)
    b = warp_kernel.warp_homography_ref(frames, H, out_hw, 1.0 / 255.0)
    torch.cuda.synchronize()
    err = float((a - b).abs().max())
    print(f"kernel warp{label}: {tuple(frames.shape)} → {out_hw}, "
          f"max|kernel - plain| = {err:.3g} (atol {WARP_ATOL})", flush=True)
    _require(err <= WARP_ATOL, f"warp kernel{label} disagrees")
    return err


def _check_edge(x, label: str) -> float:
    """The edge kernel against its plain version on maps ``x`` (N, H, W):
    equal where both fire, the same NMS support, a zero border band.
    Returns the largest difference."""
    import torch

    from camkifu_tpu_torch.ops.cuda import edge_kernel
    from camkifu_tpu_torch.ops.cuda.edge_kernel import BORDER

    a = edge_kernel.edge_magnitude(x)
    b = edge_kernel.edge_magnitude_ref(x)
    torch.cuda.synchronize()
    inner = (slice(None), slice(BORDER, -BORDER), slice(BORDER, -BORDER))
    sa, sb = a[inner] > 0, b[inner] > 0
    both = sa & sb
    iou = float(both.sum()) / max(float((sa | sb).sum()), 1.0)
    err = float((a[inner] - b[inner])[both].abs().max())
    band = a.clone()
    band[inner] = 0
    print(f"kernel edge{label}: max|kernel - plain| = {err:.3g} where both "
          f"fire (atol {EDGE_ATOL}), support IoU {iou:.5f}, band max "
          f"{float(band.abs().max())}", flush=True)
    _require(err <= EDGE_ATOL, f"edge kernel{label} disagrees")
    _require(iou >= EDGE_SUPPORT, f"edge kernel{label} NMS support disagrees")
    _require(float(band.abs().max()) == 0.0,
             f"edge kernel{label} band is not 0")
    return err


def _check_hough(pts, wts, rho_max: float, label: str) -> float:
    """The Hough kernel against its plain version on (..., K, 2) points,
    128 × 256 bins. Returns the largest difference."""
    import torch

    from camkifu_tpu_torch.ops.cuda import hough_kernel

    a = hough_kernel.hough_accumulate(pts, wts, rho_max, 128, 256)
    b = hough_kernel.hough_accumulate_ref(pts, wts, rho_max, 128, 256)
    torch.cuda.synchronize()
    err = float((a - b).abs().max())
    print(f"kernel hough{label}: max|kernel - plain| = {err:.3g} "
          f"(atol {HOUGH_ATOL}, max vote {float(b.max()):.4g})", flush=True)
    _require(err <= HOUGH_ATOL, f"hough kernel{label} disagrees")
    return err


def phase_kernels(frames, corners) -> dict:
    """Each kernel against its plain version at the main path's shapes."""
    import torch

    from camkifu_tpu_torch.board.bf_auto import (REFINE_RES, _rect_H,
                                                  resize_bilinear)
    from camkifu_tpu_torch.ops.color import rgb_to_gray_u8
    from camkifu_tpu_torch.ops.edges import edge_map
    from camkifu_tpu_torch.ops.hough import topk_edge_points
    from camkifu_tpu_torch.ops.warp import canonical_corners, homography_dlt

    errs = {}
    # Warp: the canonical warp of 8 frames, and the detector's gray rect.
    H = homography_dlt(canonical_corners(device=frames.device), corners)
    gray = rgb_to_gray_u8(frames[0])[None, :, :, None].contiguous()
    errs["warp"] = max(
        _check_warp(frames[:8], H, (304, 304), ""),
        _check_warp(gray, _rect_H(corners, 0.10, REFINE_RES),
                    (REFINE_RES,) * 2, " (detector rect)"))

    # Edge: the detector's 256² luma and chroma maps of frame 0.
    f0 = frames[0]
    small = resize_bilinear(rgb_to_gray_u8(f0).float() / 255.0, (256, 256))
    chroma = resize_bilinear((f0[..., 0].float() - f0[..., 2].float())
                             / 255.0, (256, 256))
    x = torch.stack([small, chroma]).contiguous()
    errs["edge"] = _check_edge(x, "")

    # Hough: K = 4096 edge points of the luma map, 128 × 256 bins.
    pts, wts = topk_edge_points(edge_map(small))
    rho_max = float(256 * 2 ** 0.5)
    errs["hough"] = _check_hough(pts, wts, rho_max, "")
    return {"errs": errs, "edge_in": x, "pts": pts, "wts": wts, "H": H,
            "rho_max": rho_max}


def phase_main_path(frames, corners_true, labels) -> dict:
    """detect_corners + read_board_batch once, counting kernel launches."""
    import numpy as np
    import torch

    from camkifu_tpu_torch import pipeline
    from camkifu_tpu_torch.board import bf_auto

    _reset_counts()
    corners, score = bf_auto.detect_corners(frames[0])
    out, conf = pipeline.read_board_batch(frames, corners)
    torch.cuda.synchronize()
    counts = _read_counts()

    corners_np = corners.cpu().numpy()
    err_px = float(np.abs(corners_np - corners_true).max())
    out_np, conf_np = out.cpu().numpy(), conf.cpu().numpy()
    right = int((out_np == labels[None]).all(axis=(1, 2)).sum())
    print(f"still path: score {float(score):.4f}, corner error {err_px:.3f} "
          f"px (tol {TOL_PX}), boards read exactly {right}/{out_np.shape[0]}, "
          f"launches {counts}", flush=True)
    _require(float(score) > 0.1, "detection score too low")
    _require(err_px < TOL_PX, "corners off the ground truth")
    _require(out_np.shape == (BATCH, 19, 19) and conf_np.shape == out_np.shape,
             "wrong output shapes")
    _require(bool(np.isfinite(conf_np).all()), "non-finite confidence")
    _require(right == BATCH, "a board was misread")
    _require_launched(counts, "still")

    # The same path on the CPU, through the plain versions.
    c_cpu, s_cpu = bf_auto.detect_corners(frames[0].cpu())
    l_cpu, _ = pipeline.read_board_batch(frames[:1].cpu(), c_cpu)
    d_cpu = float(np.abs(c_cpu.numpy() - corners_np).max())
    same = np.array_equal(l_cpu.numpy()[0], out_np[0])
    print(f"plain CPU path: corners within {d_cpu:.4f} px of the card's "
          f"(tol {TOL_CPU_PX}), score {float(s_cpu):.4f}, labels "
          f"{'equal' if same else 'DIFFER'}", flush=True)
    _require(d_cpu < TOL_CPU_PX, "card and CPU corners disagree")
    _require(same, "card and CPU labels disagree")
    return {"corners": corners, "launches": counts}


def phase_times(frames, corners, k: dict, card: str) -> dict:
    """CUDA-event times of c1, c2 and each kernel beside its plain version."""
    import torch

    from camkifu_tpu_torch import pipeline
    from camkifu_tpu_torch.board import bf_auto
    from camkifu_tpu_torch.ops.cuda import edge_kernel, hough_kernel, \
        warp_kernel

    def c1():
        cs, _ = bf_auto.detect_corners(frames[0])
        return pipeline.read_board_batch(frames[:1], cs)

    def c2():
        cs, _ = bf_auto.detect_corners(frames[0])
        return pipeline.read_board_batch(frames, cs)

    runs = {
        "c1": _cuda_ms_runs(c1, reps=20),
        "c2": _cuda_ms_runs(c2, reps=20),
        "detect": _cuda_ms_runs(lambda: bf_auto.detect_corners(frames[0]),
                                reps=20),
        "classify": _cuda_ms_runs(
            lambda: pipeline.read_board_batch(frames, corners), reps=20),
    }
    med = {k: _median(v) for k, v in runs.items()}
    print(f"times on {card}, median of 20 calls [min, max]: " + ", ".join(
        f"{k} {med[k]:.3f} ms [{v[0]:.3f}, {v[-1]:.3f}]"
        for k, v in runs.items())
        + f"; c2 {BATCH / med['c2'] * 1e3:.1f} frames/s ({BATCH} frames "
        f"per batch)", flush=True)
    c1_ms, c2_ms = med["c1"], med["c2"]

    scale = 1.0 / 255.0
    edge2 = k["edge_in"]                  # the still path's luma + chroma
    pairs = {
        "warp": (lambda: warp_kernel.warp_homography(frames, k["H"],
                                                     (304, 304), scale),
                 lambda: warp_kernel.warp_homography_ref(frames, k["H"],
                                                         (304, 304), scale)),
        "edge": (lambda: edge_kernel.edge_magnitude(edge2),
                 lambda: edge_kernel.edge_magnitude_ref(edge2)),
        "hough": (lambda: hough_kernel.hough_accumulate(
                      k["pts"], k["wts"], k["rho_max"], 128, 256),
                  lambda: hough_kernel.hough_accumulate_ref(
                      k["pts"], k["wts"], k["rho_max"], 128, 256)),
    }
    times = {}
    for name, (kern, plain) in pairs.items():
        reps = 5 if name == "warp" else 50
        # Plain, kernel, kernel, plain: the pairs share the card's state.
        p1 = _cuda_ms(plain, reps)
        k1 = _cuda_ms(kern, reps)
        k2 = _cuda_ms(kern, reps)
        p2 = _cuda_ms(plain, reps)
        paced = _cuda_ms(kern, reps, spin=False)
        times[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        print(f"time {name}: kernel {times[name][0]:.4f} ms, plain "
              f"{times[name][1]:.4f} ms on the device; kernel {paced:.4f} ms "
              f"as the host issues it ({card})", flush=True)
    return {"c1_ms": c1_ms, "c2_ms": c2_ms, "kernels": times}


def phase_film(dev) -> dict:
    """The recorded-video path once: a seeded game from a fixed 720p
    camera through ``filecheck.run_pipeline`` with automatic detection,
    then its first batch through the plain CPU path."""
    import numpy as np
    import torch

    from camkifu_tpu.config import cvconf
    from camkifu_tpu.core.gamesync import score_moves
    from camkifu_tpu_torch import filecheck
    from camkifu_tpu_torch.board import bf_auto
    from camkifu_tpu_torch.stone import sf_meta
    from camkifu_tpu_torch.utils.still import render_game, sample_moves

    t0 = time.perf_counter()
    moves = sample_moves(FILM_MOVES, seed=5)
    frames, truth = render_game(moves, cvconf.vote_window + 2,
                                frame_hw=FILM_HW, empty_leadin=FILM_LEADIN)
    t_render = time.perf_counter() - t0

    t0 = time.perf_counter()
    _reset_counts()
    ex, stats = filecheck.run_pipeline(iter(frames), corners=None,
                                       batch=FILM_BATCH, device=dev)
    torch.cuda.synchronize()
    counts = _read_counts()
    t_run = time.perf_counter() - t0
    report = score_moves(ex.moves, moves)
    corners = np.asarray(stats["corners"], np.float32)
    err_px = float(np.abs(corners - truth).max())
    print(f"film path: {len(frames)} frames {FILM_HW[0]}p in batches of "
          f"{FILM_BATCH}, {report['good']}/{report['ref_moves']} moves "
          f"right, agreement {report['agreement']}, corner error "
          f"{err_px:.3f} px (tol {FILM_TOL_PX}), launches {counts} "
          f"(render {t_render:.1f} s, first run {t_run:.1f} s)", flush=True)
    _require(report["agreement"] == 1.0, "the film game was misread")
    _require(err_px < FILM_TOL_PX, "film corners off the ground truth")
    _require_launched(counts, "film")
    _require(max(counts["edge"][1]) >= 16,
             "the edge kernel never ran at N >= 16 on the film path")
    _require(max(counts["hough"][1]) > 1,
             "the Hough kernel never ran with B > 1 on the film path")

    # The first batch through the plain CPU path: the same corners from
    # detection, then the same labels and stable board from the vote scan
    # (both read through the card's corners).
    t0 = time.perf_counter()
    fb = torch.from_numpy(frames[:FILM_BATCH])
    c_cpu = bf_auto.detect_batch_stable(fb)
    d_cpu = float(np.abs(c_cpu.numpy() - corners).max())
    c_dev = torch.from_numpy(corners)
    st_d, lab_d, _, _ = sf_meta.read_batch(
        sf_meta.init_state(device=dev), fb.to(dev), c_dev.to(dev))
    st_c, lab_c, _, _ = sf_meta.read_batch(sf_meta.init_state(), fb, c_dev)
    same_labels = torch.equal(lab_d.cpu(), lab_c)
    same_stable = torch.equal(st_d.stable.cpu(), st_c.stable)
    print(f"film, plain CPU path on the first batch: corners within "
          f"{d_cpu:.4f} px of the card's (tol {TOL_CPU_PX}), labels "
          f"{'equal' if same_labels else 'DIFFER'}, stable "
          f"{'equal' if same_stable else 'DIFFERS'} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    _require(d_cpu < TOL_CPU_PX, "film: card and CPU corners disagree")
    _require(same_labels and same_stable,
             "film: card and CPU vote scans disagree")
    return {"frames": frames, "corners": corners, "launches": counts}


def _drift_frames(dev):
    """``REDETECT_RENDERS`` 1080p stills whose corners drift ±3 px (as
    tests/test_detect_shared.py makes them), tiled to ``REDETECT_BATCH``
    frames on the card, and each frame's true corners."""
    import numpy as np
    import torch

    from camkifu_tpu_torch.utils.still import default_corners, render_still

    labels = np.zeros((19, 19), np.int8)
    idx = np.random.default_rng(1).choice(361, 40, replace=False)
    labels.flat[idx[::2]] = 1
    labels.flat[idx[1::2]] = 2
    base = default_corners(FRAME_HW)
    renders, truth = [], []
    for i in range(REDETECT_RENDERS):
        c = base + np.array([REDETECT_DRIFT * np.sin(i / 2.0),
                             REDETECT_DRIFT * np.cos(i / 3.0)], np.float32)
        f, gt = render_still(labels, frame_hw=FRAME_HW, seed=i, corners=c)
        renders.append(torch.from_numpy(f).to(dev))
        truth.append(gt)
    reps = REDETECT_BATCH // REDETECT_RENDERS
    return torch.stack(renders * reps), np.stack(truth * reps)


def phase_redetect(dev) -> dict:
    """``detect_batch`` once on 64 drifting 1080p frames."""
    import numpy as np
    import torch

    from camkifu_tpu_torch.board import bf_auto

    t0 = time.perf_counter()
    frames, truth = _drift_frames(dev)
    t_render = time.perf_counter() - t0
    _reset_counts()
    corners, scores = bf_auto.detect_batch(frames)
    torch.cuda.synchronize()
    counts = _read_counts()
    # The verdicts of the same stage 1 and chunked route: every chunk took
    # the shared canvas, whose corners detect_batch returned.
    grays, quads, scores1 = bf_auto._detect_prepare_batch(frames, 256)
    routed, oks = bf_auto._chunked_route(grays, quads, scores1, 19,
                                         bf_auto.SHARED_CHUNK)
    oks = oks.cpu().numpy()
    err_px = float(np.abs(corners.cpu().numpy() - truth).max())
    print(f"redetect path: {REDETECT_BATCH} x {FRAME_HW[0]}p, corner error "
          f"{err_px:.3f} px (tol {TOL_PX}), shared route in "
          f"{int(oks.sum())}/{oks.size} chunks, scores "
          f"[{float(scores.min()):.3f}, {float(scores.max()):.3f}], launches "
          f"{counts} (render {t_render:.1f} s)", flush=True)
    _require(err_px < TOL_PX, "redetect corners off the ground truth")
    _require(bool(oks.all()), "a redetect chunk left the shared route")
    _require(torch.equal(routed, corners),
             "detect_batch did not return the shared-route corners")
    _require_launched(counts, "redetect")
    _require(max(counts["edge"][1]) >= 2 * REDETECT_BATCH,
             "the edge kernel did not take the whole batch at once")
    _require(max(counts["hough"][1]) == REDETECT_BATCH,
             "the Hough kernel did not take the whole batch at once")
    return {"frames": frames, "launches": counts, "grays": grays,
            "quads": quads}


def phase_batch_kernels(redetect: dict, film: dict, dev) -> dict:
    """Each kernel against its plain version at the film and redetect
    paths' shapes: the warp kernel on a redetect chunk's shared gray
    rectification (8 × 1080p, C = 1 → 320²) and on a film batch's
    canonical warp (32 × 720p RGB → 304²), the edge kernel at N = 128 and
    the Hough kernel at B = 64."""
    import torch

    from camkifu_tpu_torch.board.bf_auto import (REFINE_RES, SHARED_CHUNK,
                                                  _rect_H, resize_bilinear)
    from camkifu_tpu_torch.ops.color import rgb_to_gray_u8
    from camkifu_tpu_torch.ops.edges import edge_map_batch
    from camkifu_tpu_torch.ops.hough import topk_edge_points
    from camkifu_tpu_torch.ops.warp import canonical_corners, homography_dlt

    grays = redetect["grays"][:SHARED_CHUNK]
    med = torch.quantile(redetect["quads"][:SHARED_CHUNK], 0.5, dim=0)
    film_frames = torch.from_numpy(film["frames"][:FILM_BATCH]).to(dev)
    film_H = homography_dlt(canonical_corners(device=dev),
                            torch.from_numpy(film["corners"]).to(dev))
    err_warp = max(
        _check_warp(grays[..., None], _rect_H(med, 0.10, REFINE_RES),
                    (REFINE_RES,) * 2, " (redetect chunk rect)"),
        _check_warp(film_frames, film_H, (304, 304), " (film batch)"))
    del film_frames

    f = redetect["frames"]
    small = resize_bilinear(rgb_to_gray_u8(f).float() / 255.0, (256, 256))
    chroma = resize_bilinear((f[..., 0].float() - f[..., 2].float())
                             / 255.0, (256, 256))
    x = torch.cat([small, chroma]).contiguous()
    err_edge = _check_edge(x, f" at N = {x.shape[0]}")

    pts, wts = topk_edge_points(edge_map_batch(small))
    rho_max = float(256 * 2 ** 0.5)
    err_hough = _check_hough(pts, wts, rho_max, f" at B = {pts.shape[0]}")
    return {"errs": {"warp": err_warp, "edge": err_edge,
                     "hough": err_hough}, "edge_in": x,
            "pts": pts, "wts": wts, "rho_max": rho_max}


def phase_film_times(film: dict, redetect: dict, kb: dict, dev,
                     card: str) -> dict:
    """CUDA-event times of c3, the full redetect and the film end to end,
    and of the edge and Hough kernels at their batched shapes beside their
    plain versions."""
    import torch

    from camkifu_tpu_torch import filecheck
    from camkifu_tpu_torch.board import bf_auto
    from camkifu_tpu_torch.ops.cuda import edge_kernel, hough_kernel
    from camkifu_tpu_torch.stone import sf_meta

    frames = film["frames"]
    idx = torch.arange(C3_BATCH) % frames.shape[0]
    c3_frames = torch.from_numpy(frames)[idx].to(dev)
    c3_corners = torch.from_numpy(film["corners"]).to(dev)
    state0 = sf_meta.init_state(device=dev)
    # Calls per time: the redetect takes ~2.4 s a call and the film ~0.6 s,
    # so they take fewer to keep the phase short.
    runs = {
        "c3": _cuda_ms_runs(lambda: sf_meta.read_batch(
            state0, c3_frames, c3_corners), reps=20),
        "redetect": _cuda_ms_runs(
            lambda: bf_auto.detect_batch(redetect["frames"]), reps=5,
            warmup=1),
        "film": _cuda_ms_runs(lambda: filecheck.run_pipeline(
            iter(frames), corners=None, batch=FILM_BATCH, device=dev),
            reps=10, warmup=1),
    }
    n = {"c3": C3_BATCH, "redetect": REDETECT_BATCH,
         "film": frames.shape[0]}
    med = {k: _median(v) for k, v in runs.items()}
    fps = {k: n[k] / med[k] * 1e3 for k in runs}
    print(f"times on {card}, median of N calls [min, max]: " + ", ".join(
        f"{k} {med[k]:.3f} ms [{v[0]:.3f}, {v[-1]:.3f}] over {len(v)} = "
        f"{fps[k]:.1f} frames/s ({n[k]} frames)" for k, v in runs.items()),
        flush=True)

    shapes = {"edge": tuple(kb["edge_in"].shape),
              "hough": tuple(kb["pts"].shape)}
    pairs = {
        "edge": (lambda: edge_kernel.edge_magnitude(kb["edge_in"]),
                 lambda: edge_kernel.edge_magnitude_ref(kb["edge_in"])),
        "hough": (lambda: hough_kernel.hough_accumulate(
                      kb["pts"], kb["wts"], kb["rho_max"], 128, 256),
                  lambda: hough_kernel.hough_accumulate_ref(
                      kb["pts"], kb["wts"], kb["rho_max"], 128, 256)),
    }
    times = {}
    for name, (kern, plain) in pairs.items():
        # Plain, kernel, kernel, plain: the pairs share the card's state.
        p1 = _cuda_ms(plain, 3)
        k1 = _cuda_ms(kern, 20)
        k2 = _cuda_ms(kern, 20)
        p2 = _cuda_ms(plain, 3)
        times[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        print(f"time {name} at {shapes[name]}: "
              f"kernel {times[name][0]:.4f} ms, plain {times[name][1]:.4f} ms "
              f"on the device ({card})", flush=True)
    return {"fps": fps, "ms": med, "kernels": times}


SOURCES = {
    "warp": ("camkifu_tpu_torch/csrc/warp.cu",
             "camkifu_tpu/ops/pallas/warp_kernel.py:122"),
    "edge": ("camkifu_tpu_torch/csrc/edge.cu",
             "camkifu_tpu/ops/pallas/edge_kernel.py:111 and :125"),
    "hough": ("camkifu_tpu_torch/csrc/hough.cu",
              "camkifu_tpu/ops/pallas/hough_kernel.py:67"),
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs a CUDA device", file=sys.stderr)
        return 1
    import numpy as np

    from camkifu_tpu_torch.ops.cuda import _build
    from camkifu_tpu_torch.utils.still import render_still

    card = _card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
          f"tf32 matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"tf32 cudnn {torch.backends.cudnn.allow_tf32}", flush=True)
    try:
        phase_build(_build)
        labels = _labels()
        frame, corners_true = render_still(labels, frame_hw=FRAME_HW, seed=0)
        dev = torch.device("cuda", 0)
        frames = torch.from_numpy(frame).to(dev)[None].expand(
            BATCH, *frame.shape).contiguous()
        torch.cuda.synchronize()
        print(f"input: {tuple(frames.shape)} uint8 on {dev}", flush=True)
        corners_dev = torch.from_numpy(corners_true).to(dev)
        k = phase_kernels(frames, corners_dev)
        run = phase_main_path(frames, corners_true, labels)
        t = phase_times(frames, run["corners"], k, card)
        del frames
        t0 = time.perf_counter()
        film = phase_film(dev)
        print(f"film phase {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        redetect = phase_redetect(dev)
        kb = phase_batch_kernels(redetect, film, dev)
        print(f"redetect phase {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        tf = phase_film_times(film, redetect, kb, dev, card)
        print(f"film and redetect times {time.perf_counter() - t0:.1f} s",
              flush=True)
    except SmokeFailure as exc:
        print(f"FAIL: {exc}", flush=True)
        return 1
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f}"
          f" MiB", flush=True)
    paths = {"still": run["launches"], "film": film["launches"],
             "redetect": redetect["launches"]}
    kernels = []
    for name, (source, replaces) in SOURCES.items():
        ms, plain_ms = t["kernels"][name]
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces,
                 "launches": sum(paths[p][name][0] for p in paths),
                 "launches_per_path": {p: paths[p][name][0] for p in paths},
                 "max_abs_err": max(k["errs"][name], kb["errs"][name]),
                 "ms": ms, "plain_ms": plain_ms}
        if name in tf["kernels"]:
            entry["batched_ms"], entry["batched_plain_ms"] = \
                tf["kernels"][name]
        kernels.append(entry)
    print(json.dumps({"c1_ms": t["c1_ms"],
                      "c2_fps": BATCH / t["c2_ms"] * 1e3,
                      "c3_fps": tf["fps"]["c3"],
                      "redetect_fps": tf["fps"]["redetect"],
                      "film_fps": tf["fps"]["film"]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
