#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``camkifu_tpu_torch/csrc`` (nvcc,
sm_90a), holds each kernel against its plain PyTorch version at the shapes
the main path gives it, then drives the main path once: one board
detection on a 1080p still (``board.bf_auto.detect_corners``) and stone
classification of a batch of 128 copies of it
(``pipeline.read_board_batch``). It checks the corners and every label grid
against the renderer's ground truth and against the plain CPU path, checks
that every kernel launched during that run, and prints the times it
measured. Every phase prints one line; any failure exits non-zero.

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


def phase_build(_build) -> None:
    t0 = time.perf_counter()
    path, compile_s, log = _build.build()
    _build.lib()
    print(f"build: {path.name} compiled in {compile_s:.2f} s "
          f"(ready in {time.perf_counter() - t0:.2f} s)", flush=True)
    for line in log.splitlines():
        if any(key in line for key in ("registers", "spill", "Compiling")):
            print(f"  ptxas: {line.strip()}", flush=True)


def phase_kernels(frames, corners) -> dict:
    """Each kernel against its plain version at the main path's shapes."""
    import torch

    from camkifu_tpu_torch.board.bf_auto import (REFINE_RES, _rect_H,
                                                  resize_bilinear)
    from camkifu_tpu_torch.ops.color import rgb_to_gray_u8
    from camkifu_tpu_torch.ops.cuda import edge_kernel, hough_kernel, \
        warp_kernel
    from camkifu_tpu_torch.ops.cuda.edge_kernel import BORDER
    from camkifu_tpu_torch.ops.edges import edge_map
    from camkifu_tpu_torch.ops.hough import topk_edge_points
    from camkifu_tpu_torch.ops.warp import canonical_corners, homography_dlt

    errs = {}
    # Warp: the canonical warp of 8 frames, and the detector's gray rect.
    H = homography_dlt(canonical_corners(device=frames.device), corners)
    a = warp_kernel.warp_homography(frames[:8], H, (304, 304), 1.0 / 255.0)
    b = warp_kernel.warp_homography_ref(frames[:8], H, (304, 304),
                                        1.0 / 255.0)
    torch.cuda.synchronize()
    err = float((a - b).abs().max())
    gray = rgb_to_gray_u8(frames[0])[None, :, :, None].contiguous()
    Hr = _rect_H(corners, 0.10, REFINE_RES).contiguous()
    a = warp_kernel.warp_homography(gray, Hr, (REFINE_RES,) * 2, 1.0 / 255.0)
    b = warp_kernel.warp_homography_ref(gray, Hr, (REFINE_RES,) * 2,
                                        1.0 / 255.0)
    torch.cuda.synchronize()
    errs["warp"] = max(err, float((a - b).abs().max()))
    print(f"kernel warp: max|kernel - plain| = {errs['warp']:.3g} "
          f"(atol {WARP_ATOL})", flush=True)
    _require(errs["warp"] <= WARP_ATOL, "warp kernel disagrees")

    # Edge: the detector's 256² luma and chroma maps of frame 0.
    f0 = frames[0]
    small = resize_bilinear(rgb_to_gray_u8(f0).float() / 255.0, (256, 256))
    chroma = resize_bilinear((f0[..., 0].float() - f0[..., 2].float())
                             / 255.0, (256, 256))
    x = torch.stack([small, chroma]).contiguous()
    a = edge_kernel.edge_magnitude(x)
    b = edge_kernel.edge_magnitude_ref(x)
    torch.cuda.synchronize()
    inner = (slice(None), slice(BORDER, -BORDER), slice(BORDER, -BORDER))
    sa, sb = a[inner] > 0, b[inner] > 0
    both = sa & sb
    iou = float(both.sum()) / max(float((sa | sb).sum()), 1.0)
    errs["edge"] = float((a[inner] - b[inner])[both].abs().max())
    band = a.clone()
    band[inner] = 0
    print(f"kernel edge: max|kernel - plain| = {errs['edge']:.3g} where both "
          f"fire (atol {EDGE_ATOL}), support IoU {iou:.5f}, band max "
          f"{float(band.abs().max())}", flush=True)
    _require(errs["edge"] <= EDGE_ATOL, "edge kernel disagrees")
    _require(iou >= EDGE_SUPPORT, "edge kernel NMS support disagrees")
    _require(float(band.abs().max()) == 0.0, "edge kernel band is not 0")

    # Hough: K = 4096 edge points of the luma map, 128 × 256 bins.
    pts, wts = topk_edge_points(edge_map(small))
    rho_max = float(256 * 2 ** 0.5)
    a = hough_kernel.hough_accumulate(pts, wts, rho_max, 128, 256)
    b = hough_kernel.hough_accumulate_ref(pts, wts, rho_max, 128, 256)
    torch.cuda.synchronize()
    errs["hough"] = float((a - b).abs().max())
    print(f"kernel hough: max|kernel - plain| = {errs['hough']:.3g} "
          f"(atol {HOUGH_ATOL}, max vote {float(b.max()):.4g})", flush=True)
    _require(errs["hough"] <= HOUGH_ATOL, "hough kernel disagrees")
    return {"errs": errs, "edge_in": x, "pts": pts, "wts": wts, "H": H,
            "rho_max": rho_max}


def phase_main_path(frames, corners_true, labels) -> dict:
    """detect_corners + read_board_batch once, counting kernel launches."""
    import numpy as np
    import torch

    from camkifu_tpu_torch import pipeline
    from camkifu_tpu_torch.board import bf_auto
    from camkifu_tpu_torch.ops.cuda import edge_kernel, hough_kernel, \
        warp_kernel

    modules = {"warp": warp_kernel, "edge": edge_kernel,
               "hough": hough_kernel}
    for m in modules.values():
        m.launches = 0
    corners, score = bf_auto.detect_corners(frames[0])
    out, conf = pipeline.read_board_batch(frames, corners)
    torch.cuda.synchronize()
    launches = {k: m.launches for k, m in modules.items()}

    corners_np = corners.cpu().numpy()
    err_px = float(np.abs(corners_np - corners_true).max())
    out_np, conf_np = out.cpu().numpy(), conf.cpu().numpy()
    right = int((out_np == labels[None]).all(axis=(1, 2)).sum())
    print(f"main path: score {float(score):.4f}, corner error {err_px:.3f} px "
          f"(tol {TOL_PX}), boards read exactly {right}/{out_np.shape[0]}, "
          f"launches {launches}", flush=True)
    _require(float(score) > 0.1, "detection score too low")
    _require(err_px < TOL_PX, "corners off the ground truth")
    _require(out_np.shape == (BATCH, 19, 19) and conf_np.shape == out_np.shape,
             "wrong output shapes")
    _require(bool(np.isfinite(conf_np).all()), "non-finite confidence")
    _require(right == BATCH, "a board was misread")
    for name, n in launches.items():
        _require(n > 0, f"the {name} kernel did not run on the main path")

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
    return {"corners": corners, "launches": launches}


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
    edge1 = k["edge_in"][:1].contiguous()
    pairs = {
        "warp": (lambda: warp_kernel.warp_homography(frames, k["H"],
                                                     (304, 304), scale),
                 lambda: warp_kernel.warp_homography_ref(frames, k["H"],
                                                         (304, 304), scale)),
        "edge": (lambda: edge_kernel.edge_magnitude(edge1),
                 lambda: edge_kernel.edge_magnitude_ref(edge1)),
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


SOURCES = {
    "warp": ("camkifu_tpu_torch/csrc/warp.cu",
             "camkifu_tpu/ops/pallas/warp_kernel.py:122"),
    "edge": ("camkifu_tpu_torch/csrc/edge.cu",
             "camkifu_tpu/ops/pallas/edge_kernel.py:111"),
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
    except SmokeFailure as exc:
        print(f"FAIL: {exc}", flush=True)
        return 1
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f}"
          f" MiB", flush=True)
    kernels = []
    for name, (source, replaces) in SOURCES.items():
        ms, plain_ms = t["kernels"][name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": run["launches"][name],
                        "max_abs_err": k["errs"][name], "ms": ms,
                        "plain_ms": plain_ms})
    print(json.dumps({"c1_ms": t["c1_ms"],
                      "c2_fps": BATCH / t["c2_ms"] * 1e3}), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
