"""The work of one ``bf_auto.detect_batch`` call's kernels, from its
shapes (the bounds of ``chip_smoke.py``'s kernel table): per stream two
maps at the detection resolution, luma and chroma, each read once and
written once as float32 by the edge kernel (its two launches) and again
by the hysteresis kernel with a pair of thresholds a map; then one frame
of ``HOUGH_TOPK`` points for the Hough kernel, each point's (x, y) and
weight read once, every (point, θ) pair voted, the (θ, ρ) votes written
once. Every point is counted as carrying a weight: a 256² edge map of a
19×19 board holds more than 4,096 edge pixels."""

from __future__ import annotations

#: Published peaks of an H100 SXM at 700 W: HBM3 bytes per second and
#: float32 operations per second outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12

#: Detection's sizes at the program's defaults (``config/cvconf.py``).
RES = 256
HOUGH_TOPK = 4096
HOUGH_THETAS = 128
HOUGH_RHOS = 256

#: Floating operations a map pixel (blur, Sobel, magnitude, NMS), a
#: hysteresis pixel (two compares and the select) and a (point, θ) vote.
EDGE_OPS_PX = 55
HYSTERESIS_OPS_PX = 3
HOUGH_OPS_PAIR = 12


def _least_s(nbytes: float, ops: float) -> float:
    """The least seconds the card could take: bytes or operations."""
    return max(nbytes / PEAK_BYTES_S, ops / PEAK_FP32_S)


def edge_s(streams: int, res: int = RES) -> float:
    px = 2 * streams * res * res
    return _least_s(8 * px, EDGE_OPS_PX * px)


def hysteresis_s(streams: int, res: int = RES) -> float:
    px = 2 * streams * res * res
    return _least_s(8 * px + 8 * 2 * streams, HYSTERESIS_OPS_PX * px)


def hough_s(streams: int, k: int = HOUGH_TOPK, n_theta: int = HOUGH_THETAS,
            n_rho: int = HOUGH_RHOS) -> float:
    nbytes = 12 * streams * k + 4 * streams * n_theta * n_rho
    return _least_s(nbytes, HOUGH_OPS_PAIR * n_theta * streams * k)


def detect_s(streams: int) -> float:
    """The least time of one call's edge, hysteresis and Hough launches."""
    return edge_s(streams) + hysteresis_s(streams) + hough_s(streams)
