"""A camera held in the hand: the still renderer's ``handheld_corners``,
each stream at its own phase (place ``place`` of an even grid over
``phase_frames``). Each sway's period is set to the nearest that makes a
whole number of cycles in the pool, so the motion runs on without a jump
where the pool wraps."""

from __future__ import annotations

import math

import numpy as np

from benchmark.traffic.generator import handheld_corners


def periods(cam: dict, n_frames: int) -> list[float]:
    """The sways' periods (``handheld_corners``' units: frames a radian),
    each moved to a whole number of cycles over ``n_frames``."""
    out = []
    for p in cam["periods"]:
        cycles = max(1, round(n_frames / (2.0 * math.pi * p)))
        out.append(n_frames / (2.0 * math.pi * cycles))
    return out


def pinhole(cam: dict, frame_hw, n_frames: int, place: int,
            n_streams: int) -> np.ndarray:
    phase = (place + 0.5) * cam["phase_frames"] / n_streams
    return handheld_corners(n_frames, frame_hw, cam["drift_px"],
                            periods(cam, n_frames), phase,
                            cam["perspective"])
