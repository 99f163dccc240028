"""The reference of ``drivers/streams_reanchor.py``, by ``detect.py``,
``tracker.py`` and ``scan.py`` alone: a batch of every stream from a
state (``start``: fresh, seeded at the program's first corners; or the
program's own state before that batch). A pool batch whose index is a
multiple of the configuration's ``reanchor.period_batches`` first
detects every stream's board again on its first frame
(``detect.detect_batch``) and keeps a stream's carried seed where the
detection is not accepted (finite corners, a score of at least
``detect.MIN_SCORE``, as the program's ``bf_auto.accept_detections``);
every batch then runs the handheld reference (``streams_handheld.step``)
from those seeds. A batch that does not re-detect gives empty
``detected`` (0, 4, 2) and ``scores`` (0,), as the driver does."""

from __future__ import annotations

import torch

from benchmark.reference import detect, streams_handheld


def start(cfg: dict, inputs: dict, anchor) -> dict:
    """Fresh states of every stream, seeded at ``anchor`` (n, 4, 2)."""
    return streams_handheld.start(cfg, inputs, anchor)


def step(cfg: dict, inputs: dict, k: int, state: dict,
         lowered: bool = False) -> tuple[dict, dict]:
    """Pool batch ``k`` from ``state`` → (the next state, the outputs).
    ``lowered``: the control, detection's maps and canvases, the tracker's
    canvases, the canonical images and the scan's arithmetic in
    bfloat16."""
    seeds = state["seeds"]
    if k % cfg["reanchor"]["period_batches"]:
        detected = seeds.new_empty((0, 4, 2))
        scores = seeds.new_empty((0,))
    else:
        first = inputs["pool"][k][:, 0]
        detected, scores = detect.detect_batch(first, cfg["gsize"], lowered)
        seeds = detect.redetect_seeds(detected, scores, seeds)
    states, out = streams_handheld.step(cfg, inputs, k,
                                        {**state, "seeds": seeds}, lowered)
    return states, {**out, "detected": detected, "scores": scores}
