"""The reference of ``drivers/streams_handheld.py``, by ``tracker.py`` and
``scan.py`` alone: a batch of every stream from a state (``start``:
fresh, seeded at the program's first corners; or the program's own state
before that batch)."""

from __future__ import annotations

from benchmark.reference import scan, tracker


def start(cfg: dict, inputs: dict, anchor) -> dict:
    """Fresh states of every stream, seeded at ``anchor`` (n, 4, 2)."""
    n = inputs["pool"].shape[1]
    return {**scan.init_states(n, cfg["gsize"], cfg["zone"], anchor.device),
            "seeds": anchor}


def step(cfg: dict, inputs: dict, k: int, state: dict,
         lowered: bool = False) -> tuple[dict, dict]:
    """Pool batch ``k`` from ``state`` → (the next state, the outputs).
    ``lowered``: the control, the tracker's canvases, the canonical images
    and the scan's arithmetic in bfloat16."""
    g, zone = cfg["gsize"], cfg["zone"]
    frames = inputs["pool"][k]
    k1 = inputs["k1"] if "k1_range" in cfg["camera"] else None
    canon, corners, sharp, align, seeds = tracker.rectify_track(
        frames, state["seeds"], k1, g, zone,
        tuple(cfg["frame_hw"]), lowered=lowered)
    states, labels, conf, agitation = scan.scan(state, canon, g, zone,
                                                lowered=lowered)
    del canon
    return {**states, "seeds": seeds}, \
        {"labels": labels, "conf": conf, "agitation": agitation,
         "corners": corners, "sharpness": sharp, "align": align,
         "seeds": seeds, **{f"state_{f}": v for f, v in states.items()}}
