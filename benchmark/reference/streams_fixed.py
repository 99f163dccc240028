"""The reference of ``drivers/streams_fixed.py``, by ``scan.py`` alone: a
batch of every stream from a state (``start``: fresh, at the program's
corners; or the program's own state before that batch)."""

from __future__ import annotations

from benchmark.reference import scan


def start(cfg: dict, inputs: dict, anchor) -> dict:
    """Fresh states of every stream, its board at ``anchor`` (n, 4, 2)."""
    n = inputs["pool"].shape[1]
    return {**scan.init_states(n, cfg["gsize"], cfg["zone"], anchor.device),
            "corners": anchor}


def step(cfg: dict, inputs: dict, k: int, state: dict,
         lowered: bool = False) -> tuple[dict, dict]:
    """Pool batch ``k`` from ``state`` → (the next state, the outputs as
    the driver names them). ``lowered``: the control, the canonical images
    and the scan's arithmetic in bfloat16 (``scan.scan``)."""
    g, zone = cfg["gsize"], cfg["zone"]
    frames = inputs["pool"][k]
    n, b = frames.shape[0], frames.shape[1]
    canon = scan.rectify_fixed(frames, state["corners"], g, zone)
    states, labels, conf, agitation = scan.scan(
        state, canon.reshape(n, b, *canon.shape[1:]), g, zone,
        lowered=lowered)
    del canon
    return {**states, "corners": state["corners"]}, \
        {"labels": labels, "conf": conf, "agitation": agitation,
         **{f"state_{f}": v for f, v in states.items()}}
