"""The comparison that decides ``correct``: the program's outputs of the
compared batches against the reference's outputs of the same batches.

Each check of a configuration (its ``checks`` list) names the outputs it
reads, a kind and a limit:

- ``mismatch``: the number of entries of one batch's output that differ
  (an exact comparison);
- ``max_abs``: the largest absolute difference;
- ``max_px``: the largest distance in pixels between two sets of points
  (..., 2).

A value that is not finite, or outputs that are missing or of another
shape, read as infinity, so they fail any limit.
"""

from __future__ import annotations

import math

import torch


def gap(kind: str, got: torch.Tensor, want: torch.Tensor) -> float:
    if got is None or want is None or got.shape != want.shape:
        return math.inf
    if kind == "mismatch":
        return float((got != want).sum())
    got = got.to(torch.float64)
    want = want.to(torch.float64)
    if kind == "max_abs":
        d = torch.abs(got - want)
    elif kind == "max_px":
        d = torch.linalg.vector_norm(got - want, dim=-1)
    else:
        raise ValueError(f"unknown check kind {kind!r}")
    if d.numel() == 0:
        return 0.0
    if not bool(torch.isfinite(d).all()):
        return math.inf
    return float(d.max())


def pairs(ref_mod, cfg: dict, inputs: dict, anchor, warm: list,
          kept: list) -> list:
    """(the program's outputs, the reference's) of every compared batch.
    The start: the warm batches (pool batches 0, 1, …), the reference
    from fresh states at the program's first corners ``anchor``. Then each
    kept batch (pool batch, the program's state before it, its outputs),
    the reference from that state: it cannot follow the whole window in
    less time than the window."""
    import torch

    out = []
    n_pool = inputs["pool"].shape[0]
    with torch.no_grad():
        st = ref_mod.start(cfg, inputs, anchor)
        for k, got in enumerate(warm):
            st, want = ref_mod.step(cfg, inputs, k % n_pool, st)
            out.append((got, want))
        for k, before, got in kept:
            out.append((got, ref_mod.step(cfg, inputs, k, before)[1]))
    return out


def numbers(checks: list, pairs: list) -> dict:
    """{check name: its worst value over every compared batch}: ``pairs``
    is a list of (the program's outputs, the reference's) of one batch,
    each a dict of tensors."""
    out = {}
    for c in checks:
        worst = 0.0 if pairs else math.inf
        for got, want in pairs:
            for name in c["outputs"]:
                v = gap(c["kind"], got.get(name), want.get(name))
                worst = v if v > worst or math.isnan(v) else worst
        out[c["name"]] = worst
    return out


def verdict(checks: list, values: dict) -> tuple[bool, dict]:
    """(every value within its limit, {name: {"value", "limit"}})."""
    ok = all(math.isfinite(values[c["name"]])
             and values[c["name"]] <= c["limit"] for c in checks)
    table = {c["name"]: {"value": _number(values[c["name"]]),
                         "limit": c["limit"]} for c in checks}
    return ok, table


def _number(v: float):
    """A value as JSON holds it: a number, or "inf" / "nan"."""
    return v if math.isfinite(v) else str(v)
