"""One tiny run of the re-detecting cell on the CPU, re-detecting at its
period, and the same run with its re-detection broken underneath:
``correct`` has to come out false where the program skips the
re-detection (its detection outputs missing, every stream tracked from
its carried seed) and where one detected corner is altered where it is
produced."""

from __future__ import annotations

import time

import pytest

from benchmark import run, spec
from camkifu_tpu_torch.parallel import mesh

SECONDS = 12.0
WORKLOAD = "handheld19.reanchor"


def _run(tiny_root, wrap=None, seed=2 ** 33 + 7):
    cell = spec.load_cell(WORKLOAD, root=tiny_root, base=tiny_root)
    return run.run_cell(cell, seed, SECONDS, False, "cpu",
                        time.perf_counter(), wrap)


class _Wrap:
    def __init__(self, program):
        self.p = program
        self.n, self.anchor = program.n, program.anchor

    def state(self):
        return self.p.state()


class _NoRedetect(_Wrap):
    """The handheld step: no re-detection, no detection outputs."""

    def step(self, k):
        p = self.p
        (p.states, labels, conf, agitation, corners, sharp, align,
         p.seeds) = mesh.multistream_track_read(
            p.states, p.pool[k], p.seeds, p.gsize, p.zone)
        return {"labels": labels, "conf": conf, "agitation": agitation,
                "corners": corners, "sharpness": sharp, "align": align,
                "seeds": p.seeds,
                **{f"state_{f}": v for f, v in
                   zip(p.states._fields, p.states)}}


class _Recording(_Wrap):
    """The driver's step as it is, recording each pool batch and how many
    detections it gave."""

    def __init__(self, program):
        super().__init__(program)
        self.seen = []

    def step(self, k):
        out = self.p.step(k)
        self.seen.append((k, out["detected"].shape[0],
                          out["scores"].shape[0]))
        return out


class _AlteredCorner(_Wrap):
    """One detected corner of each re-detecting batch moved by a pixel."""

    def step(self, k):
        out = self.p.step(k)
        if out["detected"].shape[0]:
            out["detected"][0, 0, 0] += 1.0
        return out


def test_tiny_run_is_correct(tiny_root):
    rec = []

    def wrap(program):
        rec.append(_Recording(program))
        return rec[0]

    result, lines = _run(tiny_root, wrap)
    assert result["correct"] is True, result["checks"]
    assert "detected_gap_px" in result["checks"]
    assert len(lines) == len(result["checks"])
    # Every stream re-detected in the pool batches at the period, none in
    # the others; both kinds ran.
    cfg = spec.load_cell(WORKLOAD, root=tiny_root, base=tiny_root).config
    period, n = cfg["reanchor"]["period_batches"], cfg["streams"]
    seen = rec[0].seen
    assert all((d, s) == ((n, n) if k % period == 0 else (0, 0))
               for k, d, s in seen), seen
    assert {k % period == 0 for k, _, _ in seen} == {True, False}


@pytest.mark.parametrize("fault", [_NoRedetect, _AlteredCorner])
def test_broken_redetection_comes_out_not_correct(tiny_root, fault):
    result, _ = _run(tiny_root, wrap=fault)
    assert result["correct"] is False
    assert result["failed"] > 0
