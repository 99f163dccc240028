"""One tiny run of each cell on the CPU, and the same run with the timed
path broken underneath: ``correct`` has to come out false for each fault
a cell can have (a step that returns its state unchanged, half of the
streams left out with the rest standing in for them, an answer altered
where it is produced). The cells run on one card, so there is no
exchange between cards to leave out."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from benchmark import run, spec

ROOT = Path(__file__).resolve().parents[2]
KEYS = ("correct", "attempted", "failed", "metrics", "device")
SECONDS = 12.0


def _run(tiny_root, workload, wrap=None, trace=False, seed=2 ** 33 + 7):
    cell = spec.load_cell(workload, root=tiny_root, base=tiny_root)
    return run.run_cell(cell, seed, SECONDS, trace, "cpu",
                        time.perf_counter(), wrap)


@pytest.mark.parametrize("workload", ["fixed19.streams",
                                      "handheld19.streams"])
def test_tiny_run_is_correct_and_well_formed(tiny_root, workload):
    result, lines = _run(tiny_root, workload)
    assert all(k in result for k in KEYS)
    assert list(result)[-1] == "checks"
    assert result["correct"] is True, result["checks"]
    assert result["compared_batches"] >= 3
    assert set(result["metrics"]) == {"frames_per_s", "batch_p95_ms",
                                      "setup_s"}
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert result["device"]["count"] == 1
    assert len(lines) == len(result["checks"])
    json.loads(json.dumps(result))
    assert run.forbidden_modules() == []


class _Wrap:
    """The program, with its step broken by a subclass."""

    def __init__(self, program):
        self.p = program
        self.n, self.anchor = program.n, program.anchor

    def state(self):
        return self.p.state()


class _Stale(_Wrap):
    """A step that returns its state unchanged: the program is handed back
    the state it started the batch from."""

    def step(self, k):
        before = self.p.states
        out = self.p.step(k)
        self.p.states = before
        out.update({f"state_{f}": v
                    for f, v in zip(before._fields, before)})
        return out


class _HalfStreams(_Wrap):
    """Half of the streams left out: the first half's outputs stand in for
    the rest."""

    def step(self, k):
        out = self.p.step(k)
        half = self.n // 2
        for v in out.values():
            if v.ndim and v.shape[0] == self.n:
                v[half:2 * half] = v[:half]
        return out


class _Altered(_Wrap):
    """One answer altered where it is produced: one intersection of the
    last frame of every batch read as the next colour."""

    def step(self, k):
        out = self.p.step(k)
        lab = out["labels"]
        lab[0, -1, 3, 3] = (lab[0, -1, 3, 3] + 1) % 3
        return out


@pytest.mark.parametrize("fault", [_Stale, _HalfStreams, _Altered])
@pytest.mark.parametrize("workload", ["fixed19.streams",
                                      "handheld19.streams"])
def test_faults_come_out_not_correct(tiny_root, workload, fault):
    result, _ = _run(tiny_root, workload, wrap=fault)
    assert result["correct"] is False
    assert result["failed"] > 0


def test_trace_run_on_the_cpu_reports_no_device_metric(tiny_root):
    """A traced run off the card has no profiler stretch: the readers find
    nothing, and only the host's own span is reported."""
    result, _ = _run(tiny_root, "fixed19.streams", trace=True)
    assert set(result["metrics"]) <= {"enqueue_ms"}
    assert "busy_s" not in result["device"]


def test_no_card_no_result(tmp_path):
    """Without a CUDA card the command exits non-zero and prints nothing
    on standard output; so it does in a directory that holds only
    ``BENCHMARK.json`` and the benchmark's own files."""
    cmd = [sys.executable, "benchmark/run.py", "--workload",
           "fixed19.streams", "--seed", str(2 ** 31 + 5), "--seconds", "1",
           "--trace", "0"]
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout == ""
