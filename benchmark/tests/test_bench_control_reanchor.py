"""The control of ``correct`` in the re-detecting cell, on the card: the
plain reference in the program's place, with detection's maps and
canvases, the tracker's canvases and the scan's arithmetic in bfloat16,
the precision below the configuration's float32, fails at least one of
the cell's limits, where the program passes all of them. At the cell's
1080p frames with four streams and a pool of 4 batches, so that a test
run holds it; the cell's own size is read by ``benchmark/calibrate.py``."""

from __future__ import annotations

import pytest

from benchmark import calibrate, spec

SEEDS = (2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13)


@pytest.mark.gpu
def test_control_fails_a_limit(cuda_device):
    cell = spec.load_cell("handheld19.reanchor")
    cell.config["streams"] = 4
    cell.mix["pool_batches"] = 4
    limits = {c["name"]: c["limit"] for c in cell.config["checks"]}
    for seed in SEEDS:
        program, control = calibrate.readings(cell, seed, 6, True,
                                              cuda_device)
        assert all(v <= limits[k] for k, v in program["numbers"].items()), \
            program
        assert any(v > limits[k] for k, v in control["numbers"].items()), \
            control
