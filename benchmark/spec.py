"""Everything the harness finds by name: the cell in ``BENCHMARK.json``,
its configuration (``configs/<config>.json``), its traffic mix
(``traffic/<mix>.json``) and the loop that mix names
(``loops/<loop>.py``), the camera kind of the configuration
(``traffic/cameras/<kind>.py``), the configuration's driver and reference
(``drivers/<driver>.py``, ``reference/<driver>.py``) and each per-layer
metric's reader (``metrics/<metric>.py``). A cell, a configuration, a mix
or a metric is added by adding its file and its entry; no file that is
there changes."""

from __future__ import annotations

import importlib
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: list
    per_layer: list

    def metrics(self, trace: bool) -> list[dict]:
        """The metrics this cell reports: its end-to-end ones, or with
        ``trace`` its per-layer ones (an entry with ``workloads`` only in
        the cells it lists)."""
        group = self.per_layer if trace else self.end_to_end
        return [m for m in group
                if self.name in m.get("workloads", [self.name])]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(workload: str, root: Path = ROOT, base: Path = HERE) -> Cell:
    """The cell named ``workload`` in ``root/BENCHMARK.json``, its
    configuration and mix read from ``base``."""
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(there are {sorted(cells)})")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(root / configs[cell["config"]]["file"])
    mix = _json(base / "traffic" / f"{cell['traffic']}.json")
    return Cell(cell["name"], cell["chips"], config, mix,
                bench["end_to_end"], bench["per_layer"])


def driver(config: dict):
    """The module that runs the system under test for ``config``."""
    return importlib.import_module(f"benchmark.drivers.{config['driver']}")


def reference(config: dict):
    """The plain reference of ``config``'s driver."""
    return importlib.import_module(f"benchmark.reference.{config['driver']}")


def loop(mix: dict):
    """The module that offers the mix's batches: ``loops/<loop>.py``."""
    return importlib.import_module(f"benchmark.loops.{mix['loop']}")


def reader(metric: str):
    """The per-layer metric's reader: ``read(ctx)`` → a number, or None
    where the run gave it nothing to read."""
    return importlib.import_module(f"benchmark.metrics.{metric}").read
