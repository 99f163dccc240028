"""Cells, configurations, traffic mixes, loops, camera kinds, drivers,
references and metric readers are found by name, as data: a cell is added by adding files and
entries, with no edit to a file that is there."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

from benchmark import spec
from benchmark.traffic import generator

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_entry_has_its_files():
    bench = _bench()
    for cell in bench["workloads"]:
        c = spec.load_cell(cell["name"])
        assert c.config["name"] == cell["config"]
        assert spec.driver(c.config).Program
        ref = spec.reference(c.config)
        assert callable(ref.start) and callable(ref.step)
        assert callable(spec.loop(c.mix).run)
        assert callable(generator.camera(c.config["camera"]["kind"]).pinhole)
        assert c.metrics(trace=False) and c.metrics(trace=True)
    for m in bench["per_layer"]:
        assert callable(spec.reader(m["name"]))


def test_contract_shapes():
    bench = _bench()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])
    for cfg in bench["configs"]:
        assert (ROOT / cfg["file"]).is_file()
        assert cfg["file"].startswith(tuple(p + "/" for p in bench["paths"]))
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
    assert len(json.dumps(bench)) < 64 * 1024


def _throwaway(tmp: Path) -> Path:
    """A repository of one new cell: its own configuration file and mix,
    beside copies of nothing else."""
    cfg = json.loads((ROOT / "benchmark/configs/fixed19_1080p.json")
                     .read_text())
    cfg.update(name="fixed13_720p", gsize=13, frame_hw=[720, 1280])
    (tmp / "configs").mkdir()
    (tmp / "configs/fixed13_720p.json").write_text(json.dumps(cfg))
    (tmp / "traffic").mkdir()
    mix = json.loads((ROOT / "benchmark/traffic/streams.json").read_text())
    mix["batch_frames"] = 32
    (tmp / "traffic/burst.json").write_text(json.dumps(mix))
    bench = _bench()
    bench["configs"].append({"name": "fixed13_720p", "source": "x",
                             "file": "configs/fixed13_720p.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "fixed13.burst",
                               "config": "fixed13_720p", "traffic": "burst",
                               "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "throwaway_metric", "unit": "%",
                               "better": "higher", "source": "device_trace",
                               "layer": "Device", "moves": "frames_per_s",
                               "workloads": ["fixed13.burst"]})
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


def test_a_new_cell_is_found_by_name(tmp_path, monkeypatch):
    root = _throwaway(tmp_path)
    cell = spec.load_cell("fixed13.burst", root=root, base=root)
    assert cell.config["gsize"] == 13 and cell.mix["batch_frames"] == 32
    per_layer = [m["name"] for m in cell.metrics(trace=True)]
    assert "throwaway_metric" in per_layer
    assert "warp_roofline_pct" not in per_layer      # listed for one cell
    # A new metric's reader is a new module found by its name.
    pkg = tmp_path / "extra"
    pkg.mkdir()
    (pkg / "throwaway_metric.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    import benchmark.metrics

    monkeypatch.setattr(benchmark.metrics, "__path__",
                        list(benchmark.metrics.__path__) + [str(pkg)])
    assert spec.reader("throwaway_metric")(None) == 42.0
    # So are a new loop and a new camera kind, named by a mix or a
    # configuration.
    for pkg_name, mod in (("benchmark.loops", "paced"),
                          ("benchmark.traffic.cameras", "tripod")):
        extra = tmp_path / pkg_name
        extra.mkdir()
        (extra / f"{mod}.py").write_text("def run():\n    return 7\n"
                                         "def pinhole():\n    return 8\n")
        pkg_mod = __import__(pkg_name, fromlist=["_"])
        monkeypatch.setattr(pkg_mod, "__path__",
                            list(pkg_mod.__path__) + [str(extra)])
    assert spec.loop({"loop": "paced"}).run() == 7
    assert generator.camera("tripod").pinhole() == 8
    # The repository's own cells are found as they were.
    assert spec.load_cell("fixed19.streams").config["gsize"] == 19
    with pytest.raises(KeyError):
        spec.load_cell("no.such.cell", root=root)
