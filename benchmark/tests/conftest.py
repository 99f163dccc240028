"""Tiny cells for the benchmark's own tests: every configuration of
``BENCHMARK.json`` cut to a few small streams, from a temporary
directory, so that a run fits on the CPU."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: The tiny size: small frames, two streams, two batches a pool.
TINY_HW = [120, 216]


def write_tiny(tmp: Path) -> Path:
    """A copy of the benchmark's cells under ``tmp``, each configuration
    at ``TINY_HW`` with 2 streams, the mix at 2 batches a pool."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (tmp / "configs").mkdir(parents=True, exist_ok=True)
    (tmp / "traffic").mkdir(exist_ok=True)
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg["frame_hw"] = TINY_HW
        cfg["streams"] = 2
        cam = cfg["camera"]
        if "drift_px" in cam:
            scale = TINY_HW[0] / 1080.0
            cam["drift_px"] = [d * scale for d in cam["drift_px"]]
        c["file"] = f"configs/{cfg['name']}.json"
        (tmp / c["file"]).write_text(json.dumps(cfg))
    for mix in (ROOT / "benchmark" / "traffic").glob("*.json"):
        m = json.loads(mix.read_text())
        m.update(pool_batches=2, trace_skip=2, trace_batches=2,
                 check_batches=4)
        (tmp / "traffic" / mix.name).write_text(json.dumps(m))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return write_tiny(tmp_path_factory.mktemp("tiny_bench"))


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided inside the
    test)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
