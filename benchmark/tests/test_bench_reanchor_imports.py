"""The re-detecting cell's reference loads nothing of the program, of
JAX or of the JAX package."""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def test_reanchor_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.reference.streams_reanchor\n"
            "import benchmark.reference.detect\n"
            "import benchmark.metrics._detect_work\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    top = set(eval(out))
    assert not top & {"camkifu_tpu_torch", "jax", "jaxlib", "flax",
                      "camkifu_tpu"}
