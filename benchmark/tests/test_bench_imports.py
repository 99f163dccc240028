"""What the benchmark loads: no JAX, no JAX package, and a reference
that imports nothing of the program."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PROGRAM = "camkifu_tpu_torch"


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module)
    return out


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "benchmark/reference").glob("*.py"):
        names = _imports(path)
        assert not {n for n in names if n.split(".")[0] == PROGRAM}, path
        assert all(n.split(".")[0] in {"benchmark", "torch", "numpy",
                                       "math", "__future__"}
                   for n in names), (path, names)


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.reference.streams_fixed\n"
            "import benchmark.reference.streams_handheld\n"
            "import benchmark.metrics._bytes\n"
            "import benchmark.traffic.generator\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    top = set(eval(out))
    assert PROGRAM not in top
    assert not top & {"jax", "jaxlib", "flax", "camkifu_tpu"}


def test_forbidden_names_compared_whole():
    from benchmark import run

    saved = dict(sys.modules)
    try:
        for name in ("camkifu_tpu", "jax.numpy", "jaxlib"):
            sys.modules.pop(name, None)
        assert "camkifu_tpu" not in run.forbidden_modules()
        sys.modules["camkifu_tpu_torch_like"] = sys
        sys.modules["jaxlibrary"] = sys
        assert run.forbidden_modules() == [] or \
            set(run.forbidden_modules()) <= {"jax", "jaxlib", "flax",
                                             "camkifu_tpu"}
        assert "jaxlibrary" not in run.forbidden_modules()
        sys.modules["camkifu_tpu.ops"] = sys
        assert "camkifu_tpu" in run.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)
