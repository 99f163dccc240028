"""The port and its smoke script import without JAX and without the JAX
package, and the smoke script refuses to run without a CUDA device."""

import os
import subprocess
import sys

import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = [
    "camkifu_tpu_torch",
    "camkifu_tpu_torch.config",
    "camkifu_tpu_torch.config.cvconf",
    "camkifu_tpu_torch.config.guiconf",
    "camkifu_tpu_torch.gamemodel",
    "camkifu_tpu_torch.gamemodel.move",
    "camkifu_tpu_torch.gamemodel.rules",
    "camkifu_tpu_torch.gamemodel.sgf",
    "camkifu_tpu_torch.gamemodel.kifu",
    "camkifu_tpu_torch.core",
    "camkifu_tpu_torch.core.gamesync",
    "camkifu_tpu_torch.core.controllerv",
    "camkifu_tpu_torch.core.video",
    "camkifu_tpu_torch.core.capture",
    "camkifu_tpu_torch.core.feeder",
    "camkifu_tpu_torch.core.vmanager",
    "camkifu_tpu_torch.utils.profiling",
    "camkifu_tpu_torch.board.boardfinder",
    "camkifu_tpu_torch.board.bf_manual",
    "camkifu_tpu_torch.stone.stonesfinder",
    "camkifu_tpu_torch.stone.sf_tuto",
    "camkifu_tpu_torch.pipeline",
    "camkifu_tpu_torch.filecheck",
    "camkifu_tpu_torch.board.bf_auto",
    "camkifu_tpu_torch.ops.background",
    "camkifu_tpu_torch.ops.hough",
    "camkifu_tpu_torch.ops.lens",
    "camkifu_tpu_torch.ops.warp",
    "camkifu_tpu_torch.ops.zones",
    "camkifu_tpu_torch.stone.sf_clustering",
    "camkifu_tpu_torch.stone.sf_contours",
    "camkifu_tpu_torch.stone.sf_meta",
    "camkifu_tpu_torch.stone.votes",
    "camkifu_tpu_torch.stone.sf_bgsub",
    "camkifu_tpu_torch.stone.sf_neural",
    "camkifu_tpu_torch.models",
    "camkifu_tpu_torch.models.neural",
    "camkifu_tpu_torch.parallel",
    "camkifu_tpu_torch.parallel.mesh",
    "camkifu_tpu_torch.ops.cuda._build",
    "camkifu_tpu_torch.ops.cuda.warp_kernel",
    "camkifu_tpu_torch.ops.cuda.edge_kernel",
    "camkifu_tpu_torch.ops.cuda.hough_kernel",
    "camkifu_tpu_torch.ops.cuda.hysteresis_kernel",
    "camkifu_tpu_torch.ops.edges",
    "camkifu_tpu_torch.utils.still",
    "camkifu_tpu_torch.utils.synth",
    "camkifu_tpu_torch.utils.latency",
    "chip_smoke",
]


def _python(code: str, cwd: str):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


#: What the port must not import: JAX and its libraries, cv2, and the JAX
#: package.
BLOCKED = ("jax", "flax", "optax", "orbax", "cv2", "camkifu_tpu")


def test_port_imports_without_jax_or_cv2():
    """With jax, flax, optax, orbax, cv2 and the whole JAX package blocked,
    every module of the port imports, and none of them is loaded
    afterwards."""
    code = ("import sys\n"
            f"for name in {BLOCKED!r}:\n"
            "    sys.modules[name] = None\n"
            "import importlib\n"
            f"for name in {MODULES!r}:\n"
            "    importlib.import_module(name)\n"
            "bad = [m for m in sys.modules if (m.split('.')[0] in"
            f" {BLOCKED!r}) and sys.modules[m] is not None]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    proc = _python(code, ROOT)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_chip_smoke_fails_without_cuda(tmp_path):
    """Here there is no CUDA device: the script exits non-zero and prints
    no result line, from the repo root and alone in an empty directory."""
    for cwd, script in ((ROOT, "chip_smoke.py"),
                        (str(tmp_path), str(tmp_path / "chip_smoke.py"))):
        if cwd != ROOT:
            with open(os.path.join(ROOT, "chip_smoke.py")) as src:
                (tmp_path / "chip_smoke.py").write_text(src.read())
        proc = subprocess.run([sys.executable, script], cwd=cwd,
                              capture_output=True, text=True, timeout=120,
                              env={k: v for k, v in os.environ.items()
                                   if k != "PYTHONPATH"})
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
