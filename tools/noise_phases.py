#!/usr/bin/env python3
"""Where a block of the sensor-noise kernel spends its time, on the card.

    python3 tools/noise_phases.py [--keep DIR]

Copies ``camkifu_tpu_torch/`` into a temporary directory, adds to that
copy of ``csrc/pcg_normal.cu`` a ``%globaltimer`` stamp a tile at five
points (the tile taken; its aggregate published; its look-back done; its
inclusive value published; its span stored), builds and runs the copy at
720p and 1080p (read noise, after two warm calls), and prints for each
phase the percentiles over the tiles of its microseconds, and the
kernel's span from the first tile taken to the last span stored. The
package itself is not touched. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MAX_TILES = 8192

#: (a line of the kernel, the stamp to add after it).
STAMPS = (
    ("  const int t = sh.tile;\n", 0),
    ("  if (tid == 0) publish_agg(agg + (size_t)t * DEPTH, acc);\n", 1),
    ("    if (lane == 0) sh.o = e.x, sh.base = e.y;\n", 2),
    ("  if (tid == 0) publish_inc(inc + 2 * (size_t)t, "
     "make_int2(total.x, base + total.y));\n", 3),
)
PHASES = ("tables", "look-back", "entries", "emit")


def instrument(src: str) -> str:
    head = (f"__device__ unsigned long long phase_stamp[{MAX_TILES}][5];\n"
            "__device__ __forceinline__ unsigned long long stamp_now() {\n"
            "  unsigned long long t;\n"
            '  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));\n'
            "  return t;\n}\n")
    src = src.replace("namespace {\n", head + "namespace {\n", 1)
    for line, k in STAMPS:
        if line not in src:
            raise SystemExit(f"noise_phases: the kernel has no line {line!r}")
        cond = "lane == 0" if line.startswith("    if (lane") else "tid == 0"
        src = src.replace(line, line + f"  if ({cond}) phase_stamp[t][{k}] = "
                          "stamp_now();\n", 1)
    end = src.rindex("\n}\n\n// Tiles the word stream")
    src = (src[:end] + "\n  __syncthreads();\n  if (tid == 0) "
           "phase_stamp[t][4] = stamp_now();" + src[end:])
    return src + ("\nCAMKIFU_API int camkifu_phase_stamps(void* dst) {\n"
                  "  return (int)cudaMemcpyFromSymbol(dst, phase_stamp, "
                  "sizeof(phase_stamp));\n}\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--keep", help="build the copy here and keep it")
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("noise_phases: needs a CUDA device", file=sys.stderr)
        return 1
    work = Path(args.keep or tempfile.mkdtemp(prefix="noise_phases_"))
    pkg = work / "camkifu_tpu_torch"
    shutil.rmtree(pkg, ignore_errors=True)
    shutil.copytree(ROOT / "camkifu_tpu_torch", pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = pkg / "csrc" / "pcg_normal.cu"
    cu.write_text(instrument(cu.read_text()))
    sys.path.insert(0, str(work))
    from camkifu_tpu_torch.ops.cuda import _build
    from camkifu_tpu_torch.ops.cuda import pcg_normal_kernel as pk

    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs

    lib = _build.lib()
    lib.camkifu_phase_stamps.argtypes = [ctypes.c_void_p]
    print(cs._card_line(), flush=True)
    for hw in ((720, 1280), (1080, 1920)):
        frame = torch.from_numpy(np.random.default_rng(1).integers(
            0, 256, (*hw, 3)).astype(np.uint8)).cuda()
        state, inc = cs._noise_state(0, hw)
        for _ in range(3):
            pk.pcg_normal_noise(frame, state, inc, 3.0)
        torch.cuda.synchronize()
        n = frame.numel()
        tiles = -(-(n + n // 32 + 4096) // 4096)
        buf = np.zeros((MAX_TILES, 5), np.uint64)
        _build.check(lib.camkifu_phase_stamps(buf.ctypes.data), "stamps")
        t = buf[:tiles].astype(np.int64)
        t = (t - t[:, 0].min()) / 1e3
        print(f"{hw[0]}p, {tiles} tiles: span {t[:, 4].max():.2f} us from "
              f"the first tile taken; the last tile taken at "
              f"{t[:, 0].max():.2f} us", flush=True)
        for k, name in enumerate(PHASES):
            d = t[:, k + 1] - t[:, k]
            print(f"  {name:9s} us: p10 {np.percentile(d, 10):.2f}, p50 "
                  f"{np.percentile(d, 50):.2f}, p90 "
                  f"{np.percentile(d, 90):.2f}, max {d.max():.2f}",
                  flush=True)
    if not args.keep:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
