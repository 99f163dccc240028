"""Where a block of the hysteresis kernel spends its time, on the card.

    python3 tools/hysteresis_phases.py

Builds a copy of ``camkifu_tpu_torch/csrc/hysteresis.cu`` with
``clock64()`` stamps written by thread 0 of every block at the ends of its
phases, and a small driver that runs the adaptive entry on 2 seeded maps
of 256² and of 512² (NMS-like: 80% zeros), 4 steps, five times each. It
prints, for blocks 0 and 7 of the first map's cluster, the SM cycles from
the block's start to the end of each phase of the last run: the band's
load, each select round (its key pass, its push, the wait for the
cluster's histograms, its end), the select, the flags of the band's end
rows, the rows pushed to the neighbouring blocks, the other flags, the
rows received, each dilation step and the store. The copy and the driver
go to ``build/hysteresis_phases/`` (nvcc, sm_90a, ``--fmad=false`` as the
port builds it).
"""

from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "camkifu_tpu_torch" / "csrc" / "hysteresis.cu"
OUT = ROOT / "build" / "hysteresis_phases"

SLOTS = 48


def _stamp(slot: str) -> str:
    return (f"  if (threadIdx.x == 0) "
            f"g_t[blockIdx.x * {SLOTS} + ({slot})] = clock64();\n")


def instrumented() -> str:
    src = SOURCE.read_text()

    def put(anchor: str, text: str, before: bool = False) -> None:
        nonlocal src
        if src.count(anchor) != 1:
            raise SystemExit(f"not once in {SOURCE}: {anchor!r}")
        src = src.replace(anchor, text + anchor if before else anchor + text)

    src = src.replace('#include "common.cuh"',
                      f'#include "{SOURCE.parent / "common.cuh"}"\n'
                      f"__device__ long long g_t[1 << 16];")
    put("  const int rank = (int)cg::this_cluster().block_rank();\n",
        _stamp("0"), before=True)
    put("  if (bulk && pixels) bar_wait(load_bar, 0);\n", _stamp("1"))
    put("      if (r == 0 && nan) atomicOr(&hist[0][BINS], 1u);",
        _stamp("16 + 4 * r"), before=True)
    put("      if (warp < 2) {\n        // Warp t sums", _stamp("17 + 4 * r"),
        before=True)
    put("        bar_wait(bar, (r >> 1) & 1);\n", _stamp("18 + 4 * r"))
    put("      pref0 = s_pref[0];\n      pref1 = s_pref[1];\n      below0",
        _stamp("19 + 4 * r"), before=True)
    put("  // Flags: a band row's", _stamp("2"), before=True)
    put("  put_flags(true);\n  __syncthreads();\n", _stamp("3"))
    put("  put_flags(false);\n", _stamp("4"), before=True)
    put("  put_flags(false);\n", _stamp("5"))
    put("    bar_wait(halo_bar, 0);\n  }\n", _stamp("6"))
    put("      a.next(kw);\n    }\n    __syncthreads();\n",
        "  " + _stamp("32 + t"))
    put("  // This block reads no other block's data after this",
        _stamp("7"), before=True)
    put('  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");\n}',
        _stamp("8"), before=True)
    return src + DRIVER


DRIVER = r'''
#include <cstdio>
#include <random>
#include <vector>

int main() {
  for (int side : {256, 512}) {
    const int n = 2, h = side, w = side;
    std::vector<float> hm((size_t)n * h * w);
    std::mt19937 rng(1);
    std::uniform_real_distribution<float> u(0.f, 1.f);
    for (auto& v : hm) {
      const float a = u(rng);
      v = u(rng) < 0.2f ? a * a * a : 0.f;
    }
    float *dm, *dout;
    cudaMalloc(&dm, hm.size() * 4);
    cudaMalloc(&dout, hm.size() * 4);
    cudaMemcpy(dm, hm.data(), hm.size() * 4, cudaMemcpyHostToDevice);
    static long long zeros[1 << 16];
    cudaMemcpyToSymbol(g_t, zeros, sizeof zeros);
    for (int rep = 0; rep < 5; ++rep) {
      const int code = camkifu_hysteresis_adaptive(dm, dout, n, h, w,
                                                   0.995f, 0.15f, 0.4f, 4,
                                                   nullptr);
      if (code) {
        printf("launch error %d\n", code);
        return 1;
      }
    }
    const cudaError_t err = cudaDeviceSynchronize();
    if (err) {
      printf("error %s\n", cudaGetErrorString(err));
      return 1;
    }
    std::vector<long long> t(16 * SLOTS_);
    cudaMemcpyFromSymbol(t.data(), g_t, t.size() * 8);
    for (int b : {0, 7}) {
      const long long* s = t.data() + b * SLOTS_;
      printf("%d² block %d, cycles from its start:", side, b);
      const char* names[] = {"", "load", "select", "end rows' flags",
                             "rows pushed", "other flags", "rows received",
                             "dilation", "store"};
      for (int k = 1; k <= 8; ++k)
        printf(" %s %lld;", names[k], s[k] - s[0]);
      printf(" rounds (keys, pushed, received, end):");
      for (int r = 0; r < 4; ++r) {
        if (s[19 + 4 * r] < s[0]) break;        // a round not run
        printf(" [%lld %lld %lld %lld]", s[16 + 4 * r] - s[0],
               s[17 + 4 * r] - s[0], s[18 + 4 * r] - s[0],
               s[19 + 4 * r] - s[0]);
      }
      printf(" steps:");
      for (int k = 0; k < 4; ++k) printf(" %lld", s[32 + k] - s[0]);
      printf("\n");
    }
    cudaFree(dm);
    cudaFree(dout);
  }
  return 0;
}
'''.replace("SLOTS_", str(SLOTS))


def main() -> int:
    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / "phases.cu"
    exe = OUT / "phases"
    src.write_text(instrumented())
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "--fmad=false", "-o", str(exe),
                    str(src)], check=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    return subprocess.call([str(exe)])


if __name__ == "__main__":
    sys.exit(main())
