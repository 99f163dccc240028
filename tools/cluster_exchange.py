"""What it costs blocks of a thread-block cluster to wait for each other,
on the card.

    python3 tools/cluster_exchange.py

Builds and runs a small CUDA program (``build/cluster_exchange/``, nvcc,
sm_90a) that launches clusters of 8 blocks, 16 clusters, back to back,
200 launches a case timed with CUDA events, and prints microseconds:

- an empty launch, with and without the cluster attribute;
- a cluster barrier (``cluster.sync()``: arrive with release, wait with
  acquire) at 128, 256, 512 and 1024 threads a block, and the same
  barrier relaxed (no memory ordering), each the difference between 50
  barriers a launch and none, over 50;
- an all-to-all exchange through mbarriers: each block's thread 0 arrives
  (release, cluster scope) on every block's mbarrier after a block
  barrier, and every thread waits;
- an all-to-all exchange of 16 bytes and of 1 KB from every block to
  every block by ``st.async`` stores into the receiver's shared memory,
  each completing bytes on the receiver's mbarrier, the receiver waiting
  for all of them.

The hysteresis kernel (``camkifu_tpu_torch/csrc/hysteresis.cu``) hands data
between its blocks the last way.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

OUT = Path(__file__).resolve().parents[1] / "build" / "cluster_exchange"

SOURCE = r'''
#include <cstdint>
#include <cstdio>
#include <cooperative_groups.h>
namespace cg = cooperative_groups;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ unsigned in_block(unsigned a, unsigned r) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out)
               : "r"(a), "r"(r));
  return out;
}
__device__ __forceinline__ void wait_parity(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.acquire.cluster.shared::cta"
        ".b64 p, [%1], %2; selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
}

__global__ void empty_k(int n, float* out) {
  if (threadIdx.x == 9999) out[0] = n;
}

__global__ void sync_k(int n, float* out) {
  cg::cluster_group c = cg::this_cluster();
  for (int i = 0; i < n; ++i) c.sync();
  if (threadIdx.x == 9999) out[0] = 1;
}

__global__ void relaxed_k(int n, float* out) {
  for (int i = 0; i < n; ++i) {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
    asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  }
  if (threadIdx.x == 9999) out[0] = 1;
}

__global__ void arrive_k(int n, float* out) {
  __shared__ __align__(8) uint64_t bar;
  cg::cluster_group c = cg::this_cluster();
  const unsigned a = smem_u32(&bar);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 8;" :: "r"(a)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  c.sync();
  for (int i = 0; i < n; ++i) {
    __syncthreads();
    if (threadIdx.x < 8)
      asm volatile(
          "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];"
          :: "r"(in_block(a, threadIdx.x)) : "memory");
    wait_parity(a, i & 1);
  }
  c.sync();
  if (threadIdx.x == 9999) out[0] = 1;
}

template <int WORDS>
__global__ void push_k(int n, float* out) {
  __shared__ __align__(16) unsigned slots[2][8][WORDS];
  __shared__ __align__(8) uint64_t bars[2];
  cg::cluster_group c = cg::this_cluster();
  const unsigned me = c.block_rank();
  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(smem_u32(&bars[b])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  c.sync();
  unsigned acc = 0;
  for (int r = 0; r < n; ++r) {
    const int b = r & 1;
    const unsigned bar = smem_u32(&bars[b]);
    if (threadIdx.x == 0)
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   :: "r"(bar), "r"(8 * WORDS * 4) : "memory");
    for (int i = threadIdx.x; i < 8 * WORDS / 4; i += blockDim.x) {
      const unsigned to = i / (WORDS / 4), v = i % (WORDS / 4);
      asm volatile(
          "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 "
          "[%0], {%1, %2, %3, %4}, [%5];"
          :: "r"(in_block(smem_u32(&slots[b][me][4 * v]), to)), "r"(acc),
             "r"(me), "r"(v), "r"(to), "r"(in_block(bar, to)) : "memory");
    }
    wait_parity(bar, (r >> 1) & 1);
    acc += slots[b][threadIdx.x & 7][threadIdx.x % WORDS];
    __syncthreads();
  }
  c.sync();
  if (acc == 0xdeadbeef) out[0] = acc;
}

template <typename K>
float us(K kern, int n, int threads, bool cluster) {
  float* out;
  cudaMalloc(&out, 4);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(16 * 8);
  cfg.blockDim = dim3(threads);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 8;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = cluster ? 1 : 0;
  for (int i = 0; i < 10; ++i) cudaLaunchKernelEx(&cfg, kern, n, out);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaDeviceSynchronize();
  cudaEventRecord(a);
  for (int i = 0; i < 200; ++i) cudaLaunchKernelEx(&cfg, kern, n, out);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms;
  cudaEventElapsedTime(&ms, a, b);
  const cudaError_t err = cudaGetLastError();
  if (err) printf("error %s\n", cudaGetErrorString(err));
  cudaFree(out);
  return ms / 200 * 1000.f;
}

template <typename K>
float each(K kern, int threads) {
  return (us(kern, 50, threads, true) - us(kern, 0, threads, true)) / 50;
}

int main() {
  printf("empty launch, 16 clusters of 8 blocks of 512 threads: %.2f us; "
         "the same blocks without clusters: %.2f us\n",
         us(empty_k, 0, 512, true), us(empty_k, 0, 512, false));
  for (int t : {128, 256, 512, 1024})
    printf("%4d threads a block: cluster barrier %.3f us, relaxed %.3f us, "
           "all-to-all mbarrier arrive %.3f us, st.async all-to-all 16 B "
           "%.3f us, 1 KB %.3f us\n", t, each(sync_k, t), each(relaxed_k, t),
           each(arrive_k, t), each(push_k<4>, t), each(push_k<256>, t));
  return 0;
}
'''


def main() -> int:
    OUT.mkdir(parents=True, exist_ok=True)
    src, exe = OUT / "bench.cu", OUT / "bench"
    src.write_text(SOURCE)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-o", str(exe), str(src)],
                   check=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    return subprocess.call([str(exe)])


if __name__ == "__main__":
    sys.exit(main())
