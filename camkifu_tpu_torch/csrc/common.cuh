// Shared declarations of the port's CUDA kernels: a plain C interface,
// bound from Python with ctypes (camkifu_tpu_torch/ops/cuda/_build.py).
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() right after the launch, so a refused launch
// (too many threads, too much shared memory) reaches the wrapper, which
// raises.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define CAMKIFU_API extern "C" __attribute__((visibility("default")))
