// Hough vote accumulator: for each of B frames, K weighted (x, y) points
// vote into an (n_theta, n_rho) float32 accumulator with a bilinear rho
// splat. Replaces the Pallas kernel camkifu_tpu/ops/pallas/hough_kernel.py:
// hough_accumulate_pallas, which wrote the scatter as one-hot matmuls
// because the TPU has no fast scatter.
//
// On the GPU the scatter is the cheap part: one block per (theta row,
// frame), grid (n_theta, B), keeps that row's n_rho bins in shared memory;
// its threads stride over the frame's K points and add both splat taps
// with shared-memory atomics, and the block writes the finished row once. Every block reads all K points (32 KB at
// K = 4096, from L2 after the first block) and writes n_rho floats, so the
// kernel is bound by shared-memory atomics, not by device memory. Sums run
// in another order than the plain version's, so results agree to rounding,
// not bit for bit.
#include "common.cuh"

namespace {

__global__ void hough_kernel(const float* __restrict__ pts,
                             const float* __restrict__ wts,
                             const float* __restrict__ trig,
                             float* __restrict__ out, int k, int n_rho,
                             float rho_max, float rho_scale, float pos_hi) {
  extern __shared__ float acc[];
  const int t = blockIdx.x;
  const size_t f = blockIdx.y;
  pts += f * 2 * k;
  wts += f * k;
  out += f * gridDim.x * n_rho;
  for (int r = threadIdx.x; r < n_rho; r += blockDim.x) acc[r] = 0.0f;
  __syncthreads();

  const float c = trig[2 * t];
  const float s = trig[2 * t + 1];
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    const float wk = wts[i];
    if (wk == 0.0f) continue;
    const float rho = pts[2 * i] * c + pts[2 * i + 1] * s;
    const float pos = fminf(fmaxf((rho + rho_max) * rho_scale, 0.0f), pos_hi);
    const float lo = floorf(pos);
    const float frac = pos - lo;
    const int bin = (int)lo;
    atomicAdd(&acc[bin], (1.0f - frac) * wk);
    atomicAdd(&acc[bin + 1], frac * wk);
  }
  __syncthreads();

  for (int r = threadIdx.x; r < n_rho; r += blockDim.x)
    out[(size_t)t * n_rho + r] = acc[r];
}

}  // namespace

CAMKIFU_API int camkifu_hough(const void* pts, const void* wts,
                              const void* trig, void* out, int b, int k,
                              int n_theta, int n_rho, float rho_max,
                              float rho_scale, float pos_hi, void* stream) {
  const size_t smem = (size_t)n_rho * sizeof(float);
  const dim3 grid(n_theta, b);
  hough_kernel<<<grid, 256, smem, (cudaStream_t)stream>>>(
      (const float*)pts, (const float*)wts, (const float*)trig, (float*)out,
      k, n_rho, rho_max, rho_scale, pos_hi);
  return (int)cudaGetLastError();
}
