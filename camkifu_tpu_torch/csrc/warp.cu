// Homography warp with bilinear taps: uint8 (B, H, W, C) frames → float32
// (B, OH, OW, C) images. Replaces the Pallas kernel
// camkifu_tpu/ops/pallas/warp_kernel.py:warp_to_canonical_pallas, and
// computes what camkifu_tpu/ops/warp.py:bilinear_sample computes on the
// sample grid of apply_homography (not the Pallas two-pass approximation).
//
// One thread per output pixel does every channel of it; the frame index is
// blockIdx.z. Each frame's 3x3 homography (output pixel -> frame pixel,
// OpenCV integer-centre convention) sits at hmats + b * h_stride, so one
// shared matrix is passed with h_stride = 0.
//
// The kernel is bound by device-memory bytes: per output pixel it reads
// four C-byte taps (neighbouring threads read neighbouring taps, so most
// come from L1/L2) and writes 4*C bytes of float32, which dominate.
#include "common.cuh"

namespace {

__global__ void warp_kernel(const uint8_t* __restrict__ frames,
                            const float* __restrict__ hmats, int h_stride,
                            float* __restrict__ out, int h, int w, int c,
                            int oh, int ow, float scale) {
  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  const int v = blockIdx.y * blockDim.y + threadIdx.y;
  const int b = blockIdx.z;
  if (u >= ow || v >= oh) return;

  const float* H = hmats + (size_t)b * h_stride;
  const float fu = (float)u;
  const float fv = (float)v;
  // (u, v, 1) @ H.T, term by term in the reference's order; the build
  // disables FMA contraction, so each product and sum rounds on its own.
  const float den = H[6] * fu + H[7] * fv + H[8];
  float x = (H[0] * fu + H[1] * fv + H[2]) / den;
  float y = (H[3] * fu + H[4] * fv + H[5]) / den;

  // Clamp with comparisons, not fminf/fmaxf, so that a NaN coordinate (a
  // degenerate homography) stays NaN: it reads pixel 0 (float-to-int of
  // NaN is 0 on the device) with a NaN weight, as the reference does.
  x = x < 0.0f ? 0.0f : (x > (float)(w - 1) ? (float)(w - 1) : x);
  y = y < 0.0f ? 0.0f : (y > (float)(h - 1) ? (float)(h - 1) : y);
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const float fx = x - x0f;
  const float fy = y - y0f;
  const int x0 = (int)x0f;
  const int y0 = (int)y0f;
  const int x1 = min(x0 + 1, w - 1);
  const int y1 = min(y0 + 1, h - 1);

  const uint8_t* img = frames + (size_t)b * h * w * c;
  const uint8_t* r0 = img + (size_t)y0 * w * c;
  const uint8_t* r1 = img + (size_t)y1 * w * c;
  float* o = out + (((size_t)b * oh + v) * ow + u) * c;
  for (int ch = 0; ch < c; ++ch) {
    const float p00 = (float)r0[x0 * c + ch];
    const float p01 = (float)r0[x1 * c + ch];
    const float p10 = (float)r1[x0 * c + ch];
    const float p11 = (float)r1[x1 * c + ch];
    const float top = p00 * (1.0f - fx) + p01 * fx;
    const float bot = p10 * (1.0f - fx) + p11 * fx;
    o[ch] = (top * (1.0f - fy) + bot * fy) * scale;
  }
}

}  // namespace

CAMKIFU_API int camkifu_warp(const void* frames, const void* hmats,
                             int h_stride, void* out, int b, int h, int w,
                             int c, int oh, int ow, float scale,
                             void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((ow + block.x - 1) / block.x, (oh + block.y - 1) / block.y,
                  b);
  warp_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)frames, (const float*)hmats, h_stride, (float*)out, h,
      w, c, oh, ow, scale);
  return (int)cudaGetLastError();
}

CAMKIFU_API const char* camkifu_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
