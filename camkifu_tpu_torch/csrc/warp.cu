// Homography warp with bilinear taps: uint8 (B, H, W, C) frames → float32
// (B, OH, OW, C) images. Replaces the Pallas kernel
// camkifu_tpu/ops/pallas/warp_kernel.py:warp_to_canonical_pallas, and
// computes what camkifu_tpu/ops/warp.py:bilinear_sample computes on the
// sample grid of apply_homography (not the Pallas two-pass approximation).
//
// Each frame's 3x3 homography (output pixel -> frame pixel, OpenCV
// integer-centre convention) sits at hmats + b * h_stride, so one shared
// matrix is passed with h_stride = 0. The frame index is blockIdx.y.
//
// Bound: device-memory bytes. Per output pixel it writes 4*C bytes of
// float32 and needs four C-byte taps; at 128 x 304^2 x 3 that is 142 MB
// each way, 0.085 ms at 3.35 TB/s. (The taps of neighbouring pixels lie
// ~3 source pixels apart, so whole 32-byte sectors of the two source rows
// under each output row are read; that floor is higher and chip_smoke.py
// measures it.) The design spends few instructions per byte:
//
// - Each thread computes PX = 4 adjacent output pixels along u, so a
//   thread's 4*C floats leave as C aligned float4 stores (a 304 x 3 float32
//   row is 3,648 B, a multiple of 16) with an evict-first hint; rows that
//   are not 16-byte aligned, and the ragged end, store float by float.
// - A pixel's two taps in one source row are 2*C adjacent bytes (C = 1 or
//   3 on the port's paths): one aligned 8-byte load, and a second only
//   when the bytes straddle an 8-byte boundary, then shifts. Every word
//   loaded holds a byte the pixel needs, so no load leaves the frame's
//   8-byte-aligned extent. Other C read byte by byte.
// - Threads are laid out row-major over (v, u/PX) of each frame, so the
//   lanes of a warp walk one or two output rows left to right and their
//   taps share sectors of the same two source rows.
// - The per-pixel arithmetic is the reference's, term by term; the build
//   disables FMA contraction, so every pixel is bitwise equal to the plain
//   version's.
#include "common.cuh"

namespace {

constexpr int PX = 4;
constexpr int THREADS = 256;

// The 2*C bytes of the taps x0 and x1 (x1 == x0 at the right edge) of one
// source row, as floats: p0[ch] at x0 and p1[ch] at x1.
template <int C>
__device__ __forceinline__ void row_taps(const uint8_t* row, int x0, int x1,
                                         float (&p0)[C], float (&p1)[C]) {
  const uint8_t* first = row + x0 * C;
  const int span = (x1 - x0 + 1) * C;           // bytes the pixel needs
  const uintptr_t addr = (uintptr_t)first;
  const int off = (int)(addr & 7);
  const unsigned long long* word =
      (const unsigned long long*)(addr - off);
  unsigned long long bits = __ldg(word) >> (8 * off);
  if (off + span > 8) bits |= __ldg(word + 1) << (64 - 8 * off);
  const int second = (x1 - x0) * C;
#pragma unroll
  for (int ch = 0; ch < C; ++ch) {
    p0[ch] = (float)(unsigned)((bits >> (8 * ch)) & 0xff);
    p1[ch] = (float)(unsigned)((bits >> (8 * (second + ch))) & 0xff);
  }
}

// One output pixel's source taps: the coordinates term by term in the
// reference's order, clamped with comparisons (not fminf/fmaxf), so that a
// NaN coordinate from a degenerate homography stays NaN: it reads pixel 0
// (float-to-int of NaN is 0 on the device) with a NaN weight, as the
// reference does.
struct Taps {
  int x0, x1, y0, y1;
  float fx, fy;
};

__device__ __forceinline__ Taps taps_of(const float (&H)[9], float fu,
                                        float fv, int h, int w) {
  const float den = H[6] * fu + H[7] * fv + H[8];
  float x = (H[0] * fu + H[1] * fv + H[2]) / den;
  float y = (H[3] * fu + H[4] * fv + H[5]) / den;
  x = x < 0.0f ? 0.0f : (x > (float)(w - 1) ? (float)(w - 1) : x);
  y = y < 0.0f ? 0.0f : (y > (float)(h - 1) ? (float)(h - 1) : y);
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  Taps t;
  t.fx = x - x0f;
  t.fy = y - y0f;
  t.x0 = (int)x0f;
  t.y0 = (int)y0f;
  t.x1 = min(t.x0 + 1, w - 1);
  t.y1 = min(t.y0 + 1, h - 1);
  return t;
}

__device__ __forceinline__ float blend(float p00, float p01, float p10,
                                       float p11, float fx, float fy,
                                       float scale) {
  const float top = p00 * (1.0f - fx) + p01 * fx;
  const float bot = p10 * (1.0f - fx) + p11 * fx;
  return (top * (1.0f - fy) + bot * fy) * scale;
}

// C > 0: the channel count is fixed at compile time and the taps are
// loaded as words. C == 0: any channel count c, byte by byte.
template <int C>
__global__ void __launch_bounds__(THREADS)
    warp_kernel(const uint8_t* __restrict__ frames,
                const float* __restrict__ hmats, int h_stride,
                float* __restrict__ out, int h, int w, int c, int oh, int ow,
                int groups, float scale) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const int v = i / groups;
  if (v >= oh) return;
  const int u0 = (i - v * groups) * PX;
  const int b = blockIdx.y;
  if (C > 0) c = C;

  float H[9];
#pragma unroll
  for (int j = 0; j < 9; ++j) H[j] = hmats[(size_t)b * h_stride + j];
  const uint8_t* img = frames + (size_t)b * h * w * c;
  float* o = out + (((size_t)b * oh + v) * ow + u0) * c;
  const int n = min(PX, ow - u0);
  const float fv = (float)v;

  if constexpr (C > 0) {
    float res[PX * C];
#pragma unroll
    for (int q = 0; q < PX; ++q) {
      const Taps t = taps_of(H, (float)(u0 + q), fv, h, w);
      float p00[C], p01[C], p10[C], p11[C];
      row_taps<C>(img + (size_t)t.y0 * w * C, t.x0, t.x1, p00, p01);
      row_taps<C>(img + (size_t)t.y1 * w * C, t.x0, t.x1, p10, p11);
#pragma unroll
      for (int ch = 0; ch < C; ++ch)
        res[q * C + ch] =
            blend(p00[ch], p01[ch], p10[ch], p11[ch], t.fx, t.fy, scale);
    }
    if (n == PX && ((uintptr_t)o & 15) == 0) {
      float4* o4 = reinterpret_cast<float4*>(o);
#pragma unroll
      for (int j = 0; j < C; ++j)
        __stcs(o4 + j, make_float4(res[4 * j], res[4 * j + 1],
                                   res[4 * j + 2], res[4 * j + 3]));
    } else {
#pragma unroll
      for (int j = 0; j < PX * C; ++j)
        if (j < n * C) o[j] = res[j];
    }
  } else {
    for (int q = 0; q < n; ++q) {
      const Taps t = taps_of(H, (float)(u0 + q), fv, h, w);
      const uint8_t* r0 = img + (size_t)t.y0 * w * c;
      const uint8_t* r1 = img + (size_t)t.y1 * w * c;
      for (int ch = 0; ch < c; ++ch)
        o[q * c + ch] = blend((float)r0[t.x0 * c + ch],
                              (float)r0[t.x1 * c + ch],
                              (float)r1[t.x0 * c + ch],
                              (float)r1[t.x1 * c + ch], t.fx, t.fy, scale);
    }
  }
}

template <int C>
cudaError_t launch(const uint8_t* frames, const float* hmats, int h_stride,
                   float* out, int b, int h, int w, int c, int oh, int ow,
                   float scale, cudaStream_t stream) {
  const int groups = (ow + PX - 1) / PX;
  const long long threads = (long long)oh * groups;
  const dim3 grid((unsigned)((threads + THREADS - 1) / THREADS), b);
  warp_kernel<C><<<grid, THREADS, 0, stream>>>(
      frames, hmats, h_stride, out, h, w, c, oh, ow, groups, scale);
  return cudaGetLastError();
}

}  // namespace

CAMKIFU_API int camkifu_warp(const void* frames, const void* hmats,
                             int h_stride, void* out, int b, int h, int w,
                             int c, int oh, int ow, float scale,
                             void* stream) {
  const uint8_t* f = (const uint8_t*)frames;
  const float* hm = (const float*)hmats;
  float* o = (float*)out;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (c) {
    case 1:
      return (int)launch<1>(f, hm, h_stride, o, b, h, w, c, oh, ow, scale, st);
    case 3:
      return (int)launch<3>(f, hm, h_stride, o, b, h, w, c, oh, ow, scale, st);
    default:
      return (int)launch<0>(f, hm, h_stride, o, b, h, w, c, oh, ow, scale, st);
  }
}

CAMKIFU_API const char* camkifu_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
