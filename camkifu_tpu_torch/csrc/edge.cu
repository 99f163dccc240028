// Fused edge magnitudes: separable Gaussian blur, 3x3 Sobel, magnitude and
// 4-sector non-maximum suppression of float32 (N, H, W) gray images, with
// zeros within `border` pixels of the image edge. Replaces the Pallas
// kernel camkifu_tpu/ops/pallas/edge_kernel.py:edge_magnitude (and its
// batch-grid twin edge_magnitude_batch).
//
// A whole 256x256 float32 image (256 KB) does not fit one block's shared
// memory, so the image is cut into TILE x TILE output tiles. Each block
// loads its tile plus a HALO-pixel ring (blur radius + Sobel 1 + NMS 1)
// once from device memory, runs every stage in shared memory, and writes
// only the NMS result: one read and one write per pixel, plus the halo.
// The stages follow camkifu_tpu/ops/filters.py and ops/edges.py term by
// term (axis-0 pass first, the same tap order); the build disables FMA
// contraction, so the interior matches the plain version to rounding.
// Outside the image the load clamps to the edge; that only reaches pixels
// inside the zeroed border band (HALO <= border).
#include "common.cuh"

namespace {

constexpr int TILE = 32;
constexpr int RAD = 4;                 // Gaussian radius for sigma = 1.4
constexpr int TAPS = 2 * RAD + 1;
constexpr int HALO = RAD + 2;
constexpr int IN = TILE + 2 * HALO;    // loaded input tile
constexpr int BL = TILE + 4;           // blurred: output +-2
constexpr int MG = TILE + 2;           // magnitude: output +-1

// tan(22.5 deg) and tan(67.5 deg), rounded to float32 as the reference's
// scalar constants are.
constexpr float T1 = 0.41421356237309503f;
constexpr float T2 = 2.414213562373095f;

struct Taps {
  float t[TAPS];
};

__global__ void edge_kernel(const float* __restrict__ img,
                            float* __restrict__ out, int h, int w,
                            int border, Taps taps) {
  __shared__ float s_in[IN][IN];
  __shared__ float s_bv[BL][IN];
  __shared__ float s_b[BL][BL];
  __shared__ float s_mag[MG][MG];
  __shared__ unsigned char s_sec[MG][MG];

  const size_t plane = (size_t)blockIdx.z * h * w;
  const float* src = img + plane;
  const int ty0 = blockIdx.y * TILE;
  const int tx0 = blockIdx.x * TILE;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nt = blockDim.x * blockDim.y;

  for (int i = tid; i < IN * IN; i += nt) {
    const int r = i / IN, c = i % IN;
    const int gy = min(max(ty0 - HALO + r, 0), h - 1);
    const int gx = min(max(tx0 - HALO + c, 0), w - 1);
    s_in[r][c] = src[(size_t)gy * w + gx];
  }
  __syncthreads();

  // Blur along axis 0 (rows of the image), then axis 1.
  for (int i = tid; i < BL * IN; i += nt) {
    const int r = i / IN, c = i % IN;
    float acc = taps.t[0] * s_in[r][c];
    for (int t = 1; t < TAPS; ++t) acc = acc + taps.t[t] * s_in[r + t][c];
    s_bv[r][c] = acc;
  }
  __syncthreads();
  for (int i = tid; i < BL * BL; i += nt) {
    const int r = i / BL, c = i % BL;
    float acc = taps.t[0] * s_bv[r][c];
    for (int t = 1; t < TAPS; ++t) acc = acc + taps.t[t] * s_bv[r][c + t];
    s_b[r][c] = acc;
  }
  __syncthreads();

  // Sobel (cv2 convention): gx smooths along axis 0 then differences along
  // axis 1; gy differences along axis 0 then smooths along axis 1.
  for (int i = tid; i < MG * MG; i += nt) {
    const int r = i / MG, c = i % MG;
    const int y = r + 1, x = c + 1;            // position in s_b
    const float sm_l = (s_b[y - 1][x - 1] + 2.0f * s_b[y][x - 1]) + s_b[y + 1][x - 1];
    const float sm_r = (s_b[y - 1][x + 1] + 2.0f * s_b[y][x + 1]) + s_b[y + 1][x + 1];
    const float gx = sm_r - sm_l;
    const float d_l = s_b[y + 1][x - 1] - s_b[y - 1][x - 1];
    const float d_c = s_b[y + 1][x] - s_b[y - 1][x];
    const float d_r = s_b[y + 1][x + 1] - s_b[y - 1][x + 1];
    const float gy = (d_l + 2.0f * d_c) + d_r;
    s_mag[r][c] = sqrtf(gx * gx + gy * gy);
    const float ax = fabsf(gx), ay = fabsf(gy);
    s_sec[r][c] = ay < T1 * ax ? 0 : (ay > T2 * ax ? 2 : (gx * gy >= 0.0f ? 1 : 3));
  }
  __syncthreads();

  for (int i = tid; i < TILE * TILE; i += nt) {
    const int oy = i / TILE, ox = i % TILE;
    const int gy = ty0 + oy, gx = tx0 + ox;
    if (gy >= h || gx >= w) continue;
    float v = 0.0f;
    if (gy >= border && gy < h - border && gx >= border && gx < w - border) {
      const int y = oy + 1, x = ox + 1;        // position in s_mag
      const float m = s_mag[y][x];
      float n1, n2;
      switch (s_sec[y][x]) {
        case 0: n1 = s_mag[y][x - 1]; n2 = s_mag[y][x + 1]; break;
        case 1: n1 = s_mag[y - 1][x - 1]; n2 = s_mag[y + 1][x + 1]; break;
        case 2: n1 = s_mag[y - 1][x]; n2 = s_mag[y + 1][x]; break;
        default: n1 = s_mag[y - 1][x + 1]; n2 = s_mag[y + 1][x - 1]; break;
      }
      v = (m >= n1 && m >= n2) ? m : 0.0f;
    }
    out[plane + (size_t)gy * w + gx] = v;
  }
}

}  // namespace

CAMKIFU_API int camkifu_edge_taps() { return TAPS; }

CAMKIFU_API int camkifu_edge(const void* img, void* out, int n, int h, int w,
                             int border, const float* taps_host,
                             void* stream) {
  Taps taps;
  for (int t = 0; t < TAPS; ++t) taps.t[t] = taps_host[t];
  const dim3 block(32, 8);
  const dim3 grid((w + TILE - 1) / TILE, (h + TILE - 1) / TILE, n);
  edge_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)img, (float*)out, h, w, border, taps);
  return (int)cudaGetLastError();
}
