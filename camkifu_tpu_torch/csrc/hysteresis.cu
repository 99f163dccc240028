// Edge hysteresis: double threshold, then `iters` steps of 8-neighbour
// dilation of the strong pixels inside the weak ones, on float32
// (N, H, W) magnitude maps; the output keeps a pixel's magnitude where it
// is strong or was reached, and is 0.0 elsewhere. Neighbours wrap around
// the image, as torch.roll's and jnp.roll's do.
//
// It replaces no Pallas kernel: camkifu_tpu/ops/edges.py:50 hysteresis is
// plain array code that XLA fuses. Eager PyTorch runs the same lines as
// some 18 launches a step, each a pass over the maps, so the port gives
// them one kernel.
//
// What bounds it: the maps read once and written once, 8 bytes a pixel
// (0.020 ms for 128 maps of 256x256 on an H100); the work in between is a
// few bit operations. A block takes a tile of TH x TW output pixels and
// loads it with a halo of `iters` pixels on every side, indices taken
// modulo H and W. Each warp loads whole rows, a lane a column of each
// 32-column word, every load in flight before the first is used, and
// __ballot_sync packs a row's weak and strong flags 32 to a word in shared
// memory (about 1 KB a tile). A dilation step is then one thread a word:
// three shifted ORs of the three rows, masked by the weak word, with a
// __syncthreads between steps. What happens at distance d from the tile's
// edge is wrong after d steps at the earliest (the tile knows nothing of
// what lies outside), so after `iters` steps the interior is exact. Every
// thread keeps the magnitudes of the interior pixels it loaded in registers
// and stores them or 0.0: the maps cross device memory once each way, the
// halo's second reading comes from the L2 cache.
#include "common.cuh"

namespace {

constexpr int TH = 32;                 // output rows a tile
constexpr int TW = 128;                // output columns a tile
constexpr int MAX_ITERS = 8;
constexpr int WARPS = 8;
constexpr int OWN = TH / WARPS;        // interior rows a warp loads and keeps
constexpr int HALO_OWN = (2 * MAX_ITERS + WARPS - 1) / WARPS;  // halo rows
constexpr int ROWS = TH + 2 * MAX_ITERS;
constexpr int KW = (TW + 2 * MAX_ITERS + 31) / 32;   // flag words a row
constexpr int PITCH = KW + 2;          // a zero word at each end of a row
constexpr unsigned FULL = 0xffffffffu;

static_assert(TH % WARPS == 0, "row split");
static_assert(ROWS * KW <= 32 * WARPS, "one thread a flag word");

__device__ __forceinline__ int wrap(int i, int n) {
  i %= n;
  return i < 0 ? i + n : i;
}

// Word `k` of a row of reach flags, dilated along the row.
__device__ __forceinline__ unsigned spread(const unsigned* row, int k) {
  const unsigned x = row[k];
  return x | (x << 1) | (row[k - 1] >> 31) | (x >> 1) | (row[k + 1] << 31);
}

__global__ void __launch_bounds__(32 * WARPS)
hysteresis_kernel(const float* __restrict__ mag, float* __restrict__ out,
                  int h, int w, int tiles_x, int tiles_y,
                  const float* __restrict__ low_ptr,
                  const float* __restrict__ high_ptr, float low_val,
                  float high_val, int iters) {
  // Flag rows 1 .. rows of the tile, a zero row above and below.
  __shared__ unsigned s_weak[ROWS + 2][PITCH];
  __shared__ unsigned s_reach[2][ROWS + 2][PITCH];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = blockIdx.x % tiles_x;
  const int ty = (blockIdx.x / tiles_x) % tiles_y;
  const int img = blockIdx.x / (tiles_x * tiles_y);
  const size_t plane = (size_t)img * h * w;
  const float low = low_ptr ? low_ptr[img] : low_val;
  const float high = high_ptr ? high_ptr[img] : high_val;
  const int x0 = tx * TW - iters, y0 = ty * TH - iters;
  const int rows = TH + 2 * iters, cols = TW + 2 * iters;

  // The lane's column of each word, wrapped once; -1 beyond the halo.
  int gx[KW];
#pragma unroll
  for (int k = 0; k < KW; ++k)
    gx[k] = 32 * k + lane < cols ? wrap(x0 + 32 * k + lane, w) : -1;

  // A warp's rows: OWN interior rows, whose magnitudes it keeps, and up to
  // HALO_OWN halo rows above or below. All loads are started before the
  // first is used, so a block waits for device memory once.
  int tr[OWN + HALO_OWN];              // row in the tile, -1 for none
  float m[OWN + HALO_OWN][KW];
#pragma unroll
  for (int j = 0; j < OWN + HALO_OWN; ++j) {
    const int hr = warp + (j - OWN) * WARPS;         // halo rows, from j = OWN
    tr[j] = j < OWN ? iters + warp * OWN + j
                    : hr < iters ? hr : hr < 2 * iters ? TH + hr : -1;
    const float* src =
        mag + plane + (size_t)wrap(y0 + max(tr[j], 0), h) * w;
#pragma unroll
    for (int k = 0; k < KW; ++k)
      m[j][k] = tr[j] >= 0 && gx[k] >= 0 ? __ldg(src + gx[k]) : 0.0f;
  }
  // Meanwhile the words no row's flags are written to: the rows above and
  // below the tile and the word at each end of every row.
  for (int i = tid; i < 2 * PITCH; i += 32 * WARPS) {
    const int r = i < PITCH ? 0 : rows + 1, k = i % PITCH;
    s_reach[0][r][k] = s_reach[1][r][k] = 0;
  }
  for (int i = tid; i < 2 * (ROWS + 2); i += 32 * WARPS) {
    const int r = i >> 1, k = (i & 1) * (PITCH - 1);
    s_reach[0][r][k] = s_reach[1][r][k] = 0;
  }
#pragma unroll
  for (int j = 0; j < OWN + HALO_OWN; ++j) {
    if (tr[j] < 0) continue;                         // the same for a warp
#pragma unroll
    for (int k = 0; k < KW; ++k) {
      const unsigned wk = __ballot_sync(FULL, gx[k] >= 0 && m[j][k] >= low);
      const unsigned st = __ballot_sync(FULL, gx[k] >= 0 && m[j][k] >= high);
      if (lane == 0) {
        s_weak[tr[j] + 1][k + 1] = wk;
        s_reach[0][tr[j] + 1][k + 1] = st;
      }
    }
  }
  __syncthreads();

  // `iters` dilations, one thread a word, from buffer to buffer.
  const int r = tid / KW + 1, k = tid % KW + 1;
  const bool mine = tid < rows * KW;
  int cur = 0;
  for (int t = 0; t < iters; ++t) {
    if (mine) {
      const unsigned d = spread(s_reach[cur][r - 1], k) |
                         spread(s_reach[cur][r], k) |
                         spread(s_reach[cur][r + 1], k);
      s_reach[cur ^ 1][r][k] = d & s_weak[r][k];
    }
    __syncthreads();
    cur ^= 1;
  }

  // Store the interior: magnitude where reached or strong, else 0.0.
#pragma unroll
  for (int j = 0; j < OWN; ++j) {
    const int rr = warp * OWN + j;
    const int y = ty * TH + rr;
    if (y >= h) continue;
    float* dst = out + plane + (size_t)y * w;
#pragma unroll
    for (int k2 = 0; k2 < KW; ++k2) {
      const int lx = 32 * k2 + lane - iters;      // column within the tile
      const int x = tx * TW + lx;
      if (lx < 0 || lx >= TW || x >= w) continue;
      const float v = m[j][k2];
      const bool hit =
          (s_reach[cur][iters + rr + 1][k2 + 1] >> lane) & 1u;
      dst[x] = (hit || v >= high) ? v : 0.0f;
    }
  }
}

}  // namespace

// `low` and `high` are device pointers to one float32 threshold a map, or
// both null for the two values passed beside them; at most MAX_ITERS steps
// (the halo a tile carries).
CAMKIFU_API int camkifu_hysteresis(const void* mag, void* out, int n, int h,
                                   int w, const void* low, const void* high,
                                   float low_val, float high_val, int iters,
                                   void* stream) {
  if (iters < 0 || iters > MAX_ITERS || !low != !high)
    return (int)cudaErrorInvalidValue;
  const int tiles_x = (w + TW - 1) / TW, tiles_y = (h + TH - 1) / TH;
  const long blocks = (long)n * tiles_x * tiles_y;
  if (blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  hysteresis_kernel<<<(unsigned)blocks, 32 * WARPS, 0, (cudaStream_t)stream>>>(
      (const float*)mag, (float*)out, h, w, tiles_x, tiles_y,
      (const float*)low, (const float*)high, low_val, high_val, iters);
  return (int)cudaGetLastError();
}
