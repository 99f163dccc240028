// Fused edge magnitudes: separable Gaussian blur, 3x3 Sobel, magnitude and
// 4-sector non-maximum suppression of float32 (N, H, W) gray images, with
// zeros within `border` pixels of the image edge. Replaces the Pallas
// kernel camkifu_tpu/ops/pallas/edge_kernel.py:edge_magnitude (and its
// batch-grid twin edge_magnitude_batch).
//
// What bounds it: 8 bytes a pixel against about 55 floating operations,
// so device memory (0.020 ms for 128 maps of 256x256 on an H100). What
// costs more than that is moving the intermediate stages between threads:
// a tile held in shared memory pays some 45 shared accesses a pixel. This
// kernel keeps every stage in registers instead. A warp owns a strip of
// 32 * COLS columns, COLS adjacent columns a lane, and walks down a
// segment of rows. Each lane carries, for its columns, the axis-0 blur
// sums of the 9 rows in the making (an input row is loaded once and
// scattered into them, in tap order), the last 3 blurred rows (the Sobel's
// per-column sums and differences) and the last 3 magnitude rows with
// their sectors (the NMS). The horizontal neighbours come from the next
// lanes by __shfl_sync: 8 blurred values, 4 Sobel terms and 2 magnitudes
// a row. No shared memory, no __syncthreads, no division per element.
// Input rows are loaded AHEAD steps before the walk needs them. The row
// loop is unrolled by a multiple of 3 and of AHEAD, so those windows' slots
// are fixed registers; only the 9 blur sums move by one slot a step.
//
// Two strip widths share the code. Wide strips (8 columns a lane, 240
// stored of 256 loaded) cover a 256-column map with one warp and compute
// nothing twice, at the price of few, heavy warps: they serve large
// batches. Narrow strips (4 columns a lane, 112 stored of 128 loaded, more
// rows ahead) make three times as many, lighter warps, which end sooner
// when a few maps leave most of the card idle. The wrapper picks the
// width and the segments' length from the batch and the card.
//
// A strip computes valid results for its columns [HALO, LOADED - HALO)
// and stores [MARGIN, LOADED - MARGIN); strips start at multiples of
// LOADED - 2 * MARGIN, a multiple of 4, so a lane loads and stores aligned
// 16-byte words where the row length allows. The first and last strip
// also store the zero band at the image's sides, which needs border >=
// MARGIN; rows of the band are stored as zeros without computing, so no
// row index is ever clamped. Columns right of the image clamp to its last
// column; they reach only the band.
//
// The stages follow camkifu_tpu/ops/filters.py and ops/edges.py term by
// term (axis-0 pass first, the same tap order, the Sobel's sums in the
// same order); the build disables FMA contraction and sqrtf rounds as
// IEEE, so the interior is bitwise equal to the plain version. The
// Gaussian taps are symmetric, so taps t and 8 - t share their product.
#include "common.cuh"

namespace {

constexpr int RAD = 4;                 // Gaussian radius for sigma = 1.4
constexpr int TAPS = 2 * RAD + 1;
constexpr int HALO = RAD + 2;          // blur + Sobel 1 + NMS 1
constexpr int MARGIN = 8;              // unstored columns at a strip's sides
constexpr int WARPS = 4;               // strips' segments a block
constexpr unsigned FULL = 0xffffffffu;

// tan(22.5 deg) and tan(67.5 deg), rounded to float32 as the reference's
// scalar constants are.
constexpr float T1 = 0.41421356237309503f;
constexpr float T2 = 2.414213562373095f;

// The first RAD + 1 taps: the kernel is symmetric, t[i] == t[2 * RAD - i].
struct Taps {
  float t[RAD + 1];
};

__device__ __forceinline__ float tap(const Taps& taps, int i) {
  return taps.t[i <= RAD ? i : 2 * RAD - i];
}

// A strip width: COLS adjacent columns a lane, AHEAD input rows in flight.
template <int COLS, int AHEAD>
struct Design {
static_assert(MARGIN >= HALO && MARGIN % 4 == 0 && COLS % 4 == 0 &&
              COLS >= RAD && AHEAD % 3 == 0 && AHEAD <= 6, "layout");
static constexpr int LOADED = 32 * COLS;
static constexpr int STORED = LOADED - 2 * MARGIN;

// What a warp's walk carries about its strip, its image and its lane.
struct Strip {
  const float* ld;     // the lane's columns in the next row to load
  float* st;           // the same columns in the next row to store
  int w;
  int off[COLS];       // column offsets from ld, clamped into the image
  unsigned own;        // bit c: this strip stores the lane's column c
  unsigned inside;     // bit c: column c lies outside the zero band
  bool vec_ld, vec_st; // the lane's columns as 16-byte words
};

static __device__ __forceinline__ void load_row(Strip& s, float (&v)[COLS]) {
  if (s.vec_ld) {
#pragma unroll
    for (int q = 0; q < COLS / 4; ++q) {
      const float4 f = __ldg((const float4*)s.ld + q);
      v[4 * q] = f.x;
      v[4 * q + 1] = f.y;
      v[4 * q + 2] = f.z;
      v[4 * q + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < COLS; ++c) v[c] = __ldg(s.ld + s.off[c]);
  }
  s.ld += s.w;
}

static __device__ __forceinline__ void store_row(Strip& s,
                                                 const float (&v)[COLS]) {
  if (s.vec_st) {
#pragma unroll
    for (int q = 0; q < COLS / 4; ++q)
      if (s.own >> (4 * q) & 1u)
        ((float4*)s.st)[q] =
            make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  } else {
#pragma unroll
    for (int c = 0; c < COLS; ++c)
      if (s.own >> c & 1u) s.st[c] = v[c];
  }
  s.st += s.w;
}

// The registers of a walk. The slots of nxt, bw, mw and sw are taken modulo
// their lengths from the step's place J in the unrolled period, so each is
// a fixed register; acc[RAD + d] holds the sum of blurred row y + d at the
// step of input row y and moves down a slot after it.
struct Walk {
  float nxt[AHEAD][COLS];      // input rows on their way
  float acc[TAPS][COLS];       // axis-0 blur sums of rows y - 4 .. y + 4
  float bw[3][COLS];           // blurred rows y - 6, y - 5, y - 4
  float mw[3][COLS + 2];       // magnitude rows y - 7 .. y - 5, lanes' ends
  unsigned sw[3];              // their sectors, 2 bits a column
};

// One step of the walk: input row y arrives (step i of its segment, place
// J of the unrolled period); blurred row y - 4, magnitude row y - 5 and
// output row y - 6 follow as soon as the rows they need have arrived.
template <int J>
static __device__ __forceinline__ void step(Strip& s, const Taps& taps, int i,
                                     bool more, Walk& k) {
  float x[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) x[c] = k.nxt[J % AHEAD][c];
  if (more) load_row(s, k.nxt[J % AHEAD]);

  // Blur along axis 0, scattered: row y is tap t of blurred row y + RAD - t,
  // and rows arrive in tap order, so each sum grows term by term as the
  // plain version's does. Taps t and 2 * RAD - t share their product.
  float e[COLS + 2 * RAD];             // columns -RAD .. COLS + RAD - 1
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    float p[RAD + 1];
#pragma unroll
    for (int t = 0; t <= RAD; ++t) p[t] = taps.t[t] * x[c];
    k.acc[TAPS - 1][c] = p[0];
#pragma unroll
    for (int t = 1; t < TAPS; ++t) {
      float& a = k.acc[TAPS - 1 - t][c];
      a = a + p[t <= RAD ? t : 2 * RAD - t];
    }
    e[RAD + c] = k.acc[0][c];          // row y - 4 is complete
  }
  if (i < 2 * RAD) return;
#pragma unroll
  for (int q = 0; q < RAD; ++q) {
    e[q] = __shfl_up_sync(FULL, e[COLS + q], 1);
    e[COLS + RAD + q] = __shfl_down_sync(FULL, e[RAD + q], 1);
  }
  // Blur along axis 1 → blurred row y - 4 in slot J % 3.
  constexpr int B2 = J % 3, B0 = (J + 1) % 3, B1 = (J + 2) % 3;
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    float a = tap(taps, 0) * e[c];
#pragma unroll
    for (int t = 1; t < TAPS; ++t) a = a + tap(taps, t) * e[c + t];
    k.bw[B2][c] = a;
  }
  if (i < 2 * RAD + 2) return;

  // Sobel (cv2 convention) of row y - 5 from blurred rows y - 6, y - 5,
  // y - 4: the axis-0 sum and difference are per column, the axis-1 pass
  // takes the next lanes' outer columns.
  float sm[COLS + 2], d[COLS + 2];
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    sm[c + 1] = (k.bw[B0][c] + 2.0f * k.bw[B1][c]) + k.bw[B2][c];
    d[c + 1] = k.bw[B2][c] - k.bw[B0][c];
  }
  sm[0] = __shfl_up_sync(FULL, sm[COLS], 1);
  d[0] = __shfl_up_sync(FULL, d[COLS], 1);
  sm[COLS + 1] = __shfl_down_sync(FULL, sm[1], 1);
  d[COLS + 1] = __shfl_down_sync(FULL, d[1], 1);
  unsigned sectors = 0;
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    const float gx = sm[c + 2] - sm[c];
    const float gy = (d[c] + 2.0f * d[c + 1]) + d[c + 2];
    k.mw[B2][c + 1] = sqrtf(gx * gx + gy * gy);
    const float ax = fabsf(gx), ay = fabsf(gy);
    const unsigned sec =
        ay < T1 * ax ? 0u : (ay > T2 * ax ? 2u : (gx * gy >= 0.0f ? 1u : 3u));
    sectors |= sec << (2 * c);
  }
  k.mw[B2][0] = __shfl_up_sync(FULL, k.mw[B2][COLS], 1);
  k.mw[B2][COLS + 1] = __shfl_down_sync(FULL, k.mw[B2][1], 1);
  k.sw[B2] = sectors;
  if (i < 2 * HALO) return;

  // NMS of row y - 6 (slot B1) against rows y - 7 (B0) and y - 5 (B2):
  // sector 0 looks west and east, 1 north-west and south-east, 2 north and
  // south, 3 north-east and south-west.
  float out[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    const int j = c + 1;
    const bool odd = k.sw[B1] >> (2 * c) & 1u;
    const bool high = k.sw[B1] >> (2 * c + 1) & 1u;
    const float m = k.mw[B1][j];
    const float n1 = high ? (odd ? k.mw[B0][j + 1] : k.mw[B0][j])
                          : (odd ? k.mw[B0][j - 1] : k.mw[B1][j - 1]);
    const float n2 = high ? (odd ? k.mw[B2][j - 1] : k.mw[B2][j])
                          : (odd ? k.mw[B2][j + 1] : k.mw[B1][j + 1]);
    const bool keep = m >= n1 && m >= n2 && (s.inside >> c & 1u);
    out[c] = keep ? m : 0.0f;
  }
  store_row(s, out);
}

// The walk of one warp: segment `seg` of strip `strip` of one image.
static __device__ __forceinline__ void walk(
    const float* __restrict__ img, float* __restrict__ out, int h, int w,
    int border, int strips, int rows, int strip, int seg, int lane,
    const Taps& taps) {
  // Output rows of the segment: zero band, computed, zero band.
  const int y_lo = seg * rows, y_hi = min(h, y_lo + rows);
  const int c_lo = min(max(y_lo, border), y_hi);
  const int c_hi = w > 2 * border ? max(c_lo, min(y_hi, h - border)) : c_lo;

  Strip s;
  const int col = strip * STORED + lane * COLS;
  const int own_lo = strip == 0 ? 0 : strip * STORED + MARGIN;
  const int own_hi = strip == strips - 1 ? w : strip * STORED + MARGIN + STORED;
  const bool vec = (w & 3) == 0 && (((size_t)img | (size_t)out) & 15) == 0;
  s.w = w;
  s.own = s.inside = 0;
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    s.off[c] = min(col + c, w - 1) - col;
    if (col + c >= own_lo && col + c < min(own_hi, w)) s.own |= 1u << c;
    if (col + c >= border && col + c < w - border) s.inside |= 1u << c;
  }
  s.vec_ld = vec && col + COLS <= w;
  s.vec_st = vec;
  s.st = out + (size_t)y_lo * w + col;

  const float zeros[COLS] = {};
  for (int y = y_lo; y < c_lo; ++y) store_row(s, zeros);
  if (c_lo < c_hi) {
    // Input rows c_lo - HALO .. c_hi - 1 + HALO, AHEAD of them in flight.
    const int steps = c_hi - c_lo + 2 * HALO;
    s.ld = img + (size_t)(c_lo - HALO) * w + col;
    Walk k;
#pragma unroll
    for (int j = 0; j < AHEAD; ++j) load_row(s, k.nxt[j]);
    int i = 0;
#define EDGE_STEP(J)                                        \
  {                                                         \
    if (i >= steps) break;                                  \
    step<J>(s, taps, i, i + AHEAD < steps, k);              \
    ++i;                                                    \
    _Pragma("unroll") for (int c = 0; c < COLS; ++c) {      \
      _Pragma("unroll") for (int t = 0; t < TAPS - 1; ++t)  \
        k.acc[t][c] = k.acc[t + 1][c];                      \
    }                                                       \
  }
    while (true) {
      EDGE_STEP(0) EDGE_STEP(1) EDGE_STEP(2)
      if (AHEAD > 3) { EDGE_STEP(3) EDGE_STEP(4) EDGE_STEP(5) }
    }
#undef EDGE_STEP
  }
  for (int y = c_hi; y < y_hi; ++y) store_row(s, zeros);
}
};  // Design

template <int COLS, int AHEAD>
__global__ void __launch_bounds__(32 * WARPS)
edge_kernel(const float* __restrict__ img, float* __restrict__ out, int n,
            int h, int w, int border, int strips, int rows, int segs,
            Taps taps) {
  const long item = (long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (item >= (long)n * strips * segs) return;
  const size_t plane = (size_t)(item / ((long)segs * strips)) * h * w;
  Design<COLS, AHEAD>::walk(img + plane, out + plane, h, w, border, strips,
                            rows, (int)((item / segs) % strips),
                            (int)(item % segs), threadIdx.x & 31, taps);
}

using Narrow = Design<4, 6>;
using Wide = Design<8, 3>;

}  // namespace

CAMKIFU_API int camkifu_edge_taps() { return TAPS; }

// Columns a strip of `cols` columns a lane stores, 0 for no such strip:
// the wrapper sizes its segments from the strips.
CAMKIFU_API int camkifu_edge_strip(int cols) {
  return cols == 4 ? Narrow::STORED : cols == 8 ? Wide::STORED : 0;
}

// `cols` columns a lane (4 or 8) and `rows` output rows a segment; every
// (image, strip, segment) is a warp. `taps_host` holds the TAPS taps, which
// must be symmetric.
CAMKIFU_API int camkifu_edge(const void* img, void* out, int n, int h, int w,
                             int border, int cols, int rows,
                             const float* taps_host, void* stream) {
  const int stored = camkifu_edge_strip(cols);
  if (border < MARGIN || rows < 1 || !stored) return (int)cudaErrorInvalidValue;
  Taps taps;
  for (int t = 0; t <= RAD; ++t) {
    if (taps_host[t] != taps_host[2 * RAD - t])
      return (int)cudaErrorInvalidValue;
    taps.t[t] = taps_host[t];
  }
  const int strips = max(1, (w - 2 * MARGIN + stored - 1) / stored);
  const int segs = (h + rows - 1) / rows;
  const long items = (long)n * strips * segs;
  const long blocks = (items + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  auto kernel = cols == 4 ? edge_kernel<4, 6> : edge_kernel<8, 3>;
  kernel<<<(unsigned)blocks, 32 * WARPS, 0, (cudaStream_t)stream>>>(
      (const float*)img, (float*)out, n, h, w, border, strips, rows, segs,
      taps);
  return (int)cudaGetLastError();
}
