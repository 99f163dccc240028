// Fused edge magnitudes: separable Gaussian blur, 3x3 Sobel, magnitude and
// 4-sector non-maximum suppression of float32 (N, H, W) gray images.
// Replaces the Pallas kernel camkifu_tpu/ops/pallas/edge_kernel.py:
// edge_magnitude (and its batch-grid twin edge_magnitude_batch), with the
// boundary of the reference's XLA route (camkifu_tpu/ops/edges.py, which
// the reference takes on every backend but the TPU): the blur and the
// Sobel pad each stage's input with its edge values and the NMS takes its
// neighbours across the image, where the Pallas kernel zeroes a band
// (board detection near the frame's edge reads those edges).
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
// 16-byte words where the row length allows. The walks store nothing
// within `border` >= MARGIN pixels of the image's edge, so no row index is
// ever clamped and columns right of the image, clamped to its last
// column, reach no stored pixel. Two more launches fill that band
// (`band_blur_kernel`, `band_nms_kernel` below).
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
    out[c] = m >= n1 && m >= n2 ? m : 0.0f;
  }
  store_row(s, out);
}

// The walk of one warp: segment `seg` of strip `strip` of one image.
static __device__ __forceinline__ void walk(
    const float* __restrict__ img, float* __restrict__ out, int h, int w,
    int border, int strips, int rows, int strip, int seg, int lane,
    const Taps& taps) {
  // Output rows of the segment outside the band.
  const int y_lo = seg * rows, y_hi = min(h, y_lo + rows);
  const int c_lo = min(max(y_lo, border), y_hi);
  const int c_hi = w > 2 * border ? max(c_lo, min(y_hi, h - border)) : c_lo;

  Strip s;
  const int col = strip * STORED + lane * COLS;
  const int own_lo = max(border, strip * STORED + MARGIN);
  const int own_hi = min(w - border, strip * STORED + MARGIN + STORED);
  const bool vec = (w & 3) == 0 && (((size_t)img | (size_t)out) & 15) == 0;
  s.w = w;
  s.own = 0;
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    s.off[c] = min(col + c, w - 1) - col;
    if (col + c >= own_lo && col + c < own_hi) s.own |= 1u << c;
  }
  s.vec_ld = vec && col + COLS <= w;
  s.vec_st = vec;
  s.st = out + (size_t)c_lo * w + col;

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

// The pixels of a map within `d` of its edge (min(y, h-1-y, x, w-1-x) < d),
// numbered compactly: the full rows at the top and the bottom, then the
// rows between them, each with its d columns at either side.
struct Ring {
  int w, top, bot, left, right, full, side;
  __device__ Ring(int h, int w_, int d)
      : w(w_), top(min(d, h)), bot(max(min(d, h), h - d)), left(min(d, w_)),
        right(max(min(d, w_), w_ - d)) {
    full = top + (h - bot);
    side = left + (w - right);
  }
  __device__ int size() const { return full * w + (bot - top) * side; }
  __device__ int index(int y, int x) const {
    if (y < top) return y * w + x;
    if (y >= bot) return (top + y - bot) * w + x;
    return full * w + (y - top) * side + (x < left ? x : left + x - right);
  }
  __device__ void pixel(int i, int& y, int& x) const {
    if (i < full * w) {
      y = i / w;
      x = i - y * w;
      if (y >= top) y += bot - top;
    } else {
      i -= full * w;
      y = top + i / side;
      x = i % side;
      if (x >= left) x += right - left;
    }
  }
};

constexpr int BAND_THREADS = 256;

__host__ __device__ inline int ring_size(int h, int w, int d) {
  const int ih = max(0, h - 2 * d), iw = max(0, w - 2 * d);
  return h * w - ih * iw;
}

// Scratch floats a map: the blur on the ring the gradients read.
__host__ __device__ inline int band_floats(int h, int w, int border) {
  return ring_size(h, w, border + 2);
}

// The band: every pixel within `border` of the map's edge, with the plain
// version's boundary rule: the blur and the Sobel pad each stage's input
// with its edge values (input rows, then blurred columns, then blurred
// rows and smoothed columns are clamped into the map), the NMS takes its
// neighbours around the map. Two launches, a thread a pixel and the maps
// on grid y, each value summed term by term in the walk's order. The
// first blurs the ring the second reads into `scratch`, each blurred
// pixel from its 9 x 9 inputs; the second takes the gradients of the
// pixel and of its two NMS neighbours from it.
__global__ void __launch_bounds__(BAND_THREADS)
band_blur_kernel(const float* __restrict__ img, float* __restrict__ scratch,
                 int h, int w, int border, Taps taps) {
  const Ring rb(h, w, border + 2);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rb.size()) return;
  img += (size_t)blockIdx.y * h * w;
  int y, x;
  rb.pixel(i, y, x);
  int rows[TAPS];
#pragma unroll
  for (int t = 0; t < TAPS; ++t) rows[t] = min(max(y - RAD + t, 0), h - 1) * w;
  float v = 0.0f;
#pragma unroll
  for (int j = 0; j < TAPS; ++j) {
    const int c = min(max(x - RAD + j, 0), w - 1);
    float a = tap(taps, 0) * __ldg(img + rows[0] + c);
#pragma unroll
    for (int t = 1; t < TAPS; ++t) a = a + tap(taps, t) * __ldg(img + rows[t] + c);
    v = j == 0 ? tap(taps, 0) * a : v + tap(taps, j) * a;
  }
  scratch[(size_t)blockIdx.y * band_floats(h, w, border) + i] = v;
}

__global__ void __launch_bounds__(BAND_THREADS)
band_nms_kernel(const float* __restrict__ scratch, float* __restrict__ out,
                int h, int w, int border) {
  const Ring rb(h, w, border + 2), ro(h, w, border);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= ro.size()) return;
  const float* const b = scratch + (size_t)blockIdx.y * rb.size();
  out += (size_t)blockIdx.y * h * w;
  int y, x;
  ro.pixel(i, y, x);
  auto at = [&](int yy, int xx) {
    return __ldg(b + rb.index(min(max(yy, 0), h - 1), min(max(xx, 0), w - 1)));
  };
  // Gradients of (yy, xx) from the blurred 3 x 3 around it, clamped.
  auto grad = [&](int yy, int xx, float& gx, float& gy) {
    const int yn = max(yy - 1, 0), ys = min(yy + 1, h - 1);
    const int xw = max(xx - 1, 0), xe = min(xx + 1, w - 1);
    const float se = (at(yn, xe) + 2.0f * at(yy, xe)) + at(ys, xe);
    const float sw = (at(yn, xw) + 2.0f * at(yy, xw)) + at(ys, xw);
    const float dw = at(ys, xw) - at(yn, xw);
    const float dc = at(ys, xx) - at(yn, xx);
    const float de = at(ys, xe) - at(yn, xe);
    gx = se - sw;
    gy = (dw + 2.0f * dc) + de;
  };
  auto mag = [&](int yy, int xx) {
    float gx, gy;
    grad(yy, xx, gx, gy);
    return sqrtf(gx * gx + gy * gy);
  };
  float gx, gy;
  grad(y, x, gx, gy);
  const float m = sqrtf(gx * gx + gy * gy);
  const float ax = fabsf(gx), ay = fabsf(gy);
  const unsigned sec = ay < T1 * ax ? 0u
                       : (ay > T2 * ax ? 2u : (gx * gy >= 0.0f ? 1u : 3u));
  // Neighbours as torch.roll's: sector 0 west and east, 1 north-west and
  // south-east, 2 north and south, 3 north-east and south-west. Chosen
  // first, so that a warp computes two magnitudes whatever its sectors.
  const int yn = y == 0 ? h - 1 : y - 1, ys = y == h - 1 ? 0 : y + 1;
  const int xw = x == 0 ? w - 1 : x - 1, xe = x == w - 1 ? 0 : x + 1;
  const int x1 = sec <= 1 ? xw : (sec == 2 ? x : xe);
  const int x2 = sec <= 1 ? xe : (sec == 2 ? x : xw);
  const float n1 = mag(sec == 0 ? y : yn, x1);
  const float n2 = mag(sec == 0 ? y : ys, x2);
  out[(size_t)y * w + x] = m >= n1 && m >= n2 ? m : 0.0f;
}

}  // namespace

CAMKIFU_API int camkifu_edge_taps() { return TAPS; }

// Columns a strip of `cols` columns a lane stores, 0 for no such strip:
// the wrapper sizes its segments from the strips.
CAMKIFU_API int camkifu_edge_strip(int cols) {
  return cols == 4 ? Narrow::STORED : cols == 8 ? Wide::STORED : 0;
}

// Scratch floats the band takes a map, for `border`.
CAMKIFU_API int camkifu_edge_scratch(int h, int w, int border) {
  return band_floats(h, w, border);
}

// `cols` columns a lane (4 or 8) and `rows` output rows a segment; every
// (image, strip, segment) is a warp. Then the band within `border` of the
// edge, through `scratch` (n * camkifu_edge_scratch floats).
// `taps_host` holds the TAPS taps, which must be symmetric.
CAMKIFU_API int camkifu_edge(const void* img, void* out, void* scratch, int n,
                             int h, int w, int border, int cols, int rows,
                             const float* taps_host, void* stream) {
  const int stored = camkifu_edge_strip(cols);
  if (border < MARGIN || rows < 1 || !stored || n > 65535)
    return (int)cudaErrorInvalidValue;
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
  if (blocks > 0)
    kernel<<<(unsigned)blocks, 32 * WARPS, 0, (cudaStream_t)stream>>>(
        (const float*)img, (float*)out, n, h, w, border, strips, rows, segs,
        taps);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n < 1) return (int)err;
  const dim3 blur_grid((ring_size(h, w, border + 2) + BAND_THREADS - 1) /
                           BAND_THREADS, n);
  band_blur_kernel<<<blur_grid, BAND_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)img, (float*)scratch, h, w, border, taps);
  const dim3 nms_grid((ring_size(h, w, border) + BAND_THREADS - 1) /
                          BAND_THREADS, n);
  band_nms_kernel<<<nms_grid, BAND_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)scratch, (float*)out, h, w, border);
  return (int)cudaGetLastError();
}
