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
// A strip loads LOADED columns from a multiple of STORED = LOADED - 2 *
// MARGIN, a multiple of 4, so a lane loads and stores aligned 16-byte
// words where the row length allows, and stores its STORED middle
// columns; the first strip also stores its left MARGIN and the last its
// right one, up to the map's edge. The boundary of the plain version is
// per stage, and the walk keeps it so in registers: input rows and
// columns are clamped into the map as they load (the blur pads its input
// with edge values, and its axis-0 pass is per column); the axis-1 pass
// takes the window's own first column left of lane 0 and its last right of
// lane 31; the Sobel takes blurred row 0 above row 0 and row h - 1 below
// row h - 1 (the walk copies them into its window of blurred rows), and
// smoothed column 0 left of column 0 and column w - 1 right of it. The NMS
// takes its neighbours around the map (torch.roll), which a walk cannot
// see on the map's outer lines: the walk writes the magnitudes of the two
// outer lines on each side, and the outer lines' sectors, into a small
// scratch buffer, and a second launch (`outer_nms_kernel`), a thread a
// pixel of the outer lines, finishes the NMS there from it. That launch is
// the walks' programmatic dependant: it is launched while they run and
// waits for their writes (griddepcontrol).
//
// The stages follow camkifu_tpu/ops/filters.py and ops/edges.py term by
// term (axis-0 pass first, the same tap order, the Sobel's sums in the
// same order); the build disables FMA contraction and sqrtf rounds as
// IEEE, so the whole map is bitwise equal to the plain version. The
// Gaussian taps are symmetric, so taps t and 8 - t share their product.
#include "common.cuh"

namespace {

constexpr int RAD = 4;                 // Gaussian radius for sigma = 1.4
constexpr int TAPS = 2 * RAD + 1;
constexpr int HALO = RAD + 2;          // blur + Sobel 1 + NMS 1
constexpr int MARGIN = 8;              // unstored columns at a strip's sides
constexpr int WARPS = 4;               // strips' segments a block
constexpr int OUTER_THREADS = 256;     // the outer lines' launch
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

__device__ __forceinline__ unsigned sector(float gx, float gy) {
  const float ax = fabsf(gx), ay = fabsf(gy);
  return ay < T1 * ax ? 0u : (ay > T2 * ax ? 2u : (gx * gy >= 0.0f ? 1u : 3u));
}

// A map's scratch: the magnitudes of its rows 0, 1, h - 2, h - 1 (w
// each; a row that is two of them, in a map of 1 to 3 rows, is held once,
// in the slot of the first of 0, h - 1, 1, h - 2 that it is), then row by
// row those of its columns 0, 1, w - 2, w - 1 (held at each place, the
// lane of column 0 writing the first two, that of column w - 1 the last
// two), then the sectors of rows 0 and h - 1, then row by row those of
// columns 0 and w - 1.
struct Outer {
  float* rmag;      // [4][w]
  float* cmag;      // [h][4]
  int* rsec;        // [2][w]
  int* csec;        // [h][2]
  int h, w;

  // `scratch`: the map's 6 * (h + w) words.
  __device__ Outer(float* scratch, int h_, int w_) : h(h_), w(w_) {
    rmag = scratch;
    cmag = col_mags(scratch, w, 0);
    rsec = (int*)(cmag + 4 * h);
    csec = col_secs(scratch, h, w, 0);
  }
  // Row y's four column magnitudes, and its two column sectors.
  static __device__ __forceinline__ float* col_mags(float* scratch, int w,
                                                    int y) {
    return scratch + 4 * (w + y);
  }
  static __device__ __forceinline__ int* col_secs(float* scratch, int h,
                                                  int w, int y) {
    return (int*)scratch + 4 * (w + h) + 2 * (w + y);
  }
  // The slot of line y of n: the first of 0, n - 1, 1, n - 2 that it is,
  // -1 for none.
  static __device__ __forceinline__ int slot(int y, int n) {
    return y == 0 ? 0 : y == n - 1 ? 3 : y == 1 ? 1 : y == n - 2 ? 2 : -1;
  }
  __device__ float mag(int y, int x) const {
    const int r = slot(y, h);
    return r >= 0 ? rmag[r * w + x] : cmag[4 * y + slot(x, w)];
  }
  __device__ unsigned sec(int y, int x) const {
    const int r = slot(y, h);
    return r == 0 || r == 3 ? rsec[(r == 3) * w + x]
                            : csec[2 * y + (slot(x, w) == 3)];
  }
};

// A strip width: COLS adjacent columns a lane, AHEAD input rows in flight.
template <int COLS, int AHEAD>
struct Design {
static_assert(MARGIN >= HALO && MARGIN % 4 == 0 && COLS % 4 == 0 &&
              COLS >= RAD && COLS <= 8 && AHEAD % 3 == 0 && AHEAD <= 6,
              "layout");
static constexpr int LOADED = 32 * COLS;
static constexpr int STORED = LOADED - 2 * MARGIN;

// What a warp's walk carries about its strip, its image and its lane.
struct Strip {
  const float* ld;     // the lane's columns in the next row to load
  float* st;           // the same columns in the next row to store
  float* scratch;      // the map's outer lines (Outer)
  int h, w;
  int yl;              // the next input row to load (clamped as it loads)
  int col;             // the lane's first column
  int re;              // w - 1 - col: the map's last column from col
  unsigned own;        // bit c: this strip stores the lane's column c
  bool first, last;    // lane 0, lane 31
  bool left, right;    // the lane holds the map's column 0, column w - 1
  bool ends;           // its last column is the map's last
  bool vec_ld, vec_st; // the lane's columns as 16-byte words
};

static __device__ __forceinline__ void load_row(Strip& s, float (&v)[COLS]) {
  const float* row = s.ld;
  if (s.yl >= 0 && s.yl < s.h - 1) s.ld += s.w;   // rows clamped to the map
  ++s.yl;
  if (s.vec_ld) {
#pragma unroll
    for (int q = 0; q < COLS / 4; ++q) {
      const float4 f = __ldg((const float4*)row + q);
      v[4 * q] = f.x;
      v[4 * q + 1] = f.y;
      v[4 * q + 2] = f.z;
      v[4 * q + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < COLS; ++c) v[c] = __ldg(row + min(c, s.re));
  }
}

static __device__ __forceinline__ void store_row(Strip& s,
                                                 const float (&v)[COLS]) {
  float* row = s.st;
  s.st += s.w;
  if (s.vec_st) {
#pragma unroll
    for (int q = 0; q < COLS / 4; ++q)
      if (s.own >> (4 * q) & 1u)
        ((float4*)row)[q] =
            make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  } else {
#pragma unroll
    for (int c = 0; c < COLS; ++c)
      if (s.own >> c & 1u) row[c] = v[c];
  }
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
// output row yo = y - 6 follow as soon as the rows they need have arrived.
// Magnitude rows [y_lo, y_hi) of the outer lines go to `o`.
template <int J>
static __device__ __forceinline__ void step(Strip& s, const Taps& taps, int i,
                                            int yo, int y_lo, int y_hi,
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
    // The window's ends stand for the map's: past them, its edge columns.
    if (s.first) e[q] = e[RAD];
    if (s.last) e[COLS + RAD + q] = e[COLS + RAD - 1];
  }
  // Blur along axis 1 → blurred row yb = y - 4 in slot J % 3.
  constexpr int B2 = J % 3, B0 = (J + 1) % 3, B1 = (J + 2) % 3;
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    float a = tap(taps, 0) * e[c];
#pragma unroll
    for (int t = 1; t < TAPS; ++t) a = a + tap(taps, t) * e[c + t];
    k.bw[B2][c] = a;
  }
  // The Sobel pads the blurred map with its edge rows: row -1 is row 0 and
  // row h is row h - 1.
  const int yb = yo + 2;
  if (yb == 0) {
#pragma unroll
    for (int c = 0; c < COLS; ++c) k.bw[B1][c] = k.bw[B2][c];
  } else if (yb == s.h) {
#pragma unroll
    for (int c = 0; c < COLS; ++c) k.bw[B2][c] = k.bw[B1][c];
  }
  if (i < 2 * RAD + 2) return;

  // Sobel (cv2 convention) of row ym = y - 5 from blurred rows y - 6,
  // y - 5, y - 4: the axis-0 sum and difference are per column, the axis-1
  // pass takes the next lanes' outer columns, and the map's edge columns
  // beyond its edges.
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
  if (s.first) sm[0] = sm[1], d[0] = d[1];
  if (s.ends) sm[COLS + 1] = sm[COLS], d[COLS + 1] = d[COLS];
  if (s.right && !s.ends) {           // a map whose width is not the lanes'
#pragma unroll
    for (int c = 0; c < COLS - 1; ++c)
      if (c == s.re) sm[c + 2] = sm[c + 1], d[c + 2] = d[c + 1];
  }
  unsigned sectors = 0;
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    const float gx = sm[c + 2] - sm[c];
    const float gy = (d[c] + 2.0f * d[c + 1]) + d[c + 2];
    k.mw[B2][c + 1] = sqrtf(gx * gx + gy * gy);
    sectors |= sector(gx, gy) << (2 * c);
  }
  k.mw[B2][0] = __shfl_up_sync(FULL, k.mw[B2][COLS], 1);
  k.mw[B2][COLS + 1] = __shfl_down_sync(FULL, k.mw[B2][1], 1);
  k.sw[B2] = sectors;

  // The outer lines' magnitudes and sectors, for the second launch: the
  // map's rows 0, 1, h - 2, h - 1 from every lane, its columns 0, 1 from
  // the lane of column 0 and w - 2, w - 1 from the lane of column w - 1.
  const int ym = yo + 1;
  if (ym >= y_lo && ym < y_hi) {
    const int rs = Outer::slot(ym, s.h);
    if (rs >= 0) {
      const Outer o(s.scratch, s.h, s.w);
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        if (!(s.own >> c & 1u)) continue;
        o.rmag[rs * s.w + s.col + c] = k.mw[B2][c + 1];
        if (rs == 0 || rs == 3)
          o.rsec[(rs == 3) * s.w + s.col + c] = sectors >> (2 * c) & 3u;
      }
    }
    if (s.left) {
      *(float2*)Outer::col_mags(s.scratch, s.w, ym) =
          make_float2(k.mw[B2][1], k.mw[B2][2]);
      Outer::col_secs(s.scratch, s.h, s.w, ym)[0] = sectors & 3u;
    }
    if (s.right) {
      float last = k.mw[B2][COLS], before = k.mw[B2][COLS - 1];
      unsigned sec = sectors >> (2 * COLS - 2);
      if (!s.ends) {                  // a map whose width is not the lanes'
#pragma unroll
        for (int c = 0; c < COLS - 1; ++c)
          if (c == s.re) last = k.mw[B2][c + 1], before = k.mw[B2][c];
        sec = sectors >> (2 * s.re);
      }
      *(float2*)(Outer::col_mags(s.scratch, s.w, ym) + 2) =
          make_float2(before, last);
      Outer::col_secs(s.scratch, s.h, s.w, ym)[1] = sec & 3u;
    }
  }
  if (i < 2 * HALO) return;

  // NMS of row y - 6 (slot B1) against rows y - 7 (B0) and y - 5 (B2):
  // sector 0 looks west and east, 1 north-west and south-east, 2 north and
  // south, 3 north-east and south-west. The outer lines' neighbours wrap:
  // the second launch overwrites them.
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
    float* __restrict__ scratch, int strips, int rows, int strip, int seg,
    int lane, const Taps& taps) {
  const int y_lo = seg * rows, y_hi = min(h, y_lo + rows);
  Strip s;
  s.scratch = scratch;
  s.h = h;
  s.w = w;
  s.col = strip * STORED + lane * COLS;
  s.re = w - 1 - s.col;
  s.first = lane == 0;
  s.last = lane == 31;
  s.left = strip == 0 && lane == 0;
  s.right = s.re >= 0 && s.re < COLS;
  s.ends = s.re == COLS - 1;
  const int own_lo = strip == 0 ? 0 : strip * STORED + MARGIN;
  const int own_hi =
      strip == strips - 1 ? w : min(w, strip * STORED + MARGIN + STORED);
  s.own = 0;
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    const int x = s.col + c;
    if (x >= own_lo && x < own_hi) s.own |= 1u << c;
  }
  const bool vec = (w & 3) == 0 && (((size_t)img | (size_t)out) & 15) == 0;
  s.vec_ld = vec && s.col + COLS <= w;
  s.vec_st = vec;

  // Input rows y_lo - HALO .. y_hi - 1 + HALO, AHEAD of them in flight.
  const int steps = y_hi - y_lo + 2 * HALO;
  s.yl = y_lo - HALO;
  s.ld = img + (size_t)min(max(s.yl, 0), h - 1) * w + s.col;
  s.st = out + (size_t)y_lo * w + s.col;
  Walk k;
#pragma unroll
  for (int j = 0; j < AHEAD; ++j) load_row(s, k.nxt[j]);
  int i = 0;
#define EDGE_STEP(J)                                                    \
  {                                                                     \
    if (i >= steps) break;                                              \
    step<J>(s, taps, i, y_lo - 2 * HALO + i, y_lo, y_hi,                \
            i + AHEAD < steps, k);                                      \
    ++i;                                                                \
    _Pragma("unroll") for (int c = 0; c < COLS; ++c) {                  \
      _Pragma("unroll") for (int t = 0; t < TAPS - 1; ++t)              \
        k.acc[t][c] = k.acc[t + 1][c];                                  \
    }                                                                   \
  }
  while (true) {
    EDGE_STEP(0) EDGE_STEP(1) EDGE_STEP(2)
    if (AHEAD > 3) { EDGE_STEP(3) EDGE_STEP(4) EDGE_STEP(5) }
  }
#undef EDGE_STEP
}
};  // Design

template <int COLS, int AHEAD>
__global__ void __launch_bounds__(32 * WARPS)
edge_kernel(const float* __restrict__ img, float* __restrict__ out,
            float* __restrict__ scratch, int n, int h, int w, int strips,
            int rows, int segs, Taps taps) {
  // The outer lines' launch may start now; it waits for this grid's end.
  asm volatile("griddepcontrol.launch_dependents;");
  const long item = (long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (item >= (long)n * strips * segs) return;
  const int map = (int)(item / ((long)segs * strips));
  const size_t plane = (size_t)map * h * w;
  Design<COLS, AHEAD>::walk(img + plane, out + plane, h, w,
                            scratch + (size_t)map * 6 * (h + w), strips, rows,
                            (int)((item / segs) % strips),
                            (int)(item % segs), threadIdx.x & 31, taps);
}

using Narrow = Design<4, 6>;
using Wide = Design<8, 3>;

// The pixels of a map's outer lines: row 0, row h - 1, then columns 0 and
// w - 1 between them.
__host__ __device__ inline int outer_size(int h, int w) {
  const int mid = h > 2 ? h - 2 : 0;
  return w + (h > 1 ? w : 0) + mid + (w > 1 ? mid : 0);
}

__device__ inline void outer_pixel(int i, int h, int w, int& y, int& x) {
  if (i < w) {
    y = 0, x = i;
    return;
  }
  i -= w;
  if (h > 1) {
    if (i < w) {
      y = h - 1, x = i;
      return;
    }
    i -= w;
  }
  const int mid = h > 2 ? h - 2 : 0;
  y = 1 + (i < mid ? i : i - mid);
  x = i < mid ? 0 : w - 1;
}

// The NMS of the outer lines, a thread a pixel and the maps on grid y,
// with torch.roll's neighbours from the walks' scratch. Every neighbour of
// an outer pixel lies on one of the lines the scratch holds.
__global__ void __launch_bounds__(OUTER_THREADS)
outer_nms_kernel(const float* __restrict__ scratch, float* __restrict__ out,
                 int h, int w) {
  asm volatile("griddepcontrol.wait;" ::: "memory");  // the walks' writes
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= outer_size(h, w)) return;
  const Outer o((float*)scratch + (size_t)blockIdx.y * 6 * (h + w), h, w);
  int y, x;
  outer_pixel(i, h, w, y, x);
  const unsigned sec = o.sec(y, x);
  // Sector 0 west and east, 1 north-west and south-east, 2 north and
  // south, 3 north-east and south-west.
  const int yn = y == 0 ? h - 1 : y - 1, ys = y == h - 1 ? 0 : y + 1;
  const int xw = x == 0 ? w - 1 : x - 1, xe = x == w - 1 ? 0 : x + 1;
  const int x1 = sec <= 1 ? xw : (sec == 2 ? x : xe);
  const int x2 = sec <= 1 ? xe : (sec == 2 ? x : xw);
  const float m = o.mag(y, x);
  const float n1 = o.mag(sec == 0 ? y : yn, x1);
  const float n2 = o.mag(sec == 0 ? y : ys, x2);
  out[((size_t)blockIdx.y * h + y) * w + x] = m >= n1 && m >= n2 ? m : 0.0f;
}

}  // namespace

CAMKIFU_API int camkifu_edge_taps() { return TAPS; }

// Columns a strip of `cols` columns a lane stores, 0 for no such strip:
// the wrapper sizes its segments from the strips.
CAMKIFU_API int camkifu_edge_strip(int cols) {
  return cols == 4 ? Narrow::STORED : cols == 8 ? Wide::STORED : 0;
}

// Scratch floats a map takes: its outer lines' magnitudes and sectors.
CAMKIFU_API int camkifu_edge_scratch(int h, int w) { return 6 * (h + w); }

// `cols` columns a lane (4 or 8) and `rows` output rows a segment; every
// (image, strip, segment) is a warp. Then the outer lines' NMS, through
// `scratch` (n * camkifu_edge_scratch floats). `taps_host` holds the TAPS
// taps, which must be symmetric.
CAMKIFU_API int camkifu_edge(const void* img, void* out, void* scratch, int n,
                             int h, int w, int cols, int rows,
                             const float* taps_host, void* stream) {
  const int stored = camkifu_edge_strip(cols);
  if (rows < 1 || !stored || n > 65535 || h < 1 || w < 1)
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
  if (n < 1) return (int)cudaSuccess;
  auto kernel = cols == 4 ? edge_kernel<4, 6> : edge_kernel<8, 3>;
  kernel<<<(unsigned)blocks, 32 * WARPS, 0, (cudaStream_t)stream>>>(
      (const float*)img, (float*)out, (float*)scratch, n, h, w, strips, rows,
      segs, taps);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // Launched as the walks' programmatic dependant: its launch overlaps
  // their run, and it waits for their writes (griddepcontrol.wait).
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((outer_size(h, w) + OUTER_THREADS - 1) / OUTER_THREADS,
                     n);
  cfg.blockDim = dim3(OUTER_THREADS);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, outer_nms_kernel,
                                 (const float*)scratch, (float*)out, h, w);
}
