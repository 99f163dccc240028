// Hough vote accumulator: for each of B frames, K weighted (x, y) points
// vote into an (n_theta, n_rho) float32 accumulator with a bilinear rho
// splat. Replaces the Pallas kernel camkifu_tpu/ops/pallas/hough_kernel.py:
// hough_accumulate_pallas, which wrote the scatter as one-hot matmuls
// because the TPU has no fast scatter.
//
// Bound: about 12 floating operations per (point, theta) pair with a
// non-zero weight (rho, bin position, fraction, two weighted taps, two
// adds); at B = 64, K = 4096, 128 thetas that is 0.40 GFLOP, 6 us at the
// H100's 67 TFLOP/s, above the 11.5 MB (3.4 us) of points and votes. What
// costs more than the arithmetic is where the adds land:
//
// - A block owns ROWS = 32 theta rows of one frame, one row per lane; its
//   WARPS warps take different points. All lanes of a warp take the same
//   point (a broadcast read), so a warp instruction's 32 adds go to 32
//   rows, and with the accumulator laid out bin-major, acc[bin][lane], to
//   32 banks: they never collide or conflict, however many points share a
//   bin (a board's ~100 points on one line do).
// - Warps share the rows, so the adds are atomic, and integer sums keep
//   them independent of the order the card runs them in. The block adds
//   votes in 64-bit fixed point: each vote times a power-of-two scale,
//   rounded to an integer. The scale is the largest that keeps the sum of
//   the block's |weights| within 2^62, so no bin can overflow, and each
//   vote is rounded by at most 2^-63 of that sum: far below the float32
//   rounding of the votes, whatever the spread of the weights (a 32-bit
//   sum would round each vote by 2^-31 of it, more than a small weight's
//   own precision). Hopper has no native shared-memory add for floats or
//   64-bit integers: both compile to a compare-and-swap loop
//   (ATOMS.CAST.SPIN, .64 here), which passes at its first try unless
//   another warp adds to the same bin in between. Those adds cost about
//   twice the native 32-bit add and bound the loop.
// - The frame's points are staged in shared memory with cp.async, as
//   (x, y, w) float4s in tiles of TILE_POINTS, and read from device memory
//   once per 32 theta rows. A warp reads BATCH = 4 points before it adds
//   any vote, so their arithmetic overlaps, and the block has 16 warps to
//   hide the adds' latency. A zero weight skips the point for the whole
//   warp at once (every lane holds the same point).
// - Where B is small the grid would not fill the card, so the K points are
//   also split across `splits` blocks. Each stores its partial rows in a
//   scratch array, and a second small kernel sums them in split order (the
//   caller's scratch, one float4 a thread). With one split the rows go
//   straight to the output.
// - The finished rows go out through padded 32x33 transposes, so the
//   stores are coalesced along rho and the shared-memory reads stay free
//   of bank conflicts.
//
// n_rho is at most MAX_BINS: 32 rows of 64-bit bins beside the point tile
// fill the 227 KB of shared memory a block can opt in to. Votes are
// rounded to fixed point, so results agree with the plain version to
// rounding, not bit for bit; they do not depend on the order in which the
// card runs the adds.
#include "common.cuh"

#include <atomic>

namespace {

constexpr int ROWS = 32;                  // theta rows per block, one a lane
constexpr int WARPS = 16;
constexpr int BATCH = 4;                  // points a warp has in flight
constexpr int THREADS = ROWS * WARPS;
constexpr int PAD = ROWS + 1;             // transpose scratch row stride
constexpr int OUT_WARPS = 8;              // warps that transpose the rows
constexpr int TILE_BYTES = OUT_WARPS * ROWS * PAD * 4;   // 33,792 B
constexpr int TILE_POINTS = TILE_BYTES / 16;           // (x, y, w, -)
constexpr int MAX_BINS = 768;
constexpr int MAX_SMEM = TILE_BYTES + MAX_BINS * ROWS * 8;  // 230,400 B

__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(gmem));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Start copying points [t0, t0 + n) into the tile as (x, y, w, -).
__device__ __forceinline__ void stage(float4* tile, const float* pts,
                                      const float* wts, int t0, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    cp_async(&tile[i], pts + 2 * (size_t)(t0 + i), 8);
    cp_async(reinterpret_cast<float*>(&tile[i]) + 2, wts + t0 + i, 4);
  }
}

// The fixed-point scale of a block whose |weights| sum to `mass`: the
// largest power of two 2^e with mass * 2^e <= 2^62 (e at most 126).
__device__ __forceinline__ float scale_for(float mass) {
  if (!(mass > 0.0f) || isinf(mass)) return 1.0f;
  const int e = max(-126, min(126, (int)floorf(62.0f - log2f(mass))));
  return __int_as_float((e + 127) << 23);
}

__global__ void __launch_bounds__(THREADS, 2)
    hough_kernel(const float* __restrict__ pts, const float* __restrict__ wts,
                 const float* __restrict__ trig, float* __restrict__ out,
                 int k, int n_theta, int n_rho, int n_groups, int chunk,
                 size_t split_stride, float rho_max, float rho_scale,
                 float pos_hi) {
  extern __shared__ float4 smem[];
  __shared__ float warp_mass[WARPS];
  float4* tile = smem;                                    // TILE_BYTES
  unsigned long long* acc =                               // acc[bin][row]
      reinterpret_cast<unsigned long long*>(smem) + TILE_BYTES / 8;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int group = blockIdx.x % n_groups;
  const int split = blockIdx.x / n_groups;
  const size_t f = blockIdx.y;
  const int n_bins = (n_rho + 31) & ~31;
  const int row = group * ROWS + lane;
  const float c = row < n_theta ? trig[2 * row] : 0.0f;
  const float s = row < n_theta ? trig[2 * row + 1] : 0.0f;
  pts += f * 2 * k;
  wts += f * k;
  const int p0 = split * chunk;
  const int p1 = min(k, p0 + chunk);

  // The first tile's copy is in flight while the block zeroes its rows
  // and sums its weight mass.
  stage(tile, pts, wts, p0, min(TILE_POINTS, p1 - p0));
  for (int i = threadIdx.x; i < n_bins * ROWS / 2; i += THREADS)
    reinterpret_cast<int4*>(acc)[i] = make_int4(0, 0, 0, 0);
  float mass = 0.0f;
  for (int i = p0 + threadIdx.x; i < p1; i += THREADS) mass += fabsf(wts[i]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mass += __shfl_xor_sync(~0u, mass, o);
  if (lane == 0) warp_mass[warp] = mass;
  __syncthreads();
  mass = 0.0f;
#pragma unroll
  for (int i = 0; i < WARPS; ++i) mass += warp_mass[i];
  const float scale = scale_for(mass);

  for (int t0 = p0; t0 < p1; t0 += TILE_POINTS) {
    const int n = min(TILE_POINTS, p1 - t0);
    if (t0 != p0) {
      __syncthreads();                    // the previous tile is consumed
      stage(tile, pts, wts, t0, n);
    }
    cp_async_wait_all();
    __syncthreads();
    for (int i = warp; i < n; i += WARPS * BATCH) {
      // BATCH points read before any add: the compiler may not move a
      // tile read past an add to the same shared array.
      float4 p[BATCH];
#pragma unroll
      for (int q = 0; q < BATCH; ++q)
        p[q] = i + q * WARPS < n ? tile[i + q * WARPS]
                                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int q = 0; q < BATCH; ++q) {
        if (p[q].z == 0.0f) continue;
        const float rho = p[q].x * c + p[q].y * s;
        const float pos =
            fminf(fmaxf((rho + rho_max) * rho_scale, 0.0f), pos_hi);
        const float lo = floorf(pos);
        const float frac = pos - lo;
        const float ws = p[q].z * scale;  // exact: scale is a power of two
        const int at = (int)lo * ROWS + lane;
        // Two's complement: a negative vote adds as its unsigned image.
        atomicAdd(&acc[at],
                  (unsigned long long)__float2ll_rn((1.0f - frac) * ws));
        atomicAdd(&acc[at + ROWS],
                  (unsigned long long)__float2ll_rn(frac * ws));
      }
    }
  }
  __syncthreads();
  if (warp >= OUT_WARPS) return;

  // 32-bin slices: lane = row into the padded scratch (in the tile's
  // space), then lane = bin out of it, one coalesced row segment at a time.
  const float unscale = 1.0f / scale;    // a power of two: exact
  float* scratch = reinterpret_cast<float*>(tile) + warp * ROWS * PAD;
  float* o = out + split * split_stride +
             (f * n_theta + (size_t)group * ROWS) * n_rho;
  const int rows_here = min(ROWS, n_theta - group * ROWS);
  for (int r0 = warp * 32; r0 < n_rho; r0 += OUT_WARPS * 32) {
#pragma unroll 8
    for (int j = 0; j < 32; ++j)
      scratch[lane * PAD + j] =
          __ll2float_rn((long long)acc[(r0 + j) * ROWS + lane]) * unscale;
    __syncwarp();
    const int r = r0 + lane;
    if (r < n_rho) {
#pragma unroll 4
      for (int j = 0; j < rows_here; ++j)
        o[(size_t)j * n_rho + r] = scratch[j * PAD + lane];
    }
    __syncwarp();
  }
}

// out = the sum over splits of the `splits` partial outputs of n floats,
// in split order: one float4 a thread where n is a multiple of 4 (so
// every partial output stays 16-byte aligned), else one float.
template <typename T>
__global__ void hough_sum(const T* __restrict__ partial, T* __restrict__ out,
                          size_t n, int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  T acc = partial[i];
  for (int s = 1; s < splits; ++s) {
    const T v = partial[s * n + i];
    if constexpr (sizeof(T) == sizeof(float)) {
      acc += v;
    } else {
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
  }
  out[i] = acc;
}

}  // namespace

CAMKIFU_API int camkifu_hough(const void* pts, const void* wts,
                              const void* trig, void* out, void* partial,
                              int b, int k, int n_theta, int n_rho,
                              int splits, float rho_max, float rho_scale,
                              float pos_hi, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t n = (size_t)b * n_theta * n_rho;
  if (k == 0) return (int)cudaMemsetAsync(out, 0, n * sizeof(float), st);
  // `partial` has room for `splits` outputs (16-byte aligned) when
  // splits > 1.
  splits = max(1, min(splits, k));
  const int chunk = (k + splits - 1) / splits;
  splits = (k + chunk - 1) / chunk;
  const int n_groups = (n_theta + ROWS - 1) / ROWS;
  const int n_bins = (n_rho + 31) & ~31;
  if (n_bins > MAX_BINS) return (int)cudaErrorInvalidValue;
  const int smem = TILE_BYTES + n_bins * ROWS * 8;
  // Opt in to the largest n_rho's shared memory once per device.
  static std::atomic<unsigned long long> opted{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(opted.load() & bit)) {
    err = cudaFuncSetAttribute(
        hough_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return (int)err;
    opted.fetch_or(bit);
  }
  const dim3 grid(n_groups * splits, b);
  hough_kernel<<<grid, THREADS, smem, st>>>(
      (const float*)pts, (const float*)wts, (const float*)trig,
      (float*)(splits > 1 ? partial : out), k, n_theta, n_rho, n_groups,
      chunk, splits > 1 ? n : 0, rho_max, rho_scale, pos_hi);
  if (splits > 1) {
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (n % 4 == 0)
      hough_sum<<<(unsigned)((n / 4 + 255) / 256), 256, 0, st>>>(
          (const float4*)partial, (float4*)out, n / 4, splits);
    else
      hough_sum<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
          (const float*)partial, (float*)out, n, splits);
  }
  return (int)cudaGetLastError();
}
