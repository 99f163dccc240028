// Edge hysteresis on float32 (N, H, W) magnitude maps: double threshold,
// then `iters` steps of 8-neighbour dilation of the strong pixels inside
// the weak ones; the output keeps a pixel's magnitude where it is strong or
// was reached, and is 0.0 elsewhere. Neighbours wrap around the image, as
// torch.roll's and jnp.roll's do. In its adaptive entry the thresholds are
// fractions of each map's own q-th percentile (linear interpolation, as
// torch.quantile computes it) of the map's 2x-strided view (even rows, even
// columns), selected in the same launch.
//
// It replaces no Pallas kernel: camkifu_tpu/ops/edges.py:50 hysteresis and
// the strided jnp.percentile before it (:104-105, :133-136) are plain array
// code that XLA fuses. Eager PyTorch runs the percentile as a strided copy,
// a sort and some thirty small launches, and each dilation step as 18.
//
// What bounds it: the maps read once and written once, 8 bytes a pixel
// (0.020 ms for 128 maps of 256x256 on an H100). The paths give it 2 to
// 16 maps, where one wave of small blocks pays the launch, a round trip to
// device memory and a chain of exchanges between blocks: that latency is
// the cost, and the design keeps the chain short.
//
// Design: one thread-block cluster of CLUSTER blocks a map. Block b owns a
// band of `band` rows (an even number, so every band starts on an even
// row) across the whole width; a block past the map's last row takes part
// in the select and does nothing else.
// - Exchanges: blocks hand each other data only by st.async stores into
//   the receiver's shared memory, each signalling the receiver's mbarrier
//   with its bytes; the receiver waits for the bytes it expects. On an H100
//   an exchange of 16 bytes a pair costs ~0.27 us at 512 threads where a
//   cluster barrier, with the release and acquire the data needs, costs
//   ~0.71 us (tools/cluster_exchange.py).
//   The select's exchanges alternate between two buffers and two
//   mbarriers, and a block fills a buffer again only after the receiver has
//   answered the exchange in between, so no buffer is written while it is
//   read. No block exits before every block has all it was sent (a relaxed
//   cluster barrier).
// - Load: one bulk copy (cp.async.bulk, the TMA's 1-D form) brings the
//   block's band into shared memory, where it stays for the select, the
//   flags and the store; code that runs once a block is kept to short
//   loops, since a block fetches it cold.
// - Select (adaptive entry): a radix select over the cluster, 8 bits a
//   round, of both order statistics torch.quantile interpolates between,
//   floor(rank) and ceil(rank). Each round a block counts its keys under a
//   target's prefix into a 256-bin histogram (each thread on its own; the
//   keys of +0.0, most of an edge map, summed over the warp first), pushes
//   it to every block of the cluster, and sums the CLUSTER histograms it
//   receives to find the bin that holds each target. After two rounds, if
//   at most CAP keys lie under the two 16-bit prefixes, every block pushes
//   its own to every block, and each block finishes the select alone over
//   that list; else two more rounds. Any NaN in the view makes the
//   thresholds NaN, and every comparison then fails (torch.quantile sorts
//   NaN last and moves the rank to the last index). The interpolation is
//   ATen's lerp, both branches, each product fused into its sum: on an H100
//   torch.lerp differs from the unfused form on ~21% of triples.
// - Flags: each thread packs a word of a band row's weak and strong flags,
//   32 pixels to a word, in shared memory.
// - Dilate: the blocks that hold the `iters` rows above a band and the
//   `iters` rows below it push those rows' weak and strong flags into the
//   band's block once (the rows above row 0 are the map's last rows), so
//   rows wrap exactly and nothing is read again from device memory; then
//   `iters` steps inside the block, one thread a word, three shifted ORs
//   of three rows masked by the weak word, columns wrapping inside the row
//   a block holds whole. One exchange instead of one a step, since a step
//   inside the block costs less than an exchange's wait
//   (tools/hysteresis_phases.py).
// - Store: each thread writes its pixels' magnitude or 0.0 over the band in
//   shared memory, and one bulk copy stores the band; the maps cross device
//   memory once each way. (Rows whose bytes are not a multiple of 16 are
//   loaded and stored by plain loops instead.)
#include "common.cuh"

#include <atomic>
#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr int CLUSTER = 8;             // blocks a map: the portable size
constexpr int WARPS = 16;
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_ITERS = 8;
constexpr int BINS = 256;              // a select round takes 8 bits
constexpr int ROUNDS = 4;
constexpr int SLOT = BINS + 4;         // a pushed histogram: bins, NaN flag
constexpr int SLOT_V4 = SLOT / 4;
// Keys under the two targets' 16-bit prefixes that the select gathers in
// every block, at most, to finish there (else it runs two more rounds).
constexpr int CAP = 256;
// Dynamic shared memory a block may take: Hopper's 227 KB less this
// file's static arrays (about 6 KB) and a margin.
constexpr int MAX_DYNAMIC = 232448 - 8192;
constexpr unsigned FULL = 0xffffffffu;

// ATen's lerp with the card's rounding: both products are fused into
// their sums, as nvcc contracts ATen's expressions (LERP_FUSED; the gpu
// test and chip_smoke.py sweep it against torch.lerp on the card).
constexpr bool LERP_FUSED = true;

static_assert(THREADS == 2 * BINS, "a thread a (target, bin) when summing");
static_assert(WARPS == 2 * CLUSTER, "a warp a (band, side) when pushing rows");
static_assert(SLOT % 4 == 0, "histograms pushed 16 bytes at a time");

template <bool FUSED>
__device__ __forceinline__ float lerp_aten(float s, float e, float w) {
  const float d = __fsub_rn(e, s);
  if (fabsf(w) < 0.5f)
    return FUSED ? __fmaf_rn(w, d, s) : __fadd_rn(s, __fmul_rn(w, d));
  const float u = __fsub_rn(1.0f, w);
  return FUSED ? __fmaf_rn(-d, u, e) : __fsub_rn(e, __fmul_rn(d, u));
}

// Order-preserving keys: a < b as floats iff key(a) < key(b) (-0.0 just
// below +0.0, which compare equal and so select alike).
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned b = __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// Shared-memory addresses, mbarriers and st.async (PTX for sm_90).
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ unsigned in_block(unsigned addr, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void bar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(bar)
               : "memory");
}

__device__ __forceinline__ void bar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Waits for the phase `parity` of an mbarrier that other blocks' st.async
// (or this block's bulk copy) complete.
__device__ __forceinline__ void bar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.acquire.cluster.shared::cta"
        ".b64 p, [%1], %2; selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
}

__device__ __forceinline__ void push1(unsigned to, unsigned v,
                                      unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];" :: "r"(to), "r"(v), "r"(bar) : "memory");
}

__device__ __forceinline__ void push4(unsigned to, uint4 v, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];"
      :: "r"(to), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar)
      : "memory");
}

// Word `k` of a row of reach flags, dilated along the row; the row holds
// `w` columns in `kw` words and wraps.
__device__ __forceinline__ unsigned spread(const unsigned* row, int k,
                                           int kw, int w) {
  const unsigned x = row[k];
  const unsigned left = k > 0 ? row[k - 1] >> 31
                              : (row[(w - 1) >> 5] >> ((w - 1) & 31)) & 1u;
  const unsigned right = k + 1 < kw ? row[k + 1] << 31
                                    : (row[0] & 1u) << ((w - 1) & 31);
  return x | (x << 1) | left | (x >> 1) | right;
}

__device__ __forceinline__ void load_band(unsigned to, const float* from,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(to), "l"(from), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void store_band(float* to, unsigned from,
                                           unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               :: "l"(to), "r"(from), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// Shared memory a block takes beyond its static arrays: its band's
// magnitudes; weak flags and two buffers of reach flags for the band and
// `iters` rows on each side of it (`kw` words a row); in the adaptive entry
// two buffers of the cluster's histograms.
__host__ __device__ inline long dynamic_bytes(int band, int w, int iters,
                                              bool adaptive) {
  const long kw = (w + 31) / 32;
  const long words = (long)band * w + 3L * (band + 2 * iters) * kw +
                     (adaptive ? 2L * CLUSTER * 2 * SLOT : 0);
  return 4 * words;
}

__host__ __device__ inline int band_rows(int h) {
  return ((h + CLUSTER - 1) / CLUSTER + 1) & ~1;
}

// A walk over (row, column) pairs of a row-major grid `n` columns wide,
// `stride` pairs a step, without a division a step.
struct Walk {
  int i, k, di, dk;
  __device__ Walk(int p, int stride, int n)
      : i(p / n), k(p % n), di(stride / n), dk(stride % n) {}
  __device__ __forceinline__ void next(int n) {
    i += di;
    k += dk;
    if (k >= n) {
      k -= n;
      ++i;
    }
  }
};

template <bool ADAPTIVE>
__global__ void __launch_bounds__(THREADS, 2)
hysteresis_kernel(const float* __restrict__ mag, float* __restrict__ out,
                  int h, int w, int band, const float* __restrict__ low_ptr,
                  const float* __restrict__ high_ptr, float low_val,
                  float high_val, float q, int iters, bool bulk) {
  extern __shared__ __align__(16) unsigned smem[];
  // This block's counts: [round & 1][target][bin], the NaN flag beside.
  __shared__ __align__(16) unsigned s_hist[2][2][SLOT];
  __shared__ unsigned s_pref[2], s_below[2], s_cnt[2], s_ncand[2];
  __shared__ unsigned s_lh[2][BINS];         // a warp's own histogram
  __shared__ int s_any_nan;
  // mbarriers: the histograms' two buffers, the rows pushed in, the load.
  __shared__ __align__(8) unsigned long long s_bar[4];

  const int rank = (int)cg::this_cluster().block_rank();
  const int img = blockIdx.x / CLUSTER;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kw = (w + 31) >> 5;
  const int r0 = rank * band;
  const int rows = max(0, min(band, h - r0));
  const int words = rows * kw;
  const int ext = rows + 2 * iters;          // rows of flags
  const int plane = (band + 2 * iters) * kw;
  const int pixels = rows * w;
  const size_t first = (size_t)img * h * w + (size_t)r0 * w;
  const bool vec = (w & 3) == 0;             // float4 rows in shared memory
  // A thread's walk over the band's words, its divisions done once: code
  // that a block runs once is fetched cold, so it is kept short.
  const Walk words_walk(tid, THREADS, kw);
  // The histograms first (16-byte pushes), then the band, its flags and
  // the rows pushed in.
  unsigned* slots = smem;                    // [2][CLUSTER][2][SLOT]
  float* m = reinterpret_cast<float*>(ADAPTIVE ? slots + 2 * CLUSTER * 2 * SLOT
                                               : smem);   // [band][w]
  // Flags for the band and `iters` rows on each side of it, extended row
  // e holding map row r0 - iters + e (the rows below the band start right
  // after its last row).
  unsigned* weak = reinterpret_cast<unsigned*>(m) + band * w;  // [ext][kw]
  unsigned* reach = weak + plane;            // [2][ext][kw]

  // mbarriers before any thread waits on one (this block's barrier) and
  // before any block may push into this one (a cluster barrier whose wait
  // comes later). The band's bulk load starts at once.
  const unsigned load_bar = smem_u32(&s_bar[3]);
  if (tid == 0) {
    for (int b = 0; b < 4; ++b) bar_init(smem_u32(&s_bar[b]));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (bulk && pixels) {
      bar_expect(load_bar, 4 * pixels);
      load_band(smem_u32(m), mag + first, 4 * pixels, load_bar);
    }
  }
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  if (!bulk)
    for (int x = tid; x < pixels; x += THREADS) m[x] = __ldg(mag + first + x);
  __syncthreads();
  if (bulk && pixels) bar_wait(load_bar, 0);

  float low, high;
  if constexpr (ADAPTIVE) {
    for (int i = tid; i < 2 * SLOT; i += THREADS) (&s_hist[0][0][0])[i] = 0u;
    if (tid < 2) s_ncand[tid] = 0u;
    // Both order statistics of torch.quantile's rank, as it computes them.
    const int kcols = (w + 1) >> 1;
    const long nv = (long)((h + 1) / 2) * kcols;
    const float rank_f = __fmul_rn(q, (float)(nv - 1));
    const long lo = (long)rank_f;
    const float weight = __fsub_rn(rank_f, (float)lo);
    const unsigned target0 = (unsigned)lo;
    const unsigned target1 = (unsigned)(long)ceilf(rank_f);
    unsigned pref0 = 0u, pref1 = 0u, below0 = 0u, below1 = 0u;
    // `fn` on every value of the band's even rows and columns: two a
    // float4 where rows are 16-byte aligned, else one.
    const int per_row = vec ? w >> 2 : kcols;   // key items a row
    const Walk keys_walk(tid, THREADS, per_row);
    auto for_keys = [&](auto&& fn) {
      if (vec) {
        const int items = ((rows + 1) >> 1) * per_row;
        Walk a = keys_walk;
#pragma unroll 1
        for (int x = tid; x < items; x += THREADS) {
          const float4 v =
              reinterpret_cast<const float4*>(m + 2 * a.i * w)[a.k];
          fn(v.x);
          fn(v.z);
          a.next(per_row);
        }
      } else {
        const int items = ((rows + 1) >> 1) * per_row;
        Walk a = keys_walk;
#pragma unroll 1
        for (int x = tid; x < items; x += THREADS) {
          fn(m[2 * (a.i * w + a.k)]);
          a.next(per_row);
        }
      }
    };
    __syncthreads();
    asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
    // Every block's keys under each target's 16-bit prefix into every
    // block's list for it (`split`: the second round counted the targets
    // apart), in the order of the blocks; slot buffer 0 is free by then.
    unsigned* cand = slots;                  // [2][CAP]
    auto gather = [&](bool split, bool split1, unsigned p0, unsigned p1,
                      unsigned total) {
      const unsigned* counts = slots + CLUSTER * 2 * SLOT;   // round 1's
      unsigned off[2] = {0u, 0u};
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const unsigned bin = ((t ? p1 : p0) >> 16) & 0xffu;
        const int from = split ? t : 0;
        for (int k = 0; k < rank; ++k)
          off[t] += counts[(k * 2 + from) * SLOT + bin];
      }
      const unsigned bar = smem_u32(&s_bar[0]);
      for_keys([&](float v) {
        const unsigned key = order_key(v);
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          if (t && !split1) break;
          if ((key & 0xffff0000u) != (t ? p1 : p0)) continue;
          const unsigned at = off[t] + atomicAdd(&s_ncand[t], 1u);
          const unsigned to = smem_u32(cand + t * CAP + at);
#pragma unroll 1
          for (int q = 0; q < CLUSTER; ++q)
            push1(in_block(to, q), key, in_block(bar, q));
        }
      });
      if (tid == 0) bar_expect(bar, 4 * total);
      if (warp < 2) bar_wait(bar, 1);        // the barrier's second phase
    };
    // Warp t selects its target's key from its list of `n` keys, 8 bits at
    // a time: the key of rank `k` in the list, under the 16-bit prefix.
    auto finish = [&](bool split1, unsigned n0, unsigned n1, unsigned k0,
                      unsigned k1, unsigned p0, unsigned p1) {
      if (warp >= 2) return;
      const int t = warp;
      const unsigned* list = cand + (split1 ? t : 0) * CAP;
      const unsigned n = t ? n1 : n0, k = t ? k1 : k0;
      unsigned pre = t ? p1 : p0, below = 0u;
      unsigned* lh = s_lh[t];
#pragma unroll 1
      for (int rr = 0; rr < 2; ++rr) {
        const int sh = 8 - 8 * rr;
        const unsigned msk = rr ? 0xffffff00u : 0xffff0000u;
        for (int b2 = lane; b2 < BINS; b2 += 32) lh[b2] = 0u;
        __syncwarp();
        for (unsigned i = lane; i < n; i += 32) {
          const unsigned key = list[i];
          if ((key & msk) == pre) atomicAdd(&lh[(key >> sh) & 0xffu], 1u);
        }
        __syncwarp();
        unsigned c[8], sum = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          c[j] = lh[8 * lane + j];
          sum += c[j];
        }
        unsigned incl = sum;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const unsigned y = __shfl_up_sync(FULL, incl, o);
          if (lane >= o) incl += y;
        }
        unsigned acc = below + incl - sum, hit_bin = 0u, hit_below = 0u;
        bool hit = false;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (acc <= k && k - acc < c[j]) {
            hit = true;
            hit_bin = 8 * lane + j;
            hit_below = acc;
          }
          acc += c[j];
        }
        const int src = __ffs(__ballot_sync(FULL, hit)) - 1;
        pre |= __shfl_sync(FULL, hit_bin, src) << sh;
        below = __shfl_sync(FULL, hit_below, src);
        __syncwarp();
      }
      if (lane == 0) s_pref[t] = pre;
    };
#pragma unroll 1
    for (int r = 0; r < ROUNDS; ++r) {
      const int shift = 24 - 8 * r;
      const unsigned mask = r ? ~0u << (shift + 8) : 0u;
      const bool split = pref0 != pref1;     // the same in every block
      const int b = r & 1;
      unsigned (*hist)[SLOT] = s_hist[b];
      // The next round's counts start from 0 (the pushes of the round
      // before this one, their last readers, are done).
      s_hist[b ^ 1][tid / BINS][tid % BINS] = 0u;
      // This block's counts of the keys under each target's prefix, each
      // thread on its own: the keys of +0.0 (most of an edge map) are
      // summed over the warp and added once, the others one by one.
      const unsigned zero_bin = (0x80000000u >> shift) & 0xffu;
      int nan = 0, zeros0 = 0, zeros1 = 0;
      auto count = [&](float v) {
        nan |= v != v;
        const unsigned key = order_key(v);
        const unsigned bin = (key >> shift) & 0xffu;
        if ((key & mask) == pref0) {
          if (key == 0x80000000u) ++zeros0;
          else atomicAdd(&hist[0][bin], 1u);
        }
        if (split && (key & mask) == pref1) {
          if (key == 0x80000000u) ++zeros1;
          else atomicAdd(&hist[1][bin], 1u);
        }
      };
      for_keys(count);
#pragma unroll
      for (int o = 16; o; o >>= 1)
        zeros0 += __shfl_xor_sync(FULL, zeros0, o);
      if (lane == 0 && zeros0) atomicAdd(&hist[0][zero_bin], (unsigned)zeros0);
      if (split) {
#pragma unroll
        for (int o = 16; o; o >>= 1)
          zeros1 += __shfl_xor_sync(FULL, zeros1, o);
        if (lane == 0 && zeros1)
          atomicAdd(&hist[1][zero_bin], (unsigned)zeros1);
      }
      if (r == 0 && nan) atomicOr(&hist[0][BINS], 1u);   // read in round 0
      __syncthreads();
      // Pushed to every block's slot for this block, [target][block][16
      // bytes] over the threads.
      const unsigned bar = smem_u32(&s_bar[b]);
      unsigned* slot = slots + b * CLUSTER * 2 * SLOT;
      for (int i = tid; i < (split ? 2 : 1) * CLUSTER * SLOT_V4;
           i += THREADS) {
        const int t = i / (CLUSTER * SLOT_V4), v = i % (CLUSTER * SLOT_V4);
        const int to = v / SLOT_V4, x = 4 * (v % SLOT_V4);
        const uint4 val = *reinterpret_cast<const uint4*>(&hist[t][x]);
        push4(in_block(smem_u32(slot + (rank * 2 + t) * SLOT + x), to), val,
              in_block(bar, to));
      }
      if (warp < 2) {
        // Warp t sums target t's histograms and finds its bin: a lane takes
        // 8 bins, the warp scans the lanes' sums.
        if (tid == 0) bar_expect(bar, (split ? 2 : 1) * CLUSTER * SLOT * 4);
        bar_wait(bar, (r >> 1) & 1);
        const int t = warp, from = split ? t : 0;
        unsigned c[8], sum = 0;
#pragma unroll
        for (int k = 0; k < 8; ++k) c[k] = 0;
#pragma unroll
        for (int s2 = 0; s2 < CLUSTER; ++s2) {
          const uint4* src4 = reinterpret_cast<const uint4*>(
              slot + (s2 * 2 + from) * SLOT + 8 * lane);
          const uint4 lo4 = src4[0], hi4 = src4[1];
          c[0] += lo4.x; c[1] += lo4.y; c[2] += lo4.z; c[3] += lo4.w;
          c[4] += hi4.x; c[5] += hi4.y; c[6] += hi4.z; c[7] += hi4.w;
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) sum += c[k];
        if (r == 0 && tid == 0) {
          int any = 0;
#pragma unroll
          for (int s2 = 0; s2 < CLUSTER; ++s2)
            any |= slot[s2 * 2 * SLOT + BINS];
          s_any_nan = any;
        }
        unsigned incl = sum;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const unsigned y = __shfl_up_sync(FULL, incl, o);
          if (lane >= o) incl += y;
        }
        const unsigned tgt = t ? target1 : target0;
        unsigned acc = (t ? below1 : below0) + incl - sum;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          if (acc <= tgt && tgt - acc < c[k]) {
            s_pref[t] =
                (t ? pref1 : pref0) | ((unsigned)(8 * lane + k) << shift);
            s_below[t] = acc;
            s_cnt[t] = c[k];
          }
          acc += c[k];
        }
      }
      __syncthreads();
      pref0 = s_pref[0];
      pref1 = s_pref[1];
      below0 = s_below[0];
      below1 = s_below[1];
      if (r == 1) {
        // With 16 bits of each target known, the keys under them, if few,
        // go to every block, which finishes the select alone.
        const bool split1 = pref0 != pref1;
        const unsigned n0 = s_cnt[0], n1 = split1 ? s_cnt[1] : 0u;
        if (n0 + n1 <= CAP) {
          gather(split, split1, pref0, pref1, n0 + n1);
          finish(split1, n0, split1 ? n1 : n0, target0 - below0,
                 target1 - below1, pref0, pref1);
          __syncthreads();
          pref0 = s_pref[0];
          pref1 = s_pref[1];
          break;
        }
      }
    }
    const float ref =
        s_any_nan ? __uint_as_float(0x7fc00000u)
                  : lerp_aten<LERP_FUSED>(key_value(pref0), key_value(pref1),
                                          weight);
    low = __fmul_rn(low_val, ref);
    high = __fmul_rn(high_val, ref);
  } else {
    low = low_ptr ? low_ptr[img] : low_val;
    high = high_ptr ? high_ptr[img] : high_val;
    asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  }

  // Flags: a band row's weak and strong pixels, 32 to a word, a thread a
  // word (its float4s taken in a lane's own order, so that a quarter warp
  // reads eight bank groups): first the `iters` rows at either end of the
  // band, which other blocks wait for, then the rest while they travel.
  const unsigned rot = lane & 7;
  auto put_flags = [&](bool ends) {
    Walk a = words_walk;
#pragma unroll 1
    for (int p = tid; p < words; p += THREADS, a.next(kw)) {
      if ((a.i < iters || a.i >= rows - iters) != ends) continue;
      const float* row = m + a.i * w + 32 * a.k;
      const int n = min(32, w - 32 * a.k);
      unsigned wk = 0, st = 0;
      if (vec && n == 32) {
#pragma unroll 2
        for (int j = 0; j < 8; ++j) {
          const unsigned jj = (j + rot) & 7;
          const float4 v = reinterpret_cast<const float4*>(row)[jj];
          wk |= ((unsigned)(v.x >= low) | (unsigned)(v.y >= low) << 1 |
                 (unsigned)(v.z >= low) << 2 | (unsigned)(v.w >= low) << 3)
                << (4 * jj);
          st |= ((unsigned)(v.x >= high) | (unsigned)(v.y >= high) << 1 |
                 (unsigned)(v.z >= high) << 2 | (unsigned)(v.w >= high) << 3)
                << (4 * jj);
        }
      } else {
        for (int c = 0; c < n; ++c) {
          wk |= (unsigned)(row[c] >= low) << c;
          st |= (unsigned)(row[c] >= high) << c;
        }
      }
      weak[iters * kw + p] = wk;
      reach[iters * kw + p] = st;
    }
  };
  put_flags(true);
  __syncthreads();

  // The `iters` rows of flags on each side of every band, pushed by the
  // blocks that hold them (rows wrap around the map), weak and strong:
  // warp 2 q + side takes band q's rows above (side 0) or below it. (A
  // band's rows within `iters` of another band's are rows at its own ends,
  // or it has no others.)
  const unsigned halo_bar = smem_u32(&s_bar[2]);
  {
    const int q = warp >> 1, side = warp & 1;
    const int q0 = q * band, q_rows = max(0, min(band, h - q0));
    const unsigned to_bar = in_block(halo_bar, q);
#pragma unroll 1
    for (int j = 0; j < iters && q_rows > 0; ++j) {
      const int e = side ? iters + q_rows + j : j;  // its extended row
      int y = q0 - iters + e;
      while (y < 0) y += h;
      while (y >= h) y -= h;
      if (y < r0 || y >= r0 + rows) continue;       // the same for a warp
      const unsigned to_weak = in_block(smem_u32(weak + e * kw), q);
      const unsigned to_reach = in_block(smem_u32(reach + e * kw), q);
      const int li = iters + y - r0;
      for (int k = lane; k < kw; k += 32) {
        push1(to_weak + 4 * k, weak[li * kw + k], to_bar);
        push1(to_reach + 4 * k, reach[li * kw + k], to_bar);
      }
    }
  }
  put_flags(false);
  if (iters > 0 && rows > 0) {
    if (tid == 0) bar_expect(halo_bar, 2 * iters * 2 * kw * 4);
    bar_wait(halo_bar, 0);
  }
  __syncthreads();

  // `iters` dilations of the extended rows, one thread a word, from buffer
  // to buffer; step t need not redo the t + 1 rows at either end, which
  // cannot reach the band in the steps left.
#pragma unroll 1
  for (int t = 0; t < iters; ++t) {
    const unsigned* rc = reach + (t & 1) * plane;
    unsigned* rn = reach + ((t & 1) ^ 1) * plane;
    const int lo_row = t + 1, hi_row = ext - t - 1;
    Walk a = words_walk;
    a.i += lo_row;
#pragma unroll 1
    for (int p = lo_row * kw + tid; p < hi_row * kw; p += THREADS) {
      const unsigned* row = rc + a.i * kw;
      rn[p] = (spread(row - kw, a.k, kw, w) | spread(row, a.k, kw, w) |
               spread(row + kw, a.k, kw, w)) & weak[p];
      a.next(kw);
    }
    __syncthreads();
  }

  // This block reads no other block's data after this; no block exits
  // before every block has got all that was pushed to it.
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");

  // Store: the magnitude where reached or strong, else 0.0, written over
  // the band in shared memory, a thread a word, then the band in one bulk
  // copy.
  const unsigned* rf = reach + (iters & 1) * plane + iters * kw;
  {
    Walk a = words_walk;
#pragma unroll 1
    for (int p = tid; p < words; p += THREADS) {
      float* row = m + a.i * w + 32 * a.k;
      const int n = min(32, w - 32 * a.k);
      const unsigned hit = rf[p];
      if (vec && n == 32) {
#pragma unroll 2
        for (int j = 0; j < 8; ++j) {
          const unsigned jj = (j + rot) & 7;
          float4 v = reinterpret_cast<float4*>(row)[jj];
          const unsigned b = hit >> (4 * jj);
          v.x = (b & 1u) || v.x >= high ? v.x : 0.0f;
          v.y = (b & 2u) || v.y >= high ? v.y : 0.0f;
          v.z = (b & 4u) || v.z >= high ? v.z : 0.0f;
          v.w = (b & 8u) || v.w >= high ? v.w : 0.0f;
          reinterpret_cast<float4*>(row)[jj] = v;
        }
      } else {
        for (int c = 0; c < n; ++c)
          row[c] = ((hit >> c) & 1u) || row[c] >= high ? row[c] : 0.0f;
      }
      a.next(kw);
    }
  }
  if (bulk) {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (tid == 0 && pixels) store_band(out + first, smem_u32(m), 4 * pixels);
  } else {
    __syncthreads();
    for (int x = tid; x < pixels; x += THREADS) out[first + x] = m[x];
  }
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

__global__ void lerp_probe_kernel(const float* __restrict__ s,
                                  const float* __restrict__ e,
                                  const float* __restrict__ w,
                                  float* __restrict__ out, int n, int form) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = form == 0   ? lerp_aten<LERP_FUSED>(s[i], e[i], w[i])
           : form == 1 ? lerp_aten<true>(s[i], e[i], w[i])
                       : lerp_aten<false>(s[i], e[i], w[i]);
}

template <bool ADAPTIVE>
int launch(const void* mag, void* out, int n, int h, int w, const void* low,
           const void* high, float low_val, float high_val, float q,
           int iters, void* stream) {
  if (iters < 0 || iters > MAX_ITERS || n < 0 || h < 1 || w < 1 ||
      (long)n * CLUSTER > 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
  const int band = band_rows(h);
  const long smem = dynamic_bytes(band, w, iters, ADAPTIVE);
  if (smem > MAX_DYNAMIC) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  // Opt in to the largest dynamic shared memory once per device.
  static std::atomic<unsigned long long> opted{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(opted.load() & bit)) {
    err = cudaFuncSetAttribute(hysteresis_kernel<ADAPTIVE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               MAX_DYNAMIC);
    if (err != cudaSuccess) return (int)err;
    opted.fetch_or(bit);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(n * CLUSTER));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = CLUSTER;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  // Whole-band bulk copies need 16-byte aligned rows, as the paths' maps
  // have.
  const bool bulk = w % 4 == 0 && (uintptr_t)mag % 16 == 0 &&
                    (uintptr_t)out % 16 == 0;
  return (int)cudaLaunchKernelEx(&cfg, hysteresis_kernel<ADAPTIVE>,
                                 (const float*)mag, (float*)out, h, w, band,
                                 (const float*)low, (const float*)high,
                                 low_val, high_val, q, iters, bulk);
}

}  // namespace

// Dynamic shared memory a block of the (h, w) maps' cluster takes, or -1
// past what a block may take (the wrapper refuses such maps).
CAMKIFU_API int camkifu_hysteresis_smem(int h, int w, int adaptive) {
  if (h < 1 || w < 1) return 0;
  const long bytes = dynamic_bytes(band_rows(h), w, MAX_ITERS, adaptive != 0);
  return bytes > MAX_DYNAMIC ? -1 : (int)bytes;
}

// Given thresholds: `low` and `high` are device pointers to one float32
// threshold a map, or both null for the two values passed beside them; at
// most MAX_ITERS steps.
CAMKIFU_API int camkifu_hysteresis(const void* mag, void* out, int n, int h,
                                   int w, const void* low, const void* high,
                                   float low_val, float high_val, int iters,
                                   void* stream) {
  if (!low != !high) return (int)cudaErrorInvalidValue;
  return launch<false>(mag, out, n, h, w, low, high, low_val, high_val, 0.0f,
                       iters, stream);
}

// Adaptive thresholds: `low_frac` and `high_frac` times each map's `q`
// quantile (a fraction in [0, 1]) of its 2x-strided view.
CAMKIFU_API int camkifu_hysteresis_adaptive(const void* mag, void* out,
                                            int n, int h, int w, float q,
                                            float low_frac, float high_frac,
                                            int iters, void* stream) {
  if (!(q >= 0.0f && q <= 1.0f)) return (int)cudaErrorInvalidValue;
  return launch<true>(mag, out, n, h, w, nullptr, nullptr, low_frac,
                      high_frac, q, iters, stream);
}

// The select's interpolation on n (s, e, w) triples: `form` 0 is the
// kernel's own (LERP_FUSED), 1 fused products, 2 separate roundings.
CAMKIFU_API int camkifu_hysteresis_lerp(const void* s, const void* e,
                                        const void* w, void* out, int n,
                                        int form, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  lerp_probe_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const float*)s, (const float*)e, (const float*)w, (float*)out, n,
      form);
  return (int)cudaGetLastError();
}
