// The renderer's sensor noise, drawn on the card exactly as numpy draws it:
// PCG64 words through numpy's ziggurat normal sampler
// (random_standard_normal), then the reference's noise expression on a
// uint8 (H, W, 3) frame (camkifu_tpu/utils/synth.py:322-332):
//
//   shot == 0: out = u8(clip(double(f) + (0.0 + noise * z), 0, 255))
//   shot != 0: out = u8(clip(f + float(z) * sqrt(float(noise^2) + shot * f)))
//              in float32, each product, sum and root rounded on its own.
//
// It replaces no Pallas kernel: the reference draws on the host
// (Generator.normal / standard_normal). Output k of the frame takes the
// k-th normal of the stream that starts at the caller's (state, inc).
//
// The parallel problem: a normal takes a varying number of words (the
// fast path 1; the wedge test 2, and a rejection starts again after them;
// the tail 1 + 2m), so where normal k starts in the word stream depends on
// every earlier rejection. Three launches:
//
// 1. run_tables: the word stream is cut into runs of RUN words, a thread
//    each. A thread jumps its generator to its run's first word (A^k s +
//    P_k inc from the jump table), evaluates the attempt that would start at
//    every word of the run (reading words past the run's end where the
//    attempt needs them), and walks the chain of attempts from each of the
//    first DEPTH words: where it leaves the run (an offset into the next
//    run) and how many normals it gave, a table of DEPTH entries. The warp
//    then composes its 32 runs' tables with shuffles (an inclusive scan of
//    functions): each run gets its prefix, from the warp's entry to its own
//    entry, and the warp its table. An entry at or past DEPTH (a tail that
//    spilled far) cannot be read from a table: it is marked and walked
//    again later from the words themselves.
// 2. scan_warps, one block: the true entry of each warp is the exit of the
//    warp before it. Each thread composes the tables of a chunk of warps,
//    warp 0 composes the chunks, and each thread then walks its chunk from
//    its true entry, writing each warp's entry offset and first output.
// 3. emit_runs, a thread a run: its entry is its warp's, through its
//    prefix; the run draws its normals again and writes its outputs. The
//    last run walks on until the frame is full, so the margin of words can
//    never run out.
//
// What bounds it: the frame read once and written once (2 bytes a value,
// 5.5 MB at 720p: 1.7 us at 3.35 TB/s) against the generator's 128-bit
// multiply-add, 16 32-bit multiply-adds a word, ~1.02 words a normal: 45 M
// at 720p, ~2.7 us at the card's 64 INT32 lanes an SM. So operations bound
// it, and the design draws each word twice (passes 1 and 3) rather than
// store 8 bytes a word. The ziggurat's tables live in shared memory; a
// run's table and prefix are 64 bytes, and the one-block scan reads 32
// bytes a warp of runs. The build keeps --fmad=false and the math library's
// double exp and log1p, as numpy's C code rounds each step on its own.
#include "common.cuh"
#include "ziggurat_tables.cuh"

namespace {

constexpr int RUN = 32;            // words a run
constexpr int DEPTH = 4;           // entry offsets a run's table holds
constexpr int THREADS = 128;       // threads a block, passes 1 and 3
constexpr int SCAN_THREADS = 1024; // the scan's one block
constexpr int LANES = 32;
constexpr unsigned FULL = 0xffffffffu;

struct U128 {
  uint64_t hi, lo;
};

__device__ __forceinline__ U128 mul(U128 a, U128 b) {
  return {__umul64hi(a.lo, b.lo) + a.lo * b.hi + a.hi * b.lo, a.lo * b.lo};
}

__device__ __forceinline__ U128 add(U128 a, U128 b) {
  const uint64_t lo = a.lo + b.lo;
  return {a.hi + b.hi + (lo < a.lo), lo};
}

// numpy's PCG64: step the 128-bit LCG, then XSL-RR of the new state.
struct Pcg {
  U128 s, inc;

  __device__ __forceinline__ uint64_t next() {
    s = add(mul(s, {zig::PCG_MULT_HI, zig::PCG_MULT_LO}), inc);
    const uint64_t x = s.hi ^ s.lo;
    const unsigned rot = (unsigned)(s.hi >> 58);
    return (x >> rot) | (x << ((64u - rot) & 63u));
  }

  __device__ __forceinline__ double next_double() {
    return (double)(next() >> 11) * (1.0 / 9007199254740992.0);
  }
};

// State k words after s: s -> A[i] s + P[i] inc for each set bit i of k;
// cinc[i] = P[i] inc, made once a block.
__device__ U128 jump(U128 s, const U128* cinc, uint64_t k) {
  for (int i = 0; k; ++i, k >>= 1)
    if (k & 1) s = add(mul({zig::JUMP_A[i][0], zig::JUMP_A[i][1]}, s), cinc[i]);
  return s;
}

__device__ void make_cinc(U128 inc, U128* cinc) {
  for (int i = threadIdx.x; i < 64; i += blockDim.x)
    cinc[i] = mul({zig::JUMP_P[i][0], zig::JUMP_P[i][1]}, inc);
}

// One attempt of random_standard_normal, whose first word is w; any further
// words come from g. Returns the words it took; *emit says whether it gave
// a normal (a wedge rejection gives none), *z the normal.
__device__ __forceinline__ int attempt(uint64_t w, Pcg& g, const uint64_t* ki,
                                       const double* wi, double* z,
                                       bool* emit) {
  const int idx = (int)(w & 0xff);
  w >>= 8;
  const int sign = (int)(w & 1);
  const uint64_t rabs = (w >> 1) & 0x000fffffffffffffull;
  double x = __dmul_rn((double)rabs, wi[idx]);
  if (sign) x = -x;
  *z = x;
  *emit = true;
  if (rabs < ki[idx]) return 1;
  if (idx == 0) {
    for (int used = 3;; used += 2) {
      const double xx = __dmul_rn(-zig::NOR_INV_R, log1p(-g.next_double()));
      const double yy = -log1p(-g.next_double());
      if (__dadd_rn(yy, yy) > __dmul_rn(xx, xx)) {
        const double t = __dadd_rn(zig::NOR_R, xx);
        *z = ((rabs >> 8) & 1) ? -t : t;
        return used;
      }
    }
  }
  const double u = g.next_double();
  const double lhs = __dadd_rn(
      __dmul_rn(__dsub_rn(zig::FI[idx - 1], zig::FI[idx]), u), zig::FI[idx]);
  *emit = lhs < exp(__dmul_rn(__dmul_rn(-0.5, x), x));
  return 2;
}

struct Stream {
  U128 s0, inc;
};

// The chain entering run r at offset o, walked from the words themselves:
// (exit offset past the run, normals given inside the run).
__device__ int2 rewalk(const Stream& st, const U128* cinc, int r, int o) {
  Pcg g{jump(st.s0, cinc, (uint64_t)r * RUN + o), st.inc};
  int p = o, n = 0;
  while (p < RUN) {
    double z;
    bool e;
    const uint64_t w = g.next();
    p += attempt(w, g, zig::KI, zig::WI, &z, &e);
    n += e;
  }
  return make_int2(p - RUN, n);
}

__device__ __forceinline__ int2 pick(const int2 (&row)[DEPTH], int o) {
  int2 e = row[0];
#pragma unroll
  for (int d = 1; d < DEPTH; ++d)
    if (o == d) e = row[d];
  return e;
}

__device__ __forceinline__ int2 run_step(const Stream& st, const U128* cinc,
                                         const int2* table, int r, int o) {
  if (o < DEPTH) return table[(long)r * DEPTH + o];
  if (o >= RUN) return make_int2(o - RUN, 0);
  return rewalk(st, cinc, r, o);
}

// A warp's function tables: entry offset d < DEPTH -> (exit offset, normals),
// ESC where the chain leaves the tables' reach (an entry at or past DEPTH).
constexpr int ESC = -1;

// Table g, then table f (a later span of runs): the composition's entry d.
__device__ __forceinline__ int2 compose(const int2 (&g)[DEPTH],
                                        const int2 (&f)[DEPTH], int d) {
  const int2 a = g[d];
  if (a.x < 0 || a.x >= DEPTH) return make_int2(ESC, 0);
  const int2 b = pick(f, a.x);
  return b.x < 0 ? b : make_int2(b.x, a.y + b.y);
}

__global__ void __launch_bounds__(THREADS)
run_tables(Stream st, int runs, int2* __restrict__ table,
           int2* __restrict__ prefix, int2* __restrict__ wtab) {
  __shared__ U128 cinc[64];
  __shared__ uint64_t ki[256];
  __shared__ double wi[256];
  make_cinc(st.inc, cinc);
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    ki[i] = zig::KI[i];
    wi[i] = zig::WI[i];
  }
  __syncthreads();
  const int r = blockIdx.x * THREADS + threadIdx.x;
  const int lane = threadIdx.x % LANES;
  int2 f[DEPTH];
#pragma unroll
  for (int d = 0; d < DEPTH; ++d) f[d] = make_int2(ESC, 0);  // past the end
  if (r < runs) {
    Pcg g{jump(st.s0, cinc, (uint64_t)r * RUN), st.inc};
    int cons[RUN];
    unsigned emits = 0;
    for (int q = 0; q < RUN; ++q) {
      const uint64_t w = g.next();
      Pcg t = g;
      double z;
      bool e;
      cons[q] = attempt(w, t, ki, wi, &z, &e);
      emits |= (unsigned)e << q;
    }
#pragma unroll
    for (int d = 0; d < DEPTH; ++d) {
      int p = d, n = 0;
      while (p < RUN) {
        n += (emits >> p) & 1;
        p += cons[p];
      }
      f[d] = make_int2(p - RUN, n);
      table[(long)r * DEPTH + d] = f[d];
    }
  }
  // The warp's inclusive scan of tables, then each lane's exclusive prefix.
#pragma unroll
  for (int s = 1; s < LANES; s <<= 1) {
    int2 g[DEPTH], h[DEPTH];
#pragma unroll
    for (int d = 0; d < DEPTH; ++d)
      g[d] = make_int2(__shfl_up_sync(FULL, f[d].x, s),
                       __shfl_up_sync(FULL, f[d].y, s));
    if (lane >= s) {
#pragma unroll
      for (int d = 0; d < DEPTH; ++d) h[d] = compose(g, f, d);
#pragma unroll
      for (int d = 0; d < DEPTH; ++d) f[d] = h[d];
    }
  }
#pragma unroll
  for (int d = 0; d < DEPTH; ++d) {
    int2 e = make_int2(__shfl_up_sync(FULL, f[d].x, 1),
                       __shfl_up_sync(FULL, f[d].y, 1));
    if (lane == 0) e = make_int2(d, 0);
    if (r < runs) prefix[(long)r * DEPTH + d] = e;
    if (lane == LANES - 1 && r - lane < runs)
      wtab[(long)(r / LANES) * DEPTH + d] = f[d];
  }
}

// Warp w (runs [w*LANES, ...)) from entry o: its table's entry, or its
// runs walked one by one where the table cannot say.
__device__ int2 warp_step(const Stream& st, const U128* cinc,
                          const int2* table, const int2* wtab, int runs,
                          int w, int o) {
  if (o >= 0 && o < DEPTH) {
    const int2 e = wtab[(long)w * DEPTH + o];
    if (e.x >= 0) return e;
  }
  int n = 0;
  for (int r = w * LANES; r < min((w + 1) * LANES, runs); ++r) {
    const int2 e = run_step(st, cinc, table, r, o);
    o = e.x;
    n += e.y;
  }
  return make_int2(o, n);
}

// Warps [lo, hi) from entry o: (exit offset, normals).
__device__ int2 chunk_step(const Stream& st, const U128* cinc,
                           const int2* table, const int2* wtab, int runs,
                           int lo, int hi, int o) {
  int n = 0;
  for (int w = lo; w < hi; ++w) {
    const int2 e = warp_step(st, cinc, table, wtab, runs, w, o);
    o = e.x;
    n += e.y;
  }
  return make_int2(o, n);
}

// The first warp of chunk c, of SCAN_THREADS chunks of `per` warps.
__device__ __forceinline__ int chunk_lo(int c, int per, int warps) {
  return min(c * per, warps);
}

struct Scan {
  Stream st;
  const U128* cinc;
  const int2* table;
  const int2* wtab;
  int runs, warps, per;
};

// Chunk c from entry o: its table's entry, or its warps one by one.
__device__ int2 chunk_at(const Scan& sc, const int2 (*ctab)[DEPTH], int c,
                         int o) {
  if (o < DEPTH && ctab[c][o].x >= 0) return ctab[c][o];
  return chunk_step(sc.st, sc.cinc, sc.table, sc.wtab, sc.runs,
                    chunk_lo(c, sc.per, sc.warps),
                    chunk_lo(c + 1, sc.per, sc.warps), o);
}

__global__ void __launch_bounds__(SCAN_THREADS)
scan_warps(Stream st, int runs, const int2* __restrict__ table,
           const int2* __restrict__ wtab, int2* __restrict__ wentry) {
  __shared__ U128 cinc[64];
  __shared__ int2 ctab[SCAN_THREADS][DEPTH];   // a chunk's table
  __shared__ int2 cent[SCAN_THREADS];          // its entry and first index
  make_cinc(st.inc, cinc);
  __syncthreads();
  const int t = threadIdx.x;
  const int warps = (runs + LANES - 1) / LANES;
  const Scan sc{st, cinc, table, wtab, runs, warps,
                (warps + SCAN_THREADS - 1) / SCAN_THREADS};
  const int lo = chunk_lo(t, sc.per, warps);
  const int hi = chunk_lo(t + 1, sc.per, warps);

  // Each chunk's table for the DEPTH entries: the warps' rows are loaded
  // whole, so the loads do not wait on the offsets.
  {
    int o[DEPTH], n[DEPTH];
#pragma unroll
    for (int d = 0; d < DEPTH; ++d) o[d] = d, n[d] = 0;
    for (int w = lo; w < hi; ++w) {
      int2 row[DEPTH];
#pragma unroll
      for (int d = 0; d < DEPTH; ++d) row[d] = wtab[(long)w * DEPTH + d];
#pragma unroll
      for (int d = 0; d < DEPTH; ++d) {
        const int2 e = o[d] >= 0 && o[d] < DEPTH ? pick(row, o[d])
                                                 : make_int2(ESC, 0);
        o[d] = e.x;
        n[d] += e.y;
      }
    }
#pragma unroll
    for (int d = 0; d < DEPTH; ++d)
      ctab[t][d] = make_int2(o[d] < DEPTH ? o[d] : ESC, n[d]);
  }
  __syncthreads();

  // Warp 0 composes the chunks: a lane a group of GROUP chunks, then the
  // groups in order (every lane computes the same walk), then each lane
  // its own group's chunks.
  if (t < LANES) {
    constexpr int GROUP = SCAN_THREADS / LANES;
    int2 gt[DEPTH];
#pragma unroll
    for (int d = 0; d < DEPTH; ++d) {
      int o = d, n = 0;
      for (int c = t * GROUP; c < (t + 1) * GROUP; ++c) {
        if (o < 0 || o >= DEPTH || ctab[c][o].x < 0) {
          o = ESC;
          break;
        }
        n += ctab[c][o].y;
        o = ctab[c][o].x;
      }
      gt[d] = make_int2(o, n);
    }
    int o = 0, base = 0, my_o = 0, my_base = 0;
    for (int g = 0; g < LANES; ++g) {
      int2 row[DEPTH];
#pragma unroll
      for (int d = 0; d < DEPTH; ++d)
        row[d] = make_int2(__shfl_sync(FULL, gt[d].x, g),
                           __shfl_sync(FULL, gt[d].y, g));
      if (t == g) my_o = o, my_base = base;
      int2 e = o < DEPTH ? pick(row, o) : make_int2(ESC, 0);
      if (e.x < 0) {
        e = make_int2(o, 0);
        for (int c = g * GROUP; c < (g + 1) * GROUP; ++c) {
          const int2 f = chunk_at(sc, ctab, c, e.x);
          e = make_int2(f.x, e.y + f.y);
        }
      }
      o = e.x;
      base += e.y;
    }
    o = my_o;
    base = my_base;
    for (int c = t * GROUP; c < (t + 1) * GROUP; ++c) {
      cent[c] = make_int2(o, base);
      const int2 e = chunk_at(sc, ctab, c, o);
      o = e.x;
      base += e.y;
    }
  }
  __syncthreads();

  // Each chunk from its true entry: every warp's entry and first index.
  int o = cent[t].x, base = cent[t].y;
  for (int w = lo; w < hi; ++w) {
    wentry[w] = make_int2(o, base);
    int2 row[DEPTH];
#pragma unroll
    for (int d = 0; d < DEPTH; ++d) row[d] = wtab[(long)w * DEPTH + d];
    int2 e = o < DEPTH ? pick(row, o) : make_int2(ESC, 0);
    if (e.x < 0) e = warp_step(st, cinc, table, wtab, runs, w, o);
    o = e.x;
    base += e.y;
  }
}

struct Noise {
  int shot;        // 0: rng.normal(0, noise) in float64; 1: shot noise
  double noise;    // the read noise's scale (shot == 0)
  float nn;        // float32(noise * noise) (shot == 1)
  float gain;      // float32(shot_noise)
};

__device__ __forceinline__ uint8_t noisy(uint8_t f, double z, const Noise& p) {
  if (!p.shot) {
    double v = __dadd_rn((double)f, __dadd_rn(0.0, __dmul_rn(p.noise, z)));
    v = fmin(fmax(v, 0.0), 255.0);
    return (uint8_t)v;
  }
  const float ff = (float)f;
  const float sd = __fsqrt_rn(__fadd_rn(p.nn, __fmul_rn(p.gain, ff)));
  float v = __fadd_rn(ff, __fmul_rn(__double2float_rn(z), sd));
  v = fminf(fmaxf(v, 0.0f), 255.0f);
  return (uint8_t)v;
}

__global__ void __launch_bounds__(THREADS)
emit_runs(Stream st, int runs, const int2* __restrict__ table,
          const int2* __restrict__ prefix, const int2* __restrict__ wentry,
          const uint8_t* __restrict__ in, uint8_t* __restrict__ out, int n,
          Noise p) {
  __shared__ U128 cinc[64];
  __shared__ uint64_t ki[256];
  __shared__ double wi[256];
  make_cinc(st.inc, cinc);
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    ki[i] = zig::KI[i];
    wi[i] = zig::WI[i];
  }
  __syncthreads();
  const int r = blockIdx.x * THREADS + threadIdx.x;
  if (r >= runs) return;
  // The run's entry: its warp's, through the warp's runs before it.
  const int2 we = wentry[r / LANES];
  int2 e = make_int2(ESC, 0);
  if (we.x < DEPTH) e = prefix[(long)r * DEPTH + we.x];
  if (e.x < 0) {
    e = make_int2(we.x, 0);
    for (int q = r - r % LANES; q < r; ++q) {
      const int2 f = run_step(st, cinc, table, q, e.x);
      e = make_int2(f.x, e.y + f.y);
    }
  }
  e.y += we.y;
  const bool last = r == runs - 1;
  int k = e.y;
  if (k >= n || (e.x >= RUN && !last)) return;
  Pcg g{jump(st.s0, cinc, (uint64_t)r * RUN + e.x), st.inc};
  for (int q = e.x; (q < RUN || last) && k < n;) {
    double z;
    bool emit;
    const uint64_t w = g.next();
    q += attempt(w, g, ki, wi, &z, &emit);
    if (emit) {
      out[k] = noisy(in[k], z, p);
      ++k;
    }
  }
}

// Runs the word stream is cut into for n normals: ~3% more words than
// normals (numpy's sampler takes ~1.022 a normal) and 4096 spare.
__host__ int runs_for(int n) {
  const long words = (long)n + n / 32 + 4096;
  return (int)((words + RUN - 1) / RUN);
}

}  // namespace

// The int32 words of scratch camkifu_pcg_normal needs for n normals: each
// run's table and its warp prefix (DEPTH int2 each), and each warp's table
// (DEPTH int2) and entry (one int2).
CAMKIFU_API int camkifu_pcg_normal_scratch(int n) {
  if (n <= 0) return 0;
  const int runs = runs_for(n), warps = (runs + LANES - 1) / LANES;
  return 2 * (2 * DEPTH * runs + (DEPTH + 1) * warps);
}

// in, out: n uint8 values; (s_hi, s_lo), (inc_hi, inc_lo): numpy's PCG64
// state and increment; scratch: camkifu_pcg_normal_scratch(n) int32 words.
CAMKIFU_API int camkifu_pcg_normal(const void* in, void* out, int n,
                                   uint64_t s_hi, uint64_t s_lo,
                                   uint64_t inc_hi, uint64_t inc_lo,
                                   int shot, double noise, float nn,
                                   float gain, void* scratch, void* stream) {
  if (n <= 0 || n > 0x7f000000) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int runs = runs_for(n), warps = (runs + LANES - 1) / LANES;
  int2* table = (int2*)scratch;
  int2* prefix = table + (long)runs * DEPTH;
  int2* wtab = prefix + (long)runs * DEPTH;
  int2* wentry = wtab + (long)warps * DEPTH;
  const Stream st{{s_hi, s_lo}, {inc_hi, inc_lo}};
  const int blocks = (runs + THREADS - 1) / THREADS;
  run_tables<<<blocks, THREADS, 0, s>>>(st, runs, table, prefix, wtab);
  cudaError_t err = cudaGetLastError();
  if (err) return (int)err;
  scan_warps<<<1, SCAN_THREADS, 0, s>>>(st, runs, table, wtab, wentry);
  err = cudaGetLastError();
  if (err) return (int)err;
  emit_runs<<<blocks, THREADS, 0, s>>>(
      st, runs, table, prefix, wentry, (const uint8_t*)in, (uint8_t*)out, n,
      Noise{shot, noise, nn, gain});
  return (int)cudaGetLastError();
}
