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
// every earlier rejection. One launch, a single pass with decoupled
// look-back. The word stream is cut into tiles of THREADS runs of RUN
// words; a block takes the next tile from a counter in scratch (so every
// tile it may wait on is already running) and:
//
// 1. draws each word of its tile once into shared memory, a thread a run
//    (one jump a tile from the stream's start, one thread's, then a short
//    one a run), and keeps the generator past the tile's last word for
//    the rare attempt that reads on;
// 2. evaluates the attempt that would start at every word of its run (the
//    fast path from the word alone, the few others in full) into three
//    bit masks, and walks from them the chain of attempts from each of
//    the run's first DEPTH words: where it leaves the run (an offset into
//    the next) and how many normals it gave, the run's table;
// 3. composes the tables over the warp with shuffles and over the block
//    through shared memory: each run's prefix (tile entry -> run entry)
//    and the tile's aggregate, which it publishes in scratch as words
//    that each carry their own valid bit (no flags, no fences);
// 4. looks back (warp 0, a window of 128 predecessors a load): the
//    aggregates after the nearest tile with an inclusive value (its exit
//    offset and normals so far), composed over the warp, carry that value
//    forward; a window of aggregates only is composed and the look-back
//    goes on before it; where the composition cannot say (an entry at or
//    past DEPTH on the way), it starts again after a backoff, once the
//    tile that could not say has published. Then it publishes its own;
// 5. takes each run's entry through its prefix (an entry at or past
//    DEPTH, a tail that spilled far, has one thread walk the tile run by
//    run from the words instead), stages the frame's span of the tile's
//    normals in shared memory in 16-byte words, walks each run again from
//    its entry over the buffered words and masks, writes the noisy bytes
//    into the stage, and stores the span. The last run walks on until the
//    frame is full, so the margin of words can never run out.
//
// What bounds it: the frame read once and written once (2 bytes a value,
// 5.5 MB at 720p: 1.7 us at 3.35 TB/s) against the generator's 128-bit
// multiply-add, 16 32-bit multiply-adds a word, ~1.02 words a normal: 45 M
// at 720p, ~2.7 us at the card's 64 INT32 lanes an SM. So operations bound
// it; every word is drawn once (a jump a run adds a few multiply-adds a
// word). The ziggurat's tables are read through L1, so that a block's
// words fit six blocks an SM. The build keeps --fmad=false and the math
// library's double exp and log1p, as numpy's C code rounds each step on
// its own.
#include "common.cuh"
#include "ziggurat_tables.cuh"

namespace {

constexpr int RUN = 32;            // words a run, a thread each
constexpr int DEPTH = 4;           // entry offsets a run's table holds
constexpr int THREADS = 128;       // runs a tile, threads a block
constexpr int LANES = 32;
constexpr int WARPS = THREADS / LANES;
constexpr int LOOK = 4;            // predecessors a look-back lane loads
constexpr int TILE = RUN * THREADS;        // words a tile
constexpr int STAGE = TILE + 16;           // a tile's normals, 16-aligned
constexpr unsigned FULL = 0xffffffffu;
static_assert(RUN == 32 && THREADS % LANES == 0, "a run's masks are words");

// Scratch ints before the tiles' published values: the tile counter.
constexpr int HEAD = 4;

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
};

__device__ __forceinline__ double to_double(uint64_t w) {
  return (double)(w >> 11) * (1.0 / 9007199254740992.0);
}

// State k words after s: s -> A[i] s + P[i] inc for each set bit i of k;
// cinc[i] = P[i] inc, made once a block.
__device__ U128 jump(U128 s, const U128* cinc, uint64_t k) {
  for (int i = 0; k; ++i, k >>= 1)
    if (k & 1) s = add(mul({zig::JUMP_A[i][0], zig::JUMP_A[i][1]}, s), cinc[i]);
  return s;
}

struct Stream {
  U128 s0, inc;
};

// An (exit offset, normals) entry of a table; ESC where the tables cannot
// say (the chain passed an entry at or past DEPTH).
__device__ __forceinline__ int2 esc() { return make_int2(-1, 0); }

__device__ __forceinline__ int2 pick(const int2 (&row)[DEPTH], int o) {
  int2 e = row[0];
#pragma unroll
  for (int d = 1; d < DEPTH; ++d)
    if (o == d) e = row[d];
  return e;
}

// Table g, then table f (a later span of runs): the composition's entries.
__device__ __forceinline__ void compose(const int2 (&g)[DEPTH],
                                        const int2 (&f)[DEPTH],
                                        int2 (&out)[DEPTH]) {
#pragma unroll
  for (int d = 0; d < DEPTH; ++d) {
    const int2 a = g[d];
    int2 b = a.x < 0 || a.x >= DEPTH ? esc() : pick(f, a.x);
    out[d] = b.x < 0 ? b : make_int2(b.x, a.y + b.y);
  }
}

// 36 KB a block, so that six blocks share an SM: the ziggurat's tables are
// read through L1, and what is needed in turn shares one union.
struct Shared {
  uint64_t words[TILE];               // word i at slot(i)
  U128 end;                           // the generator after the tile's words
  U128 start;                         // the generator before them
  int2 wagg[WARPS][DEPTH];            // each warp's composed table
  union {
    U128 cinc[64];                    // the jump's increments (first)
    int2 tab[THREADS][DEPTH];         // the runs' tables, then (the rare
                                      // walk) each run's entry at tab[r][0]
    __align__(16) uint8_t stage[STAGE];  // the frame's span, then noisy
  } u;
  int tile, o, base;
  int2 total;                         // the tile's exit and normals
};

// Word i of the tile, swizzled within its run so that the threads of a
// warp, each at word q of its own run, meet no bank twice over.
__device__ __forceinline__ int slot(int i) { return i ^ (i >> 5 & 15); }

// Words of the tile from word i on: the buffer, then the generator past
// its end.
struct Cursor {
  const Shared& sh;
  U128 inc;
  int i;
  Pcg g;

  __device__ Cursor(const Shared& sh_, U128 inc_, int i_)
      : sh(sh_), inc(inc_), i(i_) {}
  __device__ __forceinline__ uint64_t next() {
    if (i < TILE) return sh.words[slot(i++)];
    if (i++ == TILE) g = Pcg{sh.end, inc};
    return g.next();
  }
};

// The attempt's first steps from its first word: its layer and
// magnitude, and its value x (the normal, unless the tail replaces it).
struct Head {
  int idx;
  uint64_t rabs;
  double x;
};

__device__ __forceinline__ Head head(uint64_t w) {
  Head h;
  h.idx = (int)(w & 0xff);
  w >>= 8;
  h.rabs = (w >> 1) & 0x000fffffffffffffull;
  h.x = __dmul_rn((double)h.rabs, __ldg(zig::WI + h.idx));
  if (w & 1) h.x = -h.x;
  return h;
}

// One attempt of random_standard_normal from the cursor's word on.
// Returns the words it took; *emit says whether it gave a normal (a wedge
// rejection gives none), *z the normal.
__device__ int attempt(Cursor& c, double* z, bool* emit) {
  const Head h = head(c.next());
  *z = h.x;
  *emit = true;
  if (h.rabs < __ldg(zig::KI + h.idx)) return 1;
  if (h.idx == 0) {
    for (int used = 3;; used += 2) {
      const double xx =
          __dmul_rn(-zig::NOR_INV_R, log1p(-to_double(c.next())));
      const double yy = -log1p(-to_double(c.next()));
      if (__dadd_rn(yy, yy) > __dmul_rn(xx, xx)) {
        const double t = __dadd_rn(zig::NOR_R, xx);
        *z = ((h.rabs >> 8) & 1) ? -t : t;
        return used;
      }
    }
  }
  const double u = to_double(c.next());
  const double lhs = __dadd_rn(
      __dmul_rn(__dsub_rn(zig::FI[h.idx - 1], zig::FI[h.idx]), u),
      zig::FI[h.idx]);
  *emit = lhs < exp(__dmul_rn(__dmul_rn(-0.5, h.x), h.x));
  return 2;
}

// A run's attempts as bit masks over its words: fast (1 word, a normal),
// wedge (2 words) and gives-a-normal; a word in neither of the first two
// starts a tail (3 or more words, a normal).
struct Masks {
  unsigned fast, wedge, emit;
};

// The chain entering run r at offset o: (exit offset past the run, normals
// given inside the run), from the masks; a tail's length from the words.
__device__ int2 chain(const Masks& m, const Shared& sh, U128 inc, int r,
                      int o) {
  int n = 0;
  while (o < RUN) {
    const unsigned ahead = ~0u << o;
    const unsigned slow = ~m.fast & ahead;
    const int s = slow ? __ffs(slow) - 1 : RUN;
    n += __popc(m.fast & ahead & (s < RUN ? (1u << s) - 1 : ~0u));
    if (s == RUN) return make_int2(0, n);
    n += m.emit >> s & 1;
    if (m.wedge >> s & 1) {
      o = s + 2;
    } else {
      Cursor c(sh, inc, r * RUN + s);
      double z;
      bool e;
      o = s + attempt(c, &z, &e);
    }
  }
  return make_int2(o - RUN, n);
}

// The chain entering run r at offset o from the words alone (another
// thread's run: the rare walk).
__device__ int2 rewalk(const Shared& sh, U128 inc, int r, int o) {
  if (o >= RUN) return make_int2(o - RUN, 0);
  Cursor c(sh, inc, r * RUN + o);
  int n = 0;
  while (o < RUN) {
    double z;
    bool e;
    o += attempt(c, &z, &e);
    n += e;
  }
  return make_int2(o - RUN, n);
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

// A tile's published values, each 32-bit word with its top bit set (the
// scratch starts zeroed, so a word reads as written or as nothing: a torn
// read is seen as not yet published, and no fence is needed). The
// aggregate: DEPTH words of (exit offset, 8 bits, 255 where the tables
// cannot say or past 254; normals, 16 bits); the inclusive value: (exit
// offset, normals so far), a word each.
constexpr unsigned VALID = 0x80000000u;

__device__ __forceinline__ unsigned pack(int2 e) {
  const unsigned x = e.x < 0 || e.x > 254 ? 255u : (unsigned)e.x;
  return VALID | x << 16 | (unsigned)e.y;
}

__device__ __forceinline__ int2 unpack(unsigned w) {
  const int x = (int)(w >> 16 & 255u);
  return x == 255 ? esc() : make_int2(x, (int)(w & 0xffffu));
}

__device__ __forceinline__ void publish_agg(unsigned* at,
                                            const int2 (&a)[DEPTH]) {
#pragma unroll
  for (int d = 0; d < DEPTH; ++d) ((volatile unsigned*)at)[d] = pack(a[d]);
}

__device__ __forceinline__ void publish_inc(unsigned* at, int2 v) {
  ((volatile unsigned*)at)[0] = VALID | (unsigned)v.x;
  ((volatile unsigned*)at)[1] = VALID | (unsigned)v.y;
}

// Waits with a growing sleep, so that a waiting warp leaves the SM's
// issue slots to the blocks still drawing their words.
struct Backoff {
  unsigned ns = 64;
  __device__ void operator()() {
    __nanosleep(ns);
    ns = min(2 * ns, 1024u);
  }
};

// Until the aggregate at `at` is published.
__device__ void wait_agg(const unsigned* at) {
  for (Backoff sleep;; sleep()) {
    bool all = true;
#pragma unroll
    for (int d = 0; d < DEPTH; ++d)
      all = all && (((const volatile unsigned*)at)[d] & VALID);
    if (all) return;
  }
}

// Warp 0: the tile's entry offset and first normal from the tiles before
// it (tile -1 enters tile 0 at offset 0 with no normals), or ESC where the
// aggregates cannot say (an entry at or past DEPTH on the way). A window
// of LANES * LOOK predecessors a round of loads, LOOK a lane: where one
// has its inclusive value, the aggregates of those after it, composed in
// each lane and then over the warp, carry it forward; a window of
// aggregates only is composed and the look-back goes on before it.
__device__ int2 look_back_once(int t, const unsigned* agg,
                               const unsigned* inc, int lane) {
  int2 r[DEPTH], f[DEPTH], g[DEPTH], tmp[DEPTH];  // r: tiles (top, t)
#pragma unroll
  for (int d = 0; d < DEPTH; ++d) r[d] = make_int2(d, 0);
  int top = t - 1;
  while (true) {
    // This lane's tiles top - LOOK * lane - k, the latest (k = 0) first.
    unsigned a[LOOK][DEPTH], x[LOOK], y[LOOK];
#pragma unroll
    for (int k = 0; k < LOOK; ++k) {
      const int p = top - LOOK * lane - k;
      x[k] = y[k] = VALID;
#pragma unroll
      for (int d = 0; d < DEPTH; ++d) a[k][d] = VALID;
      if (p >= 0) {
        const volatile unsigned* va = agg + (size_t)p * DEPTH;
        const volatile unsigned* vi = inc + 2 * (size_t)p;
#pragma unroll
        for (int d = 0; d < DEPTH; ++d) a[k][d] = va[d];
        x[k] = vi[0];
        y[k] = vi[1];
      }
    }
    // The lane's latest tile with an inclusive value (LOOK: none), and
    // its first tile after that without its aggregate (LOOK: none).
    int kinc = LOOK, kwait = LOOK;
#pragma unroll
    for (int k = LOOK - 1; k >= 0; --k)
      if (x[k] & y[k] & VALID) kinc = k;
#pragma unroll
    for (int k = LOOK - 1; k >= 0; --k) {
      bool has = true;
#pragma unroll
      for (int d = 0; d < DEPTH; ++d) has = has && (a[k][d] & VALID);
      if (k < kinc && !has) kwait = k;
    }
    const unsigned incs = __ballot_sync(FULL, kinc < LOOK);
    const unsigned waiting = __ballot_sync(FULL, kwait < LOOK);
    const int j = incs ? __ffs(incs) - 1 : LANES - 1;
    const unsigned late = waiting & (j == LANES - 1 ? FULL : (2u << j) - 1);
    if (late) {
      // One lane waits on the latest tile still drawing, then the window
      // is read again.
      const int l = __ffs(late) - 1;
      const int p = top - LOOK * l - __shfl_sync(FULL, kwait, l);
      if (lane == 0) wait_agg(agg + (size_t)p * DEPTH);
      __syncwarp();
      continue;
    }
    // Each lane's tiles after its inclusive value, earliest first; lanes
    // past j none; then the lanes, earliest first.
#pragma unroll
    for (int d = 0; d < DEPTH; ++d) f[d] = make_int2(d, 0);
#pragma unroll
    for (int k = LOOK - 1; k >= 0; --k) {
      if (k < kinc && lane <= j) {
#pragma unroll
        for (int d = 0; d < DEPTH; ++d) g[d] = unpack(a[k][d]);
        compose(f, g, tmp);
#pragma unroll
        for (int d = 0; d < DEPTH; ++d) f[d] = tmp[d];
      }
    }
#pragma unroll
    for (int s = 1; s < LANES; s <<= 1) {
#pragma unroll
      for (int d = 0; d < DEPTH; ++d)
        g[d] = make_int2(__shfl_down_sync(FULL, f[d].x, s),
                         __shfl_down_sync(FULL, f[d].y, s));
      if (lane + s < LANES) {
        compose(g, f, tmp);
#pragma unroll
        for (int d = 0; d < DEPTH; ++d) f[d] = tmp[d];
      }
    }
#pragma unroll
    for (int d = 0; d < DEPTH; ++d)
      f[d] = make_int2(__shfl_sync(FULL, f[d].x, 0),
                       __shfl_sync(FULL, f[d].y, 0));
    compose(f, r, tmp);
#pragma unroll
    for (int d = 0; d < DEPTH; ++d) r[d] = tmp[d];
    if (incs) {
      unsigned ix = x[0], iy = y[0];
#pragma unroll
      for (int k = 1; k < LOOK; ++k)
        if (k == kinc) ix = x[k], iy = y[k];
      const int ex = __shfl_sync(FULL, (int)(ix & ~VALID), j);
      const int ey = __shfl_sync(FULL, (int)(iy & ~VALID), j);
      const int k0 = __shfl_sync(FULL, kinc, j);
      const int p0 = top - LOOK * j - k0;
      const int2 e = p0 < 0 ? make_int2(0, 0) : make_int2(ex, ey);
      if (p0 == t - 1) return e;          // exact, even past DEPTH
      const int2 c = e.x < DEPTH ? pick(r, e.x) : esc();
      return c.x < 0 ? c : make_int2(c.x, e.y + c.y);
    }
    top -= LANES * LOOK;
  }
}

// The look-back until it can say: the tile whose aggregate could not
// (it walked its own runs from its entry) publishes its inclusive value,
// and the look-back then starts from it.
__device__ int2 look_back(int t, const unsigned* agg, const unsigned* inc,
                          int lane) {
  for (Backoff sleep;; sleep()) {
    const int2 e = look_back_once(t, agg, inc, lane);
    if (e.x >= 0) return e;
  }
}

__global__ void __launch_bounds__(THREADS, 6)
pcg_normal_kernel(Stream st, int tiles, int* __restrict__ counter,
                  unsigned* __restrict__ agg, unsigned* __restrict__ inc,
                  const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                  int n, Noise p, bool vec) {
  __shared__ Shared sh;
  const int tid = threadIdx.x, lane = tid % LANES, warp = tid / LANES;
  if (tid == 0) sh.tile = atomicAdd(counter, 1);
  for (int i = tid; i < 64; i += THREADS)
    sh.u.cinc[i] = mul({zig::JUMP_P[i][0], zig::JUMP_P[i][1]}, st.inc);
  __syncthreads();
  const int t = sh.tile;
  if (tid == 0) sh.start = jump(st.s0, sh.u.cinc, (uint64_t)t * TILE);
  __syncthreads();

  // 1. The tile's words, each drawn once, and the run's fast attempts.
  Masks m{0u, 0u, 0u};
  {
    Pcg g{jump(sh.start, sh.u.cinc, (uint64_t)tid * RUN), st.inc};
#pragma unroll 4
    for (int q = 0; q < RUN; ++q) {
      const uint64_t w = g.next();
      sh.words[slot(tid * RUN + q)] = w;
      if ((w >> 9 & 0x000fffffffffffffull) < __ldg(zig::KI + (w & 0xff)))
        m.fast |= 1u << q;
    }
    if (tid == THREADS - 1) sh.end = g.s;
  }
  __syncthreads();                    // the increments' space becomes tab

  // 2. The run's other attempts, then its table.
  m.emit = m.fast;
  for (unsigned slow = ~m.fast; slow; slow &= slow - 1) {
    const int q = __ffs(slow) - 1;
    Cursor c(sh, st.inc, tid * RUN + q);
    double z;
    bool e;
    const int used = attempt(c, &z, &e);
    m.wedge |= (unsigned)(used == 2) << q;
    m.emit |= (unsigned)e << q;
  }
  int2 f[DEPTH];
#pragma unroll
  for (int d = 0; d < DEPTH; ++d) {
    f[d] = chain(m, sh, st.inc, tid, d);
    sh.u.tab[tid][d] = f[d];
  }

  // 3. The warp's inclusive scan of tables, each run's exclusive prefix in
  // its warp; then the warps' tables composed through shared memory.
#pragma unroll
  for (int s = 1; s < LANES; s <<= 1) {
    int2 g[DEPTH], h[DEPTH];
#pragma unroll
    for (int d = 0; d < DEPTH; ++d)
      g[d] = make_int2(__shfl_up_sync(FULL, f[d].x, s),
                       __shfl_up_sync(FULL, f[d].y, s));
    if (lane >= s) {
      compose(g, f, h);
#pragma unroll
      for (int d = 0; d < DEPTH; ++d) f[d] = h[d];
    }
  }
  int2 pre[DEPTH];
#pragma unroll
  for (int d = 0; d < DEPTH; ++d) {
    pre[d] = make_int2(__shfl_up_sync(FULL, f[d].x, 1),
                       __shfl_up_sync(FULL, f[d].y, 1));
    if (lane == 0) pre[d] = make_int2(d, 0);
    if (lane == LANES - 1) sh.wagg[warp][d] = f[d];
  }
  __syncthreads();
  int2 acc[DEPTH], wpre[DEPTH], tmp[DEPTH];
#pragma unroll
  for (int d = 0; d < DEPTH; ++d) acc[d] = wpre[d] = make_int2(d, 0);
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    if (w == warp) {
#pragma unroll
      for (int d = 0; d < DEPTH; ++d) wpre[d] = acc[d];
    }
    compose(acc, sh.wagg[w], tmp);
#pragma unroll
    for (int d = 0; d < DEPTH; ++d) acc[d] = tmp[d];
  }
  compose(wpre, pre, tmp);            // tile entry -> this run's entry
  if (tid == 0) publish_agg(agg + (size_t)t * DEPTH, acc);

  // 4. The tile's entry and first normal.
  if (warp == 0) {
    const int2 e = t == 0 ? make_int2(0, 0) : look_back(t, agg, inc, lane);
    if (lane == 0) sh.o = e.x, sh.base = e.y;
  }
  __syncthreads();
  const int o = sh.o, base = sh.base;

  // 5. Each run's entry, through its prefix or, where one cannot say, the
  // tile walked run by run; the inclusive value.
  int2 ent = o < DEPTH ? pick(tmp, o) : esc();
  int2 total = o < DEPTH ? pick(acc, o) : esc();
  if (__syncthreads_or(ent.x < 0 || total.x < 0)) {
    if (tid == 0) {
      int oo = o, k = 0;
      for (int r = 0; r < THREADS; ++r) {
        const int2 e = oo < DEPTH ? sh.u.tab[r][oo] : rewalk(sh, st.inc, r, oo);
        sh.u.tab[r][0] = make_int2(oo, k);
        oo = e.x;
        k += e.y;
      }
      sh.total = make_int2(oo, k);
    }
    __syncthreads();
    ent = sh.u.tab[tid][0];
    total = sh.total;
  }
  if (tid == 0) publish_inc(inc + 2 * (size_t)t, make_int2(total.x, base + total.y));

  // 6. The frame's span of the tile's normals, staged; each run walked
  // again from its entry; the span stored.
  const int first = base, stop = min(n, base + total.y);
  const int al = first & ~15;
  __syncthreads();                    // the tables' space becomes the stage
  for (int i = al + 16 * tid; i < stop; i += 16 * THREADS) {
    if (vec && i >= first && i + 16 <= stop) {
      *(uint4*)(sh.u.stage + (i - al)) = __ldg((const uint4*)(in + i));
    } else {
      for (int b = max(i, first); b < min(i + 16, stop); ++b)
        sh.u.stage[b - al] = in[b];
    }
  }
  __syncthreads();
  const bool last = t == tiles - 1 && tid == THREADS - 1;
  int q = ent.x, k = base + ent.y;
  if (k < n && (q < RUN || last)) {
    // Inside the run, from the masks; a tail, and the last run past its
    // end, from the words.
    Cursor c(sh, st.inc, tid * RUN + q);
    while ((q < RUN || last) && k < n) {
      double z;
      bool e;
      int used;
      if (q < RUN && (m.fast | m.wedge) >> q & 1) {
        used = m.fast >> q & 1 ? 1 : 2;
        e = m.emit >> q & 1;
        z = head(sh.words[slot(tid * RUN + q)]).x;
      } else {
        c.i = tid * RUN + q;
        used = attempt(c, &z, &e);
      }
      if (e) {
        if (q < RUN)
          sh.u.stage[k - al] = noisy(sh.u.stage[k - al], z, p);
        else
          out[k] = noisy(in[k], z, p);
        ++k;
      }
      q += used;
    }
  }
  __syncthreads();
  for (int i = al + 16 * tid; i < stop; i += 16 * THREADS) {
    if (vec && i >= first && i + 16 <= stop) {
      *(uint4*)(out + i) = *(const uint4*)(sh.u.stage + (i - al));
    } else {
      for (int b = max(i, first); b < min(i + 16, stop); ++b)
        out[b] = sh.u.stage[b - al];
    }
  }
}

// Tiles the word stream is cut into for n normals: ~3% more words than
// normals (numpy's sampler takes ~1.022 a normal) and 4096 spare.
__host__ int tiles_for(int n) {
  const long words = (long)n + n / 32 + 4096;
  return (int)((words + TILE - 1) / TILE);
}

}  // namespace

// The int32 words of scratch camkifu_pcg_normal needs for n normals: the
// tile counter (padded), then each tile's aggregate (DEPTH words) and
// inclusive value (two words).
CAMKIFU_API int camkifu_pcg_normal_scratch(int n) {
  if (n <= 0) return 0;
  return HEAD + (DEPTH + 2) * tiles_for(n);
}

// in, out: n uint8 values; (s_hi, s_lo), (inc_hi, inc_lo): numpy's PCG64
// state and increment; scratch: camkifu_pcg_normal_scratch(n) int32 words,
// zeroed here on the stream.
CAMKIFU_API int camkifu_pcg_normal(const void* in, void* out, int n,
                                   uint64_t s_hi, uint64_t s_lo,
                                   uint64_t inc_hi, uint64_t inc_lo,
                                   int shot, double noise, float nn,
                                   float gain, void* scratch, void* stream) {
  if (n <= 0 || n > 0x7f000000) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int tiles = tiles_for(n);
  int* counter = (int*)scratch;
  unsigned* agg = (unsigned*)counter + HEAD;
  unsigned* inc = agg + (size_t)tiles * DEPTH;
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, sizeof(int) * (size_t)camkifu_pcg_normal_scratch(n), s);
  if (err) return (int)err;
  const bool vec = (((size_t)in | (size_t)out) & 15) == 0;
  pcg_normal_kernel<<<tiles, THREADS, 0, s>>>(
      Stream{{s_hi, s_lo}, {inc_hi, inc_lo}}, tiles, counter, agg, inc,
      (const uint8_t*)in, (uint8_t*)out, n, Noise{shot, noise, nn, gain}, vec);
  return (int)cudaGetLastError();
}
