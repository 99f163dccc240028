// The temporal vote scan of stone/sf_meta.py scan_streams: every stream's
// votes, stable board, region trust and background carried over every
// frame of a batch, in one launch. Replaces no Pallas kernel: the
// reference's scan is the jax.lax.scan in camkifu_tpu/stone/sf_meta.py
// _scan_canonical, which XLA compiles into one loop; eager PyTorch ran it
// as ~52 small launches a frame (camkifu_tpu_torch/ops/cuda/
// vote_scan_kernel.py vote_scan_ref, the plain version).
//
// Bound: latency. A call reads the classifiers' outputs and the small luma
// once and writes labels, confidences and the new carry once (~4.5 MB at
// 8 streams x 16 frames x 19x19, ~1.3 us at 3.35 TB/s), but every frame's
// step depends on the one before. So no step may wait on device memory:
//
// - Vote blocks, the first n blocks, one a stream: a thread owns one
//   intersection and keeps its three votes and its stable label in
//   registers over all frames. It issues the loads of CHUNK frames of its
//   seven inputs (three labels, three confidences, the calm flag), of the
//   stream's agitation and of its region's agreement before it runs those
//   frames' steps from registers. The 3x3 region trust is a recurrence per
//   region that every thread of the region runs alike (its region's EMA
//   from the same loads), so no thread waits on another; threads 0-8 also
//   run region t's, whose carry they write.
// - Background blocks, the rest, ceil(h*w / THREADS) a stream: a thread
//   owns one pixel of the stream's background. The "uninitialised" flag
//   that each frame tests, bg[0, 0] < 0, is pixel (0, 0)'s own trajectory:
//   every thread runs that pixel's EMA beside its own, with the same
//   arithmetic, from a broadcast load.
// - No shared memory and no barrier: the blocks are independent and so are
//   their threads.
//
// Bitwise the plain version on the card: the build has --fmad=false, each
// product and sum rounds on its own in the plain version's order, every
// constant comes from the wrapper as PyTorch rounds the Python scalar to
// float32, comparisons are the plain version's (agitation <= thr gates the
// trust, agitation > thr slows the background, >= commits), and argmax,
// amax, sort and clamp treat NaN as PyTorch does. The confidence is
// top * (1 / window): PyTorch's CUDA division by a Python scalar multiplies
// by the scalar's float32 reciprocal.
#include "common.cuh"

namespace {

constexpr int THREADS = 384;   // a vote block holds up to 19 x 19 threads
constexpr int CHUNK = 8;       // frames whose loads are issued together

struct Consts {
  float agit_thr;    // cvconf.agitation_threshold
  float trust_keep;  // 1 - TRUST_EMA
  float trust_rate;  // TRUST_EMA
  float promote;     // TRUST_PROMOTE
  float decay;       // 1 - 1 / vote_window
  float min_conf;    // vote_min_conf
  float vote_thr;    // vote_threshold
  float inv_window;  // float32(1) / float32(vote_window)
  float ema;         // background_ema
  float slow_ema;    // 0.1 * background_ema
};

struct Args {
  const int8_t* lab[3];   // (n, b, g, g) contours, clustering, net
  const float* conf[3];   // (n, b, g, g)
  const float* calm;      // (n, b, g, g) zone_calm
  const float* agit;      // (n, b)
  const float* ragree;    // (n, b, 3, 3)
  const float* luma;      // (n, b, npix)
  const float* votes;     // (n, g, g, 3)
  const int8_t* stable;   // (n, g, g)
  const float* bg;        // (n, npix)
  const float* trust;     // (n, 3, 3)
  int8_t* labels_out;     // (n, b, g, g)
  float* conf_out;        // (n, b, g, g)
  float* votes_out;
  int8_t* stable_out;
  float* bg_out;
  float* trust_out;
  int n, b, g, npix, nvalid, tiles;
  Consts k;
};

// torch.argmax's order: the first NaN wins, else the first of the largest.
__device__ __forceinline__ bool beats(float c, float best) {
  return !isnan(best) && (isnan(c) || c > best);
}

// amax's NaN-propagating maximum.
__device__ __forceinline__ float max_nan(float a, float b) {
  return (isnan(a) || a > b) ? a : b;
}

// The middle of torch.sort's ascending order of three, NaN sorted last.
__device__ __forceinline__ float middle(float a, float b, float c) {
  const int nans = (int)isnan(a) + (int)isnan(b) + (int)isnan(c);
  if (nans >= 2) return __int_as_float(0x7fc00000);
  if (nans == 1) {
    const float x = isnan(a) ? b : a;
    const float y = isnan(c) ? b : c;
    return x > y ? x : y;
  }
  const float lo = a < b ? a : b;
  const float hi = a < b ? b : a;
  const float m = hi < c ? hi : c;
  return lo > m ? lo : m;
}

// torch.clamp(x, 0, 1), NaN kept.
__device__ __forceinline__ float clamp01(float x) {
  return isnan(x) ? x : fminf(fmaxf(x, 0.0f), 1.0f);
}

__device__ __forceinline__ int region_of(int r, int c, int g) {
  return min(r * 3 / g, 2) * 3 + min(c * 3 / g, 2);
}

__device__ void vote_block(const Args& a, const int s) {
  const Consts& k = a.k;
  const int t = threadIdx.x;
  const int gg = a.g * a.g;
  const bool mine = t < gg;
  const bool writer = t < 9;   // carries region t's trust out
  const int reg = mine ? region_of(t / a.g, t % a.g, a.g) : 0;
  const long frame0 = (long)s * a.b;   // this stream's first frame

  float tr = a.trust[s * 9 + reg];          // this intersection's region
  float tw = writer ? a.trust[s * 9 + t] : 0.0f;
  float v0 = 0.0f, v1 = 0.0f, v2 = 0.0f;
  int st = 0;
  if (mine) {
    const float* v = a.votes + ((long)s * gg + t) * 3;
    v0 = v[0];
    v1 = v[1];
    v2 = v[2];
    st = a.stable[(long)s * gg + t];
  }

  for (int base = 0; base < a.nvalid; base += CHUNK) {
    float ag[CHUNK], ra[CHUNK], rw[CHUNK], cc[CHUNK], ck[CHUNK], cn[CHUNK],
        cm[CHUNK];
    int lc[CHUNK], lk[CHUNK], ln[CHUNK];
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      const int i = base + j;
      ag[j] = ra[j] = rw[j] = cc[j] = ck[j] = cn[j] = cm[j] = 0.0f;
      lc[j] = lk[j] = ln[j] = 0;
      if (i < a.nvalid) {
        const long f = frame0 + i;
        ag[j] = a.agit[f];
        ra[j] = a.ragree[f * 9 + reg];
        if (writer) rw[j] = a.ragree[f * 9 + t];
        if (mine) {
          const long x = f * gg + t;
          lc[j] = a.lab[0][x];
          lk[j] = a.lab[1][x];
          ln[j] = a.lab[2][x];
          cc[j] = a.conf[0][x];
          ck[j] = a.conf[1][x];
          cn[j] = a.conf[2][x];
          cm[j] = a.calm[x];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      const int i = base + j;
      if (i >= a.nvalid) break;
      // The region trust's EMA, only while the stream is calm.
      const bool calm = ag[j] <= k.agit_thr;
      if (calm) tr = tr * k.trust_keep + ra[j] * k.trust_rate;
      if (writer && calm) tw = tw * k.trust_keep + rw[j] * k.trust_rate;
      if (!mine) continue;
      // Contours always, clustering once its region's trust promotes, the
      // net when given: the most confident reading votes.
      float conf = cc[j];
      int lab = lc[j];
      const float ck_eff = tr >= k.promote ? ck[j] : -1.0f;
      if (beats(ck_eff, conf)) { conf = ck_eff; lab = lk[j]; }
      if (beats(cn[j], conf)) { conf = cn[j]; lab = ln[j]; }
      // vote_update: decay, cast, commit.
      const float cast = conf >= k.min_conf ? 1.0f : 0.0f;
      const float w0 = ((lab == 0 ? 1.0f : 0.0f) * cast) * cm[j];
      const float w1 = ((lab == 1 ? 1.0f : 0.0f) * cast) * cm[j];
      const float w2 = ((lab == 2 ? 1.0f : 0.0f) * cast) * cm[j];
      v0 = v0 * k.decay + w0;
      v1 = v1 * k.decay + w1;
      v2 = v2 * k.decay + w2;
      const float top = max_nan(max_nan(v0, v1), v2);
      int top_label = 0;
      float best = v0;
      if (beats(v1, best)) { best = v1; top_label = 1; }
      if (beats(v2, best)) { top_label = 2; }
      const float runner = middle(v0, v1, v2);
      if (top >= k.vote_thr && top >= 2.0f * runner) st = top_label;
      const long x = (frame0 + i) * gg + t;
      a.labels_out[x] = (int8_t)st;
      a.conf_out[x] = clamp01(top * k.inv_window);
    }
  }

  if (mine) {
    // Padded frames emit the stable board and the carried votes'
    // confidence, and leave the carry as it is.
    const float old_conf =
        clamp01(max_nan(max_nan(v0, v1), v2) * k.inv_window);
    for (int i = a.nvalid; i < a.b; ++i) {
      const long x = (frame0 + i) * gg + t;
      a.labels_out[x] = (int8_t)st;
      a.conf_out[x] = old_conf;
    }
    float* v = a.votes_out + ((long)s * gg + t) * 3;
    v[0] = v0;
    v[1] = v1;
    v[2] = v2;
    a.stable_out[(long)s * gg + t] = (int8_t)st;
  }
  if (writer) a.trust_out[s * 9 + t] = tw;
}

__device__ void background_block(const Args& a, const int s,
                                 const int tile) {
  const Consts& k = a.k;
  const int p = tile * THREADS + threadIdx.x;
  const bool mine = p < a.npix;
  const float* luma = a.luma + (long)s * a.b * a.npix;
  float x = mine ? a.bg[(long)s * a.npix + p] : 0.0f;
  float x00 = a.bg[(long)s * a.npix];   // pixel (0, 0): the flag's own

  for (int base = 0; base < a.nvalid; base += CHUNK) {
    float lu[CHUNK], l00[CHUNK], ag[CHUNK];
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      const int i = base + j;
      lu[j] = l00[j] = ag[j] = 0.0f;
      if (i < a.nvalid) {
        const float* frame = luma + (long)i * a.npix;
        l00[j] = frame[0];
        ag[j] = a.agit[(long)s * a.b + i];
        if (mine) lu[j] = frame[p];
      }
    }
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      if (base + j >= a.nvalid) break;
      // The EMA, slowed 10x while the scene is agitated; an uninitialised
      // background starts from the frame.
      const float rate = ag[j] > k.agit_thr ? k.slow_ema : k.ema;
      const float keep = 1.0f - rate;
      const bool fresh = x00 < 0.0f;
      const float b00 = fresh ? l00[j] : x00;
      x00 = b00 * keep + l00[j] * rate;
      const float bp = fresh ? lu[j] : x;
      x = bp * keep + lu[j] * rate;
    }
  }
  if (mine) a.bg_out[(long)s * a.npix + p] = x;
}

__global__ void __launch_bounds__(THREADS) vote_scan_kernel(const Args a) {
  const int blk = blockIdx.x;
  if (blk < a.n) {
    vote_block(a, blk);
  } else {
    const int j = blk - a.n;
    background_block(a, j / a.tiles, j % a.tiles);
  }
}

}  // namespace

// Intersections a vote block takes: g * g may not exceed it.
CAMKIFU_API int camkifu_vote_scan_threads() { return THREADS; }

// `tensors` holds 20 device pointers in Args' order: lab_cont, lab_clus,
// lab_nn, conf_cont, conf_clus, conf_nn, zone_calm, agitation,
// region_agree, luma_small, votes, stable, bg, trust, then the outputs
// labels, conf, votes, stable, bg, trust. `consts` holds Consts' 10 floats
// in order. Frames at index >= nvalid (0 <= nvalid <= b) leave the carry.
CAMKIFU_API int camkifu_vote_scan(void* const* tensors, const float* consts,
                                  int n, int b, int g, int npix, int nvalid,
                                  void* stream) {
  if (n < 0 || b < 0 || g < 1 || g * g > THREADS || npix < 1 ||
      nvalid < 0 || nvalid > b)
    return (int)cudaErrorInvalidValue;
  const int tiles = (npix + THREADS - 1) / THREADS;
  const long blocks = (long)n * (1 + tiles);
  if (blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  Args a;
  for (int i = 0; i < 3; ++i) {
    a.lab[i] = (const int8_t*)tensors[i];
    a.conf[i] = (const float*)tensors[3 + i];
  }
  a.calm = (const float*)tensors[6];
  a.agit = (const float*)tensors[7];
  a.ragree = (const float*)tensors[8];
  a.luma = (const float*)tensors[9];
  a.votes = (const float*)tensors[10];
  a.stable = (const int8_t*)tensors[11];
  a.bg = (const float*)tensors[12];
  a.trust = (const float*)tensors[13];
  a.labels_out = (int8_t*)tensors[14];
  a.conf_out = (float*)tensors[15];
  a.votes_out = (float*)tensors[16];
  a.stable_out = (int8_t*)tensors[17];
  a.bg_out = (float*)tensors[18];
  a.trust_out = (float*)tensors[19];
  a.n = n;
  a.b = b;
  a.g = g;
  a.npix = npix;
  a.nvalid = nvalid;
  a.tiles = tiles;
  a.k = Consts{consts[0], consts[1], consts[2], consts[3], consts[4],
               consts[5], consts[6], consts[7], consts[8], consts[9]};
  vote_scan_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
