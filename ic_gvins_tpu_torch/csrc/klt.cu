// Bidirectional pyramidal Lucas-Kanade tracker for Hopper (sm_90a).
//
// Replaces the TPU kernel ic_gvins_tpu/vision/klt_pallas.py:_track_level_pallas
// (one pallas_call per pyramid level and direction) and the functions around it,
// lk_track_pallas / lk_track_bidirectional_pallas. The semantics follow the
// plain tracker ic_gvins_tpu/vision/klt.py (and its PyTorch twin
// ic_gvins_tpu_torch/vision/klt.py), not the Pallas kernel's edge rules:
//   * bounds are image bounds only (no search-window gate), the entry gate
//     is klt.py's (x in [10, w-11], y in [10, h-11]);
//   * bilinear taps clip their base index to [0, w-2] x [0, h-2], the
//     weights come from the unclipped floor;
//   * every level starts from the input valid flag, only level 0's ok counts;
//   * the backward pass starts from the forward result, seeds from pts0 and
//     takes the forward ok as its valid;
//   * the 30-step loop exits once a step is < 0.01 px (tested on the squared
//     norm) or would leave the image, which gives the result of klt.py's
//     fixed 30-trip frozen loop; level coordinates are scaled by exact
//     powers of two (a multiplication where klt.py divides: same value).
// The only deliberate difference is arithmetic: sums of the 441 window
// terms are taken in another order (per-thread partial sums, a warp
// butterfly, then the four warp sums in a fixed order); the bilinear
// weights are taken once per point from its own fractional part, where
// klt.py takes them per window pixel from the rounded sum point + offset;
// and nvcc may contract a*b+c into FMAs. So points differ from the plain
// version by rounding, and by up to one convergence step where a step norm
// sits at the 0.01 px threshold.
//
// What bounds it on this card: neither bytes nor operations but latency.
// A call moves a few MB of distinct pixels and does a few hundred MFLOP
// (microseconds of either), yet each feature runs a serial chain of 8
// level passes with up to 30 dependent Gauss-Newton steps, and at 200
// features the card is mostly empty; with thousands of features the
// limit is the instructions issued per sample (index arithmetic, not
// flop). The design shortens the chain's links:
//   * one block of 128 threads per feature, each thread owning at most 4 of
//     the 441 window pixels (template value and both gradients in registers);
//   * per level the block stages two tiles in shared memory with cp.async:
//     the 25 x 25 neighbourhood of the template point (window, +-1 gradient
//     taps, +1 bilinear tap) and a 32 x 32 search tile of the other image
//     around the estimate; every Gauss-Newton step then reads its taps from
//     shared memory, and the tile is reloaded only when the estimate leaves
//     its 5 px margin;
//   * copies overlap compute: the search tile is issued before the template
//     is built, and the next finer level's template tile (its centre is known
//     from the start) is prefetched into a second buffer while this level
//     iterates;
//   * all window pixels sit at integer offsets from one point, so a step
//     computes the four bilinear weights once and each sample is four
//     shared-memory reads and four multiply-adds from a clipped base index;
//   * the dot products are reduced by a warp butterfly and the four warp
//     sums are added by every thread in the same order, so all threads hold
//     bit-identical steps and the stop test is block-uniform without a vote.
// All levels and both directions run in one launch. Beside its results the
// kernel writes, per feature, how many passes it ran at each level and how
// many Gauss-Newton steps in all: the work from which a call's roofline
// bound is computed.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int WIN = 21;
constexpr int HALF = WIN / 2;
constexpr int NPIX = WIN * WIN;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
static_assert(WARPS == 4, "block_sum adds four warp sums");
constexpr int PER_THREAD = (NPIX + THREADS - 1) / THREADS;
constexpr int MAX_ITERS = 30;
constexpr float EPS_STEP = 0.01f;
constexpr float MIN_EIG = 1e-4f;
constexpr int MAX_LEVELS = 8;

// Template tile: samples sit at floor(p0) + k with k in [-11, 11] (window
// and gradient taps) and read the base and its +1 tap: 24 entries from the
// origin floor(p0) - 11; 25 keeps the row stride odd.
constexpr int T_ORG = HALF + 1;
constexpr int TT = 2 * T_ORG + 3;
// Search tile: the window around an estimate p needs [floor(p) - 10,
// floor(p) + 11]; a 32-wide tile from floor(p) - 15 leaves 5 px of margin
// each way. Each level re-centres it on the seed, so only a move of more
// than 5 px within one level pays for a reload. (Measured on an H100 at
// 200 / 1000 / 4000 features: 48 x 48 took 5-10% longer.)
constexpr int ST = 32;
constexpr int ST_STRIDE = ST + 1;  // odd row stride: fewer bank conflicts
constexpr int S_ORG = HALF + (ST - 2 * HALF - 2) / 2;

struct Pyramids {
  const float* a[MAX_LEVELS];  // previous frame, level 0 first
  const float* b[MAX_LEVELS];  // current frame
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
  int levels;
};

struct Shared {
  float tmpl[2][TT * TT];
  float search[ST * ST_STRIDE];
  float red[2][WARPS][3];
};

// Asynchronously copy the SIZE x SIZE tile of img with origin (ox, oy) into
// shared memory; coordinates outside the image are clamped (those entries
// are never sampled, the clamp only keeps the addresses valid).
template <int SIZE, int STRIDE>
__device__ __forceinline__ void load_tile(float* dst, const float* img, int h,
                                          int w, int ox, int oy, int tid) {
  if (ox >= 0 && oy >= 0 && ox + SIZE <= w && oy + SIZE <= h) {
    const float* src = img + static_cast<size_t>(oy) * w + ox;
    for (int i = tid; i < SIZE * SIZE; i += THREADS) {
      const int r = i / SIZE, c = i % SIZE;
      __pipeline_memcpy_async(dst + r * STRIDE + c, src + r * w + c,
                              sizeof(float));
    }
    return;
  }
  for (int i = tid; i < SIZE * SIZE; i += THREADS) {
    const int r = i / SIZE, c = i % SIZE;
    const int gy = min(max(oy + r, 0), h - 1);
    const int gx = min(max(ox + c, 0), w - 1);
    __pipeline_memcpy_async(dst + r * STRIDE + c,
                            img + static_cast<size_t>(gy) * w + gx,
                            sizeof(float));
  }
}

// Integer part and bilinear weights of a point. Every window pixel sits
// at an integer offset from it and shares the weights.
struct Frac {
  int ix, iy;
  float w00, w01, w10, w11;
};

__device__ __forceinline__ Frac frac_of(float x, float y) {
  const float fx = floorf(x), fy = floorf(y);
  const float ax = x - fx, ay = y - fy;
  return {static_cast<int>(fx), static_cast<int>(fy), (1.f - ay) * (1.f - ax),
          (1.f - ay) * ax, ay * (1.f - ax), ay * ax};
}

// Bilinear sample from a tile whose origin is (ox, oy) in the image, at the
// pixel (x, y) + the fraction of f. As in klt.py the base index is clipped
// to [0, w-2] x [0, h-2] while the weights stay those of the unclipped
// point; the clipped base is then moved into the tile, so the first and
// last rows and columns behave as in the image.
__device__ __forceinline__ float bilinear(const float* tile, int stride, int ox,
                                          int oy, int h, int w, int y, int x,
                                          const Frac& f) {
  const int bx = min(max(x, 0), w - 2) - ox;
  const int by = min(max(y, 0), h - 2) - oy;
  const float* p = tile + by * stride + bx;
  return f.w00 * p[0] + f.w01 * p[1] + f.w10 * p[stride] +
         f.w11 * p[stride + 1];
}

// Sum N values over the block; every thread returns bit-identical sums.
// Successive calls alternate between the two slot sets (phase), so one
// barrier per call is enough: a set is rewritten only two calls later,
// after a barrier that every reader of it has passed.
template <int N>
__device__ __forceinline__ void block_sum(float (&v)[N], float (*red)[WARPS][3],
                                          int& phase, int tid) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
  }
  float(*slot)[3] = red[phase];
  if ((tid & 31) == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) slot[tid >> 5][i] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i)
    v[i] = (slot[0][i] + slot[1][i]) + (slot[2][i] + slot[3][i]);
  phase ^= 1;
}

__device__ __forceinline__ bool in_bounds(float x, float y, int h, int w) {
  return x >= HALF && x <= w - 1 - HALF && y >= HALF && y <= h - 1 - HALF;
}

// Coarse to fine over all levels in one direction; the whole block works
// on one feature and every thread returns the same (out_x, out_y, ok).
__device__ void track_pyramid(const Pyramids& P, bool backward, float x0,
                              float y0, float x1, float y1, bool ok_in,
                              float& out_x, float& out_y, bool& ok, Shared& sm,
                              int& phase, int& passes, int& steps, int tid) {
  const int L = P.levels;
  float px = x1 * ldexpf(1.f, 1 - L), py = y1 * ldexpf(1.f, 1 - L);
  ok = ok_in;
  bool prefetched = false;  // this level's template tile is already on its way
  for (int lv = L - 1; lv >= 0; --lv) {
    if (lv < L - 1) {
      px *= 2.f;
      py *= 2.f;
    }
    const float s = ldexpf(1.f, -lv);
    const float* I0 = backward ? P.b[lv] : P.a[lv];
    const float* I1 = backward ? P.a[lv] : P.b[lv];
    const int h = P.h[lv], w = P.w[lv];
    const float p0x = x0 * s, p0y = y0 * s;
    float* tmpl = sm.tmpl[lv & 1];
    bool ok_lv = false;

    // the gates that need no pixels; a level that fails them leaves the
    // estimate as it is (block-uniform)
    if (!(ok_in && in_bounds(p0x, p0y, h, w) && in_bounds(px, py, h, w))) {
      __pipeline_wait_prior(0);  // a prefetch into tmpl may still be in flight
      prefetched = false;
      if (lv == 0) ok = false;
      continue;
    }

    passes += 1 << (4 * lv);  // one hex digit per level
    // copy group 1: this level's template tile, unless it was prefetched
    const int tox = static_cast<int>(floorf(p0x)) - T_ORG;
    const int toy = static_cast<int>(floorf(p0y)) - T_ORG;
    if (!prefetched) load_tile<TT, TT>(tmpl, I0, h, w, tox, toy, tid);
    __pipeline_commit();
    // group 2: the search tile around the estimate
    int sox = static_cast<int>(floorf(px)) - S_ORG;
    int soy = static_cast<int>(floorf(py)) - S_ORG;
    load_tile<ST, ST_STRIDE>(sm.search, I1, h, w, sox, soy, tid);
    __pipeline_commit();
    // group 3: the next finer level's template tile into the other buffer
    prefetched = false;
    if (lv > 0) {
      const float sn = ldexpf(1.f, 1 - lv);
      const float nx = x0 * sn, ny = y0 * sn;
      const int hn = P.h[lv - 1], wn = P.w[lv - 1];
      if (in_bounds(nx, ny, hn, wn)) {
        load_tile<TT, TT>(sm.tmpl[(lv - 1) & 1],
                          backward ? P.b[lv - 1] : P.a[lv - 1], hn, wn,
                          static_cast<int>(floorf(nx)) - T_ORG,
                          static_cast<int>(floorf(ny)) - T_ORG, tid);
        prefetched = true;
      }
    }
    __pipeline_commit();

    // template, gradients and structure tensor from the template tile
    __pipeline_wait_prior(2);
    __syncthreads();
    float t[PER_THREAD], gx[PER_THREAD], gy[PER_THREAD];
    int kx[PER_THREAD], ky[PER_THREAD];
    float g[3] = {0.f, 0.f, 0.f};
    const Frac f0 = frac_of(p0x, p0y);
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) {
      const int k = tid + THREADS * j;
      t[j] = gx[j] = gy[j] = 0.f;
      ky[j] = k / WIN - HALF;
      kx[j] = k % WIN - HALF;
      if (k < NPIX) {
        const int ys = f0.iy + ky[j], xs = f0.ix + kx[j];
        t[j] = bilinear(tmpl, TT, tox, toy, h, w, ys, xs, f0);
        gx[j] = 0.5f * (bilinear(tmpl, TT, tox, toy, h, w, ys, xs + 1, f0) -
                        bilinear(tmpl, TT, tox, toy, h, w, ys, xs - 1, f0));
        gy[j] = 0.5f * (bilinear(tmpl, TT, tox, toy, h, w, ys + 1, xs, f0) -
                        bilinear(tmpl, TT, tox, toy, h, w, ys - 1, xs, f0));
        g[0] += gx[j] * gx[j];
        g[1] += gx[j] * gy[j];
        g[2] += gy[j] * gy[j];
      }
    }
    block_sum<3>(g, sm.red, phase, tid);
    const float gxx = g[0], gxy = g[1], gyy = g[2];
    const float det = gxx * gyy - gxy * gxy;
    const float tr = gxx + gyy;
    const float min_eig =
        0.5f * (tr - sqrtf(fmaxf(tr * tr - 4.f * det, 0.f))) / NPIX;
    const float inv = det > 1e-12f ? 1.f / det : 0.f;
    const bool ok0 = min_eig > MIN_EIG;

    // Gauss-Newton steps from the search tile
    __pipeline_wait_prior(1);
    __syncthreads();
    bool done = !ok0;
    for (int it = 0; it < MAX_ITERS && !done; ++it) {
      ++steps;
      const Frac f1 = frac_of(px, py);
      const int ix = f1.ix, iy = f1.iy;
      if (ix - HALF < sox || ix + HALF + 1 > sox + ST - 1 || iy - HALF < soy ||
          iy + HALF + 1 > soy + ST - 1) {
        // the estimate left the tile's margin: centre a new tile on it (all
        // threads are past the previous step's barrier, so none reads the
        // old tile any more)
        sox = ix - S_ORG;
        soy = iy - S_ORG;
        load_tile<ST, ST_STRIDE>(sm.search, I1, h, w, sox, soy, tid);
        __pipeline_commit();
        __pipeline_wait_prior(0);
        __syncthreads();
      }
      float b[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < PER_THREAD; ++j) {
        if (tid + THREADS * j < NPIX) {
          const float d = bilinear(sm.search, ST_STRIDE, sox, soy, h, w,
                                   iy + ky[j], ix + kx[j], f1) -
                          t[j];
          b[0] += d * gx[j];
          b[1] += d * gy[j];
        }
      }
      block_sum<2>(b, sm.red, phase, tid);
      const float dx = -inv * (gyy * b[0] - gxy * b[1]);
      const float dy = -inv * (gxx * b[1] - gxy * b[0]);
      const bool step_ok = in_bounds(px + dx, py + dy, h, w);
      if (step_ok) {
        px += dx;
        py += dy;
      }
      done = dx * dx + dy * dy < EPS_STEP * EPS_STEP || !step_ok;
    }
    ok_lv = ok0 && in_bounds(px, py, h, w);
    // every read of the search tile and of this template buffer is done
    // before the next level overwrites them
    __syncthreads();
    if (lv == 0) ok = ok && ok_lv;
  }
  out_x = px;
  out_y = py;
}

__global__ void __launch_bounds__(THREADS)
    klt_bidirectional_kernel(Pyramids P, const float* __restrict__ pts0,
                             const float* __restrict__ pts1_init,
                             const unsigned char* __restrict__ valid,
                             float* __restrict__ pts1_out,
                             float* __restrict__ fb_out,
                             int* __restrict__ work_out,
                             unsigned char* __restrict__ ok_out,
                             float fb_thresh) {
  __shared__ Shared sm;
  const int f = blockIdx.x;
  const int tid = threadIdx.x;
  int phase = 0, passes = 0, steps = 0;
  const float x0 = pts0[2 * f], y0 = pts0[2 * f + 1];
  float x1, y1, bx, by;
  bool ok_f, ok_b;
  track_pyramid(P, false, x0, y0, pts1_init[2 * f], pts1_init[2 * f + 1],
                valid[f] != 0, x1, y1, ok_f, sm, phase, passes, steps, tid);
  track_pyramid(P, true, x1, y1, x0, y0, ok_f, bx, by, ok_b, sm, phase, passes,
                steps, tid);
  const float ex = bx - x0, ey = by - y0;
  const float fb = sqrtf(ex * ex + ey * ey);
  if (tid == 0) {
    pts1_out[2 * f] = x1;
    pts1_out[2 * f + 1] = y1;
    fb_out[f] = fb;
    work_out[2 * f] = passes;
    work_out[2 * f + 1] = steps;
    ok_out[f] = (ok_f && ok_b && fb < fb_thresh) ? 1 : 0;
  }
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// imgs holds 2 * levels device pointers to contiguous float32 images: the
// previous frame's pyramid, level 0 first, then the current frame's;
// shapes holds (height, width) of each of the `levels` levels. work_out
// [n, 2] receives each feature's (level passes, Gauss-Newton steps); the
// passes are packed, 4 bits per level (at most 2 each: forward, backward),
// level 0 in the lowest.
extern "C" int klt_bidirectional_launch(
    const float* const* imgs, const int* shapes, int levels, const float* pts0,
    const float* pts1_init, const unsigned char* valid, float* pts1_out,
    float* fb_out, int* work_out, unsigned char* ok_out, int n,
    float fb_thresh, void* stream) {
  if (levels < 1 || levels > MAX_LEVELS || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Pyramids P;
  for (int i = 0; i < MAX_LEVELS; ++i) {
    const bool on = i < levels;
    P.a[i] = on ? imgs[i] : nullptr;
    P.b[i] = on ? imgs[levels + i] : nullptr;
    P.h[i] = on ? shapes[2 * i] : 0;
    P.w[i] = on ? shapes[2 * i + 1] : 0;
  }
  P.levels = levels;
  if (n == 0) return 0;
  klt_bidirectional_kernel<<<n, THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      P, pts0, pts1_init, valid, pts1_out, fb_out, work_out, ok_out, fb_thresh);
  return static_cast<int>(cudaGetLastError());
}
