// Bidirectional pyramidal Lucas-Kanade tracker for Hopper (sm_90a).
//
// Replaces the TPU kernel ic_gvins_tpu/vision/klt_pallas.py:_track_level_pallas
// (one pallas_call per pyramid level and direction) and the functions around it,
// lk_track_pallas / lk_track_bidirectional_pallas. The semantics follow the
// plain tracker ic_gvins_tpu/vision/klt.py (and its PyTorch twin
// ic_gvins_tpu_torch/vision/klt.py), not the Pallas kernel's edge rules:
//   * bounds are image bounds only (no search-window gate), the entry gate
//     is klt.py's (x in [10, w-11], y in [10, h-11]);
//   * bilinear taps clip their base index to [0, w-2] x [0, h-2];
//   * every level starts from the input valid flag, only level 0's ok counts;
//   * the backward pass starts from the forward result, seeds from pts0 and
//     takes the forward ok as its valid;
//   * the 30-step loop exits once a step is < 0.01 px or would leave the
//     image, which gives the result of klt.py's fixed 30-trip frozen loop.
// The only deliberate difference is arithmetic: sums of the 441 window
// terms are taken in another order (per-lane partial sums, then a warp
// butterfly), and nvcc may contract a*b+c into FMAs, so points differ from
// the plain version by rounding, and by up to one convergence step where
// a step norm sits at the 0.01 px threshold.
//
// What bounds it on this card: gathers. Every Gauss-Newton step of every
// feature reads 441 bilinear samples = 1764 scattered 4-byte loads, and
// the template with its gradients another 5 x 1764 per level; arithmetic
// is a few FLOPs per load. The design keeps everything but the image
// samples in registers: one warp per feature, each lane owning 14 of the
// 441 window pixels (template value and both gradients in registers), the
// two dot products b1/b2 and the structure tensor reduced by warp shuffles
// (a butterfly, so every lane holds bit-identical sums and the loop exit
// is warp-uniform), all pyramid levels and both directions in one launch.
// Samples are read through the read-only cache (__ldg); a whole level-0
// image (1278 x 1022 f32 = 5.2 MB) and its pyramid sit in the 50 MB L2.
// Two warps per block spread 200 features over 100 blocks.

#include <cuda_runtime.h>

namespace {

constexpr int WIN = 21;
constexpr int HALF = WIN / 2;
constexpr int NPIX = WIN * WIN;
constexpr int PER_LANE = (NPIX + 31) / 32;
constexpr int MAX_ITERS = 30;
constexpr float EPS_STEP = 0.01f;
constexpr float MIN_EIG = 1e-4f;
constexpr int MAX_LEVELS = 8;
constexpr int WARPS_PER_BLOCK = 2;

struct Pyramids {
  const float* a[MAX_LEVELS];  // previous frame, level 0 first
  const float* b[MAX_LEVELS];  // current frame
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
  int levels;
};

__device__ __forceinline__ float bilinear(const float* __restrict__ img, int h,
                                          int w, float y, float x) {
  const float fx = floorf(x), fy = floorf(y);
  const float ax = x - fx, ay = y - fy;
  const int x0 = min(max(static_cast<int>(fx), 0), w - 2);
  const int y0 = min(max(static_cast<int>(fy), 0), h - 2);
  const float* p = img + static_cast<size_t>(y0) * w + x0;
  const float i00 = __ldg(p), i01 = __ldg(p + 1);
  const float i10 = __ldg(p + w), i11 = __ldg(p + w + 1);
  return i00 * (1.f - ay) * (1.f - ax) + i01 * (1.f - ay) * ax +
         i10 * ay * (1.f - ax) + i11 * ay * ax;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ bool in_bounds(float x, float y, int h, int w) {
  return x >= HALF && x <= w - 1 - HALF && y >= HALF && y <= h - 1 - HALF;
}

// One level for one feature; the whole warp works on it and every lane
// returns the same (px, py, ok).
__device__ void track_level(const float* __restrict__ I0,
                            const float* __restrict__ I1, int h, int w,
                            float p0x, float p0y, float& px, float& py,
                            bool ok_in, bool& ok_out, int lane) {
  float t[PER_LANE], gx[PER_LANE], gy[PER_LANE];
  float sxx = 0.f, sxy = 0.f, syy = 0.f;
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    const int k = lane + 32 * j;
    t[j] = gx[j] = gy[j] = 0.f;
    if (k < NPIX) {
      const float ys = p0y + static_cast<float>(k / WIN - HALF);
      const float xs = p0x + static_cast<float>(k % WIN - HALF);
      t[j] = bilinear(I0, h, w, ys, xs);
      gx[j] = 0.5f * (bilinear(I0, h, w, ys, xs + 1.f) -
                      bilinear(I0, h, w, ys, xs - 1.f));
      gy[j] = 0.5f * (bilinear(I0, h, w, ys + 1.f, xs) -
                      bilinear(I0, h, w, ys - 1.f, xs));
      sxx += gx[j] * gx[j];
      sxy += gx[j] * gy[j];
      syy += gy[j] * gy[j];
    }
  }
  const float gxx = warp_sum(sxx), gxy = warp_sum(sxy), gyy = warp_sum(syy);
  const float det = gxx * gyy - gxy * gxy;
  const float tr = gxx + gyy;
  const float min_eig =
      0.5f * (tr - sqrtf(fmaxf(tr * tr - 4.f * det, 0.f))) / NPIX;
  const float inv = det > 1e-12f ? 1.f / det : 0.f;
  const bool ok0 = ok_in && in_bounds(p0x, p0y, h, w) &&
                   in_bounds(px, py, h, w) && min_eig > MIN_EIG;

  bool done = !ok0;
  for (int it = 0; it < MAX_ITERS && !done; ++it) {
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) {
      const int k = lane + 32 * j;
      if (k < NPIX) {
        const float d =
            bilinear(I1, h, w, py + static_cast<float>(k / WIN - HALF),
                     px + static_cast<float>(k % WIN - HALF)) -
            t[j];
        s1 += d * gx[j];
        s2 += d * gy[j];
      }
    }
    const float b1 = warp_sum(s1), b2 = warp_sum(s2);
    const float dx = -inv * (gyy * b1 - gxy * b2);
    const float dy = -inv * (gxx * b2 - gxy * b1);
    const bool step_ok = in_bounds(px + dx, py + dy, h, w);
    if (step_ok) {
      px += dx;
      py += dy;
    }
    done = sqrtf(dx * dx + dy * dy) < EPS_STEP || !step_ok;
  }
  ok_out = ok0 && in_bounds(px, py, h, w);
}

// Coarse to fine over all levels in one direction.
__device__ void track_pyramid(const Pyramids& P, bool backward, float x0,
                              float y0, float x1, float y1, bool ok_in,
                              float& ox, float& oy, bool& ok, int lane) {
  const int L = P.levels;
  float px = x1 / ldexpf(1.f, L - 1), py = y1 / ldexpf(1.f, L - 1);
  ok = ok_in;
  for (int lv = L - 1; lv >= 0; --lv) {
    if (lv < L - 1) {
      px *= 2.f;
      py *= 2.f;
    }
    const float s = ldexpf(1.f, lv);
    const float* I0 = backward ? P.b[lv] : P.a[lv];
    const float* I1 = backward ? P.a[lv] : P.b[lv];
    bool ok_lv;
    track_level(I0, I1, P.h[lv], P.w[lv], x0 / s, y0 / s, px, py, ok_in,
                ok_lv, lane);
    if (lv == 0) ok = ok && ok_lv;
  }
  ox = px;
  oy = py;
}

__global__ void __launch_bounds__(32 * WARPS_PER_BLOCK)
    klt_bidirectional_kernel(Pyramids P, const float* __restrict__ pts0,
                             const float* __restrict__ pts1_init,
                             const unsigned char* __restrict__ valid,
                             float* __restrict__ pts1_out,
                             unsigned char* __restrict__ ok_out,
                             float* __restrict__ fb_out, int n,
                             float fb_thresh) {
  const int f = blockIdx.x * WARPS_PER_BLOCK + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (f >= n) return;  // uniform over the warp
  const float x0 = pts0[2 * f], y0 = pts0[2 * f + 1];
  float x1, y1, bx, by;
  bool ok_f, ok_b;
  track_pyramid(P, false, x0, y0, pts1_init[2 * f], pts1_init[2 * f + 1],
                valid[f] != 0, x1, y1, ok_f, lane);
  track_pyramid(P, true, x1, y1, x0, y0, ok_f, bx, by, ok_b, lane);
  const float ex = bx - x0, ey = by - y0;
  const float fb = sqrtf(ex * ex + ey * ey);
  if (lane == 0) {
    pts1_out[2 * f] = x1;
    pts1_out[2 * f + 1] = y1;
    ok_out[f] = (ok_f && ok_b && fb < fb_thresh) ? 1 : 0;
    fb_out[f] = fb;
  }
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// img0/img1/heights/widths are host arrays of `levels` entries, level 0
// first; every pointer is a contiguous float32 device image.
extern "C" int klt_bidirectional_launch(
    const float* const* img0, const float* const* img1, const int* heights,
    const int* widths, int levels, const float* pts0, const float* pts1_init,
    const unsigned char* valid, float* pts1_out, unsigned char* ok_out,
    float* fb_out, int n, float fb_thresh, void* stream) {
  if (levels < 1 || levels > MAX_LEVELS || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Pyramids P;
  for (int i = 0; i < MAX_LEVELS; ++i) {
    const bool on = i < levels;
    P.a[i] = on ? img0[i] : nullptr;
    P.b[i] = on ? img1[i] : nullptr;
    P.h[i] = on ? heights[i] : 0;
    P.w[i] = on ? widths[i] : 0;
  }
  P.levels = levels;
  if (n == 0) return 0;
  const int blocks = (n + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  klt_bidirectional_kernel<<<blocks, 32 * WARPS_PER_BLOCK, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      P, pts0, pts1_init, valid, pts1_out, ok_out, fb_out, n, fb_thresh);
  return static_cast<int>(cudaGetLastError());
}
