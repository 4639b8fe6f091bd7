// K3: flow warp as a bounded-window stencil, forward and adjoint, for
// sm_90a. Replaces the TPU kernel `_warp_kernel` of
// tclight_tpu/ops/warp_kernel.py; the plain version is `window_warp_plain`
// in tclight_torch/ops/warp_kernel.py.
//
//   forward  out[p] = sum_d k(dy - fy[p]) k(dx - fx[p]) x[p + d]
//   adjoint  adj[q] = sum_d k(dy + fy[q+d]) k(dx + fx[q+d]) g[q + d]
//
// over |dy|, |dx| <= rh = radius + kernel radius RK (Keys cubic, a =
// -0.75: RK = 2; bilinear: RK = 1), zero outside the frame. x and g are
// NHWC f32 with C <= 4 channels; flows NHW2 f32 as [dx, dy]. Taps beyond
// the radius are dropped, as in the TPU kernel.
//
// What bounds it on the H100: with a smooth flow (the post-optimization's)
// a pixel has 2RK x 2RK taps of weight, and the kernel must move x (or g),
// the flows and the output once: bytes. With a wide flow range per tile
// the tap arithmetic grows (operations).
//
// Design. One block of 256 threads per 32 x 64 output tile; a thread owns
// column t % 64 of rows t / 64 + 4i, i < 8, so a warp covers 32
// neighbouring pixels of one row.
//  - Forward, a direct gather: a pixel reads its flow as one float2,
//    computes its 2RK + 2RK separable weights once (a tap outside the frame
//    or the radius gets weight 0 and a clamped address) and sums its 4RK^2
//    taps' C channels without a branch, reading x through L1: a warp's taps
//    are 32 neighbouring pixels of the same few rows, so the tile's source
//    window crosses device memory about once. A window staged in shared
//    memory first (the TPU kernel's design: the tile's flow range, then the
//    bounded window copied in coalesced rows, in chunks beyond a budget)
//    measured twice as slow on the H100 (0.39 against 0.20 ms at
//    16 x 720 x 960 x 3, r = 4, PERF.md), so neither direction stages a
//    window and there is no chunked route: a wide flow range costs taps,
//    not shared memory.
//  - Adjoint, as the scatter it is. First the flow range over the tile's
//    halo window (tile +- rh, clipped to the frame), as the TPU kernel
//    bounds its taps (warp_kernel.py:129-141): a tap d reads the flow at
//    q + d, so the taps with a nonzero weight lie in floor(-max f) - RK + 1
//    .. floor(-min f) + RK, clipped to [-rh, rh], and the sources that can
//    reach the tile in the tile moved by that range. Each such source s in
//    the frame (read once, coalesced by rows) computes its 2RK + 2RK
//    weights once from its own flow and adds w * g[s] into the 2RK x 2RK
//    outputs q = s - d of the tile that its taps d reach (|d| <= rh), by
//    shared-memory atomic adds into the tile's accumulators (C x 32 x 64).
//    That is 4RK^2 adds a source however wide the flow range, where a
//    gather walks the whole bounded window per output (53 x 53 taps at r =
//    24).
//  - Deterministic sums. The adds land in no fixed order, so the
//    accumulators are fixed point, whose sums do not depend on the order:
//    the same inputs give the same bits on every run. An output's sum is
//    held in two 32-bit limbs: one shared-memory atomic add of a 64-bit
//    integer measured slower on the H100 than two of 32 bits (PERF.md).
//    The same pass that takes the flow range takes
//    gmax = max |g| over the halo. A term is |w g| <= gmax (|k| <= 1), and
//    an output receives at most one term per tap of the bounded range (its
//    source is q + d): ntap = (hi_y - lo_y + 1)(hi_x - lo_x + 1) terms.
//    With ntap < 2^(32 - L) and gmax < 2^e1, a term T, the f32 product
//    w * (g 2^k) rounded once to an integer (scaling by a power of two is
//    exact), with k = 2L - 2 - e1, sums below 2^(L + 30). Its low L bits
//    go to an unsigned limb (ntap of them sum below 2^32) and T >> L to a
//    signed one (they sum below 2^30 + ntap < 2^31 in magnitude, as the
//    entry point's radius <= 16000 keeps ntap < 2^30); the output is
//    (high << L) + low, times 2^-k. k is clamped to [-100, 126], where 2^k
//    and 2^-k are normal f32 (-100 is never reached). An output's error is
//    at most ntap half-units of 2^-k, below ntap^3 2^-60 gmax: 2^-37 gmax
//    at r = 4, 2^-25 at r = 24, 2^-13 at r = 100 (an f32 sum of 16 such
//    terms errs by up to about 2^-20 gmax). A non-finite g in the halo
//    makes the tile's outputs NaN.
//  - The outputs go out per thread, a warp's 32 pixels one contiguous span.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TH = 32, TW = 64;          // output tile, rows x columns
constexpr int THREADS = 256;
constexpr int ROWS_PER_STEP = THREADS / TW;  // 4
constexpr int PIX = TH / ROWS_PER_STEP;      // 8 pixels a thread
constexpr int MAXC = 4;

// the weight of tap i of 2RK at signed distance s, |s| in the region that
// tap always lies in: Keys cubic (a = -0.75) near for the inner two taps,
// far for the outer two (both are 0 at |s| = 1 and far is 0 at 2, as
// `window_warp_plain`'s kernel), or bilinear
template <int RK>
__device__ __forceinline__ float tap_weight(int i, float s) {
  s = fabsf(s);
  if constexpr (RK == 1) return fmaxf(0.f, 1.f - s);
  const float a = -0.75f;
  if (i == 1 || i == 2) return ((a + 2.f) * s - (a + 3.f)) * s * s + 1.f;
  return (((s - 5.f) * s + 8.f) * s - 4.f) * a;
}

// min (even i) / max (odd i) of N values over the block (red: N x 8 floats)
template <int N>
__device__ __forceinline__ void block_range(float (&v)[N], float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float u = __shfl_xor_sync(0xffffffffu, v[i], o);
      v[i] = (i & 1) ? fmaxf(v[i], u) : fminf(v[i], u);
    }
  const int lane = threadIdx.x % 32, wid = threadIdx.x / 32;
  if (lane == 0)
#pragma unroll
    for (int i = 0; i < N; ++i) red[i * 8 + wid] = v[i];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float r = red[i * 8];
    for (int w = 1; w < THREADS / 32; ++w)
      r = (i & 1) ? fmaxf(r, red[i * 8 + w]) : fminf(r, red[i * 8 + w]);
    v[i] = r;
  }
}

// 2^e as an f32, for -126 <= e <= 127
__device__ __forceinline__ float pow2(int e) { return __int_as_float((127 + e) << 23); }

template <int C, int RK>
__global__ void __launch_bounds__(THREADS)
window_warp_fwd_kernel(const float* __restrict__ x, const float* __restrict__ flows,
                       float* __restrict__ out, int h, int w, int rh) {
  constexpr int NW = 2 * RK;  // taps an axis
  const int n = blockIdx.z;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int tx = threadIdx.x % TW, ty = threadIdx.x / TW;
  const size_t plane = (size_t)h * w;
  const float* xn = x + (size_t)n * plane * C;
  const float2* fn = reinterpret_cast<const float2*>(flows) + (size_t)n * plane;
  float* on = out + (size_t)n * plane * C;
#pragma unroll 2
  for (int i = 0; i < PIX; ++i) {
    const int py = y0 + ty + ROWS_PER_STEP * i, px = x0 + tx;
    if (py >= h || px >= w) continue;
    const float2 f = fn[(size_t)py * w + px];
    // taps d = b + a: a tap outside the frame or the radius gets weight 0
    // and a clamped address
    const int by = (int)floorf(f.y) - RK + 1, bx = (int)floorf(f.x) - RK + 1;
    float wy[NW], wx[NW];
    int ry[NW], rx[NW];
#pragma unroll
    for (int a = 0; a < NW; ++a) {
      const int sy = py + by + a, sx = px + bx + a;
      const bool oky = sy >= 0 && sy < h && by + a >= -rh && by + a <= rh;
      const bool okx = sx >= 0 && sx < w && bx + a >= -rh && bx + a <= rh;
      wy[a] = oky ? tap_weight<RK>(a, (float)(by + a) - f.y) : 0.f;
      wx[a] = okx ? tap_weight<RK>(a, (float)(bx + a) - f.x) : 0.f;
      ry[a] = min(max(sy, 0), h - 1) * w;
      rx[a] = min(max(sx, 0), w - 1);
    }
    float acc[C];
#pragma unroll
    for (int ch = 0; ch < C; ++ch) acc[ch] = 0.f;
#pragma unroll
    for (int a = 0; a < NW; ++a)
#pragma unroll
      for (int b = 0; b < NW; ++b) {
        const float wgt = wy[a] * wx[b];
        const float* src = xn + (size_t)(ry[a] + rx[b]) * C;
#pragma unroll
        for (int ch = 0; ch < C; ++ch) acc[ch] = fmaf(wgt, __ldg(src + ch), acc[ch]);
      }
    float* o = on + ((size_t)py * w + px) * C;
#pragma unroll
    for (int ch = 0; ch < C; ++ch) o[ch] = acc[ch];
  }
}

template <int C, int RK>
__global__ void __launch_bounds__(THREADS, 4)  // 4 blocks an SM at C = 3: 48 KB each
window_warp_adj_kernel(const float* __restrict__ g, const float* __restrict__ flows,
                       float* __restrict__ out, int h, int w, int rh) {
  constexpr int NW = 2 * RK;
  // the tile's fixed-point accumulators (dynamic: 16 KB a channel): the
  // low limbs, C x TH x TW unsigned, then the high limbs, C x TH x TW int
  extern __shared__ unsigned so[];
  __shared__ float red[6 * 8];
  const int n = blockIdx.z;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int tx = threadIdx.x % TW, ty = threadIdx.x / TW;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const size_t plane = (size_t)h * w;
  const float* gn = g + (size_t)n * plane * C;
  const float2* fn = reinterpret_cast<const float2*>(flows) + (size_t)n * plane;
  float* on = out + (size_t)n * plane * C;
  for (int i = threadIdx.x; i < 2 * C * TH * TW; i += THREADS) so[i] = 0u;

  // 1. the flow range and max |g| over the halo window, clipped to the
  //    frame (a source outside the frame holds a zero cotangent and adds
  //    nothing); a non-finite g counts as infinite. v[4] is unused.
  float v[6] = {INFINITY, -INFINITY, INFINITY, -INFINITY, 0.f, 0.f};
  {
    const int hy0 = max(y0 - rh, 0), hy1 = min(y0 + TH - 1 + rh, h - 1);
    const int hx0 = max(x0 - rh, 0), hx1 = min(x0 + TW - 1 + rh, w - 1);
    for (int r = hy0 + warp; r <= hy1; r += THREADS / 32)
      for (int cx = hx0 + lane; cx <= hx1; cx += 32) {
        const size_t s = (size_t)r * w + cx;
        const float2 f = fn[s];
        v[0] = fminf(v[0], f.x); v[1] = fmaxf(v[1], f.x);
        v[2] = fminf(v[2], f.y); v[3] = fmaxf(v[3], f.y);
#pragma unroll
        for (int ch = 0; ch < C; ++ch) {
          const float a = fabsf(gn[s * C + ch]);
          v[5] = fmaxf(v[5], a <= 3.402823466e38f ? a : INFINITY);
        }
      }
  }
  block_range(v, red);  // its __syncthreads also orders the zeroing
  const int lo_y = max((int)floorf(-v[3]) - RK + 1, -rh), hi_y = min((int)floorf(-v[2]) + RK, rh);
  const int lo_x = max((int)floorf(-v[1]) - RK + 1, -rh), hi_x = min((int)floorf(-v[0]) + RK, rh);
  const bool finite = v[5] <= 3.402823466e38f;

  // 2. the fixed-point scale 2^k and the low limb's width L (header):
  //    gmax < 2^e1, ntap < 2^(32 - L)
  int e1;
  frexpf(v[5], &e1);
  const unsigned ntap = (unsigned)max(hi_y - lo_y + 1, 1) * (unsigned)max(hi_x - lo_x + 1, 1);
  const int L = __clz((int)ntap);
  const int k = min(max(2 * L - 2 - e1, -100), 126);
  const long long low = (1ll << L) - 1;
  const float up = pow2(k);

  // 3. every source of the window, in the frame, scatters into the tile
  const int sy0 = max(y0 + lo_y, 0), sy1 = min(y0 + TH - 1 + hi_y, h - 1);
  const int sx0 = max(x0 + lo_x, 0), sx1 = min(x0 + TW - 1 + hi_x, w - 1);
  for (int sy = sy0 + warp; finite && sy <= sy1; sy += THREADS / 32) {
    for (int sx = sx0 + lane; sx <= sx1; sx += 32) {
      const size_t s = (size_t)sy * w + sx;
      const float2 f = fn[s];
      float gv[C];
#pragma unroll
      for (int ch = 0; ch < C; ++ch) gv[ch] = gn[s * C + ch] * up;
      // taps d = b + i reach q = s - d with weight k(d + f)
      const int by = (int)floorf(-f.y) - RK + 1, bx = (int)floorf(-f.x) - RK + 1;
      float wy[NW], wx[NW];
      int qy[NW], qx[NW];
#pragma unroll
      for (int a = 0; a < NW; ++a) {
        qy[a] = sy - (by + a) - y0;
        qx[a] = sx - (bx + a) - x0;
        const bool oky = qy[a] >= 0 && qy[a] < TH && by + a >= -rh && by + a <= rh;
        const bool okx = qx[a] >= 0 && qx[a] < TW && bx + a >= -rh && bx + a <= rh;
        wy[a] = oky ? tap_weight<RK>(a, (float)(by + a) + f.y) : 0.f;
        wx[a] = okx ? tap_weight<RK>(a, (float)(bx + a) + f.x) : 0.f;
      }
#pragma unroll
      for (int a = 0; a < NW; ++a) {
        if (wy[a] == 0.f) continue;
#pragma unroll
        for (int b = 0; b < NW; ++b) {
          if (wx[b] == 0.f) continue;
          const float wgt = wy[a] * wx[b];
#pragma unroll
          for (int ch = 0; ch < C; ++ch) {
            const long long t = __float2ll_rn(wgt * gv[ch]);
            const int i = (ch * TH + qy[a]) * TW + qx[b];
            atomicAdd(&so[i], (unsigned)(t & low));
            atomicAdd(reinterpret_cast<int*>(&so[C * TH * TW + i]), (int)(t >> L));
          }
        }
      }
    }
  }
  __syncthreads();
  // 4. the outputs: a warp's 32 pixels are one contiguous span
  const float down = pow2(-k);
#pragma unroll
  for (int i = 0; i < PIX; ++i) {
    const int ly = ty + ROWS_PER_STEP * i, py = y0 + ly, px = x0 + tx;
    if (py >= h || px >= w) continue;
    float* o = on + ((size_t)py * w + px) * C;
#pragma unroll
    for (int ch = 0; ch < C; ++ch) {
      const int j = (ch * TH + ly) * TW + tx;
      const long long sum = (long long)(int)so[C * TH * TW + j] * (1ll << L) + (long long)so[j];
      o[ch] = finite ? __ll2float_rn(sum) * down : NAN;
    }
  }
}

template <int C, int RK>
cudaError_t launch(const float* x, const float* flows, float* out, int n, int h, int w,
                   int rh, bool adjoint, cudaStream_t s) {
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, n);
  if (adjoint) {
    constexpr int smem = 2 * C * TH * TW * 4;  // C = 4 takes more than the default 48 KB
    static bool attr_set = false;  // once per kernel instance, not per launch
    if (!attr_set) {
      cudaError_t err = cudaFuncSetAttribute(window_warp_adj_kernel<C, RK>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
      attr_set = true;
    }
    window_warp_adj_kernel<C, RK><<<grid, THREADS, smem, s>>>(x, flows, out, h, w, rh);
  } else {
    window_warp_fwd_kernel<C, RK><<<grid, THREADS, 0, s>>>(x, flows, out, h, w, rh);
  }
  return cudaSuccess;
}

}  // namespace

// x, flows, out: device pointers (NHWC f32, NHW2 f32, NHWC f32); mode 0 =
// bicubic, 1 = bilinear. Returns the cudaError_t of the launch.
extern "C" int tclight_window_warp_f32(const float* x, const float* flows, float* out,
                                       int n, int h, int w, int c, int radius, int mode,
                                       int adjoint, void* stream) {
  // radius <= 16000 keeps the adjoint's ntap below 2^30 (its high limb)
  if (c < 1 || c > MAXC || (mode != 0 && mode != 1) || radius < 0 || n > 65535 ||
      radius > 16000)
    return (int)cudaErrorInvalidValue;
  if (n == 0 || h == 0 || w == 0) return 0;
  const int rk = mode == 1 ? 1 : 2;
  const int rh = radius + rk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
#define TCLIGHT_WARP_CASE(C_)                                                      \
  case C_:                                                                         \
    err = rk == 2 ? launch<C_, 2>(x, flows, out, n, h, w, rh, adjoint != 0, s)     \
                  : launch<C_, 1>(x, flows, out, n, h, w, rh, adjoint != 0, s);    \
    break;
  switch (c) {
    TCLIGHT_WARP_CASE(1) TCLIGHT_WARP_CASE(2) TCLIGHT_WARP_CASE(3) TCLIGHT_WARP_CASE(4)
  }
#undef TCLIGHT_WARP_CASE
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
