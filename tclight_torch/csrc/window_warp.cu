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
// Design. Blocks of 256 threads, a warp over 32 neighbouring pixels of one
// row.
//  - Forward, a direct gather on 4 x 64 tiles, a pixel a thread: a pixel
//    reads its flow as one float2, computes its 2RK + 2RK separable weights
//    once (a tap outside the frame or the radius gets weight 0 and a
//    clamped address) and sums its 4RK^2 taps' C channels without a
//    branch, reading x through L1: a warp's taps are 32 neighbouring pixels
//    of the same few rows, so the tile's source window crosses device
//    memory about once. The 32 x 64 tiles before (8 pixels a thread) left
//    a small frame batch's grid under one wave: 30 blocks at 2 x 160 x 192
//    took 0.029 ms, 4 x 64 tiles 0.013 (and 0.186 against 0.195 at 16 x 720
//    x 960, r = 4; 2 pixels a thread on 8 x 64 tiles was as fast but spilled;
//    ablate_postopt, NVIDIA H100 80GB HBM3, 700.00 W, PERF.md). A window
//    staged in shared memory first (the TPU kernel's design) measured twice
//    as slow (0.39 against 0.20 ms at 16 x 720 x 960 x 3, r = 4), so neither
//    direction stages a window and there is no chunked route: a wide flow
//    range costs taps, not shared memory.
//  - Weights. A tap's distance is i - (RK - 1) - u for u the flow's
//    fraction, and the Keys weights reduce to polynomials in u (no fabs, no
//    select; see tap_weight).
//  - Adjoint, as the scatter it is, a block per 32 x 64 output tile. First
//    the flow range over the tile's halo window (tile +- rh, clipped to the
//    frame), as the TPU kernel bounds its taps (warp_kernel.py:129-141): a
//    tap d reads the flow at q + d, so the taps with a nonzero weight lie
//    in floor(-max f) - RK + 1 .. floor(-min f) + RK, clipped to [-rh, rh],
//    and the sources that can reach the tile in the tile moved by that
//    range. Each such source s in the frame computes its 2RK + 2RK weights
//    once from its own flow and adds w * g[s] into the 2RK x 2RK outputs
//    q = s - d of the tile that its taps d reach (|d| <= rh), by
//    shared-memory atomic adds into the tile's accumulators (C x 32 x 64).
//    That is 4RK^2 adds a source however wide the flow range, where a
//    gather walks the whole bounded window per output (53 x 53 taps at r =
//    24). The halo and the sources are walked flattened (RectWalk), so
//    every lane has a pixel (walked by rows, 32 lanes a row, a 67-column
//    window left 29% of the lanes idle: with two limbs the flat walk took
//    0.304 against 0.353 ms on the same card), and rows of zero weight are
//    skipped whole.
//  - Deterministic sums. The adds land in no fixed order, so the
//    accumulators are fixed point, whose sums do not depend on the order:
//    the same inputs give the same bits on every run. The same pass that
//    takes the flow range takes gmax = max |g| over the halo. A term is
//    |w g| <= gmax (|k| <= 1), and an output receives at most one term per
//    tap of the bounded range (its source is q + d): ntap = (hi_y - lo_y +
//    1)(hi_x - lo_x + 1) terms. With gmax < 2^e1 and ntap of bit length b,
//    a term T is the f32 product w * (g 2^k) rounded once to an integer
//    (scaling by a power of two is exact).
//    * Under 64 taps (b <= 6: the post-optimization's smooth flows, 16-25
//      taps a tile at r = 4) an output's sum is one signed 32-bit limb,
//      k = 31 - b - e1: ntap terms of magnitude <= 2^(31 - b) sum below
//      2^31. One conversion and one atomic add a term, where two limbs
//      take a 64-bit conversion, a split and two: 12% of the adjoint at 16
//      x 720 x 960, r = 4 (0.277 against 0.246 ms, NVIDIA H100 80GB HBM3,
//      700.00 W). Its error is at most
//      ntap half-units of 2^-k, below ntap 2^(b + e1 - 32) < 2^-19 gmax.
//    * From 64 taps on, two 32-bit limbs (one shared-memory atomic add of a
//      64-bit integer measured slower on the H100 than two of 32 bits):
//      with L = 32 - b, k = 2L - 2 - e1, T sums below 2^(L + 30). Its low L
//      bits go to an unsigned limb (ntap of them sum below 2^32) and T >> L
//      to a signed one (they sum below 2^30 + ntap < 2^31 in magnitude, as
//      the entry point's radius <= 16000 keeps ntap < 2^30); the output is
//      (high << L) + low, times 2^-k. An output's error is at most ntap
//      half-units of 2^-k, below ntap^3 2^-60 gmax: 2^-37 gmax at r = 4,
//      2^-25 at r = 24, 2^-13 at r = 100 (an f32 sum of 16 such terms errs
//      by up to about 2^-20 gmax).
//    k is clamped to [-126, 126], where 2^k and 2^-k are normal f32; no
//    rule goes below -126 (k >= 25 - 128 with one limb, 2 * 2 - 2 - 128
//    with two). A non-finite g in the halo makes the tile's outputs NaN.
//  - Measured and dropped (ablate_postopt at 16 x 720 x 960, r = 4 unless
//    said, NVIDIA H100 80GB HBM3, 700.00 W, PERF.md): lanes whose taps
//    share a floor summing their terms by shuffles before one add, 1.7x
//    slower (0.617 against 0.356 ms; register adds in place of the atomics
//    are only 3-4% faster, 16% at r = 24); 16 x 32 tiles, 1.4x slower (2.1x
//    at r = 24) and faster only at 2 x 160 x 192 (0.135 against 0.179); a
//    warp writing a tile row's output floats in order, 9% slower (0.265
//    against 0.243), with or without planes padded against bank conflicts;
//    the halo's loads 4 pixels at a time (the pass alone 0.023 ms faster,
//    the kernel no faster); no radius checks in tiles whose taps stay
//    inside it (no faster).
//  - The outputs go out per thread, a warp's 32 pixels one contiguous span.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TH = 32, TW = 64;          // the adjoint's output tile, rows x columns
constexpr int THREADS = 256;
constexpr int ROWS_PER_STEP = THREADS / TW;  // 4
constexpr int PLANE = TH * TW;              // an accumulator plane (adjoint)
constexpr int MAXC = 4;

// the weight of tap i of a pixel's 2RK along one axis, whose distances are
// s_i = i - (RK - 1) - u for u in [0, 1), the flow's fraction: Keys cubic
// (a = -0.75), near(|s|) for the inner two taps and far(|s|) for the outer
// two, which reduce to a u (1 - u)^2 and a u^2 (1 - u) (0 at u = 0, as the
// plain version's kernel at |s| = 1 and 2), or bilinear; i is a constant
// of an unrolled loop
template <int RK>
__device__ __forceinline__ float tap_weight(int i, float u) {
  if constexpr (RK == 1) return i == 0 ? 1.f - u : u;
  constexpr float A = -0.75f;
  const float v = 1.f - u;
  if (i == 0) return A * u * v * v;
  if (i == 1) return ((A + 2.f) * u - (A + 3.f)) * u * u + 1.f;
  if (i == 2) return ((A + 2.f) * v - (A + 3.f)) * v * v + 1.f;
  return A * u * u * v;
}

// lo <= i <= hi, in one unsigned comparison
__device__ __forceinline__ bool within(int i, int lo, int hi) {
  return (unsigned)(i - lo) <= (unsigned)(hi - lo);
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

// the forward on tiles of ROWS_PER_STEP rows x TW columns, a pixel a thread
template <int C, int RK>
__global__ void __launch_bounds__(THREADS)
window_warp_fwd_kernel(const float* __restrict__ x, const float* __restrict__ flows,
                       float* __restrict__ out, int h, int w, int rh) {
  constexpr int NW = 2 * RK;  // taps an axis
  const int n = blockIdx.z;
  const int py = blockIdx.y * ROWS_PER_STEP + threadIdx.x / TW;
  const int px = blockIdx.x * TW + threadIdx.x % TW;
  if (py >= h || px >= w) return;
  const size_t plane = (size_t)h * w;
  const float* xn = x + (size_t)n * plane * C;
  const float2* fn = reinterpret_cast<const float2*>(flows) + (size_t)n * plane;
  float* on = out + (size_t)n * plane * C;
  const float2 f = fn[(size_t)py * w + px];
  // taps d = b + a: a tap outside the frame or the radius gets weight 0
  // and a clamped address
  const float fly = floorf(f.y), flx = floorf(f.x);
  const int by = (int)fly - RK + 1, bx = (int)flx - RK + 1;
  const float uy = f.y - fly, ux = f.x - flx;
  float wy[NW], wx[NW];
  int ry[NW], rx[NW];
#pragma unroll
  for (int a = 0; a < NW; ++a) {
    const int sy = py + by + a, sx = px + bx + a;
    wy[a] = within(sy, 0, h - 1) && within(by + a, -rh, rh) ? tap_weight<RK>(a, uy) : 0.f;
    wx[a] = within(sx, 0, w - 1) && within(bx + a, -rh, rh) ? tap_weight<RK>(a, ux) : 0.f;
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

// a thread's walk over the pixels of a rectangle [y0, y0 + rows) x [x0, x0
// + cols), flattened row-major: pixel threadIdx.x, then every THREADS-th,
// so that every lane has one while pixels are left (a warp's pixels run
// along a row, coalesced)
struct RectWalk {
  int y, x, x0, cols, dy, dx, left;
  __device__ __forceinline__ RectWalk(int y0_, int x0_, int rows, int cols_)
      : x0(x0_), cols(cols_) {
    const int i = threadIdx.x;
    left = rows > 0 && cols_ > 0 ? rows * cols_ - i : 0;
    y = y0_ + (cols_ > 0 ? i / cols_ : 0);
    x = x0_ + (cols_ > 0 ? i % cols_ : 0);
    dy = cols_ > 0 ? THREADS / cols_ : 0;
    dx = cols_ > 0 ? THREADS % cols_ : 0;
  }
  __device__ __forceinline__ bool live() const { return left > 0; }
  __device__ __forceinline__ void next() {
    left -= THREADS;
    x += dx;
    y += dy;
    if (x >= x0 + cols) {
      x -= cols;
      ++y;
    }
  }
};

// every source of the window [sy0, sy0 + rows) x [sx0, sx0 + cols) scatters
// its 2RK x 2RK terms w * g 2^k, rounded to integers, into the tile's
// accumulators: ONE: one signed 32-bit limb a term; else the low L bits
// into the unsigned limb and the rest into the signed one (header)
template <int C, int RK, bool ONE>
__device__ __forceinline__ void scatter(unsigned* so, const float* __restrict__ gn,
                                        const float2* __restrict__ fn, int w, int y0, int x0,
                                        int sy0, int sx0, int rows, int cols, int rh, float up,
                                        int L) {
  constexpr int NW = 2 * RK;
  const long long low = (1ll << L) - 1;
  for (RectWalk p(sy0, sx0, rows, cols); p.live(); p.next()) {
    const size_t s = (size_t)p.y * w + p.x;
    const float2 f = fn[s];
    float gv[C];
#pragma unroll
    for (int ch = 0; ch < C; ++ch) gv[ch] = gn[s * C + ch] * up;
    // taps d = b + i reach q = s - d with weight k(d + f); a tap whose q
    // lies outside the tile or whose d lies outside the radius gets weight
    // 0 and adds nothing
    const float fly = floorf(-f.y), flx = floorf(-f.x);
    const int by = (int)fly - RK + 1, bx = (int)flx - RK + 1;
    const int qy0 = p.y - by - y0, qx0 = p.x - bx - x0;  // tap 0's output
    const float uy = -f.y - fly, ux = -f.x - flx;
    float wy[NW], wx[NW];
#pragma unroll
    for (int a = 0; a < NW; ++a) {
      const bool oky = within(qy0 - a, 0, TH - 1) && within(by + a, -rh, rh);
      const bool okx = within(qx0 - a, 0, TW - 1) && within(bx + a, -rh, rh);
      wy[a] = oky ? tap_weight<RK>(a, uy) : 0.f;
      wx[a] = okx ? tap_weight<RK>(a, ux) : 0.f;
    }
#pragma unroll
    for (int a = 0; a < NW; ++a) {
      if (wy[a] == 0.f) continue;  // whole rows: the zero flows' outer taps
#pragma unroll
      for (int b = 0; b < NW; ++b) {
        if (wx[b] == 0.f) continue;
        const float wgt = wy[a] * wx[b];
        unsigned* q = so + (qy0 - a) * TW + (qx0 - b);
#pragma unroll
        for (int ch = 0; ch < C; ++ch) {
          if constexpr (ONE) {
            atomicAdd(q + ch * PLANE, (unsigned)__float2int_rn(wgt * gv[ch]));
          } else {
            const long long t = __float2ll_rn(wgt * gv[ch]);
            atomicAdd(q + ch * PLANE, (unsigned)(t & low));
            atomicAdd(reinterpret_cast<int*>(q + (C + ch) * PLANE), (int)(t >> L));
          }
        }
      }
    }
  }
}

// 4 blocks an SM at C <= 3 (48 KB each at C = 3), 3 at C = 4 (64 KB)
template <int C, int RK>
__global__ void __launch_bounds__(THREADS, C <= 3 ? 4 : 3)
window_warp_adj_kernel(const float* __restrict__ g, const float* __restrict__ flows,
                       float* __restrict__ out, int h, int w, int rh) {
  // the tile's fixed-point accumulators (dynamic: 16 KB a channel): the
  // low (or only) limbs, C x TH x TW, then the high limbs, C x TH x TW int
  extern __shared__ unsigned so[];
  __shared__ float red[6 * 8];
  const int n = blockIdx.z;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const size_t plane = (size_t)h * w;
  const float* gn = g + (size_t)n * plane * C;
  const float2* fn = reinterpret_cast<const float2*>(flows) + (size_t)n * plane;
  float* on = out + (size_t)n * plane * C;
  for (int i = threadIdx.x; i < 2 * C * PLANE; i += THREADS) so[i] = 0u;

  // 1. the flow range and max |g| over the halo window, clipped to the
  //    frame (a source outside the frame holds a zero cotangent and adds
  //    nothing); a non-finite g counts as infinite. v[4] is unused.
  float v[6] = {INFINITY, -INFINITY, INFINITY, -INFINITY, 0.f, 0.f};
  {
    const int hy0 = max(y0 - rh, 0), hy1 = min(y0 + TH - 1 + rh, h - 1);
    const int hx0 = max(x0 - rh, 0), hx1 = min(x0 + TW - 1 + rh, w - 1);
    for (RectWalk p(hy0, hx0, hy1 - hy0 + 1, hx1 - hx0 + 1); p.live(); p.next()) {
      const size_t s = (size_t)p.y * w + p.x;
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

  // 2. the fixed-point scale 2^k and the limbs (header): gmax < 2^e1; ntap
  //    < 64: one 32-bit limb, k = 31 - bitlen(ntap) - e1; else two, the low
  //    one L = 32 - bitlen(ntap) bits wide, k = 2L - 2 - e1
  int e1;
  frexpf(v[5], &e1);
  const unsigned ntap = (unsigned)max(hi_y - lo_y + 1, 1) * (unsigned)max(hi_x - lo_x + 1, 1);
  const int L = __clz((int)ntap);
  const bool one = ntap < 64;
  const int k = min(max(one ? L - 1 - e1 : 2 * L - 2 - e1, -126), 126);
  const float up = pow2(k);

  // 3. every source of the window, in the frame, scatters into the tile
  const int sy0 = max(y0 + lo_y, 0), sy1 = min(y0 + TH - 1 + hi_y, h - 1);
  const int sx0 = max(x0 + lo_x, 0), sx1 = min(x0 + TW - 1 + hi_x, w - 1);
  const int rows = sy1 - sy0 + 1, cols = sx1 - sx0 + 1;
  if (finite && one)
    scatter<C, RK, true>(so, gn, fn, w, y0, x0, sy0, sx0, rows, cols, rh, up, L);
  else if (finite)
    scatter<C, RK, false>(so, gn, fn, w, y0, x0, sy0, sx0, rows, cols, rh, up, L);
  __syncthreads();
  // 4. the outputs: a thread's pixels of one column, a warp's 32 pixels one
  //    contiguous span
  const float down = pow2(-k);
  const int tx = threadIdx.x % TW, ty = threadIdx.x / TW;
#pragma unroll
  for (int i = 0; i < TH / ROWS_PER_STEP; ++i) {
    const int ly = ty + ROWS_PER_STEP * i, py = y0 + ly, px = x0 + tx;
    if (py >= h || px >= w) continue;
    float* o = on + ((size_t)py * w + px) * C;
#pragma unroll
    for (int ch = 0; ch < C; ++ch) {
      const int j = ch * PLANE + ly * TW + tx;
      const long long sum = one ? (long long)(int)so[j]
                                : (long long)(int)so[C * PLANE + j] * (1ll << L)
                                      + (long long)so[j];
      o[ch] = finite ? __ll2float_rn(sum) * down : NAN;
    }
  }
}

template <int C, int RK>
cudaError_t launch(const float* x, const float* flows, float* out, int n, int h, int w,
                   int rh, bool adjoint, cudaStream_t s) {
  if (adjoint) {
    const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, n);
    constexpr int smem = 2 * C * PLANE * 4;  // C = 4 takes more than the default 48 KB
    static bool attr_set = false;  // once per kernel instance, not per launch
    if (!attr_set) {
      cudaError_t err = cudaFuncSetAttribute(window_warp_adj_kernel<C, RK>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
      attr_set = true;
    }
    window_warp_adj_kernel<C, RK><<<grid, THREADS, smem, s>>>(x, flows, out, h, w, rh);
  } else {
    const dim3 grid((w + TW - 1) / TW, (h + ROWS_PER_STEP - 1) / ROWS_PER_STEP, n);
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
