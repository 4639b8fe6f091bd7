// K3: flow warp as a bounded-window stencil, forward and adjoint, for
// sm_90a. Replaces the TPU kernel `_warp_kernel` of
// tclight_tpu/ops/warp_kernel.py; the plain version is `window_warp_plain`
// in tclight_torch/ops/warp_kernel.py.
//
//   forward  out[p] = sum_d k(dy - fy[p]) k(dx - fx[p]) x[p + d]
//   adjoint  adj[q] = sum_d k(dy + fy[q+d]) k(dx + fx[q+d]) g[q + d]
//
// over |dy|, |dx| <= rh = radius + kernel radius, zero outside the frame.
// x and g are NHWC f32 with C <= 4 channels; flows NHW2 f32 as [dx, dy].
//
// What bounds it on the H100: with a smooth flow a pixel needs a handful
// of taps and the kernel moves x, the flows and the output once (bytes);
// with a wide flow range per tile the adjoint walks a large window and the
// f32 tap arithmetic dominates (operations).
//
// Design. The TPU kernel walks one bounded window sum for both directions,
// because Mosaic cannot gather per pixel. Here:
//  - the forward reads only the 4x4 (bilinear 2x2) taps around p + f[p],
//    the only ones where k is nonzero, clipped to the window; neighbouring
//    threads read neighbouring pixels, so the taps come through L1/L2;
//  - the adjoint owns a 32x32 output tile per block. It first reduces the
//    flow's min/max over the tile's whole halo window (tile +- rh): a tap
//    d reads the flow at q + d, which lies anywhere in that halo, so the
//    bounds must cover it and not only the centre tile. The taps with a
//    nonzero weight then satisfy floor(min(-f)) - rk + 1 <= d <= floor(max(-f)) + rk.
//    The kernel walks that bounded window in 8x8-tap chunks: for each chunk
//    it stages the cotangent and the flow of the (32+7)^2 source pixels in
//    shared memory (zeros outside the frame), then every thread sums the
//    chunk's taps for its four pixels in f32 registers.
// Taps beyond the radius are dropped, as in the TPU kernel.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;                 // output tile side, pixels
constexpr int THREADS = 256;             // thread t owns column t % 32 of rows t / 32 + 8k
constexpr int ROW_STEP = THREADS / TILE; // 8
constexpr int PIX = TILE / ROW_STEP;     // 4 pixels per thread
constexpr int CHUNK = 8;                 // adjoint taps per staged chunk, each axis
constexpr int REG = TILE + CHUNK - 1;    // 39: staged source region side
constexpr int MAXC = 4;

__device__ __forceinline__ float kweight(float s, int mode) {
  s = fabsf(s);
  if (mode == 1) return fmaxf(0.f, 1.f - s);  // bilinear
  const float a = -0.75f;                     // Keys cubic, torch's bicubic
  const float near = ((a + 2.f) * s - (a + 3.f)) * s * s + 1.f;
  const float far = (((s - 5.f) * s + 8.f) * s - 4.f) * a;
  return s <= 1.f ? near : (s < 2.f ? far : 0.f);
}

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <bool ADJ>
__global__ void __launch_bounds__(THREADS)
window_warp_kernel(const float* __restrict__ x, const float* __restrict__ flows,
                   float* __restrict__ out, int h, int w, int c, int rh, int mode) {
  const int n = blockIdx.z;
  const int x0 = blockIdx.x * TILE, y0 = blockIdx.y * TILE;
  const int tx = threadIdx.x % TILE, ty = threadIdx.x / TILE;
  const int rk = mode == 1 ? 1 : 2;
  const size_t plane = (size_t)h * w;
  const float* xn = x + (size_t)n * plane * c;
  const float* fn = flows + (size_t)n * plane * 2;
  float* on = out + (size_t)n * plane * c;

  if constexpr (!ADJ) {
#pragma unroll
    for (int k = 0; k < PIX; ++k) {
      const int py = y0 + ty + ROW_STEP * k, px = x0 + tx;
      if (py >= h || px >= w) continue;
      const size_t p = (size_t)py * w + px;
      const float fx = fn[2 * p], fy = fn[2 * p + 1];
      const int by = (int)floorf(fy), bx = (int)floorf(fx);
      const int dy_lo = max(by - rk + 1, -rh), dy_hi = min(by + rk, rh);
      const int dx_lo = max(bx - rk + 1, -rh), dx_hi = min(bx + rk, rh);
      float acc[MAXC] = {0.f, 0.f, 0.f, 0.f};
      for (int dy = dy_lo; dy <= dy_hi; ++dy) {
        const int sy = py + dy;
        if (sy < 0 || sy >= h) continue;
        const float wy = kweight((float)dy - fy, mode);
        for (int dx = dx_lo; dx <= dx_hi; ++dx) {
          const int sx = px + dx;
          if (sx < 0 || sx >= w) continue;
          const float wgt = wy * kweight((float)dx - fx, mode);
          const float* src = xn + ((size_t)sy * w + sx) * c;
#pragma unroll
          for (int ch = 0; ch < MAXC; ++ch)
            if (ch < c) acc[ch] += wgt * __ldg(src + ch);
        }
      }
#pragma unroll
      for (int ch = 0; ch < MAXC; ++ch)
        if (ch < c) on[p * c + ch] = acc[ch];
    }
  } else {
    __shared__ float sg[MAXC][REG][REG + 1];
    __shared__ float sf[2][REG][REG + 1];
    __shared__ float red[4][THREADS / 32];

    // 1. flow range over the halo window, clipped to the frame (a tap
    //    outside the frame reads a zero cotangent and adds nothing)
    const int wy0 = max(y0 - rh, 0), wy1 = min(y0 + TILE - 1 + rh, h - 1);
    const int wx0 = max(x0 - rh, 0), wx1 = min(x0 + TILE - 1 + rh, w - 1);
    const int ww = wx1 - wx0 + 1, wcount = ww * (wy1 - wy0 + 1);
    float mnx = INFINITY, mxx = -INFINITY, mny = INFINITY, mxy = -INFINITY;
    for (int i = threadIdx.x; i < wcount; i += THREADS) {
      const size_t p = (size_t)(wy0 + i / ww) * w + (wx0 + i % ww);
      const float fx = __ldg(fn + 2 * p), fy = __ldg(fn + 2 * p + 1);
      mnx = fminf(mnx, fx); mxx = fmaxf(mxx, fx);
      mny = fminf(mny, fy); mxy = fmaxf(mxy, fy);
    }
    mnx = warp_min(mnx); mxx = warp_max(mxx); mny = warp_min(mny); mxy = warp_max(mxy);
    const int lane = threadIdx.x % 32, wid = threadIdx.x / 32;
    if (lane == 0) { red[0][wid] = mnx; red[1][wid] = mxx; red[2][wid] = mny; red[3][wid] = mxy; }
    __syncthreads();
    mnx = red[0][0]; mxx = red[1][0]; mny = red[2][0]; mxy = red[3][0];
    for (int i = 1; i < THREADS / 32; ++i) {
      mnx = fminf(mnx, red[0][i]); mxx = fmaxf(mxx, red[1][i]);
      mny = fminf(mny, red[2][i]); mxy = fmaxf(mxy, red[3][i]);
    }
    // weights are nonzero for |d - s| < rk with s = -f
    const int lo_y = max((int)floorf(-mxy) - rk + 1, -rh), hi_y = min((int)floorf(-mny) + rk, rh);
    const int lo_x = max((int)floorf(-mxx) - rk + 1, -rh), hi_x = min((int)floorf(-mnx) + rk, rh);

    float acc[PIX][MAXC];
#pragma unroll
    for (int k = 0; k < PIX; ++k)
#pragma unroll
      for (int ch = 0; ch < MAXC; ++ch) acc[k][ch] = 0.f;

    // 2. the bounded window in staged chunks of CHUNK x CHUNK taps
    for (int cy = lo_y; cy <= hi_y; cy += CHUNK) {
      for (int cx = lo_x; cx <= hi_x; cx += CHUNK) {
        __syncthreads();  // the previous chunk's readers are done
        for (int i = threadIdx.x; i < REG * REG; i += THREADS) {
          const int r = i / REG, col = i % REG;
          const int sy = y0 + cy + r, sx = x0 + cx + col;
          const bool in = sy >= 0 && sy < h && sx >= 0 && sx < w;
          const size_t p = in ? (size_t)sy * w + sx : 0;
#pragma unroll
          for (int ch = 0; ch < MAXC; ++ch)
            if (ch < c) sg[ch][r][col] = in ? __ldg(xn + p * c + ch) : 0.f;
          sf[0][r][col] = in ? __ldg(fn + 2 * p) : 0.f;
          sf[1][r][col] = in ? __ldg(fn + 2 * p + 1) : 0.f;
        }
        __syncthreads();
        const int ey = min(cy + CHUNK - 1, hi_y), ex = min(cx + CHUNK - 1, hi_x);
#pragma unroll
        for (int k = 0; k < PIX; ++k) {
          const int ly = ty + ROW_STEP * k;
          for (int dy = cy; dy <= ey; ++dy) {
            const int r = ly + dy - cy;
            for (int dx = cx; dx <= ex; ++dx) {
              const int col = tx + dx - cx;
              const float wgt = kweight((float)dy + sf[1][r][col], mode) *
                                kweight((float)dx + sf[0][r][col], mode);
#pragma unroll
              for (int ch = 0; ch < MAXC; ++ch)
                if (ch < c) acc[k][ch] += wgt * sg[ch][r][col];
            }
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < PIX; ++k) {
      const int py = y0 + ty + ROW_STEP * k, px = x0 + tx;
      if (py >= h || px >= w) continue;
      const size_t p = (size_t)py * w + px;
#pragma unroll
      for (int ch = 0; ch < MAXC; ++ch)
        if (ch < c) on[p * c + ch] = acc[k][ch];
    }
  }
}

}  // namespace

// x, flows, out: device pointers (NHWC f32, NHW2 f32, NHWC f32); mode 0 =
// bicubic, 1 = bilinear. Returns the cudaError_t of the launch.
extern "C" int tclight_window_warp_f32(const float* x, const float* flows, float* out,
                                       int n, int h, int w, int c, int radius, int mode,
                                       int adjoint, void* stream) {
  if (c < 1 || c > MAXC || (mode != 0 && mode != 1) || radius < 0 || n > 65535)
    return (int)cudaErrorInvalidValue;
  if (n == 0 || h == 0 || w == 0) return 0;
  const int rh = radius + (mode == 1 ? 1 : 2);
  const dim3 grid((w + TILE - 1) / TILE, (h + TILE - 1) / TILE, n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (adjoint)
    window_warp_kernel<true><<<grid, THREADS, 0, s>>>(x, flows, out, h, w, c, rh, mode);
  else
    window_warp_kernel<false><<<grid, THREADS, 0, s>>>(x, flows, out, h, w, c, rh, mode);
  return (int)cudaGetLastError();
}
