// K1: inference flash attention for Hopper (sm_90a), bf16 in, bf16 out.
//
// Replaces the TPU kernel tclight_tpu/ops/attention.py `_flash_kernel`
// (pallas_call at :418, reached through `_flash_attention_pallas` and
// `flash_attention`). Same function: softmax(scale * q k^T) v per (batch,
// head), online softmax in log2 space with f32 running max / sum /
// accumulator, out = acc / max(l, 1e-30).
//
// What bounds it on the H100: tensor-core operations. At the level-0 UNet
// self-attention (S ~ 35.6k merged + bank tokens, 8 heads, head dim 40)
// the work is 4*B*H*S^2*D ~ 3.3 TFLOP against ~0.1 GB of q/k/v/o, far
// above the card's ~295 FLOP/byte balance point. Second to it are the k/v
// tiles every q tile streams through shared memory.
//
// Design (the FlashAttention-2 layout): one block of 8 warps per (128-row
// q tile, batch*head); a loop over 64-row kv tiles inside the block takes
// the place of the TPU's sequential kv grid axis. Each warp owns 16 q rows
// and keeps in registers their q fragments, their 16x64 score tile, the
// running max and sum, and the 16xD output accumulator. Both products run
// on the tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulation), with
// fragments loaded by ldmatrix; the probabilities go from the score
// registers straight into the A operand of the p.v product. The head dim
// is padded only to the MMA depth of 16 (40 -> 48), not to the TPU's 128
// lanes; the padding is zero-filled by the loads. k/v tiles are double
// buffered with cp.async, so the next tile's copy overlaps this tile's
// products. The ragged kv tail is masked to -inf before the row max (no
// zero logits join the max). q/k/v are read in place from the (B, S, H, D)
// layout, so no transposed copies are made. Not yet used: wgmma, TMA.
//
// Shared memory per block is the q tile plus two k and two v tiles, rows
// padded by 8 elements: (128 + 4 * 64) * (DP + 8) * 2 bytes, 129,024 at the
// largest head dim (D = 160, level 2) and 43,008 at D = 40, against the
// 232,448 a block may use. m, l and the accumulator stay in registers:
// 4 * DP / 8 + 4 floats a thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_common.cuh"

using namespace tclight;

namespace {

constexpr int BQ = 128;
constexpr int BK = 64;
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int MAX_D = 160;

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__host__ __device__ constexpr size_t smem_bytes(int dp) {
  return (size_t)(BQ + 4 * BK) * (dp + 8) * 2;  // q tile + double-buffered k, v
}

template <int DP>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, int H, int Sq, int Skv, int D,
                 float scale_log2) {
  constexpr int LD = DP + 8;       // smem row, +16 bytes against bank conflicts
  constexpr int KSTEPS = DP / 16;  // depth steps of q.k^T
  constexpr int NT_O = DP / 8;     // 8-column tiles of the output
  constexpr int NT_S = BK / 8;     // 8-column tiles of a score tile
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = sQ + BQ * LD;      // 2 buffers of BK x LD
  __nv_bfloat16* sV = sK + 2 * BK * LD;  // 2 buffers of BK x LD

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const long row_stride = (long)H * D;  // elements between consecutive tokens
  const __nv_bfloat16* qb = q + ((long)b * Sq * H + h) * D;
  const __nv_bfloat16* kb = k + ((long)b * Skv * H + h) * D;
  const __nv_bfloat16* vb = v + ((long)b * Skv * H + h) * D;
  __nv_bfloat16* ob = o + ((long)b * Sq * H + h) * D;

  load_tile_async<BQ, NTHREADS>(sQ, LD, qb, row_stride, q0, Sq, D, DP);
  load_tile_async<BK, NTHREADS>(sK, LD, kb, row_stride, 0, Skv, D, DP);
  load_tile_async<BK, NTHREADS>(sV, LD, vb, row_stride, 0, Skv, D, DP);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const int r0 = warp * 16;
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk)
    ldmatrix_x4(qf[kk], smem_u32(sQ + (r0 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8));

  float acc[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums

  const int n_tiles = (Skv + BK - 1) / BK;
  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      load_tile_async<BK, NTHREADS>(sK + (buf ^ 1) * BK * LD, LD, kb, row_stride,
                                    (j + 1) * BK, Skv, D, DP);
      load_tile_async<BK, NTHREADS>(sV + (buf ^ 1) * BK * LD, LD, vb, row_stride,
                                    (j + 1) * BK, Skv, D, DP);
    }
    cp_async_commit();
    const __nv_bfloat16* tK = sK + buf * BK * LD;
    const __nv_bfloat16* tV = sV + buf * BK * LD;

    // s = q k^T for the warp's 16 rows x 64 keys
    float s[NT_S][4];
#pragma unroll
    for (int n = 0; n < NT_S; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int np = 0; np < NT_S / 2; ++np) {
        uint32_t bf[4];
        ldmatrix_x4(bf, smem_u32(tK + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                                 kk * 16 + ((lane >> 3) & 1) * 8));
        mma_bf16(s[2 * np], qf[kk], bf[0], bf[1]);
        mma_bf16(s[2 * np + 1], qf[kk], bf[2], bf[3]);
      }
    }

    // online softmax; this thread holds rows g (c0, c1) and g + 8 (c2, c3)
    const int kv0 = j * BK;
    const bool ragged = kv0 + BK > Skv;
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NT_S; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (ragged && kv0 + n * 8 + 2 * t + (e & 1) >= Skv) x = -INFINITY;
        s[n][e] = x;
        tmax[e >> 1] = fmaxf(tmax[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
      const float m_new = fmaxf(m_run[r], tmax[r]);  // finite: a tile has a valid key
      alpha[r] = fast_exp2(m_run[r] - m_new);
      m_run[r] = m_new;
    }
    float rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NT_S; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = fast_exp2(s[n][e] - m_run[e >> 1]);
        rsum[e >> 1] += s[n][e];
      }
    }
    l_run[0] = l_run[0] * alpha[0] + rsum[0];
    l_run[1] = l_run[1] * alpha[1] + rsum[1];
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // acc += p v, p taken from the score registers as bf16 A fragments
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < NT_O / 2; ++np) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, smem_u32(tV + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                       np * 16 + (lane >> 4) * 8));
        mma_bf16(acc[2 * np], pa, bf[0], bf[1]);
        mma_bf16(acc[2 * np + 1], pa, bf[2], bf[3]);
      }
    }
    cp_async_wait_all();
    __syncthreads();  // the next tile has landed; this tile's buffer is free
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = 1.f / fmaxf(l, 1e-30f);
  }
#pragma unroll
  for (int n = 0; n < NT_O; ++n) {
    const int col = n * 8 + 2 * t;
    if (col >= D) continue;  // d % 8 == 0: a tile is wholly in or out
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + r0 + g + 8 * r;
      if (row < Sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + (long)row * row_stride + col) =
            __floats2bfloat162_rn(acc[n][2 * r] * inv[r], acc[n][2 * r + 1] * inv[r]);
    }
  }
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int Sq, int Skv, int D, float scale, cudaStream_t stream) {
  const size_t bytes = smem_bytes(DP);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<DP><<<grid, NTHREADS, bytes, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)o, H, Sq, Skv, D, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (B, Sq, H, D), k/v: (B, Skv, H, D), o: (B, Sq, H, D); all bf16,
// contiguous, 16-byte aligned; D % 8 == 0, D <= 160. Returns
// cudaGetLastError() after the launch.
extern "C" int tclight_flash_attention_bf16(const void* q, const void* k,
                                            const void* v, void* o, int B,
                                            int H, int Sq, int Skv, int D,
                                            float scale, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0 || D <= 0 || D % 8 != 0 ||
      D > MAX_D || (long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch ((D + 15) / 16 * 16) {
    case 16: return launch<16>(q, k, v, o, B, H, Sq, Skv, D, scale, s);
    case 32: return launch<32>(q, k, v, o, B, H, Sq, Skv, D, scale, s);
    case 48: return launch<48>(q, k, v, o, B, H, Sq, Skv, D, scale, s);
    case 64: return launch<64>(q, k, v, o, B, H, Sq, Skv, D, scale, s);
    case 80: return launch<80>(q, k, v, o, B, H, Sq, Skv, D, scale, s);
    case 96: return launch<96>(q, k, v, o, B, H, Sq, Skv, D, scale, s);
    case 112: return launch<112>(q, k, v, o, B, H, Sq, Skv, D, scale, s);
    case 128: return launch<128>(q, k, v, o, B, H, Sq, Skv, D, scale, s);
    case 144: return launch<144>(q, k, v, o, B, H, Sq, Skv, D, scale, s);
    default: return launch<160>(q, k, v, o, B, H, Sq, Skv, D, scale, s);
  }
}
