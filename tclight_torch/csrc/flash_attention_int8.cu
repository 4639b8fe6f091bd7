// K7: inference flash attention with int8 q.k^T and p.v products, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel tclight_tpu/ops/attention.py
// `_flash_kernel_int8_full` (pallas_call at :459, backend
// "pallas_int8pv"): the logits come from an int8 q.k^T with exact int32
// accumulation,
//   s = scale * log2(e) * sq[q block] * sk[j] * <q8_i, k8_j>,
// V is int8 with one scale per channel, P is quantized per (row, 1024-key
// block) against the block's own max,
//   p8 = round(127 * exp2(s - blockmax)),
// and dequantized with sp / 127, sp = exp2(blockmax - m); the softmax sum l
// accumulates the exact f32 p. It matches the plain version
// `flash_attention_int8_plain` (the dense emulation JAX runs off the TPU)
// up to exp2 rounding and p8 values that a rounding tie may move by one.
// (K6, the int8 q.k^T with a bf16 p.v, has its own design and pre-pass in
// csrc/flash_attention_qk_int8.cu.)
//
// The operands come from the quantization pre-pass (`int8_prepass` in
// tclight_torch/ops/attention.py, plain torch ops): q8 (BH, Sq_pad, DK)
// and k8 (BH, Skv_pad, DK) int8, the head dim zero-padded to DK, a
// multiple of the int8 MMA depth 32 (40 -> 64, 80 -> 96, 160); the Q scale
// sq per (batch * head, 1024-row block) and the K scale sk per token
// (Skv_pad = ceil64(Skv), the padded keys zero); v8t (BH, DV, Skv_pad)
// int8, V transposed with its keys on the contiguous axis (ldmatrix.trans
// does not transpose 8-bit data) and the channels padded to DV =
// ceil16(D); sv (BH, DV) f32.
//
// What bounds it on the H100: tensor-core operations. At the level-0 UNet
// self-attention (S ~ 35.6k tokens, 8 heads, head dim 40) each product is
// 2*B*H*S^2*D ~ 1.6 T operations on ~0.1 GB of operands: at the int8 peak
// (1,979 TOPS) both need >= 1.6 ms.
//
// Design: PR 1's K1 layout. One block of 8 warps per (128-row q tile,
// batch * head); a loop over 64-key tiles, double buffered with cp.async;
// each warp keeps its 16 rows' q fragments, score tile, softmax state and
// output accumulator in registers. q.k^T runs on mma.sync m16n8k32 s8 ->
// s32; in bytes its fragments have the bf16 k16 layout, so q8 and k8 load
// with the same non-transposed ldmatrix as bf16 q and k. The 1024-row Q
// scale block holds whole 128-row tiles, so a block reads one sq.
//
// K7 needs the row max of a whole 1024-key block before it can quantize
// that block's first tile. It takes two passes over each block's 16
// tiles: the first computes only q.k^T and the row max, the second
// recomputes q.k^T (int8, the cheap half), quantizes p and runs p8.v8 on
// mma.sync m16n8k32. A thread's s32 score fragment holds keys {2t, 2t+1}
// of each 8-key tile, while the int8 A operand wants keys {4t..4t+3} of
// each 16. The pre-pass therefore stores each 16 keys of v8t permuted
// (logical key 4t + 2a + c holds physical key 8a + 2t + c), so four score
// values pack into one A register as they lie. The p8.v8 sums of one tile
// are exact int32 and are dequantized into the f32 accumulator tile by
// tile, one 16-channel pair at a time (8 int32 registers live).
//
// Shared memory per block: the q8 tile, two k8 tiles and two v8t tiles,
// rows padded by 16 bytes against bank conflicts: 70,656 bytes at D = 160,
// against the 232,448 a block may use. Not yet used: wgmma, TMA.

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
constexpr int KBLOCK = 1024;        // keys of one P-scale block (K7)
constexpr int TPB = KBLOCK / BK;    // 64-key tiles per P-scale block

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_s8(int a, int b, int c, int d) {
  return (uint32_t)(a & 0xff) | ((uint32_t)(b & 0xff) << 8) |
         ((uint32_t)(c & 0xff) << 16) | ((uint32_t)(d & 0xff) << 24);
}

// ROWS rows of COLS bytes (COLS % 16 == 0) of an int8 matrix with `stride`
// bytes per row into shared memory rows of `ld` bytes; every row exists
template <int ROWS, int COLS>
__device__ __forceinline__ void load_s8_tile(int8_t* dst, int ld, const int8_t* src,
                                             long stride) {
  constexpr int CHUNKS = COLS / 16;
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += NTHREADS) {
    const int r = i / CHUNKS;
    const int c = (i % CHUNKS) * 16;
    cp_async16(smem_u32(dst + r * ld + c), src + r * stride + c, true);
  }
}

template <int DK, int DV>
__host__ __device__ constexpr size_t smem_bytes() {
  return (size_t)(BQ + 2 * BK) * (DK + 16) + (size_t)2 * DV * (BK + 16);
}

template <int DK, int DV>
__global__ void __launch_bounds__(NTHREADS)
flash_int8_kernel(const int8_t* __restrict__ q8, const int8_t* __restrict__ k8,
                  const int8_t* __restrict__ v8t, const float* __restrict__ sq,
                  const float* __restrict__ sk, const float* __restrict__ sv,
                  __nv_bfloat16* __restrict__ o, int H, int Sq, int Skv, int D,
                  int Sq_pad, int n_qb, int bq, float scale_log2) {
  constexpr int LDQ = DK + 16;                  // bytes per q8 / k8 smem row
  constexpr int KSTEPS = DK / 32;               // depth steps of q.k^T
  constexpr int NT_O = DV / 8;                  // 8-column tiles of the output
  constexpr int NT_S = BK / 8;                  // 8-key tiles of a score tile
  constexpr int LDV = BK + 16;                  // bytes per v8t smem row
  constexpr int VTILE = DV * LDV;               // bytes per v buffer
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* sQ = reinterpret_cast<int8_t*>(smem);
  int8_t* sK = sQ + BQ * LDQ;                   // 2 buffers of BK x LDQ
  unsigned char* sV = smem + (BQ + 2 * BK) * LDQ;  // 2 buffers of VTILE bytes

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int Skv_pad = (Skv + BK - 1) / BK * BK;
  const int n_tiles = Skv_pad / BK;
  const int8_t* kb = k8 + (long)bh * Skv_pad * DK;
  const float* skb = sk + (long)bh * Skv_pad;
  const float qscale = scale_log2 * sq[(long)bh * n_qb + q0 / bq];
  const long row_stride = (long)H * D;  // bf16 elements between tokens of o
  const int8_t* v8b = v8t + (long)bh * DV * Skv_pad;
  __nv_bfloat16* ob = o + ((long)b * Sq * H + h) * D;

  auto load_k = [&](int j, int buf) {
    load_s8_tile<BK, DK>(sK + buf * BK * LDQ, LDQ, kb + (long)j * BK * DK, DK);
  };
  auto load_v = [&](int j, int buf) {
    load_s8_tile<DV, BK>(reinterpret_cast<int8_t*>(sV + buf * VTILE), LDV,
                         v8b + (long)j * BK, Skv_pad);
  };

  load_s8_tile<BQ, DK>(sQ, LDQ, q8 + ((long)bh * Sq_pad + q0) * DK, DK);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  const int r0 = warp * 16;
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk)
    ldmatrix_x4(qf[kk], smem_u32(sQ + (r0 + (lane & 15)) * LDQ + kk * 32 + (lane >> 4) * 16));

  // the warp's 16 x 64 logits (log2 space) of key tile j in buffer buf;
  // keys past Skv are -inf. This thread holds rows g (e = 0, 1) and g + 8
  // (e = 2, 3), keys 8n + 2t + (e & 1).
  auto scores = [&](int j, int buf, float (&s)[NT_S][4]) {
    const int8_t* tK = sK + buf * BK * LDQ;
    int32_t d[NT_S][4];
#pragma unroll
    for (int n = 0; n < NT_S; ++n) d[n][0] = d[n][1] = d[n][2] = d[n][3] = 0;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int np = 0; np < NT_S / 2; ++np) {
        uint32_t bf[4];
        ldmatrix_x4(bf, smem_u32(tK + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDQ +
                                 kk * 32 + ((lane >> 3) & 1) * 16));
        mma_s8(d[2 * np], qf[kk], bf[0], bf[1]);
        mma_s8(d[2 * np + 1], qf[kk], bf[2], bf[3]);
      }
    }
    const int kv0 = j * BK;
#pragma unroll
    for (int n = 0; n < NT_S; ++n) {
      const int col = kv0 + n * 8 + 2 * t;
      const float2 skv = *reinterpret_cast<const float2*>(skb + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = (float)d[n][e] * (qscale * ((e & 1) ? skv.y : skv.x));
        if (col + (e & 1) >= Skv) x = -INFINITY;
        s[n][e] = x;
      }
    }
  };

  float acc[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums

  // K7: per 1024-key block, a max pass then a quantize + p8.v8 pass
  const int n_blocks = (n_tiles + TPB - 1) / TPB;
  for (int blk = 0; blk < n_blocks; ++blk) {
    const int j0 = blk * TPB;
    const int j1 = min(j0 + TPB, n_tiles);
    float bmax[2] = {-INFINITY, -INFINITY};
    __syncthreads();  // every warp is done with the buffers of the last pass
    load_k(j0, 0);
    cp_async_commit();
    for (int j = j0; j < j1; ++j) {
      const int buf = (j - j0) & 1;
      cp_async_wait_all();
      __syncthreads();  // tile j landed; buffer buf ^ 1 is free
      if (j + 1 < j1) load_k(j + 1, buf ^ 1);
      cp_async_commit();
      float s[NT_S][4];
      scores(j, buf, s);
#pragma unroll
      for (int n = 0; n < NT_S; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) bmax[e >> 1] = fmaxf(bmax[e >> 1], s[n][e]);
    }
    float sp[2], pdeq[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      bmax[r] = fmaxf(bmax[r], __shfl_xor_sync(0xffffffffu, bmax[r], 1));
      bmax[r] = fmaxf(bmax[r], __shfl_xor_sync(0xffffffffu, bmax[r], 2));
      const float m_new = fmaxf(m_run[r], bmax[r]);  // finite: a block has a valid key
      const float alpha = fast_exp2(m_run[r] - m_new);
      m_run[r] = m_new;
      sp[r] = fast_exp2(bmax[r] - m_new);
      pdeq[r] = sp[r] / 127.f;
      l_run[r] *= alpha;
#pragma unroll
      for (int n = 0; n < NT_O; ++n) {
        acc[n][2 * r] *= alpha;
        acc[n][2 * r + 1] *= alpha;
      }
    }

    float lb[2] = {0.f, 0.f};  // sums of p / sp over the block
    __syncthreads();
    load_k(j0, 0);
    load_v(j0, 0);
    cp_async_commit();
    for (int j = j0; j < j1; ++j) {
      const int buf = (j - j0) & 1;
      cp_async_wait_all();
      __syncthreads();
      if (j + 1 < j1) {
        load_k(j + 1, buf ^ 1);
        load_v(j + 1, buf ^ 1);
      }
      cp_async_commit();
      float s[NT_S][4];
      scores(j, buf, s);
      int p8[NT_S][4];
#pragma unroll
      for (int n = 0; n < NT_S; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pr = fast_exp2(s[n][e] - bmax[e >> 1]);  // p / sp, <= 1
          lb[e >> 1] += pr;
          p8[n][e] = __float2int_rn(127.f * pr);
        }
      // A operands of the two 32-key depth steps: keys {2t, 2t+1} of the
      // 8-key tiles 4kk, 4kk + 1 (and 4kk + 2, 4kk + 3), which the
      // pre-pass's key permutation of v8t lines up with V's rows
      uint32_t pa[BK / 32][4];
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk) {
        const int n0 = 4 * kk;
        pa[kk][0] = pack_s8(p8[n0][0], p8[n0][1], p8[n0 + 1][0], p8[n0 + 1][1]);
        pa[kk][1] = pack_s8(p8[n0][2], p8[n0][3], p8[n0 + 1][2], p8[n0 + 1][3]);
        pa[kk][2] = pack_s8(p8[n0 + 2][0], p8[n0 + 2][1], p8[n0 + 3][0], p8[n0 + 3][1]);
        pa[kk][3] = pack_s8(p8[n0 + 2][2], p8[n0 + 2][3], p8[n0 + 3][2], p8[n0 + 3][3]);
      }
      const int8_t* tV = reinterpret_cast<const int8_t*>(sV + buf * VTILE);
#pragma unroll
      for (int np = 0; np < NT_O / 2; ++np) {
        int32_t d[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk) {
          uint32_t bf[4];
          ldmatrix_x4(bf, smem_u32(tV + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDV +
                                   kk * 32 + ((lane >> 3) & 1) * 16));
          mma_s8(d[0], pa[kk], bf[0], bf[1]);
          mma_s8(d[1], pa[kk], bf[2], bf[3]);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[2 * np + i][e] += (float)d[i][e] * pdeq[e >> 1];
      }
    }
    l_run[0] += sp[0] * lb[0];
    l_run[1] += sp[1] * lb[1];
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
    const float2 cs = *reinterpret_cast<const float2*>(sv + (long)bh * DV + col);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + r0 + g + 8 * r;
      if (row < Sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + (long)row * row_stride + col) =
            __floats2bfloat162_rn(acc[n][2 * r] * cs.x * inv[r],
                                  acc[n][2 * r + 1] * cs.y * inv[r]);
    }
  }
}

template <int DK, int DV>
int launch(const void* q8, const void* k8, const void* v, const void* sq, const void* sk,
           const void* sv, void* o, int B, int H, int Sq, int Skv, int D, int Sq_pad,
           int n_qb, int bq, float scale, cudaStream_t stream) {
  const size_t bytes = smem_bytes<DK, DV>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_int8_kernel<DK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_int8_kernel<DK, DV><<<grid, NTHREADS, bytes, stream>>>(
      (const int8_t*)q8, (const int8_t*)k8, (const int8_t*)v, (const float*)sq, (const float*)sk,
      (const float*)sv, (__nv_bfloat16*)o, H, Sq, Skv, D, Sq_pad, n_qb, bq,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

int dispatch(const void* q8, const void* k8, const void* v, const void* sq,
             const void* sk, const void* sv, void* o, int B, int H, int Sq, int Skv,
             int D, int Sq_pad, int n_qb, int bq, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0 || D <= 0 || D % 8 != 0 || D > MAX_D ||
      (long)B * H > 65535 || bq <= 0 || bq % BQ != 0 || Sq_pad < Sq || Sq_pad % bq != 0 ||
      n_qb != Sq_pad / bq)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define TCLIGHT_INT8_CASE(DK_, DV_)                                                   \
  if ((D + 31) / 32 * 32 == DK_ && (D + 15) / 16 * 16 == DV_)                         \
    return launch<DK_, DV_>(q8, k8, v, sq, sk, sv, o, B, H, Sq, Skv, D, Sq_pad,       \
                                 n_qb, bq, scale, s);
  TCLIGHT_INT8_CASE(32, 16)
  TCLIGHT_INT8_CASE(32, 32)
  TCLIGHT_INT8_CASE(64, 48)
  TCLIGHT_INT8_CASE(64, 64)
  TCLIGHT_INT8_CASE(96, 80)
  TCLIGHT_INT8_CASE(96, 96)
  TCLIGHT_INT8_CASE(128, 112)
  TCLIGHT_INT8_CASE(128, 128)
  TCLIGHT_INT8_CASE(160, 144)
  TCLIGHT_INT8_CASE(160, 160)
#undef TCLIGHT_INT8_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// K7. q8 (B*H, Sq_pad, DK), k8 (B*H, ceil64(Skv), DK) int8; v8t (B*H, DV,
// ceil64(Skv)) int8, DV = ceil16(D), its keys permuted within each 16 (see
// the head of this file); sq (B*H, n_qb), sk (B*H, ceil64(Skv)) and sv
// (B*H, DV) f32; o (B, Sq, H, D) bf16. DK = ceil32(D), D % 8 == 0, D <=
// 160; Sq_pad = n_qb * bq, bq % 128 == 0. All contiguous and 16-byte
// aligned. Returns cudaGetLastError() after the launch.
extern "C" int tclight_flash_attention_int8pv(const void* q8, const void* k8,
                                              const void* v8t, const void* sq,
                                              const void* sk, const void* sv, void* o,
                                              int B, int H, int Sq, int Skv, int D,
                                              int Sq_pad, int n_qb, int bq, float scale,
                                              void* stream) {
  return dispatch(q8, k8, v8t, sq, sk, sv, o, B, H, Sq, Skv, D, Sq_pad, n_qb, bq, scale,
                  stream);
}
