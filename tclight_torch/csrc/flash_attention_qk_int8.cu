// K6: inference flash attention with an int8 q.k^T, for Hopper (sm_90a),
// and the quantization pre-pass that makes its operands.
//
// Replaces the TPU kernel tclight_tpu/ops/attention.py
// `_flash_kernel_qk_int8` (pallas_call at :470, backend "pallas_int8"):
// the logits come from an int8 q.k^T with exact int32 accumulation,
//   s = scale * log2(e) * sq[q block] * sk[j] * <q8_i, k8_j>,
// and the p.v product stays bf16 with f32 accumulation, as in K1. It
// matches the plain version `flash_attention_int8_plain` (the dense
// emulation JAX runs off the TPU) up to exp2 rounding and p in bf16.
//
// What bounds it on the H100: at the level-0 UNet self-attention (S ~
// 35.6k tokens, 8 heads, head dim 40) q.k^T is 2*B*H*S^2*D ~ 1.6 T int8
// operations (0.8 ms at 1,979 TOPS) and p.v as many bf16 ones (1.6 ms at
// 989 TFLOP/s); the softmax takes B*H*S^2 ~ 2.0e10 exponentials, ~5.2 ms
// on the special-function units, as in K1.
//
// The pre-pass (two kernels; its plain version is `int8_prepass` in
// ops/attention.py, which `qk_int8_operands_plain` lays out as below).
// Both take blocks of 256 rows per batch * head, q slices then k slices,
// one row a thread held in registers where a row is the unit of work:
// - `flash_int8_prepass_stats_kernel`: a q slice's amax; a k slice's f32
//   channel sums, and the last k slice of a batch * head to finish (an
//   atomic counter) adds the slices' sums in a fixed order into the token
//   mean, divided by Skv and rounded to bf16.
// - `flash_int8_prepass_quant_kernel`: a q slice takes its 1024-row
//   Q-scale block's amax from the slices', sq = max(amax, 1e-6) / 127 and
//   q8 = round_half_even(q / sq) (true IEEE divisions: never build with
//   --use_fast_math); a k slice takes k - mean rounded to bf16, one scale
//   per token as for q, and k8; and copies v.
// It writes what the main kernel's TMA boxes read: q8 (BH, DK / 16, Sq,
// 16) and k8 (BH, DK / 16, Skv, 16) int8, chunk-major with the head dim
// zero-padded to DK = ceil32(D); v (BH, D / 8, Skv, 8) bf16, chunk-major
// as K1's wrapper copies it; sq (BH, n_qb) and sk (BH, ceil128(Skv)) f32,
// the padded keys' scales 0. It reads q twice and k twice (the second
// reads mostly from L2) and v once, and writes ~0.16 GB at level 0. At D =
// 128 it writes q8 (BH, Sq, 128) and k8 (BH, Skv, 128) row-major and no v
// copy (see the main kernel's head-dim-128 layout below).
//
// The same two kernels with PV = true are the pre-pass of K7
// (csrc/flash_attention_int8.cu, int8 p.v; entry tclight_int8pv_prepass;
// plain version `int8pv_operands_plain`): the stats kernel's k slices
// also take V's channel amax over their keys, and the last slice to finish
// makes sv = max(amax, 1e-6) / 127 per (batch * head, channel); the quant
// kernel's k slices write, instead of the v copy, v8 = round_half_even(v /
// sv) in the B layout of K7's s8 wgmma: (BH, ceil16(Skv) / 16, D, 16), 16
// keys of one channel per 16 bytes (8-bit wgmma takes K-major operands
// only), so a (keys x channels) tile is one TMA box. Within each 16 keys
// the order is permuted: byte 4t + 2a + c holds key 8a + 2t + c, so that
// the s32 score fragment of a thread (keys 2t, 2t + 1 of each 8) packs as
// it lies into the s8 A fragment (bytes 4t..4t+3 of each 16). Keys past
// Skv are zeros. A k slice stages its 16 chunks in shared memory and
// stores them as one contiguous span. It also writes q8's and k8's values
// as bf16 (exact), chunk-major in 8-value chunks with the head dim padded to
// ceil16(D), for K7's max pass: a bf16 product with f32 sums gives the
// exact dot already converted (|dot| < 2^22). At D = 128 v8 is
// channel-major instead, (BH, 128, ceil128(Skv)), each channel's keys
// contiguous in the same order within each 16 (K7 reads a 128-key tile of
// a channel as one 128-byte swizzle row), and there are no bf16 copies:
// K7's max pass reads q8 and k8 by s8 wgmma.
//
// Design of the main kernel: K1's (csrc/flash_attention.cu), the
// FlashAttention-3 shape. One block of three warpgroups per (q tile,
// batch * head). Warpgroup 0 is the producer: one thread loads the q8
// tile by TMA (once), and the k8 tile, the v tile and the tile's K scales
// (one bulk copy) into a ring of stages with full / empty mbarriers. Two
// consumer warpgroups own MB blocks of 64 q rows each (two up to DP = 96:
// 256-row q tiles, 64-key tiles, 4 stages; one above: 128 rows, 128 keys).
// - q.k^T on wgmma.m64nBKk32.s32.s8.s8, both operands K-major in shared
//   memory (8-bit wgmma takes no other layout; q8 and k8 are row-major in
//   the head dim, which is that). DK = 64 at D = 40, 96 at 80, 160 at 160.
// - p.v on wgmma.m64nDPk16 bf16 with p packed in registers, exactly K1's.
// - Dequantisation. The int32 sums convert to f32 exactly, |q8 . k8| <=
//   127^2 * DK <= 2,580,640 < 2^24, by the conversion instruction (the
//   exact alternative, one integer and one float add on the magic number
//   1.5 * 2^23, measured slower: `python -m tclight_torch.ablate_qk_int8`).
//   Each score is then multiplied by its key's sk (read from the stage),
//   the row max is taken on those, and the row's factor sq * scale *
//   log2(e) folds into the exponent's FMA, as K1 folds its scale. The
//   1024-row Q-scale block holds whole q tiles (one block when Sq <=
//   1024), so a tile reads one sq. Keys past Skv (zero-filled by TMA) are
//   masked to -inf before the row max in the last tile; out = acc /
//   max(l, 1e-30).
// - Overlap, as K1: tile j's p.v and tile j + 1's q.k^T are issued
//   together and the softmax of tile j + 1 runs while that p.v is in
//   flight; the two consumer warpgroups take turns to issue (named-barrier
//   ping-pong). No wgmma is issued under a condition.
//
// - Head dim 128 (the Cosmos DiTs' attn_backend "int8") has a layout of
//   its own (SW = true), as K1's: there the chunk-major tiles moved as
//   16-byte-wide TMA boxes, 3,072 rows of 16 bytes a 128-key tile, and
//   with the k8 and v loads taken out the kernel ran twice as fast
//   (PERF.md, the head-dim-128 ablation). An int8 row of 128 dims is one
//   128-byte swizzle row, so the pre-pass writes q8 and k8 row-major,
//   (BH, S, 128), and the kernel reads each q8 or k8 tile as one box of
//   128-byte rows in the 128-byte swizzle, which the s8 wgmma reads through
//   K-major descriptors (32 bytes a k32 step within the rows, as K1's bf16
//   k16 steps); v is read in place from (B, S, H, D) as K1's D = 128 path
//   reads it (two boxes of 64 dims, MN-major), so the pre-pass writes no v
//   copy. 128 q rows (one 64-row block per consumer warpgroup), 128-key
//   tiles, 3 stages, K1's choice at D = 128. Every other head dim, 120
//   next to it included, keeps the chunk-major layout.
//
// Shared memory per block: BQ * DK + NST * BK * (DK + 2 * DP + 4) bytes
// and the barriers: 58,368 + 72 at D = 40, 144,384 + 40 at D = 160;
// 165,376 + 56 (and the 1,024-byte alignment) at D = 128.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

using namespace tclight::hopper;

namespace {

constexpr int NTHREADS = 384;
constexpr int MAX_D = 160;
constexpr int PRE_THREADS = 256;
constexpr int SLICE = 256;  // rows (queries or keys) per block of the pre-pass

__host__ __device__ constexpr int row_blocks(int dp) { return dp <= 96 ? 2 : 1; }
__host__ __device__ constexpr int q_rows(int dp) { return 128 * row_blocks(dp); }
__host__ __device__ constexpr int kv_rows(int dp) { return row_blocks(dp) == 2 ? 64 : 128; }
__host__ __device__ constexpr int n_stages(int dp) {
  return row_blocks(dp) == 2 ? 4 : (dp <= 128 ? 3 : 2);
}

__host__ __device__ constexpr size_t smem_bytes(int dk, int dp) {
  return (size_t)q_rows(dp) * dk + (size_t)n_stages(dp) * kv_rows(dp) * (dk + 2 * dp + 4) +
         8 * (1 + 2 * n_stages(dp)) + 128;
}

// D = 128 reads its operands in place in the 128-byte swizzle (an int8 row
// of q8 or k8 is one swizzle row): 128 q rows (one 64-row block per
// consumer warpgroup), SW_BK-key tiles in a ring of SW_NST stages; tiles
// aligned to 1,024 bytes
constexpr int SW_D = 128;
constexpr int SW_BQ = 128;
constexpr int SW_BK = 128;
constexpr int SW_NST = 3;
constexpr size_t SW_SMEM = (size_t)SW_BQ * SW_D + (size_t)SW_NST * SW_BK * (3 * SW_D + 4) +
                           8 * (1 + 2 * SW_NST) + 1024;

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// exact: |x| < 2^24 (see the head of this file)
__device__ __forceinline__ float s32_to_f32(uint32_t x) { return (float)(int)x; }

__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

__device__ __forceinline__ float block_max(float x, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  __syncthreads();  // red is free
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  float m = red[0];
  for (int w = 1; w < PRE_THREADS / 32; ++w) m = fmaxf(m, red[w]);
  return m;
}

// ------------------------------------------------------------- pre-pass

// loads a (B, S, H, D) row of CH 16-byte chunks into registers
template <int CH>
__device__ __forceinline__ void load_row(const __nv_bfloat16* row, uint4 (&u)[CH]) {
#pragma unroll
  for (int c = 0; c < CH; ++c) u[c] = *reinterpret_cast<const uint4*>(row + c * 8);
}

// the 16 int8 values of output chunk c16: head dims 16 c16 .. 16 c16 + 15
// of f / s rounded half to even, zero past the row's CH * 8 dims
template <int CH, class F>
__device__ __forceinline__ uint4 quantize_chunk(int c16, F&& value, float s) {
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int c = 2 * c16 + half;
    if (c < CH) {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        w[2 * half + e / 4] |= (uint32_t)(__float2int_rn(value(c, e) / s) & 0xff) << (8 * (e % 4));
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// the 8 quantized values of bf16 chunk c8: head dims 8 c8 .. 8 c8 + 7 of
// f / s rounded half to even, exact in bf16 (|x| <= 127), zero past the
// row's CH * 8 dims
template <int CH, class F>
__device__ __forceinline__ uint4 quantize_chunk_bf16(int c8, F&& value, float s) {
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  if (c8 < CH) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const __nv_bfloat162 b2 = __floats2bfloat162_rn(rintf(value(c8, 2 * e) / s),
                                                      rintf(value(c8, 2 * e + 1) / s));
      w[e] = *reinterpret_cast<const uint32_t*>(&b2);
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Blocks of 256 rows, per batch * head: first the q slices, then the k
// slices. A q slice writes the amax of its rows to qmax. A k slice writes
// the f32 sums of its keys' channels to part; the last k slice of a
// batch * head to finish (a counter in `count`, zeroed before the launch)
// adds the slices' sums in a fixed order and writes the token mean, f32
// divided by Skv and rounded to bf16, to kmean.
// With PV, a k slice also writes the amax of V's channels over its keys to
// vpart, and the last slice writes sv.
template <int CH, bool PV>
__global__ void __launch_bounds__(PRE_THREADS)
flash_int8_prepass_stats_kernel(const __nv_bfloat16* __restrict__ q,
                                const __nv_bfloat16* __restrict__ k,
                                const __nv_bfloat16* __restrict__ v, float* __restrict__ qmax,
                                float* __restrict__ part, float* __restrict__ vpart,
                                float* __restrict__ kmean, float* __restrict__ sv,
                                unsigned* __restrict__ count, int H, int Sq, int Skv, int n_qs,
                                int n_ks) {
  constexpr int D = CH * 8;
  __shared__ float red[PRE_THREADS * 8];
  __shared__ bool last;
  const int bh = blockIdx.x / (n_qs + n_ks), sl = blockIdx.x % (n_qs + n_ks);
  const int b = bh / H, h = bh % H;
  if (sl < n_qs) {
    const int r = sl * SLICE + threadIdx.x;
    float amax = 0.f;
    if (r < Sq) {
      uint4 u[CH];
      load_row<CH>(q + (((long)b * Sq + r) * H + h) * D, u);
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        float f[8];
        unpack8(u[c], f);
#pragma unroll
        for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(f[e]));
      }
    }
    amax = block_max(amax, red);
    if (threadIdx.x == 0) qmax[bh * n_qs + sl] = amax;
    return;
  }
  const int ks = sl - n_qs;
  {
    // thread (row lane rl, chunk cl): the lanes' sums, then the lanes in order
    constexpr int LANES = PRE_THREADS / CH;
    const int rl = threadIdx.x / CH, cl = threadIdx.x % CH;
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    float vmax[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (rl < LANES) {
      for (int r = ks * SLICE + rl; r < min(ks * SLICE + SLICE, Skv); r += LANES) {
        float f[8];
        const long at = (((long)b * Skv + r) * H + h) * D + cl * 8;
        unpack8(*reinterpret_cast<const uint4*>(k + at), f);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] += f[e];
        if constexpr (PV) {
          unpack8(*reinterpret_cast<const uint4*>(v + at), f);
#pragma unroll
          for (int e = 0; e < 8; ++e) vmax[e] = fmaxf(vmax[e], fabsf(f[e]));
        }
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) red[rl * D + cl * 8 + e] = acc[e];
    }
    __syncthreads();
    for (int c = threadIdx.x; c < D; c += PRE_THREADS) {
      float s = 0.f;
      for (int l = 0; l < LANES; ++l) s += red[l * D + c];
      part[((long)bh * n_ks + ks) * D + c] = s;
    }
    if constexpr (PV) {
      __syncthreads();  // red is free
      if (rl < LANES) {
#pragma unroll
        for (int e = 0; e < 8; ++e) red[rl * D + cl * 8 + e] = vmax[e];
      }
      __syncthreads();
      for (int c = threadIdx.x; c < D; c += PRE_THREADS) {
        float m = 0.f;
        for (int l = 0; l < LANES; ++l) m = fmaxf(m, red[l * D + c]);
        vpart[((long)bh * n_ks + ks) * D + c] = m;
      }
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&count[bh], 1u) == (unsigned)n_ks - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // lane l of channel c adds slices l, l + L, ...; then the lanes in order
  constexpr int L = PRE_THREADS / D;
  const int c = threadIdx.x % D, l = threadIdx.x / D;
  if (l < L) {
    float s = 0.f;
    for (int p = l; p < n_ks; p += L) s += __ldcg(part + ((long)bh * n_ks + p) * D + c);
    red[l * D + c] = s;
  }
  __syncthreads();
  if (threadIdx.x < D) {
    float s = 0.f;
    for (int j = 0; j < L; ++j) s += red[j * D + threadIdx.x];
    kmean[bh * D + threadIdx.x] = __bfloat162float(__float2bfloat16_rn(s / (float)Skv));
    if constexpr (PV) {
      float m = 0.f;
      for (int p = 0; p < n_ks; ++p)
        m = fmaxf(m, __ldcg(vpart + ((long)bh * n_ks + p) * D + threadIdx.x));
      sv[bh * D + threadIdx.x] = fmaxf(m, 1e-6f) / 127.f;
    }
  }
}

// Blocks of 256 rows as above, one row a thread, held in registers: a q
// slice quantizes its rows with its Q-scale block's scale (from the
// slices' amax) and writes that scale once; a k slice smooths its keys by
// the token mean (rounded to bf16), quantizes each key with its own scale
// and copies v chunk-major (PV: writes v8, staged in shared memory).
// SW (D = 128): q8 and k8 row-major, one 128-byte row a token; no v copy;
// PV: v8 channel-major, no bf16 copies.
template <int CH, bool PV, bool SW>
__global__ void __launch_bounds__(PRE_THREADS)
flash_int8_prepass_quant_kernel(const __nv_bfloat16* __restrict__ q,
                                const __nv_bfloat16* __restrict__ k,
                                const __nv_bfloat16* __restrict__ v,
                                const float* __restrict__ qmax, const float* __restrict__ kmean,
                                const float* __restrict__ sv, int8_t* __restrict__ q8,
                                int8_t* __restrict__ k8, __nv_bfloat16* __restrict__ vc,
                                int8_t* __restrict__ v8, __nv_bfloat16* __restrict__ q_bf,
                                __nv_bfloat16* __restrict__ k_bf, float* __restrict__ sq,
                                float* __restrict__ sk, int H, int Sq, int Skv, int bq, int n_qb,
                                int n_qs, int n_ks, int skv_pad) {
  constexpr int D = CH * 8;
  constexpr int CH8 = (D + 31) / 32 * 2;  // 16-byte chunks of an int8 row (DK / 16)
  constexpr int CHB = (D + 15) / 16 * 2;  // PV: 8-value chunks of a bf16 row (ceil16(D) / 8)
  __shared__ float km[D];
  // PV: V's channel scales, and the slice's v8, 16 chunks of (D channels
  // x 16 keys)
  __shared__ float svs[PV ? D : 1];
  __shared__ __align__(16) int8_t v8s[PV ? SLICE * D : 16];
  // where 16-byte chunk c16 of row r of q8 or k8 (S rows) goes
  auto at8 = [&](int bh, int c16, int S, int r) {
    return SW ? ((long)bh * S + r) * CH8 + c16 : ((long)bh * CH8 + c16) * S + r;
  };
  const int bh = blockIdx.x / (n_qs + n_ks), sl = blockIdx.x % (n_qs + n_ks);
  const int b = bh / H, h = bh % H;
  if (sl < n_qs) {
    const int qb = min(sl * SLICE / bq, n_qb - 1);
    const int s0 = qb * bq / SLICE, s1 = qb == n_qb - 1 ? n_qs : (qb + 1) * bq / SLICE;
    float amax = 0.f;
    for (int j = s0; j < s1; ++j) amax = fmaxf(amax, qmax[bh * n_qs + j]);
    const float s = fmaxf(amax, 1e-6f) / 127.f;
    if (threadIdx.x == 0 && sl == s0) sq[bh * n_qb + qb] = s;
    const int r = sl * SLICE + threadIdx.x;
    if (r >= Sq) return;
    uint4 u[CH];
    load_row<CH>(q + (((long)b * Sq + r) * H + h) * D, u);
    auto value = [&](int c, int e) {
      float f[8];
      unpack8(u[c], f);
      return f[e];
    };
#pragma unroll
    for (int c16 = 0; c16 < CH8; ++c16)
      *reinterpret_cast<uint4*>(q8 + at8(bh, c16, Sq, r) * 16) = quantize_chunk<CH>(c16, value, s);
    if constexpr (PV && !SW) {
#pragma unroll
      for (int c8 = 0; c8 < CHB; ++c8)
        *reinterpret_cast<uint4*>(q_bf + (((long)bh * CHB + c8) * Sq + r) * 8) =
            quantize_chunk_bf16<CH>(c8, value, s);
    }
    return;
  }
  const int r = (sl - n_qs) * SLICE + threadIdx.x;
  for (int c = threadIdx.x; c < D; c += PRE_THREADS) {
    km[c] = kmean[bh * D + c];
    if constexpr (PV) svs[c] = sv[bh * D + c];
  }
  __syncthreads();
  if constexpr (PV) {
    // byte 4t + 2a + c of a 16-key chunk holds key 8a + 2t + c; staged as
    // [chunk][channel][16], or SW [channel][key]
    const int kp = threadIdx.x % 16;
    const int perm = 4 * ((kp % 8) / 2) + 2 * (kp / 8) + kp % 2;
    constexpr int CSTEP = SW ? SLICE : 16;  // bytes from one channel to the next
    int8_t* dst = v8s + (threadIdx.x / 16) * (SW ? 16 : D * 16) + perm;
    if (r < Skv) {
      uint4 u[CH];
      load_row<CH>(v + (((long)b * Skv + r) * H + h) * D, u);
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        float f[8];
        unpack8(u[c], f);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[(c * 8 + e) * CSTEP] = (int8_t)__float2int_rn(f[e] / svs[c * 8 + e]);
      }
    } else {
      for (int c = 0; c < D; ++c) dst[c * CSTEP] = 0;
    }
    __syncthreads();
    if constexpr (SW) {
      // (BH, D, skv_pad): each channel's keys of the slice below skv_pad
      // (a multiple of 128) are one contiguous run
      const int k0 = (sl - n_qs) * SLICE, n16 = min(SLICE, skv_pad - k0) / 16;
      for (int i = threadIdx.x; i < n16 * D; i += PRE_THREADS) {
        const int c = i / n16, u = i % n16;
        reinterpret_cast<uint4*>(v8 + ((long)bh * D + c) * skv_pad + k0)[u] =
            reinterpret_cast<const uint4*>(v8s + c * SLICE)[u];
      }
    } else {
      // the slice's whole chunks below ceil16(Skv) are one contiguous span
      const int n_vc = (Skv + 15) / 16, c0 = (sl - n_qs) * (SLICE / 16);
      const int n_chunks = min(SLICE / 16, n_vc - c0);
      uint4* out = reinterpret_cast<uint4*>(v8 + ((long)bh * n_vc + c0) * D * 16);
      for (int i = threadIdx.x; i < n_chunks * D; i += PRE_THREADS)
        out[i] = reinterpret_cast<const uint4*>(v8s)[i];
    }
  }
  if (r >= Skv) {
    if (r < skv_pad) sk[(long)bh * skv_pad + r] = 0.f;
    return;
  }
  // k minus its token mean, rounded to bf16, as the plain version
  float ks[D];
  {
    uint4 u[CH];
    load_row<CH>(k + (((long)b * Skv + r) * H + h) * D, u);
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      float f[8];
      unpack8(u[c], f);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        ks[c * 8 + e] = __bfloat162float(__float2bfloat16_rn(f[e] - km[c * 8 + e]));
    }
  }
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < D; ++i) amax = fmaxf(amax, fabsf(ks[i]));
  const float s = fmaxf(amax, 1e-6f) / 127.f;
  sk[(long)bh * skv_pad + r] = s;
  auto value = [&](int c, int e) { return ks[c * 8 + e]; };
#pragma unroll
  for (int c16 = 0; c16 < CH8; ++c16)
    *reinterpret_cast<uint4*>(k8 + at8(bh, c16, Skv, r) * 16) = quantize_chunk<CH>(c16, value, s);
  if constexpr (PV && !SW) {
#pragma unroll
    for (int c8 = 0; c8 < CHB; ++c8)
      *reinterpret_cast<uint4*>(k_bf + (((long)bh * CHB + c8) * Skv + r) * 8) =
          quantize_chunk_bf16<CH>(c8, value, s);
  } else if constexpr (!PV && !SW) {
    uint4 u[CH];
    load_row<CH>(v + (((long)b * Skv + r) * H + h) * D, u);
#pragma unroll
    for (int c = 0; c < CH; ++c)
      *reinterpret_cast<uint4*>(vc + (((long)bh * CH + c) * Skv + r) * 8) = u[c];
  }
}

// ---------------------------------------------------------- main kernel

template <int DK, int DP, bool SW>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_int8_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const float* __restrict__ sq, const float* __restrict__ sk,
                        __nv_bfloat16* __restrict__ o, int H, int Sq, int Skv, int D, int n_qb,
                        int bq, int skv_pad, float scale_log2) {
  static_assert(!SW || (DK == SW_D && DP == SW_D), "the swizzled path is D = 128's");
  constexpr int MB = SW ? 1 : row_blocks(DP);
  constexpr int BQ = SW ? SW_BQ : q_rows(DP);
  constexpr int BK = SW ? SW_BK : kv_rows(DP);
  constexpr int NST = SW ? SW_NST : n_stages(DP);
  constexpr uintptr_t ALIGN = SW ? 1024 : 128;
  extern __shared__ unsigned char smem_raw[];
  int8_t* sQ = reinterpret_cast<int8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + ALIGN - 1) & ~(ALIGN - 1));
  int8_t* sK = sQ + BQ * DK;                                          // NST k8 tiles
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(sK + NST * BK * DK);  // NST v tiles
  float* sS = reinterpret_cast<float*>(sV + NST * BK * DP);           // NST tiles of K scales
  uint64_t* qbar = reinterpret_cast<uint64_t*>(sS + NST * BK);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + NST;

  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int n_tiles = (Skv + BK - 1) / BK;
  // warp-uniform as far as the compiler can see: wgmma on a path it
  // cannot prove uniform is serialised
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < NST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * 4);  // one arrive per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------------------------------------------------- producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(qbar, BQ * DK);
      if constexpr (SW) tma_load_4d(sQ, &tq, qbar, 0, q0, bh, 0);
      else tma_load_4d(sQ, &tq, qbar, 0, q0, 0, bh);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % NST;
        if (j >= NST) mbar_wait(&empty[st], ((j / NST) - 1) & 1);
        mbar_expect_tx(&full[st], BK * DK + BK * DP * 2 + BK * 4);
        if constexpr (SW) {
          // k8 one box of 128-byte rows; v in place, one box per 64-dim slab
          tma_load_4d(sK + st * BK * DK, &tk, &full[st], 0, j * BK, bh, 0);
          for (int c = 0; c < DP / 64; ++c)
            tma_load_4d(sV + st * BK * DP + c * BK * 64, &tv, &full[st], c * 64, h, j * BK, b);
        } else {
          tma_load_4d(sK + st * BK * DK, &tk, &full[st], 0, j * BK, 0, bh);
          tma_load_4d(sV + st * BK * DP, &tv, &full[st], 0, j * BK, 0, bh);
        }
        bulk_load(sS + st * BK, sk + (long)bh * skv_pad + j * BK, BK * 4, &full[st]);
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    setmaxnreg_inc<240>();
    const int cw = wg - 1;  // which MB * 64 q rows
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    // the row factor of the logits: this tile's Q scale, the softmax scale
    // and log2(e)
    const float c_row = scale_log2 * sq[bh * n_qb + q0 / bq];

    float acc[MB][DP / 2];
    uint32_t s[MB][BK / 2];  // int32 sums, then f32 bits in place
    uint32_t pa[MB][BK / 16][4];  // p of the tile whose p.v is next or in flight
    float m_run[MB][2], l_run[MB][2];  // l: this thread's share of the row sums
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) {
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) acc[mb][i] = 0.f;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[mb][i] = 0u;
      m_run[mb][0] = m_run[mb][1] = -INFINITY;
      l_run[mb][0] = l_run[mb][1] = 0.f;
    }
    auto fence_all = [&]() {
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) {
        fence_regs(s[mb]);
        fence_regs(acc[mb]);
      }
    };

    // int32 q8 k8^T of tile j into s: per row block, 64 rows x BK keys in
    // DK / 32 steps of depth 32 (two 16-byte chunks), both operands
    // K-major in shared memory; swizzled, 32 bytes a step within the
    // 128-byte rows, this warpgroup's 64 q rows 8 KB into the tile
    auto issue_qk = [&](int j) {
      const int8_t* tK = sK + (j % NST) * BK * DK;
#pragma unroll
      for (int kk = 0; kk < DK / 32; ++kk)
#pragma unroll
        for (int mb = 0; mb < MB; ++mb) {
          if constexpr (SW)
            WgmmaS8<BK>::run(s[mb], wgmma_desc_sw128(sQ + (cw * MB + mb) * 64 * DK + kk * 32, 16, 1024),
                             wgmma_desc_sw128(tK + kk * 32, 16, 1024), kk > 0 ? 1 : 0);
          else
            WgmmaS8<BK>::run(s[mb],
                             wgmma_desc(sQ + (cw * MB + mb) * 64 * 16 + kk * 2 * BQ * 16, BQ * 16,
                                        128),
                             wgmma_desc(tK + kk * 2 * BK * 16, BK * 16, 128), kk > 0 ? 1 : 0);
        }
      wgmma_commit();
    };
    // O += p v of tile j: v MN-major. Chunk-major: next 8 keys 128 bytes
    // on, next 8 dims BK * 16. Swizzled (K1's): 16 keys a step (2 KB),
    // next 8 keys 1,024 bytes on, next 64 dims one slab (BK * 128 bytes) on.
    auto issue_pv = [&](int j) {
      const __nv_bfloat16* tV = sV + (j % NST) * BK * DP;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int mb = 0; mb < MB; ++mb) {
          if constexpr (SW)
            WgmmaRS<DP>::run(acc[mb], pa[mb][kk],
                             wgmma_desc_sw128(tV + kk * 16 * 64, BK * 128, 1024), 1);
          else
            WgmmaRS<DP>::run(acc[mb], pa[mb][kk], wgmma_desc(tV + kk * 16 * 8, 128, BK * 16), 1);
        }
      wgmma_commit();
    };
    // online softmax of tile j: the sums to f32 times their key's scale,
    // the kv tail masked to -inf, then K1's softmax with the row factor
    // c_row. This thread holds rows g (s[4n], s[4n+1]) and g + 8 (s[4n+2],
    // s[4n+3]) of its warp's 16 of each row block, keys 8n + 2t, 8n + 2t + 1.
    const bool fold = c_row > 0.f;
    auto softmax = [&](int j, float (&alpha)[MB][2]) {
      const int kv0 = j * BK;
      const float* tS = sS + (j % NST) * BK;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        const float2 skv = *reinterpret_cast<const float2*>(tS + n * 8 + 2 * t);
#pragma unroll
        for (int mb = 0; mb < MB; ++mb)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[mb][4 * n + e] =
                __float_as_uint(s32_to_f32(s[mb][4 * n + e]) * ((e & 1) ? skv.y : skv.x));
      }
      if (kv0 + BK > Skv) {
#pragma unroll
        for (int mb = 0; mb < MB; ++mb)
#pragma unroll
          for (int i = 0; i < BK / 2; ++i)
            if (kv0 + (i >> 2) * 8 + 2 * t + (i & 1) >= Skv) s[mb][i] = __float_as_uint(-INFINITY);
      }
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) {
        float tmax[2] = {-INFINITY, -INFINITY};
        if (fold) {
#pragma unroll
          for (int i = 0; i < BK / 2; ++i)
            tmax[(i >> 1) & 1] = fmaxf(tmax[(i >> 1) & 1], __uint_as_float(s[mb][i]));
        } else {
#pragma unroll
          for (int i = 0; i < BK / 2; ++i) {
            s[mb][i] = __float_as_uint(__uint_as_float(s[mb][i]) * c_row);
            tmax[(i >> 1) & 1] = fmaxf(tmax[(i >> 1) & 1], __uint_as_float(s[mb][i]));
          }
        }
        float neg_m[2];  // -(the new running max), in the exponent's units
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
          tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
          if (fold) tmax[r] *= c_row;
          const float m_new = fmaxf(m_run[mb][r], tmax[r]);  // finite: a tile has a valid key
          alpha[mb][r] = fast_exp2(m_run[mb][r] - m_new);
          m_run[mb][r] = m_new;
          neg_m[r] = -m_new;
        }
        const float c = fold ? c_row : 1.f;
        float rsum[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const float p = fast_exp2(fmaf(__uint_as_float(s[mb][i]), c, neg_m[(i >> 1) & 1]));
          s[mb][i] = __float_as_uint(p);
          rsum[(i >> 1) & 1] += p;
        }
        l_run[mb][0] = l_run[mb][0] * alpha[mb][0] + rsum[0];
        l_run[mb][1] = l_run[mb][1] * alpha[mb][1] + rsum[1];
      }
    };
    // p as bf16 A fragments: keys 16kk..16kk+15 are blocks 2kk, 2kk + 1
    auto pack_p = [&]() {
#pragma unroll
      for (int mb = 0; mb < MB; ++mb)
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
          for (int x = 0; x < 4; ++x)
            pa[mb][kk][x] = pack_bf16(__uint_as_float(s[mb][8 * kk + 2 * x]),
                                      __uint_as_float(s[mb][8 * kk + 2 * x + 1]));
    };

    // the two consumer warpgroups take turns to issue their products, as
    // in K1 (named barriers 1 and 2)
    const int my_turn = 1 + cw, other_turn = 2 - cw;
    if (cw == 1) named_arrive(other_turn, 256);
    auto take_turn = [&]() { named_sync(my_turn, 256); };
    auto pass_turn = [&](bool last) {
      if (cw == 0 || !last) named_arrive(other_turn, 256);
    };

    mbar_wait(qbar, 0);
    mbar_wait(&full[0], 0);
    take_turn();
    fence_all();
    wgmma_fence();
    issue_qk(0);
    pass_turn(false);
    wgmma_wait<0>();
    fence_all();
    {
      float alpha[MB][2];
      softmax(0, alpha);  // alpha is 0 and acc is 0: nothing to rescale
      pack_p();
    }
    for (int j = 0; j + 1 < n_tiles; ++j) {
      mbar_wait(&full[(j + 1) % NST], ((j + 1) / NST) & 1);
      take_turn();
      fence_all();
      wgmma_fence();
      issue_qk(j + 1);
      issue_pv(j);
      pass_turn(false);
      wgmma_wait<1>();  // q.k^T of tile j + 1 (the older group) is done
      fence_all();
      float alpha[MB][2];
      softmax(j + 1, alpha);
      wgmma_wait<0>();  // p.v of tile j is done: acc and pa are free
      fence_all();
#pragma unroll
      for (int mb = 0; mb < MB; ++mb)
#pragma unroll
        for (int i = 0; i < DP / 2; ++i) acc[mb][i] *= alpha[mb][(i >> 1) & 1];
      pack_p();
      // this warp is done with stage j: one arrive for its 32 threads
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[j % NST]);
    }
    take_turn();
    fence_all();
    wgmma_fence();
    issue_pv(n_tiles - 1);
    pass_turn(true);
    wgmma_wait<0>();
    fence_all();

    const long row_stride = (long)H * D;
    __nv_bfloat16* ob = o + ((long)b * Sq * H + h) * D;
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) {
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float l = l_run[mb][r];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        inv[r] = 1.f / fmaxf(l, 1e-30f);
      }
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        const int col = n * 8 + 2 * t;
        if (col >= D) continue;  // d % 8 == 0: an 8-column block is wholly in or out
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = q0 + (cw * MB + mb) * 64 + warp * 16 + g + 8 * r;
          if (row < Sq)
            *reinterpret_cast<__nv_bfloat162*>(ob + (long)row * row_stride + col) =
                __floats2bfloat162_rn(acc[mb][4 * n + 2 * r] * inv[r],
                                      acc[mb][4 * n + 2 * r + 1] * inv[r]);
        }
      }
    }
  }
}

// ------------------------------------------------------------------- host

// q8 or k8 as the pre-pass writes it, (BH, DK / 16, S, 16), as 4-d (16, S,
// DK / 16, BH): one box of 16 x rows x DK / 16 chunks is a tile, laid out
// [chunk][row][16]; rows past S read as zeros
bool make_s8_map(CUtensorMap* map, const void* x, int BH, int S, int DK, int rows) {
  const cuuint64_t dims[4] = {16, (cuuint64_t)S, (cuuint64_t)(DK / 16), (cuuint64_t)BH};
  const cuuint64_t strides[3] = {16, (cuuint64_t)S * 16, (cuuint64_t)S * 16 * (DK / 16)};
  const cuuint32_t box[4] = {16, (cuuint32_t)rows, (cuuint32_t)(DK / 16), 1};
  return tensor_map_4d(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, x, dims, strides, box);
}

// v as the pre-pass writes it, (BH, D / 8, S, 8) bf16, as K1 reads its
// chunk-major copy: chunks past D / 8 and keys past S read as zeros
bool make_v_map(CUtensorMap* map, const void* x, int BH, int S, int D, int DP, int rows) {
  const cuuint64_t dims[4] = {8, (cuuint64_t)S, (cuuint64_t)(D / 8), (cuuint64_t)BH};
  const cuuint64_t strides[3] = {16, (cuuint64_t)S * 16, (cuuint64_t)S * 16 * (D / 8)};
  const cuuint32_t box[4] = {8, (cuuint32_t)rows, (cuuint32_t)(DP / 8), 1};
  return tensor_map_4d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, dims, strides, box);
}

template <int DK, int DP, bool SW>
int launch(const void* q8, const void* k8, const void* vc, const void* sq, const void* sk,
           void* o, int B, int H, int Sq, int Skv, int D, int bq, float scale,
           cudaStream_t stream) {
  const size_t bytes = SW ? SW_SMEM : smem_bytes(DK, DP);
  static bool attr_set = false;  // once per kernel instance, not per launch
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(flash_int8_wgmma_kernel<DK, DP, SW>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)bytes);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  CUtensorMap tq, tk, tv;
  bool mapped;
  if constexpr (SW)
    mapped = tensor_map_rows_sw128(&tq, q8, B * H, Sq, SW_D, SW_BQ) &&
             tensor_map_rows_sw128(&tk, k8, B * H, Skv, SW_D, SW_BK) &&
             tensor_map_bshd_sw128(&tv, vc, B, Skv, H, SW_BK);
  else
    mapped = make_s8_map(&tq, q8, B * H, Sq, DK, q_rows(DP)) &&
             make_s8_map(&tk, k8, B * H, Skv, DK, kv_rows(DP)) &&
             make_v_map(&tv, vc, B * H, Skv, D, DP, kv_rows(DP));
  if (!mapped) return (int)cudaErrorInvalidValue;
  const int bq_rows = SW ? SW_BQ : q_rows(DP);
  const dim3 grid((Sq + bq_rows - 1) / bq_rows, B * H);
  flash_int8_wgmma_kernel<DK, DP, SW><<<grid, NTHREADS, bytes, stream>>>(
      tq, tk, tv, (const float*)sq, (const float*)sk, (__nv_bfloat16*)o, H, Sq, Skv, D,
      (Sq + bq - 1) / bq, bq, (Skv + 127) / 128 * 128, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int H, int Sq, int Skv, int D, int bq) {
  return B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0 || D <= 0 || D % 8 != 0 || D > MAX_D ||
         (long)B * H > 65535 || bq <= 0 || bq % 128 != 0 ||
         (Sq > bq && bq != 1024);  // a q tile lies in one Q-scale block
}


// scratch: qmax (BH * n_qs), part (BH * n_ks * D), with PV vpart (BH *
// n_ks * D), kmean (BH * D), count (BH)
template <int CH, bool PV, bool SW>
int launch_prepass(const void* q, const void* k, const void* v, void* q8, void* k8, void* vc,
                   void* v8, void* qb, void* kb, void* sq, void* sk, void* sv, void* scratch,
                   int B, int H, int Sq, int Skv, int bq, cudaStream_t s) {
  const int BH = B * H, D = CH * 8;
  const int n_qs = (Sq + SLICE - 1) / SLICE, n_ks = (Skv + SLICE - 1) / SLICE;
  float* qmax = (float*)scratch;
  float* part = qmax + (long)BH * n_qs;
  float* vpart = part + (long)BH * n_ks * D;
  float* kmean = vpart + (PV ? (long)BH * n_ks * D : 0);
  unsigned* count = (unsigned*)(kmean + (long)BH * D);
  cudaError_t err = cudaMemsetAsync(count, 0, (size_t)BH * 4, s);
  if (err != cudaSuccess) return (int)err;
  flash_int8_prepass_stats_kernel<CH, PV><<<BH * (n_qs + n_ks), PRE_THREADS, 0, s>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, qmax, part,
      vpart, kmean, (float*)sv, count, H, Sq, Skv, n_qs, n_ks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_int8_prepass_quant_kernel<CH, PV, SW><<<BH * (n_qs + n_ks), PRE_THREADS, 0, s>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, qmax, kmean,
      (const float*)sv, (int8_t*)q8, (int8_t*)k8, (__nv_bfloat16*)vc, (int8_t*)v8,
      (__nv_bfloat16*)qb, (__nv_bfloat16*)kb, (float*)sq, (float*)sk, H, Sq, Skv, bq,
      (Sq + bq - 1) / bq, n_qs, n_ks, (Skv + 127) / 128 * 128);
  return (int)cudaGetLastError();
}

}  // namespace

// The pre-pass. q (B, Sq, H, D), k and v (B, Skv, H, D) bf16; writes q8
// (B*H, DK/16, Sq, 16) and k8 (B*H, DK/16, Skv, 16) int8, vc (B*H, D/8,
// Skv, 8) bf16, sq (B*H, ceil(Sq / bq)) and sk (B*H, ceil128(Skv)) f32;
// at D = 128 q8 (B*H, Sq, 128) and k8 (B*H, Skv, 128) and no vc (the
// kernel reads v in place; vc is not written);
// scratch: B*H * (n_qs + n_ks * D + D + 1) f32, n_qs = ceil(Sq / 256), n_ks
// = ceil(Skv / 256). DK = ceil32(D), D % 8 == 0, D <= 160; bq =
// min(1024, ceil128(Sq)). All contiguous and 16-byte aligned. Returns
// cudaGetLastError() after the launches.
extern "C" int tclight_qk_int8_prepass(const void* q, const void* k, const void* v, void* q8,
                                       void* k8, void* vc, void* sq, void* sk, void* scratch,
                                       int B, int H, int Sq, int Skv, int D, int bq,
                                       void* stream) {
  if (bad_shape(B, H, Sq, Skv, D, bq)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (D == SW_D)
    return launch_prepass<SW_D / 8, false, true>(q, k, v, q8, k8, vc, nullptr, nullptr, nullptr,
                                                 sq, sk, nullptr, scratch, B, H, Sq, Skv, bq, s);
  switch (D / 8) {
#define TCLIGHT_PREPASS_CASE(CH_)                                                             \
  case CH_:                                                                                  \
    return launch_prepass<CH_, false, false>(q, k, v, q8, k8, vc, nullptr, nullptr, nullptr, sq, sk, \
                                      nullptr, scratch, B, H, Sq, Skv, bq, s);
    TCLIGHT_PREPASS_CASE(1) TCLIGHT_PREPASS_CASE(2) TCLIGHT_PREPASS_CASE(3)
    TCLIGHT_PREPASS_CASE(4) TCLIGHT_PREPASS_CASE(5) TCLIGHT_PREPASS_CASE(6)
    TCLIGHT_PREPASS_CASE(7) TCLIGHT_PREPASS_CASE(8) TCLIGHT_PREPASS_CASE(9)
    TCLIGHT_PREPASS_CASE(10) TCLIGHT_PREPASS_CASE(11) TCLIGHT_PREPASS_CASE(12)
    TCLIGHT_PREPASS_CASE(13) TCLIGHT_PREPASS_CASE(14) TCLIGHT_PREPASS_CASE(15)
    TCLIGHT_PREPASS_CASE(16) TCLIGHT_PREPASS_CASE(17) TCLIGHT_PREPASS_CASE(18)
    TCLIGHT_PREPASS_CASE(19) TCLIGHT_PREPASS_CASE(20)
#undef TCLIGHT_PREPASS_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

// K7's pre-pass: as above, but v8 (B*H, ceil16(Skv) / 16, D, 16) int8 in
// the place of vc, sv (B*H, D) f32, and q8's and k8's values also in bf16
// for the max pass, qb (B*H, DB / 8, Sq, 8) and kb (B*H, DB / 8, Skv, 8),
// DB = ceil16(D); scratch: B*H * (n_qs + 2 * n_ks * D + D + 1) f32. At D =
// 128: q8 and k8 row-major as K6's, v8 channel-major (B*H, 128,
// ceil128(Skv)), each channel's keys permuted within each 16 as above,
// and no qb / kb (the max pass reads q8 and k8).
extern "C" int tclight_int8pv_prepass(const void* q, const void* k, const void* v, void* q8,
                                      void* k8, void* v8, void* qb, void* kb, void* sq,
                                      void* sk, void* sv, void* scratch, int B, int H, int Sq,
                                      int Skv, int D, int bq, void* stream) {
  if (bad_shape(B, H, Sq, Skv, D, bq)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (D == SW_D)
    return launch_prepass<SW_D / 8, true, true>(q, k, v, q8, k8, nullptr, v8, nullptr, nullptr, sq,
                                                sk, sv, scratch, B, H, Sq, Skv, bq, s);
  switch (D / 8) {
#define TCLIGHT_PREPASS_CASE(CH_)                                                             \
  case CH_:                                                                                  \
    return launch_prepass<CH_, true, false>(q, k, v, q8, k8, nullptr, v8, qb, kb, sq, sk, sv, scratch, \
                                     B, H, Sq, Skv, bq, s);
    TCLIGHT_PREPASS_CASE(1) TCLIGHT_PREPASS_CASE(2) TCLIGHT_PREPASS_CASE(3)
    TCLIGHT_PREPASS_CASE(4) TCLIGHT_PREPASS_CASE(5) TCLIGHT_PREPASS_CASE(6)
    TCLIGHT_PREPASS_CASE(7) TCLIGHT_PREPASS_CASE(8) TCLIGHT_PREPASS_CASE(9)
    TCLIGHT_PREPASS_CASE(10) TCLIGHT_PREPASS_CASE(11) TCLIGHT_PREPASS_CASE(12)
    TCLIGHT_PREPASS_CASE(13) TCLIGHT_PREPASS_CASE(14) TCLIGHT_PREPASS_CASE(15)
    TCLIGHT_PREPASS_CASE(16) TCLIGHT_PREPASS_CASE(17) TCLIGHT_PREPASS_CASE(18)
    TCLIGHT_PREPASS_CASE(19) TCLIGHT_PREPASS_CASE(20)
#undef TCLIGHT_PREPASS_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

// K6 on the pre-pass's operands (at D = 128 vc is v (B, Skv, H, D) as it
// lies); o (B, Sq, H, D) bf16. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue when the arguments or the tensor maps are
// refused).
extern "C" int tclight_flash_attention_qk_int8(const void* q8, const void* k8, const void* vc,
                                               const void* sq, const void* sk, void* o, int B,
                                               int H, int Sq, int Skv, int D, int bq,
                                               float scale, void* stream) {
  if (bad_shape(B, H, Sq, Skv, D, bq)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (D == SW_D)
    return launch<SW_D, SW_D, true>(q8, k8, vc, sq, sk, o, B, H, Sq, Skv, D, bq, scale, s);
#define TCLIGHT_QK_INT8_CASE(DK_, DP_)                                                    \
  if ((D + 31) / 32 * 32 == DK_ && (D + 15) / 16 * 16 == DP_)                             \
    return launch<DK_, DP_, false>(q8, k8, vc, sq, sk, o, B, H, Sq, Skv, D, bq, scale, s);
  TCLIGHT_QK_INT8_CASE(32, 16)
  TCLIGHT_QK_INT8_CASE(32, 32)
  TCLIGHT_QK_INT8_CASE(64, 48)
  TCLIGHT_QK_INT8_CASE(64, 64)
  TCLIGHT_QK_INT8_CASE(96, 80)
  TCLIGHT_QK_INT8_CASE(96, 96)
  TCLIGHT_QK_INT8_CASE(128, 112)
  TCLIGHT_QK_INT8_CASE(128, 128)  // D = 120
  TCLIGHT_QK_INT8_CASE(160, 144)
  TCLIGHT_QK_INT8_CASE(160, 160)
#undef TCLIGHT_QK_INT8_CASE
  return (int)cudaErrorInvalidValue;
}
