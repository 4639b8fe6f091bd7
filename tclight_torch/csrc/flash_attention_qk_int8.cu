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
// on the special-function units (16 a clock an SM), as in K1. Beside K1's
// softmax each score takes a conversion from int32, a multiply by its key's
// scale and a shared-memory read of that scale: that work, not the
// products, sets K6's time (PERF.md, the int8 attentions' ablation).
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
//   per token as for q, and k8.
// It writes q8 (BH, Sq, DR) and k8 (BH, Skv, DR) int8 row-major, a row
// of DR = ceil16(D) bytes, the dims past D zero; sq (BH, n_qb) and sk (BH,
// ceil128(Skv)) f32, the padded keys' scales 0. It writes no v copy: K6
// reads v in place. At level 0 it reads q and k twice (the second mostly
// from L2) and writes ~0.05 GB.
//
// The same two kernels with PV = true are the pre-pass of K7
// (csrc/flash_attention_int8.cu, int8 p.v; entry tclight_int8pv_prepass;
// plain version `int8pv_operands_plain`): the stats kernel's k slices
// also take V's channel amax over their keys, and the last slice to finish
// makes sv = max(amax, 1e-6) / 127 per (batch * head, channel); the quant
// kernel's k slices write K7's K scales, (BH, 2, ceil128(Skv)): each key's
// sk' (its scale with the two lowest significand bits cleared) and -1.5 *
// 2^23 * sk', exact (x * sk' from them by an integer add and one FMA; K7
// reads the first row), and v8 = round_half_even(v / sv) channel-major,
// (BH, D, ceil128(Skv)), each channel's keys contiguous (8-bit wgmma reads
// its B operand K-major only, and a tile of a channel's keys is one
// swizzle row), keys past Skv zero. Within each 16 keys the order is
// permuted: byte 4t + 2a + c holds key 8a + 2t + c, so that the s32 score
// fragment of a thread (keys 2t, 2t + 1 of each 8) packs as it lies into
// the s8 A fragment (bytes 4t..4t+3 of each 16). A k slice stages its
// channels in shared memory and stores each as one contiguous run.
//
// Design of the main kernel: K1's (csrc/flash_attention.cu), the
// FlashAttention-3 shape, with K1's geometry by dp = ceil16(D): one block
// per (q tile, batch * head), a producer warpgroup and three consumer
// warpgroups of 160 registers up to dp 64 (the UNet's D = 40), two of 240
// above; 128-key tiles up to dp 128 (4 stages up to dp 64, 3 above),
// 64-key tiles at dp 144-160 (D = 160). One producer thread loads the q8
// tile by TMA (once), and the k8 tile, the v tile and the tile's K scales
// (one bulk copy) into the ring, behind full / empty mbarriers.
// - Layout, read in place. q8 and k8 tiles are boxes of R8 bytes x a
//   tile's rows in the R8-byte swizzle (hopper.cuh's `tensor_map_rows_sw`),
//   ceil(DK / R8) a row, DK = ceil32(D), R8 = 64 up to DK 64 (the UNet's
//   40; 128-byte boxes measured no faster there) and 128 above, the bytes
//   past the row's DR zero-filled by TMA; v is read from (B, S, H, D) in
//   K1's boxes of 64 dims (`tensor_map_bshd_slabs`). The wrapper makes no
//   copy.
// - q.k^T on wgmma.m64nBKk32.s32.s8.s8, both operands K-major in the
//   swizzle (32 bytes a k32 step within a row, as K1's bf16 k16 steps);
//   DK / 32 steps: 2 at D = 40, 3 at 80, 5 at 160.
// - p.v on wgmma.m64nDPk16 bf16 with p packed in registers, K1's.
// - Scores. The int32 sums convert to f32 exactly, |q8 . k8| <= 127^2 *
//   160 < 2^24, by the conversion instruction, times the key's scale (a
//   float2 of two keys' scales from the stage). An integer add and one
//   FMA with a pair of scales a key (`kernel_k_scales`) measured slower here:
//   the pairs' shared-memory reads cost more than the conversion, whose
//   unit is not the exponentials'. Then K1's softmax with the row factor
//   c = sq * scale * log2(e) of the warpgroup's 64 rows (64 divides the
//   1024-row Q-scale block): the row max on the scores, c folded into the
//   exponent's FMA; keys past Skv masked to -inf in the last tile; where D
//   = dp - 8 up to dp 64 (the UNet's 40) the row sums come from p.v
//   through a v column of ones at dim D (`SUMCOL`, K1's); out = acc /
//   max(l, 1e-30).
// - Overlap, as K1: tile j's p.v and tile j + 1's q.k^T are issued
//   together and the softmax of tile j + 1 runs while that p.v is in
//   flight; the consumer warpgroups take turns, in a ring, to issue
//   (named barriers). No wgmma is issued under a condition.
//
// Shared memory per block: q rows * ceil(DK / R8) * R8 bytes, and per
// stage a k8 tile of as many bytes a row, a v tile of ceil(dp / 64) * 128
// bytes a key and 4 bytes a key of K scales; the barriers and the
// 1,024-byte alignment: 113,736 at D = 40, 166,456 at D = 80 and 128,
// 157,496 at D = 160.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

using namespace tclight::hopper;

namespace {

constexpr int MAX_D = 160;
constexpr int SLAB = 64;    // bf16 dims of one of v's boxes: a 128-byte swizzle row
constexpr int PRE_THREADS = 256;
constexpr int SLICE = 256;  // rows (queries or keys) per block of the pre-pass
constexpr float ROUND_MAGIC = 12582912.f;  // 1.5 * 2^23 (K7's K-scale pairs)

// The geometry, by dp = ceil16(D): K1's
__host__ __device__ constexpr int depth8(int dp) { return (dp + 31) / 32 * 32; }  // DK
// bytes of a row of one of q8's or k8's boxes: one 64-byte swizzle row where
// the q.k^T depth fits it (the UNet's 40), else a 128-byte one
__host__ __device__ constexpr int row8(int dp) { return depth8(dp) <= 64 ? 64 : 128; }
__host__ __device__ constexpr int slabs8(int dp) { return (depth8(dp) + row8(dp) - 1) / row8(dp); }
__host__ __device__ constexpr int slabs(int dp) { return (dp + SLAB - 1) / SLAB; }
__host__ __device__ constexpr int consumers(int dp) { return dp <= 64 ? 3 : 2; }
__host__ __device__ constexpr int q_rows(int dp) { return 64 * consumers(dp); }
__host__ __device__ constexpr int kv_rows(int dp) { return dp <= 128 ? 128 : 64; }
__host__ __device__ constexpr int n_stages(int dp) { return dp <= 64 ? 4 : 3; }
// where D = dp - 8, p.v also takes the row sums (see `SUMCOL`)
__host__ __device__ constexpr bool sums_on_tc(int dp) { return dp <= 64; }
// independent chains a row of the softmax's row max and row sum
__host__ __device__ constexpr int chains(int dp) { return dp <= 96 ? 2 : 1; }
__host__ __device__ constexpr int n_threads(int dp) { return 128 * (1 + consumers(dp)); }
// a consumer thread's registers: the block's launch share (65,536 over its
// threads, in 8s) less the producer's 24, over the consumers
__host__ __device__ constexpr int consumer_regs(int nwg) {
  return ((65536 / (128 * (nwg + 1))) / 8 * 8 * (nwg + 1) - 24) / nwg / 8 * 8;
}
// bytes of one stage: the k8 tile, the v tile, the K scales
__host__ __device__ constexpr int stage_bytes(int dp) {
  return kv_rows(dp) * (slabs8(dp) * row8(dp) + slabs(dp) * SLAB * 2 + 4);
}
__host__ __device__ constexpr size_t smem_bytes(int dp) {
  return (size_t)q_rows(dp) * slabs8(dp) * row8(dp) + (size_t)n_stages(dp) * stage_bytes(dp) +
         8 * (1 + 2 * n_stages(dp)) + 1024;
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

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
// and writes that scale (PV: K7's pair, see the head) and, PV, v8, staged
// in shared memory.
template <int CH, bool PV>
__global__ void __launch_bounds__(PRE_THREADS)
flash_int8_prepass_quant_kernel(const __nv_bfloat16* __restrict__ q,
                                const __nv_bfloat16* __restrict__ k,
                                const __nv_bfloat16* __restrict__ v,
                                const float* __restrict__ qmax, const float* __restrict__ kmean,
                                const float* __restrict__ sv, int8_t* __restrict__ q8,
                                int8_t* __restrict__ k8, int8_t* __restrict__ v8,
                                float* __restrict__ sq, float* __restrict__ sk, int H, int Sq,
                                int Skv, int bq, int n_qb, int n_qs, int n_ks, int skv_pad) {
  constexpr int D = CH * 8;
  constexpr int W16 = (D + 15) / 16;  // 16-byte chunks of a q8 or k8 row (DR / 16)
  __shared__ float km[D];
  // PV: V's channel scales, and the slice's v8, D channels x 256 keys
  __shared__ float svs[PV ? D : 1];
  __shared__ __align__(16) int8_t v8s[PV ? SLICE * D : 16];
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
    uint4* row = reinterpret_cast<uint4*>(q8 + ((long)bh * Sq + r) * W16 * 16);
#pragma unroll
    for (int c16 = 0; c16 < W16; ++c16) row[c16] = quantize_chunk<CH>(c16, value, s);
    return;
  }
  const int r = (sl - n_qs) * SLICE + threadIdx.x;
  for (int c = threadIdx.x; c < D; c += PRE_THREADS) {
    km[c] = kmean[bh * D + c];
    if constexpr (PV) svs[c] = sv[bh * D + c];
  }
  __syncthreads();
  if constexpr (PV) {
    // byte 4t + 2a + c of each 16 keys holds key 8a + 2t + c; staged as
    // [channel][key of the slice]
    const int kp = threadIdx.x % 16;
    const int perm = 4 * ((kp % 8) / 2) + 2 * (kp / 8) + kp % 2;
    int8_t* dst = v8s + (threadIdx.x / 16) * 16 + perm;
    if (r < Skv) {
      uint4 u[CH];
      load_row<CH>(v + (((long)b * Skv + r) * H + h) * D, u);
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        float f[8];
        unpack8(u[c], f);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[(c * 8 + e) * SLICE] = (int8_t)__float2int_rn(f[e] / svs[c * 8 + e]);
      }
    } else {
      for (int c = 0; c < D; ++c) dst[c * SLICE] = 0;
    }
    __syncthreads();
    // (BH, D, skv_pad): each channel's keys of the slice below skv_pad (a
    // multiple of 128) are one contiguous run
    const int k0 = (sl - n_qs) * SLICE, n16 = min(SLICE, skv_pad - k0) / 16;
    for (int i = threadIdx.x; i < n16 * D; i += PRE_THREADS) {
      const int c = i / n16, u = i % n16;
      reinterpret_cast<uint4*>(v8 + ((long)bh * D + c) * skv_pad + k0)[u] =
          reinterpret_cast<const uint4*>(v8s + c * SLICE)[u];
    }
  }
  if (r >= Skv) {
    if (r < skv_pad) {
      sk[(long)bh * (PV ? 2 : 1) * skv_pad + r] = 0.f;
      if constexpr (PV) sk[((long)bh * 2 + 1) * skv_pad + r] = 0.f;
    }
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
  if constexpr (PV) {
    // K7's pair: s with its two lowest significand bits cleared, so that
    // 1.5 * 2^23 times it is exact, and that product negated (see the head)
    const float s_kern = __uint_as_float(__float_as_uint(s) & ~3u);
    sk[(long)bh * 2 * skv_pad + r] = s_kern;
    sk[((long)bh * 2 + 1) * skv_pad + r] = -ROUND_MAGIC * s_kern;
  } else {
    sk[(long)bh * skv_pad + r] = s;
  }
  auto value = [&](int c, int e) { return ks[c * 8 + e]; };
  uint4* row = reinterpret_cast<uint4*>(k8 + ((long)bh * Skv + r) * W16 * 16);
#pragma unroll
  for (int c16 = 0; c16 < W16; ++c16) row[c16] = quantize_chunk<CH>(c16, value, s);
}

// ---------------------------------------------------------- main kernel

template <int DP, bool SUMCOL>
__global__ void __launch_bounds__(n_threads(DP), 1)
flash_int8_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const float* __restrict__ sq, const float* __restrict__ sk,
                        __nv_bfloat16* __restrict__ o, int H, int Sq, int Skv, int D, int n_qb,
                        int bq, int skv_pad, float scale_log2) {
  constexpr int NWG = consumers(DP);
  constexpr int BQ = q_rows(DP);
  constexpr int BK = kv_rows(DP);
  constexpr int NST = n_stages(DP);
  constexpr int DK = depth8(DP);
  constexpr int R8 = row8(DP);         // bytes of a q8 or k8 box row (a swizzle row)
  constexpr int NSK = slabs8(DP);      // R8-byte slabs of a q8 or k8 row
  constexpr int NS = slabs(DP);        // 64-dim slabs of a v row
  constexpr int NPV = DP;              // the p.v width
  constexpr int KTILE = BK * NSK * R8;  // bytes of one k8 tile
  constexpr int VTILE = BK * NS * SLAB;  // elements of one v tile
  constexpr uint32_t STAGE_TX = KTILE + VTILE * 2 + BK * 4;
  constexpr int REGS = consumer_regs(NWG);  // 240 for two consumers, 160 for three
  // SUMCOL (D = DP - 8): dim D of every v tile, zero-filled by TMA, is set
  // to 1 before its p.v, so acc's column D sums each row's p and is
  // rescaled with the rest; the softmax takes no row sums (K1's)
  constexpr int SUM_DIM = DP - 8;
  constexpr int CH = chains(DP);
  static_assert(BQ <= 256 && NPV <= NS * SLAB, "a TMA box holds at most 256 rows");
  static_assert(!SUMCOL || SUM_DIM < NPV, "the sum column lies in the p.v width");
  extern __shared__ unsigned char smem_raw[];
  int8_t* sQ = reinterpret_cast<int8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  int8_t* sK = sQ + BQ * NSK * R8;                                          // NST tiles
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(sK + NST * KTILE);   // NST tiles
  float* sS = reinterpret_cast<float*>(sV + NST * VTILE);  // NST tiles of K scales
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
      mbar_init(&empty[s], NWG * 4);  // one arrive per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------------------------------------------------- producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(qbar, BQ * NSK * R8);
      for (int c = 0; c < NSK; ++c) tma_load_4d(sQ + c * BQ * R8, &tq, qbar, c * R8, q0, bh, 0);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % NST;
        if (j >= NST) mbar_wait(&empty[st], ((j / NST) - 1) & 1);
        mbar_expect_tx(&full[st], STAGE_TX);
        for (int c = 0; c < NSK; ++c)
          tma_load_4d(sK + st * KTILE + c * BK * R8, &tk, &full[st], c * R8, j * BK, bh, 0);
        for (int c = 0; c < NS; ++c)
          tma_load_4d(sV + st * VTILE + c * BK * SLAB, &tv, &full[st], c * SLAB, h, j * BK, b);
        bulk_load(sS + st * BK, sk + (long)bh * skv_pad + j * BK, BK * 4, &full[st]);
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    setmaxnreg_inc<REGS>();
    const int cw = wg - 1;  // which 64 q rows
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    // the row factor of the logits: the Q scale of this warpgroup's 64 rows
    // (64 divides the Q-scale block), the softmax scale and log2(e)
    const float c_row = scale_log2 * sq[bh * n_qb + min((q0 + cw * 64) / bq, n_qb - 1)];

    float acc[NPV / 2];
    uint32_t s[BK / 2];      // int32 sums, then f32 bits in place
    uint32_t pa[BK / 16][4];  // p of the tile whose p.v is next or in flight
    float m_run[2], l_run[2];  // l: this thread's share of the row sums
#pragma unroll
    for (int i = 0; i < NPV / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0u;
    m_run[0] = m_run[1] = -INFINITY;
    l_run[0] = l_run[1] = 0.f;
    // dim SUM_DIM of tile j's v rows to 1 (SUMCOL): one key a thread, its
    // 16-byte chunk in the 128-byte swizzle; every consumer warpgroup writes
    // the same ones, before its own p.v of the tile, ordered by its turn's
    // barrier
    auto ones_column = [&](int j) {
      if constexpr (SUMCOL) {
        const int r = threadIdx.x % 128;
        if (r < BK) {
          __nv_bfloat16* row = sV + (j % NST) * VTILE + (SUM_DIM / SLAB) * BK * SLAB + r * SLAB;
          row[(((SUM_DIM % SLAB) / 8) ^ (r & 7)) * 8] = __float2bfloat16(1.f);
        }
        fence_proxy_async();
      }
    };
    auto fence_all = [&]() {
      fence_regs(s);
      fence_regs(acc);
    };

    // int32 q8 k8^T of tile j into s: 64 rows x BK keys in DK / 32 steps
    // of depth 32, both operands K-major in the R8-byte swizzle: slab kk /
    // (R8 / 32), 32 bytes a step within its rows; this warpgroup's 64 q rows
    // 64 * R8 bytes into each slab
    auto issue_qk = [&](int j) {
      const int8_t* tK = sK + (j % NST) * KTILE;
      constexpr int STEPS = R8 / 32;  // k32 steps a slab
#pragma unroll
      for (int kk = 0; kk < DK / 32; ++kk)
        WgmmaS8<BK>::run(s,
                         wgmma_desc_rows(sQ + (kk / STEPS) * BQ * R8 + cw * 64 * R8 +
                                         (kk % STEPS) * 32, R8),
                         wgmma_desc_rows(tK + (kk / STEPS) * BK * R8 + (kk % STEPS) * 32, R8),
                         kk > 0 ? 1 : 0);
      wgmma_commit();
    };
    // O += p v of tile j (K1's): v MN-major, 16 keys a step (2 KB), the next
    // 8 keys 1,024 bytes on, the next 64 dims one slab (BK * 128 bytes) on
    auto issue_pv = [&](int j) {
      const __nv_bfloat16* tV = sV + (j % NST) * VTILE;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        WgmmaRS<NPV>::run(acc, pa[kk], wgmma_desc_sw128(tV + kk * 16 * SLAB, BK * 128, 1024), 1);
      wgmma_commit();
    };
    // online softmax of tile j: the sums to f32 times their key's scale
    // (see the head), the kv tail masked to -inf, then K1's softmax with the
    // row factor c_row. This thread holds rows g (s[4n], s[4n+1]) and g + 8
    // (s[4n+2], s[4n+3]) of its warp's 16, keys 8n + 2t, 8n + 2t + 1.
    const bool fold = c_row > 0.f;
    auto softmax = [&](int j, float (&alpha)[2]) {
      const int kv0 = j * BK;
      const float* tS = sS + (j % NST) * BK;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        const float2 skv = *reinterpret_cast<const float2*>(tS + n * 8 + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * n + e;
          s[i] = __float_as_uint((float)(int)s[i] * ((e & 1) ? skv.y : skv.x));
        }
      }
      if (kv0 + BK > Skv) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i)
          if (kv0 + (i >> 2) * 8 + 2 * t + (i & 1) >= Skv) s[i] = __float_as_uint(-INFINITY);
      }
      float tmax[2][CH];
#pragma unroll
      for (int ch = 0; ch < CH; ++ch) tmax[0][ch] = tmax[1][ch] = -INFINITY;
      if (fold) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i)
          tmax[(i >> 1) & 1][(i >> 2) % CH] =
              fmaxf(tmax[(i >> 1) & 1][(i >> 2) % CH], __uint_as_float(s[i]));
      } else {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          s[i] = __float_as_uint(__uint_as_float(s[i]) * c_row);
          tmax[(i >> 1) & 1][(i >> 2) % CH] =
              fmaxf(tmax[(i >> 1) & 1][(i >> 2) % CH], __uint_as_float(s[i]));
        }
      }
      float neg_m[2];  // -(the new running max), in the exponent's units
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = tmax[r][0];
#pragma unroll
        for (int ch = 1; ch < CH; ++ch) mx = fmaxf(mx, tmax[r][ch]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        if (fold) mx *= c_row;
        const float m_new = fmaxf(m_run[r], mx);  // finite: a tile has a valid key
        alpha[r] = fast_exp2(m_run[r] - m_new);
        m_run[r] = m_new;
        neg_m[r] = -m_new;
      }
      const float c = fold ? c_row : 1.f;
      float rsum[2][CH] = {};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const float p = fast_exp2(fmaf(__uint_as_float(s[i]), c, neg_m[(i >> 1) & 1]));
        s[i] = __float_as_uint(p);
        if constexpr (!SUMCOL) rsum[(i >> 1) & 1][(i >> 2) % CH] += p;
      }
      if constexpr (!SUMCOL) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float sum = rsum[r][0];
#pragma unroll
          for (int ch = 1; ch < CH; ++ch) sum += rsum[r][ch];
          l_run[r] = l_run[r] * alpha[r] + sum;
        }
      }
    };
    // p as bf16 A fragments: keys 16kk..16kk+15 are blocks 2kk, 2kk + 1
    auto pack_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          pa[kk][x] = pack_bf16(__uint_as_float(s[8 * kk + 2 * x]),
                                __uint_as_float(s[8 * kk + 2 * x + 1]));
    };

    // The consumer warpgroups take turns, in a ring, to issue their
    // products (K1's): named barrier 1 + c is warpgroup c's turn, 256
    // threads (its sync meets the arrive of the warpgroup before it). The
    // last warpgroup opens warpgroup 0's first turn, and leaves out its
    // last arrive, which no sync would meet.
    const int my_turn = 1 + cw, next_turn = NWG == 2 ? 2 - cw : 1 + (cw + 1) % NWG;
    if (cw == NWG - 1) named_arrive(next_turn, 256);
    auto take_turn = [&]() { named_sync(my_turn, 256); };
    auto pass_turn = [&](bool last) {
      if (cw != NWG - 1 || !last) named_arrive(next_turn, 256);
    };

    mbar_wait(qbar, 0);
    mbar_wait(&full[0], 0);
    ones_column(0);
    take_turn();
    fence_all();
    wgmma_fence();
    issue_qk(0);
    pass_turn(false);
    wgmma_wait<0>();
    fence_all();
    {
      float alpha[2];
      softmax(0, alpha);  // alpha is 0 and acc is 0: nothing to rescale
      pack_p();
    }
    for (int j = 0; j + 1 < n_tiles; ++j) {
      mbar_wait(&full[(j + 1) % NST], ((j + 1) / NST) & 1);
      ones_column(j + 1);
      take_turn();
      fence_all();
      wgmma_fence();
      issue_qk(j + 1);
      issue_pv(j);
      pass_turn(false);
      wgmma_wait<1>();  // q.k^T of tile j + 1 (the older group) is done
      fence_all();
      float alpha[2];
      softmax(j + 1, alpha);
      wgmma_wait<0>();  // p.v of tile j is done: acc and pa are free
      fence_all();
#pragma unroll
      for (int i = 0; i < NPV / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
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
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l;
      if constexpr (SUMCOL) {  // column SUM_DIM: lane 4g's, t = 0
        l = __shfl_sync(0xffffffffu, acc[4 * (SUM_DIM / 8) + 2 * r], lane & ~3);
      } else {
        l = l_run[r];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
      }
      inv[r] = 1.f / fmaxf(l, 1e-30f);
    }
#pragma unroll
    for (int n = 0; n < NPV / 8; ++n) {
      const int col = n * 8 + 2 * t;
      if (col >= D) continue;  // d % 8 == 0: an 8-column block is wholly in or out
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + cw * 64 + warp * 16 + g + 8 * r;
        if (row < Sq)
          *reinterpret_cast<__nv_bfloat162*>(ob + (long)row * row_stride + col) =
              __floats2bfloat162_rn(acc[4 * n + 2 * r] * inv[r], acc[4 * n + 2 * r + 1] * inv[r]);
      }
    }
  }
}

// ------------------------------------------------------------------- host

template <int DP, bool SUMCOL>
int launch(const void* q8, const void* k8, const void* v, const void* sq, const void* sk,
           void* o, int B, int H, int Sq, int Skv, int D, int bq, float scale,
           cudaStream_t stream) {
  const size_t bytes = smem_bytes(DP);
  static bool attr_set = false;  // once per kernel instance, not per launch
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(flash_int8_wgmma_kernel<DP, SUMCOL>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)bytes);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  // q8, k8 (BH, S, DP) row-major, one box of row8 bytes a slab; v in place
  CUtensorMap tq, tk, tv;
  if (!(tensor_map_rows_sw(&tq, q8, B * H, Sq, DP, row8(DP), q_rows(DP)) &&
        tensor_map_rows_sw(&tk, k8, B * H, Skv, DP, row8(DP), kv_rows(DP)) &&
        tensor_map_bshd_slabs(&tv, v, B, Skv, H, D, kv_rows(DP))))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((Sq + q_rows(DP) - 1) / q_rows(DP), B * H);
  flash_int8_wgmma_kernel<DP, SUMCOL><<<grid, n_threads(DP), bytes, stream>>>(
      tq, tk, tv, (const float*)sq, (const float*)sk, (__nv_bfloat16*)o, H, Sq, Skv, D,
      (Sq + bq - 1) / bq, bq, (Skv + 127) / 128 * 128, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_dp(const void* q8, const void* k8, const void* v, const void* sq, const void* sk,
              void* o, int B, int H, int Sq, int Skv, int D, int bq, float scale,
              cudaStream_t stream) {
  if constexpr (sums_on_tc(DP))
    if (D == DP - 8)
      return launch<DP, true>(q8, k8, v, sq, sk, o, B, H, Sq, Skv, D, bq, scale, stream);
  return launch<DP, false>(q8, k8, v, sq, sk, o, B, H, Sq, Skv, D, bq, scale, stream);
}

bool bad_shape(int B, int H, int Sq, int Skv, int D, int bq) {
  return B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0 || D <= 0 || D % 8 != 0 || D > MAX_D ||
         (long)B * H > 65535 || bq <= 0 || bq % 128 != 0 ||
         (Sq > bq && bq != 1024);  // a warpgroup's 64 rows lie in one Q-scale block
}

// scratch: qmax (BH * n_qs), part (BH * n_ks * D), with PV vpart (BH *
// n_ks * D), kmean (BH * D), count (BH)
template <int CH, bool PV>
int launch_prepass(const void* q, const void* k, const void* v, void* q8, void* k8, void* v8,
                   void* sq, void* sk, void* sv, void* scratch, int B, int H, int Sq, int Skv,
                   int bq, cudaStream_t s) {
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
  flash_int8_prepass_quant_kernel<CH, PV><<<BH * (n_qs + n_ks), PRE_THREADS, 0, s>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, qmax, kmean,
      (const float*)sv, (int8_t*)q8, (int8_t*)k8, (int8_t*)v8, (float*)sq, (float*)sk, H, Sq,
      Skv, bq, (Sq + bq - 1) / bq, n_qs, n_ks, (Skv + 127) / 128 * 128);
  return (int)cudaGetLastError();
}

template <bool PV>
int prepass(const void* q, const void* k, const void* v, void* q8, void* k8, void* v8, void* sq,
            void* sk, void* sv, void* scratch, int B, int H, int Sq, int Skv, int D, int bq,
            cudaStream_t s) {
  switch (D / 8) {
#define TCLIGHT_PREPASS_CASE(CH_)                                                       \
  case CH_:                                                                            \
    return launch_prepass<CH_, PV>(q, k, v, q8, k8, v8, sq, sk, sv, scratch, B, H, Sq, Skv, bq, s);
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

}  // namespace

// The pre-pass. q (B, Sq, H, D), k (B, Skv, H, D) bf16; writes q8 (B*H,
// Sq, DR) and k8 (B*H, Skv, DR) int8, DR = ceil16(D), sq (B*H, ceil(Sq /
// bq)) f32 and sk (B*H, ceil128(Skv)) f32, the padded keys' 0; scratch:
// B*H * (n_qs + n_ks * D + D + 1) f32, n_qs = ceil(Sq / 256), n_ks =
// ceil(Skv / 256). D % 8 == 0, D <= 160; bq = min(1024, ceil128(Sq)). All
// contiguous and 16-byte aligned. Returns cudaGetLastError() after the
// launches.
extern "C" int tclight_qk_int8_prepass(const void* q, const void* k, void* q8, void* k8,
                                       void* sq, void* sk, void* scratch, int B, int H, int Sq,
                                       int Skv, int D, int bq, void* stream) {
  if (bad_shape(B, H, Sq, Skv, D, bq)) return (int)cudaErrorInvalidValue;
  return prepass<false>(q, k, nullptr, q8, k8, nullptr, sq, sk, nullptr, scratch, B, H, Sq, Skv,
                        D, bq, (cudaStream_t)stream);
}

// K7's pre-pass: as above, but sk (B*H, 2, ceil128(Skv)) f32, each key's
// (sk', -1.5 * 2^23 * sk') (see the head), and v8 (B*H, D, ceil128(Skv))
// int8 channel-major, each channel's keys permuted within each 16 as above,
// and sv (B*H, D) f32; scratch: B*H * (n_qs + 2 * n_ks * D + D + 1) f32.
extern "C" int tclight_int8pv_prepass(const void* q, const void* k, const void* v, void* q8,
                                      void* k8, void* v8, void* sq, void* sk, void* sv,
                                      void* scratch, int B, int H, int Sq, int Skv, int D, int bq,
                                      void* stream) {
  if (bad_shape(B, H, Sq, Skv, D, bq)) return (int)cudaErrorInvalidValue;
  return prepass<true>(q, k, v, q8, k8, v8, sq, sk, sv, scratch, B, H, Sq, Skv, D, bq,
                       (cudaStream_t)stream);
}

// K6 on the pre-pass's operands and v (B, Skv, H, D) bf16 as it lies; o (B,
// Sq, H, D) bf16. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue when the arguments or the tensor maps are
// refused).
extern "C" int tclight_flash_attention_qk_int8(const void* q8, const void* k8, const void* v,
                                               const void* sq, const void* sk, void* o, int B,
                                               int H, int Sq, int Skv, int D, int bq,
                                               float scale, void* stream) {
  if (bad_shape(B, H, Sq, Skv, D, bq)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch ((D + 15) / 16 * 16) {
    case 16: return launch_dp<16>(q8, k8, v, sq, sk, o, B, H, Sq, Skv, D, bq, scale, s);
    case 32: return launch_dp<32>(q8, k8, v, sq, sk, o, B, H, Sq, Skv, D, bq, scale, s);
    case 48: return launch_dp<48>(q8, k8, v, sq, sk, o, B, H, Sq, Skv, D, bq, scale, s);
    case 64: return launch_dp<64>(q8, k8, v, sq, sk, o, B, H, Sq, Skv, D, bq, scale, s);
    case 80: return launch_dp<80>(q8, k8, v, sq, sk, o, B, H, Sq, Skv, D, bq, scale, s);
    case 96: return launch_dp<96>(q8, k8, v, sq, sk, o, B, H, Sq, Skv, D, bq, scale, s);
    case 112: return launch_dp<112>(q8, k8, v, sq, sk, o, B, H, Sq, Skv, D, bq, scale, s);
    case 128: return launch_dp<128>(q8, k8, v, sq, sk, o, B, H, Sq, Skv, D, bq, scale, s);
    case 144: return launch_dp<144>(q8, k8, v, sq, sk, o, B, H, Sq, Skv, D, bq, scale, s);
    default: return launch_dp<160>(q8, k8, v, sq, sk, o, B, H, Sq, Skv, D, bq, scale, s);
  }
}
