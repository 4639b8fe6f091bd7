// K7: inference flash attention with int8 q.k^T and p.v products, for
// Hopper (sm_90a), in two kernels: a max pass and the attention.
//
// Replaces the TPU kernel tclight_tpu/ops/attention.py
// `_flash_kernel_int8_full` (pallas_call at :459, backend
// "pallas_int8pv"): the logits come from an int8 q.k^T with exact int32
// accumulation,
//   w = scale * log2(e) * sq[q block] * (sk[j] * <q8_i, k8_j>),
// V is int8 with one scale per channel (sv), and P is quantized per (row,
// P block of PB = min(1024, ceil128(Skv)) keys) against the block's own
// max:
//   p8 = round(127 * exp2(w - bm)),  bm = max of w over the block's keys,
// dequantized with sp / 127, sp = exp2(bm - m), m the row's max; the
// softmax sum l accumulates the exact f32 p = sp * exp2(w - bm), and out
// = (sum over blocks of sp / 127 * (p8 . v8)) * sv / max(l, 1e-30). It
// matches the plain version `flash_attention_int8_plain` (the dense
// emulation JAX runs off the TPU) up to exp2 rounding, p8 values that a
// rounding tie may move by one step and a K scale rounded to 22
// significant bits (sk', K6's).
//
// The operands come from K6's pre-pass kernels in their PV variant
// (tclight_int8pv_prepass in csrc/flash_attention_qk_int8.cu): q8 (BH,
// Sq, DR) and k8 (BH, Skv, DR) int8 row-major, DR = ceil16(D); sq (BH,
// n_qb) f32; the K scales as (BH, 2, ceil128(Skv)) f32, each key's sk'
// (its scale with the two lowest significand bits cleared) and -1.5 * 2^23
// * sk', padded keys 0; v8 (BH, D, ceil128(Skv)) int8
// channel-major, each channel's keys in the permuted order that the score
// fragment packs into (see there); sv (BH, D) f32.
//
// What bounds it on the H100: at the level-0 UNet self-attention (S ~
// 35.6k tokens, 8 heads, head dim 40) each product is 2*B*H*S^2*D ~ 0.8 T
// int8 multiply-adds (1.6 T operations, 0.8 ms at 1,979 TOPS each); the
// softmax takes B*H*S^2 ~ 2.0e10 exponentials (~5.2 ms on the special-
// function units, as K1 and K6); the max pass a conversion, a multiply
// and a max a score beside its q.k^T.
//
// Ordering, and why it agrees with the TPU kernel. The TPU kernel keeps a
// running max over 1024-key blocks, rescales acc and l by alpha, and
// quantizes p against the max of the block's p after the row max has
// moved; padded keys take part in its max as zero logits and are masked in
// p afterwards (attention.py:255-259). Here a max pass first writes every
// (row, P block) max of w, the padded keys masked to -inf before the max.
// The attention then takes the row max m from those before its first tile,
// so alpha is 1 throughout and acc and l are never rescaled. p8 is a ratio
// to its block's max (round(127 p / sp) is invariant to the scale of p), so
// the two orders give the same p8 and, after the division by l, the same
// output, up to f32 rounding of the exponentials; a zero logit of a padded
// key changes only the scale that cancels. That is the dense plain
// version's order exactly.
//
// Design. Both kernels have K6's shape and geometry (K1's, by dp =
// ceil16(D)): one block per (q tile, batch * head); warpgroup 0's thread 0
// loads the q8 tile by TMA once and keeps a ring of stages full (k8 tile,
// the tile's K scales by bulk copies, and in the attention the v8 tile)
// behind full / empty mbarriers; three consumer warpgroups of 160 registers
// up to dp 48, two of 240 above, each owning 64 q rows; 128-key tiles up to
// dp 128, 64 above (the live registers at dp 160: 32 scores, 80 int32 p.v
// sums, the 80-value accumulator and 8 of p8). A P block is a whole number
// of tiles.
// - Layout, read in place. q8 and k8 tiles are K6's boxes (64 bytes in the
//   64-byte swizzle up to the depth DK = ceil32(D) = 64, else 128 in the
//   128-byte one, zero-filled past DR); a v8 tile is one box of dp channels
//   x the tile's keys (one swizzle row a channel: 128 bytes in the 128-byte
//   swizzle, 64 in the 64-byte one), the channels past D zero-filled. All
//   three are read by K-major s8 wgmma descriptors, 32 bytes a k32 step
//   within a row. The pre-pass writes no bf16 copy and no v copy.
// - Max pass (`flash_int8_blockmax_kernel`): q.k^T on s8 wgmma, each score
//   x * sk', the running max of the P block in four chains a row; at the
//   block's last tile it writes blockmax[bh, row, kb] = max * c, c = scale
//   * log2(e) * sq (the same as the max of the products, since rounding is
//   monotone; c <= 0 takes the product first). One score buffer a
//   warpgroup: the other warpgroups' products run while one reduces. Up to
//   dp 48 (the UNet's 40) the products are short and the conversion
//   instruction's quarter rate binds the pass, so a score is made without
//   it: the int32 sum plus the bits of 1.5 * 2^23 are the float 1.5 * 2^23
//   + x exactly (|x| <= 160 * 127^2 < 2^22), and one FMA with the key's
//   pair (sk', -1.5 * 2^23 * sk') leaves x * sk' rounded once. Above, the
//   conversion instruction and a multiply (the pairs' second row unread).
// - Attention (`flash_int8pv_wgmma_kernel`): p = exp2(fma(x * sk', c,
//   -bm)) (x by the conversion instruction, which the exponentials hide;
//   in the last tile the padded keys' p set to 0), l += sp * sum(p) per
//   tile in two chains a row, p8 = the low byte of fma(127, p, 1.5 * 2^23)
//   (round half to even without a conversion instruction), four p8 packed
//   into an A register by byte permutes as the score fragment lies (the
//   pre-pass permuted v8's keys to match). p.v runs on
//   wgmma.m64nDPk32.s32.s8.s8 with A from registers and v8 K-major from the
//   ring, accumulating int32 over a P block (exact: 127 * 127 * 1024 <
//   2^24, so the f32 conversion is exact too) and dequantized into the f32
//   accumulator with sp / 127 at the block's last tile. Overlap as K6: tile
//   j's p.v and tile j + 1's q.k^T are issued together and the softmax of
//   tile j + 1 runs while that p.v is in flight; the consumer warpgroups
//   take turns, in a ring, to issue (named barriers). No wgmma is issued
//   under a condition.
// - out = acc * sv / max(l, 1e-30), written in bf16.
//
// Shared memory per block: the q8 tile (q rows * ceil(DK / R8) * R8
// bytes) and per stage a k8 tile, the attention's v8 tile (dp * keys bytes)
// and K scales (4 bytes a key), or the max pass's pairs (8 bytes a key),
// the barriers and the 1,024-byte alignment.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

using namespace tclight::hopper;

namespace {

constexpr int MAX_D = 160;
constexpr int PBLOCK = 1024;  // keys of a P-scale block, at most
constexpr uint32_t MAGIC_BITS = 0x4B400000u;  // the bits of 1.5 * 2^23
constexpr float ROUND_MAGIC = 12582912.f;     // 1.5 * 2^23: its low bits round to an integer

// The geometry, by dp = ceil16(D): K6's (K1's)
__host__ __device__ constexpr int depth8(int dp) { return (dp + 31) / 32 * 32; }  // DK
// bytes of a row of one of q8's or k8's boxes: one 64-byte swizzle row where
// the q.k^T depth fits it (the UNet's 40), else a 128-byte one
__host__ __device__ constexpr int row8(int dp) { return depth8(dp) <= 64 ? 64 : 128; }
__host__ __device__ constexpr int slabs8(int dp) { return (depth8(dp) + row8(dp) - 1) / row8(dp); }
// the attention: three consumer warpgroups of 160 registers up to dp 48
// (the UNet's 40); above, the live registers (scores, int32 p.v sums, the
// accumulator, p8) outgrow 160
__host__ __device__ constexpr int consumers(int dp) { return dp <= 48 ? 3 : 2; }
// the max pass: the attention's warpgroups, one score buffer each (with
// two, ptxas waits for the products in flight all the same, C7517; taking
// turns to issue, as the attention's warpgroups do, was slower: PERF.md,
// the int8 attentions' ablation)
__host__ __device__ constexpr int mp_consumers(int dp) { return dp <= 48 ? 3 : 2; }
// the max pass converts its scores by an integer add and one FMA with the
// key's pair up to dp 48, where its products are short and the conversion
// instruction's quarter rate binds it; above, by the conversion
// instruction and a multiply (fewer shared-memory reads)
__host__ __device__ constexpr bool mp_magic(int dp) { return dp <= 48; }
// independent chains a row of the max pass's running max, and of the
// attention's row sum: one chain's dependent FMNMX / FADD per score would
// bind the latency
constexpr int MP_CH = 4;
constexpr int PV_CH = 2;
__host__ __device__ constexpr int kv_rows(int dp) { return dp <= 128 ? 128 : 64; }
__host__ __device__ constexpr int n_stages(int dp) { return dp <= 64 ? 4 : 3; }
__host__ __device__ constexpr int consumer_regs(int nwg) {
  return ((65536 / (128 * (nwg + 1))) / 8 * 8 * (nwg + 1) - 24) / nwg / 8 * 8;
}
// bytes of one stage: the k8 tile, and the attention's v8 tile and K
// scales (sk'), or the max pass's K-scale pairs (sk', -1.5 * 2^23 * sk')
__host__ __device__ constexpr int stage_bytes(int dp, bool pv) {
  return kv_rows(dp) * (slabs8(dp) * row8(dp) + (pv ? dp + 4 : 8));
}
__host__ __device__ constexpr size_t smem_bytes(int dp, bool pv) {
  return (size_t)64 * (pv ? consumers(dp) : mp_consumers(dp)) * slabs8(dp) * row8(dp) +
         (size_t)n_stages(dp) * stage_bytes(dp, pv) + 8 * (1 + 2 * n_stages(dp)) + 1024;
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the low bytes of four words, in order
__device__ __forceinline__ uint32_t pack_low_bytes(uint32_t a, uint32_t b, uint32_t c,
                                                   uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// q k^T of the k8 tile at tK into s: 64 rows x BK keys in DK / 32 steps of
// depth 32, both operands K-major in the R8-byte swizzle: slab kk / (R8 /
// 32), 32 bytes a step within its rows; the warpgroup's 64 q rows at sQw,
// each slab of the q tile BQ * R8 bytes on
template <int BQ, int BK, int DK, int R8>
__device__ __forceinline__ void issue_qk8(uint32_t (&s)[BK / 2], const int8_t* sQw,
                                          const int8_t* tK) {
  constexpr int STEPS = R8 / 32;  // k32 steps a slab
#pragma unroll
  for (int kk = 0; kk < DK / 32; ++kk)
    WgmmaS8<BK>::run(s, wgmma_desc_rows(sQw + (kk / STEPS) * BQ * R8 + (kk % STEPS) * 32, R8),
                     wgmma_desc_rows(tK + (kk / STEPS) * BK * R8 + (kk % STEPS) * 32, R8),
                     kk > 0 ? 1 : 0);
  wgmma_commit();
}

// The max pass's reduction of one tile's scores into the running block
// maxes. This thread holds rows g (s[4n], s[4n+1]) and g + 8 (s[4n+2],
// s[4n+3]) of its warp's 16, keys 8n + 2t, +1; tS holds the tile's sk',
// then its -1.5 * 2^23 * sk'. Each score is x * sk', MAGIC by an integer add
// and one FMA (see the head of this file), else by the conversion
// instruction and a multiply. TAIL masks the keys past Skv (lim:
// Skv less the tile's first key and 2t); FOLD (c > 0) leaves the multiply
// by c to the block's end.
template <int BK, bool MAGIC, bool TAIL, bool FOLD>
__device__ __forceinline__ void reduce_tile(const uint32_t (&s)[BK / 2], float (&bmax)[2][MP_CH],
                                            const float* tS, int t, int lim, float c_row) {
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) {
    const float2 sk2 = *reinterpret_cast<const float2*>(tS + n * 8 + 2 * t);
    const float2 b2 =
        MAGIC ? *reinterpret_cast<const float2*>(tS + BK + n * 8 + 2 * t) : make_float2(0.f, 0.f);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float k = (e & 1) ? sk2.y : sk2.x, kb = (e & 1) ? b2.y : b2.x;
      float u = MAGIC ? fmaf(__uint_as_float(s[4 * n + e] + MAGIC_BITS), k, kb)
                      : (float)(int)s[4 * n + e] * k;
      if (!FOLD) u *= c_row;
      if (TAIL) u = n * 8 + (e & 1) < lim ? u : -INFINITY;
      bmax[e >> 1][n % MP_CH] = fmaxf(bmax[e >> 1][n % MP_CH], u);
    }
  }
}

// The attention's softmax of one tile's scores: p = exp2(x * sk' * c -
// bm), rsum += p, and p8 in the low byte of s. This thread holds rows g
// (s[4n], s[4n+1]) and g + 8 (s[4n+2], s[4n+3]) of its warp's 16, keys 8n
// + 2t, 8n + 2t + 1; tS holds the tile's sk'. The scores convert to f32
// by the conversion instruction (beside the exponentials it binds nothing;
// joining c to each key's scale, a multiply a key, measured slower). TAIL
// (the last tile only) sets the padded keys' p to 0, in a body of its own,
// so that the other tiles carry no per-score test.
template <int BK, bool TAIL>
__device__ __forceinline__ void softmax_tile(uint32_t (&s)[BK / 2], float (&rsum)[2][PV_CH],
                                             const float* tS, int t, int lim, float c_row,
                                             const float (&bm)[2]) {
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) {
    const float2 skv = *reinterpret_cast<const float2*>(tS + n * 8 + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float u = (float)(int)s[4 * n + e] * ((e & 1) ? skv.y : skv.x);
      float p = fast_exp2(fmaf(u, c_row, -bm[e >> 1]));
      if (TAIL) p = n * 8 + (e & 1) < lim ? p : 0.f;
      rsum[e >> 1][n % PV_CH] += p;
      s[4 * n + e] = __float_as_uint(fmaf(127.f, p, ROUND_MAGIC));
    }
  }
}

// --------------------------------------------------------------- max pass

// The max pass: each (row, P block)'s max of the logits, q.k^T on s8
// wgmma over q8 and k8 in place, each score x * sk' (`reduce_tile`) and a
// max in MP_CH chains a row. Each consumer warpgroup reduces its tile while
// the others' products run.
template <int DP>
__global__ void __launch_bounds__(128 * (1 + mp_consumers(DP)), 1)
flash_int8_blockmax_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const float* __restrict__ sq, const float* __restrict__ sk,
                           float* __restrict__ blockmax, int Sq, int Skv, int n_qb, int bq,
                           int skv_pad, int tiles_per_block, int n_kb, float scale_log2) {
  constexpr int NWG = mp_consumers(DP);
  constexpr int BQ = 64 * NWG;
  constexpr int BK = kv_rows(DP);
  constexpr int NS = n_stages(DP);
  constexpr int DK = depth8(DP);
  constexpr int R8 = row8(DP);
  constexpr int NSK = slabs8(DP);
  constexpr int KTILE = BK * NSK * R8;
  constexpr uint32_t MP_STAGE_TX = KTILE + BK * 8;
  extern __shared__ unsigned char smem_raw[];
  int8_t* sQ = reinterpret_cast<int8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  int8_t* sK = sQ + BQ * NSK * R8;
  float* sS = reinterpret_cast<float*>(sK + NS * KTILE);  // per stage BK sk', then BK pairs' b
  uint64_t* qbar = reinterpret_cast<uint64_t*>(sS + NS * 2 * BK);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + NS;

  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int n_tiles = (Skv + BK - 1) / BK;
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NWG * 4);  // one arrive per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(qbar, BQ * NSK * R8);
      for (int c = 0; c < NSK; ++c) tma_load_4d(sQ + c * BQ * R8, &tq, qbar, c * R8, q0, bh, 0);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % NS;
        if (j >= NS) mbar_wait(&empty[st], ((j / NS) - 1) & 1);
        mbar_expect_tx(&full[st], MP_STAGE_TX);
        for (int c = 0; c < NSK; ++c)
          tma_load_4d(sK + st * KTILE + c * BK * R8, &tk, &full[st], c * R8, j * BK, bh, 0);
        for (int c = 0; c < 2; ++c)
          bulk_load(sS + (st * 2 + c) * BK, sk + ((long)bh * 2 + c) * skv_pad + j * BK, BK * 4,
                    &full[st]);
      }
    }
  } else {
    setmaxnreg_inc<consumer_regs(NWG)>();
    const int cw = wg - 1;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    const float c_row = scale_log2 * sq[bh * n_qb + min((q0 + cw * 64) / bq, n_qb - 1)];
    const bool fold = c_row > 0.f;  // max(u) * c == max(u * c): rounding is monotone

    uint32_t sc[BK / 2];
    float bmax[2][MP_CH];  // the rows' running maxes of the P block, MP_CH chains each
#pragma unroll
    for (int ch = 0; ch < MP_CH; ++ch) bmax[0][ch] = bmax[1][ch] = -INFINITY;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0u;
    mbar_wait(qbar, 0);
    for (int j = 0; j < n_tiles; ++j) {
      mbar_wait(&full[j % NS], (j / NS) & 1);
      fence_regs(sc);
      wgmma_fence();
      issue_qk8<BQ, BK, DK, R8>(sc, sQ + cw * 64 * R8, sK + (j % NS) * KTILE);
      wgmma_wait<0>();
      fence_regs(sc);
      // tile j is done: reduce it, free its stage, and at a P block's last
      // tile write the block's maxes
      const float* tS = sS + (j % NS) * 2 * BK;
      const int lim = Skv - j * BK - 2 * t;  // this thread's keys 8n + 2t + e' < Skv
      constexpr bool M = mp_magic(DP);
      if ((j + 1) * BK > Skv) {
        if (fold) reduce_tile<BK, M, true, true>(sc, bmax, tS, t, lim, c_row);
        else reduce_tile<BK, M, true, false>(sc, bmax, tS, t, lim, c_row);
      } else {
        if (fold) reduce_tile<BK, M, false, true>(sc, bmax, tS, t, lim, c_row);
        else reduce_tile<BK, M, false, false>(sc, bmax, tS, t, lim, c_row);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[j % NS]);
      if ((j + 1) % tiles_per_block == 0 || j + 1 == n_tiles) {
        const int kb = j / tiles_per_block;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float m = bmax[r][0];
#pragma unroll
          for (int ch = 1; ch < MP_CH; ++ch) m = fmaxf(m, bmax[r][ch]);
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
          const int row = q0 + cw * 64 + warp * 16 + g + 8 * r;
          if (t == 0 && row < Sq) blockmax[((long)bh * Sq + row) * n_kb + kb] = fold ? m * c_row : m;
#pragma unroll
          for (int ch = 0; ch < MP_CH; ++ch) bmax[r][ch] = -INFINITY;
        }
      }
    }
  }
}

// -------------------------------------------------------------- attention

template <int DP>
__global__ void __launch_bounds__(128 * (1 + consumers(DP)), 1)
flash_int8pv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const float* __restrict__ sq, const float* __restrict__ sk,
                          const float* __restrict__ sv, const float* __restrict__ blockmax,
                          __nv_bfloat16* __restrict__ o, int H, int Sq, int Skv, int D, int n_qb,
                          int bq, int skv_pad, int tiles_per_block, int n_kb, float scale_log2) {
  constexpr int NWG = consumers(DP);
  constexpr int BQ = 64 * NWG;
  constexpr int BK = kv_rows(DP);
  constexpr int NS = n_stages(DP);
  constexpr int DK = depth8(DP);
  constexpr int NSK = slabs8(DP);
  constexpr int R8 = row8(DP);
  constexpr int KTILE = BK * NSK * R8;  // bytes of one k8 tile
  constexpr int VTILE = DP * BK;        // bytes of one v8 tile: DP channels x BK keys
  constexpr uint32_t STAGE_TX = KTILE + VTILE + BK * 4;
  extern __shared__ unsigned char smem_raw[];
  int8_t* sQ = reinterpret_cast<int8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  int8_t* sK = sQ + BQ * NSK * R8;  // NS k8 tiles
  int8_t* sV = sK + NS * KTILE;     // NS v8 tiles, [channel][key], swizzled
  float* sS = reinterpret_cast<float*>(sV + NS * VTILE);  // NS tiles of K scales (sk')
  uint64_t* qbar = reinterpret_cast<uint64_t*>(sS + NS * BK);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + NS;

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
    for (int s = 0; s < NS; ++s) {
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
        const int st = j % NS;
        if (j >= NS) mbar_wait(&empty[st], ((j / NS) - 1) & 1);
        mbar_expect_tx(&full[st], STAGE_TX);
        for (int c = 0; c < NSK; ++c)
          tma_load_4d(sK + st * KTILE + c * BK * R8, &tk, &full[st], c * R8, j * BK, bh, 0);
        tma_load_4d(sV + st * VTILE, &tv, &full[st], j * BK, 0, bh, 0);
        bulk_load(sS + st * BK, sk + (long)bh * 2 * skv_pad + j * BK, BK * 4, &full[st]);
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    setmaxnreg_inc<consumer_regs(NWG)>();
    const int cw = wg - 1;  // which 64 q rows
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    const float c_row = scale_log2 * sq[bh * n_qb + min((q0 + cw * 64) / bq, n_qb - 1)];

    // this thread's rows, and the row max m from the block maxes
    int row[2];
    float m_row[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      row[r] = q0 + cw * 64 + warp * 16 + g + 8 * r;
      float m = 0.f;  // rows past Sq: any finite value; they are not stored
      if (row[r] < Sq) {
        const float* bm = blockmax + ((long)bh * Sq + row[r]) * n_kb;
        m = bm[0];
        for (int kb = 1; kb < n_kb; ++kb) m = fmaxf(m, bm[kb]);
      }
      m_row[r] = m;
    }
    auto block_max = [&](int r, int kb) {
      return row[r] < Sq ? blockmax[((long)bh * Sq + row[r]) * n_kb + kb] : 0.f;
    };

    float acc[DP / 2];
    uint32_t pv[DP / 2];   // int32 p8 . v8 of the P block in flight
    uint32_t s[BK / 2];    // int32 sums, then p8 in the low byte of f32 bits
    uint32_t pa[BK / 32][4];  // p8 of the tile whose p.v is next or in flight
    float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums
    float bm_cur[2] = {0.f, 0.f}, sp_cur[2] = {0.f, 0.f};  // the softmax tile's block: bm, exp2(bm - m)
    float sp_pv[2];        // sp of the block of the p.v tile
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) {
      acc[i] = 0.f;
      pv[i] = 0u;
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0u;
    auto fence_all = [&]() {
      fence_regs(s);
      fence_regs(pv);
    };

    auto issue_qk = [&](int j) {
      issue_qk8<BQ, BK, DK, R8>(s, sQ + cw * 64 * R8, sK + (j % NS) * KTILE);
    };
    // pv (+)= p8 v8 of tile j; v8 K-major: 32 keys a step, 32 bytes within
    // a channel's row of BK bytes (the BK-byte swizzle), the next 8
    // channels 8 * BK bytes on; the first tile of a P block overwrites
    auto issue_pv = [&](int j) {
      const int8_t* tV = sV + (j % NS) * VTILE;
      const int keep = j % tiles_per_block != 0;
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk) {
        const uint64_t dv = BK == 128 ? wgmma_desc_sw128(tV + kk * 32, 16, 8 * BK)
                                      : wgmma_desc_sw64(tV + kk * 32, 16, 8 * BK);
        WgmmaS8RS<DP>::run(pv, pa[kk], dv, kk > 0 ? 1 : keep);
      }
      wgmma_commit();
    };
    // the softmax of tile j (`softmax_tile`), its P block's bm and sp taken
    // at the block's first tile, l += sp * sum(p)
    auto softmax = [&](int j) {
      if (j % tiles_per_block == 0) {
        const int kb = j / tiles_per_block;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          bm_cur[r] = block_max(r, kb);
          sp_cur[r] = fast_exp2(bm_cur[r] - m_row[r]);
        }
      }
      const float* tS = sS + (j % NS) * BK;
      const int lim = Skv - j * BK - 2 * t;  // this thread's keys 8n + 2t + e' < Skv
      float rsum[2][PV_CH] = {};
      if ((j + 1) * BK > Skv) softmax_tile<BK, true>(s, rsum, tS, t, lim, c_row, bm_cur);
      else softmax_tile<BK, false>(s, rsum, tS, t, lim, c_row, bm_cur);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float sum = rsum[r][0];
#pragma unroll
        for (int ch = 1; ch < PV_CH; ++ch) sum += rsum[r][ch];
        l_run[r] = fmaf(sp_cur[r], sum, l_run[r]);
      }
    };
    // p8 as s8 A fragments: keys 32kk..32kk+31 are the 8-key blocks 4kk..
    // 4kk + 3; register x of a depth step holds row g (x even) or g + 8
    // (x odd), keys {2t, 2t+1} of blocks 4kk + 2 (x / 2), 4kk + 2 (x / 2) + 1
    auto pack_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int n0 = 4 * kk + 2 * (x >> 1), e0 = 2 * (x & 1);
          pa[kk][x] = pack_low_bytes(s[4 * n0 + e0], s[4 * n0 + e0 + 1], s[4 * (n0 + 1) + e0],
                                     s[4 * (n0 + 1) + e0 + 1]);
        }
    };
    // the P block of tile j ends: its int32 sums into acc with sp / 127
    // (exact conversions: |p8 . v8| <= 127^2 * 1024 < 2^24)
    auto dequant = [&](int j) {
      if ((j + 1) % tiles_per_block == 0 || j + 1 == n_tiles) {
        const float deq[2] = {sp_pv[0] / 127.f, sp_pv[1] / 127.f};
#pragma unroll
        for (int i = 0; i < DP / 2; ++i)
          acc[i] = fmaf((float)(int)pv[i], deq[(i >> 1) & 1], acc[i]);
      }
    };

    // the consumer warpgroups take turns, in a ring, to issue their
    // products, as in K1 and K6 (named barriers 1 + c)
    const int my_turn = 1 + cw, next_turn = NWG == 2 ? 2 - cw : 1 + (cw + 1) % NWG;
    if (cw == NWG - 1) named_arrive(next_turn, 256);
    auto take_turn = [&]() { named_sync(my_turn, 256); };
    auto pass_turn = [&](bool last) {
      if (cw != NWG - 1 || !last) named_arrive(next_turn, 256);
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
    softmax(0);
    pack_p();
    for (int j = 0; j + 1 < n_tiles; ++j) {
      sp_pv[0] = sp_cur[0], sp_pv[1] = sp_cur[1];
      mbar_wait(&full[(j + 1) % NS], ((j + 1) / NS) & 1);
      take_turn();
      fence_all();
      wgmma_fence();
      issue_qk(j + 1);
      issue_pv(j);
      pass_turn(false);
      wgmma_wait<1>();  // q.k^T of tile j + 1 (the older group) is done
      fence_all();
      softmax(j + 1);
      wgmma_wait<0>();  // p.v of tile j is done: pv and pa are free
      fence_all();
      dequant(j);
      pack_p();
      // this warp is done with stage j: one arrive for its 32 threads
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[j % NS]);
    }
    sp_pv[0] = sp_cur[0], sp_pv[1] = sp_cur[1];
    take_turn();
    fence_all();
    wgmma_fence();
    issue_pv(n_tiles - 1);
    pass_turn(true);
    wgmma_wait<0>();
    fence_all();
    dequant(n_tiles - 1);

    const long row_stride = (long)H * D;
    __nv_bfloat16* ob = o + ((long)b * Sq * H + h) * D;
    const float* svb = sv + (long)bh * D;
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      inv[r] = 1.f / fmaxf(l, 1e-30f);
    }
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int col = n * 8 + 2 * t;
      if (col >= D) continue;  // d % 8 == 0: an 8-column block is wholly in or out
      const float2 cs = *reinterpret_cast<const float2*>(svb + col);
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (row[r] < Sq)
          *reinterpret_cast<__nv_bfloat162*>(ob + (long)row[r] * row_stride + col) =
              __floats2bfloat162_rn(acc[4 * n + 2 * r] * cs.x * inv[r],
                                    acc[4 * n + 2 * r + 1] * cs.y * inv[r]);
    }
  }
}

// ------------------------------------------------------------------- host

template <class K>
int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)bytes);
}

int p_block(int Skv) { return min(PBLOCK, (Skv + 127) / 128 * 128); }

template <int DP>
int launch_blockmax(const void* q8, const void* k8, const void* sq, const void* sk,
                    void* blockmax, int B, int H, int Sq, int Skv, int bq, float scale,
                    cudaStream_t stream) {
  const size_t bytes = smem_bytes(DP, false);
  static bool attr_set = false;  // once per kernel instance, not per launch
  if (!attr_set) {
    const int err = set_smem(flash_int8_blockmax_kernel<DP>, bytes);
    if (err) return err;
    attr_set = true;
  }
  const int bq_rows = 64 * mp_consumers(DP);
  CUtensorMap tq, tk;
  if (!(tensor_map_rows_sw(&tq, q8, B * H, Sq, DP, row8(DP), bq_rows) &&
        tensor_map_rows_sw(&tk, k8, B * H, Skv, DP, row8(DP), kv_rows(DP))))
    return (int)cudaErrorInvalidValue;
  const int pb = p_block(Skv);
  const dim3 grid((Sq + bq_rows - 1) / bq_rows, B * H);
  flash_int8_blockmax_kernel<DP><<<grid, 128 * (1 + mp_consumers(DP)), bytes, stream>>>(
      tq, tk, (const float*)sq, (const float*)sk, (float*)blockmax, Sq, Skv, (Sq + bq - 1) / bq,
      bq, (Skv + 127) / 128 * 128, pb / kv_rows(DP), (Skv + pb - 1) / pb,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

template <int DP>
int launch(const void* q8, const void* k8, const void* v8, const void* sq, const void* sk,
           const void* sv, const void* blockmax, void* o, int B, int H, int Sq, int Skv, int D,
           int bq, float scale, cudaStream_t stream) {
  const size_t bytes = smem_bytes(DP, true);
  static bool attr_set = false;
  if (!attr_set) {
    const int err = set_smem(flash_int8pv_wgmma_kernel<DP>, bytes);
    if (err) return err;
    attr_set = true;
  }
  const int bk = kv_rows(DP), skv_pad = (Skv + 127) / 128 * 128, bq_rows = 64 * consumers(DP);
  // q8, k8 (BH, S, DP) row-major in boxes of row8 bytes; v8 (BH, D channels,
  // skv_pad keys), a tile one box of bk keys (bytes) x DP channels in the
  // bk-byte swizzle
  CUtensorMap tq, tk, tv;
  if (!(tensor_map_rows_sw(&tq, q8, B * H, Sq, DP, row8(DP), bq_rows) &&
        tensor_map_rows_sw(&tk, k8, B * H, Skv, DP, row8(DP), bk) &&
        tensor_map_rows_sw(&tv, v8, B * H, D, skv_pad, bk, DP)))
    return (int)cudaErrorInvalidValue;
  const int pb = p_block(Skv);
  const dim3 grid((Sq + bq_rows - 1) / bq_rows, B * H);
  flash_int8pv_wgmma_kernel<DP><<<grid, 128 * (1 + consumers(DP)), bytes, stream>>>(
      tq, tk, tv, (const float*)sq, (const float*)sk, (const float*)sv, (const float*)blockmax,
      (__nv_bfloat16*)o, H, Sq, Skv, D, (Sq + bq - 1) / bq, bq, skv_pad, pb / bk,
      (Skv + pb - 1) / pb, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int H, int Sq, int Skv, int D, int bq) {
  return B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0 || D <= 0 || D % 8 != 0 || D > MAX_D ||
         (long)B * H > 65535 || bq <= 0 || bq % 128 != 0 ||
         (Sq > bq && bq != 1024);  // a warpgroup's 64 rows lie in one Q-scale block
}

}  // namespace

#define TCLIGHT_INT8PV_CASES(CALL) \
  CALL(16) CALL(32) CALL(48) CALL(64) CALL(80) CALL(96) CALL(112) CALL(128) CALL(144) CALL(160)

// The max pass. q8, k8, sq, sk as the PV pre-pass writes them; blockmax
// (B*H, Sq, n_kb) f32, n_kb = ceil(Skv / PB), PB = min(1024,
// ceil128(Skv)): each (row, P block)'s max of w (log2 units), the keys
// past Skv left out. D % 8 == 0, D <= 160; bq = min(1024, ceil128(Sq)).
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue when
// the arguments or the tensor maps are refused).
extern "C" int tclight_int8pv_blockmax(const void* q8, const void* k8, const void* sq,
                                       const void* sk, void* blockmax, int B, int H, int Sq,
                                       int Skv, int D, int bq, float scale, void* stream) {
  if (bad_shape(B, H, Sq, Skv, D, bq)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define TCLIGHT_CASE(DP_)                                                                  \
  if ((D + 15) / 16 * 16 == DP_)                                                           \
    return launch_blockmax<DP_>(q8, k8, sq, sk, blockmax, B, H, Sq, Skv, bq, scale, s);
  TCLIGHT_INT8PV_CASES(TCLIGHT_CASE)
#undef TCLIGHT_CASE
  return (int)cudaErrorInvalidValue;
}

// K7 on the pre-pass's operands and the max pass's block maxes; o (B, Sq,
// H, D) bf16. Returns cudaGetLastError() after the launch.
extern "C" int tclight_flash_attention_int8pv(const void* q8, const void* k8, const void* v8,
                                              const void* sq, const void* sk, const void* sv,
                                              const void* blockmax, void* o, int B, int H,
                                              int Sq, int Skv, int D, int bq, float scale,
                                              void* stream) {
  if (bad_shape(B, H, Sq, Skv, D, bq)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define TCLIGHT_CASE(DP_)                                                                    \
  if ((D + 15) / 16 * 16 == DP_)                                                             \
    return launch<DP_>(q8, k8, v8, sq, sk, sv, blockmax, o, B, H, Sq, Skv, D, bq, scale, s);
  TCLIGHT_INT8PV_CASES(TCLIGHT_CASE)
#undef TCLIGHT_CASE
  return (int)cudaErrorInvalidValue;
}
