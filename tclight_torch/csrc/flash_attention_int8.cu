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
// emulation JAX runs off the TPU) up to exp2 rounding and p8 values that a
// rounding tie may move by one step.
//
// The operands come from K6's pre-pass kernels in their PV variant
// (tclight_int8pv_prepass in csrc/flash_attention_qk_int8.cu): q8 (BH, DK
// / 16, Sq, 16) and k8 (BH, DK / 16, Skv, 16) int8 chunk-major, DK =
// ceil32(D); sq (BH, n_qb), sk (BH, ceil128(Skv)) f32 (padded keys 0); v8
// (BH, ceil16(Skv) / 16, D, 16) int8, each 16 bytes the 16 keys of one
// channel in the permuted order that the score fragment packs into (see
// there); sv (BH, D) f32.
// At D = 128: q8 (BH, Sq, 128), k8 (BH, Skv, 128) row-major, v8 (BH, 128,
// ceil128(Skv)) channel-major in the same key order (see below).
//
// What bounds it on the H100: at the level-0 UNet self-attention (S ~
// 35.6k tokens, 8 heads, head dim 40) each product is 2*B*H*S^2*D ~ 0.8 T
// int8 multiply-adds (1.6 T operations, 0.8 ms at 1,979 TOPS each); the
// softmax takes B*H*S^2 ~ 2.0e10 exponentials (~5.2 ms on the special-
// function units, as K1 and K6), and the max pass a conversion, two
// multiplies and a max per score more.
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
// Design. Both kernels have K6's shape (csrc/flash_attention_qk_int8.cu,
// after K1): one block of three warpgroups per (q tile, batch * head);
// warpgroup 0's thread 0 loads the q8 tile by TMA once and keeps a ring of
// stages full (k8 tile, the tile's K scales by a bulk copy, and in the
// attention the v8 tile) behind full / empty mbarriers; two consumer
// warpgroups own MB blocks of 64 q rows each and run q.k^T on
// wgmma.m64nBKk32.s32.s8.s8.
// - Tiles: MB = 2 (256 q rows, 64-key tiles) up to DP = ceil16(D) = 48;
//   MB = 1 above, with 128-key tiles up to DP = 96 and 64-key tiles above,
//   so that the live registers (scores, the int32 p.v sums, the f32
//   accumulator) fit 240 a thread. A P block is a whole number of tiles.
// - Max pass (`flash_int8_blockmax_kernel`): q.k^T on bf16 wgmma over q8's
//   and k8's values in bf16 (exact; the pre-pass writes them) with f32
//   sums, which are the exact dots (|q8 . k8| < 2^22) with no conversion
//   instruction, times the key's scale, the running max of the P block; at the block's
//   last tile it writes blockmax[bh, row, kb] = max * c, c = scale * log2(e)
//   * sq (the same as the max of the products, since rounding is monotone;
//   c <= 0 takes the product first). Each consumer warpgroup keeps two
//   score buffers: tile j + 1's q.k^T runs on the tensor cores while it
//   reduces tile j (one at D = 128, where it measured faster).
// - Attention (`flash_int8pv_wgmma_kernel`): p = exp2(fma(s * sk, c, -bm))
//   (the padded keys' p set to 0), l += sp * sum(p) per tile, p8 = the low
//   byte of fma(127, p, 1.5 * 2^23) (round half to even without a
//   conversion instruction), four p8 packed into an A register by byte
//   permutes as the score fragment lies (the pre-pass permuted v8's keys to
//   match). p.v runs on wgmma.m64nDPk32.s32.s8.s8 with A from registers and
//   v8 K-major from the ring, accumulating int32 over a P block (exact:
//   127 * 127 * 1024 < 2^24, so the f32 conversion is exact too) and
//   dequantized into the f32 accumulator with sp / 127 at the block's last
//   tile. Overlap as K6: tile j's p.v and tile j + 1's q.k^T are issued
//   together and the softmax of tile j + 1 runs while that p.v is in
//   flight; the two consumer warpgroups take turns to issue (named-barrier
//   ping-pong). No wgmma is issued under a condition.
// - out = acc * sv / max(l, 1e-30), written in bf16.
// - Head dim 128 (the Cosmos DiTs' attn_backend "int8pv") has a layout of
//   its own (SW = true), as K1's and K6's: the 16-byte-wide boxes of the
//   chunk-major tiles held the kernels back (PERF.md, the head-dim-128
//   ablation). q8 and k8 are K6's row-major (BH, S, 128), v8 is
//   channel-major (BH, 128, ceil128(Skv)); each q8 or k8 tile is one box
//   of 128-byte rows, each v8 tile one box of 128 channels x 128 keys (a
//   channel's keys are one 128-byte row), all in the 128-byte swizzle that
//   the s8 wgmma reads through K-major descriptors (32 bytes a k32 step).
//   v8's keys keep their order within each 16, so p8 still goes to wgmma
//   as it lies in the A fragment. 128 q rows (one 64-row block per
//   consumer warpgroup), 128-key tiles (the live registers: 64 scores, 64
//   int32 p.v sums, the 64-value accumulator and 16 of p8 a thread, under
//   the consumers' 240), 3 stages. The max pass runs its q.k^T on s8
//   wgmma over the same in-place q8 / k8 tiles, exact as the bf16 product
//   (|q8 . k8| <= 128 * 127^2 < 2^24), for one conversion a score, and the
//   pre-pass writes no bf16 copies. Every other head dim keeps its layout.
//
// Shared memory per block: the attention BQ * DK + NST * BK * (DK + DP + 4)
// bytes (46,080 at D = 40, 104,448 at D = 80, 103,424 at D = 160; 116,224
// at D = 128, 3 stages), the max pass BQ * 2 DP + NST * BK * (2 DP + 4)
// (50,176 at D = 40; at D = 128 on q8 / k8 BQ * 128 + 3 * BK * 132,
// 67,072), the barriers, and at D = 128 the 1,024-byte alignment.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

using namespace tclight::hopper;

namespace {

constexpr int NTHREADS = 384;
constexpr int MAX_D = 160;
constexpr int NST = 4;           // ring stages
constexpr int PBLOCK = 1024;     // keys of a P-scale block, at most

__host__ __device__ constexpr int row_blocks(int dp) { return dp <= 48 ? 2 : 1; }
__host__ __device__ constexpr int q_rows(int dp) { return 128 * row_blocks(dp); }
__host__ __device__ constexpr int kv_rows(int dp) {
  return row_blocks(dp) == 2 ? 64 : (dp <= 96 ? 128 : 64);
}

__host__ __device__ constexpr size_t smem_bytes(int dk, int dp) {
  return (size_t)q_rows(dp) * dk + (size_t)NST * kv_rows(dp) * (dk + dp + 4) +
         8 * (1 + 2 * NST) + 128;
}

// the max pass: bf16 q and k tiles of depth dp
__host__ __device__ constexpr size_t smem_bytes_maxpass(int dp) {
  return (size_t)q_rows(dp) * dp * 2 + (size_t)NST * kv_rows(dp) * (dp * 2 + 4) +
         8 * (1 + 2 * NST) + 128;
}

// D = 128 reads its operands in place in the 128-byte swizzle: q8 and k8
// (one int8 row is one swizzle row), v8 channel-major (a channel's 128
// keys of a tile are one swizzle row); 128 q rows (one 64-row block per
// consumer warpgroup), SW_BK-key tiles, SW_NST stages (the max pass ran
// faster on 3 than on 4, the attention as fast), tiles aligned to 1,024
// bytes. The max pass runs its q.k^T on s8 wgmma over q8 and k8 (on bf16
// copies in the same swizzle it was slower, PERF.md).
constexpr int SW_D = 128;
constexpr int SW_BQ = 128;
constexpr int SW_BK = 128;
constexpr int SW_NST = 3;
constexpr size_t SW_SMEM = (size_t)SW_BQ * SW_D + (size_t)SW_NST * SW_BK * (2 * SW_D + 4) +
                           8 * (1 + 2 * SW_NST) + 1024;
constexpr size_t SW_SMEM_MAXPASS = (size_t)SW_BQ * SW_D + (size_t)SW_NST * SW_BK * (SW_D + 4) +
                                   8 * (1 + 2 * SW_NST) + 1024;

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// exact: |x| < 2^24 (see the head of this file)
__device__ __forceinline__ float s32_to_f32(uint32_t x) { return (float)(int)x; }

constexpr float ROUND_MAGIC = 12582912.f;  // 1.5 * 2^23: its low bits round to an integer

// a max-pass score as f32: the bf16 product's f32 sum, or the s8 one's int32
__device__ __forceinline__ float score_f32(float x) { return x; }
__device__ __forceinline__ float score_f32(uint32_t x) { return s32_to_f32(x); }

// the low bytes of four words, in order
__device__ __forceinline__ uint32_t pack_low_bytes(uint32_t a, uint32_t b, uint32_t c,
                                                   uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// --------------------------------------------------------------- max pass

// a tile's scores into the running block maxes. This thread holds rows g
// (s[4n], s[4n+1]) and g + 8 (s[4n+2], s[4n+3]) of its warp's 16 of each
// row block, keys 8n + 2t, +1. TAIL masks the keys past Skv (lim: Skv less
// the tile's first key and 2t); FOLD (c > 0) leaves the multiply by c to
// the block's end.
template <int MB, int BK, bool TAIL, bool FOLD, class T>
__device__ __forceinline__ void reduce_tile(const T (&s)[MB][BK / 2], float (&bmax)[MB][2],
                                            const float* tS, int t, int lim, float c_row) {
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) {
    const float2 skv = *reinterpret_cast<const float2*>(tS + n * 8 + 2 * t);
#pragma unroll
    for (int mb = 0; mb < MB; ++mb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float u = score_f32(s[mb][4 * n + e]) * ((e & 1) ? skv.y : skv.x);
        if constexpr (!FOLD) u *= c_row;
        if constexpr (TAIL) u = n * 8 + (e & 1) < lim ? u : -INFINITY;
        bmax[mb][e >> 1] = fmaxf(bmax[mb][e >> 1], u);
      }
  }
}

// The max pass, on q8's and k8's values in bf16 (exact): the bf16 product
// with f32 sums gives the exact dot already as f32 (|dot| < 2^22), so a
// score costs a multiply and a max. SW (D = 128): on q8 and k8 in place
// by s8 wgmma (the int32 dot converts to f32 exactly, |dot| <= 128 *
// 127^2 < 2^24), half the operand bytes and tensor-core time of the bf16
// product for one conversion a score.
template <int DP, bool SW>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_int8_blockmax_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const float* __restrict__ sq, const float* __restrict__ sk,
                           float* __restrict__ blockmax, int Sq, int Skv, int n_qb, int bq,
                           int skv_pad, int tiles_per_block, int n_kb, float scale_log2) {
  static_assert(!SW || DP == SW_D, "the swizzled path is D = 128's");
  constexpr int MB = SW ? 1 : row_blocks(DP);
  constexpr int BQ = SW ? SW_BQ : q_rows(DP);
  constexpr int BK = SW ? SW_BK : kv_rows(DP);
  constexpr int NS = SW ? SW_NST : NST;  // ring stages
  constexpr int ROW = SW ? SW_D : DP * 2;  // bytes of a q or k row: int8, or bf16
  constexpr uintptr_t ALIGN = SW ? 1024 : 128;
  using Score = typename std::conditional<SW, uint32_t, float>::type;  // s32 or f32 sums
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + ALIGN - 1) & ~(ALIGN - 1));
  unsigned char* sK = sQ + BQ * ROW;
  float* sS = reinterpret_cast<float*>(sK + NS * BK * ROW);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(sS + NS * BK);
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
      mbar_init(&empty[s], 2 * 4);  // one arrive per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(qbar, BQ * ROW);
      if constexpr (SW) tma_load_4d(sQ, &tq, qbar, 0, q0, bh, 0);
      else tma_load_4d(sQ, &tq, qbar, 0, q0, 0, bh);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % NS;
        if (j >= NS) mbar_wait(&empty[st], ((j / NS) - 1) & 1);
        mbar_expect_tx(&full[st], BK * ROW + BK * 4);
        if constexpr (SW) tma_load_4d(sK + st * BK * ROW, &tk, &full[st], 0, j * BK, bh, 0);
        else tma_load_4d(sK + st * BK * ROW, &tk, &full[st], 0, j * BK, 0, bh);
        bulk_load(sS + st * BK, sk + (long)bh * skv_pad + j * BK, BK * 4, &full[st]);
      }
    }
  } else {
    setmaxnreg_inc<240>();
    const int cw = wg - 1;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    const float c_row = scale_log2 * sq[bh * n_qb + q0 / bq];
    const bool fold = c_row > 0.f;  // max(u) * c == max(u * c): rounding is monotone

    // two score buffers: tile j + 1's q.k^T runs on the tensor cores while
    // this warpgroup reduces tile j (SW: one, see below)
    Score sa[MB][BK / 2], sb[MB][BK / 2];
    float bmax[MB][2];
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sa[mb][i] = sb[mb][i] = 0;
      bmax[mb][0] = bmax[mb][1] = -INFINITY;
    }
    // q k^T of tile j into sc: per row block, 64 rows x BK keys in DP / 16
    // steps of depth 16 (two 16-byte chunks), both operands K-major. SW: s8,
    // 32 bytes a k32 step within the 128-byte rows, this warpgroup's 64 rows
    // 8 KB into the tile
    auto issue = [&](Score (&sc)[MB][BK / 2], int j) {
      mbar_wait(&full[j % NS], (j / NS) & 1);
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) fence_regs(sc[mb]);
      wgmma_fence();
      const unsigned char* tK = sK + (j % NS) * BK * ROW;
#pragma unroll
      for (int kk = 0; kk < ROW / 32; ++kk)
#pragma unroll
        for (int mb = 0; mb < MB; ++mb) {
          if constexpr (SW)
            WgmmaS8<BK>::run(sc[mb], wgmma_desc_sw128(sQ + (cw * MB + mb) * 64 * ROW + kk * 32, 16,
                                                      1024),
                             wgmma_desc_sw128(tK + kk * 32, 16, 1024), kk > 0 ? 1 : 0);
          else
            WgmmaSS<BK>::run(sc[mb],
                             wgmma_desc(sQ + (cw * MB + mb) * 64 * 16 + kk * 2 * BQ * 16, BQ * 16,
                                        128),
                             wgmma_desc(tK + kk * 2 * BK * 16, BK * 16, 128), kk > 0 ? 1 : 0);
        }
      wgmma_commit();
    };
    auto finish = [&](Score (&sc)[MB][BK / 2], int j) {
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) fence_regs(sc[mb]);
      const float* tS = sS + (j % NS) * BK;
      const int lim = Skv - j * BK - 2 * t;  // this thread's keys 8n + 2t + e' < Skv
      if ((j + 1) * BK > Skv) {
        if (fold) reduce_tile<MB, BK, true, true>(sc, bmax, tS, t, lim, c_row);
        else reduce_tile<MB, BK, true, false>(sc, bmax, tS, t, lim, c_row);
      } else {
        if (fold) reduce_tile<MB, BK, false, true>(sc, bmax, tS, t, lim, c_row);
        else reduce_tile<MB, BK, false, false>(sc, bmax, tS, t, lim, c_row);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[j % NS]);
      if ((j + 1) % tiles_per_block == 0 || j + 1 == n_tiles) {
        const int kb = j / tiles_per_block;
#pragma unroll
        for (int mb = 0; mb < MB; ++mb)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float m = bmax[mb][r];
            m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
            m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
            const int row = q0 + (cw * MB + mb) * 64 + warp * 16 + g + 8 * r;
            if (t == 0 && row < Sq)
              blockmax[((long)bh * Sq + row) * n_kb + kb] = fold ? m * c_row : m;
            bmax[mb][r] = -INFINITY;
          }
      }
    };
    mbar_wait(qbar, 0);
    if constexpr (SW) {
      // one score buffer: with two, ptxas waited for the tile in flight
      // anyway (C7517) and the pass ran 3-4% slower (PERF.md)
      for (int j = 0; j < n_tiles; ++j) {
        issue(sa, j);
        wgmma_wait<0>();
        finish(sa, j);
      }
    } else {
      issue(sa, 0);
      int j = 0;
      for (; j + 2 < n_tiles; j += 2) {  // tile j is in flight in sa
        issue(sb, j + 1);
        wgmma_wait<1>();
        finish(sa, j);
        issue(sa, j + 2);
        wgmma_wait<1>();
        finish(sb, j + 1);
      }
      if (j + 1 < n_tiles) {  // two tiles left
        issue(sb, j + 1);
        wgmma_wait<1>();
        finish(sa, j);
        wgmma_wait<0>();
        finish(sb, j + 1);
      } else {
        wgmma_wait<0>();
        finish(sa, j);
      }
    }
  }
}

// -------------------------------------------------------------- attention

template <int DK, int DP, bool SW>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_int8pv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const float* __restrict__ sq, const float* __restrict__ sk,
                          const float* __restrict__ sv, const float* __restrict__ blockmax,
                          __nv_bfloat16* __restrict__ o, int H, int Sq, int Skv, int D, int n_qb,
                          int bq, int skv_pad, int tiles_per_block, int n_kb, float scale_log2) {
  static_assert(!SW || (DK == SW_D && DP == SW_D), "the swizzled path is D = 128's");
  constexpr int MB = SW ? 1 : row_blocks(DP);
  constexpr int BQ = SW ? SW_BQ : q_rows(DP);
  constexpr int BK = SW ? SW_BK : kv_rows(DP);
  constexpr int NS = SW ? SW_NST : NST;  // ring stages
  constexpr uintptr_t ALIGN = SW ? 1024 : 128;
  extern __shared__ unsigned char smem_raw[];
  int8_t* sQ = reinterpret_cast<int8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + ALIGN - 1) & ~(ALIGN - 1));
  int8_t* sK = sQ + BQ * DK;                  // NS k8 tiles
  // NS v8 tiles, [16-key chunk][channel][16]; SW [channel][key], swizzled
  int8_t* sV = sK + NS * BK * DK;
  float* sS = reinterpret_cast<float*>(sV + NS * BK * DP);  // NS tiles of K scales
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
        const int st = j % NS;
        if (j >= NS) mbar_wait(&empty[st], ((j / NS) - 1) & 1);
        mbar_expect_tx(&full[st], BK * DK + BK * DP + BK * 4);
        if constexpr (SW) {
          tma_load_4d(sK + st * BK * DK, &tk, &full[st], 0, j * BK, bh, 0);
          tma_load_4d(sV + st * BK * DP, &tv, &full[st], j * BK, 0, bh, 0);
        } else {
          tma_load_4d(sK + st * BK * DK, &tk, &full[st], 0, j * BK, 0, bh);
          tma_load_4d(sV + st * BK * DP, &tv, &full[st], 0, 0, j * (BK / 16), bh);
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
    const float c_row = scale_log2 * sq[bh * n_qb + q0 / bq];

    // this thread's rows, their block maxes' base, and the row max m
    int row[MB][2];
    float m_row[MB][2];
#pragma unroll
    for (int mb = 0; mb < MB; ++mb)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        row[mb][r] = q0 + (cw * MB + mb) * 64 + warp * 16 + g + 8 * r;
        float m = 0.f;  // rows past Sq: any finite value; they are not stored
        if (row[mb][r] < Sq) {
          const float* bm = blockmax + ((long)bh * Sq + row[mb][r]) * n_kb;
          m = bm[0];
          for (int kb = 1; kb < n_kb; ++kb) m = fmaxf(m, bm[kb]);
        }
        m_row[mb][r] = m;
      }
    auto block_max = [&](int mb, int r, int kb) {
      return row[mb][r] < Sq ? blockmax[((long)bh * Sq + row[mb][r]) * n_kb + kb] : 0.f;
    };

    float acc[MB][DP / 2];
    uint32_t pv[MB][DP / 2];   // int32 p8 . v8 of the P block in flight
    uint32_t s[MB][BK / 2];    // int32 sums, then p8 in the low byte of f32 bits
    uint32_t pa[MB][BK / 32][4];  // p8 of the tile whose p.v is next or in flight
    float l_run[MB][2];        // this thread's share of the row sums
    float bm_cur[MB][2], sp_cur[MB][2];  // the softmax tile's block: bm, exp2(bm - m)
    float sp_pv[MB][2];        // sp of the block of the p.v tile
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) {
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) {
        acc[mb][i] = 0.f;
        pv[mb][i] = 0u;
      }
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[mb][i] = 0u;
      l_run[mb][0] = l_run[mb][1] = 0.f;
      bm_cur[mb][0] = bm_cur[mb][1] = sp_cur[mb][0] = sp_cur[mb][1] = 0.f;
    }
    auto fence_all = [&]() {
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) {
        fence_regs(s[mb]);
        fence_regs(pv[mb]);
      }
    };

    // q8 k8^T as K6's (swizzled: 32 bytes a k32 step within the 128-byte
    // rows, this warpgroup's 64 q rows 8 KB into the tile)
    auto issue_qk = [&](int j) {
      const int8_t* tK = sK + (j % NS) * BK * DK;
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
    // pv (+)= p8 v8 of tile j; v8 K-major: the next 16 keys DP * 16 bytes
    // on, the next 8 channels 128 (swizzled: 32 keys a step, 32 bytes
    // within a channel's 128-byte row, the next 8 channels 1,024 bytes on);
    // the first tile of a P block overwrites
    auto issue_pv = [&](int j) {
      const int8_t* tV = sV + (j % NS) * BK * DP;
      const int keep = j % tiles_per_block != 0;
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk)
#pragma unroll
        for (int mb = 0; mb < MB; ++mb) {
          if constexpr (SW)
            WgmmaS8RS<DP>::run(pv[mb], pa[mb][kk], wgmma_desc_sw128(tV + kk * 32, 16, 1024),
                               kk > 0 ? 1 : keep);
          else
            WgmmaS8RS<DP>::run(pv[mb], pa[mb][kk],
                               wgmma_desc(tV + kk * 2 * DP * 16, DP * 16, 128), kk > 0 ? 1 : keep);
        }
      wgmma_commit();
    };
    // the softmax of tile j: p = exp2(w - bm), l += sp * sum(p), and p8 in
    // the low byte of s. This thread holds rows g (s[4n], s[4n+1]) and g +
    // 8 (s[4n+2], s[4n+3]) of its warp's 16 of each row block, keys 8n +
    // 2t, 8n + 2t + 1.
    auto softmax = [&](int j) {
      if (j % tiles_per_block == 0) {
        const int kb = j / tiles_per_block;
#pragma unroll
        for (int mb = 0; mb < MB; ++mb)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            bm_cur[mb][r] = block_max(mb, r, kb);
            sp_cur[mb][r] = fast_exp2(bm_cur[mb][r] - m_row[mb][r]);
          }
      }
      const int kv0 = j * BK;
      const float* tS = sS + (j % NS) * BK;
      const bool tail = kv0 + BK > Skv;
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) {
        float rsum[2] = {0.f, 0.f};
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) {
          const float2 skv = *reinterpret_cast<const float2*>(tS + n * 8 + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float u = s32_to_f32(s[mb][4 * n + e]) * ((e & 1) ? skv.y : skv.x);
            float p = fast_exp2(fmaf(u, c_row, -bm_cur[mb][e >> 1]));
            if (tail && kv0 + n * 8 + 2 * t + (e & 1) >= Skv) p = 0.f;
            rsum[e >> 1] += p;
            s[mb][4 * n + e] = __float_as_uint(fmaf(127.f, p, ROUND_MAGIC));
          }
        }
        l_run[mb][0] = fmaf(sp_cur[mb][0], rsum[0], l_run[mb][0]);
        l_run[mb][1] = fmaf(sp_cur[mb][1], rsum[1], l_run[mb][1]);
      }
    };
    // p8 as s8 A fragments: keys 32kk..32kk+31 are the 8-key blocks 4kk..
    // 4kk + 3; register x of a depth step holds row g (x even) or g + 8
    // (x odd), keys {2t, 2t+1} of blocks 4kk + 2 (x / 2), 4kk + 2 (x / 2) + 1
    auto pack_p = [&]() {
#pragma unroll
      for (int mb = 0; mb < MB; ++mb)
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk)
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int n0 = 4 * kk + 2 * (x >> 1), e0 = 2 * (x & 1);
            pa[mb][kk][x] = pack_low_bytes(s[mb][4 * n0 + e0], s[mb][4 * n0 + e0 + 1],
                                           s[mb][4 * (n0 + 1) + e0], s[mb][4 * (n0 + 1) + e0 + 1]);
          }
    };
    // the P block of tile j ends: its int32 sums into acc with sp / 127
    auto dequant = [&](int j) {
      if ((j + 1) % tiles_per_block == 0 || j + 1 == n_tiles) {
#pragma unroll
        for (int mb = 0; mb < MB; ++mb) {
          const float deq[2] = {sp_pv[mb][0] / 127.f, sp_pv[mb][1] / 127.f};
#pragma unroll
          for (int i = 0; i < DP / 2; ++i)
            acc[mb][i] = fmaf(s32_to_f32(pv[mb][i]), deq[(i >> 1) & 1], acc[mb][i]);
        }
      }
    };

    // the two consumer warpgroups take turns to issue their products, as
    // in K1 and K6 (named barriers 1 and 2)
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
    softmax(0);
    pack_p();
    for (int j = 0; j + 1 < n_tiles; ++j) {
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) sp_pv[mb][0] = sp_cur[mb][0], sp_pv[mb][1] = sp_cur[mb][1];
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
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) sp_pv[mb][0] = sp_cur[mb][0], sp_pv[mb][1] = sp_cur[mb][1];
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
        const float2 cs = *reinterpret_cast<const float2*>(svb + col);
#pragma unroll
        for (int r = 0; r < 2; ++r)
          if (row[mb][r] < Sq)
            *reinterpret_cast<__nv_bfloat162*>(ob + (long)row[mb][r] * row_stride + col) =
                __floats2bfloat162_rn(acc[mb][4 * n + 2 * r] * cs.x * inv[r],
                                      acc[mb][4 * n + 2 * r + 1] * cs.y * inv[r]);
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

// v8 as the pre-pass writes it, (BH, n_vc, D, 16), as 4-d (16, D, n_vc,
// BH): one box of 16 x DP channels x rows / 16 chunks is a tile, laid out
// [chunk][channel][16]; channels past D and chunks past n_vc read as zeros
bool make_v8_map(CUtensorMap* map, const void* x, int BH, int Skv, int D, int DP, int rows) {
  const int n_vc = (Skv + 15) / 16;
  const cuuint64_t dims[4] = {16, (cuuint64_t)D, (cuuint64_t)n_vc, (cuuint64_t)BH};
  const cuuint64_t strides[3] = {16, (cuuint64_t)D * 16, (cuuint64_t)n_vc * D * 16};
  const cuuint32_t box[4] = {16, (cuuint32_t)DP, (cuuint32_t)(rows / 16), 1};
  return tensor_map_4d(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, x, dims, strides, box);
}

template <class K>
int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)bytes);
}

int p_block(int Skv) { return min(PBLOCK, (Skv + 127) / 128 * 128); }

// q8's or k8's values in bf16 as the pre-pass writes them, (BH, DP / 8, S,
// 8), as 4-d (8, S, DP / 8, BH): one box of 8 x rows x DP / 8 chunks is a
// tile, laid out [chunk][row][8]; rows past S read as zeros
bool make_bf16_map(CUtensorMap* map, const void* x, int BH, int S, int DP, int rows) {
  const cuuint64_t dims[4] = {8, (cuuint64_t)S, (cuuint64_t)(DP / 8), (cuuint64_t)BH};
  const cuuint64_t strides[3] = {16, (cuuint64_t)S * 16, (cuuint64_t)S * 16 * (DP / 8)};
  const cuuint32_t box[4] = {8, (cuuint32_t)rows, (cuuint32_t)(DP / 8), 1};
  return tensor_map_4d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, dims, strides, box);
}

template <int DP, bool SW>
int launch_blockmax(const void* qb, const void* kb, const void* sq, const void* sk,
                    void* blockmax, int B, int H, int Sq, int Skv, int bq, float scale,
                    cudaStream_t stream) {
  const size_t bytes = SW ? SW_SMEM_MAXPASS : smem_bytes_maxpass(DP);
  static bool attr_set = false;  // once per kernel instance, not per launch
  if (!attr_set) {
    const int err = set_smem(flash_int8_blockmax_kernel<DP, SW>, bytes);
    if (err) return err;
    attr_set = true;
  }
  const int bq_rows = SW ? SW_BQ : q_rows(DP), bk = SW ? SW_BK : kv_rows(DP);
  CUtensorMap tq, tk;
  bool mapped;
  if constexpr (SW)
    mapped = tensor_map_rows_sw128(&tq, qb, B * H, Sq, SW_D, bq_rows) &&
             tensor_map_rows_sw128(&tk, kb, B * H, Skv, SW_D, bk);
  else
    mapped = make_bf16_map(&tq, qb, B * H, Sq, DP, bq_rows) &&
             make_bf16_map(&tk, kb, B * H, Skv, DP, bk);
  if (!mapped) return (int)cudaErrorInvalidValue;
  const int pb = p_block(Skv);
  const dim3 grid((Sq + bq_rows - 1) / bq_rows, B * H);
  flash_int8_blockmax_kernel<DP, SW><<<grid, NTHREADS, bytes, stream>>>(
      tq, tk, (const float*)sq, (const float*)sk, (float*)blockmax, Sq, Skv, (Sq + bq - 1) / bq,
      bq, (Skv + 127) / 128 * 128, pb / bk, (Skv + pb - 1) / pb, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

template <int DK, int DP, bool SW>
int launch(const void* q8, const void* k8, const void* v8, const void* sq, const void* sk,
           const void* sv, const void* blockmax, void* o, int B, int H, int Sq, int Skv, int D,
           int bq, float scale, cudaStream_t stream) {
  const size_t bytes = SW ? SW_SMEM : smem_bytes(DK, DP);
  static bool attr_set = false;
  if (!attr_set) {
    const int err = set_smem(flash_int8pv_wgmma_kernel<DK, DP, SW>, bytes);
    if (err) return err;
    attr_set = true;
  }
  const int bq_rows = SW ? SW_BQ : q_rows(DP), bk = SW ? SW_BK : kv_rows(DP);
  const int skv_pad = (Skv + 127) / 128 * 128;
  CUtensorMap tq, tk, tv;
  bool mapped;
  if constexpr (SW)
    // q8, k8 (BH, S, 128); v8 (BH, 128 channels, skv_pad keys)
    mapped = tensor_map_rows_sw128(&tq, q8, B * H, Sq, SW_D, bq_rows) &&
             tensor_map_rows_sw128(&tk, k8, B * H, Skv, SW_D, bk) &&
             tensor_map_rows_sw128(&tv, v8, B * H, SW_D, skv_pad, SW_D);
  else
    mapped = make_s8_map(&tq, q8, B * H, Sq, DK, bq_rows) &&
             make_s8_map(&tk, k8, B * H, Skv, DK, bk) &&
             make_v8_map(&tv, v8, B * H, Skv, D, DP, bk);
  if (!mapped) return (int)cudaErrorInvalidValue;
  const int pb = p_block(Skv);
  const dim3 grid((Sq + bq_rows - 1) / bq_rows, B * H);
  flash_int8pv_wgmma_kernel<DK, DP, SW><<<grid, NTHREADS, bytes, stream>>>(
      tq, tk, tv, (const float*)sq, (const float*)sk, (const float*)sv, (const float*)blockmax,
      (__nv_bfloat16*)o, H, Sq, Skv, D, (Sq + bq - 1) / bq, bq, skv_pad, pb / bk,
      (Skv + pb - 1) / pb, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int H, int Sq, int Skv, int D, int bq) {
  return B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0 || D <= 0 || D % 8 != 0 || D > MAX_D ||
         (long)B * H > 65535 || bq <= 0 || bq % 128 != 0 ||
         (Sq > bq && bq != 1024);  // a q tile lies in one Q-scale block
}

}  // namespace

#define TCLIGHT_INT8PV_CASES(CALL) \
  CALL(32, 16) CALL(32, 32) CALL(64, 48) CALL(64, 64) CALL(96, 80) CALL(96, 96) \
  CALL(128, 112) CALL(128, 128) CALL(160, 144) CALL(160, 160)

// The max pass. qb, kb (q8's and k8's values in bf16; at D = 128 q8 and
// k8 themselves), sq, sk as the PV pre-pass writes them; blockmax (B*H, Sq, n_kb) f32, n_kb = ceil(Skv / PB), PB = min(1024, ceil128(Skv)): each
// (row, P block)'s max of w (log2 units), the keys past Skv left out. D % 8
// == 0, D <= 160; bq = min(1024, ceil128(Sq)). Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue when the arguments or the tensor
// maps are refused).
extern "C" int tclight_int8pv_blockmax(const void* qb, const void* kb, const void* sq,
                                       const void* sk, void* blockmax, int B, int H, int Sq,
                                       int Skv, int D, int bq, float scale, void* stream) {
  if (bad_shape(B, H, Sq, Skv, D, bq)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (D == SW_D)
    return launch_blockmax<SW_D, true>(qb, kb, sq, sk, blockmax, B, H, Sq, Skv, bq, scale, s);
#define TCLIGHT_CASE(DK_, DP_)                                                            \
  if ((D + 15) / 16 * 16 == DP_)                                                          \
    return launch_blockmax<DP_, false>(qb, kb, sq, sk, blockmax, B, H, Sq, Skv, bq, scale, s);
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
  if (D == SW_D)
    return launch<SW_D, SW_D, true>(q8, k8, v8, sq, sk, sv, blockmax, o, B, H, Sq, Skv, D, bq,
                                    scale, s);
#define TCLIGHT_CASE(DK_, DP_)                                                              \
  if ((D + 31) / 32 * 32 == DK_ && (D + 15) / 16 * 16 == DP_)                               \
    return launch<DK_, DP_, false>(q8, k8, v8, sq, sk, sv, blockmax, o, B, H, Sq, Skv, D, bq, \
                                   scale, s);
  TCLIGHT_INT8PV_CASES(TCLIGHT_CASE)
#undef TCLIGHT_CASE
  return (int)cudaErrorInvalidValue;
}
