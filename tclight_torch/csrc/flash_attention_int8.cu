// K7: inference flash attention with int8 q.k^T and p.v products, for
// Hopper (sm_90a), in one kernel.
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
// dequantized with sp / 127, sp = exp2(bm - m), m the row's running max;
// the softmax sum l accumulates the exact f32 p = sp * exp2(w - bm), and
// out = (sum over blocks of sp / 127 * (p8 . v8)) * sv / max(l, 1e-30). It
// matches the plain version `flash_attention_int8_plain` (the dense
// emulation JAX runs off the TPU) up to exp2 rounding, p8 values that a
// rounding tie may move by one step and a K scale rounded to 22
// significant bits (sk', K6's).
//
// The operands come from K6's pre-pass kernels in their PV variant
// (tclight_int8pv_prepass in csrc/flash_attention_qk_int8.cu): q8 (BH,
// Sq, DR) and k8 (BH, Skv, DR) int8 row-major, DR = ceil16(D); sq (BH,
// n_qb) f32; the K scales as (BH, 2, ceil128(Skv)) f32, of which the
// kernel reads the first row, each key's sk' (its scale with the two lowest
// significand bits cleared), padded keys 0; v8 (BH, D, ceil128(Skv)) int8
// channel-major, each channel's keys in the permuted order that the score
// fragment packs into (see there); sv (BH, D) f32.
//
// What bounds it on the H100: at the level-0 UNet self-attention (S ~
// 35.6k tokens, 8 heads, head dim 40) each product is 2*B*H*S^2*D ~ 0.8 T
// int8 multiply-adds (1.6 T operations, 0.8 ms at 1,979 TOPS each); the
// softmax takes B*H*S^2 ~ 2.0e10 exponentials (~5.2 ms on the special-
// function units, as K1 and K6); the block maxes take a second q.k^T and
// a conversion, a multiply and a max a score. At head dim 40 the issue
// slots bind: the softmax issues ~6.5 instructions a score, the maxes ~3.
//
// Ordering, and why it agrees with the TPU kernel. The TPU kernel keeps a
// running max over 1024-key blocks, rescales acc and l by alpha =
// exp2(m_old - m_new), and quantizes p against the max of the block's p
// after the row max has moved; padded keys take part in its max as zero
// logits and are masked in p afterwards (attention.py:255-259). Here each
// P block's max of w (bm) is made first, by a first sweep of the block's
// q.k^T, the padded keys masked to -inf before the max; the second sweep
// quantizes p against it, and the row max is kept online across P blocks
// as the TPU kernel keeps it: m_new = max(m, bm), acc and l rescaled by
// alpha = exp2(m - m_new) once a block, sp = exp2(bm - m_new). p8 is a
// ratio to its block's max (round(127 p / sp) is invariant to the scale of
// p), so the orders give the same p8 and, after the division by l, the
// same output, up to f32 rounding of the exponentials; a zero logit of a
// padded key changes only the scale that cancels.
//
// Design. K6's shape and geometry (K1's, by dp = ceil16(D)): one block per
// (q tile, batch * head); the producer warpgroup's thread 0 loads the q8
// tile by TMA once and keeps a ring of k8 tiles full (each with its keys'
// K scales, by a bulk copy), its thread 32 a ring of v8 tiles, behind
// full / empty mbarriers; three consumer warpgroups of 160 registers up to
// dp 48, two of 240 above, each owning 64 q rows; 128-key tiles up to dp
// 128, 64 above (the live registers at dp 160: 32 scores, 80 int32 p.v
// sums, the 80-value accumulator and 8 of p8). A P block is a whole number
// of tiles (tpb of them). The live registers crowd the budget at dp 32-48
// and 96-128, where ptxas spills some; 64-key tiles, which do not spill
// there, and a schedule without the overlap of p.v, which spills less,
// measured slower.
// - Two sweeps of each P block, one block apart. The iteration that issues
//   tile j's q.k^T for the softmax (sweep 2) also makes tile j + tpb's
//   scores once more, after its softmax, and folds them into the next P
//   block's running max (sweep 1). So every iteration of every warpgroup
//   holds both the softmax's exponentials (the special-function units) and
//   sweep 1's conversion, multiply and max, and one warpgroup's sweep 1 can
//   run while another's exponentials wait. A warpgroup has registers for
//   one tile of int32 scores only: sweep 1's q.k^T reuses them once the
//   tile's p8 are packed and is waited before its reduction. Block 0's
//   sweep 1 runs alone, before the first softmax.
// - k8 residency. tpb + 1 k8 tiles are live at once (sweep 2's tile j to
//   sweep 1's j + tpb). Where a ring of tpb + 2 or more fits beside the q
//   tile and the v8 ring (dp <= 112: the UNet's 40 and 80), each k8 tile is
//   loaded once and read by both sweeps; above (dp 128-160: the DiTs' 128,
//   the UNet's 160) it is loaded twice, in the order the sweeps read it,
//   the second time mostly from L2.
// - Layout, read in place. q8 and k8 tiles are K6's boxes (64 bytes in the
//   64-byte swizzle up to the depth DK = ceil32(D) = 64, else 128 in the
//   128-byte one, zero-filled past DR); a v8 tile is one box of dp channels
//   x the tile's keys (one swizzle row a channel: 128 bytes in the 128-byte
//   swizzle, 64 in the 64-byte one), the channels past D zero-filled. All
//   three are read by K-major s8 wgmma descriptors, 32 bytes a k32 step
//   within a row. The pre-pass writes no bf16 copy and no v copy.
// - Sweep 1 (`reduce_tile`): each score x * sk' (x by the conversion
//   instruction), the running max of the P block in S1_CH chains a row; at
//   its first softmax bm = max * c, c = scale * log2(e) * sq (the same as
//   the max of the products, since rounding is monotone; c <= 0 takes the
//   product first). An integer add and one FMA with a pair of scales a key
//   in place of the conversion measured 4% slower at dp 48: the add and the
//   max share the integer pipe's half rate with the softmax's byte
//   permutes.
// - Sweep 2 (`softmax_tile`): p = exp2(x * (sk' * c) - bm) in one FMA (x by
//   the conversion instruction; c joined to each key's scale as the tile is
//   read; in the last tile the padded keys' p set to 0), l += sp * sum(p)
//   per tile in two chains a row, p8 = the low byte of fma(127, p, 1.5 *
//   2^23) (round half to even
//   without a conversion instruction), four p8 packed into an A register by
//   byte permutes as the score fragment lies (the pre-pass permuted v8's
//   keys to match). p.v runs on wgmma.m64nDPk32.s32.s8.s8 with A from
//   registers and v8 K-major from the ring, accumulating int32 over a P
//   block (exact: 127 * 127 * 1024 < 2^24, so the f32 conversion is exact
//   too) and dequantized into the f32 accumulator with sp / 127 at the
//   block's last tile, after acc took the next block's alpha. Tile
//   j's p.v and tile j + 1's q.k^T are issued together and the softmax of
//   tile j + 1 runs while that p.v is in flight; the consumer warpgroups
//   take turns in a ring (named barriers): three to issue their products,
//   two to run their softmax (see there). No wgmma is
//   issued under a condition, and none is in flight across a loop's
//   back-edge.
// - out = acc * sv / max(l, 1e-30), written in bf16.
//
// Shared memory per block: the q8 tile (q rows * ceil(DK / R8) * R8
// bytes), the k8 ring (a tile and its keys' scales, 4 bytes a key, per
// slot), the v8 ring (dp * keys bytes a stage), the barriers and the
// 1,024-byte alignment.

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
constexpr float ROUND_MAGIC = 12582912.f;     // 1.5 * 2^23: its low bits round to an integer
constexpr size_t SMEM_MAX = 232448;           // dynamic shared memory a block may use

// The geometry, by dp = ceil16(D): K6's (K1's)
__host__ __device__ constexpr int depth8(int dp) { return (dp + 31) / 32 * 32; }  // DK
// bytes of a row of one of q8's or k8's boxes: one 64-byte swizzle row where
// the q.k^T depth fits it (the UNet's 40), else a 128-byte one
__host__ __device__ constexpr int row8(int dp) { return depth8(dp) <= 64 ? 64 : 128; }
__host__ __device__ constexpr int slabs8(int dp) { return (depth8(dp) + row8(dp) - 1) / row8(dp); }
// three consumer warpgroups of 160 registers up to dp 48 (the UNet's 40);
// above, the live registers (scores, int32 p.v sums, the accumulator, p8)
// outgrow 160
__host__ __device__ constexpr int consumers(int dp) { return dp <= 48 ? 3 : 2; }
// independent chains a row of sweep 1's running max, and of sweep 2's row
// sum: one chain's dependent FMNMX / FADD per score would bind the latency
constexpr int S1_CH = 2;
constexpr int PV_CH = 2;
__host__ __device__ constexpr int kv_rows(int dp) { return dp <= 128 ? 128 : 64; }
__host__ __device__ constexpr int n_stages(int dp) { return dp <= 64 ? 4 : 3; }  // v8 stages
__host__ __device__ constexpr int consumer_regs(int nwg) {
  return ((65536 / (128 * (nwg + 1))) / 8 * 8 * (nwg + 1) - 24) / nwg / 8 * 8;
}
// bytes of one k8 slot: the tile and its keys' scales sk'; of one v8
// stage: dp channels x the tile's keys
__host__ __device__ constexpr int k_slot_bytes(int dp) {
  return kv_rows(dp) * (slabs8(dp) * row8(dp) + 4);
}
__host__ __device__ constexpr int v_stage_bytes(int dp) { return dp * kv_rows(dp); }
// k8 slots: with the tiles resident, a P block's tiles and the next one's
// first (sweep 1 runs a block ahead) and one or three to load into; loaded
// twice, four
__host__ __device__ constexpr int k_slots(int dp, bool res) {
  return res ? PBLOCK / kv_rows(dp) + (dp <= 64 ? 4 : 2) : 4;
}
__host__ __device__ constexpr size_t smem_bytes(int dp, bool res) {
  return (size_t)64 * consumers(dp) * slabs8(dp) * row8(dp) +
         (size_t)k_slots(dp, res) * k_slot_bytes(dp) + (size_t)n_stages(dp) * v_stage_bytes(dp) +
         8 * (1 + 2 * k_slots(dp, res) + 2 * n_stages(dp)) + 1024;
}
// each k8 tile loaded once, read by both sweeps, where its ring fits
__host__ __device__ constexpr bool resident(int dp) { return smem_bytes(dp, true) <= SMEM_MAX; }

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

// one arrive of this warp on `bar`
__device__ __forceinline__ void warp_arrive(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
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

// Sweep 1's reduction of one tile's scores into the running block maxes.
// This thread holds rows g (s[4n], s[4n+1]) and g + 8 (s[4n+2], s[4n+3])
// of its warp's 16, keys 8n + 2t, +1; tS holds the tile's sk'. Each score
// is x * sk'. TAIL masks the keys past Skv (lim: Skv less the tile's first
// key and 2t); FOLD (c > 0) leaves the multiply by c to the block's end.
template <int BK, bool TAIL, bool FOLD>
__device__ __forceinline__ void reduce_tile(const uint32_t (&s)[BK / 2], float (&bmax)[2][S1_CH],
                                            const float* tS, int t, int lim, float c_row) {
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) {
    const float2 sk2 = *reinterpret_cast<const float2*>(tS + n * 8 + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float u = (float)(int)s[4 * n + e] * ((e & 1) ? sk2.y : sk2.x);
      if (!FOLD) u *= c_row;
      if (TAIL) u = n * 8 + (e & 1) < lim ? u : -INFINITY;
      bmax[e >> 1][n % S1_CH] = fmaxf(bmax[e >> 1][n % S1_CH], u);
    }
  }
}

// Sweep 2's softmax of one tile's scores: p = exp2(x * (sk' * c) - bm),
// rsum += p, and p8 in the low byte of s. This thread holds rows g (s[4n],
// s[4n+1]) and g + 8 (s[4n+2], s[4n+3]) of its warp's 16, keys 8n + 2t, 8n
// + 2t + 1; tS holds the tile's sk'. The scores convert to f32 by the
// conversion instruction (beside the exponentials it binds nothing); c
// joins each key's scale as the tile is read, one multiply a key for one a
// score (4% faster at head dim 40 than a multiply a score; at 128 the two
// are within 2%). TAIL (the last tile only) sets the padded keys' p to 0,
// in a body of its own, so that the other tiles carry no per-score test.
template <int BK, bool TAIL>
__device__ __forceinline__ void softmax_tile(uint32_t (&s)[BK / 2], float (&rsum)[2][PV_CH],
                                             const float* tS, int t, int lim, float c_row,
                                             const float (&bm)[2]) {
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) {
    const float2 skv = *reinterpret_cast<const float2*>(tS + n * 8 + 2 * t);
    const float kc0 = skv.x * c_row, kc1 = skv.y * c_row;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = fast_exp2(fmaf((float)(int)s[4 * n + e], (e & 1) ? kc1 : kc0, -bm[e >> 1]));
      if (TAIL) p = n * 8 + (e & 1) < lim ? p : 0.f;
      rsum[e >> 1][n % PV_CH] += p;
      s[4 * n + e] = __float_as_uint(fmaf(127.f, p, ROUND_MAGIC));
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(128 * (1 + consumers(DP)), 1)
flash_int8pv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const float* __restrict__ sq, const float* __restrict__ sk,
                          const float* __restrict__ sv, __nv_bfloat16* __restrict__ o, int H,
                          int Sq, int Skv, int D, int n_qb, int bq, int skv_pad, int tpb,
                          float scale_log2) {
  constexpr int NWG = consumers(DP);
  constexpr int BQ = 64 * NWG;
  constexpr int BK = kv_rows(DP);
  constexpr int DK = depth8(DP);
  constexpr int NSK = slabs8(DP);
  constexpr int R8 = row8(DP);
  constexpr bool RES = resident(DP);
  constexpr int NK = k_slots(DP, RES);  // k8 slots
  constexpr int NV = n_stages(DP);      // v8 stages
  constexpr int KTILE = BK * NSK * R8;  // bytes of one k8 tile
  constexpr int VTILE = DP * BK;        // bytes of one v8 tile: DP channels x BK keys
  constexpr uint32_t K_TX = KTILE + BK * 4;
  static_assert(smem_bytes(DP, RES) <= SMEM_MAX, "shared memory");
  extern __shared__ unsigned char smem_raw[];
  int8_t* sQ = reinterpret_cast<int8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  int8_t* sK = sQ + BQ * NSK * R8;  // NK k8 tiles
  int8_t* sV = sK + NK * KTILE;     // NV v8 tiles, [channel][key], swizzled
  float* sS = reinterpret_cast<float*>(sV + NV * VTILE);  // per k8 slot its BK keys' sk'
  uint64_t* qbar = reinterpret_cast<uint64_t*>(sS + NK * BK);
  uint64_t* kfull = qbar + 1;
  uint64_t* kempty = kfull + NK;
  uint64_t* vfull = kempty + NK;
  uint64_t* vempty = vfull + NV;

  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int n_tiles = (Skv + BK - 1) / BK;
  const int n1 = min(tpb, n_tiles);        // block 0's tiles: sweep 1 before the first softmax
  const int n_mixed = max(0, n_tiles - tpb);  // sweep-2 tiles j whose iteration sweeps j + tpb
  // warp-uniform as far as the compiler can see: wgmma on a path it
  // cannot prove uniform is serialised
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < NK; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&kempty[s], NWG * 4);  // one arrive per consumer warp
    }
    for (int s = 0; s < NV; ++s) {
      mbar_init(&vfull[s], 1);
      mbar_init(&vempty[s], NWG * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------------------------------------------------- producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      // the q8 tile, then the k8 tiles in the order the consumers read them
      mbar_expect_tx(qbar, BQ * NSK * R8);
      for (int c = 0; c < NSK; ++c) tma_load_4d(sQ + c * BQ * R8, &tq, qbar, c * R8, q0, bh, 0);
      int n = 0;
      auto load_k = [&](int kt) {
        const int st = n % NK;
        if (n >= NK) mbar_wait(&kempty[st], ((n / NK) - 1) & 1);
        mbar_expect_tx(&kfull[st], K_TX);
        for (int c = 0; c < NSK; ++c)
          tma_load_4d(sK + st * KTILE + c * BK * R8, &tk, &kfull[st], c * R8, kt * BK, bh, 0);
        bulk_load(sS + st * BK, sk + (long)bh * 2 * skv_pad + kt * BK, BK * 4, &kfull[st]);
        ++n;
      };
      if (RES) {
        for (int kt = 0; kt < n_tiles; ++kt) load_k(kt);
      } else {
        for (int kt = 0; kt < n1; ++kt) load_k(kt);
        for (int j = 0; j < n_tiles; ++j) {
          load_k(j);
          if (j < n_mixed) load_k(j + tpb);
        }
      }
    } else if (threadIdx.x == 32) {
      // the v8 tiles
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % NV;
        if (j >= NV) mbar_wait(&vempty[st], ((j / NV) - 1) & 1);
        mbar_expect_tx(&vfull[st], VTILE);
        tma_load_4d(sV + st * VTILE, &tv, &vfull[st], j * BK, 0, bh, 0);
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
    const bool fold = c_row > 0.f;  // max(u) * c == max(u * c): rounding is monotone
    const int8_t* sQw = sQ + cw * 64 * R8;

    float acc[DP / 2];
    uint32_t pv[DP / 2];   // int32 p8 . v8 of the P block in flight
    uint32_t s[BK / 2];    // int32 sums, then p8 in the low byte of f32 bits
    uint32_t pa[BK / 32][4];  // p8 of the tile whose p.v is next or in flight
    float bmax[2][S1_CH];  // sweep 1: the running maxes of the next P block's logits
    float bm[2];           // the max of the P block of the softmax's tile
    float m_run[2] = {-INFINITY, -INFINITY};  // the row max over the P blocks so far
    float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums
    float sp_cur[2] = {0.f, 0.f};  // the softmax tile's block: exp2(bm - m)
    float sp_pv[2] = {0.f, 0.f};   // sp of the block of the p.v tile
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) {
      acc[i] = 0.f;
      pv[i] = 0u;
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0u;
#pragma unroll
    for (int ch = 0; ch < S1_CH; ++ch) bmax[0][ch] = bmax[1][ch] = -INFINITY;
    auto fence_all = [&]() {
      fence_regs(s);
      fence_regs(pv);
    };
    // the k8 ring's entry of sweep 2's tile j, and of the sweep-1 tile of
    // the iteration of tile j (j < n_mixed): the tile itself where the tiles
    // are resident, else their place in the producer's order
    auto kseq2 = [&](int j) { return RES ? j : n1 + j + min(j, n_mixed); };
    auto kseq1 = [&](int j) { return RES ? j + tpb : n1 + 2 * j + 1; };

    // ------------------------------------------------------------ sweep 1
    // tile kt's scores (k8 entry seq) into the running maxes of its P block
    auto sweep1 = [&](int kt, int seq) {
      const int st = seq % NK;
      mbar_wait(&kfull[st], (seq / NK) & 1);
      fence_regs(s);
      wgmma_fence();
      issue_qk8<BQ, BK, DK, R8>(s, sQw, sK + st * KTILE);
      wgmma_wait<0>();
      fence_regs(s);
      const float* tS = sS + st * BK;
      const int lim = Skv - kt * BK - 2 * t;  // this thread's keys 8n + 2t + e' < Skv
      if ((kt + 1) * BK > Skv) {
        if (fold) reduce_tile<BK, true, true>(s, bmax, tS, t, lim, c_row);
        else reduce_tile<BK, true, false>(s, bmax, tS, t, lim, c_row);
      } else {
        if (fold) reduce_tile<BK, false, true>(s, bmax, tS, t, lim, c_row);
        else reduce_tile<BK, false, false>(s, bmax, tS, t, lim, c_row);
      }
      if (!RES) warp_arrive(&kempty[st], lane);
    };

    // ------------------------------------------------------------ sweep 2
    // pv (+)= p8 v8 of tile j from v8 stage vs; v8 K-major: 32 keys a step,
    // 32 bytes within a channel's row of BK bytes (the BK-byte swizzle), the
    // next 8 channels 8 * BK bytes on; the first tile of a P block overwrites
    auto issue_pv = [&](int j, int vs) {
      const int8_t* tV = sV + vs * VTILE;
      const int keep = j % tpb != 0;
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk) {
        const uint64_t dv = BK == 128 ? wgmma_desc_sw128(tV + kk * 32, 16, 8 * BK)
                                      : wgmma_desc_sw64(tV + kk * 32, 16, 8 * BK);
        WgmmaS8RS<DP>::run(pv, pa[kk], dv, kk > 0 ? 1 : keep);
      }
      wgmma_commit();
    };
    // the softmax of tile j (`softmax_tile`) against its P block's bm. At
    // the block's first tile, bm from sweep 1's running maxes, which start
    // over (sweep 1 has swept this block and not begun the next: a ragged
    // last block ends its sweep 1 early, while the block before it still
    // takes its softmax against its own max); the row max moves to max(m,
    // bm), and l, acc and the sp of the block whose last p.v is in flight
    // take alpha = exp2(m - m_new); sp = exp2(bm - m_new). l += sp * sum(p)
    auto softmax = [&](int j, const float* tS) {
      if (j % tpb == 0) {
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float m = bmax[r][0];
#pragma unroll
          for (int ch = 1; ch < S1_CH; ++ch) m = fmaxf(m, bmax[r][ch]);
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
          bm[r] = fold ? m * c_row : m;
#pragma unroll
          for (int ch = 0; ch < S1_CH; ++ch) bmax[r][ch] = -INFINITY;
          const float m_new = fmaxf(m_run[r], bm[r]);
          alpha[r] = fast_exp2(m_run[r] - m_new);  // 0 at the first block
          sp_cur[r] = fast_exp2(bm[r] - m_new);
          l_run[r] *= alpha[r];
          sp_pv[r] *= alpha[r];
          m_run[r] = m_new;
        }
#pragma unroll
        for (int i = 0; i < DP / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
      }
      const int lim = Skv - j * BK - 2 * t;  // this thread's keys 8n + 2t + e' < Skv
      float rsum[2][PV_CH] = {};
      if ((j + 1) * BK > Skv) softmax_tile<BK, true>(s, rsum, tS, t, lim, c_row, bm);
      else softmax_tile<BK, false>(s, rsum, tS, t, lim, c_row, bm);
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
      if ((j + 1) % tpb == 0 || j + 1 == n_tiles) {
        const float deq[2] = {sp_pv[0] / 127.f, sp_pv[1] / 127.f};
#pragma unroll
        for (int i = 0; i < DP / 2; ++i)
          acc[i] = fmaf((float)(int)pv[i], deq[(i >> 1) & 1], acc[i]);
      }
    };

    // the consumer warpgroups take turns, in a ring (named barriers 1 + c):
    // with three, to issue their sweep-2 products, as in K1 and K6 (their
    // softmaxes then run together: one warpgroup's alone measured 10%
    // slower at head dim 40); with two, to run their softmax, one beside the
    // other's sweep 1 (2-6% faster than the turns to issue)
    constexpr bool TURN_SOFTMAX = NWG == 2;
    const int my_turn = 1 + cw, next_turn = NWG == 2 ? 2 - cw : 1 + (cw + 1) % NWG;
    if (cw == NWG - 1) named_arrive(next_turn, 256);
    auto take_turn = [&]() { named_sync(my_turn, 256); };
    auto pass_turn = [&](bool last) {
      if (cw != NWG - 1 || !last) named_arrive(next_turn, 256);
    };
    // tile j's q.k^T with tile j - 1's p.v, the softmax of tile j, then
    // tile j - 1's P block dequantized where it ends and tile j's p8 packed
    auto step = [&](int j) {
      sp_pv[0] = sp_cur[0], sp_pv[1] = sp_cur[1];
      const int vs = (j - 1) % NV, seq = kseq2(j), st = seq % NK;
      mbar_wait(&vfull[vs], ((j - 1) / NV) & 1);
      if (!RES) mbar_wait(&kfull[st], (seq / NK) & 1);  // resident: waited in sweep 1
      if constexpr (!TURN_SOFTMAX) take_turn();
      fence_all();
      wgmma_fence();
      issue_qk8<BQ, BK, DK, R8>(s, sQw, sK + st * KTILE);
      issue_pv(j - 1, vs);
      if constexpr (!TURN_SOFTMAX) pass_turn(false);
      wgmma_wait<1>();  // q.k^T of tile j (the older group) is done
      fence_all();
      if constexpr (TURN_SOFTMAX) take_turn();
      softmax(j, sS + st * BK);
      if constexpr (TURN_SOFTMAX) pass_turn(false);
      wgmma_wait<0>();  // p.v of tile j - 1 is done: pv and pa are free
      fence_all();
      warp_arrive(&kempty[st], lane);
      warp_arrive(&vempty[vs], lane);
      dequant(j - 1);
      pack_p();
    };

    mbar_wait(qbar, 0);
    for (int kt = 0; kt < n1; ++kt) sweep1(kt, kt);
    {  // tile 0: q.k^T and softmax, no p.v yet
      const int seq = kseq2(0), st = seq % NK;
      if (!RES) mbar_wait(&kfull[st], (seq / NK) & 1);
      if constexpr (!TURN_SOFTMAX) take_turn();
      fence_all();
      wgmma_fence();
      issue_qk8<BQ, BK, DK, R8>(s, sQw, sK + st * KTILE);
      if constexpr (!TURN_SOFTMAX) pass_turn(false);
      wgmma_wait<0>();
      fence_all();
      if constexpr (TURN_SOFTMAX) take_turn();
      softmax(0, sS + st * BK);
      if constexpr (TURN_SOFTMAX) pass_turn(false);
      warp_arrive(&kempty[st], lane);
      pack_p();
    }
    for (int kt = tpb; kt < min(n_tiles, tpb + 1); ++kt) sweep1(kt, kseq1(0));
    int j = 1;
    for (; j < n_mixed; ++j) {
      step(j);
      sweep1(j + tpb, kseq1(j));
    }
    for (; j < n_tiles; ++j) step(j);
    {  // the last tile's p.v
      sp_pv[0] = sp_cur[0], sp_pv[1] = sp_cur[1];
      const int vs = (n_tiles - 1) % NV;
      mbar_wait(&vfull[vs], ((n_tiles - 1) / NV) & 1);
      take_turn();
      fence_all();
      wgmma_fence();
      issue_pv(n_tiles - 1, vs);
      pass_turn(true);
      wgmma_wait<0>();
      fence_all();
      dequant(n_tiles - 1);
    }

    const long row_stride = (long)H * D;
    __nv_bfloat16* ob = o + ((long)b * Sq * H + h) * D;
    const float* svb = sv + (long)bh * D;
    float inv[2];
    int row[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      row[r] = q0 + cw * 64 + warp * 16 + g + 8 * r;
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

int p_block(int Skv) { return min(PBLOCK, (Skv + 127) / 128 * 128); }

template <int DP>
int launch(const void* q8, const void* k8, const void* v8, const void* sq, const void* sk,
           const void* sv, void* o, int B, int H, int Sq, int Skv, int D, int bq, float scale,
           cudaStream_t stream) {
  const size_t bytes = smem_bytes(DP, resident(DP));
  static bool attr_set = false;  // once per kernel instance, not per launch
  if (!attr_set) {
    const int err = (int)cudaFuncSetAttribute(
        flash_int8pv_wgmma_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
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
  const dim3 grid((Sq + bq_rows - 1) / bq_rows, B * H);
  flash_int8pv_wgmma_kernel<DP><<<grid, 128 * (1 + consumers(DP)), bytes, stream>>>(
      tq, tk, tv, (const float*)sq, (const float*)sk, (const float*)sv, (__nv_bfloat16*)o, H,
      Sq, Skv, D, (Sq + bq - 1) / bq, bq, skv_pad, p_block(Skv) / bk,
      scale * 1.4426950408889634f);
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

// K7 on the pre-pass's operands; o (B, Sq, H, D) bf16. D % 8 == 0, D <=
// 160; bq = min(1024, ceil128(Sq)). Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue when the arguments or the tensor maps are
// refused).
extern "C" int tclight_flash_attention_int8pv(const void* q8, const void* k8, const void* v8,
                                              const void* sq, const void* sk, const void* sv,
                                              void* o, int B, int H, int Sq, int Skv, int D,
                                              int bq, float scale, void* stream) {
  if (bad_shape(B, H, Sq, Skv, D, bq)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define TCLIGHT_CASE(DP_)                                                                  \
  if ((D + 15) / 16 * 16 == DP_)                                                           \
    return launch<DP_>(q8, k8, v8, sq, sk, sv, o, B, H, Sq, Skv, D, bq, scale, s);
  TCLIGHT_INT8PV_CASES(TCLIGHT_CASE)
#undef TCLIGHT_CASE
  return (int)cudaErrorInvalidValue;
}
