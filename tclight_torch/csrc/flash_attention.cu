// K1: inference flash attention for Hopper (sm_90a), bf16 in, bf16 out.
//
// Replaces the TPU kernel tclight_tpu/ops/attention.py `_flash_kernel`
// (pallas_call at :418, reached through `_flash_attention_pallas` and
// `flash_attention`). Same function: softmax(scale * q k^T) v per (batch,
// head), online softmax in log2 space with f32 running max / sum /
// accumulator, the ragged kv tail masked to -inf before the row max,
// out = acc / max(l, 1e-30).
//
// What bounds it on the H100: at the level-0 UNet self-attention (S ~ 35.6k
// merged + bank tokens, 8 heads, head dim 40) the products are 4*B*H*S^2*D
// ~ 3.3 TFLOP (3.3 ms at the bf16 peak) on ~0.1 GB of q/k/v/o, and the
// softmax takes B*H*S^2 ~ 2.0e10 exponentials, ~5.2 ms on the special-
// function units (~3.9e12 ex2/s), with ~4 more FMA-pipe instructions a
// score. At D = 40 the softmax, not the tensor cores, sets the floor, so
// the design keeps the tensor cores and the softmax's pipes busy at once.
// At head dim 128 (the Cosmos DiTs) the products bind.
//
// Design (the FlashAttention-3 shape):
// - One block per (q tile, batch * head): a producer warpgroup and NWG
//   consumer warpgroups. One producer thread issues the TMA loads of the q
//   tile (once) and of the k and v tiles into a ring of NST stages, with
//   full / empty mbarriers (one empty arrive per consumer warp). It gives
//   up registers (setmaxnreg 24) to the consumers.
// - Each consumer warpgroup owns one block of 64 q rows (MB = 1). S = q k^T
//   is a chain of wgmma.m64nBKk16 with both operands in shared memory; the
//   softmax runs on the S registers; p is packed to bf16 in registers as
//   the A operand of O += p v (wgmma.m64nNPVk16, v MN-major from shared
//   memory).
// - Geometry by the q.k^T depth dp = ceil16(D) (`consumers`, `kv_rows`,
//   `n_stages` below). Up to dp = 64 (the UNet's D = 40) three consumer
//   warpgroups of 160 registers (192 q rows), 128-key tiles in 4 stages:
//   three warps a scheduler to hide the softmax's latencies, and half the
//   fixed costs a key of 64-key tiles (a barrier round, the row max's
//   shuffles, the accumulator's rescale). Up to dp = 128 (D = 80, 128) two
//   of 240 registers, 128-key tiles in 3 stages; above (D = 160) two,
//   64-key tiles in 3 stages (128 keys do not fit beside a 128-row q tile).
// - Overlap. Within a warpgroup, tile j's p.v and tile j + 1's q.k^T are
//   issued together, and the softmax of tile j + 1 is written to run
//   while that p.v is in flight; ptxas places most of its exponentials
//   after the wait on that p.v all the same (a loop that ends on the
//   softmax keeps them before the wait, and was slower). Across
//   warpgroups, a ping-pong on named barriers makes them take turns, in a
//   ring, to issue their products, so that the others' softmax runs while
//   one's products do. No wgmma is issued on a path ptxas cannot prove
//   warp-uniform: it would serialise them all (warning C7520).
// - Softmax. For scale > 0 the row max is taken on the raw scores and the
//   scale folds into the exponent's argument, one FMA a score; the kv
//   tail is masked to -inf in a pass of its own, in the last tile only.
//   The row max and row sum run in two chains a row up to dp = 96, one
//   above (head dim 128's code as it was). Where D = dp - 8 up to dp = 64
//   (the UNet's 40), the tensor cores take the row sums: p.v reads a v
//   tile whose zero-filled dim D is set to 1 (`SUMCOL`), one FMA-pipe add
//   a score fewer.
// - Layout. q, k and v are read in place from (B, S, H, D) through 4-d
//   tensor maps (D, H, S, B), each tile as ceil(dp / 64) boxes of 64 dims
//   (one 128-byte row) x its rows, in the 128-byte swizzle that wgmma reads
//   directly (hopper.cuh): K-major q and k for q.k^T, MN-major v for p.v;
//   the wrapper makes no copy. A box over a row of D < 64 dims, or over the
//   last slab of a row, reaches past D: TMA fills those dims with zeros, so
//   the q.k^T depth dp and the p.v width NPV = dp read zeros there and
//   nothing of the next head. Tokens past S and q rows past Sq lie outside
//   the maps too. (The layout before read 16-byte boxes, 8 dims x a
//   tile's rows, through chunk-major copies of k and v the wrapper made:
//   the copies cost a read and a write of k and v a launch, and a 16-byte
//   box moves a tile as that many 16-byte rows.)
//
// Shared memory per block: (q rows + 2 * NST * kv rows) * slabs * 128
// bytes (+ barriers and the 1,024-byte alignment): 155,648 at dp <= 64,
// 229,376 at dp 80-128, 196,608 at dp 144-160.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

using namespace tclight::hopper;

namespace {

constexpr int MAX_D = 160;
constexpr int SLAB = 64;  // head dims of one TMA box: a 128-byte swizzle row

// The geometry, by the q.k^T depth dp = ceil16(D)
__host__ __device__ constexpr int slabs(int dp) { return (dp + SLAB - 1) / SLAB; }
__host__ __device__ constexpr int consumers(int dp) { return dp <= 64 ? 3 : 2; }
__host__ __device__ constexpr int row_blocks(int dp) { return 1; }
__host__ __device__ constexpr int q_rows(int dp) { return 64 * row_blocks(dp) * consumers(dp); }
__host__ __device__ constexpr int kv_rows(int dp) { return dp <= 128 ? 128 : 64; }
__host__ __device__ constexpr int n_stages(int dp) { return dp <= 64 ? 4 : 3; }
// the p.v product's width: dp, a width that stops inside a 64-dim slab
__host__ __device__ constexpr int pv_width(int dp) { return dp; }
// where D = dp - 8, p.v also takes the row sums (see `SUMCOL`)
__host__ __device__ constexpr bool sums_on_tc(int dp) { return dp <= 64; }
// independent chains a row of the softmax's row max and row sum
__host__ __device__ constexpr int chains(int dp) { return dp <= 96 ? 2 : 1; }
constexpr bool PINGPONG = true;

__host__ __device__ constexpr int n_threads(int dp) { return 128 * (1 + consumers(dp)); }
// a consumer thread's registers: the block's launch share (65,536 over its
// threads, in 8s) less the producer's 24, over the consumers
__host__ __device__ constexpr int consumer_regs(int nwg) {
  return ((65536 / (128 * (nwg + 1))) / 8 * 8 * (nwg + 1) - 24) / nwg / 8 * 8;
}
__host__ __device__ constexpr size_t smem_bytes(int dp) {
  return (size_t)(q_rows(dp) + 2 * n_stages(dp) * kv_rows(dp)) * slabs(dp) * SLAB * 2 +
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

template <int DP, bool SUMCOL>
__global__ void __launch_bounds__(n_threads(DP), 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       __nv_bfloat16* __restrict__ o, int H, int Sq, int Skv, int D,
                       float scale_log2) {
  constexpr int NWG = consumers(DP);
  constexpr int MB = row_blocks(DP);
  constexpr int BQ = q_rows(DP);
  constexpr int BK = kv_rows(DP);
  constexpr int NST = n_stages(DP);
  constexpr int NS = slabs(DP);
  constexpr int NPV = pv_width(DP);
  constexpr int TILE = BK * NS * SLAB;  // elements of one k or v tile
  constexpr int REGS = consumer_regs(NWG);  // 240 for two consumers, 160 for three
  // SUMCOL (D = DP - 8): dim D of every v tile, zero-filled by TMA, is set
  // to 1 before its p.v, so acc's column D sums each row's p (the bf16 p
  // the product takes) and is rescaled with the rest; the softmax takes
  // no row sums, one FMA-pipe add a score fewer
  constexpr int SUM_DIM = DP - 8;
  constexpr int CH = chains(DP);
  static_assert(BQ <= 256 && NPV <= NS * SLAB, "a TMA box holds at most 256 rows");
  static_assert(!SUMCOL || SUM_DIM < NPV, "the sum column lies in the p.v width");
  extern __shared__ unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __nv_bfloat16* sK = sQ + BQ * NS * SLAB;  // NST tiles
  __nv_bfloat16* sV = sK + NST * TILE;      // NST tiles
  uint64_t* qbar = reinterpret_cast<uint64_t*>(sV + NST * TILE);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + NST;

  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
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
      // k or v tile j into stage st: one box per 64-dim slab
      auto load_kv = [&](__nv_bfloat16* ring, const CUtensorMap* map, int st, int j) {
        for (int c = 0; c < NS; ++c)
          tma_load_4d(ring + st * TILE + c * BK * SLAB, map, &full[st], c * SLAB, h, j * BK, b);
      };
      mbar_expect_tx(qbar, BQ * NS * SLAB * 2);
      for (int c = 0; c < NS; ++c)
        tma_load_4d(sQ + c * BQ * SLAB, &tq, qbar, c * SLAB, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % NST;
        if (j >= NST) mbar_wait(&empty[st], ((j / NST) - 1) & 1);
        mbar_expect_tx(&full[st], 2 * TILE * 2);
        load_kv(sK, &tk, st, j);
        load_kv(sV, &tv, st, j);
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    setmaxnreg_inc<REGS>();
    const int cw = wg - 1;  // which MB * 64 q rows
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int g = lane >> 2;
    const int t = lane & 3;

    float acc[MB][NPV / 2];
    float s[MB][BK / 2];
    uint32_t pa[MB][BK / 16][4];  // p of the tile whose p.v is next or in flight
    float m_run[MB][2], l_run[MB][2];  // l: this thread's share of the row sums
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) {
#pragma unroll
      for (int i = 0; i < NPV / 2; ++i) acc[mb][i] = 0.f;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[mb][i] = 0.f;
      m_run[mb][0] = m_run[mb][1] = -INFINITY;
      l_run[mb][0] = l_run[mb][1] = 0.f;
    }
    // dim SUM_DIM of tile j's v rows to 1 (SUMCOL): one key a thread, its
    // 16-byte chunk in the 128-byte swizzle; every consumer warpgroup writes
    // the same ones, before its own p.v of the tile, after a barrier
    auto ones_column = [&](int j) {
      if constexpr (SUMCOL) {
        const int r = threadIdx.x % 128;
        if (r < BK) {
          __nv_bfloat16* row = sV + (j % NST) * TILE + (SUM_DIM / SLAB) * BK * SLAB + r * SLAB;
          row[(((SUM_DIM % SLAB) / 8) ^ (r & 7)) * 8] = __float2bfloat16(1.f);
        }
        fence_proxy_async();
        if (!PINGPONG) named_sync(5 + cw, 128);  // else take_turn's barrier orders them
      }
    };
    auto fence_all = [&]() {
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) {
        fence_regs(s[mb]);
        fence_regs(acc[mb]);
      }
    };

    // S = q k^T of tile j into s: per row block, 64 rows x BK keys in DP /
    // 16 steps of depth 16, both operands K-major in shared memory: slab
    // kk / 4 (rows of 128 bytes), 32 bytes a step within it; a 64-row q
    // block starts 8 KB into its slab
    auto issue_qk = [&](int j) {
      const __nv_bfloat16* tK = sK + (j % NST) * TILE;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
#pragma unroll
        for (int mb = 0; mb < MB; ++mb)
          WgmmaSS<BK>::run(
              s[mb], wgmma_desc_sw128(sQ + (kk / 4) * BQ * SLAB + (cw * MB + mb) * 64 * SLAB +
                                          (kk % 4) * 16,
                                      16, 1024),
              wgmma_desc_sw128(tK + (kk / 4) * BK * SLAB + (kk % 4) * 16, 16, 1024),
              kk > 0 ? 1 : 0);
      wgmma_commit();
    };
    // O += p v of tile j: v MN-major, 16 keys a step (2 KB), the next 8
    // keys 1,024 bytes on, the next 64 dims one slab (BK * 128 bytes) on;
    // a width NPV that stops inside a slab reads its first NPV % 64 dims
    auto issue_pv = [&](int j) {
      const __nv_bfloat16* tV = sV + (j % NST) * TILE;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int mb = 0; mb < MB; ++mb)
          WgmmaRS<NPV>::run(acc[mb], pa[mb][kk],
                            wgmma_desc_sw128(tV + kk * 16 * SLAB, BK * 128, 1024), 1);
      wgmma_commit();
    };
    // online softmax of tile j in s: the exponentials in place, the row
    // maxima and sums updated, each row's rescale of the accumulator in
    // alpha. This thread holds rows g (s[4n], s[4n+1]) and g + 8 (s[4n+2],
    // s[4n+3]) of its warp's 16 of each row block, keys 8n + 2t, 8n + 2t + 1.
    // Keys past Skv (only in the last tile) are masked to -inf before the
    // row max. For scale > 0 the max is taken on the raw scores and the
    // scale folds into the exponent's argument, one FMA a score:
    // exp2(s * c - m * c) with m = max(s); the maxima are kept scaled.
    // Maxima and sums run in CH chains a row (n % CH).
    const bool fold = scale_log2 > 0.f;
    auto softmax = [&](int j, float (&alpha)[MB][2]) {
      const int kv0 = j * BK;
      if (kv0 + BK > Skv) {
#pragma unroll
        for (int mb = 0; mb < MB; ++mb)
#pragma unroll
          for (int i = 0; i < BK / 2; ++i)
            if (kv0 + (i >> 2) * 8 + 2 * t + (i & 1) >= Skv) s[mb][i] = -INFINITY;
      }
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) {
        float tmax[2][CH];
#pragma unroll
        for (int ch = 0; ch < CH; ++ch) tmax[0][ch] = tmax[1][ch] = -INFINITY;
        if (fold) {
#pragma unroll
          for (int i = 0; i < BK / 2; ++i)
            tmax[(i >> 1) & 1][(i >> 2) % CH] = fmaxf(tmax[(i >> 1) & 1][(i >> 2) % CH], s[mb][i]);
        } else {
#pragma unroll
          for (int i = 0; i < BK / 2; ++i) {
            s[mb][i] *= scale_log2;
            tmax[(i >> 1) & 1][(i >> 2) % CH] = fmaxf(tmax[(i >> 1) & 1][(i >> 2) % CH], s[mb][i]);
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
          if (fold) mx *= scale_log2;
          const float m_new = fmaxf(m_run[mb][r], mx);  // finite: a tile has a valid key
          alpha[mb][r] = fast_exp2(m_run[mb][r] - m_new);
          m_run[mb][r] = m_new;
          neg_m[r] = -m_new;
        }
        const float c = fold ? scale_log2 : 1.f;
        float rsum[2][CH] = {};
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          s[mb][i] = fast_exp2(fmaf(s[mb][i], c, neg_m[(i >> 1) & 1]));
          if constexpr (!SUMCOL) rsum[(i >> 1) & 1][(i >> 2) % CH] += s[mb][i];
        }
        if constexpr (!SUMCOL) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float sum = rsum[r][0];
#pragma unroll
            for (int ch = 1; ch < CH; ++ch) sum += rsum[r][ch];
            l_run[mb][r] = l_run[mb][r] * alpha[mb][r] + sum;
          }
        }
      }
    };
    // p as bf16 A fragments: keys 16kk..16kk+15 are blocks 2kk, 2kk + 1
    auto pack_p = [&]() {
#pragma unroll
      for (int mb = 0; mb < MB; ++mb)
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          pa[mb][kk][0] = pack_bf16(s[mb][8 * kk + 0], s[mb][8 * kk + 1]);
          pa[mb][kk][1] = pack_bf16(s[mb][8 * kk + 2], s[mb][8 * kk + 3]);
          pa[mb][kk][2] = pack_bf16(s[mb][8 * kk + 4], s[mb][8 * kk + 5]);
          pa[mb][kk][3] = pack_bf16(s[mb][8 * kk + 6], s[mb][8 * kk + 7]);
        }
    };

    // The consumer warpgroups take turns, in a ring, to issue their
    // products: named barrier 1 + c is warpgroup c's turn, 256 threads (its
    // sync meets the arrive of the warpgroup before it), so that the
    // others' softmax runs while one's products do. The last warpgroup
    // opens warpgroup 0's first turn, and leaves out its last arrive,
    // which no sync would meet.
    const int my_turn = 1 + cw, next_turn = NWG == 2 ? 2 - cw : 1 + (cw + 1) % NWG;
    if (PINGPONG && cw == NWG - 1) named_arrive(next_turn, 256);
    auto take_turn = [&]() {
      if (PINGPONG) named_sync(my_turn, 256);
    };
    auto pass_turn = [&](bool last) {
      if (PINGPONG && (cw != NWG - 1 || !last)) named_arrive(next_turn, 256);
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
      float alpha[MB][2];
      softmax(0, alpha);  // alpha is 0 and acc is 0: nothing to rescale
      pack_p();
    }
    // Tile j's p.v and tile j + 1's q.k^T are issued together; the softmax
    // of tile j + 1 runs while p.v of tile j is in flight (p of tile j + 1
    // is packed only after that p.v has read pa: the wait<0> below). No
    // wgmma is issued under a condition: ptxas serialises wgmma on a
    // divergent path.
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
      float alpha[MB][2];
      softmax(j + 1, alpha);
      wgmma_wait<0>();  // p.v of tile j is done: acc and pa are free
      fence_all();
#pragma unroll
      for (int mb = 0; mb < MB; ++mb)
#pragma unroll
        for (int i = 0; i < NPV / 2; ++i) acc[mb][i] *= alpha[mb][(i >> 1) & 1];
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
        float l;
        if constexpr (SUMCOL) {  // column SUM_DIM: lane 4g's, t = 0
          l = __shfl_sync(0xffffffffu, acc[mb][4 * (SUM_DIM / 8) + 2 * r], lane & ~3);
        } else {
          l = l_run[mb][r];
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

template <int DP, bool SUMCOL>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int Sq,
           int Skv, int D, float scale, cudaStream_t stream) {
  const size_t bytes = smem_bytes(DP);
  static bool attr_set = false;  // once per kernel instance, not per launch
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<DP, SUMCOL>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)bytes);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  CUtensorMap tq, tk, tv;
  if (!(tensor_map_bshd_slabs(&tq, q, B, Sq, H, D, q_rows(DP)) &&
        tensor_map_bshd_slabs(&tk, k, B, Skv, H, D, kv_rows(DP)) &&
        tensor_map_bshd_slabs(&tv, v, B, Skv, H, D, kv_rows(DP))))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((Sq + q_rows(DP) - 1) / q_rows(DP), B * H);
  flash_fwd_wgmma_kernel<DP, SUMCOL><<<grid, n_threads(DP), bytes, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)o, H, Sq, Skv, D, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_dp(const void* q, const void* k, const void* v, void* o, int B, int H, int Sq,
              int Skv, int D, float scale, cudaStream_t stream) {
  if constexpr (sums_on_tc(DP))
    if (D == DP - 8) return launch<DP, true>(q, k, v, o, B, H, Sq, Skv, D, scale, stream);
  return launch<DP, false>(q, k, v, o, B, H, Sq, Skv, D, scale, stream);
}

}  // namespace

// q: (B, Sq, H, D); k, v: (B, Skv, H, D); o: (B, Sq, H, D); all bf16,
// contiguous, as they lie; D % 8 == 0, D <= 160. Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue when the arguments or the tensor
// maps are refused).
extern "C" int tclight_flash_attention_bf16(const void* q, const void* k,
                                            const void* v, void* o, int B,
                                            int H, int Sq, int Skv, int D,
                                            float scale, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0 || D <= 0 || D % 8 != 0 ||
      D > MAX_D || (long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch ((D + 15) / 16 * 16) {
    case 16: return launch_dp<16>(q, k, v, o, B, H, Sq, Skv, D, scale, s);
    case 32: return launch_dp<32>(q, k, v, o, B, H, Sq, Skv, D, scale, s);
    case 48: return launch_dp<48>(q, k, v, o, B, H, Sq, Skv, D, scale, s);
    case 64: return launch_dp<64>(q, k, v, o, B, H, Sq, Skv, D, scale, s);
    case 80: return launch_dp<80>(q, k, v, o, B, H, Sq, Skv, D, scale, s);
    case 96: return launch_dp<96>(q, k, v, o, B, H, Sq, Skv, D, scale, s);
    case 112: return launch_dp<112>(q, k, v, o, B, H, Sq, Skv, D, scale, s);
    case 128: return launch_dp<128>(q, k, v, o, B, H, Sq, Skv, D, scale, s);
    case 144: return launch_dp<144>(q, k, v, o, B, H, Sq, Skv, D, scale, s);
    default: return launch_dp<160>(q, k, v, o, B, H, Sq, Skv, D, scale, s);
  }
}
