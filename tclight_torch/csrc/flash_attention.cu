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
//
// Design (the FlashAttention-3 shape):
// - One block of three warpgroups per (q tile, batch * head). Warpgroup 0
//   is the producer: one thread issues the TMA loads of the q tile (once)
//   and of the k and v tiles into a ring of NST stages, with full / empty
//   mbarriers (one empty arrive per consumer warp). It gives up registers
//   (setmaxnreg 24) to the two consumer warpgroups (240 each).
// - Each consumer warpgroup owns MB blocks of 64 q rows: two up to DP = 96
//   (q tiles of 256 rows, k/v tiles of 64 keys, 4 stages), one above (128
//   rows, 128 keys, 3 stages up to DP = 128, else 2). S = q k^T is a chain
//   of wgmma.m64nBKk16 per row block with both operands in shared memory;
//   the softmax runs on the S registers; p is packed to bf16 in registers
//   as the A operand of O += p v (wgmma.m64nDPk16, V MN-major from shared
//   memory). Two row blocks halve the k/v tiles streamed per q row and
//   interleave two independent wgmma chains.
// - Overlap. Within a warpgroup, tile j's p.v and tile j + 1's q.k^T are
//   issued together, and the softmax of tile j + 1 runs while that p.v is
//   in flight. Across the two warpgroups, a ping-pong on two named
//   barriers makes them take turns to issue their products, so that one's
//   softmax runs while the other's products do. No wgmma is issued on a
//   path ptxas cannot prove warp-uniform: it would serialise them all
//   (warning C7520).
// - Softmax. For scale > 0 the row max is taken on the raw scores and the
//   scale folds into the exponent's argument, one FMA a score; the kv
//   tail is masked to -inf in a pass of its own, in the last tile only.
// - Layout. wgmma reads the non-swizzled operand layout (see hopper.cuh),
//   which takes any multiple of 8 head dims: D = 40 rows are 80 bytes, no
//   swizzle width, so no swizzled layout fits them without a padded copy.
//   q is read in place from (B, S, H, D) through a 4-d tensor map
//   (D, H, S, B), one box of 8 dims x the tile's rows per 16-byte chunk,
//   once a block. k and v are streamed for every q tile, so the wrapper
//   makes chunk-major copies of them, (B * H, D / 8, S, 8): a whole tile is
//   then one TMA box of contiguous runs, laid out [chunk][token][8] as
//   wgmma reads it. Read in place, the same tile took a 16-byte box per
//   chunk: 16-byte pieces of 80-byte rows 640 bytes apart, each fetching a
//   32-byte sector, and those loads alone set the kernel's time at level
//   0. The copies cost one read and one write of k and v (~0.18 GB at
//   level 0). Chunks past D / 8 (the q.k^T depth is DP = ceil16(D)),
//   tokens past S and q rows past Sq lie outside the tensor maps, and TMA
//   fills them with zeros: no padded copy, nothing of the next head read.
//
// - Head dim 128 (the Cosmos DiTs' self-attention) has a layout of its own
//   (SW = true). There the chunk-major tiles cost more than they saved: a
//   box 16 bytes wide moves a 32 KB tile as 2,048 rows of 16 bytes, and
//   with the k/v loads taken out the kernel ran 2.5x faster (PERF.md, the
//   head-dim-128 ablation). A 256-byte row is two 128-byte swizzle rows, so
//   q, k and v are read in place from (B, S, H, D), each tile as two boxes
//   of 64 dims (128 bytes) x its rows, in the 128-byte swizzle that wgmma
//   reads directly (hopper.cuh): K-major q and k for q.k^T, MN-major v for
//   p.v; the wrapper makes no copy. One 64-row q block per consumer
//   warpgroup, 128-key tiles, 3 stages: 176- or 192-key tiles in 2 stages
//   and 128 in 2 were slower. Every other head dim, the UNet's 40 / 80 /
//   160 and the 120 next to 128 included, keeps the chunk-major layout.
//
// Shared memory per block: (q rows + 2 * NST * kv rows) * DP * 2 bytes,
// 204,800 at D = 160 and 73,728 at D = 40; 229,376 (+ barriers and the
// 1,024-byte alignment) at D = 128.

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

// 64-row blocks of q per consumer warpgroup: two up to DP = 96, where their
// registers fit (two score tiles, two accumulators), one above. Two halve
// the k/v tiles streamed per q row and give each warpgroup two independent
// chains of wgmma to interleave.
__host__ __device__ constexpr int row_blocks(int dp) { return dp <= 96 ? 2 : 1; }
__host__ __device__ constexpr int q_rows(int dp) { return 128 * row_blocks(dp); }
__host__ __device__ constexpr int kv_rows(int dp) { return row_blocks(dp) == 2 ? 64 : 128; }
__host__ __device__ constexpr int n_stages(int dp) {
  return row_blocks(dp) == 2 ? 4 : (dp <= 128 ? 3 : 2);
}

__host__ __device__ constexpr size_t smem_bytes(int dp) {
  return (size_t)(q_rows(dp) + 2 * n_stages(dp) * kv_rows(dp)) * dp * 2 +
         8 * (1 + 2 * n_stages(dp)) + 128;
}

// D = 128 reads q, k and v in place in the 128-byte swizzle: 128 q rows (one
// 64-row block per consumer warpgroup), SW_BK-key tiles in a ring of SW_NST
// stages; tiles aligned to 1,024 bytes
constexpr int SW_D = 128;
constexpr int SW_BQ = 128;
constexpr int SW_BK = 128;
constexpr int SW_NST = 3;
constexpr size_t SW_SMEM = (size_t)(SW_BQ + 2 * SW_NST * SW_BK) * SW_D * 2 +
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

template <int DP, bool SW>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       __nv_bfloat16* __restrict__ o, int H, int Sq, int Skv, int D,
                       float scale_log2) {
  static_assert(!SW || DP == SW_D, "the swizzled path is D = 128's");
  constexpr int MB = SW ? 1 : row_blocks(DP);
  constexpr int BQ = SW ? SW_BQ : q_rows(DP);
  constexpr int BK = SW ? SW_BK : kv_rows(DP);
  constexpr int BOX = SW ? 64 : 8;  // head dims of one TMA box: a 128-byte slab, or a chunk
  constexpr int NST = SW ? SW_NST : n_stages(DP);
  constexpr int TILE = BK * DP;  // elements of one k or v tile
  constexpr uintptr_t ALIGN = SW ? 1024 : 128;
  extern __shared__ unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + ALIGN - 1) & ~(ALIGN - 1));
  __nv_bfloat16* sK = sQ + BQ * DP;       // NST tiles
  __nv_bfloat16* sV = sK + NST * TILE;    // NST tiles
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
      mbar_init(&empty[s], 2 * 4);  // one arrive per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------------------------------------------------- producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      // k or v tile j into stage st: in place, one box per 64-dim slab, or
      // the chunk-major copy's one box
      auto load_kv = [&](__nv_bfloat16* ring, const CUtensorMap* map, int st, int j) {
        if constexpr (SW) {
          for (int c = 0; c < DP / BOX; ++c)
            tma_load_4d(ring + st * TILE + c * BK * BOX, map, &full[st], c * BOX, h, j * BK, b);
        } else {
          tma_load_4d(ring + st * TILE, map, &full[st], 0, j * BK, 0, blockIdx.y);
        }
      };
      mbar_expect_tx(qbar, BQ * DP * 2);
      for (int c = 0; c < DP / BOX; ++c)
        tma_load_4d(sQ + c * BQ * BOX, &tq, qbar, c * BOX, h, q0, b);
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
    setmaxnreg_inc<240>();
    const int cw = wg - 1;  // which MB * 64 q rows
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int g = lane >> 2;
    const int t = lane & 3;

    float acc[MB][DP / 2];
    float s[MB][BK / 2];
    uint32_t pa[MB][BK / 16][4];  // p of the tile whose p.v is next or in flight
    float m_run[MB][2], l_run[MB][2];  // l: this thread's share of the row sums
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) {
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) acc[mb][i] = 0.f;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[mb][i] = 0.f;
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

    // S = q k^T of tile j into s: per row block, 64 rows x BK keys in DP /
    // 16 steps of depth 16, both operands K-major in shared memory; the row
    // blocks' independent chains interleave
    auto issue_qk = [&](int j) {
      const __nv_bfloat16* tK = sK + (j % NST) * TILE;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
#pragma unroll
        for (int mb = 0; mb < MB; ++mb) {
          if constexpr (SW) {
            // slab kk / 4 (rows of 128 bytes), 32 bytes a step within it;
            // this warpgroup's 64 q rows start 8 KB into the slab
            WgmmaSS<BK>::run(
                s[mb], wgmma_desc_sw128(sQ + (kk / 4) * BQ * 64 + (cw * MB + mb) * 64 * 64 +
                                            (kk % 4) * 16,
                                        16, 1024),
                wgmma_desc_sw128(tK + (kk / 4) * BK * 64 + (kk % 4) * 16, 16, 1024),
                kk > 0 ? 1 : 0);
          } else {
            WgmmaSS<BK>::run(s[mb],
                             wgmma_desc(sQ + (cw * MB + mb) * 64 * 8 + kk * 2 * BQ * 8, BQ * 16,
                                        128),
                             wgmma_desc(tK + kk * 2 * BK * 8, BK * 16, 128), kk > 0 ? 1 : 0);
          }
        }
      wgmma_commit();
    };
    // O += p v of tile j: v MN-major. Chunk-major: next 8 keys 128 bytes
    // on, next 8 dims BK * 16. Swizzled: 16 keys a step (2 KB), next 8 keys
    // 1,024 bytes on, next 64 dims one slab (BK * 128 bytes) on.
    auto issue_pv = [&](int j) {
      const __nv_bfloat16* tV = sV + (j % NST) * TILE;
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
    // online softmax of tile j in s: the exponentials in place, the row
    // maxima and sums updated, each row's rescale of the accumulator in
    // alpha. This thread holds rows g (s[4n], s[4n+1]) and g + 8 (s[4n+2],
    // s[4n+3]) of its warp's 16 of each row block, keys 8n + 2t, 8n + 2t + 1.
    // Keys past Skv (only in the last tile) are masked to -inf before the
    // row max. For scale > 0 the max is taken on the raw scores and the
    // scale folds into the exponent's argument, one FMA a score:
    // exp2(s * c - m * c) with m = max(s); the maxima are kept scaled.
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
        float tmax[2] = {-INFINITY, -INFINITY};
        if (fold) {
#pragma unroll
          for (int i = 0; i < BK / 2; ++i)
            tmax[(i >> 1) & 1] = fmaxf(tmax[(i >> 1) & 1], s[mb][i]);
        } else {
#pragma unroll
          for (int i = 0; i < BK / 2; ++i) {
            s[mb][i] *= scale_log2;
            tmax[(i >> 1) & 1] = fmaxf(tmax[(i >> 1) & 1], s[mb][i]);
          }
        }
        float neg_m[2];  // -(the new running max), in the exponent's units
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
          tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
          if (fold) tmax[r] *= scale_log2;
          const float m_new = fmaxf(m_run[mb][r], tmax[r]);  // finite: a tile has a valid key
          alpha[mb][r] = fast_exp2(m_run[mb][r] - m_new);
          m_run[mb][r] = m_new;
          neg_m[r] = -m_new;
        }
        const float c = fold ? scale_log2 : 1.f;
        float rsum[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          s[mb][i] = fast_exp2(fmaf(s[mb][i], c, neg_m[(i >> 1) & 1]));
          rsum[(i >> 1) & 1] += s[mb][i];
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
        for (int kk = 0; kk < BK / 16; ++kk) {
          pa[mb][kk][0] = pack_bf16(s[mb][8 * kk + 0], s[mb][8 * kk + 1]);
          pa[mb][kk][1] = pack_bf16(s[mb][8 * kk + 2], s[mb][8 * kk + 3]);
          pa[mb][kk][2] = pack_bf16(s[mb][8 * kk + 4], s[mb][8 * kk + 5]);
          pa[mb][kk][3] = pack_bf16(s[mb][8 * kk + 6], s[mb][8 * kk + 7]);
        }
    };

    // The two consumer warpgroups take turns to issue their products
    // (named barriers 1 and 2, 256 threads: one's sync meets the other's
    // arrive), so that one's softmax runs while the other's products do.
    // The second warpgroup lets the first go first, and leaves out its
    // last arrive, which no sync would meet.
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
    // Tile j's p.v and tile j + 1's q.k^T are issued together; the softmax
    // of tile j + 1 runs while p.v of tile j is in flight (p of tile j + 1
    // is packed only after that p.v has read pa: the wait<0> below). No
    // wgmma is issued under a condition: ptxas serialises wgmma on a
    // divergent path.
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

// q (B, S, H, D) as it lies, as 4-d (D, H, S, B): boxes of 8 dims x BQ
// tokens of one head, one per 16-byte chunk of the q tile (loaded once a
// block); everything outside reads as zeros
bool make_q_map(CUtensorMap* map, const void* q, int B, int S, int H, int D, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)S * H * D * 2};
  const cuuint32_t box[4] = {8, 1, (cuuint32_t)rows, 1};
  return tensor_map_4d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, q, dims, strides, box);
}

// k or v as the wrapper's chunk-major copy (B * H, D / 8, S, 8), as 4-d
// (8, S, D / 8, B * H): one box of 8 x BK tokens x DP / 8 chunks is a whole
// tile, laid out [chunk][token][8]; chunks past D / 8 and tokens past S
// read as zeros
bool make_kv_map(CUtensorMap* map, const void* kv, int BH, int S, int D, int DP, int rows) {
  const cuuint64_t dims[4] = {8, (cuuint64_t)S, (cuuint64_t)(D / 8), (cuuint64_t)BH};
  const cuuint64_t strides[3] = {16, (cuuint64_t)S * 16, (cuuint64_t)S * 16 * (D / 8)};
  const cuuint32_t box[4] = {8, (cuuint32_t)rows, (cuuint32_t)(DP / 8), 1};
  return tensor_map_4d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, kv, dims, strides, box);
}

template <int DP, bool SW>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int Sq,
           int Skv, int D, float scale, cudaStream_t stream) {
  const size_t bytes = SW ? SW_SMEM : smem_bytes(DP);
  static bool attr_set = false;  // once per kernel instance, not per launch
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<DP, SW>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)bytes);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  CUtensorMap tq, tk, tv;
  bool mapped;
  if constexpr (SW)
    mapped = tensor_map_bshd_sw128(&tq, q, B, Sq, H, SW_BQ) &&
             tensor_map_bshd_sw128(&tk, k, B, Skv, H, SW_BK) &&
             tensor_map_bshd_sw128(&tv, v, B, Skv, H, SW_BK);
  else
    mapped = make_q_map(&tq, q, B, Sq, H, D, q_rows(DP)) &&
             make_kv_map(&tk, k, B * H, Skv, D, DP, kv_rows(DP)) &&
             make_kv_map(&tv, v, B * H, Skv, D, DP, kv_rows(DP));
  if (!mapped) return (int)cudaErrorInvalidValue;
  const int bq = SW ? SW_BQ : q_rows(DP);
  const dim3 grid((Sq + bq - 1) / bq, B * H);
  flash_fwd_wgmma_kernel<DP, SW><<<grid, NTHREADS, bytes, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)o, H, Sq, Skv, D, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (B, Sq, H, D); k, v: for D = 128 (B, Skv, H, D) as they lie, for
// every other D the chunk-major copies (B * H, D / 8, Skv, 8); o: (B, Sq,
// H, D); all bf16, contiguous, 16-byte aligned; D % 8 == 0, D <= 160.
// Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue when the
// arguments or the tensor maps are refused).
extern "C" int tclight_flash_attention_bf16(const void* q, const void* k,
                                            const void* v, void* o, int B,
                                            int H, int Sq, int Skv, int D,
                                            float scale, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0 || D <= 0 || D % 8 != 0 ||
      D > MAX_D || (long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (D == SW_D) return launch<SW_D, true>(q, k, v, o, B, H, Sq, Skv, D, scale, s);
  switch ((D + 15) / 16 * 16) {
    case 16: return launch<16, false>(q, k, v, o, B, H, Sq, Skv, D, scale, s);
    case 32: return launch<32, false>(q, k, v, o, B, H, Sq, Skv, D, scale, s);
    case 48: return launch<48, false>(q, k, v, o, B, H, Sq, Skv, D, scale, s);
    case 64: return launch<64, false>(q, k, v, o, B, H, Sq, Skv, D, scale, s);
    case 80: return launch<80, false>(q, k, v, o, B, H, Sq, Skv, D, scale, s);
    case 96: return launch<96, false>(q, k, v, o, B, H, Sq, Skv, D, scale, s);
    case 112: return launch<112, false>(q, k, v, o, B, H, Sq, Skv, D, scale, s);
    case 128: return launch<128, false>(q, k, v, o, B, H, Sq, Skv, D, scale, s);  // D = 120
    case 144: return launch<144, false>(q, k, v, o, B, H, Sq, Skv, D, scale, s);
    default: return launch<160, false>(q, k, v, o, B, H, Sq, Skv, D, scale, s);
  }
}
