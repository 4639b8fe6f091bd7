// K2: fused matmul + running (max, first argmax) for ToMe matching, for
// Hopper (sm_90a), bf16 in.
//
// Replaces the TPU kernel tclight_tpu/ops/match_kernel.py `_kernel`
// (pallas_call at :96, via `online_argmax_scores`, called from
// tclight_tpu/ops/tome.py:217). Same function: for every src row s,
// node_max[s] = max over (b, d) of a[b, s] . bt[b, d] and node_idx[s] =
// b * D + d of the first maximiser in b-major order.
//
// What bounds it on the H100: tensor-core operations. At the level-0
// global merge (B=2, S=D=23,760, C=320) the products are 2*B*S*D*C ~ 0.72
// TFLOP (0.73 ms at the bf16 peak) against ~30 MB of inputs. A plain
// matmul + max would write and read back a (B, S, D) score tensor (~4.5 GB
// in f32); this kernel never writes a score to device memory. What it must
// feed the tensor cores from L2 is the dst stream: every src tile reads all
// B * D dst rows.
//
// Design (a persistent, warp-specialised GEMM whose epilogue is a fold):
// - Work. A tile is (src tile of BS rows, batch b, 128-row dst tile of
//   b). The tiles, src tile slowest and dst tile fastest, are cut into one
//   contiguous range a CTA (`match_plan` in ops/match_kernel.py mirrors
//   the cut), so the busiest range holds an even share rounded up and a
//   CTA loads a src tile only where its range enters a new (src tile,
//   batch): one to four times a call at the paths' shapes. (Clusters of
//   two CTAs with different src tiles sharing each dst stage by TMA
//   multicast measured 1.5-2.2x slower: the two wait on each other's
//   releases.)
// - One CTA of three warpgroups. Warpgroup 0 is the producer: one thread
//   loads the CTA's src tile by TMA, one barrier a 64-channel slab so that
//   the first products start on the first slab, where it stays while the
//   range stays in its (src tile, batch); and streams dst stages of 128
//   rows x 64 channels through a ring of full / empty mbarriers (one empty
//   arrive per consumer warp). It gives up registers (setmaxnreg 24) to
//   the two consumer warpgroups (240 each).
// - Each consumer warpgroup runs its products on wgmma (bf16 in, f32
//   accumulation), both operands in shared memory, into two accumulators,
//   one commit group each per stage: up to 384 channels (C = 320, level 0)
//   it owns two 64-row src blocks (BS = 256) and an accumulator is one
//   block against the 128 dst rows (m64n128k16); above (C = 640, level 1,
//   BS = 128, where the resident tile leaves room for few stages) it owns
//   one block and an accumulator is the block against 64 of the 128 dst
//   rows (m64n64k16). A stage is released when the next stage's products
//   have been issued and its own have read it (wgmma.wait_group 2).
// - The fold overlaps the products. Accumulator 0 folds while accumulator
//   1's last products run; accumulator 1 folds while the next tile's first
//   products (stage 0 into accumulator 0) run, issued at the end of the
//   tile before, and awaited there: no product is in flight from one
//   iteration of the tile loop to the next, where ptxas would serialise
//   every wgmma (C7514). The kernel is a template of the depth in slabs
//   (NKC), so each tile's products are straight-line code.
// - The fold keeps the dense path's rule at ~1 instruction a score: a
//   row's tile max by fmaxf (two chains, then the 4 lanes of the row); its
//   lowest column is searched (2 instructions a score) only where a row of
//   the warp beats its running max, and the running value changes only on
//   a strictly greater score, so the first maximiser wins; dst rows past D
//   (zero-filled by TMA) are -inf, masked in the last dst tile only. The
//   range's rows end each (src tile, batch) by merging their (max, index)
//   into a 64-bit key per src row with atomicMax: the order-preserving
//   bits of the max (-0.0 made +0.0, as the dense argmax treats them as
//   equal) in the high word, ~(b * D + d) in the low word, so a larger max
//   wins and, on equal maxima, the lower b-major index. The merge is exact
//   and the order of the merges does not matter. A second, tiny kernel
//   unpacks the keys into node_max / node_idx.
// - Layout. a (B, S, C) and bt (B, D, C) are read in place through 4-d
//   tensor maps (C, 1, rows, B), boxes of 64 channels (one 128-byte row) x
//   a tile's rows in the 128-byte swizzle that wgmma reads directly
//   (`tensor_map_bshd_slabs`, `wgmma_desc_sw128` in hopper.cuh), ceil(C /
//   64) boxes a row, at least two; channels past C, rows past S or D read
//   as zeros. The wrapper makes no copy. (The layout before read 16-byte
//   boxes, 8 channels x a tile's rows, from chunk-major copies that the
//   wrapper made on every call, and the dst stream through them bound it.)
//
// Shared memory per CTA: BS * 64 * NKC * 2 bytes of src tile, 16 KB a
// stage, the barriers, 1,024 of alignment: 230,512 bytes at C = 320 and
// 230,552 at 640 (4 stages).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "hopper.cuh"

using namespace tclight::hopper;

namespace {

constexpr int NTHREADS = 384;
constexpr int BN = 128;   // dst rows of a tile
constexpr int SLAB = 64;  // channels of a stage and of a TMA box: one 128-byte swizzle row
constexpr int MAX_C = 768;
constexpr int MAX_STAGES = 8;
constexpr size_t SMEM_LIMIT = 232448;  // per CTA on the H100
constexpr size_t STAGE_BYTES = (size_t)BN * SLAB * 2;

// The geometry, by the depth in 64-channel slabs nkc = ceil(C / 64), at least 2
// 64-row src blocks per consumer warpgroup: two up to 6 slabs (384
// channels), one above
__host__ __device__ constexpr int row_blocks(int nkc) { return nkc <= 6 ? 2 : 1; }
__host__ __device__ constexpr size_t src_bytes(int mb, int nkc) {
  return (size_t)128 * mb * nkc * SLAB * 2;
}

__host__ __device__ constexpr size_t smem_bytes(int mb, int nkc, int nst) {
  return 1024 + src_bytes(mb, nkc) + nst * STAGE_BYTES + 8 * (nkc + 1 + 2 * nst);
}

// as many stages as fit beside the resident src tile, at most MAX_STAGES
__host__ __device__ constexpr int n_stages(int mb, int nkc) {
  int n = MAX_STAGES;
  while (n > 2 && smem_bytes(mb, nkc, n) > SMEM_LIMIT) --n;
  return n;
}

// order-preserving unsigned image of a float: a < b iff key(a) < key(b),
// and -0.0 and +0.0 map to the same key
__device__ __forceinline__ unsigned long long pack_key(float m, int idx) {
  uint32_t u = __float_as_uint(m == 0.f ? 0.f : m);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (unsigned long long)(~(uint32_t)idx);
}

template <int NKC>
__global__ void __launch_bounds__(NTHREADS, 1)
match_argmax_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                          const __grid_constant__ CUtensorMap tb,
                          unsigned long long* __restrict__ keys, int B, int S, int D, int n_dt,
                          int n_tiles, int per) {
  constexpr int MB = row_blocks(NKC);
  constexpr int NST = n_stages(MB, NKC);
  constexpr int BS = 128 * MB;  // src rows of a CTA
  constexpr int BW = BN * MB / 2;  // dst rows of one accumulator: 128, or 64 at MB = 1
  constexpr int J1_ROW = BN - BW;  // accumulator 1's first dst row in a tile
  extern __shared__ unsigned char smem_raw[];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __nv_bfloat16* sB = sA + (size_t)BS * NKC * SLAB;  // NST stages of BN x SLAB
  uint64_t* a_full = reinterpret_cast<uint64_t*>(sB + (size_t)NST * BN * SLAB);  // one a slab
  uint64_t* a_empty = a_full + NKC;
  uint64_t* full = a_empty + 1;
  uint64_t* empty = full + NST;

  const int w0 = blockIdx.x * per;  // this CTA's tiles: [w0, w1)
  const int w1 = min(w0 + per, n_tiles);
  // warp-uniform as far as the compiler can see: wgmma on a path it
  // cannot prove uniform is serialised
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    for (int kc = 0; kc < NKC; ++kc) mbar_init(&a_full[kc], 1);
    mbar_init(a_empty, 2 * 4);  // one arrive per consumer warp
    for (int s = 0; s < NST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------------------------------------------------- producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      int it = 0;  // stages loaded by this CTA
      int k = 0;   // src tiles loaded
      for (int w = w0; w < w1; ++w) {
        const int dt = w % n_dt;
        const int b = (w / n_dt) % B;
        if (w == w0 || dt == 0) {  // the range enters a (src tile, batch)
          if (k > 0) mbar_wait(a_empty, (k - 1) & 1);
          const int row0 = w / n_dt / B * BS;
          for (int kc = 0; kc < NKC; ++kc) {
            mbar_expect_tx(&a_full[kc], (uint32_t)(BS * SLAB * 2));
            tma_load_4d(sA + (size_t)kc * BS * SLAB, &ta, &a_full[kc], kc * SLAB, 0, row0, b);
          }
          ++k;
        }
        for (int kc = 0; kc < NKC; ++kc, ++it) {
          const int s = it % NST;
          if (it >= NST) mbar_wait(&empty[s], ((it / NST) - 1) & 1);
          mbar_expect_tx(&full[s], (uint32_t)STAGE_BYTES);
          tma_load_4d(sB + (size_t)s * BN * SLAB, &tb, &full[s], kc * SLAB, 0, dt * BN, b);
        }
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    setmaxnreg_inc<240>();
    const int cw = wg - 1;  // which MB * 64 src rows
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int g = lane >> 2;
    const int t4 = lane & 3;
    constexpr std::integral_constant<int, 0> J0{};
    constexpr std::integral_constant<int, 1> J1{};

    float acc[2][BW / 2];
    float run_max[MB][2];
    int run_idx[MB][2];
    auto reset = [&]() {
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) {
        run_max[mb][0] = run_max[mb][1] = -INFINITY;
        run_idx[mb][0] = run_idx[mb][1] = 0;
      }
    };
    auto fence_acc = [&]() {
      fence_regs(acc[0]);
      fence_regs(acc[1]);
    };
    // the products of accumulator J on one 64-channel stage: 4 steps of
    // depth 16, both operands K-major in the 128-byte swizzle; its src
    // block starts 8 KB (64 rows) on per block in the tile's slab kc, its
    // dst rows (MB = 1: 64 J on) 8 KB on per 64 rows in the stage
    auto issue = [&](auto jc, int s, int kc) {
      constexpr int J = decltype(jc)::value;
      const __nv_bfloat16* tA =
          sA + ((size_t)kc * BS + (cw * MB + (MB == 2 ? J : 0)) * 64) * SLAB;
      const __nv_bfloat16* tB = sB + ((size_t)s * BN + (MB == 1 ? J * 64 : 0)) * SLAB;
#pragma unroll
      for (int kk = 0; kk < SLAB / 16; ++kk)
        WgmmaSS<BW>::run(acc[J], wgmma_desc_sw128(tA + kk * 16, 16, 1024),
                         wgmma_desc_sw128(tB + kk * 16, 16, 1024), (kc | kk) ? 1 : 0);
      wgmma_commit();
    };
    auto release = [&](int it) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[it % NST]);
    };
    // fold accumulator J, whose column 0 is dst row d0, into the running
    // (max, index) of its rows: g and g + 8 of the warp's 16 in src block
    // R; element i is column 8 (i / 4) + 2 t4 + (i & 1) of row (i / 2) & 1
    auto fold = [&](auto jc, int d0) {
      constexpr int J = decltype(jc)::value;
      constexpr int R = MB == 2 ? J : 0;
      if (d0 + BW > D) {
#pragma unroll
        for (int i = 0; i < BW / 2; ++i)
          if (d0 + (i >> 2) * 8 + 2 * t4 + (i & 1) >= D) acc[J][i] = -INFINITY;
      }
      float tmax[2];
      bool up = false;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float m0 = acc[J][2 * r], m1 = acc[J][2 * r + 1];
#pragma unroll
        for (int j = 1; j < BW / 8; ++j) {
          m0 = fmaxf(m0, acc[J][4 * j + 2 * r]);
          m1 = fmaxf(m1, acc[J][4 * j + 2 * r + 1]);
        }
        float m = fmaxf(m0, m1);
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));  // the 4 lanes of a row
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        tmax[r] = m;
        up |= m > run_max[R][r];
      }
      if (__any_sync(0xffffffffu, up)) {  // the lowest column of the tile max
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          int col = BW;
#pragma unroll
          for (int j = BW / 8 - 1; j >= 0; --j)
#pragma unroll
            for (int e = 1; e >= 0; --e)
              if (acc[J][4 * j + 2 * r + e] == tmax[r]) col = 8 * j + 2 * t4 + e;
          col = min(col, __shfl_xor_sync(0xffffffffu, col, 1));
          col = min(col, __shfl_xor_sync(0xffffffffu, col, 2));
          if (tmax[r] > run_max[R][r]) {  // strictly greater: the first one wins
            run_max[R][r] = tmax[r];
            run_idx[R][r] = d0 + col;
          }
        }
      }
    };

    // The tile loop carries no product in flight from one iteration to
    // the next (ptxas serialises every wgmma where one is, C7514): a tile's
    // first products into accumulator 0 are issued at the end of the
    // iteration before, the tile before's accumulator 1 folds under them,
    // and they are awaited there. The slab loop is unrolled (NKC is a
    // template argument), so the last products before each wait are known.
    int it = 0, k = 0;  // stages and src tiles consumed
    auto stage_wait = [&](int kc) {
      mbar_wait(&full[it % NST], (it / NST) & 1);
      mbar_wait(&a_full[kc], k & 1);
    };
    // a tile's first products: stage 0 into accumulator 0
    auto first = [&]() {
      stage_wait(0);
      fence_acc();
      wgmma_fence();
      issue(J0, it % NST, 0);
    };
    // the rest of the tile's products (dst rows d0 on), then accumulator
    // 0's fold under accumulator 1's last products
    auto rest = [&](int d0) {
      fence_acc();
      wgmma_fence();
      issue(J1, it % NST, 0);
      ++it;
#pragma unroll
      for (int kc = 1; kc < NKC; ++kc, ++it) {
        stage_wait(kc);
        fence_acc();
        wgmma_fence();
        issue(J0, it % NST, kc);
        issue(J1, it % NST, kc);
        wgmma_wait<2>();  // the stage before's products are done
        fence_acc();
        release(it - 1);
      }
      wgmma_wait<1>();  // accumulator 0 folds under accumulator 1's last products
      fence_acc();
      fold(J0, d0);
    };

    reset();
    for (int w = w0; w < w1;) {
      // the range's tiles [w, we) of one (src tile, batch): the src tile
      // stays; each tile's accumulator 1 folds under the next one's first
      // products, the last one's after its own
      const int we = min(w1, (w / n_dt + 1) * n_dt);
      first();
      for (int t = w; t + 1 < we; ++t) {
        rest(t % n_dt * BN);
        first();  // tile t + 1's first products, under which accumulator 1 folds
        wgmma_wait<1>();
        fence_acc();
        release(it - 1);
        fold(J1, t % n_dt * BN + J1_ROW);
        wgmma_wait<0>();  // nothing in flight from one tile to the next
        fence_acc();
      }
      rest((we - 1) % n_dt * BN);
      wgmma_wait<0>();
      fence_acc();
      release(it - 1);
      fold(J1, (we - 1) % n_dt * BN + J1_ROW);
      // every product of this src tile has read it
      __syncwarp();
      if (lane == 0) mbar_arrive(a_empty);
      if (t4 == 0) {
        const int b = (w / n_dt) % B;
        const int row0 = w / n_dt / B * BS + cw * MB * 64 + warp * 16 + g;
#pragma unroll
        for (int mb = 0; mb < MB; ++mb)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = row0 + mb * 64 + 8 * r;
            if (row < S) atomicMax(keys + row, pack_key(run_max[mb][r], b * D + run_idx[mb][r]));
          }
      }
      reset();
      ++k;
      w = we;
    }
  }
}

__global__ void match_argmax_unpack_kernel(const unsigned long long* __restrict__ keys,
                                           float* __restrict__ node_max,
                                           int* __restrict__ node_idx, int S) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= S) return;
  const unsigned long long key = keys[i];
  const uint32_t hi = (uint32_t)(key >> 32);
  node_max[i] = __uint_as_float((hi & 0x80000000u) ? (hi & 0x7fffffffu) : ~hi);
  node_idx[i] = (int)~(uint32_t)key;
}

template <int NKC>
cudaError_t set_smem_attr() {
  static bool attr_set = false;  // once per kernel instance
  if (attr_set) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(match_argmax_wgmma_kernel<NKC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)SMEM_LIMIT);
  attr_set = err == cudaSuccess;
  return err;
}

template <int NKC>
constexpr size_t kernel_smem() {
  return smem_bytes(row_blocks(NKC), NKC, n_stages(row_blocks(NKC), NKC));
}

template <int NKC>
int launch(const void* a, const void* bt, void* keys, void* node_max, void* node_idx, int B,
           int S, int D, int C, int grid, cudaStream_t stream) {
  cudaError_t err = set_smem_attr<NKC>();
  if (err != cudaSuccess) return (int)err;
  const int bs = 128 * row_blocks(NKC);
  const int n_dt = (D + BN - 1) / BN;
  const long n_tiles = (long)((S + bs - 1) / bs) * B * n_dt;
  if (n_tiles >= (1L << 31)) return (int)cudaErrorInvalidValue;
  // one contiguous range of tiles a CTA, the ranges even to a tile
  int ctas = (int)std::min<long>(grid, n_tiles);
  const int per = (int)((n_tiles + ctas - 1) / ctas);
  ctas = (int)((n_tiles + per - 1) / per);
  CUtensorMap ta, tb;
  if (!tensor_map_bshd_slabs(&ta, a, B, S, 1, C, bs) ||
      !tensor_map_bshd_slabs(&tb, bt, B, D, 1, C, BN))
    return (int)cudaErrorInvalidValue;
  err = cudaMemsetAsync(keys, 0, (size_t)S * 8, stream);
  if (err != cudaSuccess) return (int)err;
  match_argmax_wgmma_kernel<NKC><<<ctas, NTHREADS, kernel_smem<NKC>(), stream>>>(
      ta, tb, (unsigned long long*)keys, B, S, D, n_dt, (int)n_tiles, per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  match_argmax_unpack_kernel<<<(S + 255) / 256, 256, 0, stream>>>(
      (const unsigned long long*)keys, (float*)node_max, (int*)node_idx, S);
  return (int)cudaGetLastError();
}

// the depth in slabs of channel count C: at least two, C <= 64 reading a
// second slab of zeros (ptxas serialises the one-slab kernel's products,
// C7514)
int depth_slabs(int C) { return std::max((C + SLAB - 1) / SLAB, 2); }

// the kernel instance of nkc slabs (2-12: C up to 768)
template <int NKC = 12>
int launch_nkc(int nkc, const void* a, const void* bt, void* keys, void* node_max,
               void* node_idx, int B, int S, int D, int C, int grid, cudaStream_t stream) {
  if (nkc == NKC)
    return launch<NKC>(a, bt, keys, node_max, node_idx, B, S, D, C, grid, stream);
  if constexpr (NKC > 2)
    return launch_nkc<NKC - 1>(nkc, a, bt, keys, node_max, node_idx, B, S, D, C, grid, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// a (B, S, C) and bt (B, D, C), bf16, contiguous, 16-byte aligned, read as
// they lie; keys: (S,) 64-bit scratch; node_max: (S,) f32, node_idx: (S,)
// i32. At most `grid` CTAs run (at least one; one an SM fills the card:
// its shared memory holds one), each one contiguous range of the tiles.
// Returns cudaGetLastError() after the launches (cudaErrorInvalidValue
// when the arguments or the tensor maps are refused).
extern "C" int tclight_match_argmax_bf16(const void* a, const void* bt, void* keys,
                                         void* node_max, void* node_idx, int B, int S, int D,
                                         int C, int grid, void* stream) {
  if (B <= 0 || S <= 0 || D <= 0 || C <= 0 || C % 8 != 0 || C > MAX_C || grid <= 0 ||
      (long)B * D >= (1L << 31))
    return (int)cudaErrorInvalidValue;
  return launch_nkc(depth_slabs(C), a, bt, keys, node_max, node_idx, B, S, D, C, grid,
                    (cudaStream_t)stream);
}
