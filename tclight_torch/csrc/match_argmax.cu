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
// in f32); this kernel never writes a score to device memory.
//
// Design (a persistent, warp-specialised GEMM whose epilogue is a fold):
// - Work units are (src tile, batch b, dst chunk): BS src rows of batch b
//   against a chunk of whole 128-row dst tiles of batch b. The wrapper
//   plans the chunks (`match_plan` in ops/match_kernel.py) from (B, S, D,
//   C) and the SM count so that the last wave of units is short; one block
//   per SM walks over the units, src tile fastest, so the blocks that run
//   together stream the same dst chunk through L2.
// - One block of three warpgroups. Warpgroup 0 is the producer: one thread
//   loads a unit's src tile by TMA into shared memory, where it stays for
//   the unit, and streams the chunk's dst tiles in stages of 128 rows x 64
//   channels through a ring of full / empty mbarriers (one empty arrive per
//   consumer warp). It gives up registers (setmaxnreg 24) to the two
//   consumer warpgroups (240 each).
// - Each consumer warpgroup owns MB blocks of 64 src rows: two (BS = 256)
//   up to 384 channels, one (BS = 128) above, where the resident src tile
//   would not leave room for two stages. Its products run on
//   wgmma.m64n128k16 (bf16 in, f32 accumulation), both operands in shared
//   memory, one commit group per 64-channel stage; a stage is released as
//   soon as the next stage's products are issued and it has been read
//   (wgmma.wait_group 1), so the ring streams a tile's depth like a GEMM's
//   K loop at any channel count.
// - The fold keeps the dense path's rule: a tile's max takes the lowest
//   column among equal scores, the running value changes only on a
//   strictly greater score, and dst rows past D (zero-filled by TMA) are
//   -inf, masked in the last dst tile only. A unit ends by merging its rows'
//   (max, index) into a 64-bit key per src row with atomicMax: the order-
//   preserving bits of the max (-0.0 made +0.0, as the dense argmax treats
//   them as equal) in the high word, ~(b * D + d) in the low word, so a
//   larger max wins and, on equal maxima, the lower b-major index. The
//   merge is exact and the order of the units does not matter. A second,
//   tiny kernel unpacks the keys into node_max / node_idx.
// - Layout. wgmma reads the non-swizzled operand layout (see hopper.cuh).
//   The wrapper makes chunk-major copies of a and bt, (B, C / 8, rows, 8),
//   so that a src tile and a dst stage are each one TMA box of contiguous
//   runs laid out [chunk][row][8]; chunks past C / 8 (the depth is padded
//   to a multiple of 64) and rows past S or D lie outside the tensor maps
//   and read as zeros. The copies cost one read and one write of a and bt
//   (~0.12 GB at the global shape).
// - L2 traffic: every src tile streams all B * D dst rows. At the global
//   shape and 256-row src tiles that is 93 x 30.4 MB ~ 2.8 GB per call
//   (half what 128-row tiles would stream), plus 0.2 GB of src tiles.
//
// Shared memory per block: BS * ceil64(C) * 2 bytes of src tile, 16 KB per
// stage, the barriers: 229,376 + 104 bytes at C = 320 (4 stages) and C =
// 640 (4 stages).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

using namespace tclight::hopper;

namespace {

constexpr int NTHREADS = 384;
constexpr int BN = 128;  // dst rows of a tile
constexpr int KC = 64;   // channels of a stage
constexpr int MAX_C = 768;
constexpr int MAX_STAGES = 8;
constexpr size_t SMEM_LIMIT = 232448;  // per block on the H100
constexpr size_t STAGE_BYTES = (size_t)BN * KC * 2;

// 64-row src blocks per consumer warpgroup: two up to 6 stages of depth
// (384 channels), one above
__host__ __device__ constexpr int row_blocks(int nkc) { return nkc <= 6 ? 2 : 1; }

__host__ __device__ constexpr size_t src_bytes(int mb, int nkc) {
  return (size_t)128 * mb * nkc * KC * 2;
}

__host__ __device__ constexpr size_t smem_bytes(int mb, int nkc, int nst) {
  return 128 + src_bytes(mb, nkc) + nst * STAGE_BYTES + 8 * (2 + 2 * nst);
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

template <int MB>
__global__ void __launch_bounds__(NTHREADS, 1)
match_argmax_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                          const __grid_constant__ CUtensorMap tb,
                          unsigned long long* __restrict__ keys, int S, int D, int nkc,
                          int nst, int n_st, int n_dt, int tpc, int nc, int n_units) {
  constexpr int BS = 128 * MB;
  extern __shared__ unsigned char smem_raw[];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  __nv_bfloat16* sB = sA + (size_t)BS * nkc * KC;  // nst stages of BN x KC
  uint64_t* a_full = reinterpret_cast<uint64_t*>(sB + (size_t)nst * BN * KC);
  uint64_t* a_empty = a_full + 1;
  uint64_t* full = a_empty + 1;
  uint64_t* empty = full + nst;

  // warp-uniform as far as the compiler can see: wgmma on a path it
  // cannot prove uniform is serialised
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    mbar_init(a_full, 1);
    mbar_init(a_empty, 2 * 4);  // one arrive per consumer warp
    for (int s = 0; s < nst; ++s) {
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
      int it = 0;  // stages loaded by this block
      int k = 0;   // units of this block
      for (int u = blockIdx.x; u < n_units; u += gridDim.x, ++k) {
        const int st = u % n_st;
        const int c = (u / n_st) % nc;
        const int b = u / n_st / nc;
        if (k > 0) mbar_wait(a_empty, (k - 1) & 1);
        mbar_expect_tx(a_full, (uint32_t)src_bytes(MB, nkc));
        tma_load_4d(sA, &ta, a_full, 0, st * BS, 0, b);
        const int t1 = min(c * tpc + tpc, n_dt);
        for (int t = c * tpc; t < t1; ++t)
          for (int kc = 0; kc < nkc; ++kc, ++it) {
            const int s = it % nst;
            if (it >= nst) mbar_wait(&empty[s], ((it / nst) - 1) & 1);
            mbar_expect_tx(&full[s], (uint32_t)STAGE_BYTES);
            tma_load_4d(sB + (size_t)s * BN * KC, &tb, &full[s], 0, t * BN, kc * 8, b);
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

    float acc[MB][BN / 2];
    auto fence_acc = [&]() {
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) fence_regs(acc[mb]);
    };
    // the products of one 64-channel stage: 4 steps of depth 16; a src
    // block's step ks lies 2 * ks chunks of BS rows into the tile
    auto issue_stage = [&](int s, int kc) {
      const __nv_bfloat16* tB = sB + (size_t)s * BN * KC;
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk)
#pragma unroll
        for (int mb = 0; mb < MB; ++mb)
          WgmmaSS<BN>::run(acc[mb],
                           wgmma_desc(sA + (cw * MB + mb) * 64 * 8 +
                                          (size_t)(kc * 4 + kk) * 2 * BS * 8,
                                      BS * 16, 128),
                           wgmma_desc(tB + kk * 2 * BN * 8, BN * 16, 128), (kc | kk) ? 1 : 0);
      wgmma_commit();
    };
    auto release = [&](int it) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[it % nst]);
    };

    int it = 0, k = 0;
    for (int u = blockIdx.x; u < n_units; u += gridDim.x, ++k) {
      const int st = u % n_st;
      const int c = (u / n_st) % nc;
      const int b = u / n_st / nc;
      float run_max[MB][2];
      int run_idx[MB][2];
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) {
        run_max[mb][0] = run_max[mb][1] = -INFINITY;
        run_idx[mb][0] = run_idx[mb][1] = 0;
      }
      mbar_wait(a_full, k & 1);
      const int t1 = min(c * tpc + tpc, n_dt);
      for (int t = c * tpc; t < t1; ++t) {
        // a tile's depth, stage by stage; no wgmma under a condition
        mbar_wait(&full[it % nst], (it / nst) & 1);
        fence_acc();
        wgmma_fence();
        issue_stage(it % nst, 0);
        ++it;
        for (int kc = 1; kc < nkc; ++kc, ++it) {
          mbar_wait(&full[it % nst], (it / nst) & 1);
          fence_acc();
          wgmma_fence();
          issue_stage(it % nst, kc);
          wgmma_wait<1>();  // the previous stage's products are done
          fence_acc();
          release(it - 1);
        }
        wgmma_wait<0>();
        fence_acc();
        release(it - 1);

        // fold the tile into the running (max, index) of this thread's
        // rows: g and g + 8 of its warp's 16 in each src block; element i
        // of acc is column 8 (i / 4) + 2 t4 + (i & 1) of row half (i / 2) & 1
        const int d0 = t * BN;
        if (d0 + BN > D) {
#pragma unroll
          for (int mb = 0; mb < MB; ++mb)
#pragma unroll
            for (int i = 0; i < BN / 2; ++i)
              if (d0 + (i >> 2) * 8 + 2 * t4 + (i & 1) >= D) acc[mb][i] = -INFINITY;
        }
#pragma unroll
        for (int mb = 0; mb < MB; ++mb)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float best = -INFINITY;
            int col = 0;
#pragma unroll
            for (int j = 0; j < BN / 8; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {  // columns in increasing order
                const float x = acc[mb][4 * j + 2 * r + e];
                if (x > best) {
                  best = x;
                  col = 8 * j + 2 * t4 + e;
                }
              }
#pragma unroll
            for (int off = 1; off <= 2; off <<= 1) {  // the 4 lanes of a row
              const float ob = __shfl_xor_sync(0xffffffffu, best, off);
              const int oc = __shfl_xor_sync(0xffffffffu, col, off);
              if (ob > best || (ob == best && oc < col)) {
                best = ob;
                col = oc;
              }
            }
            if (best > run_max[mb][r]) {  // strictly greater: the first one wins
              run_max[mb][r] = best;
              run_idx[mb][r] = d0 + col;
            }
          }
      }
      // every product of this unit has read the src tile
      __syncwarp();
      if (lane == 0) mbar_arrive(a_empty);
      if (t4 == 0) {
#pragma unroll
        for (int mb = 0; mb < MB; ++mb)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = st * BS + (cw * MB + mb) * 64 + warp * 16 + g + 8 * r;
            if (row < S) atomicMax(keys + row, pack_key(run_max[mb][r], b * D + run_idx[mb][r]));
          }
      }
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

// a or bt as the wrapper's chunk-major copy (B, C / 8, R, 8), as 4-d (8, R,
// C / 8, B): a box of 8 x rows x chunks is one src tile or dst stage, laid
// out [chunk][row][8]; chunks past C / 8 and rows past R read as zeros
bool make_map(CUtensorMap* map, const void* x, int B, int R, int C, int rows, int chunks) {
  const cuuint64_t dims[4] = {8, (cuuint64_t)R, (cuuint64_t)(C / 8), (cuuint64_t)B};
  const cuuint64_t strides[3] = {16, (cuuint64_t)R * 16, (cuuint64_t)R * 16 * (C / 8)};
  const cuuint32_t box[4] = {8, (cuuint32_t)rows, (cuuint32_t)chunks, 1};
  return tensor_map_4d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, dims, strides, box);
}

template <int MB>
int launch(const void* a, const void* bt, void* keys, void* node_max, void* node_idx, int B,
           int S, int D, int C, int n_chunks, int grid, cudaStream_t stream) {
  const int nkc = (C + KC - 1) / KC;
  const int nst = n_stages(MB, nkc);
  const size_t bytes = smem_bytes(MB, nkc, nst);
  static bool attr_set = false;  // once per kernel instance (the most any C takes)
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(match_argmax_wgmma_kernel<MB>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)SMEM_LIMIT);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const int bs = 128 * MB;
  const int n_st = (S + bs - 1) / bs;
  const int n_dt = (D + BN - 1) / BN;
  const int tpc = (n_dt + n_chunks - 1) / n_chunks;
  const int nc = (n_dt + tpc - 1) / tpc;  // chunks that hold a tile
  const int n_units = n_st * B * nc;
  CUtensorMap ta, tb;
  if (!make_map(&ta, a, B, S, C, bs, nkc * 8) || !make_map(&tb, bt, B, D, C, BN, 8))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(keys, 0, (size_t)S * 8, stream);
  if (err != cudaSuccess) return (int)err;
  match_argmax_wgmma_kernel<MB><<<min(grid, n_units), NTHREADS, bytes, stream>>>(
      ta, tb, (unsigned long long*)keys, S, D, nkc, nst, n_st, n_dt, tpc, nc, n_units);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  match_argmax_unpack_kernel<<<(S + 255) / 256, 256, 0, stream>>>(
      (const unsigned long long*)keys, (float*)node_max, (int*)node_idx, S);
  return (int)cudaGetLastError();
}

}  // namespace

// a, bt: the chunk-major copies (B, C / 8, S, 8) and (B, C / 8, D, 8) of
// a (B, S, C) and bt (B, D, C), bf16, contiguous, 16-byte aligned; keys:
// (S,) 64-bit scratch; node_max: (S,) f32, node_idx: (S,) i32. The dst
// tiles of each batch are cut into n_chunks chunks; grid blocks walk over
// the (src tile, batch, chunk) units. Returns cudaGetLastError() after the
// launches (cudaErrorInvalidValue when the arguments or the tensor maps
// are refused).
extern "C" int tclight_match_argmax_bf16(const void* a, const void* bt, void* keys,
                                         void* node_max, void* node_idx, int B, int S, int D,
                                         int C, int n_chunks, int grid, void* stream) {
  if (B <= 0 || S <= 0 || D <= 0 || C <= 0 || C % 8 != 0 || C > MAX_C || n_chunks <= 0 ||
      grid <= 0 || (long)B * D >= (1L << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (row_blocks((C + KC - 1) / KC) == 2)
    return launch<2>(a, bt, keys, node_max, node_idx, B, S, D, C, n_chunks, grid, s);
  return launch<1>(a, bt, keys, node_max, node_idx, B, S, D, C, n_chunks, grid, s);
}
