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
// global merge (B=2, S=D~23.8k, C=320) the products are 2*B*S*D*C ~ 0.7
// TFLOP against ~30 MB of inputs. A plain matmul + max would write and read
// back a (B, S, D) score tensor (~4.5 GB in f32), which would make it
// memory bound; this kernel never writes a score to device memory.
//
// Design: one block per src tile of 16 rows per warp: 8 warps (128 rows)
// with double-buffered dst tiles where that fits in shared memory (C <=
// 448, the level-0 merges), else 4 warps (64 rows), double buffered up to
// C = 592 (single buffered at level 1's C = 640). A block keeps its src
// rows of batch b in shared memory and streams the dst rows of the batch
// in 64-row tiles with cp.async; 8 warps keep twice the products in
// flight on an SM and halve the dst traffic per src row. Each warp
// computes its 16x64 score tile in registers with mma.sync m16n8k16 (bf16
// in, f32 accumulation, fragments loaded by ldmatrix) and folds it into a
// running (max, index) per row, also in registers. A tile's max takes the
// lowest column among equal scores, and the running value changes only on
// a strictly greater score, so the first b-major occurrence wins, as in
// the dense argmax. Padded dst columns are -inf. Not yet used: wgmma, TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_common.cuh"

using namespace tclight;

namespace {

constexpr int BD = 64;
constexpr int MAX_C = 768;
constexpr size_t SMEM_LIMIT = 232448;  // per block on the H100

__host__ __device__ inline int padded(int c) { return (c + 15) / 16 * 16; }

__host__ inline size_t smem_bytes(int bs, int nbuf, int c) {
  return (size_t)(bs + nbuf * BD) * (padded(c) + 8) * 2;
}

template <int NWARPS>
__global__ void __launch_bounds__(NWARPS * 32)
match_argmax_kernel(const __nv_bfloat16* __restrict__ a,
                    const __nv_bfloat16* __restrict__ bt,
                    float* __restrict__ node_max, int* __restrict__ node_idx,
                    int B, int S, int D, int C, int nbuf) {
  constexpr int BS = NWARPS * 16;
  constexpr int NTHREADS = NWARPS * 32;
  extern __shared__ __align__(128) unsigned char smem[];
  const int cp = padded(C);
  const int ld = cp + 8;
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sB = sA + BS * ld;  // nbuf buffers of BD x ld

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int s0 = blockIdx.x * BS;
  const int r0 = warp * 16;
  const int n_dt = (D + BD - 1) / BD;
  const int total = B * n_dt;  // (batch, dst tile) pairs, batch-major

  auto load_b = [&](int it, int buf) {
    const int bb = it / n_dt;
    load_tile_async<BD, NTHREADS>(sB + buf * BD * ld, ld, bt + (long)bb * D * C, C,
                                  (it % n_dt) * BD, D, C, cp);
  };

  load_tile_async<BS, NTHREADS>(sA, ld, a, C, s0, S, C, cp);
  load_b(0, 0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  float run_max[2] = {-INFINITY, -INFINITY};
  int run_idx[2] = {0, 0};
  for (int it = 0; it < total; ++it) {
    const int b = it / n_dt;
    const int d0 = (it % n_dt) * BD;
    if (d0 == 0 && b > 0) {  // the src rows of the next batch
      load_tile_async<BS, NTHREADS>(sA, ld, a + (long)b * S * C, C, s0, S, C, cp);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
    }
    const int buf = nbuf == 2 ? (it & 1) : 0;
    if (nbuf == 2 && it + 1 < total) {
      load_b(it + 1, buf ^ 1);
      cp_async_commit();
    }
    const __nv_bfloat16* tB = sB + buf * BD * ld;

    float s[BD / 8][4];
#pragma unroll
    for (int n = 0; n < BD / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    for (int kk = 0; kk < cp; kk += 16) {
      uint32_t af[4];
      ldmatrix_x4(af, smem_u32(sA + (r0 + (lane & 15)) * ld + kk + (lane >> 4) * 8));
#pragma unroll
      for (int np = 0; np < BD / 16; ++np) {
        uint32_t bf[4];
        ldmatrix_x4(bf, smem_u32(tB + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * ld +
                                 kk + ((lane >> 3) & 1) * 8));
        mma_bf16(s[2 * np], af, bf[0], bf[1]);
        mma_bf16(s[2 * np + 1], af, bf[2], bf[3]);
      }
    }

    // fold the tile into the running (max, index) of rows g and g + 8
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float best = -INFINITY;
      int col = 0x7fffffff;
#pragma unroll
      for (int n = 0; n < BD / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {  // columns in increasing order
          const int c = n * 8 + 2 * t + e;
          const float x = d0 + c < D ? s[n][2 * r + e] : -INFINITY;
          if (x > best) {
            best = x;
            col = c;
          }
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
      if (best > run_max[r]) {  // strictly greater: the first b-major one wins
        run_max[r] = best;
        run_idx[r] = b * D + d0 + col;
      }
    }

    if (nbuf == 2) {
      cp_async_wait_all();
      __syncthreads();  // the next tile has landed; this buffer is free
    } else {
      __syncthreads();
      if (it + 1 < total) {
        load_b(it + 1, 0);
        cp_async_commit();
        cp_async_wait_all();
        __syncthreads();
      }
    }
  }

  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = s0 + r0 + g + 8 * r;
      if (row < S) {
        node_max[row] = run_max[r];
        node_idx[row] = run_idx[r];
      }
    }
  }
}

template <int NWARPS>
int launch(const void* a, const void* bt, void* node_max, void* node_idx, int B,
           int S, int D, int C, int nbuf, cudaStream_t stream) {
  constexpr int BS = NWARPS * 16;
  const size_t bytes = smem_bytes(BS, nbuf, C);
  cudaError_t err = cudaFuncSetAttribute(
      match_argmax_kernel<NWARPS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BS - 1) / BS);
  match_argmax_kernel<NWARPS><<<grid, NWARPS * 32, bytes, stream>>>(
      (const __nv_bfloat16*)a, (const __nv_bfloat16*)bt, (float*)node_max,
      (int*)node_idx, B, S, D, C, nbuf);
  return (int)cudaGetLastError();
}

}  // namespace

// a: (B, S, C), bt: (B, D, C) bf16, contiguous, 16-byte aligned;
// node_max: (S,) f32, node_idx: (S,) i32. Returns cudaGetLastError().
extern "C" int tclight_match_argmax_bf16(const void* a, const void* bt,
                                         void* node_max, void* node_idx, int B,
                                         int S, int D, int C, void* stream) {
  if (B <= 0 || S <= 0 || D <= 0 || C <= 0 || C % 8 != 0 || C > MAX_C ||
      (long)B * D >= (1L << 31))
    return (int)cudaErrorInvalidValue;
  if (smem_bytes(128, 2, C) <= SMEM_LIMIT)
    return launch<8>(a, bt, node_max, node_idx, B, S, D, C, 2, (cudaStream_t)stream);
  const int nbuf = smem_bytes(64, 2, C) <= SMEM_LIMIT ? 2 : 1;
  return launch<4>(a, bt, node_max, node_idx, B, S, D, C, nbuf, (cudaStream_t)stream);
}
