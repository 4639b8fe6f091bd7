// Small PTX helpers shared by the port's kernels: cp.async copies, ldmatrix
// fragment loads and the bf16 m16n8k16 tensor-core product (sm_80+).
//
// Fragment layouts of mma.sync.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16x16, row major): a0 = A[g][2t..2t+1], a1 = A[g+8][2t..],
//                         a2 = A[g][2t+8..],   a3 = A[g+8][2t+8..]
//   B (16x8, k x n):      b0 = B[2t..2t+1][g], b1 = B[2t+8..2t+9][g]
//   C (16x8, f32):        c0,c1 = C[g][2t..2t+1], c2,c3 = C[g+8][2t..2t+1]
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tclight {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; zero fill when !valid (src is then not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a * b (bf16 inputs, f32 accumulation)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows [row0, row0 + ROWS) of a bf16 matrix with `row_stride` elements per
// row into shared memory rows of `ld` elements, zero filled past row
// `nrows` and column `d`; d % 8 == 0, `dp` (a multiple of 8) columns copied
template <int ROWS, int NTHREADS>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst, int ld,
                                                const __nv_bfloat16* src, long row_stride,
                                                int row0, int nrows, int d, int dp) {
  const int chunks = dp / 8;
  for (int i = threadIdx.x; i < ROWS * chunks; i += NTHREADS) {
    const int r = i / chunks;
    const int c = (i % chunks) * 8;
    const bool valid = (row0 + r < nrows) && (c < d);
    const __nv_bfloat16* g = valid ? src + (long)(row0 + r) * row_stride + c : src;
    cp_async16(smem_u32(dst + r * ld + c), g, valid);
  }
}

}  // namespace tclight
