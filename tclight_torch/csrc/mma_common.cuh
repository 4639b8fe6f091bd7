// Small PTX helpers of K7 (csrc/flash_attention_int8.cu): cp.async copies,
// ldmatrix fragment loads and the int8 m16n8k32 tensor-core product
// (sm_80+).
//
// Fragment layouts of mma.sync.m16n8k16 (g = lane / 4, t = lane % 4), which
// m16n8k32 on 8-bit data has in bytes:
//   A (16x16, row major): a0 = A[g][2t..2t+1], a1 = A[g+8][2t..],
//                         a2 = A[g][2t+8..],   a3 = A[g+8][2t+8..]
//   B (16x8, k x n):      b0 = B[2t..2t+1][g], b1 = B[2t+8..2t+9][g]
//   C (16x8, f32):        c0,c1 = C[g][2t..2t+1], c2,c3 = C[g+8][2t..2t+1]
#pragma once

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

// d += a * b (int8 inputs, exact int32 accumulation), m16n8k32. In bytes
// its fragments have the m16n8k16 layout above: a0 = A[g][4t..4t+3],
// a1 = A[g+8][4t..], a2 = A[g][16+4t..], a3 = A[g+8][16+4t..];
// b0 = B[4t..4t+3][g], b1 = B[16+4t..][g]; C as the f32 C above.
__device__ __forceinline__ void mma_s8(int32_t (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace tclight
