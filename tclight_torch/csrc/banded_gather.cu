// K4 and K5: the banded (windowed) palette gather, for sm_90a. They
// replace the TPU kernels `_kernel` (K4) and `_kernel_multi` (K5) of
// tclight_tpu/ops/banded_gather.py; the plain versions are
// `banded_gather_plain` and `banded_gather_plain_multi` in
// tclight_torch/ops/banded_gather.py.
//
//   K4: out[b, i] = table[starts[b] + offs[b, i]],          0 <= offs < window
//   K5: out[b, i] = table[starts[b, k] + offs[b, i] - k * window],
//       k = offs[b, i] / window,                            0 <= offs < K * window
//   offs < 0 gives a zero row. Every output row is written: an offset
//   past K4's window is read from the table directly, one past K5's
//   windows gives a zero row.
//
// The table is row-major (P, C) f32, C <= 4 (the TPU packs it as
// (P/128, 8, 128) tiles so that a window is one DMA; here a window of rows
// is one contiguous byte range anyway). The output is (NB, BL, C)
// row-major, its base 16-byte aligned for cp.async. Offsets come as int16
// or int32, as the host planner emits them. The plan's segment starts are
// a TPU DMA grouping and are not read.
//
// What bounds it on the H100: bytes. Each output row is C floats written
// once; the offsets and the table rows are read once.
//
// Design: one thread block per plan block (BL outputs). For each of its K
// windows the block reduces the smallest and largest offset that selects
// that window, stages just that span of table rows into shared memory with
// 16-byte cp.async copies (zero-filled past the table's end, so no tail
// margin is needed), and every thread then writes the rows its entries
// select from shared memory. Tracks are near-monotone in scanline order,
// so the span is close to BL rows and the staging reads each table row
// about once.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

template <typename OffT>
__device__ __forceinline__ void banded_gather_block(
    const float* __restrict__ table, long long n_rows, int c, const int* __restrict__ starts,
    const OffT* __restrict__ offs, float* __restrict__ out, int bl, int window, int nwin) {
  extern __shared__ float4 smem4[];
  float* win = reinterpret_cast<float*>(smem4);
  __shared__ int red_lo[THREADS / 32], red_hi[THREADS / 32];
  __shared__ int span_lo, span_hi;

  const int b = blockIdx.x;
  const OffT* ob = offs + (size_t)b * bl;
  float* outb = out + (size_t)b * bl * c;
  const long long total = n_rows * c;

  // rows that no staged window holds: offs < 0 gives zeros; K4 reads an
  // offset past its window straight from the table, as the plain version
  // does; an offset past K5's windows, or a row past the table's end,
  // gives zeros
  for (int i = threadIdx.x; i < bl; i += THREADS) {
    const int o = (int)ob[i];
    if (o < 0 || o >= nwin * window) {
      const long long row = (nwin == 1 && o >= 0) ? (long long)starts[b] + o : -1;
      const bool in_table = row >= 0 && row < n_rows;
      for (int ch = 0; ch < c; ++ch)
        outb[(size_t)i * c + ch] = in_table ? table[row * c + ch] : 0.f;
    }
  }

  for (int k = 0; k < nwin; ++k) {
    // the span of this window's rows that the block's entries select
    int lo = INT_MAX, hi = -1;
    for (int i = threadIdx.x; i < bl; i += THREADS) {
      const int o = (int)ob[i];  // widened before the window subtraction
      if (o >= 0 && o / window == k) {
        const int l = o - k * window;
        lo = min(lo, l);
        hi = max(hi, l);
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    }
    if (threadIdx.x % 32 == 0) { red_lo[threadIdx.x / 32] = lo; red_hi[threadIdx.x / 32] = hi; }
    __syncthreads();
    if (threadIdx.x == 0) {
      int l = red_lo[0], h = red_hi[0];
      for (int i = 1; i < THREADS / 32; ++i) { l = min(l, red_lo[i]); h = max(h, red_hi[i]); }
      span_lo = l;
      span_hi = h;
    }
    __syncthreads();
    const int s_lo = span_lo, s_hi = span_hi;
    if (s_hi < 0) continue;  // no entry of this block selects window k

    // stage floats [f0, f1) of the table, from the 16-byte boundary below f0
    const long long f0 = ((long long)starts[(size_t)b * nwin + k] + s_lo) * c;
    const long long f1 = f0 + (long long)(s_hi - s_lo + 1) * c;
    const long long a0 = f0 & ~3LL;
    const int shift = (int)(f0 - a0);
    const int nvec = (int)((f1 - a0 + 3) / 4);
    for (int v = threadIdx.x; v < nvec; v += THREADS) {
      const long long fi = a0 + 4LL * v;
      const long long valid = total - fi;
      const int bytes = valid >= 4 ? 16 : (valid > 0 ? (int)valid * 4 : 0);
      cp_async_16(win + 4 * v, table + (bytes > 0 ? fi : 0), bytes);
    }
    cp_async_wait_all();
    __syncthreads();
    for (int i = threadIdx.x; i < bl; i += THREADS) {
      const int o = (int)ob[i];
      if (o >= 0 && o / window == k) {
        const float* src = win + shift + (size_t)(o - k * window - s_lo) * c;
        for (int ch = 0; ch < c; ++ch) outb[(size_t)i * c + ch] = src[ch];
      }
    }
    __syncthreads();  // the staging buffer is reused by window k + 1
  }
}

// K4: one window per block
template <typename OffT>
__global__ void __launch_bounds__(THREADS)
banded_gather_kernel(const float* __restrict__ table, long long n_rows, int c,
                     const int* __restrict__ starts, const OffT* __restrict__ offs,
                     float* __restrict__ out, int bl, int window) {
  banded_gather_block<OffT>(table, n_rows, c, starts, offs, out, bl, window, 1);
}

// K5: nwin windows per block, selected by offs / window
template <typename OffT>
__global__ void __launch_bounds__(THREADS)
banded_gather_multi_kernel(const float* __restrict__ table, long long n_rows, int c,
                           const int* __restrict__ starts, const OffT* __restrict__ offs,
                           float* __restrict__ out, int bl, int window, int nwin) {
  banded_gather_block<OffT>(table, n_rows, c, starts, offs, out, bl, window, nwin);
}

template <typename OffT>
int launch(const float* table, long long n_rows, int c, const int* starts, const void* offs,
           float* out, int nb, int bl, int window, int nwin, void* stream) {
  if (c < 1 || c > 4 || bl < 1 || window < 1 || nwin < 1 || n_rows < 0)
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(table) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  if (nb == 0) return 0;
  // the widest span a window can stage, plus the 16-byte alignment slack
  const size_t smem = ((size_t)window * c + 8) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const OffT* o = static_cast<const OffT*>(offs);
  cudaError_t e;
  if (nwin == 1) {
    e = cudaFuncSetAttribute(banded_gather_kernel<OffT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    banded_gather_kernel<OffT><<<nb, THREADS, smem, s>>>(table, n_rows, c, starts, o, out,
                                                         bl, window);
  } else {
    e = cudaFuncSetAttribute(banded_gather_multi_kernel<OffT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    banded_gather_multi_kernel<OffT><<<nb, THREADS, smem, s>>>(table, n_rows, c, starts, o,
                                                               out, bl, window, nwin);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// table (n_rows, c) f32; starts (nb,) int32; offs (nb, bl) int16 when
// offs_bytes == 2, else int32; out (nb, bl, c) f32. Returns the cudaError_t.
extern "C" int tclight_banded_gather(const float* table, long long n_rows, int c,
                                     const int* starts, const void* offs, int offs_bytes,
                                     float* out, int nb, int bl, int window, void* stream) {
  return offs_bytes == 2
             ? launch<int16_t>(table, n_rows, c, starts, offs, out, nb, bl, window, 1, stream)
             : launch<int32_t>(table, n_rows, c, starts, offs, out, nb, bl, window, 1, stream);
}

// K windows per block: starts (nb, nwin) int32, offs encode the window as
// offs / window.
extern "C" int tclight_banded_gather_multi(const float* table, long long n_rows, int c,
                                           const int* starts, const void* offs,
                                           int offs_bytes, float* out, int nb, int bl,
                                           int window, int nwin, void* stream) {
  return offs_bytes == 2
             ? launch<int16_t>(table, n_rows, c, starts, offs, out, nb, bl, window, nwin, stream)
             : launch<int32_t>(table, n_rows, c, starts, offs, out, nb, bl, window, nwin, stream);
}
