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
//   windows gives a zero row; a row past the table's end reads as zeros.
//
// The table is row-major (P, C) f32, C <= 4, its base 16-byte aligned (the
// TPU packs it as (P/128, 8, 128) tiles so that a window is one DMA; here
// a window of rows is one contiguous byte range anyway). The output is
// (NB, BL, C) row-major. Offsets come as int16 or int32, as the host
// planner emits them. The plan's segment starts are a TPU DMA grouping
// and are not read.
//
// What bounds it on the H100: bytes. Each output row is C floats written
// once; the offsets and the selected table rows are read once.
//
// K4 stages nothing: each thread gathers the rows its entries select
// straight from global memory (the plan keeps a block's rows inside one
// window, so they stay in L2) and writes them with float4 stores that
// stream past L2 (see banded_gather_kernel). An earlier body staged each
// block's whole selected span in shared memory: ~3.5k rows to write 512 at
// the render's density of ~7 table rows per output. A staged body sized to
// the span and fetched by one bulk copy lost to the direct gather on the
// adjoint's sparse plans and on plans whose rows repeat (PERF.md): L1 and
// L2 already serve the repeats.
// K5 stages, per window, the span its entries select with cp.async into a
// window-sized buffer.

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

// K5: nwin windows per block, selected by offs / window
template <typename OffT>
__global__ void __launch_bounds__(THREADS)
banded_gather_multi_kernel(const float* __restrict__ table, long long n_rows, int c,
                           const int* __restrict__ starts, const OffT* __restrict__ offs,
                           float* __restrict__ out, int bl, int window, int nwin) {
  banded_gather_block<OffT>(table, n_rows, c, starts, offs, out, bl, window, nwin);
}

// the largest dynamic shared memory a kernel was given; raised, never
// lowered, so the attribute is set once per kernel and size, not per launch
template <auto Kernel>
int raise_smem_limit(size_t bytes) {
  static size_t limit = 48 * 1024;  // what every kernel may use unasked
  if (bytes <= limit) return 0;
  cudaError_t e = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)bytes);
  if (e != cudaSuccess) return (int)e;
  limit = bytes;
  return 0;
}

constexpr int K4_ROWS = 4;       // consecutive entries a thread gathers
constexpr int K4_THREADS = 128;

// the offsets of entries [i0, i0 + K4_ROWS) of a block: one 8- or 16-byte
// load where the block's offsets allow it
template <typename OffT>
__device__ __forceinline__ void load_offs(const OffT* ob, int i0, int bl, bool vec,
                                          int (&o)[K4_ROWS]) {
  static_assert(K4_ROWS * sizeof(OffT) == 8 || K4_ROWS * sizeof(OffT) == 16, "vector width");
  if (vec && i0 + K4_ROWS <= bl) {
    OffT p[K4_ROWS];
    if constexpr (K4_ROWS * sizeof(OffT) == 16)
      *reinterpret_cast<int4*>(p) = *reinterpret_cast<const int4*>(ob + i0);
    else
      *reinterpret_cast<int2*>(p) = *reinterpret_cast<const int2*>(ob + i0);
#pragma unroll
    for (int e = 0; e < K4_ROWS; ++e) o[e] = (int)p[e];
  } else {
#pragma unroll
    for (int e = 0; e < K4_ROWS; ++e) o[e] = i0 + e < bl ? (int)ob[i0 + e] : -1;
  }
}

// table row `row` into r[0..C), or zeros
template <int C>
__device__ __forceinline__ void fetch_row(float* r, const float* __restrict__ table,
                                          long long row, bool valid) {
  if constexpr (C == 4) {
    const float4 v = valid ? __ldg(reinterpret_cast<const float4*>(table + row * 4))
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    r[0] = v.x, r[1] = v.y, r[2] = v.z, r[3] = v.w;
  } else {
#pragma unroll
    for (int ch = 0; ch < C; ++ch) r[ch] = valid ? __ldg(table + row * C + ch) : 0.f;
  }
}

// K4: each thread reads the offsets of its K4_ROWS consecutive entries
// once, issues the loads of all their selected rows, then writes its
// K4_ROWS * C contiguous output floats (a multiple of 4) as float4 stores
// that stream past L2 (evict-first), so that the output does not push the
// table out; a warp covers one contiguous run of the block's output.
template <typename OffT, int C>
__global__ void __launch_bounds__(K4_THREADS)
banded_gather_kernel(const float* __restrict__ table, long long n_rows,
                     const int* __restrict__ starts, const OffT* __restrict__ offs,
                     float* __restrict__ out, int bl) {
  constexpr int V = K4_ROWS;
  const int b = blockIdx.x;
  const OffT* ob = offs + (size_t)b * bl;
  float* outb = out + (size_t)b * bl * C;
  const bool vec = bl % V == 0 && reinterpret_cast<uintptr_t>(offs) % 16 == 0;
  const bool vec_out = reinterpret_cast<uintptr_t>(outb) % 16 == 0;
  const long long start = starts[b];
  for (int i0 = V * threadIdx.x; i0 < bl; i0 += V * blockDim.x) {
    int o[V];
    load_offs<OffT>(ob, i0, bl, vec, o);
    float r[V * C];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const long long row = start + o[e];
      fetch_row<C>(r + e * C, table, row, o[e] >= 0 && row < n_rows);
    }
    if (vec_out && i0 + V <= bl) {
      float4* dst = reinterpret_cast<float4*>(outb + (size_t)i0 * C);
#pragma unroll
      for (int q = 0; q < V * C / 4; ++q)
        __stcs(dst + q, make_float4(r[4 * q], r[4 * q + 1], r[4 * q + 2], r[4 * q + 3]));
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        if (i0 + e < bl) {
#pragma unroll
          for (int ch = 0; ch < C; ++ch) outb[(size_t)(i0 + e) * C + ch] = r[e * C + ch];
        }
      }
    }
  }
}

template <typename OffT, int C>
int launch_k4(const float* table, long long n_rows, const int* starts, const void* offs,
              float* out, int nb, int bl, cudaStream_t s) {
  // whole warps, enough for one pass of K4_ROWS entries each over a block
  int threads = ((bl + K4_ROWS - 1) / K4_ROWS + 31) / 32 * 32;
  if (threads > K4_THREADS) threads = K4_THREADS;
  banded_gather_kernel<OffT, C><<<nb, threads, 0, s>>>(
      table, n_rows, starts, static_cast<const OffT*>(offs), out, bl);
  return (int)cudaGetLastError();
}

template <typename OffT>
int launch_k4_c(const float* table, long long n_rows, int c, const int* starts,
                const void* offs, float* out, int nb, int bl, cudaStream_t s) {
  switch (c) {
    case 1: return launch_k4<OffT, 1>(table, n_rows, starts, offs, out, nb, bl, s);
    case 2: return launch_k4<OffT, 2>(table, n_rows, starts, offs, out, nb, bl, s);
    case 3: return launch_k4<OffT, 3>(table, n_rows, starts, offs, out, nb, bl, s);
    default: return launch_k4<OffT, 4>(table, n_rows, starts, offs, out, nb, bl, s);
  }
}

template <typename OffT>
int launch_multi(const float* table, long long n_rows, int c, const int* starts,
                 const void* offs, float* out, int nb, int bl, int window, int nwin,
                 void* stream) {
  if (c < 1 || c > 4 || bl < 1 || window < 1 || nwin < 1 || n_rows < 0)
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(table) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  if (nb == 0) return 0;
  // the widest span a window can stage, plus the 16-byte alignment slack
  const size_t smem = ((size_t)window * c + 8) * sizeof(float);
  int e = raise_smem_limit<banded_gather_multi_kernel<OffT>>(smem);
  if (e) return e;
  banded_gather_multi_kernel<OffT><<<nb, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      table, n_rows, c, starts, static_cast<const OffT*>(offs), out, bl, window, nwin);
  return (int)cudaGetLastError();
}

}  // namespace

// K4. table (n_rows, c) f32; starts (nb,) int32; offs (nb, bl) int16 when
// offs_bytes == 2, else int32; out (nb, bl, c) f32. Returns the
// cudaError_t. The window bounds the plan's offsets and is not needed to
// gather them.
extern "C" int tclight_banded_gather(const float* table, long long n_rows, int c,
                                     const int* starts, const void* offs, int offs_bytes,
                                     float* out, int nb, int bl, int window, void* stream) {
  if (c < 1 || c > 4 || bl < 1 || window < 1 || n_rows < 0) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(table) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  if (nb == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return offs_bytes == 2 ? launch_k4_c<int16_t>(table, n_rows, c, starts, offs, out, nb, bl, s)
                         : launch_k4_c<int32_t>(table, n_rows, c, starts, offs, out, nb, bl, s);
}

// K5. K windows per block: starts (nb, nwin) int32, offs encode the window
// as offs / window.
extern "C" int tclight_banded_gather_multi(const float* table, long long n_rows, int c,
                                           const int* starts, const void* offs,
                                           int offs_bytes, float* out, int nb, int bl,
                                           int window, int nwin, void* stream) {
  return offs_bytes == 2
             ? launch_multi<int16_t>(table, n_rows, c, starts, offs, out, nb, bl, window, nwin,
                                     stream)
             : launch_multi<int32_t>(table, n_rows, c, starts, offs, out, nb, bl, window, nwin,
                                     stream);
}
