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
//
// K5 is K4's direct gather with the window select: each entry's window k
// and in-window offset come from one read of the block's offsets, the
// row from starts[b, k] (the block's K starts stay in L1). A staged body
// was measured against it on the render's and the adjoint's K = 2 plans:
// persistent blocks of threads, two stages of shared memory, each
// window's selected span (not the whole window) fetched by one TMA bulk
// copy while the previous block gathered. It lost on the render (0.099 -
// 0.105 ms against 0.086) and tied on the adjoint (0.149 - 0.152 against
// 0.151 - 0.153), with pools for 8 blocks an SM; pools for 4 took 0.144
// and 0.208 (PERF.md §6; the staged body is in commit cae8620). With
// the render's plans indexing 1.5 table rows a pixel and the adjoint's
// 0.67 pixels a track, L1 and L2 already serve each block's span.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// ------------------------------------------------------------------ K5

// entries [i0, i0 + K4_ROWS) of a plan block as (window, offset in it);
// k = -1 where the entry gives a zero row (offs < 0 or >= nwin * window).
// Offsets are widened to int before the window subtraction.
template <typename OffT>
__device__ __forceinline__ void k5_entries(const OffT* ob, int i0, int bl, bool vec, int window,
                                           int nwin, int (&k)[K4_ROWS], int (&l)[K4_ROWS]) {
  int o[K4_ROWS];
  load_offs<OffT>(ob, i0, bl, vec, o);
  const long long limit = (long long)nwin * window;
#pragma unroll
  for (int e = 0; e < K4_ROWS; ++e) {
    const bool live = o[e] >= 0 && o[e] < limit;
    k[e] = live ? o[e] / window : -1;
    l[e] = live ? o[e] - k[e] * window : 0;
  }
}

// K5: as K4, each thread reads the offsets of its K4_ROWS consecutive
// entries once, loads the rows they select (row starts[b, k] + l, a row
// past the table's end a zero row) and writes its K4_ROWS * C contiguous
// output floats as float4 streaming stores.
template <typename OffT, int C>
__global__ void __launch_bounds__(K4_THREADS)
banded_gather_multi_kernel(const float* __restrict__ table, long long n_rows,
                           const int* __restrict__ starts, const OffT* __restrict__ offs,
                           float* __restrict__ out, int bl, int window, int nwin) {
  constexpr int V = K4_ROWS;
  const int b = blockIdx.x;
  const OffT* ob = offs + (size_t)b * bl;
  const int* sb = starts + (size_t)b * nwin;
  float* outb = out + (size_t)b * bl * C;
  const bool vec = bl % V == 0 && reinterpret_cast<uintptr_t>(offs) % 16 == 0;
  const bool vec_out = reinterpret_cast<uintptr_t>(outb) % 16 == 0;
  for (int i0 = V * threadIdx.x; i0 < bl; i0 += V * blockDim.x) {
    int k[V], l[V];
    k5_entries<OffT>(ob, i0, bl, vec, window, nwin, k, l);
    float r[V * C];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const long long row = k[e] >= 0 ? max((long long)__ldg(sb + k[e]) + l[e], 0LL) : 0;
      fetch_row<C>(r + e * C, table, row, k[e] >= 0 && row < n_rows);
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
int launch_k5(const float* table, long long n_rows, const int* starts, const void* offs,
              float* out, int nb, int bl, int window, int nwin, cudaStream_t s) {
  int threads = ((bl + K4_ROWS - 1) / K4_ROWS + 31) / 32 * 32;
  if (threads > K4_THREADS) threads = K4_THREADS;
  banded_gather_multi_kernel<OffT, C><<<nb, threads, 0, s>>>(
      table, n_rows, starts, static_cast<const OffT*>(offs), out, bl, window, nwin);
  return (int)cudaGetLastError();
}

template <typename OffT>
int launch_k5_c(const float* table, long long n_rows, int c, const int* starts, const void* offs,
                float* out, int nb, int bl, int window, int nwin, cudaStream_t s) {
  switch (c) {
    case 1: return launch_k5<OffT, 1>(table, n_rows, starts, offs, out, nb, bl, window, nwin, s);
    case 2: return launch_k5<OffT, 2>(table, n_rows, starts, offs, out, nb, bl, window, nwin, s);
    case 3: return launch_k5<OffT, 3>(table, n_rows, starts, offs, out, nb, bl, window, nwin, s);
    default: return launch_k5<OffT, 4>(table, n_rows, starts, offs, out, nb, bl, window, nwin, s);
  }
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
  if (c < 1 || c > 4 || bl < 1 || window < 1 || nwin < 1 || n_rows < 0)
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(table) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  if (nb == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return offs_bytes == 2
             ? launch_k5_c<int16_t>(table, n_rows, c, starts, offs, out, nb, bl, window, nwin, s)
             : launch_k5_c<int32_t>(table, n_rows, c, starts, offs, out, nb, bl, window, nwin, s);
}
