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
// straight from global memory and writes them with float4 stores that
// stream past L2 (see banded_gather_kernel). The order of its blocks is
// what bounded it. The render's plans come from tracks numbered by their
// mean scanline position, so block j of every frame reads the same ~3.5k-
// row span, about 7 rows apart: each 12-byte row costs a 32-byte sector
// (a quarter of them two), and the frames share the span's sectors. In
// plan order (frame-major) frame b + 1 reaches span j a whole table later
// (57.7 MB at 960 x 720 x 8, above the 50 MB L2), so every frame's rows
// crossed device memory again. The kernel takes the plan's leading rows
// (the frames of a batch): a CTA gathers block j of two consecutive rows,
// entry by entry, and the CTAs of block j are consecutive, so the spans in
// flight are few and each sector crosses device memory about once.
// Measured on the main path's render plan (16 x 691,200 px, window 8192;
// ablate_postopt, NVIDIA H100 80GB HBM3, 700.00 W, PERF.md), padded batch
// / 16 distinct frames: plan order 0.342 / 0.408 ms; a CTA a block, block j
// of every row together, 0.167 / 0.188 (sorted by start through an index
// array: 0.166); this body, 2 rows a CTA, 0.154 / 0.170 (1 row 0.155 /
// 0.168, 4 rows 0.157 / 0.189, all 16 rows a CTA 0.347 / 0.408: every CTA
// resident at once puts every span in flight); with no table read at all
// (the offsets and the output alone) 0.097. An L2 evict-last policy on the
// table changed nothing, 8 entries a thread cost 13-35%, and a table
// padded to 16-byte rows (a copy the render would write every call) saved
// up to 13% on some plans and lost 27% on others. The adjoint's plans (window 2048, a frame's rows
// read once) keep plan order, one row: 0.435 / 0.818 against 0.469 / 0.910
// for the same loads and stores in a body without the rows' loop (not
// explained: no profiler runs here); interleaved over the frames they were
// 5% slower, sorted by start 0.438 (a per-frame order the wrapper would have
// to cache per batch). An earlier body staged each
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
constexpr int K4_GROUP = 2;      // plan rows a CTA gathers, at most

// the plan rows a K4 CTA gathers: the largest power of two up to K4_GROUP
// that divides the plan's rows
inline int k4_group(int rows) {
  int group = 1;
  while (group * 2 <= K4_GROUP && rows % (group * 2) == 0) group *= 2;
  return group;
}

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

// K4: the plan's nb blocks are `rows` leading rows of nbr = nb / rows
// blocks; a CTA gathers block j of `group` consecutive rows, and the rows /
// group CTAs of block j are consecutive, so that the blocks of one index,
// which read one table span, run together (a CTA of all the rows would put
// every span in flight at once). A CTA goes entry by entry over its rows'
// blocks: their entries at one position read rows close to each other (the
// padded batch's repeated frames the same rows), which L1 then serves.
// Each thread reads the offsets of its K4_ROWS consecutive entries of a
// block once, issues the loads of all their selected rows, then writes its
// K4_ROWS * C contiguous output floats (a multiple of 4) as float4 stores
// that stream past L2 (evict-first), so that the output does not push the
// table out; a warp covers one contiguous run of a block's output.
template <typename OffT, int C>
__global__ void __launch_bounds__(K4_THREADS)
banded_gather_kernel(const float* __restrict__ table, long long n_rows,
                     const int* __restrict__ starts, const OffT* __restrict__ offs,
                     float* __restrict__ out, int bl, int rows, int group) {
  constexpr int V = K4_ROWS;
  const int slots = rows / group;        // CTAs a block index
  const int nbr = gridDim.x / slots;     // blocks a plan row
  const int j = blockIdx.x / slots, r0 = blockIdx.x % slots * group;
  const bool vec = bl % V == 0 && reinterpret_cast<uintptr_t>(offs) % 16 == 0;
  for (int i0 = V * threadIdx.x; i0 < bl; i0 += V * blockDim.x) {
#pragma unroll 2
    for (int rr = 0; rr < group; ++rr) {
      const int b = (r0 + rr) * nbr + j;
      const OffT* ob = offs + (size_t)b * bl;
      float* outb = out + (size_t)b * bl * C;
      const long long start = __ldg(starts + b);
      int o[V];
      load_offs<OffT>(ob, i0, bl, vec, o);
      float r[V * C];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const long long row = start + o[e];
        fetch_row<C>(r + e * C, table, row, o[e] >= 0 && row < n_rows);
      }
      if (reinterpret_cast<uintptr_t>(outb) % 16 == 0 && i0 + V <= bl) {
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
}

template <typename OffT, int C>
int launch_k4(const float* table, long long n_rows, const int* starts, const void* offs,
              float* out, int nb, int bl, int rows, cudaStream_t s) {
  // whole warps, enough for one pass of K4_ROWS entries each over a block
  int threads = ((bl + K4_ROWS - 1) / K4_ROWS + 31) / 32 * 32;
  if (threads > K4_THREADS) threads = K4_THREADS;
  const int group = k4_group(rows);
  banded_gather_kernel<OffT, C><<<nb / group, threads, 0, s>>>(
      table, n_rows, starts, static_cast<const OffT*>(offs), out, bl, rows, group);
  return (int)cudaGetLastError();
}

template <typename OffT>
int launch_k4_c(const float* table, long long n_rows, int c, const int* starts,
                const void* offs, float* out, int nb, int bl, int rows, cudaStream_t s) {
  switch (c) {
    case 1: return launch_k4<OffT, 1>(table, n_rows, starts, offs, out, nb, bl, rows, s);
    case 2: return launch_k4<OffT, 2>(table, n_rows, starts, offs, out, nb, bl, rows, s);
    case 3: return launch_k4<OffT, 3>(table, n_rows, starts, offs, out, nb, bl, rows, s);
    default: return launch_k4<OffT, 4>(table, n_rows, starts, offs, out, nb, bl, rows, s);
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
// offs_bytes == 2, else int32; out (nb, bl, c) f32; the plan's nb blocks
// are `rows` leading rows of nb / rows blocks each (1: one row, plan
// order). Returns the cudaError_t. The window bounds the plan's offsets
// and is not needed to gather them.
extern "C" int tclight_banded_gather(const float* table, long long n_rows, int c,
                                     const int* starts, const void* offs, int offs_bytes,
                                     float* out, int nb, int bl, int window, int rows,
                                     void* stream) {
  if (c < 1 || c > 4 || bl < 1 || window < 1 || n_rows < 0 || rows < 1 || nb % rows != 0)
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(table) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  if (nb == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return offs_bytes == 2
             ? launch_k4_c<int16_t>(table, n_rows, c, starts, offs, out, nb, bl, rows, s)
             : launch_k4_c<int32_t>(table, n_rows, c, starts, offs, out, nb, bl, rows, s);
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
