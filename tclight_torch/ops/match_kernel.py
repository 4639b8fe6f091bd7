"""Fused matmul + online argmax for ToMe matching (counterpart of
tclight_tpu/ops/match_kernel.py).

For every src token the greedy bipartite matching (ops/tome.py) needs the
max similarity and its argmax over ALL (batch, dst) pairs. On a CUDA tensor
`online_argmax_scores` launches the hand-written kernel K2
(`csrc/match_argmax.cu`), which never writes the (B, S, D) score tensor to
device memory; on a CPU tensor it takes the plain dense version
`online_argmax_scores_plain` (`online_argmax_scores_xla`).

Tie semantics are the dense path's: the b-major first occurrence wins.

K2 replaces the TPU kernel `_kernel` of tclight_tpu/ops/match_kernel.py.
On the H100 it is bound by tensor-core operations (the level-0 global
merge is ~0.7 TFLOP on ~30 MB of tokens); a matmul followed by a max would
instead be bound by the bytes of its (B, S, D) f32 score tensor (~4.5 GB).
Its design is a persistent, warp-specialised GEMM whose epilogue is a
fold: a producer warp streams dst tiles by TMA, read in place from a and
bt in the 128-byte swizzle (`match_geometry`; the wrapper copies
nothing), beside a resident src tile; two consumer warpgroups run the
products on wgmma and fold each score tile into a running (max, index) in
registers, the fold of one accumulator under the products of the other,
so no score reaches device memory. The (src tile, batch, dst tile) tiles
are cut into one contiguous range a CTA (`match_plan`); each (src tile,
batch) a range holds merges its rows' maxima into a packed 64-bit key per
src row by atomicMax (`pack_match_keys` states the rule), and a second
small kernel unpacks the keys. Details in the source.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from tclight_torch.ops import kernels

__all__ = ["online_argmax_scores", "online_argmax_scores_plain",
           "online_argmax_scores_cuda", "match_geometry", "match_plan", "match_operands",
           "pack_match_keys", "unpack_match_keys"]

DST_TILE = 128  # dst rows of one tile of the kernel
SLAB = 64       # channels of one stage and one TMA box: a 128-byte swizzle row
MAX_C = 768
SMEM_PER_CTA = 232448
_TOP_BIT = -(1 << 63)  # int64 with only bit 63 set
# tclight_match_argmax_bf16(a, bt, keys, node_max, node_idx, B, S, D, C,
# grid, stream)
K2_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def online_argmax_scores_plain(a: torch.Tensor, bt: torch.Tensor
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """a (B, S, C) x bt (B, D, C) -> (node_max (S,) f32, node_idx (S,) i32),
    from the dense f32 score tensor. `torch.argmax` returns the first
    maximal index, which over the `s (b d)` layout is the b-major first
    occurrence."""
    b, s, _ = a.shape
    d = bt.shape[1]
    scores = torch.einsum("bsc,bdc->bsd", a.float(), bt.float())
    s2 = scores.transpose(0, 1).reshape(s, b * d)
    return s2.amax(dim=-1), s2.argmax(dim=-1).to(torch.int32)


def match_geometry(b: int, s: int, d: int, c: int) -> dict:
    """K2's launch geometry, as `csrc/match_argmax.cu` lays it out, by the
    depth in 64-channel slabs (`slabs`, ceil(c / 64), at least two: c <=
    64 reads a second slab of zeros, since ptxas serialises the one-slab
    kernel's products): the 64-row src blocks of a consumer warpgroup (two
    up to 6 slabs, else one) and the src rows of a CTA's resident tile
    that follow (256 or 128), the dst rows of one accumulator (128, or 64
    with one src block: each warpgroup keeps two accumulators), the ring's
    stages (as many as fit, 2-8), the dynamic shared memory, the bytes
    each mbarrier expects (a src slab, a dst stage), and the 4-d tensor
    maps (dims innermost first, strides of dims 1-3 in bytes, box, swizzle
    in bytes): a (B, S, C) and bt (B, D, C) read in place as (C, 1, rows,
    B), boxes of 64 channels (one 128-byte swizzle row) by a src tile's or
    a 128-row dst stage's rows; channels past c (`zero_channels` of the
    last slab) and rows past s or d read as zeros. The wrapper makes no
    copy (`copies` False)."""
    slabs = max(-(-c // SLAB), 2)
    mb = 2 if slabs <= 6 else 1
    bs = 128 * mb

    def smem(n: int) -> int:
        return 1024 + bs * slabs * SLAB * 2 + n * DST_TILE * SLAB * 2 + 8 * (slabs + 1 + 2 * n)

    stages = max([n for n in range(2, 9) if smem(n) <= SMEM_PER_CTA] or [2])

    def inplace(rows: int, box_rows: int) -> dict:
        return {"dims": (c, 1, rows, b), "strides": (2 * c, 2 * c, 2 * c * rows),
                "box": (SLAB, 1, box_rows, 1), "swizzle": 128}

    return {"slabs": slabs, "zero_channels": slabs * SLAB - c, "row_blocks": mb,
            "src_rows": bs, "acc_rows": DST_TILE * mb // 2, "stages": stages,
            "smem": smem(stages), "copies": False, "tx_src_slab": bs * SLAB * 2,
            "tx_stage": DST_TILE * SLAB * 2,
            "maps": {"a": inplace(s, bs), "bt": inplace(d, DST_TILE)}}


@functools.lru_cache(maxsize=256)
def match_plan(b: int, s: int, d: int, c: int, n_sm: int) -> dict:
    """K2's work split, as `csrc/match_argmax.cu` runs it on a card of
    `n_sm` SMs (one CTA an SM: its shared memory holds one). A tile is (src
    tile of `src_rows` rows, batch, 128-row dst tile). The tiles, src tile
    slowest and dst tile fastest, are cut into `ctas` contiguous ranges of
    `tiles_per_cta` (the last may hold fewer, none is empty): min(n_sm,
    tiles) CTAs, the ranges as even as whole tiles allow. `src_loads`: the
    most src tiles a CTA loads (the (src tile, batch) pairs its range
    enters)."""
    g = match_geometry(b, s, d, c)
    n_st, n_dt = -(-s // g["src_rows"]), -(-d // DST_TILE)
    tiles = n_st * b * n_dt
    ctas = min(max(n_sm, 1), tiles)
    per = -(-tiles // ctas)
    ctas = -(-tiles // per)
    firsts = np.arange(ctas) * per
    lasts = np.minimum(firsts + per, tiles) - 1
    src_loads = int((lasts // n_dt - firsts // n_dt + 1).max())
    return {"src_rows": g["src_rows"], "stages": g["stages"], "src_tiles": n_st,
            "dst_tiles": n_dt, "tiles": tiles, "ctas": ctas, "tiles_per_cta": per,
            "src_loads": src_loads}


def pack_match_keys(node_max: torch.Tensor, node_idx: torch.Tensor) -> torch.Tensor:
    """The kernel's merge key of a (max, b-major index) pair, as int64
    holding the 64-bit unsigned key's bits: the order-preserving image of
    the f32 max in the high word (-0.0 made +0.0, which the dense argmax
    treats as equal; a positive float gets its sign bit set, a negative
    one all bits flipped) and ~index in the low word. As unsigned integers
    a larger key has the larger max or, on equal maxima, the lower index,
    so the max key over any split of the (b, d) range is the dense
    argmax's first maximiser. Plain version of `pack_key` in
    `csrc/match_argmax.cu`."""
    m = torch.where(node_max == 0, torch.zeros_like(node_max), node_max)
    u = m.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = torch.where(u >= 0x80000000, u ^ 0xFFFFFFFF, u | 0x80000000)
    low = (~node_idx.to(torch.int64)) & 0xFFFFFFFF
    return ((u << 32) | low) ^ _TOP_BIT  # signed order of the result = unsigned order of the key


def unpack_match_keys(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Inverse of `pack_match_keys` (as `match_argmax_unpack_kernel`)."""
    k = keys ^ _TOP_BIT
    hi = (k >> 32) & 0xFFFFFFFF
    u = torch.where(hi >= 0x80000000, hi & 0x7FFFFFFF, hi ^ 0xFFFFFFFF)
    m = u.to(torch.int32).view(torch.float32)  # wraps u >= 2^31 to its int32 bits
    return m, (~k & 0xFFFFFFFF).to(torch.int32)


def match_operands(a: torch.Tensor, bt: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The a and bt that K2 reads: the (B, S, C) and (B, D, C) tensors
    themselves (`match_geometry`'s maps read them in place)."""
    return a, bt


def online_argmax_scores_cuda(a: torch.Tensor, bt: torch.Tensor
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K2 on bf16 CUDA tensors; C % 8 == 0, C <= 768."""
    for name, t in (("a", a), ("bt", bt)):
        if not t.is_cuda or t.dtype != torch.bfloat16:
            raise ValueError(f"match kernel: {name} must be a bf16 CUDA tensor, "
                             f"got {t.dtype} on {t.device}")
        if t.dim() != 3 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"match kernel: {name} must be a contiguous, "
                             "16-byte aligned 3-d tensor")
    b, s, c = a.shape
    d = bt.shape[1]
    if bt.shape != (b, d, c):
        raise ValueError(f"match kernel: a {tuple(a.shape)} and bt "
                         f"{tuple(bt.shape)} disagree")
    if c % 8 or c > MAX_C:
        raise ValueError(f"match kernel: channels {c} must be a multiple of 8 "
                         "and at most 768")
    return _launch(a, bt, torch.cuda.get_device_properties(a.device).multi_processor_count)


def _launch(a: torch.Tensor, bt: torch.Tensor, grid: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K2 on at most `grid` CTAs (at least one), each one contiguous range
    of the tiles (checked inputs; the card tests force other splits through
    it)."""
    b, s, c = a.shape
    d = bt.shape[1]
    ka, kb = match_operands(a, bt)
    keys = torch.empty(s, dtype=torch.int64, device=a.device)
    node_max = torch.empty(s, dtype=torch.float32, device=a.device)
    node_idx = torch.empty(s, dtype=torch.int32, device=a.device)
    fn = kernels.function("match_argmax", "tclight_match_argmax_bf16", K2_ARGTYPES, ctypes.c_int)
    rc = fn(ka.data_ptr(), kb.data_ptr(), keys.data_ptr(), node_max.data_ptr(),
            node_idx.data_ptr(), b, s, d, c, grid,
            torch.cuda.current_stream(a.device).cuda_stream)
    kernels.check_launch(rc, "online_argmax_scores")
    kernels.STATS["online_argmax_scores"].record((b, s, d, c))
    return node_max, node_idx


def online_argmax_scores(a: torch.Tensor, bt: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """node_max[s] = max over (b, d) of a[b, s] . bt[b, d]; node_idx the
    b-major global index b * D + d of the first maximiser. A CUDA tensor
    goes to the kernel (or the call raises); a CPU tensor to the plain
    version."""
    if a.is_cuda:
        return online_argmax_scores_cuda(a, bt)
    return online_argmax_scores_plain(a, bt)
