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
fold: a producer warp streams dst tiles by TMA, two consumer warpgroups
run the products on wgmma and fold each score tile into a running (max,
index) in registers, so no score reaches device memory. The (batch, dst)
range is cut into chunks (`match_plan`) so that the units (src tile,
batch, chunk) fill the card's last wave; each unit merges its rows' maxima
into a packed 64-bit key per src row by atomicMax (`pack_match_keys`
states the rule), and a second small kernel unpacks the keys. Details in
the source.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from tclight_torch.ops import kernels

__all__ = ["online_argmax_scores", "online_argmax_scores_plain",
           "online_argmax_scores_cuda", "match_plan", "pack_match_keys", "unpack_match_keys"]

DST_TILE = 128  # dst rows of one tile of the kernel
STAGE_C = 64    # channels of one stage; the depth is padded to a multiple of it
MAX_C = 768
_TOP_BIT = -(1 << 63)  # int64 with only bit 63 set
# tclight_match_argmax_bf16(a, bt, keys, node_max, node_idx, B, S, D, C,
# n_chunks, grid, stream)
K2_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


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


@functools.lru_cache(maxsize=256)
def match_plan(b: int, s: int, d: int, c: int, n_sm: int) -> dict:
    """K2's work split, as `csrc/match_argmax.cu` runs it. A unit is (src
    tile, batch, dst chunk): `src_rows` src rows of one batch against
    `tiles_per_chunk` whole 128-row dst tiles of that batch (the last
    chunk of a batch may hold fewer). The src tile holds 256 rows (two
    64-row blocks per consumer warpgroup) while the depth padded to 64 is
    at most 384 channels, else 128, where the resident tile leaves room
    for too few stages. A persistent grid of min(n_sm, units) blocks walks
    over the units in order (src tile fastest); block i takes units i,
    i + grid, ... The chunk count is the one, of 1-32, whose busiest block
    has the least work, counting a unit's tiles plus one tile's worth for
    its src load and merge; the fewest chunks among equals."""
    nkc = -(-c // STAGE_C)
    mb = 2 if nkc <= 6 else 1
    bs = 128 * mb
    n_st, n_dt = -(-s // bs), -(-d // DST_TILE)
    best = None
    for n_chunks in range(1, min(32, n_dt) + 1):
        tpc = -(-n_dt // n_chunks)
        nc = -(-n_dt // tpc)
        tiles = np.full(nc, tpc)
        tiles[-1] = n_dt - (nc - 1) * tpc
        units = n_st * b * nc
        grid = min(n_sm, units)
        cost = np.tile(np.repeat(tiles + 1, n_st), b)  # unit u = (b * nc + chunk) * n_st + st
        busiest = np.bincount(np.arange(units) % grid, weights=cost).max()
        if best is None or busiest < best[0]:
            best = (busiest, n_chunks, tpc, nc, units, grid)
    busiest, n_chunks, tpc, nc, units, grid = best
    return {"depth_stages": nkc, "row_blocks": mb, "src_rows": bs, "src_tiles": n_st,
            "dst_tiles": n_dt, "n_chunks": n_chunks, "tiles_per_chunk": tpc, "chunks": nc,
            "units": units, "grid": grid, "busiest_tiles": float(busiest)}


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
    plan = match_plan(b, s, d, c, torch.cuda.get_device_properties(a.device).multi_processor_count)
    return _launch(a, bt, plan["n_chunks"], plan["grid"])


def _launch(a: torch.Tensor, bt: torch.Tensor, n_chunks: int, grid: int
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """K2 with a given split: each batch's dst tiles in `n_chunks` chunks,
    `grid` persistent blocks (checked inputs; the card tests force every
    split through it)."""
    b, s, c = a.shape
    d = bt.shape[1]
    # chunk-major copies (B, C / 8, rows, 8): a src tile and a dst stage
    # are each one TMA box, in the layout wgmma reads (see the source)
    ac, btc = (t.view(b, -1, c // 8, 8).transpose(1, 2).contiguous() for t in (a, bt))
    keys = torch.empty(s, dtype=torch.int64, device=a.device)
    node_max = torch.empty(s, dtype=torch.float32, device=a.device)
    node_idx = torch.empty(s, dtype=torch.int32, device=a.device)
    fn = kernels.function("match_argmax", "tclight_match_argmax_bf16", K2_ARGTYPES, ctypes.c_int)
    rc = fn(ac.data_ptr(), btc.data_ptr(), keys.data_ptr(), node_max.data_ptr(),
            node_idx.data_ptr(), b, s, d, c, n_chunks, grid,
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
