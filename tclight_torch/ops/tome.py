"""Token merging (VidToMe) as explicit functional ops (counterpart of
tclight_tpu/ops/tome.py).

A joined chunk is ``[unm_pre | frame_0 tokens | frame_1 tokens | ...]``; a
merged sequence is ``[unmerged_src | dst]`` with dst = ``[dst frame tokens,
previous unmerged]``. The random choices (dst frame `randf`, global `flip`)
are host values drawn by the caller.

Every batch-aligned matching goes through `online_argmax_scores` (kernel
K2 on CUDA, the dense plain version on the CPU), so the port has one tie
rule everywhere: the b-major first occurrence. The chunked scan
`_greedy_match_chunked` of the JAX package, whose ties are chunk-major, has
no counterpart here.

A yt slot captured into CUDA graphs (pipeline/slot_graphs.py) splits its
capture at each matching: inside `matcher_hook(hook)` a batch-aligned
matching calls `hook(a, bt)` in place of the matcher.

Hazard: `jnp.argsort` is stable, so every sort here passes `stable=True`.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Sequence

import torch

from tclight_torch.ops.match_kernel import online_argmax_scores

__all__ = [
    "MergeIndices", "LocalLevelSpec", "plan_local_levels",
    "compute_local_merge", "compute_split_merge", "tome_merge",
    "tome_unmerge", "unmerge_rows", "compose_rows", "gather_rows",
    "join_frame", "split_frame", "local_merge_sequence", "local_unmerge_rows",
    "local_unmerge_sequence", "global_merge", "global_unmerge_rows",
    "global_unmerge", "matcher_hook",
]

_matcher_hook = None  # set by `matcher_hook`; None calls the matcher


@contextlib.contextmanager
def matcher_hook(hook):
    """Route every batch-aligned matching to `hook(a, bt)`, which returns
    (node_max, node_idx) as `online_argmax_scores` does, while the block
    runs."""
    global _matcher_hook
    prev, _matcher_hook = _matcher_hook, hook
    try:
        yield
    finally:
        _matcher_hook = prev


def join_frame(x: torch.Tensor, fsize: int) -> torch.Tensor:
    """(B*F, N, C) -> (B, F*N, C)."""
    bf, n, c = x.shape
    return x.reshape(bf // fsize, fsize * n, c)


def split_frame(x: torch.Tensor, fsize: int) -> torch.Tensor:
    """(B, F*N, C) -> (B*F, N, C)."""
    b, fn, c = x.shape
    return x.reshape(b * fsize, fn // fsize, c)


class MergeIndices(NamedTuple):
    """a_idx (S,), b_idx (D,): src / dst positions in the full sequence;
    unm_idx (Bi, S-r), src_idx (Bi, r): indices into src; dst_idx (Bi, r):
    dst slot of each merged src token; n_total = S + D."""

    a_idx: torch.Tensor
    b_idx: torch.Tensor
    unm_idx: torch.Tensor
    src_idx: torch.Tensor
    dst_idx: torch.Tensor
    n_total: int


class LocalLevelSpec(NamedTuple):
    f: int
    tnum: int
    unm_pre: int
    stride: int
    n_dst_frames: int
    r: int
    n_src: int
    n_dst: int


def plan_local_levels(f: int, tnum: int, ratio: float, target_stride: int = 4
                      ) -> list[LocalLevelSpec]:
    """Static plan of the recursive local merge chain: F frames merge down
    to F // stride dst frames until one frame remains."""
    levels: list[LocalLevelSpec] = []
    unm_pre = 0
    cur_f = f
    while cur_f > 1:
        stride = min(target_stride, cur_f)
        if cur_f % stride != 0:
            raise ValueError(
                f"frame count {cur_f} not a multiple of stride {stride}; "
                "pad the chunk to a multiple of the target stride")
        n_dst_frames = cur_f // stride
        n_src = (cur_f - n_dst_frames) * tnum
        n_dst = n_dst_frames * tnum + unm_pre
        r = min(n_src, int(n_src * ratio))
        levels.append(LocalLevelSpec(cur_f, tnum, unm_pre, stride, n_dst_frames,
                                     r, n_src, n_dst))
        unm_pre += n_src - r
        cur_f = n_dst_frames
    return levels


def _greedy_match(metric: torch.Tensor, a_idx: torch.Tensor,
                  b_idx: torch.Tensor, r: int, align_batch: bool):
    """Cosine-similarity greedy bipartite matching. Returns (unm_idx,
    src_idx, dst_idx), each (Bi, ·) with Bi = 1 when aligned."""
    mn = metric * torch.rsqrt(
        (metric.float() ** 2).sum(dim=-1, keepdim=True) + 1e-20).to(metric.dtype)
    a = mn[:, a_idx].contiguous()  # (B, S, C)
    b = mn[:, b_idx].contiguous()  # (B, D, C)
    d = b.shape[1]
    if align_batch:
        # one matching shared across the batch: max over all (b, d)
        match = online_argmax_scores if _matcher_hook is None else _matcher_hook
        node_max, node_idx = match(a, b)
        edge_idx = torch.argsort(-node_max, stable=True)
        src_idx = edge_idx[:r][None]
        unm_idx = edge_idx[r:][None]
        dst_idx = (node_idx[src_idx[0]].long() % d)[None]
        return unm_idx, src_idx, dst_idx
    scores = torch.einsum("bsc,bdc->bsd", a.float(), b.float())
    node_max, node_idx = scores.max(dim=-1)
    edge_idx = torch.argsort(-node_max, dim=-1, stable=True)
    src_idx = edge_idx[:, :r]
    unm_idx = edge_idx[:, r:]
    dst_idx = torch.gather(node_idx, 1, src_idx)
    return unm_idx, src_idx, dst_idx


def compute_local_merge(metric: torch.Tensor, spec: LocalLevelSpec, randf: int,
                        align_batch: bool = True) -> MergeIndices:
    """Merge indices for one local level; `randf` in [0, spec.stride)
    chooses the dst frame group."""
    f, tnum, unm_pre = spec.f, spec.tnum, spec.unm_pre
    dev = metric.device
    is_dst_f = (torch.arange(f, device=dev) % spec.stride) == randf
    # stable partition of the frame axis: src frames in order, then dst
    order_f = torch.argsort(is_dst_f.to(torch.int8), stable=True)
    order = (order_f[:, None] * tnum
             + torch.arange(tnum, device=dev)[None, :]).reshape(-1)
    a_idx = order[: spec.n_src] + unm_pre
    b_frames = order[spec.n_src:] + unm_pre
    b_idx = torch.cat([b_frames, torch.arange(unm_pre, device=dev)])
    unm_idx, src_idx, dst_idx = _greedy_match(metric, a_idx, b_idx, spec.r,
                                              align_batch)
    return MergeIndices(a_idx, b_idx, unm_idx, src_idx, dst_idx,
                        f * tnum + unm_pre)


def compute_split_merge(metric: torch.Tensor, src_len: int, ratio: float,
                        align_batch: bool = True) -> MergeIndices:
    """[src | dst] split matching: the first `src_len` tokens are src."""
    n = metric.shape[1]
    r = min(src_len, int(src_len * ratio))
    a_idx = torch.arange(src_len, device=metric.device)
    b_idx = torch.arange(src_len, n, device=metric.device)
    unm_idx, src_idx, dst_idx = _greedy_match(metric, a_idx, b_idx, r,
                                              align_batch)
    return MergeIndices(a_idx, b_idx, unm_idx, src_idx, dst_idx, n)


def _bcast_rows(idx: torch.Tensor, b: int) -> torch.Tensor:
    return idx.expand((b,) + tuple(idx.shape[1:]))


def gather_rows(y: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Apply a row map: (B, M, C), (Bi, N) -> (B, N, C)."""
    b, _, c = y.shape
    idx = _bcast_rows(rows, b)
    return torch.gather(y, 1, idx[..., None].expand(b, idx.shape[1], c))


def tome_merge(x: torch.Tensor, mi: MergeIndices, mode: str = "replace"
               ) -> torch.Tensor:
    """(B, N, C) -> (B, n_unm + n_dst, C) = [unm | dst].

    "replace": merged src tokens are dropped (dst wins), TC-Light's
    default. "mean": each dst row becomes the mean of itself and the src
    rows merged into it (torch scatter_reduce "mean", include_self)."""
    if mode == "replace":
        # one composed gather: the unmerged src rows sit at a_idx[unm_idx]
        comp = torch.cat([mi.a_idx[mi.unm_idx],
                          mi.b_idx[None].expand(mi.unm_idx.shape[0], -1)], dim=1)
        return gather_rows(x, comp)
    if mode != "mean":
        raise ValueError(f"unknown merge mode {mode!r}")
    b, _, c = x.shape
    src, dst = x[:, mi.a_idx], x[:, mi.b_idx]
    n_dst = dst.shape[1]
    src_sel = gather_rows(src, mi.src_idx).reshape(-1, c)
    # flat (batch, dst slot) rows, so one index_add_ serves the whole batch
    rows = (_bcast_rows(mi.dst_idx, b)
            + n_dst * torch.arange(b, device=x.device)[:, None]).reshape(-1)
    sums = torch.zeros((b * n_dst, c), dtype=x.dtype, device=x.device)
    sums.index_add_(0, rows, src_sel)
    counts = torch.zeros(b * n_dst, dtype=x.dtype, device=x.device)
    counts.index_add_(0, rows, torch.ones_like(rows, dtype=x.dtype))
    dst = (dst + sums.reshape(b, n_dst, c)) / (1.0 + counts.reshape(b, n_dst, 1))
    return torch.cat([gather_rows(src, mi.unm_idx), dst], dim=1)


def tome_unmerge(y: torch.Tensor, mi: MergeIndices) -> torch.Tensor:
    """Invert `tome_merge`: (B, n_unm + n_dst, C) -> (B, N, C); a merged
    src token takes its dst token's value."""
    return gather_rows(y, unmerge_rows(mi))


def unmerge_rows(mi: MergeIndices) -> torch.Tensor:
    """Row map g (Bi, n_total) inverting `tome_merge`:
    unmerged[p] = merged[g[p]]. The dst, unmerged-src and merged-src write
    sets partition [0, n_total)."""
    bi = mi.unm_idx.shape[0]
    n_unm = mi.unm_idx.shape[-1]
    dev = mi.b_idx.device
    unm_pos = mi.a_idx[mi.unm_idx]
    src_pos = mi.a_idx[mi.src_idx]
    d_rows = n_unm + torch.arange(mi.b_idx.shape[0], device=dev)
    g = torch.zeros((bi, mi.n_total), dtype=torch.long, device=dev)
    g[:, mi.b_idx] = d_rows
    g.scatter_(1, unm_pos, torch.arange(n_unm, device=dev).expand(bi, -1))
    g.scatter_(1, src_pos, n_unm + mi.dst_idx)
    return g


def compose_rows(outer: torch.Tensor, inner: torch.Tensor) -> torch.Tensor:
    """result[b, q] = outer[b, inner[b, q]] (batch dims broadcast)."""
    bb = max(outer.shape[0], inner.shape[0])
    return torch.gather(_bcast_rows(outer, bb), 1, _bcast_rows(inner, bb))


def local_merge_sequence(x: torch.Tensor, metric: torch.Tensor,
                         levels: Sequence[LocalLevelSpec], randf: int,
                         align_batch: bool = True, mode: str = "replace"
                         ) -> tuple[torch.Tensor, list[MergeIndices]]:
    """The full local merge chain on a joined sequence (B, F*T, C); the
    same `randf` drives every level."""
    infos: list[MergeIndices] = []
    for spec in levels:
        mi = compute_local_merge(metric, spec, randf % spec.stride, align_batch)
        x = tome_merge(x, mi, mode)
        metric = tome_merge(metric, mi, mode)
        infos.append(mi)
    return x, infos


def local_unmerge_rows(infos: Sequence[MergeIndices]) -> torch.Tensor:
    """Composed row map of the whole local chain."""
    rows = unmerge_rows(infos[0])
    for mi in infos[1:]:
        rows = compose_rows(unmerge_rows(mi), rows)
    return rows


def local_unmerge_sequence(y: torch.Tensor, infos: Sequence[MergeIndices]
                           ) -> torch.Tensor:
    """Invert the whole local chain in one gather."""
    return gather_rows(y, local_unmerge_rows(infos))


def global_merge(local_tokens: torch.Tensor, global_tokens: torch.Tensor,
                 metric_local: torch.Tensor, metric_global: torch.Tensor,
                 ratio: float, flip: bool, align_batch: bool = True,
                 mode: str = "replace") -> tuple[torch.Tensor, MergeIndices, bool]:
    """Merge local tokens against the carried global token bank; `flip`
    picks which side is src."""
    if local_tokens.shape != global_tokens.shape:
        raise ValueError("global bank must match the local merged length")
    src_len = local_tokens.shape[1]

    def _order(a, b):
        return torch.cat([b, a] if flip else [a, b], dim=1)

    tokens = _order(local_tokens, global_tokens)
    metric = _order(metric_local, metric_global)
    mi = compute_split_merge(metric, src_len, ratio, align_batch)
    return tome_merge(tokens, mi, mode), mi, flip


def global_unmerge_rows(mi: MergeIndices, flip: bool, src_len: int
                        ) -> torch.Tensor:
    """Row map restoring the local half of a global merge."""
    rows = unmerge_rows(mi)
    return rows[:, src_len:] if flip else rows[:, :src_len]


def global_unmerge(y: torch.Tensor, mi: MergeIndices, flip: bool, src_len: int
                   ) -> torch.Tensor:
    """Invert `global_merge`, returning the restored local chunk."""
    return gather_rows(y, global_unmerge_rows(mi, flip, src_len))
