"""VidToMe token merging around a self-attention, in plain float32.

A chunk of F frames of T tokens each is joined into one sequence of F*T
tokens per batch row. The local merge keeps one dst frame (frame `randf`
mod F) and matches every token of the other frames (src) to its most
similar dst token by cosine similarity; the `int(ratio * n_src)` src
tokens with the highest similarity are merged, i.e. dropped, and take
their dst token's output after the attention ("replace" merging). The
global merge does the same between the locally merged sequence and the
bank carried from the slot before: the first `len` tokens of
[local | bank] (or [bank | local] when `flip`) are src, the rest dst.

One matching serves the whole batch (align_batch): a src token's match is
the maximum over every (batch row, dst token) pair, the first in
batch-major order on a tie. Src tokens rank by that maximum, ties in
their order.

The matching is an argmax, so rounding decides between near-equal
choices, and the clip's repeated frames (a short chunk repeats its last
frame) make exact ties. Given the program's `Matching` (the maximum
similarity of each src token and the batch-major index of its argmax, as
its matcher returned them), the reference ranks and splits by the
program's maxima, as the program does, and takes the program's dst, where
each agrees with its own float32 similarities within `tol`: a maximum that
is off by more is replaced by the reference's, a dst whose similarity lies
more than `tol` below the best by the reference's own. Each replacement is
counted in `stats`; the divergence it makes shows in the step's output.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Matching:
    """One matching of the program: per src token the maximum similarity
    over every (batch row, dst token) and the batch-major index b * D + d
    of its first argmax."""

    node_max: torch.Tensor
    node_idx: torch.Tensor


def _normalise(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + 1e-20)


def _best(a: torch.Tensor, bt: torch.Tensor, block: int = 2048):
    b, s, _ = a.shape
    d = bt.shape[1]
    best = torch.empty(s, dtype=torch.float32, device=a.device)
    arg = torch.empty(s, dtype=torch.long, device=a.device)
    for i in range(0, s, block):
        sc = torch.einsum("bsc,bdc->sbd", a[:, i:i + block], bt).reshape(-1, b * d)
        best[i:i + block], arg[i:i + block] = sc.max(-1).values, sc.argmax(-1)
    return best, arg % d


def match(src: torch.Tensor, dst: torch.Tensor, r: int, matching: Matching | None = None,
          tol: float = 0.0, stats: dict | None = None, quant=None, record: list | None = None):
    """src (B, S, C), dst (B, D, C) -> (merged, dst_of_merged, unmerged):
    src positions merged in rank order and their dst positions, and the
    unmerged src positions in rank order. `quant` rounds the product's
    operands (the control's lower precision); `record` collects this
    matching's own maxima and argmaxes."""
    a, bt = _normalise(src.float()), _normalise(dst.float())
    if quant is not None:
        a, bt = quant(a), quant(bt)
    best, arg = _best(a, bt)
    if record is not None:
        record.append(Matching(best, arg))
    score, dst_of = best, arg
    if matching is not None:
        stats = {} if stats is None else stats
        nm = matching.node_max.to(src.device).float()
        ni = matching.node_idx.to(src.device).long() % bt.shape[1]
        if nm.shape != best.shape:
            raise ValueError(f"the program matched {nm.shape[0]} src tokens, not {best.shape[0]}")
        off = (nm - best).abs()
        chosen = (a * bt[:, ni]).sum(-1).max(0).values
        short = best - chosen
        _count(stats, "max_replaced", int((off > tol).sum()), "max_off", off)
        _count(stats, "dst_replaced", int((short > tol).sum()), "dst_short", short)
        score = torch.where(off > tol, best, nm)
        dst_of = torch.where(short > tol, arg, ni)
    order = torch.argsort(-score, stable=True)
    return order[:r], dst_of[order[:r]], order[r:]


def _count(stats: dict, key: str, n: int, worst_key: str, values: torch.Tensor) -> None:
    stats[key] = stats.get(key, 0) + n
    if values.numel():
        stats[worst_key] = max(stats.get(worst_key, 0.0), float(values.max()))


def local_merge(x: torch.Tensor, frames: int, randf: int, ratio: float, **kw):
    """x (B, F*T, C) -> (merged (B, n_unm + T, C), row (F*T,)): the merged
    sequence [unmerged src in rank order | dst frame], and for every token
    of x the merged row whose output it takes."""
    _, n, _ = x.shape
    t = n // frames
    dst_f = randf % frames
    frame = lambda f: torch.arange(f * t, (f + 1) * t, device=x.device)
    src_pos = torch.cat([frame(f) for f in range(frames) if f != dst_f])
    dst_pos = frame(dst_f)
    m, dm, u = match(x[:, src_pos], x[:, dst_pos], int(len(src_pos) * ratio), **kw)
    row = torch.empty(n, dtype=torch.long, device=x.device)
    row[dst_pos] = len(u) + torch.arange(t, device=x.device)
    row[src_pos[u]] = torch.arange(len(u), device=x.device)
    row[src_pos[m]] = len(u) + dm
    return torch.cat([x[:, src_pos[u]], x[:, dst_pos]], dim=1), row


def global_merge(local: torch.Tensor, bank: torch.Tensor, ratio: float, flip: bool, **kw):
    """-> (merged, row, new_bank): `row` maps each local token to the
    merged row whose output it takes; the new bank is the local sequence
    with its merged tokens replaced by their dst tokens."""
    n = local.shape[1]
    seq = torch.cat([bank, local] if flip else [local, bank], dim=1)
    src, dst = seq[:, :n], seq[:, n:]
    m, dm, u = match(src, dst, int(n * ratio), **kw)
    dev = local.device
    row_all = torch.empty(2 * n, dtype=torch.long, device=dev)
    row_all[n:] = len(u) + torch.arange(n, device=dev)
    row_all[u] = torch.arange(len(u), device=dev)
    row_all[m] = len(u) + dm
    merged = torch.cat([src[:, u], dst], dim=1)
    row = row_all[n:] if flip else row_all[:n]
    return merged, row, merged[:, row]
