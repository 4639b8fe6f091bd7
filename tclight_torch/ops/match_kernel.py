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
Its design keeps each score tile and the running (max, index) of its rows
in registers, so no score reaches device memory, and streams the dst rows
through double-buffered shared memory (details in the source).
"""

from __future__ import annotations

import ctypes

import torch

from tclight_torch.ops import kernels

__all__ = ["online_argmax_scores", "online_argmax_scores_plain",
           "online_argmax_scores_cuda"]


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
    if c % 8 or c > 768:
        raise ValueError(f"match kernel: channels {c} must be a multiple of 8 "
                         "and at most 768")
    node_max = torch.empty(s, dtype=torch.float32, device=a.device)
    node_idx = torch.empty(s, dtype=torch.int32, device=a.device)
    fn = kernels.library("match_argmax").tclight_match_argmax_bf16
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(a.data_ptr(), bt.data_ptr(), node_max.data_ptr(),
            node_idx.data_ptr(), b, s, d, c,
            torch.cuda.current_stream(a.device).cuda_stream)
    kernels.check_launch(rc, "online_argmax_scores")
    kernels.STATS["online_argmax_scores"].record((s, d))
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
