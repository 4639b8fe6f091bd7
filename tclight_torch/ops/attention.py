"""Multi-head attention for the port (counterpart of
tclight_tpu/ops/attention.py).

Layout: (B, S, H, D) — batch, sequence, heads, head_dim. Inference only.

- `dot_product_attention`: plain matmul + softmax, for short KV (the
  cross-attention over 77 text tokens and every skv <= 512 call).
- `flash_attention`: on a CUDA tensor, the hand-written kernel K1
  (`csrc/flash_attention.cu`); on a CPU tensor, its plain version
  `flash_attention_plain`, the online-softmax loop over KV chunks of
  `_flash_attention_xla`.

K1 replaces the TPU kernel `_flash_kernel` of tclight_tpu/ops/attention.py.
On the H100 it is bound by tensor-core operations: the level-0 UNet
self-attention (~35.6k tokens, 8 heads, head dim 40) is ~3.3 TFLOP on
~0.1 GB of q/k/v/o. Its design keeps the score tile, the softmax state and
the output accumulator of each warp's 16 q rows in registers, runs both
products on mma.sync bf16 tensor cores, pads the head dim only to 16, and
double-buffers the k/v tiles with cp.async (details in the source).
"""

from __future__ import annotations

import ctypes
import math

import torch

from tclight_torch.ops import kernels

__all__ = ["dot_product_attention", "flash_attention", "flash_attention_plain",
           "flash_attention_cuda"]


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float | None = None) -> torch.Tensor:
    """q: (B, Sq, H, D), k/v: (B, Skv, H, D); logits and softmax in f32."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float, kv_chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention over KV chunks in f32 (O(Sq * kv_chunk)
    memory). Keys past the end of a ragged last chunk are simply absent,
    which is the -inf masking of `_flash_attention_xla`."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    qf = q.float().permute(0, 2, 1, 3)  # (B, H, Sq, D)
    m = torch.full((b, h, sq), -math.inf, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    for c0 in range(0, skv, kv_chunk):
        kc = k[:, c0:c0 + kv_chunk].float().permute(0, 2, 3, 1)  # (B, H, D, c)
        vc = v[:, c0:c0 + kv_chunk].float().permute(0, 2, 1, 3)  # (B, H, c, D)
        logits = torch.matmul(qf, kc) * scale
        m_cur = torch.maximum(m, logits.amax(dim=-1))
        alpha = torch.exp(m - m_cur)
        p = torch.exp(logits - m_cur[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.matmul(p, vc)
        m = m_cur
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float) -> torch.Tensor:
    """Launch K1 on bf16 CUDA tensors (B, S, H, D), D % 8 == 0, D <= 160."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.dtype != torch.bfloat16:
            raise ValueError(f"flash_attention kernel: {name} must be a bf16 "
                             f"CUDA tensor, got {t.dtype} on {t.device}")
        if t.dim() != 4 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention kernel: {name} must be a "
                             "contiguous, 16-byte aligned (B, S, H, D) tensor")
    b, sq, h, d = q.shape
    skv = k.shape[1]
    if k.shape != (b, skv, h, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention kernel: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if d % 8 or d > 160:
        raise ValueError(f"flash_attention kernel: head dim {d} must be a "
                         "multiple of 8 and at most 160")
    out = torch.empty_like(q)
    fn = kernels.library("flash_attention").tclight_flash_attention_bf16
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, sq,
            skv, d, float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check_launch(rc, "flash_attention")
    kernels.STATS["flash_attention"].record(d)
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float | None = None) -> torch.Tensor:
    """Memory-efficient attention. q: (B, Sq, H, D); k/v: (B, Skv, H, D).
    A CUDA tensor goes to the kernel (or the call raises); a CPU tensor to
    the plain version."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, scale)
    return flash_attention_plain(q, k, v, scale)
