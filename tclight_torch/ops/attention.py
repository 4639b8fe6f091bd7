"""Multi-head attention for the port (counterpart of
tclight_tpu/ops/attention.py).

Layout: (B, S, H, D) — batch, sequence, heads, head_dim. Inference only.

- `dot_product_attention`: plain matmul + softmax, for short KV (the
  cross-attention over 77 text tokens and every skv <= 512 call).
- `flash_attention`: on a CUDA tensor, the hand-written kernel K1
  (`csrc/flash_attention.cu`); on a CPU tensor, its plain version
  `flash_attention_plain`, the online-softmax loop over KV chunks of
  `_flash_attention_xla`.
- `flash_attention(..., backend="int8" | "int8pv")`: the int8 variants.
  A quantization pre-pass makes int8 Q with one scale per 1024-row block,
  int8 K (smoothed by its token mean) with one scale per token, and for
  "int8pv" int8 V with one scale per channel. On a CUDA tensor the kernel
  K6 (int8 QK^T, bf16 PV; `csrc/flash_attention_qk_int8.cu`) runs on the
  operands of its own pre-pass kernels (`qk_int8_operands`), and K7 (int8
  QK^T and PV, P quantized per (row, 1024-key block);
  `csrc/flash_attention_int8.cu`) on those of the same pre-pass kernels'
  PV variant (`int8pv_operands`) and of its max pass (`int8_block_rowmax`,
  each (row, P block)'s logit max); on a CPU tensor
  `flash_attention_int8_plain`, the dense emulation of
  `_flash_attention_int8_xla`, one 1024-row block of queries at a time.

K1 replaces the TPU kernel `_flash_kernel` of tclight_tpu/ops/attention.py.
On the H100 the level-0 UNet self-attention (~35.6k tokens, 8 heads, head
dim 40) is ~3.3 TFLOP of products and ~2e10 exponentials on ~0.1 GB of
q/k/v/o: the tensor cores and, at head dim 40, the special-function units
bound it. Its design is warp-specialised: a producer warp feeds a ring of
k/v tiles by TMA (q read in place, k and v from chunk-major copies the
wrapper makes; `flash_geometry` gives the tensor maps), two consumer
warpgroups run both products on wgmma and the softmax in registers, and
overlap one's softmax with the other's products (details in the source). K6
replaces `_flash_kernel_qk_int8` in K1's design, with q.k^T on int8 wgmma
and operands that its pre-pass kernels write in the layout its TMA boxes
read (`qk_int8_geometry`); K7 replaces `_flash_kernel_int8_full` in the
same design, p.v on int8 wgmma too, after a max pass in that design that
writes the P blocks' maxes (`int8pv_geometry`; details in their sources).

The int8 products of the plain version are f32 matmuls of integer-valued
tensors: exact, since |dot| <= 127^2 * 160 < 2^24, as long as TF32 is off
for matmuls (the default).
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from tclight_torch.ops import kernels

__all__ = ["dot_product_attention", "flash_attention", "flash_attention_plain",
           "flash_attention_cuda", "flash_geometry", "flash_attention_int8_plain",
           "flash_attention_int8_cuda", "quantize_rows", "quantize_blocks",
           "quantize_channels", "smooth_k", "int8_prepass", "qk_int8_geometry",
           "qk_int8_operands", "qk_int8_operands_plain", "chunk_major", "from_chunk_major",
           "int8pv_geometry", "int8pv_operands", "int8pv_operands_plain", "v8_chunks",
           "int8_block_rowmax", "int8_block_rowmax_plain", "BACKENDS"]

BACKENDS = (None, "int8", "int8pv")
QBLOCK = 1024  # rows of a Q scale block, and keys of a K7 P-scale block


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float | None = None,
                          mask: torch.Tensor | None = None) -> torch.Tensor:
    """q: (B, Sq, H, D), k/v: (B, Skv, H, D); logits and softmax in f32.
    `mask` is boolean, broadcastable to (B, H, Sq, Skv): False keys get a
    logit of -1e30, as in JAX."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        logits = torch.where(mask, logits, torch.full((), -1e30, device=logits.device))
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


SMEM_PER_BLOCK = 232_448  # dynamic shared memory a block may use on the H100
# tclight_flash_attention_bf16(q, k, v, o, B, H, Sq, Skv, D, scale, stream)
K1_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]


def flash_geometry(b: int, sq: int, skv: int, h: int, d: int) -> dict:
    """K1's launch geometry, as `csrc/flash_attention.cu` lays it out:
    the q.k^T depth `dp` (d padded to 16 by TMA's zero fill, no padded
    copy) and its 16-byte chunks; the 64-row q blocks per consumer
    warpgroup (two up to dp 96, where their registers fit), the q rows per
    block and the keys per k/v tile that follow, the ring depth, the
    dynamic shared memory, the grid, the bytes each mbarrier expects, and
    the 4-d tensor maps (dims innermost first, strides of dims 1-3 in
    bytes, box): q's over (B, S, H, D) as it lies, k's and v's over the
    wrapper's chunk-major copies (B * H, D / 8, S, 8)."""
    dp = _ceil_to(d, 16)
    mb = 2 if dp <= 96 else 1
    bq, bk = 128 * mb, 64 if mb == 2 else 128
    stages = 4 if mb == 2 else (3 if dp <= 128 else 2)
    row = 2 * d  # bytes of one head's row
    # q in place, (D, H, S, B): one box per 16-byte chunk of the q tile
    qmap = {"dims": (d, h, sq, b), "strides": (row, h * row, sq * h * row),
            "box": (8, 1, bq, 1)}
    # k, v as the chunk-major copies (B * H, D / 8, S, 8), as (8, S, D / 8,
    # B * H): one box per tile
    kvmap = {"dims": (8, skv, d // 8, b * h), "strides": (16, skv * 16, skv * 16 * (d // 8)),
             "box": (8, bk, dp // 8, 1)}
    return {"dp": dp, "chunks": dp // 8, "zero_chunks": (dp - d) // 8, "row_blocks": mb,
            "q_rows": bq, "kv_rows": bk, "stages": stages,
            "smem": (bq + 2 * stages * bk) * dp * 2 + 8 * (1 + 2 * stages) + 128,
            "grid": (-(-sq // bq), b * h), "tx_q": bq * dp * 2, "tx_kv": 2 * bk * dp * 2,
            "kv_tiles": -(-skv // bk), "maps": {"q": qmap, "k": kvmap, "v": dict(kvmap)}}


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
    if flash_geometry(b, sq, skv, h, d)["grid"][1] > 65535:
        raise ValueError(f"flash_attention kernel: batch * heads = {b * h} is over "
                         "the grid's 65535")
    # k and v chunk-major, (B * H, D / 8, Skv, 8): one TMA box is a whole
    # k or v tile, in the layout wgmma reads (see the kernel's source)
    kc, vc = (t.view(b, skv, h, d // 8, 8).permute(0, 2, 3, 1, 4).contiguous()
              for t in (k, v))
    out = torch.empty_like(q)
    fn = kernels.function("flash_attention", "tclight_flash_attention_bf16", K1_ARGTYPES,
                          ctypes.c_int)
    rc = fn(q.data_ptr(), kc.data_ptr(), vc.data_ptr(), out.data_ptr(), b, h, sq,
            skv, d, float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check_launch(rc, "flash_attention")
    kernels.STATS["flash_attention"].record((b, sq, skv, h, d))
    return out


# ------------------------------------------------------------ int8 variants


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d as a true division on every device: on the card a Python
    scalar divisor becomes a multiply by its reciprocal, which rounds
    otherwise than JAX's division."""
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)


def _scale(amax: torch.Tensor) -> torch.Tensor:
    return _div(torch.clamp(amax, min=1e-6), 127.0)


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization over the last axis (JAX
    `_quantize_rows`): (int8 values, f32 scales with the last axis
    dropped). round() is half to even, as jnp.round."""
    xf = x.float()
    s = _scale(xf.abs().amax(dim=-1, keepdim=True))
    return torch.round(xf / s).to(torch.int8), s[..., 0]


def quantize_blocks(x: torch.Tensor, block: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization of (N, S, D), S a multiple of `block`,
    with one scale per block of `block` rows (JAX `_quantize_blocks`):
    (int8 values, (N, S / block) scales)."""
    n, s, d = x.shape
    xf = x.float().reshape(n, s // block, block, d)
    sc = _scale(xf.abs().amax(dim=(2, 3), keepdim=True))
    return torch.round(xf / sc).to(torch.int8).reshape(n, s, d), sc[:, :, 0, 0]


def quantize_channels(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-channel int8 quantization of (N, S, D) over S (JAX
    `_quantize_channels`): (int8 values, (N, D) scales)."""
    xf = x.float()
    s = _scale(xf.abs().amax(dim=1, keepdim=True))
    return torch.round(xf / s).to(torch.int8), s[:, 0, :]


def smooth_k(kt: torch.Tensor) -> torch.Tensor:
    """K minus its token mean, per (batch * head), in K's dtype, as JAX
    does it: the mean accumulates in f32 and is rounded to K's dtype, and
    the difference is rounded to it too. The shift changes every logit of
    a query row by the same constant, so the softmax is unchanged."""
    km = kt.float().mean(dim=1, keepdim=True).to(kt.dtype)
    return kt - km


def _heads_first(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) -> (B * H, S, D)."""
    b, s, h, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, s, d)


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softmax: exp(x - max) / sum, over the last axis."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def flash_attention_int8_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               scale: float, pv_int8: bool = False) -> torch.Tensor:
    """The int8 variants' math as JAX's `_flash_attention_int8_xla` does
    it, which is what the JAX package runs off the TPU for both backends:
    smoothed K, per-token K scales and per-1024-row-block Q scales, exact
    integer QK^T, a dense softmax; with `pv_int8`, P quantized per (row,
    1024-key block) against the block's max and V per channel, both
    dequantized before the product. The queries go one Q-scale block at a
    time, so the dense logits of only one block are held."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    qt, kt, vt = _heads_first(q), _heads_first(k), _heads_first(v)
    bq = min(QBLOCK, _ceil_to(sq, 128))
    sq_pad = _ceil_to(sq, bq)
    q8, sqs = quantize_blocks(F.pad(qt, (0, 0, 0, sq_pad - sq)), bq)
    k8, sks = quantize_rows(smooth_k(kt))
    k8f = k8.float().transpose(1, 2)  # (BH, D, Skv), integer valued
    if pv_int8:
        bk = min(QBLOCK, _ceil_to(skv, 128))
        skv_pad = _ceil_to(skv, bk)
        v8, svs = quantize_channels(vt)
        v_in = v8.float() * svs[:, None, :]
    else:
        v_in = vt.float()
    outs = []
    for i, r0 in enumerate(range(0, sq, bq)):
        rows = min(bq, sq - r0)
        dots = torch.matmul(q8[:, r0:r0 + rows].float(), k8f)  # exact
        logits = dots * (scale * sqs[:, i, None, None]) * sks[:, None, :]
        p = _softmax(logits)
        del dots, logits
        if pv_int8:
            pb = F.pad(p, (0, skv_pad - skv)).reshape(-1, rows, skv_pad // bk, bk)
            sp = torch.clamp(pb.amax(dim=-1, keepdim=True), min=1e-30)
            # 127 / sp as one division, as JAX (a scalar numerator would be
            # a reciprocal times 127)
            p8 = torch.round(pb * (torch.full_like(sp, 127.0) / sp))
            p = (p8 * _div(sp, 127.0)).reshape(-1, rows, skv_pad)[:, :, :skv]
            del pb, p8
        else:
            p = p.to(vt.dtype).float()
        outs.append(torch.matmul(p, v_in))
        del p
    out = torch.cat(outs, dim=1)
    return out.reshape(b, h, sq, d).permute(0, 2, 1, 3).to(q.dtype)


def int8_prepass(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pv_int8: bool):
    """The plain version of the pre-pass kernels of K6 and K7, made with
    the plain quantizers above, in a plain layout that
    `qk_int8_operands_plain` and `int8pv_operands_plain` lay out as the
    kernels read them: q8 (BH, Sq_pad, DK) and k8 (BH, Skv_pad, DK) int8
    with the head dim zero-padded to DK, a multiple of the int8 MMA depth
    32 (zero columns change no dot product) and K's tokens to a multiple
    of 64; sq (BH, n_qblocks) and sk (BH, Skv_pad) f32 scales. With
    `pv_int8` also v8 (BH, Skv, D) int8 and sv (BH, D) f32, V quantized
    per channel."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    dk = _ceil_to(d, 32)
    bq = min(QBLOCK, _ceil_to(sq, 128))
    sq_pad, skv_pad = _ceil_to(sq, bq), _ceil_to(skv, 64)
    q8, sqs = quantize_blocks(F.pad(_heads_first(q), (0, dk - d, 0, sq_pad - sq)), bq)
    k8, sks = quantize_rows(F.pad(smooth_k(_heads_first(k)), (0, dk - d, 0, skv_pad - skv)))
    # elementwise results keep their input's strides, and a (B, S, H, D)
    # -> (B * H, S, D) view with B = 1 is not contiguous: the kernels need
    # row-major operands
    ops = {"q8": q8.contiguous(), "k8": k8.contiguous(), "sq": sqs.contiguous(),
           "sk": sks.contiguous(), "bq": bq}
    if pv_int8:
        v8, svs = quantize_channels(_heads_first(v))
        ops["v8"], ops["sv"] = v8.contiguous(), svs.contiguous()
    return ops


def chunk_major(x: torch.Tensor, width: int) -> torch.Tensor:
    """(N, S, C) -> (N, C / width, S, width): the rows' `width`-element
    chunks, chunk by chunk, the layout the kernels' TMA boxes read."""
    n, s, c = x.shape
    return x.reshape(n, s, c // width, width).transpose(1, 2).contiguous()


def from_chunk_major(x: torch.Tensor) -> torch.Tensor:
    """Inverse of `chunk_major`: (N, C / w, S, w) -> (N, S, C)."""
    n, nc, s, w = x.shape
    return x.transpose(1, 2).reshape(n, s, nc * w)


def qk_int8_geometry(b: int, sq: int, skv: int, h: int, d: int) -> dict:
    """The layout of K6's operands, as its pre-pass writes them and its TMA
    boxes read them (`csrc/flash_attention_qk_int8.cu`): the q.k^T depth
    `dk` (d padded to the int8 wgmma's 32 with zero columns) and the p.v
    width `dp` (padded to 16 by TMA's zero fill); the Q-scale block `bq`
    and its count; the K scales padded to 128 keys (zeros); the pre-pass's
    slices of 256 queries and 256 keys, and its f32 scratch (per batch *
    head: each q slice's amax, each k slice's channel sums, the token mean
    and a counter); each operand's shape; the q rows, keys and stages of
    K1's design, which K6 keeps."""
    dk, dp = _ceil_to(d, 32), _ceil_to(d, 16)
    bq = min(QBLOCK, _ceil_to(sq, 128))
    bh = b * h
    mb = 2 if dp <= 96 else 1
    n_qs, n_ks = -(-sq // 256), -(-skv // 256)
    return {"dk": dk, "dp": dp, "bq": bq, "n_qb": -(-sq // bq), "skv_pad": _ceil_to(skv, 128),
            "q_slices": n_qs, "k_slices": n_ks, "row_blocks": mb, "q_rows": 128 * mb,
            "kv_rows": 64 if mb == 2 else 128, "stages": 4 if mb == 2 else (3 if dp <= 128 else 2),
            "shapes": {"q8": (bh, dk // 16, sq, 16), "k8": (bh, dk // 16, skv, 16),
                       "v": (bh, d // 8, skv, 8), "sq": (bh, -(-sq // bq)),
                       "sk": (bh, _ceil_to(skv, 128)), "scratch": (bh, n_qs + n_ks * d + d + 1)}}


def qk_int8_operands_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> dict:
    """K6's operands from the plain pre-pass `int8_prepass`, in the layout
    of `qk_int8_geometry` (the plain version of the pre-pass kernels):
    q8 and k8 chunk-major in 16-byte chunks, only the real rows; v
    chunk-major in 8-element chunks; the K scales of the padded keys 0."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    g = qk_int8_geometry(b, sq, skv, h, d)
    ops = int8_prepass(q, k, v, pv_int8=False)
    return {"q8": chunk_major(ops["q8"][:, :sq], 16), "k8": chunk_major(ops["k8"][:, :skv], 16),
            "v": chunk_major(_heads_first(v), 8), "sq": ops["sq"],
            "sk": F.pad(ops["sk"][:, :skv], (0, g["skv_pad"] - skv)), "bq": g["bq"]}


def v8_chunks(v8: torch.Tensor) -> torch.Tensor:
    """K7's v8 layout from a plain (BH, Skv, D) int8: (BH, ceil16(Skv) /
    16, D, 16), the 16 keys of each channel contiguous (8-bit wgmma reads
    its B operand K-major only), keys past Skv zero, and within each 16
    keys byte 4t + 2a + c holding key 8a + 2t + c: a thread's int32 score
    fragment (keys 2t, 2t + 1 of each 8) then packs as it lies into the s8
    A fragment (bytes 4t..4t+3 of each 16)."""
    bh, skv, d = v8.shape
    n_vc = -(-skv // 16)
    x = F.pad(v8, (0, 0, 0, 16 * n_vc - skv)).reshape(bh, n_vc, 2, 4, 2, d)
    # (bh, chunk, a, t, c, d) -> (bh, chunk, d, t, a, c)
    return x.permute(0, 1, 5, 3, 2, 4).reshape(bh, n_vc, d, 16).contiguous()


def int8pv_geometry(b: int, sq: int, skv: int, h: int, d: int) -> dict:
    """The layout of K7's operands and tiles, as its pre-pass, max pass and
    attention (`csrc/flash_attention_int8.cu`) lay them out: K6's q8, k8,
    sq and sk; v8 (`v8_chunks`) and sv; qb and kb, q8's and k8's values in
    bf16 for the max pass, chunk-major in 8-value chunks with the head dim
    padded to dp = ceil16(D); the P block `pb` (min(1024,
    ceil128(Skv)) keys) and its count; the block maxes (BH, Sq, n_kb); the
    q rows per block (two 64-row blocks per consumer warpgroup up to DP =
    ceil16(D) = 48, one above), the keys per tile (64, 128 for 48 < DP <=
    96), its 4 stages and the tiles per P block; the pre-pass's f32
    scratch; the dynamic shared memory of the attention and the max
    pass."""
    g6 = qk_int8_geometry(b, sq, skv, h, d)
    dk, dp, bh = g6["dk"], g6["dp"], b * h
    mb = 2 if dp <= 48 else 1
    bk = 64 if (mb == 2 or dp > 96) else 128
    pb = min(QBLOCK, _ceil_to(skv, 128))
    n_kb = -(-skv // pb)
    bars = 8 * (1 + 2 * 4) + 128
    shapes = {n: g6["shapes"][n] for n in ("q8", "k8", "sq", "sk")}
    shapes.update(v8=(bh, -(-skv // 16), d, 16), sv=(bh, d), qb=(bh, dp // 8, sq, 8),
                  kb=(bh, dp // 8, skv, 8), blockmax=(bh, sq, n_kb),
                  scratch=(bh * (g6["q_slices"] + 2 * g6["k_slices"] * d + d + 1),))
    return {"dk": dk, "dp": dp, "bq": g6["bq"], "n_qb": g6["n_qb"], "pb": pb, "n_kb": n_kb,
            "row_blocks": mb, "q_rows": 128 * mb, "kv_rows": bk, "stages": 4,
            "tiles_per_block": pb // bk, "skv_pad": g6["skv_pad"],
            "smem": 128 * mb * dk + 4 * bk * (dk + dp + 4) + bars,
            "smem_maxpass": 128 * mb * 2 * dp + 4 * bk * (2 * dp + 4) + bars, "shapes": shapes}


def int8pv_operands_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> dict:
    """K7's operands from the plain pre-pass `int8_prepass`, in the layout
    of `int8pv_geometry` (the plain version of the PV pre-pass kernels):
    K6's q8, k8, sq and sk, v8 by `v8_chunks`, sv, and q8's and k8's values
    in bf16 (qb, kb)."""
    ops = int8_prepass(q, k, v, pv_int8=True)
    b, sq, h, d = q.shape
    skv = k.shape[1]
    g = int8pv_geometry(b, sq, skv, h, d)
    q8, k8 = ops["q8"][:, :sq], ops["k8"][:, :skv]
    return {"q8": chunk_major(q8, 16), "k8": chunk_major(k8, 16),
            "sq": ops["sq"], "sk": F.pad(ops["sk"][:, :skv], (0, g["skv_pad"] - skv)),
            "v8": v8_chunks(ops["v8"]), "sv": ops["sv"],
            "qb": chunk_major(q8[..., :g["dp"]].bfloat16(), 8),
            "kb": chunk_major(k8[..., :g["dp"]].bfloat16(), 8), "bq": g["bq"]}


def int8_block_rowmax_plain(ops: dict, sq: int, skv: int, scale: float) -> torch.Tensor:
    """The plain version of K7's max pass: from the operands of
    `int8pv_operands`, (BH, Sq, n_kb) f32, each (query, P block)'s max of
    the logits in log2 units, w = (f32(q8 . k8) * sk) * c with c = scale *
    log2(e) * sq of the query's Q-scale block, the keys past Skv left out.
    For c > 0 the max is taken before the multiply by c (the same value:
    rounding is monotone), as the kernel does. One Q-scale block of
    queries at a time."""
    q8, k8 = from_chunk_major(ops["q8"]).float(), from_chunk_major(ops["k8"]).float()
    bq = ops["bq"]
    pb = min(QBLOCK, _ceil_to(skv, 128))
    n_kb = -(-skv // pb)
    sk = ops["sk"][:, :skv]
    out = []
    for i, r0 in enumerate(range(0, sq, bq)):
        u = torch.matmul(q8[:, r0:r0 + bq], k8.transpose(1, 2)) * sk[:, None, :]  # exact dots
        c = (torch.tensor(scale, dtype=torch.float32) * 1.4426950408889634).to(u.device) \
            * ops["sq"][:, i, None, None]
        fold = bool((c > 0).all())
        if not fold:
            u = u * c
        u = F.pad(u, (0, n_kb * pb - skv), value=-math.inf)
        m = u.reshape(u.shape[0], u.shape[1], n_kb, pb).amax(dim=-1)
        out.append(m * c if fold else m)
    return torch.cat(out, dim=1)


# tclight_qk_int8_prepass(q, k, v, q8, k8, vc, sq, sk, scratch, B, H, Sq, Skv,
# D, bq, stream)
PREPASS_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
# tclight_flash_attention_qk_int8(q8, k8, vc, sq, sk, o, B, H, Sq, Skv, D,
# bq, scale, stream)
K6_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
# tclight_int8pv_prepass(q, k, v, q8, k8, v8, qb, kb, sq, sk, sv, scratch, B,
# H, Sq, Skv, D, bq, stream)
PV_PREPASS_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
# tclight_int8pv_blockmax(qb, kb, sq, sk, blockmax, B, H, Sq, Skv, D, bq,
# scale, stream)
MAXPASS_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
# tclight_flash_attention_int8pv(q8, k8, v8, sq, sk, sv, blockmax, o, B, H,
# Sq, Skv, D, bq, scale, stream)
K7_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]


def _check_int8_inputs(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for nm, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.dtype != torch.bfloat16:
            raise ValueError(f"{name} kernel: {nm} must be a bf16 CUDA tensor, "
                             f"got {t.dtype} on {t.device}")
        if t.dim() != 4 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} kernel: {nm} must be a contiguous, "
                             "16-byte aligned (B, S, H, D) tensor")
    b, sq, h, d = q.shape
    skv = k.shape[1]
    if k.shape != (b, skv, h, d) or v.shape != k.shape:
        raise ValueError(f"{name} kernel: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if d % 8 or d > 160:
        raise ValueError(f"{name} kernel: head dim {d} must be a multiple of 8 "
                         "and at most 160")
    if b * h > 65535:
        raise ValueError(f"{name} kernel: batch * heads = {b * h} is over the grid's 65535")


def qk_int8_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> dict:
    """K6's operands (`qk_int8_geometry`): on CUDA tensors from the
    hand-written pre-pass kernels, on CPU tensors from the plain version
    `qk_int8_operands_plain`."""
    if not q.is_cuda:
        return qk_int8_operands_plain(q, k, v)
    _check_int8_inputs("flash_attention_int8", q, k, v)
    b, sq, h, d = q.shape
    skv = k.shape[1]
    g = qk_int8_geometry(b, sq, skv, h, d)
    sh = g["shapes"]
    ops = {name: torch.empty(sh[name], dtype=dt, device=q.device) for name, dt in (
        ("q8", torch.int8), ("k8", torch.int8), ("v", torch.bfloat16), ("sq", torch.float32),
        ("sk", torch.float32), ("scratch", torch.float32))}
    fn = kernels.function("flash_attention_qk_int8", "tclight_qk_int8_prepass",
                          PREPASS_ARGTYPES, ctypes.c_int)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), ops["q8"].data_ptr(),
            ops["k8"].data_ptr(), ops["v"].data_ptr(), ops["sq"].data_ptr(),
            ops["sk"].data_ptr(), ops["scratch"].data_ptr(), b, h, sq, skv, d, g["bq"],
            torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check_launch(rc, "flash_attention_int8 pre-pass")
    kernels.STATS["flash_attention_int8_prepass"].record((sq, skv, d))
    del ops["scratch"]
    ops["bq"] = g["bq"]
    return ops


def int8pv_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> dict:
    """K7's operands (`int8pv_geometry`): on CUDA tensors from the PV
    variant of the pre-pass kernels, on CPU tensors from the plain version
    `int8pv_operands_plain`."""
    if not q.is_cuda:
        return int8pv_operands_plain(q, k, v)
    _check_int8_inputs("flash_attention_int8pv", q, k, v)
    b, sq, h, d = q.shape
    skv = k.shape[1]
    g = int8pv_geometry(b, sq, skv, h, d)
    sh = g["shapes"]
    ops = {name: torch.empty(sh[name], dtype=dt, device=q.device) for name, dt in (
        ("q8", torch.int8), ("k8", torch.int8), ("v8", torch.int8), ("qb", torch.bfloat16),
        ("kb", torch.bfloat16), ("sq", torch.float32), ("sk", torch.float32),
        ("sv", torch.float32), ("scratch", torch.float32))}
    fn = kernels.function("flash_attention_qk_int8", "tclight_int8pv_prepass",
                          PV_PREPASS_ARGTYPES, ctypes.c_int)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
            *(ops[n].data_ptr() for n in ("q8", "k8", "v8", "qb", "kb", "sq", "sk", "sv",
                                          "scratch")),
            b, h, sq, skv, d, g["bq"], torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check_launch(rc, "flash_attention_int8pv pre-pass")
    kernels.STATS["flash_attention_int8pv_prepass"].record((sq, skv, d))
    del ops["scratch"]
    ops["bq"] = g["bq"]
    return ops


def int8_block_rowmax(ops: dict, b: int, h: int, sq: int, skv: int, d: int,
                      scale: float) -> torch.Tensor:
    """K7's max pass on the operands of `int8pv_operands`: on CUDA tensors
    the kernel, on CPU tensors `int8_block_rowmax_plain`."""
    if not ops["q8"].is_cuda:
        return int8_block_rowmax_plain(ops, sq, skv, scale)
    g = int8pv_geometry(b, sq, skv, h, d)
    bm = torch.empty(g["shapes"]["blockmax"], dtype=torch.float32, device=ops["q8"].device)
    fn = kernels.function("flash_attention_int8", "tclight_int8pv_blockmax", MAXPASS_ARGTYPES,
                          ctypes.c_int)
    rc = fn(ops["qb"].data_ptr(), ops["kb"].data_ptr(), ops["sq"].data_ptr(),
            ops["sk"].data_ptr(), bm.data_ptr(), b, h, sq, skv, d, ops["bq"], float(scale),
            torch.cuda.current_stream(bm.device).cuda_stream)
    kernels.check_launch(rc, "flash_attention_int8pv max pass")
    kernels.STATS["flash_attention_int8pv_maxpass"].record((sq, skv, d))
    return bm


def flash_attention_int8_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              scale: float, pv_int8: bool = False) -> torch.Tensor:
    """Launch K6 (`pv_int8` False: after its pre-pass kernels) or K7 (after
    the PV pre-pass kernels and the max pass) on bf16 CUDA tensors (B, S,
    H, D), D % 8 == 0, D <= 160."""
    name = "flash_attention_int8pv" if pv_int8 else "flash_attention_int8"
    _check_int8_inputs(name, q, k, v)
    b, sq, h, d = q.shape
    skv = k.shape[1]
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if pv_int8:
        ops = int8pv_operands(q, k, v)
        bm = int8_block_rowmax(ops, b, h, sq, skv, d, scale)
        fn = kernels.function("flash_attention_int8", "tclight_flash_attention_int8pv",
                              K7_ARGTYPES, ctypes.c_int)
        rc = fn(*(ops[n].data_ptr() for n in ("q8", "k8", "v8", "sq", "sk", "sv")),
                bm.data_ptr(), out.data_ptr(), b, h, sq, skv, d, ops["bq"], float(scale),
                stream)
    else:
        ops = qk_int8_operands(q, k, v)
        fn = kernels.function("flash_attention_qk_int8", "tclight_flash_attention_qk_int8",
                              K6_ARGTYPES, ctypes.c_int)
        rc = fn(ops["q8"].data_ptr(), ops["k8"].data_ptr(), ops["v"].data_ptr(),
                ops["sq"].data_ptr(), ops["sk"].data_ptr(), out.data_ptr(), b, h, sq, skv, d,
                ops["bq"], float(scale), stream)
    kernels.check_launch(rc, name)
    kernels.STATS[name].record((sq, skv, d))
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float | None = None, backend: str | None = None
                    ) -> torch.Tensor:
    """Memory-efficient attention. q: (B, Sq, H, D); k/v: (B, Skv, H, D).
    `backend`: None (bf16 products, K1), "int8" (int8 QK^T, K6) or
    "int8pv" (int8 QK^T and PV, K7), the port's names for JAX's
    "pallas", "pallas_int8" and "pallas_int8pv". A CUDA tensor goes to the
    kernel (or the call raises); a CPU tensor to the plain version."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown attention backend {backend!r}; one of {BACKENDS}")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if backend is None:
        if q.is_cuda:
            return flash_attention_cuda(q, k, v, scale)
        return flash_attention_plain(q, k, v, scale)
    pv = backend == "int8pv"
    if q.is_cuda:
        return flash_attention_int8_cuda(q, k, v, scale, pv)
    return flash_attention_int8_plain(q, k, v, scale, pv)
