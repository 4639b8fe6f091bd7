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
  `csrc/flash_attention_int8.cu`, one kernel that makes each P block's
  logit max in a first sweep of its q.k^T) on those of the same pre-pass
  kernels' PV variant (`int8pv_operands`); on a CPU tensor
  `flash_attention_int8_plain`, the dense emulation of
  `_flash_attention_int8_xla`, one 1024-row block of queries at a time.

K1 replaces the TPU kernel `_flash_kernel` of tclight_tpu/ops/attention.py.
On the H100 the level-0 UNet self-attention (~35.6k tokens, 8 heads, head
dim 40) is ~3.3 TFLOP of products and ~2e10 exponentials on ~0.1 GB of
q/k/v/o: the tensor cores and, at head dim 40, the special-function units
bound it. Its design is warp-specialised: a producer warp feeds a ring of
k/v tiles by TMA (q, k and v read in place from (B, S, H, D) at every head
dim, in 64-dim boxes in the 128-byte swizzle, dims past D zero-filled; the
wrapper makes no copy: `flash_kv_operands`; `flash_geometry` gives the
tiles and the tensor maps), two or three consumer warpgroups run both
products on wgmma and the softmax in registers, and overlap one's softmax
with the others' products (details in the source). K6
replaces `_flash_kernel_qk_int8` in K1's design and geometry, with q.k^T on
int8 wgmma; K7 replaces `_flash_kernel_int8_full` in the same design, p.v
on int8 wgmma too, each P block swept twice (its maxes, then its softmax
and p.v) and the row max kept online across P blocks. Both read their
operands in place at every head dim: q8 and k8 row-major in boxes of 128
bytes in the 128-byte swizzle (rows of ceil16(D) bytes, zero-filled to
the int8 depth), v as K1 reads it (K6), v8
channel-major (K7); their pre-pass kernels write q8, k8, the scales and
v8, and no copy of v or of q8 / k8 (`qk_int8_geometry`,
`int8pv_geometry`; details in their sources). The int32 dots become f32
logits by the conversion instruction and a multiply by the key's scale
(K7's softmax by one FMA with the key's scale times the row factor).

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
           "flash_attention_cuda", "flash_geometry", "flash_kv_operands",
           "flash_attention_int8_plain", "flash_attention_int8_cuda", "quantize_rows",
           "quantize_blocks", "quantize_channels", "smooth_k", "int8_prepass", "qk_int8_geometry",
           "qk_int8_operands", "qk_int8_operands_plain", "kernel_k_scales", "int8pv_geometry",
           "int8pv_operands", "int8pv_operands_plain", "v8_channels", "int8_block_rowmax_plain",
           "BACKENDS"]

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
ROUND_MAGIC = 12582912.0  # 1.5 * 2^23: plus an int32 below 2^22 in magnitude, exact in f32
SLAB = 64  # head dims of one of K1's TMA boxes: a 128-byte swizzle row


def flash_geometry(b: int, sq: int, skv: int, h: int, d: int) -> dict:
    """K1's launch geometry, as `csrc/flash_attention.cu` lays it out, by
    the q.k^T depth `dp` (d padded to 16): the 64-dim slabs a row of q, k
    or v takes (`slabs`, ceil(dp / 64)), the consumer warpgroups (three of
    160 registers up to dp 64, else two of 240), one 64-row q block each,
    the q rows per block and the keys per k/v tile that follow (128 keys
    up to dp 128, 64 above, where 128 do not fit), the ring depth, the p.v
    width `pv_width` (dp: it stops inside a slab where dp is not a multiple
    of 64), whether p.v also takes the row sums (`sums_on_tc`: d = dp - 8
    up to dp 64, through a v column of ones at dim d), the softmax's
    independent chains a row for the row max and sum, the threads and a
    consumer's registers, the dynamic shared memory, the grid, the bytes
    each mbarrier expects, and the 4-d tensor maps (dims innermost first,
    strides of dims 1-3 in bytes, box, swizzle in bytes): q, k and v read
    in place from (B, S, H, D), boxes of 64 dims (one 128-byte swizzle
    row) by a tile's rows, `slabs` of them a row; dims past d are outside
    the maps and read as zeros (`zero_dims` of the last slab). The wrapper
    makes no copy (`kv_copies` False)."""
    dp = _ceil_to(d, 16)
    slabs = -(-dp // SLAB)
    nwg = 3 if dp <= 64 else 2
    bq, bk = 64 * nwg, 128 if dp <= 128 else 64
    stages = 4 if dp <= 64 else 3
    row = 2 * d  # bytes of one head's row

    def inplace(s: int, rows: int) -> dict:
        return {"dims": (d, h, s, b), "strides": (row, h * row, s * h * row),
                "box": (SLAB, 1, rows, 1), "swizzle": 128}

    # a consumer thread's registers: the block's launch share less the
    # producer's 24, over the consumers
    regs = ((65536 // (128 * (nwg + 1))) // 8 * 8 * (nwg + 1) - 24) // nwg // 8 * 8
    return {"dp": dp, "slabs": slabs, "zero_dims": slabs * SLAB - d, "consumers": nwg,
            "row_blocks": 1, "q_rows": bq, "kv_rows": bk, "stages": stages, "pv_width": dp,
            "sums_on_tc": d == dp - 8 and dp <= 64, "chains": 2 if dp <= 96 else 1,
            "threads": 128 * (1 + nwg), "registers": regs, "kv_copies": False,
            "smem": (bq + 2 * stages * bk) * slabs * SLAB * 2 + 8 * (1 + 2 * stages) + 1024,
            "grid": (-(-sq // bq), b * h), "tx_q": bq * slabs * SLAB * 2,
            "tx_kv": 2 * bk * slabs * SLAB * 2, "kv_tiles": -(-skv // bk),
            "maps": {"q": inplace(sq, bq), "k": inplace(skv, bk), "v": inplace(skv, bk)}}


def flash_kv_operands(k: torch.Tensor, v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The k and v that K1 reads: the (B, S, H, D) tensors themselves, at
    every head dim (`flash_geometry`'s maps read them in place)."""
    return k, v


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
    kc, vc = flash_kv_operands(k, v)
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


def kernel_k_scales(sk: torch.Tensor) -> torch.Tensor:
    """K7's K scales, from (N, S) f32 scales: (N, 2, S), each key's sk' (the
    scale with its two lowest significand bits cleared) and -1.5 * 2^23 *
    sk', exact in f32: the bits of 1.5 * 2^23 added to an int32 dot x make
    the float 1.5 * 2^23 + x, and one FMA with the pair leaves x * sk'
    rounded once, without the conversion instruction. K7 reads the first
    row: its conversion instruction and a multiply by sk' measured faster
    than the pair's add and FMA. sk' differs from sk by less than 2^-21 of
    it."""
    s = (sk.float().contiguous().view(torch.int32) & ~3).view(torch.float32)
    return torch.stack([s, s * -ROUND_MAGIC], dim=-2)


def _rows_map(n: int, r: int, c: int, box_c: int, rows: int) -> dict:
    """The tensor map of a row-major (N, R, C) int8 operand
    (`tensor_map_rows_sw` of csrc/hopper.cuh): dims innermost first,
    strides in bytes, boxes of `box_c` values of a row (128, or 64 in the
    64-byte swizzle) by `rows` rows, ceil(C / box_c) a row, the values past
    C read as zeros."""
    return {"dims": (c, r, n, 1), "strides": (c, c * r, c * r * n), "box": (box_c, rows, 1, 1),
            "swizzle": box_c}


def qk_int8_geometry(b: int, sq: int, skv: int, h: int, d: int) -> dict:
    """The layout of K6's operands, as its pre-pass writes them and its TMA
    boxes read them (`csrc/flash_attention_qk_int8.cu`), at every head dim:
    the q.k^T depth `dk` (d padded to the int8 wgmma's 32 by TMA's zero
    fill) and the p.v width `dp` (d padded to 16), which is also the bytes
    of a q8 or k8 row (`row_bytes`); the bytes of a row of q8's and k8's
    boxes (`row8`: 64, in the 64-byte swizzle, where dk fits it, else 128)
    and the boxes a row (`slabs8`); the Q-scale block `bq` and its count;
    the K scales padded to 128 keys (zeros); the pre-pass's slices of 256
    queries and 256 keys, and its f32 scratch (per batch * head: each q
    slice's amax, each k slice's channel sums, the token mean and a
    counter); each operand's shape: q8 and k8 row-major, v the input read
    in place (the pre-pass copies nothing); K1's tiles (`flash_geometry`:
    consumer warpgroups, q rows, keys per tile, stages, the row sums on the
    tensor cores at d = dp - 8 up to dp 64); the dynamic shared memory; and
    the tensor maps (`maps`): q8 and k8 in boxes of row8 bytes by a tile's
    rows, v K1's."""
    k1 = flash_geometry(b, sq, skv, h, d)
    dk, dp = _ceil_to(d, 32), k1["dp"]
    bq = min(QBLOCK, _ceil_to(sq, 128))
    bh = b * h
    n_qs, n_ks = -(-sq // 256), -(-skv // 256)
    row8 = 64 if dk <= 64 else 128
    slabs8 = -(-dk // row8)
    bk, stages = k1["kv_rows"], k1["stages"]
    stage = bk * (slabs8 * row8 + k1["slabs"] * SLAB * 2 + 4)
    return {"dk": dk, "dp": dp, "row_bytes": dp, "row8": row8, "slabs8": slabs8, "bq": bq,
            "n_qb": -(-sq // bq), "skv_pad": _ceil_to(skv, 128), "q_slices": n_qs,
            "k_slices": n_ks,
            **{key: k1[key] for key in ("consumers", "q_rows", "kv_rows", "stages", "sums_on_tc",
                                        "threads", "grid")},
            "smem": k1["q_rows"] * slabs8 * row8 + stages * stage + 8 * (1 + 2 * stages) + 1024,
            "shapes": {"q8": (bh, sq, dp), "k8": (bh, skv, dp), "v": (b, skv, h, d),
                       "sq": (bh, -(-sq // bq)), "sk": (bh, _ceil_to(skv, 128)),
                       "scratch": (bh, n_qs + n_ks * d + d + 1)},
            "maps": {"q8": _rows_map(bh, sq, dp, row8, k1["q_rows"]),
                     "k8": _rows_map(bh, skv, dp, row8, bk), "v": k1["maps"]["v"]}}


def _int8_rows_layout(x: torch.Tensor, s: int, d: int) -> torch.Tensor:
    """q8 or k8 (BH, S_pad, DK) of the plain pre-pass in the kernels'
    layout: its S real rows, row-major, ceil16(d) bytes a row."""
    return x[:, :s, :_ceil_to(d, 16)].contiguous()


def qk_int8_operands_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> dict:
    """K6's operands from the plain pre-pass `int8_prepass`, in the layout
    of `qk_int8_geometry` (the plain version of the pre-pass kernels):
    q8 and k8 row-major, only the real rows; v itself (read in place); the
    K scales of the padded keys 0."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    g = qk_int8_geometry(b, sq, skv, h, d)
    ops = int8_prepass(q, k, v, pv_int8=False)
    return {"q8": _int8_rows_layout(ops["q8"], sq, d), "k8": _int8_rows_layout(ops["k8"], skv, d),
            "v": v, "sq": ops["sq"], "sk": F.pad(ops["sk"][:, :skv], (0, g["skv_pad"] - skv)),
            "bq": g["bq"]}


def v8_channels(v8: torch.Tensor) -> torch.Tensor:
    """K7's v8 layout from a plain (BH, Skv, D) int8: (BH, D,
    ceil128(Skv)), each channel's keys contiguous (a channel's keys of a
    tile are one swizzle row, K-major for the s8 wgmma), keys past Skv
    zero, and within each 16 keys byte 4t + 2a + c holding key 8a + 2t + c:
    a thread's int32 score fragment (keys 2t, 2t + 1 of each 8) then packs
    as it lies into the k32 A fragment, whose bytes 4t..4t+3 of each 16 are
    a thread's keys 2t, 2t + 1, 8 + 2t, 9 + 2t."""
    bh, skv, d = v8.shape
    n16 = _ceil_to(skv, 128) // 16
    x = F.pad(v8, (0, 0, 0, 16 * n16 - skv)).reshape(bh, n16, 2, 4, 2, d)
    # (bh, chunk, a, t, c, d) -> (bh, d, chunk, t, a, c)
    return x.permute(0, 5, 1, 3, 2, 4).reshape(bh, d, 16 * n16).contiguous()


def int8pv_geometry(b: int, sq: int, skv: int, h: int, d: int) -> dict:
    """The layout of K7's operands and tiles, as its pre-pass and its kernel
    (`csrc/flash_attention_int8.cu`) lay them out, at every head dim: K6's
    q8, k8, sq, boxes and keys per tile (K1's), with three consumer
    warpgroups up to dp 48 and two above (the live registers outgrow three
    above); the K scales as `kernel_k_scales` makes them, (BH, 2,
    ceil128(Skv)); v8 channel-major (BH, D, ceil128(Skv)) (`v8_channels`)
    and sv; the P block `pb` (min(1024, ceil128(Skv)) keys), its count and
    the tiles per P block; the k8 ring (`k_slots`, each a tile and its keys'
    scales sk'): with `resident` the tiles of a P block and of the next
    one's first sweep, each k8 tile loaded once, where that ring fits the
    block's shared memory (dp <= 112), else four slots, each tile loaded
    twice; the v8 ring (K6's `stages`); the pre-pass's f32 scratch; the
    dynamic shared memory; and the tensor maps: K6's q8 and k8, and v8 in
    boxes of a tile's keys by dp channels, in the 128-byte swizzle at
    128-key tiles and the 64-byte one at 64."""
    g6 = qk_int8_geometry(b, sq, skv, h, d)
    dk, dp, bh, bk, stages = g6["dk"], g6["dp"], b * h, g6["kv_rows"], g6["stages"]
    nwg, row8, slabs8 = 3 if dp <= 48 else 2, g6["row8"], g6["slabs8"]
    pb = min(QBLOCK, _ceil_to(skv, 128))
    skv_pad = g6["skv_pad"]
    shapes = {n: g6["shapes"][n] for n in ("q8", "k8", "sq")}
    shapes.update(sk=(bh, 2, skv_pad), v8=(bh, d, skv_pad), sv=(bh, d),
                  scratch=(bh * (g6["q_slices"] + 2 * g6["k_slices"] * d + d + 1),))

    def smem(slots: int) -> int:
        return (64 * nwg * slabs8 * row8 + slots * bk * (slabs8 * row8 + 4) + stages * dp * bk
                + 8 * (1 + 2 * slots + 2 * stages) + 1024)

    slots = QBLOCK // bk + (4 if dp <= 64 else 2)
    resident = smem(slots) <= SMEM_PER_BLOCK
    slots = slots if resident else 4
    return {"dk": dk, "dp": dp, "row8": row8, "slabs8": slabs8, "bq": g6["bq"],
            "n_qb": g6["n_qb"], "pb": pb, "n_kb": -(-skv // pb), "consumers": nwg,
            "q_rows": 64 * nwg, "threads": 128 * (1 + nwg), "grid": (-(-sq // (64 * nwg)), bh),
            "kv_rows": bk, "stages": stages, "k_slots": slots,
            "resident": resident, "tiles_per_block": pb // bk, "skv_pad": skv_pad,
            "smem": smem(slots), "shapes": shapes,
            "maps": {"q8": _rows_map(bh, sq, dp, row8, 64 * nwg), "k8": g6["maps"]["k8"],
                     "v8": _rows_map(bh, d, skv_pad, bk, dp)}}


def int8pv_operands_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> dict:
    """K7's operands from the plain pre-pass `int8_prepass`, in the layout
    of `int8pv_geometry` (the plain version of the PV pre-pass kernels):
    K6's q8, k8 and sq, the K scales by `kernel_k_scales`, v8 by
    `v8_channels`, and sv."""
    ops = int8_prepass(q, k, v, pv_int8=True)
    b, sq, h, d = q.shape
    skv = k.shape[1]
    g = int8pv_geometry(b, sq, skv, h, d)
    return {"q8": _int8_rows_layout(ops["q8"], sq, d), "k8": _int8_rows_layout(ops["k8"], skv, d),
            "sq": ops["sq"],
            "sk": F.pad(kernel_k_scales(ops["sk"][:, :skv]), (0, g["skv_pad"] - skv)),
            "sv": ops["sv"], "v8": v8_channels(ops["v8"]), "bq": g["bq"]}


def int8_block_rowmax_plain(ops: dict, sq: int, skv: int, scale: float) -> torch.Tensor:
    """The plain version of K7's first sweep: from the operands of
    `int8pv_operands`, (BH, Sq, n_kb) f32, each (query, P block)'s max of
    the logits in log2 units, w = (f32(q8 . k8) * sk') * c with sk' the
    kernels' K scale (`kernel_k_scales`) and c = scale * log2(e) * sq of
    the query's Q-scale block, the keys past Skv left out. For c > 0 the
    max is taken before the multiply by c (the same value: rounding is
    monotone), as the kernel does. One Q-scale block of queries at a
    time."""
    q8, k8 = ops["q8"].float(), ops["k8"].float()
    bq = ops["bq"]
    pb = min(QBLOCK, _ceil_to(skv, 128))
    n_kb = -(-skv // pb)
    sk = ops["sk"][:, 0, :skv]
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


# tclight_qk_int8_prepass(q, k, q8, k8, sq, sk, scratch, B, H, Sq, Skv, D, bq,
# stream)
PREPASS_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
# tclight_flash_attention_qk_int8(q8, k8, v, sq, sk, o, B, H, Sq, Skv, D, bq,
# scale, stream)
K6_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
# tclight_int8pv_prepass(q, k, v, q8, k8, v8, sq, sk, sv, scratch, B, H, Sq,
# Skv, D, bq, stream)
PV_PREPASS_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
# tclight_flash_attention_int8pv(q8, k8, v8, sq, sk, sv, o, B, H, Sq, Skv,
# D, bq, scale, stream)
K7_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]


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


def _empty_operands(g: dict, names, device) -> dict:
    """Uninitialised operands of the pre-pass kernels, shaped by the geometry
    `g`: the int8 ones (q8, k8, v8) and the f32 ones."""
    return {n: torch.empty(g["shapes"][n], device=device,
                           dtype=torch.int8 if n in ("q8", "k8", "v8") else torch.float32)
            for n in names}


def qk_int8_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> dict:
    """K6's operands (`qk_int8_geometry`): on CUDA tensors from the
    hand-written pre-pass kernels, on CPU tensors from the plain version
    `qk_int8_operands_plain`. v is read in place: the pre-pass copies
    nothing."""
    if not q.is_cuda:
        return qk_int8_operands_plain(q, k, v)
    _check_int8_inputs("flash_attention_int8", q, k, v)
    b, sq, h, d = q.shape
    skv = k.shape[1]
    g = qk_int8_geometry(b, sq, skv, h, d)
    ops = _empty_operands(g, ("q8", "k8", "sq", "sk", "scratch"), q.device)
    fn = kernels.function("flash_attention_qk_int8", "tclight_qk_int8_prepass",
                          PREPASS_ARGTYPES, ctypes.c_int)
    rc = fn(q.data_ptr(), k.data_ptr(), *(ops[n].data_ptr() for n in ("q8", "k8", "sq", "sk",
                                                                     "scratch")),
            b, h, sq, skv, d, g["bq"], torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check_launch(rc, "flash_attention_int8 pre-pass")
    kernels.STATS["flash_attention_int8_prepass"].record((sq, skv, d))
    del ops["scratch"]
    return ops | {"v": v, "bq": g["bq"]}


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
    names = ("q8", "k8", "v8", "sq", "sk", "sv", "scratch")
    ops = _empty_operands(g, names, q.device)
    fn = kernels.function("flash_attention_qk_int8", "tclight_int8pv_prepass",
                          PV_PREPASS_ARGTYPES, ctypes.c_int)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), *(ops[n].data_ptr() for n in names),
            b, h, sq, skv, d, g["bq"], torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check_launch(rc, "flash_attention_int8pv pre-pass")
    kernels.STATS["flash_attention_int8pv_prepass"].record((sq, skv, d))
    del ops["scratch"]
    return ops | {"bq": g["bq"]}


def flash_attention_int8_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              scale: float, pv_int8: bool = False) -> torch.Tensor:
    """Launch K6 (`pv_int8` False: after its pre-pass kernels) or K7 (after
    the PV pre-pass kernels) on bf16 CUDA tensors (B, S, H, D), D % 8 ==
    0, D <= 160."""
    name = "flash_attention_int8pv" if pv_int8 else "flash_attention_int8"
    _check_int8_inputs(name, q, k, v)
    b, sq, h, d = q.shape
    skv = k.shape[1]
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if pv_int8:
        ops = int8pv_operands(q, k, v)
        fn = kernels.function("flash_attention_int8", "tclight_flash_attention_int8pv",
                              K7_ARGTYPES, ctypes.c_int)
        rc = fn(*(ops[n].data_ptr() for n in ("q8", "k8", "v8", "sq", "sk", "sv")),
                out.data_ptr(), b, h, sq, skv, d, ops["bq"], float(scale), stream)
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
