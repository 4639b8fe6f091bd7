"""The UNet of IC-Light fc on SD1.5 in plain float32, with VidToMe merging.

Weights are a dict under diffusers' UNet2DConditionModel keys. Activations
are NCHW; the entry takes NHWC (B*F, H, W, C) with B the CFG batch and F
the frames of a chunk. Equations as published (SD1.5: resnets with
GroupNorm 32 / eps 1e-5 and timestep projection; Transformer2D with
GroupNorm eps 1e-6, 1x1 proj in / out, a block of self-attention,
cross-attention and a GEGLU feed-forward, LayerNorm eps 1e-5; sinusoidal
timestep embedding with cos first), with two departures that the
configuration's file lists under `departures`: the downsampler pads by
(0, 1) on the right and bottom before its stride-2 convolution, and an
upsample to an odd skip size takes the nearest-exact rows.

Token merging runs around each self-attention at levels whose downsample
factor is at most `max_downsample` (tome.py); each such block reads the
bank its previous slot left and leaves its own. With `matchings` set, the
matchings follow the program's maxima and argmaxes where they agree with
the reference's within `tol` (tome.match).

`attention_calls` / `match_calls`, when lists, collect the shapes of the
self-attentions over more than 512 keys and of the matchings, for the
roofline bounds.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from tcbench.reference import tome

ATTN_QUERY_BLOCK = 2048


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                       device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one scale for the tensor (its
    maximum at 448), back in float32: the operands of the control's
    products."""
    scale = 448.0 / x.abs().amax().clamp(min=1e-30)
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
              quant=None) -> torch.Tensor:
    """(B, Sq, C), (B, Skv, C) x2 -> (B, Sq, C): softmax(q k^T / sqrt(d)) v
    per head, one block of queries at a time; `quant` rounds the products'
    operands."""
    qt = quant or (lambda t: t)
    b, sq, c = q.shape
    d = c // heads
    qh = q.reshape(b, sq, heads, d).transpose(1, 2)
    kh = qt(k.reshape(b, -1, heads, d).transpose(1, 2))
    vh = qt(v.reshape(b, -1, heads, d).transpose(1, 2))
    out = torch.empty_like(qh)
    for i in range(0, sq, ATTN_QUERY_BLOCK):
        s = torch.matmul(qt(qh[:, :, i:i + ATTN_QUERY_BLOCK]), kh.transpose(-1, -2)) / math.sqrt(d)
        out[:, :, i:i + ATTN_QUERY_BLOCK] = torch.matmul(qt(torch.softmax(s, dim=-1)), vh)
    return out.transpose(1, 2).reshape(b, sq, c)


class UNet:
    def __init__(self, weights: dict, cfg: dict, tome_cfg: dict,
                 attention_calls: list | None = None, match_calls: list | None = None):
        self.w = weights
        self.cfg = cfg
        self.tome = tome_cfg
        self.attention_calls = attention_calls
        self.match_calls = match_calls
        # the program's matchings in call order (an iterator of tome.Matching)
        self.matchings = None
        self.tol = 0.0
        self.stats: dict = {}
        # the control: every product's operands rounded by `quant` (fp8),
        # its own matchings collected in `record`
        self.quant = None
        self.record: list | None = None
        self._qcache: dict = {}

    # ------------------------------------------------------------ layers

    def _q(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.quant is None else self.quant(x)

    def _qw(self, name: str) -> torch.Tensor:
        if self.quant is None:
            return self.w[name]
        if name not in self._qcache:
            self._qcache[name] = self.quant(self.w[name])
        return self._qcache[name]

    def lin(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return F.linear(self._q(x), self._qw(name + ".weight"), self.w.get(name + ".bias"))

    def conv(self, name: str, x: torch.Tensor, stride: int = 1, padding: int = 1) -> torch.Tensor:
        return F.conv2d(self._q(x), self._qw(name + ".weight"), self.w[name + ".bias"], stride,
                        padding)

    def gn(self, name: str, x: torch.Tensor, eps: float) -> torch.Tensor:
        return F.group_norm(x, self.cfg["norm_groups"], self.w[name + ".weight"],
                            self.w[name + ".bias"], eps)

    def ln(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, x.shape[-1:], self.w[name + ".weight"], self.w[name + ".bias"], 1e-5)

    def resnet(self, name: str, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        h = self.conv(name + ".conv1", F.silu(self.gn(name + ".norm1", x, 1e-5)))
        h = h + self.lin(name + ".time_emb_proj", F.silu(temb))[:, :, None, None]
        h = self.conv(name + ".conv2", F.silu(self.gn(name + ".norm2", h, 1e-5)))
        if name + ".conv_shortcut.weight" in self.w:
            x = self.conv(name + ".conv_shortcut", x, padding=0)
        return x + h

    def mha(self, name: str, x: torch.Tensor, ctx: torch.Tensor) -> torch.Tensor:
        q, k, v = (self.lin(f"{name}.to_{p}", y) for p, y in (("q", x), ("k", ctx), ("v", ctx)))
        heads = self.cfg["num_heads"]
        if self.attention_calls is not None and k.shape[1] > 512:
            self.attention_calls.append((q.shape[0], heads, q.shape[1], k.shape[1],
                                         q.shape[2] // heads))
        return self.lin(name + ".to_out.0", attention(q, k, v, heads, self.quant))

    def _matching(self) -> dict:
        """The program's next matching to follow (tome.match), if given."""
        kw = {"quant": self.quant, "record": self.record}
        if self.matchings is not None:
            d = next(self.matchings, None)
            if d is None:
                raise ValueError("the program made fewer matchings than the reference")
            kw.update(matching=d, tol=self.tol, stats=self.stats)
        return kw

    def _match_shape(self, b: int, s: int, d: int, c: int) -> None:
        if self.match_calls is not None:
            self.match_calls.append((b, s, d, c))

    # ------------------------------------------------------------ blocks

    def block(self, name: str, x: torch.Tensor, ctx: torch.Tensor, merge: bool, slot: dict,
              bank: torch.Tensor | None, dedup: bool):
        """One BasicTransformerBlock on tokens (B*F, T, C)."""
        t = self.tome
        h = self.ln(name + ".norm1", x)
        new_bank = bank
        if merge:
            f = t["chunk_size"]
            bf, n, c = h.shape
            joined = h.reshape(bf // f, f * n, c)
            self._match_shape(bf // f, (f - 1) * n, n, c)
            local, row = tome.local_merge(joined, f, slot["randf"], t["local_ratio"],
                                          **self._matching())
            if t["merge_global"] and slot["use_global"] and bank is not None:
                self._match_shape(local.shape[0], local.shape[1], local.shape[1], c)
                merged, g_row, new_bank = tome.global_merge(local, bank, t["global_ratio"],
                                                           slot["flip"], **self._matching())
                row = g_row[row]
            else:
                merged = local
                new_bank = local if t["merge_global"] else None
            out = self.mha(name + ".attn1", merged, merged)[:, row]
            attn = out.reshape(bf, n, c)
        else:
            attn = self.mha(name + ".attn1", h, h)
        x = x + attn
        if dedup:
            x = torch.cat([x, x])
            new_bank = None if new_bank is None else torch.cat([new_bank, new_bank])
        x = x + self.mha(name + ".attn2", self.ln(name + ".norm2", x), ctx)
        h = self.lin(name + ".ff.net.0.proj", self.ln(name + ".norm3", x))
        h, gate = h.chunk(2, dim=-1)
        return x + self.lin(name + ".ff.net.2", h * F.gelu(gate)), new_bank

    def transformer(self, name: str, x: torch.Tensor, ctx: torch.Tensor, merge: bool,
                    slot: dict, banks: dict, new_banks: dict, dedup: bool) -> torch.Tensor:
        b, c, hh, ww = x.shape
        z = self.conv(name + ".proj_in", self.gn(name + ".norm", x, 1e-6), padding=0)
        z = z.permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        bank = banks.get(name)
        if dedup and bank is not None:
            bank = bank[: bank.shape[0] // 2]
        z, nb = self.block(name + ".transformer_blocks.0", z, ctx, merge, slot, bank, dedup)
        if nb is not None:
            new_banks[name] = nb
        if dedup:
            x = torch.cat([x, x])
        z = z.reshape(x.shape[0], hh, ww, c).permute(0, 3, 1, 2)
        return self.conv(name + ".proj_out", z, padding=0) + x

    # ------------------------------------------------------------ entry

    def __call__(self, x: torch.Tensor, t: float, ctx: torch.Tensor, slot: dict,
                 banks: dict, dedup: bool = False):
        """x NHWC (B*F, H, W, C_in), float32; with `dedup` x is the one half
        of the CFG batch and ctx the whole batch. -> (eps NHWC, new banks)."""
        cfg, ch = self.cfg, self.cfg["block_out_channels"]
        n_lvl, per = len(ch), cfg["layers_per_block"]
        if self.tome["chunk_size"] > 4:
            raise ValueError("one local merge level: chunks of at most 4 frames")
        x = x.permute(0, 3, 1, 2)
        h0, w0 = x.shape[-2:]
        tt = torch.full((x.shape[0],), float(t), device=x.device)
        temb = self.lin("time_embedding.linear_2",
                        F.silu(self.lin("time_embedding.linear_1", timestep_embedding(tt, ch[0]))))
        temb_full = torch.cat([temb, temb]) if dedup else temb
        new_banks: dict = {}
        pending = dedup

        def attn(name, h, dup=False):
            factor = math.ceil(math.sqrt(h0 * w0 / (h.shape[-2] * h.shape[-1])))
            merge = factor <= self.tome["max_downsample"]
            return self.transformer(name, h, ctx, merge, slot, banks, new_banks, dup)

        h = self.conv("conv_in", x)
        skips = [torch.cat([h, h]) if dedup else h]
        for lvl in range(n_lvl):
            for blk in range(per):
                h = self.resnet(f"down_blocks.{lvl}.resnets.{blk}", h,
                                temb if pending else temb_full)
                if lvl < n_lvl - 1:
                    h = attn(f"down_blocks.{lvl}.attentions.{blk}", h, pending)
                    pending = False
                skips.append(h)
            if lvl < n_lvl - 1:
                h = self.conv(f"down_blocks.{lvl}.downsamplers.0.conv",
                              F.pad(h, (0, 1, 0, 1)), stride=2, padding=0)
                skips.append(h)
        h = self.resnet("mid_block.resnets.0", h, temb_full)
        h = attn("mid_block.attentions.0", h)
        h = self.resnet("mid_block.resnets.1", h, temb_full)
        for i, lvl in enumerate(reversed(range(n_lvl))):
            for blk in range(per + 1):
                h = self.resnet(f"up_blocks.{i}.resnets.{blk}",
                                torch.cat([h, skips.pop()], dim=1), temb_full)
                if lvl < n_lvl - 1:
                    h = attn(f"up_blocks.{i}.attentions.{blk}", h)
            if lvl > 0:
                size = tuple(skips[-1].shape[-2:])
                if size == (2 * h.shape[-2], 2 * h.shape[-1]):
                    h = h.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
                else:
                    h = F.interpolate(h, size=size, mode="nearest-exact")
                h = self.conv(f"up_blocks.{i}.upsamplers.0.conv", h)
        h = self.conv("conv_out", F.silu(self.gn("conv_norm_out", h, 1e-5)))
        return h.permute(0, 2, 3, 1), new_banks
