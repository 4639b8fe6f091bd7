"""Seeded UNet weights under diffusers' keys, made on the device.

`unet_shapes` lists every tensor of an SD1.5-topology UNet2DConditionModel
(diffusers' names and layouts: Linear (out, in), Conv2d (out, in, kh, kw))
for the widths of a configuration. `make` draws all of them in one call of
the device's generator, in the type they are served in, and scales each
in place: kernels N(0, 1 / fan_in), biases N(0, 0.02^2), norm scales
1 + N(0, 0.05^2) and norm shifts N(0, 0.05^2), so that no term of the
network is trivially zero or one. The benchmark hands these tensors to the
program and makes them again from the same seed for the reference.
"""

from __future__ import annotations

import torch

# q and k kernels at 1.4 times the fan-in scale: logits of unit-variance
# tokens spread with a standard deviation of about 2 (1.4^2), so that a
# softmax over tens of thousands of keys weighs some hundreds of them, as a
# trained model's peaked maps do. At the fan-in scale the softmax is nearly
# flat, its output the mean of v whatever q and k are (the program's int8
# attention then read the same as its bf16 one); at twice it is nearly
# one-hot, and bf16 rounding flips which key wins
QK_GAIN = 1.4


def _resnet(out: list, name: str, cin: int, cout: int, temb: int) -> None:
    out += [(f"{name}.norm1.weight", (cin,)), (f"{name}.norm1.bias", (cin,)),
            (f"{name}.conv1.weight", (cout, cin, 3, 3)), (f"{name}.conv1.bias", (cout,)),
            (f"{name}.time_emb_proj.weight", (cout, temb)), (f"{name}.time_emb_proj.bias", (cout,)),
            (f"{name}.norm2.weight", (cout,)), (f"{name}.norm2.bias", (cout,)),
            (f"{name}.conv2.weight", (cout, cout, 3, 3)), (f"{name}.conv2.bias", (cout,))]
    if cin != cout:
        out += [(f"{name}.conv_shortcut.weight", (cout, cin, 1, 1)),
                (f"{name}.conv_shortcut.bias", (cout,))]


def _transformer(out: list, name: str, c: int, ctx: int) -> None:
    out += [(f"{name}.norm.weight", (c,)), (f"{name}.norm.bias", (c,)),
            (f"{name}.proj_in.weight", (c, c, 1, 1)), (f"{name}.proj_in.bias", (c,))]
    tb = f"{name}.transformer_blocks.0"
    for a, kv in (("attn1", c), ("attn2", ctx)):
        out += [(f"{tb}.{a}.to_q.weight", (c, c)), (f"{tb}.{a}.to_k.weight", (c, kv)),
                (f"{tb}.{a}.to_v.weight", (c, kv)), (f"{tb}.{a}.to_out.0.weight", (c, c)),
                (f"{tb}.{a}.to_out.0.bias", (c,))]
    for i in (1, 2, 3):
        out += [(f"{tb}.norm{i}.weight", (c,)), (f"{tb}.norm{i}.bias", (c,))]
    out += [(f"{tb}.ff.net.0.proj.weight", (8 * c, c)), (f"{tb}.ff.net.0.proj.bias", (8 * c,)),
            (f"{tb}.ff.net.2.weight", (c, 4 * c)), (f"{tb}.ff.net.2.bias", (c,)),
            (f"{name}.proj_out.weight", (c, c, 1, 1)), (f"{name}.proj_out.bias", (c,))]


def unet_shapes(model: dict) -> list[tuple[str, tuple]]:
    ch = list(model["block_out_channels"])
    n, per, ctx = len(ch), model["layers_per_block"], model["context_dim"]
    temb = 4 * ch[0]
    out: list = [("time_embedding.linear_1.weight", (temb, ch[0])),
                 ("time_embedding.linear_1.bias", (temb,)),
                 ("time_embedding.linear_2.weight", (temb, temb)),
                 ("time_embedding.linear_2.bias", (temb,)),
                 ("conv_in.weight", (ch[0], model["in_channels"], 3, 3)), ("conv_in.bias", (ch[0],))]
    cur, skip = ch[0], [ch[0]]
    for lvl in range(n):
        for blk in range(per):
            _resnet(out, f"down_blocks.{lvl}.resnets.{blk}", cur, ch[lvl], temb)
            cur = ch[lvl]
            if lvl < n - 1:
                _transformer(out, f"down_blocks.{lvl}.attentions.{blk}", cur, ctx)
            skip.append(cur)
        if lvl < n - 1:
            out += [(f"down_blocks.{lvl}.downsamplers.0.conv.weight", (cur, cur, 3, 3)),
                    (f"down_blocks.{lvl}.downsamplers.0.conv.bias", (cur,))]
            skip.append(cur)
    _resnet(out, "mid_block.resnets.0", cur, ch[-1], temb)
    _transformer(out, "mid_block.attentions.0", ch[-1], ctx)
    _resnet(out, "mid_block.resnets.1", ch[-1], ch[-1], temb)
    cur = ch[-1]
    for i, lvl in enumerate(reversed(range(n))):
        for blk in range(per + 1):
            _resnet(out, f"up_blocks.{i}.resnets.{blk}", cur + skip.pop(), ch[lvl], temb)
            cur = ch[lvl]
            if lvl < n - 1:
                _transformer(out, f"up_blocks.{i}.attentions.{blk}", cur, ctx)
        if lvl > 0:
            out += [(f"up_blocks.{i}.upsamplers.0.conv.weight", (cur, cur, 3, 3)),
                    (f"up_blocks.{i}.upsamplers.0.conv.bias", (cur,))]
    out += [("conv_norm_out.weight", (ch[0],)), ("conv_norm_out.bias", (ch[0],)),
            ("conv_out.weight", (model["out_channels"], ch[0], 3, 3)),
            ("conv_out.bias", (model["out_channels"],))]
    return out


def _is_qk(name: str) -> bool:
    return name.endswith((".to_q.weight", ".to_k.weight"))


def _is_norm(name: str) -> bool:
    module = name.rsplit(".", 1)[0].split(".")[-1]
    return module.startswith("norm") or module == "conv_norm_out"


@torch.no_grad()
def make(model: dict, seed: int, device, dtype: torch.dtype) -> dict[str, torch.Tensor]:
    shapes = unet_shapes(model)
    total = sum(torch.Size(s).numel() for _, s in shapes)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    out, off = {}, 0
    for name, shape in shapes:
        t = flat[off: off + torch.Size(shape).numel()].view(shape)
        off += t.numel()
        if _is_norm(name):
            t.mul_(0.05)
            if name.endswith("weight"):
                t.add_(1.0)
        elif name.endswith("bias"):
            t.mul_(0.02)
        else:
            t.mul_(torch.Size(shape[1:]).numel() ** -0.5 * (QK_GAIN if _is_qk(name) else 1.0))
        out[name] = t
    return out
