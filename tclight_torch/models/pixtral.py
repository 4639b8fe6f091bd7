"""The Pixtral prompt upsampler: vision transformer, multimodal projector,
the AR decoder and the dialog layout (counterpart of
tclight_tpu/models/pixtral.py).

TC-Light calls it once per video when no prompt is given: the last frame
goes through the ViT (`PixtralViT`: a bias-free patch conv, `ln_pre`, and
blocks whose attention rotates the first half of each head's dims with
the patch row and the second half with its column), the projector
(`MultimodalProjector`: Linear, exact erf GELU, Linear) maps the patch
features to the decoder's width, `embed_vision_language` writes them into
the prompt's [IMG] positions (cast to the embedding dtype), and the
decoder (`ar_transformer.Transformer`) writes up to 400 tokens at
temperature 0.01 and top-p 0.9.

`load_vlm` reads a cosmos-native `model.pt` (through `torch.load(mmap=
True)`) or HF-keyed `*.safetensors` (through the port's memory-mapped
reader; the card's machine has no `safetensors`), converts the keys
(`models/convert_ar.py`) and copies each tensor into the modules, cast to
the parameter's dtype: the decoder in its compute dtype (bf16 for
Pixtral-12B), the ViT and the projector in f32. JAX's `load_vlm` widens
every tensor to an f32 numpy copy (49 GB for 12.25 B parameters) and its
`nn.Dense(dtype=bf16)` casts each kernel back to bf16 when it computes; a
bf16 checkpoint survives bf16 -> f32 -> bf16 unchanged, so storing the
decoder in bf16 computes the same products from 24.5 GB.

`upsample_tokens` takes the tokenizer as an argument (the card's machine
has no `transformers`; the chip smoke passes the `DummyTokenizer`), and
`upsample_prompt_from_frames`, the Generator's hook, loads the VLM and
the checkpoint's HF tokenizer and decodes.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tclight_torch.models.ar_transformer import (ARConfig, ARGenerator, RMSNorm, SwiGLUMLP,
                                                 Transformer, apply_rope, grouped_attention,
                                                 rope_frequencies)
from tclight_torch.utils.device import resolve_device

__all__ = ["UPSAMPLER_INSTRUCTION", "ViTConfig", "ViTAttention2DRoPE", "PixtralViT",
           "MultimodalProjector", "PixtralVLM", "build_vlm", "build_tiny_vlm",
           "prepare_dialog_tokens", "load_vlm", "upsampler_image", "upsample_tokens",
           "upsample_prompt_from_frames"]

UPSAMPLER_INSTRUCTION = (
    "Describe the lighting, materials, and atmosphere of this video frame "
    "in one detailed caption suitable as an image-relighting prompt."
)


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 1024
    patch_size: int = 16
    dim: int = 1024
    n_layers: int = 24
    n_heads: int = 16
    ffn_hidden: int = 4096
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.float32

    @staticmethod
    def tiny() -> "ViTConfig":
        return ViTConfig(image_size=64, patch_size=16, dim=64, n_layers=2, n_heads=4,
                         ffn_hidden=128)


class ViTAttention2DRoPE(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        for name in ("wq", "wk", "wv", "wo"):
            setattr(self, name, nn.Linear(cfg.dim, cfg.dim, bias=False, dtype=cfg.dtype))

    def forward(self, x: torch.Tensor, rope_2d) -> torch.Tensor:
        cfg = self.cfg
        hd = cfg.dim // cfg.n_heads
        b, s, _ = x.shape
        x = x.to(cfg.dtype)
        q, k, v = (getattr(self, n)(x).reshape(b, s, cfg.n_heads, hd) for n in ("wq", "wk", "wv"))
        half = hd // 2
        rope_r, rope_c, pos_r, pos_c = rope_2d
        q = torch.cat([apply_rope(q[..., :half], rope_r, pos_r),
                       apply_rope(q[..., half:], rope_c, pos_c)], dim=-1)
        k = torch.cat([apply_rope(k[..., :half], rope_r, pos_r),
                       apply_rope(k[..., half:], rope_c, pos_c)], dim=-1)
        out = grouped_attention(q, k, v, None, cfg.dtype)
        return self.wo(out.reshape(b, s, cfg.dim))


class PixtralViT(nn.Module):
    """images (B, H, W, 3) in [0, 1] -> patch features (B, S, dim), the
    patches in row-major order."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        p = cfg.patch_size
        self.patch_conv = nn.Conv2d(3, cfg.dim, p, stride=p, bias=False, dtype=cfg.dtype)
        self.ln_pre = RMSNorm(cfg.dim, cfg.norm_eps, cfg.dtype)
        for i in range(cfg.n_layers):
            setattr(self, f"layers_{i}_attention", ViTAttention2DRoPE(cfg))
            setattr(self, f"layers_{i}_attention_norm", RMSNorm(cfg.dim, cfg.norm_eps, cfg.dtype))
            setattr(self, f"layers_{i}_feed_forward", SwiGLUMLP(cfg.dim, cfg.ffn_hidden, cfg.dtype))
            setattr(self, f"layers_{i}_ffn_norm", RMSNorm(cfg.dim, cfg.norm_eps, cfg.dtype))
        self._rope: torch.Tensor | None = None

    def rope(self, device: torch.device) -> torch.Tensor:
        if self._rope is None or self._rope.device != device:
            hd = self.cfg.dim // self.cfg.n_heads
            self._rope = torch.from_numpy(rope_frequencies(
                hd // 2, self.cfg.image_size // self.cfg.patch_size, self.cfg.rope_theta)
            ).to(device)
        return self._rope

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        p = cfg.patch_size
        x = images.to(cfg.dtype).permute(0, 3, 1, 2)
        # flax's "SAME" padding of a stride-p conv of size p (none when the
        # size is a multiple of p)
        ph = (-x.shape[2]) % p
        pw = (-x.shape[3]) % p
        x = F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
        x = self.patch_conv(x)
        b, _, gh, gw = x.shape
        max_grid = cfg.image_size // p
        if gh > max_grid or gw > max_grid:
            raise ValueError(f"a {gh} x {gw} patch grid exceeds the ViT's {max_grid} rows "
                             "of RoPE positions")
        x = self.ln_pre(x.flatten(2).transpose(1, 2))
        rope = self.rope(x.device)
        rows = torch.arange(gh, device=x.device).repeat_interleave(gw)
        cols = torch.arange(gw, device=x.device).repeat(gh)
        rope_2d = (rope, rope, rows, cols)
        for i in range(cfg.n_layers):
            x = x + getattr(self, f"layers_{i}_attention")(
                getattr(self, f"layers_{i}_attention_norm")(x), rope_2d)
            x = x + getattr(self, f"layers_{i}_feed_forward")(
                getattr(self, f"layers_{i}_ffn_norm")(x))
        return x


class MultimodalProjector(nn.Module):
    """Vision -> text width: Linear, exact (erf) GELU, Linear."""

    def __init__(self, in_dim: int, out_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.w_in = nn.Linear(in_dim, out_dim, dtype=dtype)
        self.w_out = nn.Linear(out_dim, out_dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.w_out(F.gelu(self.w_in(x.to(self.dtype)), approximate="none"))


@dataclasses.dataclass
class PixtralVLM:
    """The text decoder, the ViT and the projector. `last_times` holds the
    last chat completion's embed, prefill and decode seconds."""

    text: Transformer
    vit: PixtralViT
    projector: MultimodalProjector
    cfg: ARConfig
    image_token_id: int = 10
    last_times: dict = dataclasses.field(default_factory=dict)

    @property
    def device(self) -> torch.device:
        return self.text.output.weight.device

    @torch.inference_mode()
    def embed_vision_language(self, token_ids: np.ndarray, image: torch.Tensor) -> torch.Tensor:
        """The prompt's embeddings (1, S, dim) with the [IMG] positions
        replaced by the projected patch features; token_ids must hold one
        [IMG] token per patch."""
        feats = self.projector(self.vit(image.to(self.device)))
        ids = torch.as_tensor(np.asarray(token_ids), device=self.device)
        tok_emb = self.text.embed(ids)
        is_img = np.asarray(token_ids) == self.image_token_id
        n_img = int(is_img.sum())
        if n_img != feats.shape[1]:
            raise ValueError(f"{n_img} [IMG] tokens vs {feats.shape[1]} patches")
        positions = torch.as_tensor(np.nonzero(is_img[0])[0], device=self.device)
        tok_emb[0, positions] = feats[0].to(tok_emb.dtype)
        return tok_emb

    def chat_completion(self, token_ids: np.ndarray, image: torch.Tensor,
                        max_gen_len: int = 400, temperature: float = 0.01, top_p: float = 0.9,
                        stop_tokens=(2,), seed: int = 0, gumbel=None) -> np.ndarray:
        """Generated ids (1, T); the noise from a generator seeded with
        `seed`, or `gumbel` (one (1, vocab) draw a step)."""
        dev = self.device
        sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
        t0 = time.perf_counter()
        emb = self.embed_vision_language(token_ids, image)
        sync()
        embed_s = time.perf_counter() - t0
        gen = ARGenerator(self.text)
        out = gen.generate(prompt_embeddings=emb, max_gen_len=max_gen_len,
                           temperature=temperature, top_p=top_p, stop_tokens=tuple(stop_tokens),
                           generator=torch.Generator(device=dev).manual_seed(seed),
                           gumbel=gumbel)
        self.last_times = {"embed_s": embed_s, **gen.last_times,
                           "prompt_tokens": int(emb.shape[1])}
        return out


def build_vlm(cfg: ARConfig, vit_cfg: ViTConfig, seed: int = 0,
              state_dicts: dict | None = None,
              device: str | torch.device | None = "cuda") -> PixtralVLM:
    """A VLM on `device`: random weights from `seed` at flax's scales
    (`init_like_flax`; the norms' weights 1), or `state_dicts` {"text",
    "vit", "projector"} (`models.bridge.vlm_state_dicts` of JAX's trees)."""
    from tclight_torch.pipeline.iclight import init_like_flax

    dev = resolve_device(device)
    with torch.device(dev):
        parts = {"text": Transformer(cfg), "vit": PixtralViT(vit_cfg),
                 "projector": MultimodalProjector(vit_cfg.dim, cfg.dim)}
    gen = torch.Generator(device=dev).manual_seed(seed)
    for name, module in parts.items():
        if state_dicts is not None:
            module.load_state_dict(state_dicts[name])
        else:
            init_like_flax(module, gen)
        module.eval().requires_grad_(False)
    return PixtralVLM(parts["text"], parts["vit"], parts["projector"], cfg)


def build_tiny_vlm(seed: int = 0, state_dicts: dict | None = None,
                   device: str | torch.device | None = "cuda") -> PixtralVLM:
    """The tiny VLM of the tests (`ARConfig.tiny()`, `ViTConfig.tiny()`)."""
    return build_vlm(ARConfig.tiny(), ViTConfig.tiny(), seed, state_dicts, device)


def prepare_dialog_tokens(tokenizer, n_image_tokens: int,
                          instruction: str = UPSAMPLER_INSTRUCTION,
                          image_token_id: int = 10) -> np.ndarray:
    """The prompt: BOS, one [IMG] per patch, the instruction's ids."""
    ids = tokenizer(instruction, truncation=False, add_special_tokens=False)["input_ids"]
    bos = getattr(tokenizer, "bos_token_id", 1)
    return np.asarray([[bos] + [image_token_id] * n_image_tokens + ids], np.int32)


def _read_checkpoint(ckpt_dir: Path) -> dict:
    """{key: tensor} of `model.pt` (memory-mapped) or of every
    `*.safetensors` (memory-mapped by the port's reader)."""
    pt = ckpt_dir / "model.pt"
    sts = sorted(ckpt_dir.glob("*.safetensors"))
    if pt.exists():
        raw = torch.load(pt, map_location="cpu", mmap=True, weights_only=True)
        return dict(raw.get("model", raw))
    if sts:
        from tclight_torch.models.convert import mmap_safetensors

        ckpt: dict = {}
        for f in sts:
            ckpt.update(mmap_safetensors(f))
        return ckpt
    raise FileNotFoundError(f"no model.pt or *.safetensors in {ckpt_dir}")


def load_vlm(ckpt_dir, cfg: ARConfig | None = None, vit_cfg: ViTConfig | None = None,
             device: str | torch.device | None = "cuda") -> PixtralVLM:
    """A Pixtral VLM (Pixtral-12B's configs by default) from a local
    checkpoint directory, cosmos-native or HF-keyed (module docstring).
    The modules are made without initialising their weights, then each
    checkpoint tensor is cast to its parameter's dtype and copied onto
    `device`; a parameter the checkpoint lacks raises KeyError."""
    from tclight_torch.models.convert_ar import convert_vlm_checkpoint, from_hf_pixtral

    cfg = cfg or ARConfig.pixtral_12b()
    vit_cfg = vit_cfg or ViTConfig()
    dev = resolve_device(device)
    ckpt = _read_checkpoint(Path(ckpt_dir))
    if any(k.startswith(("language_model.", "vision_tower.")) for k in ckpt):
        ckpt = from_hf_pixtral(ckpt, llm_heads=cfg.n_heads, llm_kv_heads=cfg.n_kv_heads,
                               vit_heads=vit_cfg.n_heads)
    sds = dict(zip(("text", "vit", "projector"), convert_vlm_checkpoint(
        ckpt, llm_layers=cfg.n_layers, vit_layers=vit_cfg.n_layers)))
    with torch.device("meta"):
        parts = {"text": Transformer(cfg), "vit": PixtralViT(vit_cfg),
                 "projector": MultimodalProjector(vit_cfg.dim, cfg.dim)}
    for name, module in parts.items():
        module.to_empty(device=dev)
        with torch.no_grad():
            params = dict(module.named_parameters())
            missing = sorted(set(params) - set(sds[name]))
            if missing:
                raise KeyError(f"checkpoint lacks {name} parameters {missing[:5]}")
            for key, param in params.items():
                param.copy_(torch.as_tensor(sds[name][key]))
        module.eval().requires_grad_(False)
    return PixtralVLM(parts["text"], parts["vit"], parts["projector"], cfg)


def upsampler_image(frames: np.ndarray) -> np.ndarray:
    """The last frame as the ViT's input (1, h, w, 3) f32 in [0, 1]: scaled
    down (bilinear) when its long side is above 1024, cropped to
    multiples of 16."""
    import cv2

    img = frames[-1]
    if img.dtype != np.float32:
        img = img.astype(np.float32) / 255.0
    h, w = img.shape[:2]
    scale = 1024 / max(h, w)
    if scale < 1.0:
        img = cv2.resize(img, (int(w * scale), int(h * scale)))
    p = 16
    return img[None, : img.shape[0] // p * p, : img.shape[1] // p * p]


def upsample_tokens(vlm: PixtralVLM, tokenizer, frames: np.ndarray, max_gen_len: int = 400,
                    seed: int = 0) -> np.ndarray:
    """The upsampler's generated ids (1, T) for the video's last frame:
    the dialog of `tokenizer`, temperature 0.01, top-p 0.9, stopping at
    the tokenizer's EOS (2 without one)."""
    img = upsampler_image(frames)
    n_patches = (img.shape[1] // 16) * (img.shape[2] // 16)
    ids = prepare_dialog_tokens(tokenizer, n_patches)
    return vlm.chat_completion(ids, torch.from_numpy(np.ascontiguousarray(img)),
                               max_gen_len=max_gen_len, temperature=0.01, top_p=0.9,
                               stop_tokens=(getattr(tokenizer, "eos_token_id", None) or 2,),
                               seed=seed)


def upsample_prompt_from_frames(ckpt_dir, frames: np.ndarray, max_gen_len: int = 400,
                                device: str | torch.device | None = "cuda") -> str:
    """The Generator's hook: the prompt the VLM of `ckpt_dir` writes for the
    video's last frame, decoded by the HF tokenizer saved beside it, EOS
    left out. (JAX's hook hands `decode` the (1, T) array as a nested list,
    which a fast tokenizer refuses; the port decodes its one row.)"""
    from transformers import AutoTokenizer

    vlm = load_vlm(ckpt_dir, device=device)
    tokenizer = AutoTokenizer.from_pretrained(str(ckpt_dir))
    out = upsample_tokens(vlm, tokenizer, frames, max_gen_len)
    return tokenizer.decode([t for t in out[0].tolist() if t != tokenizer.eos_token_id])
