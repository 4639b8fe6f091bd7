"""The latent diffusion decoder that cleans up AR-generated video
(counterpart of tclight_tpu/cosmos/diffusion_decoder.py).

- `DiffusionDecoderGeneralDIT`: a GeneralDIT whose input is [noisy
  latents | the AR tokens' embedding, bilinearly resized up to the latent
  grid | (the condition's c_noise channel)] (and the padding mask inside
  the DiT). The port's decoder is a `GeneralDIT` subclass with the token
  embedder beside its modules, so its state dict has the reference
  checkpoint's keys (`cosmos/convert_dit.convert_diffusion_decoder_dit`);
  its self-attention goes to the flash kernel (K1, or K6 / K7 by
  `attn_backend`) as the DiT's does.
- `LatentDiffusionDecoder`: conditional EDM generation with CFG in x0
  space, cond + g * (cond - uncond), where the uncondition zeroes both the
  T5 context and the token stream; the condition's sigma is drawn
  U[0, 0.01) and its c_noise fills the sigma channel; RES "2ab" sampling
  from sigma_max * noise over a rho ladder that ends at sigma_min.
- `split_with_overlap` / `linear_blend_video_list`: reflect-padded
  temporal chunking and the linear cross-fade that reassembles it.
- `diffusion_decoder_process_tokens`: per video, the token stream in
  overlapping latent chunks, one generation per chunk, each decoded by the
  continuous tokenizer (`decode_fn`), the chunk videos blended.
- `DiffusionDecoderSamplingConfig`: the shipped defaults (guidance 1.8,
  15 steps, sigma_min 0.02, overlap 2, a 57-frame window).

The draws: the initial noise N(0, I) and the condition sigma's uniform
come from `LatentDiffusionDecoder.draws(seed, noise_shape)`, by default a
`torch.Generator` seeded with `seed`; JAX draws them from PRNGKey(seed),
and a caller that passes JAX's arrays gets JAX's latents.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from tclight_torch.cosmos.dit import DiTConfig, GeneralDIT, init_dit_
from tclight_torch.cosmos.edm import EDMScaling, SolverConfig, rho_timesteps, sample_res
from tclight_torch.models.dpt import _resize_bilinear

__all__ = ["DiffusionDecoderSamplingConfig", "DiffusionDecoderGeneralDIT",
           "LatentDiffusionDecoder", "split_with_overlap", "linear_blend_video_list",
           "diffusion_decoder_process_tokens", "build_tiny_decoder", "default_draws"]


@dataclasses.dataclass(frozen=True)
class DiffusionDecoderSamplingConfig:
    """The shipped sampling defaults."""

    guidance: float = 1.8
    sigma_min: float = 0.02
    sigma: float = 8.0
    num_steps: int = 15
    overlap: int = 2
    continuous_tokenizer_channel: int = 16
    continuous_tokenizer_spatial_compression_ratio: int = 8
    dd_train_num_video_frames: int = 57
    max_iter: int = 99
    fps: int = 24


def split_with_overlap(video_bcthw: np.ndarray, num_video_frames: int,
                       overlap: int = 2) -> List[np.ndarray]:
    """Windows of `num_video_frames` over T of (B, C, T, H, W), `overlap`
    frames shared; the last window reflect-pads past the end."""
    assert overlap < num_video_frames, "Overlap should be < num_video_frames"
    v = np.asarray(video_bcthw)
    t = v.shape[2]
    chunks = []
    for start in range(0, t - overlap, num_video_frames - overlap):
        end = start + num_video_frames
        if end > t:
            pad = end - t
            chunks.append(np.concatenate([v[:, :, start:t], v[:, :, t - 2: t - 2 - pad: -1]],
                                         axis=2))
        else:
            chunks.append(v[:, :, start:end])
    return chunks


def linear_blend_video_list(videos: Sequence[np.ndarray], d: int) -> np.ndarray:
    """Cross-fade consecutive (B, C, T, H, W) chunks of one shape over their
    d-frame overlap."""
    assert len(videos) >= 2, "At least two videos are required."
    b, c, t, h, w = videos[0].shape
    n = len(videos)
    out = np.zeros((b, c, n * t - d * (n - 1), h, w), np.float32)
    out[:, :, : t - d] = videos[0][:, :, : t - d]
    pos = t - d
    wts = np.linspace(0.0, 1.0, d, dtype=np.float32)
    for i in range(1, n):
        for j in range(d):
            out[:, :, pos] = ((1 - wts[j]) * videos[i - 1][:, :, t - d + j]
                              + wts[j] * videos[i][:, :, j])
            pos += 1
        if i < n - 1:
            k = t - 2 * d
            if k > 0:
                out[:, :, pos: pos + k] = videos[i][:, :, d: t - d]
                pos += k
        else:
            out[:, :, pos: pos + t - d] = videos[i][:, :, d:]
            pos += t - d
    return out


def _resize_hw_bilinear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(..., H0, W0, C) -> (..., h, w, C), JAX's bilinear weights (the token
    embedding is resized up, so no antialiasing enters)."""
    lead = x.shape[:-3]
    flat = x.reshape((-1,) + tuple(x.shape[-3:])).permute(0, 3, 1, 2)
    out = _resize_bilinear(flat, h, w, align_corners=False).permute(0, 2, 3, 1)
    return out.reshape(tuple(lead) + tuple(out.shape[1:]))


class DiffusionDecoderGeneralDIT(GeneralDIT):
    """forward(x (B, T, H, W, C), timesteps (B,), context (B, S, ctx),
    latent_condition: int tokens (B, T, Ht, Wt) with `condition_on_token`,
    else continuous latents (B, T, H, W, C); latent_condition_sigma (B,)
    c_noise values for the optional sigma channel; padding_mask / fps as
    GeneralDIT). `cfg.in_channels` is the latent's width; the DiT's input
    is widened by the condition's (token_dim, or the latent's) and the
    sigma channel."""

    def __init__(self, cfg: DiTConfig, token_vocab: int = 64000, token_dim: int = 32,
                 condition_on_token: bool = True, condition_on_sigma: bool = False,
                 attn_backend: Optional[str] = None):
        extra = (token_dim if condition_on_token else cfg.in_channels) + int(condition_on_sigma)
        super().__init__(dataclasses.replace(cfg, in_channels=cfg.in_channels + extra),
                         attn_backend)
        self.latent_channels = cfg.in_channels
        self.condition_on_token, self.condition_on_sigma = condition_on_token, condition_on_sigma
        if condition_on_token:
            # zero-initialised in the reference; an f32 table, as JAX's
            self.token_embedder = nn.Embedding(token_vocab, token_dim, dtype=torch.float32)
            nn.init.zeros_(self.token_embedder.weight)

    def forward(self, x, timesteps, context, latent_condition=None,
                latent_condition_sigma=None, crossattn_mask=None, fps=None, padding_mask=None,
                mesh=None):
        b, t, h, w, _ = x.shape
        if self.condition_on_token:
            emb = self.token_embedder(latent_condition.long())
            cond = _resize_hw_bilinear(emb, h, w)
        else:
            cond = latent_condition
        x = torch.cat([x, cond.to(x.dtype)], dim=-1)
        if self.condition_on_sigma:
            sig = torch.as_tensor(latent_condition_sigma, device=x.device).reshape(b, 1, 1, 1, 1)
            x = torch.cat([x, sig.to(x.dtype).expand(b, t, h, w, 1)], dim=-1)
        return super().forward(x, timesteps, context, crossattn_mask=crossattn_mask, fps=fps,
                               padding_mask=padding_mask, mesh=mesh)


def default_draws(seed: int, noise_shape: tuple, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(noise N(0, I) of `noise_shape`, u U[0, 1) of (B,)), f32 from a
    generator seeded with `seed`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    noise = torch.randn(noise_shape, generator=gen, dtype=torch.float32, device=device)
    return noise, torch.rand((noise_shape[0],), generator=gen, device=device)


@dataclasses.dataclass
class LatentDiffusionDecoder:
    """Conditional EDM generation over the AR token stream with CFG over
    (text, tokens). `draws(seed, noise_shape)` -> (noise, u) gives the
    initial noise and the condition sigma's uniform draw."""

    network: DiffusionDecoderGeneralDIT
    sigma_data: float = 0.5
    guidance: float = 1.8
    n_steps: int = 15
    sigma_max: float = 80.0
    sigma_min: float = 0.02
    solver_option: str = "2ab"
    # condition corruption; zero in the shipped inference config
    cond_sigma_low: float = 0.0
    cond_sigma_high: float = 0.0
    corrupt_prob: float = 0.0
    draws: Optional[Callable] = None

    def _device(self) -> torch.device:
        return next(self.network.parameters()).device

    def _x0_fn(self, context, tokens, sigma_cond):
        """The condition's c_noise fills latent_condition_sigma; the
        uncondition zeroes both the context and the tokens."""
        scaling = EDMScaling(self.sigma_data)
        b = tokens.shape[0]
        c_noise_cond = scaling(sigma_cond)[3]

        def denoise(x, sigma, ctx, toks):
            c_skip, c_out, c_in, c_noise = scaling(torch.tensor(float(sigma), device=x.device))
            pred = self.network(c_in * x, c_noise.expand(b), ctx, latent_condition=toks,
                                latent_condition_sigma=c_noise_cond)
            return c_skip * x + c_out * pred

        uncond_ctx, uncond_tokens = torch.zeros_like(context), torch.zeros_like(tokens)

        def x0_fn(x, sigma):
            cond = denoise(x, sigma, context, tokens)
            uncond = denoise(x, sigma, uncond_ctx, uncond_tokens)
            return cond + self.guidance * (cond - uncond)

        return x0_fn

    @torch.inference_mode()
    def __call__(self, tokens: torch.Tensor, context: torch.Tensor, latent_shape: tuple,
                 seed: int = 1, corrupt_sigma: float = 0.01) -> torch.Tensor:
        """tokens (B, T, Ht, Wt) int; context (B, S, ctx); latent_shape
        (T, H, W, C) -> the generated clean latents (B, T, H, W, C) f32."""
        device = self._device()
        tokens = torch.as_tensor(tokens, device=device)
        context = torch.as_tensor(context, dtype=torch.float32, device=device)
        b = tokens.shape[0]
        draws = self.draws or (lambda s, shape: default_draws(s, shape, device))
        noise, u = draws(seed, (b,) + tuple(latent_shape))
        noise = torch.as_tensor(noise, dtype=torch.float32, device=device)
        sigma_cond = torch.as_tensor(u, dtype=torch.float32, device=device) * corrupt_sigma
        sigmas = rho_timesteps(sigma_max=self.sigma_max, sigma_min=self.sigma_min,
                               n=self.n_steps)[:-1]
        x0_fn = self._x0_fn(context, tokens, sigma_cond)
        return sample_res(x0_fn, noise * self.sigma_max, sigmas,
                          SolverConfig(is_multi=self.solver_option == "2ab"))


def _to_numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().cpu().numpy()
    return np.asarray(a)


def diffusion_decoder_process_tokens(
        decoder: LatentDiffusionDecoder, indices_tensor: Sequence[np.ndarray],
        decode_fn: Callable, video_height: int, video_width: int,
        dd_sampling_config: DiffusionDecoderSamplingConfig | None = None,
        t5_emb_batch: Optional[Sequence[np.ndarray]] = None, context_dim: int = 1024,
        seed: int = 1) -> List[np.ndarray]:
    """Per video, its AR token stream (T', Ht, Wt) in overlapping latent
    chunks, one generation per chunk (seed + chunk index), each decoded by
    `decode_fn` (latents (B, T, H, W, C) -> pixels (B, C, Tp, Hp, Wp) in
    [-1, 1]) and clipped, the chunk videos blended over overlap * 8
    frames. -> [0, 1] videos (C, Tp, Hp, Wp), one per input."""
    cfg = dd_sampling_config or DiffusionDecoderSamplingConfig()
    latent_t = (cfg.dd_train_num_video_frames - 1) // 8 + 1
    device = decoder._device()
    out_videos: List[np.ndarray] = []
    for i, tok_thw in enumerate(indices_tensor):
        tok = _to_numpy(tok_thw)
        chunks = split_with_overlap(tok[None, None].astype(np.int32), latent_t,
                                    overlap=cfg.overlap)
        if t5_emb_batch is not None and t5_emb_batch[i] is not None:
            ctx = torch.as_tensor(_to_numpy(t5_emb_batch[i]), dtype=torch.float32,
                                  device=device)[None]
        else:
            ctx = torch.zeros((1, 512, context_dim), dtype=torch.float32, device=device)
        lat_h = video_height // cfg.continuous_tokenizer_spatial_compression_ratio
        lat_w = video_width // cfg.continuous_tokenizer_spatial_compression_ratio
        pix_chunks = []
        for it, chunk in enumerate(chunks[: cfg.max_iter]):
            toks = torch.as_tensor(chunk[:, 0], device=device)  # (1, T', Ht, Wt)
            latents = decoder(toks, ctx, latent_shape=(latent_t, lat_h, lat_w,
                                                       cfg.continuous_tokenizer_channel),
                              seed=seed + it)
            pix_chunks.append(np.clip(_to_numpy(decode_fn(latents)), -1.0, 1.0))
        # the pixel overlap is the latent overlap through the 8x temporal window
        blended = (linear_blend_video_list(pix_chunks, cfg.overlap * 8) if len(pix_chunks) > 1
                   else pix_chunks[0])
        out_videos.append((1.0 + blended[0]) / 2.0)
    return out_videos


def build_tiny_decoder(seed: int = 0, latent_channels: int = 4, context_dim: int = 32,
                       token_vocab: int = 64, device="cpu") -> LatentDiffusionDecoder:
    """A tiny decoder with weights drawn from `seed` (adaLN gates and the
    token table non-zero, so that every block and the tokens count; the
    reference zero-initialises both), 4 steps."""
    cfg = dataclasses.replace(DiTConfig.tiny(), in_channels=latent_channels,
                              out_channels=latent_channels, context_dim=context_dim)
    net = DiffusionDecoderGeneralDIT(cfg, token_vocab=token_vocab, token_dim=8)
    gen = torch.Generator().manual_seed(seed)
    init_dit_(net, gen)
    with torch.no_grad():
        net.token_embedder.weight.normal_(0.0, 1.0, generator=gen)
    return LatentDiffusionDecoder(net.to(device).eval().requires_grad_(False), n_steps=4)
