"""The continuous (CV) video tokenizer and its inference wrappers
(counterpart of tclight_tpu/cosmos/cv_tokenizer.py).

- `CausalContinuousVideoTokenizer`: the factorized causal encoder and
  decoder of dv_tokenizer.py with a 16-channel continuous latent, a
  1x1x1 convolution pair in place of the FSQ quantizer.
- `VideoTokenizer`: temporal-causal chunked inference. T splits into
  `pixel_chunk_duration`-frame causal chunks, each encoded or decoded on
  its own, with the batch of chunks capped, and the latent mean / std
  normalisation; a temporal compression of 1 is the per-frame image path.
- `ImageTokenizer` and `JointImageVideoTokenizer`: the image branch and
  the T == 1 dispatch between the two.

Layout is channel-last (B, T, H, W, C) at every boundary, as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from tclight_torch.cosmos.dv_tokenizer import (CausalConv3d, DecoderFactorized,
                                               DVTokenizerConfig, EncoderFactorized)

__all__ = ["CausalContinuousVideoTokenizer", "VideoTokenizer", "ImageTokenizer",
           "JointImageVideoTokenizer", "cv_config_8x8x8"]


def cv_config_8x8x8(**overrides) -> DVTokenizerConfig:
    """The CV8x8x8 layout: a 16-channel continuous latent, 8x spatial and
    8x temporal compression (the Cosmos-1.0-Tokenizer-CV8x8x8 contract),
    with a Haar patch of 4. The JAX package's patch of 2 leaves two hybrid
    temporal downsamplings in the encoder but one temporal upsampling in
    the mirrored decoder, so a 121-frame chunk decodes to 61 frames and
    its decode fails (ROADMAP C11); with a patch of 4 the encoder and the
    decoder each make one, and 121 frames come back."""
    base = dict(channels=128, channels_mult=(2, 4, 4), num_res_blocks=2, attn_resolutions=(32,),
                resolution=1024, patch_size=4, z_channels=16, embedding_dim=16,
                spatial_compression=8, temporal_compression=8)
    base.update(overrides)
    return DVTokenizerConfig(**base)


class CausalContinuousVideoTokenizer(nn.Module):
    """encode: (B, T, H, W, 3) -> (B, t, h, w, embedding_dim); decode back."""

    def __init__(self, cfg: DVTokenizerConfig):
        super().__init__()
        self.cfg = cfg
        zc = cfg.z_factor * cfg.z_channels
        self.encoder = EncoderFactorized(cfg, zc)
        self.decoder = DecoderFactorized(cfg, cfg.z_channels)
        self.quant_conv = CausalConv3d(zc, cfg.embedding_dim, (1, 1, 1), padding=0)
        self.post_quant_conv = CausalConv3d(cfg.embedding_dim, cfg.z_channels, (1, 1, 1),
                                            padding=0)
        self.to(cfg.dtype)

    def encode(self, x):
        dtype = self.quant_conv.conv3d.weight.dtype
        return self.quant_conv(self.encoder(x.to(dtype))).permute(0, 2, 3, 4, 1)

    def decode(self, latent):
        dtype = self.quant_conv.conv3d.weight.dtype
        return self.decoder(self.post_quant_conv(latent.to(dtype).permute(0, 4, 1, 2, 3)))

    def forward(self, x):
        z = self.encode(x)
        return self.decode(z), z


def _batched(fn, x, max_bs: int):
    outs = [fn(x[i:i + max_bs]) for i in range(0, x.shape[0], max_bs)]
    return outs[0] if len(outs) == 1 else torch.cat(outs)


@dataclasses.dataclass
class VideoTokenizer:
    """Chunked, normalised encode / decode: encode gives (module.encode(x)
    - latent_mean) / latent_std per causal pixel chunk, decode inverts it.
    `latent_mean` / `latent_std` default to 0 / 1 and broadcast against a
    chunk's latent, (t, 1, 1, C) per chunk position as the reference's."""

    module: Any                      # CausalContinuousVideoTokenizer
    pixel_chunk_duration: int = 17
    temporal_compression_factor: int = 8
    max_enc_batch_size: int = 8
    max_dec_batch_size: int = 4
    latent_mean: Any = 0.0
    latent_std: Any = 1.0

    @property
    def latent_ch(self) -> int:
        return self.module.cfg.embedding_dim

    @property
    def latent_chunk_duration(self) -> int:
        assert (self.pixel_chunk_duration - 1) % self.temporal_compression_factor == 0
        return (self.pixel_chunk_duration - 1) // self.temporal_compression_factor + 1

    def get_latent_num_frames(self, num_pixel_frames: int) -> int:
        if num_pixel_frames == 1:
            return 1
        assert num_pixel_frames % self.pixel_chunk_duration == 0
        return num_pixel_frames // self.pixel_chunk_duration * self.latent_chunk_duration

    def get_pixel_num_frames(self, num_latent_frames: int) -> int:
        if num_latent_frames == 1:
            return 1
        assert num_latent_frames % self.latent_chunk_duration == 0
        return num_latent_frames // self.latent_chunk_duration * self.pixel_chunk_duration

    @torch.inference_mode()
    def encode(self, video: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W, 3) -> (B, t, h, w, latent_ch) f32, normalised."""
        b, t = video.shape[:2]
        if self.temporal_compression_factor == 1:  # image path
            chunks = video.reshape(b * t, 1, *video.shape[2:])
        else:
            pcd = self.pixel_chunk_duration
            if t % pcd:
                raise ValueError(f"T={t} not divisible by chunk {pcd}")
            chunks = video.reshape(b * (t // pcd), pcd, *video.shape[2:])
        lat = _batched(self.module.encode, chunks, self.max_enc_batch_size).float()
        lat = (lat - self.latent_mean) / self.latent_std
        return lat.reshape(b, -1, *lat.shape[2:])

    @torch.inference_mode()
    def decode(self, latent: torch.Tensor) -> torch.Tensor:
        """(B, t, h, w, latent_ch) -> (B, T, H, W, 3) f32."""
        b, t = latent.shape[:2]
        if self.temporal_compression_factor == 1:
            chunks = latent.reshape(b * t, 1, *latent.shape[2:])
        else:
            lcd = self.latent_chunk_duration
            if t % lcd:
                raise ValueError(f"latent T={t} not divisible by {lcd}")
            chunks = latent.reshape(b * (t // lcd), lcd, *latent.shape[2:])
        chunks = chunks * self.latent_std + self.latent_mean
        out = _batched(self.module.decode, chunks, self.max_dec_batch_size).float()
        if self.temporal_compression_factor != 1 and out.shape[1] != self.pixel_chunk_duration:
            raise ValueError(f"a chunk decoded to {out.shape[1]} frames, not "
                             f"{self.pixel_chunk_duration}")
        return out.reshape(b, -1, *out.shape[2:])


@dataclasses.dataclass
class ImageTokenizer:
    """The JITVAE equivalent: encode / decode of a wrapped module with its
    own latent mean / std, shape-agnostic (an image VAE on (B, H, W, C),
    or the causal video net on single-frame (B, 1, H, W, C) clips)."""

    module: Any
    latent_mean: Any = 0.0
    latent_std: Any = 1.0
    max_batch_size: int = 8

    @property
    def latent_ch(self) -> int:
        return self.module.cfg.embedding_dim

    @torch.inference_mode()
    def encode(self, state: torch.Tensor) -> torch.Tensor:
        lat = _batched(self.module.encode, state, self.max_batch_size).float()
        return (lat - self.latent_mean) / self.latent_std

    @torch.inference_mode()
    def decode(self, latent: torch.Tensor) -> torch.Tensor:
        return _batched(self.module.decode, latent * self.latent_std + self.latent_mean,
                        self.max_batch_size).float()


@dataclasses.dataclass
class JointImageVideoTokenizer:
    """T == 1 goes to the image branch, clips to the chunked video
    tokenizer. With `squeeze_for_image` the T axis is dropped around the
    image VAE; the shared variant keeps it and runs the one causal video
    net with the image mean / std."""

    image_vae: Any
    video_vae: VideoTokenizer
    squeeze_for_image: bool = True

    @classmethod
    def shared_jit(cls, module, image_mean_std=(0.0, 1.0), video_mean_std=(0.0, 1.0),
                   **video_kwargs) -> "JointImageVideoTokenizer":
        """One causal video net serves both branches, each with its own
        mean / std pair, the image branch keeping its T = 1 axis."""
        video = VideoTokenizer(module, latent_mean=video_mean_std[0],
                               latent_std=video_mean_std[1], **video_kwargs)
        image = ImageTokenizer(module, latent_mean=image_mean_std[0],
                               latent_std=image_mean_std[1])
        return cls(image_vae=image, video_vae=video, squeeze_for_image=False)

    def encode_image(self, state):
        if self.squeeze_for_image:
            return self.image_vae.encode(state[:, 0])[:, None]
        return self.image_vae.encode(state)

    def decode_image(self, latent):
        if self.squeeze_for_image:
            return self.image_vae.decode(latent[:, 0])[:, None]
        return self.image_vae.decode(latent)

    def encode(self, state):
        return self.encode_image(state) if state.shape[1] == 1 else self.video_vae.encode(state)

    def decode(self, latent):
        return self.decode_image(latent) if latent.shape[1] == 1 else self.video_vae.decode(latent)

    def get_latent_num_frames(self, num_pixel_frames: int) -> int:
        return 1 if num_pixel_frames == 1 else self.video_vae.get_latent_num_frames(
            num_pixel_frames)

    def get_pixel_num_frames(self, num_latent_frames: int) -> int:
        return 1 if num_latent_frames == 1 else self.video_vae.get_pixel_num_frames(
            num_latent_frames)

    @property
    def latent_ch(self) -> int:
        return self.video_vae.latent_ch

    @property
    def pixel_chunk_duration(self) -> int:
        return self.video_vae.pixel_chunk_duration

    @property
    def latent_chunk_duration(self) -> int:
        return self.video_vae.latent_chunk_duration

    @property
    def temporal_compression_factor(self) -> int:
        return self.video_vae.temporal_compression_factor
