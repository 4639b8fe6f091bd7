"""The FSQ discrete video tokenizer of the AR pipeline: finite scalar
quantization, causal 3D Haar patching and a small causal convolutional
encoder / decoder (counterpart of tclight_tpu/cosmos/fsq.py).

- `FSQuantizer`: each latent channel bounded with tanh and rounded to one
  of `levels[i]` values (straight through); the joint index is the
  mixed-radix integer of the digits. The bound's shift is
  tan(offset / half), as in JAX (the checkpoint-faithful quantizer of
  dv_tokenizer.py takes arctanh and an eps).
- `haar_patch_3d` / `haar_unpatch_3d`: one level halves (T, H, W) and
  multiplies the channels by 8, sub-bands channel-major.
- `CausalConv3D`: a 3D convolution whose time is zero-padded on the left
  only, height and width by k // 2 on each side.
- `CausalDiscreteVideoTokenizer`: encode (B, T, H, W, 3) -> (indices (B,
  t, h, w), quantized codes (B, t, h, w, dim)); decode_indices back.

Layout is JAX's channel-last at every boundary; the modules carry the
flax module names (`enc_in.Conv_0`, `enc_blocks_0.GroupNorm_0`, ...), so
`models/bridge.py`'s `flax_to_state_dict` maps JAX's parameter tree onto
them (a 3D kernel (kT, kH, kW, I, O) becomes (O, I, kT, kH, kW)).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["FSQuantizer", "haar_patch_3d", "haar_unpatch_3d", "CausalConv3D",
           "CausalDiscreteVideoTokenizer", "TokenizerConfig", "from_flax"]


class FSQuantizer:
    """Finite scalar quantizer over the last axis."""

    def __init__(self, levels: Sequence[int] = (8, 8, 8, 5, 5, 5)):
        self.levels = np.asarray(levels, np.int32)
        self.dim = len(levels)
        self.basis = np.concatenate([[1], np.cumprod(self.levels[:-1])]).astype(np.int64)

    @property
    def codebook_size(self) -> int:
        return int(np.prod(self.levels))

    def _consts(self, device):
        lv = torch.as_tensor(self.levels, dtype=torch.float32, device=device)
        half = (lv - 1) / 2
        offset = torch.where(lv % 2 == 0, 0.5, 0.0)
        return half, offset

    def bound(self, z: torch.Tensor) -> torch.Tensor:
        half, offset = self._consts(z.device)
        shift = torch.tan(offset / half.clamp_min(1e-6))
        return torch.tanh(z + shift) * half - offset

    def quantize(self, z: torch.Tensor) -> torch.Tensor:
        """z (..., dim) -> the rounded values (straight-through form)."""
        zb = self.bound(z)
        return zb + (torch.round(zb) - zb).detach()

    def codes_to_indices(self, q: torch.Tensor) -> torch.Tensor:
        half, offset = self._consts(q.device)
        digits = torch.round(q + half + offset)
        basis = torch.as_tensor(self.basis, device=q.device)
        return (digits.long() * basis).sum(-1).to(torch.int32)

    def indices_to_codes(self, idx: torch.Tensor) -> torch.Tensor:
        half, offset = self._consts(idx.device)
        basis = torch.as_tensor(self.basis, device=idx.device)
        lv = torch.as_tensor(self.levels.astype(np.int64), device=idx.device)
        digits = (idx.long()[..., None] // basis) % lv
        return digits.float() - half - offset


_H = 1.0 / math.sqrt(2.0)


def haar_patch_3d(x: torch.Tensor, levels: int = 1) -> torch.Tensor:
    """Causal 3D Haar wavelet packet transform of (B, T, H, W, C), T even:
    t, then h, then w, each band pair concatenated on the channels."""
    for _ in range(levels):
        for dim in (1, 2, 3):
            even = x.narrow(dim, 0, x.shape[dim] // 2 * 2)
            pair = even.unflatten(dim, (x.shape[dim] // 2, 2))
            a, b = pair.select(dim + 1, 0), pair.select(dim + 1, 1)
            x = torch.cat([(a + b) * _H, (a - b) * _H], dim=-1)
    return x


def haar_unpatch_3d(x: torch.Tensor, levels: int = 1) -> torch.Tensor:
    """Inverse of `haar_patch_3d`."""
    for _ in range(levels):
        for dim in (3, 2, 1):
            lo, hi = x.chunk(2, dim=-1)
            x = torch.stack([(lo + hi) * _H, (lo - hi) * _H], dim=dim + 1).flatten(dim, dim + 1)
    return x


class CausalConv3D(nn.Module):
    """(B, C, T, H, W) -> (B, O, T', H', W'): time zero-padded by kt - 1
    on the left, height and width by k // 2 on each side."""

    def __init__(self, cin: int, cout: int, kernel=(3, 3, 3), strides=(1, 1, 1)):
        super().__init__()
        kt, kh, kw = kernel
        self.pad = (kw // 2, kw // 2, kh // 2, kh // 2, kt - 1, 0)
        self.Conv_0 = nn.Conv3d(cin, cout, kernel, stride=strides)

    def forward(self, x):
        return self.Conv_0(F.pad(x, self.pad))


@dataclasses.dataclass(frozen=True)
class TokenizerConfig:
    channels: int = 64
    n_res_blocks: int = 2
    latent_dim: int = 6           # == len(fsq_levels)
    fsq_levels: tuple = (8, 8, 8, 5, 5, 5)
    patch_levels: int = 1
    dtype: torch.dtype = torch.float32

    @staticmethod
    def tiny() -> "TokenizerConfig":
        return TokenizerConfig(channels=16, n_res_blocks=1, fsq_levels=(5, 5, 5), latent_dim=3)


class _ResBlock3D(nn.Module):
    """GroupNorm(8) (eps 1e-6), SiLU, causal conv, twice; a 1x1x1 shortcut
    (JAX's Dense) when the width changes."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.GroupNorm_0 = nn.GroupNorm(8, cin, eps=1e-6)
        self.CausalConv3D_0 = CausalConv3D(cin, cout)
        self.GroupNorm_1 = nn.GroupNorm(8, cout, eps=1e-6)
        self.CausalConv3D_1 = CausalConv3D(cout, cout)
        if cin != cout:
            self.Dense_0 = nn.Linear(cin, cout)

    def forward(self, x):
        h = self.CausalConv3D_0(F.silu(self.GroupNorm_0(x)))
        h = self.CausalConv3D_1(F.silu(self.GroupNorm_1(h)))
        if hasattr(self, "Dense_0"):
            x = self.Dense_0(x.movedim(1, -1)).movedim(-1, 1)
        return x + h


class CausalDiscreteVideoTokenizer(nn.Module):
    """encode: video (B, T, H, W, 3) -> (indices, quantized latents);
    decode_indices: indices -> video. The Haar patch does the
    spatio-temporal downsampling; the convolutions are causal in time."""

    def __init__(self, cfg: TokenizerConfig):
        super().__init__()
        self.cfg = cfg
        c, n = cfg.channels, len(cfg.fsq_levels)
        cin = 3 * 8 ** cfg.patch_levels
        self.quantizer = FSQuantizer(cfg.fsq_levels)
        self.enc_in = CausalConv3D(cin, c)
        for i in range(cfg.n_res_blocks):
            setattr(self, f"enc_blocks_{i}", _ResBlock3D(c, c))
        self.enc_out = nn.Linear(c, n)
        self.dec_in = nn.Linear(n, c)
        for i in range(cfg.n_res_blocks):
            setattr(self, f"dec_blocks_{i}", _ResBlock3D(c, c))
        self.dec_out = CausalConv3D(c, cin)
        self.to(cfg.dtype)

    def _dtype(self):
        return self.enc_out.weight.dtype

    def encode(self, video: torch.Tensor):
        x = haar_patch_3d(video.to(self._dtype()), self.cfg.patch_levels)
        h = self.enc_in(x.movedim(-1, 1))
        for i in range(self.cfg.n_res_blocks):
            h = getattr(self, f"enc_blocks_{i}")(h)
        z = self.enc_out(h.movedim(1, -1))
        q = self.quantizer.quantize(z)
        return self.quantizer.codes_to_indices(q), q

    def decode_codes(self, q: torch.Tensor) -> torch.Tensor:
        h = self.dec_in(q.to(self._dtype())).movedim(-1, 1)
        for i in range(self.cfg.n_res_blocks):
            h = getattr(self, f"dec_blocks_{i}")(h)
        x = self.dec_out(h).movedim(1, -1)
        return haar_unpatch_3d(x, self.cfg.patch_levels)

    def decode_indices(self, idx: torch.Tensor) -> torch.Tensor:
        return self.decode_codes(self.quantizer.indices_to_codes(idx))

    def forward(self, video):
        idx, q = self.encode(video)
        return self.decode_codes(q), idx


def from_flax(params) -> dict[str, torch.Tensor]:
    """The JAX package's tokenizer tree ({'params': ...} or its inside,
    numpy leaves) -> the port's state dict."""
    from tclight_torch.cosmos.convert_dit import _flatten

    if "params" in params:
        params = params["params"]
    out = {}
    for path, v in _flatten(params).items():
        *mods, leaf = path.split("/")
        v = np.array(v, np.float32)
        if leaf == "kernel":
            leaf, v = "weight", (v.transpose(4, 3, 0, 1, 2) if v.ndim == 5 else v.T)
        elif leaf == "scale":
            leaf = "weight"
        out[".".join(mods + [leaf])] = torch.from_numpy(np.ascontiguousarray(v))
    return out
