"""One denoising step of TC-Light's sampler, in plain float32.

The xy pass runs the UNet on every chunk slot of the step's plan, in
order, each slot merging against the banks the slot before left; the
classifier-free guidance mixes each chunk's [uncond | cond] outputs. With
alpha_t > 0 the yt pass does the same on the width columns of the clip,
seen as (time, height) images, over overlapping temporal windows, and its
prediction, renormalised to the xy one's per-(frame, channel) mean and std
(AdaIN, unbiased variance + 1e-5), is mixed in with weight
alpha_t * final_factor_t ** (i / n_steps). The DPM-Solver++ step (dpm.py)
then moves the sample.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tcbench.reference import chunks, dpm
from tcbench.reference.unet import UNet


def draws(settings: dict, n_frames: int, width: int, clip_seed: int, upto: int) -> list:
    """Every step's plan draws up to step `upto`, as the sampler makes
    them from the clip's seed: per step the xy pass's, then each yt
    window's."""
    g = settings["generation"]
    rng = np.random.default_rng(clip_seed)
    args = (g["chunk_ord"], g["merge_global"], g["global_rand"])
    out = []
    for _ in range(upto + 1):
        xy = chunks.step_draws(n_frames, g["chunk_size"], rng, *args)
        yt = []
        if g["alpha_t"] > 0:
            _, starts, _ = chunks.yt_windows(n_frames, g["win_size_t"])
            cs = min(g["chunk_size_t"] or g["chunk_size"], width)
            yt = [chunks.step_draws(width, cs, rng, *args) for _ in starts]
        out.append((xy, yt))
    return out


def pass_noise(unet: UNet, x: torch.Tensor, conds: torch.Tensor, embeds, t: float,
               plan, guidance: float, dedup: bool) -> torch.Tensor:
    """One pass over a plan: the CFG noise prediction of every frame of x."""
    indices, valid, randfs, flips = plan
    uncond, cond = embeds
    out = torch.zeros_like(x)
    banks: dict = {}
    for s in range(len(indices)):
        idx = torch.as_tensor(indices[s], device=x.device)
        inp = torch.cat([x[idx], conds[idx]], dim=-1)
        cs = len(idx)
        ctx = torch.cat([uncond.expand(cs, -1, -1), cond.expand(cs, -1, -1)])
        slot = {"randf": int(randfs[s]), "flip": bool(flips[s]), "use_global": s > 0}
        eps, banks = unet(inp if dedup else torch.cat([inp, inp]), t, ctx, slot, banks, dedup)
        eu, ec = eps.chunk(2)
        e = eu + guidance * (ec - eu)
        keep = np.flatnonzero(valid[s])
        if keep.size:
            out[torch.as_tensor(indices[s][keep], device=x.device)] = e[torch.as_tensor(
                keep, device=x.device)]
    return out


def _mean_std(x: torch.Tensor):
    flat = x.reshape(x.shape[0], -1, x.shape[-1])
    return flat.mean(1)[:, None, None], (flat.var(1, unbiased=True) + 1e-5).sqrt()[:, None, None]


def noise_prediction(unet: UNet, settings: dict, x: torch.Tensor, conds: torch.Tensor,
                     embeds, embeds_t, i: int, step_draws, dedup: bool = False) -> torch.Tensor:
    """The step's fused noise prediction from its sample x (N, H, W, C)."""
    g = settings["generation"]
    n_steps = g["n_timesteps"]
    t = float(dpm.timesteps(n_steps)[i])
    xy_plan, yt_plans = step_draws
    eps = pass_noise(unet, x, conds, embeds, t, xy_plan, g["guidance_scale"], dedup)
    if g["alpha_t"] <= 0:
        return eps
    win, starts, overlaps = chunks.yt_windows(x.shape[0], g["win_size_t"])
    eps_t = torch.zeros_like(x)
    for w_i, (start, plan) in enumerate(zip(starts, yt_plans)):
        xt = x[start:start + win].permute(2, 0, 1, 3).contiguous()
        ct = conds[start:start + win].permute(2, 0, 1, 3).contiguous()
        pred = pass_noise(unet, xt, ct, embeds_t, t, plan, g["guidance_scale"], dedup)
        eps_t[start:start + win] = pred.permute(1, 2, 0, 3)
        if start > 0:
            eps_t[start:start + overlaps[w_i - 1]] *= math.sqrt(0.5)
    alpha = g["alpha_t"] * g["final_factor_t"] ** min(i / n_steps, 1.0)
    m_t, s_t = _mean_std(eps_t)
    m, s = _mean_std(eps)
    eps_t = (eps_t - m_t) / s_t * s + m
    return math.sqrt(alpha) * eps_t + math.sqrt(1.0 - alpha) * eps
