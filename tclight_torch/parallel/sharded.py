"""Multi-device execution of the TC-Light hot loops over torch.distributed
(counterpart of tclight_tpu/parallel/sharded.py).

- `build_parallel_denoise_step`: xy denoising with the chunk slots run in
  rounds of the data size: each data rank runs its slot of a round, all
  from the same global token banks; the banks then advance once per round,
  to those of the round's last slot (broadcast from the rank that ran it),
  and the slots' noise predictions are gathered to every rank.
- `build_sharded_exposure_step` / `build_sharded_uvt_step`: one
  post-optimization update with the frame batch split over the data ranks
  (the losses are pipeline/postopt.py's, the gradients summed over the
  data group before the same Adam step).
- `build_cp_dit_forward`: the context-parallel Cosmos DiT forward (frames,
  and so tokens, split over the data ranks; K and V all-gathered before
  each self-attention).

Without a mesh each builder gives the single-process computation it
stands for, which is what the multi-rank runs are held against.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from tclight_torch.parallel.mesh import Mesh, gather_rows
from tclight_torch.pipeline.postopt import PostOptConfig, exposure_loss, train_step, uvt_loss

__all__ = ["build_parallel_denoise_step", "build_cp_dit_forward", "build_sharded_uvt_step",
           "build_sharded_exposure_step", "pad_plans_to_rounds"]


def build_cp_dit_forward(model, mesh: Mesh | None):
    """Context-parallel GeneralDIT forward: each data rank holds T / data
    of the video's latent frames, and through the 3D patchify that share
    of the tokens; every self-attention all-gathers K and V over the data
    group, and the output frames are gathered at the end.

    fwd(x (B, T, H, W, C), c_noise (B,), context (B, S, Dc), **kw)
    -> (B, T, H, W, C_out) on every rank. T must divide by the data size
    (pad frames to a multiple upstream)."""

    def fwd(x, c_noise, context, **kw):
        return model(x, c_noise, context, mesh=mesh, **kw)

    return fwd


def pad_plans_to_rounds(plan_idx, plan_valid, round_size: int):
    """(slots, cs) plans -> (rounds, round_size, cs), padding with invalid
    slots."""
    slots = plan_idx.shape[0]
    rounds = -(-slots // round_size)
    pad = rounds * round_size - slots
    if pad:
        plan_idx = np.concatenate(
            [plan_idx, np.zeros((pad,) + plan_idx.shape[1:], plan_idx.dtype)])
        plan_valid = np.concatenate(
            [plan_valid, np.zeros((pad,) + plan_valid.shape[1:], bool)])
    return (plan_idx.reshape(rounds, round_size, -1),
            plan_valid.reshape(rounds, round_size, -1))


def build_parallel_denoise_step(unet, chunk_size: int, guidance: float, mesh: Mesh | None,
                                tome_spec=None):
    """The xy denoise step over round-grouped chunk plans.

    step(x (N, h, w, c), concat_conds (N, h, w, cc), (uncond, cond), t,
         plan_idx (R, rs, cs), plan_valid, randfs (R, rs), flips (R, rs))
    -> noises (N, h, w, c), the same on every rank. With a mesh, rs is
    its data size and data rank r runs slot r of each round; without one,
    the slots of a round run in turn, each from the round's input banks."""
    cs = chunk_size
    dtype = unet.config.dtype

    def pred_chunk(x_c, cc_c, embeds, t, randf, flip, banks, use_global):
        uncond, cond = embeds
        inp = torch.cat([torch.cat([x_c, x_c]), torch.cat([cc_c, cc_c])], dim=-1).to(dtype)
        ctx = torch.cat([uncond.expand(cs, -1, -1), cond.expand(cs, -1, -1)]).to(dtype)
        eps, banks = unet(inp, t, ctx, tome_spec=tome_spec, randf=randf, flip=flip,
                          banks=banks, use_global=use_global)
        eps_u, eps_c = eps.chunk(2)
        return eps_u + guidance * (eps_c - eps_u), banks

    @torch.inference_mode()
    def step(x, concat_conds, embeds, t, plan_idx, plan_valid, randfs, flips):
        rounds, rs = plan_idx.shape[:2]
        if mesh is not None and rs != mesh.shape["data"]:
            raise ValueError(f"rounds of {rs} slots on {mesh.shape['data']} data ranks")
        mine = [mesh.data_index] if mesh is not None else list(range(rs))
        last_rank = None if mesh is None else mesh.data_ranks()[rs - 1]
        noises = torch.zeros_like(x)
        banks = None
        for r in range(rounds):
            eps, round_banks = [], None
            for s in mine:
                idx = torch.as_tensor(plan_idx[r, s], dtype=torch.long, device=x.device)
                e, slot_banks = pred_chunk(x[idx], concat_conds[idx], embeds, t,
                                           int(randfs[r, s]), bool(flips[r, s]), banks, r > 0)
                eps.append(e)
                round_banks = slot_banks  # the last slot's, single-process
            eps = gather_rows(torch.stack(eps), mesh)  # (rs, cs, h, w, c)
            if mesh is not None:
                for key in sorted(round_banks):
                    dist.broadcast(round_banks[key], src=last_rank, group=mesh.data_group)
            banks = round_banks
            for s in range(rs):
                sel = np.flatnonzero(plan_valid[r, s])
                if sel.size:
                    pos = torch.as_tensor(sel, device=x.device)
                    noises[torch.as_tensor(plan_idx[r, s][sel], device=x.device)] = eps[s][pos]
        return noises

    return step


def build_sharded_uvt_step(mesh: Mesh | None, cfg: PostOptConfig, h: int, w: int,
                           warp_radius: int | None = None):
    """One UVT update with the frame batch split over the data ranks; the
    loss is pipeline.postopt.uvt_loss, the one the single-device epochs
    run. Returns (step, make_optimizer):

    step(features (P, 3), opt, frames (N, H, W, 3), past_flows, masks,
         tables, idxs (B,), bmask (B,)) -> loss, updating features in place;
    make_optimizer(features) -> Adam at cfg.feature_lr, eps 1e-15."""

    def make_optimizer(features):
        return torch.optim.Adam([features], lr=cfg.feature_lr, eps=1e-15)

    def step(features, opt, frames, past_flows, masks, tables, idxs, bmask):
        def loss_fn(i, m):
            return uvt_loss(features, frames, past_flows, masks, tables, i, m, cfg,
                            warp_radius, h, w, mesh)
        return train_step(features, opt, cfg.feature_lr, loss_fn, idxs, bmask, mesh)

    return step, make_optimizer


def build_sharded_exposure_step(mesh: Mesh | None, cfg: PostOptConfig, lr_schedule,
                                warp_radius: int | None = None):
    """One exposure-alignment update, the frame batch split over the data
    ranks; the loss is pipeline.postopt.exposure_loss. Returns (step,
    make_optimizer):

    step(exposure (N, 3, 4), opt, frames, past_flows, masks, idxs, bmask)
    -> loss, updating exposure in place at lr_schedule(update count)."""

    def make_optimizer(exposure):
        opt = torch.optim.Adam([exposure], lr=lr_schedule(0))
        opt.updates = 0
        return opt

    def step(exposure, opt, frames, past_flows, masks, idxs, bmask):
        def loss_fn(i, m):
            return exposure_loss(exposure, frames, past_flows, masks, i, m, cfg,
                                 warp_radius, mesh)
        loss = train_step(exposure, opt, lr_schedule(opt.updates), loss_fn, idxs, bmask, mesh)
        opt.updates += 1
        return loss

    return step, make_optimizer
