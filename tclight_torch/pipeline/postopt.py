"""The two-stage test-time post-optimization (counterpart of
tclight_tpu/pipeline/postopt.py).

Stage 1, exposure alignment: one learnable 3x4 affine colour matrix per
frame, optimized against (1-lf)[(1-ld) L1 + ld (1 - relaxed MS-SSIM)] + lf
flow-warped L1 with the log-lerp learning-rate schedule, then baked into
the frames.

Stage 2, Unique Video Tensor (UVT) refinement: the video becomes a palette
of flow-linked pixel tracks (`unq_inv`), each with its own learned SH-DC
colour, initialized by a scatter-mean and optimized against flow, DSSIM
and TV losses; the output video is a gather from the palette.

Epochs draw the JAX package's batches (`np.random.default_rng(seed)`
permutations, padded to `batch_size` with masked rows), and the optimizer
is Adam with the lr of update i set to `lr_fn(i)` before the step, as
optax counts. The palette gather has three exact adjoints, each an
autograd Function, chosen per video by `build_uvt_tables` as in JAX: the
banded route (K4/K5 on the card, both ways), the dense inverse map, and
the sorted CSR. None of them is a scatter with reassociated sums of
near-zero gradients: under Adam's eps=1e-15 a sign flip in such a
gradient becomes a full-lr step.

With a mesh (parallel/mesh.py) each data rank computes the per-sample
terms of its share of the batch, `_batch_constraint`'s counterpart; every
masked mean divides by the count over the whole batch, so the ranks'
shares sum to the single-device loss. The shares' gradients (and losses)
are summed over the data group before the same Adam step on every rank.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import time

import numpy as np
import torch
import torch.distributed as dist

from tclight_torch.ops import banded_gather as banded
from tclight_torch.ops.color import C0, RGB2SH
from tclight_torch.ops.flow import flow_radius, warp_flow
from tclight_torch.ops.losses import MS_SSIM_WEIGHTS, relaxed_ms_ssim
from tclight_torch.ops.schedules import expon_lr_schedule
from tclight_torch.parallel.mesh import data_rows
from tclight_torch.utils.logging import get_logger

__all__ = ["PostOptConfig", "flow_radius", "exposure_loss", "run_exposure_align", "train_step",
           "palette_pixel_index", "init_palette", "render_palette",
           "kinematic_relabel", "build_uvt_tables", "uvt_gather", "uvt_render",
           "uvt_loss", "run_uvt"]

log = get_logger()


@dataclasses.dataclass(frozen=True)
class PostOptConfig:
    """The post_opt config block (configs/tclight_default.yaml)."""

    epochs_exposure: int = 35
    epochs: int = 70
    batch_size: int = 16
    lambda_dssim: float = 0.2
    lambda_flow: float = 0.8
    lambda_tv: float = 0.05
    feature_lr: float = 0.05
    exposure_lr_init: float = 0.01
    exposure_lr_final: float = 0.001
    exposure_lr_delay_steps: int = 0
    exposure_lr_delay_mult: float = 0.0
    ms_ssim_start_level: int = 1
    # MS-SSIM pyramid levels; 5 is the reference, fewer allow small images
    ms_ssim_levels: int = 5


def _clip01(x: torch.Tensor) -> torch.Tensor:
    """clip to [0, 1] with jnp.clip's gradient (1/2 at the bounds)."""
    return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_ones(()))


def _sh2rgb(sh: torch.Tensor) -> torch.Tensor:
    """SH2RGB rounded once, as a fused multiply-add: the product of two
    f32 values is exact in f64, and so is its sum with 0.5. XLA fuses the
    JAX package's `sh * C0 + 0.5` this way, and the two roundings differ
    exactly where it matters: a palette entry initialized to 0 maps back
    to -7e-9 fused and to 0.0 unfused, which the clip then passes with
    gradient 0 or 1/2, and Adam (eps=1e-15) turns that into no step or a
    full-lr step every update."""
    c0 = float(np.float32(C0))
    return (sh.double() * c0 + 0.5).to(sh.dtype)


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with jnp.abs's gradient (+1 at 0)."""
    return torch.where(x >= 0, x, -x)


def _ms_ssim_per_sample(a, b, cfg: PostOptConfig):
    return relaxed_ms_ssim(a, b, start_level=cfg.ms_ssim_start_level, data_range=1.0,
                           size_average=False, weights=MS_SSIM_WEIGHTS[: cfg.ms_ssim_levels])


def _masked_mean(x_per_sample: torch.Tensor, weight: torch.Tensor,
                 rows: slice = slice(None)) -> torch.Tensor:
    """The masked mean over the batch of the per-sample terms of `rows`
    (the whole batch by default): their weighted sum over the batch's
    total weight, which a rank's share must divide by too."""
    w = weight.float()
    return (x_per_sample * w[rows]).sum() / torch.clamp(w.sum(), min=1.0)


def _apply_exposure(frames: torch.Tensor, exposure: torch.Tensor) -> torch.Tensor:
    """frames (B, H, W, 3) x exposure (B, 3, 4) -> clipped affine map,
    out[..., d] = sum_c frames[..., c] E[c, d] + E[d, 3]. Written as three
    broadcast multiply-adds rather than an einsum: as a (HW, 3) x (3, 3)
    matrix product, the forward and its weight gradient (a reduction over
    HW) go to tall, thin cuBLAS GEMMs that took 21 ms a call on a batch of
    16 frames at 960x720 (H100)."""
    m = exposure[:, None, None, :3, :3]
    out = (frames[..., 0:1] * m[..., 0, :] + frames[..., 1:2] * m[..., 1, :]
           + frames[..., 2:3] * m[..., 2, :])
    return _clip01(out + exposure[:, None, None, :3, 3])


def exposure_loss(exposure, frames, past_flows, masks_bwd, idxs, bmask,
                  cfg: PostOptConfig, warp_radius=None, mesh=None):
    """The stage-1 loss of one batch; idxs (B,) long, bmask (B,) bool.
    With a mesh, this data rank's share of it."""
    rows = data_rows(idxs.shape[0], mesh)
    ids = idxs[rows]
    edited = frames[ids]
    pre_idx = torch.clamp(ids - 1, min=0)
    images = _apply_exposure(edited, exposure[ids])
    pre_images = _apply_exposure(frames[pre_idx], exposure[pre_idx])
    l1_per = _abs(images - edited).mean(dim=(1, 2, 3))
    dssim_per = 1.0 - _ms_ssim_per_sample(images, edited, cfg)
    loss_photo = (_masked_mean(l1_per, bmask, rows) * (1 - cfg.lambda_dssim)
                  + _masked_mean(dssim_per, bmask, rows) * cfg.lambda_dssim)
    warped = warp_flow(pre_images, past_flows[ids].float(), radius=warp_radius)
    m = masks_bwd[ids].float()
    flow_per = _abs(warped * m - images * m).mean(dim=(1, 2, 3))
    loss_flow = _masked_mean(flow_per, bmask & (idxs > 0), rows)
    return (1 - cfg.lambda_flow) * loss_photo + cfg.lambda_flow * loss_flow


def _epoch_batches(n: int, batch_size: int, rng: np.random.Generator):
    """Shuffled, padded batch indices of one epoch: (n_batches, B) + mask."""
    perm = rng.permutation(n)
    n_batches = -(-n // batch_size)
    pad = n_batches * batch_size - n
    idxs = np.concatenate([perm, np.zeros(pad, np.int64)])
    mask = np.concatenate([np.ones(n, bool), np.zeros(pad, bool)])
    return (idxs.reshape(n_batches, batch_size).astype(np.int32),
            mask.reshape(n_batches, batch_size))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_step(param, opt, lr: float, loss_fn, idxs, bmask, mesh=None) -> torch.Tensor:
    """One Adam update of `param` at `lr` on the batch's loss. With a mesh,
    `loss_fn` gives this data rank's share, and the shares' gradients and
    losses are summed over the data group before the update. Returns the
    batch's loss."""
    for group in opt.param_groups:
        group["lr"] = lr
    opt.zero_grad(set_to_none=True)
    loss = loss_fn(idxs, bmask)
    loss.backward()
    loss = loss.detach().clone()
    if mesh is not None:
        dist.all_reduce(param.grad, group=mesh.data_group)
        dist.all_reduce(loss, group=mesh.data_group)
    opt.step()
    return loss


def _optimize(param, loss_fn, opt, lr_fn, n, cfg, epochs, seed, mesh=None):
    """Adam over `epochs` shuffled epochs; update i runs at lr_fn(i).
    Returns (loss history, per-epoch wall seconds)."""
    dev = param.device
    rng = np.random.default_rng(seed)
    history, epoch_times, step = [], [], 0
    for _ in range(epochs):
        t0 = time.perf_counter()
        idxs_all, masks_all = _epoch_batches(n, cfg.batch_size, rng)
        for idxs, bmask in zip(idxs_all, masks_all):
            history.append(train_step(param, opt, lr_fn(step), loss_fn,
                                      torch.from_numpy(idxs).long().to(dev),
                                      torch.from_numpy(bmask).to(dev), mesh))
            step += 1
        _sync(dev)
        epoch_times.append(time.perf_counter() - t0)
    hist = torch.stack(history).cpu().numpy() if history else np.zeros(0)
    return hist, np.asarray(epoch_times)


def run_exposure_align(frames: torch.Tensor, past_flows: torch.Tensor,
                       masks_bwd: torch.Tensor, cfg: PostOptConfig, seed: int = 0,
                       warp_radius: int | None = None, mesh=None):
    """Optimize per-frame affine exposure and bake it in. Returns (aligned
    frames, exposure (N, 3, 4), loss history, per-epoch wall seconds).
    With `mesh`, the frame batch is split over its data ranks."""
    n = frames.shape[0]
    if masks_bwd.dim() == 3:
        masks_bwd = masks_bwd[..., None]
    exposure = torch.eye(3, 4, device=frames.device).expand(n, 3, 4).clone()
    exposure.requires_grad_(True)
    total_iters = max(cfg.epochs_exposure * n // cfg.batch_size, 1)
    lr_fn = expon_lr_schedule(cfg.exposure_lr_init, cfg.exposure_lr_final,
                              cfg.exposure_lr_delay_steps, cfg.exposure_lr_delay_mult,
                              total_iters)
    opt = torch.optim.Adam([exposure], lr=lr_fn(0))

    def loss_fn(idxs, bmask):
        return exposure_loss(exposure, frames, past_flows, masks_bwd, idxs, bmask,
                             cfg, warp_radius, mesh)

    hist, times = _optimize(exposure, loss_fn, opt, lr_fn, n, cfg,
                            cfg.epochs_exposure, seed, mesh)
    with torch.no_grad():
        aligned = _apply_exposure(frames, exposure)
    return aligned, exposure.detach(), hist, times


# ------------------------------------------------------------ palette gather


def palette_pixel_index(inv_ids: np.ndarray, p_pad: int):
    """Per-frame track -> pixel inverse maps for the gather adjoint.
    Returns inv_map (N, p_pad) int32 (the first pixel of track p in frame
    f, or the sentinel HW), and ovf_pos / ovf_ids (N, O) int32: the
    duplicate pixels beyond the first occurrence and their tracks (padded
    with HW / p_pad)."""
    n, hw = inv_ids.shape
    inv_map = np.full((n, p_pad), hw, np.int32)
    pos = np.arange(hw, dtype=np.int32)
    ovf_pos, ovf_ids = [], []
    for f in range(n):
        inv_map[f, inv_ids[f, ::-1]] = pos[::-1]  # reversed: the first occurrence wins
        dup = inv_map[f, inv_ids[f]] != pos
        ovf_pos.append(pos[dup])
        ovf_ids.append(inv_ids[f, dup])
    o = max((len(x) for x in ovf_pos), default=0)
    op = np.full((n, o), hw, np.int32)
    oi = np.full((n, o), p_pad, np.int32)
    for f in range(n):
        op[f, : len(ovf_pos[f])] = ovf_pos[f]
        oi[f, : len(ovf_ids[f])] = ovf_ids[f]
    return inv_map, op, oi


def _segment_sum(vals: torch.Tensor, ids: torch.Tensor, num: int) -> torch.Tensor:
    out = vals.new_zeros((num, vals.shape[-1]))
    return out.index_add_(0, ids.reshape(-1).long(), vals.reshape(-1, vals.shape[-1]))


def _overflow_sum(g, ovf_pos, ovf_ids, p_pad):
    """Segment-sum of the cotangent rows at ovf_pos (HW = padding) into
    their tracks ovf_ids (p_pad = padding)."""
    b, hw, c = g.shape
    gpad = torch.cat([g, g.new_zeros(b, 1, c)], dim=1)
    vals = torch.gather(gpad, 1, ovf_pos.long()[..., None].expand(-1, -1, c))
    return _segment_sum(vals, ovf_ids, p_pad + 1)[:p_pad]


def _dense_adjoint(g, inv_map, ovf_pos, ovf_ids, p_pad):
    b, hw, c = g.shape
    gpad = torch.cat([g, g.new_zeros(b, 1, c)], dim=1)
    adj = torch.gather(gpad, 1, inv_map.long()[..., None].expand(-1, -1, c)).sum(dim=0)
    if ovf_pos.shape[1]:
        adj = adj + _overflow_sum(g, ovf_pos, ovf_ids, p_pad)
    return adj


class _DenseGather(torch.autograd.Function):
    """features (P, C) x inv_ids (B, HW) -> (B, HW, C); the adjoint gathers
    the cotangent through the static track -> pixel maps and sums over the
    batch, plus a segment-sum of the collision overflow."""

    @staticmethod
    def forward(ctx, features, inv_ids, inv_map, ovf_pos, ovf_ids):
        ctx.tabs, ctx.p_pad = (inv_map, ovf_pos, ovf_ids), features.shape[0]
        return features[inv_ids.long()]

    @staticmethod
    def backward(ctx, g):
        return (_dense_adjoint(g.contiguous(), *ctx.tabs, ctx.p_pad),) + (None,) * 4


def _banded_windows(hw: int, p_pad: int) -> tuple[int, int]:
    """(render window, adjoint window): each direction's density geometry,
    as the planner derived it."""
    return banded.banded_geometry(p_pad, hw)[0], banded.banded_geometry(hw, p_pad)[0]


def _banded_render(features, hw, fst, foff, fop, foi):
    b, nb, blk = foff.shape
    wf = _banded_windows(hw, features.shape[0])[0]
    if fst.dim() == 3:  # K-window plans
        raw = banded.banded_gather_multi(features, fst.reshape(-1, fst.shape[-1]),
                                         foff.reshape(-1, blk), wf)
    else:
        raw = banded.banded_gather(features, fst.reshape(-1), foff.reshape(-1, blk), wf)
    out = raw.reshape(b, nb * blk, -1)
    if fop.shape[1]:
        # exact patch for the window-miss pixels (pos -1 is padding)
        hit = fop >= 0
        rows = torch.arange(b, device=fop.device)[:, None].expand_as(fop)[hit]
        out[rows, fop[hit].long()] = features[foi[hit].long()].float()
    return out[:, :hw]


def _banded_adjoint(g, bst, boff, ovf_pos, ovf_ids, p_pad):
    b, hw, c = g.shape
    nbt, blk = boff.shape[1], boff.shape[2]
    wb = _banded_windows(hw, p_pad)[1]
    packed = banded.pack_frames(g)
    base = (torch.arange(b, dtype=torch.int32, device=g.device)
            * (banded.frame_tiles(hw) * 128))
    if bst.dim() == 3:
        per = banded.banded_gather_multi(
            packed, (bst + base[:, None, None]).reshape(-1, bst.shape[-1]),
            boff.reshape(-1, blk), wb)
    else:
        per = banded.banded_gather(packed, (bst + base[:, None]).reshape(-1),
                                   boff.reshape(-1, blk), wb)
    adj = per.reshape(b, nbt * blk, c).sum(dim=0)[:p_pad]
    if ovf_pos.shape[1]:
        adj = adj + _overflow_sum(g, ovf_pos, ovf_ids, p_pad)
    return adj


class _BandedGather(torch.autograd.Function):
    """The render as per-frame banded window gathers (K4/K5 on the card),
    window misses patched exactly; the adjoint is a track-major banded
    gather of the cotangent through the inverse position plans (absent
    tracks are masked entries), plus one segment-sum over the merged
    collision and window-miss overflow."""

    @staticmethod
    def forward(ctx, features, hw, fst, foff, fop, foi, bst, boff, op, oi):
        ctx.tabs, ctx.p_pad = (bst, boff, op, oi), features.shape[0]
        return _banded_render(features, hw, fst, foff, fop, foi)

    @staticmethod
    def backward(ctx, g):
        return (_banded_adjoint(g.contiguous(), *ctx.tabs, ctx.p_pad),) + (None,) * 9


def _sorted_adjoint(g, perm, ids_sorted, p_pad):
    adj = g.new_zeros((p_pad, g.shape[-1]))
    for gb, pb, ib in zip(g, perm, ids_sorted):
        adj = adj + _segment_sum(gb[pb.long()], ib, p_pad)
    return adj


class _SortedGather(torch.autograd.Function):
    """Memory-bounded route: per-frame pixel order presorted by track on
    the host; the adjoint is a gather and a sorted segment-sum per frame."""

    @staticmethod
    def forward(ctx, features, inv_ids, perm, ids_sorted):
        ctx.tabs, ctx.p_pad = (perm, ids_sorted), features.shape[0]
        return features[inv_ids.long()]

    @staticmethod
    def backward(ctx, g):
        return (_sorted_adjoint(g.contiguous(), *ctx.tabs, ctx.p_pad),) + (None,) * 3


def init_palette(frames: torch.Tensor, unq_inv: torch.Tensor, n_unique: int,
                 pad_to: int | None = None) -> torch.Tensor:
    """Scatter-mean per-track colour -> SH-DC palette; pad rows are zero."""
    n, h, w, c = frames.shape
    p = pad_to or n_unique
    flat = frames.reshape(n * h * w, c)
    sums = _segment_sum(flat, unq_inv, p)
    counts = _segment_sum(flat.new_ones(flat.shape[0], 1), unq_inv, p)[:, 0]
    return RGB2SH(sums / torch.clamp(counts, min=1.0)[:, None])


def render_palette(features_dc: torch.Tensor, unq_inv: torch.Tensor, shape) -> torch.Tensor:
    """Per-pixel colours gathered from the palette."""
    return _clip01(_sh2rgb(features_dc)[unq_inv.long()]).reshape(shape)


def kinematic_relabel(inv_np: np.ndarray, p_pad: int) -> np.ndarray:
    """Renumber tracks by their mean scanline position, so per-frame ids
    become near-monotone again on long videos (any consistent permutation
    of track ids is exact: the palette is learned per track)."""
    n, hw = inv_np.shape
    counts = np.bincount(inv_np.reshape(-1), minlength=p_pad)
    pos = np.arange(hw, dtype=np.float64)
    sums = np.zeros(p_pad, np.float64)
    for t in range(n):  # frame by frame: bounds the bincount temporaries
        sums += np.bincount(inv_np[t], weights=pos, minlength=p_pad)
    mean = sums / np.maximum(counts, 1)
    mean[counts == 0] = np.inf  # palette pad rows rank last
    order = np.argsort(mean, kind="stable").astype(np.int32)
    rank = np.empty(p_pad, np.int32)
    rank[order] = np.arange(p_pad, dtype=np.int32)
    return rank[inv_np]


# Route budgets, copied from the JAX package so that both packages pick the
# same route for the same ids. They were sized for a 16 GB TPU v5e, not for
# the H100's 80 GB (ROADMAP lists them).
# The dense (N, P) inverse map costs N*P*4 bytes; above this the sorted CSR
# adjoint takes over.
_DENSE_MAP_MAX_BYTES = int(5e8)
# int16 banded plans of both gather directions, and plans + f32 frames
_BANDED_PLAN_MAX_BYTES = int(3.5e9)
_BANDED_PLAN_PLUS_FRAMES_MAX_BYTES = int(7.5e9)

# single-slot cache of built UVT tables (see build_uvt_tables)
_UVT_TABLE_CACHE: dict = {}


def _build_banded_tables(plan_fn, bwd_plan_fn, inv_np, hw, p_pad, plan_bytes, nwin):
    """Plan both gather directions and assemble the 10 banded tables (numpy),
    or None if either direction's full plan rejects the ids."""
    fseg, fst, foff, fop, foi, fok = plan_fn(inv_np)
    if not fok:
        return None
    inv_map_np, ovf_pos_np, ovf_ids_np = palette_pixel_index(inv_np, p_pad)
    pos = np.where(inv_map_np == hw, -1, inv_map_np)
    bseg, bst, boff, bop, boi, bok = bwd_plan_fn(pos)
    if not bok:
        return None
    # the adjoint plan's window misses: its rows are tracks and its values
    # pixel positions; swap them into the (pixel, track) collision
    # convention and merge both into one segment-sum patch
    bop_pix = np.where(bop >= 0, boi, hw).astype(np.int32)
    bop_trk = np.where(bop >= 0, bop, p_pad).astype(np.int32)
    op_all = np.concatenate([ovf_pos_np, bop_pix], axis=1)
    oi_all = np.concatenate([ovf_ids_np, bop_trk], axis=1)
    log.info("UVT: banded-gather route (%d tracks, %d window(s)/block, plans %.0f MB, "
             "overflow fwd %d + bwd %d cols)", p_pad, nwin, plan_bytes / 1e6,
             fop.shape[1], op_all.shape[1])
    return (fseg, fst, foff, fop, foi, bseg, bst, boff, op_all, oi_all)


def _pick_banded_plan(inv_np, n, hw, p_pad):
    """The cheapest banded plan kind that covers the ids (one window, then
    2 or 3 windows, then both again on kinematically relabeled ids), judged
    on a few sampled frames. Returns (plan_fn, bwd_plan_fn, nwin, ids) or
    None."""
    wf, sf = banded.banded_geometry(p_pad, hw)
    fgeo = dict(window=wf, slope=sf)

    def pick(ids):
        sample = ids[:: max(1, n // 4)][:4]
        if banded.plan_banded_gather_rows_robust(sample, **fgeo)[-1]:
            return functools.partial(banded.plan_banded_gather_rows_robust, **fgeo), 1
        for k in (2, 3):
            if banded.plan_banded_gather_rows_multi(sample, n_windows=k, **fgeo)[-1]:
                return functools.partial(banded.plan_banded_gather_rows_multi,
                                         n_windows=k, **fgeo), k
        return None, 0

    used = inv_np
    plan_fn, nwin = pick(inv_np)
    if plan_fn is None:
        relabeled = kinematic_relabel(inv_np, p_pad)
        plan_fn, nwin = pick(relabeled)
        if plan_fn is None:
            return None
        log.info("UVT: kinematic track relabeling restored the banded id "
                 "structure (%d windows/block)", nwin)
        used = relabeled
    # the adjoint plan's rows are tracks and its values pixel positions:
    # same planner kind, its own density geometry
    wb, sb = banded.banded_geometry(hw, p_pad)
    bgeo = dict(window=wb, slope=sb)
    bwd_fn = (functools.partial(banded.plan_banded_gather_rows_robust, **bgeo)
              if nwin == 1 else
              functools.partial(banded.plan_banded_gather_rows_multi, n_windows=nwin,
                                **bgeo))
    return plan_fn, bwd_fn, nwin, used


def build_uvt_tables(unq_inv: np.ndarray, n: int, h: int, w: int, p_pad: int,
                     allow_banded: bool | None = None, device="cpu"):
    """Static per-frame palette-index tables on `device`. Returns (tables,
    inv_np): 10 tables -> the banded route both ways (when the ids meet
    the window precondition); 4 -> the dense inverse-map adjoint; 3 -> the
    sorted CSR adjoint (very long videos). `allow_banded=None` takes the
    banded route on a CUDA device only (on the CPU its plain version is no
    faster than the dense route).

    The banded tables are cached in a single slot keyed on a digest of the
    ids: a Generator serves many prompts per video."""
    device = torch.device(device)
    if allow_banded is None:
        allow_banded = device.type == "cuda"
    hw = h * w
    inv_np = np.asarray(unq_inv, np.int32).reshape(n, hw)
    key = (hashlib.blake2b(inv_np.tobytes(), digest_size=16).hexdigest(),
           n, h, w, p_pad, bool(allow_banded), str(device))
    cached = _UVT_TABLE_CACHE.get("slot")
    if cached is not None and cached[0] == key:
        return cached[1], cached[2]

    def put(arrays):
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays)

    if allow_banded:
        # int16 offsets: 2 bytes x 512 entries per block, both directions
        plan_bytes = 2 * 512 * n * (banded.row_blocks(hw) + banded.row_blocks(p_pad))
        if (plan_bytes <= _BANDED_PLAN_MAX_BYTES
                and plan_bytes + 4 * n * hw * 3 <= _BANDED_PLAN_PLUS_FRAMES_MAX_BYTES):
            picked = _pick_banded_plan(inv_np, n, hw, p_pad)
            if picked is not None:
                plan_fn, bwd_fn, nwin, used = picked
                arrays = _build_banded_tables(plan_fn, bwd_fn, used, hw, p_pad,
                                              plan_bytes, nwin)
                if arrays is not None:
                    tables = put(arrays)
                    _UVT_TABLE_CACHE["slot"] = (key, tables, used)
                    return tables, used
    if n * p_pad * 4 <= _DENSE_MAP_MAX_BYTES:
        rest = palette_pixel_index(inv_np, p_pad)
    else:
        perm_np = np.argsort(inv_np, axis=1, kind="stable").astype(np.int32)
        rest = (perm_np, np.take_along_axis(inv_np, perm_np, axis=1))
    # dense and sorted tables are cheap to build and can be large: not cached
    return put((inv_np,) + tuple(rest)), inv_np


def uvt_gather(features: torch.Tensor, tables, idx: torch.Tensor, hw: int) -> torch.Tensor:
    """Palette gather of frames `idx` through the route the tables hold
    (10 = banded, 4 = dense inverse map, 3 = sorted CSR) -> (B, HW, C)."""
    if len(tables) == 10:
        _, fst, foff, fop, foi, _, bst, boff, op, oi = tables
        return _BandedGather.apply(features, hw, fst[idx], foff[idx], fop[idx], foi[idx],
                                   bst[idx], boff[idx], op[idx], oi[idx])
    if len(tables) == 4:
        inv, inv_map, op, oi = tables
        return _DenseGather.apply(features, inv[idx], inv_map[idx], op[idx], oi[idx])
    inv, perm, ids_sorted = tables
    return _SortedGather.apply(features, inv[idx], perm[idx], ids_sorted[idx])


def _uvt_adjoint(tables, idx, cot, p_pad):
    """The palette gather's adjoint applied to cot (B, HW, C)."""
    if len(tables) == 10:
        return _banded_adjoint(cot, tables[6][idx], tables[7][idx], tables[8][idx],
                               tables[9][idx], p_pad)
    if len(tables) == 4:
        return _dense_adjoint(cot, tables[1][idx], tables[2][idx], tables[3][idx], p_pad)
    return _sorted_adjoint(cot, tables[1][idx], tables[2][idx], p_pad)


def uvt_render(features, tables, idx, h: int, w: int) -> torch.Tensor:
    return _clip01(_sh2rgb(uvt_gather(features, tables, idx, h * w))).reshape(-1, h, w, 3)


def uvt_loss(features, frames, past_flows, masks_bwd, tables, idxs, bmask,
             cfg: PostOptConfig, warp_radius, h: int, w: int, mesh=None):
    """The stage-2 loss of one batch. With a mesh, this data rank's share
    of it."""
    rows = data_rows(idxs.shape[0], mesh)
    ids = idxs[rows]
    pre_idx = torch.clamp(ids - 1, min=0)
    images = uvt_render(features, tables, ids, h, w)
    pre_images = uvt_render(features, tables, pre_idx, h, w)
    edited = frames[ids]
    warped = warp_flow(pre_images, past_flows[ids].float(), radius=warp_radius)
    m = masks_bwd[ids].float()
    flow_per = _abs(warped * m - images * m).mean(dim=(1, 2, 3))
    loss_flow = _masked_mean(flow_per, bmask & (idxs > 0), rows)
    dssim_per = 1.0 - _ms_ssim_per_sample(images, edited, cfg)
    loss_photo = _masked_mean(dssim_per, bmask, rows) * cfg.lambda_dssim
    # per-sample TV, masked mean over the real batch rows
    c = images.shape[-1]
    h_tv = ((images[:, 1:] - images[:, :-1]) ** 2).sum(dim=(1, 2, 3))
    w_tv = ((images[:, :, 1:] - images[:, :, :-1]) ** 2).sum(dim=(1, 2, 3))
    tv_per = 2.0 * (h_tv / (c * (h - 1) * w) + w_tv / (c * h * (w - 1)))
    tv = cfg.lambda_tv * _masked_mean(tv_per, bmask, rows)
    return (1 - cfg.lambda_flow) * loss_photo + cfg.lambda_flow * loss_flow + tv


def run_uvt(frames: torch.Tensor, past_flows: torch.Tensor, masks_bwd: torch.Tensor,
            unq_inv: np.ndarray, n_unique: int, cfg: PostOptConfig, seed: int = 0,
            warp_radius: int | None = None, allow_banded: bool | None = None,
            mesh=None):
    """Unique-Video-Tensor optimization. Returns (rendered frames, loss
    history, per-epoch wall seconds). With `mesh`, the frame batch is
    split over its data ranks."""
    if cfg.epochs <= 0:
        return frames, np.zeros(0), np.zeros(0)
    n, h, w, _ = frames.shape
    dev = frames.device
    if masks_bwd.dim() == 3:
        masks_bwd = masks_bwd[..., None]
    p_pad = max(128, int(np.ceil(n_unique / 128)) * 128)
    tables, inv_np = build_uvt_tables(unq_inv, n, h, w, p_pad, allow_banded, dev)

    # scatter-mean init, frame-chunked: the per-track sums are the palette
    # gather's adjoint applied to the frames; counts from a host bincount
    counts = torch.from_numpy(np.maximum(
        np.bincount(inv_np.reshape(-1), minlength=p_pad), 1.0).astype(np.float32)).to(dev)
    init_bs = min(16, n)
    sums = torch.zeros((p_pad, 3), device=dev)
    with torch.no_grad():
        for c0 in range(0, n, init_bs):
            sel = np.arange(c0, min(c0 + init_bs, n))
            pad = init_bs - len(sel)
            idx = torch.from_numpy(np.concatenate([sel, np.zeros(pad, np.int64)])).to(dev)
            cot_mask = torch.from_numpy(
                np.concatenate([np.ones(len(sel)), np.zeros(pad)]).astype(np.float32)).to(dev)
            cot = frames[idx].reshape(init_bs, h * w, 3) * cot_mask[:, None, None]
            sums = sums + _uvt_adjoint(tables, idx, cot, p_pad)
    features = RGB2SH(sums / counts[:, None]).requires_grad_(True)
    feature_lr = cfg.feature_lr * cfg.batch_size / n
    opt = torch.optim.Adam([features], lr=feature_lr, eps=1e-15)

    def loss_fn(idxs, bmask):
        return uvt_loss(features, frames, past_flows, masks_bwd, tables, idxs, bmask,
                        cfg, warp_radius, h, w, mesh)

    hist, times = _optimize(features, loss_fn, opt, lambda _: feature_lr, n, cfg,
                            cfg.epochs, seed, mesh)
    with torch.no_grad():
        rendered = torch.cat([
            uvt_render(features, tables, torch.arange(c0, min(c0 + init_bs, n), device=dev),
                       h, w)
            for c0 in range(0, n, init_bs)])
    return rendered, hist, times
