"""Multi-rank dry run on the CPU: n gloo ranks run the parallel denoise
step, the sharded exposure and UVT steps and the context-parallel DiT
forward on tiny models, and each result is held against the same call in
one process without a process group (the shape of the JAX package's
`__graft_entry__.dryrun_multichip`).

    python -m tclight_torch.parallel.dryrun --n 4

prints one line: the mesh and, per job, the largest difference from the
single-process run. The jobs' inputs come from numpy seeds, so the tests
build the same inputs for the JAX package; `run_world` runs any jobs in a
spawned world and returns each rank's results.
"""

from __future__ import annotations

import argparse
import socket
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from tclight_torch.parallel.mesh import Mesh, make_mesh, shard_params, unshard_params

__all__ = ["run_world", "JOBS", "tiny_unet", "denoise_inputs", "postopt_inputs",
           "tiny_dit", "dit_inputs"]

N_FRAMES, LAT = 10, 16
POST_N, POST_HW = 8, 32


# ---------------------------------------------------------------- inputs


def tiny_unet():
    """The tiny 4-channel UNet (f32, CPU, weights from seed 0) and the ToMe
    spec of the JAX package's parallel tests."""
    from tclight_torch.models.unet import ToMeSpec, UNet2DCondition, UNetConfig
    from tclight_torch.pipeline.iclight import init_like_flax

    unet = UNet2DCondition(UNetConfig.tiny(in_channels=4))
    init_like_flax(unet, torch.Generator().manual_seed(0))
    unet.eval().requires_grad_(False)
    return unet, ToMeSpec(n_frames=4, local_ratio=0.5, merge_global=True)


def denoise_inputs(round_size: int) -> dict:
    """A 10-frame chunk plan in rounds of `round_size`, its randfs and
    flips, latents and prompt features (numpy)."""
    from tclight_torch.parallel.sharded import pad_plans_to_rounds
    from tclight_torch.pipeline.chunks import make_chunk_plan

    rng = np.random.default_rng(3)
    plan = make_chunk_plan(N_FRAMES, 4, rng)
    plan_idx, plan_valid = pad_plans_to_rounds(plan.indices, plan.valid, round_size)
    rounds, rs = plan_idx.shape[:2]
    randfs = rng.integers(0, 4, size=(rounds, rs)).astype(np.int32)
    flips = rng.random((rounds, rs)) > 0.5
    x = rng.standard_normal((N_FRAMES, LAT, LAT, 4)).astype(np.float32)
    uncond = rng.standard_normal((1, 77, 32)).astype(np.float32)
    cond = 2.0 * rng.standard_normal((1, 77, 32)).astype(np.float32)
    return dict(x=x, cc=np.zeros((N_FRAMES, LAT, LAT, 0), np.float32), uncond=uncond,
                cond=cond, t=np.float32(5.0), plan_idx=plan_idx, plan_valid=plan_valid,
                randfs=randfs, flips=flips)


def postopt_inputs() -> dict:
    """Frames, flows and masks of the JAX package's post-opt mesh test."""
    rng = np.random.default_rng(0)
    n, h, w = POST_N, POST_HW, POST_HW
    return dict(frames=rng.uniform(0.2, 0.8, (n, h, w, 3)).astype(np.float32),
                flows=rng.normal(0, 0.5, (n, h, w, 2)).astype(np.float32),
                masks=np.ones((n, h, w), np.float32),
                unq_inv=np.tile(np.arange(h * w, dtype=np.int32), n))


def postopt_config():
    from tclight_torch.pipeline.postopt import PostOptConfig

    return PostOptConfig(epochs_exposure=2, epochs=2, batch_size=4, ms_ssim_levels=2)


def tiny_dit():
    """The tiny DiT with every weight drawn (gates non-zero), seed 0."""
    from tclight_torch.cosmos.dit import DiTConfig, GeneralDIT, init_dit_

    model = GeneralDIT(DiTConfig.tiny())
    init_dit_(model, torch.Generator().manual_seed(0))
    return model.eval().requires_grad_(False)


def dit_inputs() -> dict:
    """(2, 8, 8, 8, 4) latents, noise levels and context (numpy)."""
    rng = np.random.default_rng(1)
    return dict(x=rng.standard_normal((2, 8, 8, 8, 4)).astype(np.float32),
                c_noise=np.array([0.3, 0.7], np.float32),
                ctx=rng.standard_normal((2, 16, 32)).astype(np.float32))


# ---------------------------------------------------------------- jobs


def job_mesh(mesh: Mesh | None, payload) -> dict:
    """The mesh's coordinates, and a column-parallel Linear against the
    whole one (`_kernel_spec`: 128 outputs shard over 2, 4 stay whole)."""
    if mesh is None:
        return {}
    from torch import nn

    gen = torch.Generator().manual_seed(0)
    dense, small = nn.Linear(64, 128), nn.Linear(4, 4)
    for m in (dense, small):
        with torch.no_grad():
            m.weight.normal_(generator=gen)
            m.bias.normal_(generator=gen)
    x = torch.randn(3, 64, generator=gen)
    ref = dense(x).detach()
    net = nn.Sequential(dense, nn.Identity(), small)
    shard_params(net, mesh)
    out = {"coords": np.array([mesh.data_index, mesh.model_index, *mesh.shape.values()]),
           "dense_rows": np.array(dense.weight.shape[0]),
           "small_rows": np.array(small.weight.shape[0]),
           "tp_err": np.array(float((dense(x) - ref).abs().max()))}
    unshard_params(net, mesh)
    out["unsharded_err"] = np.array(float((dense(x) - ref).abs().max()))
    return out


def job_denoise(mesh: Mesh | None, payload) -> dict:
    """The parallel denoise step (rounds of the data size, 4 without a
    mesh), tensor-parallel UNet when the mesh has model ranks."""
    from tclight_torch.parallel.sharded import build_parallel_denoise_step

    rs = mesh.shape["data"] if mesh is not None else (payload or {}).get("round_size", 4)
    unet, spec = tiny_unet()
    if mesh is not None:
        shard_params(unet, mesh)
    d = denoise_inputs(rs)
    step = build_parallel_denoise_step(unet, 4, 2.0, mesh, tome_spec=spec)
    t = {k: torch.from_numpy(np.asarray(d[k])) for k in ("x", "cc", "uncond", "cond")}
    noises = step(t["x"], t["cc"], (t["uncond"], t["cond"]), float(d["t"]), d["plan_idx"],
                  d["plan_valid"], d["randfs"], d["flips"])
    return {"noises": noises.numpy()}


def job_postopt(mesh: Mesh | None, payload) -> dict:
    """run_exposure_align and run_uvt (2 epochs each, batch 4), then one
    update of each sharded step builder."""
    from tclight_torch.ops.schedules import expon_lr_schedule
    from tclight_torch.parallel.sharded import (build_sharded_exposure_step,
                                                build_sharded_uvt_step)
    from tclight_torch.pipeline.postopt import (build_uvt_tables, init_palette,
                                                run_exposure_align, run_uvt)

    d = {k: torch.from_numpy(v) for k, v in postopt_inputs().items()}
    cfg = postopt_config()
    n, h, w = POST_N, POST_HW, POST_HW
    a, e, he, _ = run_exposure_align(d["frames"], d["flows"], d["masks"], cfg, seed=3,
                                     mesh=mesh)
    r, hu, _ = run_uvt(a, d["flows"], d["masks"], d["unq_inv"].numpy(), h * w, cfg, seed=3,
                       mesh=mesh)
    out = {"exposure": e.numpy(), "exposure_hist": he, "uvt": r.numpy(), "uvt_hist": hu}

    b = 4
    idxs, bmask = torch.arange(b), torch.tensor([True, True, True, False])
    masks = d["masks"][..., None]
    exp_step, make_opt = build_sharded_exposure_step(
        mesh, cfg, expon_lr_schedule(0.01, 0.001, max_steps=10))
    expo = torch.eye(3, 4).expand(n, 3, 4).clone().requires_grad_(True)
    opt = make_opt(expo)
    out["step_exposure_loss"] = np.array(float(
        exp_step(expo, opt, d["frames"], d["flows"], masks, idxs, bmask)))
    out["step_exposure"] = expo.detach().numpy()
    p_pad = 1024
    tables, _ = build_uvt_tables(d["unq_inv"].numpy(), n, h, w, p_pad)
    with torch.no_grad():
        feats = init_palette(d["frames"], d["unq_inv"], h * w, pad_to=p_pad)
    feats.requires_grad_(True)
    uvt_step, make_opt = build_sharded_uvt_step(mesh, cfg, h, w)
    opt = make_opt(feats)
    out["step_uvt_loss"] = np.array(float(
        uvt_step(feats, opt, d["frames"], d["flows"], masks, tables, idxs, bmask)))
    out["step_uvt"] = feats.detach().numpy()
    return out


def job_cp_dit(mesh: Mesh | None, payload) -> dict:
    """The context-parallel DiT forward and EDM denoiser."""
    from tclight_torch.cosmos.dit import make_edm_denoiser
    from tclight_torch.parallel.sharded import build_cp_dit_forward

    model = tiny_dit()
    d = {k: torch.from_numpy(v) for k, v in dit_inputs().items()}
    with torch.inference_mode():
        out = build_cp_dit_forward(model, mesh)(d["x"], d["c_noise"], d["ctx"])
        x0 = make_edm_denoiser(model, d["ctx"][:1], mesh=mesh)(d["x"][:1], 1.3)
    return {"dit": out.numpy(), "x0": x0.numpy()}


def job_generator(mesh: Mesh | None, payload) -> dict:
    """The port's Generator on the tiny IC-Light stack; `payload` holds
    the config (with or without its `parallel` block), the frame ids and
    the output directory."""
    from tclight_torch.config import ConfigDict
    from tclight_torch.data.dataparsers import VideoDataParser
    from tclight_torch.pipeline.generator import Generator
    from tclight_torch.pipeline.iclight import build_tiny_iclight

    cfg = ConfigDict(payload["config"])
    models = build_tiny_iclight(seed=0, num_inference_steps=2, device="cpu")
    gen = Generator(models, cfg, data_parser=VideoDataParser(cfg.data), device="cpu")
    if dist.is_initialized() != (gen.mesh is not None):
        raise RuntimeError("the Generator's mesh disagrees with the world")
    out = gen(None, payload["out_dir"], payload["frame_ids"])
    return {"frames": next(iter(out.values()))}


JOBS = {"mesh": job_mesh, "denoise": job_denoise, "postopt": job_postopt,
        "cp_dit": job_cp_dit, "generator": job_generator}


# ---------------------------------------------------------------- world


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(rank: int, world: int, port: int, jobs, out_dir: str, model_parallel: int,
            payload) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        results = {}
        # the Generator makes its own mesh, from its config's parallel block
        mesh = make_mesh(world, model_parallel) if set(jobs) - {"generator"} else None
        for job in jobs:
            res = JOBS[job](mesh, payload)
            results.update({f"{job}/{k}": v for k, v in res.items()})
        np.savez(Path(out_dir) / f"rank{rank}.npz", **results)
    finally:
        dist.destroy_process_group()


def run_world(n: int, jobs, model_parallel: int = 1, payload=None) -> list[dict]:
    """Run `jobs` (names in JOBS) on n spawned gloo ranks; returns each
    rank's {job/key: array}."""
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_worker, args=(n, _free_port(), list(jobs), tmp, model_parallel, payload or {}),
                 nprocs=n, join=True)
        outs = []
        for r in range(n):
            with np.load(Path(tmp) / f"rank{r}.npz") as z:
                outs.append({k: z[k] for k in z.files})
        return outs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=4, help="ranks (gloo, on the CPU)")
    args = p.parse_args(argv)
    model_parallel = 2 if args.n % 2 == 0 and args.n > 1 else 1
    torch.set_num_threads(1)
    jobs = ("denoise", "postopt", "cp_dit")
    outs = run_world(args.n, jobs, model_parallel)
    data = args.n // model_parallel
    ref = {}
    for job in jobs:
        res = JOBS[job](None, {"round_size": data})
        ref.update({f"{job}/{k}": v for k, v in res.items()})
    errs = {k: max(float(np.abs(np.asarray(o[k], np.float64) - ref[k]).max()) for o in outs)
            for k in sorted(ref)}
    ok = all(np.isfinite(list(errs.values())))
    print(f"dryrun {'OK' if ok else 'FAILED'}: {args.n} gloo ranks, mesh "
          f"{{'data': {data}, 'model': {model_parallel}}}; max |multi-rank - one process|: "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
