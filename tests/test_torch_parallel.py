"""The port's multi-device layer (tclight_torch/parallel/, the Generator's
`parallel` block, the post-optimization's mesh) on CPU gloo worlds of 2
and 4 ranks, spawned with torch.multiprocessing (the children run
`tclight_torch.parallel.dryrun`'s jobs and import no JAX).

- Multi-rank against the same call in one process without a process
  group: within 2e-5 (the JAX package's own context-parallel tolerance);
  the Generator with `parallel: {n_devices: 2, model_parallel: 2 or 1}`
  within the JAX test's limits (max 2e-2, mean 2e-3).
- Against the JAX package's 8-device CPU mesh on the same weights and
  inputs: the parallel denoise step (rounds of 4: JAX's mesh of 8 with
  model_parallel 2), the post-optimization (its runs and one update of
  each sharded step builder) and the context-parallel DiT forward, within
  1e-4 of max |reference|.
- `parallel.n_devices: 2` without a process group raises ValueError.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tclight_torch.models import bridge
from tclight_torch.parallel import dryrun
from tclight_torch.parallel.mesh import _kernel_spec, make_mesh
from tclight_torch.parallel.sharded import pad_plans_to_rounds
from tclight_torch.utils.video_io import save_frames

torch.set_num_threads(2)

MULTI_TOL = 2e-5


def _rel(ref) -> float:
    return 1e-4 * float(np.abs(ref).max())


def _single(job, payload=None) -> dict:
    return dryrun.JOBS[job](None, payload or {})


@pytest.fixture(scope="module")
def world4():
    """4 ranks, one model rank: the mesh, the denoise step (rounds of 4),
    the post-optimization and the CP DiT."""
    return dryrun.run_world(4, ("mesh", "denoise", "postopt", "cp_dit"), model_parallel=1)


@pytest.fixture(scope="module")
def world2():
    """2 ranks, one model rank: the post-optimization and the CP DiT."""
    return dryrun.run_world(2, ("postopt", "cp_dit"), model_parallel=1)


@pytest.fixture(scope="module")
def single_postopt():
    return _single("postopt")


@pytest.fixture(scope="module")
def jax_dit():
    """JAX's GeneralDIT on the port's tiny DiT weights (the JAX converter
    on the port's Cosmos-layout state dict)."""
    from tclight_torch.cosmos.convert_dit import reference_state_dict
    from tclight_tpu.cosmos.convert_dit import convert_general_dit
    from tclight_tpu.cosmos.dit import DiTConfig, GeneralDIT

    model = GeneralDIT(DiTConfig.tiny())
    return model, convert_general_dit(reference_state_dict(dryrun.tiny_dit()))


def test_make_mesh_shapes(world4, tmp_path):
    """Rank r sits where JAX's mesh puts device r; a world that does not
    divide raises, as does a mesh without a process group."""
    from tclight_tpu.parallel.mesh import make_mesh as jmake_mesh

    with pytest.raises(ValueError):
        make_mesh(6, model_parallel=4)
    with pytest.raises(ValueError, match="process group"):
        make_mesh(4, model_parallel=2)
    jmesh = jmake_mesh(4, model_parallel=1)
    for r, out in enumerate(world4):
        pos = np.argwhere(np.vectorize(lambda d: d.id)(jmesh.devices) == jax.devices()[r].id)[0]
        data_i, model_i, data, model = out["mesh/coords"]
        assert (data_i, model_i) == tuple(pos)
        assert {"data": data, "model": model} == dict(jmesh.shape)
    # the 2 x 2 layout of a world of 4 with model_parallel 2, rank by rank
    j22 = jmake_mesh(4, model_parallel=2)
    assert dict(j22.shape) == {"data": 2, "model": 2}
    for r in range(4):
        pos = np.argwhere(np.vectorize(lambda d: d.id)(j22.devices) == jax.devices()[r].id)[0]
        assert tuple(pos) == (r // 2, r % 2)


def test_shard_params_rules():
    """`_kernel_spec` is JAX's rule for rule; on a 2 x 2 world the
    column-parallel Linear keeps half its rows and gives the whole
    Linear's output, and unsharding restores it."""
    from tclight_tpu.parallel.mesh import _kernel_spec as jspec

    for leaf, shape in (("kernel", (64, 128)), ("bias", (128,)), ("kernel", (4, 4)),
                        ("embedding", (1000, 32)), ("kernel", (3, 3, 16, 24)),
                        ("kernel", (64, 130)), ("scale", (128,))):
        for size in (1, 2, 4):
            assert _kernel_spec(leaf, shape, size) == tuple(jspec(leaf, shape, size)), (leaf, shape)
    outs = dryrun.run_world(4, ("mesh",), model_parallel=2)
    for r, out in enumerate(outs):
        assert tuple(out["mesh/coords"]) == (r // 2, r % 2, 2, 2)
        assert out["mesh/dense_rows"] == 64 and out["mesh/small_rows"] == 4
        assert out["mesh/tp_err"] < 1e-5 and out["mesh/unsharded_err"] == 0


def test_pad_plans_to_rounds():
    """Equal to JAX's on the same plan; padded slots are invalid."""
    from tclight_torch.pipeline.chunks import make_chunk_plan
    from tclight_tpu.parallel.sharded import pad_plans_to_rounds as jpad

    plan = make_chunk_plan(10, 4, np.random.default_rng(0))
    for rs in (2, 4, 8):
        idx, valid = pad_plans_to_rounds(plan.indices, plan.valid, rs)
        jidx, jvalid = jpad(plan.indices, plan.valid, rs)
        np.testing.assert_array_equal(idx, jidx)
        np.testing.assert_array_equal(valid, jvalid)
        assert idx.shape[1:] == (rs, 4) and idx.shape[0] * rs >= plan.n_slots
        assert not valid.reshape(-1, 4)[plan.n_slots:].any()


def test_parallel_denoise_covers_all_frames(world4):
    """4 data ranks, rounds of 4: every frame predicted, every rank the
    same noises, equal to one process's rounds within 2e-5 and to JAX's
    step on its 8-device mesh (model_parallel 2, so rounds of 4) within
    1e-4 of max |reference|, on the same plan, randfs and flips."""
    from tclight_tpu.models.unet import ToMeSpec as JSpec
    from tclight_tpu.models.unet import UNet2DCondition as JUNet
    from tclight_tpu.models.unet import UNetConfig as JCfg
    from tclight_tpu.parallel.mesh import make_mesh as jmake_mesh
    from tclight_tpu.parallel.sharded import build_parallel_denoise_step as jbuild

    ref = _single("denoise", {"round_size": 4})["noises"]
    for out in world4:
        np.testing.assert_allclose(out["denoise/noises"], ref, atol=MULTI_TOL, rtol=0)
    assert (np.abs(ref).reshape(ref.shape[0], -1).max(axis=1) > 1e-6).all()

    unet, _ = dryrun.tiny_unet()
    d = dryrun.denoise_inputs(4)
    junet = JUNet(JCfg.tiny(in_channels=4),
                  tome_spec=JSpec(n_frames=4, local_ratio=0.5, merge_global=True))
    mesh = jmake_mesh(8, model_parallel=2)
    step = jbuild(junet, 4, 2.0, mesh)
    with mesh:
        jn = step(bridge.module_to_flax(unet), jnp.asarray(d["x"]), jnp.asarray(d["cc"]),
                  (jnp.asarray(d["uncond"]), jnp.asarray(d["cond"])), jnp.asarray(d["t"]),
                  jnp.asarray(d["plan_idx"]), jnp.asarray(d["plan_valid"]),
                  jnp.asarray(d["randfs"]), jnp.asarray(d["flips"]))
    jn = np.asarray(jn)
    np.testing.assert_allclose(world4[0]["denoise/noises"], jn, atol=_rel(jn), rtol=0)


@pytest.fixture(scope="module")
def jax_mesh_postopt():
    """The JAX package's postopt job on its 8-device mesh (model_parallel
    2, so 4 data devices): run_exposure_align, run_uvt, and one update of
    each sharded step builder, on dryrun's inputs and config."""
    from tclight_tpu.ops.schedules import expon_lr_schedule
    from tclight_tpu.parallel.mesh import make_mesh as jmake_mesh
    from tclight_tpu.parallel.sharded import build_sharded_exposure_step as jexp_step
    from tclight_tpu.parallel.sharded import build_sharded_uvt_step as juvt_step
    from tclight_tpu.pipeline import postopt as jpo

    d = dryrun.postopt_inputs()
    n, h, w = dryrun.POST_N, dryrun.POST_HW, dryrun.POST_HW
    cfg = jpo.PostOptConfig(epochs_exposure=2, epochs=2, batch_size=4, ms_ssim_levels=2)
    mesh = jmake_mesh(8, model_parallel=2)
    frames, flows, masks = (jnp.asarray(d[k]) for k in ("frames", "flows", "masks"))
    a, e, he, _ = jpo.run_exposure_align(frames, flows, masks, cfg, seed=3, mesh=mesh)
    r, hu, _ = jpo.run_uvt(a, flows, masks, d["unq_inv"], h * w, cfg, seed=3, mesh=mesh)
    out = {"exposure": e, "exposure_hist": he, "uvt": r, "uvt_hist": hu}
    idxs, bmask = jnp.arange(4), jnp.asarray([True, True, True, False])
    step, tx = jexp_step(mesh, cfg, expon_lr_schedule(0.01, 0.001, max_steps=10))
    expo = jnp.broadcast_to(jnp.eye(3, 4), (n, 3, 4))
    with mesh:
        expo, _, loss = step(expo, tx.init(expo), frames, flows, masks[..., None], idxs, bmask)
    out.update(step_exposure_loss=loss, step_exposure=expo)
    tables, _ = jpo.build_uvt_tables(d["unq_inv"], n, h, w, 1024)
    feats = jpo.init_palette(frames, jnp.asarray(d["unq_inv"]), h * w, pad_to=1024)
    step, tx = juvt_step(mesh, cfg, h, w)
    with mesh:
        feats, _, loss = step(feats, tx.init(feats), frames, flows, masks[..., None], tables,
                              idxs, bmask)
    out.update(step_uvt_loss=loss, step_uvt=feats)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("world", ["world2", "world4"])
def test_postopt_mesh_matches_single_device(world, single_postopt, jax_mesh_postopt, request):
    """run_exposure_align / run_uvt and one update of each sharded step
    builder, batch split over 2 or 4 data ranks, against one process
    within 2e-5: the masked means divide by the whole batch's count (a row
    is masked in the step builders' batch), so the shares sum to the same
    loss. Each rank's results also match the JAX package's on its 8-device
    mesh within 1e-4 of max |reference|."""
    for out in request.getfixturevalue(world):
        for key, ref in single_postopt.items():
            np.testing.assert_allclose(out[f"postopt/{key}"], ref, atol=MULTI_TOL, rtol=0,
                                       err_msg=key)
            jref = jax_mesh_postopt[key]
            np.testing.assert_allclose(out[f"postopt/{key}"], jref, atol=_rel(jref), rtol=0,
                                       err_msg=f"{key} against JAX's mesh")


@pytest.mark.parametrize("world", ["world2", "world4"])
def test_cp_dit_forward_matches_single_device(world, jax_dit, request):
    """The context-parallel DiT forward and EDM denoiser on 2 and 4 data
    ranks (8 latent frames: 4 or 2 a rank) against one process (2e-5) and
    against JAX's build_cp_dit_forward on its 8-device mesh (1e-4 of max
    |reference|); non-zero gates, so every block counts."""
    from tclight_tpu.cosmos.dit import make_edm_denoiser as jdenoiser
    from tclight_tpu.parallel.mesh import make_mesh as jmake_mesh
    from tclight_tpu.parallel.sharded import build_cp_dit_forward as jcp

    ref = _single("cp_dit")
    model, params = jax_dit
    d = dryrun.dit_inputs()
    mesh = jmake_mesh(8, model_parallel=1)
    with mesh:
        jout = np.asarray(jcp(model, mesh)(params, jnp.asarray(d["x"]),
                                           jnp.asarray(d["c_noise"]), jnp.asarray(d["ctx"])))
        jx0 = np.asarray(jdenoiser(model, params, jnp.asarray(d["ctx"][:1]), mesh=mesh)(
            jnp.asarray(d["x"][:1]), 1.3))
    for out in request.getfixturevalue(world):
        np.testing.assert_allclose(out["cp_dit/dit"], ref["dit"], atol=MULTI_TOL, rtol=0)
        np.testing.assert_allclose(out["cp_dit/x0"], ref["x0"], atol=MULTI_TOL, rtol=0)
        np.testing.assert_allclose(out["cp_dit/dit"], jout, atol=_rel(jout), rtol=0)
        np.testing.assert_allclose(out["cp_dit/x0"], jx0, atol=_rel(jx0), rtol=0)
    # the gates are live: the blocks move the output
    zeroed = dryrun.tiny_dit()
    for blk in zeroed.blocks.values():
        for sub in blk.blocks:
            torch.nn.init.zeros_(sub.adaLN_modulation[-1].weight)
    with torch.inference_mode():
        ident = zeroed(*(torch.from_numpy(d[k]) for k in ("x", "c_noise", "ctx"))).numpy()
    assert np.abs(ident - ref["dit"]).max() > 0.1 * np.abs(ref["dit"]).max()


def _generator_config(tmp_path):
    rng = np.random.default_rng(0)
    base = rng.uniform(0.2, 0.8, (32, 32, 3)).astype(np.float32)
    vid_dir = tmp_path / "vid"
    save_frames(np.stack([np.roll(base, 2 * t, axis=1) for t in range(8)]), vid_dir)
    return {
        "work_dir": str(tmp_path / "wd"),
        "data": {"scene_type": "video", "rgb_path": str(vid_dir), "height": 32, "width": 32,
                 "fps": 8, "flow_model": "farneback"},
        "generation": dict(guidance_scale=2.0, n_timesteps=2, chunk_size=4, chunk_ord="mix-4",
                           local_merge_ratio=0.5, merge_global=True, global_merge_ratio=0.5,
                           align_batch=True, max_downsample=2, noise_mode="same",
                           alpha_t=0.0, negative_prompt="bad quality",
                           prompt={"test": "warm sunset light"}, save_frame=False),
        "post_opt": {"apply_opt": True, "epochs_exposure": 1, "epochs": 1, "batch_size": 4,
                     "ms_ssim_levels": 2},
        "seed": 7,
    }


@pytest.fixture(scope="module")
def generator_single(tmp_path_factory):
    """The config, and the frames of the Generator in one process."""
    tmp = tmp_path_factory.mktemp("generator")
    cfg = _generator_config(tmp)
    ref = _single("generator", {"config": cfg, "out_dir": str(tmp / "one"),
                                "frame_ids": list(range(8))})["frames"]
    return cfg, ref


@pytest.mark.parametrize("model_parallel", [2, 1])
def test_generator_mesh_matches_single_device(tmp_path, model_parallel, generator_single):
    """The Generator under `parallel: {n_devices: 2, model_parallel: 2}`
    (the UNet's column-parallel modules split over the 2 model ranks) and
    `model_parallel: 1` (each chunk's UNet batch split over the 2 data
    ranks, gathered around the token merging; the post-optimization's
    batches split too) on a 2-rank gloo world against one process: JAX's
    limits, max 2e-2 and mean 2e-3; both ranks end with the same frames."""
    cfg, ref = generator_single
    cfg_mesh = dict(cfg, parallel={"n_devices": 2, "model_parallel": model_parallel})
    outs = dryrun.run_world(2, ("generator",), payload={
        "config": cfg_mesh, "out_dir": str(tmp_path / "mesh"), "frame_ids": list(range(8))})
    for out in outs:
        got = out["generator/frames"]
        assert got.shape == ref.shape == (8, 32, 32, 3)
        np.testing.assert_allclose(got, ref, atol=2e-2, rtol=0)
        assert np.abs(got - ref).mean() < 2e-3
    np.testing.assert_array_equal(outs[0]["generator/frames"], outs[1]["generator/frames"])
    assert (tmp_path / "mesh").is_dir()


def test_generator_refuses_n_devices_without_a_process_group(tmp_path):
    """C9: `parallel.n_devices: 2` in one process raises ValueError naming
    the key and what it found, where it used to run on one device."""
    from tclight_torch.config import ConfigDict
    from tclight_torch.pipeline.generator import Generator
    from tclight_torch.pipeline.iclight import build_tiny_iclight

    cfg = ConfigDict(dict(_generator_config(tmp_path),
                          parallel={"n_devices": 2, "model_parallel": 1}))
    models = build_tiny_iclight(seed=0, num_inference_steps=2, device="cpu")
    with pytest.raises(ValueError, match=r"parallel\.n_devices=2.*no process group"):
        Generator(models, cfg, device="cpu")
    # n_devices 1 (or absent) is the single-device run
    Generator(models, ConfigDict(dict(_generator_config(tmp_path),
                                      parallel={"n_devices": 1})), device="cpu")
