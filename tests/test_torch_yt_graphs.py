"""The yt pass's chunk slots as CUDA graph replays (pipeline/slot_graphs.py).

On the CPU, on the tiny UNet: the variant keys of a 4-frame chunk (4 for
the first slot, 8 for the others); for each key, the split recorder lists
the matchings of an eager forward, operand shapes and all, and a forward
split at its matchings with the matcher called between the pieces, as a
replay calls it, gives the eager output exactly; the launch counts a
capture records are taken back out; the yt pass on the CPU stays eager;
`Generator._device_plan` scatters as host indices do.

On the card (`cuda` marker; these tests import no JAX and skip without a
card): two steps of the yt pass at 8 frames of 960x720 with the navsim
settings on the full-width UNet (random weights), graphed against eager,
under the attention backends None, "int8" and "int8pv": the outputs are
bit-equal, a wrapper on `tome.online_argmax_scores` sees the same
matchings in the same order with the same results, every slot after the
first two of the first window is a replay, nothing is captured after that
window, and the kernels' launch counts are the eager ones. Run them on the card with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_yt_graphs.py -q
"""

import numpy as np
import pytest
import torch

from tclight_torch.models.unet import ToMeSpec
from tclight_torch.ops import tome
from tclight_torch.pipeline import chunks as chunklib
from tclight_torch.pipeline import slot_graphs
from tclight_torch.pipeline.generator import Generator

NAVSIM = {"chunk_size": 4, "chunk_ord": "mix-4", "local_merge_ratio": 0.6,
          "merge_global": True, "global_merge_ratio": 0.5, "global_rand": 0.5,
          "align_batch": True, "max_downsample": 2, "cfg_dedup": True, "guidance_scale": 2.0,
          "alpha_t": 0.4, "final_factor_t": 0.01, "win_size_t": 64, "chunk_size_t": 0}
FIRST, LATER = slot_graphs.variant_keys(ToMeSpec(n_frames=4))
KEYS = list(FIRST.items()) + list(LATER.items())


def test_variant_keys_of_a_four_frame_chunk():
    """4 keys for the first slot (randf % 4) and 8 for the others (with the
    flip); every draw of the generator lands on one of them."""
    spec = ToMeSpec(n_frames=4)
    assert len(FIRST) == 4 and len(LATER) == 8 and not set(FIRST) & set(LATER)
    for randf in range(4):
        for flip in (False, True):
            assert slot_key_of(spec, randf, flip, False) in FIRST
            assert slot_key_of(spec, randf, flip, True) in LATER
    for key, args in KEYS:
        assert slot_key_of(spec, *args) == key
    # without the global merge the later slots have the first slot's keys
    first, later = slot_graphs.variant_keys(ToMeSpec(n_frames=4, merge_global=False))
    assert set(first) == set(later) and len(first) == 4


def slot_key_of(spec, randf, flip, use_global):
    return slot_graphs.slot_key(spec, randf, flip, use_global)


def _tiny_generator(device="cpu", dtype=torch.float32, **gen_cfg):
    from tclight_torch.pipeline.iclight import build_tiny_iclight

    models = build_tiny_iclight(seed=0, in_channels=8, dtype=dtype, device=device)
    return Generator(models, {"generation": {**NAVSIM, "n_timesteps": 2, **gen_cfg}},
                     device=device)


@pytest.fixture(scope="module")
def tiny():
    torch.manual_seed(0)
    gen = _tiny_generator()
    x = torch.randn(4, 8, 8, 4)  # a slot: 4 columns as (8, 8) images
    cc = torch.randn(4, 8, 8, 4)
    embeds = tuple(torch.randn(1, 8, 32) for _ in range(2))
    with torch.inference_mode():
        _, banks = gen._pred_chunk(gen.models, x, cc, embeds, 500.0, 0, False, None, False)
    return gen, x, cc, embeds, banks


@pytest.mark.parametrize("key,args", KEYS, ids=[str(k) for k, _ in KEYS])
def test_split_recorder_lists_the_eager_matchings(tiny, key, args):
    """For each variant key: the matchings the split recorder stages are
    those of an eager forward (count, operand shapes, dtype), and with the
    matcher called on the staged operands between the pieces, as a replay
    does, the forward's output and banks are the eager ones exactly."""
    gen, x, cc, embeds, banks0 = tiny
    randf, flip, use_global = args
    banks = banks0 if use_global else None

    def forward():
        return gen._pred_chunk(gen.models, x, cc, embeds, 500.0, randf, flip, banks, use_global)

    eager = slot_graphs.MatchList()
    with torch.inference_mode():
        with tome.matcher_hook(eager):
            eps_e, banks_e = forward()
        n, rows = slot_graphs.staging_size(eager.calls)
        rec = slot_graphs.SplitRecorder(torch.full((n,), float("nan")),
                                        torch.empty(rows), torch.empty(rows, dtype=torch.int32))

        def split_then_match(a, bt):
            out = rec(a, bt)
            av, bv, node_max, node_idx = rec.calls[-1]
            m, i = tome.online_argmax_scores(av, bv)
            node_max.copy_(m)
            node_idx.copy_(i)
            return out
        with tome.matcher_hook(split_then_match):
            rec.begin()
            eps_s, banks_s = forward()
            rec.end()
    assert len(eager.calls) == (8 if use_global else 4)  # 4 merging blocks in the tiny UNet
    assert [(tuple(a.shape), tuple(b.shape), a.dtype) for a, b, _, _ in rec.calls] == eager.calls
    assert rec.segments == []  # no graph pool: nothing captured
    for a, b, _, _ in rec.calls:  # K2's alignment
        assert a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
    assert torch.equal(eps_s, eps_e)
    assert banks_s.keys() == banks_e.keys()
    assert all(torch.equal(banks_s[k], banks_e[k]) for k in banks_e)


def test_capture_leaves_the_launch_counts_as_they_were():
    """What a capture records in `kernels.STATS` is taken back out and kept
    as the launches of one replay."""
    from tclight_torch.ops import kernels

    kernels.reset_stats()
    kernels.STATS["flash_attention"].record((2, 64))
    before = slot_graphs._launches()
    kernels.STATS["flash_attention"].record((2, 64))
    kernels.STATS["flash_attention"].record((4, 32))
    kernels.STATS["online_argmax_scores"].record((1, 8))
    got = slot_graphs._launches_since(before)
    assert {k: (n, dict(c)) for k, (n, c) in got.items()} == {
        "flash_attention": (2, {(2, 64): 1, (4, 32): 1}), "online_argmax_scores": (1, {(1, 8): 1})}
    assert slot_graphs._launches() == before
    kernels.reset_stats()


def test_yt_pass_on_the_cpu_stays_eager(monkeypatch):
    """On the CPU the yt windows run `_step_core`: no slot graphs are made,
    and the output is that of `_step_core` called in their place."""
    torch.manual_seed(1)
    x = torch.randn(6, 8, 12, 4)
    cc = torch.randn(6, 8, 12, 4)
    embeds = tuple(torch.randn(1, 8, 32) for _ in range(2))

    def yt(gen):
        with torch.inference_mode():
            return gen._temporal_noises(x, cc, embeds, 700.0, np.random.default_rng(5))

    def no_graphs(*a, **k):
        raise AssertionError("slot graphs on the CPU")
    monkeypatch.setattr(slot_graphs.SlotGraphs, "pred", no_graphs)
    gen = _tiny_generator(win_size_t=4)
    out = yt(gen)
    assert gen._slot_graphs is None and "yt_graphs" not in gen.stage_times
    ref_gen = _tiny_generator(win_size_t=4)
    ref_gen._yt_step_core = ref_gen._step_core
    assert torch.equal(out, yt(ref_gen))


def test_device_plan_scatters_as_the_eager_slots():
    """The plan uploaded once: each slot's indices, and the scatter of its
    valid frames against a write of them with host indices."""
    plan = chunklib.make_chunk_plan(23, 4, np.random.default_rng(2))
    idx, scatter = Generator._device_plan(plan, torch.device("cpu"))
    assert torch.equal(idx, torch.from_numpy(plan.indices.astype(np.int64)))
    got, ref = torch.zeros(23, 3), torch.zeros(23, 3)
    for s in range(plan.n_slots):
        e = torch.randn(4, 3)
        scatter(got, e, s)
        sel = np.flatnonzero(plan.valid[s])
        ref[torch.from_numpy(plan.indices[s][sel])] = e[torch.from_numpy(sel)]
    assert torch.equal(got, ref)
    assert not plan.valid.all()  # padded or empty slots among them


# ------------------------------------------------------------------ card


@pytest.fixture(scope="module")
def full_width():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the slots' graphs are CUDA graphs")
    from tclight_torch.models.unet import UNet2DCondition, UNetConfig
    from tclight_torch.ops import kernels
    from tclight_torch.pipeline.iclight import ICLightModels, init_like_flax
    from tclight_torch.diffusion.schedulers import DPMSolverMultistepScheduler

    kernels.build_all()
    with torch.device("cuda"):
        unet = UNet2DCondition(UNetConfig.sd15(in_channels=8))
    init_like_flax(unet, torch.Generator(device="cuda").manual_seed(0))
    unet.eval().requires_grad_(False)
    return ICLightModels(unet=unet, vae=None, text_encoder=None, tokenizer=None,
                         scheduler=DPMSolverMultistepScheduler(num_inference_steps=25))


def _yt_two_steps(models, backend, graphed: bool, monkeypatch):
    """Two steps of the yt pass (8 frames of 90 x 120 latents: one window of
    31 slots of 4 columns); returns (outputs, matchings, counters, the
    kernels' launch counts)."""
    from tclight_torch.ops import kernels

    flags = {"attn_qk_int8": backend is not None, "attn_pv_int8": backend == "int8pv"}
    gen = Generator(models, {"generation": {**NAVSIM, "n_timesteps": 25, **flags}},
                    device="cuda")
    assert gen.attn_backend == backend
    if not graphed:
        gen._yt_step_core = gen._step_core
    seen = []
    inner = tome.online_argmax_scores

    def wrapped(a, bt):
        m, i = inner(a, bt)
        seen.append((m.clone(), i.clone()))
        return m, i
    monkeypatch.setattr(tome, "online_argmax_scores", wrapped)
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(8, 90, 120, 4, device="cuda", generator=g)
    cc = torch.randn(8, 90, 120, 4, device="cuda", generator=g)
    embeds = tuple(torch.randn(1, 77, 768, device="cuda", generator=g) for _ in range(2))
    rng = np.random.default_rng(11)
    outs, counts = [], []
    kernels.reset_stats()
    with torch.inference_mode():
        for t in (999.0, 959.0):
            outs.append(gen._temporal_noises(x, cc, embeds, t, rng))
            x = 0.9 * x + 0.1 * outs[-1]
            counts.append(dict(gen.stage_times.get("yt_graphs", {})))
    torch.cuda.synchronize()
    monkeypatch.setattr(tome, "online_argmax_scores", inner)
    launches = {k: (st.launches, dict(st.shapes)) for k, st in kernels.STATS.items()}
    return outs, seen, counts, launches


@pytest.mark.cuda
@pytest.mark.parametrize("backend", [None, "int8", "int8pv"])
def test_graphed_yt_pass_is_the_eager_one(full_width, backend, monkeypatch):
    eager, seen_e, _, launches_e = _yt_two_steps(full_width, backend, False, monkeypatch)
    graphed, seen_g, counts, launches_g = _yt_two_steps(full_width, backend, True, monkeypatch)
    for a, b in zip(graphed, eager):
        assert torch.equal(a, b)
    assert len(seen_g) == len(seen_e) == 2 * (10 + 30 * 20)
    for (m_g, i_g), (m_e, i_e) in zip(seen_g, seen_e):
        assert torch.equal(m_g, m_e) and torch.equal(i_g, i_e)
    first, second = counts
    assert first["keys"] == 12 and first["eager"] == 2 and first["replayed"] == 29
    assert first["captured"] == 4 * 11 + 8 * 21 and first["capture_s"] > 0
    assert second["eager"] == 2 and second["replayed"] == 29 + 31
    assert second["captured"] == first["captured"]  # nothing captured into the pool again
    # the kernels' launch counts: a capture adds none, each replay its slot's
    assert launches_g == launches_e
