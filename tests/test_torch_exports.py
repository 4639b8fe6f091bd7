"""The JAX package's remaining exports in the port, held against JAX on the
same numpy inputs from a seed: the ToMe "mean" merge (1e-6: index_add_
against .at[].add sums) and the unmerges (gathers, exact), the resample
samplers (1e-5), the chunk plans, `iter_leaves`, `save_video_stream`, the
logging helpers, the two host tools and the two scripts; the Generator's
output stage (output_gt.mp4 encoded on a thread during the fetch,
`output_fetch` / `output_save` as the JAX package records them); and a guard
that every public top-level name of `tclight_tpu` has a counterpart in the
port or a line in ROADMAP.md's "Not to port" list."""

import ast
import importlib.util
import json
import logging
import os
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tclight_tpu import config as jconfig
from tclight_tpu.ops import resample as jresample
from tclight_tpu.ops import tome as jtome
from tclight_tpu.pipeline import chunks as jchunks
from tclight_tpu.utils import video_io as jvideo_io
from tclight_torch import config as tconfig
from tclight_torch.ops import resample as tresample
from tclight_torch.ops import tome as ttome
from tclight_torch.pipeline import chunks as tchunks
from tclight_torch.utils import logging as tlogging
from tclight_torch.utils import video_io as tvideo_io

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
MEAN_TOL = dict(atol=1e-6, rtol=0)


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


# --- ToMe ---------------------------------------------------------------


@pytest.mark.parametrize("mode", ["replace", "mean"])
@pytest.mark.parametrize("align_batch", [True, False])
def test_local_chain_merge_and_unmerge_match(mode, align_batch):
    rng = np.random.default_rng(3)
    b, f, tnum, c, randf = 2, 8, 20, 16, 3
    x = rng.standard_normal((b, f * tnum, c)).astype(np.float32)
    levels = ttome.plan_local_levels(f, tnum, 0.6, 2)
    merged_j, infos_j = jax.jit(jtome.local_merge_sequence, static_argnums=(2, 4, 5))(
        jnp.asarray(x), jnp.asarray(x), tuple(jtome.plan_local_levels(f, tnum, 0.6, 2)),
        jnp.int32(randf), align_batch, mode)
    infos_j = [mi._replace(n_total=int(mi.n_total)) for mi in infos_j]
    merged_t, infos_t = ttome.local_merge_sequence(_t(x), _t(x), levels, randf,
                                                   align_batch, mode)
    if mode == "replace":
        np.testing.assert_array_equal(merged_t.numpy(), np.asarray(merged_j))
    else:
        np.testing.assert_allclose(merged_t.numpy(), np.asarray(merged_j), **MEAN_TOL)
    y = rng.standard_normal(merged_t.shape).astype(np.float32)
    np.testing.assert_array_equal(
        ttome.local_unmerge_sequence(_t(y), infos_t).numpy(),
        np.asarray(jax.jit(lambda v: jtome.local_unmerge_sequence(v, infos_j))(y)))
    # one level's merge inverted alone
    y0 = rng.standard_normal((b, infos_t[0].n_total - infos_t[0].src_idx.shape[1], c))
    y0 = y0.astype(np.float32)
    np.testing.assert_array_equal(
        ttome.tome_unmerge(_t(y0), infos_t[0]).numpy(),
        np.asarray(jax.jit(lambda v: jtome.tome_unmerge(v, infos_j[0]))(y0)))


@pytest.mark.parametrize("mode", ["replace", "mean"])
@pytest.mark.parametrize("flip", [False, True])
def test_global_merge_and_unmerge_match(mode, flip):
    rng = np.random.default_rng(4 + flip)
    b, n, c = 2, 90, 16
    local = rng.standard_normal((b, n, c)).astype(np.float32)
    bank = rng.standard_normal((b, n, c)).astype(np.float32)
    merged_j, mi_j, _ = jax.jit(jtome.global_merge, static_argnums=(4, 6, 7))(
        jnp.asarray(local), jnp.asarray(bank), jnp.asarray(local), jnp.asarray(bank),
        0.5, jnp.bool_(flip), True, mode)
    mi_j = mi_j._replace(n_total=int(mi_j.n_total))
    merged_t, mi_t, _ = ttome.global_merge(_t(local), _t(bank), _t(local), _t(bank),
                                           0.5, flip, True, mode)
    if mode == "replace":
        np.testing.assert_array_equal(merged_t.numpy(), np.asarray(merged_j))
    else:
        np.testing.assert_allclose(merged_t.numpy(), np.asarray(merged_j), **MEAN_TOL)
    y = rng.standard_normal(merged_t.shape).astype(np.float32)
    np.testing.assert_array_equal(
        ttome.global_unmerge(_t(y), mi_t, flip, n).numpy(),
        np.asarray(jax.jit(lambda v: jtome.global_unmerge(v, mi_j, jnp.bool_(flip), n))(y)))


def test_tome_merge_refuses_an_unknown_mode():
    x = torch.zeros(1, 8, 4)
    mi = ttome.compute_split_merge(torch.randn(1, 8, 4), 4, 0.5)
    with pytest.raises(ValueError, match="mode"):
        ttome.tome_merge(x, mi, "sum")


# --- resample, chunk plans, config ---------------------------------------


@pytest.mark.parametrize("name", ["bilinear_sample", "bicubic_sample"])
def test_samplers_match(name):
    rng = np.random.default_rng(5)
    images = rng.standard_normal((2, 12, 16, 3)).astype(np.float32)
    # coordinates past every edge, so the zero padding is held too
    coords = np.stack([rng.uniform(-3, 19, (2, 9, 11)), rng.uniform(-3, 15, (2, 9, 11))],
                      axis=-1).astype(np.float32)
    out_t = getattr(tresample, name)(_t(images), _t(coords))
    out_j = getattr(jresample, name)(jnp.asarray(images), jnp.asarray(coords))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-5, rtol=0)


@pytest.mark.parametrize("chunk_ord,merge_global", [
    ("mix-4", True), ("rand", True), ("seq", True), ("mix-4", False)])
def test_make_step_plans_match(chunk_ord, merge_global):
    args = (6, 23, 4, 11, chunk_ord, merge_global)
    (idx_t, valid_t), (idx_j, valid_j) = (tchunks.make_step_plans(*args),
                                          jchunks.make_step_plans(*args))
    assert idx_t.shape == (6, tchunks.n_chunk_slots(23, 4), 4)
    np.testing.assert_array_equal(idx_t, idx_j)
    np.testing.assert_array_equal(valid_t, valid_j)


def test_iter_leaves_matches():
    path = REPO / "configs" / "tclight_default.yaml"
    cfg_t, cfg_j = tconfig.load_yaml(path), jconfig.load_yaml(path)
    leaves = list(tconfig.iter_leaves(cfg_t))
    assert leaves == list(jconfig.iter_leaves(cfg_j))
    assert ("generation.n_timesteps", cfg_t.generation.n_timesteps) in leaves
    nested = {"a": {"b": {"c": 1}, "d": [2]}, 3: "e"}
    assert list(tconfig.iter_leaves(nested)) == list(jconfig.iter_leaves(nested)) == [
        ("a.b.c", 1), ("a.d", [2]), ("3", "e")]


# --- video I/O ---------------------------------------------------------------


def _clip(n: int = 7, h: int = 32, w: int = 48) -> np.ndarray:
    rng = np.random.default_rng(6)
    base = rng.uniform(0.1, 0.9, (h, w, 3))
    return np.stack([np.roll(base, 3 * t, axis=1) for t in range(n)]).astype(np.float32)


@pytest.mark.parametrize("kind", ["float32", "uint8", "mixed"])
def test_save_video_stream_matches_jax(tmp_path, kind):
    frames = _clip()
    u8 = (frames * 255 + 0.5).astype(np.uint8)
    chunks = {"float32": [frames[:3], frames[3:]], "uint8": [u8[:2], u8[2:5], u8[5:]],
              "mixed": [u8[:3], frames[3:5], u8[5:]]}[kind]
    tvideo_io.save_video_stream(iter(chunks), tmp_path / "t.mp4", fps=8)
    jvideo_io.save_video_stream(iter(chunks), tmp_path / "j.mp4", fps=8)
    out_t = tvideo_io.load_video(tmp_path / "t.mp4")
    assert out_t.shape == frames.shape
    np.testing.assert_array_equal(out_t, jvideo_io.load_video(tmp_path / "j.mp4"))


def test_save_video_stream_raises_writer_and_producer_errors(tmp_path):
    def writer_fails():
        yield np.full((2, 16, 16, 3), "x")  # no clip for strings: the writer thread raises
        for _ in range(8):  # more than the queue holds: the producer must not block
            yield np.zeros((2, 16, 16, 3), np.uint8)

    with pytest.raises(TypeError):
        tvideo_io.save_video_stream(writer_fails(), tmp_path / "w.mp4", fps=8)

    def producer_fails():
        yield np.zeros((2, 16, 16, 3), np.uint8)
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="boom"):
        tvideo_io.save_video_stream(producer_fails(), tmp_path / "p.mp4", fps=8)


# --- logging helpers -----------------------------------------------------


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages: list[str] = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def test_timer_logs_as_context_and_as_decorator():
    logger = logging.getLogger("test_torch_exports.timer")
    logger.setLevel(logging.INFO)
    records = _Records()
    logger.addHandler(records)
    try:
        with tlogging.timer("block", logger) as t:
            sum(range(1000))
        assert t.elapsed is not None and t.elapsed >= 0

        @tlogging.timer("call", logger)
        def f(x):
            return 2 * x

        assert f(3) == 6
    finally:
        logger.removeHandler(records)
    assert [m.split(" took ")[0] for m in records.messages] == ["block", "call"]
    assert all(m.endswith(" s") for m in records.messages)


def test_device_memory_stats_and_cost_tracker_on_the_cpu():
    assert tlogging.device_memory_stats("cpu") == {}
    rec = tlogging.CostTracker(torch.device("cpu")).finish(4, 32, 48)
    assert rec["max_memory_allocated"] == 0.0 and rec["resolution"] == "48x32"
    if not torch.cuda.is_available():
        # the default device is the card: no quiet answer without one
        with pytest.raises(RuntimeError):
            tlogging.device_memory_stats()


def test_profile_trace_and_block_and_time(tmp_path):
    with tlogging.profile_trace(tmp_path, device="cpu") as prof:
        torch.randn(64, 64) @ torch.randn(64, 64)
    traces = list(tmp_path.glob("*.pt.trace.json"))
    assert len(traces) == 1
    assert json.loads(traces[0].read_text())["traceEvents"]
    assert any("mm" in e.key for e in prof.key_averages())

    timed = tlogging.block_and_time(lambda a: {"y": [a + 1, (a * 2,)], "n": 3})
    out, seconds = timed(torch.ones(3))
    assert seconds >= 0 and out["n"] == 3
    np.testing.assert_array_equal(out["y"][1][0].numpy(), [2.0, 2.0, 2.0])


def test_cuda_event_ms_times_only_on_a_card(monkeypatch):
    """The CUDA-event timer raises where there is no card (a device time
    comes only from one), and calls nothing before it does."""
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlogging.cuda_event_ms(lambda: calls.append(1), 5, 3)
    assert calls == []


def test_turns_legs_carry_this_checkouts_timer(tmp_path):
    """`python -m tclight_torch.turns` runs each leg as a program of its
    own with the other checkout first on sys.path: the program compiles,
    puts that checkout first, and defines this checkout's timer, which the
    other checkout may lack, before the leg that calls it; K1 is timed at
    every UNet shape."""
    from tclight_torch import turns

    shapes = [sh for sh in turns.SHAPES if sh[0] == "K1"]
    assert [sh[1] for sh in shapes] == ["L0", "L1", "L2", "yt-L0", "yt-L1", "dd", "t2w",
                                        "t2w-704"]
    code = turns.leg_code(tmp_path, shapes, tmp_path / "f.npy", tmp_path / "p.pt")
    tree = ast.parse(code)
    assert isinstance(tree.body[0], ast.ImportFrom) and tree.body[0].module == "__future__"
    assert f"sys.path.insert(0, {str(tmp_path)!r})" in code
    defs = [n.name for n in tree.body if isinstance(n, ast.FunctionDef)]
    assert defs == ["cuda_event_ms", "leg"]
    call = tree.body[-1].value
    assert call.func.id == "leg" and ast.literal_eval(call.args[0]) == shapes


# --- the host tools and the scripts -------------------------------------


def _reference_tool(name: str):
    spec = importlib.util.spec_from_file_location(f"ref_{name}", REPO / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_tools_round_trip_as_the_reference_tools(tmp_path):
    from tclight_torch.tools import img2video, video2img

    frames = _clip(n=6, h=40, w=56)
    tvideo_io.save_frames(frames, tmp_path / "src")
    crop = ["--crop", "0", "32", "8", "56"]
    assert img2video.main(["--input_dir", str(tmp_path / "src"), "--output",
                           str(tmp_path / "t.mp4"), "--fps", "8", *crop]) == 0
    assert _reference_tool("img2video").main(["--input_dir", str(tmp_path / "src"), "--output",
                                              str(tmp_path / "j.mp4"), "--fps", "8", *crop]) == 0
    mp4_t = tvideo_io.load_video(tmp_path / "t.mp4")
    assert mp4_t.shape == (6, 32, 48, 3)
    np.testing.assert_array_equal(mp4_t, tvideo_io.load_video(tmp_path / "j.mp4"))

    rng_args = ["--frame_range", "1", "6", "2"]
    assert video2img.main(["--input", str(tmp_path / "t.mp4"), "--output_dir",
                           str(tmp_path / "ft"), *rng_args]) == 0
    assert _reference_tool("video2img").main(["--input", str(tmp_path / "t.mp4"),
                                              "--output_dir", str(tmp_path / "fj"),
                                              *rng_args]) == 0
    names = sorted(p.name for p in (tmp_path / "ft").iterdir())
    assert names == ["00000.png", "00001.png", "00002.png"]
    assert names == sorted(p.name for p in (tmp_path / "fj").iterdir())
    np.testing.assert_array_equal(tvideo_io.load_video(tmp_path / "ft"),
                                  tvideo_io.load_video(tmp_path / "fj"))
    np.testing.assert_array_equal(tvideo_io.load_video(tmp_path / "ft"), mp4_t[1:6:2])


_STUB = """#!/usr/bin/env bash
echo "${CUDA_VISIBLE_DEVICES:-unset} $*" >> "$STUB_LOG"
[[ "$*" != *"%s"* ]]
"""


def _run_script(tmp_path, script: str, args: list[str], env: dict, fail: str = "@none@"):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir(exist_ok=True)
    (bin_dir / "python").write_text(_STUB % fail)
    (bin_dir / "nvidia-smi").write_text("#!/usr/bin/env bash\nprintf '0\\n1\\n'\n")
    for stub in bin_dir.iterdir():
        stub.chmod(0o755)
    log = tmp_path / "calls.log"
    log.unlink(missing_ok=True)
    env = {**{k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}, **env,
           "PATH": f"{bin_dir}{os.pathsep}{os.environ['PATH']}", "STUB_LOG": str(log)}
    proc = subprocess.run(["bash", str(REPO / "scripts" / script), *args], env=env,
                          capture_output=True, text=True, timeout=60)
    calls = log.read_text().splitlines() if log.exists() else []
    return proc, calls


def test_relight_script_runs_each_config_once_on_its_card(tmp_path):
    configs = sorted(p.relative_to(REPO).as_posix()
                     for p in (REPO / "configs" / "examples").glob("*.yaml"))
    # two cards from nvidia-smi: config i on card i % 2
    proc, calls = _run_script(tmp_path, "relight_torch.sh", ["-i", "clip.mp4"], {})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert sorted(calls) == sorted(
        f"{i % 2} -m tclight_torch.run --config {cfg} -i clip.mp4"
        for i, cfg in enumerate(configs))
    # the cards CUDA_VISIBLE_DEVICES names; a failed config fails the run,
    # the others still run
    proc, calls = _run_script(tmp_path, "relight_torch.sh", [],
                              {"CUDA_VISIBLE_DEVICES": "5"}, fail=configs[1])
    assert proc.returncode == 1
    assert calls == [f"5 -m tclight_torch.run --config {cfg}" for cfg in configs]
    assert f"FAILED: {configs[1]}" in proc.stdout


def test_eval_script_runs_the_port_then_the_averages(tmp_path):
    proc, calls = _run_script(tmp_path, "eval_torch.sh",
                              ["runs", "--flow_model", "farneback"], {})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert calls == [
        "unset -m tclight_torch.evaluate --output_dir runs --eval_cost --flow_model farneback",
        "unset tools/avg_metrics.py --output_dir runs"]


# --- the Generator's output stage ----------------------------------------


def test_generator_output_stage(tmp_path):
    from tclight_torch.config import ConfigDict
    from tclight_torch.data.dataparsers import VideoDataParser
    from tclight_torch.pipeline.generator import Generator
    from tclight_torch.pipeline.iclight import build_tiny_iclight

    size, n = 32, 4
    frames = _clip(n=n, h=size, w=size)
    tvideo_io.save_frames(frames, tmp_path / "vid")
    cfg = ConfigDict({
        "work_dir": str(tmp_path / "wd"),
        "data": {"scene_type": "video", "rgb_path": str(tmp_path / "vid"),
                 "height": size, "width": size, "fps": 8},
        "generation": {"n_timesteps": 1, "chunk_size": 4, "prompt": {"p": "warm light"},
                       "local_merge_ratio": 0.0, "global_merge_ratio": 0.0,
                       "save_frame": True},
        "post_opt": {"apply_opt": False}, "seed": 3})
    gen = Generator(build_tiny_iclight(num_inference_steps=1, device="cpu"), cfg,
                    data_parser=VideoDataParser(cfg.data), device="cpu")
    decoded = []
    decode = gen.decode_latents_batch
    gen.decode_latents_batch = lambda lat: decoded.append(decode(lat)) or decoded[-1]
    out = gen(None, str(tmp_path / "out"), list(range(n)))["p"]

    # the frames as decoded, untouched by the output stage, in both files
    np.testing.assert_array_equal(out, decoded[0].numpy())
    out_dir = next((tmp_path / "out").iterdir())
    tvideo_io.save_video(out, tmp_path / "out_ref.mp4", fps=8)
    tvideo_io.save_video(gen.data_parser.load_video(frame_ids=list(range(n))),
                         tmp_path / "gt_ref.mp4", fps=8)
    for name, ref in (("output.mp4", "out_ref.mp4"), ("output_gt.mp4", "gt_ref.mp4")):
        np.testing.assert_array_equal(tvideo_io.load_video(out_dir / name),
                                      tvideo_io.load_video(tmp_path / ref))
    u8 = (np.clip(out, 0, 1) * 255 + 0.5).astype(np.uint8)
    np.testing.assert_array_equal(tvideo_io.load_video(out_dir / "frames"),
                                  u8.astype(np.float32) / 255)
    # JAX's two output-stage times, also in the run's config
    st = gen.stage_times
    assert st["output_fetch"] >= 0 and st["output_save"] >= 0
    saved = yaml.safe_load((out_dir / "config.yaml").read_text())["stage_times"]
    assert saved["output_fetch"] == st["output_fetch"]
    assert saved["output_save"] == st["output_save"]


# --- the guard -----------------------------------------------------------

# Public top-level names of tclight_tpu that the port does not have, by
# module: each has a line in ROADMAP.md's "Not to port" list, which says why.
NOT_TO_PORT = {
    *{(m, "Dtype") for m in (
        "cosmos/dit.py", "models/ar_transformer.py", "models/briarmbg.py",
        "models/clip_text.py", "models/clip_vision.py", "models/controlnet.py",
        "models/dpt.py", "models/layers.py", "models/raft.py", "models/unet.py",
        "models/vae.py")},
    *(("utils/device.py", n) for n in (
        "set_compute_platform", "compute_platform", "use_pallas", "warm_transfer_path")),
    ("parallel/mesh.py", "replicate"), ("parallel/mesh.py", "data_sharding"),
    ("ops/banded_gather.py", "pack_table"),
    ("ops/banded_gather.py", "banded_gather_xla"),
    ("ops/banded_gather.py", "banded_gather_xla_multi"),
    ("ops/match_kernel.py", "online_argmax_scores_xla"),
    ("ops/warp_kernel.py", "window_warp_xla"), ("ops/warp_kernel.py", "window_warp_pallas"),
    ("native/__init__.py", "ensure_built"), ("native/__init__.py", "available"),
    ("cosmos/dit.py", "AdaLNModulation"),
    ("pipeline/single_image.py", "log"),
}


def _bound_names(path: Path, with_imports: bool) -> set[str]:
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif with_imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return {n for n in names if not n.startswith("_")}


def _roadmap_not_to_port() -> set[tuple[str, str]]:
    """(module, name) pairs of ROADMAP.md's "Not to port" list: on each
    item, before its " — ", the backticked `*.py` modules and names."""
    text = (REPO / "ROADMAP.md").read_text()
    section = text.split("#### Not to port", 1)[1].split("\n#", 1)[0]
    pairs = set()
    for item in section.split("\n- ")[1:]:
        head = item.split(" — ", 1)[0]
        ticks = head.split("`")[1::2]
        modules = [t for t in ticks if t.endswith(".py")]
        pairs |= {(m, n) for m in modules for n in ticks if not n.endswith(".py")}
    return pairs


def test_every_jax_export_has_a_counterpart_or_a_reason():
    jax_root, port_root = REPO / "tclight_tpu", REPO / "tclight_torch"
    missing = set()
    for path in sorted(jax_root.rglob("*.py")):
        rel = path.relative_to(jax_root).as_posix()
        port = port_root / rel
        assert port.is_file(), f"no port module for {rel}"
        missing |= {(rel, n) for n in
                    _bound_names(path, False) - _bound_names(port, True)}
    assert missing == NOT_TO_PORT, (
        f"without a counterpart or a reason: {sorted(missing - NOT_TO_PORT)}; "
        f"listed but now ported: {sorted(NOT_TO_PORT - missing)}")
    assert _roadmap_not_to_port() == NOT_TO_PORT
