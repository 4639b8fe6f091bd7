"""The harness end to end on a tiny cell on the CPU: a sound run comes out
correct, and a run whose timed path is broken underneath comes out not
correct, once for each fault a sampling cell can have. The exchange
between cards is not among them: every cell runs on one card."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from tcbench import run

from .conftest import DATA, load


def test_a_sound_run_is_correct(tiny_run):
    r = tiny_run()
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["metrics"]) == {"sampling_s_per_frame", "setup_s", "peak_device_gib"}
    assert list(r)[-1] == "checks"
    gap = r["checks"]["update_gap"]
    assert gap["value"] < 1e-5 < gap["limit"]  # float32 on both sides here


def test_the_yt_pass_is_checked_too(tiny_run):
    r = tiny_run("tiny-yt-sample")
    assert r["correct"] and r["checks"]["update_gap"]["value"] < 1e-5


def test_a_traced_run_reads_per_layer_metrics(tiny_run):
    r = tiny_run(trace=True, seconds=0.5)
    assert r["correct"] and r["attempted"] >= 1 + run.TRACE_STEPS
    assert set(r["metrics"]) <= {"step_mfu.sampling", "device_idle_share.sampling"}
    assert r["device"]["window_s"] > 0 and "breakdown" in r


def _unchanged_state(monkeypatch):
    from tclight_torch.diffusion.schedulers import DPMSolverMultistepScheduler

    orig = DPMSolverMultistepScheduler.step

    def step(self, state, eps, sample, noise=None):
        return orig(self, state, eps, sample, noise)[0], sample
    monkeypatch.setattr(DPMSolverMultistepScheduler, "step", step)


def _half_batch(monkeypatch):
    """Each chunk's UNet runs on its first half of frames; the rest take
    the mean of their predictions."""
    from tclight_torch.pipeline.generator import Generator

    orig = Generator._pred_chunk

    def pred(self, models, x_c, cc_c, embeds, t, *rest):
        h = x_c.shape[0] // 2
        eps, banks = orig(self, models, x_c, cc_c, embeds, t, *rest)
        eps = eps.clone()
        eps[h:] = eps[:h].mean(0, keepdim=True)
        return eps, banks
    monkeypatch.setattr(Generator, "_pred_chunk", pred)


def _altered_answer(monkeypatch):
    """One frame's noise prediction altered where the step produces it."""
    from tclight_torch.pipeline.generator import Generator

    orig = Generator._run_plan

    def run_plan(self, x, plan, randfs, flips, pred):
        out = orig(self, x, plan, randfs, flips, pred)
        out[1] *= 1.1
        return out
    monkeypatch.setattr(Generator, "_run_plan", run_plan)


@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch, _altered_answer],
                         ids=["unchanged_state", "half_batch", "altered_answer"])
def test_a_broken_timed_path_is_not_correct(tiny_run, monkeypatch, fault):
    fault(monkeypatch)
    r = tiny_run()
    assert not r["correct"]
    gap = r["checks"]["update_gap"]
    assert gap["value"] > 10 * gap["limit"]


def test_the_control_is_not_correct(tiny_run):
    """The reference with every product's operands in fp8, put in the
    program's place at the steps checked."""
    r = tiny_run(variant="fp8")
    assert not r["correct"]
    assert r["checks"]["update_gap"]["value"] > 10 * r["checks"]["update_gap"]["limit"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["default-sample-30f", "navsim-sample-30f"])
def test_the_control_fails_at_the_cells_size(workload):
    """On the card: the fp8 control of each cell, three seeds, at the
    cell's own size, each run not correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "-m", "tcbench.calibrate", "--workload", workload,
                          "--seconds", "4", "--variant", "fp8", "--seeds", "1", "2", "3"],
                         cwd=run.ROOT, capture_output=True, text=True, timeout=1500)
    assert out.returncode == 0, out.stderr[-4000:]
    rows = [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]
    assert len(rows) == 3 and not any(r["correct"] for r in rows)


def test_run_exits_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "tcbench.run", "--workload", "default-sample-30f",
                          "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                         cwd=run.ROOT, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0 and "{" not in out.stdout
    assert "needs 1 CUDA card" in out.stderr


def test_tiny_data_keeps_the_cells_settings():
    for name in ("tiny", "tiny-yt"):
        tiny = load(DATA / "configs" / f"{name}.json")["settings"]
        real = load(run.TCBENCH / "configs" / {"tiny": "iclight-sd15-default.json",
                                               "tiny-yt": "iclight-sd15-navsim.json"}[name])
        assert tiny == real["settings"]
