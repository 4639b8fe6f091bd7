"""The port stands alone: importing every module of tclight_torch (the
post-optimization's and the checkpoint loaders' included) loads neither
JAX, optax nor the JAX package, nor `safetensors` (which the card's
machine lacks: the port reads the files itself) or `transformers` (only a
tokenizer directory needs it), and its entry points refuse to run on the
CPU unless asked to."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent

_IMPORT_ALL = """
import importlib, pkgutil, sys
import tclight_torch
names = [m.name for m in pkgutil.walk_packages(tclight_torch.__path__, "tclight_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "tclight_tpu"))
print(len(names), "modules")
assert not bad, bad
# the post-optimization slice's modules are among those imported
slice2 = {"tclight_torch.ops." + m for m in (
    "color", "schedules", "resample", "warp_kernel", "flow", "banded_gather", "losses")}
slice2 |= {"tclight_torch.native", "tclight_torch.data.flow_backends",
           "tclight_torch.data.dataparsers", "tclight_torch.pipeline.postopt"}
assert slice2 <= set(names), sorted(slice2 - set(names))
# the checkpoint loaders' modules, and the packages they must not need
loaders = {"tclight_torch.models.convert", "tclight_torch.pipeline.iclight"}
assert loaders <= set(names), sorted(loaders - set(names))
extra = sorted(m for m in sys.modules if m.split(".")[0] in ("safetensors", "transformers"))
assert not extra, extra
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[0]) >= 31


def _require_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")


def test_entry_points_default_to_cuda_and_raise_without_it():
    _require_no_cuda()
    from tclight_torch.config import ConfigDict
    from tclight_torch.pipeline.generator import Generator
    from tclight_torch.pipeline.iclight import (build_full_width_random,
                                               build_tiny_iclight, load_iclight)
    from tclight_torch.utils.device import resolve_device

    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        build_tiny_iclight()
    with pytest.raises(RuntimeError, match="CUDA"):
        build_full_width_random()
    with pytest.raises(RuntimeError, match="CUDA"):
        load_iclight(REPO / "no_such_model_dir")
    models = build_tiny_iclight(device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        Generator(models, ConfigDict({"post_opt": {"apply_opt": False}}))


def test_cli_defaults_to_cuda_and_raises_without_it(monkeypatch):
    _require_no_cuda()
    from tclight_torch.run import main

    monkeypatch.chdir(REPO)
    monkeypatch.setenv("TCLIGHT_TINY", "1")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--config", "configs/tclight_default.yaml", "-i", "unused.mp4",
              "-p", "x", "post_opt.apply_opt=false", "work_dir=workdir/unused"])
