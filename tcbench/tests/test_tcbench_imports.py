"""No module the harness or the reference loads is JAX's or the JAX
package's, compared by whole top-level name, and the reference loads
nothing of the program."""

from __future__ import annotations

import json
import subprocess
import sys

from tcbench import run

HARNESS = """
import json, sys
from tcbench import run
from tests_data import BENCH, DATA
r = run.run_cell("tiny-sample", 5, 0.3, True, BENCH, files=DATA, device="cpu")
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

REFERENCE = """
import json, sys
import tcbench.reference.unet, tcbench.reference.step, tcbench.reference.weights
import tcbench.reference.dpm, tcbench.reference.chunks, tcbench.reference.tome
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _top_level(code: str, tmp_path) -> set:
    (tmp_path / "tests_data.py").write_text(
        "from pathlib import Path\nfrom tcbench.tests.conftest import TINY_BENCH as BENCH\n"
        f"DATA = Path({str(run.TCBENCH / 'tests' / 'data')!r})\n")
    env = {"PYTHONPATH": f"{run.ROOT}:{tmp_path}", "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax(tmp_path):
    mods = _top_level(HARNESS, tmp_path)
    assert "tclight_torch" in mods and "tcbench" in mods
    assert not mods & set(run.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program(tmp_path):
    mods = _top_level(REFERENCE, tmp_path)
    assert not mods & (set(run.FORBIDDEN) | {"tclight_torch"})


def test_forbidden_names_are_compared_whole():
    assert run.FORBIDDEN == ("jax", "jaxlib", "flax", "tclight_tpu")
    # the port's name begins with the JAX package's and is not forbidden
    assert "tclight_torch".split(".")[0] not in run.FORBIDDEN
