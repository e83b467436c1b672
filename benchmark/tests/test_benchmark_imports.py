"""Nothing of the benchmark imports the JAX stack or the JAX package, the
reference imports nothing of the program either, and a run's process
holds neither once it ends; names are compared whole at the top level
(the program's name begins with the JAX package's)."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT

JAX_SIDE = {"jax", "jaxlib", "flax", "openpose_plus_tpu"}
PROGRAM = "openpose_plus_tpu_torch"


def _imports(path: str) -> set:
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            names.add(node.module.split(".")[0])
    return names


def _sources(sub: str = "") -> list:
    out = []
    for d, _, files in os.walk(os.path.join(BENCH, sub)):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return out


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(
    p, BENCH))
def test_no_jax_side_import(path):
    assert not _imports(path) & JAX_SIDE


def test_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        names = _imports(path)
        assert PROGRAM not in names and not names & JAX_SIDE, path
        assert names <= {"__future__", "concurrent", "contextlib",
                         "dataclasses", "importlib", "json", "math", "os",
                         "types", "numpy", "torch", "cv2", "reference"}, path


def test_forbidden_modules_compares_whole_names():
    import run

    assert run.forbidden_modules(["openpose_plus_tpu_torch",
                                  "openpose_plus_tpu_torch.engine",
                                  "jaxtyping", "flaxen", "numpy"]) == []
    assert run.forbidden_modules(["openpose_plus_tpu.engine", "jax._src",
                                  "flax", "jaxlib.xla_client"]) == [
        "flax", "jax", "jaxlib", "openpose_plus_tpu"]


def test_a_run_loads_no_jax_side_module(tiny_root):
    """A whole cut-down run in a fresh process, then its sys.modules."""
    code = f"""
import sys, time
sys.path[:0] = [{BENCH!r}, {ROOT!r}]
import torch
torch.set_num_threads(2)
from harness import runner, spec
import run
cell = spec.load_cell({tiny_root[0]!r}, "mobilenet_thin.live_720p_bs1",
                      {tiny_root[1]!r})
runner.run(cell, 5, 0.3, False, time.perf_counter(), device="cpu")
print("LOADED", run.forbidden_modules(), PROGRAM_SEEN := any(
    m.split(".")[0] == "openpose_plus_tpu_torch" for m in sys.modules))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "LOADED [] True"
