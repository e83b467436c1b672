"""CPU tests of the benchmark. A test that needs the card is marked `cuda`
and decides inside itself whether there is one.

`tiny_root` copies the benchmark's data files into a temporary checkout
with every cell cut to a size a CPU test holds (96x112 inputs, batches of
two, a handful of inputs; what else its network file names as a CPU cut,
`CPU_CUT`: two stages of VGG19's and MobileNet-thin's six, none of
BODY_25's, which takes no other count) and limits for that size.
There sound runs on seeds 5-8 read 0.59-1.0 bf16 units at the keypoints
(the int8 control 2.4-19), lose 0-0.08 of the reference's steady people
(a person of each image left out: 0.11-0.27) and serve 0-0.04 of their
keypoints off every reference peak. FAULT_SEED gives every cut cell
images with several reference people."""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest
import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [p for p in (BENCH, ROOT) if p not in sys.path]
torch.set_num_threads(2)

from reference import models  # noqa: E402

TINY_MODEL = {"hin": 96, "win": 112}
TINY_TRAFFIC = {"height": 120, "width": 160, "batches": 3,
                "check_batches": 2, "frames": 3}
TINY_LIMITS = {"peak_error_bf16_units": 2.0, "steady_people_lost": 0.1,
               "off_peak_share": 0.06, "invariant_breaks": 0,
               "repeat_mismatch": 0, "layout_mismatch": 0}
BIG_SEED = 2**31 + 12345
FAULT_SEED = 5


def bench_json() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def make_tiny_root(path: str) -> tuple[str, str]:
    """(root, benchmark dir) of a cut-down copy of the benchmark."""
    bench = bench_json()
    bdir = os.path.join(path, "benchmark")
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(os.path.join(BENCH, sub), os.path.join(bdir, sub),
                        ignore=shutil.ignore_patterns("__pycache__"))
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        cfg["model"].update(TINY_MODEL)
        cfg["model"].update(getattr(models.network(cfg["model"]["name"]),
                                    "CPU_CUT", {}))
        with open(os.path.join(path, c["file"]), "w") as f:
            json.dump(cfg, f)
    for name in os.listdir(os.path.join(bdir, "traffic")):
        p = os.path.join(bdir, "traffic", name)
        with open(p) as f:
            t = json.load(f)
        t.update({k: v for k, v in TINY_TRAFFIC.items() if k in t})
        t["batch"] = min(t["batch"], 2)
        with open(p, "w") as f:
            json.dump(t, f)
    for w in bench["workloads"]:
        with open(os.path.join(bdir, "limits", f"{w['name']}.json"),
                  "w") as f:
            json.dump({k: {"limit": v} for k, v in TINY_LIMITS.items()}, f)
    with open(os.path.join(path, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return path, bdir


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny_root(str(tmp_path_factory.mktemp("tiny")))


@pytest.fixture(scope="session")
def workloads():
    return [w["name"] for w in bench_json()["workloads"]]


@pytest.fixture(scope="session")
def run_tiny(tiny_root):
    """run_tiny(workload, seed=FAULT_SEED, trace=False, compute_dtype=None):
    one run of a cut-down cell on the CPU, past the look for a card."""
    import time

    from harness import runner, spec

    def run(workload: str, seed: int = FAULT_SEED, trace: bool = False,
            compute_dtype=None) -> dict:
        cell = spec.load_cell(tiny_root[0], workload, tiny_root[1])
        return runner.run(cell, seed, 0.5, trace, time.perf_counter(),
                          device="cpu", compute_dtype=compute_dtype)

    return run
