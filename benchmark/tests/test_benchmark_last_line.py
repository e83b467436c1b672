"""The result line has the contract's keys and no others (with the
compared numbers last), standard error ends with the compared numbers,
and a machine without the card gets no result."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT

KEYS = ["correct", "attempted", "failed", "metrics", "device", "compared"]


@pytest.mark.parametrize("trace", [False, True])
def test_last_line_keys(run_tiny, capsys, trace):
    import run

    run.emit(run_tiny("vgg19.batch_bs8", trace=trace))
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line) == KEYS          # breakdown only from a card's trace
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert line["correct"] is True and line["attempted"] > 0
    names = set(line["metrics"])
    if trace:
        assert names <= {"models.forward_device_ms.bs8",
                         "postproc.decode_device_ms.bs8", "mfu.serve",
                         "device.idle_share.bs8"}
    else:
        assert names == {"images_per_s", "setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    tail = err.strip().splitlines()[-len(line["compared"]):]
    assert [t.split()[1] for t in tail] == list(line["compared"])
    assert all(t.startswith("compared ") and " limit " in t for t in tail)


def test_live_cell_reports_its_tail(run_tiny):
    out = run_tiny("mobilenet_thin.live_720p_bs1")
    assert set(out["metrics"]) == {"call_mean_ms", "setup_s"}


def test_no_card_no_result():
    if shutil.which("nvidia-smi") or os.environ.get("CUDA_VISIBLE_DEVICES"):
        pytest.skip("a card may be present: the guard only fails without")
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "vgg19.batch_bs8", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True,
                         cwd=ROOT, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "H100" in out.stderr


def test_benchmark_files_alone_no_result(tmp_path):
    """A checkout holding only BENCHMARK.json and the benchmark's files
    (no program) prints no result."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "vgg19.batch_bs8", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True,
                         cwd=tmp_path, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "openpose_plus_tpu_torch" in out.stderr
