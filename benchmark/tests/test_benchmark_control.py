"""The control: the program's own int8 path in place of the bf16 one it is
configured with, served through the same run. It has to read worse than
the program, and on the card, at the cells' own sizes, come out not
correct where the program comes out correct."""

from __future__ import annotations

import time

import pytest
import torch

from conftest import ROOT, bench_json

WORKLOADS = [w["name"] for w in bench_json()["workloads"]]


@pytest.mark.parametrize("workload", ["vgg19.batch_bs8",
                                      "mobilenet_thin.live_720p_bs1"])
def test_control_reads_worse_on_the_cpu(run_tiny, workload):
    program = run_tiny(workload)["_values"]
    control = run_tiny(workload, compute_dtype="int8")["_values"]
    assert control["peak_error_bf16_units"] > 2 * program["peak_error_bf16_units"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_not_correct_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the cells' own sizes")
    from harness import runner, spec

    cell = spec.load_cell(ROOT, workload)
    seed = 2**31 + 99
    program = runner.run(cell, seed, 2.0, False, time.perf_counter())
    control = runner.run(cell, seed, 2.0, False, time.perf_counter(),
                         compute_dtype="int8")
    assert program["correct"], program["_values"]
    assert not control["correct"], control["_values"]
