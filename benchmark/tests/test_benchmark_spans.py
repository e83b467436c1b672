"""The readers of the program's own spans: on the CPU-cut cells the six
return None (no replay, no card) and never raise; on a made-up loop they
read the tracer's spans and counters, and nothing where the program's
tracer cannot record. The traced slice's idle attribution names a program
span where the loop thread was inside one."""

from __future__ import annotations

import types

import pytest
import torch

from conftest import ROOT, bench_json
from harness import profile, spans, spec
from test_benchmark_profile import CPU, CUDA, Ev

NEW = ("engine.replay_launch_ms.bs8", "engine.replay_launch_ms.bs1",
       "engine.host_ms.bs1", "postproc.smooth_device_ms.bs8",
       "postproc.peaks_device_ms.bs8", "postproc.group_device_ms.bs8")
WORKLOADS = [w["name"] for w in bench_json()["workloads"]]


def _reader(name):
    return spec.load_reader(spec.BENCH_DIR, name)


def test_the_new_metrics_are_declared():
    per_layer = {m["name"]: m for m in bench_json()["per_layer"]}
    for name in NEW:
        m = per_layer[name]
        assert m["source"] == "program_span" and m["unit"] == "ms"
        assert m["layer"] == name.split(".")[0]
        assert all(w in WORKLOADS for w in m["workloads"])


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cpu_cut_cells_read_none(run_tiny, workload):
    """On the CPU every call runs eagerly and there is no card: the new
    readers report nothing, and the traced run still ends correct."""
    cell = spec.load_cell(ROOT, workload)
    assert {m["name"] for m in cell.per_layer} & set(NEW)
    out = run_tiny(workload, trace=True)
    assert not set(out["metrics"]) & set(NEW), out["metrics"]
    assert out["correct"]


class _Loop:
    """A made-up driver whose step opens the spans a served call opens."""

    def __init__(self, eager=False):
        from openpose_plus_tpu_torch.utils.tracer import count, scope

        self.count, self.scope, self.eager = count, scope, eager

    def step(self):
        with self.scope("engine.infer", call=True):
            self.count("engine.calls")
            if self.eager:
                self.count("engine.eager_calls")
            with self.scope("engine.replay"):
                pass
        return 1


def _run(batch, eager=False):
    return types.SimpleNamespace(batch=batch, device=torch.device("cpu"),
                                 driver=_Loop(eager))


def test_host_readers_on_a_made_up_loop(monkeypatch):
    monkeypatch.setattr(spans, "SLICE_S", 0.05)
    monkeypatch.setattr(spans, "WARM_S", 0.01)
    run = _run(1)
    launch = _reader("engine.replay_launch_ms.bs1")(run)
    host = _reader("engine.host_ms.bs1")(run)
    assert 0 < launch < host
    assert spans.host_slice(run).counters["engine.calls"] > 1
    assert _reader("engine.replay_launch_ms.bs8")(run) is None
    assert _reader("engine.replay_launch_ms.bs8")(_run(8)) > 0
    eager = _run(1, eager=True)
    assert _reader("engine.host_ms.bs1")(eager) is None
    for name in NEW[3:]:                           # no card: no stages
        assert _reader(name)(_run(8)) is None


def test_readers_without_a_recorder(monkeypatch):
    """A program whose tracer cannot record (an older port's): None."""
    from openpose_plus_tpu_torch.utils import tracer

    monkeypatch.setattr(tracer, "GLOBAL_TRACER",
                        types.SimpleNamespace(scope=tracer.scope))
    for name in NEW:
        assert _reader(name)(_run(int(name[-1]))) is None


def test_idle_goes_to_the_program_span():
    """A gap while the loop thread is inside `engine.replay` (after its
    `cudaGraphLaunch` returned) is put down to that span, not to no host
    op; the span's device-side shadow is no device work."""
    events = [
        Ev("bench.slice", CPU, 100, 1100),
        Ev("engine.infer", CPU, 100, 600),
        Ev("engine.replay", CPU, 150, 400),
        Ev("cudaGraphLaunch", CPU, 150, 200),
        Ev("engine.replay", CUDA, 150, 400, annotation=True),
        Ev("fused_sepconv_kernel<2>", CUDA, 100, 250),
        Ev("fused_sepconv_kernel<2>", CUDA, 400, 600),
        Ev("resize", CPU, 600, 1000),
        Ev("cudaStreamSynchronize", CPU, 1000, 1100),
        Ev("decode_kernel", CUDA, 1000, 1100),
    ]
    t = profile.reduce(events)
    assert t.busy_s == pytest.approx(450e-6)
    assert t.idle_by_host == {"engine.replay": pytest.approx(150e-6),
                              "resize": pytest.approx(400e-6)}
    assert "engine.replay" not in t.kernels
