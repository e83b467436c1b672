"""The program's own spans and counters (the port's `utils.tracer`) for the
per-layer readers:

  host_slice      SLICE_S seconds of the cell's own loop recorded by the
                  program's tracer, after WARM_S of warm-up, without the
                  profiler: the Recording (spans and counters)
  decode_stages   device ms of each traced stage of the cell's decode: the
                  program's decode (its family's `decode_call`) on the
                  forward's maps of one of the cell's inputs, CALLS
                  decodes captured in one CUDA graph while the tracer
                  records, the median of REPLAYS replays after a first
                  one, per decode

Each is computed once and kept on the run. Each is None where the program
has no recorder (a port whose tracer cannot record); the stages also off
the card. A port without the stage spans gives no stages."""

from __future__ import annotations

import statistics
import time
from typing import Optional

import torch

from harness import families
from harness.device_time import CALLS, REPLAYS

SLICE_S = 1.0
WARM_S = 0.2


def _tracer():
    """The program's tracer, or None where it cannot record."""
    from openpose_plus_tpu_torch.utils import tracer

    t = getattr(tracer, "GLOBAL_TRACER", None)
    return t if hasattr(t, "recording") else None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def host_slice(run):
    if not hasattr(run, "_span_slice"):
        run._span_slice = _host_slice(run)
    return run._span_slice


def _host_slice(run):
    tracer = _tracer()
    if tracer is None:
        return None
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < WARM_S:
        run.driver.step()
    _sync(run.device)
    with tracer.recording() as rec:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < SLICE_S:
            run.driver.step()
        _sync(run.device)
    return rec


def decode_stages(run) -> Optional[dict]:
    if not hasattr(run, "_span_stages"):
        run._span_stages = _decode_stages(run)
    return run._span_stages


def _decode_stages(run) -> Optional[dict]:
    tracer = _tracer()
    if tracer is None or run.device.type != "cuda":
        return None
    decode = families.of(run.model).decode_call(run)
    with torch.inference_mode():
        decode()
        torch.cuda.synchronize(run.device)
        graph = torch.cuda.CUDAGraph()
        with tracer.recording() as rec, torch.cuda.graph(graph):
            for _ in range(CALLS):
                decode()
    per: dict = {}
    for _ in range(REPLAYS):
        graph.replay()
        torch.cuda.synchronize(run.device)
        for name, ms in rec.device_ms().items():
            per.setdefault(name, []).append(sum(ms) / CALLS)
    del graph
    return {name: statistics.median(v[1:]) for name, v in per.items()}
