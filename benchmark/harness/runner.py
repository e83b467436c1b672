"""One run of one cell: set-up, the measured window, the traced slice and
the per-layer readers (with --trace 1), then the check against the
reference, which runs once the program's state is freed."""

from __future__ import annotations

import dataclasses
import subprocess
import time
from typing import Optional

import torch

from harness import (check, cost, device_time, drivers, families, profile,
                     weights)


@dataclasses.dataclass
class Run:
    """What a run measured, for the metric readers."""

    cell: object
    seed: int
    device: torch.device
    engine: object = None
    driver: object = None
    shapes: dict = None
    setup_s: float = 0.0
    window_s: float = 0.0
    images: int = 0
    calls: int = 0
    latencies: list = None        # seconds of each call in the window
    trace: Optional[profile.Trace] = None
    memory_peak_bytes: int = 0
    phases: dict = dataclasses.field(default_factory=dict)   # s since t0

    def mark(self, phase: str, t0: float) -> None:
        self.phases[phase] = time.perf_counter() - t0

    @property
    def model(self) -> dict:
        return self.cell.config["model"]

    @property
    def batch(self) -> int:
        return self.cell.traffic["batch"]

    def forward_device_ms(self) -> Optional[float]:
        x = self.driver.model_batch()
        return device_time.graph_ms(lambda: self.engine.forward(x),
                                    self.device)

    def decode_device_ms(self) -> Optional[float]:
        decode = families.of(self.model).decode_call(self)
        return device_time.graph_ms(decode, self.device)

    def flops_per_image(self) -> float:
        return cost.cnn_flops(self.model, self.shapes, 1)


def postproc(cell) -> dict:
    """The decode's parameters: the configuration's, with the traffic's
    overrides (an accuracy-first mix asks for another decode)."""
    return {**cell.config["postproc"], **cell.traffic.get("postproc", {})}


def program_config(cell, compute_dtype: Optional[str] = None):
    """The program's Config for the cell."""
    from openpose_plus_tpu_torch.config import default_config

    model = dict(cell.config["model"])
    if compute_dtype is not None:
        model["compute_dtype"] = compute_dtype
    cfg = default_config(model["name"])
    return cfg.replace(
        model=dataclasses.replace(cfg.model, **model),
        postproc=dataclasses.replace(cfg.postproc, **postproc(cell)))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def power_limit() -> Optional[str]:
    """The card's power limit as nvidia-smi reads it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


def run(cell, seed: int, seconds: float, trace: bool, t0: float,
        device: str = "cuda", compute_dtype: Optional[str] = None) -> dict:
    """The cell once; returns the result line's object (its `compared`
    key last) and, under "_compared", the compared (name, value, limit)
    rows. `compute_dtype` serves the configuration in another precision
    (the control)."""
    from openpose_plus_tpu_torch.engine import Engine
    from openpose_plus_tpu_torch.models import get_model

    dev = torch.device(device)
    r = Run(cell, seed, dev)
    cfg = program_config(cell, compute_dtype)
    with torch.device("meta"):
        r.shapes = {k: tuple(v.shape)
                    for k, v in get_model(cfg.model).state_dict().items()}
    w = cell.config["weights"]
    r.mark("imports", t0)
    sd = weights.make(r.shapes, seed, dev, w["bias_std"], r.model)
    r.mark("weights", t0)
    r.driver = drivers.DRIVERS[cell.traffic["driver"]](r)
    first = r.driver.setup()
    r.mark("inputs", t0)
    heads = time.perf_counter()
    weights.scale_heads(sd, r.model, torch.from_numpy(first).to(dev), w)
    _sync(dev)
    reference_s = time.perf_counter() - heads
    if dev.type == "cuda":            # the reference's forward sets no peak
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    r.mark("heads", t0)
    r.engine = Engine(cfg, params=sd, device=dev)
    r.mark("engine", t0)
    r.driver.build()
    r.mark("compile", t0)
    r.driver.warm()
    _sync(dev)
    r.setup_s = time.perf_counter() - t0 - reference_s
    r.mark("warm", t0)

    n0 = len(r.driver.latencies)
    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
        r.images += r.driver.step()
        r.calls += 1
    _sync(dev)
    r.window_s = time.perf_counter() - start
    r.latencies = r.driver.latencies[n0:]
    if dev.type == "cuda":
        r.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)

    metrics, out = {}, {}
    if trace:
        if dev.type == "cuda":
            r.trace = profile.trace_slice(r.driver.step, dev)
        entries = cell.per_layer
    else:
        entries = cell.end_to_end
    for m in entries:
        value = cell.reader(m["name"])(r)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    answers, planes, layout = r.driver.answers()
    repeats = r.driver.repeat_mismatch
    r.driver = r.engine = None
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    pp = postproc(cell)
    values, ref = check.evaluate(cell.config, sd, answers, planes, pp, dev,
                                 repeats, layout)
    correct, rows = check.judge(values, cell.limits)

    out.update(correct=bool(correct), attempted=r.images, failed=0,
               metrics=metrics)
    out["device"] = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                     "kind": (torch.cuda.get_device_name(dev)
                              if dev.type == "cuda" else "cpu"),
                     "count": 1,
                     "memory_peak_bytes": r.memory_peak_bytes,
                     "power_limit": (power_limit() if dev.type == "cuda"
                                     else None)}
    if r.trace is not None:
        out["device"].update(busy_s=r.trace.busy_s,
                             window_s=r.trace.window_s)
        out["breakdown"] = r.trace.breakdown()
    out["compared"] = {name: {"value": v, "limit": lim}
                       for name, v, lim in rows}
    r.mark("check", t0)
    out["_phases"] = r.phases
    out["_values"] = values
    out["_rows"] = rows
    out["_sample"] = (answers, ref, pp, repeats, layout)
    return out
