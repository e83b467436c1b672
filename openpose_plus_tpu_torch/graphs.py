"""CUDA-graph capture, the port's counterpart of `jax.jit`: a captured
program replays with one launch and no host work between its kernels.
Used by `Engine` (compile, flip-TTA, the scale search), the train step and
loaded export artifacts. Imports nothing of the model code, so a loaded
artifact captures without it."""

from __future__ import annotations

from typing import Any, Callable

import torch

from openpose_plus_tpu_torch.utils.tracer import GLOBAL_TRACER, count, scope

CAPTURE_WARMUP = 2               # eager calls before a CUDA-graph capture


def on_side_stream(fn: Callable[[], Any], device: torch.device) -> Any:
    """fn() eagerly on a side stream of `device` that first waits for the
    current stream's work, which then waits for it: a warm-up call before a
    capture, ordered with the calls around it."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        out = fn()
    torch.cuda.current_stream(device).wait_stream(side)
    return out


def capture_graph(step: Callable[[], Any], device: torch.device,
                  warmup: int = CAPTURE_WARMUP
                  ) -> tuple[torch.cuda.CUDAGraph, Any]:
    """`step()` captured in a CUDA graph on `device`, with a memory pool of
    its own: `warmup` eager calls on a side stream first (they build the
    kernels and fill every lazy cache, an int8 engine's packed weights
    among them; a caller that ran its own warm-ups passes 0); returns the
    graph and its own output, which each replay overwrites. The capture
    executes nothing. A capture that fails raises. Traced as the span
    `graphs.capture` and the counter `graphs.captures`; the tracer's device
    spans record nothing inside, so the graph carries no tracer events."""
    count("graphs.captures")
    with scope("graphs.capture"), GLOBAL_TRACER.no_device_spans():
        for _ in range(warmup):
            on_side_stream(step, device)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = step()
    return graph, out
