"""Device time of a call without the host: CALLS calls captured in one CUDA
graph and replayed back to back between CUDA events, the median of
REPLAYS replays after a first one, divided by CALLS."""

from __future__ import annotations

import statistics
from typing import Callable, Optional

import torch

CALLS = 20
REPLAYS = 6


def graph_ms(fn: Callable[[], object], device: torch.device
             ) -> Optional[float]:
    """ms of one fn() on the card; None on the CPU (no device time)."""
    if device.type != "cuda":
        return None
    with torch.inference_mode():
        fn()
        torch.cuda.synchronize(device)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(CALLS):
                fn()
    times = []
    for _ in range(REPLAYS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / CALLS)
    del graph
    return statistics.median(times[1:])
