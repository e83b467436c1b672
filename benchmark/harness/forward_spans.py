"""Device ms of each traced stage of the program's forward, for the
per-layer readers of a network's own spans (BODY_25's `models.front`,
`models.paf_stages`, `models.conf_stages`): the program's forward
(`Engine.forward`) of one of the cell's inputs, CALLS forwards captured in
one CUDA graph while the program's tracer records, the median of REPLAYS
replays after a first one, per forward, as `spans.decode_stages` times the
decode's stages.

Computed once and kept on the run. None where the program has no recorder,
and off the card; a network without such spans gives none of them, and a
reader then reads None."""

from __future__ import annotations

import statistics
from typing import Optional

import torch

from harness import spans
from harness.device_time import CALLS, REPLAYS


def forward_stages(run) -> Optional[dict]:
    if not hasattr(run, "_forward_stages"):
        run._forward_stages = _forward_stages(run)
    return run._forward_stages


def _forward_stages(run) -> Optional[dict]:
    tracer = spans._tracer()
    if tracer is None or run.device.type != "cuda":
        return None
    x = run.driver.model_batch()
    with torch.inference_mode():
        run.engine.forward(x)
        torch.cuda.synchronize(run.device)
        graph = torch.cuda.CUDAGraph()
        with tracer.recording() as rec, torch.cuda.graph(graph):
            for _ in range(CALLS):
                run.engine.forward(x)
    per: dict = {}
    for _ in range(REPLAYS):
        graph.replay()
        torch.cuda.synchronize(run.device)
        for name, ms in rec.device_ms().items():
            per.setdefault(name, []).append(sum(ms) / CALLS)
    del graph
    return {name: statistics.median(v[1:]) for name, v in per.items()}
