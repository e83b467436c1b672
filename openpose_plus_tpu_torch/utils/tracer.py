"""Hierarchical scope timing for the host pipeline, and device traces
(port of `openpose_plus_tpu/utils/tracer.py`).

Nested scopes accumulate wall time and call counts and print an indented
report (the original project's RAII tracer). Device-side profiling goes
through torch.profiler (`trace_device`, a Chrome trace); `timeit` times a
device function, waiting for the card before it reads the clock.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Iterator

import torch


@dataclass
class _Node:
    name: str
    total_s: float = 0.0
    calls: int = 0
    children: dict[str, "_Node"] = field(default_factory=dict)


class Tracer:
    """Accumulating nested scope timer (thread-local scope stack; the
    nodes are shared, so their updates hold a lock)."""

    def __init__(self) -> None:
        self._root = _Node("total")
        self._local = threading.local()
        self._lock = threading.Lock()

    def _stack(self) -> list[_Node]:
        if not hasattr(self._local, "stack"):
            self._local.stack = [self._root]
        return self._local.stack

    @contextlib.contextmanager
    def scope(self, name: str) -> Iterator[None]:
        stack = self._stack()
        with self._lock:
            node = stack[-1].children.setdefault(name, _Node(name))
        stack.append(node)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            elapsed = time.perf_counter() - t0
            with self._lock:
                node.total_s += elapsed
                node.calls += 1
            stack.pop()

    def report(self) -> str:
        """Indented per-scope cumulative time/count table."""
        lines = ["scope                                    calls      "
                 "total s      mean ms"]

        def walk(node: _Node, depth: int) -> None:
            for child in node.children.values():
                mean_ms = (child.total_s / child.calls * 1e3
                           if child.calls else 0)
                lines.append(
                    f"{'  ' * depth}{child.name:<{40 - 2 * depth}}"
                    f"{child.calls:>6}{child.total_s:>13.3f}{mean_ms:>13.2f}")
                walk(child, depth + 1)

        walk(self._root, 0)
        return "\n".join(lines)

    def reset(self) -> None:
        self._root = _Node("total")
        self._local = threading.local()


GLOBAL_TRACER = Tracer()
scope = GLOBAL_TRACER.scope

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace_device(log_dir: str) -> Iterator[torch.profiler.profile]:
    """torch.profiler around a block (host ops, and the card's kernels
    where there is one), written to `log_dir/trace.json` as a Chrome trace
    (chrome://tracing, Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def _tensors(out) -> Iterator[torch.Tensor]:
    """The tensors of a result: a tensor, a dataclass (HumanBatch), or a
    tuple, list or dict of them."""
    if isinstance(out, torch.Tensor):
        yield out
    elif dataclasses.is_dataclass(out):
        for f in dataclasses.fields(out):
            yield from _tensors(getattr(out, f.name))
    elif isinstance(out, (tuple, list)):
        for x in out:
            yield from _tensors(x)
    elif isinstance(out, dict):
        for x in out.values():
            yield from _tensors(x)


def block(out) -> None:
    """Wait until the card has computed `out` (a no-op for host results)."""
    devices = {t.device for t in _tensors(out) if t.device.type == "cuda"}
    for dev in devices:
        torch.cuda.synchronize(dev)


def timeit(fn, *args, warmup: int = 2, iters: int = 10,
           block=block) -> float:
    """Mean seconds/call of a device function (after warm-up, waiting for
    the last result before reading the clock)."""
    for _ in range(warmup):
        block(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    block(out)
    return (time.perf_counter() - t0) / iters
