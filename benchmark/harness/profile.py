"""A traced slice of a cell's own loop: `torch.profiler` with CUDA activity
over SLICE_S seconds of steady calls (after WARM_S under the profiler,
which starts slowly), reduced to what the per-layer readers and the
breakdown need: the seconds in which some operation ran on the device,
the slice's length, the device time and launches of kernels by name, and
the idle gaps by what the host's loop thread was doing."""

from __future__ import annotations

import bisect
import collections
import dataclasses
import time
from typing import Callable

import torch

SLICE_S = 1.0
WARM_S = 0.3


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: dict                     # name -> [seconds, launches]
    idle_by_host: dict                # host activity -> idle seconds

    def kernel(self, substring: str) -> tuple[float, int]:
        """(seconds, launches) of the kernels whose name holds it."""
        hits = [v for k, v in self.kernels.items() if substring in k]
        return sum(v[0] for v in hits), sum(v[1] for v in hits)

    def breakdown(self) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:10]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k[:160], v[0]] for k, v in ops],
                "idle_gaps": [[k[:160], v] for k, v in gaps]}


def _merge(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _host_at(host: list, starts: list, t: int) -> str:
    """The innermost host op on the loop thread at time t: of the ops
    that cover t, the one that started last (ops nest)."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 256, -1), -1):
        if host[j][1] > t:
            return host[j][2]
    return "no host op"


def _span(e) -> tuple[int, int]:
    """(start, end) of a profiler event in ns."""
    return e.start_ns(), e.start_ns() + e.duration_ns()


def _device_work(e) -> bool:
    """A kernel, copy or memset on the device: not a synchronisation, not
    the device-side shadow of a host annotation."""
    name = e.name()
    return (e.device_type() == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", lambda: False)()
            and not name.startswith("bench.") and not name.endswith(" Sync"))


def trace_slice(step: Callable[[], None], device: torch.device) -> Trace:
    """Run `step` in a loop under the profiler and reduce the slice."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < WARM_S:
            step()
        torch.cuda.synchronize(device)
        with record_function("bench.slice"):
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < SLICE_S:
                step()
            torch.cuda.synchronize(device)
    return reduce(prof.profiler.kineto_results.events())


def reduce(events: list) -> Trace:
    """The slice marked "bench.slice" of a profile's events."""
    mark = next(e for e in events if e.name() == "bench.slice"
                and e.device_type() == torch.autograd.DeviceType.CPU)
    lo, hi = _span(mark)
    loop_thread = mark.start_thread_id()
    kernels: dict = collections.defaultdict(lambda: [0.0, 0])
    busy, host = [], []
    for e in events:
        start, end = _span(e)
        s, t = max(start, lo), min(end, hi)
        if t <= s:
            continue
        if _device_work(e):
            busy.append((s, t))
            kernels[e.name()][0] += (t - s) * 1e-9
            kernels[e.name()][1] += 1
        elif (e.device_type() == torch.autograd.DeviceType.CPU
              and e.start_thread_id() == loop_thread
              and e.name() != "bench.slice"):
            host.append((start, end, e.name()))
    merged = _merge(busy)
    busy_s = sum(e - s for s, e in merged) * 1e-9
    host.sort()
    starts = [h[0] for h in host]
    idle: dict = collections.defaultdict(float)
    edges = [lo] + [x for iv in merged for x in iv] + [hi]
    for s, e in zip(edges[::2], edges[1::2]):
        if e > s:
            idle[_host_at(host, starts, (s + e) // 2)] += (e - s) * 1e-9
    return Trace((hi - lo) * 1e-9, busy_s, dict(kernels), dict(idle))
