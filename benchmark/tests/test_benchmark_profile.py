"""The traced slice's reduction on made-up profiler events: busy time is
the union of device work inside the slice, idle gaps go to the innermost
host op of the loop thread, synchronisations and annotations are no
device work."""

from __future__ import annotations

import pytest
import torch

from harness import profile

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Ev:
    def __init__(self, name, device, start_us, end_us, thread=1,
                 annotation=False):
        self._n, self._d, self._s, self._e = name, device, start_us, end_us
        self._t, self._a = thread, annotation

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s * 1000

    def duration_ns(self):
        return (self._e - self._s) * 1000

    def start_thread_id(self):
        return self._t

    def is_user_annotation(self):
        return self._a


def test_reduce_busy_idle_and_gaps():
    events = [
        Ev("bench.slice", CPU, 100, 1100),
        Ev("bench.slice", CUDA, 100, 1100, annotation=True),
        Ev("step", CPU, 100, 1100),
        Ev("cudaGraphLaunch", CPU, 100, 150),
        Ev("cudaStreamSynchronize", CPU, 150, 700),
        Ev("to_host", CPU, 700, 1100),
        Ev("fused_sepconv_kernel<2>", CUDA, 50, 300),      # clipped to 100
        Ev("fused_sepconv_kernel<2>", CUDA, 250, 400),     # overlaps
        Ev("Memcpy DtoH", CUDA, 800, 850),
        Ev("Stream Sync", CUDA, 400, 700),
        Ev("worker decode", CPU, 300, 900, thread=2),
    ]
    t = profile.reduce(events)
    assert t.window_s == pytest.approx(1000e-6)
    assert t.busy_s == pytest.approx(350e-6)                # 100-400, 800-850
    assert t.kernel("fused_sepconv") == (pytest.approx(350e-6), 2)
    assert t.idle_by_host == {
        "cudaStreamSynchronize": pytest.approx(400e-6),     # 400-800
        "to_host": pytest.approx(250e-6)}                   # 850-1100
    b = t.breakdown()
    assert b["device_ops"][0][0] == "fused_sepconv_kernel<2>"
    assert [g[0] for g in b["idle_gaps"]] == ["cudaStreamSynchronize",
                                               "to_host"]
