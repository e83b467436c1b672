"""Spans and counters at the port's layer boundaries, and device timing
(port of `openpose_plus_tpu/utils/tracer.py`).

The tracer is off by default: `scope(name)` then returns one shared null
context and `count(name)` returns at once, with no lock and no clock read.
It records while a `recording()` block is open:

    with GLOBAL_TRACER.recording() as rec:
        engine.infer(images)
    print(rec.report())

Each scope appends a span (name, start and end on `time.perf_counter_ns`,
its parent, its thread, and the id of the `Engine.infer` call it belongs
to) to a list its thread owns; a thread registers its list once, on first
use. Counters add up per thread. `rec.spans` and `rec.counters` gather the
threads' lists when the block ends. A scope given the `device` its work
runs on also records a pair of CUDA events on the current stream while
recording on the card; they are `external` events, so a scope inside a
CUDA-graph capture times its stage on every replay of the graph
(`capture_graph` pauses them in its own captures, so a served graph
carries none).

Whenever a `torch.profiler` session is active, recording or not, every
scope also opens `torch.profiler.record_function(name)`: the spans are
then host events on the profiler's own timeline.

`timeit` times a device function, waiting for the card before it reads
the clock; `block` waits for a result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time
from typing import Iterator, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

_NULL = contextlib.nullcontext()
_CALL_IDS = itertools.count(1)


@dataclasses.dataclass(frozen=True)
class Span:
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]          # index in Recording.spans
    thread: int                    # threading.get_ident()
    call: Optional[int]            # the Engine.infer call it belongs to
    events: Optional[tuple] = None  # a device span's CUDA event pair

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


class _Thread:
    """One thread's spans and counters in one recording (`session`, the
    recording's list of threads); `current` is the index of its innermost
    open span, `call` that span's call id."""

    __slots__ = ("session", "spans", "counters", "current", "call",
                 "ident")

    def __init__(self, session: list) -> None:
        self.session = session
        self.spans: list[list] = []
        self.counters: dict[str, int] = {}
        self.current: Optional[int] = None
        self.call: Optional[int] = None
        self.ident = threading.get_ident()


class _Scope:
    """A recorded span: its record is appended on entry (so that children
    find their parent's index) and completed on exit."""

    __slots__ = ("tracer", "session", "name", "new_call", "device",
                 "state", "record", "saved", "prof")

    def __init__(self, tracer: "Tracer", session: list, name: str,
                 new_call: bool, device: Optional[torch.device]) -> None:
        self.tracer, self.session, self.name = tracer, session, name
        self.new_call, self.device = new_call, device

    def __enter__(self) -> None:
        st = self.tracer._thread(self.session)
        call = next(_CALL_IDS) if self.new_call else st.call
        self.prof = None
        if _autograd_profiler._is_profiler_enabled:
            self.prof = torch.profiler.record_function(self.name)
            self.prof.__enter__()
        events = None
        if self.device is not None:
            events = (torch.cuda.Event(enable_timing=True, external=True),
                      torch.cuda.Event(enable_timing=True, external=True))
            events[0].record()
        self.saved = (st.current, st.call)
        self.record = [self.name, time.perf_counter_ns(), None, st.current,
                       st.ident, call, events]
        self.state = st
        st.current, st.call = len(st.spans), call
        st.spans.append(self.record)

    def __exit__(self, *exc) -> None:
        record = self.record
        record[2] = time.perf_counter_ns()
        if record[6] is not None:
            record[6][1].record()
        if self.prof is not None:
            self.prof.__exit__(*exc)
        self.state.current, self.state.call = self.saved


@dataclasses.dataclass
class Recording:
    """What one `recording()` block recorded, gathered when it ended.
    A span still open then ends at that moment."""

    spans: list[Span] = dataclasses.field(default_factory=list)
    counters: dict[str, int] = dataclasses.field(default_factory=dict)

    def _gather(self, session: list, stop_ns: int) -> None:
        counters: dict[str, int] = {}
        for st in list(session):
            base = len(self.spans)
            for name, start, end, parent, ident, call, events in \
                    list(st.spans):
                self.spans.append(Span(
                    name, start, stop_ns if end is None else end,
                    None if parent is None else base + parent, ident, call,
                    events))
            for name, n in list(st.counters.items()):
                counters[name] = counters.get(name, 0) + n
        self.counters = counters

    def mean_ms(self, name: str) -> Optional[float]:
        """Mean host ms of the spans named `name` (None without one)."""
        got = [s.seconds for s in self.spans if s.name == name]
        return 1e3 * sum(got) / len(got) if got else None

    def device_ms(self) -> dict[str, list[float]]:
        """Device ms of each device span by name, read now: after the card
        has run them (a captured span: after each replay, which records
        its events again)."""
        out: dict[str, list[float]] = {}
        for s in self.spans:
            if s.events is not None:
                out.setdefault(s.name, []).append(
                    s.events[0].elapsed_time(s.events[1]))
        return out

    def summary(self) -> dict[str, tuple[int, float]]:
        """Nested name ("outer/inner") -> (calls, total seconds), in the
        order each first opened."""
        paths: list[str] = []
        out: dict[str, list] = {}
        for s in self.spans:
            path = s.name if s.parent is None else \
                f"{paths[s.parent]}/{s.name}"
            paths.append(path)
            entry = out.setdefault(path, [0, 0.0])
            entry[0] += 1
            entry[1] += s.seconds
        return {k: (n, t) for k, (n, t) in out.items()}

    def report(self) -> str:
        """Indented per-scope calls, total s and mean ms; then the
        counters."""
        tree: dict = {}
        for path, (calls, total) in self.summary().items():
            *parents, name = path.split("/")
            node = tree
            for part in parents:
                node = node[part][2]
            node[name] = (calls, total, {})
        lines = ["scope                                    calls      "
                 "total s      mean ms"]

        def walk(node: dict, depth: int) -> None:
            for name, (calls, total, children) in node.items():
                lines.append(f"{'  ' * depth}{name:<{40 - 2 * depth}}"
                             f"{calls:>6}{total:>13.3f}"
                             f"{total / calls * 1e3:>13.2f}")
                walk(children, depth + 1)

        walk(tree, 0)
        if self.counters:
            lines.append(f"{'counter':<40}{'value':>6}")
            lines += [f"{name:<40}{n:>6}"
                      for name, n in sorted(self.counters.items())]
        return "\n".join(lines)


class Tracer:
    """The span-and-counter recorder (see the module docstring)."""

    def __init__(self) -> None:
        self._session: Optional[list] = None     # its threads, recording
        self._local = threading.local()
        self._lock = threading.Lock()       # taken once a thread a recording
        self._device_paused = 0
        self.last = Recording()

    def scope(self, name: str, call: bool = False,
              device: Optional[torch.device] = None):
        """A span named `name`; `call` starts a new call id, which the
        spans inside it carry. Given the `device` its work runs on, a span
        recorded on the card also times that work between two CUDA
        events."""
        session = self._session
        if session is None:
            if _autograd_profiler._is_profiler_enabled:
                return torch.profiler.record_function(name)
            return _NULL
        if device is not None and (device.type != "cuda"
                                   or self._device_paused):
            device = None
        return _Scope(self, session, name, call, device)

    def count(self, name: str, n: int = 1) -> None:
        session = self._session
        if session is None:
            return
        counters = self._thread(session).counters
        counters[name] = counters.get(name, 0) + n

    def _thread(self, session: list) -> _Thread:
        st = getattr(self._local, "state", None)
        if st is None or st.session is not session:
            st = _Thread(session)
            self._local.state = st
            with self._lock:
                session.append(st)
        return st

    @contextlib.contextmanager
    def recording(self) -> Iterator[Recording]:
        """Record every span and counter of the block, of every thread;
        the Recording is filled when the block ends (and kept as
        `last`)."""
        if self._session is not None:
            raise RuntimeError("the tracer is already recording")
        session: list = []
        rec = Recording()
        self._session = session
        try:
            yield rec
        finally:
            self._session = None
            rec._gather(session, time.perf_counter_ns())
            self.last = rec

    @contextlib.contextmanager
    def no_device_spans(self) -> Iterator[None]:
        """Spans record no CUDA events inside the block (a capture whose
        graph must carry none)."""
        self._device_paused += 1
        try:
            yield
        finally:
            self._device_paused -= 1


GLOBAL_TRACER = Tracer()
scope = GLOBAL_TRACER.scope
count = GLOBAL_TRACER.count


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
