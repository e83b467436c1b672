"""Threaded decode -> letterbox -> batch stream for image files and frames
(port of `openpose_plus_tpu/native.py`: `load_image`, `letterbox`,
`NativeStreamLoader`).

The reference runs this stage in C++ (`native/src/stream.cpp`). Here a pool
of `workers` threads does the same work with cv2 and numpy, which release
the GIL: each frame is decoded (`data.pipeline._load_image`), letterboxed
(`data.augment.letterbox`, bit for bit the JAX package's Python letterbox)
and packed into the engine's space-to-depth layout (`host.pack`). At most
`queue_capacity` batches are read ahead of the consumer. Batches come in
source order (the native loader yields in completion order; source order is
one of the orders it allows), a file that cannot be decoded is skipped, the
short tail batch is kept, and an exception raised in a worker reaches the
consumer. The scopes `decode`, `resize`, `s2d` and `s2d2` are timed in
`utils.tracer.GLOBAL_TRACER`, under the native tracer's names.

While a loader with more than one worker runs, cv2's own thread pool is
held to one thread (`cv2.setNumThreads(1)`, a process-wide setting; the
count in force before comes back when the last such loader closes): each
worker already runs its own cv2 calls, and cv2 fanning every `warpAffine`
and `cvtColor` out over all cores as well oversubscribed them (PERF.md,
streams).

Decode is at full resolution: the native loader's DCT-scaled JPEG decode is
not ported (ROADMAP.md).
"""

from __future__ import annotations

import collections
import concurrent.futures
import functools
import itertools
import queue
import threading
from typing import Callable, Iterable, Iterator, Optional, Sequence

import numpy as np

from openpose_plus_tpu_torch import host
from openpose_plus_tpu_torch.data import augment
from openpose_plus_tpu_torch.data.pipeline import _load_image
from openpose_plus_tpu_torch.utils.tracer import scope

Loaded = tuple[np.ndarray, float, tuple[float, float]]


def load_image(path: str, hin: int, win: int) -> Optional[Loaded]:
    """Decode + letterbox: (image (hin, win, 3) uint8, scale, pads), or None
    when the file cannot be decoded."""
    try:
        with scope("decode"):
            rgb = _load_image(path)
    except FileNotFoundError:          # cv2 could not read or decode it
        return None
    return letterbox(rgb, hin, win)


def letterbox(rgb: np.ndarray, hin: int, win: int) -> Loaded:
    """Letterbox of an in-memory RGB frame: (image, scale, (pad_x, pad_y))."""
    with scope("resize"):
        return augment.letterbox(rgb, hin, win)


def s2d_level(requested: int, hin: int, win: int) -> int:
    """The space-to-depth level a (hin, win) frame can take: the request,
    demoted as `native/src/stream.cpp` demotes it (level 2 needs dims % 4
    == 0, level 1 even dims)."""
    if requested >= 2 and hin % 4 == 0 and win % 4 == 0:
        return 2
    return 1 if requested >= 1 and hin % 2 == 0 and win % 2 == 0 else 0


def _pack(loaded: Optional[Loaded], level: int) -> Optional[Loaded]:
    if loaded is None or level == 0:
        return loaded
    img, scale, pads = loaded
    with scope("s2d2" if level == 2 else "s2d"):
        return host.pack(img, level), scale, pads


def _load_file(path: str, hin: int, win: int, level: int
               ) -> Optional[Loaded]:
    return _pack(load_image(path, hin, win), level)


def _load_frame(frame: np.ndarray, hin: int, win: int, level: int
                ) -> Loaded:
    return _pack(letterbox(frame, hin, win), level)


class _SerialCv2:
    """Holds cv2's process-wide thread count at 1 while any holder is
    active; the last release restores the count found by the first."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._holders = 0
        self._saved = 0

    def acquire(self) -> None:
        import cv2

        with self._lock:
            if self._holders == 0:
                self._saved = cv2.getNumThreads()
                cv2.setNumThreads(1)
            self._holders += 1

    def release(self) -> None:
        import cv2

        with self._lock:
            self._holders -= 1
            if self._holders == 0:
                cv2.setNumThreads(self._saved)


SERIAL_CV2 = _SerialCv2()


class _Pool:
    """`n` daemon threads running submitted calls; each call's result or
    exception lands in its Future."""

    def __init__(self, n: int):
        if n < 1:
            raise ValueError(f"workers must be >= 1, got {n}")
        self._tasks: queue.SimpleQueue = queue.SimpleQueue()
        self.threads = [threading.Thread(target=self._work, daemon=True,
                                         name=f"stream-loader-{i}")
                        for i in range(n)]
        for t in self.threads:
            t.start()

    def _work(self) -> None:
        while True:
            task = self._tasks.get()
            if task is None:
                return
            future, fn, arg = task
            if not future.set_running_or_notify_cancel():
                continue                  # cancelled by close()
            try:
                future.set_result(fn(arg))
            except Exception as exc:      # raised again by future.result()
                future.set_exception(exc)

    def submit(self, fn: Callable, arg) -> concurrent.futures.Future:
        future: concurrent.futures.Future = concurrent.futures.Future()
        self._tasks.put((future, fn, arg))
        return future

    def close(self) -> None:
        """Stop every thread after its current call and join it."""
        for _ in self.threads:
            self._tasks.put(None)
        for t in self.threads:
            if t is not threading.current_thread():
                t.join()


class PooledBatches:
    """Batches of `job(payload)` over `source`'s (index, payload) pairs,
    run on a pool of `workers` threads with at most `queue_capacity` batches
    in flight, yielded in source order as dicts: images (n, ...) uint8,
    scales (n,) and pads (n, 2) float32, indices (n,) int32. A job that
    returns None (an unreadable file) is skipped; `give_up_after` such
    misses in a row end the stream (a looped list with nothing readable).
    Iterating to the end, or closing, stops and joins the threads."""

    def __init__(self, source: Iterable[tuple[int, object]],
                 job: Callable[[object], Optional[Loaded]], batch: int,
                 workers: int, queue_capacity: int,
                 give_up_after: Optional[int] = None):
        if batch < 1 or queue_capacity < 1:
            raise ValueError(f"batch and queue_capacity must be >= 1, got "
                             f"{batch} and {queue_capacity}")
        self.batch = batch
        self._source = iter(source)
        self._job = job
        self._window = queue_capacity * batch       # frames in flight
        self._give_up_after = give_up_after
        self._pending: collections.deque = collections.deque()
        self._cv2_hold = SERIAL_CV2 if workers > 1 else None
        if self._cv2_hold is not None:
            self._cv2_hold.acquire()
        self._pool = _Pool(workers)
        self._closed = False

    @property
    def threads(self) -> list[threading.Thread]:
        return self._pool.threads

    def _fill(self) -> None:
        while len(self._pending) < self._window:
            item = next(self._source, None)
            if item is None:
                return
            index, payload = item
            self._pending.append((index, self._pool.submit(self._job,
                                                           payload)))

    def __iter__(self) -> Iterator[dict]:
        images, scales, pads, indices = [], [], [], []
        misses = 0
        try:
            while not self._closed:
                self._fill()
                if not self._pending:
                    break
                index, future = self._pending.popleft()
                loaded = future.result()
                if loaded is None:
                    misses += 1
                    if misses == self._give_up_after:
                        break
                    continue
                misses = 0
                images.append(loaded[0])
                scales.append(loaded[1])
                pads.append(loaded[2])
                indices.append(index)
                if len(images) == self.batch:
                    yield _batch(images, scales, pads, indices)
                    images, scales, pads, indices = [], [], [], []
            if images and not self._closed:
                yield _batch(images, scales, pads, indices)
        finally:
            self.close()

    def close(self) -> None:
        """Cancel the frames not started, stop and join every worker."""
        if self._closed:
            return
        self._closed = True
        for _, future in self._pending:
            future.cancel()
        self._pending.clear()
        self._pool.close()
        if self._cv2_hold is not None:
            self._cv2_hold.release()


def _batch(images, scales, pads, indices) -> dict:
    return {"images": np.stack(images),
            "scales": np.asarray(scales, np.float32),
            "pads": np.asarray(pads, np.float32),
            "indices": np.asarray(indices, np.int32)}


class StreamLoader(PooledBatches):
    """Multithreaded decode -> letterbox -> batch stream over image files
    (port of `openpose_plus_tpu/native.py` `NativeStreamLoader`).

    Yields dict batches: images (B, hin, win, 3) uint8, or the space-to-depth
    layout of level `s2d` ((B, hin/2, win/2, 12) or (B, hin/4, win/4, 48));
    scales (B,), pads (B, 2), indices (B,); the last batch may be short.
    `self.s2d` is the level in effect (the request demoted by `s2d_level`).
    With `loop`, frame i is `paths[i % len(paths)]`, without end."""

    def __init__(self, paths: Sequence[str], hin: int, win: int,
                 batch: int = 8, workers: int = 8, queue_capacity: int = 4,
                 loop: bool = False, s2d: int = 0):
        paths = list(paths)
        n = len(paths)
        if loop and not n:
            raise ValueError("a looped stream needs at least one path")
        self.hin, self.win = hin, win
        self.s2d = s2d_level(s2d, hin, win)
        indices = (i % n for i in itertools.count()) if loop else range(n)
        super().__init__(
            ((i, paths[i]) for i in indices),
            functools.partial(_load_file, hin=hin, win=win, level=self.s2d),
            batch, workers, queue_capacity,
            give_up_after=n if loop else None)


class FrameLoader(PooledBatches):
    """The same pool over in-memory RGB frames (a camera or a video): each
    is letterboxed and packed on a worker. `frames` is read on the
    consumer's thread, at most `queue_capacity` batches ahead, so an endless
    iterator streams."""

    def __init__(self, frames: Iterable[np.ndarray], hin: int, win: int,
                 batch: int = 8, workers: int = 8, queue_capacity: int = 4,
                 s2d: int = 0):
        self.hin, self.win = hin, win
        self.s2d = s2d_level(s2d, hin, win)
        super().__init__(
            enumerate(frames),
            functools.partial(_load_frame, hin=hin, win=win, level=self.s2d),
            batch, workers, queue_capacity)
