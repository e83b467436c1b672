"""Threaded decode -> letterbox -> batch stream for image files and frames
(port of `openpose_plus_tpu/native.py`: `load_image`, `letterbox`,
`NativeStreamLoader`).

The reference runs this stage in C++ (`native/src/stream.cpp`). Here a pool
of `workers` threads does the same work with cv2 and numpy, which release
the GIL: each file is decoded (`decode`, below) and letterboxed, each
in-memory frame letterboxed (`data.augment.letterbox`, bit for bit the JAX
package's Python letterbox), and packed into the engine's space-to-depth
layout (`host.pack`). At most
`queue_capacity` batches are read ahead of the consumer. Batches come in
source order (the native loader yields in completion order; source order is
one of the orders it allows), a file that cannot be decoded is skipped, the
short tail batch is kept, and an exception raised in a worker reaches the
consumer. While `utils.tracer.GLOBAL_TRACER` records (or a
`torch.profiler` session is active), the workers' scopes `decode`,
`resize`, `s2d` and `s2d2` are spans under the native tracer's names, the
consumer's wait for a worker is the span `loader.wait`, and each file that
cannot be decoded counts in `loader.skipped`; otherwise they cost an
attribute read.

While a loader with more than one worker runs, cv2's own thread pool is
held to one thread (`cv2.setNumThreads(1)`, a process-wide setting; the
count in force before comes back when the last such loader closes): each
worker already runs its own cv2 calls, and cv2 fanning every `warpAffine`
and `cvtColor` out over all cores as well oversubscribed them (PERF.md,
streams).

A file decodes as the native loader decodes it (`native/src/image.cpp`):
a JPEG (first bytes FF D8) headed for a letterbox smaller than itself is
decoded DCT-scaled, a PNG or any other file at full size. The native decode
takes libjpeg's coarsest M/8 scale that still covers the letterboxed
content, M = ceil(8 ts) with ts = min(win / W, hin / H) in float32; cv2
offers 1/8, 1/4 and 1/2 (`IMREAD_REDUCED_COLOR_{8,4,2}`), so the port
decodes at the largest of those with 8/d >= M, else at full size. That is
the native plane for M in {1, 2, 4}; for M in {3, 5, 6, 7} the port's plane
is one cv2 step finer (1/2 for 3/8, full size for 5/8-7/8). The scale and
pads are always those of the original (H, W), read from the JPEG's SOF
marker, so `(p - pad) / scale` maps back to original pixels whatever the
decode: a reduced plane is sampled through its plane-to-original ratio with
the native letterbox's pixel centres, and a full-size decode letterboxes as
`data.augment.letterbox` does (bit for bit the reference's Python path).
cv2 applies a JPEG's EXIF orientation and libjpeg does not: the port takes
the original dims in the orientation cv2 returns (EXIF 5-8 swap them), so
that scale and pads are those of a full cv2 decode.
"""

from __future__ import annotations

import collections
import concurrent.futures
import functools
import itertools
import math
import queue
import struct
import threading
from typing import Callable, Iterable, Iterator, Optional, Sequence

import numpy as np

from openpose_plus_tpu_torch import host
from openpose_plus_tpu_torch.data import augment
from openpose_plus_tpu_torch.utils.tracer import count, scope

Loaded = tuple[np.ndarray, float, tuple[float, float]]

# start-of-frame markers: C0-CF but DHT (C4), JPG (C8) and DAC (CC)
_SOF = frozenset(range(0xC0, 0xD0)) - {0xC4, 0xC8, 0xCC}
_SOS = 0xDA
_APP1 = 0xE1
_TRANSPOSING = frozenset((5, 6, 7, 8))      # EXIF orientations


def _exif_orientation(data: np.ndarray, start: int, end: int) -> int:
    """The EXIF orientation tag of an APP1 payload data[start:end] (1, the
    identity, when there is none or it cannot be read)."""
    if bytes(data[start:start + 6]) != b"Exif\0\0" or end - start < 14:
        return 1
    tiff = start + 6
    order = {b"II": "<", b"MM": ">"}.get(bytes(data[tiff:tiff + 2]))
    if order is None:
        return 1
    ifd = tiff + struct.unpack_from(order + "I", data, tiff + 4)[0]
    if ifd + 2 > end:
        return 1
    count = struct.unpack_from(order + "H", data, ifd)[0]
    for entry in range(ifd + 2, min(ifd + 2 + 12 * count, end - 11), 12):
        tag, kind = struct.unpack_from(order + "HH", data, entry)
        if tag == 0x0112 and kind == 3:                 # SHORT
            return struct.unpack_from(order + "H", data, entry + 8)[0]
    return 1


def jpeg_dims(data: np.ndarray) -> Optional[tuple[int, int]]:
    """The (H, W) of a JPEG's bytes from its SOF marker, in the orientation
    cv2 decodes it to; None if `data` is not a JPEG (it does not start FF
    D8, as `native/src/image.cpp` tests it) or no frame header comes before
    the first scan."""
    if len(data) < 4 or data[0] != 0xFF or data[1] != 0xD8:
        return None
    i, orientation = 2, 1
    while i + 4 <= len(data):
        if data[i] != 0xFF:
            return None
        marker = int(data[i + 1])
        if marker == 0xFF:                              # a fill byte
            i += 1
            continue
        if marker == 0x01 or 0xD0 <= marker <= 0xD7:    # no length field
            i += 2
            continue
        length = struct.unpack_from(">H", data, i + 2)[0]
        if marker in _SOF and i + 9 <= len(data):
            h, w = struct.unpack_from(">HH", data, i + 5)
            if h == 0 or w == 0:
                return None
            return (w, h) if orientation in _TRANSPOSING else (h, w)
        if marker == _SOS:
            return None
        if marker == _APP1 and orientation == 1:
            orientation = _exif_orientation(data, i + 4,
                                            min(i + 2 + length, len(data)))
        i += 2 + length
    return None


def dct_reduction(h: int, w: int, hin: int, win: int) -> int:
    """The cv2 reduction d in {1, 2, 4, 8} for an (h, w) JPEG headed for a
    (hin, win) letterbox: the largest d with 8/d >= M, M the native decode's
    ceil(8 ts) in float32 (`image.cpp`), 1 when ts >= 1."""
    ts = min(np.float32(win) / np.float32(w), np.float32(hin) / np.float32(h))
    if ts >= 1:
        return 1
    m = min(max(math.ceil(ts * np.float32(8)), 1), 8)
    return next((d for d in (8, 4, 2) if 8 // d >= m), 1)


def decode(path: str, hin: int, win: int
           ) -> Optional[tuple[np.ndarray, tuple[int, int]]]:
    """A file decoded for a (hin, win) letterbox: (RGB plane, the original
    (H, W)), the plane DCT-scaled for a large JPEG (module docstring), or
    None when the file cannot be read or decoded."""
    import cv2

    try:
        data = np.fromfile(path, np.uint8)
    except OSError:
        return None
    if not data.size:                   # cv2.imdecode raises on no bytes
        return None
    dims = jpeg_dims(data)
    d = dct_reduction(*dims, hin, win) if dims is not None else 1
    bgr = cv2.imdecode(data, {1: cv2.IMREAD_COLOR,
                              2: cv2.IMREAD_REDUCED_COLOR_2,
                              4: cv2.IMREAD_REDUCED_COLOR_4,
                              8: cv2.IMREAD_REDUCED_COLOR_8}[d])
    if bgr is None:
        return None
    plane = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
    return plane, (dims if d > 1 else plane.shape[:2])


def letterbox_plane(plane: np.ndarray, dims: tuple[int, int], hin: int,
                    win: int) -> Loaded:
    """Letterbox of a decoded plane whose original image was `dims` (H, W):
    scale and pads are the original's, as `data.augment.letterbox` computes
    them; a reduced plane is sampled through the plane-to-original ratio
    with the native letterbox's pixel centres (`image.cpp`
    `letterbox_resize`)."""
    h, w = dims
    if plane.shape[:2] == (h, w):
        return augment.letterbox(plane, hin, win)
    import cv2

    scale = min(win / w, hin / h)
    pad_x = win / 2 - scale * w / 2
    pad_y = hin / 2 - scale * h / 2
    sx, sy = scale * w / plane.shape[1], scale * h / plane.shape[0]
    m = np.array([[sx, 0.0, pad_x + 0.5 * sx - 0.5],
                  [0.0, sy, pad_y + 0.5 * sy - 0.5]])
    img = cv2.warpAffine(plane, m, (win, hin), flags=cv2.INTER_LINEAR,
                         borderMode=cv2.BORDER_CONSTANT, borderValue=0)
    return img, scale, (pad_x, pad_y)


def load_image(path: str, hin: int, win: int) -> Optional[Loaded]:
    """Decode (DCT-scaled for a large JPEG) + letterbox: (image (hin, win,
    3) uint8, scale, pads) against the original dims, or None when the
    file cannot be decoded (`native.load_image`)."""
    with scope("decode"):
        decoded = decode(path, hin, win)
    if decoded is None:
        return None
    with scope("resize"):
        return letterbox_plane(*decoded, hin, win)


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
                with scope("loader.wait"):
                    loaded = future.result()
                if loaded is None:
                    count("loader.skipped")
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
