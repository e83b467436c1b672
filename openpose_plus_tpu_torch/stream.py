"""Stream mode: a pipelined frame source feeding the engine (port of
`openpose_plus_tpu/stream.py`).

As in the reference, the CNN and the grouping are one device step, so only
decode and letterbox remain on the host. The engine is compiled at the
stream's batch shape (a CUDA-graph capture), and one batch stays in flight:
the host letterboxes batch N+1 while the device runs batch N. Host batches
go to the card through two pinned buffers used in turn; each copy is
asynchronous and guarded by a CUDA event, so a buffer is refilled only
after its last copy has finished, and a result is handed out after its own
batch's event, not after a device-wide synchronize. Sustained throughput =
max(host rate, device rate), the reference's law.

The host side is `loader.py`: a pool of `workers` threads decodes (files),
letterboxes and packs frames, at most `queue_capacity` batches ahead, in
the reference's C++ loader's place (`run_files`, `benchmark_stream`) and
for in-memory frames (`run_frames`, `run_video`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterable, Iterator, Optional, Sequence

import numpy as np
import torch

from openpose_plus_tpu_torch import host
from openpose_plus_tpu_torch.engine import Engine
from openpose_plus_tpu_torch.loader import (FrameLoader, PooledBatches,
                                            StreamLoader)
from openpose_plus_tpu_torch.postproc import HumanBatch


@dataclasses.dataclass
class StreamResult:
    indices: np.ndarray        # (n,) source frame indices
    humans: HumanBatch         # device results for the batch (n rows valid)
    scales: np.ndarray         # (n,) letterbox scale per frame
    pads: np.ndarray           # (n, 2) letterbox pads per frame
    n: int


class StreamEstimator:
    """Sustained-throughput pose estimation over a frame stream."""

    def __init__(self, engine: Engine, batch: int = 8, workers: int = 8,
                 queue_capacity: int = 4):
        self.engine = engine
        self.batch = batch
        # the host pool: threads, and batches read ahead (loader.py)
        self.workers = workers
        self.queue_capacity = queue_capacity
        # the engine's largest space-to-depth input layout: the host
        # permutes the bytes after the letterbox
        self.s2d = engine.config.model.preferred_input_layout()
        self.shape = engine.config.model.input_shape(batch, self.s2d)
        if engine.device.type == "cuda":
            engine.compile(batch, host.INPUT_LAYOUTS[self.s2d])

    def run_files(self, paths: Sequence[str], loop: bool = False
                  ) -> Iterator[StreamResult]:
        """Stream image files (decoded and letterboxed on the pool); with
        `loop`, frame i is `paths[i % len(paths)]`, without end."""
        m = self.engine.config.model
        yield from self._pooled(StreamLoader(
            paths, m.hin, m.win, batch=self.batch, workers=self.workers,
            queue_capacity=self.queue_capacity, loop=loop, s2d=self.s2d))

    def run_frames(self, frames: Iterable[np.ndarray]
                   ) -> Iterator[StreamResult]:
        """Stream in-memory RGB frames (camera or video source), each
        letterboxed to the engine's geometry on the pool; `frames` may be
        endless."""
        m = self.engine.config.model
        yield from self._pooled(FrameLoader(
            frames, m.hin, m.win, batch=self.batch, workers=self.workers,
            queue_capacity=self.queue_capacity, s2d=self.s2d))

    def run_video(self, path: str) -> Iterator[StreamResult]:
        """Stream a video file (cv2.VideoCapture decode on the host)."""
        import cv2

        cap = cv2.VideoCapture(path)
        if not cap.isOpened():
            raise FileNotFoundError(path)

        def frames():
            while True:
                ok, frame = cap.read()
                if not ok:
                    return
                yield cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)

        try:
            yield from self.run_frames(frames())
        finally:
            # released also when the consumer stops early or the engine
            # raises mid-stream (closing the generator runs this)
            cap.release()

    # ------------------------------------------------------------------ --

    def _pooled(self, loader: PooledBatches) -> Iterator[StreamResult]:
        """`_run` over a loader, closed (its threads joined) also when the
        consumer stops early or the engine raises."""
        try:
            yield from self._run(iter(loader))
        finally:
            loader.close()

    def _run(self, batches: Iterator[dict]) -> Iterator[StreamResult]:
        """Keep one batch in flight; every batch padded to the compiled
        shape (zeros past the tail's frames)."""
        on_card = self.engine.device.type == "cuda"
        if on_card:
            staging = [torch.empty(self.shape, dtype=torch.uint8,
                                   pin_memory=True) for _ in range(2)]
            copied: list[Optional[torch.cuda.Event]] = [None, None]
        pending: Optional[tuple] = None
        for i, batch in enumerate(batches):
            images = batch["images"]
            n = images.shape[0]
            if on_card:
                slot = i % 2
                if copied[slot] is not None:     # its last copy has run
                    copied[slot].synchronize()
                buf = staging[slot]
                # numpy fills the pinned slot on this thread: a torch copy
                # would wake torch's intra-op threads, whose spinning after
                # it took cores from the loader's workers (PERF.md, streams)
                host_view = buf.numpy()
                host_view[:n] = images
                host_view[n:] = 0
                images = buf.to(self.engine.device, non_blocking=True)
                copied[slot] = torch.cuda.Event()
                copied[slot].record()
            elif n < self.batch:
                padded = np.zeros(self.shape, np.uint8)
                padded[:n] = images
                images = padded
            humans = self.engine.infer(images)
            done = None
            if on_card:
                done = torch.cuda.Event()
                done.record()
            if pending is not None:
                yield self._materialize(*pending)
            pending = (batch, humans, done)
        if pending is not None:
            yield self._materialize(*pending)

    @staticmethod
    def _materialize(batch: dict, humans: HumanBatch,
                     done: Optional[torch.cuda.Event]) -> StreamResult:
        if done is not None:
            done.synchronize()
        return StreamResult(indices=batch["indices"], humans=humans,
                            scales=batch["scales"], pads=batch["pads"],
                            n=batch["indices"].shape[0])


def benchmark_stream(engine: Engine, paths: Sequence[str],
                     n_batches: int = 20, batch: int = 8,
                     workers: int = 8) -> dict:
    """Sustained FPS over a looped file stream, after one warm-up batch."""
    it = StreamEstimator(engine, batch=batch, workers=workers).run_files(
        paths, loop=True)
    try:
        next(it)                 # warm-up: fills the pool's read-ahead
        t0 = time.perf_counter()
        frames = sum(next(it).n for _ in range(n_batches))
        dt = time.perf_counter() - t0
    finally:
        it.close()
    return {"fps": frames / dt, "frames": frames, "seconds": dt}
