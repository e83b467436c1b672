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

The reference's file stream (`run_files`, `benchmark_stream`) runs on its
native C++ loader, which the port does not have yet (ROADMAP.md item 11).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator, Optional, Sequence

import numpy as np
import torch

from openpose_plus_tpu_torch import host
from openpose_plus_tpu_torch.engine import Engine
from openpose_plus_tpu_torch.postproc import HumanBatch

_NATIVE = ("the native image loader is ROADMAP.md item 11; stream in-memory "
           "frames (run_frames) or a video (run_video)")


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
        # the native file loader's settings (run_files, ROADMAP.md item 11)
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
        raise NotImplementedError(f"run_files: {_NATIVE}")

    def run_frames(self, frames: Iterable[np.ndarray]
                   ) -> Iterator[StreamResult]:
        """Stream in-memory RGB frames (camera or video source), each
        letterboxed to the engine's geometry."""
        from openpose_plus_tpu_torch.data.augment import letterbox

        m = self.engine.config.model

        def batch_of(images, scales, pads, idx) -> dict:
            return {"images": np.stack(images),
                    "scales": np.asarray(scales, np.float32),
                    "pads": np.asarray(pads, np.float32),
                    "indices": np.asarray(idx, np.int32)}

        def batcher():
            images, scales, pads, idx = [], [], [], []
            for i, frame in enumerate(frames):
                img, s, p = letterbox(frame, m.hin, m.win)
                images.append(host.pack(img, self.s2d))
                scales.append(s)
                pads.append(p)
                idx.append(i)
                if len(images) == self.batch:
                    yield batch_of(images, scales, pads, idx)
                    images, scales, pads, idx = [], [], [], []
            if images:
                yield batch_of(images, scales, pads, idx)

        yield from self._run(batcher())

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
                buf[:n].copy_(torch.from_numpy(images))
                buf[n:].zero_()
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
                     n_batches: int = 20, batch: int = 8) -> dict:
    """Sustained FPS over a looped file stream: needs `run_files`."""
    raise NotImplementedError(f"benchmark_stream: {_NATIVE}")
