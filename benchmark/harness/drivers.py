"""The loops that drive the program, one a kind of traffic (the traffic
file's "driver"), each a closed loop of one caller that takes every answer
to the host before the next call:

  engine_batches  seeded letterboxed batches held on the device, served by
                  `Engine.infer` at the compiled batch, in turn
  live_frames     seeded raw frames in host memory, each letterboxed by
                  `loader.letterbox` and served by `Engine.infer` at batch 1

A driver keeps, for each input, its latest answer (host arrays of its
image) and the answer it gave first, and counts the answers that differ
from the first; the check reads them after the window. A traffic file's
"cv2_threads" sets cv2's process-wide thread count for the run (one
caller's host work on one core, as a camera's loop runs it)."""

from __future__ import annotations

import time

import numpy as np
import torch

from harness import scenes
from reference import images as rimages

FIELDS = ("coords", "part_scores", "part_valid", "score", "n_parts", "valid")


def to_host(humans) -> dict:
    """Every field of a HumanBatch copied to the host."""
    return {f: getattr(humans, f).cpu().numpy() for f in FIELDS}


class Driver:
    """What the drivers share: the answers and their bookkeeping."""

    def __init__(self, run):
        self.run = run
        self.t = run.cell.traffic
        self.latest: dict = {}
        self.first: dict = {}
        self.repeat_mismatch = 0
        self.latencies: list = []
        if "cv2_threads" in self.t:
            import cv2

            cv2.setNumThreads(self.t["cv2_threads"])

    def record(self, index: int, host: dict, row: int) -> None:
        ans = {f: host[f][row] for f in FIELDS}
        self.latest[index] = ans
        first = self.first.setdefault(index, ans)
        if first is not ans and not all(np.array_equal(first[f], ans[f])
                                        for f in FIELDS):
            self.repeat_mismatch += 1

    def warm(self) -> None:
        for _ in range(self.warm_steps()):
            self.step()


class EngineBatches(Driver):
    def setup(self) -> np.ndarray:
        m = self.run.cell.config["model"]
        t = self.t
        self.host = np.stack(scenes.render_many(
            self.run.seed, t["batches"] * t["batch"], m["hin"], m["win"],
            t["people"])).reshape(t["batches"], t["batch"], m["hin"],
                                  m["win"], 3)
        self.batches = torch.from_numpy(self.host).to(self.run.device)
        self.i = 0
        return self.host[0, :1]

    def build(self) -> None:
        self.run.engine.compile(self.t["batch"])

    def warm_steps(self) -> int:
        return 2 * self.t["batches"]

    def step(self) -> int:
        k = self.i % self.t["batches"]
        self.i += 1
        host = to_host(self.run.engine.infer(self.batches[k]))
        b = self.t["batch"]
        for row in range(b):
            self.record(k * b + row, host, row)
        return b

    def model_batch(self) -> torch.Tensor:
        return self.batches[0]

    def answers(self) -> tuple[list, np.ndarray, int]:
        """A seeded sample of `check_batches` of the batches."""
        b, n = self.t["batch"], self.t["batches"]
        pick = np.sort(np.random.default_rng(self.run.seed).choice(
            n, size=min(self.t["check_batches"], n), replace=False))
        idx = [k * b + r for k in pick for r in range(b)]
        return ([self.latest[i] for i in idx],
                self.host.reshape(-1, *self.host.shape[2:])[idx], 0)


class LiveFrames(Driver):
    def setup(self) -> np.ndarray:
        t = self.t
        self.frames = scenes.render_many(self.run.seed, t["frames"],
                                         t["height"], t["width"],
                                         t["people"])
        self.planes: dict = {}
        self.i = 0
        m = self.run.cell.config["model"]
        return rimages.letterbox_frame(self.frames[0], m["hin"],
                                       m["win"])[0][None]

    def build(self) -> None:
        from openpose_plus_tpu_torch import loader

        self.letterbox = loader.letterbox
        self.run.engine.compile(1)
        self.plane_mismatch = 0

    def warm_steps(self) -> int:
        return 2 * len(self.frames)

    def step(self) -> int:
        m = self.run.cell.config["model"]
        k = self.i % len(self.frames)
        self.i += 1
        t0 = time.perf_counter()
        img = self.letterbox(self.frames[k], m["hin"], m["win"])[0]
        host = to_host(self.run.engine.infer(img[None]))
        self.latencies.append(time.perf_counter() - t0)
        self.record(k, host, 0)
        first = self.planes.setdefault(k, img)
        if first is not img and not np.array_equal(first, img):
            self.plane_mismatch += 1
        return 1

    def model_batch(self) -> torch.Tensor:
        m = self.run.cell.config["model"]
        img = self.letterbox(self.frames[0], m["hin"], m["win"])[0]
        return torch.from_numpy(img[None]).to(self.run.device)

    def letterbox_ms(self, passes: int) -> float:
        """ms a frame of `loader.letterbox` alone over the cell's frames."""
        m = self.run.cell.config["model"]
        t0 = time.perf_counter()
        for _ in range(passes):
            for f in self.frames:
                self.letterbox(f, m["hin"], m["win"])
        return (time.perf_counter() - t0) * 1e3 / (passes * len(self.frames))

    def answers(self) -> tuple[list, np.ndarray, int]:
        m = self.run.cell.config["model"]
        planes = np.stack([rimages.letterbox_frame(f, m["hin"], m["win"])[0]
                           for f in self.frames])
        wrong = self.plane_mismatch + sum(
            not np.array_equal(self.planes[k], planes[k])
            for k in range(len(self.frames)))
        return [self.latest[k] for k in range(len(self.frames))], planes, \
            wrong


DRIVERS = {"engine_batches": EngineBatches, "live_frames": LiveFrames}
