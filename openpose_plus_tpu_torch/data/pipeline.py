"""Host input pipeline: decode + augment workers feeding the train step
(`openpose_plus_tpu/data/pipeline.py`).

Worker threads decode images and apply one affine warp a sample (GT maps are
synthesised on the device, in the train step); a bounded queue of ready
batches gives back-pressure. Same seeds, draws, epoch cursor, shards, cache,
error handling and `stop()` as the reference, with one difference: the
images always come out plain, (B, hin, win, 3) uint8. The port's stems never
lower through space-to-depth, so packing on the host only to unpack on the
device would be waste (the train step still takes every layout `Engine`
takes). `cv2` is imported inside the call.
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Iterator, Optional

import numpy as np

from openpose_plus_tpu_torch.config import Config
from openpose_plus_tpu_torch.data import augment as A
from openpose_plus_tpu_torch.data.coco import CocoPoseDataset, pad_keypoints


def _load_image(path: str) -> np.ndarray:
    """An image file -> (H, W, 3) uint8 RGB."""
    try:
        import cv2
    except ImportError:
        raise RuntimeError("cv2 required to load images") from None
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


class TrainPipeline:
    """Infinite shuffled batch stream: {'images', 'keypoints', 'mask'}.

    images:    (B, hin, win, 3) uint8, plain RGB
    keypoints: (B, max_people, 18, 3) float32, network-input pixel coords
    mask:      (B, hout, wout, 1) float32 loss mask

    Worker `wid` draws from `default_rng(seed * 1000 + wid)`. Without
    `with_replacement` all workers share one shuffled-epoch cursor (every
    sample once an epoch, a new permutation each epoch); `shard_index` /
    `shard_count` keep a rank-strided slice of the samples (disjoint
    shards); `cache_decoded` keeps decoded frames in RAM (augmentation still
    runs on every draw). An unreadable file is skipped with one warning; if
    nothing is readable, or augmentation raises, the iterator raises.
    """

    def __init__(self, dataset: CocoPoseDataset, config: Config,
                 seed: int = 0, num_workers: Optional[int] = None,
                 max_people: int = 32, with_replacement: bool = False,
                 shard_index: int = 0, shard_count: int = 1,
                 cache_decoded: bool = False):
        self.ds = dataset
        self.cfg = config
        self.max_people = max_people
        self._img_cache: Optional[dict[int, np.ndarray]] = (
            {} if cache_decoded else None)
        self._img_cache_lock = threading.Lock()
        self.seed = seed
        self.num_workers = num_workers or config.data.num_workers
        self.with_replacement = with_replacement
        self._q: queue.Queue = queue.Queue(maxsize=config.data.prefetch)
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._started = False
        self._error: Optional[BaseException] = None
        self._bad_paths: set[str] = set()
        self._shard = (shard_index, shard_count)
        self._indices = np.arange(shard_index, len(dataset), shard_count)
        if len(self._indices) == 0:
            raise ValueError(
                f"shard {shard_index}/{shard_count} of a {len(dataset)}-"
                f"sample dataset is empty")
        self._epoch_lock = threading.Lock()
        self._epoch_rng = np.random.default_rng(seed)
        self._perm = self._indices[
            self._epoch_rng.permutation(len(self._indices))]
        self._cursor = 0

    def _draw_indices(self, n: int, rng: np.random.Generator) -> np.ndarray:
        if self.with_replacement:
            return self._indices[rng.integers(0, len(self._indices), size=n)]
        out = np.empty(n, np.int64)
        with self._epoch_lock:
            for i in range(n):
                if self._cursor >= len(self._perm):
                    self._perm = self._indices[
                        self._epoch_rng.permutation(len(self._indices))]
                    self._cursor = 0
                out[i] = self._perm[self._cursor]
                self._cursor += 1
        return out

    def _image(self, i: int, path: str) -> np.ndarray:
        if self._img_cache is None:
            return _load_image(path)
        with self._img_cache_lock:
            img = self._img_cache.get(i)
        if img is None:
            img = _load_image(path)
            with self._img_cache_lock:
                self._img_cache[i] = img
        return img

    # --------------------------------------------------------- workers ---

    def _worker(self, wid: int) -> None:
        import cv2

        rng = np.random.default_rng(self.seed * 1000 + wid)
        m = self.cfg.model
        b = self.cfg.train.batch_size
        consecutive_skips = 0
        while not self._stop.is_set():
            images, kps, masks = [], [], []
            while len(images) < b and not self._stop.is_set():
                i = int(self._draw_indices(1, rng)[0])
                s = self.ds[i]
                try:
                    img = self._image(i, s.image_path)
                    consecutive_skips = 0
                except Exception as e:
                    # one bad file must not kill the worker: warn once per
                    # path and draw another sample; if NOTHING is readable,
                    # fail loudly instead of spinning forever
                    if s.image_path not in self._bad_paths:
                        self._bad_paths.add(s.image_path)
                        logging.getLogger(__name__).warning(
                            "skipping unreadable sample %s: %s",
                            s.image_path, e)
                    consecutive_skips += 1
                    if consecutive_skips > max(4 * len(self._indices), 64):
                        self._error = RuntimeError(
                            f"{consecutive_skips} consecutive unreadable "
                            f"samples — is the image dir correct?")
                        self._stop.set()
                        return
                    continue
                try:
                    aug = A.augment_sample(img, s.keypoints, s.ignore_mask(),
                                           self.cfg.data, m.hin, m.win, rng)
                    images.append(aug.image)
                    kps.append(pad_keypoints(aug.keypoints, self.max_people))
                    small = cv2.resize(aug.mask, (m.wout, m.hout),
                                       interpolation=cv2.INTER_AREA)
                    masks.append((small > 0.5).astype(np.float32)[..., None])
                except Exception as e:
                    # augmentation bugs are not data problems: surface them
                    # to the consumer instead of dying silently
                    self._error = e
                    self._stop.set()
                    return
            if self._stop.is_set():
                return
            batch = {
                "images": np.stack(images),
                "keypoints": np.stack(kps),
                "mask": np.stack(masks),
            }
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.2)
                    break
                except queue.Full:
                    continue

    def start(self) -> None:
        if self._started:
            return
        self._started = True
        for w in range(self.num_workers):
            t = threading.Thread(target=self._worker, args=(w,), daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        """Stops the workers and waits for them (each sees the flag within
        one sample's augmentation or 0.2 s of a full queue)."""
        self._stop.set()
        for t in self._threads:
            if t is not threading.current_thread():
                t.join(timeout=10.0)

    def __iter__(self) -> Iterator[dict]:
        self.start()
        while True:
            try:
                yield self._q.get(timeout=5.0)
            except queue.Empty:
                if self._error is not None:
                    raise RuntimeError(
                        "pipeline worker failed") from self._error
                if not any(t.is_alive() for t in self._threads):
                    raise RuntimeError(
                        "all pipeline workers exited; no batches coming")
