"""The port's training data path against the JAX package's, on the CPU:

- `decode_segmentation` (polygon, uncompressed RLE, compressed RLE) and
  `PoseSample.ignore_mask` bit-equal;
- `augment_sample` bit-equal for the same numpy Generator seed;
- a one-worker `TrainPipeline` with the same seed gives the same keypoints
  and masks as the JAX pipeline, and the same images once the JAX batch's
  space-to-depth layout is unpacked (the port's pipeline emits plain
  images);
- a corrupt file is skipped, dead workers raise, an augmentation error
  reaches the consumer, shards are disjoint (as tests/test_train.py checks
  the JAX pipeline), and the shared epoch cursor survives thread
  contention.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from openpose_plus_tpu.config import default_config as jdefault_config
from openpose_plus_tpu.data import augment as jaugment
from openpose_plus_tpu.data import coco as jcoco
from openpose_plus_tpu.data import pipeline as jpipeline
from openpose_plus_tpu_torch.config import default_config
from openpose_plus_tpu_torch.data import augment, coco, pipeline
from openpose_plus_tpu_torch.models.common import to_plain

torch.set_num_threads(2)


def _rle_counts(mask: np.ndarray) -> list:
    """COCO uncompressed RLE: column-major runs, starting with zeros."""
    flat = mask.T.reshape(-1)
    counts, val, run = [], 0, 0
    for v in flat:
        if v != val:
            counts.append(run)
            val, run = v, 0
        run += 1
    return counts + [run]


def _encode_rle(mask: np.ndarray) -> str:
    """pycocotools' rleToString: each count from the 3rd on delta-coded
    against the one two before, 5 bits a character with sign folding."""
    counts = _rle_counts(mask)
    out = []
    for i, c in enumerate(counts):
        x = c - counts[i - 2] if i > 2 else c
        more = True
        while more:
            ch = x & 0x1F
            x >>= 5
            more = x != -1 if ch & 0x10 else x != 0
            if more:
                ch |= 0x20
            out.append(chr(ch + 48))
    return "".join(out)


def _blobs(rng, h, w, n=3):
    mask = np.zeros((h, w), np.uint8)
    for _ in range(n):
        y0, x0 = rng.integers(0, h - 4), rng.integers(0, w - 4)
        mask[y0:y0 + rng.integers(2, h // 2), x0:x0 + rng.integers(2, w // 2)] = 1
    return mask


@pytest.mark.parametrize("h,w,seed", [(37, 53, 0), (64, 48, 1), (120, 160, 2)])
def test_decode_segmentation_matches_jax(h, w, seed):
    rng = np.random.default_rng(seed)
    mask = _blobs(rng, h, w)
    polys = [list(rng.uniform(0, [w, h], (5, 2)).ravel()),
             list(rng.uniform(0, [w, h], (3, 2)).ravel())]
    segms = [polys,
             {"counts": _rle_counts(mask), "size": [h, w]},
             {"counts": _encode_rle(mask), "size": [h, w]},
             {"counts": _encode_rle(mask).encode("ascii"), "size": [h, w]},
             {"counts": _encode_rle(np.zeros((h, w), np.uint8)),
              "size": [h, w]}]
    for segm in segms:
        out = coco.decode_segmentation(segm, h, w)
        ref = jcoco.decode_segmentation(segm, h, w)
        assert out.dtype == ref.dtype == np.uint8
        np.testing.assert_array_equal(out, ref)
    # the compressed string decodes to the mask it encodes
    np.testing.assert_array_equal(
        coco._decode_compressed_rle(_encode_rle(mask), h, w), mask)


def test_ignore_mask_matches_jax():
    rng = np.random.default_rng(3)
    h, w = 90, 70
    segms = [[[5, 5, 30, 8, 20, 40]],
             {"counts": _rle_counts(_blobs(rng, h, w)), "size": [h, w]},
             {"counts": _encode_rle(_blobs(rng, h, w)), "size": [h, w]}]
    for ignore in ([], segms[:1], segms):
        kw = dict(image_id=1, image_path="x.jpg", width=w, height=h,
                  keypoints=np.zeros((1, 18, 3), np.float32),
                  keypoints_coco=np.zeros((1, 17, 3), np.float32),
                  areas=np.ones(1, np.float32), ignore_segms=ignore)
        out = coco.PoseSample(**kw).ignore_mask()
        ref = jcoco.PoseSample(**kw).ignore_mask()
        assert out.dtype == np.uint8 and out.shape == (h, w)
        np.testing.assert_array_equal(out, ref)
    assert out.min() == 0 and out.max() == 1


@pytest.mark.parametrize("seed", range(6))
def test_augment_sample_matches_jax(seed):
    """Same Generator seed -> bit-equal image, keypoints (flip swap
    included) and mask; the Generators end in the same state."""
    rng = np.random.default_rng(100 + seed)
    image = rng.integers(0, 256, (97, 131, 3), dtype=np.uint8)
    kp = np.zeros((3, 18, 3), np.float32)
    kp[..., 0] = rng.uniform(-10, 140, (3, 18))
    kp[..., 1] = rng.uniform(-10, 105, (3, 18))
    kp[..., 2] = rng.uniform(0, 1, (3, 18)) < 0.8
    mask = _blobs(rng, 97, 131) ^ 1
    jcfg, cfg = jdefault_config().data, default_config().data
    if seed % 2:
        jcfg, cfg = (dataclasses.replace(c, flip_prob=1.0, shift_frac=0.1)
                     for c in (jcfg, cfg))
    g_out, g_ref = (np.random.default_rng(seed) for _ in range(2))
    out = augment.augment_sample(image, kp, mask, cfg, 64, 72, g_out)
    ref = jaugment.augment_sample(image, kp, mask, jcfg, 64, 72, g_ref)
    for name in ("image", "keypoints", "mask"):
        a, r = getattr(out, name), getattr(ref, name)
        assert a.dtype == r.dtype, name
        np.testing.assert_array_equal(a, r, name)
    assert g_out.uniform() == g_ref.uniform()


# ------------------------------------------------------------- pipeline ---

def _write_dataset(tmp_path, n_images=6, crowd=True):
    """JPEGs with annotations: 1-2 people an image, a crowd region with a
    polygon or RLE segmentation on some."""
    import cv2

    img_dir = tmp_path / "imgs"
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.default_rng(0)
    images, annotations = [], []
    for i in range(n_images):
        h, w = (120, 160) if i % 2 else (150, 110)
        name = f"im{i}.jpg"
        cv2.imwrite(str(img_dir / name),
                    rng.integers(0, 255, (h, w, 3), dtype=np.uint8))
        images.append({"id": i, "file_name": name, "width": w, "height": h})
        for p in range(1 + i % 2):
            kps = []
            for _ in range(17):
                kps += [float(rng.uniform(5, w - 5)),
                        float(rng.uniform(5, h - 5)), int(rng.integers(0, 3))]
            annotations.append({
                "id": 100 + 10 * i + p, "image_id": i, "category_id": 1,
                "iscrowd": 0, "area": 3000.0, "keypoints": kps,
                "segmentation": []})
        if crowd and i % 3 != 2:
            segm = ([[10, 10, 60, 12, 40, 70]] if i % 3 == 0 else
                    {"counts": _encode_rle(_blobs(rng, h, w)),
                     "size": [h, w]})
            annotations.append({
                "id": 900 + i, "image_id": i, "category_id": 1,
                "iscrowd": 1, "area": 500.0, "keypoints": [0] * 51,
                "bbox": [10, 10, 50, 60], "segmentation": segm})
    ann_path = tmp_path / "ann.json"
    with open(ann_path, "w") as f:
        json.dump({"images": images, "annotations": annotations}, f)
    return str(ann_path), str(img_dir)


def _configs(name, batch=3):
    out = []
    for dc in (jdefault_config, default_config):
        cfg = dc(name)
        out.append(cfg.replace(
            model=dataclasses.replace(cfg.model, hin=64, win=72),
            data=dataclasses.replace(cfg.data, prefetch=2),
            train=dataclasses.replace(cfg.train, batch_size=batch)))
    return out


def _batches(pipe, n):
    it = iter(pipe)
    try:
        return [next(it) for _ in range(n)]
    finally:
        pipe.stop()


@pytest.mark.parametrize("name,kw", [
    ("mobilenet_thin", {}),
    ("vggtiny", {"cache_decoded": True}),
    ("vgg19", {"with_replacement": True, "shard_index": 1,
               "shard_count": 2})], ids=["s2d2", "s2d-cached", "plain-sharded"])
def test_pipeline_matches_jax(tmp_path, name, kw):
    """One worker, the same seed: the same batches, 4 of them (more than an
    epoch of a shard), with the JAX images unpacked from the model's
    space-to-depth layout (s2d^2 for MobileNet-thin, s2d for VGG-tiny,
    plain for VGG19's training lowering)."""
    ann, imgs = _write_dataset(tmp_path)
    jcfg, cfg = _configs(name)
    ref = _batches(jpipeline.TrainPipeline(
        jcoco.CocoPoseDataset(ann, imgs), jcfg, seed=7, num_workers=1, **kw),
        4)
    out = _batches(pipeline.TrainPipeline(
        coco.CocoPoseDataset(ann, imgs), cfg, seed=7, num_workers=1, **kw),
        4)
    m = cfg.model
    for o, r in zip(out, ref):
        assert o["images"].shape == (3, m.hin, m.win, 3)
        assert o["images"].dtype == np.uint8
        np.testing.assert_array_equal(
            o["images"], to_plain(torch.from_numpy(r["images"])).numpy())
        for key in ("keypoints", "mask"):
            assert o[key].dtype == r[key].dtype == np.float32
            np.testing.assert_array_equal(o[key], r[key], key)
    assert o["mask"].shape == (3, m.hout, m.wout, 1)
    assert any((b["mask"] == 0).any() for b in out)   # crowd regions


def test_pipeline_skips_corrupt_images(tmp_path):
    ann, imgs = _write_dataset(tmp_path, n_images=6)
    open(os.path.join(imgs, "im1.jpg"), "wb").write(b"not a jpeg")
    os.remove(os.path.join(imgs, "im3.jpg"))
    _, cfg = _configs("vggtiny", batch=4)
    pipe = pipeline.TrainPipeline(coco.CocoPoseDataset(ann, imgs), cfg,
                                  seed=0, num_workers=2)
    for batch in _batches(pipe, 3):
        assert batch["images"].shape[0] == 4
    assert pipe._bad_paths == {os.path.join(imgs, "im1.jpg"),
                               os.path.join(imgs, "im3.jpg")}
    assert not any(t.is_alive() for t in pipe._threads)   # stop() joined


def test_pipeline_raises_when_workers_die(tmp_path):
    ann, imgs = _write_dataset(tmp_path, n_images=2)
    for i in range(2):
        os.remove(os.path.join(imgs, f"im{i}.jpg"))
    _, cfg = _configs("vggtiny", batch=2)
    pipe = pipeline.TrainPipeline(coco.CocoPoseDataset(ann, imgs), cfg,
                                  seed=0, num_workers=1)
    with pytest.raises(RuntimeError, match="pipeline worker failed"):
        next(iter(pipe))


def test_pipeline_surfaces_augmentation_errors(tmp_path, monkeypatch):
    ann, imgs = _write_dataset(tmp_path, n_images=2)
    _, cfg = _configs("vggtiny", batch=2)

    def broken(*args, **kwargs):
        raise ZeroDivisionError("augmentation bug")

    monkeypatch.setattr(augment, "augment_sample", broken)
    pipe = pipeline.TrainPipeline(coco.CocoPoseDataset(ann, imgs), cfg,
                                  seed=0, num_workers=1)
    with pytest.raises(RuntimeError) as info:
        next(iter(pipe))
    assert isinstance(info.value.__cause__, ZeroDivisionError)


def test_pipeline_shards_are_disjoint(tmp_path):
    ann, imgs = _write_dataset(tmp_path, n_images=6)
    ds = coco.CocoPoseDataset(ann, imgs)
    _, cfg = _configs("vggtiny", batch=2)
    a = pipeline.TrainPipeline(ds, cfg, seed=0, shard_index=0, shard_count=2)
    b = pipeline.TrainPipeline(ds, cfg, seed=1, shard_index=1, shard_count=2)
    sa, sb = set(a._indices.tolist()), set(b._indices.tolist())
    assert sa.isdisjoint(sb)
    assert sa | sb == set(range(6))
    with pytest.raises(ValueError, match="empty"):
        pipeline.TrainPipeline(ds, cfg, shard_index=7, shard_count=8)


def test_pipeline_epoch_cursor_under_thread_contention(tmp_path):
    """The shared shuffled-epoch cursor under 24 threads with a 1 us switch
    interval: every sample is drawn exactly once an epoch (a lost cursor
    update would draw one twice and skip another)."""
    import sys
    import threading

    ann, imgs = _write_dataset(tmp_path, n_images=6, crowd=False)
    _, cfg = _configs("vggtiny")
    pipe = pipeline.TrainPipeline(coco.CocoPoseDataset(ann, imgs), cfg,
                                  seed=3)
    epochs, n = 200, len(pipe._indices)
    draws, lock = [], threading.Lock()

    def worker(wid):
        rng = np.random.default_rng(wid)
        mine = [int(pipe._draw_indices(1, rng)[0])
                for _ in range(epochs * n // 24)]
        with lock:
            draws.extend(mine)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(w,))
                   for w in range(24)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(draws) == epochs * n
    assert np.bincount(draws, minlength=n).tolist() == [epochs] * n
