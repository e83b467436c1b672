"""The port's stream mode against the JAX package's, on the CPU.

- `run_frames` (5 frames of mixed sizes, batch 2) gives the JAX
  `StreamEstimator.run_frames`'s indices, letterbox scales and pads
  exactly, and per batch the humans of `Engine.infer` on the letterboxed
  (space-to-depth packed, tail zero-padded) batch; against the JAX stream's
  humans to test_torch_engine.py's port-vs-JAX tolerance. The JAX side is
  pinned to its Python letterbox (`native.is_available` patched to False).
- `run_video` on an MJPG clip written by cv2 (skipped without an encoder)
  equals `run_frames` on the clip's decoded frames.
- `run_files` and `benchmark_stream` raise, naming the native loader's
  ROADMAP item.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util

from openpose_plus_tpu import config as jconfig
from openpose_plus_tpu import native
from openpose_plus_tpu import stream as jstream
from openpose_plus_tpu.checkpoint import _flatten
from openpose_plus_tpu.engine import Engine as JaxEngine
from openpose_plus_tpu_torch import config as tconfig
from openpose_plus_tpu_torch import host, stream
from openpose_plus_tpu_torch.data.augment import letterbox
from openpose_plus_tpu_torch.engine import Engine

cv2 = pytest.importorskip("cv2")

torch.set_num_threads(2)

SIZES = [(50, 70), (64, 64), (90, 40), (33, 81), (64, 100)]
BATCH = 2


def _cfg(config=tconfig):
    cfg = config.default_config("mobilenet_thin")
    return cfg.replace(model=dataclasses.replace(
        cfg.model, hin=64, win=64, n_stages=2, compute_dtype="float32"))


_PAIR = {}


def _engines():
    """A JAX and a port MobileNet-thin on the same parameters, heads
    scaled so that random frames group into humans."""
    if not _PAIR:
        flat = _flatten(jax.device_get(
            JaxEngine(_cfg(jconfig), seed=3).params))
        for branch, gain in (("conf", 400.0), ("paf", 1000.0)):
            key = f"params/stages/stage2_{branch}/Conv_0/kernel"
            flat[key] = np.asarray(flat[key]) * gain
        nested = traverse_util.unflatten_dict(
            {tuple(k.split("/")): v for k, v in flat.items()})
        _PAIR["jax"] = JaxEngine(_cfg(jconfig), params=nested)
        _PAIR["torch"] = Engine(_cfg(), params=flat, device="cpu")
    return _PAIR["jax"], _PAIR["torch"]


def _frames(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (*hw, 3), dtype=np.uint8) for hw in SIZES]


def _served_batch(engine, frames):
    """The batch Engine.infer sees: letterboxed, packed, zero-padded."""
    m = engine.config.model
    level = m.preferred_input_layout()
    images = [host.pack(letterbox(f, m.hin, m.win)[0], level)
              for f in frames]
    batch = np.zeros(m.input_shape(BATCH, level), np.uint8)
    batch[:len(images)] = images
    return batch


def test_run_frames_matches_the_jax_stream(monkeypatch):
    monkeypatch.setattr(native, "is_available", lambda: False)
    jax_engine, engine = _engines()
    frames = _frames()
    ref = list(jstream.StreamEstimator(jax_engine, batch=BATCH).run_frames(
        frames))
    est = stream.StreamEstimator(engine, batch=BATCH)
    assert est.s2d == 2                 # the s2d^2 layout is exercised
    out = list(est.run_frames(frames))
    assert [r.n for r in out] == [r.n for r in ref] == [2, 2, 1]
    humans = 0
    for r, j in zip(out, ref):
        for name in ("indices", "scales", "pads"):
            np.testing.assert_array_equal(getattr(r, name), getattr(j, name),
                                          name)
        own = engine.infer(_served_batch(engine, [frames[i]
                                                  for i in r.indices]))
        for f in dataclasses.fields(own):
            assert torch.equal(getattr(r.humans, f.name),
                               getattr(own, f.name)), f.name
        for name in ("valid", "n_parts", "part_valid"):
            np.testing.assert_array_equal(
                getattr(r.humans, name).numpy(),
                np.asarray(getattr(j.humans, name)), name)
        for name in ("coords", "part_scores", "score"):
            np.testing.assert_allclose(
                getattr(r.humans, name).numpy(),
                np.asarray(getattr(j.humans, name)), rtol=0, atol=1e-5,
                err_msg=name)
        humans += int(r.humans.num_humans[:r.n].sum())
    assert humans >= 1                   # the grouping is exercised


def test_run_video_equals_run_frames(tmp_path):
    path = str(tmp_path / "clip.avi")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 5.0,
                             (70, 50))
    if not writer.isOpened():
        pytest.skip("no MJPG encoder in this cv2 build")
    for frame in _frames(1):
        writer.write(cv2.resize(frame, (70, 50)))
    writer.release()
    cap = cv2.VideoCapture(path)
    decoded = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        decoded.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    cap.release()
    assert len(decoded) == len(SIZES)
    _, engine = _engines()
    est = stream.StreamEstimator(engine, batch=BATCH)
    video = list(est.run_video(path))
    frames = list(est.run_frames(decoded))
    assert [r.n for r in video] == [2, 2, 1]
    for a, b in zip(video, frames):
        np.testing.assert_array_equal(a.indices, b.indices)
        for f in dataclasses.fields(a.humans):
            assert torch.equal(getattr(a.humans, f.name),
                               getattr(b.humans, f.name)), f.name
    with pytest.raises(FileNotFoundError):
        next(est.run_video(str(tmp_path / "missing.avi")))


def test_file_stream_waits_for_the_native_loader():
    _, engine = _engines()
    est = stream.StreamEstimator(engine, batch=BATCH)
    with pytest.raises(NotImplementedError, match="item 11"):
        next(est.run_files(["a.jpg"]))
    with pytest.raises(NotImplementedError, match="item 11"):
        stream.benchmark_stream(engine, ["a.jpg"])
