"""The port's threaded file and frame loader (`openpose_plus_tpu_torch/
loader.py`) against the JAX package's loaders, on the CPU.

- Exact against the JAX package's Python path (its CLI's fallback): each
  PNG and JPEG frame equals `data.augment.letterbox(data.pipeline.
  _load_image(p))` packed by `native.s2d_u8` / `native.s2d2_u8`, bit for
  bit, with equal scales and pads; the unreadable file is skipped, the tail
  batch kept, batches in source order.
- Against the native C++ loader where it is built: the same indices, equal
  scales, pads within 1e-4 px (float32 in C++), pixels within the
  reference's own native-vs-cv2 bound (median |d| <= 2,
  tests/test_native_stream.py).
- The pool: loop mode indexes `i % n`, read-ahead is bounded by
  `queue_capacity` batches, a worker's exception reaches the consumer,
  closing (or stopping early, or reaching the end) joins every worker, a
  looped list of unreadable files ends, order holds under 16 workers with a
  short switch interval, cv2 runs on one thread while a multi-worker pool
  does and gets its thread count back after.
"""

import itertools
import sys

import numpy as np
import pytest

from openpose_plus_tpu import native
from openpose_plus_tpu.data.augment import letterbox as jletterbox
from openpose_plus_tpu.data.pipeline import _load_image as jload_image
from openpose_plus_tpu_torch import loader
from openpose_plus_tpu_torch.utils.tracer import GLOBAL_TRACER

cv2 = pytest.importorskip("cv2")

HIN = WIN = 64
SIZES = [(50, 70), (64, 64), (90, 40), (33, 81), (64, 100), (120, 96)]
JOIN_S = 30.0                     # every wait in these tests is bounded


def _smooth(rng, h, w):
    """Seeded low-frequency content (a coarse random grid, cubic-resized),
    so that JPEG decoders and bilinear resamplers differ by little."""
    coarse = rng.integers(0, 256, (4, 5, 3), dtype=np.uint8)
    return cv2.resize(coarse, (w, h), interpolation=cv2.INTER_CUBIC)


@pytest.fixture
def files(tmp_path):
    """PNGs and JPEGs of mixed sizes, with an unreadable file third."""
    rng = np.random.default_rng(0)
    paths = []
    for i, (h, w) in enumerate(SIZES):
        path = str(tmp_path / f"img{i}.{'png' if i % 2 else 'jpg'}")
        cv2.imwrite(path, _smooth(rng, h, w))
        paths.append(path)
    bad = str(tmp_path / "broken.jpg")
    with open(bad, "wb") as f:
        f.write(b"\xff\xd8 not a jpeg")
    paths.insert(2, bad)
    return paths


def _collect(stream):
    batches = list(stream)
    out = {k: np.concatenate([b[k] for b in batches])
           for k in ("images", "scales", "pads", "indices")}
    return batches, out


def _joined(threads):
    for t in threads:
        t.join(timeout=JOIN_S)
    return not any(t.is_alive() for t in threads)


@pytest.mark.parametrize("level", [0, 1, 2])
def test_loader_equals_the_jax_python_path(files, level):
    stream = loader.StreamLoader(files, HIN, WIN, batch=2, workers=3,
                                 queue_capacity=2, s2d=level)
    assert stream.s2d == level
    batches, out = _collect(stream)
    # 6 readable of 7: two full batches and the tail, in source order
    assert [b["indices"].tolist() for b in batches] == [[0, 1], [3, 4],
                                                        [5, 6]]
    pack = {0: lambda x: x, 1: native.s2d_u8, 2: native.s2d2_u8}[level]
    for row, i in enumerate(out["indices"]):
        img, scale, pads = jletterbox(jload_image(files[i]), HIN, WIN)
        np.testing.assert_array_equal(out["images"][row], pack(img),
                                      files[i])
        assert out["scales"][row] == np.float32(scale)
        np.testing.assert_array_equal(out["pads"][row],
                                      np.asarray(pads, np.float32))
    assert out["images"].dtype == np.uint8
    assert _joined(stream.threads)


@pytest.mark.parametrize("level", [0, 2])
def test_loader_within_the_native_loaders_bounds(files, level):
    if not native.is_available():
        pytest.skip("libpose_host.so not built")
    ours = _collect(loader.StreamLoader(files, HIN, WIN, batch=4, workers=2,
                                        s2d=level))[1]
    ref_loader = native.NativeStreamLoader(files, HIN, WIN, batch=4,
                                           workers=2, s2d=level)
    try:
        ref = _collect(ref_loader)[1]
    finally:
        ref_loader.close()
    order = np.argsort(ref["indices"])
    ref = {k: v[order] for k, v in ref.items()}
    np.testing.assert_array_equal(ours["indices"], ref["indices"])
    assert 2 not in ours["indices"]            # the unreadable file
    np.testing.assert_array_equal(ours["scales"], ref["scales"])
    np.testing.assert_allclose(ours["pads"], ref["pads"], rtol=0, atol=1e-4)
    diff = np.abs(ours["images"].astype(int) - ref["images"].astype(int))
    for row, d in enumerate(diff):
        assert np.median(d) <= 2, (ours["indices"][row], np.median(d))


@pytest.mark.parametrize("requested, hw, level", [
    (2, (64, 64), 2), (2, (66, 64), 1), (2, (65, 64), 0),
    (1, (64, 64), 1), (1, (64, 63), 0), (0, (64, 64), 0)])
def test_s2d_level_is_demoted_as_the_native_loader(requested, hw, level):
    assert loader.s2d_level(requested, *hw) == level
    stream = loader.StreamLoader([], *hw, workers=1, s2d=requested)
    stream.close()
    assert stream.s2d == level and _joined(stream.threads)


def test_loop_mode_cycles_and_close_joins(files):
    good = [files[i] for i in (0, 1, 3)]
    stream = loader.StreamLoader(good, HIN, WIN, batch=2, workers=2,
                                 queue_capacity=2, loop=True)
    it = iter(stream)
    taken = [next(it)["indices"].tolist() for _ in range(5)]
    assert list(itertools.chain(*taken)) == [i % 3 for i in range(10)]
    it.close()
    assert _joined(stream.threads)


def test_read_ahead_is_bounded_and_an_endless_source_streams():
    pulled = []

    def endless():
        for i in itertools.count():
            pulled.append(i)
            yield np.full((20, 30, 3), i % 256, np.uint8)

    stream = loader.FrameLoader(endless(), HIN, WIN, batch=3, workers=2,
                                queue_capacity=2)
    it = iter(stream)
    for expect in ([0, 1, 2], [3, 4, 5]):
        assert next(it)["indices"].tolist() == expect
    # consumed 6; at most queue_capacity batches in flight beyond them
    assert len(pulled) <= 6 + 2 * 3
    it.close()
    assert _joined(stream.threads)


def test_a_worker_exception_reaches_the_consumer(files, monkeypatch):
    def broken(path, hin, win):
        if path == files[3]:
            raise ValueError("decoder fault")
        return loader.letterbox(np.zeros((8, 8, 3), np.uint8), hin, win)

    monkeypatch.setattr(loader, "load_image", broken)
    stream = loader.StreamLoader(files, HIN, WIN, batch=2, workers=2)
    with pytest.raises(ValueError, match="decoder fault"):
        list(stream)
    assert _joined(stream.threads)


def test_stopping_early_or_closing_joins_the_workers(files):
    stream = loader.StreamLoader(files, HIN, WIN, batch=1, workers=3)
    for _ in stream:
        break                     # the abandoned generator closes the pool
    assert _joined(stream.threads)
    unstarted = loader.StreamLoader(files, HIN, WIN, workers=2)
    unstarted.close()
    assert _joined(unstarted.threads) and list(unstarted) == []


def test_a_looped_list_with_nothing_readable_ends(tmp_path):
    bad = str(tmp_path / "x.png")
    with open(bad, "w") as f:
        f.write("not an image")
    stream = loader.StreamLoader([bad, str(tmp_path / "missing.jpg")], HIN,
                                 WIN, loop=True, workers=2)
    assert list(stream) == []
    assert _joined(stream.threads)
    with pytest.raises(ValueError):
        loader.StreamLoader([], HIN, WIN, loop=True)
    with pytest.raises(ValueError):
        loader.FrameLoader([], HIN, WIN, workers=0)


def test_order_holds_under_many_workers():
    """16 workers, a short switch interval: every frame once, in order,
    each letterboxed from its own frame."""
    rng = np.random.default_rng(1)
    frames = [rng.integers(0, 256, (int(rng.integers(8, 40)),
                                    int(rng.integers(8, 40)), 3),
                           dtype=np.uint8) for _ in range(96)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        stream = loader.FrameLoader(frames, 16, 16, batch=5, workers=16,
                                    queue_capacity=3, s2d=1)
        batches, out = _collect(stream)
    finally:
        sys.setswitchinterval(interval)
    assert [len(b["indices"]) for b in batches] == [5] * 19 + [1]
    np.testing.assert_array_equal(out["indices"], np.arange(96))
    for i in (0, 37, 95):
        np.testing.assert_array_equal(
            out["images"][i], native.s2d_u8(jletterbox(frames[i], 16, 16)[0]))
    assert _joined(stream.threads)


def test_cv2_is_held_to_one_thread_while_a_pool_runs(files):
    """More than one worker: cv2's own threads drop to 1 until the last
    such loader closes, then the count found comes back; one worker leaves
    cv2 alone."""
    before = cv2.getNumThreads()
    try:
        cv2.setNumThreads(3)
        single = loader.StreamLoader(files, HIN, WIN, workers=1)
        assert cv2.getNumThreads() == 3
        a = loader.StreamLoader(files, HIN, WIN, workers=2)
        b = loader.FrameLoader([], HIN, WIN, workers=4)
        assert cv2.getNumThreads() == 1
        a.close()
        assert cv2.getNumThreads() == 1
        list(b)                       # the end of iteration closes it
        assert cv2.getNumThreads() == 3
        single.close()
        assert cv2.getNumThreads() == 3
        assert all(_joined(x.threads) for x in (single, a, b))
    finally:
        cv2.setNumThreads(before)


def test_the_native_scopes_are_traced(files):
    GLOBAL_TRACER.reset()
    list(loader.StreamLoader(files, HIN, WIN, batch=4, workers=2, s2d=2))
    scopes = GLOBAL_TRACER._root.children
    assert scopes["decode"].calls == len(files)     # the unreadable too
    assert scopes["resize"].calls == scopes["s2d2"].calls == len(files) - 1
    assert "s2d2" in GLOBAL_TRACER.report()
