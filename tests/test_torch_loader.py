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
- DCT-scaled JPEG decode, against the native loader (`native/src/
  image.cpp`): photo-like JPEGs sized so that into 64x64 the native decode
  takes M/8 = 1/8, 2/8, 4/8 (cv2's 1/8, 1/4, 1/2: the same plane) and 3/8,
  6/8 (the port one cv2 step finer): equal scales, pads within 1e-4, and
  inside the content (its first and last row and column excluded, where
  the two letterboxes' edges differ even unscaled) pixels within 1 level
  for the same plane, the median bound above otherwise; by `load_image`
  and through both stream loaders. A PNG is never scaled (the first bytes
  decide, not the name); an EXIF-rotated JPEG letterboxes against the dims
  cv2 turns it to.
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


# ---------------------------------------------- DCT-scaled JPEG decode ---

# (h, w) into 64x64, and the native decode's M (libjpeg's M/8 scale)
SCALED = [((512, 448), 1), ((320, 700), 1), ((256, 224), 2), ((150, 300), 2),
          ((128, 112), 4), ((100, 160), 4), ((200, 180), 3), ((100, 90), 6)]
CV2_REDUCTION = {1: 8, 2: 4, 3: 2, 4: 2, 6: 1}     # 8/d >= M, d in 8/4/2/1


def _photo(rng, h, w):
    """Photo-like content: the smooth field plus seeded pixel noise."""
    noisy = _smooth(rng, h, w) + rng.normal(0.0, 3.0, (h, w, 3))
    return np.clip(noisy, 0, 255).astype(np.uint8)


@pytest.fixture
def photos(tmp_path):
    rng = np.random.default_rng(2)
    paths = []
    for i, ((h, w), _) in enumerate(SCALED):
        paths.append(str(tmp_path / f"photo{i}.jpg"))
        cv2.imwrite(paths[-1], _photo(rng, h, w))
    return paths


def _native_m(h, w):
    """M of `image.cpp`'s decode_jpeg, in float32 as there."""
    ts = min(np.float32(WIN) / np.float32(w), np.float32(HIN) / np.float32(h))
    return min(max(int(np.ceil(ts * np.float32(8))), 1), 8)


def _content(scale, pads, h, w):
    """The native letterbox's content rectangle (image.cpp), its first and
    last row and column dropped: (rows, cols) slices."""
    x0, y0 = max(0, int(pads[0])), max(0, int(pads[1]))
    x1 = min(WIN, int(np.float32(pads[0] + scale * w + 0.999)))
    y1 = min(HIN, int(np.float32(pads[1] + scale * h + 0.999)))
    return slice(y0 + 1, y1 - 1), slice(x0 + 1, x1 - 1)


def _check_against_native(ours, ref, m, h, w, what):
    img, scale, pads = ours
    assert np.float32(scale) == np.float32(ref[1]), what
    np.testing.assert_allclose(pads, ref[2], rtol=0, atol=1e-4,
                               err_msg=what)
    diff = np.abs(img.astype(int) - ref[0].astype(int))
    if m in (1, 2, 4):                  # the native plane itself
        inner = diff[_content(ref[1], ref[2], h, w)]
        assert inner.size and inner.max() <= 1, (what, inner.max())
    else:
        assert np.median(diff) <= 2, (what, np.median(diff))


@pytest.mark.parametrize("case", range(len(SCALED)))
def test_reduction_is_the_native_decodes_scale(photos, case):
    (h, w), m = SCALED[case]
    assert _native_m(h, w) == m
    d = loader.dct_reduction(h, w, HIN, WIN)
    assert d == CV2_REDUCTION[m]
    assert loader.jpeg_dims(np.fromfile(photos[case], np.uint8)) == (h, w)
    plane, dims = loader.decode(photos[case], HIN, WIN)
    assert dims == (h, w)
    assert plane.shape == (-(-h // d), -(-w // d), 3)


@pytest.mark.parametrize("case", range(len(SCALED)))
def test_scaled_decode_matches_the_native_loader(photos, case):
    if not native.is_available():
        pytest.skip("libpose_host.so not built")
    (h, w), m = SCALED[case]
    ours = loader.load_image(photos[case], HIN, WIN)
    _check_against_native(ours, native.load_image(photos[case], HIN, WIN),
                          m, h, w, photos[case])


@pytest.mark.parametrize("level", [0, 2])
def test_scaled_stream_matches_the_native_stream(photos, level):
    if not native.is_available():
        pytest.skip("libpose_host.so not built")
    paths = photos + [photos[0] + ".missing"]
    ours = _collect(loader.StreamLoader(paths, HIN, WIN, batch=3, workers=2,
                                        s2d=level))[1]
    ref_loader = native.NativeStreamLoader(paths, HIN, WIN, batch=3,
                                           workers=2, s2d=level)
    try:
        ref = _collect(ref_loader)[1]
    finally:
        ref_loader.close()
    order = np.argsort(ref["indices"])
    ref = {k: v[order] for k, v in ref.items()}
    np.testing.assert_array_equal(ours["indices"], np.arange(len(SCALED)))
    np.testing.assert_array_equal(ref["indices"], ours["indices"])
    for row, i in enumerate(ours["indices"]):
        (h, w), m = SCALED[i]
        _check_against_native(
            (native.d2s_u8(ours["images"][row]), ours["scales"][row],
             ours["pads"][row]),
            (native.d2s_u8(ref["images"][row]), ref["scales"][row],
             ref["pads"][row]), m, h, w, paths[i])


def test_a_png_is_never_scaled(tmp_path):
    """The first two bytes decide: a large PNG (under either name) decodes
    at full size and equals the JAX Python path bit for bit; a JPEG named
    .png is scaled."""
    img = _photo(np.random.default_rng(3), 512, 448)
    png = str(tmp_path / "big.png")
    cv2.imwrite(png, img)
    jpeg_named_png = str(tmp_path / "big_jpeg.png")
    with open(jpeg_named_png, "wb") as f:
        f.write(cv2.imencode(".jpg", img)[1].tobytes())
    png_named_jpg = str(tmp_path / "big_png.jpg")
    with open(png, "rb") as src, open(png_named_jpg, "wb") as dst:
        dst.write(src.read())
    for path in (png, png_named_jpg):
        plane, dims = loader.decode(path, HIN, WIN)
        assert plane.shape == (512, 448, 3) and dims == (512, 448)
        out, scale, pads = loader.load_image(path, HIN, WIN)
        ref, rscale, rpads = jletterbox(jload_image(path), HIN, WIN)
        np.testing.assert_array_equal(out, ref)
        assert (scale, pads) == (rscale, rpads)
    plane, dims = loader.decode(jpeg_named_png, HIN, WIN)
    assert plane.shape == (64, 56, 3) and dims == (512, 448)


@pytest.mark.parametrize("content", [None, b"", b"\xff\xd8",
                                     b"\xff\xd8\xff\xc0\x00\x11\x08",
                                     b"\x89PNG\r\n"])
def test_unreadable_files_load_as_none(tmp_path, content):
    """A missing file, a directory, an empty file, a bare or truncated JPEG
    header and a bare PNG signature: None (the stream skips them), as
    `native.load_image` gives."""
    path = str(tmp_path / "x.jpg")
    if content is not None:
        with open(path, "wb") as f:
            f.write(content)
    assert loader.load_image(path, HIN, WIN) is None
    assert loader.load_image(str(tmp_path), HIN, WIN) is None
    if native.is_available():
        assert native.load_image(path, HIN, WIN) is None


def _with_orientation(jpeg: bytes, orientation: int, order: str) -> bytes:
    """`jpeg` with an APP1 EXIF segment holding one orientation tag."""
    import struct

    mark = {"<": b"II", ">": b"MM"}[order]
    tiff = (mark + struct.pack(order + "HIH", 42, 8, 1)
            + struct.pack(order + "HHIHH", 0x0112, 3, 1, orientation, 0)
            + struct.pack(order + "I", 0))
    payload = b"Exif\0\0" + tiff
    return (jpeg[:2] + b"\xff\xe1" + struct.pack(">H", len(payload) + 2)
            + payload + jpeg[2:])


@pytest.mark.parametrize("orientation, order", [(6, ">"), (8, "<"),
                                                (3, "<"), (1, ">")])
def test_exif_rotated_jpeg_letterboxes_as_cv2_turns_it(tmp_path, orientation,
                                                       order):
    """cv2 applies EXIF orientation (libjpeg does not): scale and pads are
    those of a full cv2 decode of the file, the plane is reduced in that
    orientation, and the pixels keep the median bound against it."""
    jpeg = cv2.imencode(".jpg", _photo(np.random.default_rng(4), 256,
                                       448))[1].tobytes()
    path = str(tmp_path / f"exif{orientation}.jpg")
    with open(path, "wb") as f:
        f.write(_with_orientation(jpeg, orientation, order))
    full = jload_image(path)
    turned = orientation in (5, 6, 7, 8)
    assert full.shape[:2] == ((448, 256) if turned else (256, 448))
    assert loader.jpeg_dims(np.fromfile(path, np.uint8)) == full.shape[:2]
    d = loader.dct_reduction(*full.shape[:2], HIN, WIN)
    assert d > 1
    plane, dims = loader.decode(path, HIN, WIN)
    assert dims == full.shape[:2]
    assert plane.shape[:2] == (-(-dims[0] // d), -(-dims[1] // d))
    out, scale, pads = loader.load_image(path, HIN, WIN)
    ref, rscale, rpads = jletterbox(full, HIN, WIN)
    assert (scale, pads) == (rscale, rpads)
    assert np.median(np.abs(out.astype(int) - ref.astype(int))) <= 2


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
    """While recording: the workers' native scopes, the consumer's wait
    for each file and the unreadable file's count."""
    with GLOBAL_TRACER.recording() as rec:
        list(loader.StreamLoader(files, HIN, WIN, batch=4, workers=2,
                                 s2d=2))
    scopes = rec.summary()
    assert scopes["decode"][0] == len(files)     # the unreadable too
    assert scopes["resize"][0] == scopes["s2d2"][0] == len(files) - 1
    assert scopes["loader.wait"][0] == len(files)
    assert rec.counters == {"loader.skipped": 1}
    assert "s2d2" in rec.report()
