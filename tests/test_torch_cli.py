"""The port's CLI (`python -m openpose_plus_tpu_torch`) on the CPU, the
reference's cases (tests/test_cli.py) with `--device cpu`: infer, eval,
missing images, a large JPEG served as the loader decodes it
(DCT-scaled), export then `infer --engine-dir`, stream --video and
--images (once and looped), no stream input or no matching image; and what
the port adds or leaves to later items: `bench` runs on `--device cpu`,
`--engine-dir` refuses engine flags, an int8 export needs calibration images,
`--checkpoint` reads a train_loop checkpoint directory and an .npz alike.
Also the app helpers: the `Tracer` (off, recording, under the profiler),
`timeit` and `draw_humans` (pixel-equal to the JAX package's)."""

import dataclasses
import functools
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from openpose_plus_tpu_torch import cli

cv2 = pytest.importorskip("cv2")

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--model", "vggtiny", "--input-height", "64", "--input-width", "64",
        "--device", "cpu"]


@pytest.fixture
def images(tmp_path):
    rng = np.random.default_rng(0)
    paths = []
    for i in range(3):
        p = str(tmp_path / f"img{i}.jpg")
        cv2.imwrite(p, rng.integers(0, 255, (100, 140, 3), dtype=np.uint8))
        paths.append(p)
    return paths


def test_cli_infer(images, tmp_path, capsys):
    out_json = str(tmp_path / "out.json")
    draw_dir = str(tmp_path / "vis")
    rc = cli.main(["infer", *TINY, "--images", *images, "--batch", "2",
                   "--json-out", out_json, "--draw-dir", draw_dir])
    assert rc == 0
    data = json.load(open(out_json))
    assert [d["image"] for d in data] == images
    assert all(os.path.exists(os.path.join(draw_dir, os.path.basename(p)))
               for p in images)
    assert "humans" in capsys.readouterr().out


def test_cli_eval(images, tmp_path, capsys):
    anns = {"images": [], "annotations": []}
    for i, p in enumerate(images):
        anns["images"].append({"id": i, "file_name": os.path.basename(p),
                               "width": 140, "height": 100})
        anns["annotations"].append({
            "id": 10 + i, "image_id": i, "category_id": 1, "iscrowd": 0,
            "area": 2000.0,
            "keypoints": sum([[20 + 3 * k, 30 + 2 * k, 2]
                              for k in range(17)], []),
            "segmentation": [],
        })
    ann_path = str(tmp_path / "ann.json")
    json.dump(anns, open(ann_path, "w"))
    rc = cli.main(["eval", *TINY, "--annotations", ann_path, "--images",
                   str(tmp_path), "--batch", "2"])
    assert rc == 0
    assert "ap" in json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_infer_feeds_the_loaders_scaled_decode(tmp_path, monkeypatch):
    """A large JPEG reaches the engine as `loader.load_image` letterboxes
    it (decoded at 1/8, as the reference's native decode), bit for bit."""
    from openpose_plus_tpu_torch import loader
    from openpose_plus_tpu_torch.engine import Engine

    path = str(tmp_path / "photo.jpg")
    coarse = np.random.default_rng(1).integers(0, 256, (5, 7, 3), np.uint8)
    cv2.imwrite(path, cv2.resize(coarse, (700, 520),
                                 interpolation=cv2.INTER_CUBIC))
    assert loader.decode(path, 64, 64)[0].shape == (65, 88, 3)
    fed = []
    infer = Engine.infer
    monkeypatch.setattr(Engine, "infer", lambda self, images, **kw: (
        fed.append(np.array(images)) or infer(self, images, **kw)))
    assert cli.main(["infer", *TINY, "--images", path, "--batch", "1"]) == 0
    assert len(fed) == 1
    np.testing.assert_array_equal(fed[0][0],
                                  loader.load_image(path, 64, 64)[0])


def test_cli_missing_images(tmp_path):
    rc = cli.main(["infer", *TINY, "--images", str(tmp_path / "none*.jpg")])
    assert rc == 2


def test_cli_export_then_infer_from_artifact(images, tmp_path):
    """export -> torch.export dir -> infer --engine-dir gives the engine's
    own detections; engine flags beside --engine-dir are refused."""
    eng_dir = str(tmp_path / "engine")
    assert cli.main(["export", *TINY, "--out", eng_dir, "--batch", "2"]) == 0
    assert os.path.exists(os.path.join(eng_dir, "manifest.json"))
    art_json, own_json = str(tmp_path / "art.json"), str(tmp_path / "own.json")
    assert cli.main(["infer", "--images", *images, "--engine-dir", eng_dir,
                     "--json-out", art_json]) == 0
    assert cli.main(["infer", *TINY, "--images", *images, "--batch", "2",
                     "--json-out", own_json]) == 0
    assert json.load(open(art_json)) == json.load(open(own_json))
    for flag in (["--model", "vgg19"], ["--device", "cpu"], ["--int8"]):
        assert cli.main(["infer", "--images", *images, "--engine-dir",
                         eng_dir, *flag]) == 2


def test_cli_int8_export_needs_calibration_images(images, tmp_path):
    out = str(tmp_path / "q")
    assert cli.main(["export", *TINY, "--int8", "--out", out]) == 2
    assert not os.path.exists(out)
    assert cli.main(["export", *TINY, "--int8", "--out", out,
                     "--calib-images", *images[:2]]) == 0
    assert json.load(open(os.path.join(out, "manifest.json")))[
        "model_config"]["compute_dtype"] == "int8"


def test_cli_checkpoint_dir_and_npz_serve_the_same_weights(images,
                                                           tmp_path):
    from openpose_plus_tpu_torch import checkpoint, config, train

    cfg = config.default_config("vggtiny")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, hin=64, win=64))
    state = train.create_train_state(cfg, seed=7, device="cpu")
    checkpoint.save(str(tmp_path / "ckpt"), state, step=3)
    npz = checkpoint.save_npz(str(tmp_path / "w"), state.model.state_dict())
    outs = []
    for source in (str(tmp_path / "ckpt"), npz):
        outs.append(str(tmp_path / f"{len(outs)}.json"))
        assert cli.main(["infer", *TINY, "--images", *images, "--batch", "3",
                         "--checkpoint", source, "--json-out",
                         outs[-1]]) == 0
    assert json.load(open(outs[0])) == json.load(open(outs[1]))


def test_cli_stream_video(tmp_path, capsys):
    rng = np.random.default_rng(0)
    path = str(tmp_path / "clip.avi")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 5.0,
                             (120, 90))
    if not writer.isOpened():
        pytest.skip("no MJPG encoder in this cv2 build")
    for _ in range(5):
        writer.write(rng.integers(0, 255, (90, 120, 3), dtype=np.uint8))
    writer.release()
    rc = cli.main(["stream", *TINY, "--video", path, "--batch", "2"])
    assert rc == 0
    assert "3 frames in" in capsys.readouterr().out   # after the first batch


@pytest.mark.parametrize("loop", [False, True])
def test_cli_stream_images(images, loop, capsys):
    argv = ["stream", *TINY, "--images", *images, "--batch", "2"]
    if loop:
        argv += ["--loop", "--repeat", "3"]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    # after the warm-up batch: the tail of one image, or 3 looped batches
    assert f"{6 if loop else 1} frames in" in out
    assert "decode" in out and "s2d" in out           # the host scopes


@pytest.mark.parametrize("argv", [
    ["stream", *TINY],
    ["stream", *TINY, "--images", "a.jpg"],
])
def test_cli_paths_not_ported_return_2(argv, capsys):
    """No stream input and no image matching return 2."""
    assert cli.main(argv) == 2
    err = capsys.readouterr().err
    assert "no input images" in err and "item 11" not in err


def test_cli_bench_on_the_cpu(capsys, monkeypatch, tmp_path):
    """`bench` (`bench.table`) runs on the CPU on a tiny row and returns 0
    with the reference's headline line and the details file."""
    from openpose_plus_tpu_torch import bench

    # one valid slope sample: 70 calls of the plain decoder, not 160
    monkeypatch.setattr(bench, "table",
                        functools.partial(bench.table, repeats=1))
    monkeypatch.setattr(bench, "ROWS", (
        ("tiny_head", "mobilenet_thin", 64, 64, 1, "float32", 0),))
    monkeypatch.setenv("BENCH_DETAILS_PATH", str(tmp_path / "d.json"))
    assert cli.main(["bench", "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert list(line) == ["metric", "value", "unit", "vs_baseline",
                          "mfu_pct", "hbm_pct_est", "spread_pct"]
    assert line["metric"] == "tiny_head" and line["value"] > 0
    assert list(json.loads((tmp_path / "d.json").read_text())) == [
        "tiny_head"]


def test_cli_camera_that_does_not_open_returns_2(monkeypatch, capsys):
    class Closed:
        def __init__(self, index):
            self.index = index

        def isOpened(self):
            return False

    monkeypatch.setattr(cv2, "VideoCapture", Closed)
    assert cli.main(["camera", "--model", "vggtiny", "--device", "3",
                     "--torch-device", "cpu"]) == 2
    assert "cannot open camera 3" in capsys.readouterr().err


def test_module_entry_point_runs_the_cli():
    proc = subprocess.run([sys.executable, "-m", "openpose_plus_tpu_torch",
                           "stream", *TINY], cwd=REPO, capture_output=True,
                          text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 2 and "no input images" in proc.stderr


# -------------------------------------------------------- app helpers ---

def test_tracer_nests_scopes_per_thread():
    """While recording, each of 16 threads (a short switch interval) keeps
    its own spans: none is lost, and each inner span's parent is an outer
    span of its thread that holds it."""
    from openpose_plus_tpu_torch.utils.tracer import Tracer

    t = Tracer()

    def work():
        for _ in range(200):
            with t.scope("outer"):
                with t.scope("inner"):
                    t.count("inner")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with t.recording() as rec:
            threads = [threading.Thread(target=work) for _ in range(16)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert rec.summary().keys() == {"outer", "outer/inner"}
    assert rec.summary()["outer"][0] == rec.summary()["outer/inner"][0] \
        == 3200
    assert rec.counters == {"inner": 3200}
    for s in rec.spans:
        if s.name == "inner":
            p = rec.spans[s.parent]
            assert p.name == "outer" and p.thread == s.thread
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    lines = rec.report().splitlines()
    assert lines[1].startswith("outer") and lines[2].startswith("  inner")
    assert lines[3].startswith("counter") and lines[4].startswith("inner")
    with t.recording() as empty:
        pass
    assert empty.report().splitlines()[1:] == [] and t.last is empty


def test_tracer_off_records_nothing_and_takes_no_lock():
    """Off, a scope is the one shared null context and a count returns:
    no span, no counter, no thread registered, the lock never taken; a
    recording opened afterwards starts empty."""
    from openpose_plus_tpu_torch.utils import tracer

    class NoLock:
        def __enter__(self):
            raise AssertionError("the tracer took its lock while off")

        __exit__ = acquire = release = __enter__

    t = tracer.Tracer()
    t._lock = NoLock()
    assert t.scope("a") is tracer._NULL
    assert t.scope("a", call=True) is tracer._NULL
    assert t.scope("a", device=torch.device("cpu")) is tracer._NULL
    with t.scope("a"):
        t.count("n")
    assert getattr(t._local, "state", None) is None
    t._lock = threading.Lock()
    with t.recording() as rec:
        pass
    assert rec.spans == [] and rec.counters == {}


def test_tracer_spans_carry_parents_and_call_ids():
    """Spans under a call scope carry its id, a new call a new id, spans
    outside any call none; parents are indices into the spans; a recording
    inside a recording is refused."""
    from openpose_plus_tpu_torch.utils.tracer import Tracer

    t = Tracer()
    with t.recording() as rec:
        for inner in ("engine.inputs", "engine.replay"):
            with t.scope("engine.infer", call=True):
                with t.scope(inner):
                    t.count("engine.calls")
        with t.scope("resize"):
            pass
        with pytest.raises(RuntimeError):
            with t.recording():
                pass
    names = [s.name for s in rec.spans]
    assert names == ["engine.infer", "engine.inputs", "engine.infer",
                     "engine.replay", "resize"]
    a, a_in, b, b_in, free = rec.spans
    assert a.call is not None and b.call is not None and a.call != b.call
    assert (a_in.call, b_in.call, free.call) == (a.call, b.call, None)
    assert (a.parent, a_in.parent, b.parent, b_in.parent, free.parent) == \
        (None, 0, None, 2, None)
    assert rec.counters == {"engine.calls": 2}
    assert rec.mean_ms("engine.infer") >= rec.mean_ms("engine.replay") >= 0
    assert rec.mean_ms("engine.eager") is None and rec.device_ms() == {}


def test_timeit():
    from openpose_plus_tpu_torch.utils import tracer

    calls = []

    def fn(x):
        calls.append(1)
        return {"y": x * 2, "n": 1}

    seconds = tracer.timeit(fn, torch.ones(4), warmup=2, iters=5)
    assert len(calls) == 7 and seconds >= 0.0
    assert not hasattr(tracer, "trace_device")


def test_scopes_are_profiler_events():
    """Under a torch.profiler session the scopes are profiler events
    whether the tracer records or not, nested as they ran."""
    from torch.profiler import ProfilerActivity, profile

    from openpose_plus_tpu_torch.utils.tracer import Tracer

    t = Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with t.scope("outer"):
            with t.scope("inner", device=torch.device("cpu")):
                torch.ones(8).sum()
        with t.recording() as rec:
            with t.scope("recorded"):
                pass
    spans = {e.name: e for e in prof.events()
             if e.name in ("outer", "inner", "recorded")}
    assert set(spans) == {"outer", "inner", "recorded"}
    outer, inner = spans["outer"].time_range, spans["inner"].time_range
    assert outer.start <= inner.start <= inner.end <= outer.end
    assert [s.name for s in rec.spans] == ["recorded"]


def test_draw_humans_equals_the_jax_package():
    from openpose_plus_tpu.utils import vis as jvis
    from openpose_plus_tpu_torch.postproc import HumanBatch
    from openpose_plus_tpu_torch.utils import vis

    rng = np.random.default_rng(3)
    m = 4
    valid = torch.tensor([[True, False, True, False]])
    humans = HumanBatch(
        coords=torch.from_numpy(rng.random((1, m, 18, 2), np.float32)),
        part_scores=torch.ones(1, m, 18),
        part_valid=torch.from_numpy(rng.random((1, m, 18)) < 0.7),
        score=torch.ones(1, m), n_parts=torch.full((1, m), 12,
                                                   dtype=torch.int32),
        valid=valid)
    canvas = rng.integers(0, 60, (90, 120, 3), dtype=np.uint8)
    out = vis.draw_humans(canvas, humans, 0)
    assert out is not canvas and not np.array_equal(out, canvas)
    np.testing.assert_array_equal(out, jvis.draw_humans(canvas, humans, 0))
    empty = dataclasses.replace(humans, valid=torch.zeros_like(valid))
    np.testing.assert_array_equal(vis.draw_humans(canvas, empty, 0), canvas)
