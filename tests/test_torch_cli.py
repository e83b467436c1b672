"""The port's CLI (`python -m openpose_plus_tpu_torch`) on the CPU, the
reference's cases (tests/test_cli.py) with `--device cpu`: infer, eval,
missing images, export then `infer --engine-dir`, stream --video and
--images (once and looped), no stream input or no matching image; and what
the port adds or leaves to later items: `bench` returns 2, `--engine-dir`
refuses engine flags, an int8 export needs calibration images,
`--checkpoint` reads a train_loop checkpoint directory and an .npz alike.
Also the app helpers: the `Tracer`, `timeit`, `trace_device` and
`draw_humans` (pixel-equal to the JAX package's)."""

import dataclasses
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
    ["bench"],
])
def test_cli_paths_not_ported_return_2(argv, capsys):
    """No stream input, no image matching, and the unported bench."""
    assert cli.main(argv) == 2
    err = capsys.readouterr().err
    if argv[0] == "stream":
        assert "no input images" in err and "item 11" not in err
    if argv == ["bench"]:
        assert "item 8" in err


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
                           "bench"], cwd=REPO, capture_output=True,
                          text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 2 and "item 8" in proc.stderr


# -------------------------------------------------------- app helpers ---

def test_tracer_nests_scopes_per_thread():
    """Threads share the scope nodes: no update is lost (16 threads, a
    short switch interval)."""
    from openpose_plus_tpu_torch.utils.tracer import Tracer

    t = Tracer()

    def work():
        for _ in range(200):
            with t.scope("outer"):
                with t.scope("inner"):
                    pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    outer = t._root.children["outer"]
    assert outer.calls == 3200 and outer.children["inner"].calls == 3200
    lines = t.report().splitlines()
    assert lines[1].startswith("outer") and lines[2].startswith("  inner")
    t.reset()
    assert t.report().splitlines()[1:] == []


def test_timeit_and_trace_device(tmp_path):
    from openpose_plus_tpu_torch.utils import tracer

    calls = []

    def fn(x):
        calls.append(1)
        return {"y": x * 2, "n": 1}

    seconds = tracer.timeit(fn, torch.ones(4), warmup=2, iters=5)
    assert len(calls) == 7 and seconds >= 0.0
    with tracer.trace_device(str(tmp_path / "trace")):
        torch.ones(8).sum()
    trace = json.load(open(tmp_path / "trace" / tracer.TRACE_FILE))
    assert trace["traceEvents"]


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
