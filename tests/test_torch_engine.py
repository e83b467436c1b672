"""Port Engine vs the JAX Engine, and guards against hidden fallbacks.

- The port's `Engine.infer` on the same uint8 images with bridged params
  (tiny float32 MobileNet-thin) gives the JAX engine's skeletons.
- The port (and a tiny CPU infer through it) never imports jax, flax or
  the JAX package; `Engine` defaults to the card.
- `chip_smoke.py` without a GPU exits non-zero and prints no result.
"""

import dataclasses
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util

from openpose_plus_tpu.checkpoint import _flatten
from openpose_plus_tpu import config as jconfig
from openpose_plus_tpu.engine import Engine as JaxEngine
from openpose_plus_tpu_torch import config as tconfig
from openpose_plus_tpu_torch.engine import Engine, preprocess_images

import kernel_inputs

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tiny(dtype="float32", config=tconfig):
    """The tiny Config, the port's own or (config=jconfig) the JAX
    package's, from the same arguments."""
    cfg = config.default_config("mobilenet_thin")
    return cfg.replace(model=dataclasses.replace(
        cfg.model, hin=64, win=64, n_stages=2, compute_dtype=dtype))


_PAIR = {}


def _engines():
    """A JAX engine and a port engine on the same parameters. The random
    init's maps are ~1e-3, below the peak threshold, so the last stage's
    prediction kernels are scaled up until the decoder finds peaks and
    connections (conf up to ~0.7, paf ~5; humans of 3+ parts): the
    comparison then covers grouping too."""
    if not _PAIR:
        cfg = _tiny()
        flat = _flatten(jax.device_get(JaxEngine(_tiny(config=jconfig),
                                                 seed=3).params))
        for branch, gain in (("conf", 400.0), ("paf", 1000.0)):
            key = f"params/stages/stage2_{branch}/Conv_0/kernel"
            flat[key] = np.asarray(flat[key]) * gain
        nested = traverse_util.unflatten_dict(
            {tuple(k.split("/")): v for k, v in flat.items()})
        _PAIR["jax"] = JaxEngine(_tiny(config=jconfig), params=nested)
        _PAIR["torch"] = Engine(cfg, params=flat, device="cpu")
        _PAIR["cfg"] = cfg
    return _PAIR["jax"], _PAIR["torch"], _PAIR["cfg"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_infer_matches_jax_engine(seed):
    """Same uint8 images -> same humans: valid, n_parts and part sets
    exactly; coords and scores to float32 accumulation order (the maps
    agree to ~1e-7 relative)."""
    jax_engine, engine, cfg = _engines()
    images = np.random.default_rng(seed).integers(
        0, 256, (3, 64, 64, 3), dtype=np.uint8)
    ref = jax_engine.infer(images)
    out = engine.infer(images)
    for name in ("valid", "n_parts", "part_valid"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)
    np.testing.assert_allclose(out.coords.numpy(), np.asarray(ref.coords),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(out.part_scores.numpy(),
                               np.asarray(ref.part_scores), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(out.score.numpy(), np.asarray(ref.score),
                               rtol=0, atol=1e-5)
    conf, paf = engine.forward(images)
    jconf, jpaf = jax_engine.forward(images)
    assert conf.shape == (3, 8, 8, 19) and paf.shape == (3, 8, 8, 38)
    np.testing.assert_allclose(conf.numpy(), np.asarray(jconf), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(paf.numpy(), np.asarray(jpaf), rtol=0,
                               atol=1e-5)


def test_infer_finds_humans():
    """The scaled-head engine pair really exercises grouping."""
    _, engine, _ = _engines()
    images = np.random.default_rng(0).integers(
        0, 256, (3, 64, 64, 3), dtype=np.uint8)
    out = engine.infer(images)
    assert int(out.num_humans.sum()) >= 2
    humans = out.to_list(int(out.num_humans.argmax()))
    assert humans and all(len(h["parts"]) >= 3 for h in humans)


def test_chunked_infer_matches_unchunked():
    _, engine, cfg = _engines()
    chunked = Engine(cfg, params=engine.model.state_dict(), chunk=2,
                     device="cpu")
    images = np.random.default_rng(4).integers(
        0, 256, (4, 64, 64, 3), dtype=np.uint8)
    a, b = engine.infer(images), chunked.infer(images)
    for f in dataclasses.fields(a):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f.name
    assert chunked.infer(images[:1]).coords.shape[0] == 1


def test_preprocess_matches_jax():
    from openpose_plus_tpu.engine import preprocess_images as jax_pre

    images = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1)
    np.testing.assert_array_equal(
        preprocess_images(torch.from_numpy(images)).numpy(),
        np.asarray(jax_pre(images)))


def test_seeded_init_is_reproducible():
    cfg = _tiny("bfloat16")
    a, b = Engine(cfg, seed=5, device="cpu"), Engine(cfg, seed=5,
                                                     device="cpu")
    for (name, p), q in zip(a.model.state_dict().items(),
                            b.model.state_dict().values()):
        assert torch.equal(p, q), name
    images = np.zeros((1, 64, 64, 3), np.uint8)
    assert a.infer(images).coords.shape == (1, 32, 18, 2)


@pytest.mark.parametrize("call", ["calibrate", "mesh", "fast_init",
                                  "calibrate_from_paths", "compile",
                                  "build_decoder"])
def test_unported_paths_raise(call):
    """The reference's API on the port: `mesh=` takes a `DeviceMesh` (a
    gloo group of one here: the engine serves as without it; other types
    raise); `compile` on a CPU engine validates the layout as the
    reference does, runs one warm-up call and leaves `infer` unchanged (the
    CUDA-graph capture is the card's; tests/test_torch_cuda.py);
    `calibrate` and `calibrate_from_paths` are no-ops on a float engine, as
    in the reference; `fast_init` is accepted and changes nothing;
    `postproc.build_decoder` binds a config to `decode_maps`."""
    cfg = _tiny()
    images = np.random.default_rng(0).integers(0, 256, (1, 64, 64, 3),
                                               dtype=np.uint8)
    if call == "mesh":
        import torch.distributed as dist

        from openpose_plus_tpu_torch.parallel import sharding

        with pytest.raises(TypeError, match="DeviceMesh"):
            Engine(cfg, mesh=object(), device="cpu")
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
        try:
            mesh = sharding.build_mesh(cfg.parallel)
            a = Engine(cfg, seed=1, mesh=mesh, device="cpu").infer(images)
        finally:
            dist.destroy_process_group()
        b = Engine(cfg, seed=1, device="cpu").infer(images)
        for f in dataclasses.fields(a):
            assert torch.equal(getattr(a, f.name), getattr(b, f.name))
        return
    if call == "build_decoder":
        from openpose_plus_tpu_torch.postproc import build_decoder, decode_maps
        _, engine, _ = _engines()
        conf, paf = engine.forward(np.repeat(images, 2, axis=0))
        a = build_decoder(cfg.postproc)(conf, paf)
        b = decode_maps(conf, paf, cfg.postproc)
        for f in dataclasses.fields(a):
            assert torch.equal(getattr(a, f.name), getattr(b, f.name))
        return
    engine = Engine(cfg, device="cpu", fast_init=call == "fast_init")
    before = {k: v.clone() for k, v in engine.model.state_dict().items()}
    ref = engine.infer(images)
    if call == "fast_init":
        plain = Engine(cfg, device="cpu")
        for k, v in plain.model.state_dict().items():
            assert torch.equal(before[k], v), k
        return
    if call == "compile":
        with pytest.raises(ValueError, match="input_layout"):
            engine.compile(1, "nchw")
        odd = Engine(cfg.replace(model=dataclasses.replace(cfg.model,
                                                           hin=62)),
                     device="cpu")
        with pytest.raises(ValueError, match="not supported"):
            odd.compile(1, "s2d2")
        engine.compile(1, "s2d")
        engine.compile(1)
        assert engine._graphs == {}          # the CPU engine stays eager
    elif call == "calibrate":
        assert engine.calibrate(images) is None
    else:
        assert engine.calibrate_from_paths(["missing.jpg"]) is None
    for k, v in engine.model.state_dict().items():
        assert torch.equal(before[k], v), k
    out = engine.infer(images)
    for f in dataclasses.fields(out):
        assert torch.equal(getattr(out, f.name), getattr(ref, f.name))


def test_bad_input_raises():
    engine = Engine(_tiny(), device="cpu")
    with pytest.raises(ValueError):
        engine.infer(np.zeros((1, 32, 32, 3), np.uint8))
    with pytest.raises(ValueError):
        engine.infer(np.zeros((1, 64, 64, 3), np.float32))


def test_infer_spans_under_the_profiler():
    """A CPU `Engine.infer` under a torch.profiler session while the tracer
    records: `engine.infer`, `engine.inputs`, `engine.eager` and the decode
    stages are profiler events nested in the call, the spans carry the
    call's id, and the counters read one call, eager."""
    from torch.profiler import ProfilerActivity, profile

    from openpose_plus_tpu_torch.utils.tracer import GLOBAL_TRACER

    engine = Engine(_tiny(), device="cpu")
    images = np.zeros((1, 64, 64, 3), np.uint8)
    names = ("engine.infer", "engine.inputs", "engine.eager",
             "postproc.smooth", "postproc.peaks", "postproc.group")
    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            GLOBAL_TRACER.recording() as rec:
        engine.infer(images)
    events = {e.name: e.time_range for e in prof.events() if e.name in names}
    assert set(events) == set(names)
    call = events["engine.infer"]
    assert all(call.start <= r.start <= r.end <= call.end
               for r in events.values())
    assert rec.counters == {"engine.calls": 1, "engine.eager_calls": 1,
                            **kernel_inputs.bias_act_calls(engine.model)}
    assert {s.name for s in rec.spans} == set(names)
    assert len({s.call for s in rec.spans}) == 1
    assert rec.spans[0].call is not None and rec.device_ms() == {}


_NO_JAX = """
import dataclasses
import importlib
import os
import pkgutil
import sys
import tempfile

import cv2

import numpy as np
import torch

import chip_smoke
import openpose_plus_tpu_torch
from openpose_plus_tpu_torch import Engine, default_config
from openpose_plus_tpu_torch import (analyze_oracle_misses, ap_bench,
                                     ap_oracle, bench, checkpoint, cli, data,
                                     engine, eval_coco, export, host, loader,
                                     models, postproc, stream, synthetic_e2e,
                                     train, tune_fragment_merge)
from openpose_plus_tpu_torch.postproc import oracle as grouping_oracle
from openpose_plus_tpu_torch.parallel import kungfu, sharding
from openpose_plus_tpu_torch.utils import tracer, vis
from openpose_plus_tpu_torch.models import hao28, vgg19, vggtiny
from openpose_plus_tpu_torch.models.common import space_to_depth
from openpose_plus_tpu_torch.ops import cuda

for pkg in (cuda, data):    # no kernel is built
    for mod in pkgutil.iter_modules(pkg.__path__):
        importlib.import_module(f"{pkg.__name__}.{mod.name}")
cfg = default_config("mobilenet_thin")
cfg = cfg.replace(model=dataclasses.replace(
    cfg.model, hin=64, win=64, n_stages=2))
images = np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3),
                                           dtype=np.uint8)
engine = Engine(cfg, seed=0, device="cpu")
out = engine.infer(images)
assert out.coords.shape == (2, 32, 18, 2)
assert engine.infer(images, flip_tta=True).coords.shape == (2, 32, 18, 2)
out = engine.infer_multiscale(images, (0.5, 1.0), flip_tta=True,
                              combine="dedup")
assert out.coords.shape == (2, 64, 18, 2)
s2d2 = space_to_depth(space_to_depth(torch.from_numpy(images)))
quality = Engine(cfg.replace(postproc=cfg.postproc.quality()), seed=0,
                 device="cpu")
assert quality.infer(s2d2).coords.shape == (2, 32, 18, 2)
chain = bench.ChainedStep(engine, torch.from_numpy(images))
assert chain.run(1).shape == () and bench.program_cost(
    engine, chain.images)[0] > 0
frames = [np.zeros((40, 50, 3), np.uint8)] * 3
assert [r.n for r in stream.StreamEstimator(engine, batch=2).run_frames(
    frames)] == [2, 1]
with tempfile.TemporaryDirectory() as tmp:
    pngs = [os.path.join(tmp, f"{i}.png") for i in range(2)]
    for path, image in zip(pngs, images):
        cv2.imwrite(path, image)
    assert [r.indices.tolist() for r in stream.StreamEstimator(
        engine, batch=2).run_files(pngs)] == [[0, 1]]
conf, paf = engine.forward(images[:1])
assert isinstance(grouping_oracle.decode_oracle(
    conf[0].float().numpy(), paf[0].float().numpy(), cfg.postproc), list)
for name in ("vgg19", "vggtiny", "hao28"):
    zoo = default_config(name)
    zoo = zoo.replace(model=dataclasses.replace(
        zoo.model, hin=64, win=64, n_stages=2))
    assert Engine(zoo, seed=0, device="cpu").infer(
        images).coords.shape == (2, 32, 18, 2)
for name in ("mobilenet_thin", "vgg19", "vggtiny", "hao28"):
    q8 = default_config(name)
    q8 = q8.replace(model=dataclasses.replace(
        q8.model, hin=64, win=64, n_stages=2, compute_dtype="int8"))
    assert Engine(q8, seed=0, device="cpu").infer(
        images).coords.shape == (2, 32, 18, 2)
tcfg = cfg.replace(train=dataclasses.replace(cfg.train, batch_size=2))
state = train.create_train_state(tcfg, device="cpu")
kp = np.zeros((2, 1, 18, 3), np.float32)
kp[..., :2], kp[..., 2] = 30.0, 1.0
state, metrics = train.make_train_step_on_batch(tcfg)(state, {
    "images": images, "keypoints": kp,
    "mask": np.ones((2, 8, 8, 1), np.float32)})
assert np.isfinite(float(metrics["loss"])) and state.step == 1
(sma,) = kungfu.make_kungfu_steps(tcfg, None, "sma")
state, metrics = sma(state, {"images": images, "keypoints": kp,
                             "mask": np.ones((2, 8, 8, 1), np.float32)})
assert state.step == 2 and sharding.process_local_slice(4) == (0, 4)
oracle = ap_oracle.run_oracle("small", device="cpu", limit=8)
assert oracle["perfect"].ap == 1.0, oracle
assert all(0.0 <= r.ap <= 1.0 for r in oracle.values()), oracle
probe = ap_oracle.run_oracle("small", ("fidelity",), device="cpu", limit=8,
                             out_stride=4)
assert 0.0 < probe["fidelity"].ap <= 1.0, probe
cuda_modules = "openpose_plus_tpu_torch.ops.cuda."
print("CUDA_MODULES", sorted(m for m in sys.modules
                             if m.startswith(cuda_modules)))
print("DATA_MODULES", sorted(m for m in sys.modules
                             if m.startswith("openpose_plus_tpu_torch.data.")))
print("PORT_MODULES", sorted(m for m in sys.modules
                             if m.startswith("openpose_plus_tpu_torch.")))
bad = chip_smoke.foreign_modules()
print("FOREIGN_MODULES", bad)
sys.exit(1 if bad else 0)
"""


def test_port_never_imports_jax():
    """The card machine has no JAX, and the port keeps its own copies of
    what it needs: importing the port (engine, models and the zoo,
    postproc, eval_coco, ap_oracle, train, ap_bench, checkpoint, the
    deploy modules cli, export, host, stream and utils.tracer, the CUDA-
    graph capture (graphs), the loader
    and the grouping oracle, parallel's kungfu and sharding, the bench,
    every ops.cuda and data module), running CPU
    engines of every model through it (int8 engines too), a stream of
    frames and one of two PNG files, the numpy oracle, a train step, an sma
    step on a world of one, the GT-map oracle on 8 small-tier images and
    its stride-4 probe, and importing the studies (tune_fragment_merge,
    analyze_oracle_misses, synthetic_e2e) loads no module of jax, flax or
    the JAX package `openpose_plus_tpu`, by chip_smoke.py's own end-of-run
    check."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "FOREIGN_MODULES []" in proc.stdout
    for name in ("build", "dw_probe", "greedy", "int8_conv", "merge",
                 "paf_sample", "sepconv"):
        assert f"openpose_plus_tpu_torch.ops.cuda.{name}'" in proc.stdout
    for name in ("augment", "coco", "pipeline", "synthetic", "targets"):
        assert f"openpose_plus_tpu_torch.data.{name}'" in proc.stdout
    for name in ("train", "ap_bench", "checkpoint", "utils.vis", "cli",
                 "export", "host", "stream", "utils.tracer", "loader",
                 "postproc.oracle", "parallel.kungfu", "parallel.sharding",
                 "bench", "tune_fragment_merge", "analyze_oracle_misses",
                 "synthetic_e2e", "graphs"):
        assert f"openpose_plus_tpu_torch.{name}'" in proc.stdout


def test_foreign_module_check_sees_the_jax_package():
    """chip_smoke's check names jax, flax and any `openpose_plus_tpu`
    module, and never the port's own."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    assert chip_smoke.foreign_modules(
        ["openpose_plus_tpu", "openpose_plus_tpu.skeleton", "jax.numpy",
         "flax", "openpose_plus_tpu_torch", "openpose_plus_tpu_torch.config",
         "numpy"]) == ["flax", "jax.numpy", "openpose_plus_tpu",
                       "openpose_plus_tpu.skeleton"]


def test_engine_defaults_to_the_card():
    """Engine runs on the card unless asked for the CPU; without a CUDA
    device the default raises instead of carrying on on the CPU."""
    import inspect

    assert inspect.signature(Engine).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        assert Engine(_tiny()).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(_tiny())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(_tiny(), device="cuda:0")
    assert Engine(_tiny(), device="cpu").device == torch.device("cpu")


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_gpu(where, tmp_path):
    """chip_smoke.py must never report success without a card: no CPU
    fallback, and no success when run without the rest of the repo."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible; this guards the no-GPU case")
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if where == "alone":
        cwd = str(tmp_path)
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
