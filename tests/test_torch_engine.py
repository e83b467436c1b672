"""Port Engine vs the JAX Engine, and guards against hidden fallbacks.

- The port's `Engine.infer` on the same uint8 images with bridged params
  (tiny float32 MobileNet-thin) gives the JAX engine's skeletons.
- The port (and a tiny CPU infer through it) never imports jax or flax.
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
from openpose_plus_tpu.config import default_config
from openpose_plus_tpu.engine import Engine as JaxEngine
from openpose_plus_tpu_torch.engine import Engine, preprocess_images

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tiny(dtype="float32"):
    cfg = default_config("mobilenet_thin")
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
        flat = _flatten(jax.device_get(JaxEngine(cfg, seed=3).params))
        for branch, gain in (("conf", 400.0), ("paf", 1000.0)):
            key = f"params/stages/stage2_{branch}/Conv_0/kernel"
            flat[key] = np.asarray(flat[key]) * gain
        nested = traverse_util.unflatten_dict(
            {tuple(k.split("/")): v for k, v in flat.items()})
        _PAIR["jax"] = JaxEngine(cfg, params=nested)
        _PAIR["torch"] = Engine(cfg, params=flat)
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
    chunked = Engine(cfg, params=engine.model.state_dict(), chunk=2)
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
    a, b = Engine(cfg, seed=5), Engine(cfg, seed=5)
    for (name, p), q in zip(a.model.state_dict().items(),
                            b.model.state_dict().values()):
        assert torch.equal(p, q), name
    images = np.zeros((1, 64, 64, 3), np.uint8)
    assert a.infer(images).coords.shape == (1, 32, 18, 2)


@pytest.mark.parametrize("call", ["flip_tta", "multiscale", "calibrate",
                                  "s2d", "mesh"])
def test_unported_paths_raise(call):
    cfg = _tiny()
    if call == "mesh":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Engine(cfg, mesh=object())
        return
    engine = Engine(cfg)
    images = np.zeros((1, 64, 64, 3), np.uint8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        if call == "flip_tta":
            engine.infer(images, flip_tta=True)
        elif call == "multiscale":
            engine.infer_multiscale(images)
        elif call == "calibrate":
            engine.calibrate(images)
        else:
            engine.infer(np.zeros((1, 32, 32, 12), np.uint8))


def test_bad_input_raises():
    engine = Engine(_tiny())
    with pytest.raises(ValueError):
        engine.infer(np.zeros((1, 32, 32, 3), np.uint8))
    with pytest.raises(ValueError):
        engine.infer(np.zeros((1, 64, 64, 3), np.float32))


_NO_JAX = """
import sys
import numpy as np
from openpose_plus_tpu_torch import Engine, default_config
import dataclasses
cfg = default_config("mobilenet_thin")
cfg = cfg.replace(model=dataclasses.replace(
    cfg.model, hin=64, win=64, n_stages=2))
out = Engine(cfg, seed=0).infer(np.zeros((2, 64, 64, 3), np.uint8))
assert out.coords.shape == (2, 32, 18, 2)
import openpose_plus_tpu_torch.ops.cuda.build  # noqa: F401  (no build)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax"))
print("JAX_MODULES", bad)
sys.exit(1 if bad else 0)
"""


def test_port_never_imports_jax():
    """The card machine has no JAX: the port and a CPU infer through it
    must not import jax or flax."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "JAX_MODULES []" in proc.stdout


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
