"""Checkpoints in the JAX package's npz layout into the port, on the CPU:
the legacy ConvRelu layout (a conv's kernel and bias under an nn.Conv child
'Conv_0', from before the reference flattened ConvRelu) loads for every
backbone as the reference's `checkpoint.load_npz` loads it
(tests/test_train.py::test_npz_legacy_convrelu_layout): the port's weights
equal the JAX ones exactly. The port keeps the reference's errors: KeyError
for a missing parameter, ValueError for a wrong shape, an extra entry
ignored. `infer --checkpoint legacy.npz` serves what the current layout
serves."""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpose_plus_tpu import checkpoint as jckpt
from openpose_plus_tpu.config import default_config as jax_default_config
from openpose_plus_tpu.models import get_model as jax_model
from openpose_plus_tpu_torch import checkpoint, cli
from openpose_plus_tpu_torch import config as tconfig
from openpose_plus_tpu_torch.engine import Engine

torch.set_num_threads(2)

MODELS = ("mobilenet_thin", "vgg19", "vggtiny", "hao28")
KW = dict(hin=64, win=64, n_stages=2, compute_dtype="float32")


@functools.lru_cache(maxsize=None)
def _jax_params(name, n_stages=KW["n_stages"]):
    """JAX-initialized parameters of a tiny model (seeded): the nested
    tree and its flat 'params/...' dict."""
    cfg = dataclasses.replace(jax_default_config(name).model,
                              **{**KW, "n_stages": n_stages})
    x = jnp.zeros((1, KW["hin"], KW["win"], 3), jnp.float32)
    params = jax.device_get(jax.jit(jax_model(cfg).init)(
        jax.random.PRNGKey(5), x))
    return params, jckpt._flatten(params)


def _port_config(name):
    cfg = tconfig.default_config(name)
    return cfg.replace(model=dataclasses.replace(cfg.model, **KW))


def _legacy(flat):
    """The legacy layout, renamed as tests/test_train.py renames it."""
    out = {}
    for key, value in flat.items():
        parts = key.split("/")
        if parts[-1] in ("kernel", "bias") and "ConvRelu" in parts[-2]:
            key = "/".join(parts[:-1] + ["Conv_0", parts[-1]])
        out[key] = value
    return out


@pytest.mark.parametrize("name", MODELS)
def test_legacy_npz_loads_as_the_reference_loads_it(name, tmp_path):
    params, flat = _jax_params(name)
    legacy = _legacy(flat)
    renamed = set(legacy) - set(flat)
    assert renamed and all("/ConvRelu_" in k for k in renamed)
    # the heads' own Conv_0 is a current name, kept as it is
    assert any(k.endswith("stage2_conf/Conv_0/kernel") for k in legacy)
    path = str(tmp_path / "legacy.npz")
    np.savez(path, **legacy)
    ref = jckpt._flatten(jckpt.load_npz(path, params))
    engine = Engine(_port_config(name), params=checkpoint.load_npz(path),
                    device="cpu")
    out = checkpoint.to_flax(engine.model.state_dict())
    assert out.keys() == ref.keys() == flat.keys()
    for key in ref:
        np.testing.assert_array_equal(out[key], ref[key], key)
        np.testing.assert_array_equal(out[key], flat[key], key)


def test_load_keeps_the_reference_errors(tmp_path):
    """A missing parameter raises KeyError and a wrong shape ValueError in
    both packages; an entry the model lacks is ignored by both."""
    params, flat = _jax_params("mobilenet_thin")
    like = Engine(_port_config("mobilenet_thin"), device="cpu"
                  ).model.state_dict()
    kernel = "params/stages/stage1_conf/ConvRelu_0/kernel"
    missing = {k: v for k, v in flat.items() if k != kernel}
    wrong = {**flat, kernel: np.zeros((1, 1, 3, 3), np.float32)}
    extra = {**_legacy(flat), "params/conv9/kernel": np.zeros((2,)),
             "batch_stats/conv1/mean": np.zeros((3,))}
    for case, error in ((missing, KeyError), (wrong, ValueError),
                        (extra, None)):
        path = str(tmp_path / "case.npz")
        np.savez(path, **case)
        if error is None:
            jckpt.load_npz(path, params)
            state = checkpoint.from_flax(checkpoint.load_npz(path), like=like)
            assert state.keys() == like.keys()
            continue
        with pytest.raises(error, match=kernel):
            jckpt.load_npz(path, params)
        with pytest.raises(error, match=kernel):
            checkpoint.from_flax(checkpoint.load_npz(path), like=like)
        with pytest.raises(error, match=kernel):
            Engine(_port_config("mobilenet_thin"),
                   params=checkpoint.load_npz(path), device="cpu")


def test_int8_engine_loads_a_legacy_float_npz():
    """A float checkpoint without calib scales serves an int8 engine: its
    scales stay zero until calibrated, as with the current layout."""
    _, flat = _jax_params("mobilenet_thin")
    cfg = _port_config("mobilenet_thin")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                compute_dtype="int8"))
    legacy = Engine(cfg, params=_legacy(flat), device="cpu")
    current = Engine(cfg, params=flat, device="cpu")
    a, b = legacy.model.state_dict(), current.model.state_dict()
    assert a.keys() == b.keys()
    for key in a:
        torch.testing.assert_close(a[key], b[key], rtol=0, atol=0)


def test_cli_serves_a_legacy_npz(tmp_path):
    import cv2

    # the CLI builds the model's default depth
    _, flat = _jax_params("vggtiny",
                          tconfig.default_config("vggtiny").model.n_stages)
    rng = np.random.default_rng(0)
    image = str(tmp_path / "img.jpg")
    cv2.imwrite(image, rng.integers(0, 255, (100, 140, 3), dtype=np.uint8))
    outs = []
    for name, layout in (("current", flat), ("legacy", _legacy(flat))):
        path = str(tmp_path / f"{name}.npz")
        np.savez(path, **layout)
        outs.append(str(tmp_path / f"{name}.json"))
        assert cli.main(["infer", "--model", "vggtiny", "--input-height",
                         "64", "--input-width", "64", "--device", "cpu",
                         "--images", image, "--batch", "1", "--checkpoint",
                         path, "--json-out", outs[-1]]) == 0
    assert json.load(open(outs[0])) == json.load(open(outs[1]))
