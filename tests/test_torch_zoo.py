"""The rest of the zoo on the port (VGG19, VGG-tiny, hao28) vs the JAX
models, with bridged parameters, and the registry's names.

The JAX models run their conv1 block on the space-to-depth grid when
`stem_s2d` is set; the port runs the plain convolutions. The two are the
same math: in float32 they agree to accumulation order, in bfloat16 to
bf16 rounding. Tolerances are relative to the largest magnitude of the
reference map, as in tests/test_torch_models.py (float32 observed <= 4e-6,
bfloat16 <= 1.1e-2 over the 13-18 dense layers of these models).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpose_plus_tpu.checkpoint import _flatten
from openpose_plus_tpu.config import default_config
from openpose_plus_tpu.engine import Engine as JaxEngine
from openpose_plus_tpu.models import get_model as jax_model
from openpose_plus_tpu.models import model_names as jax_model_names
from openpose_plus_tpu_torch import config as tconfig
from openpose_plus_tpu_torch.checkpoint import from_flax
from openpose_plus_tpu_torch.engine import Engine
from openpose_plus_tpu_torch.models import common, get_model as torch_model
from openpose_plus_tpu_torch.models import model_names

torch.set_num_threads(2)

ZOO = ("vgg19", "vggtiny", "hao28")
REL_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# (backbone feature channels, stage-1 projection, refine kernel, refine
# convs) of each model
PLAN = {"vgg19": (128, 512, 7, 5), "vggtiny": (128, 512, 3, 5),
        "hao28": (128, 256, 3, 3)}

_OUT_CACHE = {}


def _kw(dtype, stem_s2d):
    return dict(hin=64, win=64, n_stages=2, compute_dtype=dtype,
                stem_s2d=stem_s2d)


def _outputs(name, dtype, stem_s2d):
    """JAX and port outputs of one model on the same input and weights."""
    key = (name, dtype, stem_s2d)
    if key not in _OUT_CACHE:
        kw = _kw(dtype, stem_s2d)
        cfg = dataclasses.replace(default_config(name).model, **kw)
        x = np.random.default_rng(0).uniform(
            -0.5, 0.5, (2, 64, 64, 3)).astype(np.float32)
        jm = jax_model(cfg)
        params = jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.asarray(x))
        ref = jax.tree.map(lambda a: np.asarray(a, np.float32),
                           jax.jit(jm.apply)(params, jnp.asarray(x)))
        tm = torch_model(dataclasses.replace(
            tconfig.default_config(name).model, **kw))
        tm.load_state_dict(from_flax(_flatten(jax.device_get(params))),
                           strict=True)
        with torch.no_grad():
            out = tm(torch.from_numpy(x))
        out = jax.tree.map(lambda t: t.float().numpy(), out)
        _OUT_CACHE[key] = (ref, out)
    return _OUT_CACHE[key]


@pytest.mark.parametrize("dtype,stem_s2d", [
    ("float32", True), ("float32", False), ("bfloat16", True),
    ("bfloat16", False)])
@pytest.mark.parametrize("stage", [0, 1])
@pytest.mark.parametrize("name", ZOO)
def test_stage_maps_match_jax(name, dtype, stem_s2d, stage):
    ref, out = _outputs(name, dtype, stem_s2d)
    for key, channels in (("conf", 19), ("paf", 38)):
        a, b = ref[key][stage], out[key][stage]
        assert a.shape == b.shape == (2, 8, 8, channels)
        assert b.dtype == np.float32
        err = np.abs(a - b).max()
        assert err <= REL_TOL[dtype] * np.abs(a).max(), (key, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ZOO)
def test_feature_map_matches_jax(name, dtype):
    ref, out = _outputs(name, dtype, True)
    a, b = ref["feature"], out["feature"]
    assert a.shape == b.shape == (2, 8, 8, PLAN[name][0])
    assert np.abs(a - b).max() <= REL_TOL[dtype] * np.abs(a).max()


@pytest.mark.parametrize("name", ZOO)
def test_dense_head_structure(name):
    """The dense branch as Flax names it: n kxk ConvRelu_0..n-1, the
    projection ConvRelu_n, the float32 Conv_0; stage 2 reads F + 19 + 38
    channels (185 on VGG19)."""
    feat, proj, kernel, n = PLAN[name]
    model = torch_model(tconfig.default_config(name).model)
    s1, s2 = model.stages.stage1_paf, model.stages.stage2_conf
    assert s1.ConvRelu_3.weight.shape == (proj, 128, 1, 1)
    assert [c for c, _ in s2.named_children()] == [
        *(f"ConvRelu_{i}" for i in range(n + 1)), "Conv_0"]
    assert s2.ConvRelu_0.weight.shape == (128, feat + 19 + 38, kernel, kernel)
    assert s2.Conv_0.weight.shape == (19, 128, 1, 1)
    assert not any(isinstance(m, common.SepConvRelu)
                   for m in model.modules())


def test_model_names_match_reference():
    """The JAX package's names, and the port's one name of its own
    (OpenPose's BODY_25, which the JAX package does not have)."""
    assert model_names() == sorted([*jax_model_names(),
                                    *tconfig.PORT_ONLY_MODELS])
    assert list(tconfig.PORT_ONLY_MODELS) == ["body25"]


@pytest.mark.parametrize("alias,name", [
    ("vgg", "vgg19"), ("hao28_experimental", "hao28"),
    ("mobilenet", "mobilenet_thin")])
def test_aliases_build_the_same_model(alias, name):
    def build(n):
        return torch_model(dataclasses.replace(
            tconfig.default_config(n).model, hin=64, win=64, n_stages=2))

    a, b = build(alias), build(name)
    assert type(a) is type(b)
    assert ({k: v.shape for k, v in a.state_dict().items()}
            == {k: v.shape for k, v in b.state_dict().items()})


@pytest.mark.parametrize("name", ZOO)
def test_input_layouts(name):
    """The s2d layout (12 channels) gives the plain image's maps exactly;
    s2d^2 is rejected by the model and by `check_input_layout`, and an s2d
    input needs `stem_s2d`, as in the JAX models."""
    cfg = dataclasses.replace(tconfig.default_config(name).model, hin=64,
                              win=64, n_stages=2, compute_dtype="float32")
    model = torch_model(cfg)
    common.init_params(model, torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        -0.5, 0.5, (1, 64, 64, 3)).astype(np.float32))
    with torch.no_grad():
        a, b = model(x), model(common.space_to_depth(x))
        for key in ("conf", "paf"):
            assert torch.equal(a[key][-1], b[key][-1])
        with pytest.raises(ValueError):
            model(common.space_to_depth(common.space_to_depth(x)))
    assert cfg.preferred_input_layout() == 1
    plain = torch_model(dataclasses.replace(cfg, stem_s2d=False))
    with torch.no_grad(), pytest.raises(ValueError, match="stem_s2d"):
        plain(common.space_to_depth(x))
    engine = Engine(tconfig.Config(model=cfg), seed=0, device="cpu")
    with pytest.raises(ValueError, match="input_layout"):
        engine.infer(common.space_to_depth(common.space_to_depth(
            torch.zeros((1, 64, 64, 3), dtype=torch.uint8))))


def test_int8_zoo_raises():
    """The zoo builds in int8 (an inference mode) and raises where the
    reference does: training it, and an unknown compute dtype."""
    from openpose_plus_tpu_torch.train import create_train_state

    cfg = tconfig.default_config("vgg19")
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, hin=64, win=64, n_stages=2, compute_dtype="int8"))
    model = torch_model(cfg.model)
    assert model.conv1_1.int8 and hasattr(model.stages, "stage2_in_scale")
    with pytest.raises(ValueError, match="int8"):
        create_train_state(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="compute_dtype"):
        torch_model(dataclasses.replace(cfg.model, compute_dtype="int4"))


def test_vggtiny_engine_matches_jax_engine():
    """A VGG-tiny engine end to end (tiny, float32, heads scaled so random
    weights give humans): the port's skeletons equal the JAX engine's on
    the same weights and uint8 images, plain and s2d input."""
    from flax import traverse_util

    kw = dict(hin=64, win=64, n_stages=2, compute_dtype="float32")
    jcfg = default_config("vggtiny")
    jcfg = jcfg.replace(model=dataclasses.replace(jcfg.model, **kw))
    tcfg = tconfig.default_config("vggtiny")
    tcfg = tcfg.replace(model=dataclasses.replace(tcfg.model, **kw))
    flat = _flatten(jax.device_get(JaxEngine(jcfg, seed=3).params))
    for branch, gain in (("conf", 300.0), ("paf", 800.0)):
        key = f"params/stages/stage2_{branch}/Conv_0/kernel"
        flat[key] = np.asarray(flat[key]) * gain
    nested = traverse_util.unflatten_dict(
        {tuple(k.split("/")): v for k, v in flat.items()})
    jax_engine = JaxEngine(jcfg, params=nested)
    engine = Engine(tcfg, params=flat, device="cpu")
    images = np.random.default_rng(5).integers(0, 256, (3, 64, 64, 3),
                                               dtype=np.uint8)
    ref = jax_engine.infer(images)
    out = engine.infer(images)
    assert int(out.num_humans.sum()) >= 2
    for name in ("valid", "n_parts", "part_valid"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)
    for name in ("coords", "part_scores", "score"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)), rtol=0,
                                   atol=1e-5, err_msg=name)
    s2d = engine.infer(common.space_to_depth(torch.from_numpy(images)))
    for f in dataclasses.fields(out):
        assert torch.equal(getattr(out, f.name), getattr(s2d, f.name))
