"""Port MobileNet-thin forward vs the JAX model, with bridged parameters.

The JAX model lowers its stem through space-to-depth on mod-4 inputs (the
deep tier); the port runs the plain convolutions. The two are the same math:
in float32 they agree to accumulation order, in bfloat16 to bf16 rounding.
Tolerances are relative to the largest magnitude of the reference map.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpose_plus_tpu.checkpoint import _flatten
from openpose_plus_tpu.config import default_config
from openpose_plus_tpu.models import get_model as jax_model
from openpose_plus_tpu_torch.checkpoint import from_flax, to_flax
from openpose_plus_tpu_torch.config import default_config as tdefault_config
from openpose_plus_tpu_torch.models import common, get_model as torch_model

torch.set_num_threads(2)

# float32: same products, another summation order (XLA's s2d block-grid
# contraction vs oneDNN's direct conv) through ~30 layers -> ~1e-6 relative
# (observed <= 6e-7). bfloat16: each layer rounds to 8 mantissa bits
# (2^-8 = 3.9e-3) at possibly different places -> a few bf16 ulps
# (observed <= 3e-3).
REL_TOL = {"float32": 1e-5, "bfloat16": 2e-2}

_OUT_CACHE = {}


def _outputs(dtype, stem_s2d):
    key = (dtype, stem_s2d)
    if key not in _OUT_CACHE:
        kw = dict(hin=64, win=64, n_stages=2, compute_dtype=dtype,
                  stem_s2d=stem_s2d)
        cfg = dataclasses.replace(default_config("mobilenet_thin").model,
                                  **kw)
        x = np.random.default_rng(0).uniform(
            -0.5, 0.5, (2, 64, 64, 3)).astype(np.float32)
        jm = jax_model(cfg)
        params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
        ref = jax.tree.map(lambda a: np.asarray(a, np.float32),
                           jm.apply(params, jnp.asarray(x)))
        tm = torch_model(dataclasses.replace(
            tdefault_config("mobilenet_thin").model, **kw))
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
def test_stage_maps_match_jax(dtype, stem_s2d, stage):
    ref, out = _outputs(dtype, stem_s2d)
    for name, channels in (("conf", 19), ("paf", 38)):
        a, b = ref[name][stage], out[name][stage]
        assert a.shape == b.shape == (2, 8, 8, channels)
        assert b.dtype == np.float32
        err = np.abs(a - b).max()
        assert err <= REL_TOL[dtype] * np.abs(a).max(), (name, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_feature_map_matches_jax(dtype):
    ref, out = _outputs(dtype, True)
    a, b = ref["feature"], out["feature"]
    assert a.shape == b.shape == (2, 8, 8, 96 + 384)   # pooled s4 + dw9
    assert np.abs(a - b).max() <= REL_TOL[dtype] * np.abs(a).max()


@pytest.mark.parametrize("size,kernel,stride", [
    (7, 3, 2), (8, 3, 2), (9, 3, 2), (6, 3, 1), (5, 3, 1), (11, 1, 1),
    (13, 3, 2), (4, 1, 2)])
@pytest.mark.parametrize("depthwise", [False, True])
def test_conv2d_same_matches_xla(size, kernel, stride, depthwise):
    """TF "SAME" puts the extra pad pixel at the high end ((0, 1) for a 3x3
    stride-2 conv on even sizes, where torch padding=1 pads (1, 1)); the
    helper must equal XLA's SAME on odd and even sizes alike."""
    rng = np.random.default_rng(size * 10 + kernel + stride)
    c, f = 4, (4 if depthwise else 5)
    x = rng.standard_normal((2, size, size + 1, c)).astype(np.float32)
    w = rng.standard_normal(
        (kernel, kernel, 1 if depthwise else c, f)).astype(np.float32)
    ref = jax.lax.conv_general_dilated(
        x, w, (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=c if depthwise else 1,
        precision=jax.lax.Precision.HIGHEST)
    out = common.conv2d_same(
        torch.from_numpy(x).permute(0, 3, 1, 2),
        torch.from_numpy(w).permute(3, 2, 0, 1), stride,
        groups=c if depthwise else 1).permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    pads = jax.lax.padtype_to_pads((size,), (kernel,), (stride,), "SAME")
    assert common.same_padding(size, kernel, stride) == tuple(pads[0])


@pytest.mark.parametrize("name", ["vgg19", "vgg", "vggtiny", "hao28",
                                  "hao28_experimental", "nonexistent"])
def test_unported_models_raise(name):
    """Every name of the zoo builds and has the reference's parameter tree
    (keys and shapes, tiny size); an unknown name raises ValueError, as
    the reference's registry does."""
    if name == "nonexistent":
        with pytest.raises(ValueError, match="unknown model"):
            torch_model(dataclasses.replace(tdefault_config().model,
                                            name=name))
        return
    kw = dict(hin=64, win=64, n_stages=2)
    cfg = dataclasses.replace(default_config(name).model, **kw)
    shapes = jax.eval_shape(lambda: jax_model(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.float32)))
    leaves, _ = jax.tree_util.tree_flatten_with_path(shapes)
    ref = {"/".join(p.key for p in path): tuple(leaf.shape)
           for path, leaf in leaves}
    model = torch_model(dataclasses.replace(tdefault_config(name).model,
                                            **kw))
    flax_shapes = {k: tuple(v.shape) for k, v in to_flax(
        model.state_dict()).items()}
    assert flax_shapes == ref


@pytest.mark.parametrize("name", ["mobilenet_thin", "vgg19", "vggtiny",
                                  "hao28"])
def test_every_model_builds_in_int8(name):
    """int8 is a compute mode of every registry model: bf16 between the
    convs, one int8 layer per ConvRelu / SepConvRelu with its two calib
    scales, the stage-input scales on dense heads only, and the same
    parameters as the float model."""
    kw = dict(hin=64, win=64, n_stages=3)
    cfg = dataclasses.replace(tdefault_config(name).model, **kw)
    model = torch_model(dataclasses.replace(cfg, compute_dtype="int8"))
    layers = [m for m in model.modules()
              if isinstance(m, (common.ConvRelu, common.SepConvRelu))]
    assert layers and all(m.int8 and m.dtype == torch.bfloat16
                          for m in layers)
    buffers = dict(model.named_buffers())
    assert len(buffers) == 2 * len(layers) + (
        0 if name == "mobilenet_thin" else 2)
    assert ("stages.stage3_in_scale" in buffers) == (name != "mobilenet_thin")
    assert [k for k, _ in model.named_parameters()] == [
        k for k, _ in torch_model(cfg).named_parameters()]
    assert not dict(torch_model(cfg).named_buffers())


def test_random_init_statistics_follow_flax():
    """Seeded init: lecun-normal kernels (std 1/sqrt(fan_in) after the
    truncation correction, |w| <= 2 sigma), zero biases, reproducible."""
    cfg = tdefault_config("mobilenet_thin").model
    a, b = torch_model(cfg), torch_model(cfg)
    common.init_params(a, torch.Generator().manual_seed(0))
    common.init_params(b, torch.Generator().manual_seed(0))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
        if name.endswith("bias"):
            assert not p.any(), name
    w = a.dw9.pw_weight.detach()               # fan_in 384, 147k values
    sigma = (1.0 / w[0].numel()) ** 0.5 / 0.87962566103423978
    assert float(w.abs().max()) <= 2 * sigma
    assert abs(float(w.std()) / (1.0 / w[0].numel()) ** 0.5 - 1) < 0.02


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_fused_inference_routes_the_marked_layers(dtype, monkeypatch):
    """`fused_inference=True` sends exactly the layers the JAX model marks
    `fused` (dw5-dw9 and every stage SepConvRelu) through
    `ops.cuda.sepconv.fused_sepconv`, never dw1-dw4; in float32 the flag
    changes nothing, as in JAX. (The port used to ignore the flag.)"""
    from openpose_plus_tpu_torch.ops.cuda import sepconv

    cfg = dataclasses.replace(
        tdefault_config("mobilenet_thin").model, hin=64, win=64, n_stages=2,
        compute_dtype=dtype, fused_inference=True)
    model = torch_model(cfg)
    common.init_params(model, torch.Generator().manual_seed(0))
    current, calls = [None], []
    for name, module in model.named_modules():
        if isinstance(module, common.SepConvRelu):
            module.register_forward_pre_hook(
                lambda m, args, name=name: current.__setitem__(0, name))
    real = sepconv.fused_sepconv

    def spy(*args, **kwargs):
        calls.append(current[0])
        return real(*args, **kwargs)

    monkeypatch.setattr(sepconv, "fused_sepconv", spy)
    x = np.random.default_rng(0).uniform(-0.5, 0.5, (1, 64, 64, 3))
    with torch.no_grad():
        model(torch.from_numpy(x.astype(np.float32)))
    marked = [f"dw{i}" for i in range(5, 10)] + [
        f"stages.stage{s}_{branch}.SepConvRelu_{i}" for s in (1, 2)
        for branch in ("conf", "paf") for i in range(3)]
    assert calls == (marked if dtype == "bfloat16" else [])

    full = torch_model(dataclasses.replace(
        tdefault_config("mobilenet_thin").model, compute_dtype=dtype,
        fused_inference=True))
    n_fused = sum(m.fused for m in full.modules()
                  if isinstance(m, common.SepConvRelu))
    assert n_fused == (41 if dtype == "bfloat16" else 0)
