"""Calibrated int8 serving on the port vs the JAX package's int8 mode.

The same seeded numpy inputs go through `openpose_plus_tpu.models.common`
(`quantize_weight`, `quantize_act`, `dequant`, `_int8_conv` in ConvRelu
and SepConvRelu, the models and the Engine) and their counterparts in
`openpose_plus_tpu_torch` (the plain versions of `ops.cuda.int8_conv` on
the CPU).

Exactness. The reference's quantized layer, run op by op (JAX's eager
mode, the function as written), is bit-equal to the port's: the int32
sums are exact and every float32 step is the same correctly rounded
operation. Under `jax.jit` XLA on the CPU contracts `acc * rescale +
bias` into an FMA and turns `s / (127 * 127)` into a multiply by the
rounded reciprocal (both checked below), so the jitted layer may land one
int8 unit (or one bf16 ulp) away on a few elements: at most 1 unit on at
most 0.1% of them. Whole models are held to the reference applied op by
op (its float32 prediction 1x1s sum in another order than oneDNN's, so
to a stated share of the map scale) with equal decoded humans, and more
loosely to the jitted JAX engine, whose one-unit moves the int8 chain
carries forward.
"""

import dataclasses
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from openpose_plus_tpu.checkpoint import _flatten
from openpose_plus_tpu.config import default_config
from openpose_plus_tpu.engine import Engine as JaxEngine
from openpose_plus_tpu.models import common as jcommon
from openpose_plus_tpu_torch import config as tconfig
from openpose_plus_tpu_torch.checkpoint import from_flax, to_flax
from openpose_plus_tpu_torch.engine import Engine
from openpose_plus_tpu_torch.models import common, get_model
from openpose_plus_tpu_torch.ops.cuda import int8_conv

torch.set_num_threads(2)

# final maps as a share of the map scale: against the reference applied op
# by op (the float32 prediction 1x1s sum in another order: observed
# <= 6e-7), and against the jitted JAX engine (FMA contraction, module
# docstring: observed <= 6e-2 between the reference's own eager and jitted
# maps)
MAP_TOL = 1e-5
JIT_TOL = 0.15


def _bits(x) -> np.ndarray:
    """bf16 / int8 / float32 values as comparable numpy arrays."""
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16
                else x).numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype == jnp.bfloat16 else x


# -------------------------------------------------- quantization helpers ---

def _ties(n: int = 254) -> np.ndarray:
    """Values t with fl(t * 127) exactly n + 0.5 for most of n in
    [-127, 126]: round-half-to-even decides their int8."""
    return (np.arange(-127, 127, dtype=np.float64) * 2 + 1).astype(
        np.float32)[:n] / np.float32(254.0)


def test_quantize_weight_matches_jax():
    rng = np.random.default_rng(0)
    k = rng.normal(0, 0.2, (3, 3, 16, 8)).astype(np.float32)
    k[..., 3] = 0.0                             # the 1e-12 floor
    k[..., 5] = 1e-14                           # below it
    ties = _ties()
    k[..., 6] = np.resize(ties, (3, 3, 16))     # wmax = 1 ...
    k[0, 0, 0, 6] = 1.0                         # ... so k / wmax is exact
    assert (np.abs(ties * np.float32(127) % 1) == 0.5).sum() >= 100
    qw, wmax = jcommon.quantize_weight(jnp.asarray(k))
    tq, twmax = int8_conv.quantize_weight(
        torch.from_numpy(k.transpose(3, 2, 0, 1).copy()))
    np.testing.assert_array_equal(tq.numpy(),
                                  np.asarray(qw).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(twmax.numpy(), np.asarray(wmax))
    assert tq.dtype == torch.int8


@pytest.mark.parametrize("scale", [0.73, 1.0, 0.0, 1e-7, 37.5])
def test_quantize_act_matches_jax(scale):
    """Clipping, the 1e-6 floor (0 and 1e-7), ties at .5 (scale 1)."""
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.normal(0, 1, 4000).astype(np.float32),
                        _ties(), -_ties(), [0.0, -0.0, 5.0, -5.0, 1e-6]])
    x = x.astype(np.float32).astype(jnp.bfloat16).astype(np.float32)
    ref = jcommon.quantize_act(jnp.asarray(x, jnp.bfloat16),
                               jnp.float32(scale))
    s = torch.tensor(scale, dtype=torch.float32)
    out = int8_conv.quantize_act(torch.from_numpy(x).to(torch.bfloat16), s)
    np.testing.assert_array_equal(out[:len(x)].numpy(), np.asarray(ref))
    assert out.dtype == torch.int8


@pytest.mark.parametrize("c", [3, 24, 64, 185, 537])
def test_quantize_act_pad_writes_zero_channels(c):
    """The reference's int8 values in a row's first C channels, zeros up
    to padded(C), the layout the int8 conv reads; a conv of the padded rows
    equals the conv of the unpadded ones, exactly."""
    rng = np.random.default_rng(c)
    x = rng.normal(0, 1, (2, 5, 6, c)).astype(np.float32)
    x = x.astype(jnp.bfloat16).astype(np.float32)
    ref = jcommon.quantize_act(jnp.asarray(x, jnp.bfloat16), jnp.float32(0.9))
    s = torch.tensor(0.9, dtype=torch.float32)
    out = int8_conv.quantize_act(torch.from_numpy(x).to(torch.bfloat16), s)
    assert out.shape == (2, 5, 6, -(-c // 64) * 64)
    assert out.dtype == torch.int8
    np.testing.assert_array_equal(out[..., :c].numpy(), np.asarray(ref))
    assert not bool(out[..., c:].any())
    qw, wmax = int8_conv.quantize_weight(torch.from_numpy(
        rng.normal(0, 1, (8, c, 3, 3)).astype(np.float32)))
    args = (int8_conv.pack_weight(qw), 3, int8_conv.rescale(s, wmax),
            torch.zeros(8), 1, (1, 1), s)
    assert torch.equal(int8_conv.int8_conv(out, *args),
                       int8_conv.int8_conv(out[..., :c].contiguous(), *args))


@pytest.mark.parametrize("scale", [0.37, 3.0, 0.0, 1e-7])
def test_dequant_matches_jax(scale):
    q = np.arange(-128, 128, dtype=np.int32).astype(np.int8)
    ref = jcommon.dequant(jcommon.QAct(jnp.asarray(q), jnp.float32(scale)))
    out = common.dequant(common.QAct(torch.from_numpy(q),
                                     torch.tensor(scale)))
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(out), _bits(ref))
    x = torch.ones(3, dtype=torch.bfloat16)
    assert common.dequant(x) is x          # float tensors pass


def test_jit_contracts_the_epilogue():
    """What the module docstring says of XLA on the CPU: under jit,
    `a * r + b` is one FMA and `s / 16129.0` a multiply by 1/16129."""
    rng = np.random.default_rng(2)
    a = rng.integers(-2 ** 20, 2 ** 20, 50000).astype(np.float32)
    r = rng.uniform(1e-6, 1e-3, 50000).astype(np.float32)
    b = rng.normal(0, 1, 50000).astype(np.float32)
    jit = np.asarray(jax.jit(lambda a, r, b: a * r + b)(a, r, b))
    fma = (a.astype(np.float64) * r + b).astype(np.float32)
    assert (jit != a * r + b).any() and (jit == fma).mean() > 0.999
    s = rng.uniform(0.01, 50, 50000).astype(np.float32)
    jdiv = np.asarray(jax.jit(lambda s: s / (127.0 * 127.0))(s))
    assert (jdiv != s / np.float32(16129.0)).any()
    np.testing.assert_array_equal(
        np.asarray(jcommon.quantize_act(jnp.asarray(s), jnp.float32(3.0))),
        int8_conv.quantize_act_plain(torch.from_numpy(s),
                                     torch.tensor(3.0))[:len(s)].numpy())


# ------------------------------------------------------- one int8 layer ---

class _Int8Bf16Out(fnn.Module):
    """The reference's `_int8_conv` with emit_q=False, as SepConvRelu's
    pointwise calls it, at any kernel and stride."""

    features: int
    kernel: int = 1
    stride: int = 1

    @fnn.compact
    def __call__(self, x):
        cin = x.q.shape[-1] if isinstance(x, jcommon.QAct) else x.shape[-1]
        k = self.param("kernel", fnn.initializers.lecun_normal(),
                       (self.kernel, self.kernel, cin, self.features),
                       jnp.float32)
        b = self.param("bias", fnn.initializers.zeros_init(),
                       (self.features,), jnp.float32)
        return jcommon._int8_conv(self, x, k, b, (self.stride, self.stride),
                                  act=True, emit_q=False)


# (kernel, stride, (H, W), Cin): every kernel size of the zoo, stride 2 on
# even and odd sizes (SAME pads (0, 1) and (1, 1)), Cin of the mobilenet
# stem (3), the VGG stage inputs (185) and the mobilenet stage pointwise
# (537)
_LAYERS = [(1, 1, (9, 11), 537), (3, 1, (10, 12), 3), (3, 2, (12, 14), 3),
           (3, 2, (11, 13), 24), (3, 1, (7, 9), 185), (7, 1, (9, 10), 185),
           (7, 1, (8, 8), 128), (1, 1, (6, 5), 3), (7, 2, (10, 9), 32)]


def _layer_case(k, stride, hw, cin, features, source, seed):
    """Seeded weights, bias, input and scales: the JAX variables, the
    port layer (an int8 ConvRelu holding the same weights and scales) and
    the two inputs (float bf16 or QAct)."""
    rng = np.random.default_rng(seed)
    kernel = rng.normal(0, 1.0 / np.sqrt(k * k * cin),
                        (k, k, cin, features)).astype(np.float32)
    bias = rng.normal(0, 0.05, features).astype(np.float32)
    x = rng.normal(0, 1, (2, *hw, cin)).astype(np.float32)
    q = np.clip(np.round(x * 40), -127, 127).astype(np.int8)
    xf = x if source == "float" else q * np.float32(0.9 / 127)
    act = float(np.abs(x).max()) * 0.8          # some inputs clip
    ref_y = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(xf), jnp.asarray(kernel), (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))) + bias
    out = float(np.maximum(ref_y, 0).max()) * 0.7  # some outputs saturate
    variables = {"params": {"kernel": jnp.asarray(kernel),
                            "bias": jnp.asarray(bias)},
                 "calib": {"act_scale": jnp.float32(act),
                           "out_scale": jnp.float32(out)}}
    layer = common.ConvRelu(cin, features, k, stride, dtype="int8")
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
        layer.bias.copy_(torch.from_numpy(bias))
        layer.act_scale.fill_(act)
        layer.out_scale.fill_(out)
    if source == "qact":
        jx = jcommon.QAct(jnp.asarray(q), jnp.float32(0.9))
        tx = common.QAct(torch.from_numpy(q).permute(0, 3, 1, 2),
                         torch.tensor(0.9))
    else:
        xb = x.astype(jnp.bfloat16)
        jx = jnp.asarray(xb)
        tx = torch.from_numpy(xb.astype(np.float32)).to(
            torch.bfloat16).permute(0, 3, 1, 2)
    return variables, layer, jx, tx


def _within_one_unit(out: np.ndarray, ref: np.ndarray) -> None:
    """The jitted reference: at most 1 int8 unit / bf16 ulp apart, on at
    most 0.1% of the elements (module docstring)."""
    diff = np.abs(out.astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


@pytest.mark.parametrize("source", ["float", "qact"])
@pytest.mark.parametrize("k,stride,hw,cin", _LAYERS)
def test_int8_layer_matches_jax(k, stride, hw, cin, source):
    """ConvRelu int8 (QAct out) and `_int8_conv` with a bf16 out: equal to
    the reference run op by op; within one unit of the jitted one."""
    features = 24
    variables, layer, jx, tx = _layer_case(k, stride, hw, cin, features,
                                           source, seed=k * 1000 + cin)
    with torch.no_grad():
        out = layer(tx)
        out16 = layer._int8_conv(tx, layer.weight, layer.bias, stride,
                                 emit_q=False)
    ref = jcommon.ConvRelu(features, k, stride, compute_dtype="int8").apply(
        variables, jx)
    assert isinstance(out, common.QAct) and out.q.dtype == torch.int8
    q = out.q.permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(q, np.asarray(ref.q))
    assert float(out.scale) == float(ref.scale)
    assert np.abs(q.astype(int)).max() == 127       # saturation reached
    ref16 = _Int8Bf16Out(features, k, stride).apply(variables, jx)
    np.testing.assert_array_equal(_bits(out16.permute(0, 2, 3, 1)),
                                  _bits(ref16))
    jit = jax.jit(lambda v, x: jcommon.ConvRelu(
        features, k, stride, compute_dtype="int8").apply(v, x))
    _within_one_unit(q, np.asarray(jit(variables, jx).q))
    jit16 = jax.jit(_Int8Bf16Out(features, k, stride).apply)
    _within_one_unit(_bits(out16.permute(0, 2, 3, 1)),
                     _bits(jit16(variables, jx)))


def test_int8_layer_zero_scales():
    """Uncalibrated (zero) scales floor at 1e-6: every nonzero input and
    output saturates, as in the reference."""
    variables, layer, jx, tx = _layer_case(3, 1, (6, 7), 24, 16, "float", 3)
    variables["calib"] = {"act_scale": jnp.float32(0.0),
                          "out_scale": jnp.float32(0.0)}
    with torch.no_grad():
        layer.act_scale.zero_()
        layer.out_scale.zero_()
        out = layer(tx)
    ref = jcommon.ConvRelu(16, 3, 1, compute_dtype="int8").apply(variables,
                                                                jx)
    np.testing.assert_array_equal(out.q.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(ref.q))
    assert float(out.scale) == float(ref.scale) == np.float32(1e-6)


@pytest.mark.parametrize("stride,hw", [(1, (8, 9)), (2, (10, 12))])
def test_int8_sepconv_matches_jax(stride, hw):
    """SepConvRelu in int8: QAct in (dequantized), bf16 depthwise, int8
    pointwise with a bf16 output; the fused gate stays shut."""
    rng = np.random.default_rng(stride)
    c, f = 40, 24
    params = {"dw_kernel": rng.normal(0, 0.3, (3, 3, 1, c)),
              "dw_bias": rng.normal(0, 0.05, c),
              "pw_kernel": rng.normal(0, 0.15, (1, 1, c, f)),
              "pw_bias": rng.normal(0, 0.05, f)}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    q = rng.integers(-127, 128, (2, *hw, c)).astype(np.int8)
    calib = {"act_scale": jnp.float32(2.5), "out_scale": jnp.float32(0.0)}
    jm = jcommon.SepConvRelu(f, stride=stride, compute_dtype="int8",
                             fused=True)
    ref = jm.apply({"params": params, "calib": calib},
                   jcommon.QAct(jnp.asarray(q), jnp.float32(0.6)))
    layer = common.SepConvRelu(c, f, stride=stride, dtype="int8",
                               fused=True)
    assert not layer.fused
    state = from_flax({f"params/{k}": v for k, v in params.items()})
    state.update(act_scale=torch.tensor(2.5), out_scale=torch.tensor(0.0))
    layer.load_state_dict(state)
    with torch.no_grad():
        out = layer(common.QAct(torch.from_numpy(q).permute(0, 3, 1, 2),
                                torch.tensor(0.6)))
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(out.permute(0, 2, 3, 1)),
                                  _bits(ref))


def test_int8_maxpool_pools_the_int8_plane():
    rng = np.random.default_rng(4)
    q = rng.integers(-127, 128, (2, 7, 9, 5)).astype(np.int8)
    ref = fnn.max_pool(jnp.asarray(q), (2, 2), strides=(2, 2))
    out = common.maxpool2x2(common.QAct(
        torch.from_numpy(q).permute(0, 3, 1, 2), torch.tensor(0.5)))
    np.testing.assert_array_equal(out.q.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(ref))
    assert float(out.scale) == 0.5


# ------------------------------------------------ models and calibration ---

def _configs(name: str, **kw):
    kw = {**dict(hin=64, win=80, n_stages=2, compute_dtype="int8"), **kw}
    j, t = default_config(name), tconfig.default_config(name)
    return (j.replace(model=dataclasses.replace(j.model, **kw)),
            t.replace(model=dataclasses.replace(t.model, **kw)))


def _nested(flat: dict) -> dict:
    return traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})


def _images(seed: int, n: int = 2) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, 64, 80, 3),
                                                dtype=np.uint8)


_PAIRS = {}


def _engines(name: str, **kw):
    """A port int8 engine (seeded init) and the JAX int8 engine on the same
    float weights, both with the calib tree the JAX engine records on
    `_images(11)`; the last stage's prediction 1x1s are then scaled (they
    feed no quantized layer) so that random weights give maps that
    decode, max |conf| 0.7 and max |paf| 5 on `_images(12)`."""
    key = (name, tuple(sorted(kw.items())))
    if key not in _PAIRS:
        jcfg, tcfg = _configs(name, **kw)
        flat = to_flax(Engine(tcfg, seed=3, device="cpu").model.state_dict())
        params = {k: v for k, v in flat.items() if k.startswith("params/")}
        jeng = JaxEngine(jcfg, params=_nested(params))
        jeng.calibrate(_images(11))
        flat = {**params, **_flatten(jax.device_get(
            {"calib": jeng.params["calib"]}))}
        conf, paf = Engine(tcfg, params=flat, device="cpu").forward(
            _images(12))
        for branch, top, maps in (("conf", 0.7, conf), ("paf", 5.0, paf)):
            k = f"params/stages/stage2_{branch}/Conv_0/kernel"
            flat[k] = flat[k] * np.float32(top / float(maps.abs().max()))
        jeng = JaxEngine(jcfg, params=_nested(flat))
        eng = Engine(tcfg, params=flat, device="cpu")
        assert not eng._needs_calibration()
        _PAIRS[key] = (jeng, eng)
    return _PAIRS[key]


def _eager_maps(jeng, images):
    """The reference's final maps, its model applied op by op."""
    from openpose_plus_tpu.engine import preprocess_images

    out = jeng.model.apply(jeng.params, preprocess_images(
        jnp.asarray(images)))
    return out["conf"][-1], out["paf"][-1]


def _check_maps(ref_maps, eng, images, rel_tol):
    """The port's final maps within rel_tol of the reference's scale;
    returns the worst ratio."""
    worst = 0.0
    for out, ref in zip(eng.forward(images), ref_maps):
        ref = np.asarray(ref, np.float32)
        scale = np.abs(ref).max()
        assert scale > 0
        err = np.abs(out.numpy() - ref).max()
        assert err <= rel_tol * scale, (err, scale)
        worst = max(worst, err / scale)
    return worst


def _check_humans(jeng, ref_maps, eng, images):
    """The reference decoder on the reference's maps, the port's engine on
    the images: equal skeleton sets, coordinates within 1e-3 px."""
    from openpose_plus_tpu.postproc import build_decoder

    ref = build_decoder(jeng.config.postproc)(*ref_maps)
    out = eng.infer(images)
    assert int(out.num_humans.sum()) >= 2
    for name in ("valid", "n_parts", "part_valid"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)
    np.testing.assert_allclose(out.coords.numpy(), np.asarray(ref.coords),
                               rtol=0, atol=1e-3)


@pytest.mark.parametrize("name", ["mobilenet_thin", "vggtiny"])
def test_int8_model_matches_jax(name):
    """A whole int8 model with the JAX calib tree bridged in: separable
    (MobileNet-thin: plain int8 stem, int8 pointwise convs) and dense
    (VGG-tiny: the QAct chain, int8 max pool, stage-input quantization).
    Against the reference applied op by op: final maps within MAP_TOL of
    their scale (the float32 prediction 1x1s sum in another order), the
    same humans. Against the jitted JAX engine, whose FMA-contracted
    epilogues move int8 units that the QAct chain carries (its own eager
    and jitted maps lie up to ~6% of the scale apart): within JIT_TOL."""
    jeng, eng = _engines(name)
    images = _images(12)
    ref_maps = _eager_maps(jeng, images)
    _check_maps(ref_maps, eng, images, MAP_TOL)
    _check_humans(jeng, ref_maps, eng, images)
    _check_maps(jeng.forward(images), eng, images, JIT_TOL)


def test_s2d_stem_int8_is_the_plain_stem():
    """The reference's int8 VGG stem on the space-to-depth grid
    (`S2DConvRelu`, stem_s2d=True) gives exactly what its plain int8 stem
    gives: the rearranged kernel holds each output channel's taps plus
    zeros, so its weight scales and integer sums are the plain ones. So
    the port's plain stem serves stem_s2d=True. Same weights and calib
    tree, whose names (`conv1_1`, `conv1_2`) both stems share."""
    jplain, eng = _engines("vggtiny")
    jcfg, tcfg = _configs("vggtiny", stem_s2d=True)
    assert jcfg.model.stem_s2d and tcfg.model.stem_s2d
    js2d = JaxEngine(jcfg, params=jplain.params)
    assert set(js2d.params["calib"]) >= {"conv1_1", "conv1_2"}
    s2d = Engine(tcfg, params=eng.model.state_dict(), device="cpu")
    images = _images(13)
    ref_maps = _eager_maps(js2d, images)
    for a, b in zip(ref_maps, _eager_maps(jplain, images)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    _check_maps(ref_maps, s2d, images, MAP_TOL)
    _check_humans(js2d, ref_maps, s2d, images)


@pytest.mark.parametrize("name", ["mobilenet_thin", "vggtiny"])
def test_calibration_matches_jax(name):
    """The port's recorded scales agree with the JAX calib tree leaf by
    leaf, same names, relative 1e-2 (bf16 float paths that round at
    different places); scales only grow; the same images again are a
    fixed point."""
    jeng, _ = _engines(name)
    _, tcfg = _configs(name)
    params = {k: v for k, v in _flatten(jax.device_get(jeng.params)).items()
              if k.startswith("params/")}
    eng = Engine(tcfg, params=params, device="cpu")
    assert eng._needs_calibration()
    eng.calibrate(_images(11))
    ours = {k: float(v) for k, v in to_flax(eng.model.state_dict()).items()
            if k.startswith("calib/")}
    ref = {k: float(v) for k, v in _flatten(jax.device_get(
        {"calib": jeng.params["calib"]})).items()}
    assert set(ours) == set(ref) and len(ours) > 10
    for k in ref:
        assert ours[k] == pytest.approx(ref[k], rel=1e-2), k
    if name == "vggtiny":
        assert "calib/stages/stage2_in_scale" in ours
    eng.calibrate(np.zeros_like(_images(11)))
    grown = {k: float(v) for k, v in to_flax(eng.model.state_dict()).items()
             if k.startswith("calib/")}
    assert all(grown[k] >= ours[k] for k in ours)
    eng.calibrate(_images(11))
    again = {k: float(v) for k, v in to_flax(eng.model.state_dict()).items()
             if k.startswith("calib/")}
    assert again == grown


# ---------------------------------------------------- engine behaviours ---

def _tiny(name="mobilenet_thin", **kw):
    return _configs(name, **kw)[1]


def test_int8_implicit_calibration_on_first_infer():
    eng = Engine(_tiny(), seed=0, device="cpu")
    assert eng._needs_calibration()
    assert all(float(b) == 0 for b in eng._calib)
    out = eng.infer(_images(0, 1))
    assert bool(torch.isfinite(out.score).all())
    assert all(float(b) > 0 for b in eng._calib)
    assert not eng._needs_calibration()


@pytest.mark.parametrize("call", ["infer", "infer_flip", "multiscale",
                                  "forward"])
def test_every_entry_point_calibrates_first(call):
    eng = Engine(_tiny("hao28"), seed=0, device="cpu")
    images = _images(1, 1)
    {"infer": lambda: eng.infer(images),
     "infer_flip": lambda: eng.infer(images, flip_tta=True),
     "multiscale": lambda: eng.infer_multiscale(images, (0.5, 1.0)),
     "forward": lambda: eng.forward(images)}[call]()
    assert all(float(b) > 0 for b in eng._calib)


def test_partially_calibrated_engine_recalibrates():
    """One zero scale and the engine is not calibrated: a zero-scale
    layer would saturate. The next infer calibrates."""
    eng = Engine(_tiny(), seed=0, device="cpu")
    images = _images(2, 1)
    eng.calibrate(images)
    with torch.no_grad():
        eng.model.dw3.act_scale.zero_()
    eng._calibrated = False
    assert eng._needs_calibration()
    out = eng.infer(images)
    assert bool(torch.isfinite(out.score).all())
    assert float(eng.model.dw3.act_scale) > 0


def test_fast_init_gives_zero_scales():
    eng = Engine(_tiny("vggtiny"), seed=0, fast_init=True, device="cpu")
    names = [k for k in eng.model.state_dict() if common.is_calib_leaf(
        k.rsplit(".", 1)[-1])]
    assert "stages.stage2_in_scale" in names and "conv1_1.act_scale" in names
    assert all(float(b) == 0 for b in eng._calib)


def test_float_checkpoint_serves_int8():
    """A float state_dict, and a Flax dict without `calib/`, load into an
    int8 engine with zero scales; a float engine takes an int8 engine's
    state_dict (the scales dropped); the float weights give the same
    int8 maps whichever way they came."""
    float_cfg = _tiny(compute_dtype="bfloat16")
    float_engine = Engine(float_cfg, seed=5, device="cpu")
    state = float_engine.model.state_dict()
    assert not any(common.is_calib_leaf(k.rsplit(".", 1)[-1])
                   for k in state)
    images = _images(3, 1)
    a = Engine(_tiny(), params=state, device="cpu")
    b = Engine(_tiny(), params=to_flax(state), device="cpu")
    assert a._needs_calibration() and b._needs_calibration()
    for x, y in zip(a.forward(images), b.forward(images)):
        assert torch.equal(x, y)
    back = Engine(float_cfg, params=a.model.state_dict(), device="cpu")
    for x, y in zip(back.forward(images), float_engine.forward(images)):
        assert torch.equal(x, y)
    with pytest.raises(RuntimeError, match="missing"):
        Engine(_tiny(), params={k: v for k, v in state.items()
                                if "conv1" not in k}, device="cpu")


def test_int8_refuses_s2d_input_on_mobilenet():
    eng = Engine(_tiny(), seed=0, device="cpu")
    assert eng.config.model.preferred_input_layout() == 0
    s2d = common.space_to_depth(torch.from_numpy(_images(4, 1)))
    with pytest.raises(ValueError, match="input_layout"):
        eng.infer(s2d)
    model = get_model(_tiny().model)
    for x in (s2d, common.space_to_depth(s2d)):
        with torch.no_grad(), pytest.raises(ValueError,
                                            match="float compute mode"):
            model(x.float())


def test_fused_inference_does_not_fuse_in_int8(monkeypatch):
    from openpose_plus_tpu_torch.ops.cuda import sepconv

    cfg = _tiny(fused_inference=True)
    eng = Engine(cfg, seed=0, device="cpu")
    assert not any(m.fused for m in eng.model.modules()
                   if isinstance(m, common.SepConvRelu))

    def refuse(*args, **kwargs):
        raise AssertionError("fused_sepconv called in int8")
    monkeypatch.setattr(sepconv, "fused_sepconv", refuse)
    eng.infer(_images(5, 1))


def test_calibrate_from_paths(tmp_path):
    """Files through the port's loader and letterbox, in batches padded
    by repeating the last image: the same scales as `calibrate` on the
    letterboxed images."""
    import cv2

    from openpose_plus_tpu_torch.data.augment import letterbox

    rng = np.random.default_rng(6)
    paths, boxed = [], []
    for i, (h, w) in enumerate([(50, 70), (90, 60), (64, 80)]):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        path = os.path.join(tmp_path, f"{i}.png")
        cv2.imwrite(path, img[:, :, ::-1])
        paths.append(path)
        boxed.append(letterbox(img, 64, 80)[0])
    a = Engine(_tiny(), seed=0, device="cpu")
    a.calibrate_from_paths(paths, batch_size=2)
    b = Engine(_tiny(), seed=0, device="cpu")
    b.calibrate(np.stack(boxed))
    assert not a._needs_calibration()
    for x, y in zip(a._calib, b._calib):
        assert float(x) == float(y)
    float_engine = Engine(_tiny(compute_dtype="bfloat16"), device="cpu")
    assert float_engine.calibrate_from_paths(["missing.png"]) is None


def test_train_still_refuses_int8():
    from openpose_plus_tpu_torch.train import create_train_state

    with pytest.raises(ValueError, match="int8"):
        create_train_state(_tiny(), seed=0, device="cpu")


def test_calib_leaves_round_trip_through_flax():
    """to_flax(from_flax(x)) keeps every calib leaf; the names are the
    JAX int8 model's own."""
    jeng, eng = _engines("vggtiny")
    flat = _flatten(jax.device_get(jeng.params))
    back = to_flax(from_flax(flat))
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], np.asarray(v, np.float32))
    assert {k for k in to_flax(eng.model.state_dict())} == set(flat)


def test_ap_bench_int8_variant_calibrates_from_train_paths(monkeypatch):
    """`ap_bench --int8`: the fidelity_int8 variant serves the same float
    weights in an int8 engine calibrated by `calibrate_from_paths` on the
    first 8 TRAIN images, never the eval ones."""
    from openpose_plus_tpu_torch import ap_bench, eval_coco

    seen = {}

    def fake_eval(engine, dataset, **kwargs):
        seen["engine"], seen["dataset"] = engine, dataset
        return eval_coco.EvalResult(0.5, 0.6, 0.4, 0.7, 1, 0)
    monkeypatch.setattr(eval_coco, "evaluate_engine", fake_eval)
    calls = []
    original = Engine.calibrate_from_paths
    monkeypatch.setattr(Engine, "calibrate_from_paths",
                        lambda self, paths, **kw: calls.append(list(paths)))

    class _Set:
        def __init__(self, tag):
            self.tag = tag

        def __len__(self):
            return 20

        def __getitem__(self, i):
            return type("S", (), {"image_path": f"{self.tag}/{i}.jpg"})()
    cfg = _tiny(compute_dtype="bfloat16")
    params = Engine(cfg, seed=0, device="cpu").model.state_dict()
    out = ap_bench.eval_variant(cfg, params, "fidelity_int8", _Set("val"),
                                device="cpu", calib_dataset=_Set("train"))
    assert seen["engine"].config.model.compute_dtype == "int8"
    assert seen["engine"].config.postproc == cfg.postproc.fidelity()
    assert calls == [[f"train/{i}.jpg" for i in range(8)]]
    assert seen["dataset"].tag == "val" and out["ap"] == 0.5
    assert original is not Engine.calibrate_from_paths
    assert "fidelity_int8" in ap_bench.INT8_VARIANTS
