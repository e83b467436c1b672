"""The port's fused separable path vs the JAX package, on the CPU.

- `fused_sepconv_plain` (the CUDA kernel's plain version) against the
  Pallas `fused_sepconv` in interpret mode;
- the depthwise probe's plain bodies against the probe's Pallas bodies;
- the tiny bf16 MobileNet-thin with `fused_inference=True`, port against
  JAX on bridged parameters, and the port's fused engine against its
  unfused engine on the same flat Flax parameters.

The Pallas side runs as tests/test_lowering_equiv.py runs it: `pallas_call`
patched with `interpret=True` around the call (for the model, around Flax
`apply`).

Tolerance of the separable conv: both sides sum in f32 (the plain version
contracts the pointwise product in float64) in another order, then round
to bf16, so an element differs by at most one bf16 ulp before the last bias
add; measured as `kernel_inputs.bf16_mismatch` units (2**-7 of the larger
value plus the bias magnitude), at most 2, with at least 98% of the
elements identical.
"""

import dataclasses
import functools
import unittest.mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from openpose_plus_tpu.checkpoint import _flatten
from openpose_plus_tpu import config as jconfig
from openpose_plus_tpu.models import get_model as jax_model
from openpose_plus_tpu.ops.pallas import sepconv as jsepconv
from openpose_plus_tpu_torch import config as tconfig
from openpose_plus_tpu_torch.engine import Engine
from openpose_plus_tpu_torch.ops.cuda import dw_probe, sepconv

from tests import kernel_inputs

torch.set_num_threads(2)

MAX_UNITS = 2.0        # see the module docstring
MIN_IDENTICAL = 0.98
REL_TOL_BF16 = 2e-2    # tests/test_torch_models.py REL_TOL["bfloat16"]


def _interpret():
    return unittest.mock.patch.object(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _bf16(a):
    return jnp.asarray(a, jnp.bfloat16)


@pytest.mark.parametrize("c,f,h,w", [(64, 128, 12, 16), (24, 32, 9, 11),
                                     (57, 40, 7, 10)])
def test_plain_fused_sepconv_matches_pallas(c, f, h, w):
    args = kernel_inputs.sepconv_inputs(np.random.default_rng(c), 2, h, w,
                                        c, f)
    x = np.asarray(_bf16(args[0]), np.float32)       # bf16-representable
    with _interpret():
        ref = jsepconv.fused_sepconv(_bf16(x), *map(jnp.asarray, args[1:]))
    ref = np.asarray(ref, np.float32)
    out = sepconv.fused_sepconv_plain(
        torch.from_numpy(x).to(torch.bfloat16),
        *map(torch.from_numpy, args[1:]))
    assert out.dtype == torch.bfloat16 and out.shape == (2, h, w, f)
    units, same = kernel_inputs.bf16_mismatch(
        out.float().numpy(), ref, np.abs(np.asarray(_bf16(args[4]),
                                                     np.float32)))
    assert units <= MAX_UNITS and same >= MIN_IDENTICAL, (units, same)


# The probe's two bodies, rebuilt from scripts/profile_pallas_dw.py:33-46
# (importing that script would reset the JAX compilation cache of the
# whole test worker).
def _dw_kernel(x_ref, dwk_ref, out_ref):
    _, h, w, c = x_ref.shape
    x = x_ref[0]
    xp = jnp.pad(x, ((1, 1), (1, 1), (0, 0)))
    acc = jnp.zeros((h, w, c), jnp.float32)
    for dy in range(3):
        for dx in range(3):
            tap = xp[dy:dy + h, dx:dx + w, :].astype(jnp.float32)
            acc = acc + tap * dwk_ref[dy * 3 + dx, :].astype(jnp.float32)
    out_ref[0] = jnp.maximum(acc, 0).astype(jnp.bfloat16)


def _copy_kernel(x_ref, dwk_ref, out_ref):
    out_ref[0] = x_ref[0] + dwk_ref[0, :].astype(jnp.bfloat16)


def _probe_pallas(body, x, dwk):
    b, h, w, c = x.shape
    return pl.pallas_call(
        body, grid=(b,),
        in_specs=[pl.BlockSpec((1, h, w, c), lambda i: (i, 0, 0, 0)),
                  pl.BlockSpec((9, c), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((1, h, w, c), lambda i: (i, 0, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((b, h, w, c), jnp.bfloat16),
        interpret=True)(x, dwk)


@pytest.mark.parametrize("c,h,w", [(128, 6, 11), (20, 5, 7)])
@pytest.mark.parametrize("body", ["dw3x3_relu", "copy_bias"])
def test_probe_plain_bodies_match_pallas(body, c, h, w):
    rng = np.random.default_rng(c + h)
    x = _bf16(rng.standard_normal((2, h, w, c)))
    dwk = _bf16(rng.standard_normal((9, c)) * 0.1)
    pallas_body = {"dw3x3_relu": _dw_kernel, "copy_bias": _copy_kernel}[body]
    ref = np.asarray(_probe_pallas(pallas_body, x, dwk), np.float32)
    tx = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    tdwk = torch.from_numpy(np.asarray(dwk, np.float32)).to(torch.bfloat16)
    out = getattr(dw_probe, body)(tx, tdwk)
    assert out.dtype == torch.bfloat16
    out = out.float().numpy()
    if body == "copy_bias":
        np.testing.assert_array_equal(out, ref)
    else:   # f32 taps summed in the same order; FMA contraction allowed
        units, same = kernel_inputs.bf16_mismatch(out, ref)
        assert units <= 1.0 and same >= MIN_IDENTICAL, (units, same)


def test_wrappers_take_the_plain_version_on_the_cpu():
    args = [torch.from_numpy(a) for a in kernel_inputs.sepconv_inputs(
        np.random.default_rng(3), 1, 5, 6, 8, 4)]
    x = args[0].to(torch.bfloat16)
    dwk = args[1].reshape(9, 8).to(torch.bfloat16)
    before = (sepconv.launches, dw_probe.dw3x3_relu_launches,
              dw_probe.copy_bias_launches)
    assert torch.equal(sepconv.fused_sepconv(x, *args[1:]),
                       sepconv.fused_sepconv_plain(x, *args[1:]))
    assert torch.equal(dw_probe.dw3x3_relu(x, dwk),
                       dw_probe.dw3x3_relu_plain(x, dwk))
    assert torch.equal(dw_probe.copy_bias(x, dwk),
                       dw_probe.copy_bias_plain(x, dwk))
    assert (sepconv.launches, dw_probe.dw3x3_relu_launches,
            dw_probe.copy_bias_launches) == before
    with pytest.raises(ValueError, match="device"):
        sepconv.fused_sepconv(x.to("meta"), *[a.to("meta") for a in args[1:]])
    with pytest.raises(ValueError, match="device"):
        dw_probe.copy_bias(x.to("meta"), dwk.to("meta"))
    with pytest.raises(ValueError, match="stride 1"):
        sepconv.fused_sepconv(x, *args[1:], stride=2)
    with pytest.raises(ValueError, match="3x3"):
        sepconv.fused_sepconv(x, args[1][:2], *args[2:])
    w = args[1].clone().requires_grad_()
    with pytest.raises(RuntimeError, match="backward"):
        sepconv.fused_sepconv(x, w, *args[2:])
    with torch.no_grad():
        sepconv.fused_sepconv(x, w, *args[2:])


# ------------------------------------------------- the slice as a whole ---

def _tiny_cfg(fused=True, config=tconfig):
    """The tiny fused model's ModelConfig, the port's own or (with
    config=the JAX package's config module) the JAX one, same fields."""
    return dataclasses.replace(
        config.default_config("mobilenet_thin").model, hin=64, win=64,
        n_stages=2, compute_dtype="bfloat16", fused_inference=fused)


_SLICE = {}


def _slice():
    """JAX fused model (Pallas in interpret mode) and its flat params, the
    port's fused model on them, one seeded batch."""
    if not _SLICE:
        cfg = _tiny_cfg(config=jconfig)
        x = np.random.default_rng(0).uniform(
            -0.5, 0.5, (2, 64, 64, 3)).astype(np.float32)
        # the flag is not a parameter: the unfused model's init gives the
        # same tree without running the interpreted kernels twice
        params = jax.jit(jax_model(dataclasses.replace(
            cfg, fused_inference=False)).init)(jax.random.PRNGKey(1),
                                               jnp.asarray(x))
        with _interpret():
            ref = jax.jit(jax_model(cfg).apply)(params, jnp.asarray(x))
        flat = _flatten(jax.device_get(params))
        _SLICE.update(x=x, flat=flat, ref=jax.tree.map(
            lambda a: np.asarray(a, np.float32), ref))
    return _SLICE


@pytest.mark.parametrize("stage", [0, 1])
def test_fused_model_matches_jax(stage):
    """JAX fuses only the layers its TPU gate admits (dw5 and the 128->128
    stage convs); the port fuses every marked stride-1 3x3 bf16 layer. Both
    compute the same function to bf16 rounding."""
    from openpose_plus_tpu_torch.checkpoint import from_flax
    from openpose_plus_tpu_torch.models import get_model

    s = _slice()
    tm = get_model(_tiny_cfg())
    tm.load_state_dict(from_flax(s["flat"]), strict=True)
    with torch.no_grad():
        out = tm(torch.from_numpy(s["x"]))
    for name, channels in (("conf", 19), ("paf", 38)):
        a = s["ref"][name][stage]
        b = out[name][stage].float().numpy()
        assert a.shape == b.shape == (2, 8, 8, channels)
        err = np.abs(a - b).max()
        assert err <= REL_TOL_BF16 * np.abs(a).max(), (name, err)


def test_fused_engine_matches_unfused_engine():
    """The flag is not a parameter: the same 'params/...' dict loads
    strictly into both engines, and their maps agree to bf16 rounding."""
    s = _slice()
    images = np.random.default_rng(4).integers(0, 256, (2, 64, 64, 3),
                                               dtype=np.uint8)
    cfg = tconfig.default_config("mobilenet_thin")
    fused = Engine(cfg.replace(model=_tiny_cfg(True)), params=s["flat"],
                   device="cpu")
    plain = Engine(cfg.replace(model=_tiny_cfg(False)), params=s["flat"],
                   device="cpu")
    before = sepconv.launches
    for a, b in zip(plain.forward(images), fused.forward(images)):
        assert a.shape == b.shape
        err = float((a - b).abs().max())
        assert err <= REL_TOL_BF16 * float(a.abs().max()), err
    assert sepconv.launches == before            # CPU: the plain version
