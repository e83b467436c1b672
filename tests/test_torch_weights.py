"""Port weight bridge and copied numpy helpers vs the JAX package.

The PyTorch port (openpose_plus_tpu_torch) names its submodules after the
Flax scopes, so a flat Flax dict maps one to one onto its state_dict; these
tests pin that mapping at full MobileNet-thin width and pin every numpy
helper the port had to copy (the originals import JAX) equal to its source.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from openpose_plus_tpu.checkpoint import _flatten, save_npz
from openpose_plus_tpu.config import default_config
from openpose_plus_tpu.models import get_model as jax_model
from openpose_plus_tpu.postproc import common as jcommon, nms as jnms
from openpose_plus_tpu_torch.checkpoint import from_flax, load_npz, to_flax
from openpose_plus_tpu_torch.models import get_model as torch_model
from openpose_plus_tpu_torch.postproc import common as tcommon, nms as tnms

torch.set_num_threads(2)


def _tiny_cfg():
    cfg = default_config("mobilenet_thin").model
    return dataclasses.replace(cfg, hin=64, win=64, n_stages=2,
                               compute_dtype="float32")


def _flax_init(model_cfg):
    model = jax_model(model_cfg)
    x = jnp.zeros((1, model_cfg.hin, model_cfg.win, 3), jnp.float32)
    return _flatten(jax.device_get(model.init(jax.random.PRNGKey(0), x)))


def test_round_trip_on_jax_init():
    """from_flax -> load into the port -> state_dict -> to_flax gives back
    the JAX model's own init, bit for bit."""
    cfg = _tiny_cfg()
    flat = _flax_init(cfg)
    model = torch_model(cfg)
    model.load_state_dict(from_flax(flat), strict=True)
    back = to_flax(model.state_dict())
    assert back.keys() == flat.keys()
    for key, value in flat.items():
        np.testing.assert_array_equal(back[key], np.asarray(value), key)


def test_full_width_keys_map_one_to_one():
    """Every Flax key of full-width MobileNet-thin (default config: 368x432,
    width 0.75, 6 stages) is consumed exactly once: the strict load fails on
    a missing, extra or mis-shaped key."""
    cfg = default_config("mobilenet_thin").model
    shapes = jax.eval_shape(
        lambda: jax_model(cfg).init(
            jax.random.PRNGKey(0),
            jnp.zeros((1, cfg.hin, cfg.win, 3), jnp.float32)))
    rng = np.random.default_rng(0)
    leaves, _ = jax.tree_util.tree_flatten_with_path(shapes)
    flat = {"/".join(p.key for p in path):
            rng.standard_normal(leaf.shape).astype(np.float32)
            for path, leaf in leaves}
    assert len(flat) == 230
    assert "params/stages/stage2_paf/SepConvRelu_1/dw_kernel" in flat
    assert "params/stages/stage1_conf/Conv_0/kernel" in flat
    state = from_flax(flat)
    assert len(state) == 230
    model = torch_model(cfg)
    model.load_state_dict(state, strict=True)
    dw = state["stages.stage2_paf.SepConvRelu_1.dw_weight"]
    c = dw.shape[0]
    assert tuple(dw.shape) == (c, 1, 3, 3)         # depthwise, groups=C
    np.testing.assert_array_equal(
        dw[:, 0].numpy(),
        flat["params/stages/stage2_paf/SepConvRelu_1/dw_kernel"][:, :, 0]
        .transpose(2, 0, 1))
    back = to_flax(model.state_dict())
    assert back.keys() == flat.keys()
    for key in flat:
        np.testing.assert_array_equal(back[key], flat[key], key)


def test_load_npz_reads_jax_save_npz(tmp_path):
    flat = _flax_init(_tiny_cfg())
    nested = traverse_util.unflatten_dict(
        {tuple(k.split("/")): v for k, v in flat.items()})
    path = save_npz(str(tmp_path / "w"), nested)
    loaded = load_npz(path[:-4])             # either spelling
    assert loaded.keys() == flat.keys()
    for key in flat:
        np.testing.assert_array_equal(loaded[key], np.asarray(flat[key]))


def test_from_flax_rejects_non_param_collections():
    with pytest.raises(KeyError):
        from_flax({"calib/conv1/act_scale": np.zeros(())})


@pytest.mark.parametrize("sigma", [0.0, 1.0, 1.25, 5.0])
def test_gaussian_kernel_copy(sigma):
    np.testing.assert_array_equal(tcommon.gaussian_kernel_1d(sigma),
                                  jcommon.gaussian_kernel_1d(sigma))


@pytest.mark.parametrize("n", [1, 2, 10, 17])
def test_line_sample_fracs_copy(n):
    np.testing.assert_array_equal(tcommon.line_sample_fracs(n),
                                  jcommon.line_sample_fracs(n))


def test_refine_peak_1d_copy():
    rng = np.random.default_rng(3)
    c, p, n = (rng.uniform(0, 1, 64).astype(np.float32) for _ in range(3))
    p[:4] = n[:4] = c[:4]                      # degenerate parabolas
    np.testing.assert_array_equal(tcommon.refine_peak_1d(c, p, n),
                                  jcommon.refine_peak_1d(c, p, n))


@pytest.mark.parametrize("n_in,factor,sigma", [
    (46, 2, 1.25), (54, 2, 1.25), (23, 8, 5.0), (8, 2, 1.0), (7, 1, 0.0),
    (9, 3, 0.0)])
def test_upsample_smooth_matrix_copy(n_in, factor, sigma):
    np.testing.assert_array_equal(
        tnms._upsample_smooth_matrix(n_in, factor, sigma),
        jnms._upsample_smooth_matrix(n_in, factor, sigma))
