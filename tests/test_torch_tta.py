"""Port flip-TTA, scale search and the s2d input layouts vs the JAX package.

- `space_to_depth` / `depth_to_space` bit-equal to the JAX functions and to
  `native.s2d_u8` / `s2d2_u8` (numpy path); `check_input_layout` raises the
  JAX errors for every level x geometry.
- The flip tables and `mirror_maps` bit-equal to JAX's.
- `Engine.infer(flip_tta=True)` and `Engine.infer_multiscale` ("avg",
  "dedup") on the same uint8 images and bridged params (tiny float32
  MobileNet-thin, scaled heads) give the JAX engine's maps and skeletons,
  for plain, s2d and s2d^2 inputs.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from openpose_plus_tpu import engine as jengine, native
from openpose_plus_tpu.engine import Engine as JaxEngine
from openpose_plus_tpu.checkpoint import _flatten
from openpose_plus_tpu import config as jconfig
from openpose_plus_tpu.models import common as jcommon
from openpose_plus_tpu.postproc import flip as jflip
from openpose_plus_tpu_torch import config as tconfig, engine as tengine
from openpose_plus_tpu_torch.engine import Engine
from openpose_plus_tpu_torch.models import common as tcommon
from openpose_plus_tpu_torch.postproc import flip as tflip

torch.set_num_threads(2)

SCALES = (0.5, 1.0, 1.5)


def _tiny(hin=64, win=64, config=tconfig):
    """The tiny float32 Config, the port's own or (config=jconfig) the JAX
    package's, from the same arguments."""
    cfg = config.default_config("mobilenet_thin")
    return cfg.replace(model=dataclasses.replace(
        cfg.model, hin=hin, win=win, n_stages=2, compute_dtype="float32"))


_PAIR = {}


def _engines():
    """A JAX engine and a port engine on the same parameters, the last
    stage's prediction kernels scaled until the decoder groups humans (as
    tests/test_torch_engine.py does)."""
    if not _PAIR:
        cfg = _tiny(config=jconfig)
        flat = _flatten(jax.device_get(JaxEngine(cfg, seed=3).params))
        for branch, gain in (("conf", 400.0), ("paf", 1000.0)):
            key = f"params/stages/stage2_{branch}/Conv_0/kernel"
            flat[key] = np.asarray(flat[key]) * gain
        nested = traverse_util.unflatten_dict(
            {tuple(k.split("/")): v for k, v in flat.items()})
        _PAIR["jax"] = JaxEngine(cfg, params=nested)
        _PAIR["torch"] = Engine(_tiny(), params=flat, device="cpu")
    return _PAIR["jax"], _PAIR["torch"]



def _images(seed, b=2):
    return np.random.default_rng(seed).integers(0, 256, (b, 64, 64, 3),
                                                dtype=np.uint8)


def _layout(images, level):
    """uint8 NHWC images in the s2d layout of `level` (numpy)."""
    x = torch.from_numpy(images)
    for _ in range(level):
        x = tcommon.space_to_depth(x)
    return x.numpy()


def _assert_humans_match(out, ref, atol=1e-5):
    """The tolerances of test_torch_engine.py::test_infer_matches_jax_engine:
    masks and counts exactly, floats to float32 accumulation order."""
    for name in ("valid", "n_parts", "part_valid"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)
    for name in ("coords", "part_scores", "score"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)), rtol=0,
                                   atol=atol, err_msg=name)


def _assert_batches_equal(a, b):
    for f in dataclasses.fields(a):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f.name


def _maps_close(out, ref, rel=1e-5):
    """max |out - ref| <= rel x max |ref|, per map."""
    for o, r in zip(out, ref):
        r = np.asarray(r)
        assert o.shape == r.shape
        np.testing.assert_allclose(o.numpy(), r, rtol=0,
                                   atol=rel * float(np.abs(r).max()))


# ------------------------------------------------------- s2d helpers ---

@pytest.mark.parametrize("shape", [(1, 4, 6, 3), (2, 8, 12, 3),
                                   (2, 6, 4, 12), (1, 16, 16, 5)])
def test_space_to_depth_matches_jax(shape):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    s2d = tcommon.space_to_depth(torch.from_numpy(x))
    np.testing.assert_array_equal(
        s2d.numpy(), np.asarray(jcommon.space_to_depth(jnp.asarray(x))))
    c = shape[-1]
    back = tcommon.depth_to_space(s2d, c)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jcommon.depth_to_space(
            jcommon.space_to_depth(jnp.asarray(x)), c)))
    assert torch.equal(back, torch.from_numpy(x))      # exact round trip
    assert back.is_contiguous()


@pytest.mark.parametrize("level", [1, 2])
def test_s2d_layouts_match_native(level, monkeypatch):
    """The port's s2d / s2d^2 of a uint8 batch equal the host loader's
    (numpy path), and to_plain inverts them exactly."""
    monkeypatch.setattr(native, "_load", lambda *a, **k: None)
    images = _images(5, b=3)
    host = np.stack([(native.s2d_u8 if level == 1 else native.s2d2_u8)(im)
                     for im in images])
    np.testing.assert_array_equal(_layout(images, level), host)
    plain = tcommon.to_plain(torch.from_numpy(host))
    assert plain.is_contiguous()
    np.testing.assert_array_equal(plain.numpy(), images)
    np.testing.assert_array_equal(
        np.stack([native.d2s_u8(h) for h in host]), images)


@pytest.mark.parametrize("level", [1, 2])
def test_plain_flip_equals_s2d_flip(level):
    """Flipping the plain image after depth_to_space is the JAX engine's
    in-layout flip (`s2d_flip_w` / `s2d2_flip_w`) followed by
    depth_to_space: the port's flip-TTA need not port the layout flips."""
    images = _images(6)
    s2d = _layout(images, level)
    flip_w = jcommon.s2d_flip_w if level == 1 else jcommon.s2d2_flip_w
    jflipped = np.asarray(flip_w(jnp.asarray(s2d), 3))
    out = tcommon.to_plain(torch.from_numpy(s2d)).flip(2)
    np.testing.assert_array_equal(
        out.numpy(), tcommon.to_plain(torch.from_numpy(jflipped.copy())))
    np.testing.assert_array_equal(out.numpy(), images[:, :, ::-1])


# ------------------------------------------------------ input layouts ---

_GEOMETRIES = {
    "mod4": dict(hin=64, win=64),
    "even": dict(hin=66, win=70),
    "odd": dict(hin=65, win=64),
    "int8": dict(hin=64, win=64, compute_dtype="int8"),
    "no_stem_s2d": dict(hin=64, win=64, stem_s2d=False),
    "vgg19": dict(name="vgg19", hin=64, win=64),
}


@pytest.mark.parametrize("layout", ["plain", "s2d", "s2d2", "nchw"])
@pytest.mark.parametrize("geometry", sorted(_GEOMETRIES))
def test_check_input_layout_matches_jax(geometry, layout):
    m = dataclasses.replace(jconfig.default_config().model,
                            **_GEOMETRIES[geometry])
    tm = dataclasses.replace(tconfig.default_config().model,
                             **_GEOMETRIES[geometry])
    try:
        ref = jengine.check_input_layout(m, layout)
    except ValueError as e:
        with pytest.raises(ValueError) as out:
            tengine.check_input_layout(tm, layout)
        assert str(out.value) == str(e)
    else:
        assert tengine.check_input_layout(tm, layout) == ref


def test_engine_rejects_bad_layouts():
    engine = Engine(_tiny(), device="cpu")
    for bad in [np.zeros((1, 16, 16, 12), np.uint8),     # s2d, wrong size
                np.zeros((1, 32, 32, 48), np.uint8),     # s2d^2, wrong size
                np.zeros((1, 32, 32, 5), np.uint8),      # no such layout
                np.zeros((1, 32, 32, 12), np.int8),      # not uint8
                np.zeros((32, 32, 12), np.uint8)]:
        with pytest.raises(ValueError):
            engine.infer(bad)
    # the layout's level is checked before the shape: 66x70 takes s2d, not
    # s2d^2
    even = Engine(_tiny(hin=66, win=70), device="cpu")
    with pytest.raises(ValueError, match="max supported level is 's2d'"):
        even.infer(np.zeros((1, 16, 17, 48), np.uint8))


# --------------------------------------------------------------- flip ---

def test_flip_tables_match_jax():
    np.testing.assert_array_equal(tflip._PART_SWAP, jflip._PART_SWAP)
    np.testing.assert_array_equal(tflip._LIMB_MIRROR, jflip._LIMB_MIRROR)
    for out, ref in zip(tflip.paf_channel_permutation(),
                        jflip.paf_channel_permutation()):
        assert out.dtype == ref.dtype
        np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("shape", [(2, 8, 10), (1, 46, 54), (8, 7)])
def test_mirror_maps_matches_jax(shape):
    rng = np.random.default_rng(1)
    conf = rng.uniform(0, 1, (*shape, 19)).astype(np.float32)
    paf = rng.uniform(-1, 1, (*shape, 38)).astype(np.float32)
    out = tflip.mirror_maps(torch.from_numpy(conf), torch.from_numpy(paf))
    ref = jflip.mirror_maps(jnp.asarray(conf), jnp.asarray(paf))
    for o, r in zip(out, ref):
        assert o.dtype == torch.float32
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    twice = tflip.mirror_maps(*out)                      # an involution
    assert torch.equal(twice[0], torch.from_numpy(conf))
    assert torch.equal(twice[1], torch.from_numpy(paf))


# ----------------------------------------------------------- flip-TTA ---

def _jax_maps_of(impl, monkeypatch, jax_engine, images, **kw):
    """Run the JAX engine's impl with its decode swapped for one that also
    returns the maps it decodes: (HumanBatch, conf, paf)."""
    decode = jengine.decode_maps
    monkeypatch.setattr(jengine, "decode_maps",
                        lambda c, p, cfg: (decode(c, p, cfg), c, p))
    fn = jax.jit(functools.partial(impl, model=jax_engine.model,
                                   postproc_cfg=jax_engine.config.postproc,
                                   **kw))
    out = fn(jax_engine.params, jnp.asarray(images))
    monkeypatch.setattr(jengine, "decode_maps", decode)
    return out


def _port_maps_of(call, monkeypatch):
    """Run an Engine call with the port's decode swapped the same way."""
    decode = tengine.decode_maps
    monkeypatch.setattr(tengine, "decode_maps",
                        lambda c, p, cfg: (decode(c, p, cfg), c, p))
    out = call()
    monkeypatch.setattr(tengine, "decode_maps", decode)
    return out


def test_tta_maps_match_jax(monkeypatch):
    """The averaged maps of `_infer_tta_impl` within 1e-5 of scale, and the
    skeletons decoded from them."""
    jax_engine, engine = _engines()
    images = _images(0)
    ref = _jax_maps_of(jengine._infer_tta_impl, monkeypatch, jax_engine,
                       images)
    out = _port_maps_of(lambda: engine.infer(images, flip_tta=True),
                        monkeypatch)
    _maps_close(out[1:], ref[1:])
    _assert_humans_match(out[0], ref[0])


@pytest.mark.parametrize("seed", [0, 1])
def test_tta_matches_jax_engine_all_layouts(seed):
    """`infer(flip_tta=True)` matches `JaxEngine.infer(flip_tta=True)` on
    plain, s2d and s2d^2 inputs, and the port's three results are equal."""
    jax_engine, engine = _engines()
    images = _images(10 + seed)
    outs = []
    for level in (0, 1, 2):
        x = _layout(images, level)
        outs.append(engine.infer(x, flip_tta=True))
        _assert_humans_match(outs[-1], jax_engine.infer(x, flip_tta=True))
    assert int(outs[0].num_humans.sum()) >= 1
    for other in outs[1:]:
        _assert_batches_equal(other, outs[0])


def test_s2d_infer_equals_plain():
    """Without flip-TTA too, and for the maps of `forward`."""
    _, engine = _engines()
    images = _images(2, b=3)
    ref = engine.infer(images)
    ref_maps = engine.forward(images)
    for level in (1, 2):
        x = _layout(images, level)
        _assert_batches_equal(engine.infer(x), ref)
        for o, r in zip(engine.forward(x), ref_maps):
            assert torch.equal(o, r)


def test_tta_of_symmetric_image_is_mirror_invariant(monkeypatch):
    """A mirror-symmetric image: the flip-averaged maps equal their own
    mirror, bit for bit."""
    _, engine = _engines()
    half = _images(3)[:, :, :32]
    sym = np.concatenate([half, half[:, :, ::-1]], axis=2)
    humans, conf, paf = _port_maps_of(
        lambda: engine.infer(sym, flip_tta=True), monkeypatch)
    mconf, mpaf = tflip.mirror_maps(conf, paf)
    assert torch.equal(mconf, conf) and torch.equal(mpaf, paf)
    assert torch.isfinite(humans.score).all()


# ------------------------------------------------------------- resize ---

@pytest.mark.parametrize("src,dst", [
    ((23, 27), (46, 54)), ((64, 64), (96, 96)), ((8, 8), (12, 12)),
    ((368, 432), (552, 648)),                               # up
    ((69, 81), (46, 54)), ((12, 12), (8, 8)), ((64, 64), (32, 32)),
    ((368, 432), (184, 216)),                               # down
    ((46, 54), (92, 27)), ((64, 64), (32, 128)),            # mixed
    ((46, 54), (46, 27))])                                  # one axis
def test_resize_linear_matches_jax(src, dst):
    x = np.random.default_rng(2).standard_normal(
        (2, *src, 5)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, *dst, 5),
                                      method="linear"))
    out = tengine.resize_linear(torch.from_numpy(x), dst)
    assert out.shape == ref.shape and out.is_contiguous()
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)


# ------------------------------------------------------- scale search ---

@pytest.mark.parametrize("scale,size", [(0.5, 184), (1.0, 368), (1.5, 552),
                                        (0.51, 184), (0.02, 8)])
def test_scaled_size_snaps_like_jax(scale, size):
    assert tengine.scaled_size(368, scale, 8) == size


@pytest.mark.parametrize("flip", [False, True])
def test_multiscale_avg_matches_jax(flip, monkeypatch):
    """Averaged maps within 1e-5 of scale; skeletons as in
    test_infer_matches_jax_engine."""
    jax_engine, engine = _engines()
    images = _images(4)
    ref = _jax_maps_of(jengine._infer_multiscale_impl, monkeypatch,
                       jax_engine, images, scales=SCALES, flip=flip, stride=8)
    out = _port_maps_of(lambda: engine.infer_multiscale(
        images, SCALES, flip_tta=flip), monkeypatch)
    assert out[1].shape == (2, 8, 8, 19) and out[2].shape == (2, 8, 8, 38)
    _maps_close(out[1:], ref[1:])
    _assert_humans_match(out[0], ref[0])


def test_multiscale_one_scale_equals_infer():
    _, engine = _engines()
    images = _images(7)
    _assert_batches_equal(engine.infer_multiscale(images, (1.0,)),
                          engine.infer(images))
    _assert_batches_equal(
        engine.infer_multiscale(_layout(images, 2), (1.0,), flip_tta=True),
        engine.infer(images, flip_tta=True))


def test_multiscale_dedup_matches_jax():
    """combine="dedup": (B, M * len(scales)) rows; masks and order exactly
    as the JAX engine's."""
    jax_engine, engine = _engines()
    images = _images(8)
    ref = jax_engine.infer_multiscale(images, SCALES, flip_tta=True,
                                      combine="dedup")
    out = engine.infer_multiscale(_layout(images, 2), SCALES, flip_tta=True,
                                  combine="dedup")
    assert out.coords.shape == (2, 32 * len(SCALES), 18, 2)
    _assert_humans_match(out, ref)
    assert int(out.num_humans.sum()) >= 1
    for b in range(2):
        k = int(out.num_humans[b])
        assert not out.valid[b, k:].any()
        assert (out.score[b, :k].diff() <= 0).all()


def test_multiscale_rejects_bad_combine():
    _, engine = _engines()
    with pytest.raises(ValueError, match="combine"):
        engine.infer_multiscale(_images(0), combine="max")
