"""The port's own copies of the JAX package's jax-free modules, pinned to
the originals.

- `openpose_plus_tpu_torch.config`: every preset `default_config` gives for
  the JAX package's model names (every section: model, postproc, data,
  train, parallel), with its `fidelity()` and `quality()` post-processing
  presets, equal field for field (`dataclasses.asdict`);
  the ModelConfig geometry helpers and `train_lowering()` give the same
  answers.
- `openpose_plus_tpu_torch.skeleton`: every table `np.array_equal`.
- `tests/kernel_inputs.py`'s scene functions (chip_smoke.py's, on the port's
  skeleton) give `tests/maputil.py`'s maps for the scenes chip_smoke draws.
"""

import dataclasses

import numpy as np
import pytest

from openpose_plus_tpu import config as jconfig, skeleton as jskeleton
from openpose_plus_tpu.models import model_names
from openpose_plus_tpu_torch import config as tconfig, skeleton as tskeleton
from openpose_plus_tpu_torch.models import model_names as tmodel_names

from tests import kernel_inputs, maputil

_NAMES = [None, *model_names()]


_SECTIONS = ["model", "postproc", "data", "train", "parallel"]


def _sections(cfg):
    """The sections of a Config the port keeps (all of them)."""
    return {k: v for k, v in dataclasses.asdict(cfg).items()
            if k in _SECTIONS}


@pytest.mark.parametrize("name", _NAMES)
def test_default_config_matches_jax(name):
    """Every JAX model name; the port's names are those and its own
    (`PORT_ONLY_MODELS`), whose presets set their map channels."""
    names = set(tmodel_names()) - set(tconfig.PORT_ONLY_MODELS)
    assert names == set(_NAMES[1:])
    for own, channels in tconfig.PORT_ONLY_MODELS.items():
        assert dataclasses.asdict(tconfig.default_config(own).model) == \
            dataclasses.asdict(dataclasses.replace(
                tconfig.ModelConfig(), name=own, **channels))
    ref = jconfig.default_config(name)
    out = tconfig.default_config(name)
    assert dataclasses.asdict(out) == _sections(ref)
    assert list(dataclasses.asdict(out)) == _SECTIONS
    for section in _SECTIONS:
        fields = [f.name for f in dataclasses.fields(getattr(out, section))]
        assert fields == [f.name for f in dataclasses.fields(
            getattr(ref, section))], section


@pytest.mark.parametrize("upsample", [None, 4])
@pytest.mark.parametrize("preset", ["fidelity", "quality"])
def test_postproc_presets_match_jax(preset, upsample):
    kw = {} if upsample is None else {"upsample": upsample}
    ref = getattr(jconfig.PostprocConfig(), preset)(**kw)
    out = getattr(tconfig.PostprocConfig(), preset)(**kw)
    assert isinstance(out, tconfig.PostprocConfig)
    assert dataclasses.asdict(out) == dataclasses.asdict(ref)
    cfg = tconfig.default_config("mobilenet_thin")
    via_replace = cfg.replace(postproc=getattr(cfg.postproc, preset)(**kw))
    assert dataclasses.asdict(via_replace) == _sections(
        jconfig.default_config("mobilenet_thin").replace(
            postproc=ref))


@pytest.mark.parametrize("kw", [
    {}, {"hin": 66, "win": 70}, {"hin": 65, "win": 64},
    {"compute_dtype": "int8"}, {"stem_s2d": False}, {"name": "vgg19"},
    {"hin": 184, "win": 216, "stride": 4}], ids=str)
def test_model_geometry_matches_jax(kw):
    ref = dataclasses.replace(jconfig.ModelConfig(), **kw)
    out = dataclasses.replace(tconfig.ModelConfig(), **kw)
    assert dataclasses.asdict(out) == dataclasses.asdict(ref)
    assert out.preferred_input_layout() == ref.preferred_input_layout()
    assert (out.hout, out.wout) == (ref.hout, ref.wout)
    for level in (None, 0, 1, 2):
        assert out.input_shape(3, level) == ref.input_shape(3, level)


@pytest.mark.parametrize("table", [
    "N_PARTS", "N_HEATMAPS", "N_LIMBS", "N_PAF_CHANNELS", "COCO_PAIRS",
    "COCO_PAIRS_NETWORK", "FLIP_SWAP_PAIRS", "COCO_FROM_OPENPOSE",
    "COCO_OKS_SIGMAS", "pairs_array", "paf_channels_array",
    "OPENPOSE_FROM_COCO", "COCO_PAIRS_RENDER", "COCO_COLORS"])
def test_skeleton_tables_match_jax(table):
    ref, out = getattr(jskeleton, table), getattr(tskeleton, table)
    if callable(ref):
        ref, out = ref(), out()
    assert type(out) is type(ref)
    assert np.asarray(out).dtype == np.asarray(ref).dtype
    assert np.array_equal(np.asarray(out), np.asarray(ref))


def test_coco_part_enum_matches_jax():
    assert ([(p.name, int(p)) for p in tskeleton.CocoPart]
            == [(p.name, int(p)) for p in jskeleton.CocoPart])


@pytest.mark.parametrize("kw", [{}, {"stem_s2d": False},
                                {"compute_dtype": "float32"}], ids=str)
@pytest.mark.parametrize("name", _NAMES[1:])
def test_train_lowering_matches_jax(name, kw):
    """`train_lowering()` gives the JAX package's config for every model
    name (VGG19 trains with stem_s2d off), so the s2d layout gate agrees."""
    ref = dataclasses.replace(jconfig.default_config(name).model, **kw)
    out = dataclasses.replace(tconfig.default_config(name).model, **kw)
    ref_t, out_t = ref.train_lowering(), out.train_lowering()
    assert dataclasses.asdict(out_t) == dataclasses.asdict(ref_t)
    assert out_t.preferred_input_layout() == ref_t.preferred_input_layout()


def test_port_skeleton_has_only_copied_names():
    """Every public name of the port's skeleton is one of the JAX
    package's (a copy, not a new table)."""
    names = {n for n in vars(tskeleton) if not n.startswith("_")}
    names -= {"annotations", "np", "enum"}
    assert names <= set(vars(jskeleton))


def _three_people(scenes):
    return [scenes.standing_person(11.37 + 15.61 * i, 21.43 - 0.7 * i,
                                   0.93 + 0.1 * i) for i in range(3)]


def _truncated(scenes):
    people = []
    for cx, cy, s in ((13.37, 21.43, 1.0), (39.61, 22.1, 1.1)):
        person = scenes.standing_person(cx, cy, s)
        people.append({p: xy for p, xy in person.items()
                       if p not in (1, 16, 17)})
    return people


@pytest.mark.parametrize("scene,noise", [
    (_three_people, 0.0), (_truncated, 0.0), (_three_people, 0.05)],
    ids=["three_people", "truncated", "three_people_noisy"])
def test_scene_maps_match_maputil(scene, noise):
    """chip_smoke.py's scenes (46x54, the served output grid), from the
    JAX-free scene functions, equal to tests/maputil.py's."""
    people = scene(kernel_inputs)
    assert people == scene(maputil)
    out = kernel_inputs.make_maps(people, 46, 54, noise=noise, seed=3)
    ref = maputil.make_maps(people, 46, 54, noise=noise, seed=3)
    for o, r in zip(out, ref):
        assert o.dtype == r.dtype == np.float32
        np.testing.assert_array_equal(o, r)
