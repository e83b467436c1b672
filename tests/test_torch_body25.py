"""OpenPose BODY_25 in the port (`models/body25.py`, `skeletons.py`, the
25-part decode) against `tests/plain_body25.py` and the benchmark's plain
grouping, on the CPU.

- The forward on seeded weights at 1x64x96 and 2x48x80: float32 equal to
  the plain reference within 1e-5 of the maps' largest magnitude (the same
  float32 operations; only a backend's summation order may differ); bf16
  within 5e-2 of it against the reference that rounds to bf16 what a bf16
  network stores. That is wider than the 2e-2 the VGG19 tests hold a
  two-stage network to: BODY_25 runs 115 bf16 convs, and one bf16 unit
  of a conv's output differing in 0.02-0.04% of the elements (measured
  on this CPU) grows to 1.0-3.0% of the largest map value at the last
  stage over eight weight and input draws. Each bf16 layer on the port's
  own input is held to the plain layer within 2e-2. A skipped PReLU or a
  wrong concat member moves the maps by 47-117%, far past both bounds
  (checked below on the plain reference itself).
- The state_dict's names and shapes, the dense-block counter and the
  model's spans; what BODY_25 refuses.
- The skeleton tables against the benchmark's skeleton files, and the
  lookup by channel counts.
- The 25-part decode's plain path against the benchmark's plain grouping
  (`benchmark/reference`) on hand-built BODY_25 maps, and a CPU engine
  serving 25-part people.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import sys

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from openpose_plus_tpu_torch import skeletons
from openpose_plus_tpu_torch.config import PostprocConfig, default_config
from openpose_plus_tpu_torch.engine import Engine
from openpose_plus_tpu_torch.models import common, get_model
from openpose_plus_tpu_torch.postproc import decode_maps, merge_dedup
from openpose_plus_tpu_torch.postproc.flip import mirror_maps
from openpose_plus_tpu_torch.utils.tracer import GLOBAL_TRACER

from tests import kernel_inputs, plain_body25

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
F32_TOL = 1e-5
BF16_TOL = 5e-2          # the whole network (module docstring)
BF16_LAYER_TOL = 2e-2    # one layer on the port's own input
SHAPES = [(1, 64, 96), (2, 48, 80)]


def _model(dtype: str, hin: int = 64, win: int = 96, **kw):
    cfg = dataclasses.replace(default_config("body25").model, hin=hin,
                              win=win, compute_dtype=dtype, **kw)
    return get_model(cfg)


def _weights(model, seed: int) -> dict:
    """Seeded: kernels at He scale, biases at 0.05, PReLU slopes about
    zero at 0.25."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for name, p in model.state_dict().items():
        if name.endswith("weight") and p.dim() > 1:
            std = math.sqrt(2.0 / p[0].numel())
        elif name.endswith("slope"):
            std = 0.25
        else:
            std = 0.05
        sd[name] = torch.randn(p.shape, generator=g) * std
    return sd


_CACHE: dict = {}


def _outputs(dtype: str, shape: tuple) -> tuple[dict, dict, dict]:
    """(port outputs, plain outputs, weights) of one seeded draw."""
    key = (dtype, shape)
    if key not in _CACHE:
        b, h, w = shape
        model = _model(dtype, h, w)
        sd = _weights(model, seed=b * 1000 + h)
        model.load_state_dict(sd)
        x = torch.rand(b, h, w, 3, generator=torch.Generator().manual_seed(
            h + w)) - 0.5
        with torch.no_grad():
            out = model(x)
        ref = plain_body25.forward(x, sd, bf16=dtype == "bfloat16")
        _CACHE[key] = (out, ref, sd)
    return _CACHE[key]


def _rel(out: torch.Tensor, ref: torch.Tensor) -> float:
    return float((out.float() - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_plain_reference(dtype, shape):
    out, ref, _ = _outputs(dtype, shape)
    b, h, w = shape
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    assert [t.shape for t in out["paf"]] == [(b, h // 8, w // 8, 52)] * 4
    assert [t.shape for t in out["conf"]] == [(b, h // 8, w // 8, 26)] * 2
    assert out["feature"].shape == (b, h // 8, w // 8, 128)
    for key in ("conf", "paf"):
        for o, r in zip(out[key], ref[key], strict=True):
            assert o.dtype == torch.float32
            assert float(r.abs().max()) > 0.5
            assert _rel(o, r) <= tol, (key, _rel(o, r))
    assert _rel(out["feature"], ref["feature"]) <= tol


def test_bf16_layers_match_plain_layers():
    """Every conv of the bf16 port on the input the port gave it, against
    the plain layer (rounded as a bf16 network stores) on that input, then
    the 2x2 max pool where the conv ends a pooled VGG block; each dense
    block's output is its three convs' outputs in order."""
    model = _model("bfloat16", 48, 80)
    sd = _weights(model, seed=7)
    model.load_state_dict(sd)
    seen: dict = {}
    pooled = set()

    def hook(name):
        def fn(module, args, kwargs, out):
            seen[name] = (module, args[0], out)
            if kwargs.get("pool"):
                pooled.add(name)
        return fn

    for name, m in model.named_modules():
        if isinstance(m, (common.PReLUConv, common.ConvRelu,
                          common.DenseBlock, common.Conv1x1F32)):
            m.register_forward_hook(hook(name), with_kwargs=True)
    x = torch.rand(2, 48, 80, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        model(x - 0.5)
    r = plain_body25._bf16
    kinds = {"prelu": 0, "relu": 0, "dense": 0, "head": 0}
    for name, (m, inp, out) in seen.items():
        inp = inp.float()
        if isinstance(m, common.PReLUConv):
            want, kind = plain_body25.conv_prelu(inp, sd, name, r), "prelu"
        elif isinstance(m, common.ConvRelu):
            want = plain_body25.relu(plain_body25.conv(inp, sd, name, r))
            if name in pooled:
                want = torch.nn.functional.max_pool2d(want, 2, 2)
            kind = "relu"
        elif isinstance(m, common.Conv1x1F32):
            want, kind = plain_body25.predict(inp, sd, name), "head"
        else:
            parts = [seen[f"{name}.conv{i}"][2] for i in range(3)]
            assert torch.equal(out, torch.cat(parts, dim=1))
            kinds["dense"] += 1
            continue
        kinds[kind] += 1
        assert float((out.float() - want).abs().max()) <= (
            BF16_LAYER_TOL * float(want.abs().max())), name
    assert kinds == {"prelu": 3 + 6 * 16, "relu": 9, "dense": 30,
                     "head": 6}
    assert pooled == {"conv1_2", "conv2_2", "conv3_4"}


def _mutated(kind: str, x: torch.Tensor, sd: dict) -> dict:
    """The plain reference (bf16-stored) with, in the last dense block of
    the last heatmap stage, the last conv's PReLU skipped or the concat of
    [a, b, b] for [a, b, c]."""
    last = "stages.stage1_L1.Mconv5"
    conv_prelu, dense_stage = plain_body25.conv_prelu, plain_body25.dense_stage

    def skip(x, sd, name, r):
        if name == f"{last}.conv2":
            return plain_body25.conv(x, sd, name, r)
        return conv_prelu(x, sd, name, r)

    def wrong(x, sd, name, r):
        if name != "stages.stage1_L1":
            return dense_stage(x, sd, name, r)
        for i in range(1, plain_body25.N_BLOCKS + 1):
            a = conv_prelu(x, sd, f"{name}.Mconv{i}.conv0", r)
            b = conv_prelu(a, sd, f"{name}.Mconv{i}.conv1", r)
            c = conv_prelu(b, sd, f"{name}.Mconv{i}.conv2", r)
            x = torch.cat([a, b, b if i == plain_body25.N_BLOCKS else c], 1)
        x = conv_prelu(x, sd, f"{name}.Mconv6", r)
        return plain_body25.predict(x, sd, f"{name}.Mconv7")

    try:
        if kind == "skipped_prelu":
            plain_body25.conv_prelu = skip
        else:
            plain_body25.dense_stage = wrong
        return plain_body25.forward(x, sd, bf16=True)
    finally:
        plain_body25.conv_prelu = conv_prelu
        plain_body25.dense_stage = dense_stage


@pytest.mark.parametrize("kind", ["skipped_prelu", "wrong_concat"])
def test_bounds_catch_a_skipped_prelu_or_concat_member(kind):
    _, ref, sd = _outputs("bfloat16", SHAPES[0])
    b, h, w = SHAPES[0]
    x = torch.rand(b, h, w, 3, generator=torch.Generator().manual_seed(
        h + w)) - 0.5
    bad = _mutated(kind, x, sd)
    assert _rel(bad["conf"][-1], ref["conf"][-1]) > 4 * BF16_TOL


def test_state_dict_names_and_shapes():
    sd = _model("bfloat16").state_dict()
    assert len(sd) == 327
    assert sum(t.numel() for t in sd.values()) == 26_166_084
    assert sd["conv4_1.weight"].shape == (512, 256, 3, 3)
    assert sd["conv4_2.weight"].shape == (512, 512, 3, 3)
    assert sd["conv4_3_cpm.weight"].shape == (256, 512, 3, 3)
    assert sd["conv4_4_cpm.slope"].shape == (128,)
    expect = {"stage0_L2": (128, 96, 256, 52),
              "stage1_L2": (180, 128, 512, 52),
              "stage3_L2": (180, 128, 512, 52),
              "stage0_L1": (180, 96, 256, 26),
              "stage1_L1": (206, 128, 512, 26)}
    for stage, (cin, width, proj, out) in expect.items():
        p = f"stages.{stage}"
        assert sd[f"{p}.Mconv1.conv0.weight"].shape == (width, cin, 3, 3)
        assert sd[f"{p}.Mconv1.conv2.weight"].shape == (width, width, 3, 3)
        assert sd[f"{p}.Mconv2.conv0.weight"].shape == (width, 3 * width,
                                                        3, 3)
        assert sd[f"{p}.Mconv5.conv2.slope"].shape == (width,)
        assert sd[f"{p}.Mconv6.weight"].shape == (proj, 3 * width, 1, 1)
        assert sd[f"{p}.Mconv7.weight"].shape == (out, proj, 1, 1)
    slopes = [k for k in sd if k.endswith(".slope")]
    assert len(slopes) == 3 + 6 * 16
    # a slope is never named as a bias or a conv kernel
    assert all(sd[k].dim() == 4 for k in sd if k.endswith(".weight"))
    assert {k.rsplit(".", 1)[1] for k in sd} == {"weight", "bias", "slope"}


def test_init_draws_slopes_at_caffe_default():
    model = _model("float32")
    common.init_params(model, torch.Generator().manual_seed(0))
    sd = model.state_dict()
    assert all(torch.all(sd[k] == common.PRELU_INIT)
               for k in sd if k.endswith(".slope"))
    assert all(torch.all(sd[k] == 0) for k in sd if k.endswith(".bias"))


def test_dense_blocks_counted_and_model_spans_recorded():
    model = _model("float32", 32, 48)
    x = torch.zeros(1, 32, 48, 3)
    with torch.no_grad():
        model(x)                               # off: nothing recorded
        with GLOBAL_TRACER.recording() as rec:
            model(x)
    assert rec.counters == {"models.dense_blocks": 30, "ops.bias_act": 108,
                            "ops.bias_act_pool": 3}
    names = [s.name for s in rec.spans]
    assert names == ["models.front", "models.paf_stages",
                     "models.conf_stages"]
    assert all(s.parent is None for s in rec.spans)
    assert rec.spans[0].end_ns <= rec.spans[1].start_ns


@pytest.mark.parametrize("kw", [
    {"n_stages": 2}, {"n_stages": 7}, {"compute_dtype": "int8"},
    {"fused_inference": True}, {"n_heatmaps": 19, "n_pafs": 38}], ids=str)
def test_refuses_what_it_would_get_wrong(kw):
    with pytest.raises(ValueError, match="BODY_25"):
        _model(kw.pop("compute_dtype", "bfloat16"), **kw)


def test_refuses_training():
    model = _model("float32", 32, 48)
    assert not model.training
    with pytest.raises(ValueError, match="inference only"):
        model.train()
    with pytest.raises(ValueError, match="inference only"):
        model(torch.zeros(1, 32, 48, 3))       # grad enabled
    model.eval()                               # train(False) is fine


def _json_skeleton(name: str) -> dict:
    with open(os.path.join(BENCH, "reference", "skeletons",
                           f"{name}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("skel", skeletons.SKELETONS, ids=lambda s: s.name)
def test_skeleton_equals_benchmark_file(skel):
    d = _json_skeleton(skel.name)
    assert d["name"] == skel.name and d["parts"] == skel.n_parts
    assert [tuple(p) for p in d["limbs"]] == list(skel.limbs)
    assert [tuple(c) for c in d["paf_channels"]] == list(skel.paf_channels)
    assert d["person_limbs"] == skel.person_limbs
    assert sorted(c for pair in skel.paf_channels for c in pair) == list(
        range(skel.n_pafs))


def test_skeleton_lookup():
    assert skeletons.for_maps(19, 38) is skeletons.COCO18
    assert skeletons.for_maps(26, 52) is skeletons.BODY25
    assert skeletons.find(n_parts=25) is skeletons.BODY25
    assert skeletons.find(n_heatmaps=19, n_limbs=19) is skeletons.COCO18
    for bad in ((19, 52), (26, 38), (18, 38), (25, 52)):
        with pytest.raises(ValueError, match="no skeleton"):
            skeletons.for_maps(*bad)
    with pytest.raises(ValueError, match="no skeleton"):
        skeletons.find(n_parts=17)
    with pytest.raises(ValueError, match="no skeleton"):
        decode_maps(torch.zeros(1, 8, 8, 19), torch.zeros(1, 8, 8, 52),
                    PostprocConfig())


def test_geometry_matches_benchmark_config():
    """default_config("body25") and the model it builds give the
    benchmark configuration's model section."""
    with open(os.path.join(BENCH, "configs", "body25-368x656.json")) as f:
        model = json.load(f)["model"]
    cfg = dataclasses.replace(default_config("body25").model,
                              hin=model["hin"], win=model["win"])
    for key, value in model.items():
        assert getattr(cfg, key) == value, key
    # shapes only: fake tensors, the ops through their fake implementations
    with FakeTensorMode(), torch.no_grad():
        out = get_model(cfg)(torch.empty(1, model["hin"], model["win"], 3))
    hout, wout = model["hin"] // model["stride"], model["win"] // 8
    assert out["conf"][-1].shape == (1, hout, wout, model["n_heatmaps"])
    assert out["paf"][-1].shape == (1, hout, wout, model["n_pafs"])
    assert len(out["conf"]) + len(out["paf"]) == model["n_stages"]


def _reference_decode():
    if BENCH not in sys.path:
        sys.path.insert(0, BENCH)
    from reference import decode as rdecode, oracle

    return rdecode, oracle


@pytest.mark.parametrize("noise", [0.0, 0.05])
@pytest.mark.parametrize("fidelity", [False, True])
def test_decode_at_25_parts_matches_plain_grouping(fidelity, noise):
    """Hand-built BODY_25 maps (three figures, and two more with parts
    missing) through the port's decode on the CPU, against the
    benchmark's plain grouping on the body25 skeleton file: the same
    people, parts and keypoints."""
    rdecode, oracle = _reference_decode()
    people = [kernel_inputs.standing_person_25(11.37 + 15.61 * i,
                                               21.43 - 0.7 * i)
              for i in range(3)]
    partial = [{p: xy for p, xy in kernel_inputs.standing_person_25(
        14.2 + 20.3 * i, 40.1).items() if p not in (1, 8)} for i in range(2)]
    maps = [kernel_inputs.make_maps(people, 46, 54, noise=noise,
                                    skel=skeletons.BODY25),
            kernel_inputs.make_maps(partial, 52, 54, noise=noise, seed=1,
                                    skel=skeletons.BODY25)]
    pp = PostprocConfig().fidelity() if fidelity else PostprocConfig()
    found = 0
    for conf, paf in maps:
        conf, paf = torch.from_numpy(conf[None]), torch.from_numpy(paf[None])
        hb = decode_maps(conf, paf, pp)
        assert hb.coords.shape == (1, pp.max_humans, 25, 2)
        ref, _ = rdecode.decode(conf, paf, dataclasses.asdict(pp),
                                oracle.load_skeleton("body25"), workers=1)
        rows = np.nonzero(hb.valid[0].numpy())[0]
        assert len(rows) == len(ref[0])
        got = sorted([(int(p), float(hb.coords[0, m, p, 0]),
                       float(hb.coords[0, m, p, 1]))
                      for p in np.nonzero(hb.part_valid[0, m].numpy())[0]]
                     for m in rows)
        want = sorted([(p, x, y) for p, (x, y, _) in sorted(h.parts.items())]
                      for h in ref[0])
        for g, r in zip(got, want):
            assert [p for p, _, _ in g] == [p for p, _, _ in r]
            assert np.allclose(np.array(g)[:, 1:], np.array(r)[:, 1:],
                               atol=1e-5)
        found += len(rows)
    assert found >= 3


def test_engine_serves_25_part_people_on_the_cpu():
    """uint8 images through `Engine.infer` on the CPU: 25-part HumanBatch;
    flip-TTA and the OKS dedup, which hold COCO's tables, refuse."""
    cfg = default_config("body25")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, hin=48, win=64))
    engine = Engine(cfg, seed=0, device="cpu")
    images = np.random.default_rng(0).integers(0, 256, (2, 48, 64, 3),
                                               dtype=np.uint8)
    hb = engine.infer(images)
    assert hb.coords.shape == (2, cfg.postproc.max_humans, 25, 2)
    assert hb.part_valid.shape == (2, cfg.postproc.max_humans, 25)
    conf, paf = engine.forward(images)
    assert (conf.shape[-1], paf.shape[-1]) == (26, 52)
    with pytest.raises(ValueError, match="COCO"):
        mirror_maps(conf, paf)
    with pytest.raises(ValueError, match="COCO"):
        merge_dedup([hb, hb])
