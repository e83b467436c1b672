"""The port's kernel ops and its torch.export artifacts, on the CPU.

- Every hand kernel's dispatching wrapper is a registered
  `openpose_plus_tpu_torch::` op: its CPU route is bit-equal to the plain
  version, and `torch.library.opcheck` passes (schema, fake tensor, AOT
  dispatch).
- `save_engine` / `load_engine` (VGG-tiny 64x64 float32, batch 2) give
  exactly `Engine.infer`'s HumanBatch, and the JAX package's artifact's on
  the same images with bridged params (the tolerance of
  test_torch_engine.py's port-vs-JAX engine test); the exported graph
  holds the op nodes and the export takes well under 30 s.
- Layouts: an s2d^2 artifact takes plain images; a layout the model does
  not take raises; an uncalibrated int8 engine refuses to export.
- A fresh process that exports first and then runs eagerly gets the same
  result (no traced constant is cached), and `load_engine` in a fresh
  process imports neither `models` nor `engine`.
- The host s2d packers and the drawing colours equal the JAX package's.
"""

import dataclasses
import os
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util

from openpose_plus_tpu import config as jconfig
from openpose_plus_tpu import export as jexport
from openpose_plus_tpu.checkpoint import _flatten
from openpose_plus_tpu.engine import Engine as JaxEngine
from openpose_plus_tpu_torch import config as tconfig
from openpose_plus_tpu_torch import export as E
from openpose_plus_tpu_torch import host, skeletons
from openpose_plus_tpu_torch.engine import Engine
from openpose_plus_tpu_torch.models.common import space_to_depth
from openpose_plus_tpu_torch.ops.cuda import (bias_act, dw_probe, greedy,
                                              int8_conv, merge, paf_sample,
                                              peaks, sepconv)
from openpose_plus_tpu_torch.postproc import nms

import kernel_inputs

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPORT_LIMIT_S = 30.0


def _cfg(name="vggtiny", config=tconfig, **model):
    cfg = config.default_config(name)
    model = {"hin": 64, "win": 64, "n_stages": 2,
             "compute_dtype": "float32", **model}
    return cfg.replace(model=dataclasses.replace(cfg.model, **model))


def _images(seed, b=2, hw=64):
    return np.random.default_rng(seed).integers(0, 256, (b, hw, hw, 3),
                                                dtype=np.uint8)


def _same(a, b):
    for name in E.FIELDS:
        assert torch.equal(getattr(a, name), getattr(b, name)), name


_PAIR = {}


def _engines():
    """VGG-tiny: a JAX engine and a port engine on the same parameters,
    the last stage's prediction kernels scaled so that the random maps
    group into humans (as test_torch_engine.py does)."""
    if not _PAIR:
        flat = _flatten(jax.device_get(
            JaxEngine(_cfg(config=jconfig), seed=3).params))
        for branch, gain in (("conf", 400.0), ("paf", 1000.0)):
            key = f"params/stages/stage2_{branch}/Conv_0/kernel"
            flat[key] = np.asarray(flat[key]) * gain
        nested = traverse_util.unflatten_dict(
            {tuple(k.split("/")): v for k, v in flat.items()})
        _PAIR["jax"] = JaxEngine(_cfg(config=jconfig), params=nested)
        _PAIR["torch"] = Engine(_cfg(), params=flat, device="cpu")
    return _PAIR["jax"], _PAIR["torch"]


# ------------------------------------------------------------ the ops ---

def _op_cases():
    rng = np.random.default_rng(0)
    scores = torch.from_numpy(kernel_inputs.limb_scores(rng, 2, 5, 0.5))
    conns = [torch.from_numpy(x) for x in (
        *kernel_inputs.connections(rng, 2, 5),
        kernel_inputs.peak_scores(rng, 2, 5))]
    paf, sy, sx = (torch.from_numpy(a) for a in
                   kernel_inputs.paf_samples(rng, 2, 8, 9, 4))
    chans = paf_sample.limb_channels(torch.device("cpu"), skeletons.COCO18)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 5, 6, 8, generator=g).bfloat16()
    dwk = torch.randn(9, 8, generator=g).bfloat16()
    sep = (x, torch.randn(3, 3, 1, 8, generator=g),
           torch.randn(8, generator=g), torch.randn(1, 1, 8, 4, generator=g),
           torch.randn(4, generator=g))
    q, weight, bias, s_in, s_out = kernel_inputs.int8_conv_inputs(
        rng, 1, 6, 7, 20, 12, 3)
    qw, wmax = int8_conv.quantize_weight(torch.from_numpy(weight))
    conv = (torch.from_numpy(q), int8_conv.pack_weight(qw), 3,
            int8_conv.rescale(torch.tensor(s_in), wmax),
            torch.from_numpy(bias), 2, (0, 1), torch.tensor(s_out))
    # smoothed maps in the decode's einsum layout
    smoothed = nms.upsample_smooth(torch.rand(2, 6, 7, 19, generator=g), 2,
                                   1.25)

    def peaks_plain(*args):
        p = nms.find_peaks_plain(*args)
        return tuple(getattr(p, f) for f in peaks.FIELDS)

    return {
        "greedy_assign": (greedy.greedy_assign, greedy.greedy_assign_plain,
                          (scores, 5)),
        "assemble": (merge.assemble, merge.assemble_plain, (*conns, 5, 32)),
        "sample_paf": (paf_sample.sample_paf, paf_sample.sample_paf_plain,
                       (paf, sy, sx, chans)),
        "fused_sepconv": (sepconv.fused_sepconv, sepconv.fused_sepconv_plain,
                          sep),
        "int8_conv": (int8_conv.int8_conv, int8_conv.int8_conv_plain, conv),
        "int8_conv_bf16": (int8_conv.int8_conv, int8_conv.int8_conv_plain,
                           (*conv[:7], None)),
        "quantize_act": (int8_conv.quantize_act,
                         int8_conv.quantize_act_plain,
                         (x, torch.tensor(0.7))),
        "dw3x3_relu": (dw_probe.dw3x3_relu, dw_probe.dw3x3_relu_plain,
                       (x, dwk)),
        "copy_bias": (dw_probe.copy_bias, dw_probe.copy_bias_plain,
                      (x, dwk)),
        "find_peaks": (peaks.find_peaks, peaks_plain, (smoothed, 0.05, 4)),
        "bias_act": (bias_act.bias_act, bias_act.bias_act_plain,
                     (x.permute(0, 3, 1, 2), sep[2], sep[2])),
    }


@pytest.mark.parametrize("name", list(_op_cases()))
def test_op_cpu_route_is_the_plain_version(name):
    """The wrapper reaches the registered op, whose CPU kernel is the plain
    version (bit-equal, no aliasing of inputs) and which passes
    torch.library.opcheck."""
    wrapper, plain, args = _op_cases()[name]
    out, ref = wrapper(*args), plain(*args)
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    for o, r in zip(outs, refs, strict=True):
        assert o.dtype == r.dtype and torch.equal(o, r)
    op_name = name.removesuffix("_bf16")
    op = getattr(torch.ops.openpose_plus_tpu_torch, op_name).default
    if op_name == "int8_conv":      # the op takes the pads as int[]
        args = (*args[:6], list(args[6]), args[7])
    elif op_name == "fused_sepconv":
        args = args[:5]
    elif op_name == "bias_act":      # no second store
        args = (*args, None, 0)
    result = torch.library.opcheck(op, args)
    assert set(result.values()) == {"SUCCESS"}, result


# ----------------------------------------------------------- artifacts ---

def test_export_roundtrip_equals_infer_and_the_jax_artifact(tmp_path):
    jax_engine, engine = _engines()
    images = _images(0)
    t0 = time.perf_counter()
    E.save_engine(engine, str(tmp_path / "port"), batch_size=2)
    seconds = time.perf_counter() - t0
    assert seconds < EXPORT_LIMIT_S, seconds
    loaded = E.load_engine(str(tmp_path / "port"))
    assert loaded.manifest["format"] == "torch.export"
    assert loaded.manifest["model"] == "vggtiny"
    assert loaded.batch_size == 2
    assert loaded.config.model == engine.config.model
    assert loaded.config.postproc == engine.config.postproc
    out = loaded.infer(images)
    ref = engine.infer(images)
    _same(out, ref)
    assert int(ref.num_humans.sum()) >= 1      # grouping is exercised

    ops = {str(n.target) for n in loaded._program.graph.nodes
           if str(n.target).startswith("openpose_plus_tpu_torch.")}
    assert ops == {f"openpose_plus_tpu_torch.{op}.default"
                   for op in ("bias_act", "find_peaks", "greedy_assign",
                              "assemble", "sample_paf")}

    jexport.save_engine(jax_engine, str(tmp_path / "jax"), batch_size=2)
    jref = jexport.load_engine(str(tmp_path / "jax")).infer(images)
    for name in ("valid", "n_parts", "part_valid"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(jref, name)), name)
    for name in ("coords", "part_scores", "score"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(jref, name)), rtol=0,
                                   atol=1e-5, err_msg=name)


def test_s2d2_artifact_accepts_plain_images(tmp_path):
    cfg = _cfg("mobilenet_thin")
    engine = Engine(cfg, seed=0, device="cpu")
    E.save_engine(engine, str(tmp_path / "a"), batch_size=2,
                  input_layout="s2d2")
    loaded = E.load_engine(str(tmp_path / "a"))
    assert loaded.manifest["input_layout"] == "s2d2"
    images = _images(1)
    ref = engine.infer(images)
    _same(loaded.infer(images), ref)             # packed on the host
    packed = space_to_depth(space_to_depth(torch.from_numpy(images)))
    _same(loaded.infer(packed), ref)             # the baked layout as is


def test_export_rejects_what_the_reference_rejects(tmp_path):
    engine = Engine(_cfg(), seed=0, device="cpu")
    with pytest.raises(ValueError, match="not supported"):
        E.save_engine(engine, str(tmp_path / "x"), input_layout="s2d2")
    odd = Engine(_cfg(hin=63), seed=0, device="cpu")
    with pytest.raises(ValueError, match="not supported"):
        E.save_engine(odd, str(tmp_path / "y"), input_layout="s2d")
    with pytest.raises(ValueError, match="input_layout"):
        E.save_engine(engine, str(tmp_path / "z"), input_layout="nchw")
    int8 = Engine(_cfg(compute_dtype="int8"), seed=0, device="cpu")
    with pytest.raises(ValueError, match="calibrat"):
        E.save_engine(int8, str(tmp_path / "q"))
    assert not os.path.exists(tmp_path / "q")


def test_calibrated_int8_artifact_equals_infer(tmp_path):
    """The int8 ops (int8_conv, quantize_act) export and reload; the
    artifact serves the calibrated engine's HumanBatch."""
    engine = Engine(_cfg(compute_dtype="int8"), seed=0, device="cpu")
    images = _images(2)
    engine.calibrate(images)
    E.save_engine(engine, str(tmp_path / "q"), batch_size=2)
    loaded = E.load_engine(str(tmp_path / "q"))
    ops = {str(n.target) for n in loaded._program.graph.nodes}
    assert {"openpose_plus_tpu_torch.int8_conv.default",
            "openpose_plus_tpu_torch.quantize_act.default"} <= ops
    _same(loaded.infer(images), engine.infer(images))


_COLD = """
import dataclasses, sys
import numpy as np
import torch
from openpose_plus_tpu_torch import config, export
from openpose_plus_tpu_torch.engine import Engine
cfg = config.default_config("mobilenet_thin")
cfg = cfg.replace(model=dataclasses.replace(
    cfg.model, hin=64, win=64, n_stages=2, compute_dtype=sys.argv[2]))
engine = Engine(cfg, seed=0, device="cpu")
images = np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3),
                                           dtype=np.uint8)
if sys.argv[2] == "int8":
    engine.calibrate(images)
export.save_engine(engine, sys.argv[1], batch_size=2)   # before any infer
out = engine.infer(images)
np.savez(sys.argv[1] + "/eager.npz",
         **{f: getattr(out, f).numpy() for f in export.FIELDS})
"""

_LOAD = """
import sys
import numpy as np
from openpose_plus_tpu_torch import export
engine = export.load_engine(sys.argv[1])
images = np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3),
                                           dtype=np.uint8)
out = engine.infer(images)
ref = np.load(sys.argv[1] + "/eager.npz")
for f in export.FIELDS:
    assert np.array_equal(getattr(out, f).numpy(), ref[f]), f
bad = sorted(m for m in sys.modules if m.startswith((
    "openpose_plus_tpu_torch.models", "openpose_plus_tpu_torch.engine",
    "jax", "openpose_plus_tpu.")) or m == "openpose_plus_tpu")
print("LOADED", bad)
sys.exit(1 if bad else 0)
"""


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_cold_process_export_then_eager_then_load(tmp_path, dtype):
    """In a fresh process, export first: the constants traced then
    (decoder tables, int8 scalars and weights) are not cached, so the
    eager infer after it runs and matches; another fresh process loads
    the artifact, equals that eager result, and imports no model code."""
    env = dict(os.environ, PYTHONPATH=REPO)
    path = str(tmp_path / "art")
    for script in (_COLD, _LOAD):
        proc = subprocess.run([sys.executable, "-c", script, path, dtype],
                              cwd=REPO, env=env, capture_output=True,
                              text=True, timeout=300)
        assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout


# ------------------------------------------------------ pinned copies ---

@pytest.mark.parametrize("level,hw", [(1, (6, 10)), (2, (8, 12))])
def test_host_packers_equal_the_jax_package(monkeypatch, level, hw):
    from openpose_plus_tpu import native
    from openpose_plus_tpu import skeleton as jskeleton
    from openpose_plus_tpu_torch import skeleton

    monkeypatch.setattr(native, "_load", lambda: None)   # numpy paths
    image = np.random.default_rng(level).integers(0, 256, (*hw, 3),
                                                  dtype=np.uint8)
    pack = (native.s2d_u8, native.s2d2_u8)[level - 1]
    np.testing.assert_array_equal(host.pack(image, level), pack(image))
    on_device = torch.from_numpy(image[None])
    for _ in range(level):
        on_device = space_to_depth(on_device)
    np.testing.assert_array_equal(host.pack(image, level), on_device[0])
    packed = pack(image)
    np.testing.assert_array_equal(host.d2s_u8(packed), native.d2s_u8(packed))
    np.testing.assert_array_equal(host.d2s_u8(packed), image)
    assert host.pack(image, 0) is image
    with pytest.raises(ValueError):
        host.pack(image[:, :-1], level)
    assert skeleton.COCO_COLORS == jskeleton.COCO_COLORS
    assert skeleton.COCO_PAIRS_RENDER == jskeleton.COCO_PAIRS_RENDER
