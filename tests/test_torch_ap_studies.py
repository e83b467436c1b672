"""The port's accuracy studies (`ap_bench`) vs scripts/ap_benchmark.py, on
the CPU.

- Variant wiring: each variant of the JAX script's tuples builds the same
  engine config (postproc, compute dtype) and evaluation arguments (flip,
  scales, combiner), `Engine` and `evaluate_engine` stubbed in both.
- Control flow: `run_model(ms_study=)` at each tier, `run_large` and
  `run_curve`, with training, evaluation and the scene banks stubbed in
  both, evaluate the same variants on the same banks and weights in the
  same order and record the same keys and stamped fields; a second call
  evaluates nothing.
- `print_table` prints the JAX script's tables for one results dict.
- `train_model(snapshots=)` writes the JAX names at the JAX schedule, and
  a second call trains nothing.
- `data.synthetic.standing_person` and `synthetic_e2e`'s dataset writer
  equal the JAX side's (tests/maputil.py, scripts/synthetic_e2e.py).
"""

import dataclasses
import importlib.util
import json
import os
import types

import cv2
import numpy as np
import pytest
import torch

import maputil
from openpose_plus_tpu import config as jconfig
from openpose_plus_tpu import train as jtrain
from openpose_plus_tpu_torch import ap_bench, ap_oracle
from openpose_plus_tpu_torch import config as tconfig
from openpose_plus_tpu_torch import synthetic_e2e
from openpose_plus_tpu_torch.data import synthetic
from openpose_plus_tpu_torch.eval_coco import EvalResult

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def apb(monkeypatch, tmp_path):
    """scripts/ap_benchmark.py writing under tmp_path."""
    module = jax_script("ap_benchmark")
    monkeypatch.setattr(module, "RESULTS_PATH", str(tmp_path / "jax.json"))
    monkeypatch.setattr(module, "BANK_DIR", str(tmp_path / "jax_bank"))
    return module


ALL_VARIANTS = sorted(set(
    ap_bench.VARIANTS + ap_bench.INT8_VARIANTS + ap_bench.MS_STUDY_VARIANTS
    + ap_bench.FM_VARIANTS + ap_bench.LARGE_VARIANTS))


def test_variant_tuples_are_the_scripts():
    """The variant tuples, scale sets and tiers are ap_benchmark.py's."""
    ref = jax_script("ap_benchmark")
    for name in ("MODELS", "VARIANTS", "MS_STUDY_VARIANTS", "FM_VARIANTS",
                 "LARGE_VARIANTS", "MS_SCALES", "GEOMETRIES"):
        assert getattr(ap_bench, name) == getattr(ref, name), name
    assert ap_bench.INT8_VARIANTS == ref.EXTRA_VARIANTS
    assert ALL_VARIANTS == sorted(set(
        ref.VARIANTS + ref.EXTRA_VARIANTS + ref.MS_STUDY_VARIANTS
        + ref.FM_VARIANTS + ref.LARGE_VARIANTS))


class _Paths:
    """A dataset stand-in: only the calibration reads it (image paths)."""

    def __init__(self, tag):
        self.tag = tag

    def __getitem__(self, i):
        return types.SimpleNamespace(image_path=f"{self.tag}/{i}.jpg")


def _wiring(monkeypatch, engine_module, eval_module, cfg, run):
    """run(cfg) with `Engine` and `evaluate_engine` recording what they
    were given; returns (config, calibration paths, eval kwargs, row)."""
    seen = {}

    class Engine:
        def __init__(self, config, params=None, **kwargs):
            seen["config"] = config

        def calibrate_from_paths(self, paths, **kwargs):
            seen["calib"] = list(paths)

    def evaluate_engine(engine, dataset, batch_size=8, **kwargs):
        seen["kwargs"] = dict(kwargs, batch_size=batch_size)
        return EvalResult(0.5, 0.6, 0.4, 0.7, 1, 1)
    monkeypatch.setattr(engine_module, "Engine", Engine)
    monkeypatch.setattr(eval_module, "evaluate_engine", evaluate_engine)
    out = run(cfg)
    out.pop("eval_seconds")
    return seen["config"], seen.get("calib"), seen["kwargs"], out


@pytest.mark.parametrize("variant", ALL_VARIANTS)
def test_variant_wiring_matches_jax(variant, monkeypatch):
    """Each variant's engine config (postproc, compute dtype), calibration
    (train paths, int8 only), evaluation arguments (flip, scales, combiner)
    and row fields equal scripts/ap_benchmark.py's eval_variant's."""
    import openpose_plus_tpu.engine as jengine
    import openpose_plus_tpu.eval_coco as jeval
    import openpose_plus_tpu_torch.engine as tengine
    import openpose_plus_tpu_torch.eval_coco as teval

    ref = jax_script("ap_benchmark")
    j = _wiring(monkeypatch, jengine, jeval, jconfig.default_config(
        "mobilenet_thin"), lambda cfg: ref.eval_variant(
            cfg, None, variant, None, calib_dataset=_Paths("train")))
    t = _wiring(monkeypatch, tengine, teval, tconfig.default_config(
        "mobilenet_thin"), lambda cfg: ap_bench.eval_variant(
            cfg, None, variant, None, device="cpu",
            calib_dataset=_Paths("train")))
    assert (dataclasses.asdict(t[0].postproc)
            == dataclasses.asdict(j[0].postproc))
    assert t[0].model.compute_dtype == j[0].model.compute_dtype
    assert t[1:] == j[1:]
    assert ("scales" in t[2]) == (variant in ap_bench.MS_SCALES)


# ------------------------------------------------------ control flow ----

def _stub_studies(monkeypatch, module, synthetic_module, coco_module,
                  ckpt_module, port: bool) -> list:
    """Stubs `module`'s train_model and eval_variant, the scene banks, the
    dataset and the npz loader; returns the log of what they were given:
    ("train", model, steps, lr, hin, snapshots) and ("eval", variant,
    bank, weights, calibration bank)."""
    log = []

    def train_model(model, steps, lr, ann, imgs, geo, snapshots=(),
                    lr_scaling="none", **kwargs):
        log.append(("train", model, steps, lr, geo["hin"], tuple(snapshots),
                    lr_scaling, ann))
        return ("cfg", "weights", {}) if port else ("cfg", "weights")

    def eval_variant(cfg, params, variant, dataset, device=None,
                     calib_dataset=None):
        log.append(("eval", variant, dataset.ann, params,
                    None if calib_dataset is None else calib_dataset.ann))
        out = {"ap": 0.25, "ap50": 0.5, "ap75": 0.125, "ar": 0.375,
               "eval_seconds": 0.0}
        if variant in module.MS_SCALES:
            out["scales"] = list(module.MS_SCALES[variant])
        return out

    class Dataset:
        def __init__(self, ann, imgs):
            self.ann = ann

    monkeypatch.setattr(module, "train_model", train_model)
    monkeypatch.setattr(module, "eval_variant", eval_variant)
    monkeypatch.setattr(synthetic_module, "make_scene_bank",
                        lambda out_dir, split, n, size: (
                            f"{split}/{n}x{size}", "images"))
    monkeypatch.setattr(coco_module, "CocoPoseDataset", Dataset)
    monkeypatch.setattr(ckpt_module, "load_npz", lambda path, *args: (
        "npz " + os.path.basename(path)))
    if port:
        monkeypatch.setattr(ckpt_module, "from_flax", lambda flat: flat)
    return log


STUDIES = {
    "model_small_ms": ("run_model", dict(geometry="small", ms_study=True)),
    "model_serving_ms": ("run_model", dict(geometry="serving",
                                           ms_study=True)),
    "model_serving_all": ("run_model", dict(geometry="serving",
                                            ms_study=True, frag_merge=True,
                                            int8=True)),
    "model_lrrule_fm": ("run_model", dict(geometry="small", frag_merge=True,
                                          lr_scaling="inv-sqrt-area")),
    "large": ("run_large", {}),
    "curve_small": ("run_curve", dict(geometry="small")),
    "curve_serving": ("run_curve", dict(geometry="serving")),
}


@pytest.mark.parametrize("study", sorted(STUDIES))
def test_study_control_flow_matches_jax(study, apb, monkeypatch, tmp_path):
    """With training, evaluation and the banks stubbed in both packages,
    the study trains the same model and snapshots, evaluates the same
    variants on the same banks and weights in the same order, and records
    the same keys with the JAX package's stamped fields (the port adds
    record_ap, device and the bank's seconds); called again, neither
    evaluates anything."""
    import openpose_plus_tpu.checkpoint as jckpt
    import openpose_plus_tpu.data.coco as jcoco
    import openpose_plus_tpu.data.synthetic as jsynthetic
    import openpose_plus_tpu_torch.checkpoint as tckpt
    import openpose_plus_tpu_torch.data.coco as tcoco

    name, kwargs = STUDIES[study]
    port_dir = str(tmp_path / "port")
    logs, results = [], []
    for module, syn, coco, ckpt, port in (
            (apb, jsynthetic, jcoco, jckpt, False),
            (ap_bench, synthetic, tcoco, tckpt, True)):
        log = _stub_studies(monkeypatch, module, syn, coco, ckpt, port)
        extra = dict(device="cpu", bank_dir=port_dir) if port else {}
        fn = getattr(module, name)
        steps = (20, 40) if name == "run_curve" else 40
        for _ in range(2):
            fn("mobilenet_thin", steps, 1e-3, False, **kwargs, **extra)
        logs.append(log)
        results.append(ap_bench._load_results(port_dir) if port
                       else apb._load_results())
    ref_log, log = logs
    assert [e for e in ref_log if e[0] == "eval"]
    assert log == ref_log
    ref, out = results
    assert list(out) == list(ref) and len(ref) == 1
    for key, row in ref.items():
        assert list(out[key]) == list(row)
        for cell, fields in row.items():
            for field, value in fields.items():
                assert out[key][cell][field] == value, (key, cell, field)
            assert out[key][cell]["device"] == "cpu"


def test_print_table_matches_jax(apb, monkeypatch, capsys):
    """print_table of one results dict (the JAX package's record, which
    has every kind of row) prints the JAX script's text."""
    with open(os.path.join(REPO, "ap_benchmark.json")) as f:
        res = json.load(f)
    monkeypatch.setattr(apb, "_load_results", lambda: res)
    apb.print_table()
    ref = capsys.readouterr().out
    monkeypatch.setattr(ap_bench, "_load_results", lambda *args: res)
    ap_bench.print_table()
    out = capsys.readouterr().out
    assert out == ref
    for heading in ("serving tier", "val_large bank", "oracle ceilings",
                    "lr-rule validation", "vggtiny#curve"):
        assert heading in out


def test_table_cli_reads_the_bank_dir(tmp_path, capsys):
    """`ap_bench --table --bank-dir D` prints D's results.json."""
    ap_bench._save_row(str(tmp_path), "oracle@368#s4",
                       {"base": {"ap": 0.65651}})
    ap_bench.main(["--table", "--bank-dir", str(tmp_path)])
    assert "| oracle@368#s4 | — | 0.657 | — | — |" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        ap_bench.main(["--bank-dir", str(tmp_path)])


# ------------------------------------------------------------ snapshots --

def test_train_model_snapshots(monkeypatch, tmp_path):
    """train_model(snapshots=(2, 4)) on a tiny small-tier config writes
    both snapshots under the JAX names (<model>_s<S>_lr<lr>_cv<total>.npz,
    JAX-layout npz), steps at the JAX package's lr schedule for the same
    config (the cut at total // 2), and a second call reuses the
    snapshots without training."""
    import openpose_plus_tpu_torch.config as config_module
    from openpose_plus_tpu_torch import checkpoint as ckpt
    from openpose_plus_tpu_torch import train as T

    default_config = config_module.default_config

    def tiny(name):
        cfg = default_config(name)
        return cfg.replace(model=dataclasses.replace(cfg.model, n_stages=2))
    monkeypatch.setattr(config_module, "default_config", tiny)
    geo = {**ap_oracle.GEOMETRIES["small"], "hin": 64, "win": 64}
    ann, imgs = synthetic.make_scene_bank(str(tmp_path), "train", 8, 128)
    lrs = []
    make_step = T.make_train_step_on_batch

    def recording(cfg):
        step = make_step(cfg)

        def run(state, batch):
            state, metrics = step(state, batch)
            lrs.append(metrics["lr"])
            return state, metrics
        return run
    monkeypatch.setattr(T, "make_train_step_on_batch", recording)
    bank = str(tmp_path / "bank")
    cfg, params, info = ap_bench.train_model(
        "mobilenet_thin", 4, 1e-3, ann, imgs, geo, snapshots=(2, 4),
        device="cpu", bank_dir=bank)
    names = [f"mobilenet_thin_s{s}_lr0.001_cv4.npz" for s in (2, 4)]
    assert sorted(os.listdir(bank)) == sorted(
        names + ["mobilenet_thin_s4_lr0.001_cv4_loss.csv"])
    jcfg = jax_script("ap_benchmark").build_config(
        "mobilenet_thin", ann, imgs, 4, 1e-3, geo)
    schedule = jtrain.lr_schedule(jcfg.train)
    np.testing.assert_allclose(lrs, [float(schedule(i)) for i in range(4)],
                               rtol=1e-6)
    assert lrs[1] > lrs[2]
    final = ckpt.load_npz(os.path.join(bank, names[1]))
    assert ckpt.to_flax(params).keys() == final.keys()
    for k, v in ckpt.to_flax(params).items():
        np.testing.assert_array_equal(final[k], v)
    assert not np.array_equal(
        ckpt.load_npz(os.path.join(bank, names[0]))[k], final[k])
    assert info["loss_first"] > 0

    monkeypatch.setattr(T, "make_train_step_on_batch", lambda cfg: 1 / 0)
    _, again, info = ap_bench.train_model(
        "mobilenet_thin", 4, 1e-3, ann, imgs, geo, snapshots=(2, 4),
        device="cpu", bank_dir=bank)
    assert info == {} and all(torch.equal(again[k], params[k])
                              for k in params)


# ------------------------------------------------ the end-to-end demo ---

@pytest.mark.parametrize("cx,cy,scale", [(0.0, 0.0, 1.0), (12.5, 30.0, 2.5),
                                         (-3.0, 7.0, 0.4)])
def test_standing_person_is_maputils(cx, cy, scale):
    """The port's copy of tests/maputil.py's stick figure."""
    assert (synthetic.standing_person(cx, cy, scale)
            == maputil.standing_person(cx, cy, scale))


def test_synthetic_dataset_matches_jax_script(tmp_path):
    """synthetic_e2e's dataset writer gives scripts/synthetic_e2e.py's
    annotations and images for one seed."""
    ref = jax_script("synthetic_e2e").make_synthetic_dataset(
        str(tmp_path / "jax"), 4, 128, seed=3)
    out = synthetic_e2e.make_synthetic_dataset(str(tmp_path / "port"), 4, 128,
                                               seed=3)
    with open(ref[0]) as f, open(out[0]) as g:
        want, got = json.load(f), json.load(g)
    assert got == want and len(got["annotations"]) >= 4
    for entry in want["images"]:
        a = cv2.imread(os.path.join(ref[1], entry["file_name"]))
        b = cv2.imread(os.path.join(out[1], entry["file_name"]))
        np.testing.assert_array_equal(a, b)
