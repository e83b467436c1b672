"""The port's GT-map oracle studies vs the JAX package's, on the CPU.

- The attribution probes (`ap_oracle.run_oracle(out_stride=4)` and
  `label_sigma=4.0`) give the JAX pipeline's AP (JAX `make_targets`,
  `build_decoder`, `evaluate_detections_full`) on 16 small-tier images.
- `ap_bench --oracle` writes the rows that scripts/ap_benchmark.py's
  `run_oracle` writes, under the same key and fields; `oracle_key` names
  the recorded probe rows of ap_benchmark.json.
- `tune_fragment_merge` and `analyze_oracle_misses` print the JAX
  scripts' lines on the same 16 small-tier images (the JAX `main()` run
  in-process, its bank and results redirected to tmp_path).
"""

import dataclasses
import importlib.util
import json
import os
import re
import sys

import jax
import pytest
import torch

from openpose_plus_tpu import config as jconfig
from openpose_plus_tpu import eval_coco as JE
from openpose_plus_tpu.data import targets as jtargets
from openpose_plus_tpu.postproc import build_decoder as jax_build_decoder
from openpose_plus_tpu_torch import (analyze_oracle_misses, ap_bench,
                                     ap_oracle, tune_fragment_merge)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBES = {"s4": (4, None), "sig4": (8, 4.0)}       # out_stride, label_sigma
IMAGES = 16


def jax_script(name: str):
    """scripts/<name>.py as a fresh module (the scripts import their
    sibling `ap_benchmark` by putting scripts/ on sys.path)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def isolate(monkeypatch, tmp_path):
    """cut(apb, n): the JAX ap_benchmark module `apb` writing its results
    and banks under tmp_path, its small tier cut to n images (a copy of
    GEOMETRIES), and the port's small tier cut alike; the scripts'
    compilation-cache settings are not applied."""
    skipped = ("jax_compilation_cache_dir", "jax_platforms",
               "jax_persistent_cache_min_compile_time_secs")
    update = jax.config.update
    monkeypatch.setattr(jax.config, "update", lambda name, value: (
        None if name in skipped else update(name, value)))

    def cut(apb, n):
        monkeypatch.setattr(apb, "RESULTS_PATH", str(tmp_path / "jax.json"))
        monkeypatch.setattr(apb, "BANK_DIR", str(tmp_path / "jax_bank"))
        monkeypatch.setattr(apb, "GEOMETRIES", {**apb.GEOMETRIES, "small": {
            **apb.GEOMETRIES["small"], "n_val": n, "n_train": n}})
        monkeypatch.setitem(ap_oracle.GEOMETRIES, "small", {
            **ap_oracle.GEOMETRIES["small"], "n_val": n, "n_train": n})
    return cut


# ------------------------------------------------------------ the probes --

_JAX_MAPS = {}


def _jax_probe(probe: str, variant: str):
    """scripts/ap_benchmark.py::run_oracle's pipeline at the probe's stride
    and sigma on the port oracle's first IMAGES small-tier images."""
    stride, sigma = PROBES[probe]
    if probe not in _JAX_MAPS:
        bank = ap_oracle.oracle_bank("small", limit=IMAGES)
        geo = bank.geo
        render = jax.jit(jax.vmap(lambda kp: jtargets.make_targets(
            kp, 128 // stride, 128 // stride, stride,
            geo["sigma"] if sigma is None else sigma, geo["limb"])))
        _JAX_MAPS[probe] = (bank, [
            render(ap_oracle.input_keypoints(bank, i))
            for i in range(0, IMAGES, ap_oracle.BATCH)])
    bank, maps = _JAX_MAPS[probe]
    pcfg = jconfig.PostprocConfig()
    if variant != "base":
        pcfg = pcfg.fidelity(upsample=stride)
    if variant == "fidelity_fm":
        pcfg = dataclasses.replace(pcfg, fragment_merge_rel=0.5)
    decoder = jax_build_decoder(pcfg)
    dets = []
    for i, (conf, paf) in zip(range(0, IMAGES, ap_oracle.BATCH), maps):
        humans = decoder(conf, paf)
        for j in range(ap_oracle.BATCH):
            dets.extend(JE.humans_to_detections(humans, j, *bank.metas[i + j],
                                                128, 128))
    return JE.evaluate_detections_full(dets, bank.gt_by_image)


@pytest.mark.parametrize("variant", ["base", "fidelity", "fidelity_fm"])
@pytest.mark.parametrize("probe", sorted(PROBES))
def test_probe_matches_jax_pipeline(probe, variant):
    """The stride-4 and sigma-4 probes of the port's oracle, rendered and
    decoded on the CPU, give the JAX pipeline's AP and detection count
    within 1e-6 (at stride 4 the fidelity decoder upsamples 4x)."""
    stride, sigma = PROBES[probe]
    out = ap_oracle.run_oracle("small", (variant,), device="cpu",
                               limit=IMAGES, out_stride=stride,
                               label_sigma=sigma)[variant]
    ref = _jax_probe(probe, variant)
    assert out.n_images == IMAGES and out.n_dets == ref.n_dets > 0
    for key, value in ref.as_dict().items():
        assert abs(out.as_dict()[key] - value) <= 1e-6, key


@pytest.mark.parametrize("probe", sorted(PROBES))
def test_oracle_rows_match_jax_script(probe, isolate, tmp_path):
    """`ap_bench --oracle` with the probe's flags writes
    scripts/ap_benchmark.py's rows for the same bank: the same key,
    variants and fields, equal values but the seconds (the port adds its
    record_ap and device)."""
    stride, sigma = PROBES[probe]
    apb = jax_script("ap_benchmark")
    isolate(apb, 8)
    apb.run_oracle(True, "small", out_stride=stride, label_sigma=sigma)
    with open(apb.RESULTS_PATH) as f:
        ref = json.load(f)
    port_dir = str(tmp_path / "port")
    flags = ["--out-stride", str(stride)] + (
        [] if sigma is None else ["--label-sigma", f"{sigma:g}"])
    ap_bench.main(["--oracle", "--geometry", "small", *flags,
                   "--device", "cpu", "--bank-dir", port_dir])
    out = ap_bench._load_results(port_dir)
    key = ap_oracle.oracle_key("small", stride, sigma)
    assert list(out) == list(ref) == [key]
    assert set(out[key]) == set(ref[key]) == set(ap_oracle.VARIANTS)
    for variant, cell in ref[key].items():
        assert cell["n_val"] == 8
        for field, value in cell.items():
            if field != "eval_seconds":
                assert out[key][variant][field] == value, (variant, field)
        assert out[key][variant]["device"] == "cpu"


@pytest.mark.parametrize("tier,stride,sigma", [
    ("small", 8, None), ("small", 4, None), ("serving", 8, None),
    ("serving", 4, None), ("serving", 8, 4.0)])
def test_oracle_key_names_the_recorded_rows(tier, stride, sigma):
    """Each oracle row of ap_benchmark.json sits under `oracle_key` of the
    stride, sigma and tier its cells record."""
    with open(os.path.join(REPO, "ap_benchmark.json")) as f:
        row = json.load(f)[ap_oracle.oracle_key(tier, stride, sigma)]
    geo = ap_oracle.GEOMETRIES[tier]
    assert set(row) == set(ap_oracle.VARIANTS)
    for cell in row.values():
        assert (cell["stride"], cell["sigma"], cell["hin"], cell["n_val"],
                cell["bank_size"]) == (
            stride, geo["sigma"] if sigma is None else sigma, geo["hin"],
            geo["n_val"], geo["size"])


# ------------------------------------------------- the sweep, the audit --

def _without_seconds(text: str) -> str:
    return re.sub(r" \(\d+s\)$", "", text, flags=re.M)


def test_sweep_matches_jax_script(isolate, monkeypatch, capsys):
    """`python -m openpose_plus_tpu_torch.tune_fragment_merge` prints
    scripts/tune_fragment_merge.py's lines (AP, AP50, AR a rel) on the
    same 16 small-tier train images; `sweep` returns them by rel."""
    tune = jax_script("tune_fragment_merge")
    isolate(tune.apb, IMAGES)
    monkeypatch.setattr(sys, "argv", ["tune_fragment_merge.py", "--geometry",
                                      "small", "--rels", "0,0.3,0.5"])
    tune.main()
    ref = capsys.readouterr().out
    tune_fragment_merge.main(["--geometry", "small", "--rels", "0,0.3,0.5",
                              "--device", "cpu"])
    out = capsys.readouterr().out
    assert "bank=train tier=small (16 scenes" in out
    assert len(out.splitlines()) == 4
    assert _without_seconds(out) == _without_seconds(ref)
    results = tune_fragment_merge.sweep("small", (0.0, 0.5), device="cpu")
    assert list(results) == [0.0, 0.5]
    assert f"rel=0.5: AP {results[0.5].ap:.4f}" in out


@pytest.mark.parametrize("frag_merge", [False, True])
def test_audit_matches_jax_script(frag_merge, isolate, monkeypatch, capsys):
    """`analyze_oracle_misses.audit` prints scripts/analyze_oracle_misses.py's
    four lines on the same 16 small-tier val images, with and without the
    fragment-merge pass, and returns their counts."""
    script = jax_script("analyze_oracle_misses")
    isolate(script.apb, IMAGES)
    monkeypatch.setattr(sys, "argv", ["analyze_oracle_misses.py",
                                      "--geometry", "small"]
                        + (["--frag-merge"] if frag_merge else []))
    script.main()
    ref = capsys.readouterr().out
    counts = analyze_oracle_misses.audit("small", frag_merge=frag_merge,
                                         device="cpu", limit=IMAGES)
    out = capsys.readouterr().out
    assert out == ref and len(out.splitlines()) == 4
    assert counts["misses"] > 0
    assert (f"{counts['gt_people']} GT people, {counts['misses']} missed"
            in out)
    assert (f"scattered across >=2 detections: {counts['scattered']} of "
            f"{counts['misses']}" in out)
    assert (f"DISCONNECTED in the limb tree: {counts['disconnected']} of"
            in out)
