"""BENCHMARK.json holds to the benchmark's contract, every cell loads with
the files it names, and a cell made only of new files loads."""

from __future__ import annotations

import json
import os
import re

import pytest

from conftest import BENCH, ROOT, bench_json
from harness import runner, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
BENCH_JSON = bench_json()
WORKLOADS = [w["name"] for w in BENCH_JSON["workloads"]]
COMPARABLE = {"peak_error_bf16_units", "steady_people_lost",
              "off_peak_share", "invariant_breaks", "repeat_mismatch",
              "layout_mismatch"}


def test_top_level_and_entry_keys():
    b = BENCH_JSON
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "benchmark/run.py"]
    assert b["paths"] == ["benchmark"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert len(c["reduced"]) <= 16
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}


def test_names_and_references():
    b = BENCH_JSON
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert all(NAME.match(n) for n in names)
    for key in ("configs", "workloads"):
        assert len({x["name"] for x in b[key]}) == len(b[key])
    metrics = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    configs = {c["name"] for c in b["configs"]}
    assert configs == {w["config"] for w in b["workloads"]}
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(set(pairs)) == len(pairs)
    e2e = {m["name"]: m for m in b["end_to_end"]}
    setup = e2e["setup_s"]
    assert setup["bound"] == 0.25 and "workloads" not in setup
    for m in b["per_layer"]:
        moved = e2e[m["moves"]]
        for w in m["workloads"]:
            assert w in WORKLOADS
            assert "workloads" not in moved or w in moved["workloads"]
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("workload", WORKLOADS)
def test_every_cell_loads(workload):
    cell = spec.load_cell(ROOT, workload)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(cell.reader(m["name"]))
    assert cell.traffic["driver"] in runner.drivers.DRIVERS
    assert {"steady_people_lost", "invariant_breaks", "repeat_mismatch",
            "layout_mismatch"} <= set(cell.limits) <= COMPARABLE
    for entry in cell.limits.values():
        assert isinstance(entry["limit"], (int, float))
        if "lower" in entry:          # set between its two readings
            assert entry["lower"] < entry["limit"] < entry["upper"]
            assert entry["upper"] >= 3 * entry["lower"]
        else:
            assert entry["limit"] == 0                 # an exact number
    cfg = runner.program_config(cell)             # the program takes it
    assert cfg.model.hin == cell.config["model"]["hin"]
    assert cell.traffic["batch"] in (1, 8)


def test_cell_from_new_files_only(tmp_path):
    """A configuration, a traffic mix, limits and a per-layer metric added
    as new files, with nothing else edited, make a cell that loads."""
    root = tmp_path
    bdir = tmp_path / "benchmark"
    for sub in ("configs", "traffic", "limits", "metrics"):
        (bdir / sub).mkdir(parents=True)
    with open(os.path.join(BENCH, "configs",
                           "mobilenet_thin-368x432-fused.json")) as f:
        config = json.load(f)
    config["model"].update(win=656)
    (bdir / "configs" / "mobilenet_thin-368x656.json").write_text(
        json.dumps(config))
    (bdir / "traffic" / "pairs_bs2.json").write_text(json.dumps(
        {"driver": "engine_batches", "batches": 4, "batch": 2,
         "check_batches": 2, "people": [1, 3]}))
    (bdir / "limits" / "mobilenet_thin.pairs_bs2.json").write_text(
        json.dumps({"peak_error_bf16_units": {"limit": 0.01}}))
    (bdir / "metrics" / "answers.per_call.py").write_text(
        "def read(run):\n    return run.images / max(run.calls, 1)\n")
    b = dict(BENCH_JSON)
    b["configs"] = [{"name": "mobilenet_thin-368x656",
                     "source": "https://github.com/tensorlayer/openpose-plus",
                     "file": "benchmark/configs/mobilenet_thin-368x656.json",
                     "reduced": [], "why": "a wider input"}]
    b["workloads"] = [{"name": "mobilenet_thin.pairs_bs2",
                       "config": "mobilenet_thin-368x656",
                       "traffic": "pairs_bs2", "chips": 1, "why": "pairs"}]
    b["per_layer"] = [{"name": "answers.per_call", "unit": "images",
                       "better": "higher", "source": "host_clock",
                       "layer": "engine", "moves": "images_per_s",
                       "workloads": ["mobilenet_thin.pairs_bs2"]}]
    b["end_to_end"] = [dict(m, workloads=["mobilenet_thin.pairs_bs2"])
                       if "workloads" in m and m["name"] == "images_per_s"
                       else m for m in b["end_to_end"]]
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    cell = spec.load_cell(str(root), "mobilenet_thin.pairs_bs2", str(bdir))
    assert cell.config["model"]["win"] == 656
    assert cell.traffic["name"] == "pairs_bs2"
    assert [m["name"] for m in cell.per_layer] == ["answers.per_call"]
    assert {m["name"] for m in cell.end_to_end} == {"images_per_s",
                                                    "setup_s"}
    fake = type("R", (), {"images": 8, "calls": 4})()
    assert cell.reader("answers.per_call")(fake) == 2
