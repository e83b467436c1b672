"""The benchmark as data: `BENCHMARK.json` at the checkout's root names the
cells, their configuration and traffic files, and the metrics; each
configuration, traffic mix, limit set and metric reader is a file of its
own under `benchmark/`, found by its name:

    benchmark/configs/<config file named in BENCHMARK.json>
    benchmark/traffic/<traffic>.json      parameters of one mix
    benchmark/limits/<workload>.json      the limits of `correct`
    benchmark/metrics/<metric>.py         read(run) -> number or None
    benchmark/reference/networks/<model.name>.py
                                          the configuration's plain network
                                          (`reference.models.network`)
    benchmark/reference/skeletons/<SKELETON>.json
                                          the skeleton its network names
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Callable, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclasses.dataclass
class Cell:
    """One workload of BENCHMARK.json with everything it names loaded."""

    name: str
    chips: int
    config: dict              # the configuration file
    traffic: dict             # the traffic file, plus its "name"
    limits: dict              # number name -> its limit entry
    end_to_end: list          # BENCHMARK.json entries this cell reports
    per_layer: list
    bench_dir: str

    def reader(self, metric: str) -> Callable:
        """`read` of benchmark/metrics/<metric>.py."""
        return load_reader(self.bench_dir, metric)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_reader(bench_dir: str, metric: str) -> Callable:
    path = os.path.join(bench_dir, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _reported(entry: dict, cell: str, e2e_names: set) -> bool:
    if "workloads" in entry:
        return cell in entry["workloads"]
    return "moves" not in entry or entry["moves"] in e2e_names


def load_cell(root: str, workload: str,
              bench_dir: Optional[str] = None) -> Cell:
    """The workload `workload` of `<root>/BENCHMARK.json`; its files are
    read from `bench_dir` (default: this benchmark's own folder)."""
    bench_dir = bench_dir or BENCH_DIR
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; have "
                       f"{sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = _json(os.path.join(bench_dir, "traffic",
                                 f"{w['traffic']}.json"))
    traffic["name"] = w["traffic"]
    limits = _json(os.path.join(bench_dir, "limits", f"{workload}.json"))
    e2e = [m for m in bench["end_to_end"] if _reported(m, workload, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _reported(m, workload, names)]
    return Cell(workload, w["chips"], config, traffic, limits, e2e,
                per_layer, bench_dir)
