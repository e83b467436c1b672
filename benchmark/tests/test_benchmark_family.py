"""A second decode family enters with new files only: a copy of the
benchmark takes a toy associative-embedding network (a 1/4 prediction of
17 heatmaps and 17 tags, a transposed conv, a 1/2 prediction of 17
heatmaps, one BatchNorm), a skeleton, a configuration and a limits file
as added files, and everything from the cell's loading to `check.judge`
works on them through `reference/families/ae.py`, from the copy, in a
fresh process: the weights' BatchNorm statistics come from the family's
`init`, the heads settle slice by slice, the reference's own people
served back read correct, and the same people with two people's arms
exchanged do not. No file that was copied changes."""

from __future__ import annotations

import filecmp
import json
import os
import shutil
import subprocess
import sys

from conftest import BENCH, ROOT, bench_json

TOY_NETWORK = '''"""Toy associative-embedding network: a 3x3 stride-2
conv with ReLU (1/2), a 3x3 stride-2 conv, a BatchNorm and ReLU (1/4), the
1/4 prediction of 17 heatmaps and 17 tags, a 4x4 stride-2 transposed conv
of the 1/4 features and prediction with ReLU (1/2), and the 1/2
prediction of 17 heatmaps."""

import torch
import torch.nn.functional as F

FAMILY = "ae"
SKELETON = "toy17"


def conv(x, sd, name, r, stride=1):
    w = sd[f"{name}.weight"]
    return r(F.conv2d(r(x), r(w.float()), sd[f"{name}.bias"].float(),
                      stride=stride, padding=w.shape[2] // 2))


def bn_relu(x, sd, name, r):
    s = (1, -1, 1, 1)
    y = (x - sd[f"{name}.running_mean"].view(s)) / torch.sqrt(
        sd[f"{name}.running_var"].view(s) + 1e-5)
    return r(F.relu(y * sd[f"{name}.weight"].view(s)
                    + sd[f"{name}.bias"].view(s)))


def predict(x, sd, name):
    return F.conv2d(x, sd[f"{name}.weight"], sd[f"{name}.bias"])


def forward(x, sd, model, r):
    x = F.relu(conv(x, sd, "stem1", r, stride=2))
    q = bn_relu(conv(x, sd, "stem2", r, stride=2), sd, "bn2", r)
    quarter = predict(q, sd, "final0")
    up = F.conv_transpose2d(r(torch.cat([q, quarter], 1)),
                            r(sd["deconv.weight"]), sd["deconv.bias"],
                            stride=2, padding=1)
    return quarter, predict(F.relu(r(up)), sd, "final1")


def heads(model):
    return "final0", "final1"


def predictions(model):
    return ["final0", "final1"]
'''

SHAPES = {"stem1.weight": [8, 3, 3, 3], "stem1.bias": [8],
          "stem2.weight": [16, 8, 3, 3], "stem2.bias": [16],
          "bn2.weight": [16], "bn2.bias": [16], "bn2.running_mean": [16],
          "bn2.running_var": [16], "bn2.num_batches_tracked": [],
          "final0.weight": [34, 16, 1, 1], "final0.bias": [34],
          "deconv.weight": [50, 8, 4, 4], "deconv.bias": [8],
          "final1.weight": [17, 8, 1, 1], "final1.bias": [17]}
HIN, WIN = 96, 112
TOY_CONFIG = {
    "name": "toy_ae-96x112", "source": "this test",
    "model": {"name": "toy_ae", "hin": HIN, "win": WIN},
    "postproc": {"max_num_people": 30, "detection_threshold": 0.1,
                 "tag_threshold": 1.0, "nms_kernel": 5, "nms_padding": 2,
                 "min_parts_per_human": 1},
    "weights": {"bias_std": 0.05, "conf_max": 0.7, "tag_max": 3.0}}
TOY_LIMITS = {k: {"limit": 0} for k in (
    "steady_people_lost", "off_peak_share", "keypoint_miss_share",
    "invariant_breaks", "repeat_mismatch", "layout_mismatch")}
WORKLOAD = "toy_ae.batch_bs8"

# Runs from the copy: sys.argv = [root, shapes file].
DRIVE = '''
import json, sys
root = sys.argv[1]
sys.path[:0] = [root + "/benchmark", root]
import numpy as np
import torch
torch.set_num_threads(2)
from harness import check, cost, scenes, spec, weights
from reference import models

SEED = 2**31 + 777
cpu = torch.device("cpu")
shapes = {k: tuple(v) for k, v in json.load(open(sys.argv[2])).items()}
cell = spec.load_cell(root, "toy_ae.batch_bs8")
m, w = cell.config["model"], cell.config["weights"]
pp = cell.config["postproc"]
assert models.family(models.network(m["name"])).__file__.startswith(root)

sd = weights.make(shapes, SEED, cpu, w["bias_std"], m)
assert (sd["bn2.running_var"] > 0).all(), sd["bn2.running_var"]
assert (sd["bn2.weight"] - 1).abs().max() < 0.5, sd["bn2.weight"]
assert not sd["final0.bias"].any() and not sd["final1.bias"].any()

planes = np.stack(scenes.render_many(SEED, 6, m["hin"], m["win"], (2, 5)))
gains = weights.scale_heads(sd, m, torch.from_numpy(planes[:1]), w)
assert len(gains) == 3, gains
quarter, half = models.forward(m, sd, torch.from_numpy(planes[:1]))
assert quarter.shape == (1, m["hin"] // 4, m["win"] // 4, 34), quarter.shape
assert half.shape == (1, m["hin"] // 2, m["win"] // 2, 17), half.shape
for maps, peak in ((quarter[..., :17], w["conf_max"]),
                   (quarter[..., 17:], w["tag_max"]),
                   (half, w["conf_max"])):
    got = float((maps - maps.mean(dim=(0, 1, 2))).abs().max())
    assert abs(got - peak) <= 1e-3 * peak, (got, peak)
assert cost.cnn_flops(m, shapes, 1) > 0

ref = check.reference(cell.config, sd, planes, pp, cpu)
assert ref.extent == (m["hin"], m["win"]) and ref.tol == 2.0
assert ref.skeleton.n_parts == 17
people = sum(len(p[1]) for p in ref.people)
assert people >= 12, people


def served_back(i):
    xy, score, parts, counts = ref.people[i]
    n, rows = xy.shape[1], max(len(score), 1)
    ans = {"coords": np.zeros((rows, n, 2), np.float32),
           "part_scores": np.zeros((rows, n), np.float32),
           "part_valid": np.zeros((rows, n), bool),
           "score": np.zeros(rows, np.float32),
           "n_parts": np.zeros(rows, np.int32),
           "valid": np.zeros(rows, bool)}
    for row, j in enumerate(np.argsort(-score, kind="stable")):
        ok = ~np.isnan(xy[j, :, 0])
        ans["coords"][row, ok] = xy[j, ok]
        ans["part_valid"][row] = ok
        ans["part_scores"][row, ok] = parts[j, ok]
        ans["score"][row] = score[j]
        ans["n_parts"][row] = counts[j]
        ans["valid"][row] = True
    return ans


answers = [served_back(i) for i in range(len(planes))]
values, _ = check.evaluate(cell.config, sd, answers, planes, pp, cpu, 0, 0)
assert values["steady_people_lost"] == 0, values
assert values["off_peak_share"] == 0, values
assert "tag_break_share" in values and "limb_break_share" not in values
good, rows = check.judge(values, cell.limits)
assert good, rows

swapped = []
for a in answers:                 # elbows and wrists of the first two
    a = {k: v.copy() for k, v in a.items()}
    for f in ("coords", "part_scores", "part_valid"):
        a[f][[0, 1], 7:11] = a[f][[1, 0], 7:11]
    swapped.append(a)
values_swapped = check.numbers(swapped, ref, pp, 0, 0)
bad, rows = check.judge(values_swapped, cell.limits)
assert not bad, rows
print("OK", json.dumps({"people": people, "gains": gains}))
'''


def test_a_family_enters_by_new_files(tmp_path):
    root = tmp_path / "root"
    bdir = root / "benchmark"
    shutil.copytree(BENCH, bdir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    copied = [os.path.relpath(os.path.join(d, f), bdir)
              for d, _, files in os.walk(bdir) for f in files]

    def add(rel: str, text: str) -> None:
        path = root / rel
        assert not path.exists(), rel
        path.write_text(text)

    with open(os.path.join(BENCH, "reference", "skeletons",
                           "coco17.json")) as f:
        skeleton = dict(json.load(f), name="toy17")
    add("benchmark/reference/networks/toy_ae.py", TOY_NETWORK)
    add("benchmark/reference/skeletons/toy17.json", json.dumps(skeleton))
    add("benchmark/configs/toy_ae-96x112.json", json.dumps(TOY_CONFIG))
    add(f"benchmark/limits/{WORKLOAD}.json", json.dumps(TOY_LIMITS))
    bench = bench_json()
    grown = json.loads(json.dumps(bench))
    grown["configs"].append({"name": "toy_ae-96x112", "source": "this test",
                             "file": "benchmark/configs/toy_ae-96x112.json",
                             "reduced": [], "why": "a toy"})
    grown["workloads"].append({"name": WORKLOAD, "config": "toy_ae-96x112",
                               "traffic": "batch_bs8", "chips": 1,
                               "why": "a toy"})
    with open(root / "BENCHMARK.json", "w") as f:
        json.dump(grown, f)
    (tmp_path / "shapes.json").write_text(json.dumps(SHAPES))
    (tmp_path / "drive.py").write_text(DRIVE)

    out = subprocess.run(
        [sys.executable, str(tmp_path / "drive.py"), str(root),
         str(tmp_path / "shapes.json")],
        capture_output=True, text=True, timeout=600, cwd=str(root))
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip().splitlines()[-1].startswith("OK ")

    for rel in copied:
        assert filecmp.cmp(bdir / rel, os.path.join(BENCH, rel),
                           shallow=False), rel
    with open(root / "BENCHMARK.json") as f:     # entries added, none edited
        served = json.load(f)
    for key in ("configs", "workloads"):
        assert served[key].pop()["name"] in ("toy_ae-96x112", WORKLOAD)
    assert served == bench
