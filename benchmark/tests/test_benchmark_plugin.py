"""A configuration brings its network, weight rule, heads and skeleton as
new files: a copy of the benchmark takes a toy network (PAF stages before
its heatmap stage, PReLU slopes at a declared scale, heads of different
stage indices) and a 5-part skeleton as added files only, and everything
from the cell's loading to the check of `correct` works on them, from the
copy, in a fresh process. No file that was copied changes."""

from __future__ import annotations

import filecmp
import json
import os
import shutil
import subprocess
import sys

from conftest import BENCH, ROOT, bench_json

TOY_NETWORK = '''"""Toy network: a stride-8 stem of three 3x3 stride-2 convs, then
`n_stages` PAF stages, then one heatmap stage that reads the last PAFs;
each stage one 3x3 conv with PReLU and a 1x1 prediction."""

import torch
import torch.nn.functional as F

from reference import models

FAMILY = "paf"
SKELETON = "toy5"
OTHER_STD = 0.25


def conv_prelu(x, sd, name, r, stride=1):
    w = sd[f"{name}.weight"]
    top, bottom = models._same(x.shape[2], w.shape[2], stride)
    left, right = models._same(x.shape[3], w.shape[3], stride)
    y = F.conv2d(F.pad(r(x), (left, right, top, bottom)), r(w.float()),
                 None, stride=stride)
    y = r(r(y) + r(sd[f"{name}.bias"].float()).view(1, -1, 1, 1))
    return r(F.prelu(y, sd[f"{name}.act.weight"].float()))


def predict(x, sd, name):
    return models.conv(x, sd[f"{name}.weight"], sd[f"{name}.bias"],
                       relu=False)


def forward(x, sd, model, r):
    for i in (1, 2, 3):
        x = conv_prelu(x, sd, f"stem{i}", r, stride=2)
    feature, paf = x, None
    for s in range(1, model["n_stages"] + 1):
        inp = feature if paf is None else torch.cat([feature, r(paf)], 1)
        paf = predict(conv_prelu(inp, sd, f"paf{s}", r), sd, f"paf{s}.pred")
    mid = conv_prelu(torch.cat([feature, r(paf)], 1), sd, "conf1", r)
    return predict(mid, sd, "conf1.pred"), paf


def heads(model):
    return "conf1.pred", f"paf{model['n_stages']}.pred"


def predictions(model):
    return ["conf1.pred"] + [f"paf{s}.pred"
                             for s in range(1, model["n_stages"] + 1)]
'''

TOY_SKELETON = {"name": "toy5", "source": "a chain of five parts",
                "parts": 5, "limbs": [[0, 1], [1, 2], [1, 3], [3, 4]],
                "paf_channels": [[0, 1], [2, 3], [4, 5], [6, 7]],
                "person_limbs": 3}

HIN, WIN, N_STAGES = 96, 112, 2
TOY_CONFIG = {
    "name": "toy-96x112", "source": "this test",
    "model": {"name": "toy_paf_first", "hin": HIN, "win": WIN, "stride": 8,
              "n_stages": N_STAGES, "n_heatmaps": 6, "n_pafs": 8},
    "postproc": {"max_peaks": 16, "max_humans": 32, "peak_threshold": 0.05,
                 "paf_n_samples": 10, "paf_sample_threshold": 0.05,
                 "paf_inlier_ratio": 0.8, "min_parts_per_human": 3,
                 "min_human_score": 0.0, "upsample_factor": 2,
                 "smooth_sigma": 1.25},
    "weights": {"bias_std": 0.05, "conf_max": 0.7, "paf_max": 5.0}}
TOY_LIMITS = {k: {"limit": 0} for k in (
    "steady_people_lost", "off_peak_share", "invariant_breaks",
    "repeat_mismatch", "layout_mismatch")}
WORKLOAD = "toy.batch_bs8"


def _shapes() -> dict:
    def layer(name, cin, cout, k, prelu=True):
        out = {f"{name}.weight": [cout, cin, k, k], f"{name}.bias": [cout]}
        if prelu:
            out[f"{name}.act.weight"] = [cout]
        return out

    s = {**layer("stem1", 3, 8, 3), **layer("stem2", 8, 16, 3),
         **layer("stem3", 16, 16, 3)}
    for i in range(1, N_STAGES + 1):
        s.update(layer(f"paf{i}", 16 if i == 1 else 24, 12, 3))
        s.update(layer(f"paf{i}.pred", 12, 8, 1, prelu=False))
    s.update(layer("conf1", 24, 12, 3))
    s.update(layer("conf1.pred", 12, 6, 1, prelu=False))
    return s


def _hand_flops() -> int:
    def conv(h, w, cin, cout, k):
        return 2 * h * w * cin * cout * k * k

    h, w = HIN // 8, WIN // 8
    n = conv(HIN // 2, WIN // 2, 3, 8, 3) + conv(HIN // 4, WIN // 4, 8, 16, 3)
    n += conv(h, w, 16, 16, 3)
    for i in range(1, N_STAGES + 1):
        n += conv(h, w, 16 if i == 1 else 24, 12, 3) + conv(h, w, 12, 8, 1)
    return n + conv(h, w, 24, 12, 3) + conv(h, w, 12, 6, 1)


# Runs from the copy: sys.argv = [root, shapes file, hand FLOPs].
DRIVE = '''
import json, math, sys
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
cell = spec.load_cell(root, "toy.batch_bs8")
assert cell.bench_dir == root + "/benchmark", cell.bench_dir
assert {m["name"] for m in cell.end_to_end} == {"images_per_s", "setup_s"}
m, w, pp = cell.config["model"], cell.config["weights"], cell.config["postproc"]
net = models.network(m["name"])

sd = weights.make(shapes, SEED, cpu, w["bias_std"], m)
gen = torch.Generator(device=cpu)
gen.manual_seed(SEED)
raw = torch.randn(sum(int(np.prod(s)) for s in shapes.values()),
                  generator=gen).split([int(np.prod(s)) for s in shapes.values()])
zero = {p + ".bias" for p in net.predictions(m)}
for (name, shape), r in zip(shapes.items(), raw):
    if name.endswith(".act.weight"):
        std = net.OTHER_STD                      # a PReLU slope
    elif name.endswith("weight"):
        std = math.sqrt(2.0 / math.prod(shape[1:]))
    else:
        std = 0.0 if name in zero else w["bias_std"]
    std = torch.tensor([std], dtype=torch.float32)
    assert torch.equal(sd[name], (r * std).view(shape)), name

planes = np.stack(scenes.render_many(SEED, 6, m["hin"], m["win"], (2, 5)))
gains = weights.scale_heads(sd, m, torch.from_numpy(planes[:1]), w)
conf, paf = models.forward(m, sd, torch.from_numpy(planes[:1]))
peaks = [float(conf.abs().max()), float(paf.abs().max())]
assert conf.shape[-1] == 6 and paf.shape[-1] == 8, (conf.shape, paf.shape)
assert abs(peaks[0] - w["conf_max"]) < 1e-5 * w["conf_max"], peaks
assert abs(peaks[1] - w["paf_max"]) < 1e-5 * w["paf_max"], peaks

flops = cost.cnn_flops(m, shapes, 1)
assert flops == int(sys.argv[3]), (flops, sys.argv[3])

ref = check.reference(cell.config, sd, planes, pp, cpu)
assert ref.skeleton.n_parts == 5 and len(ref.skeleton.limbs) == 4
people = sum(len(p[1]) for p in ref.people)
assert people >= 6, people


def served_back(i, n_parts=5, rows=32):
    xy, score = ref.people[i][:2]
    h, w_ = ref.extent
    ans = {"coords": np.zeros((rows, n_parts, 2), np.float32),
           "part_scores": np.zeros((rows, n_parts), np.float32),
           "part_valid": np.zeros((rows, n_parts), bool),
           "score": np.zeros(rows, np.float32),
           "n_parts": np.zeros(rows, np.int32),
           "valid": np.zeros(rows, bool)}
    for row, j in enumerate(np.argsort(-score, kind="stable")):
        present = np.nonzero(~np.isnan(xy[j, :, 0]))[0]
        px = np.clip(np.round(xy[j, present] * (w_, h) - 0.5), 0,
                     (w_ - 1, h - 1)).astype(int)
        ans["coords"][row, present] = xy[j, present]
        ans["part_valid"][row, present] = True
        ans["part_scores"][row, present] = ref.maps[i][px[:, 1], px[:, 0],
                                                       present]
        ans["score"][row] = score[j]
        ans["n_parts"][row] = len(present)
        ans["valid"][row] = True
    return ans


answers = [served_back(i) for i in range(len(planes))]
values = check.numbers(answers, ref, pp, 0, 0)
good, rows = check.judge(values, cell.limits)
assert good, rows

moved = [{k: v.copy() for k, v in a.items()} for a in answers]
i = next(i for i, a in enumerate(moved) if a["valid"].any())
p = int(np.nonzero(moved[i]["part_valid"][0])[0][0])
moved[i]["coords"][0, p] = (1.5, 1.5)            # outside the image
values_moved = check.numbers(moved, ref, pp, 0, 0)
bad, _ = check.judge(values_moved, cell.limits)
assert not bad and values_moved["off_peak_share"] > 0, values_moved

coco = [served_back(i, n_parts=18) for i in range(len(planes))]
values_coco = check.numbers(coco, ref, pp, 0, 0)
assert not check.judge(values_coco, cell.limits)[0], values_coco
assert values_coco["invariant_breaks"] > 0, values_coco
print("OK", json.dumps({"people": people, "gains": gains, "flops": flops}))
'''


def test_a_configuration_plugs_in_by_new_files(tmp_path):
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

    add("benchmark/reference/networks/toy_paf_first.py", TOY_NETWORK)
    add("benchmark/reference/skeletons/toy5.json", json.dumps(TOY_SKELETON))
    add("benchmark/configs/toy-96x112.json", json.dumps(TOY_CONFIG))
    add(f"benchmark/limits/{WORKLOAD}.json", json.dumps(TOY_LIMITS))
    bench = bench_json()
    grown = json.loads(json.dumps(bench))
    grown["configs"].append({"name": "toy-96x112", "source": "this test",
                             "file": "benchmark/configs/toy-96x112.json",
                             "reduced": [], "why": "a toy"})
    grown["workloads"].append({"name": WORKLOAD, "config": "toy-96x112",
                               "traffic": "batch_bs8", "chips": 1,
                               "why": "a toy"})
    for m in grown["end_to_end"]:
        if m["name"] == "images_per_s":
            m["workloads"].append(WORKLOAD)
    with open(root / "BENCHMARK.json", "w") as f:
        json.dump(grown, f)
    (tmp_path / "shapes.json").write_text(json.dumps(_shapes()))
    (tmp_path / "drive.py").write_text(DRIVE)

    out = subprocess.run(
        [sys.executable, str(tmp_path / "drive.py"), str(root),
         str(tmp_path / "shapes.json"), str(_hand_flops())],
        capture_output=True, text=True, timeout=600, cwd=str(root))
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip().splitlines()[-1].startswith("OK ")

    for rel in copied:
        assert filecmp.cmp(bdir / rel, os.path.join(BENCH, rel),
                           shallow=False), rel
    with open(root / "BENCHMARK.json") as f:     # entries added, none edited
        served = json.load(f)
    for key in ("configs", "workloads"):
        assert served[key].pop()["name"] in ("toy-96x112", WORKLOAD)
    for m in served["end_to_end"]:
        if WORKLOAD in m.get("workloads", []):
            m["workloads"].remove(WORKLOAD)
    assert served == bench
