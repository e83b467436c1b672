"""Every traffic mix and the weights are a function of the seed: the same
seed gives the same inputs, another seed other inputs of the same
sizes."""

from __future__ import annotations

import hashlib

import numpy as np
import pytest
import torch

from conftest import BIG_SEED, bench_json
from harness import drivers, scenes, spec, weights

WORKLOADS = [w["name"] for w in bench_json()["workloads"]]


def test_scenes_follow_the_seed():
    a = scenes.render(np.random.default_rng(BIG_SEED), 90, 160, (2, 4))
    b = scenes.render(np.random.default_rng(BIG_SEED), 90, 160, (2, 4))
    c = scenes.render(np.random.default_rng(BIG_SEED + 1), 90, 160, (2, 4))
    assert a.shape == c.shape == (90, 160, 3) and a.dtype == np.uint8
    assert np.array_equal(a, b) and not np.array_equal(a, c)


def test_weights_follow_the_seed():
    head = "stages.stage1_conf.Conv_0"
    shapes = {"a.weight": (4, 3, 3, 3), "a.bias": (4,),
              f"{head}.weight": (2, 4, 1, 1), f"{head}.bias": (2,),
              "stages.stage1_paf.Conv_0.weight": (2, 4, 1, 1),
              "stages.stage1_paf.Conv_0.bias": (2,)}
    cpu = torch.device("cpu")
    model = {"name": "vgg19", "n_stages": 1}
    one = weights.make(shapes, BIG_SEED, cpu, 0.05, model)
    two = weights.make(shapes, BIG_SEED, cpu, 0.05, model)
    other = weights.make(shapes, 3, cpu, 0.05, model)
    assert all(torch.equal(one[k], two[k]) for k in shapes)
    assert not torch.equal(one["a.weight"], other["a.weight"])
    assert not one[f"{head}.bias"].any() and one["a.bias"].any()
    assert one["a.weight"].std() == pytest.approx((2 / 27) ** 0.5, rel=0.5)


def _inputs(root, workload, seed):
    cell = spec.load_cell(root[0], workload, root[1])
    run = type("R", (), {"cell": cell, "seed": seed,
                         "device": torch.device("cpu")})()
    d = drivers.DRIVERS[cell.traffic["driver"]](run)
    first = d.setup()
    if hasattr(d, "frames"):
        data = [f.tobytes() for f in d.frames]
    else:
        data = [d.host.tobytes()]
    return first, [hashlib.sha256(x).hexdigest() for x in data], \
        [len(x) for x in data]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_traffic_follows_the_seed(tiny_root, workload):
    first, a, sizes = _inputs(tiny_root, workload, BIG_SEED)
    _, b, _ = _inputs(tiny_root, workload, BIG_SEED)
    _, c, other_sizes = _inputs(tiny_root, workload, BIG_SEED + 7)
    assert a == b and a != c
    assert first.dtype == np.uint8 and first.shape[0] == 1
    assert sizes == other_sizes
