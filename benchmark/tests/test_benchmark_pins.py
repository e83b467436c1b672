"""Moving the PAF path behind its decode family moved no number: every
cell's cut run on the CPU (`conftest.make_tiny_root`: BODY_25 at its six
stages, the others at two) reads, on two seeds, the state_dict bits, the
head gains, the numbers `check.numbers` computes and `correct` recorded in
`pinned_cut_runs.json` on the benchmark as it stood before the families
(commit 04652fc, its harness on the same cut; the CPU build of torch on
two threads)."""

from __future__ import annotations

import hashlib
import json
import os

import pytest

from harness import weights

with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "pinned_cut_runs.json")) as f:
    PINS = json.load(f)


def _digest(sd: dict) -> str:
    h = hashlib.sha256()
    for t in sd.values():
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("key", sorted(PINS))
def test_cut_run_is_pinned(run_tiny, monkeypatch, key):
    workload, seed = key.split("/")
    seen = {}
    make, scale = weights.make, weights.scale_heads

    def make_seen(*a, **k):
        sd = seen["sd"] = make(*a, **k)
        seen["state_dict"] = _digest(sd)
        return sd

    def scale_seen(*a, **k):
        seen["gains"] = list(scale(*a, **k))
        seen["scaled"] = _digest(seen["sd"])
        return tuple(seen["gains"])

    monkeypatch.setattr(weights, "make", make_seen)
    monkeypatch.setattr(weights, "scale_heads", scale_seen)
    out = run_tiny(workload, int(seed))
    pin = PINS[key]
    assert seen["state_dict"] == pin["state_dict"]
    assert seen["gains"] == pin["gains"]
    assert seen["scaled"] == pin["scaled"]
    assert out["_values"] == pin["values"]
    assert out["correct"] == pin["correct"]
