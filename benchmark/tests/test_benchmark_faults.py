"""A whole run, past the look for a card, with the timed path broken
underneath: `correct` has to come out false for each fault a serving cell
can have (an answer altered where it is produced: misrouted to another
image, its keypoints moved, left empty, or one of its people left out),
and true without one.

On the CPU the engine serves every call through `engine.infer_step`,
which the faults wrap."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from conftest import bench_json

WORKLOADS = [w["name"] for w in bench_json()["workloads"]]


def _misrouted(hb):
    return dataclasses.replace(hb, **{f.name: torch.roll(
        getattr(hb, f.name), 1, dims=0) for f in dataclasses.fields(hb)})


def _moved(hb):
    # every keypoint 4 pixels right on the cut cells' default decode grid
    # (28 wide; 16 at the fidelity decode's)
    coords = hb.coords.clone()
    coords[..., 0] += 4.0 / 28.0
    return dataclasses.replace(hb, coords=coords)


def _emptied(hb):
    return dataclasses.replace(hb, valid=torch.zeros_like(hb.valid),
                               part_valid=torch.zeros_like(hb.part_valid))


def _person_dropped(hb):
    # each image's first person left out, the rows after it moved up
    def drop(t):
        return torch.cat([t[:, 1:], torch.zeros_like(t[:, :1])], dim=1)

    return dataclasses.replace(hb, **{f.name: drop(getattr(hb, f.name))
                                      for f in dataclasses.fields(hb)})


FAULTS = {"misrouted": _misrouted, "moved": _moved, "emptied": _emptied,
          "person_dropped": _person_dropped}


@pytest.mark.parametrize("workload", WORKLOADS)
def test_sound_run_is_correct(run_tiny, workload):
    out = run_tiny(workload)
    assert out["correct"], out["_values"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", WORKLOADS)
def test_fault_is_not_correct(run_tiny, monkeypatch, workload, fault):
    from openpose_plus_tpu_torch import engine

    if fault == "misrouted" and "bs1" in workload:
        pytest.skip("one image a call: nothing to misroute")
    step = engine.infer_step
    monkeypatch.setattr(engine, "infer_step",
                        lambda *a, **k: FAULTS[fault](step(*a, **k)))
    out = run_tiny(workload)
    assert not out["correct"], out["_values"]
