"""The comparison that decides `correct`, on its own: the float32
reference's own people served back read no error at all, and each fault
planted in them reads in the number meant to catch it."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from conftest import BIG_SEED
from harness import check, scenes
from readings import FAULTS
from test_benchmark_reference import HIN, WIN, _setup

POSTPROC = {"max_peaks": 16, "max_humans": 32, "peak_threshold": 0.05,
            "paf_n_samples": 10, "paf_sample_threshold": 0.05,
            "paf_inlier_ratio": 0.8, "min_parts_per_human": 3,
            "min_human_score": 0.0, "upsample_factor": 2,
            "smooth_sigma": 1.25}


def _served_back(ref: check.Reference, i: int, rows: int = 32) -> dict:
    """The float32 reference's people of image i as an answer."""
    xy, score = ref.people[i][:2]
    h, w = ref.extent
    ans = {"coords": np.zeros((rows, 18, 2), np.float32),
           "part_scores": np.zeros((rows, 18), np.float32),
           "part_valid": np.zeros((rows, 18), bool),
           "score": np.zeros(rows, np.float32),
           "n_parts": np.zeros(rows, np.int32),
           "valid": np.zeros(rows, bool)}
    order = np.argsort(-score, kind="stable")
    for m, j in enumerate(order):
        present = ~np.isnan(xy[j, :, 0])
        ans["coords"][m][present] = xy[j][present]
        ans["part_valid"][m] = present
        px = np.clip(np.round(xy[j, present] * (w, h) - 0.5), 0,
                     (w - 1, h - 1)).astype(int)
        ans["part_scores"][m][present] = ref.maps[i][px[:, 1], px[:, 0],
                                                     np.nonzero(present)[0]]
        ans["score"][m] = score[j]
        ans["n_parts"][m] = present.sum()
        ans["valid"][m] = True
    return ans


@pytest.fixture(scope="module")
def sample():
    _, sd, _ = _setup("vgg19", BIG_SEED)
    rng = np.random.default_rng(BIG_SEED)
    planes = np.stack([scenes.render(rng, HIN, WIN, (3, 6))
                       for _ in range(6)])
    config = {"model": {"name": "vgg19", "n_stages": 2}}
    ref = check.reference(config, sd, planes, POSTPROC, torch.device("cpu"))
    answers = [_served_back(ref, i) for i in range(len(planes))]
    assert sum(len(p[1]) for p in ref.people) >= 12
    return ref, answers


def test_reference_served_back_reads_nothing(sample):
    ref, answers = sample
    v = check.numbers(answers, ref, POSTPROC, 0, 0)
    assert v["keypoint_miss_share"] == 0
    assert v["person_score_gap"] < 1e-6            # scores in float32
    assert v["steady_people_broken"] == 0
    assert v["off_peak_share"] == 0
    assert v["invariant_breaks"] == 0
    assert v["peak_error_bf16_units"] < 1e-3


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_reads(sample, fault):
    ref, answers = sample
    v = check.numbers([FAULTS[fault](a) for a in answers], ref, POSTPROC,
                      0, 0)
    assert v["keypoint_miss_share"] > 0
    assert v["steady_people_broken"] > 0
    assert v["invariant_breaks"] == 0

