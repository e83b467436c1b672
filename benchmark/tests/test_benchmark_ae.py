"""The associative-embedding family's plain grouping (`reference.families.
ae`, HigherHRNet's single-scale test path) on hand-made planes: planted
people decode to exactly themselves; the Hungarian assignment written
there costs what scipy's does; the NMS keeps a plateau whole; `adjust`
and `refine` move and fill joints as HigherHRNet's `HeatmapParser`
does."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from reference.families import ae

SKEL = ae.load_skeleton("coco17")
N = SKEL.n_parts
POSTPROC = {"max_num_people": 30, "detection_threshold": 0.1,
            "tag_threshold": 1.0, "nms_kernel": 5, "nms_padding": 2}
H, W, SIGMA = 72, 96, 1.5


def _plant(people: list) -> tuple[torch.Tensor, torch.Tensor]:
    """(heat, tags), (N, H, W) float32: a Gaussian of peak 1 at each
    person's (x, y) of each part, the tag plane of a part the tag of the
    person whose part is nearest."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    heat = np.zeros((N, H, W))
    tags = np.zeros((N, H, W))
    for j in range(N):
        d2 = np.stack([(xx - p["xy"][j][0]) ** 2 + (yy - p["xy"][j][1]) ** 2
                       for p in people])
        heat[j] = np.exp(-d2 / (2 * SIGMA ** 2)).max(0)
        tags[j] = np.array([p["tag"] for p in people])[d2.argmin(0)]
    return (torch.from_numpy(heat.astype(np.float32)),
            torch.from_numpy(tags.astype(np.float32)))


def _people(seed: int, n: int) -> list:
    """n people, each part of each at least 7 pixels from the same part
    of any other (the NMS window is 5), tags 2.5 apart, half of them a
    third of a pixel right and down of a pixel centre."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n:
        xy = rng.integers(3, (W - 3, H - 3), size=(N, 2)).astype(float)
        if len(out) % 2:
            xy += 1.0 / 3.0
        if all(np.hypot(*(xy - p["xy"]).T).min() >= 7 for p in out):
            out.append({"xy": xy, "tag": 2.5 * len(out) - 4.0})
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_planted_people_decode_to_themselves(seed):
    planted = _people(seed, 2 + seed)
    heat, tags = _plant(planted)
    (xy, score, parts, counts), _ = ae.group(heat, tags, POSTPROC, SKEL)
    assert len(score) == len(planted) and (counts == N).all()
    for p in planted:
        # the quarter shift: to the larger neighbour, to the lower index
        # on a tie (a Gaussian centred on a pixel), then half a pixel
        px = np.floor(p["xy"] + 0.5)
        shift = np.where(p["xy"] > px, 0.25, -0.25)
        want = (px + shift + 0.5) / (W, H)
        match = [i for i in range(len(score))
                 if np.allclose(xy[i], want, atol=1e-6)]
        assert len(match) == 1
        i = match[0]
        vals = heat.numpy()[np.arange(N), px[:, 1].astype(int),
                            px[:, 0].astype(int)]
        assert np.array_equal(parts[i], vals)
        assert score[i] == np.float32(vals.astype(np.float32).mean())


def test_hungarian_costs_what_scipy_does():
    rng = np.random.default_rng(12345)
    for t in range(200):
        n, m = rng.integers(1, 31, size=2)
        if t % 4 == 0:
            m = n                                          # square
        if t % 2:
            cost = rng.random((n, m)) * 10
        else:       # HigherHRNet's costs: rounded distances, many ties
            cost = (np.round(rng.random((n, m)) * 3) * 100
                    - rng.random((n, m)))
        rows, cols = ae.hungarian(cost)
        want_rows, want_cols = linear_sum_assignment(cost)
        assert len(rows) == min(n, m) == len(set(cols.tolist()))
        assert list(rows) == sorted(set(rows.tolist()))
        assert cost[rows, cols].sum() == pytest.approx(
            cost[want_rows, want_cols].sum(), rel=1e-12, abs=1e-9)
    assert [len(a) for a in ae.hungarian(np.zeros((0, 3)))] == [0, 0]


def test_nms_keeps_a_plateau_and_the_window_rule():
    heat = torch.zeros(N, 20, 20)
    heat[0, 5:7, 5:7] = 0.8                  # a 2x2 plateau: all four kept
    heat[0, 5, 8] = 0.5                      # 2 pixels from it: suppressed
    heat[0, 15, 5] = 0.5                     # 3 pixels from the next: kept
    heat[0, 12, 5] = 0.4                     # and the next: kept
    heat[1, 3, 3] = 0.1                      # not over the threshold
    cands, peaks = ae.candidates(heat, POSTPROC)
    px, py, val = cands[0]
    assert list(zip(py.tolist(), px.tolist())) == [
        (5, 5), (5, 6), (6, 5), (6, 6), (15, 5), (12, 5)]
    assert val.tolist() == pytest.approx([0.8] * 4 + [0.5, 0.4])
    assert len(cands[1][0]) == 0 and len(peaks.xs[1]) == 0
    assert sorted(zip(peaks.ys[0].tolist(), peaks.xs[0].tolist())) == [
        (5, 5), (5, 6), (6, 5), (6, 6), (12, 5), (15, 5)]


def test_adjust_moves_a_quarter_and_a_half():
    heat = np.zeros((N, 8, 8), np.float32)
    heat[0, 4, 4], heat[0, 4, 5], heat[0, 3, 4] = 1.0, 0.6, 0.3   # right, up
    heat[1, 2, 2] = 1.0                                 # ties: lower index
    heat[2, 0, 7], heat[2, 0, 6] = 1.0, 0.2      # at the corner: the edge
    # pixel stands in for its missing neighbour (1.0 > 0.2: right)
    person = np.zeros((N, 4), np.float32)
    person[0, :3] = (4, 4, 1.0)
    person[1, :3] = (2, 2, 1.0)
    person[2, :3] = (7, 0, 1.0)
    ae.adjust(person, heat)
    assert person[0, :2].tolist() == [4.75, 4.25]
    assert person[1, :2].tolist() == [2.25, 2.25]
    assert person[2, :2].tolist() == [7.75, 0.25]
    assert person[3].tolist() == [0, 0, 0, 0]           # absent: untouched


def test_refine_fills_where_heat_less_tag_distance_is_largest():
    heat = np.zeros((N, 10, 12), np.float32)
    tags = np.zeros((N, 10, 12), np.float32)
    heat[0, 5, 5], tags[0, 5, 5] = 0.9, 1.0          # the person's joint
    heat[1, 2, 2], tags[1, 2, 2] = 0.9, 3.6          # round(2.6) = 3 off
    heat[1, 7, 9], tags[1, 7, 9] = 0.4, 1.4          # round(0.4) = 0 off
    heat[1, 7, 10] = 0.3                             # its right neighbour
    heat[2] = -0.5                                   # nothing over 0
    person = np.zeros((N, 4), np.float32)
    person[0, :3] = (5.25, 5.25, 0.9)                # adjusted already
    ae.refine(person, heat, tags)
    assert person[1, :3].tolist() == pytest.approx([9.75, 7.25, 0.4])
    assert person[2, 2] == 0 and person[0, :3].tolist() == pytest.approx(
        [5.25, 5.25, 0.9])
