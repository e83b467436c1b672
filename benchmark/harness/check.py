"""What decides `correct`: the answers the timed path served, judged against
the plain reference on the same inputs.

The reference works out each sampled image's maps from the seed's weights,
through the cell's network (`models.network`), twice: in float32 with TF32
off, and with what a bf16 network stores rounded to bf16
(`models.forward(..., bf16=True)`), and decodes both as the configuration
states, by the network's decode family (`models.family`: its `read`
gives the heat planes on the decode grid, the peaks, both sides' people
and its own structure data). The bf16-stored reference stands for what
rounding alone may move. Served and reference people of an image are
paired greedily by the parts they share, a part shared where both place
it within the family's tolerance (one cell of the network's finest output
grid). The numbers (a cell's limits file names those it compares):

  peak_error_bf16_units     every served keypoint's score against the
                            float32 heat plane of its part at its pixel (of
                            the two rows and two columns around its
                            subpixel position, the one whose value is
                            nearest the served score): the root of the
                            summed squares of the gaps, over the same of
                            the bf16-stored heat plane's gaps there.
  steady_people_lost        the share of the reference's steady people
                            (those the bf16-stored reference pairs whole)
                            with which no served person shares half their
                            parts or more.
  off_peak_share            the served keypoints farther than the
                            tolerance from every float32 peak of their
                            part.
  keypoint_miss_bf16_units  keypoints of either side that their pair does
                            not share, as a share of all, over the same
                            share of the bf16-stored reference's people.
  person_score_bf16_units   over pairs that share every part, the root of
                            the summed squared gaps of the persons' scores
                            (as the family scores a person), as a share of
                            the reference's, over the same of the
                            bf16-stored reference's pairs.
  <family STRUCTURE>        the share of what holds served people together
                            (their parts' links or tags) that the family's
                            own structure data of the float32 reference
                            breaks (`structure_breaks`).
  steady_people_broken      steady people no served person serves whole.

Exact numbers: the letterbox of every served input against
the reference's (`layout_mismatch`), the answers of one input served again
against its first (`repeat_mismatch`), and the decoder's own guarantees on
every answer (`invariant_breaks`: valid rows first and by descending score,
no valid row with fewer parts than the minimum, part flags only on valid
rows, and the skeleton's part count: an answer with another counts each of
its rows, and serves no people).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from reference import models
from reference.families import Readings as Reference


def invariant_breaks(ans: dict, min_parts: int) -> int:
    """Rows of one image's answer that break the decoder's guarantees."""
    valid, score = ans["valid"], ans["score"]
    breaks = int(np.sum(valid[1:] & ~valid[:-1]))            # valid first
    v = score[valid]
    breaks += int(np.sum(v[1:] > v[:-1]))                      # by score
    breaks += int(np.sum(valid & (ans["n_parts"] < min_parts)))
    breaks += int(np.sum(ans["part_valid"] & ~valid[:, None]))
    return breaks


def part_count_breaks(ans: dict, n_parts: int) -> int:
    """0 where one image's answer serves `n_parts` parts, else its rows (at
    least one)."""
    if all(ans[f].shape[1] == n_parts
           for f in ("coords", "part_scores", "part_valid")):
        return 0
    return max(len(ans["valid"]), 1)


def keypoint_rows(ans: dict, ref: np.ndarray, ref16: np.ndarray) -> list:
    """(served score, reference value, bf16-stored reference value) of each
    of one image's served keypoints, the references read from their
    smoothed heatmaps (H, W, heatmaps) at the keypoint's pixel: of the two rows
    and two columns around its subpixel position, the one whose reference
    value is nearest the served score."""
    h, w, _ = ref.shape
    out = []
    for m in np.nonzero(ans["valid"])[0]:
        for p in np.nonzero(ans["part_valid"][m])[0]:
            x = float(ans["coords"][m, p, 0]) * w - 0.5
            y = float(ans["coords"][m, p, 1]) * h - 0.5
            served = float(ans["part_scores"][m, p])
            pixels = [(yi, xi) for yi in {int(np.floor(y)), int(np.ceil(y))}
                      for xi in {int(np.floor(x)), int(np.ceil(x))}
                      if 0 <= yi < h and 0 <= xi < w]
            if not pixels:                       # outside the map
                out.append((served, 0.0, 0.0))
                continue
            yi, xi = min(pixels, key=lambda c: abs(ref[c[0], c[1], p]
                                                   - served))
            out.append((served, float(ref[yi, xi, p]),
                        float(ref16[yi, xi, p])))
    return out


def served_people(ans: dict) -> tuple[np.ndarray, np.ndarray]:
    """(coords (P, parts, 2), NaN where a part is absent; scores (P,)) of
    one image's served valid rows, coordinates normalized."""
    rows = np.nonzero(ans["valid"])[0]
    xy = ans["coords"][rows].astype(np.float64)
    xy[~ans["part_valid"][rows]] = np.nan
    return xy, ans["score"][rows].astype(np.float64)


def pair(a: np.ndarray, b: np.ndarray, extent: tuple, tol: float
         ) -> tuple[list, np.ndarray]:
    """People of one image paired greedily by the parts they share (a part
    shared where both sides place it within `tol` pixels of the decode
    grid (H, W)): ([(i, j, shared parts)], shared counts (len(a),
    len(b)))."""
    shared = np.zeros((len(a), len(b)), dtype=np.int64)
    if len(a) and len(b):
        d = (a[:, None] - b[None, :]) * np.array(extent[::-1])
        with np.errstate(invalid="ignore"):
            shared = (np.hypot(d[..., 0], d[..., 1]) <= tol).sum(-1)
    counts = shared.copy()
    pairs = []
    while shared.size and shared.max() > 0:
        i, j = np.unravel_index(np.argmax(shared), shared.shape)
        pairs.append((int(i), int(j), int(shared[i, j])))
        shared[i, :] = -1
        shared[:, j] = -1
    return pairs, counts


@dataclasses.dataclass
class Agreement:
    """One side's people against the float32 reference's over a sample:
    keypoints and misses, the (side, reference) scores of pairs sharing
    every part, and the reference's steady people (those the bf16-stored
    reference pairs whole) that the side loses (no person sharing half
    their parts or more) or does not serve whole."""

    keypoints: int = 0
    misses: int = 0
    scores: list = dataclasses.field(default_factory=list)
    steady: int = 0
    lost: int = 0
    broken: int = 0

    def add(self, side: tuple, ref: tuple, steady: list, extent: tuple,
            tol: float) -> None:
        """One image: `side` and `ref` as served_people gives them,
        `steady` the indices of the reference's steady people."""
        (a, sa), (b, sb) = side[:2], ref[:2]
        na, nb = ~np.isnan(a[..., 0]), ~np.isnan(b[..., 0])
        pairs, counts = pair(a, b, extent, tol)
        self.keypoints += int(na.sum() + nb.sum())
        self.misses += int(na.sum() + nb.sum()) - 2 * sum(
            k for _, _, k in pairs)
        self.scores += [(sa[i], sb[j]) for i, j, k in pairs
                        if k == na[i].sum() == nb[j].sum()]
        self.steady += len(steady)
        self.lost += sum(not np.any(2 * counts[:, j] >= nb[j].sum())
                         for j in steady)
        self.broken += sum(not np.any((counts[:, j] == nb[j].sum())
                                      & (na.sum(-1) == nb[j].sum()))
                           for j in steady)

    def miss_share(self) -> float:
        return units(self.misses, self.keypoints)

    def score_gap(self) -> float:
        """Root of the summed squared score gaps over that of the
        reference's scores, over pairs sharing every part."""
        if not self.scores:
            return 0.0
        s, r = np.array(self.scores).T
        return float(np.sqrt(np.sum((s - r) ** 2) / np.sum(r ** 2)))


def units(value: float, unit: float) -> float:
    """value / unit; 0 / 0 is 0, anything else over 0 infinite."""
    if unit > 0:
        return float(value / unit)
    return 0.0 if value == 0 else float("inf")


def off_peak(xy: np.ndarray, peaks, extent: tuple, tol: float,
             n_parts: int) -> tuple[int, int]:
    """(keypoints of people `xy` (P, parts, 2), those farther than `tol`
    from every reference peak of their part)."""
    h, w = extent
    n = far = 0
    for part in range(n_parts):
        pts = xy[:, part]
        pts = pts[~np.isnan(pts[:, 0])] * (w, h) - 0.5
        n += len(pts)
        if not len(pts):
            continue
        py, px = peaks.ys[part], peaks.xs[part]
        if not len(py):
            far += len(pts)
            continue
        d = np.hypot(pts[:, :1] - px[None], pts[:, 1:] - py[None])
        far += int(np.sum(d.min(axis=1) > tol))
    return n, far


def reference(cell_config: dict, sd: dict, planes: np.ndarray,
              postproc: dict, device: torch.device, block: int = 8
              ) -> Reference:
    """The reference's readings of planes (uint8, hin x win), worked out
    `block` images at a time by the network's decode family."""
    model = cell_config["model"]
    net = models.network(model["name"])
    fam = models.family(net)
    skel = fam.skeleton(net)
    ref = Reference(skeleton=skel, family=fam)
    for i in range(0, len(planes), block):
        x = torch.from_numpy(planes[i:i + block]).to(device)
        ref.extend(fam.read(model, sd, x, postproc, skel))
    return ref


def numbers(answers: list, ref: Reference, postproc: dict,
            repeat_mismatch: int, layout_mismatch: int) -> dict:
    """The numbers of a sample: answers[i] (host arrays of one image)
    against the reference's readings of its input."""
    extent, tol, n_parts = ref.extent, ref.tol, ref.n_parts
    no_people = (np.full((0, n_parts, 2), np.nan), np.zeros(0))
    breaks = 0
    rows = []
    program, bf16 = Agreement(), Agreement()
    counts = np.zeros(4, dtype=np.int64)
    for i, ans in enumerate(answers):
        breaks += invariant_breaks(ans, postproc["min_parts_per_human"])
        wrong = part_count_breaks(ans, n_parts)
        breaks += wrong
        if not wrong:
            rows += keypoint_rows(ans, ref.maps[i], ref.maps16[i])
        r, r16 = ref.people[i], ref.people16[i]
        served = no_people if wrong else served_people(ans)
        pairs16, _ = pair(r16[0], r[0], extent, tol)
        steady = [j for i16, j, k in pairs16
                  if k == (~np.isnan(r16[0][i16, :, 0])).sum()
                  == (~np.isnan(r[0][j, :, 0])).sum()]
        program.add(served, r, steady, extent, tol)
        bf16.add(r16, r, [], extent, tol)
        counts += (*off_peak(served[0], ref.peaks[i], extent, tol, n_parts),
                   *ref.family.structure_breaks(served[0], ref.structure[i],
                                                postproc))
    k = np.array(rows, dtype=np.float64).reshape(-1, 3)
    served, refv, ref16 = k.T
    err2 = float(np.sum((served - refv) ** 2))
    bf16_err2 = float(np.sum((ref16 - refv) ** 2))
    return {"peak_error_bf16_units": float(np.sqrt(units(err2, bf16_err2))),
            "keypoint_miss_bf16_units": units(program.miss_share(),
                                              bf16.miss_share()),
            "person_score_bf16_units": units(program.score_gap(),
                                             bf16.score_gap()),
            "steady_people_lost": units(program.lost, program.steady),
            "steady_people_broken": units(program.broken, program.steady),
            "off_peak_share": units(counts[1], counts[0]),
            ref.family.STRUCTURE: units(counts[3], counts[2]),
            "invariant_breaks": breaks, "repeat_mismatch": repeat_mismatch,
            "layout_mismatch": layout_mismatch,
            "keypoints": len(k),
            "peak_score_rel_rms": (float(np.sqrt(err2 / np.sum(refv ** 2)))
                                   if len(k) else 0.0),
            "keypoint_miss_share": program.miss_share(),
            "keypoint_miss_share_bf16": bf16.miss_share(),
            "person_score_gap": program.score_gap(),
            "person_score_gap_bf16": bf16.score_gap(),
            "steady_people": program.steady}


def evaluate(cell_config: dict, sd: dict, answers: list, planes: np.ndarray,
             postproc: dict, device: torch.device, repeat_mismatch: int,
             layout_mismatch: int) -> tuple[dict, Reference]:
    """(numbers, the reference's readings) of answers[i] against the
    reference's readings of planes[i]."""
    ref = reference(cell_config, sd, planes, postproc, device)
    return numbers(answers, ref, postproc, repeat_mismatch,
                   layout_mismatch), ref


def judge(values: dict, limits: dict) -> tuple[bool, list]:
    """(every compared number within its limit, [(name, value, limit)]):
    a number passes at or under its limit."""
    rows = [(name, values[name], limits[name]["limit"]) for name in limits]
    return all(v <= lim for _, v, lim in rows), rows
