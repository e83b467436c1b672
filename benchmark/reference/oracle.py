"""The bottom-up PAF grouping of OpenPose (Cao et al. CVPR 2017, the
CMU / tf-pose grouping) in plain numpy: a frozen copy of the grouping
oracle that the served program is held to, so that the benchmark's
reference imports nothing of the program.

  1. 3x3 local-max NMS of the smoothed heatmaps above a threshold, one
     peak per exact plateau (the lowest flat index), ordered by score
     (ties: flat index), the top `max_peaks` of each part;
  2. per limb, every peak pair scored by a line integral over the PAF
     (nearest-neighbour samples, >= ceil(ratio * n) inliers, height
     prior, a positive score);
  3. greedy highest-score-first assignment per limb;
  4. the sequential subset merge into people (CMU's quirk of overwriting
     an occupied slot while counting it is kept; a fixed table of
     `max_humans` rows, a merged row cleared in place);
  5. people with too few parts or too low a mean score dropped; the
     peaks refined to subpixel by a quadratic fit.

Step 2 scores all pairs of a limb at once, in the same float32
arithmetic as the one-pair-at-a-time original.

The parts, the limbs, their PAF channels and the limbs that may start a
person are the network's skeleton: a file `skeletons/<name>.json` beside
this module, read by `load_skeleton`.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

SKELETON_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "skeletons")


@dataclasses.dataclass(frozen=True)
class Skeleton:
    """A body schema: `n_parts` parts (heatmap channels 0 .. n_parts - 1),
    the limbs' (part_a, part_b) in the order the grouping takes them, the
    (x, y) PAF channels of each limb, and `person_limbs`: limbs before it
    may start a person, the rest only join one."""

    name: str
    n_parts: int
    limbs: tuple
    paf_channels: tuple
    person_limbs: int


def load_skeleton(name: str) -> Skeleton:
    """`skeletons/<name>.json` as a Skeleton."""
    path = os.path.join(SKELETON_DIR, f"{name}.json")
    with open(path) as f:
        d = json.load(f)
    skel = Skeleton(name, d["parts"], tuple(map(tuple, d["limbs"])),
                    tuple(map(tuple, d["paf_channels"])), d["person_limbs"])
    if len(skel.paf_channels) != len(skel.limbs) or not (
            0 <= skel.person_limbs <= len(skel.limbs)) or any(
            not 0 <= p < skel.n_parts for limb in skel.limbs for p in limb):
        raise ValueError(f"{path}: limbs, PAF channels and person_limbs "
                         f"do not fit {skel.n_parts} parts")
    return skel


@dataclasses.dataclass
class Peaks:
    """Per-part peak lists, by descending score (ties: flat index)."""

    ys: list
    xs: list
    scores: list


@dataclasses.dataclass
class Human:
    parts: dict          # part -> (x, y, score); normalized once decoded
    score: float         # sum of peak and connection scores
    n_parts: int


def find_peaks(maps: np.ndarray, skeleton: Skeleton, threshold: float,
               max_peaks) -> Peaks:
    """Peaks of each part's channel of (H, W, >= parts) smoothed maps: >=
    all 8 neighbours (-inf border), > threshold, and the lowest flat index
    among the equal-valued candidates around it; `max_peaks` None keeps
    all."""
    h, w, _ = maps.shape
    m = np.ascontiguousarray(
        np.moveaxis(maps[:, :, :skeleton.n_parts], 2, 0))
    padded = np.pad(m, ((0, 0), (1, 1), (1, 1)), constant_values=-np.inf)
    is_max = m > threshold
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                is_max &= m >= padded[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
    idx = np.arange(h * w, dtype=np.float32).reshape(h, w)
    u = np.where(is_max, -idx, -np.inf).astype(np.float32)
    up = np.pad(u, ((0, 0), (1, 1), (1, 1)), constant_values=-np.inf)
    umax = np.full(u.shape, -np.inf, dtype=np.float32)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            umax = np.maximum(umax, up[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w])
    is_max &= u >= umax
    ys, xs, scores = [], [], []
    for part in range(skeleton.n_parts):
        py, px = np.nonzero(is_max[part])
        s = m[part, py, px]
        order = np.lexsort((py * w + px, -s))[:max_peaks]
        ys.append(py[order])
        xs.append(px[order])
        scores.append(s[order].astype(np.float32))
    return Peaks(ys, xs, scores)


def limb_candidates(paf: np.ndarray, peaks: Peaks, skeleton: Skeleton,
                    limb: int, n_samples: int, sample_threshold: float,
                    inlier_ratio: float) -> list:
    """Every valid (slot_a, slot_b, score) of one limb, in (slot_a,
    slot_b) order, all arithmetic in float32."""
    f32 = np.float32
    ia, ib = skeleton.limbs[limb]
    cx, cy = skeleton.paf_channels[limb]
    na, nb = len(peaks.scores[ia]), len(peaks.scores[ib])
    if not (na and nb):
        return []
    fracs = np.linspace(0.0, 1.0, n_samples).astype(f32)
    ax = peaks.xs[ia].astype(f32)[:, None]
    ay = peaks.ys[ia].astype(f32)[:, None]
    dx = peaks.xs[ib].astype(f32)[None, :] - ax                # (na, nb)
    dy = peaks.ys[ib].astype(f32)[None, :] - ay
    dist = np.maximum(np.sqrt(dx * dx + dy * dy, dtype=f32), f32(1e-4))
    ux, uy = dx / dist, dy / dist
    sx = np.round(ax[..., None] + fracs * dx[..., None]).astype(np.int64)
    sy = np.round(ay[..., None] + fracs * dy[..., None]).astype(np.int64)
    dots = (paf[sy, sx, cx] * ux[..., None]
            + paf[sy, sx, cy] * uy[..., None]).astype(f32)
    inliers = np.sum(dots > f32(sample_threshold), axis=-1)
    mean = np.mean(dots, axis=-1, dtype=f32)
    prior = np.minimum(0.5 * paf.shape[0] / dist - 1.0, 0.0)
    score = mean + prior
    ok = (inliers >= int(np.ceil(inlier_ratio * n_samples))) & (score > 0)
    return [(int(a), int(b), float(score[a, b]))
            for a, b in zip(*np.nonzero(ok))]


def greedy_assign(candidates: list, n_a: int, n_b: int) -> list:
    """Best score first, each peak used once; ties in candidate order."""
    if not candidates:
        return []
    idx = np.array([a * max(n_b, 1) + b for a, b, _ in candidates])
    sc = np.array([s for _, _, s in candidates])
    out, used_a, used_b = [], set(), set()
    for i in np.lexsort((idx, -sc)):
        a, b, s = candidates[i]
        if a in used_a or b in used_b:
            continue
        used_a.add(a)
        used_b.add(b)
        out.append((a, b, s))
        if len(out) >= min(n_a, n_b):
            break
    return out


def assemble(connections: list, peaks: Peaks, skeleton: Skeleton,
             max_peaks: int, min_parts: int, min_score: float,
             max_humans: int) -> list:
    """The sequential subset merge, limb by limb in greedy order. One
    matching row: attach b (overwriting, and counting, an occupant); two:
    merge when part-disjoint, else attach b to the first; more: nothing;
    none, limb < person_limbs: a new row in the first empty slot."""
    parts = np.full((max_humans, skeleton.n_parts), -1, dtype=np.int64)
    score = np.zeros(max_humans, dtype=np.float64)
    count = np.zeros(max_humans, dtype=np.int64)

    def peak_score(gid: int) -> float:
        part, slot = divmod(gid, max_peaks)
        return float(peaks.scores[part][slot])

    for limb, conns in enumerate(connections):
        ia, ib = skeleton.limbs[limb]
        for sa, sb, cscore in conns:
            a_gid, b_gid = ia * max_peaks + sa, ib * max_peaks + sb
            found = np.nonzero((parts[:, ia] == a_gid)
                               | (parts[:, ib] == b_gid))[0]
            if len(found) == 1:
                j = found[0]
                if parts[j, ib] != b_gid:
                    parts[j, ib] = b_gid
                    count[j] += 1
                    score[j] += peak_score(b_gid) + cscore
            elif len(found) == 2:
                j1, j2 = found
                if not np.any((parts[j1] >= 0) & (parts[j2] >= 0)):
                    parts[j1] = np.where(parts[j2] >= 0, parts[j2],
                                         parts[j1])
                    count[j1] += count[j2]
                    score[j1] += score[j2] + cscore
                    parts[j2], count[j2], score[j2] = -1, 0, 0.0
                else:
                    parts[j1, ib] = b_gid
                    count[j1] += 1
                    score[j1] += peak_score(b_gid) + cscore
            elif len(found) == 0 and limb < skeleton.person_limbs:
                empty = np.nonzero(count == 0)[0]
                if len(empty):
                    j = empty[0]
                    parts[j, ia], parts[j, ib] = a_gid, b_gid
                    count[j] = 2
                    score[j] = (peak_score(a_gid) + peak_score(b_gid)
                                + cscore)
    humans = []
    for j in range(max_humans):
        if count[j] < min_parts or count[j] == 0:
            continue
        if score[j] / count[j] <= min_score:
            continue
        found = {}
        for part in range(skeleton.n_parts):
            gid = int(parts[j, part])
            if gid >= 0:
                p, slot = divmod(gid, max_peaks)
                found[part] = (float(peaks.xs[p][slot]),
                               float(peaks.ys[p][slot]),
                               float(peaks.scores[p][slot]))
        humans.append(Human(found, float(score[j]), int(count[j])))
    return humans


def refine(maps: np.ndarray, x: float, y: float, part: int
           ) -> tuple[float, float]:
    """Quadratic subpixel offset in [-0.5, 0.5] on each axis; none at a
    border or where the parabola is flat."""
    h, w, _ = maps.shape
    xi, yi = int(x), int(y)
    m = maps[:, :, part]

    def offset(c, prev, nxt):
        c, prev, nxt = np.float32(c), np.float32(prev), np.float32(nxt)
        denom = 2.0 * c - nxt - prev
        off = 0.5 * (nxt - prev) / denom if abs(denom) > 1e-6 else 0.0
        return float(np.clip(off, -0.5, 0.5))

    ox = (offset(m[yi, xi], m[yi, xi - 1], m[yi, xi + 1])
          if 0 < xi < w - 1 else 0.0)
    oy = (offset(m[yi, xi], m[yi - 1, xi], m[yi + 1, xi])
          if 0 < yi < h - 1 else 0.0)
    return x + ox, y + oy


def group(smoothed: np.ndarray, paf: np.ndarray, cfg: dict,
          skeleton: Skeleton) -> list:
    """People of one image from its smoothed heatmaps and upsampled PAF
    (both at the decode resolution), coordinates normalized as
    (px + 0.5) / extent. `cfg`: the post-processing parameters by their
    names in the configuration file."""
    peaks = find_peaks(smoothed, skeleton, cfg["peak_threshold"],
                       cfg["max_peaks"])
    connections = []
    for limb, (ia, ib) in enumerate(skeleton.limbs):
        cands = limb_candidates(paf, peaks, skeleton, limb,
                                cfg["paf_n_samples"],
                                cfg["paf_sample_threshold"],
                                cfg["paf_inlier_ratio"])
        connections.append(greedy_assign(cands, len(peaks.scores[ia]),
                                         len(peaks.scores[ib])))
    humans = assemble(connections, peaks, skeleton, cfg["max_peaks"],
                      cfg["min_parts_per_human"], cfg["min_human_score"],
                      cfg["max_humans"])
    h, w, _ = smoothed.shape
    for hu in humans:
        refined = {}
        for part, (x, y, s) in hu.parts.items():
            rx, ry = refine(smoothed, x, y, part)
            refined[part] = ((rx + 0.5) / w, (ry + 0.5) / h, s)
        hu.parts = refined
    return humans
