"""The associative-embedding family: bottom-up networks whose outputs give
heatmaps at two or more resolutions and, in the coarsest, one tag a part
(Newell et al. NeurIPS 2017), grouped into people by matching tags joint
by joint. This is HigherHRNet's single-scale test path (Cheng et al. CVPR
2020, github.com/HRNet/HigherHRNet-Human-Pose-Estimation:
`lib/core/inference.py` `get_multi_stage_outputs` and `aggregate_results`,
`lib/core/group.py` `HeatmapParser`) in plain numpy and torch, with the
TEST settings of `experiments/coco/higher_hrnet/w32_512_adam_lr1e-3.yaml`:
its sizes and thresholds as the configuration's `postproc` names them,
ADJUST, REFINE, PROJECT2IMAGE and USE_DETECTION_VAL on, IGNORE_TOO_MUCH
off, and without flip:

  maps          the network's outputs, coarsest first: the first gives the
                heatmaps (its first `parts` channels) and one tag a part
                (the next `parts`), each later one heatmaps only
  heads         `heads(model)`, the prediction conv of each output: every
                heatmap channel peaks at the configuration's `conf_max`,
                every tag channel at `tag_max`, each channel slice of a
                conv centred and scaled on its own
  heat planes   each output's heatmaps resized (bilinear, half-pixel
                centres, `align_corners=False`) to the finest output's
                grid and averaged; the tags of the first resized the same
                way; both resized again to the input size (PROJECT2IMAGE),
                which is then the decode grid
  peaks         a part's `nms_kernel` x `nms_kernel` maxima (padding
                `nms_padding`; every value equal to its window's maximum
                kept) over `detection_threshold`, and the points `refine`
                gave the float32 reference's people
  tolerance     one cell of the finest output, in pixels of the decode
                grid
  structure     `tag_break_share`: parts of served people whose float32
                tag lies more than `tag_threshold` from their person's mean
                tag

Grouping (`group`), image by image: the top `max_num_people` NMS maxima of
each part, ties to the lower flat index; `match_by_tag` in the skeleton's
`joint_order`: candidates over `detection_threshold`; the cost round(|tag -
mean tag of person|) * 100 - value (numpy's round, half to even), solved
by a Hungarian assignment written here (`hungarian`); a pair below
`tag_threshold` (unrounded) joins the person, any other candidate starts
one; `adjust` moves each coordinate a quarter pixel towards its larger
neighbour on that axis (towards the lower index on a tie) and adds 0.5; a
person's score is the mean of its joints' values, an absent joint 0,
before `refine`, which fills each missing joint at argmax(heat - round(|tag
- mean tag|)) with the same quarter shift. Coordinates are normalized by
the decode grid.

Departures from the original, each a choice where it is ambiguous or
serves one image: people are kept in the order they start, where the
original keys them by their first tag's value (two bit-equal tags would
merge two people); where there are more candidates than people the
assignment is solved on the real columns alone, which the original pads
with columns of 1e10 (a constant added to every full assignment: the same
optimum).
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch
import torch.nn.functional as F

from reference import models
from reference.families import Readings

STRUCTURE = "tag_break_share"
SKELETON_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "skeletons")


@dataclasses.dataclass(frozen=True)
class Skeleton:
    """A keypoint set: `n_parts` parts and the order `match_by_tag` takes
    them in."""

    name: str
    n_parts: int
    joint_order: tuple


def load_skeleton(name: str) -> Skeleton:
    path = os.path.join(SKELETON_DIR, f"{name}.json")
    with open(path) as f:
        d = json.load(f)
    skel = Skeleton(name, d["parts"], tuple(d["joint_order"]))
    if sorted(skel.joint_order) != list(range(skel.n_parts)):
        raise ValueError(f"{path}: joint_order is no order of "
                         f"{skel.n_parts} parts")
    return skel


def skeleton(net) -> Skeleton:
    return load_skeleton(net.SKELETON)


def head_rule(net, model: dict, skel: Skeleton) -> list:
    n = skel.n_parts
    heads = net.heads(model)
    return ([(heads[0], 0, slice(0, n), "conf_max"),
             (heads[0], 0, slice(n, 2 * n), "tag_max")]
            + [(h, i, slice(0, n), "conf_max")
               for i, h in enumerate(heads[1:], 1)])


def init(name: str, shape: tuple, generator: torch.Generator):
    """BatchNorms' tensors (every 1-D weight of these networks is a
    BatchNorm's): running variances in [1, 1.25), means about zero at 0.1,
    weights about one at 0.1, the batch count zero; None for anything
    else."""
    dev = generator.device
    if name.endswith(".running_var"):
        return 1.0 + 0.25 * torch.rand(shape, generator=generator,
                                       device=dev)
    if name.endswith(".running_mean"):
        return 0.1 * torch.randn(shape, generator=generator, device=dev)
    if name.endswith(".num_batches_tracked"):
        return torch.zeros(shape, device=dev)
    if name.endswith(".weight") and len(shape) == 1:
        return 1.0 + 0.1 * torch.randn(shape, generator=generator,
                                       device=dev)
    return None


def aggregate(maps: tuple, n: int, size: tuple
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The network's outputs (NHWC, coarsest first) -> (heatmaps, tags),
    (B, n, H, W) float32 on the decode grid, `size` (the input's (H,
    W))."""
    outs = [m.permute(0, 3, 1, 2) for m in maps]
    last = outs[-1].shape[2:]
    total, tags = 0, None
    for i, out in enumerate(outs):
        if len(outs) > 1 and i != len(outs) - 1:
            out = F.interpolate(out, size=last, mode="bilinear",
                                align_corners=False)
        total = total + out[:, :n]
        if i == 0:
            tags = out[:, n:2 * n]
    heat, tags = (F.interpolate(t, size=tuple(size), mode="bilinear",
                                align_corners=False)
                  for t in (total / len(outs), tags))
    return heat.contiguous(), tags.contiguous()


@dataclasses.dataclass
class Peaks:
    """Per-part peak positions on the decode grid."""

    ys: list
    xs: list


def candidates(heat: torch.Tensor, postproc: dict) -> tuple[list, Peaks]:
    """One image's (n, H, W) heatmaps -> (per part (x, y, value) of its top
    `max_num_people` NMS maxima over `detection_threshold`, by value, ties
    to the lower flat index; every such maximum as Peaks)."""
    k = postproc["nms_kernel"]
    pooled = F.max_pool2d(heat[None], k, 1, postproc["nms_padding"])[0]
    keep = ((pooled == heat) & (heat > postproc["detection_threshold"]))
    keep = keep.cpu().numpy()
    h = heat.cpu().numpy()
    w = h.shape[2]
    out, ys, xs = [], [], []
    for part in range(h.shape[0]):
        py, px = np.nonzero(keep[part])
        ys.append(py)
        xs.append(px)
        val = h[part, py, px]
        order = np.lexsort((py * w + px, -val))[:postproc["max_num_people"]]
        out.append((px[order], py[order], val[order]))
    return out, Peaks(ys, xs)


def hungarian(cost) -> tuple[np.ndarray, np.ndarray]:
    """The least-cost assignment of a rectangular cost matrix, as scipy's
    `linear_sum_assignment` gives it: (rows, columns), rows ascending, one
    pair a row or a column, whichever are fewer. The shortest augmenting
    path method with row and column potentials, in float64."""
    cost = np.asarray(cost, dtype=np.float64)
    flip = cost.shape[0] > cost.shape[1]
    if flip:
        cost = cost.T
    n, m = cost.shape
    if n == 0:
        empty = np.zeros(0, dtype=np.int64)
        return empty, empty
    u, v = np.zeros(n + 1), np.zeros(m + 1)
    match = np.zeros(m + 1, dtype=np.int64)      # column -> row, 1-based
    way = np.zeros(m + 1, dtype=np.int64)
    for i in range(1, n + 1):
        match[0], j0 = i, 0
        minv = np.full(m + 1, np.inf)
        used = np.zeros(m + 1, dtype=bool)
        while True:
            used[j0] = True
            i0 = match[j0]
            cur = cost[i0 - 1] - u[i0] - v[1:]
            free = ~used[1:]
            better = free & (cur < minv[1:])
            minv[1:][better] = cur[better]
            way[1:][better] = j0
            reach = np.where(free, minv[1:], np.inf)
            j1 = int(np.argmin(reach)) + 1
            delta = reach[j1 - 1]
            u[match[used]] += delta
            v[used] -= delta
            minv[~used] -= delta
            j0 = j1
            if match[j0] == 0:
                break
        while j0:
            j1 = way[j0]
            match[j0] = match[j1]
            j0 = j1
    cols = np.nonzero(match[1:])[0]
    rows = match[1:][cols] - 1
    if flip:
        rows, cols = cols, rows
    order = np.argsort(rows)
    return rows[order], cols[order]


def match_by_tag(cands: list, tags: np.ndarray, postproc: dict,
                 skel: Skeleton) -> list:
    """One image's candidates (`candidates`) and tag planes (n, H, W)
    float32 -> people, each (n, 4) float32 rows (x, y, value, tag), a
    joint absent where its value is 0."""
    n = skel.n_parts
    people, person_tags = [], []
    for i, idx in enumerate(skel.joint_order):
        px, py, val = cands[idx]
        tag = tags[idx, py, px].astype(np.float32)
        joints = np.stack([px, py, val, tag], 1).astype(np.float64)
        if not len(joints):
            continue
        if i == 0 or not people:
            for row in range(len(joints)):
                people.append(np.zeros((n, 4)))
                people[-1][idx] = joints[row]
                person_tags.append([tag[row:row + 1]])
            continue
        grouped = range(min(len(people), postproc["max_num_people"]))
        mean = np.array([np.mean(person_tags[p], axis=0) for p in grouped])
        dist = np.linalg.norm(joints[:, None, 3:] - mean[None], ord=2,
                              axis=2)
        cost = np.round(dist) * 100 - joints[:, 2:3]
        rows, cols = hungarian(cost)
        into = dict(zip(rows.tolist(), cols.tolist()))
        for row in range(len(joints)):
            col = into.get(row)
            if col is not None and dist[row, col] < postproc["tag_threshold"]:
                people[col][idx] = joints[row]
                person_tags[col].append(tag[row:row + 1])
            else:
                people.append(np.zeros((n, 4)))
                people[-1][idx] = joints[row]
                person_tags.append([tag[row:row + 1]])
    return [p.astype(np.float32) for p in people]


def _quarter(plane: np.ndarray, y: int, x: int) -> tuple[float, float]:
    """(dx, dy): a quarter pixel towards the larger neighbour on each
    axis, towards the lower index on a tie (the edge pixel standing in for
    a missing neighbour)."""
    h, w = plane.shape
    dx = 0.25 if plane[y, min(x + 1, w - 1)] > plane[y, max(x - 1, 0)] \
        else -0.25
    dy = 0.25 if plane[min(y + 1, h - 1), x] > plane[max(y - 1, 0), x] \
        else -0.25
    return dx, dy


def adjust(person: np.ndarray, heat: np.ndarray) -> np.ndarray:
    """A person's present joints moved a quarter pixel each way
    (`_quarter`) and by 0.5, in place."""
    for j in np.nonzero(person[:, 2] > 0)[0]:
        x, y = person[j, 0], person[j, 1]
        dx, dy = _quarter(heat[j], int(y), int(x))
        person[j, 0], person[j, 1] = x + dx + 0.5, y + dy + 0.5
    return person


def refine(person: np.ndarray, heat: np.ndarray, tags: np.ndarray
           ) -> np.ndarray:
    """A person's missing joints filled, in place, where the heatmap less
    the rounded tag distance from the person's mean tag is largest, if the
    heatmap is above 0 there."""
    present = np.nonzero(person[:, 2] > 0)[0]
    seen = np.array([tags[j, int(person[j, 1]), int(person[j, 0])]
                     for j in present], dtype=np.float32)[:, None]
    mean = np.mean(seen, axis=0)
    for j in np.nonzero(person[:, 2] == 0)[0]:
        dist = ((tags[j][..., None] - mean[None, None, :]) ** 2).sum(
            axis=2) ** 0.5
        y, x = np.unravel_index(np.argmax(heat[j] - np.round(dist)),
                                heat[j].shape)
        val = heat[j, y, x]
        if val > 0:
            dx, dy = _quarter(heat[j], y, x)
            person[j, 0], person[j, 1] = x + 0.5 + dx, y + 0.5 + dy
            person[j, 2] = val
    return person


def group(heat: torch.Tensor, tags: torch.Tensor, postproc: dict,
          skel: Skeleton) -> tuple[tuple, Peaks]:
    """One image's (n, H, W) heatmaps and tags on the decode grid ->
    (people (coords, scores, part scores, part counts), its peaks and the
    points refine filled)."""
    cands, peaks = candidates(heat, postproc)
    h, t = heat.cpu().numpy(), tags.cpu().numpy()
    people = match_by_tag(cands, t, postproc, skel)
    scores = []
    for p in people:
        adjust(p, h)
        scores.append(float(p[:, 2].mean()))
        missing = p[:, 2] == 0
        refine(p, h, t)
        for j in np.nonzero(missing & (p[:, 2] > 0))[0]:
            peaks.xs[j] = np.append(peaks.xs[j], int(p[j, 0]))
            peaks.ys[j] = np.append(peaks.ys[j], int(p[j, 1]))
    n, ext = skel.n_parts, np.array([h.shape[2], h.shape[1]])
    xy = np.full((len(people), n, 2), np.nan)
    parts = np.zeros((len(people), n))
    for i, p in enumerate(people):
        ok = p[:, 2] > 0
        xy[i, ok] = p[ok, :2].astype(np.float64) / ext
        parts[i, ok] = p[ok, 2]
    counts = np.array([int((p[:, 2] > 0).sum()) for p in people],
                      dtype=np.int64)
    return (xy, np.array(scores), parts, counts), peaks


def decode(maps: tuple, postproc: dict, skel: Skeleton, extent: tuple
           ) -> tuple[list, np.ndarray]:
    heat, tags = aggregate(maps, skel.n_parts, extent)
    found = [group(heat[b], tags[b], postproc, skel)[0]
             for b in range(heat.shape[0])]
    return found, heat.permute(0, 2, 3, 1).cpu().numpy()


def read(model: dict, sd: dict, x: torch.Tensor, postproc: dict,
         skel: Skeleton) -> Readings:
    maps = models.forward(model, sd, x)
    extent = tuple(x.shape[1:3])
    tol = extent[1] / maps[-1].shape[2]
    heat, tags = aggregate(maps, skel.n_parts, extent)
    del maps
    found, peaks = zip(*[group(heat[b], tags[b], postproc, skel)
                         for b in range(heat.shape[0])])
    found16, heat16 = decode(models.forward(model, sd, x, bf16=True),
                             postproc, skel, extent)
    return Readings(
        maps=list(heat.permute(0, 2, 3, 1).cpu().numpy()),
        maps16=list(heat16), peaks=list(peaks), people=list(found),
        people16=found16,
        structure=list(tags.permute(0, 2, 3, 1).cpu().numpy()),
        extent=extent, tol=float(tol), skeleton=skel)


def structure_breaks(xy: np.ndarray, tags: np.ndarray, postproc: dict
                     ) -> tuple[int, int]:
    """(parts of people `xy` (P, parts, 2), those whose float32 tag (tags
    (H, W, parts) at the part's pixel) lies more than `tag_threshold` from
    the mean of their person's tags)."""
    h, w, _ = tags.shape
    n = bad = 0
    for person in xy:
        parts = np.nonzero(~np.isnan(person[:, 0]))[0]
        if not len(parts):
            continue
        px = np.clip(np.round(person[parts] * (w, h) - 0.5), 0,
                     (w - 1, h - 1)).astype(np.int64)
        t = tags[px[:, 1], px[:, 0], parts]
        n += len(parts)
        bad += int(np.sum(np.abs(t - t.mean()) > postproc["tag_threshold"]))
    return n, bad
