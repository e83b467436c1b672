"""The PAF family: OpenPose-style networks whose last stage gives heatmaps
and part affinity fields, (conf, paf), grouped into people by limb line
integrals (`reference.decode`, the frozen `reference.oracle`) on a
skeleton of parts, limbs and PAF channels (`oracle.load_skeleton`).

  maps          the network's last (conf, paf)
  heads         the last heatmap and the last PAF prediction: the first
                peaks at the configuration's `conf_max`, the second at
                `paf_max`
  heat planes   the heatmaps upsampled by `upsample_factor` and smoothed
  peaks         every 3x3 local maximum over `peak_threshold` of the
                float32 heat planes
  tolerance     `upsample_factor` pixels of the decode grid (one output
                cell)
  structure     `limb_break_share`: limbs of served people whose line
                integral over the float32 PAF, upsampled, fails the
                decode's test for a connection

It also holds `stages`, the two-branch stages of the CPM networks that end
in (conf, paf), for the network files that build on them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from reference import decode as rdecode
from reference import models, oracle
from reference.families import Readings

STRUCTURE = "limb_break_share"


def stages(feature: torch.Tensor, sd: dict, n_stages: int, r
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """`n_stages` two-branch stages on `feature`; stage t > 1 reads
    concat(feature, conf, paf) of stage t - 1. Returns the last (conf,
    paf)."""
    x = feature
    for s in range(1, n_stages + 1):
        if s > 1:
            x = torch.cat([feature, r(conf), r(paf)], dim=1)
        conf = models.branch(x, sd, f"stages.stage{s}_conf", r)
        paf = models.branch(x, sd, f"stages.stage{s}_paf", r)
    return conf, paf


def stage_heads(model: dict) -> tuple[str, str]:
    """The (conf, paf) prediction prefixes of the last stage of
    `stages`."""
    n = model["n_stages"]
    return (f"stages.stage{n}_conf.Conv_0", f"stages.stage{n}_paf.Conv_0")


def stage_predictions(model: dict) -> list[str]:
    """Every prediction prefix of `stages`."""
    return [p for s in range(1, model["n_stages"] + 1)
            for p in stage_heads({"n_stages": s})]


def skeleton(net) -> oracle.Skeleton:
    return oracle.load_skeleton(net.SKELETON)


def head_rule(net, model: dict, skel: oracle.Skeleton) -> list:
    conf, paf = net.heads(model)
    return [(conf, 0, None, "conf_max"), (paf, 1, None, "paf_max")]


def people(humans: list, skel: oracle.Skeleton) -> tuple:
    """One image's oracle people as (coords, scores, part scores, part
    counts), each scored as the program scores a person: its summed score
    over its part count (which counts a part overwritten in the merge
    again)."""
    xy = np.full((len(humans), skel.n_parts, 2), np.nan)
    parts = np.zeros((len(humans), skel.n_parts))
    for i, hu in enumerate(humans):
        for part, (x, y, s) in hu.parts.items():
            xy[i, part] = (x, y)
            parts[i, part] = s
    return xy, np.array([hu.score / hu.n_parts for hu in humans],
                        dtype=np.float64), parts, np.array(
        [hu.n_parts for hu in humans], dtype=np.int64)


def decode(maps: tuple, postproc: dict, skel: oracle.Skeleton,
           extent: tuple = None) -> tuple[list, np.ndarray]:
    """(The extent is the upsampling's: `extent` is not read.)"""
    conf, paf = maps
    humans, smoothed = rdecode.decode(conf, paf, postproc, skel)
    return [people(h, skel) for h in humans], smoothed


@dataclasses.dataclass
class Limbs:
    """One image's structure data: its upsampled float32 PAF (H, W, PAF
    channels) and the skeleton."""

    paf: np.ndarray
    skeleton: oracle.Skeleton


def read(model: dict, sd: dict, x: torch.Tensor, postproc: dict,
         skel: oracle.Skeleton) -> Readings:
    conf, paf = models.forward(model, sd, x)
    found, smoothed = decode((conf, paf), postproc, skel)
    paf_up = rdecode.resample(paf, postproc["upsample_factor"],
                              0.0).cpu().numpy()
    del conf, paf
    maps16 = models.forward(model, sd, x, bf16=True)
    found16, smoothed16 = decode(maps16, postproc, skel)
    del maps16
    return Readings(
        maps=list(smoothed), maps16=list(smoothed16),
        peaks=[oracle.find_peaks(m, skel, postproc["peak_threshold"], None)
               for m in smoothed],
        people=found, people16=found16,
        structure=[Limbs(p, skel) for p in paf_up],
        extent=smoothed.shape[1:3],
        tol=float(postproc["upsample_factor"]), skeleton=skel)


def structure_breaks(xy: np.ndarray, limbs: Limbs, postproc: dict
                     ) -> tuple[int, int]:
    return limb_breaks(xy, limbs.paf, postproc, limbs.skeleton)


def limb_breaks(xy: np.ndarray, paf: np.ndarray, postproc: dict,
                skeleton: oracle.Skeleton) -> tuple[int, int]:
    """(limbs of people `xy` (P, parts, 2) with both parts present, those
    whose line integral over the reference's upsampled PAF (H, W, PAF
    channels) at the parts' pixels fails the decode's test for a
    connection)."""
    h, w, _ = paf.shape
    f32 = np.float32
    n_samples = postproc["paf_n_samples"]
    need = int(np.ceil(postproc["paf_inlier_ratio"] * n_samples))
    fracs = np.linspace(0.0, 1.0, n_samples).astype(f32)
    n = bad = 0
    for limb, (ia, ib) in enumerate(skeleton.limbs):
        cx, cy = skeleton.paf_channels[limb]
        ok = ~np.isnan(xy[:, ia, 0]) & ~np.isnan(xy[:, ib, 0])
        if not ok.any():
            continue
        pa = np.round(xy[ok, ia] * (w, h) - 0.5).astype(f32)
        pb = np.round(xy[ok, ib] * (w, h) - 0.5).astype(f32)
        pa = np.clip(pa, 0, (w - 1, h - 1))
        pb = np.clip(pb, 0, (w - 1, h - 1))
        d = pb - pa
        dist = np.maximum(np.hypot(d[:, 0], d[:, 1]).astype(f32), f32(1e-4))
        u = d / dist[:, None]
        sx = np.round(pa[:, :1] + fracs * d[:, :1]).astype(np.int64)
        sy = np.round(pa[:, 1:] + fracs * d[:, 1:]).astype(np.int64)
        dots = paf[sy, sx, cx] * u[:, :1] + paf[sy, sx, cy] * u[:, 1:]
        inliers = np.sum(dots > f32(postproc["paf_sample_threshold"]), -1)
        score = dots.mean(-1) + np.minimum(0.5 * h / dist - 1.0, 0.0)
        n += int(ok.sum())
        bad += int(np.sum((inliers < need) | (score <= 0)))
    return n, bad
