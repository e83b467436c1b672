"""Maps to people, plainly: the maps upsampled by bilinear interpolation
(half-pixel centres; at an edge the one tap inside the map), smoothed by a
zero-padded Gaussian (radius ceil(3 sigma)), both in float64 and rounded
once to float32, then grouped image by image by the frozen oracle."""

from __future__ import annotations

import concurrent.futures
import math

import numpy as np
import torch

from reference import oracle


def _gaussian(sigma: float) -> np.ndarray:
    if sigma <= 0:
        return np.ones(1)
    radius = int(math.ceil(3.0 * sigma))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32).astype(np.float64)


def _upsample_axis(n_in: int, factor: int) -> np.ndarray:
    """(n_in * factor, n_in) bilinear weights."""
    n_out = n_in * factor
    src = (np.arange(n_out) + 0.5) / factor - 0.5
    lo = np.floor(src).astype(np.int64)
    frac = src - lo
    r = np.zeros((n_out, n_in))
    rows = np.arange(n_out)
    for tap, wt in ((lo, 1.0 - frac), (lo + 1, frac)):
        ok = (tap >= 0) & (tap < n_in)
        r[rows[ok], tap[ok]] += wt[ok]
    return r / r.sum(axis=1, keepdims=True)


def _smooth_axis(n: int, sigma: float) -> np.ndarray:
    k = _gaussian(sigma)
    rad = k.size // 2
    g = np.zeros((n, n))
    for j, kv in enumerate(k):
        off = j - rad
        idx = np.arange(max(0, -off), min(n, n - off))
        g[idx, idx + off] = kv
    return g


def resample(maps: torch.Tensor, factor: int, sigma: float) -> torch.Tensor:
    """(B, H, W, C) -> (B, H*factor, W*factor, C): upsampled, then smoothed
    when sigma > 0, float64 throughout, float32 out."""
    out = maps.double()
    for axis in (1, 2):
        a = _upsample_axis(maps.shape[axis], factor)
        if sigma > 0:
            a = _smooth_axis(a.shape[0], sigma) @ a
        op = torch.from_numpy(a).to(maps.device)
        out = torch.movedim(torch.tensordot(op, out, dims=([1], [axis])),
                            0, axis)
    return out.float()


def decode(conf: torch.Tensor, paf: torch.Tensor, cfg: dict,
           skeleton: oracle.Skeleton, workers: int = 4
           ) -> tuple[list, np.ndarray]:
    """(B, h, w, heatmaps) and (B, h, w, PAF channels) maps -> (people of
    each image, the smoothed heatmaps (B, H, W, heatmaps) at the decode
    resolution, numpy), grouped by `skeleton`; the images are grouped on
    `workers` threads."""
    f = cfg["upsample_factor"]
    smoothed = resample(conf, f, cfg["smooth_sigma"]).cpu().numpy()
    paf_up = resample(paf, f, 0.0).cpu().numpy()
    with concurrent.futures.ThreadPoolExecutor(workers) as pool:
        people = list(pool.map(lambda i: oracle.group(
            smoothed[i], paf_up[i], cfg, skeleton), range(smoothed.shape[0])))
    return people, smoothed
