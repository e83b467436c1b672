"""PAF line-integral limb scoring + greedy assignment.

Port of `openpose_plus_tpu/postproc/paf.py` (the gather lowering) with the
batch dimension written out: scores are (B, n_limbs, K, K), connection
fields (B, n_limbs, K), n_limbs the skeleton's (`skeletons`). The PAF
samples and `greedy_assign` go through the
dispatching wrappers of the CUDA sampling and greedy kernels
(`ops/cuda/paf_sample.py`, `ops/cuda/greedy.py`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from openpose_plus_tpu_torch import skeletons
from openpose_plus_tpu_torch.ops import device_cache
from openpose_plus_tpu_torch.ops.cuda import greedy, merge, paf_sample
from openpose_plus_tpu_torch.postproc import common, nms
from openpose_plus_tpu_torch.postproc.nms import PeakSet


@dataclasses.dataclass
class Connections:
    """Accepted limb connections in greedy-accept order, (B, n_limbs, K):
    slot t of limb l is the t-th accepted connection (or invalid)."""

    slot_a: torch.Tensor  # int32 peak slot of endpoint A
    slot_b: torch.Tensor  # int32 peak slot of endpoint B
    score: torch.Tensor   # float32 prior-adjusted limb score
    valid: torch.Tensor   # bool


def sample_coords(ax: torch.Tensor, ay: torch.Tensor, dx: torch.Tensor,
                  dy: torch.Tensor, fracs: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Integer sample points (B, L, S, K, K) along every candidate segment:
    round(a + t * d), half to even as jnp.round."""
    f = fracs[None, None, :, None, None]
    sx = torch.round(ax[:, :, None, :, None] + f * dx[:, :, None])
    sy = torch.round(ay[:, :, None, :, None] + f * dy[:, :, None])
    return sy.to(torch.int32), sx.to(torch.int32)


@device_cache
def _tables(device: torch.device, n_samples: int,
            skeleton: skeletons.Skeleton
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The skeleton's limb endpoint pairs ((L, 2) int32, the merge
    kernel's table), PAF channel pairs ((L, 2) int64) and the sample
    fractions, cached per device (no host copy per call)."""
    return (merge.limb_pairs(device, skeleton),
            paf_sample.limb_channels(device, skeleton),
            torch.as_tensor(common.line_sample_fracs(n_samples),
                            device=device))


def score_candidates(paf: torch.Tensor, peaks: PeakSet, n_samples: int,
                     sample_threshold: float, inlier_ratio: float,
                     lowres_factor: int = 1) -> torch.Tensor:
    """Dense candidate scores (B, n_limbs, K, K) of the limbs of the
    skeleton of the peaks' parts and the map's channels (`skeletons.find`);
    invalid pairs -> -inf.

    Mean dot of the PAF with the unit limb direction over `n_samples`
    nearest-neighbour samples, plus the height prior, kept when at least
    ceil(ratio * n) samples exceed `sample_threshold`. With
    `lowres_factor > 1`, `paf` is the network-resolution map and the peaks
    live on the upsampled grid: the map is upsampled (`nms.upsample`) and
    then sampled."""
    h = paf.shape[1] * lowres_factor
    skel = skeletons.find(n_parts=peaks.y.shape[1], n_pafs=paf.shape[-1])
    pairs, chans, fracs = _tables(paf.device, n_samples, skel)

    ax = peaks.x[:, pairs[:, 0]].to(torch.float32)      # (B, L, K)
    ay = peaks.y[:, pairs[:, 0]].to(torch.float32)
    bx = peaks.x[:, pairs[:, 1]].to(torch.float32)
    by = peaks.y[:, pairs[:, 1]].to(torch.float32)
    va = peaks.valid[:, pairs[:, 0]]
    vb = peaks.valid[:, pairs[:, 1]]

    dx = bx[:, :, None, :] - ax[:, :, :, None]          # (B, L, K, K)
    dy = by[:, :, None, :] - ay[:, :, :, None]
    dist = torch.sqrt(dx * dx + dy * dy).clamp_min(1e-4)
    ux, uy = dx / dist, dy / dist

    sy, sx = sample_coords(ax, ay, dx, dy, fracs)
    px, py = paf_sample.sample_paf(
        nms.upsample(paf, lowres_factor).contiguous(), sy, sx, chans)

    dots = px * ux[:, :, None] + py * uy[:, :, None]     # (B, L, S, K, K)
    mean_dot = dots.mean(dim=2)
    inliers = (dots > sample_threshold).sum(dim=2)
    prior = (0.5 * h / dist - 1.0).clamp_max(0.0)
    score = mean_dot + prior

    min_inliers = int(np.ceil(inlier_ratio * n_samples))
    ok = ((inliers >= min_inliers) & (score > 0)
          & va[:, :, :, None] & vb[:, :, None, :])
    return torch.where(ok, score, torch.full_like(score, -torch.inf))


def greedy_assign(scores: torch.Tensor, max_peaks: int) -> Connections:
    """Greedy best-first assignment per limb (ties to the lowest row-major
    candidate index); the CUDA kernel on a GPU tensor."""
    slot_a, slot_b, score, valid = greedy.greedy_assign(
        scores.contiguous(), max_peaks)
    return Connections(slot_a=slot_a, slot_b=slot_b, score=score,
                       valid=valid)
