"""End-to-end decoding: (conf, paf) maps -> fixed-size skeletons.

Port of `openpose_plus_tpu/postproc/decode.py :: decode_maps` with the
batch dimension written out (no vmap): upsample + smooth, peaks, PAF
candidate scores, greedy assignment (CUDA kernel), subset merge (CUDA
kernel), peak lookup, validity filter and a stable score-sorted compaction.
Everything stays on the maps' device; nothing synchronises with the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from openpose_plus_tpu.config import PostprocConfig
from openpose_plus_tpu_torch.postproc import group, nms, paf


@dataclasses.dataclass
class HumanBatch:
    """Fixed-capacity skeleton results for a batch of images.

    Coordinates are normalized to [0, 1] in network-input space using the
    pixel-center convention (px + 0.5) / extent. Rows are compacted: valid
    humans first, sorted by descending mean score.
    """

    coords: torch.Tensor       # (B, M, 18, 2) float32 — (x, y) normalized
    part_scores: torch.Tensor  # (B, M, 18) float32 peak score (0 if absent)
    part_valid: torch.Tensor   # (B, M, 18) bool
    score: torch.Tensor        # (B, M) float32 mean score
    n_parts: torch.Tensor      # (B, M) int32
    valid: torch.Tensor        # (B, M) bool

    @property
    def num_humans(self) -> torch.Tensor:
        return self.valid.sum(dim=-1)

    def to_list(self, batch_index: int = 0) -> list[dict]:
        """Host-side list-of-humans view:
        [{'parts': {part: (x, y, score)}, 'score': float}]."""
        valid = self.valid[batch_index].cpu().numpy()
        coords = self.coords[batch_index].cpu().numpy()
        pvalid = self.part_valid[batch_index].cpu().numpy()
        pscore = self.part_scores[batch_index].cpu().numpy()
        score = self.score[batch_index].cpu().numpy()
        out = []
        for m in np.nonzero(valid)[0]:
            parts = {
                int(p): (float(coords[m, p, 0]), float(coords[m, p, 1]),
                         float(pscore[m, p]))
                for p in np.nonzero(pvalid[m])[0]
            }
            out.append({"parts": parts, "score": float(score[m])})
        return out

    @classmethod
    def cat(cls, batches: list["HumanBatch"]) -> "HumanBatch":
        """Concatenate along the batch dimension."""
        return cls(**{f.name: torch.cat([getattr(b, f.name)
                                         for b in batches])
                      for f in dataclasses.fields(cls)})


def decode_maps(conf: torch.Tensor, paf_map: torch.Tensor,
                cfg: PostprocConfig) -> HumanBatch:
    """Batched decode: (B, H, W, 19) + (B, H, W, 38) -> HumanBatch.

    Maps are upcast to float32 first (bfloat16 model outputs would change
    the peak ordering)."""
    if cfg.fragment_merge_rel > 0:
        raise NotImplementedError(
            "fragment_merge_rel > 0 (PostprocConfig.quality()) is ROADMAP.md "
            "item 'Flip-TTA and the quality decoder'")
    conf = conf.float()
    paf_map = paf_map.float()
    b = conf.shape[0]
    k = cfg.max_peaks
    smoothed = nms.upsample_smooth(conf, cfg.upsample_factor,
                                   cfg.smooth_sigma)
    peaks = nms.find_peaks(smoothed, cfg.peak_threshold, k)
    cand = paf.score_candidates(
        paf_map, peaks, cfg.paf_n_samples, cfg.paf_sample_threshold,
        cfg.paf_inlier_ratio, lowres_factor=cfg.upsample_factor)
    conns = paf.greedy_assign(cand, k)
    subsets = group.assemble(conns, peaks.score, k, cfg.max_humans)

    h, w = smoothed.shape[1], smoothed.shape[2]
    rx = ((peaks.refined_x + 0.5) / w).reshape(b, -1)       # (B, 18*K)
    ry = ((peaks.refined_y + 0.5) / h).reshape(b, -1)
    table = torch.stack([rx, ry, peaks.score.reshape(b, -1)], dim=-1)

    gids = subsets.parts                                      # (B, M, 18)
    m, n_parts = gids.shape[1], gids.shape[2]
    part_valid = gids >= 0
    safe = torch.where(part_valid, gids, torch.zeros_like(gids)).long()
    vals = table.gather(1, safe.reshape(b, -1, 1).expand(-1, -1, 3))
    vals = vals.reshape(b, m, n_parts, 3)
    coords = torch.where(part_valid[..., None], vals[..., :2],
                         torch.zeros_like(vals[..., :2]))
    part_scores = torch.where(part_valid, vals[..., 2],
                              torch.zeros_like(vals[..., 2]))

    count = subsets.count
    mean_score = torch.where(count > 0,
                             subsets.score / count.clamp_min(1),
                             torch.zeros_like(subsets.score))
    valid = ((count >= cfg.min_parts_per_human)
             & (mean_score > cfg.min_human_score))

    # Compact: valid humans first, by descending mean score; ties keep row
    # order (a STABLE sort, as jnp.argsort).
    key = -torch.where(valid, mean_score,
                       torch.full_like(mean_score, -torch.inf))
    order = torch.argsort(key, dim=1, stable=True)            # (B, M)

    def take(x: torch.Tensor) -> torch.Tensor:
        idx = order.reshape(b, m, *([1] * (x.dim() - 2)))
        return x.gather(1, idx.expand_as(x))

    valid_o = take(valid)
    return HumanBatch(
        coords=take(coords), part_scores=take(part_scores),
        part_valid=take(part_valid) & valid_o[..., None],
        score=take(mean_score), n_parts=take(count).to(torch.int32),
        valid=valid_o)


def merge_dedup(batches, oks_threshold: float = 0.5) -> HumanBatch:
    raise NotImplementedError(
        "merge_dedup is ROADMAP.md item 'Flip-TTA and the quality decoder'")
