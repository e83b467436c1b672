"""End-to-end decoding: (conf, paf) maps -> fixed-size skeletons.

Port of `openpose_plus_tpu/postproc/decode.py` with the batch dimension
written out (no vmap; `build_decoder` binds a config): upsample + smooth, peaks, PAF candidate scores,
greedy assignment (CUDA kernel), subset merge (CUDA kernel), peak lookup,
the optional fragment-merge pass, validity filter and a stable
score-sorted compaction; and `merge_dedup`, the OKS-NMS combiner of
per-scale results. Everything stays on the maps' device; nothing
synchronises with the host.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from openpose_plus_tpu_torch import skeleton, skeletons
from openpose_plus_tpu_torch.config import PostprocConfig
from openpose_plus_tpu_torch.ops import device_cache
from openpose_plus_tpu_torch.postproc import group, nms, paf
from openpose_plus_tpu_torch.utils.tracer import scope


@dataclasses.dataclass
class HumanBatch:
    """Fixed-capacity skeleton results for a batch of images.

    Coordinates are normalized to [0, 1] in network-input space using the
    pixel-center convention (px + 0.5) / extent. Rows are compacted: valid
    humans first, sorted by descending mean score. P is the skeleton's
    part count: 18 (COCO) or 25 (BODY_25).
    """

    coords: torch.Tensor       # (B, M, P, 2) float32 — (x, y) normalized
    part_scores: torch.Tensor  # (B, M, P) float32 peak score (0 if absent)
    part_valid: torch.Tensor   # (B, M, P) bool
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


def _lookup(table: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """table (B, N, C) rows at index (B, R) -> (B, R, C), as the reference's
    one-hot matmul computes it (`decode.py:119-123`): the selected entry
    plus 0 x every other entry of its column, so an entry is NaN wherever
    another entry of its image's column is not finite (0 x inf = NaN), and
    is itself otherwise."""
    vals = table.gather(1, index[..., None].expand(-1, -1, table.shape[-1]))
    bad = ~torch.isfinite(table)
    others_bad = (bad.sum(1, keepdim=True)
                  - (~torch.isfinite(vals)).to(torch.long)) > 0
    return torch.where(others_bad, torch.full_like(vals, float("nan")), vals)


def decode_maps(conf: torch.Tensor, paf_map: torch.Tensor,
                cfg: PostprocConfig) -> HumanBatch:
    """Batched decode: (B, H, W, 19) + (B, H, W, 38) -> HumanBatch of
    COCO's 18 parts, (B, H, W, 26) + (B, H, W, 52) -> one of BODY_25's 25
    (the skeleton of the maps' channel counts, `skeletons.for_maps`; each
    stage finds it again from its own tensors' shapes).

    Maps are upcast to float32 first (bfloat16 model outputs would change
    the peak ordering). With `cfg.fragment_merge_rel > 0` (the `quality()`
    preset) the fragment-merge pass runs before the validity filter.

    Traced in three spans that time the card's work (`utils.tracer`):
    `postproc.smooth` (the upcast, upsample and smoothing),
    `postproc.peaks` (NMS, top-K and refinement) and `postproc.group`
    (everything after)."""
    skeletons.for_maps(conf.shape[-1], paf_map.shape[-1])   # or raise
    with scope("postproc.smooth", device=conf.device):
        conf = conf.float()
        paf_map = paf_map.float()
        smoothed = nms.upsample_smooth(conf, cfg.upsample_factor,
                                       cfg.smooth_sigma)
    with scope("postproc.peaks", device=conf.device):
        peaks = nms.find_peaks(smoothed, cfg.peak_threshold, cfg.max_peaks)
    with scope("postproc.group", device=conf.device):
        return _group(paf_map, smoothed.shape[1:3], peaks, cfg)


def _group(paf_map: torch.Tensor, grid: tuple[int, int], peaks: nms.PeakSet,
           cfg: PostprocConfig) -> HumanBatch:
    """The decode after its peaks: PAF candidate scores, greedy
    assignment, subset merge, the peak lookup on the (h, w) grid of the
    smoothed maps, the optional fragment merge, the validity filter and
    the compaction."""
    b = paf_map.shape[0]
    k = cfg.max_peaks
    cand = paf.score_candidates(
        paf_map, peaks, cfg.paf_n_samples, cfg.paf_sample_threshold,
        cfg.paf_inlier_ratio, lowres_factor=cfg.upsample_factor)
    conns = paf.greedy_assign(cand, k)
    subsets = group.assemble(conns, peaks.score, k, cfg.max_humans)

    h, w = grid
    rx = ((peaks.refined_x + 0.5) / w).reshape(b, -1)       # (B, P*K)
    ry = ((peaks.refined_y + 0.5) / h).reshape(b, -1)
    table = torch.stack([rx, ry, peaks.score.reshape(b, -1)], dim=-1)

    gids = subsets.parts                                      # (B, M, P)
    m, n_parts = gids.shape[1], gids.shape[2]
    part_valid = gids >= 0
    safe = torch.where(part_valid, gids, torch.zeros_like(gids)).long()
    vals = _lookup(table, safe.reshape(b, -1)).reshape(b, m, n_parts, 3)
    coords = torch.where(part_valid[..., None], vals[..., :2],
                         torch.zeros_like(vals[..., :2]))
    part_scores = torch.where(part_valid, vals[..., 2],
                              torch.zeros_like(vals[..., 2]))

    count = subsets.count
    mean_score = torch.where(count > 0,
                             subsets.score / count.clamp_min(1),
                             torch.zeros_like(subsets.score))
    if cfg.fragment_merge_rel > 0:
        # before the min-parts filter, so sub-threshold fragments can
        # combine into a valid person
        coords, part_scores, part_valid, mean_score, count = \
            merge_fragments(coords, part_scores, part_valid, mean_score,
                            count, w=w, h=h,
                            rel_threshold=cfg.fragment_merge_rel,
                            rounds=cfg.fragment_merge_rounds)
    valid = ((count >= cfg.min_parts_per_human)
             & (mean_score > cfg.min_human_score))

    # Compact: valid humans first, by descending mean score; ties keep row
    # order (a STABLE sort, as jnp.argsort).
    order = _score_order(valid, mean_score)
    valid_o = _take(valid, order)
    return HumanBatch(
        coords=_take(coords, order), part_scores=_take(part_scores, order),
        part_valid=_take(part_valid, order) & valid_o[..., None],
        score=_take(mean_score, order),
        n_parts=_take(count, order).to(torch.int32), valid=valid_o)


def build_decoder(cfg: PostprocConfig):
    """Standalone decoder fn(conf, paf) -> HumanBatch bound to `cfg`
    (`openpose_plus_tpu.postproc.build_decoder`; eager, nothing to
    compile)."""
    return functools.partial(decode_maps, cfg=cfg)


def _score_order(valid: torch.Tensor, score: torch.Tensor) -> torch.Tensor:
    """(B, M) row order: valid rows first, by descending score; ties keep
    row order (a STABLE sort, as jnp.argsort)."""
    key = -torch.where(valid, score, torch.full_like(score, -torch.inf))
    return torch.argsort(key, dim=1, stable=True)


def _take(x: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """x (B, M, ...) with its rows in `order` (B, M)."""
    idx = order.reshape(*order.shape, *([1] * (x.dim() - 2)))
    return x.gather(1, idx.expand_as(x))


# ----------------------------------------------------- fragment merge ---

def merge_fragments(coords: torch.Tensor, part_scores: torch.Tensor,
                    part_valid: torch.Tensor, score: torch.Tensor,
                    count: torch.Tensor, *, w: int, h: int,
                    rel_threshold: float, rounds: int
                    ) -> tuple[torch.Tensor, ...]:
    """Greedy fragment merge over each image's assembled skeletons
    (`openpose_plus_tpu/postproc/decode.py :: _merge_fragments_single`,
    the batch written out).

    Bottom-up assembly fragments truncated or occluded people into
    disjoint-part skeletons. Up to `rounds` times per image, merge the
    closest pair of live skeletons whose part sets are disjoint and whose
    minimum part-to-part distance is <= rel_threshold x the larger one's
    bbox diagonal (pixels of the (w, h) grid): j into i, i < j, ties to the
    lowest flat (i, j) index. Each round is masked tensor updates: no host
    sync, an image with nothing eligible is left as it is.

    coords (B, M, 18, 2) normalized, part_scores / part_valid (B, M, 18),
    score (B, M) mean score, count (B, M) int -> the same five, merged."""
    b, m = coords.shape[:2]
    dev = coords.device
    wh = _grid_size(w, h, dev)
    px, psc, pvd, sc, cnt = coords * wh, part_scores, part_valid, score, count
    rows = torch.arange(m, device=dev)
    upper = rows[:, None] < rows[None, :]                     # i < j
    bi = torch.arange(b, device=dev)
    for _ in range(rounds):
        # min part distance over valid part pairs (sqrt is monotonic, so
        # the min of the squares, rooted, is the min of the distances)
        diff = px[:, :, None, :, None] - px[:, None, :, None, :]
        d2 = (diff * diff).sum(-1)                         # (B, M, M, 18, 18)
        pair_ok = pvd[:, :, None, :, None] & pvd[:, None, :, None, :]
        mind = torch.sqrt(torch.where(pair_ok, d2, torch.inf).amin(
            dim=(3, 4)))
        big = torch.where(pvd[..., None], px, -torch.inf)
        small = torch.where(pvd[..., None], px, torch.inf)
        ext = big.amax(dim=2) - small.amin(dim=2)            # (B, M, 2)
        ext = torch.where(cnt[..., None] > 0, ext, torch.zeros_like(ext))
        diag = torch.sqrt((ext * ext).sum(-1).clamp_min(1e-6))
        rel = mind / torch.maximum(diag[:, :, None],
                                   diag[:, None, :]).clamp_min(1e-3)
        shared = (pvd[:, :, None] & pvd[:, None]).any(-1)     # (B, M, M)
        live = cnt > 0
        elig = (upper & ~shared & live[:, :, None] & live[:, None, :]
                & (rel <= rel_threshold))
        rel = torch.where(elig, rel, torch.inf).reshape(b, m * m)
        flat = rel.argmin(dim=1)              # first index on ties
        do = torch.isfinite(rel[bi, flat])                    # (B,)
        i, j = flat // m, flat % m
        oi = (rows == i[:, None]) & do[:, None]               # (B, M)
        oj = (rows == j[:, None]) & do[:, None]
        # merge j into i: take j's parts, then empty j
        upd = oi[:, :, None] & pvd[bi, j][:, None, :]        # (B, M, 18)
        px = torch.where(upd[..., None], px[bi, j][:, None], px)
        psc = torch.where(upd, psc[bi, j][:, None], psc)
        pvd = pvd | upd
        cnt_i, cnt_j = cnt[bi, i], cnt[bi, j]
        tot = cnt_i + cnt_j
        sc_i = (sc[bi, i] * cnt_i + sc[bi, j] * cnt_j) / tot.clamp_min(1)
        sc = torch.where(oi, sc_i[:, None], sc)
        cnt = torch.where(oi, tot[:, None],
                          torch.where(oj, torch.zeros_like(cnt), cnt))
        pvd = pvd & ~oj[..., None]
    coords = torch.where(pvd[..., None], px / wh, torch.zeros_like(px))
    part_scores = torch.where(pvd, psc, torch.zeros_like(psc))
    return coords, part_scores, pvd, sc, cnt


@device_cache
def _grid_size(w: int, h: int, device: torch.device) -> torch.Tensor:
    """float32 (w, h) on `device`, cached: a tensor, so the division by it
    is a true division on every device (a Python scalar divisor may become
    a reciprocal multiply)."""
    return torch.tensor([w, h], dtype=torch.float32, device=device)


# --------------------------------------------------------------- dedup ---

def _oks_sigmas_18() -> np.ndarray:
    """Per-part OKS falloff in OPENPOSE-18 order: the COCO-17 sigmas routed
    through skeleton.COCO_FROM_OPENPOSE; the neck, absent from COCO, gets
    the shoulder-class sigma (`decode.py :: _oks_sigmas_18`)."""
    sig = np.full(18, 0.079, np.float32)          # neck default
    for c17, part in enumerate(skeleton.COCO_FROM_OPENPOSE):
        sig[part] = skeleton.COCO_OKS_SIGMAS[c17]
    return sig


@device_cache
def _oks_var(device: torch.device) -> torch.Tensor:
    """(2 sigma)^2 per part on `device`, cached."""
    sig = torch.as_tensor(_oks_sigmas_18(), device=device)
    return (2.0 * sig) ** 2


def merge_dedup(batches: list[HumanBatch], oks_threshold: float = 0.5
                ) -> HumanBatch:
    """Merge HumanBatches (e.g. one per scale) by greedy OKS-NMS
    (`openpose_plus_tpu/postproc/decode.py :: merge_dedup`, the batch
    written out).

    The rows of all batches are concatenated (N = the sum of their M) and
    re-sorted by descending score, valid first (stable). A row is
    suppressed when a higher-ranked kept row overlaps it with skeleton-OKS
    > oks_threshold; OKS uses the keeper's valid-part bbox area as the
    scale and averages over the parts both rows carry (rows sharing no
    part never suppress each other). The suppression runs over the N rows
    as masked updates, with no host sync. Output: (B, N, ...) rows, kept
    rows first by descending score."""
    cat = HumanBatch(**{f.name: torch.cat([getattr(x, f.name)
                                           for x in batches], dim=1)
                        for f in dataclasses.fields(HumanBatch)})
    pre = _score_order(cat.valid, cat.score)
    coords, part_scores, part_valid, score, n_parts, valid = (
        _take(getattr(cat, f.name), pre)
        for f in dataclasses.fields(HumanBatch))
    if coords.shape[2] != skeletons.COCO18.n_parts:
        raise ValueError(f"merge_dedup holds COCO's 18 OKS sigmas, not "
                         f"{coords.shape[2]} parts")
    n = coords.shape[1]
    var = _oks_var(coords.device)                             # (18,)

    diff = coords[:, :, None] - coords[:, None]               # (B,N,N,18,2)
    d2 = (diff * diff).sum(-1)                                # (B,N,N,18)
    big = torch.where(part_valid[..., None], coords, -torch.inf)
    small = torch.where(part_valid[..., None], coords, torch.inf)
    ext = big.amax(dim=2) - small.amin(dim=2)                 # (B, N, 2)
    area = torch.where(n_parts > 0, ext[..., 0] * ext[..., 1],
                       torch.zeros_like(ext[..., 0])).clamp_min(1e-4)
    both = part_valid[:, :, None] & part_valid[:, None]       # (B,N,N,18)
    e = d2 / (2.0 * area[:, :, None, None] * var + 1e-12)
    oks = ((torch.exp(-e) * both).sum(-1)
           / both.sum(-1).clamp_min(1))                       # (B, N, N)

    later = torch.arange(n, device=coords.device)
    supp = torch.zeros_like(valid)
    for i in range(n):
        keep_i = valid[:, i] & ~supp[:, i]                    # (B,)
        row = (oks[:, i] > oks_threshold) & (later > i)
        supp = supp | (row & keep_i[:, None])
    keep = valid & ~supp
    order = _score_order(keep, score)
    keep_o = _take(keep, order)
    return HumanBatch(
        coords=_take(coords, order), part_scores=_take(part_scores, order),
        part_valid=_take(part_valid, order) & keep_o[..., None],
        score=_take(torch.where(keep, score, torch.zeros_like(score)), order),
        n_parts=_take(torch.where(keep, n_parts, torch.zeros_like(n_parts)),
                      order),
        valid=keep_o)
