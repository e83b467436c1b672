"""Numpy re-implementation of the reference PAF grouping algorithm (port of
`openpose_plus_tpu/postproc/oracle.py`, on the port's own `skeleton` and
`postproc/common.py`; numpy only, no torch).

This is the *test oracle*: a faithful, dynamic-shape, sequential
implementation of the bottom-up grouping used by the reference
(Cao et al. CVPR'17, the CMU/tf-pose grouping):

  1. smooth heatmaps, 3x3 local-max NMS, threshold -> per-part peak lists
  2. per limb: score every peak pair by a line integral over the PAF
     (nearest-neighbor sampling, >=80% inlier samples, height prior)
  3. greedy highest-score-first assignment per limb
  4. sequential subset merge of accepted connections into humans
  5. drop humans with too few parts / low mean score

The port's batched decoder (`postproc/decode.py`) matches it exactly (same
peak ordering, same greedy order, same merge semantics) up to its static
capacity caps; tests/test_torch_oracle.py holds it to that on the CPU, and
chip_smoke.py on the card.

Deliberate, documented deviations from the original CMU code (mirrored on
both sides so parity holds):
  * CMU's quirk of overwriting an already-occupied part slot while still
    incrementing the part count IS reproduced.
  * Subset storage is a fixed table of `max_humans` slots: a merged-away row
    is cleared in place and new subsets go to the first empty slot, whereas
    CMU np.delete's the row and appends new ones at the end. This can change
    which of two matching rows is "first" in rare double-match cases (only
    observable through the overlap-attach tie-break); AP impact negligible.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from openpose_plus_tpu_torch import skeleton
from openpose_plus_tpu_torch.postproc import common


@dataclasses.dataclass
class OraclePeaks:
    """Per-part peak lists, ordered by descending score (ties: flat index)."""

    ys: list[np.ndarray]      # [n_parts] arrays of int row coords
    xs: list[np.ndarray]
    scores: list[np.ndarray]


@dataclasses.dataclass
class OracleHuman:
    # part index -> (x, y, score) in map pixel coords (unrefined ints for
    # topology; refined float coords filled by decode_oracle).
    parts: dict[int, tuple[float, float, float]]
    score: float              # sum score (peaks + connections)
    n_parts: int


def smooth_maps(maps: np.ndarray, sigma: float) -> np.ndarray:
    """Separable Gaussian blur with zero padding, (H, W, C) float32."""
    k = common.gaussian_kernel_1d(sigma)
    if k.size == 1:
        return maps.astype(np.float32)
    r = k.size // 2
    out = maps.astype(np.float32)
    # rows
    pad = np.pad(out, ((r, r), (0, 0), (0, 0)))
    out = sum(k[i] * pad[i:i + out.shape[0]] for i in range(k.size))
    # cols
    pad = np.pad(out, ((0, 0), (r, r), (0, 0)))
    out = sum(k[i] * pad[:, i:i + out.shape[1]] for i in range(k.size))
    return out.astype(np.float32)


def upsample_maps(maps: np.ndarray, factor: int) -> np.ndarray:
    """Bilinear (half-pixel-center) upsample matching jax.image.resize.

    Implemented by gathering with the same align convention XLA uses
    ('linear' resize: src = (dst + 0.5) * scale - 0.5).
    """
    if factor == 1:
        return maps.astype(np.float32)
    h, w, c = maps.shape
    oh, ow = h * factor, w * factor

    def axis_weights(n_in: int, n_out: int):
        src = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
        lo = np.floor(src).astype(np.int64)
        frac = (src - lo).astype(np.float32)
        lo0 = np.clip(lo, 0, n_in - 1)
        lo1 = np.clip(lo + 1, 0, n_in - 1)
        return lo0, lo1, frac

    y0, y1, fy = axis_weights(h, oh)
    x0, x1, fx = axis_weights(w, ow)
    rows = maps[y0] * (1 - fy)[:, None, None] + maps[y1] * fy[:, None, None]
    out = (rows[:, x0] * (1 - fx)[None, :, None]
           + rows[:, x1] * fx[None, :, None])
    return out.astype(np.float32)


def find_peaks(maps: np.ndarray, threshold: float,
               max_peaks: int | None = None) -> OraclePeaks:
    """3x3 local-max NMS per part channel on (already smoothed) maps.

    A pixel is a peak iff it is >= all 8 neighbors (-inf-padded border),
    strictly above `threshold`, and has the lowest flat index among
    equal-valued candidate neighbors (one peak per exact plateau —
    mirrors nms.find_peaks' lexicographic tie-break). Ordered by
    descending score, ties broken by ascending flat index — identical to
    the decoder's top-k ordering.
    """
    h, w, _ = maps.shape
    ys, xs, scores = [], [], []
    for part in range(skeleton.N_PARTS):
        m = maps[:, :, part]
        padded = np.pad(m, 1, constant_values=-np.inf)
        is_max = np.ones((h, w), dtype=bool)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy == 0 and dx == 0:
                    continue
                is_max &= m >= padded[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
        is_max &= m > threshold
        # plateau tie-break: lowest flat index among candidate neighbors
        idx = np.arange(h * w, dtype=np.float32).reshape(h, w)
        u = np.where(is_max, -idx, -np.inf)
        up = np.pad(u, 1, constant_values=-np.inf)
        umax = np.full((h, w), -np.inf, dtype=np.float32)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                umax = np.maximum(
                    umax, up[1 + dy:1 + dy + h, 1 + dx:1 + dx + w])
        is_max &= u >= umax
        py, px = np.nonzero(is_max)
        s = m[py, px]
        flat = py * w + px
        order = np.lexsort((flat, -s))
        if max_peaks is not None:
            order = order[:max_peaks]
        ys.append(py[order])
        xs.append(px[order])
        scores.append(s[order].astype(np.float32))
    return OraclePeaks(ys, xs, scores)


def score_limb_candidates(
    paf: np.ndarray,
    peaks: OraclePeaks,
    limb: int,
    n_samples: int,
    sample_threshold: float,
    inlier_ratio: float,
) -> list[tuple[int, int, float]]:
    """All valid (slot_a, slot_b, score) candidates for one limb.

    Line integral with nearest-neighbor PAF sampling; candidate is valid iff
    >= ceil(inlier_ratio * n_samples) samples exceed sample_threshold AND
    the prior-adjusted score is positive (reference criterion).
    """
    h = paf.shape[0]
    ia, ib = skeleton.COCO_PAIRS[limb]
    cx, cy = skeleton.COCO_PAIRS_NETWORK[limb]
    fracs = common.line_sample_fracs(n_samples)
    out = []
    f32 = np.float32
    for sa in range(len(peaks.scores[ia])):
        ax, ay = f32(peaks.xs[ia][sa]), f32(peaks.ys[ia][sa])
        for sb in range(len(peaks.scores[ib])):
            bx, by = f32(peaks.xs[ib][sb]), f32(peaks.ys[ib][sb])
            # All arithmetic in float32 to stay bit-identical with the
            # decoder (rounding of sample coords near .5 is sensitive).
            dx, dy = bx - ax, by - ay
            dist = np.maximum(np.sqrt(dx * dx + dy * dy, dtype=f32), f32(1e-4))
            ux, uy = dx / dist, dy / dist
            sx = np.round(ax + fracs * dx).astype(np.int64)
            sy = np.round(ay + fracs * dy).astype(np.int64)
            dots = (paf[sy, sx, cx] * ux + paf[sy, sx, cy] * uy).astype(f32)
            n_inliers = int(np.sum(dots > f32(sample_threshold)))
            score = float(common.limb_score_with_prior(
                np.mean(dots, dtype=f32), dist, h))
            if n_inliers >= int(np.ceil(inlier_ratio * n_samples)) and score > 0:
                out.append((sa, sb, score))
    return out


def greedy_assign(candidates: list[tuple[int, int, float]],
                  n_a: int, n_b: int) -> list[tuple[int, int, float]]:
    """Greedy best-score-first assignment; each peak used at most once.

    Candidates scanned in descending score order (ties: by (slot_a, slot_b)
    enumeration order — matching the decoder's greedy tie-break on row-major
    candidate index).
    """
    idx = np.array([sa * max(n_b, 1) + sb for sa, sb, _ in candidates])
    sc = np.array([s for _, _, s in candidates])
    accepted: list[tuple[int, int, float]] = []
    used_a: set[int] = set()
    used_b: set[int] = set()
    for i in np.lexsort((idx, -sc)) if len(candidates) else []:
        sa, sb, s = candidates[i]
        if sa in used_a or sb in used_b:
            continue
        used_a.add(sa)
        used_b.add(sb)
        accepted.append((sa, sb, s))
        if len(accepted) >= min(n_a, n_b):
            break
    return accepted


def assemble_humans(
    connections: list[list[tuple[int, int, float]]],
    peaks: OraclePeaks,
    max_peaks: int,
    min_parts: int,
    min_score: float,
    max_humans: int = 96,
) -> list[OracleHuman]:
    """Sequential subset merge (the CMU algorithm; fixed-slot storage).

    Global peak id gid = part * max_peaks + slot. Subset rows hold one gid
    per part (-1 = empty) plus running score and part count. Connections are
    processed limb by limb, within each limb in greedy-accept order:

      * 1 matching row:  attach endpoint B (even overwriting a different
        occupant — CMU quirk — while incrementing the count)
      * 2 matching rows: merge if part-disjoint (clear the second in place),
        else attach B to the first
      * >2 matching rows: no-op (CMU falls through)
      * 0 matching rows, limb < 17: new subset at the first empty slot
        (ear-shoulder limbs 17, 18 never create)
    """
    parts_tbl = np.full((max_humans, skeleton.N_PARTS), -1, dtype=np.int64)
    score_tbl = np.zeros(max_humans, dtype=np.float64)
    cnt_tbl = np.zeros(max_humans, dtype=np.int64)

    def peak_score(gid: int) -> float:
        part, slot = divmod(gid, max_peaks)
        return float(peaks.scores[part][slot])

    for limb, conns in enumerate(connections):
        ia, ib = skeleton.COCO_PAIRS[limb]
        for sa, sb, cscore in conns:
            a_gid = ia * max_peaks + sa
            b_gid = ib * max_peaks + sb
            found = [j for j in range(max_humans)
                     if parts_tbl[j, ia] == a_gid or parts_tbl[j, ib] == b_gid]
            if len(found) == 1:
                j = found[0]
                if parts_tbl[j, ib] != b_gid:
                    parts_tbl[j, ib] = b_gid
                    cnt_tbl[j] += 1
                    score_tbl[j] += peak_score(b_gid) + cscore
            elif len(found) == 2:
                j1, j2 = found
                overlap = np.any((parts_tbl[j1] >= 0) & (parts_tbl[j2] >= 0))
                if not overlap:
                    parts_tbl[j1] = np.where(parts_tbl[j2] >= 0,
                                             parts_tbl[j2], parts_tbl[j1])
                    cnt_tbl[j1] += cnt_tbl[j2]
                    score_tbl[j1] += score_tbl[j2] + cscore
                    parts_tbl[j2] = -1
                    cnt_tbl[j2] = 0
                    score_tbl[j2] = 0.0
                else:
                    parts_tbl[j1, ib] = b_gid
                    cnt_tbl[j1] += 1
                    score_tbl[j1] += peak_score(b_gid) + cscore
            elif len(found) == 0 and limb < 17:
                empties = np.nonzero(cnt_tbl == 0)[0]
                if len(empties):
                    j = empties[0]
                    parts_tbl[j, ia] = a_gid
                    parts_tbl[j, ib] = b_gid
                    cnt_tbl[j] = 2
                    score_tbl[j] = peak_score(a_gid) + peak_score(b_gid) + cscore
            # len(found) > 2: no-op

    humans = []
    for j in range(max_humans):
        if cnt_tbl[j] < min_parts or cnt_tbl[j] == 0:
            continue
        if score_tbl[j] / cnt_tbl[j] <= min_score:
            continue
        parts = {}
        for part in range(skeleton.N_PARTS):
            gid = int(parts_tbl[j, part])
            if gid < 0:
                continue
            p, slot = divmod(gid, max_peaks)
            parts[part] = (float(peaks.xs[p][slot]), float(peaks.ys[p][slot]),
                           float(peaks.scores[p][slot]))
        humans.append(OracleHuman(parts=parts, score=float(score_tbl[j]),
                                  n_parts=int(cnt_tbl[j])))
    return humans


def refine_coords(maps: np.ndarray, x: float, y: float, part: int
                  ) -> tuple[float, float]:
    """Quadratic subpixel refinement of an integer peak coordinate."""
    h, w, _ = maps.shape
    xi, yi = int(x), int(y)
    m = maps[:, :, part]

    def axis(v, lo, hi, get_prev, get_next):
        if v <= 0 or v >= hi - 1:
            return 0.0
        return float(common.refine_peak_1d(
            np.float32(m[yi, xi]), np.float32(get_prev()), np.float32(get_next())))

    ox = axis(xi, 0, w, lambda: m[yi, xi - 1], lambda: m[yi, xi + 1])
    oy = axis(yi, 0, h, lambda: m[yi - 1, xi], lambda: m[yi + 1, xi])
    return x + ox, y + oy


def decode_oracle(conf: np.ndarray, paf: np.ndarray, cfg,
                  preprocessed: bool = False) -> list[OracleHuman]:
    """Full reference pipeline on one image's (H, W, 19)/(H, W, 38) maps.

    `cfg` is a PostprocConfig (the port's `config.PostprocConfig`). Returns humans with subpixel-refined coords
    normalized to [0, 1] ((px + 0.5) / extent convention).

    With preprocessed=True, `conf` must already be upsampled+smoothed and
    `paf` upsampled. Peak detection compares floats for exact equality on
    plateaus, so bit-exact parity with the decoder is only achievable
    when both consume the *same* preprocessed maps; the preprocessing
    numerics themselves are compared to 1e-6 in separate tests.
    """
    if preprocessed:
        smoothed, paf_u = conf.astype(np.float32), paf.astype(np.float32)
    else:
        conf_u = upsample_maps(conf, cfg.upsample_factor)
        paf_u = upsample_maps(paf, cfg.upsample_factor)
        smoothed = smooth_maps(conf_u, cfg.smooth_sigma)
    peaks = find_peaks(smoothed, cfg.peak_threshold, cfg.max_peaks)
    connections = []
    for limb in range(skeleton.N_LIMBS):
        ia, ib = skeleton.COCO_PAIRS[limb]
        cands = score_limb_candidates(
            paf_u, peaks, limb, cfg.paf_n_samples,
            cfg.paf_sample_threshold, cfg.paf_inlier_ratio)
        connections.append(greedy_assign(
            cands, len(peaks.scores[ia]), len(peaks.scores[ib])))
    humans = assemble_humans(connections, peaks, cfg.max_peaks,
                             cfg.min_parts_per_human, cfg.min_human_score,
                             cfg.max_humans)
    h, w, _ = smoothed.shape
    for hu in humans:
        refined = {}
        for part, (x, y, s) in hu.parts.items():
            rx, ry = refine_coords(smoothed, x, y, part)
            refined[part] = ((rx + 0.5) / w, (ry + 0.5) / h, s)
        hu.parts = refined
    return humans
