"""COCO keypoint evaluation: OKS matching + AP, on the port.

Copy of `openpose_plus_tpu/eval_coco.py` (which imports the JAX package's
post-processing and JAX itself): the keypoint-OKS AP protocol of COCOeval,
implemented directly (no pycocotools):

  * OKS(det, gt) = mean over labeled gt keypoints of
      exp(-d_i^2 / (2 * area * (2*sigma_i)^2))
  * per image, detections (sorted by score) greedily match the unmatched
    GT with the highest OKS (COCOeval's keypoint matching)
  * AP = mean over OKS thresholds 0.50:0.05:0.95 of the 101-point
    interpolated precision-recall integral; maxDets=20
  * AP50 / AP75 / AR and the medium / large area ranges also reported

`evaluate_engine` runs a port `Engine` over a dataset, on one process or,
with `distributed=True`, each rank of the process group over its slice,
the detections and ground truth gathered over gloo on the host
(`_allgather_padded`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from openpose_plus_tpu_torch import skeleton
from openpose_plus_tpu_torch.postproc import HumanBatch

OKS_THRESHOLDS = np.arange(0.5, 1.0, 0.05)
RECALL_GRID = np.linspace(0, 1, 101)
MAX_DETS = 20


@dataclasses.dataclass
class Detection:
    image_id: int
    keypoints: np.ndarray   # (17, 3) x, y, confidence in ORIGINAL pixels
    score: float


def host_row(field, batch_index: int) -> np.ndarray:
    """One image's row of a HumanBatch field, as a host array."""
    if isinstance(field, torch.Tensor):
        return field[batch_index].cpu().numpy()
    return np.asarray(field[batch_index])


def host_humans(humans: HumanBatch) -> HumanBatch:
    """The HumanBatch with every field copied to the host once (numpy):
    per-row reads then need no device sync."""
    return HumanBatch(**{f.name: getattr(humans, f.name).cpu().numpy()
                         for f in dataclasses.fields(humans)})


def humans_to_detections(humans: HumanBatch, batch_index: int, image_id: int,
                         scale: float, pad: tuple[float, float],
                         hin: int, win: int) -> list[Detection]:
    """HumanBatch row -> COCO-17 detections in original image coordinates.

    Normalized net-space coords are unpadded/unscaled with the letterbox
    transform (data/augment.py :: letterbox). `humans` may hold tensors on
    any device or host arrays (`host_humans`: one copy per batch).
    """
    out = []
    valid = host_row(humans.valid, batch_index)
    coords = host_row(humans.coords, batch_index)
    pvalid = host_row(humans.part_valid, batch_index)
    pscore = host_row(humans.part_scores, batch_index)
    hscore = host_row(humans.score, batch_index)
    for m in np.nonzero(valid)[0]:
        kp = np.zeros((17, 3), np.float32)
        for c, part in enumerate(skeleton.COCO_FROM_OPENPOSE):
            if not pvalid[m, part]:
                continue
            x = (coords[m, part, 0] * win - pad[0]) / scale
            y = (coords[m, part, 1] * hin - pad[1]) / scale
            kp[c] = (x, y, pscore[m, part])
        out.append(Detection(image_id=image_id, keypoints=kp,
                             score=float(hscore[m])))
    return out


def compute_oks(det: np.ndarray, gt: np.ndarray, area: float) -> float:
    """OKS between one detection and one GT annotation ((17, 3) each)."""
    labeled = gt[:, 2] > 0
    if not labeled.any():
        return 0.0
    k = 2.0 * skeleton.COCO_OKS_SIGMAS
    d2 = (det[:, 0] - gt[:, 0]) ** 2 + (det[:, 1] - gt[:, 1]) ** 2
    s2 = max(float(area), 1.0)
    e = d2 / (2.0 * s2 * k * k)
    return float(np.mean(np.exp(-e[labeled])))


@dataclasses.dataclass
class EvalResult:
    ap: float
    ap50: float
    ap75: float
    ar: float
    n_images: int
    n_dets: int
    ap_medium: float = -1.0   # COCOeval area range [32^2, 96^2)
    ap_large: float = -1.0    # [96^2, inf)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


AREA_MEDIUM = (32.0 ** 2, 96.0 ** 2)
AREA_LARGE = (96.0 ** 2, float("inf"))


def compute_oks_box(det: np.ndarray, box: np.ndarray) -> float:
    """Bbox-fallback OKS against an unlabeled/crowd annotation (COCOeval
    computeOks' k1==0 branch): per-keypoint distance to the box expanded
    by one box-extent on each side, zero inside it."""
    bx, by, bw, bh = [float(v) for v in box[:4]]
    if bw <= 0 or bh <= 0:
        return 0.0
    z = np.float32(0.0)
    dx = np.maximum(z, (bx - bw) - det[:, 0]) + \
        np.maximum(z, det[:, 0] - (bx + 2 * bw))
    dy = np.maximum(z, (by - bh) - det[:, 1]) + \
        np.maximum(z, det[:, 1] - (by + 2 * bh))
    k = 2.0 * skeleton.COCO_OKS_SIGMAS
    s2 = max(bw * bh, 1.0)
    e = (dx ** 2 + dy ** 2) / (2.0 * s2 * k * k)
    return float(np.mean(np.exp(-e)))


def _gt_entry(value):
    """gt_by_image value: (kps, areas) or (kps, areas, ignore_boxes)."""
    if len(value) == 2:
        return value[0], value[1], np.zeros((0, 4), np.float32)
    return value


def evaluate_detections_full(detections, gt_by_image) -> EvalResult:
    """All-areas AP plus the COCOeval medium/large area breakdowns.

    The O(dets x gts) OKS matrices are computed ONCE per image and shared
    by the three area passes (only the target/ignore split differs)."""
    cache = _build_match_cache(detections, gt_by_image)
    res = evaluate_detections(detections, gt_by_image, _cache=cache)
    res.ap_medium = evaluate_detections(
        detections, gt_by_image, AREA_MEDIUM, _cache=cache).ap
    res.ap_large = evaluate_detections(
        detections, gt_by_image, AREA_LARGE, _cache=cache).ap
    return res


def _build_match_cache(detections, gt_by_image) -> dict:
    """Per image: score-sorted top-MAX_DETS detections, the dense OKS
    matrix against every labeled GT, and the bbox-fallback OKS against
    every crowd/unlabeled ignore region."""
    by_img: dict[int, list[Detection]] = {}
    for d in detections:
        by_img.setdefault(d.image_id, []).append(d)
    cache = {}
    for img_id, value in gt_by_image.items():
        gts, areas, ign_boxes = _gt_entry(value)
        labeled = [(g, a) for g, a in zip(gts, areas) if (g[:, 2] > 0).any()]
        dets = sorted(by_img.get(img_id, []),
                      key=lambda d: -d.score)[:MAX_DETS]
        oks = np.array([[compute_oks(d.keypoints, g, a) for g, a in labeled]
                        for d in dets]) if dets and labeled else \
            np.zeros((len(dets), len(labeled)))
        oks_box = np.array([[compute_oks_box(d.keypoints, b)
                             for b in ign_boxes]
                            for d in dets]) if dets and len(ign_boxes) else \
            np.zeros((len(dets), len(ign_boxes)))
        cache[img_id] = (dets, labeled, oks, oks_box)
    return cache


def evaluate_detections(
    detections: Sequence[Detection],
    gt_by_image: dict[int, tuple],
    area_range: tuple[float, float] = (0.0, float("inf")),
    _cache: Optional[dict] = None,
) -> EvalResult:
    """AP over {image_id: (gt_keypoints (G,17,3), areas (G,)[, ignore
    boxes (Q,4)])}.

    area_range restricts to GTs within [lo, hi) (COCOeval area ranges:
    medium = [32^2, 96^2), large = [96^2, inf)). IGNORED GTs — labeled
    GTs outside the range, plus crowd/unlabeled annotations' boxes
    (COCOeval gtIg) — absorb detections rather than scoring them as
    false positives. With zero in-range GTs, returns the COCOeval -1.0
    sentinel (not-applicable), never a fake 0 AP.
    """
    # Per image: sort dets by score, greedy-match to best unmatched GT.
    lo, hi = area_range
    # (det score, per-thr TP bits, per-thr counted bits)
    matches: list[tuple[float, np.ndarray, np.ndarray]] = []
    n_gt = 0
    cache = _cache if _cache is not None else _build_match_cache(
        detections, gt_by_image)

    n_thr = len(OKS_THRESHOLDS)
    for img_id in gt_by_image:
        dets, labeled, oks_all, oks_box = cache[img_id]
        in_range = np.array([lo <= a < hi for _, a in labeled], bool) \
            if labeled else np.zeros((0,), bool)
        n_gt += int(in_range.sum())
        if not dets:
            continue
        hits = np.zeros((len(dets), n_thr), bool)
        counted = np.ones((len(dets), n_thr), bool)
        for ti, thr in enumerate(OKS_THRESHOLDS):
            used = np.zeros(len(labeled), bool)
            for i in range(len(dets)):
                free = ~used & in_range & (oks_all[i] >= thr)
                if free.any():
                    j = int(np.argmax(np.where(free, oks_all[i], -1.0)))
                    used[j] = True
                    hits[i, ti] = True
                    continue
                # out-of-range labeled GTs and crowd/unlabeled boxes both
                # ignore-absorb the detection (dropped from the PR curve)
                if ((~in_range & (oks_all[i] >= thr)).any()
                        or (oks_box[i] >= thr).any()):
                    counted[i, ti] = False
        for i, d in enumerate(dets):
            matches.append((d.score, hits[i], counted[i]))

    if n_gt == 0:
        return EvalResult(-1.0, -1.0, -1.0, -1.0, len(gt_by_image),
                          len(detections))

    if not matches:
        return EvalResult(0.0, 0.0, 0.0, 0.0, len(gt_by_image), 0)

    order = np.argsort([-s for s, _, _ in matches], kind="stable")
    tp = np.stack([matches[i][1] for i in order])       # (D, T)
    cnt = np.stack([matches[i][2] for i in order])      # (D, T)
    aps, ars = [], []
    for ti in range(len(OKS_THRESHOLDS)):
        cum_tp = np.cumsum(tp[:, ti] & cnt[:, ti])
        cum_fp = np.cumsum(~tp[:, ti] & cnt[:, ti])
        recall = cum_tp / n_gt
        precision = cum_tp / np.maximum(cum_tp + cum_fp, 1)
        # monotone precision envelope + 101-point interpolation (COCOeval)
        for i in range(len(precision) - 1, 0, -1):
            precision[i - 1] = max(precision[i - 1], precision[i])
        idx = np.searchsorted(recall, RECALL_GRID, side="left")
        p = np.where(idx < len(precision), precision[np.minimum(
            idx, len(precision) - 1)], 0.0)
        aps.append(p.mean())
        ars.append(recall[-1] if len(recall) else 0.0)
    aps = np.asarray(aps)
    return EvalResult(
        ap=float(aps.mean()),
        ap50=float(aps[0]),
        ap75=float(aps[5]),
        ar=float(np.mean(ars)),
        n_images=len(gt_by_image),
        n_dets=len(detections),
    )


def evaluate_engine(engine, dataset, batch_size: int = 8,
                    limit: Optional[int] = None,
                    distributed: bool = False,
                    flip_tta: bool = False,
                    scales: Optional[tuple] = None,
                    ms_combine: str = "avg") -> EvalResult:
    """Run the engine over a CocoPoseDataset slice and compute AP
    (`openpose_plus_tpu.eval_coco.evaluate_engine`, its loader path).

    The images stream through `loader.StreamLoader` (the reference's
    native loader: a pool of threads decodes, a large JPEG DCT-scaled,
    letterboxes and packs each image in the model's space-to-depth input
    layout). GT is registered for every sample of the slice first, so an
    image the loader cannot decode is skipped and its people count against
    AP.

    With distributed=True each rank evaluates its `process_local_slice`
    (all of it without a process group) and the detections and ground
    truth of every rank are gathered before the AP, so every rank returns
    the AP of the whole slice. flip_tta averages horizontally-flipped
    predictions; scales enables the multi-scale search (e.g. (0.5, 1.0,
    1.5)) with `ms_combine` "avg" or "dedup" (see Engine.infer_multiscale).
    """
    from openpose_plus_tpu_torch.loader import StreamLoader
    from openpose_plus_tpu_torch.parallel.sharding import (
        host_group, process_local_slice, rank_and_world)

    n = len(dataset) if limit is None else min(limit, len(dataset))
    lo, hi = process_local_slice(n) if distributed else (0, n)
    m = engine.config.model
    dets: list[Detection] = []
    gt_by_image: dict[int, tuple] = {}
    batch_imgs, batch_meta = [], []

    def flush():
        nonlocal batch_imgs, batch_meta
        if not batch_imgs:
            return
        real = len(batch_imgs)
        while len(batch_imgs) < batch_size:   # pad the last batch
            batch_imgs.append(np.zeros_like(batch_imgs[0]))
            batch_meta.append(None)
        stack = np.stack(batch_imgs)
        if scales:
            humans = engine.infer_multiscale(stack, scales=tuple(scales),
                                             flip_tta=flip_tta,
                                             combine=ms_combine)
        else:
            humans = engine.infer(stack, flip_tta=flip_tta)
        humans = host_humans(humans)           # the copy synchronises
        for b in range(real):
            img_id, scale, pad = batch_meta[b]
            dets.extend(humans_to_detections(
                humans, b, img_id, scale, pad, m.hin, m.win))
        batch_imgs, batch_meta = [], []

    samples = [dataset[i] for i in range(lo, hi)]
    for s in samples:
        gt_by_image[s.image_id] = (
            s.keypoints_coco, s.areas,
            getattr(s, "ignore_boxes", np.zeros((0, 4), np.float32)))
    loader = StreamLoader([s.image_path for s in samples], m.hin, m.win,
                          batch=batch_size, s2d=m.preferred_input_layout())
    try:
        for nb in loader:
            for b in range(nb["images"].shape[0]):
                s = samples[int(nb["indices"][b])]
                batch_imgs.append(nb["images"][b])
                batch_meta.append((s.image_id, float(nb["scales"][b]),
                                   (float(nb["pads"][b, 0]),
                                    float(nb["pads"][b, 1]))))
                if len(batch_imgs) == batch_size:
                    flush()
        flush()
    finally:
        loader.close()
    if distributed and rank_and_world()[1] > 1:
        # every rank must see every detection AND every GT
        with host_group() as group:
            dets = _unpack_detections(_allgather_padded(
                _pack_detections(dets), group))
            gt_by_image = _unpack_gt(_allgather_padded(
                _pack_gt(gt_by_image), group))
    return evaluate_detections_full(dets, gt_by_image)


# ---------------------------------------------------- multihost packing ---

def _allgather_padded(arr: np.ndarray, group=None) -> np.ndarray:
    """All-gather of (N, W) float32 host payloads whose N and W vary per
    rank, over a gloo `group` (the default group if None). The gather needs
    IDENTICAL shapes on every rank, so the global (max N, max W) is agreed
    first via a fixed-shape gather of the dims, payloads are padded with
    -1-id sentinel rows / zero columns, and the result flattens to
    (world * max N, max W)."""
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return arr
    world = dist.get_world_size(group)
    dims = torch.tensor(arr.shape, dtype=torch.int64)
    all_dims = [torch.empty_like(dims) for _ in range(world)]
    dist.all_gather(all_dims, dims, group=group)            # fixed shape
    m = int(max(d[0] for d in all_dims))
    w = int(max(d[1] for d in all_dims))
    padded = np.full((m, w), 0.0, np.float32)
    padded[:, 0] = -1.0                              # sentinel image ids
    padded[: arr.shape[0], : arr.shape[1]] = arr
    mine = torch.from_numpy(padded)
    gathered = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(gathered, mine, group=group)
    return torch.stack(gathered).numpy().reshape(-1, w)


def _pack_detections(dets: list[Detection]) -> np.ndarray:
    """Fixed-width float rows [image_id, score, 51x kp] for allgather."""
    out = np.zeros((len(dets), 53), np.float32)
    for i, d in enumerate(dets):
        out[i, 0] = d.image_id
        out[i, 1] = d.score
        out[i, 2:] = d.keypoints.reshape(-1)
    return out


def _unpack_detections(arr: np.ndarray) -> list[Detection]:
    arr = np.asarray(arr).reshape(-1, 53) if arr.size else \
        np.zeros((0, 53), np.float32)
    out = []
    for row in arr:
        if row[0] < 0:
            continue
        out.append(Detection(image_id=int(row[0]), score=float(row[1]),
                             keypoints=row[2:].reshape(17, 3).copy()))
    return out


def _pack_gt(gt: dict[int, tuple]) -> np.ndarray:
    """Variable-width rows [img_id, G, Q, G*(area+51), Q*4]; every rank's
    rows are padded to the widest by _allgather_padded, and the per-row
    G/Q counts make the unpack exact — no people cap, no dropped images,
    ignore boxes preserved."""
    rows = []
    for img_id, value in gt.items():
        kps, areas, ign = _gt_entry(value)
        g, q = len(kps), len(ign)
        row = np.zeros((3 + g * 52 + q * 4,), np.float32)
        row[0], row[1], row[2] = img_id, g, q
        for p in range(g):
            base = 3 + p * 52
            row[base] = areas[p] if p < len(areas) else 0.0
            row[base + 1: base + 52] = np.asarray(kps[p]).reshape(-1)
        for b in range(q):
            base = 3 + g * 52 + b * 4
            row[base: base + 4] = np.asarray(ign[b]).reshape(-1)[:4]
        rows.append(row)
    if not rows:
        return np.zeros((0, 3), np.float32)
    w = max(len(r) for r in rows)
    out = np.zeros((len(rows), w), np.float32)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out


def _unpack_gt(arr: np.ndarray) -> dict[int, tuple]:
    out: dict[int, tuple] = {}
    for row in np.asarray(arr):
        if row.size < 3 or row[0] < 0:
            continue
        g, q = int(row[1]), int(row[2])
        kps = row[3: 3 + g * 52].reshape(g, 52)
        ign = row[3 + g * 52: 3 + g * 52 + q * 4].reshape(q, 4).copy() \
            if q else np.zeros((0, 4), np.float32)
        out[int(row[0])] = (
            kps[:, 1:].reshape(g, 17, 3).copy(),
            kps[:, 0].copy(),
            ign,
        )
    return out
