"""Host-side renders (`openpose_plus_tpu/utils/vis.py`): skeletons drawn
onto a frame (`draw_humans`, the CLI's `--draw-dir` and the camera app),
and the training loop's predicted-vs-GT heatmap dumps
(`draw_maps_overlay`). `cv2` is imported inside the calls."""

from __future__ import annotations

import numpy as np

from openpose_plus_tpu_torch import skeleton


def _cv2():
    try:
        import cv2
    except ImportError:
        raise RuntimeError("cv2 unavailable") from None
    return cv2


def draw_humans(image: np.ndarray, humans, batch_index: int = 0
                ) -> np.ndarray:
    """Draw the detected skeletons of one image of a HumanBatch onto a BGR
    uint8 image (returns a copy). The coords are normalized to [0, 1] and
    scaled to the image's size here; parts and limbs take the per-part
    colours `skeleton.COCO_COLORS`."""
    from openpose_plus_tpu_torch.eval_coco import host_row

    cv2 = _cv2()
    img = image.copy()
    h, w = img.shape[:2]
    valid = host_row(humans.valid, batch_index)
    coords = host_row(humans.coords, batch_index)
    pvalid = host_row(humans.part_valid, batch_index)
    radius = max(2, int(round(min(h, w) / 120)))
    for m in range(valid.shape[0]):
        if not valid[m]:
            continue
        centers = {}
        for part in range(skeleton.N_PARTS):
            if not pvalid[m, part]:
                continue
            cx = int(round(coords[m, part, 0] * w))
            cy = int(round(coords[m, part, 1] * h))
            centers[part] = (cx, cy)
            cv2.circle(img, (cx, cy), radius, skeleton.COCO_COLORS[part], -1)
        colors = skeleton.COCO_COLORS
        for limb, (ia, ib) in enumerate(skeleton.COCO_PAIRS_RENDER):
            if ia in centers and ib in centers:
                cv2.line(img, centers[ia], centers[ib],
                         colors[limb % len(colors)], radius // 2 + 1)
    return img


def draw_maps_overlay(image: np.ndarray, conf: np.ndarray) -> np.ndarray:
    """Heatmap max-projection (parts only) blended over a BGR uint8
    image."""
    cv2 = _cv2()
    h, w = image.shape[:2]
    m = np.asarray(conf)[..., : skeleton.N_PARTS].max(-1)
    m = cv2.resize(m, (w, h), interpolation=cv2.INTER_LINEAR)
    m8 = np.clip(m * 255, 0, 255).astype(np.uint8)
    heat = cv2.applyColorMap(m8, cv2.COLORMAP_JET)
    return cv2.addWeighted(image, 0.6, heat, 0.4, 0)
