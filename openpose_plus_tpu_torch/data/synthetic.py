"""Seeded synthetic scene bank (`openpose_plus_tpu/data/synthetic.py`):
the quality benchmark's dataset of multi-person scenes (crowds, overlap,
~3.5x scale variation, border truncation, clutter), COCO-format.

`make_scene_bank` and `render_scene` draw with `cv2`, imported inside the
call as in the reference. `scene_bank_annotations` returns the same COCO
dict that `make_scene_bank` writes without `cv2` and without images: it
makes every `rng` draw of the rendering, in order (the noise image, the
clutter segments' endpoints, colours and widths, each person's colour),
and skips only the drawing, so the keypoints are the same.
"""

from __future__ import annotations

import json
import os

import numpy as np

from openpose_plus_tpu_torch import skeleton

# Canonical 18-part figure in unit coordinates (spans ~[-5,5] x [-10,9]
# around the pelvis).
_CANONICAL: dict[int, tuple[float, float]] = {
    0: (0.0, -10.0), 1: (0.0, -7.0),
    2: (-3.0, -7.0), 3: (-4.0, -3.0), 4: (-5.0, 1.0),
    5: (3.0, -7.0), 6: (4.0, -3.0), 7: (5.0, 1.0),
    8: (-2.0, 0.0), 9: (-2.0, 5.0), 10: (-2.0, 9.0),
    11: (2.0, 0.0), 12: (2.0, 5.0), 13: (2.0, 9.0),
    14: (-1.0, -10.5), 15: (1.0, -10.5),
    16: (-2.0, -10.0), 17: (2.0, -10.0),
}
_SEEDS = {"train": 1000, "val": 2000, "val_large": 3000}


def _sample_person(rng: np.random.Generator, cx: float, cy: float,
                   s: float) -> dict[int, tuple[float, float]]:
    """Articulated figure: global rotation + per-joint jitter at scale s."""
    theta = rng.uniform(-25, 25) * np.pi / 180.0
    ct, st = np.cos(theta), np.sin(theta)
    pose = {}
    for part, (ux, uy) in _CANONICAL.items():
        jx = ux + rng.normal(0, 0.45)
        jy = uy + rng.normal(0, 0.45)
        pose[part] = (cx + s * (ct * jx - st * jy),
                      cy + s * (st * jx + ct * jy))
    return pose


def _scene(rng: np.random.Generator, size: int, cv2,
           scale_div_lo: float = 48, scale_div_hi: float = 16,
           max_people: int = 6,
           ) -> tuple[np.ndarray, list[dict[int, tuple[float, float]]]]:
    """`render_scene`'s draws; with cv2 None nothing is drawn, every rng
    draw is still made."""
    base = int(rng.integers(10, 70))
    img = rng.integers(0, base, (size, size, 3), dtype=np.uint8)
    # clutter: distractor segments that are NOT limbs of any person
    for _ in range(int(rng.integers(0, 5))):
        p0 = tuple(int(v) for v in rng.integers(0, size, 2))
        p1 = tuple(int(v) for v in rng.integers(0, size, 2))
        color = tuple(int(c) for c in rng.integers(60, 160, 3))
        width = int(rng.integers(1, 3))
        if cv2 is not None:
            cv2.line(img, p0, p1, color, width)

    n_people = int(rng.integers(1, max_people + 1))
    poses: list[dict[int, tuple[float, float]]] = []
    centers: list[tuple[float, float, float]] = []  # (cx, cy, s)
    for _ in range(n_people):
        # log-uniform scale: ~size/48 (small background) .. size/16 (large)
        s = float(np.exp(rng.uniform(np.log(size / scale_div_lo),
                                     np.log(size / scale_div_hi))))
        if centers and rng.random() < 0.5:
            # crowd: drop next to an existing person (overlapping boxes)
            bx, by, bs = centers[int(rng.integers(0, len(centers)))]
            cx = bx + rng.uniform(-4, 4) * max(s, bs)
            cy = by + rng.uniform(-3, 3) * max(s, bs)
        else:
            # margin allows partial truncation at every border
            cx = rng.uniform(-2 * s, size + 2 * s)
            cy = rng.uniform(6 * s, size + 4 * s)
        cx = float(np.clip(cx, -3 * s, size + 3 * s))
        cy = float(np.clip(cy, 2 * s, size + 6 * s))
        pose = _sample_person(rng, cx, cy, s)
        poses.append(pose)
        centers.append((cx, cy, s))

    # render back-to-front so overlapping people occlude consistently
    # (nominal-RGB colours on an image the bank saves with cv2.imwrite's
    # BGR convention, as the reference does)
    for pose in poses:
        color = tuple(int(c) for c in rng.integers(120, 255, 3))
        if cv2 is None:
            continue
        for ia, ib in skeleton.COCO_PAIRS_RENDER:
            if ia in pose and ib in pose:
                cv2.line(img, (int(pose[ia][0]), int(pose[ia][1])),
                         (int(pose[ib][0]), int(pose[ib][1])), color, 2)
        for p, (x, y) in pose.items():
            cv2.circle(img, (int(x), int(y)), 3,
                       skeleton.COCO_COLORS[p % 18], -1)
    return img, poses


def render_scene(rng: np.random.Generator, size: int,
                 scale_div_lo: float = 48, scale_div_hi: float = 16,
                 max_people: int = 6,
                 ) -> tuple[np.ndarray, list[dict[int, tuple[float, float]]]]:
    """One clutter+crowd scene; returns (HxWx3 uint8, list of poses).

    Figure scale is log-uniform over size/scale_div_lo .. size/scale_div_hi;
    the "val_large" split overrides these (few, frame-filling figures)."""
    import cv2

    return _scene(rng, size, cv2, scale_div_lo, scale_div_hi, max_people)


def _bank_scenes(split: str, n_images: int, size: int, version: int, cv2):
    """Yields (i, image, poses) of the split's seeded bank."""
    seed = _SEEDS.get(split)
    if seed is None:
        raise ValueError(f"unknown split {split!r} (train|val|val_large)")
    style = ({"scale_div_lo": 24, "scale_div_hi": 10, "max_people": 3}
             if split == "val_large" else {})
    rng = np.random.default_rng(seed + version * 10_000)
    for i in range(n_images):
        yield (i, *_scene(rng, size, cv2, **style))


def _annotate(i: int, poses, size: int, ann_id: int) -> list[dict]:
    """COCO annotations of image i's in-frame people, ids from ann_id."""
    out = []
    for pose in poses:
        kp, n_vis = [], 0
        for c17 in range(17):
            x, y = pose[skeleton.COCO_FROM_OPENPOSE[c17]]
            v = 2 if 0 <= x < size and 0 <= y < size else 0
            n_vis += v > 0
            kp += [float(x), float(y), v]
        if n_vis == 0:
            continue  # fully out of frame
        xs = [p[0] for p in pose.values()]
        ys = [p[1] for p in pose.values()]
        area = max((max(xs) - min(xs)) * (max(ys) - min(ys)), 1.0)
        out.append({
            "id": ann_id + len(out), "image_id": i, "category_id": 1,
            "iscrowd": 0, "area": float(area), "keypoints": kp,
            "segmentation": [], "num_keypoints": int(n_vis),
        })
    return out


def _image_entry(split: str, i: int, size: int) -> dict:
    return {"id": i, "file_name": f"{split}{i:04d}.jpg", "width": size,
            "height": size}


def scene_bank_annotations(split: str, n_images: int, size: int = 256,
                           version: int = 1) -> dict:
    """The COCO dict `make_scene_bank` writes for these arguments, without
    cv2 and without images."""
    images, annotations = [], []
    for i, _, poses in _bank_scenes(split, n_images, size, version, None):
        annotations += _annotate(i, poses, size, len(annotations))
        images.append(_image_entry(split, i, size))
    return {"images": images, "annotations": annotations}


def make_scene_bank(out_dir: str, split: str, n_images: int,
                    size: int = 256, version: int = 1) -> tuple[str, str]:
    """Seeded scene bank -> (annotations.json path, images dir).

    Seeds are derived from (split, version) only, so the bank is bit-
    reproducible. Reuses an existing complete bank on disk."""
    import cv2

    bank = os.path.join(out_dir, f"{split}_v{version}_{n_images}x{size}")
    img_dir = os.path.join(bank, "images")
    ann_path = os.path.join(bank, "annotations.json")
    if os.path.exists(os.path.join(bank, ".complete")):
        return ann_path, img_dir
    if split not in _SEEDS:
        raise ValueError(f"unknown split {split!r} (train|val|val_large)")
    os.makedirs(img_dir, exist_ok=True)
    images, annotations = [], []
    for i, img, poses in _bank_scenes(split, n_images, size, version, cv2):
        annotations += _annotate(i, poses, size, len(annotations))
        entry = _image_entry(split, i, size)
        cv2.imwrite(os.path.join(img_dir, entry["file_name"]), img)
        images.append(entry)
    with open(ann_path, "w") as f:
        json.dump({"images": images, "annotations": annotations}, f)
    open(os.path.join(bank, ".complete"), "w").close()
    return ann_path, img_dir
